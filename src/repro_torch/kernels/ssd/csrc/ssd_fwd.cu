// Mamba-2 SSD chunked-scan forward for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py
// (_ssd_kernel, launched by ssd_pallas). Per (batch, head) and per chunk of
// Q tokens, with cum = cumsum(dt * a) over the chunk:
//   y_i  = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j     intra-chunk
//        + exp(cum_i) C_i . S^T                                    carried state
//        + D x_i
//   S    = S exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// The products are fp32, as in the TPU kernel; y is written in x's type.
// The chunk's cumsum is taken in fp64. In fp32, as the TPU kernel and the
// plain version take it, cum reaches about -200 over a chunk of 256 at the
// serving shape, so every decay exponent cum_i - cum_j carries about one
// fp32 ulp of 200 (1.5e-5) of absolute error, enough to move outputs where
// terms cancel outside tests/test_kernels.py::_tol of the exact result.
// Here each exponent is formed in fp64 and rounded to fp32 once.
// Beyond the TPU kernel it takes an optional initial state, writes the
// final fp32 state, and masks a ragged last chunk (L need not divide Q),
// which is what the plain version (ref.ssd_reference) computes.
//
// Layouts: x and y (B, L, H, P); dt (B, L, H) fp32; a and D (H,) fp32;
// B and C (B, L, G, N), head h reading group h / (H / G); states
// (B, H, P, N) fp32. All contiguous.
//
// What bounds it on the H100. At the serving prefill shape of mamba2-130m
// (B 8, L 4096, H 24, P 64, G 1, N 128, Q 256, bf16 x/B/C) the scan needs
// about 64.6 GFLOP (65 us at the 989 TFLOP/s bf16 rate) and about 227.5 MB
// of inputs and outputs once each (68 us at 3.35 TB/s), so the bound is
// bytes. This first kernel is far from it: its products run in fp32 on the
// CUDA cores (67 TFLOP/s), so it is bound near 1 ms by operations. What
// the design does:
//   * one block owns one (b, h) and loops over the chunks in order, so the
//     (P, N) fp32 state is carried in shared memory from chunk to chunk
//     (the TPU carries it in VMEM across the innermost grid axis; here
//     blocks run in no order, so nothing may cross between blocks);
//   * the (Q, Q) score tile does not fit in shared memory at Q = 256, so a
//     chunk is cut into 64-row query tiles, and each query tile visits only
//     the 64-row key tiles at or below the diagonal;
//   * for j > i, exp(cum_i - cum_j) can overflow to inf, so the gate is
//     selected to 0 there (and on the padded rows of a ragged chunk), never
//     multiplied by a mask;
//   * the three products (C S^T, the gate times X, and X^T B for the state)
//     are register-tiled: each thread keeps a 4 x (P/16) or (P/16) x (N/16)
//     block of outputs, and shared-memory rows have odd strides so the 16
//     rows a half-warp reads hit 16 different banks.
// It does not yet use the tensor cores, cp.async/TMA or more than one
// block per SM (the state, one C tile, one B tile and one X tile take
// about 120 KB at P 64, N 128), and 192 blocks at the serving shape fill
// 132 SMs in 1.45 waves; that is what separates it from the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kMaxChunk = 1024;

struct Params {
  const void* x;      // (B, L, H, P)
  const float* dt;    // (B, L, H)
  const float* a;     // (H,)
  const void* b;      // (B, L, G, N)
  const void* c;      // (B, L, G, N)
  const float* d;     // (H,) or null
  const float* s0;    // (B, H, P, N) or null
  void* y;            // (B, L, H, P)
  float* s_out;       // (B, H, P, N) or null
  int L, H, G, Q;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Rows [row0, row0 + kTile) of a chunk into shared memory (fp32, row stride
// LD): row r of the chunk starts at src + r * row_stride and has W values.
// Rows at or past `nrows` are zero-filled; with `scale`, row r is multiplied
// by scale[r].
template <typename T, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t row_stride,
                                          int row0, int nrows, const float* scale) {
  for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
    const int r = e / W, col = e % W;
    float v = 0.f;
    if (row0 + r < nrows) {
      v = to_f(src[(size_t)(row0 + r) * row_stride + col]);
      if (scale != nullptr) v *= scale[row0 + r];
    }
    dst[r * LD + col] = v;
  }
}

template <int P, int N>
struct Smem {
  static constexpr int LDN = N + 1;        // odd: 16 rows read at one n hit 16 banks
  static constexpr int LDG = kTile + 1;
  static constexpr int kState = P * LDN;
  static constexpr int kC = kTile * LDN;
  static constexpr int kB = kTile * LDN > kTile * LDG ? kTile * LDN : kTile * LDG;
  static constexpr int kX = kTile * P;
  static size_t bytes(int q) {
    const size_t qpad = round_up(q, kTile);
    return sizeof(double) * qpad + sizeof(float) * ((size_t)kState + kC + kB + kX + 2 * qpad);
  }
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_fwd_kernel(Params p) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  using S = Smem<P, N>;
  constexpr int LDN = S::LDN, LDG = S::LDG;
  constexpr int CP = P / 16;   // y columns and state rows per thread
  constexpr int CN = N / 16;   // state columns per thread

  extern __shared__ double smem_d[];
  const int qpad = round_up(p.Q, kTile);
  double* s_cum = smem_d;                 // (qpad,) cumsum(dt * a), fp64
  float* s_state = reinterpret_cast<float*>(s_cum + qpad);  // (P, LDN): S[p][n]
  float* s_c = s_state + S::kState;       // (kTile, LDN): C rows of the query tile
  float* s_b = s_c + S::kC;               // (kTile, LDN): B rows of the key tile,
                                          // then (kTile, LDG): the gate tile
  float* s_x = s_b + S::kB;               // (kTile, P): X rows of the key tile
  float* s_dt = s_x + S::kX;              // (qpad,) dt, 0 past the chunk's end
  float* s_w = s_dt + qpad;               // (qpad,) exp(cum_last - cum_j) dt_j

  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, lane = tid % 32;
  const float a = p.a[h];
  const float dskip = p.d != nullptr ? p.d[h] : 0.f;
  const size_t xrow = (size_t)p.H * P;   // row (token) stride of x and y
  const size_t brow = (size_t)p.G * N;   // row stride of B and C
  const size_t trow = p.H;               // row stride of dt
  const size_t state_off = ((size_t)bi * p.H + h) * P * N;

  for (int e = tid; e < P * N; e += kThreads) {
    const int r = e / N, n = e % N;
    s_state[r * LDN + n] = p.s0 != nullptr ? p.s0[state_off + e] : 0.f;
  }

  for (int c0 = 0; c0 < p.L; c0 += p.Q) {
    const int qlen = min(p.Q, p.L - c0);
    const size_t row0 = (size_t)bi * p.L + c0;
    const T* xc = static_cast<const T*>(p.x) + row0 * xrow + (size_t)h * P;
    T* yc = static_cast<T*>(p.y) + row0 * xrow + (size_t)h * P;
    const T* bc = static_cast<const T*>(p.b) + row0 * brow + (size_t)g * N;
    const T* cc = static_cast<const T*>(p.c) + row0 * brow + (size_t)g * N;
    const float* dtc = p.dt + row0 * trow + h;

    __syncthreads();  // the previous chunk is done with s_dt, s_cum, s_w
    if (tid < 32) {
      // inclusive scan of dt * a by one warp, 32 rows at a time; rows past
      // the chunk's end get dt = 0, so their cum is cum_last (the plain
      // version's zero padding)
      double carry = 0.0;
      for (int base = 0; base < qpad; base += 32) {
        const int j = base + lane;
        const float dtj = j < qlen ? dtc[(size_t)j * trow] : 0.f;
        double v = (double)(dtj * a);  // the product rounds to fp32 as in the plain version
#pragma unroll
        for (int o = 1; o < 32; o *= 2) {
          const double up = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += up;
        }
        v += carry;
        s_dt[j] = dtj;
        s_cum[j] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const double cum_last = s_cum[qlen - 1];
    for (int j = tid; j < qpad; j += kThreads)
      s_w[j] = expf((float)(cum_last - s_cum[j])) * s_dt[j];

    // ---- outputs, one 64-row query tile at a time ----
    for (int i0 = 0; i0 < qlen; i0 += kTile) {
      __syncthreads();  // s_c, s_b and s_x are free
      load_tile<T, N, LDN>(s_c, cc, brow, i0, qlen, nullptr);
      __syncthreads();

      // carried state: acc[r][k] for row i0 + ty + 16 r, column tx + 16 k
      float acc[4][CP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < CP; ++k) acc[r][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[CP];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = s_c[(ty + 16 * r) * LDN + n];
#pragma unroll
        for (int k = 0; k < CP; ++k) sv[k] = s_state[(tx + 16 * k) * LDN + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < CP; ++k) acc[r][k] = fmaf(cv[r], sv[k], acc[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf((float)s_cum[i0 + ty + 16 * r]);
#pragma unroll
        for (int k = 0; k < CP; ++k) acc[r][k] *= e;
      }

      // intra-chunk: the key tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        __syncthreads();  // the previous key tile's gate and X are read
        load_tile<T, N, LDN>(s_b, bc, brow, j0, qlen, nullptr);
        load_tile<T, P, P>(s_x, xc, xrow, j0, qlen, nullptr);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[r][k] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = s_c[(ty + 16 * r) * LDN + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = s_b[(tx + 16 * k) * LDN + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) sc[r][k] = fmaf(cv[r], bv[k], sc[r][k]);
        }
        __syncthreads();  // every thread has read s_b: it now takes the gate
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = j0 + tx + 16 * k;
            // select, never multiply by a mask: for j > i the exponent is
            // positive and exp can reach inf, and inf * 0 is NaN
            const bool live = j <= i && j < qlen;
            const float decay = expf(live ? (float)(s_cum[i] - s_cum[j]) : 0.f);
            s_b[(ty + 16 * r) * LDG + tx + 16 * k] = live ? decay * sc[r][k] * s_dt[j] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < kTile; ++jj) {
          float gv[4], xv[CP];
#pragma unroll
          for (int r = 0; r < 4; ++r) gv[r] = s_b[(ty + 16 * r) * LDG + jj];
#pragma unroll
          for (int k = 0; k < CP; ++k) xv[k] = s_x[jj * P + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < CP; ++k) acc[r][k] = fmaf(gv[r], xv[k], acc[r][k]);
        }
      }

      // skip connection, then y in x's type
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= qlen) continue;
#pragma unroll
        for (int k = 0; k < CP; ++k) {
          const size_t off = (size_t)i * xrow + tx + 16 * k;
          store(yc + off, acc[r][k] + dskip * to_f(xc[off]));
        }
      }
    }

    // ---- state update: S = S exp(cum_last) + (X w)^T B ----
    // thread owns S[ty + 16 r][tx + 16 k]
    float sacc[CP][CN];
#pragma unroll
    for (int r = 0; r < CP; ++r)
#pragma unroll
      for (int k = 0; k < CN; ++k) sacc[r][k] = 0.f;
    for (int j0 = 0; j0 < qlen; j0 += kTile) {
      __syncthreads();
      load_tile<T, N, LDN>(s_b, bc, brow, j0, qlen, nullptr);
      load_tile<T, P, P>(s_x, xc, xrow, j0, qlen, s_w);
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kTile; ++jj) {
        float xv[CP], bv[CN];
#pragma unroll
        for (int r = 0; r < CP; ++r) xv[r] = s_x[jj * P + ty + 16 * r];
#pragma unroll
        for (int k = 0; k < CN; ++k) bv[k] = s_b[jj * LDN + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < CP; ++r)
#pragma unroll
          for (int k = 0; k < CN; ++k) sacc[r][k] = fmaf(xv[r], bv[k], sacc[r][k]);
      }
    }
    // Only the owner touches these elements here; the other threads read
    // S only in the query tiles above, and the next chunk starts with a
    // barrier.
    const float chunk_decay = expf((float)cum_last);
#pragma unroll
    for (int r = 0; r < CP; ++r)
#pragma unroll
      for (int k = 0; k < CN; ++k) {
        float& s = s_state[(ty + 16 * r) * LDN + tx + 16 * k];
        s = s * chunk_decay + sacc[r][k];
      }
  }

  if (p.s_out != nullptr) {
    __syncthreads();
    for (int e = tid; e < P * N; e += kThreads) {
      const int r = e / N, n = e % N;
      p.s_out[state_off + e] = s_state[r * LDN + n];
    }
  }
}

template <typename T, int P, int N>
int launch(const Params& p, int B, cudaStream_t st) {
  const size_t bytes = Smem<P, N>::bytes(p.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_fwd_kernel<T, P, N><<<dim3(p.H, B), kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_n(const Params& p, int B, int N, cudaStream_t st) {
  switch (N) {
    case 16: return launch<T, P, 16>(p, B, st);
    case 32: return launch<T, P, 32>(p, B, st);
    case 64: return launch<T, P, 64>(p, B, st);
    case 128: return launch<T, P, 128>(p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_pn(const Params& p, int B, int P, int N, cudaStream_t st) {
  switch (P) {
    case 16: return launch_n<T, 16>(p, B, N, st);
    case 32: return launch_n<T, 32>(p, B, N, st);
    case 64: return launch_n<T, 64>(p, B, N, st);
    case 128: return launch_n<T, 128>(p, B, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code (0 on success).
// is_bf16: 1 for bf16 x/B/C/y, 0 for fp32. d, s0 and s_out may be null (no
// skip term, zero initial state, no final state). P and N must be one of
// 16, 32, 64, 128; 1 <= Q <= 1024; H % G == 0. The caller checks shapes,
// types and contiguity.
int ssd_fwd(const void* x, const float* dt, const float* a, const void* b,
            const void* c, const float* d, const float* s0, void* y, float* s_out,
            int B, int L, int H, int P, int G, int N, int Q, int is_bf16,
            void* stream) {
  if (Q < 1 || Q > kMaxChunk || G < 1 || H % G != 0 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, a, b, c, d, s0, y, s_out, L, H, G, Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_pn<bf16>(p, B, P, N, st) : launch_pn<float>(p, B, P, N, st);
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
