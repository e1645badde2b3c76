// Mamba-2 SSD chunked-scan forward for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py
// (_ssd_kernel, launched by ssd_pallas). Per (batch, head) and per chunk z
// of Q tokens, with cum = cumsum(dt * a) over the chunk:
//   y_i  = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j     intra-chunk
//        + exp(cum_i) C_i . S_{z-1}^T                              carried state
//        + D x_i
//   S_z  = S_{z-1} exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// y is written in x's type, the states are fp32. The chunk's cumsum is
// taken in fp64. In fp32, as the TPU kernel and the plain version take it,
// cum reaches about -200 over a chunk of 256 at the serving shape, so every
// decay exponent cum_i - cum_j carries about one fp32 ulp of 200 (1.5e-5)
// of absolute error, enough to move outputs where terms cancel outside
// tests/test_kernels.py::_tol of the exact result. Here every exponent is
// rounded to fp32 from fp64 values that are small wherever its exponential
// is not negligible (see pass 3).
// Beyond the TPU kernel it takes an optional initial state, writes the
// final fp32 state, and masks a ragged last chunk (L need not divide Q),
// which is what the plain version (ref.ssd_reference) computes.
//
// Layouts: x and y (B, L, H, P); dt (B, L, H) fp32; a and D (H,) fp32;
// B and C (B, L, G, N), head h reading group h / (H / G); states
// (B, H, P, N) fp32. All contiguous; bf16 x, B and C 16-byte aligned.
//
// What bounds it on the H100. At the serving prefill shape of mamba2-130m
// (B 8, L 4096, H 24, P 64, G 1, N 128, Q 256, bf16 x/B/C) the scan needs
// about 64.6 GFLOP (65 us at the 989 TFLOP/s bf16 rate) and about 227.5 MB
// of inputs and outputs once each (68 us at 3.35 TB/s), so the bound is
// bytes, with operations close behind. The bf16 design is the chunk-
// parallel form of the plain version, three launches on the caller's
// stream with every product on the tensor cores:
//   1. ssd_chunk_state, one block per (b, h, chunk) (3,072 at the serving
//      shape): the chunk's fp64 cumsum, its decay exp(cum_last), and its
//      local state X^T (w B), w_j = exp(cum_last - cum_j) dt_j, into an
//      fp32 scratch (B, chunks, H, P, N) (100.7 MB at the serving shape);
//   2. ssd_state_pass, one thread per state element: the recurrence
//      S_z = S_{z-1} exp(cum_last_z) + local_z from the initial state,
//      leaving in the scratch the state carried into each chunk and writing
//      the final state. Elementwise, bound by its bytes;
//   3. ssd_chunk_output, one block per (b, h, chunk): 64-row query tiles,
//      each with its carried-state term and the key tiles at or below the
//      diagonal (those above are skipped), plus the skip term.
// Pass 3, not pass 1, takes the intra-chunk term: pass 1 would have to hand
// pass 3 a partial y in fp32 (201 MB written and read again at the serving
// shape), where pass 3 computing it re-reads only x and B (109 MB, much of
// it from L2).
// Every product is mma.sync m16n8k16 bf16 with fp32 accumulation, operands
// from shared memory by ldmatrix, tiles double-buffered by cp.async (the
// next key tile lands while the current one is multiplied). C B^T comes
// exactly from the bf16 inputs. The operands the TPU kernel holds in fp32
// (the gate exp(cum_i - cum_j) (C_i . B_j) dt_j, the w-weighted x of the
// state product and the carried state) are each split into hi + lo bf16
// parts and multiplied twice; hi + lo keeps 16 significant bits. Rounded
// once to bf16 instead (2^-9 relative), each breaks the float64
// comparison (tests/test_torch_ssd_numerics.py emulates this arithmetic
// at L 2048, H 8, P 64, N 128, chunk 256): rounding the gate alone puts
// 1,214 of 1,048,576 outputs outside _tol, the carried state alone 8, and
// the weighted x alone 47,167 of 65,536 final-state elements outside the
// 2e-4 they are held to; with all three split, none. On the H100 at the
// serving shape the split kernel is within 8.6e-5 of the float64 final
// state, and y within _tol on every element.
// Above the diagonal, exp(cum_i - cum_j) can overflow to inf, so the gate
// is selected to 0 there (and past the end of a ragged chunk), never
// multiplied by a mask.
// What still separates it from the bound: the scratch's round trips
// (about 400 MB of traffic at the serving shape, more than the inputs'
// 227.5 MB), the split products (about 116 GFLOP where 64.6 are needed),
// and mma.sync's rate, below wgmma's.
//
// fp32 inputs are off the serving path and keep the one-block-per-(b, h)
// kernel ssd_fwd_f32 (fp32 CUDA-core products, state carried in shared
// memory from chunk to chunk).

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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
  float* states;      // bf16 path: (B, nc, H, P, N) scratch
  float* decay;       // bf16 path: (B, nc, H) scratch, exp(cum_last)
  int L, H, G, Q, nc;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_fwd_f32(Params p) {
  typedef float T;
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


// ---- bf16: chunk-parallel on the tensor cores ------------------------------

constexpr int kTcThreads = 128;   // 4 warps
constexpr double kLog2eD = 1.4426950408889634;
constexpr int kPad = 8;           // bf16 row padding: the 8 rows an ldmatrix
                                  // reads start in 8 different bank groups

// The chunk's dt (0 past its end) and inclusive cumsum of dt * a in fp64,
// by one warp, 32 rows at a time. Rows past the end get dt = 0, so their
// cum is cum_last (the plain version's zero padding).
__device__ __forceinline__ void chunk_scan(const float* dtc, size_t trow, float a, int qlen,
                                           int qpad, double* s_cum, float* s_dt) {
  const int lane = threadIdx.x % 32;
  for (int j = lane; j < qpad; j += 32)   // every load in flight at once
    s_dt[j] = j < qlen ? dtc[(size_t)j * trow] : 0.f;
  __syncwarp();
  double carry = 0.0;
  for (int base = 0; base < qpad; base += 32) {
    const int j = base + lane;
    const float dtj = s_dt[j];
    double v = (double)(dtj * a);  // the product rounds to fp32 as in the plain version
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const double up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    v += carry;
    s_cum[j] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// Rows [row0, row0 + kTile) of a chunk (W bf16 values each, row stride
// `stride` in global memory) into shared memory with row stride W + kPad,
// by cp.async; rows at or past `nrows` are zero-filled.
template <int W>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, size_t stride,
                                                int row0, int nrows) {
  constexpr int CH = W / 8;   // 16-byte pieces per row
  for (int e = threadIdx.x; e < kTile * CH; e += kTcThreads) {
    const int r = e / CH, c = e % CH;
    const bool in = row0 + r < nrows;
    cp_async_16(dst + r * (W + kPad) + c * 8,
                in ? src + (size_t)(row0 + r) * stride + c * 8 : src, in ? 16 : 0);
  }
}

// The chunk a block of passes 1 and 3 owns: blockIdx.x = z * H + h (heads of
// one chunk are neighbours and share its B and C rows in L2), blockIdx.y = b.
struct Chunk {
  int h, z, b, g, c0, qlen, qpad;
  size_t row0;   // token row of the chunk's first row in (B * L)
  __device__ Chunk(const Params& p) {
    h = blockIdx.x % p.H;
    z = blockIdx.x / p.H;
    b = blockIdx.y;
    g = h / (p.H / p.G);
    c0 = z * p.Q;
    qlen = min(p.Q, p.L - c0);
    qpad = round_up(qlen, kTile);
    row0 = (size_t)b * p.L + c0;
  }
};

template <int P, int N>
struct TcSmem {
  static constexpr int LDX = P + kPad, LDN = N + kPad;
  static constexpr size_t X_TILE = (size_t)kTile * LDX * 2;   // bytes
  static constexpr size_t N_TILE = (size_t)kTile * LDN * 2;
  // pass 1: cum (fp64), dt, w; two X and two B tiles
  static size_t state_bytes(int q) {
    return 16 * (size_t)round_up(q, kTile) + 2 * X_TILE + 2 * N_TILE;
  }
  // pass 3: cum (fp64), dt, the column factors of off-diagonal gates; the
  // carried state as bf16 hi and lo; one C tile; two B and two X tiles
  static size_t output_bytes(int q) {
    return 16 * (size_t)round_up(q, kTile) + 2 * (size_t)P * LDN * 2 + 3 * N_TILE + 2 * X_TILE;
  }
};

// Pass 1: local state X^T (w B) of one chunk, w_j = exp(cum_last - cum_j)
// dt_j, as a (P, N) product over the chunk's rows: A = (w x)^T from the X
// tile by ldmatrix.trans, split hi + lo; B from the B tile by
// ldmatrix.trans. Warps tile the (P, N) output WM x WN.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads) ssd_chunk_state(Params p) {
  using L = TcSmem<P, N>;
  constexpr int LDX = L::LDX, LDN = L::LDN;
  constexpr int WM = P / 16 < 4 ? P / 16 : 4;
  constexpr int WN = 4 / WM < N / 16 ? 4 / WM : N / 16;
  constexpr int MT = P / 16 / WM;   // 16-row tiles of P per warp
  constexpr int NT = N / 8 / WN;    // 8-column tiles of N per warp (even)
  extern __shared__ __align__(16) unsigned char smem[];
  const Chunk ch(p);
  double* s_cum = reinterpret_cast<double*>(smem);
  float* s_dt = reinterpret_cast<float*>(s_cum + ch.qpad);
  float* s_w = s_dt + ch.qpad;
  bf16* s_x = reinterpret_cast<bf16*>(s_w + ch.qpad);
  bf16* s_b = s_x + 2 * kTile * LDX;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t xrow = (size_t)p.H * P, brow = (size_t)p.G * N;
  const bf16* xc = static_cast<const bf16*>(p.x) + ch.row0 * xrow + (size_t)ch.h * P;
  const bf16* bc = static_cast<const bf16*>(p.b) + ch.row0 * brow + (size_t)ch.g * N;

  load_tile_async<P>(s_x, xc, xrow, 0, ch.qlen);
  load_tile_async<N>(s_b, bc, brow, 0, ch.qlen);
  cp_async_commit();
  const float a = p.a[ch.h];
  if (warp == 0) chunk_scan(p.dt + ch.row0 * p.H + ch.h, p.H, a, ch.qlen, ch.qpad, s_cum, s_dt);
  __syncthreads();
  const double cum_last = s_cum[ch.qlen - 1];
  for (int j = tid; j < ch.qpad; j += kTcThreads)
    s_w[j] = expf((float)(cum_last - s_cum[j])) * s_dt[j];
  const size_t bzh = ((size_t)ch.b * p.nc + ch.z) * p.H + ch.h;
  if (tid == 0) p.decay[bzh] = expf((float)cum_last);

  const int wm = warp % WM, wn = warp / WM;
  const bool active = warp < WM * WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int n_tiles = ch.qpad / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();
    __syncthreads();   // tile kt has landed; every warp is done with tile kt - 1
    if (kt + 1 < n_tiles) {
      load_tile_async<P>(s_x + (buf ^ 1) * kTile * LDX, xc, xrow, (kt + 1) * kTile, ch.qlen);
      load_tile_async<N>(s_b + (buf ^ 1) * kTile * LDN, bc, brow, (kt + 1) * kTile, ch.qlen);
    }
    cp_async_commit();
    if (!active) continue;
    const bf16* xs = s_x + buf * kTile * LDX;
    const bf16* bs = s_b + buf * kTile * LDN;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      const int jr = ks * 16;   // row of the tile
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int p0 = (wm * MT + mt) * 16;
        uint32_t raw[4];
        ldmatrix_x4_trans(raw, xs + (jr + lane % 8 + (lane / 16) * 8) * LDX + p0 +
                                   ((lane / 8) % 2) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // raw[i] holds x at rows j, j + 1 of column p0 + lane / 4 (+ 8)
          const int j = kt * kTile + jr + 2 * (lane % 4) + (i / 2) * 8;
          const float2 xv = unpack_bf16x2(raw[i]);
          split_bf16x2(xv.x * s_w[j], xv.y * s_w[j + 1], ahi[mt][i], alo[mt][i]);
        }
      }
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2)
        ldmatrix_x4_trans(bf[nt / 2], bs + (jr + lane % 8 + ((lane / 8) % 2) * 8) * LDN +
                                          (wn * NT + nt) * 8 + (lane / 16) * 8);
      // the hi products over every accumulator, then the lo ones: no two
      // products in a row wait on each other
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[mt][nt], ahi[mt], bf[nt / 2][2 * (nt % 2)], bf[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[mt][nt], alo[mt], bf[nt / 2][2 * (nt % 2)], bf[nt / 2][2 * (nt % 2) + 1]);
    }
  }

  if (active) {
    float* out = p.states + bzh * P * N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = (wm * MT + mt) * 16 + lane / 4, n = (wn * NT + nt) * 8 + 2 * (lane % 4);
        *reinterpret_cast<float2*>(out + (size_t)r * N + n) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(out + (size_t)(r + 8) * N + n) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
}

// Pass 2: the recurrence S_z = S_{z-1} exp(cum_last_z) + local_z from the
// initial state, four state elements of one (b, h) per thread
// (blockIdx.y = b * H + h). Replaces local_z in the scratch by S_{z-1}, the
// state carried into chunk z, and writes the final state. Every load of a
// batch of chunks is issued before its first store: a store to the scratch
// may alias a later load as far as the compiler knows, so loads and stores
// interleaved chunk by chunk would wait out one memory round trip each.
__global__ void __launch_bounds__(256) ssd_state_pass(Params p, int pn) {
  constexpr int kBatch = 8;
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (k >= pn) return;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const size_t zstride = (size_t)p.H * pn;   // floats from chunk z to z + 1
  float* slot0 = p.states + ((size_t)b * p.nc * p.H + h) * pn + k;
  const float* dec0 = p.decay + (size_t)b * p.nc * p.H + h;
  float4 s = p.s0 != nullptr ? *reinterpret_cast<const float4*>(p.s0 + (size_t)bh * pn + k)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z0 = 0; z0 < p.nc; z0 += kBatch) {
    float4 local[kBatch];
    float dec[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (z0 + i < p.nc) {
        local[i] = *reinterpret_cast<const float4*>(slot0 + (z0 + i) * zstride);
        dec[i] = dec0[(size_t)(z0 + i) * p.H];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (z0 + i < p.nc) {
        *reinterpret_cast<float4*>(slot0 + (z0 + i) * zstride) = s;
        s.x = s.x * dec[i] + local[i].x;
        s.y = s.y * dec[i] + local[i].y;
        s.z = s.z * dec[i] + local[i].z;
        s.w = s.w * dec[i] + local[i].w;
      }
    }
  }
  if (p.s_out != nullptr) *reinterpret_cast<float4*>(p.s_out + (size_t)bh * pn + k) = s;
}

// Pass 3: y of one chunk, 64-row query tiles, one warp per 16 rows:
// exp(cum_i) C_i . S^T (S split hi + lo), then for each key tile at or
// below the diagonal the score tile C B^T, the gate (split hi + lo, as the
// A operand straight from the accumulator layout) times X, and D x.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads) ssd_chunk_output(Params p) {
  using L = TcSmem<P, N>;
  constexpr int LDX = L::LDX, LDN = L::LDN;
  constexpr int KS = N / 16;   // k-steps over the state dimension
  constexpr int PT = P / 8;    // 8-column tiles of y
  extern __shared__ __align__(16) unsigned char smem[];
  const Chunk ch(p);
  double* s_cum = reinterpret_cast<double*>(smem);
  float* s_dt = reinterpret_cast<float*>(s_cum + ch.qpad);
  float* s_colf = s_dt + ch.qpad;                          // (qpad,)
  bf16* s_shi = reinterpret_cast<bf16*>(s_colf + ch.qpad); // (P, LDN)
  bf16* s_slo = s_shi + P * LDN;
  bf16* s_c = s_slo + P * LDN;                             // (kTile, LDN)
  bf16* s_b = s_c + kTile * LDN;                           // 2 x (kTile, LDN)
  bf16* s_x = s_b + 2 * kTile * LDN;                       // 2 x (kTile, LDX)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c2 = 2 * (lane % 4);
  const size_t xrow = (size_t)p.H * P, brow = (size_t)p.G * N;
  const size_t hoff = (size_t)ch.h * P, goff = (size_t)ch.g * N;
  const bf16* xc = static_cast<const bf16*>(p.x) + ch.row0 * xrow + hoff;
  const bf16* bc = static_cast<const bf16*>(p.b) + ch.row0 * brow + goff;
  const bf16* cc = static_cast<const bf16*>(p.c) + ch.row0 * brow + goff;
  bf16* yc = static_cast<bf16*>(p.y) + ch.row0 * xrow + hoff;
  const float dskip = p.d != nullptr ? p.d[ch.h] : 0.f;

  load_tile_async<N>(s_c, cc, brow, 0, ch.qlen);
  load_tile_async<N>(s_b, bc, brow, 0, ch.qlen);
  load_tile_async<P>(s_x, xc, xrow, 0, ch.qlen);
  cp_async_commit();
  if (warp == 0)
    chunk_scan(p.dt + ch.row0 * p.H + ch.h, p.H, p.a[ch.h], ch.qlen, ch.qpad, s_cum, s_dt);
  {
    const float4* sp = reinterpret_cast<const float4*>(
        p.states + (((size_t)ch.b * p.nc + ch.z) * p.H + ch.h) * P * N);
    for (int e = tid; e < P * N / 4; e += kTcThreads) {
      const float4 v = sp[e];
      const int r = e * 4 / N, n = e * 4 % N;
      uint32_t* hi = reinterpret_cast<uint32_t*>(s_shi + r * LDN + n);
      uint32_t* lo = reinterpret_cast<uint32_t*>(s_slo + r * LDN + n);
      split_bf16x2(v.x, v.y, hi[0], lo[0]);
      split_bf16x2(v.z, v.w, hi[1], lo[1]);
    }
  }

  // Off the diagonal, every row i of a query tile lies below every row j of
  // the key tile, and with R the (base-2) cumsum of the key tile's last row
  // the decay factors as exp2(c_i - R) exp2(R - c_j), both at most 1: the
  // column factor exp2(R - c_j) dt_j depends on j alone and is taken here
  // once, the row factor once per tile pair, and the gate needs no
  // exponential per element. (On the diagonal c_i - R can be large and
  // positive, so the diagonal tile keeps exp2(c_i - c_j).)
  __syncthreads();   // the scan is done
  for (int j = tid; j < ch.qpad; j += kTcThreads) {
    const double r = s_cum[(j / kTile) * kTile + kTile - 1];
    s_colf[j] = ex2_approx((float)((r - s_cum[j]) * kLog2eD)) * s_dt[j];
  }

  const int n_qt = ch.qpad / kTile;
  uint32_t cf[KS][4];    // this warp's 16 C rows as A fragments
  float acc[PT][4];
  int buf = 0;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int i0 = qt * kTile;
    const int il = i0 + warp * 16 + lane / 4, ih = il + 8;   // rows of the chunk
    for (int kt = 0; kt <= qt; ++kt, buf ^= 1) {
      cp_async_wait<0>();
      __syncthreads();   // pair (qt, kt) has landed; every warp is done with the last
      const int nq = kt < qt ? qt : qt + 1, nk = kt < qt ? kt + 1 : 0;
      if (nq < n_qt) {
        load_tile_async<N>(s_b + (buf ^ 1) * kTile * LDN, bc, brow, nk * kTile, ch.qlen);
        load_tile_async<P>(s_x + (buf ^ 1) * kTile * LDX, xc, xrow, nk * kTile, ch.qlen);
      }
      if (kt == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldmatrix_x4(cf[ks], s_c + (warp * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDN +
                                  ks * 16 + (lane / 16) * 8);
      }
      if (nq < n_qt && nk == 0) {
        if (kt == 0) __syncthreads();   // every warp holds its C rows
        load_tile_async<N>(s_c, cc, brow, nq * kTile, ch.qlen);
      }
      cp_async_commit();

      if (kt == 0) {
        // carried state: acc = exp(cum_i) C_i . (S_hi + S_lo)^T
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) acc[pt][0] = acc[pt][1] = acc[pt][2] = acc[pt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t bh[PT / 2][4], bl[PT / 2][4];
#pragma unroll
          for (int pt = 0; pt < PT; pt += 2) {
            const int off = (pt * 8 + lane % 8 + (lane / 16) * 8) * LDN + ks * 16 +
                            ((lane / 8) % 2) * 8;
            ldmatrix_x4(bh[pt / 2], s_shi + off);
            ldmatrix_x4(bl[pt / 2], s_slo + off);
          }
#pragma unroll
          for (int pt = 0; pt < PT; ++pt)
            mma_16816(acc[pt], cf[ks], bh[pt / 2][2 * (pt % 2)], bh[pt / 2][2 * (pt % 2) + 1]);
#pragma unroll
          for (int pt = 0; pt < PT; ++pt)
            mma_16816(acc[pt], cf[ks], bl[pt / 2][2 * (pt % 2)], bl[pt / 2][2 * (pt % 2) + 1]);
        }
        const float el = expf((float)s_cum[il]), eh = expf((float)s_cum[ih]);
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) {
          acc[pt][0] *= el;
          acc[pt][1] *= el;
          acc[pt][2] *= eh;
          acc[pt][3] *= eh;
        }
      }

      // scores C_i . B_j of this warp's rows and the key tile's 64 columns
      const bf16* bs = s_b + buf * kTile * LDN;
      const bf16* xs = s_x + buf * kTile * LDX;
      // On the diagonal tile, warp w's rows see keys below 16 (w + 1) only:
      // the score columns and k-steps of X past them are skipped.
      const bool diag = kt == qt;
      const int live_jt = diag ? 2 * warp + 2 : kTile / 8;   // 8-column tiles
      float sc[kTile / 8][4];
#pragma unroll
      for (int jt = 0; jt < kTile / 8; ++jt) sc[jt][0] = sc[jt][1] = sc[jt][2] = sc[jt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bb[kTile / 16][4];
#pragma unroll
        for (int jt = 0; jt < kTile / 8; jt += 2)
          if (jt < live_jt)
            ldmatrix_x4(bb[jt / 2], bs + (jt * 8 + lane % 8 + (lane / 16) * 8) * LDN + ks * 16 +
                                        ((lane / 8) % 2) * 8);
#pragma unroll
        for (int jt = 0; jt < kTile / 8; ++jt)
          if (jt < live_jt)
            mma_16816(sc[jt], cf[ks], bb[jt / 2][2 * (jt % 2)], bb[jt / 2][2 * (jt % 2) + 1]);
      }
      // gate = exp(cum_i - cum_j) score dt_j
      const int j0 = kt * kTile;
      if (diag) {
        // selected to 0 above the diagonal and past the chunk's end. The
        // exponent is the difference of fp64 offsets from the tile's first
        // row, each rounded to fp32 once: where the decay is not negligible
        // both offsets are small, so it keeps the fp64 cumsum's accuracy
        // with one fp32 subtraction per element.
        const double ref = s_cum[j0];
        const float el2 = (float)((s_cum[il] - ref) * kLog2eD);
        const float eh2 = (float)((s_cum[ih] - ref) * kLog2eD);
#pragma unroll
        for (int jt = 0; jt < kTile / 8; ++jt) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = j0 + jt * 8 + c2 + c;
            const float ej2 = (float)((s_cum[j] - ref) * kLog2eD);
            const float dtj = s_dt[j];
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int e = 2 * hi + c, i = hi ? ih : il;
              const bool live = j <= i && j < ch.qlen;
              const float decay = ex2_approx(live ? (hi ? eh2 : el2) - ej2 : 0.f);
              sc[jt][e] = live ? decay * sc[jt][e] * dtj : 0.f;
            }
          }
        }
      } else {
        const double r = s_cum[j0 + kTile - 1];
        const float fl = ex2_approx((float)((s_cum[il] - r) * kLog2eD));
        const float fh = ex2_approx((float)((s_cum[ih] - r) * kLog2eD));
#pragma unroll
        for (int jt = 0; jt < kTile / 8; ++jt) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float cj = s_colf[j0 + jt * 8 + c2 + c];
            sc[jt][c] *= fl * cj;
            sc[jt][2 + c] *= fh * cj;
          }
        }
      }
      // acc += (G_hi + G_lo) X
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if (kk >= live_jt / 2) break;   // all-zero gate columns of the diagonal
        uint32_t ghi[4], glo[4];
        split_bf16x2(sc[2 * kk][0], sc[2 * kk][1], ghi[0], glo[0]);
        split_bf16x2(sc[2 * kk][2], sc[2 * kk][3], ghi[1], glo[1]);
        split_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ghi[2], glo[2]);
        split_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ghi[3], glo[3]);
        uint32_t bx[PT / 2][4];
#pragma unroll
        for (int pt = 0; pt < PT; pt += 2)
          ldmatrix_x4_trans(bx[pt / 2], xs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDX +
                                            pt * 8 + (lane / 16) * 8);
#pragma unroll
        for (int pt = 0; pt < PT; ++pt)
          mma_16816(acc[pt], ghi, bx[pt / 2][2 * (pt % 2)], bx[pt / 2][2 * (pt % 2) + 1]);
#pragma unroll
        for (int pt = 0; pt < PT; ++pt)
          mma_16816(acc[pt], glo, bx[pt / 2][2 * (pt % 2)], bx[pt / 2][2 * (pt % 2) + 1]);
      }
      if (diag) {
        // skip term from the diagonal tile's X rows (the query rows), then y
        const bf16* xl = xs + (il - i0) * LDX;
        const bf16* xh = xs + (ih - i0) * LDX;
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) {
          const int col = pt * 8 + c2;
          const float2 vl = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(xl + col));
          const float2 vh = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(xh + col));
          if (il < ch.qlen)
            *reinterpret_cast<uint32_t*>(yc + (size_t)il * xrow + col) =
                pack_bf16x2(acc[pt][0] + dskip * vl.x, acc[pt][1] + dskip * vl.y);
          if (ih < ch.qlen)
            *reinterpret_cast<uint32_t*>(yc + (size_t)ih * xrow + col) =
                pack_bf16x2(acc[pt][2] + dskip * vh.x, acc[pt][3] + dskip * vh.y);
        }
      }
    }
  }
}

template <int P, int N>
int launch_tc(const Params& p, int B, cudaStream_t st) {
  using L = TcSmem<P, N>;
  const size_t s1 = L::state_bytes(p.Q), s3 = L::output_bytes(p.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(s1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_output<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.nc * p.H, B);
  ssd_chunk_state<P, N><<<grid, kTcThreads, s1, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_state_pass<<<dim3((P * N / 4 + 255) / 256, B * p.H), 256, 0, st>>>(p, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_output<P, N><<<grid, kTcThreads, s3, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int launch_f32(const Params& p, int B, cudaStream_t st) {
  const size_t bytes = Smem<P, N>::bytes(p.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_f32<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_fwd_f32<P, N><<<dim3(p.H, B), kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int launch(const Params& p, int B, int is_bf16, cudaStream_t st) {
  return is_bf16 ? launch_tc<P, N>(p, B, st) : launch_f32<P, N>(p, B, st);
}

template <int P>
int launch_n(const Params& p, int B, int N, int is_bf16, cudaStream_t st) {
  switch (N) {
    case 16: return launch<P, 16>(p, B, is_bf16, st);
    case 32: return launch<P, 32>(p, B, is_bf16, st);
    case 64: return launch<P, 64>(p, B, is_bf16, st);
    case 128: return launch<P, 128>(p, B, is_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code (0 on success).
// is_bf16: 1 for bf16 x/B/C/y (three launches: chunk states, the state
// recurrence, outputs), 0 for fp32 (one launch). d, s0 and s_out may be
// null (no skip term, zero initial state, no final state). states
// (B, ceil(L / Q), H, P, N) and decay (B, ceil(L / Q), H) are fp32 scratch
// for the bf16 path (null for fp32). P and N must be one of 16, 32, 64,
// 128; 1 <= Q <= 1024; H % G == 0. The caller checks shapes, types,
// contiguity and, for bf16, 16-byte alignment of x, B and C.
int ssd_fwd(const void* x, const float* dt, const float* a, const void* b,
            const void* c, const float* d, const float* s0, void* y, float* s_out,
            float* states, float* decay, int B, int L, int H, int P, int G, int N, int Q,
            int is_bf16, void* stream) {
  if (Q < 1 || Q > kMaxChunk || G < 1 || H % G != 0 || L < 1 ||
      (is_bf16 && (states == nullptr || decay == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, a, b, c, d, s0, y, s_out, states, decay, L, H, G, Q, (L + Q - 1) / Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_n<16>(p, B, N, is_bf16, st);
    case 32: return launch_n<32>(p, B, N, is_bf16, st);
    case 64: return launch_n<64>(p, B, N, is_bf16, st);
    case 128: return launch_n<128>(p, B, N, is_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
