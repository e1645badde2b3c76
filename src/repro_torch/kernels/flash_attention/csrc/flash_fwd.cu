// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention): causal GQA attention with a
// blockwise online softmax, an aligned-end causal mask (query r sees keys
// <= r + (T - S)), an optional sliding window and an optional logit soft-cap
// softcap * tanh(s / softcap). Running max, sum and accumulator are fp32; the
// output is acc / max(l, 1e-30) in the input type.
//
// Layouts: q and o are (B, S, H, D), k and v are (B, T, K, D), all
// contiguous. Query head h reads kv head h / (H / K).
//
// What bounds it on the H100. At the serving prefill shape (B 8, S = T 1024,
// H 24, K 8, D 128, bf16) the causal work is about 51.5 GFLOP (52 us at
// 989 TFLOP/s) and the bytes each input and output need once are about
// 134 MB (40 us at 3.35 TB/s), so it is bound by tensor-core operations.
// The design does three things about that:
//   * the two products of each tile (Q K^T and P V) run on the tensor cores
//     as mma.sync m16n8k16 bf16 with fp32 accumulation; the score tile never
//     leaves registers (its accumulator layout is reused directly as the A
//     operand of P V);
//   * each block walks only the key tiles that its queries can see: the loop
//     starts at the window's first live tile and stops at the causal
//     frontier, where the TPU kernel visits every tile and skips the masked
//     ones with pl.when;
//   * the grid is (query tile, query head, batch) and the key sweep is a loop
//     inside the block, so the running max and sum are per-row registers
//     (reduced across the four threads that share a row), not the TPU's
//     lane-broadcast (bq, 128) scratch.
// It does not yet use wgmma, TMA or warp specialisation, and it does not
// overlap loads with compute; that is what separates it from the bound.
//
// Ragged edges: S and T need not divide the tile sizes; rows and keys past
// the end are masked here. The fp32 path runs in full fp32 on the CUDA
// cores (never TF32) and scales q after the load, as the TPU kernel does;
// the bf16 path multiplies the fp32 score by the scale, which is the same
// arithmetic up to rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// Start of the running max: the TPU kernel's NEG_INF. Masked scores are
// -inf, so exp(masked - m) is 0 and no NaN arises from -inf - -inf.
constexpr float kMaxInit = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, K;
  int causal;
  int window;      // <= 0: no window
  float softcap;   // <= 0: no soft-cap
  float scale;
};

__device__ __forceinline__ bool visible(const Params& p, int r, int t) {
  if (t >= p.T) return false;
  if (!p.causal) return true;
  const int last = r + (p.T - p.S);
  if (t > last) return false;
  return p.window <= 0 || t > last - p.window;
}

// Key range [t0, t1) that queries [q0, q1) can see, t0 rounded down to a tile.
__device__ __forceinline__ void key_range(const Params& p, int q0, int q1,
                                          int tile, int& t0, int& t1) {
  t0 = 0;
  t1 = p.T;
  if (p.causal) {
    const int shift = p.T - p.S;
    t1 = min(p.T, q1 + shift);
    if (p.window > 0) t0 = max(0, q0 + shift - p.window + 1);
  }
  t0 = (t0 / tile) * tile;
}

__device__ __forceinline__ float cap(const Params& p, float s) {
  return p.softcap > 0.f ? p.softcap * tanhf(s / p.softcap) : s;
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c += a * b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix with row stride
// `stride` into shared memory with row stride LD; rows at or past `nrows`
// are zero-filled. 16-byte loads: the wrapper checks the alignment.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int nrows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// bf16: 4 warps, 16 query rows each, 64-key tiles, D in {32, 64, 128}.
// Thread (g = lane / 4, c = lane % 4) holds rows g and g + 8 of its warp's
// slice, columns 2c and 2c + 1 of every 8-wide tile (the mma C layout).
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  constexpr int BQ = 64, BK = 64, LD = D + 8;
  constexpr int NKD = D / 16;   // k-steps of Q K^T
  constexpr int NOT = D / 8;    // 8-wide output tiles
  constexpr int NST = BK / 8;   // 8-wide score tiles
  __shared__ __align__(16) bf16 ks[BK * LD];
  __shared__ __align__(16) bf16 vs[BK * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = (lane % 4) * 2;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.K * D;
  const bf16* qb = static_cast<const bf16*>(p.q) + ((size_t)b * p.S * p.H + h) * D;
  const bf16* kb = static_cast<const bf16*>(p.k) + ((size_t)b * p.T * p.K + kh) * D;
  const bf16* vb = static_cast<const bf16*>(p.v) + ((size_t)b * p.T * p.K + kh) * D;
  bf16* ob = static_cast<bf16*>(p.o) + ((size_t)b * p.S * p.H + h) * D;

  // Q tile through shared memory (ks doubles as its staging buffer) into
  // A fragments held for the whole sweep.
  load_rows<BQ, D, LD>(ks, qb, q_stride, q0, p.S);
  __syncthreads();
  const int row = warp * 16 + g;
  uint32_t qf[NKD][4];
#pragma unroll
  for (int kk = 0; kk < NKD; ++kk) {
    const bf16* q_lo = ks + row * LD + kk * 16 + c2;
    const bf16* q_hi = q_lo + 8 * LD;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(q_lo);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(q_hi);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(q_lo + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(q_hi + 8);
  }
  __syncthreads();

  float acc[NOT][4];
#pragma unroll
  for (int j = 0; j < NOT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kMaxInit, kMaxInit}, l[2] = {0.f, 0.f};
  const int r_lo = q0 + row, r_hi = r_lo + 8;

  int t_begin, t_end;
  key_range(p, q0, min(q0 + BQ, p.S), BK, t_begin, t_end);
  for (int t0 = t_begin; t0 < t_end; t0 += BK) {
    load_rows<BK, D, LD>(ks, kb, kv_stride, t0, p.T);
    load_rows<BK, D, LD>(vs, vb, kv_stride, t0, p.T);
    __syncthreads();

    float s[NST][4];
#pragma unroll
    for (int j = 0; j < NST; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* k_row = ks + (j * 8 + g) * LD + c2;
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(k_row + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(k_row + kk * 16 + 8);
        mma_16816(s[j], qf[kk], b0, b1);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r_lo : r_hi;
        const int t = t0 + j * 8 + c2 + (e & 1);
        const float x = visible(p, r, t) ? cap(p, s[j][e] * p.scale) : -INFINITY;
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[j][e] - m[e / 2]);
        s[j][e] = pe;
        rs[e / 2] += pe;
      }
    }
    // l holds this thread's partial row sums; alpha is uniform per row, so
    // the four partials are reduced once, after the sweep.
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int j = 0; j < NOT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_floats(s[2 * kk][0], s[2 * kk][1]),
          pack_floats(s[2 * kk][2], s[2 * kk][3]),
          pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const bf16* v_col = vs + (kk * 16 + c2) * LD + g;
#pragma unroll
      for (int j = 0; j < NOT; ++j) {
        const bf16* v0 = v_col + j * 8;
        const uint32_t b0 = pack_bf16(v0[0], v0[LD]);
        const uint32_t b1 = pack_bf16(v0[8 * LD], v0[9 * LD]);
        mma_16816(acc[j], a, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < NOT; ++j) {
    if (r_lo < p.S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_lo * q_stride + j * 8 + c2) =
          pack_floats(acc[j][0] / l[0], acc[j][1] / l[0]);
    if (r_hi < p.S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r_hi * q_stride + j * 8 + c2) =
          pack_floats(acc[j][2] / l[1], acc[j][3] / l[1]);
  }
}

// fp32: 4 warps, 4 query rows each, 32-key tiles. Lane j scores key j of the
// tile; for the accumulator, lane i owns columns i, i + 32, ... of the row.
template <int D>
__global__ void __launch_bounds__(128) flash_fwd_f32(Params p) {
  constexpr int BQ = 16, BK = 32, RPW = BQ / 4, NV = D / 32;
  __shared__ float qs[BQ][D];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.K * D;
  const float* qb = static_cast<const float*>(p.q) + ((size_t)b * p.S * p.H + h) * D;
  const float* kb = static_cast<const float*>(p.k) + ((size_t)b * p.T * p.K + kh) * D;
  const float* vb = static_cast<const float*>(p.v) + ((size_t)b * p.T * p.K + kh) * D;
  float* ob = static_cast<float*>(p.o) + ((size_t)b * p.S * p.H + h) * D;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    qs[r][d] = q0 + r < p.S ? qb[(size_t)(q0 + r) * q_stride + d] * p.scale : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][NV];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kMaxInit;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[rr][i] = 0.f;
  }

  int t_begin, t_end;
  key_range(p, q0, min(q0 + BQ, p.S), BK, t_begin, t_end);
  for (int t0 = t_begin; t0 < t_end; t0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const bool in = t0 + r < p.T;
      ks[r][d] = in ? kb[(size_t)(t0 + r) * kv_stride + d] : 0.f;
      vs[r][d] = in ? vb[(size_t)(t0 + r) * kv_stride + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int row = warp * RPW + rr, r = q0 + row, t = t0 + lane;
      float x = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) x = fmaf(qs[row][d], ks[lane][d], x);
      x = visible(p, r, t) ? cap(p, x) : -INFINITY;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - m_new);
      const float pe = expf(x - m_new);
      float ps = pe;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[rr] = l[rr] * alpha + ps;
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[rr][i] *= alpha;
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pe, j);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[rr][i] = fmaf(pj, vs[j][lane + 32 * i], acc[rr][i]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
    if (r >= p.S) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i) ob[(size_t)r * q_stride + lane + 32 * i] = acc[rr][i] / denom;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// is_bf16: 1 for bf16 inputs, 0 for fp32. window <= 0 and softcap <= 0 mean
// "none". The caller checks shapes, types, contiguity and 16-byte alignment.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int K, int D, int is_bf16,
                        int causal, int window, float softcap, float scale,
                        void* stream) {
  Params p{q, k, v, o, S, T, H, K, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((S + 63) / 64, H, B);
    switch (D) {
      case 32: flash_fwd_bf16<32><<<grid, 128, 0, st>>>(p); break;
      case 64: flash_fwd_bf16<64><<<grid, 128, 0, st>>>(p); break;
      case 128: flash_fwd_bf16<128><<<grid, 128, 0, st>>>(p); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    const dim3 grid((S + 15) / 16, H, B);
    switch (D) {
      case 32: flash_fwd_f32<32><<<grid, 128, 0, st>>>(p); break;
      case 64: flash_fwd_f32<64><<<grid, 128, 0, st>>>(p); break;
      case 128: flash_fwd_f32<128><<<grid, 128, 0, st>>>(p); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
