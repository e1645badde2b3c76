// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// The JAX package has no TPU kernel for this: its training differentiates
// chunked_attention through XLA, and its Pallas kernel
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel) is a forward
// only. The port's attention runs the hand-written forward (flash_fwd.cu)
// on the card, so its gradient is a hand-written kernel too. It takes what
// the forward takes: causal GQA attention with aligned ends (query r sees
// keys <= r + (T - S)), an optional sliding window and an optional logit
// soft-cap softcap * tanh(s / softcap), D in {32, 64, 128}, bf16 or fp32.
//
// Inputs q, o, dO (B, S, H, D); k, v (B, T, K, D); lse (B, H, S) fp32, the
// natural-log log-sum-exp of each row's scaled, soft-capped and masked
// scores that the forward writes. Outputs dq (B, S, H, D), dk, dv
// (B, T, K, D) in the input type. All contiguous, 16-byte aligned. Query
// head h reads kv head h / (H / K).
//
// With x = scale q.k, s = softcap tanh(x / softcap) (or x), P = exp(s - lse)
// on visible pairs and 0 elsewhere, and Delta = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta) o (1 - tanh^2(x / softcap)),
//   dQ = scale dS K,  dK = scale dS^T Q.
// Three launches on the caller's stream, all deterministic (no atomics):
//   1. flash_bwd_preprocess: Delta (B, H, S) fp32, one warp per row;
//   2. flash_bwd_dkdv: one block per (b, kv head, 64-key tile); it walks
//      the query heads of its GQA group and, for each, the 32-row query
//      tiles that see the key tile (the causal frontier and the window
//      bound the range, as in the forward). dK and dV of its 64 keys sum
//      over the group in registers and are written once;
//   3. flash_bwd_dq: one block per (b, h, 64-query tile), walking the live
//      64-key tiles; dQ sums in registers and is written once.
// Masked pairs get P = 0 by selection, never by multiplying with a mask:
// exp above the diagonal can overflow, and 0 * inf is NaN.
//
// What bounds it on the H100. At the training shape of llama3.2-3b (B 2,
// S = T 2048, H 24, K 8, D 128, bf16, causal) the backward does five
// S x T x D products over the visible pairs, about 129 GFLOP (130 us at
// 989 TFLOP/s), against about 270 MB of inputs and outputs (80 us at
// 3.35 TB/s): it is bound by tensor-core operations. This first design is
// simple and right rather than fast: every product is mma.sync m16n8k16
// bf16 with fp32 accumulation (not wgmma, which alone reaches the full
// rate), operands from padded shared memory by ldmatrix(.trans), tiles
// double-buffered by cp.async, four warps per block, each owning 16 keys
// (dkdv) or 16 query rows (dq). S and dP are recomputed in both passes.
// The fp32 path runs on the CUDA cores (never TF32).

#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, S, T, H, K;
  int causal;
  int window;      // <= 0: no window
  float softcap;   // <= 0: no soft-cap
  float scale;
};

using flash_mask::key_range;
using flash_mask::query_range;

__device__ __forceinline__ bool visible(const Params& p, int r, int t) {
  return flash_mask::visible<true>(p, r, t);
}

// Score of a raw product acc = q.k: returns s (scaled and soft-capped) and
// sets dcap = ds/dx of the soft-cap at x = scale acc (1 without one).
__device__ __forceinline__ float score(const Params& p, float acc, float& dcap) {
  const float x = acc * p.scale;
  if (p.softcap > 0.f) {
    const float th = tanhf(x / p.softcap);
    dcap = 1.f - th * th;
    return p.softcap * th;
  }
  dcap = 1.f;
  return x;
}

// ---- 1. Delta = rowsum(dO o O) ---------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_preprocess(Params p) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= p.B * p.S * p.H) return;
  // row = (b * S + s) * H + h, the (B, S, H) order of o and dO
  const T* o = static_cast<const T*>(p.o) + (size_t)row * D;
  const T* g = static_cast<const T*>(p.dout) + (size_t)row * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % p.H, s = (row / p.H) % p.S, b = row / (p.H * p.S);
    p.delta[((size_t)b * p.H + h) * p.S + s] = acc;
  }
}

// ---- bf16: mma.sync m16n8k16 -------------------------------------------------

constexpr int kPad = 8;   // bf16 row padding: ldmatrix rows land in distinct banks

// rows x D bf16 tile from global (row stride `stride` elements) into shared
// memory with rows of D + kPad, by cp.async; rows >= valid are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride, int rows,
                                          int valid) {
  constexpr int CH = D / 8;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = r < valid;
    cp_async_16(dst + r * (D + kPad) + c, in ? src + (size_t)r * stride + c : src, in ? 16 : 0);
  }
}

// acc (16 x 8 n-tiles of NT) += A (16 rows at `a` of the warp, all D columns)
// times B^T, B being NT * 8 rows at `b`: both tiles row-major with rows of
// D + kPad, so A is read by ldmatrix and B (n-rows, k contiguous) by
// ldmatrix as the column-major operand.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a, const bf16* b,
                                        int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane % 8 + ((lane / 8) % 2) * 8) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, b + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                           ((lane / 8) % 2) * 8);
      mma_16816(acc[2 * np], af, bfr[0], bfr[1]);
      mma_16816(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// acc (16 x D) += A B, A (16 x 16 KT) given as accumulator fragments of n-tiles
// (fp32, rounded to bf16 here), B (16 KT x D) row-major at `b` with rows of
// D + kPad, read by ldmatrix.trans.
template <int D, int KT>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const float (&a)[2 * KT][4],
                                       const bf16* b, int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t af[4] = {pack_bf16x2(a[2 * kt][0], a[2 * kt][1]),
                            pack_bf16x2(a[2 * kt][2], a[2 * kt][3]),
                            pack_bf16x2(a[2 * kt + 1][0], a[2 * kt + 1][1]),
                            pack_bf16x2(a[2 * kt + 1][2], a[2 * kt + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, b + (kt * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + nd * 16 +
                                 (lane / 16) * 8);
      mma_16816(acc[2 * nd], af, bfr[0], bfr[1]);
      mma_16816(acc[2 * nd + 1], af, bfr[2], bfr[3]);
    }
  }
}

// Stores a warp's 16 x D fp32 accumulator (times `mul`) as bf16 rows
// row_lo, row_lo + 8 of `out` (row stride `stride`), rows >= limit dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, size_t stride, const float (&acc)[D / 8][4],
                                           int row_lo, int limit, float mul, int lane) {
  const int c2 = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row_lo < limit)
      *reinterpret_cast<uint32_t*>(out + (size_t)row_lo * stride + j * 8 + c2) =
          pack_bf16x2(acc[j][0] * mul, acc[j][1] * mul);
    if (row_lo + 8 < limit)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row_lo + 8) * stride + j * 8 + c2) =
          pack_bf16x2(acc[j][2] * mul, acc[j][3] * mul);
  }
}

constexpr int kKeys = 64;      // dkdv: keys per block, 16 per warp
constexpr int kQTile = 32;     // dkdv: query rows per step
constexpr int kRows = 64;      // dq: query rows per block, 16 per warp
constexpr int kKTile = 64;     // dq: keys per step

template <int D>
struct DkdvLayout {
  static constexpr int LD = D + kPad;
  static constexpr int KV = kKeys * LD;          // elements of the K (or V) tile
  static constexpr int QT = kQTile * LD;         // elements of a Q (or dO) tile
  static constexpr int BYTES = (2 * KV + 2 * 2 * QT) * 2 + 2 * 2 * kQTile * 4;
};

// 2. dK, dV of 64 keys of one (b, kv head), summed over the GQA group.
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkdv(Params p) {
  using Lay = DkdvLayout<D>;
  constexpr int LD = Lay::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + Lay::KV;
  bf16* qs = vs + Lay::KV;            // [stage][kQTile][LD]
  bf16* gs = qs + 2 * Lay::QT;        // dO, the same
  float* lse_s = reinterpret_cast<float*>(gs + 2 * Lay::QT);   // [stage][kQTile], times log2(e)
  float* dl_s = lse_s + 2 * kQTile;                            // [stage][kQTile]

  const int t0 = blockIdx.x * kKeys, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = p.H / p.K;
  const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.K * D;
  const int t1 = min(p.T, t0 + kKeys);
  int r_begin, r_end;
  query_range(p, t0, t1, kQTile, r_begin, r_end);
  const int n_q = r_end > r_begin ? (r_end - r_begin + kQTile - 1) / kQTile : 0;
  const int n_items = n_q * group;

  const size_t kv_off = ((size_t)b * p.T + t0) * kv_stride + (size_t)kh * D;
  load_tile<D>(ks, static_cast<const bf16*>(p.k) + kv_off, kv_stride, kKeys, t1 - t0);
  load_tile<D>(vs, static_cast<const bf16*>(p.v) + kv_off, kv_stride, kKeys, t1 - t0);

  // item i: query head kh * group + i / n_q, query tile r_begin + (i % n_q) * kQTile
  auto prefetch = [&](int i) {
    const int st = i % 2, h = kh * group + i / n_q, r0 = r_begin + (i % n_q) * kQTile;
    const size_t off = ((size_t)b * p.S + r0) * q_stride + (size_t)h * D;
    const int valid = min(kQTile, p.S - r0);
    load_tile<D>(qs + st * Lay::QT, static_cast<const bf16*>(p.q) + off, q_stride, kQTile, valid);
    load_tile<D>(gs + st * Lay::QT, static_cast<const bf16*>(p.dout) + off, q_stride, kQTile,
                 valid);
    for (int r = threadIdx.x; r < kQTile; r += blockDim.x) {
      const size_t row = ((size_t)b * p.H + h) * p.S + r0 + r;
      const bool in = r0 + r < p.S;
      lse_s[st * kQTile + r] = in ? p.lse[row] * kLog2e : 0.f;
      dl_s[st * kQTile + r] = in ? p.delta[row] : 0.f;
    }
  };
  if (n_items > 0) prefetch(0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int key_lo = t0 + 16 * warp + lane / 4, c2 = (lane % 4) * 2;
  const bf16* kw = ks + 16 * warp * LD;
  const bf16* vw = vs + 16 * warp * LD;
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = i % 2, r0 = r_begin + (i % n_q) * kQTile;
    const bf16* qt = qs + st * Lay::QT;
    const bf16* gt = gs + st * Lay::QT;

    // S^T and dP^T for the warp's 16 keys x 32 queries
    float s[kQTile / 8][4], dp[kQTile / 8][4];
#pragma unroll
    for (int n = 0; n < kQTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, kQTile / 8>(s, kw, qt, lane);
    mma_abt<D, kQTile / 8>(dp, vw, gt, lane);
    // P^T (kept in dp's place) and dS^T (in s's place)
#pragma unroll
    for (int n = 0; n < kQTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key_lo : key_lo + 8, rl = n * 8 + c2 + (e & 1);
        float dcap;
        const float sc = score(p, s[n][e], dcap);
        const float pe = visible(p, r0 + rl, key)
                             ? ex2_approx(fmaf(sc, kLog2e, -lse_s[st * kQTile + rl]))
                             : 0.f;
        s[n][e] = pe * (dp[n][e] - dl_s[st * kQTile + rl]) * dcap;
        dp[n][e] = pe;
      }
    mma_ab<D, kQTile / 16>(dv, dp, gt, lane);   // dV += P^T dO
    mma_ab<D, kQTile / 16>(dk, s, qt, lane);    // dK += dS^T Q
    __syncthreads();   // the stage is refilled by item i + 2's loads
  }
  cp_async_wait<0>();

  const size_t out_off = ((size_t)b * p.T) * kv_stride + (size_t)kh * D;
  store_rows<D>(static_cast<bf16*>(p.dk) + out_off, kv_stride, dk, key_lo, p.T, p.scale, lane);
  store_rows<D>(static_cast<bf16*>(p.dv) + out_off, kv_stride, dv, key_lo, p.T, 1.f, lane);
}

template <int D>
struct DqLayout {
  static constexpr int LD = D + kPad;
  static constexpr int QT = kRows * LD;    // the Q (or dO) tile
  static constexpr int KT = kKTile * LD;   // a K (or V) tile
  static constexpr int BYTES = (2 * QT + 2 * 2 * KT) * 2;
};

// 3. dQ of 64 query rows of one (b, h).
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq(Params p) {
  using Lay = DqLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + Lay::QT;
  bf16* ks = gs + Lay::QT;          // [stage][kKTile][LD]
  bf16* vs = ks + 2 * Lay::KT;      // the same

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.K * D;
  int t_begin, t_end;
  key_range(p, q0, min(q0 + kRows, p.S), kKTile, t_begin, t_end);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kKTile - 1) / kKTile : 0;

  const size_t q_off = ((size_t)b * p.S + q0) * q_stride + (size_t)h * D;
  load_tile<D>(qs, static_cast<const bf16*>(p.q) + q_off, q_stride, kRows, p.S - q0);
  load_tile<D>(gs, static_cast<const bf16*>(p.dout) + q_off, q_stride, kRows, p.S - q0);
  auto prefetch = [&](int i) {
    const int st = i % 2, t0 = t_begin + i * kKTile;
    const size_t off = ((size_t)b * p.T + t0) * kv_stride + (size_t)kh * D;
    load_tile<D>(ks + st * Lay::KT, static_cast<const bf16*>(p.k) + off, kv_stride, kKTile,
                 p.T - t0);
    load_tile<D>(vs + st * Lay::KT, static_cast<const bf16*>(p.v) + off, kv_stride, kKTile,
                 p.T - t0);
  };
  if (n_tiles > 0) prefetch(0);
  cp_async_commit();

  const int row_lo = q0 + 16 * warp + lane / 4, c2 = (lane % 4) * 2;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const size_t idx = ((size_t)b * p.H + h) * p.S + row;
    lse2[r] = row < p.S ? p.lse[idx] * kLog2e : 0.f;
    dl[r] = row < p.S ? p.delta[idx] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const bf16* qw = qs + 16 * warp * Lay::LD;
  const bf16* gw = gs + 16 * warp * Lay::LD;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = i % 2, t0 = t_begin + i * kKTile;
    const bf16* kt = ks + st * Lay::KT;
    const bf16* vt = vs + st * Lay::KT;

    float s[kKTile / 8][4], dp[kKTile / 8][4];
#pragma unroll
    for (int n = 0; n < kKTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, kKTile / 8>(s, qw, kt, lane);    // S = Q K^T
    mma_abt<D, kKTile / 8>(dp, gw, vt, lane);   // dP = dO V^T
#pragma unroll
    for (int n = 0; n < kKTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = t0 + n * 8 + c2 + (e & 1);
        float dcap;
        const float sc = score(p, s[n][e], dcap);
        const float pe = visible(p, row_lo + 8 * r, key) ? ex2_approx(fmaf(sc, kLog2e, -lse2[r]))
                                                         : 0.f;
        s[n][e] = pe * (dp[n][e] - dl[r]) * dcap;   // dS
      }
    mma_ab<D, kKTile / 16>(dq, s, kt, lane);   // dQ += dS K
    __syncthreads();
  }
  cp_async_wait<0>();

  store_rows<D>(static_cast<bf16*>(p.dq) + ((size_t)b * p.S) * q_stride + (size_t)h * D, q_stride,
                dq, row_lo, p.S, p.scale, lane);
}

// ---- fp32: CUDA cores ---------------------------------------------------------

constexpr int kF32Keys = 32;   // dkdv: keys per block, 8 per warp
constexpr int kF32Rows = 32;   // dkdv: query rows per step (lane j: row j)
constexpr int kF32QRows = 16;  // dq: query rows per block, 4 per warp
constexpr int kF32KTile = 32;  // dq: keys per step (lane j: key j)

// dK, dV of 32 keys; warp w owns keys 8w..8w+7, lane i columns i, i + 32, ...
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_f32(Params p) {
  constexpr int LD = D + 1, NV = D / 32, KPW = kF32Keys / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);   // [kF32Keys][LD]
  float* vs = ks + kF32Keys * LD;
  float* qs = vs + kF32Keys * LD;                   // [kF32Rows][LD]
  float* gs = qs + kF32Rows * LD;

  const int t0 = blockIdx.x * kF32Keys, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = p.H / p.K;
  const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.K * D;
  const float* kb = static_cast<const float*>(p.k) + ((size_t)b * p.T * p.K + kh) * D;
  const float* vb = static_cast<const float*>(p.v) + ((size_t)b * p.T * p.K + kh) * D;
  for (int i = threadIdx.x; i < kF32Keys * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const bool in = t0 + r < p.T;
    ks[r * LD + d] = in ? kb[(size_t)(t0 + r) * kv_stride + d] : 0.f;
    vs[r * LD + d] = in ? vb[(size_t)(t0 + r) * kv_stride + d] : 0.f;
  }
  float dk[KPW][NV], dv[KPW][NV];
#pragma unroll
  for (int j = 0; j < KPW; ++j)
#pragma unroll
    for (int c = 0; c < NV; ++c) dk[j][c] = dv[j][c] = 0.f;

  int r_begin, r_end;
  query_range(p, t0, min(p.T, t0 + kF32Keys), kF32Rows, r_begin, r_end);
  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    const float* qb = static_cast<const float*>(p.q) + ((size_t)b * p.S * p.H + h) * D;
    const float* gb = static_cast<const float*>(p.dout) + ((size_t)b * p.S * p.H + h) * D;
    for (int r0 = r_begin; r0 < r_end; r0 += kF32Rows) {
      __syncthreads();
      for (int i = threadIdx.x; i < kF32Rows * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        const bool in = r0 + r < p.S;
        qs[r * LD + d] = in ? qb[(size_t)(r0 + r) * q_stride + d] : 0.f;
        gs[r * LD + d] = in ? gb[(size_t)(r0 + r) * q_stride + d] : 0.f;
      }
      __syncthreads();
      const int r = r0 + lane;
      const size_t row = ((size_t)b * p.H + h) * p.S + r;
      const float lse = r < p.S ? p.lse[row] : 0.f;
      const float dl = r < p.S ? p.delta[row] : 0.f;
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        const int kl = warp * KPW + j, key = t0 + kl;
        float acc = 0.f, dpv = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          acc = fmaf(qs[lane * LD + d], ks[kl * LD + d], acc);
          dpv = fmaf(gs[lane * LD + d], vs[kl * LD + d], dpv);
        }
        float dcap;
        const float sc = score(p, acc, dcap);
        const float pe = visible(p, r, key) ? expf(sc - lse) : 0.f;
        const float ds = pe * (dpv - dl) * dcap;
        for (int jj = 0; jj < kF32Rows; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, pe, jj);
          const float dj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
          for (int c = 0; c < NV; ++c) {
            dv[j][c] = fmaf(pj, gs[jj * LD + lane + 32 * c], dv[j][c]);
            dk[j][c] = fmaf(dj, qs[jj * LD + lane + 32 * c], dk[j][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const int key = t0 + warp * KPW + j;
    if (key >= p.T) continue;
    float* dko = static_cast<float*>(p.dk) + (((size_t)b * p.T + key) * p.K + kh) * D;
    float* dvo = static_cast<float*>(p.dv) + (((size_t)b * p.T + key) * p.K + kh) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      dko[lane + 32 * c] = dk[j][c] * p.scale;
      dvo[lane + 32 * c] = dv[j][c];
    }
  }
}

// dQ of 16 query rows; warp w owns rows 4w..4w+3, lane i columns i, i + 32, ...
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32(Params p) {
  constexpr int LD = D + 1, NV = D / 32, RPW = kF32QRows / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [kF32QRows][D]
  float* gs = qs + kF32QRows * D;
  float* ks = gs + kF32QRows * D;                   // [kF32KTile][LD]
  float* vs = ks + kF32KTile * LD;

  const int q0 = blockIdx.x * kF32QRows, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.K * D;
  const float* qb = static_cast<const float*>(p.q) + ((size_t)b * p.S * p.H + h) * D;
  const float* gb = static_cast<const float*>(p.dout) + ((size_t)b * p.S * p.H + h) * D;
  const float* kb = static_cast<const float*>(p.k) + ((size_t)b * p.T * p.K + kh) * D;
  const float* vb = static_cast<const float*>(p.v) + ((size_t)b * p.T * p.K + kh) * D;
  for (int i = threadIdx.x; i < kF32QRows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const bool in = q0 + r < p.S;
    qs[i] = in ? qb[(size_t)(q0 + r) * q_stride + d] : 0.f;
    gs[i] = in ? gb[(size_t)(q0 + r) * q_stride + d] : 0.f;
  }
  float lse[RPW], dl[RPW], dq[RPW][NV];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
    const size_t row = ((size_t)b * p.H + h) * p.S + r;
    lse[rr] = r < p.S ? p.lse[row] : 0.f;
    dl[rr] = r < p.S ? p.delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) dq[rr][c] = 0.f;
  }

  int t_begin, t_end;
  key_range(p, q0, min(q0 + kF32QRows, p.S), kF32KTile, t_begin, t_end);
  for (int t0 = t_begin; t0 < t_end; t0 += kF32KTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32KTile * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const bool in = t0 + r < p.T;
      ks[r * LD + d] = in ? kb[(size_t)(t0 + r) * kv_stride + d] : 0.f;
      vs[r * LD + d] = in ? vb[(size_t)(t0 + r) * kv_stride + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int rl = warp * RPW + rr, r = q0 + rl, t = t0 + lane;
      float acc = 0.f, dpv = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        acc = fmaf(qs[rl * D + d], ks[lane * LD + d], acc);
        dpv = fmaf(gs[rl * D + d], vs[lane * LD + d], dpv);
      }
      float dcap;
      const float sc = score(p, acc, dcap);
      const float pe = visible(p, r, t) ? expf(sc - lse[rr]) : 0.f;
      const float ds = pe * (dpv - dl[rr]) * dcap;
      for (int j = 0; j < kF32KTile; ++j) {
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < NV; ++c) dq[rr][c] = fmaf(dj, ks[j * LD + lane + 32 * c], dq[rr][c]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = q0 + warp * RPW + rr;
    if (r >= p.S) continue;
    float* out = static_cast<float*>(p.dq) + ((size_t)(b * p.S + r) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c) out[lane + 32 * c] = dq[rr][c] * p.scale;
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int bytes, const Params& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 128, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_all(const Params& p, int is_bf16, cudaStream_t st) {
  const int rows = p.B * p.S * p.H;
  if (is_bf16)
    flash_bwd_preprocess<bf16, D><<<(rows + 7) / 8, 256, 0, st>>>(p);
  else
    flash_bwd_preprocess<float, D><<<(rows + 7) / 8, 256, 0, st>>>(p);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  if (is_bf16) {
    rc = launch(flash_bwd_dkdv<D>, dim3((p.T + kKeys - 1) / kKeys, p.K, p.B),
                DkdvLayout<D>::BYTES, p, st);
    if (rc == 0)
      rc = launch(flash_bwd_dq<D>, dim3((p.S + kRows - 1) / kRows, p.H, p.B),
                  DqLayout<D>::BYTES, p, st);
    return rc;
  }
  rc = launch(flash_bwd_dkdv_f32<D>, dim3((p.T + kF32Keys - 1) / kF32Keys, p.K, p.B),
              (2 * kF32Keys + 2 * kF32Rows) * (D + 1) * 4, p, st);
  if (rc == 0)
    rc = launch(flash_bwd_dq_f32<D>, dim3((p.S + kF32QRows - 1) / kF32QRows, p.H, p.B),
                (2 * kF32QRows * D + 2 * kF32KTile * (D + 1)) * 4, p, st);
  return rc;
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` and returns a CUDA error code (0 on
// success). is_bf16: 1 for bf16 tensors, 0 for fp32. window <= 0 and
// softcap <= 0 mean "none". delta is an fp32 (B, H, S) scratch. The caller
// checks shapes, types, contiguity and 16-byte alignment.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
                        void* dv, int B, int S, int T, int H, int K, int D, int is_bf16,
                        int causal, int window, float softcap, float scale, void* stream) {
  Params p{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
           dq, dk, dv, B, S, T, H, K, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_all<32>(p, is_bf16, st);
    case 64: return launch_all<64>(p, is_bf16, st);
    case 128: return launch_all<128>(p, is_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
