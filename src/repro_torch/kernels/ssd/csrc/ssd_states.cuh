// What the SSD forward (ssd_fwd.cu) and backward (ssd_bwd.cu) share: the
// chunk geometry, the chunk's fp64 cumsum, cp.async tile loads, the
// chunk-state product on the tensor cores and the batched recurrence over
// the chunks. Both sources include it; kernels/cuda_build.py hashes it into
// both libraries' tags. Everything here has internal linkage: each library
// holds its own copy of the kernels.
//
// The chunk-state product of chunk z (Q rows, cum = cumsum(dt * a) over the
// chunk in fp64) is the (P, N) sum over its rows j of s_j u_j v_j^T, with u
// from a (B, L, H, P) bf16 array and v from a (B, L, G, N) one:
//   kScaleToEnd:     s_j = exp(cum_last - cum_j) dt_j  (u = x, v = B: the
//                    chunk's local state; also writes exp(cum_last));
//   kScaleFromStart: s_j = exp(cum_j)                  (u = dy, v = C: the
//                    local term of the state's gradient).
// The recurrence runs over those per-chunk terms, forward
// (S_z = S_{z-1} exp(cum_last_z) + local_z) or in reverse
// (G_{z-1} = local_z + exp(cum_last_z) G_z).

#pragma once

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;         // rows of a query or key tile
constexpr int kTcThreads = 128;   // 4 warps, one per 16 rows of a tile
constexpr double kLog2eD = 1.4426950408889634;
constexpr int kPad = 8;           // bf16 row padding: the 8 rows an ldmatrix
                                  // reads start in 8 different bank groups

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The chunk a block works on: blockIdx.x = (z * H + h) * tiles + tile (the
// heads of one chunk are neighbours and share its B and C rows in L2),
// blockIdx.y = b.
struct Chunk {
  int h, z, b, g, tile, c0, qlen, qpad;
  size_t row0;   // token row of the chunk's first row in (B * L)
  size_t bzh;    // (b, z, h) in (B, chunks, H)
  __device__ Chunk(int L, int H, int G, int Q, int tiles) {
    tile = blockIdx.x % tiles;
    const int zh = blockIdx.x / tiles;
    h = zh % H;
    z = zh / H;
    b = blockIdx.y;
    g = h / (H / G);
    c0 = z * Q;
    qlen = min(Q, L - c0);
    qpad = round_up(qlen, kTile);
    row0 = (size_t)b * L + c0;
    bzh = ((size_t)b * ((L + Q - 1) / Q) + z) * H + h;
  }
};

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
// by cp.async from a block of THREADS; rows at or past `nrows` are
// zero-filled.
template <int W, int THREADS = kTcThreads>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, size_t stride,
                                                int row0, int nrows) {
  constexpr int CH = W / 8;   // 16-byte pieces per row
  for (int e = threadIdx.x; e < kTile * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const bool in = row0 + r < nrows;
    cp_async_16(dst + r * (W + kPad) + c * 8,
                in ? src + (size_t)(row0 + r) * stride + c * 8 : src, in ? 16 : 0);
  }
}

// An fp32 (P, N) state into shared memory as bf16 hi and lo parts with row
// stride N + kPad, by a block of THREADS, float4 loads.
template <int P, int N, int THREADS = kTcThreads>
__device__ __forceinline__ void load_state_split(bf16* hi, bf16* lo, const float* src) {
  const float4* sp = reinterpret_cast<const float4*>(src);
  for (int e = threadIdx.x; e < P * N / 4; e += THREADS) {
    const float4 v = sp[e];
    const int r = e * 4 / N, n = e * 4 % N;
    uint32_t* h = reinterpret_cast<uint32_t*>(hi + r * (N + kPad) + n);
    uint32_t* l = reinterpret_cast<uint32_t*>(lo + r * (N + kPad) + n);
    split_bf16x2(v.x, v.y, h[0], l[0]);
    split_bf16x2(v.z, v.w, h[1], l[1]);
  }
}

// ---- the chunk-state product -----------------------------------------------

constexpr int kScaleToEnd = 0;
constexpr int kScaleFromStart = 1;

struct StateArgs {
  const bf16* u;      // (B, L, H, P): x or dy
  const bf16* v;      // (B, L, G, N): B or C
  const float* dt;    // (B, L, H)
  const float* a;     // (H,)
  float* out;         // (B, chunks, H, P, N)
  float* decay;       // (B, chunks, H): exp(cum_last); kScaleToEnd only
  int L, H, G, Q;
};

template <int P, int N>
struct StateSmem {
  static constexpr int LDU = P + kPad, LDV = N + kPad;
  // Blocks an SM ptxas must fit: at P 128 one (up to 255 registers), where
  // its own choice of 168 spills; elsewhere three (up to 168), which the
  // smem of a 256-row chunk allows and every P <= 64 kernel fits.
  static constexpr int MIN_BLOCKS = P == 128 ? 1 : 3;
  // cum (fp64), dt, s; two U and two V tiles
  static size_t bytes(int q) {
    return 16 * (size_t)round_up(q, kTile) + 2 * (size_t)kTile * (LDU + LDV) * 2;
  }
};

// One block per (b, h, chunk): sum_j s_j u_j v_j^T as a (P, N) product over
// the chunk's rows, A = (s u)^T from the U tile by ldmatrix.trans, split
// hi + lo (s u is fp32), B from the V tile by ldmatrix.trans; tiles
// double-buffered by cp.async. Warps tile the (P, N) output WM x WN.
template <int P, int N, int SCALE>
__global__ void __launch_bounds__(kTcThreads, StateSmem<P, N>::MIN_BLOCKS)
    ssd_chunk_state(StateArgs p) {
  using L = StateSmem<P, N>;
  constexpr int LDU = L::LDU, LDV = L::LDV;
  constexpr int WM = P / 16 < 4 ? P / 16 : 4;
  constexpr int WN = 4 / WM < N / 16 ? 4 / WM : N / 16;
  constexpr int MT = P / 16 / WM;   // 16-row tiles of P per warp
  constexpr int NT = N / 8 / WN;    // 8-column tiles of N per warp (even)
  extern __shared__ __align__(16) unsigned char smem[];
  const Chunk ch(p.L, p.H, p.G, p.Q, 1);
  double* s_cum = reinterpret_cast<double*>(smem);
  float* s_dt = reinterpret_cast<float*>(s_cum + ch.qpad);
  float* s_s = s_dt + ch.qpad;
  bf16* s_u = reinterpret_cast<bf16*>(s_s + ch.qpad);
  bf16* s_v = s_u + 2 * kTile * LDU;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t urow = (size_t)p.H * P, vrow = (size_t)p.G * N;
  const bf16* uc = p.u + ch.row0 * urow + (size_t)ch.h * P;
  const bf16* vc = p.v + ch.row0 * vrow + (size_t)ch.g * N;

  load_tile_async<P>(s_u, uc, urow, 0, ch.qlen);
  load_tile_async<N>(s_v, vc, vrow, 0, ch.qlen);
  cp_async_commit();
  const float a = p.a[ch.h];
  if (warp == 0) chunk_scan(p.dt + ch.row0 * p.H + ch.h, p.H, a, ch.qlen, ch.qpad, s_cum, s_dt);
  __syncthreads();
  const double cum_last = s_cum[ch.qlen - 1];
  for (int j = tid; j < ch.qpad; j += kTcThreads)
    s_s[j] = SCALE == kScaleToEnd ? expf((float)(cum_last - s_cum[j])) * s_dt[j]
                                  : expf((float)s_cum[j]);
  if (SCALE == kScaleToEnd && tid == 0) p.decay[ch.bzh] = expf((float)cum_last);

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
      load_tile_async<P>(s_u + (buf ^ 1) * kTile * LDU, uc, urow, (kt + 1) * kTile, ch.qlen);
      load_tile_async<N>(s_v + (buf ^ 1) * kTile * LDV, vc, vrow, (kt + 1) * kTile, ch.qlen);
    }
    cp_async_commit();
    if (!active) continue;
    const bf16* us = s_u + buf * kTile * LDU;
    const bf16* vs = s_v + buf * kTile * LDV;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      const int jr = ks * 16;   // row of the tile
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2)
        ldmatrix_x4_trans(bf[nt / 2], vs + (jr + lane % 8 + ((lane / 8) % 2) * 8) * LDV +
                                          (wn * NT + nt) * 8 + (lane / 16) * 8);
      // one 16-row tile of P at a time (at P 128 two: their split A
      // fragments at once would spill)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int p0 = (wm * MT + mt) * 16;
        uint32_t raw[4], ahi[4], alo[4];
        ldmatrix_x4_trans(raw, us + (jr + lane % 8 + (lane / 16) * 8) * LDU + p0 +
                                   ((lane / 8) % 2) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // raw[i] holds u at rows j, j + 1 of column p0 + lane / 4 (+ 8)
          const int j = kt * kTile + jr + 2 * (lane % 4) + (i / 2) * 8;
          const float2 uv = unpack_bf16x2(raw[i]);
          split_bf16x2(uv.x * s_s[j], uv.y * s_s[j + 1], ahi[i], alo[i]);
        }
        // the hi products over every accumulator, then the lo ones: no
        // two products in a row wait on each other
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[mt][nt], ahi, bf[nt / 2][2 * (nt % 2)], bf[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[mt][nt], alo, bf[nt / 2][2 * (nt % 2)], bf[nt / 2][2 * (nt % 2) + 1]);
      }
    }
  }

  if (active) {
    float* out = p.out + ch.bzh * P * N;
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

template <int P, int N, int SCALE>
cudaError_t launch_chunk_state(const StateArgs& p, int B, int nc, cudaStream_t st) {
  const size_t bytes = StateSmem<P, N>::bytes(p.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state<P, N, SCALE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssd_chunk_state<P, N, SCALE><<<dim3(nc * p.H, B), kTcThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

// ---- the recurrence over the chunks ----------------------------------------

struct RecurrenceArgs {
  float* slots;          // (B, chunks, H, pn): each chunk's local term in,
                         // the value carried into (forward) or out of
                         // (reverse) the chunk out
  const float* decay;    // (B, chunks, H): exp(cum_last)
  const float* init;     // (B, H, pn): the initial state (forward) or the
                         // final state's gradient (reverse); null for zeros
  float* last;           // (B, H, pn): the final state (forward) or the
                         // initial state's gradient (reverse); may be null
  int H, nc, pn;
};

// Four state elements of one (b, h) per thread (blockIdx.y = b * H + h):
// forward, S_z = S_{z-1} exp(cum_last_z) + local_z with local_z replaced by
// S_{z-1}; in reverse (REVERSE 1), G_{z-1} = local_z + exp(cum_last_z) G_z
// with local_z replaced by G_z. Every load of a batch of chunks is issued
// before its first store: a store to the slots may alias a later load as
// far as the compiler knows, so loads and stores interleaved chunk by chunk
// would wait out one memory round trip each.
template <int REVERSE>
__global__ void __launch_bounds__(256) ssd_state_pass(RecurrenceArgs p) {
  constexpr int kBatch = 8;
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (k >= p.pn) return;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const size_t zstride = (size_t)p.H * p.pn;   // floats from chunk z to z + 1
  float* slot0 = p.slots + ((size_t)b * p.nc * p.H + h) * p.pn + k;
  const float* dec0 = p.decay + (size_t)b * p.nc * p.H + h;
  float4 s = p.init != nullptr ? *reinterpret_cast<const float4*>(p.init + (size_t)bh * p.pn + k)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n0 = 0; n0 < p.nc; n0 += kBatch) {
    float4 local[kBatch];
    float dec[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int z = REVERSE ? p.nc - 1 - (n0 + i) : n0 + i;
      if (n0 + i < p.nc) {
        local[i] = *reinterpret_cast<const float4*>(slot0 + z * zstride);
        dec[i] = dec0[(size_t)z * p.H];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int z = REVERSE ? p.nc - 1 - (n0 + i) : n0 + i;
      if (n0 + i < p.nc) {
        *reinterpret_cast<float4*>(slot0 + z * zstride) = s;
        s.x = s.x * dec[i] + local[i].x;
        s.y = s.y * dec[i] + local[i].y;
        s.z = s.z * dec[i] + local[i].z;
        s.w = s.w * dec[i] + local[i].w;
      }
    }
  }
  if (p.last != nullptr) *reinterpret_cast<float4*>(p.last + (size_t)bh * p.pn + k) = s;
}

template <int REVERSE>
cudaError_t launch_state_pass(const RecurrenceArgs& p, int B, cudaStream_t st) {
  ssd_state_pass<REVERSE><<<dim3((p.pn / 4 + 255) / 256, B * p.H), 256, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
