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
// x, B, C and y are bf16, the states are fp32. The chunk's cumsum is
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
// (B, H, P, N) fp32. All contiguous; x, B and C 16-byte aligned.
//
// What bounds it on the H100. At the serving prefill shape of mamba2-130m
// (B 8, L 4096, H 24, P 64, G 1, N 128, Q 256) the scan needs
// about 64.6 GFLOP (65 us at the 989 TFLOP/s bf16 rate) and about 227.5 MB
// of inputs and outputs once each (68 us at 3.35 TB/s), so the bound is
// bytes, with operations close behind. The design is the chunk-
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

#include <math.h>
#include <stdint.h>

#include "ssd_states.cuh"

namespace {

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
  float* states;      // (B, nc, H, P, N) scratch
  float* decay;       // (B, nc, H) scratch, exp(cum_last)
  int L, H, G, Q, nc;
};

// ---- bf16: chunk-parallel on the tensor cores ------------------------------

template <int P, int N>
struct TcSmem {
  static constexpr int LDX = P + kPad, LDN = N + kPad;
  static constexpr size_t X_TILE = (size_t)kTile * LDX * 2;   // bytes
  static constexpr size_t N_TILE = (size_t)kTile * LDN * 2;
  // pass 3: cum (fp64), dt, the column factors of off-diagonal gates; the
  // carried state as bf16 hi and lo; one C tile; two B and two X tiles
  static size_t output_bytes(int q) {
    return 16 * (size_t)round_up(q, kTile) + 2 * (size_t)P * LDN * 2 + 3 * N_TILE + 2 * X_TILE;
  }
};

// Passes 1 and 2 are ssd_chunk_state<P, N, kScaleToEnd> and
// ssd_state_pass<0> of ssd_states.cuh, which the backward shares.

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
  const Chunk ch(p.L, p.H, p.G, p.Q, 1);
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
  load_state_split<P, N>(s_shi, s_slo, p.states + ch.bzh * P * N);

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
  const size_t s3 = TcSmem<P, N>::output_bytes(p.Q);
  const StateArgs sa{static_cast<const bf16*>(p.x), static_cast<const bf16*>(p.b), p.dt, p.a,
                     p.states, p.decay, p.L, p.H, p.G, p.Q};
  const RecurrenceArgs ra{p.states, p.decay, p.s0, p.s_out, p.H, p.nc, P * N};
  cudaError_t err = launch_chunk_state<P, N, kScaleToEnd>(sa, B, p.nc, st);
  if (err == cudaSuccess) err = launch_state_pass<0>(ra, B, st);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_output<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s3));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_output<P, N><<<dim3(p.nc * p.H, B), kTcThreads, s3, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_n(const Params& p, int B, int N, cudaStream_t st) {
  switch (N) {
    case 16: return launch_tc<P, 16>(p, B, st);
    case 32: return launch_tc<P, 32>(p, B, st);
    case 64: return launch_tc<P, 64>(p, B, st);
    case 128: return launch_tc<P, 128>(p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code (0 on success):
// three launches (chunk states, the state recurrence, outputs) over bf16
// x/B/C/y. d, s0 and s_out may be null (no skip term, zero initial state,
// no final state). states (B, ceil(L / Q), H, P, N) and decay
// (B, ceil(L / Q), H) are fp32 scratch. P and N must be one of 16, 32, 64,
// 128; 1 <= Q <= 1024; H % G == 0. The caller checks shapes, types,
// contiguity and 16-byte alignment of x, B and C.
int ssd_fwd(const void* x, const float* dt, const float* a, const void* b,
            const void* c, const float* d, const float* s0, void* y, float* s_out,
            float* states, float* decay, int B, int L, int H, int P, int G, int N, int Q,
            void* stream) {
  if (Q < 1 || Q > kMaxChunk || G < 1 || H % G != 0 || L < 1 || states == nullptr ||
      decay == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, a, b, c, d, s0, y, s_out, states, decay, L, H, G, Q, (L + Q - 1) / Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_n<16>(p, B, N, st);
    case 32: return launch_n<32>(p, B, N, st);
    case 64: return launch_n<64>(p, B, N, st);
    case 128: return launch_n<128>(p, B, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
