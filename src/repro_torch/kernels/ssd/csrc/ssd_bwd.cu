// Mamba-2 SSD chunked-scan backward for Hopper (sm_90a), bound to Python
// with ctypes.
//
// The JAX package has no TPU kernel for it: JAX differentiates
// src/repro/kernels/ssd/ref.py::ssd_reference through XLA. This is the
// backward of the CUDA forward in ssd_fwd.cu (which replaces
// src/repro/kernels/ssd/kernel.py::_ssd_kernel); its plain version is
// ref.ssd_backward_reference, whose docstring writes out the formulas.
// Per (batch, head) and chunk z of Q tokens, with cum = cumsum(dt * a) over
// the chunk (fp64, as the forward takes it), L_ij = exp(cum_i - cum_j) for
// j <= i, S_prev the state carried into the chunk, S_out the state it hands
// on and G the gradient of S_out:
//   G_{z-1} = sum_i exp(cum_i) dy_i C_i^T + exp(cum_last) G_z   (reverse
//             recurrence from the final state's gradient; its last value is
//             the initial state's gradient)
//   dx_j  = sum_{i>=j} L_ij (C_i.B_j) dt_j dy_i + w_j G B_j + D dy_j,
//           w_j = exp(cum_last - cum_j) dt_j
//   dC_i  = sum_{j<=i} M_ij B_j + exp(cum_i) S_prev^T dy_i,
//           M_ij = (dy_i.x_j) L_ij dt_j
//   dB_j  = sum_{i>=j} M_ij C_i + w_j G^T x_j
//   ddt_j = sum_i F_ij + exp(cum_last - cum_j) x_j.G B_j + a dda_j,
//           F_ij = L_ij (C_i.B_j)(dy_i.x_j)
//   dcum_i = sum_j F_ij dt_j - dt_i sum_i' F_i'i + C_i.(exp(cum_i) S_prev^T dy_i)
//            - w_i x_i.G B_i   (+ <G, S_out> on the chunk's last row)
//   dda = reverse in-chunk cumsum of dcum; da = sum dt dda; dD = sum dy.x
// dB and dC sum over the heads of a group.
//
// Ten launches on the caller's stream, through one fp32 workspace the
// wrapper allocates (ssd_bwd_workspace_floats):
//   1. the chunk's local state sum_j w_j x_j B_j^T and its decay
//      exp(cum_last), one block per (b, h, chunk);
//   2. the forward recurrence, leaving S_prev of every chunk and the final
//      state (the carried states are recomputed: the forward saves only its
//      inputs);
//   3. each chunk's sum_i exp(cum_i) dy_i C_i^T;
//   4. the reverse recurrence, leaving G of every chunk and the initial
//      state's gradient;
//   5. the query pass, one block per 64-row query tile: dC (per head) and
//      the query side of dcum;
//   6. the key pass, one block per 64-row key tile: dx, dB (per head), the
//      direct part of ddt, the key side of dcum and each row's dy.x;
//   7. ssd_bwd_chunk, one block per (b, h, chunk): <G, S_out>, the reverse
//      cumsum of dcum in fp64, ddt += a dda, and per-chunk partials of da
//      and dD;
//   8-9. ssd_bwd_group_sum (dB, dC): the heads of each group summed in a
//      fixed order;
//   10. ssd_bwd_head_sum: da and dD summed over (batch, chunk) in a fixed
//      order.
// Deterministic: every output element and every partial has one writer,
// and every reduction runs in a fixed order; there are no atomics, so two
// runs are bit-identical. Every sum that feeds dcum (the row and column
// sums of F, x.G B, C.dC, dy.x), dcum itself and its reverse cumsum are
// fp64: da weighs each row's dcum by its cum, which reaches a few hundred.
// Above the diagonal exp(cum_i - cum_j) can overflow, so it is selected to
// 0 there (and past a ragged chunk's end), never multiplied by a mask.
//
// x, B, C and dy and their gradients are bf16. Every product runs on the
// tensor cores, mma.sync m16n8k16 bf16 with fp32 accumulation, operands
// from shared memory by ldmatrix, tiles brought in by cp.async (bf16 rows
// padded by kPad) and double-buffered. Passes 1-4 are the forward's chunk-state
// product and batched recurrence (ssd_states.cuh): pass 1 is the forward's
// pass 1, pass 3 the same product with u = dy, v = C and the scale
// exp(cum), pass 4 the recurrence in reverse. Passes 5 and 6 take one
// 64-row tile a block, 16 rows a warp (pass 6 at P + N > 192: two warps,
// one for dx's side and one for dB's), and stream the other side's tiles
// in halves of 32 rows: the tiles C B^T and dy x^T (query-major in pass 5,
// key-major as B C^T and x dy^T in pass 6) are exact from the bf16 inputs,
// and M (pass 5), gate^T and M^T (pass 6) come out of the accumulators
// already in the A-operand layout of the next product. Off the diagonal
// the decay factors into a row and a column term, so that only the
// diagonal tiles take an exponential per element. Every fp32 operand is
// split into bf16 hi + lo and multiplied twice: the w-weighted x and
// exp(cum)-weighted dy of passes 1 and 3, S_prev, G, the gate and M
// (tests/test_torch_ssd_numerics.py emulates this arithmetic and what each
// split buys). Each warp owns its rows' sums, so the fp64 sums that feed
// dcum are per-thread partials over the accumulator fragments reduced over
// the four lanes of a row by __shfl_xor_sync, in a fixed order.
//
// What bounds it on the H100. At the training shape of mamba2-130m (B 8,
// L 4096, H 24, P 64, G 1, N 128, Q 256) the backward needs about 167.91
// GFLOP (per chunk, q(q+1)/2 (query, key) pairs at 2(3N + 2P)
// operations and 10 q N P for the five state products: 0.1698 ms at the
// 989 TFLOP/s bf16 rate) and about 342 MB of inputs and outputs once each
// (0.10 ms at 3.35 TB/s): operations bound it.
// What still separates the design from the bound: the products it runs
// beyond the count (the query and key passes each recompute C B^T and
// dy x^T, the diagonal tiles' dead halves, the hi + lo splits: about 2.3
// times the counted operations) at mma.sync's rate, below wgmma's, with
// every warp reading its own B operands from shared memory by ldmatrix;
// the elementwise work between products (the fp64 sums), with two blocks
// of four warps an SM to hide it; and the workspace's round trips (two
// (B, chunks, H, P, N) state arrays, 201 MB, and per-head dB and dC
// partials of (B, L, H, N), 805 MB, at the training shape).
//
// Layouts as the forward: x, dy, dx (B, L, H, P); dt, ddt (B, L, H) fp32;
// a, D, da, dD (H,) fp32; B, C, dB, dC (B, L, G, N), head h reading group
// h / (H / G); states and their gradients (B, H, P, N) fp32. All
// contiguous; x, dy, B, C, the initial state and the final state's
// gradient 16-byte aligned.

#include <math.h>
#include <stdint.h>

#include "ssd_states.cuh"

namespace {

constexpr int kThreads = 256;   // pass 7's block
constexpr int kMaxChunk = 1024;

__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

__host__ __device__ constexpr size_t align4(size_t v) { return (v + 3) / 4 * 4; }

struct Params {
  const void* x;        // (B, L, H, P)
  const float* dt;      // (B, L, H)
  const float* a;       // (H,)
  const void* b;        // (B, L, G, N)
  const void* c;        // (B, L, G, N)
  const float* d;       // (H,) or null
  const float* s0;      // (B, H, P, N) or null
  const void* dy;       // (B, L, H, P)
  const float* dfinal;  // (B, H, P, N) or null
  void* dx;             // (B, L, H, P)
  float* ddt;           // (B, L, H)
  float* da;            // (H,)
  void* db;             // (B, L, G, N)
  void* dc;             // (B, L, G, N)
  float* dd;            // (H,) or null
  float* ds0;           // (B, H, P, N) or null
  // workspace
  float* states;        // (B, nc, H, P, N): S_prev of each chunk
  float* dstates;       // (B, nc, H, P, N): G of each chunk
  float* s_last;        // (B, H, P, N): the final state
  float* decay;         // (B, nc, H): exp(cum_last)
  float* db_part;       // (B, L, H, N): dB per head
  float* dc_part;       // (B, L, H, N): dC per head
  double* dcum;         // (B, L, H), fp64
  float* dd_rows;       // (B, L, H): dy . x per row
  float* part_a;        // (B, nc, H)
  float* part_d;        // (B, nc, H)
  int B, L, H, G, P, N, Q, nc;
};

// The workspace's arrays, in floats, each a multiple of 4: two of `states`,
// one of `s_last`, three of `decay` (decay, part_a, part_d), two of
// `rows_n`, three of `rows` (dcum, two floats a row, and dd_rows).
struct Workspace {
  size_t states, s_last, decay, rows_n, rows;
  Workspace(int B, int L, int H, int P, int N, int Q) {
    const size_t nc = (L + Q - 1) / Q;
    states = align4((size_t)B * nc * H * P * N);
    s_last = align4((size_t)B * H * P * N);
    decay = align4((size_t)B * nc * H);
    rows_n = align4((size_t)B * L * H * N);
    rows = align4((size_t)B * L * H);
  }
  size_t total() const { return 2 * states + s_last + 3 * decay + 2 * rows_n + 3 * rows; }
  void carve(float* w, Params& p) const {
    p.states = w;
    p.dstates = p.states + states;
    p.s_last = p.dstates + states;
    p.decay = p.s_last + s_last;
    p.db_part = p.decay + decay;
    p.dc_part = p.db_part + rows_n;
    p.dcum = reinterpret_cast<double*>(p.dc_part + rows_n);   // 2 floats a row
    p.dd_rows = p.dc_part + rows_n + 2 * rows;
    p.part_a = p.dd_rows + rows;
    p.part_d = p.part_a + decay;
  }
};

// The chunk's dt (0 past its end) and inclusive cumsum of dt * a in fp64,
// by every thread of the block: each sums a run of consecutive rows, thread
// 0 scans the runs' totals, and each adds its offset. s_tot holds kThreads
// doubles. Ends with a barrier.
__device__ __forceinline__ void block_scan(const Params& p, const Chunk& ch, double* s_cum,
                                           float* s_dt, double* s_tot) {
  const float a = p.a[ch.h];
  const float* dtc = p.dt + ch.row0 * p.H + ch.h;
  const int seg = (ch.qpad + kThreads - 1) / kThreads;
  const int j0 = threadIdx.x * seg;
  double run = 0.0;
  for (int j = j0; j < min(j0 + seg, ch.qpad); ++j) {
    const float dtj = j < ch.qlen ? dtc[(size_t)j * p.H] : 0.f;
    s_dt[j] = dtj;
    run += (double)(dtj * a);   // the product rounds to fp32 as in the plain version
    s_cum[j] = run;
  }
  s_tot[threadIdx.x] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int t = 0; t < kThreads; ++t) {
      const double v = s_tot[t];
      s_tot[t] = acc;
      acc += v;
    }
  }
  __syncthreads();
  const double off = s_tot[threadIdx.x];
  for (int j = j0; j < min(j0 + seg, ch.qpad); ++j) s_cum[j] += off;
  __syncthreads();
}

// ---- bf16: the query and key passes on the tensor cores ----------------------

// Shared memory of passes 5 and 6: fp64 cum, fp32 dt and the off-diagonal
// column factors of the chunk, then bf16 tiles with rows padded by kPad:
// the block's own N and X tiles, and two buffers of the streamed side's N
// and X tiles. Before the stream starts, the second buffer holds the state
// (S_prev or G) as bf16 hi and lo.
template <int P, int N>
struct TcTiles {
  static constexpr int LDX = P + kPad, LDN = N + kPad;
  static constexpr int X_TILE = kTile * LDX, N_TILE = kTile * LDN;   // bf16 elements
  static constexpr int STATE = P * LDN;
  static constexpr int BUF = N_TILE + X_TILE;
  static constexpr int BUF1 = BUF > 2 * STATE ? BUF : 2 * STATE;
  static size_t bytes(int q) {
    return 16 * (size_t)round_up(q, kTile) + 2 * ((size_t)N_TILE + X_TILE + BUF + BUF1);
  }
};

// Fragment addresses, for a warp's 16 rows starting at `row0` of a tile
// with row stride LD (bf16 elements) and 16-wide k-step ks:
// the A operand (rows are M, columns are K)
template <int LD>
__device__ __forceinline__ int a_frag(int row0, int ks) {
  const int lane = threadIdx.x % 32;
  return (row0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + ks * 16 + (lane / 16) * 8;
}
// the B operands of n-tiles nt and nt + 1 from a tile whose rows are N and
// columns K (ldmatrix), and from one whose rows are K and columns N
// (ldmatrix.trans); k0 is the first row or column of K
template <int LD>
__device__ __forceinline__ int b_frag_nk(int nt, int k0) {
  const int lane = threadIdx.x % 32;
  return (nt * 8 + lane % 8 + (lane / 16) * 8) * LD + k0 + ((lane / 8) % 2) * 8;
}
template <int LD>
__device__ __forceinline__ int b_frag_kn(int nt, int k0) {
  const int lane = threadIdx.x % 32;
  return (k0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + nt * 8 + (lane / 16) * 8;
}

// acc[t] += A B for the NT n-tiles of B, with A one 16 x 16 fragment (or
// the sum of two, hi and lo, each B fragment loaded once for both): B's
// fragments by ldmatrix (TRANS 0: rows of `b` are N) or ldmatrix.trans
// (TRANS 1: rows are K), k-step at row or column k0.
template <int NT, int LD, int TRANS, int PARTS = 1>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4], const uint32_t (&a)[PARTS][4],
                                        const bf16* b, int k0) {
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
    uint32_t bb[4];
    if (TRANS)
      ldmatrix_x4_trans(bb, b + b_frag_kn<LD>(nt, k0));
    else
      ldmatrix_x4(bb, b + b_frag_nk<LD>(nt, k0));
#pragma unroll
    for (int part = 0; part < PARTS; ++part) {
      mma_16816(acc[nt], a[part], bb[0], bb[1]);
      mma_16816(acc[nt + 1], a[part], bb[2], bb[3]);
    }
  }
}

// The A operand of one 16-column k-step (accumulator tiles 2 kk and
// 2 kk + 1 of a 16-row fp32 tile) split into bf16 hi (a[0]) and lo (a[1]).
__device__ __forceinline__ void split_frag(const float (&t0)[4], const float (&t1)[4],
                                           uint32_t (&a)[2][4]) {
  split_bf16x2(t0[0], t0[1], a[0][0], a[1][0]);
  split_bf16x2(t0[2], t0[3], a[0][1], a[1][1]);
  split_bf16x2(t1[0], t1[1], a[0][2], a[1][2]);
  split_bf16x2(t1[2], t1[3], a[0][3], a[1][3]);
}

// acc += (rows of tile `a` from row0, K columns) times the state (P, N) in
// shared memory as bf16 hi and lo: TRANS 0 takes the state's rows as N
// (A's K is the state's N), TRANS 1 as K (A's K is the state's P).
template <int NT, int K, int LDA, int LDS, int TRANS>
__device__ __forceinline__ void mma_state(float (&acc)[NT][4], const bf16* a, int row0,
                                          const bf16* s_hi, const bf16* s_lo) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t af[1][4];
    ldmatrix_x4(af[0], a + a_frag<LDA>(row0, ks));
    mma_row<NT, LDS, TRANS>(acc, af, s_hi, ks * 16);
    mma_row<NT, LDS, TRANS>(acc, af, s_lo, ks * 16);
  }
}

// out[t] = (rows of tile `a` from row0) (rows of tile `b` from col0)^T over
// K columns, for 4 n-tiles (32 columns): the exact bf16 products C B^T,
// dy x^T, B C^T and x dy^T.
template <int K, int LD>
__device__ __forceinline__ void score_half(float (&out)[4][4], const bf16* a, int row0,
                                           const bf16* b, int col0) {
#pragma unroll
  for (int t = 0; t < 4; ++t) out[t][0] = out[t][1] = out[t][2] = out[t][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t af[1][4];
    ldmatrix_x4(af[0], a + a_frag<LD>(row0, ks));
    mma_row<4, LD, 0>(out, af, b + col0 * LD, ks * 16);
  }
}

__device__ __forceinline__ double row_total(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp(hi - lo) of two fp64 cumsums, by the special-function unit: the
// difference is taken in fp64 and rounded to fp32 once.
__device__ __forceinline__ float decay(double hi, double lo) {
  return ex2_approx((float)((hi - lo) * kLog2eD));
}

// Off the diagonal every key j of a (query, key) tile pair lies before every
// query i, and with R the cumsum at the key tile's last row the decay
// factors as exp(cum_i - R) exp(R - cum_j), both at most 1 (cum falls along
// the chunk): the passes take the key factors once per key tile, the query
// factors once per tile pair, and no exponential per element. On the
// diagonal cum_i - R can be large and positive, so the diagonal tile keeps
// exp(cum_i - cum_j) per element, selected to 0 above the diagonal (where it
// can overflow) and past the chunk's end: never multiplied by a mask.

// ---- pass 5: the query side, one block per 64-row query tile -----------------
// One warp per 16 query rows i:
//   dC_i   = exp(cum_i) S_prev^T dy_i + sum_{j<=i} M_ij B_j   (per head)
//   dcum_i = C_i . (exp(cum_i) S_prev^T dy_i) + sum_j (C_i . B_j) M_ij
// The carried term is dy (A) times S_prev split hi + lo. Key tiles at or
// below the diagonal stream through two buffers; for each half of 32 keys,
// C B^T and dy x^T, M, and dC += M B with M split hi + lo as the A operand
// straight from the accumulator layout.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 1) ssd_bwd_tc_query(Params p, int tiles) {
  using S = TcTiles<P, N>;
  constexpr int LDX = S::LDX, LDN = S::LDN;
  constexpr int NT = N / 8;   // 8-column tiles of dC
  extern __shared__ __align__(16) unsigned char smem[];
  const Chunk ch(p.L, p.H, p.G, p.Q, tiles);
  const int i0 = ch.tile * kTile;
  if (i0 >= ch.qlen) return;
  double* s_cum = reinterpret_cast<double*>(smem);
  float* s_dt = reinterpret_cast<float*>(s_cum + ch.qpad);
  float* s_colf = s_dt + ch.qpad;                          // exp(R - cum_j) dt_j
  bf16* s_c = reinterpret_cast<bf16*>(s_colf + ch.qpad);  // (kTile, LDN) query rows
  bf16* s_dy = s_c + S::N_TILE;                           // (kTile, LDX) query rows
  bf16* s_kv = s_dy + S::X_TILE;                          // 2 x key tiles: B, then x
  bf16* s_shi = s_kv + S::BUF;                            // S_prev hi and lo, (P, LDN)
  bf16* s_slo = s_shi + S::STATE;                         // each, in the second buffer

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c2 = 2 * (lane % 4);
  const size_t xrow = (size_t)p.H * P, brow = (size_t)p.G * N;
  const size_t hoff = (size_t)ch.h * P, goff = (size_t)ch.g * N;
  const bf16* xc = static_cast<const bf16*>(p.x) + ch.row0 * xrow + hoff;
  const bf16* dyc = static_cast<const bf16*>(p.dy) + ch.row0 * xrow + hoff;
  const bf16* bc = static_cast<const bf16*>(p.b) + ch.row0 * brow + goff;
  const bf16* cc = static_cast<const bf16*>(p.c) + ch.row0 * brow + goff;

  load_tile_async<N>(s_c, cc, brow, i0, ch.qlen);
  load_tile_async<P>(s_dy, dyc, xrow, i0, ch.qlen);
  load_tile_async<N>(s_kv, bc, brow, 0, ch.qlen);
  load_tile_async<P>(s_kv + S::N_TILE, xc, xrow, 0, ch.qlen);
  cp_async_commit();
  if (warp == 0)
    chunk_scan(p.dt + ch.row0 * p.H + ch.h, p.H, p.a[ch.h], ch.qlen, ch.qpad, s_cum, s_dt);
  load_state_split<P, N>(s_shi, s_slo, p.states + ch.bzh * P * N);
  __syncthreads();   // the scan is done
  for (int j = tid; j < i0; j += kTcThreads)   // keys of the tiles below the diagonal
    s_colf[j] = decay(s_cum[(j / kTile) * kTile + kTile - 1], s_cum[j]) * s_dt[j];
  cp_async_wait<0>();
  __syncthreads();   // S_prev, the column factors and the first tiles are in

  const int r0 = warp * 16;                    // the warp's first row of the tile
  const int rl = r0 + lane / 4, rh = rl + 8;   // this thread's two rows
  const int il = i0 + rl, ih = i0 + rh;        // the same, rows of the chunk
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // carried state: acc = exp(cum_i) dy_i (S_hi + S_lo)
  mma_state<NT, P, LDX, LDN, 1>(acc, s_dy, r0, s_shi, s_slo);
  double fl = 0.0, fh = 0.0;   // the rows' dcum
  {
    const float el = expf((float)s_cum[il]), eh = expf((float)s_cum[ih]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + c2;
      const float2 cl = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(s_c + rl * LDN + col));
      const float2 chv = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(s_c + rh * LDN + col));
      acc[nt][0] *= el;
      acc[nt][1] *= el;
      acc[nt][2] *= eh;
      acc[nt][3] *= eh;
      fl += (double)(cl.x * acc[nt][0]) + (double)(cl.y * acc[nt][1]);
      fh += (double)(chv.x * acc[nt][2]) + (double)(chv.y * acc[nt][3]);
    }
  }

  const double cum_l = s_cum[il], cum_h = s_cum[ih];
  for (int kt = 0; kt <= ch.tile; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();
    __syncthreads();   // key tile kt has landed; every warp is done with the other buffer
    if (kt < ch.tile) {
      bf16* nb = s_kv + (buf ^ 1) * S::BUF;
      load_tile_async<N>(nb, bc, brow, (kt + 1) * kTile, ch.qlen);
      load_tile_async<P>(nb + S::N_TILE, xc, xrow, (kt + 1) * kTile, ch.qlen);
    }
    cp_async_commit();
    const bf16* bs = s_kv + buf * S::BUF;
    const bf16* xs = bs + S::N_TILE;
    const bool diag = kt == ch.tile;
    const int j0 = kt * kTile;
    // the rows' decay factors off the diagonal, exp(cum_i - R)
    const double rk = s_cum[j0 + kTile - 1];
    const float rfl = diag ? 0.f : decay(cum_l, rk), rfh = diag ? 0.f : decay(cum_h, rk);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = half * 32;   // the half's first key, in the tile
      // on the diagonal the warp's rows see keys up to r0 + 15 only
      if (diag && k0 > r0 + 15) continue;
      float sc[4][4], m[4][4];
      score_half<N, LDN>(sc, s_c, r0, bs, k0);
      score_half<P, LDX>(m, s_dy, r0, xs, k0);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + k0 + t * 8 + c2 + c;
          if (diag) {
            const double cum_j = s_cum[j];
            const float dtj = s_dt[j];
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int e = 2 * hi + c, i = hi ? ih : il;
              const bool live = j <= i && i < ch.qlen;
              const float ell = decay(live ? (hi ? cum_h : cum_l) : cum_j, cum_j);
              m[t][e] = live ? m[t][e] * ell * dtj : 0.f;
            }
          } else {
            // rows past the chunk's end have dy = 0, so M = 0 there
            const float cf = s_colf[j];
            m[t][c] *= rfl * cf;
            m[t][2 + c] *= rfh * cf;
          }
          fl += (double)(sc[t][c] * m[t][c]);
          fh += (double)(sc[t][2 + c] * m[t][2 + c]);
        }
      }
      // dC += M B over the half's keys
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (diag && k0 + kk * 16 > r0 + 15) continue;   // all-zero columns of M
        uint32_t ma[2][4];
        split_frag(m[2 * kk], m[2 * kk + 1], ma);
        mma_row<NT, LDN, 1, 2>(acc, ma, bs, k0 + kk * 16);
      }
    }
  }

  fl = row_total(fl);
  fh = row_total(fh);
  const size_t rowh = ch.row0 * p.H + ch.h;   // (b, chunk row 0, h) in (B, L, H)
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = hi ? ih : il;
    if (i >= ch.qlen) continue;
    float* out = p.dc_part + (rowh + (size_t)i * p.H) * N;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(out + nt * 8 + c2) =
          make_float2(acc[nt][2 * hi], acc[nt][2 * hi + 1]);
    if (lane % 4 == 0) p.dcum[rowh + (size_t)i * p.H] = hi ? fh : fl;
  }
}

// ---- pass 6: the key side, one block per 64-row key tile ---------------------
// For 16 key rows j:
//   dx side: dx_j = w_j G B_j + sum_{i>=j} gate_ij dy_i + D dy_j;
//     ddt_j (direct) = sum_i F_ij + exp(cum_last - cum_j) x_j.G B_j;
//     dcum_j += -dt_j sum_i F_ij - w_j x_j.G B_j;  dd_rows_j = dy_j.x_j
//   dB side: dB_j = w_j G^T x_j + sum_{i>=j} M_ij C_i   (per head)
// One warp takes both sides of 16 rows, unless dx's and dB's accumulators
// together pass 96 fp32 registers a thread (P + N > 192): then two warps
// take one side each, so that neither spills (8 warps; with 4, two blocks
// share an SM, which measured faster where both fit). The state terms are B or x (A) times G split hi + lo. Query
// tiles at or above the diagonal stream through two buffers; for each half
// of 32 queries, the key-major B C^T (dx side) and x dy^T (both), then
// gate^T and F's sums or M^T, and dx += gate^T dy or dB += M^T C with
// gate^T or M^T split hi + lo as the A operand.
template <int P, int N>
struct KeyWarps {
  static constexpr int value = P + N > 192 ? 8 : 4;
};
constexpr int kSideDx = 1, kSideDb = 2;   // bit masks of the sides a warp takes

template <int P, int N, int SIDES, int THREADS>
__device__ __forceinline__ void key_side(const Params& p, const Chunk& ch, unsigned char* smem) {
  using S = TcTiles<P, N>;
  constexpr int LDX = S::LDX, LDN = S::LDN;
  constexpr bool DX = SIDES & kSideDx, DB = SIDES & kSideDb;
  constexpr int PT = DX ? P / 8 : 2, NT = DB ? N / 8 : 2;   // 8-column tiles of dx, dB
  const int j0 = ch.tile * kTile;
  double* s_cum = reinterpret_cast<double*>(smem);
  float* s_dt = reinterpret_cast<float*>(s_cum + ch.qpad);
  float* s_colf = s_dt + ch.qpad;                          // exp(cum_i - R)
  bf16* s_b = reinterpret_cast<bf16*>(s_colf + ch.qpad);  // (kTile, LDN) key rows
  bf16* s_x = s_b + S::N_TILE;                            // (kTile, LDX) key rows
  bf16* s_qv = s_x + S::X_TILE;                           // 2 x query tiles: C, then dy
  bf16* s_ghi = s_qv + S::BUF;                            // G hi and lo, (P, LDN) each,
  bf16* s_glo = s_ghi + S::STATE;                         // in the second buffer

  const int lane = threadIdx.x % 32, c2 = 2 * (lane % 4);
  const int r0 = (threadIdx.x / 32) % 4 * 16;
  const int rl = r0 + lane / 4, rh = rl + 8;   // this thread's two key rows of the tile
  const int jl = j0 + rl, jh = j0 + rh;        // the same, rows of the chunk
  const size_t xrow = (size_t)p.H * P, brow = (size_t)p.G * N;
  const size_t hoff = (size_t)ch.h * P, goff = (size_t)ch.g * N;
  const bf16* dyc = static_cast<const bf16*>(p.dy) + ch.row0 * xrow + hoff;
  const bf16* cc = static_cast<const bf16*>(p.c) + ch.row0 * brow + goff;
  const double cum_last = s_cum[ch.qlen - 1];
  const double cum_l = s_cum[jl], cum_h = s_cum[jh];
  const float dtl = s_dt[jl], dth = s_dt[jh];
  const float wl = expf((float)(cum_last - cum_l)) * dtl;
  const float wh = expf((float)(cum_last - cum_h)) * dth;

  float dxa[PT][4], dba[NT][4];
  double dwl = 0.0, dwh = 0.0;
  if constexpr (DX) {
    // dxa = G B_j, then x_j . G B_j and dxa *= w_j
#pragma unroll
    for (int t = 0; t < PT; ++t) dxa[t][0] = dxa[t][1] = dxa[t][2] = dxa[t][3] = 0.f;
    mma_state<PT, N, LDN, LDN, 0>(dxa, s_b, r0, s_ghi, s_glo);
#pragma unroll
    for (int t = 0; t < PT; ++t) {
      const int col = t * 8 + c2;
      const float2 xl = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(s_x + rl * LDX + col));
      const float2 xh = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(s_x + rh * LDX + col));
      dwl += (double)(xl.x * dxa[t][0]) + (double)(xl.y * dxa[t][1]);
      dwh += (double)(xh.x * dxa[t][2]) + (double)(xh.y * dxa[t][3]);
      dxa[t][0] *= wl;
      dxa[t][1] *= wl;
      dxa[t][2] *= wh;
      dxa[t][3] *= wh;
    }
  }
  if constexpr (DB) {
    // dba = w_j G^T x_j
#pragma unroll
    for (int t = 0; t < NT; ++t) dba[t][0] = dba[t][1] = dba[t][2] = dba[t][3] = 0.f;
    mma_state<NT, P, LDX, LDN, 1>(dba, s_x, r0, s_ghi, s_glo);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      dba[t][0] *= wl;
      dba[t][1] *= wl;
      dba[t][2] *= wh;
      dba[t][3] *= wh;
    }
  }

  // the key rows' decay factors off the diagonal, exp(R - cum_j), R the
  // cumsum at the key tile's last row
  const double rk = s_cum[j0 + kTile - 1];
  const float rfl = decay(rk, cum_l), rfh = decay(rk, cum_h);
  double fl = 0.0, fh = 0.0, ddl = 0.0, ddh = 0.0;   // the rows' sum_i F_ij and dy.x
  const float dskip = p.d != nullptr ? p.d[ch.h] : 0.f;
  const int n_it = (ch.qpad - j0) / kTile;   // query tiles at or above the diagonal
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();   // query tile it has landed; every warp is done with the other buffer
    if (it + 1 < n_it) {
      bf16* nb = s_qv + (buf ^ 1) * S::BUF;
      load_tile_async<N, THREADS>(nb, cc, brow, j0 + (it + 1) * kTile, ch.qlen);
      load_tile_async<P, THREADS>(nb + S::N_TILE, dyc, xrow, j0 + (it + 1) * kTile, ch.qlen);
    }
    cp_async_commit();
    const bf16* cs = s_qv + buf * S::BUF;
    const bf16* ds = cs + S::N_TILE;
    const bool diag = it == 0;
    const int i0 = j0 + it * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q0 = half * 32;   // the half's first query, in the tile
      // on the diagonal the warp's keys see queries from r0 on only
      if (diag && q0 + 31 < r0) continue;
      float sc[4][4], m[4][4];   // B C^T (dx side) and x dy^T
      if constexpr (DX) score_half<N, LDN>(sc, s_b, r0, cs, q0);
      score_half<P, LDX>(m, s_x, r0, ds, q0);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = i0 + q0 + t * 8 + c2 + c;
          // ell_ij dt_j and ell_ij for the two key rows: rows past the
          // chunk's end have dt = 0, columns past it C = dy = 0
          float el, eh;
          if (diag) {
            const double cum_i = s_cum[i];
            const bool live_l = jl <= i && i < ch.qlen, live_h = jh <= i && i < ch.qlen;
            el = live_l ? decay(cum_i, cum_l) : 0.f;
            eh = live_h ? decay(cum_i, cum_h) : 0.f;
          } else {
            const float cf = s_colf[i];
            el = rfl * cf;
            eh = rfh * cf;
          }
          if constexpr (DX) {
            const float gl = el * sc[t][c], gh = eh * sc[t][2 + c];
            fl += (double)(gl * m[t][c]);
            fh += (double)(gh * m[t][2 + c]);
            sc[t][c] = gl * dtl;   // gate^T
            sc[t][2 + c] = gh * dth;
          }
          if constexpr (DB) {
            m[t][c] *= el * dtl;   // M^T
            m[t][2 + c] *= eh * dth;
          }
        }
      }
      // dx += gate^T dy and dB += M^T C over the half's queries
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (diag && q0 + kk * 16 + 15 < r0) continue;   // all-zero columns
        uint32_t ga[2][4];
        if constexpr (DX) {
          split_frag(sc[2 * kk], sc[2 * kk + 1], ga);
          mma_row<PT, LDX, 1, 2>(dxa, ga, ds, q0 + kk * 16);
        }
        if constexpr (DB) {
          split_frag(m[2 * kk], m[2 * kk + 1], ga);
          mma_row<NT, LDN, 1, 2>(dba, ga, cs, q0 + kk * 16);
        }
      }
    }
    if (DX && diag) {
      // the diagonal tile's dy rows are the key rows: skip term and dy.x
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        const int col = t * 8 + c2;
        const float2 yl = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(ds + rl * LDX + col));
        const float2 yh = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(ds + rh * LDX + col));
        const float2 xl = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(s_x + rl * LDX + col));
        const float2 xh = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(s_x + rh * LDX + col));
        dxa[t][0] = fmaf(dskip, yl.x, dxa[t][0]);
        dxa[t][1] = fmaf(dskip, yl.y, dxa[t][1]);
        dxa[t][2] = fmaf(dskip, yh.x, dxa[t][2]);
        dxa[t][3] = fmaf(dskip, yh.y, dxa[t][3]);
        ddl += (double)(yl.x * xl.x) + (double)(yl.y * xl.y);
        ddh += (double)(yh.x * xh.x) + (double)(yh.y * xh.y);
      }
    }
  }

  const size_t rowh = ch.row0 * p.H + ch.h;
  if constexpr (DB) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int j = hi ? jh : jl;
      if (j >= ch.qlen) continue;
      float* out = p.db_part + (rowh + (size_t)j * p.H) * N;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        *reinterpret_cast<float2*>(out + t * 8 + c2) = make_float2(dba[t][2 * hi], dba[t][2 * hi + 1]);
    }
  }
  if constexpr (DX) {
    fl = row_total(fl);
    fh = row_total(fh);
    dwl = row_total(dwl);
    dwh = row_total(dwh);
    ddl = row_total(ddl);
    ddh = row_total(ddh);
    bf16* dxc = static_cast<bf16*>(p.dx) + ch.row0 * xrow + hoff;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int j = hi ? jh : jl;
      if (j >= ch.qlen) continue;
#pragma unroll
      for (int t = 0; t < PT; ++t)
        *reinterpret_cast<uint32_t*>(dxc + (size_t)j * xrow + t * 8 + c2) =
            pack_bf16x2(dxa[t][2 * hi], dxa[t][2 * hi + 1]);
      if (lane % 4 == 0) {
        const size_t o = rowh + (size_t)j * p.H;
        const double f = hi ? fh : fl, dw = hi ? dwh : dwl;
        p.ddt[o] = (float)(f + (double)expf((float)(cum_last - s_cum[j])) * dw);
        p.dcum[o] += -(double)s_dt[j] * f - (double)(hi ? wh : wl) * dw;   // pass 5 wrote the query side
        p.dd_rows[o] = (float)(hi ? ddh : ddl);
      }
    }
  }
}

template <int P, int N>
__global__ void __launch_bounds__(32 * KeyWarps<P, N>::value, 1)
    ssd_bwd_tc_key(Params p, int tiles) {
  using S = TcTiles<P, N>;
  constexpr int kKeyThreads = 32 * KeyWarps<P, N>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Chunk ch(p.L, p.H, p.G, p.Q, tiles);
  const int j0 = ch.tile * kTile;
  if (j0 >= ch.qlen) return;
  double* s_cum = reinterpret_cast<double*>(smem);
  float* s_dt = reinterpret_cast<float*>(s_cum + ch.qpad);
  float* s_colf = s_dt + ch.qpad;
  bf16* s_b = reinterpret_cast<bf16*>(s_colf + ch.qpad);
  bf16* s_x = s_b + S::N_TILE;
  bf16* s_qv = s_x + S::X_TILE;
  bf16* s_ghi = s_qv + S::BUF;
  const size_t xrow = (size_t)p.H * P, brow = (size_t)p.G * N;
  const size_t hoff = (size_t)ch.h * P, goff = (size_t)ch.g * N;
  load_tile_async<N, kKeyThreads>(s_b, static_cast<const bf16*>(p.b) + ch.row0 * brow + goff,
                                  brow, j0, ch.qlen);
  load_tile_async<P, kKeyThreads>(s_x, static_cast<const bf16*>(p.x) + ch.row0 * xrow + hoff,
                                  xrow, j0, ch.qlen);
  load_tile_async<N, kKeyThreads>(s_qv, static_cast<const bf16*>(p.c) + ch.row0 * brow + goff,
                                  brow, j0, ch.qlen);
  load_tile_async<P, kKeyThreads>(s_qv + S::N_TILE,
                                  static_cast<const bf16*>(p.dy) + ch.row0 * xrow + hoff, xrow,
                                  j0, ch.qlen);
  cp_async_commit();
  if (threadIdx.x < 32)
    chunk_scan(p.dt + ch.row0 * p.H + ch.h, p.H, p.a[ch.h], ch.qlen, ch.qpad, s_cum, s_dt);
  load_state_split<P, N, kKeyThreads>(s_ghi, s_ghi + S::STATE, p.dstates + ch.bzh * P * N);
  __syncthreads();   // the scan is done
  const double rk = s_cum[j0 + kTile - 1];
  for (int i = j0 + kTile + threadIdx.x; i < ch.qpad; i += kKeyThreads)   // queries past the tile
    s_colf[i] = decay(s_cum[i], rk);
  cp_async_wait<0>();
  __syncthreads();   // G, the column factors and the first tiles are in
  if constexpr (kKeyThreads == kTcThreads) {
    key_side<P, N, kSideDx | kSideDb, kKeyThreads>(p, ch, smem);
  } else {
    // warp-uniform: both sides pass the same barriers, once per query tile
    if (threadIdx.x < kTcThreads)
      key_side<P, N, kSideDx, kKeyThreads>(p, ch, smem);
    else
      key_side<P, N, kSideDb, kKeyThreads>(p, ch, smem);
  }
}

// ---- pass 7: one block per (b, h, chunk) ------------------------------------
// dcum of the chunk's last row += <G, S_out>; dda = reverse cumsum of dcum
// (fp64); ddt += a dda; part_a = sum dt dda; part_d = sum dy.x.
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk(Params p) {
  extern __shared__ double smem_d[];
  const Chunk ch(p.L, p.H, p.G, p.Q, 1);
  double* s_cum = smem_d;
  double* s_tot = s_cum + ch.qpad;
  double* s_dda = s_tot + kThreads;        // (qpad,) dcum, then dda
  float* s_dt = reinterpret_cast<float*>(s_dda + ch.qpad);
  float* s_ddr = s_dt + ch.qpad;           // (qpad,) dy . x
  const int tid = threadIdx.x;
  const int pn = p.P * p.N;
  const size_t rowh = ch.row0 * p.H + ch.h;
  for (int i = tid; i < ch.qlen; i += kThreads) {
    s_dda[i] = p.dcum[rowh + (size_t)i * p.H];
    s_ddr[i] = p.dd_rows[rowh + (size_t)i * p.H];
  }
  block_scan(p, ch, s_cum, s_dt, s_tot);

  // <G_z, S_out_z>: S_out_z is S_prev of the next chunk, or the final state
  const float* gz = p.dstates + ch.bzh * pn;
  const float* so = ch.z + 1 < p.nc ? p.states + (ch.bzh + p.H) * pn
                                    : p.s_last + ((size_t)ch.b * p.H + ch.h) * pn;
  double part = 0.0;
  for (int e = tid; e < pn; e += kThreads) part += (double)gz[e] * (double)so[e];
  s_tot[tid] = part;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (tid < half) s_tot[tid] += s_tot[tid + half];
    __syncthreads();
  }
  if (tid == 0) {
    double acc = s_tot[0], pa = 0.0, pd = 0.0;   // acc: the term of the last row
    for (int i = ch.qlen - 1; i >= 0; --i) {
      acc += s_dda[i];
      s_dda[i] = acc;
      pa += (double)s_dt[i] * acc;
      pd += (double)s_ddr[i];
    }
    p.part_a[ch.bzh] = (float)pa;
    p.part_d[ch.bzh] = (float)pd;
  }
  __syncthreads();
  const float a = p.a[ch.h];
  for (int i = tid; i < ch.qlen; i += kThreads) {
    const size_t o = rowh + (size_t)i * p.H;
    p.ddt[o] += a * (float)s_dda[i];
  }
}

// ---- passes 8 and 9: dB and dC, the heads of each group summed in order ----
template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_group_sum(const float* part, T* out, int rows,
                                                         int H, int G, int N) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;   // (row, g, n)
  if (e >= (size_t)rows * G * N) return;
  const int n = e % N, g = (e / N) % G;
  const size_t row = e / ((size_t)N * G);
  const int rep = H / G;
  const float* src = part + (row * H + (size_t)g * rep) * N + n;
  float s = 0.f;
  for (int k = 0; k < rep; ++k) s += src[(size_t)k * N];
  store(out + e, s);
}

// ---- pass 10: da and dD, summed over (batch, chunk) in order ---------------
__global__ void ssd_bwd_head_sum(Params p) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= p.H) return;
  double sa = 0.0, sd = 0.0;
  for (int bz = 0; bz < p.B * p.nc; ++bz) {
    sa += (double)p.part_a[(size_t)bz * p.H + h];
    sd += (double)p.part_d[(size_t)bz * p.H + h];
  }
  p.da[h] = (float)sa;
  if (p.dd != nullptr) p.dd[h] = (float)sd;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Passes 7-10, after the query and key passes.
cudaError_t launch_sums(Params& p, size_t chunk_bytes, cudaStream_t st) {
  cudaError_t err = set_smem(ssd_bwd_chunk, chunk_bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk<<<dim3(p.nc * p.H, p.B), kThreads, chunk_bytes, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int rows = p.B * p.L;
  const unsigned gsum = (unsigned)(((size_t)rows * p.G * p.N + 255) / 256);
  ssd_bwd_group_sum<bf16><<<gsum, 256, 0, st>>>(p.db_part, static_cast<bf16*>(p.db), rows, p.H,
                                                 p.G, p.N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_group_sum<bf16><<<gsum, 256, 0, st>>>(p.dc_part, static_cast<bf16*>(p.dc), rows, p.H,
                                                 p.G, p.N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_head_sum<<<(p.H + 127) / 128, 128, 0, st>>>(p);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_tc(Params& p, cudaStream_t st) {
  const int qpad = round_up(p.Q, kTile), tiles = qpad / kTile;
  const size_t tile_bytes = TcTiles<P, N>::bytes(p.Q);
  const size_t chunk = sizeof(double) * (2 * (size_t)qpad + kThreads) + sizeof(float) * 2 * qpad;
  cudaError_t err;
  if ((err = set_smem(ssd_bwd_tc_query<P, N>, tile_bytes)) != cudaSuccess ||
      (err = set_smem(ssd_bwd_tc_key<P, N>, tile_bytes)) != cudaSuccess)
    return err;
  const bf16 *x = static_cast<const bf16*>(p.x), *dy = static_cast<const bf16*>(p.dy);
  const bf16 *b = static_cast<const bf16*>(p.b), *c = static_cast<const bf16*>(p.c);
  const StateArgs local{x, b, p.dt, p.a, p.states, p.decay, p.L, p.H, p.G, p.Q};
  const StateArgs dlocal{dy, c, p.dt, p.a, p.dstates, nullptr, p.L, p.H, p.G, p.Q};
  const RecurrenceArgs fwd{p.states, p.decay, p.s0, p.s_last, p.H, p.nc, P * N};
  const RecurrenceArgs rev{p.dstates, p.decay, p.dfinal, p.ds0, p.H, p.nc, P * N};
  const dim3 per_tile(p.nc * p.H * tiles, p.B);
  if ((err = launch_chunk_state<P, N, kScaleToEnd>(local, p.B, p.nc, st)) != cudaSuccess ||
      (err = launch_state_pass<0>(fwd, p.B, st)) != cudaSuccess ||
      (err = launch_chunk_state<P, N, kScaleFromStart>(dlocal, p.B, p.nc, st)) != cudaSuccess ||
      (err = launch_state_pass<1>(rev, p.B, st)) != cudaSuccess)
    return err;
  ssd_bwd_tc_query<P, N><<<per_tile, kTcThreads, tile_bytes, st>>>(p, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int key_threads = 32 * KeyWarps<P, N>::value;
  ssd_bwd_tc_key<P, N><<<per_tile, key_threads, tile_bytes, st>>>(p, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sums(p, chunk, st);
}

template <int P>
int launch_n(Params& p, cudaStream_t st) {
  switch (p.N) {
    case 16: return static_cast<int>(launch_tc<P, 16>(p, st));
    case 32: return static_cast<int>(launch_tc<P, 32>(p, st));
    case 64: return static_cast<int>(launch_tc<P, 64>(p, st));
    case 128: return static_cast<int>(launch_tc<P, 128>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Floats of fp32 workspace ssd_bwd needs for these sizes.
long long ssd_bwd_workspace_floats(int B, int L, int H, int P, int N, int Q) {
  return static_cast<long long>(Workspace(B, L, H, P, N, Q).total());
}

// Launches on `stream` and returns the CUDA error code (0 on success).
// x, B, C, dy, dx, dB and dC are bf16. d, s0 and dfinal may be null (no skip
// term, zero initial state, zero final-state gradient); dd is null when d
// is, ds0 may be null. workspace holds ssd_bwd_workspace_floats(...)
// floats, 16-byte aligned. P and N must be one of 16, 32, 64, 128;
// 1 <= Q <= 1024; H % G == 0. The caller checks shapes, types, contiguity
// and 16-byte alignment of x, dy, B, C, s0 and dfinal.
int ssd_bwd(const void* x, const float* dt, const float* a, const void* b, const void* c,
            const float* d, const float* s0, const void* dy, const float* dfinal, void* dx,
            float* ddt, float* da, void* db, void* dc, float* dd, float* ds0, float* workspace,
            int B, int L, int H, int P, int G, int N, int Q, void* stream) {
  if (Q < 1 || Q > kMaxChunk || G < 1 || H % G != 0 || L < 1 || B < 1 || workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, a, b, c, d, s0, dy, dfinal, dx, ddt, da, db, dc, d != nullptr ? dd : nullptr, ds0};
  p.B = B;
  p.L = L;
  p.H = H;
  p.G = G;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.nc = (L + Q - 1) / Q;
  Workspace(B, L, H, P, N, Q).carve(workspace, p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_n<16>(p, st);
    case 32: return launch_n<32>(p, st);
    case 64: return launch_n<64>(p, st);
    case 128: return launch_n<128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
