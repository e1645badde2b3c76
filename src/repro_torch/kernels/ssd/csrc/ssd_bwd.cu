// Mamba-2 SSD chunked-scan backward for Hopper (sm_90a), bound to Python
// with ctypes.
//
// The JAX package has no TPU kernel for it: JAX differentiates
// src/repro/kernels/ssd/ref.py::ssd_reference through XLA. This is the
// backward of the CUDA forward in ssd_fwd.cu; its plain version is
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
// Design: a simple kernel that is right. Every product runs in fp32 on the
// CUDA cores from fp32 copies of the inputs in shared memory (bf16 x, B, C
// and dy are widened on load). Ten launches on the caller's stream, through
// one fp32 workspace the wrapper allocates (ssd_bwd_workspace_floats):
//   1. ssd_bwd_outer<.., 0>, one block per (b, h, chunk): the chunk's local
//      state sum_j w_j x_j B_j^T and its decay exp(cum_last);
//   2. ssd_bwd_state_pass: the forward recurrence, leaving S_prev of every
//      chunk and the final state (the carried states are recomputed: the
//      forward saves only its inputs);
//   3. ssd_bwd_outer<.., 1>: each chunk's sum_i exp(cum_i) dy_i C_i^T;
//   4. ssd_bwd_dstate_pass: the reverse recurrence, leaving G of every chunk
//      and the initial state's gradient;
//   5. ssd_bwd_query, one block per 64-row query tile: dC (per head) and the
//      query side of dcum;
//   6. ssd_bwd_key, one block per 64-row key tile: dx, dB (per head), the
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
// runs are bit-identical. Above the diagonal exp(cum_i - cum_j) can
// overflow, so it is selected to 0 there (and past a ragged chunk's end),
// never multiplied by a mask.
//
// What bounds it on the H100. At the training shape of mamba2-130m (B 8,
// L 4096, H 24, P 64, G 1, N 128, Q 256, bf16 x/B/C/dy) the backward needs
// about 168 GFLOP (per chunk, q(q+1)/2 (query, key) pairs at 2(3N + 2P)
// operations and 10 q N P for the five state products: 0.17 ms at the
// 989 TFLOP/s bf16 rate) and about 342 MB of inputs and outputs once each
// (0.10 ms at 3.35 TB/s): operations bound it.
// What the simple design leaves on the table: the products run on fp32
// CUDA cores (67 TFLOP/s, under a fifteenth of the tensor cores' rate) out
// of shared memory, read by scalar loads; the query and key passes each
// recompute the chunk's C B^T and dy x^T tiles (about 1.5 times the
// pairwise operations); the workspace's round trips (two (B, chunks, H, P,
// N) state arrays, 201 MB, and per-head dB and dC partials of (B, L, H, N),
// 805 MB, at the training shape) are several times the inputs' bytes; and
// with 140-200 KB of shared memory a block, one block runs per SM. Tensor
// cores with the forward's hi + lo bf16 split, and fused passes, are later
// work.
//
// Layouts as the forward: x, dy, dx (B, L, H, P); dt, ddt (B, L, H) fp32;
// a, D, da, dD (H,) fp32; B, C, dB, dC (B, L, G, N), head h reading group
// h / (H / G); states and their gradients (B, H, P, N) fp32. All contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTile = 64;       // rows of a query or key tile
constexpr int kMaxChunk = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
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

// The chunk a block works on. blockIdx.x = (z * H + h) * tiles + tile,
// blockIdx.y = b.
struct Chunk {
  int h, z, b, g, tile, c0, qlen, qpad;
  size_t row0;   // token row of the chunk's first row in (B * L)
  __device__ Chunk(const Params& p, int tiles) {
    tile = blockIdx.x % tiles;
    const int zh = blockIdx.x / tiles;
    h = zh % p.H;
    z = zh / p.H;
    b = blockIdx.y;
    g = h / (p.H / p.G);
    c0 = z * p.Q;
    qlen = min(p.Q, p.L - c0);
    qpad = round_up(qlen, kTile);
    row0 = (size_t)b * p.L + c0;
  }
  __device__ size_t bzh(const Params& p) const { return ((size_t)b * p.nc + z) * p.H + h; }
};

// The chunk's dt (0 past its end) and inclusive cumsum of dt * a in fp64,
// by every thread of the block: each sums a run of consecutive rows, thread
// 0 scans the runs' totals, and each adds its offset. s_tot holds kThreads
// doubles. Ends with a barrier.
__device__ __forceinline__ void chunk_scan(const Params& p, const Chunk& ch, double* s_cum,
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

// Rows [row0, row0 + kTile) of a chunk into shared memory as fp32 with row
// stride LD: row r of the chunk starts at src + r * stride and has W values.
// Rows at or past `nrows` are zero-filled.
template <typename T, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t stride, int row0,
                                          int nrows) {
  for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
    const int r = e / W, col = e % W;
    dst[r * LD + col] = row0 + r < nrows ? to_f(src[(size_t)(row0 + r) * stride + col]) : 0.f;
  }
}

// Sum over the 16 threads of each tile row (ty + 16 r) of v[r], added to
// out[row] by thread `row` (tid < 64), in a fixed order. s_red holds
// kTile x 17 doubles. Starts and ends with a barrier. The sums that feed
// dcum are kept in fp64: the reverse cumsum adds up to Q of them, and da
// weighs each row's dcum by its cum, which reaches a few hundred.
__device__ __forceinline__ void row_sum(const double (&v)[4], double* s_red, double* out) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) s_red[(ty + 16 * r) * 17 + tx] = v[r];
  __syncthreads();
  if (threadIdx.x < kTile) {
    double s = 0.0;
    for (int t = 0; t < 16; ++t) s += s_red[threadIdx.x * 17 + t];
    out[threadIdx.x] += s;
  }
  __syncthreads();
}

// ---- passes 1 and 3: a chunk's sum over its rows of s_r u_r v_r^T ----------
// MODE 0: u = x, v = B, s = w = exp(cum_last - cum) dt (the local state);
//         also writes the chunk's decay exp(cum_last).
// MODE 1: u = dy, v = C, s = exp(cum) (the state gradient's local term).
// Thread (ty, tx) owns output rows ty + 16 r and columns tx + 16 k.
template <typename T, int P, int N, int MODE>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_outer(Params p) {
  constexpr int RP = P / 16, CN = N / 16;
  extern __shared__ double smem_d[];
  const Chunk ch(p, 1);
  double* s_cum = smem_d;                                  // (qpad,)
  double* s_tot = s_cum + ch.qpad;                         // (kThreads,)
  float* s_dt = reinterpret_cast<float*>(s_tot + kThreads);  // (qpad,)
  float* s_scale = s_dt + ch.qpad;                         // (qpad,)
  float* s_u = s_scale + ch.qpad;                          // (kTile, P)
  float* s_v = s_u + kTile * P;                            // (kTile, N)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t urow = (size_t)p.H * P, vrow = (size_t)p.G * N;
  const T* u = static_cast<const T*>(MODE == 0 ? p.x : p.dy) + ch.row0 * urow + (size_t)ch.h * P;
  const T* v = static_cast<const T*>(MODE == 0 ? p.b : p.c) + ch.row0 * vrow + (size_t)ch.g * N;

  chunk_scan(p, ch, s_cum, s_dt, s_tot);
  const double cum_last = s_cum[ch.qlen - 1];
  for (int j = tid; j < ch.qpad; j += kThreads)
    s_scale[j] = MODE == 0 ? expf((float)(cum_last - s_cum[j])) * s_dt[j] : expf((float)s_cum[j]);
  if (MODE == 0 && tid == 0) p.decay[ch.bzh(p)] = expf((float)cum_last);

  float acc[RP][CN];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int k = 0; k < CN; ++k) acc[r][k] = 0.f;
  for (int j0 = 0; j0 < ch.qlen; j0 += kTile) {
    __syncthreads();   // the last tile is read (and s_scale is written)
    for (int e = tid; e < kTile * P; e += kThreads) {
      const int r = e / P, col = e % P;
      s_u[e] = j0 + r < ch.qlen ? to_f(u[(size_t)(j0 + r) * urow + col]) * s_scale[j0 + r] : 0.f;
    }
    load_tile<T, N, N>(s_v, v, vrow, j0, ch.qlen);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float uv[RP], vv[CN];
#pragma unroll
      for (int r = 0; r < RP; ++r) uv[r] = s_u[jj * P + ty + 16 * r];
#pragma unroll
      for (int k = 0; k < CN; ++k) vv[k] = s_v[jj * N + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int k = 0; k < CN; ++k) acc[r][k] = fmaf(uv[r], vv[k], acc[r][k]);
    }
  }
  float* out = (MODE == 0 ? p.states : p.dstates) + ch.bzh(p) * P * N;
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int k = 0; k < CN; ++k) out[(size_t)(ty + 16 * r) * N + tx + 16 * k] = acc[r][k];
}

// ---- passes 2 and 4: the recurrences over the chunks, one thread per state
// element of one (b, h) (blockIdx.y = b * H + h) ----------------------------
// Forward: S_prev,z = S_{z-1}; S_z = S_{z-1} exp(cum_last_z) + local_z, from
// the initial state. Replaces local_z by S_prev,z; writes the final state.
__global__ void __launch_bounds__(256) ssd_bwd_state_pass(Params p) {
  const int pn = p.P * p.N;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= pn) return;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  float* slot = p.states + ((size_t)b * p.nc * p.H + h) * pn + k;
  const size_t zstride = (size_t)p.H * pn;
  float s = p.s0 != nullptr ? p.s0[(size_t)bh * pn + k] : 0.f;
  for (int z = 0; z < p.nc; ++z) {
    const float local = slot[z * zstride];
    slot[z * zstride] = s;
    s = s * p.decay[((size_t)b * p.nc + z) * p.H + h] + local;
  }
  p.s_last[(size_t)bh * pn + k] = s;
}

// Reverse: G_z = dS_prev,z+1 (the final state's gradient for the last
// chunk); dS_prev,z = dlocal_z + exp(cum_last_z) G_z. Replaces dlocal_z by
// G_z; writes dS_prev,0, the initial state's gradient, when asked.
__global__ void __launch_bounds__(256) ssd_bwd_dstate_pass(Params p) {
  const int pn = p.P * p.N;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= pn) return;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  float* slot = p.dstates + ((size_t)b * p.nc * p.H + h) * pn + k;
  const size_t zstride = (size_t)p.H * pn;
  float g = p.dfinal != nullptr ? p.dfinal[(size_t)bh * pn + k] : 0.f;
  for (int z = p.nc - 1; z >= 0; --z) {
    const float local = slot[z * zstride];
    slot[z * zstride] = g;
    g = local + p.decay[((size_t)b * p.nc + z) * p.H + h] * g;
  }
  if (p.ds0 != nullptr) p.ds0[(size_t)bh * pn + k] = g;
}

// Shared memory of the tile passes: fp64 cum, scan totals, three per-row
// arrays and the row-sum scratch; then fp32 dt, one more per-row array and
// the tiles.
template <int P, int N>
struct TileSmem {
  static constexpr int LDP = P + 1, LDN = N + 1, LDT = kTile + 1;
  static size_t bytes(int q, int n_ptiles, int n_ntiles, int n_ttiles) {
    const size_t qpad = round_up(q, kTile);
    return sizeof(double) * (qpad + kThreads + 3 * kTile + kTile * 17) +
           sizeof(float) * (2 * qpad + (size_t)n_ptiles * kTile * LDP +
                            (size_t)n_ntiles * kTile * LDN + (size_t)n_ttiles * kTile * LDT);
  }
};

// ---- pass 5: the query side, one block per 64-row query tile -----------------
// dC_i = exp(cum_i) S_prev^T dy_i + sum_{j<=i} M_ij B_j (per head, into
// dc_part); dcum_i = C_i.(exp(cum_i) S_prev^T dy_i) + sum_j F_ij dt_j.
// Thread (ty, tx) owns rows ty + 16 r of the tile; its dC columns are
// tx + 16 k, and in a (query, key) tile pair its keys are tx + 16 k.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_query(Params p, int tiles) {
  using S = TileSmem<P, N>;
  constexpr int LDP = S::LDP, LDN = S::LDN, LDT = S::LDT;
  constexpr int CN = N / 16;
  constexpr int PT = P < kTile ? P : kTile;   // rows of S_prev per state tile
  extern __shared__ double smem_d[];
  const Chunk ch(p, tiles);
  const int i0 = ch.tile * kTile;
  if (i0 >= ch.qlen) return;
  double* s_cum = smem_d;
  double* s_tot = s_cum + ch.qpad;
  double* s_acc = s_tot + kThreads;        // (kTile,) dcum of the tile's rows
  double* s_red = s_acc + 3 * kTile;       // (kTile, 17)
  float* s_dt = reinterpret_cast<float*>(s_red + kTile * 17);
  float* s_ecum = s_dt + ch.qpad;          // (qpad,) exp(cum)
  float* s_dy = s_ecum + ch.qpad;          // (kTile, LDP)
  float* s_x = s_dy + kTile * LDP;         // (kTile, LDP)
  float* s_c = s_x + kTile * LDP;          // (kTile, LDN)
  float* s_b = s_c + kTile * LDN;          // (kTile, LDN): B tile or S_prev rows
  float* s_m = s_b + kTile * LDN;          // (kTile, LDT)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t xrow = (size_t)p.H * P, brow = (size_t)p.G * N;
  const size_t hoff = (size_t)ch.h * P, goff = (size_t)ch.g * N;
  const T* xc = static_cast<const T*>(p.x) + ch.row0 * xrow + hoff;
  const T* dyc = static_cast<const T*>(p.dy) + ch.row0 * xrow + hoff;
  const T* bc = static_cast<const T*>(p.b) + ch.row0 * brow + goff;
  const T* cc = static_cast<const T*>(p.c) + ch.row0 * brow + goff;

  chunk_scan(p, ch, s_cum, s_dt, s_tot);
  for (int j = tid; j < ch.qpad; j += kThreads) s_ecum[j] = expf((float)s_cum[j]);
  if (tid < kTile) s_acc[tid] = 0.0;
  load_tile<T, N, LDN>(s_c, cc, brow, i0, ch.qlen);
  load_tile<T, P, LDP>(s_dy, dyc, xrow, i0, ch.qlen);

  // carried state: acc[r][k] = sum_p dy[i][p] S_prev[p][n], PT rows of S_prev
  // at a time through s_b
  float acc[4][CN];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < CN; ++k) acc[r][k] = 0.f;
  const float* sp = p.states + ch.bzh(p) * P * N;
  for (int p0 = 0; p0 < P; p0 += PT) {
    __syncthreads();
    for (int e = tid; e < PT * N; e += kThreads) s_b[(e / N) * LDN + e % N] = sp[(size_t)p0 * N + e];
    __syncthreads();
#pragma unroll 4
    for (int pp = 0; pp < PT; ++pp) {
      float dv[4], sv[CN];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = s_dy[(ty + 16 * r) * LDP + p0 + pp];
#pragma unroll
      for (int k = 0; k < CN; ++k) sv[k] = s_b[pp * LDN + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < CN; ++k) acc[r][k] = fmaf(dv[r], sv[k], acc[r][k]);
    }
  }
  {
    double part[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = s_ecum[i0 + ty + 16 * r];
      part[r] = 0.0;
#pragma unroll
      for (int k = 0; k < CN; ++k) {
        acc[r][k] *= e;
        part[r] += (double)(s_c[(ty + 16 * r) * LDN + tx + 16 * k] * acc[r][k]);
      }
    }
    row_sum(part, s_red, s_acc);
  }

  // intra-chunk: key tiles at or below the diagonal
  for (int j0 = 0; j0 <= i0; j0 += kTile) {
    __syncthreads();   // the last key tile and M are read
    load_tile<T, N, LDN>(s_b, bc, brow, j0, ch.qlen);
    load_tile<T, P, LDP>(s_x, xc, xrow, j0, ch.qlen);
    __syncthreads();
    float sc[4][4], dot[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[r][k] = dot[r][k] = 0.f;
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
#pragma unroll 4
    for (int pp = 0; pp < P; ++pp) {
      float dv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = s_dy[(ty + 16 * r) * LDP + pp];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = s_x[(tx + 16 * k) * LDP + pp];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) dot[r][k] = fmaf(dv[r], xv[k], dot[r][k]);
    }
    double fdt[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      fdt[r] = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + tx + 16 * k;
        // select, never multiply by a mask: above the diagonal the exponent
        // is positive and exp can reach inf, and inf * 0 is NaN
        const bool live = j <= i && i < ch.qlen;
        const float ell = expf(live ? (float)(s_cum[i] - s_cum[j]) : 0.f);
        const float dtj = s_dt[j];
        s_m[(ty + 16 * r) * LDT + tx + 16 * k] = live ? dot[r][k] * ell * dtj : 0.f;
        fdt[r] += live ? (double)(ell * sc[r][k] * dot[r][k] * dtj) : 0.0;
      }
    }
    row_sum(fdt, s_red, s_acc);   // its barriers also publish s_m
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float mv[4], bv[CN];
#pragma unroll
      for (int r = 0; r < 4; ++r) mv[r] = s_m[(ty + 16 * r) * LDT + jj];
#pragma unroll
      for (int k = 0; k < CN; ++k) bv[k] = s_b[jj * LDN + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < CN; ++k) acc[r][k] = fmaf(mv[r], bv[k], acc[r][k]);
    }
  }

  const size_t rowh = ch.row0 * p.H + ch.h;   // (b, chunk row 0, h) in (B, L, H)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= ch.qlen) continue;
    float* out = p.dc_part + (rowh + (size_t)i * p.H) * N;
#pragma unroll
    for (int k = 0; k < CN; ++k) out[tx + 16 * k] = acc[r][k];
  }
  if (tid < kTile && i0 + tid < ch.qlen) p.dcum[rowh + (size_t)(i0 + tid) * p.H] = s_acc[tid];
}

// ---- pass 6: the key side, one block per 64-row key tile ---------------------
// dx_j = sum_{i>=j} gate_ij dy_i + w_j G B_j + D dy_j; dB_j (per head) =
// sum_{i>=j} M_ij C_i + w_j G^T x_j; ddt_j (direct) = sum_i F_ij +
// exp(cum_last - cum_j) x_j.G B_j; dcum_j += -dt_j sum_i F_ij - w_j
// x_j.G B_j; dd_rows_j = dy_j.x_j. Thread (ty, tx) owns key rows ty + 16 r
// of the tile for dx (columns tx + 16 k) and dB; in a (query, key) tile
// pair its queries are ty + 16 r and its keys tx + 16 k.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_key(Params p, int tiles) {
  using S = TileSmem<P, N>;
  constexpr int LDP = S::LDP, LDN = S::LDN, LDT = S::LDT;
  constexpr int CP = P / 16, CN = N / 16;
  constexpr int PT = P < kTile ? P : kTile;   // rows of G per state tile
  constexpr int KT = PT / 16;
  extern __shared__ double smem_d[];
  const Chunk ch(p, tiles);
  const int j0 = ch.tile * kTile;
  if (j0 >= ch.qlen) return;
  double* s_cum = smem_d;
  double* s_tot = s_cum + ch.qpad;
  double* s_dw = s_tot + kThreads;         // (kTile,) x_j.G B_j
  double* s_fcol = s_dw + kTile;           // (kTile,) sum_i F_ij
  double* s_ddr = s_fcol + kTile;          // (kTile,) dy_j.x_j
  double* s_red = s_ddr + kTile;           // (kTile, 17)
  float* s_dt = reinterpret_cast<float*>(s_red + kTile * 17);
  float* s_w = s_dt + ch.qpad;             // (qpad,) w = exp(cum_last - cum) dt
  float* s_dy = s_w + ch.qpad;             // (kTile, LDP)
  float* s_x = s_dy + kTile * LDP;         // (kTile, LDP)
  float* s_c = s_x + kTile * LDP;          // (kTile, LDN): C tile or G rows
  float* s_b = s_c + kTile * LDN;          // (kTile, LDN)
  float* s_gate = s_b + kTile * LDN;       // (kTile, LDT)
  float* s_m = s_gate + kTile * LDT;       // (kTile, LDT)
  float* s_f = s_m + kTile * LDT;          // (kTile, LDT)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t xrow = (size_t)p.H * P, brow = (size_t)p.G * N;
  const size_t hoff = (size_t)ch.h * P, goff = (size_t)ch.g * N;
  const T* xc = static_cast<const T*>(p.x) + ch.row0 * xrow + hoff;
  const T* dyc = static_cast<const T*>(p.dy) + ch.row0 * xrow + hoff;
  const T* bc = static_cast<const T*>(p.b) + ch.row0 * brow + goff;
  const T* cc = static_cast<const T*>(p.c) + ch.row0 * brow + goff;
  const float dskip = p.d != nullptr ? p.d[ch.h] : 0.f;

  chunk_scan(p, ch, s_cum, s_dt, s_tot);
  const double cum_last = s_cum[ch.qlen - 1];
  for (int j = tid; j < ch.qpad; j += kThreads)
    s_w[j] = expf((float)(cum_last - s_cum[j])) * s_dt[j];
  if (tid < kTile) s_dw[tid] = s_fcol[tid] = s_ddr[tid] = 0.0;
  load_tile<T, P, LDP>(s_x, xc, xrow, j0, ch.qlen);
  load_tile<T, N, LDN>(s_b, bc, brow, j0, ch.qlen);

  float dxa[4][CP], dba[4][CN];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < CP; ++k) dxa[r][k] = 0.f;
#pragma unroll
    for (int k = 0; k < CN; ++k) dba[r][k] = 0.f;
  }

  // the state handed on: G B_j and G^T x_j, PT rows of G at a time through s_c
  const float* gp = p.dstates + ch.bzh(p) * P * N;
  double dwp[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int p0 = 0; p0 < P; p0 += PT) {   // unrolled: dxa's column index is constant
    __syncthreads();
    for (int e = tid; e < PT * N; e += kThreads) s_c[(e / N) * LDN + e % N] = gp[(size_t)p0 * N + e];
    __syncthreads();
    // gb[r][kk] = sum_n B[j][n] G[p][n], j = ty + 16 r, p = p0 + tx + 16 kk
    float gb[4][KT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) gb[r][kk] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float bv[4], gv[KT];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = s_b[(ty + 16 * r) * LDN + n];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) gv[kk] = s_c[(tx + 16 * kk) * LDN + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) gb[r][kk] = fmaf(bv[r], gv[kk], gb[r][kk]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jr = ty + 16 * r;
      const float w = s_w[j0 + jr];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        dxa[r][p0 / 16 + kk] = fmaf(w, gb[r][kk], dxa[r][p0 / 16 + kk]);
        dwp[r] += (double)(s_x[jr * LDP + p0 + tx + 16 * kk] * gb[r][kk]);
      }
    }
    // dba[r][k] += w_j sum_{p in tile} x[j][p] G[p][n]
#pragma unroll 4
    for (int pp = 0; pp < PT; ++pp) {
      float xv[4], gv[CN];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = s_x[(ty + 16 * r) * LDP + p0 + pp] * s_w[j0 + ty + 16 * r];
#pragma unroll
      for (int k = 0; k < CN; ++k) gv[k] = s_c[pp * LDN + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < CN; ++k) dba[r][k] = fmaf(xv[r], gv[k], dba[r][k]);
    }
  }
  row_sum(dwp, s_red, s_dw);

  // intra-chunk: query tiles at or above the diagonal
  for (int i0 = j0; i0 < ch.qlen; i0 += kTile) {
    __syncthreads();   // the last query tile, gate, M and F are read
    load_tile<T, N, LDN>(s_c, cc, brow, i0, ch.qlen);
    load_tile<T, P, LDP>(s_dy, dyc, xrow, i0, ch.qlen);
    __syncthreads();
    float sc[4][4], dot[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[r][k] = dot[r][k] = 0.f;
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
#pragma unroll 4
    for (int pp = 0; pp < P; ++pp) {
      float dv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = s_dy[(ty + 16 * r) * LDP + pp];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = s_x[(tx + 16 * k) * LDP + pp];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) dot[r][k] = fmaf(dv[r], xv[k], dot[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + tx + 16 * k;
        const bool live = j <= i && i < ch.qlen;   // select, never multiply by a mask
        const float ell = expf(live ? (float)(s_cum[i] - s_cum[j]) : 0.f);
        const float dtj = s_dt[j];
        const int e = (ty + 16 * r) * LDT + tx + 16 * k;
        s_gate[e] = live ? ell * sc[r][k] * dtj : 0.f;
        s_m[e] = live ? dot[r][k] * ell * dtj : 0.f;
        s_f[e] = live ? ell * sc[r][k] * dot[r][k] : 0.f;
      }
    }
    __syncthreads();
    if (tid < kTile) {   // column sums of F, rows in order
      double s = 0.0;
      for (int ii = 0; ii < kTile; ++ii) s += (double)s_f[ii * LDT + tid];
      s_fcol[tid] += s;
    }
#pragma unroll 4
    for (int ii = 0; ii < kTile; ++ii) {
      float gv[4], mv[4], dv[CP], cv[CN];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        gv[r] = s_gate[ii * LDT + ty + 16 * r];
        mv[r] = s_m[ii * LDT + ty + 16 * r];
      }
#pragma unroll
      for (int k = 0; k < CP; ++k) dv[k] = s_dy[ii * LDP + tx + 16 * k];
#pragma unroll
      for (int k = 0; k < CN; ++k) cv[k] = s_c[ii * LDN + tx + 16 * k];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int k = 0; k < CP; ++k) dxa[r][k] = fmaf(gv[r], dv[k], dxa[r][k]);
#pragma unroll
        for (int k = 0; k < CN; ++k) dba[r][k] = fmaf(mv[r], cv[k], dba[r][k]);
      }
    }
    if (i0 == j0) {
      // the diagonal tile's dy rows are the key rows: skip term and dy.x
      double part[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jr = ty + 16 * r;
        part[r] = 0.0;
#pragma unroll
        for (int k = 0; k < CP; ++k) {
          const float dv = s_dy[jr * LDP + tx + 16 * k];
          dxa[r][k] = fmaf(dskip, dv, dxa[r][k]);
          part[r] += (double)(dv * s_x[jr * LDP + tx + 16 * k]);
        }
      }
      row_sum(part, s_red, s_ddr);
    }
  }
  __syncthreads();   // s_fcol is complete

  const size_t rowh = ch.row0 * p.H + ch.h;
  T* dxc = static_cast<T*>(p.dx) + ch.row0 * xrow + hoff;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j >= ch.qlen) continue;
#pragma unroll
    for (int k = 0; k < CP; ++k) store(dxc + (size_t)j * xrow + tx + 16 * k, dxa[r][k]);
    float* out = p.db_part + (rowh + (size_t)j * p.H) * N;
#pragma unroll
    for (int k = 0; k < CN; ++k) out[tx + 16 * k] = dba[r][k];
  }
  if (tid < kTile && j0 + tid < ch.qlen) {
    const int j = j0 + tid;
    const size_t o = rowh + (size_t)j * p.H;
    const double dw = s_dw[tid], fcol = s_fcol[tid];
    p.ddt[o] = (float)(fcol + (double)expf((float)(cum_last - s_cum[j])) * dw);
    p.dcum[o] += -(double)s_dt[j] * fcol - (double)s_w[j] * dw;   // pass 5 wrote the query side
    p.dd_rows[o] = (float)s_ddr[tid];
  }
}

// ---- pass 7: one block per (b, h, chunk) ------------------------------------
// dcum of the chunk's last row += <G, S_out>; dda = reverse cumsum of dcum
// (fp64); ddt += a dda; part_a = sum dt dda; part_d = sum dy.x.
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk(Params p) {
  extern __shared__ double smem_d[];
  const Chunk ch(p, 1);
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
  chunk_scan(p, ch, s_cum, s_dt, s_tot);

  // <G_z, S_out_z>: S_out_z is S_prev of the next chunk, or the final state
  const float* gz = p.dstates + ch.bzh(p) * pn;
  const float* so = ch.z + 1 < p.nc ? p.states + (ch.bzh(p) + p.H) * pn
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
    p.part_a[ch.bzh(p)] = (float)pa;
    p.part_d[ch.bzh(p)] = (float)pd;
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

template <typename T, int P, int N>
int launch(Params& p, cudaStream_t st) {
  using S = TileSmem<P, N>;
  const int qpad = round_up(p.Q, kTile), tiles = qpad / kTile;
  const size_t outer = sizeof(double) * (qpad + kThreads) +
                       sizeof(float) * (2 * (size_t)qpad + kTile * (P + N));
  const size_t query = S::bytes(p.Q, 2, 2, 1);
  const size_t key = S::bytes(p.Q, 2, 2, 3);
  const size_t chunk = sizeof(double) * (2 * (size_t)qpad + kThreads) + sizeof(float) * 2 * qpad;
  cudaError_t err;
  if ((err = set_smem(ssd_bwd_outer<T, P, N, 0>, outer)) != cudaSuccess ||
      (err = set_smem(ssd_bwd_outer<T, P, N, 1>, outer)) != cudaSuccess ||
      (err = set_smem(ssd_bwd_query<T, P, N>, query)) != cudaSuccess ||
      (err = set_smem(ssd_bwd_key<T, P, N>, key)) != cudaSuccess ||
      (err = set_smem(ssd_bwd_chunk, chunk)) != cudaSuccess)
    return static_cast<int>(err);
  const dim3 per_chunk(p.nc * p.H, p.B), per_tile(p.nc * p.H * tiles, p.B);
  const dim3 per_state((P * N + 255) / 256, p.B * p.H);
  ssd_bwd_outer<T, P, N, 0><<<per_chunk, kThreads, outer, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_state_pass<<<per_state, 256, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_outer<T, P, N, 1><<<per_chunk, kThreads, outer, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dstate_pass<<<per_state, 256, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_query<T, P, N><<<per_tile, kThreads, query, st>>>(p, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_key<T, P, N><<<per_tile, kThreads, key, st>>>(p, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk<<<per_chunk, kThreads, chunk, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int rows = p.B * p.L;
  const unsigned gsum = (unsigned)(((size_t)rows * p.G * N + 255) / 256);
  ssd_bwd_group_sum<T><<<gsum, 256, 0, st>>>(p.db_part, static_cast<T*>(p.db), rows, p.H, p.G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_group_sum<T><<<gsum, 256, 0, st>>>(p.dc_part, static_cast<T*>(p.dc), rows, p.H, p.G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_sum<<<(p.H + 127) / 128, 128, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_n(Params& p, cudaStream_t st) {
  switch (p.N) {
    case 16: return launch<T, P, 16>(p, st);
    case 32: return launch<T, P, 32>(p, st);
    case 64: return launch<T, P, 64>(p, st);
    case 128: return launch<T, P, 128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_p(Params& p, cudaStream_t st) {
  switch (p.P) {
    case 16: return launch_n<T, 16>(p, st);
    case 32: return launch_n<T, 32>(p, st);
    case 64: return launch_n<T, 64>(p, st);
    case 128: return launch_n<T, 128>(p, st);
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
// is_bf16: 1 for bf16 x/B/C/dy/dx/dB/dC, 0 for fp32. d, s0 and dfinal may
// be null (no skip term, zero initial state, zero final-state gradient);
// dd is null when d is, ds0 may be null. workspace holds
// ssd_bwd_workspace_floats(...) floats, 16-byte aligned. P and N must be
// one of 16, 32, 64, 128; 1 <= Q <= 1024; H % G == 0. The caller checks
// shapes, types and contiguity.
int ssd_bwd(const void* x, const float* dt, const float* a, const void* b, const void* c,
            const float* d, const float* s0, const void* dy, const float* dfinal, void* dx,
            float* ddt, float* da, void* db, void* dc, float* dd, float* ds0, float* workspace,
            int B, int L, int H, int P, int G, int N, int Q, int is_bf16, void* stream) {
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
  return is_bf16 ? launch_p<bf16>(p, st) : launch_p<float>(p, st);
}

const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
