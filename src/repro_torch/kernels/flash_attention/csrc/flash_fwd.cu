// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention): causal GQA attention with a
// blockwise online softmax, an aligned-end causal mask (query r sees keys
// <= r + (T - S)), an optional sliding window and an optional logit soft-cap
// softcap * tanh(s / softcap). Inputs and output are bf16; running max, sum
// and accumulator are fp32, and the output is acc / max(l, 1e-30). Given an
// lse pointer, it also writes each row's log-sum-exp of the scaled,
// soft-capped, masked scores, fp32 (B, H, S), in natural-log units (the base
// flash_bwd.cu reads): (m + log2(l)) ln 2, since the softmax runs in base 2.
// Serving passes a null pointer.
//
// Layouts: q and o are (B, S, H, D), k and v are (B, T, K, D), all
// contiguous. Query head h reads kv head h / (H / K).
//
// What bounds it on the H100. At the serving prefill shape (B 8, S = T 1024,
// H 24, K 8, D 128, bf16) the causal work is about 51.6 GFLOP (52 us at
// 989 TFLOP/s) and the bytes each input and output need once are about
// 134 MB (40 us at 3.35 TB/s), so it is bound by tensor-core operations,
// and only wgmma reaches the tensor cores' full rate on this card. The bf16
// design (flash_fwd_wgmma):
//   * a work item is 128 query rows of one (b, h): two consumer warpgroups
//     of 64 rows each and one producer warp. setmaxnreg moves registers from
//     the producer's warpgroup (40 each) to the consumers (232 each), which
//     hold the 64 x 128 score tile, the 64 x D output and P in registers;
//   * the producer issues TMA loads only: the Q tile once, then K and V
//     tiles of 128 keys into a two-stage ring guarded by full/empty mbarrier
//     pairs (K and V separately, so S = Q K^T starts before V lands). The
//     tensor maps are 4-D over (B, S, H, D) and (B, T, K, D), so a ragged
//     S or T is zero-filled by the hardware; rows are 128-byte swizzled
//     (64-byte at D 32) in 64-column panels, the layout wgmma reads. At
//     D 80 (zamba2-2.7b) a tile is two panels: the tensor maps' D extent is
//     80, so TMA fills columns 80-127 of the second panel with zeros;
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//     the online softmax stays in registers, in base 2 with scale * log2(e)
//     folded into one FFMA before ex2.approx; P is rounded to bf16 in
//     registers and is the register A operand of O += P V, where V is read
//     from shared memory as the MN-major (transposed) B operand;
//   * within a warpgroup, tile i's S = Q K^T and tile i - 1's O += P V are
//     issued back to back and the softmax of tile i runs while P V is on
//     the tensor cores; no wgmma is issued under a branch, because ptxas
//     serialises every wgmma of a kernel that does (warning C7520);
//   * only the key tiles an item's rows can see are loaded (the loop starts
//     at the window's first live tile and stops at the causal frontier),
//     and the masks (causal, window, ragged T) run only on tiles that cross
//     an edge. Rows past a ragged S are dropped at the store;
//   * the grid is persistent: one block per SM walks the work items
//     (128 query rows of one (b, h)) heaviest first, item blockIdx.x, then
//     + gridDim.x, ...; the producer loads the next item's Q and first K/V
//     tiles while the consumers finish the last P V and store, so a block's
//     prologue is paid once per SM, not once per item.
// What still separates it from the bound: both warpgroups can sit in their
// softmax at once while the tensor cores idle (ping-pong scheduling of the
// two on named barriers, as FlashAttention-3 does, measured no faster on
// an H100); the softmax's exponentials and conversions take issue slots the
// products need; and the output is stored from registers, not by TMA.
//
// At D 80 and D 120 the kernel is the D-128 kernel over zero-filled
// columns: S = Q K^T takes the (D + 15) / 16 k-steps that hold real columns
// (5; 8 at D 120, whose last is half zeros), but O += P V is one n128
// product per k-step, of which 128 - D columns are zeros dropped at the
// store (wgmma allows n80 or n120, but such a product reads a partial
// 128-byte swizzle atom of the MN-major V, which this first version does
// not risk), and shared memory holds the padded tiles. So P V does 1.6
// times the products it needs at D 80, 1.07 times at D 120.
//
// At D 256 (gemma2-2b) the D-128 tiling does not fit: Q (128 x 256) is 64
// KB and two stages of 128-key K and V tiles 256 KB more, over the 227 KB
// of shared memory; and a consumer's O (64 x 256 fp32, 128 registers a
// thread) beside a 128-key S and P would spill. So a K/V tile holds 64 keys
// (Q plus two stages: 192 KB), S = Q K^T is m64n64k16 over 16 k-steps, O +=
// P V two m64n128k16 per k-step (hopper.cuh's Wgmma<256>), and the
// consumers take 240 registers, the producer 24 (at 232 ptxas spilled and
// serialised the wgmma, C7512). Half the keys a tile doubles the softmax
// rounds and barrier waits per key, so D 256 stands further from its bound
// (operations) than D 128.
//
// D 224 (zamba2-7b's shared blocks, 7168 / 32) is the D-256 kernel over
// zero-filled columns, as D 80 is the D-128 one: four 64-column panels
// whose tensor maps' D extent is 224, so TMA fills columns 224-255 of the
// fourth with zeros; S = Q K^T takes the 14 k-steps of real columns, O +=
// P V runs at n256 (the last 32 columns of O stay 0 and are not stored).
// So P V does 1.14 times the products it needs; registers and shared
// memory are D 256's. The softmax scale is the caller's (Zamba-2 takes
// (D / 2)^-1/2), applied in fp32 in the exponent's FFMA, never to q in
// bf16.

#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

// Start of the running max: the TPU kernel's NEG_INF. Masked scores are
// -inf, so exp(masked - m) is 0 and no NaN arises from -inf - -inf.
constexpr float kMaxInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;      // (B, H, S) or null
  int S, T, H, K, B;
  int causal;
  int window;      // <= 0: no window
  float softcap;   // <= 0: no soft-cap
  float scale;
};

using flash_mask::key_range;

__device__ __forceinline__ bool visible(const Params& p, int r, int t) {
  return flash_mask::visible<false>(p, r, t);
}

// ---- bf16: wgmma + TMA, warp-specialised ----------------------------------

constexpr int kBQ = 128;           // query rows per block (two warpgroups of 64)
constexpr int kStages = 2;         // K/V ring depth
constexpr int kWgThreads = 384;    // consumer warpgroups 0 and 1, producer 2
// setmaxnreg: registers a producer and a consumer thread get (producer + 2
// consumers <= 512). At D 256 the consumers hold O's 128 fp32 accumulators
// beside S and P in flight; at 232 ptxas spilled and serialised the wgmma
// (C7512), so they take 240 and the producer 24.
template <int D>
struct Regs {
  static constexpr int PRODUCER = D > 128 ? 24 : 40;
  static constexpr int CONSUMER = D > 128 ? 240 : 232;
};

// Shared memory, from a 1024-byte aligned base: Q, then the K and V ring,
// then the barriers. Each tile is stored as DP / PANEL panels of rows of
// PANEL elements (one swizzle row each: 128 bytes, or 64 at D 32), where
// DP is D rounded up to whole panels (128 at D 80 and 120, 256 at D 224;
// the columns past D are TMA's zeros). BK keys a tile: 128, or 64 at D 256, where two
// stages of 128-key K and V tiles would not fit beside Q.
template <int D>
struct WgLayout {
  static constexpr int PANEL = D < 64 ? D : 64;
  static constexpr int DP = (D + PANEL - 1) / PANEL * PANEL;
  static constexpr int PANELS = DP / PANEL;
  static constexpr int BK = D > 128 ? 64 : 128;
  static constexpr int SWIZZLE = PANEL == 64 ? 1 : 2;   // wgmma code: 128 B, 64 B
  static constexpr int ROW_BYTES = PANEL * 2;
  static constexpr int Q_BYTES = kBQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 + 4 * kStages) * 8;
  static constexpr int LAUNCH_BYTES = BYTES + 1024;   // room to align the base
  static_assert(LAUNCH_BYTES <= 232448, "over the 227 KB a block may use");
  static_assert(D % 8 == 0 && (DP == D || DP == 128 || DP == 256),
                "a head dim wgmma takes");
};

// One consumer warpgroup's view of the block: its rows, the softmax
// constants and the shared-memory addresses of Q and of the K/V ring.
template <int D>
struct Consumer {
  using Lay = WgLayout<D>;
  static constexpr int PANEL = Lay::PANEL, ROW = Lay::ROW_BYTES, DP = Lay::DP, kBK = Lay::BK;
  const Params& p;
  uint32_t q_addr, k_base, v_base;
  int r0, row_lo, row_hi, c2, shift;
  bool softcap;
  float mult, cap_in, cap_out;

  // S (64 x BK fp32 fragment) = Q K^T for the K tile in ring slot `stage`,
  // over the k-steps of 16 columns that hold real columns (at D 120 the
  // eighth is half TMA's zeros; D / 16 would drop columns 112-119).
  __device__ __forceinline__ void qk(float (&s)[kBK / 2], int stage) const {
    const uint32_t k_addr = k_base + stage * Lay::KV_BYTES;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk) {
      const uint32_t off = (kk * 16 % PANEL) * 2;   // bytes into the swizzled row
      const uint32_t panel = kk * 16 / PANEL;
      const uint64_t da = wgmma_desc(q_addr + panel * kBQ * ROW + off, 16, 8 * ROW,
                                     Lay::SWIZZLE);
      const uint64_t db = wgmma_desc(k_addr + panel * kBK * ROW + off, 16, 8 * ROW,
                                     Lay::SWIZZLE);
      Wgmma<kBK>::ss(s, da, db, kk > 0);
    }
    wgmma_commit();
  }

  // O += P V for the V tile in ring slot `stage`; P in registers (bf16).
  // O spans the DP columns of the padded tile.
  __device__ __forceinline__ void pv(float (&o)[DP / 2], uint32_t (&pf)[kBK / 16][4],
                                     int stage) const {
    const uint32_t v_addr = v_base + stage * Lay::KV_BYTES;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // V rows kk*16.. of every panel: LBO steps across panels (along D),
      // SBO across groups of 8 keys
      const uint64_t db = wgmma_desc(v_addr + kk * 16 * ROW, kBK * ROW, 8 * ROW, Lay::SWIZZLE);
      Wgmma<DP>::rs_trans_b(o, pf[kk], db, 1);
    }
    wgmma_commit();
  }

  // Online softmax of the scores of the key tile at t0, in place: s becomes
  // P, m and l move to the tile, alpha is the factor O must take. The masks
  // run only where the tile crosses an edge (causal, window, ragged T); a
  // tile no row sees leaves m, l and alpha = 1 as they were, with P = 0.
  __device__ __forceinline__ void softmax(float (&s)[kBK / 2], int t0, float (&m)[2],
                                          float (&l)[2], float (&alpha)[2]) const {
    const bool edge = t0 + kBK > p.T ||
                      (p.causal && (t0 + kBK - 1 > r0 + shift ||
                                    (p.window > 0 && t0 <= r0 + 63 + shift - p.window)));
    if (softcap) {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) s[j] = cap_out * tanhf(s[j] * cap_in);
    }
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? row_lo : row_hi;
          if (!visible(p, r, t0 + j * 8 + c2 + (e & 1))) s[4 * j + e] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) mx[(j / 2) & 1] = fmaxf(mx[(j / 2) & 1], s[j]);
    float neg_m[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * mult);
      alpha[r] = ex2_approx(m[r] - m_new);
      m[r] = m_new;
      neg_m[r] = -m_new;
    }
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int r = (j / 2) & 1;
      s[j] = ex2_approx(fmaf(s[j], mult, neg_m[r]));
      rs[r] += s[j];
    }
    // l holds this thread's partial row sums; alpha is uniform per row, so
    // the four partials are reduced once, after the sweep.
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
  }
};

// One block's unit of work: 128 query rows of one (b, h), over key tiles
// of kBK. Work items are numbered heaviest first (the last query tile of
// every (b, h), then the one before, ...), and a block takes items
// blockIdx.x, + gridDim.x, ...
template <int kBK>
struct WorkItem {
  int q0, h, b, t_begin, n_tiles;
  __device__ WorkItem(const Params& p, int w, int nq) {
    const int hb = w % (p.H * p.B);
    q0 = (nq - 1 - w / (p.H * p.B)) * kBQ;
    h = hb % p.H;
    b = hb / p.H;
    int t_end;
    key_range(p, q0, min(q0 + kBQ, p.S), kBK, t_begin, t_end);
    n_tiles = (t_end - t_begin + kBK - 1) / kBK;
  }
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, Params p) {
  using Lay = WgLayout<D>;
  constexpr int PANEL = Lay::PANEL, ROW = Lay::ROW_BYTES, DP = Lay::DP, kBK = Lay::BK;
  using Work = WorkItem<kBK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  bf16* q_s = reinterpret_cast<bf16*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Lay::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  const int nq = (p.S + kBQ - 1) / kBQ, n_work = nq * p.H * p.B;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);         // lane 0 of each consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);
      mbar_init(&v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // K/V tiles are numbered across the block's work items (`it`), so the
  // ring's stage and phase run on from one item to the next; Q's barriers
  // turn once per item (`tc`).
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    setmaxnreg_dec<Regs<D>::PRODUCER>();
    if (threadIdx.x == 256) {
      int it = 0, tc = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++tc) {
        const Work t(p, w, nq);
        const int kh = t.h / (p.H / p.K);
        mbar_wait(q_empty, (tc & 1) ^ 1);   // the last item's S products are done
        mbar_arrive_expect_tx(q_full, Lay::Q_BYTES);
#pragma unroll
        for (int pn = 0; pn < Lay::PANELS; ++pn)
          tma_load_4d(q_s + pn * kBQ * PANEL, &tm_q, q_full, pn * PANEL, t.h, t.q0, t.b);
        for (int i = 0; i < t.n_tiles; ++i, ++it) {
          const int stage = it % kStages, parity = ((it / kStages) & 1) ^ 1;
          const int t0 = t.t_begin + i * kBK;
          bf16* k_s = reinterpret_cast<bf16*>(base + Lay::K_OFF + stage * Lay::KV_BYTES);
          bf16* v_s = reinterpret_cast<bf16*>(base + Lay::V_OFF + stage * Lay::KV_BYTES);
          mbar_wait(&k_empty[stage], parity);
          mbar_arrive_expect_tx(&k_full[stage], Lay::KV_BYTES);
#pragma unroll
          for (int pn = 0; pn < Lay::PANELS; ++pn)
            tma_load_4d(k_s + pn * kBK * PANEL, &tm_k, &k_full[stage], pn * PANEL, kh, t0, t.b);
          mbar_wait(&v_empty[stage], parity);
          mbar_arrive_expect_tx(&v_full[stage], Lay::KV_BYTES);
#pragma unroll
          for (int pn = 0; pn < Lay::PANELS; ++pn)
            tma_load_4d(v_s + pn * kBK * PANEL, &tm_v, &v_full[stage], pn * PANEL, kh, t0, t.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    setmaxnreg_inc<Regs<D>::CONSUMER>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    Consumer<D> cw{p};
    cw.q_addr = smem_addr(q_s) + wg * 64 * ROW;
    cw.k_base = smem_addr(base + Lay::K_OFF);
    cw.v_base = smem_addr(base + Lay::V_OFF);
    cw.c2 = (lane % 4) * 2;
    cw.shift = p.T - p.S;
    cw.softcap = p.softcap > 0.f;
    // base-2 logits: x * mult, where x is the raw score, or the soft-capped
    // score already multiplied by log2(e) (mult 1)
    cw.mult = cw.softcap ? 1.f : p.scale * kLog2e;
    cw.cap_in = p.scale / p.softcap;
    cw.cap_out = p.softcap * kLog2e;
    const int c2 = cw.c2;
    const size_t q_stride = (size_t)p.H * D;

    int it = 0, tc = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++tc) {
      const Work t(p, w, nq);
      cw.r0 = t.q0 + 64 * wg;
      cw.row_lo = cw.r0 + 16 * warp + lane / 4;
      cw.row_hi = cw.row_lo + 8;

      float o[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
      float m[2] = {kMaxInit, kMaxInit}, l[2] = {0.f, 0.f}, alpha[2];
      float s[kBK / 2];          // scores of tile i, then its probabilities
      uint32_t pf[kBK / 16][4];  // P of tile i - 1 in bf16, the A operand of P V

      // Tile i's products overlap tile i - 1's: S_i = Q K_i^T and O = alpha
      // O + P_{i-1} V_{i-1} are issued back to back, and the softmax of S_i
      // runs while the second is on the tensor cores. No product is issued
      // under a branch (ptxas would serialise every wgmma): a tile that no
      // row of this warpgroup sees is multiplied and masked like any edge
      // tile.
      mbar_wait(q_full, tc & 1);
      mbar_wait(&k_full[it % kStages], (it / kStages) & 1);
      cw.qk(s, it % kStages);
      wgmma_wait<0>();
      fence_regs(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[it % kStages]);
      cw.softmax(s, t.t_begin, m, l, alpha);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pf[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
        pf[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
        pf[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
        pf[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      }
      for (int i = 1; i < t.n_tiles; ++i) {
        const int cur = it + i, prev = cur - 1;
        const int stage = cur % kStages, pstage = prev % kStages;
        mbar_wait(&k_full[stage], (cur / kStages) & 1);
        cw.qk(s, stage);                                  // S_i
#pragma unroll
        for (int j = 0; j < DP / 2; ++j) o[j] *= alpha[(j / 2) & 1];
        mbar_wait(&v_full[pstage], (prev / kStages) & 1);
        cw.pv(o, pf, pstage);                             // O += P_{i-1} V_{i-1}
        wgmma_wait<1>();                                  // S_i is done
        fence_regs(s);
        __syncwarp();
        if (lane == 0) mbar_arrive(&k_empty[stage]);
        cw.softmax(s, t.t_begin + i * kBK, m, l, alpha);
        wgmma_wait<0>();                                  // P_{i-1} V_{i-1} is done
        fence_regs(o);
        fence_regs(pf);
        __syncwarp();
        if (lane == 0) mbar_arrive(&v_empty[pstage]);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          pf[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
          pf[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
          pf[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
          pf[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
        }
      }
      // every S product of this item is done: the producer may load the
      // next item's Q while this one's last P V and its store run
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
      {
        const int last = it + t.n_tiles - 1, stage = last % kStages;
#pragma unroll
        for (int j = 0; j < DP / 2; ++j) o[j] *= alpha[(j / 2) & 1];
        mbar_wait(&v_full[stage], (last / kStages) & 1);
        cw.pv(o, pf, stage);
        wgmma_wait<0>();
        fence_regs(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(&v_empty[stage]);
      }
      it += t.n_tiles;

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
      bf16* ob = static_cast<bf16*>(p.o) + ((size_t)t.b * p.S * p.H + t.h) * D;
      const int row_lo = cw.row_lo, row_hi = cw.row_hi;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (row_lo < p.S)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row_lo * q_stride + j * 8 + c2) =
              pack_bf16x2(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
        if (row_hi < p.S)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row_hi * q_stride + j * 8 + c2) =
              pack_bf16x2(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
      }
      // after the item's last wgmma, and under no branch that encloses one
      if (p.lse != nullptr && c2 == 0) {
        float* lb = p.lse + ((size_t)t.b * p.H + t.h) * p.S;
        if (row_lo < p.S) lb[row_lo] = (m[0] + log2f(fmaxf(l[0], 1e-30f))) * kLn2;
        if (row_hi < p.S) lb[row_hi] = (m[1] + log2f(fmaxf(l[1], 1e-30f))) * kLn2;
      }
    }
  }
}

template <int D>
int launch_wgmma(const Params& p, int B, cudaStream_t st) {
  using Lay = WgLayout<D>;
  const CUtensorMapSwizzle swizzle =
      Lay::PANEL == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = encode_bf16_4d(&tm_q, p.q, D, p.H, p.S, B, Lay::PANEL, kBQ, swizzle);
  if (rc == 0) rc = encode_bf16_4d(&tm_k, p.k, D, p.K, p.T, B, Lay::PANEL, Lay::BK, swizzle);
  if (rc == 0) rc = encode_bf16_4d(&tm_v, p.v, D, p.K, p.T, B, Lay::PANEL, Lay::BK, swizzle);
  if (rc != 0) return rc;
  // persistent: one block per SM, each walking its share of the work items
  int dev = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::LAUNCH_BYTES);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_work = (p.S + kBQ - 1) / kBQ * p.H * B;
  flash_fwd_wgmma<D><<<min(n_work, sms), kWgThreads, Lay::LAUNCH_BYTES, st>>>(tm_q, tm_k, tm_v,
                                                                              p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns a CUDA error code (0 on success).
// q, k, v and o are bf16. window <= 0 and softcap <= 0 mean "none". lse:
// fp32 (B, H, S) or null. The caller checks shapes, types, contiguity and
// 16-byte alignment.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int S, int T, int H, int K, int D,
                        int causal, int window, float softcap,
                        float scale, void* stream) {
  Params p{q, k, v, o, static_cast<float*>(lse), S, T, H, K, B, causal, window,
           softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_wgmma<32>(p, B, st);
    case 64: return launch_wgmma<64>(p, B, st);
    case 80: return launch_wgmma<80>(p, B, st);
    case 120: return launch_wgmma<120>(p, B, st);
    case 128: return launch_wgmma<128>(p, B, st);
    case 224: return launch_wgmma<224>(p, B, st);
    case 256: return launch_wgmma<256>(p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
