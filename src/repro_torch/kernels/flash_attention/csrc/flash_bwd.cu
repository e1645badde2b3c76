// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// The JAX package has no TPU kernel for this: its training differentiates
// chunked_attention through XLA, and its Pallas kernel
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel) is a forward
// only. The port's attention runs the hand-written forward (flash_fwd.cu)
// on the card, so its gradient is a hand-written kernel too. It takes what
// the forward takes: causal GQA attention with aligned ends (query r sees
// keys <= r + (T - S)), an optional sliding window and an optional logit
// soft-cap softcap * tanh(s / softcap), D in {32, 64, 80, 120, 128, 224,
// 256}, bf16, and the softmax scale the caller gives.
//
// Inputs q, o, dO (B, S, H, D); k, v (B, T, K, D); lse (B, H, S) fp32, the
// natural-log log-sum-exp of each row's scaled, soft-capped and masked
// scores that the forward writes. Outputs dq (B, S, H, D), dk, dv
// (B, T, K, D) in bf16. All contiguous, 16-byte aligned. Query
// head h reads kv head h / (H / K).
//
// With x = scale q.k, s = softcap tanh(x / softcap) (or x), P = exp(s - lse)
// on visible pairs and 0 elsewhere, and Delta = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta) o (1 - tanh^2(x / softcap)),
//   dQ = scale dS K,  dK = scale dS^T Q.
// Three launches on the caller's stream, all deterministic (no atomics):
// Delta (flash_bwd_preprocess, one warp per row), then dK/dV, then dQ.
// Masked pairs get P = 0 by selection, never by multiplying with a mask:
// exp above the diagonal can overflow, and 0 * inf is NaN.
//
// What bounds it on the H100. At the training shape of llama3.2-3b (B 2,
// S = T 2048, H 24, K 8, D 128, bf16, causal) the backward's five
// S x T x D products over the visible pairs are about 129 GFLOP (130 us at
// 989 TFLOP/s), against about 135 MB of inputs and outputs (40 us at
// 3.35 TB/s): it is bound by tensor-core operations, and only wgmma reaches
// their full rate on this card. The bf16 design follows the forward's
// (flash_fwd_wgmma): one producer warp issues TMA loads only, through 4-D
// tensor maps that zero-fill a ragged S or T, into 64-column panels with
// a 128-byte swizzle (64-byte at D 32); full/empty mbarrier rings; two
// consumer warpgroups get the producer's registers by setmaxnreg (240 a
// consumer thread in dK/dV, 232 in dQ); masks run only on tiles that
// cross an edge; no wgmma is issued under a branch (ptxas would serialise
// every wgmma of the kernel, warning C7520). The two passes:
//   * flash_bwd_dkdv_wgmma: a block per (b, kv head, 128 keys), heaviest
//     first (the early key tiles see the most causal rows); each consumer
//     warpgroup owns 64 keys. K and V are loaded once; the producer streams
//     (Q, dO) tiles of 64 query rows, with those rows' LSE log2(e) and
//     Delta, for each query head of the GQA group and each live query
//     tile, through a three-stage ring. Per tile, S^T = K Q^T and
//     dP^T = V dO^T are wgmma m64n64k16 from shared memory; P^T is formed
//     in registers while dP^T is on the tensor cores, dS^T while dV is;
//     dV += P^T dO and dK += dS^T Q are wgmma m64nDk16 with P^T and dS^T
//     as the bf16 register operand and dO, Q read MN-major (transposed)
//     from shared memory. dK and dV sum over the group in registers and
//     are written once;
//   * flash_bwd_dq_wgmma: a block per (b, h, 128 query rows), heaviest
//     (last) first, 64 rows per consumer warpgroup. Q and dO are loaded
//     once; K and V tiles of 128 keys stream over the live range through a
//     two-stage ring. S = Q K^T and dP = dO V^T are wgmma m64n128k16, P is
//     formed while dP is on the tensor cores, and dQ += dS K is wgmma
//     m64nDk16 with K read MN-major. dQ is written once.
// What still separates it from the bound: S and dP are computed in both
// passes (seven products where five are counted; one pass would need a
// deterministic sum of dQ across key tiles); within a warpgroup a tile's
// products wait for its elementwise work, so only the other warpgroup's
// products overlap it (issuing the next tile's S and dP before the last
// product of this one needs more registers than a consumer has: ptxas
// then serialises the wgmma, C7512, and both passes ran slower); the two
// warpgroups are not scheduled in ping-pong; a block is not persistent,
// so each pays its own prologue; outputs are stored from registers, not
// by TMA.
//
// D 120 (h2o-danube-3-4b) runs the D-128 design on tiles padded to 128
// columns (Panels::DP): TMA fills columns 120-127 with zeros, the products
// over D take 8 k-steps, the accumulators span 128 columns whose last 8
// stay 0, and the stores write the 120 real ones. So the padding costs
// 1.07 times the products, as in the forward. D 80 (zamba2-2.7b's shared
// block, 2560 / 32) pads the same way: two 64-column panels whose columns
// 80-127 TMA fills with zeros, 5 k-steps over D, and stores of the 80 real
// columns (10 of the 16 column groups). The products with an N of D (dV,
// dK, dQ) run at n128, so 48 of their 128 columns (37.5%) are zeros: the
// padding costs 1.6 times those three products and 1.35 times the five.
//
// D 256 (gemma2-2b) does not fit the D-128 split. In dK/dV a warpgroup
// owning 64 keys would hold dK and dV of 64 x 256 each, 256 fp32 registers
// a thread, over the 240 a consumer gets; and 128 keys of K and V (128 KB)
// beside three (Q, dO) stages (192 KB) are over 227 KB. So
// flash_bwd_dkdv_split_wgmma takes blocks of 64 keys whose two warpgroups
// split D (128 columns of dK and dV each, 128 registers) and compute S^T
// and dP^T once, one each, exchanged through shared memory (fp32 dP^T -
// Delta one way, bf16 P^T and dS^T back), two stages: 226 KB. The dQ pass
// keeps 128 query rows (Q and dO 64 KB each) and streams 32-key tiles of K
// and V through its two stages (S and dP m64n32k16; dQ += dS K two
// m64n128k16 a k-step): 192 KB. What bounds these: the exchange serialises
// the warpgroups' elementwise work with each other's products, and 32-key
// products run the tensor cores at a quarter of their width.
//
// D 224 (zamba2-7b's shared blocks) runs the D-256 design on tiles padded
// to 256 columns (Panels::DP): TMA fills columns 224-255 of the fourth
// panel with zeros, the products over D take 14 k-steps, and the stores
// write the 224 real columns: in the split dK/dV pass warpgroup 1 owns
// columns 128-255 and stores 128-223, the dQ pass stores 28 of its 32
// column groups. The products with an N of D run at n128 pairs over 256
// columns, so the padding costs 1.14 times those three.

#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// ---- 1. Delta = rowsum(dO o O) ---------------------------------------------

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

// ---- bf16: wgmma + TMA, warp-specialised ------------------------------------

constexpr int kWgThreads = 384;    // consumer warpgroups 0 and 1, producer 2
// setmaxnreg moves registers from the producer's warpgroup to the two
// consumer warpgroups (producer + 2 consumers = 64512 a block). Both passes
// hold 192 fp32 accumulators a consumer thread at D 128; with 240 ptxas
// spills one register of the dQ consumer at D 64, with 232 none, and the
// dK/dV consumer spills at 232 (PERF.md).
constexpr int kDkdvProducerRegs = 24;
constexpr int kDkdvConsumerRegs = 240;
constexpr int kDqProducerRegs = 40;
constexpr int kDqConsumerRegs = 232;
constexpr int kQTile = 64;         // dkdv: query rows per step
constexpr int kRows = 128;         // dq: query rows per block, 64 per warpgroup
constexpr int kDqStages = 2;       // dq: (K, V) ring depth

// A tile of `rows` rows of D bf16 is stored as PANELS panels of `rows` rows
// of PANEL elements, one swizzle row each (128 bytes, or 64 at D 32). DP is
// D rounded up to whole panels: at D 80 and 120 a tile is two panels, and
// TMA fills columns D-127 with zeros (the tensor maps' D extent is D), so
// every product over D runs on the D-128 tiles and the zeros add nothing;
// stores write the real columns only. KSTEPS is the k-steps of 16 columns
// that hold real columns ((D + 15) / 16: D / 16 would drop 112-119 at
// D 120; 5 at D 80).
template <int D>
struct Panels {
  static constexpr int PANEL = D < 64 ? D : 64;
  static constexpr int DP = (D + PANEL - 1) / PANEL * PANEL;
  static constexpr int PANELS = DP / PANEL;
  static constexpr int KSTEPS = (D + 15) / 16;
  static constexpr int SWIZZLE = PANEL == 64 ? 1 : 2;   // wgmma code: 128 B, 64 B
  static constexpr int ROW = PANEL * 2;                 // bytes
  static_assert(D % 8 == 0 && (DP == D || DP == 128 || DP == 256),
                "a head dim wgmma takes");
};

// Keys per dK/dV block and per dQ step. D <= 128: 128 and 128. D 256: the
// dK/dV block takes 64 keys (flash_bwd_dkdv_split_wgmma) and the dQ pass
// 32-key tiles, so that two stages of K and V fit beside its 128-row Q and
// dO (64 KB each at D 256).
template <int D>
struct Tiles {
  static constexpr int KEYS = D > 128 ? 64 : 128;
  static constexpr int KT = D > 128 ? 32 : 128;
};

// wgmma descriptor of a K-major operand: rows row0.. of a tile of `rows`
// rows at `tile`, columns 16 kk .. 16 kk + 15.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0, int kk) {
  using L = Panels<D>;
  return wgmma_desc(tile + (kk * 16 / L::PANEL) * rows * L::ROW + row0 * L::ROW +
                        (kk * 16 % L::PANEL) * 2,
                    16, 8 * L::ROW, L::SWIZZLE);
}

// wgmma descriptor of an MN-major (transposed) operand: rows 16 kk ..
// 16 kk + 15 of a tile of `rows` rows, all D columns; LBO steps across
// panels (along D), SBO across groups of 8 rows.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using L = Panels<D>;
  return wgmma_desc(tile + kk * 16 * L::ROW, rows * L::ROW, 8 * L::ROW, L::SWIZZLE);
}

// TMA: `rows` rows of one head from row0, all D columns, into `dst` as panels.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int head, int row0, int b) {
  using L = Panels<D>;
#pragma unroll
  for (int pn = 0; pn < L::PANELS; ++pn)
    tma_load_4d(dst + pn * rows * L::ROW, map, bar, pn * L::PANEL, head, row0, b);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// The softmax constants of a consumer: a base-2 logit is x * mult for the
// raw product x (mult = scale log2(e)) or, with a soft-cap, th * cap_out
// for th = tanh(x * cap_in) (cap_in = scale / softcap, cap_out = softcap
// log2(e)), whose dcap is 1 - th^2.
struct Logits {
  bool softcap;
  float mult, cap_in, cap_out;
  __device__ explicit Logits(const Params& p)
      : softcap(p.softcap > 0.f), mult(p.scale * kLog2e), cap_in(p.scale / p.softcap),
        cap_out(p.softcap * kLog2e) {}
  // P = 2^(logit - lse2) of one raw product x, and dcap.
  __device__ __forceinline__ float prob(float x, float lse2, float& dcap) const {
    if (softcap) {
      const float th = tanhf(x * cap_in);
      dcap = fmaf(-th, th, 1.f);
      return ex2_approx(fmaf(th, cap_out, -lse2));
    }
    dcap = 1.f;
    return ex2_approx(fmaf(x, mult, -lse2));
  }
};

// Whether a warpgroup's tile (rows r0 .. r0 + nr - 1, keys t0 .. t0 + nt - 1)
// crosses an edge: a ragged S or T, the causal diagonal or the window.
__device__ __forceinline__ bool edge_tile(const Params& p, int r0, int nr, int t0, int nt) {
  const int shift = p.T - p.S;
  return t0 + nt > p.T || r0 + nr > p.S ||
         (p.causal && (t0 + nt - 1 > r0 + shift ||
                       (p.window > 0 && t0 <= r0 + nr - 1 + shift - p.window)));
}

// ---- 2. dK, dV ----------------------------------------------------------------

// Shared memory of a dK/dV block: its KEYS keys of K and V, a ring of STAGES
// (Q, dO, LSE log2(e), Delta) steps of kQTile query rows, then (split only)
// the exchange between the two warpgroups, then the barriers.
template <int D, int KEYS, int STAGES, bool SPLIT>
struct DkdvLayout {
  using L = Panels<D>;
  static constexpr int kKeys = KEYS, kStages = STAGES;
  static constexpr int KV_BYTES = KEYS * L::DP * 2;
  static constexpr int QT_BYTES = kQTile * L::DP * 2;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;                       // [stage] Q tile
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;         // [stage] dO tile
  static constexpr int LSE_OFF = DO_OFF + STAGES * QT_BYTES;       // [stage][kQTile] lse log2(e)
  static constexpr int DL_OFF = LSE_OFF + STAGES * kQTile * 4;     // [stage][kQTile] Delta
  // split: [32][128] fp32, dP^T - Delta by fragment element and thread;
  // then [32][128] u32, the bf16 A fragments of P^T (16) and dS^T (16)
  static constexpr int X_OFF = DL_OFF + STAGES * kQTile * 4;
  static constexpr int PD_OFF = X_OFF + (SPLIT ? 32 * 128 * 4 : 0);
  static constexpr int BAR_OFF = PD_OFF + (SPLIT ? 32 * 128 * 4 : 0);
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8;
  static constexpr int LAUNCH_BYTES = BYTES + 1024;   // room to align the base
  static_assert(LAUNCH_BYTES <= 232448, "over the 227 KB a block may use");
};

// D <= 128: 128 keys a block, 64 per warpgroup, three stages.
template <int D>
using DkdvPairLayout = DkdvLayout<D, Tiles<D>::KEYS, 3, false>;
// D 256: 64 keys a block shared by both warpgroups, two stages.
template <int D>
using DkdvSplitLayout = DkdvLayout<D, Tiles<D>::KEYS, 2, true>;

// One block's work: kKeys keys of one (b, kv head). Blocks are numbered
// heaviest first: key tile 0 of every (b, kv head), then tile 1, ...
template <int kKeys>
struct DkdvWork {
  int t0, kh, b, r_begin, n_q, n_steps;
  __device__ explicit DkdvWork(const Params& p) {
    const int kb = blockIdx.x % (p.K * p.B);
    t0 = blockIdx.x / (p.K * p.B) * kKeys;
    kh = kb % p.K;
    b = kb / p.K;
    int r_end;
    query_range(p, t0, min(p.T, t0 + kKeys), kQTile, r_begin, r_end);
    n_q = r_end > r_begin ? (r_end - r_begin + kQTile - 1) / kQTile : 0;
    n_steps = n_q * (p.H / p.K);   // step i: head kh * group + i / n_q, tile i % n_q
  }
};

template <class Lay>
__device__ __forceinline__ void dkdv_init_barriers(unsigned char* base) {
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + Lay::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + Lay::kStages;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < Lay::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);     // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The dK/dV producer warp: its lanes copy LSE and Delta, lane 0 issues TMA:
// K and V once, then the (Q, dO) steps of every query head of the group.
template <int D, class Lay>
__device__ __forceinline__ void dkdv_producer(const Params& p, const DkdvWork<Lay::kKeys>& w,
                                              unsigned char* base, const CUtensorMap* tm_q,
                                              const CUtensorMap* tm_do, const CUtensorMap* tm_k,
                                              const CUtensorMap* tm_v, int lane) {
  float* lse_s = reinterpret_cast<float*>(base + Lay::LSE_OFF);
  float* dl_s = reinterpret_cast<float*>(base + Lay::DL_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + Lay::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + Lay::kStages;
  if (lane == 0) {
    mbar_arrive_expect_tx(kv_full, 2 * Lay::KV_BYTES);
    load_tile<D>(base + Lay::K_OFF, tm_k, kv_full, Lay::kKeys, w.kh, w.t0, w.b);
    load_tile<D>(base + Lay::V_OFF, tm_v, kv_full, Lay::kKeys, w.kh, w.t0, w.b);
  }
  int h = w.kh * (p.H / p.K), qi = 0;
#pragma unroll 1   // unrolled, the loop spills the producer's 24 registers
  for (int i = 0; i < w.n_steps; ++i) {
    const int stage = i % Lay::kStages, r0 = w.r_begin + qi * kQTile;
    mbar_wait(&empty[stage], ((i / Lay::kStages) & 1) ^ 1);
    for (int r = lane; r < kQTile; r += 32) {
      const bool in = r0 + r < p.S;
      const size_t row = ((size_t)w.b * p.H + h) * p.S + r0 + r;
      lse_s[stage * kQTile + r] = in ? p.lse[row] * kLog2e : 0.f;
      dl_s[stage * kQTile + r] = in ? p.delta[row] : 0.f;
    }
    __syncwarp();   // the lanes' stores before lane 0's arrive
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[stage], 2 * Lay::QT_BYTES);
      load_tile<D>(base + Lay::Q_OFF + stage * Lay::QT_BYTES, tm_q, &full[stage], kQTile, h, r0,
                   w.b);
      load_tile<D>(base + Lay::DO_OFF + stage * Lay::QT_BYTES, tm_do, &full[stage], kQTile, h,
                   r0, w.b);
    }
    if (++qi == w.n_q) {
      qi = 0;
      ++h;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, Params p) {
  using Lay = DkdvPairLayout<D>;
  using L = Panels<D>;
  constexpr int kKeys = Lay::kKeys, kStages = Lay::kStages, DP = L::DP;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* base = align_1024(smem_tiles);
  const float* lse_s = reinterpret_cast<const float*>(base + Lay::LSE_OFF);
  const float* dl_s = reinterpret_cast<const float*>(base + Lay::DL_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + Lay::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  const DkdvWork<kKeys> w(p);
  dkdv_init_barriers<Lay>(base);

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  if (wg == 2) {
    setmaxnreg_dec<kDkdvProducerRegs>();
    if (warp == 0 && w.n_steps > 0)
      dkdv_producer<D, Lay>(p, w, base, &tm_q, &tm_do, &tm_k, &tm_v, lane);
  } else {
    // ---- consumers: warpgroup wg owns keys t0 + 64 wg .. + 63 ----
    setmaxnreg_inc<kDkdvConsumerRegs>();
    const Logits lg(p);
    const int c2 = (lane % 4) * 2;
    const int k0 = w.t0 + 64 * wg, key_lo = k0 + 16 * warp + lane / 4;
    const uint32_t k_addr = smem_addr(base + Lay::K_OFF);
    const uint32_t v_addr = smem_addr(base + Lay::V_OFF);

    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) dk[j] = dv[j] = 0.f;

    if (w.n_steps > 0) mbar_wait(kv_full, 0);
    int qi = 0;
    for (int i = 0; i < w.n_steps; ++i) {
      const int stage = i % kStages, r0 = w.r_begin + qi * kQTile;
      if (++qi == w.n_q) qi = 0;
      const uint32_t q_addr = smem_addr(base + Lay::Q_OFF + stage * Lay::QT_BYTES);
      const uint32_t do_addr = smem_addr(base + Lay::DO_OFF + stage * Lay::QT_BYTES);
      const float* lse_t = lse_s + stage * kQTile;
      const float* dl_t = dl_s + stage * kQTile;
      mbar_wait(&full[stage], (i / kStages) & 1);

      // S^T = K Q^T, then dP^T = V dO^T: 64 keys x 64 query rows each
      float s[kQTile / 2], dp[kQTile / 2];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::KSTEPS; ++kk)
        Wgmma<kQTile>::ss(s, desc_k<D>(k_addr, kKeys, 64 * wg, kk),
                          desc_k<D>(q_addr, kQTile, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < L::KSTEPS; ++kk)
        Wgmma<kQTile>::ss(dp, desc_k<D>(v_addr, kKeys, 64 * wg, kk),
                          desc_k<D>(do_addr, kQTile, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();   // S^T is done; dP^T is still on the tensor cores
      fence_regs(s);

      // P^T (bf16, the A operand of dV) and P^T dcap in place of S^T.
      // Element 4 jj + e: key key_lo (e < 2) or key_lo + 8, query row
      // r0 + 8 jj + c2 + (e & 1); pair (j, j + 1) is A register
      // [j / 8][(j % 8) / 2] of the m16n8k16 layout.
      const bool edge = edge_tile(p, r0, kQTile, k0, 64);
      uint32_t pa[kQTile / 16][4];
#pragma unroll
      for (int j = 0; j < kQTile / 2; j += 2) {
        const int col = 8 * (j / 4) + c2, key = j % 4 ? key_lo + 8 : key_lo;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
        float d0, d1;
        float p0 = lg.prob(s[j], l2.x, d0), p1 = lg.prob(s[j + 1], l2.y, d1);
        if (edge) {
          if (!visible(p, r0 + col, key)) p0 = 0.f;
          if (!visible(p, r0 + col + 1, key)) p1 = 0.f;
        }
        pa[j / 8][(j % 8) / 2] = pack_bf16x2(p0, p1);
        s[j] = p0 * d0;
        s[j + 1] = p1 * d1;
      }

      // dV += P^T dO (dO transposed from shared memory)
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk)
        Wgmma<DP>::rs_trans_b(dv, pa[kk], desc_mn<D>(do_addr, kQTile, kk), 1);
      wgmma_commit();
      wgmma_wait<1>();   // dP^T is done; dV is still on the tensor cores
      fence_regs(dp);

      // dS^T = P^T dcap (dP^T - Delta), bf16
      uint32_t da[kQTile / 16][4];
#pragma unroll
      for (int j = 0; j < kQTile / 2; j += 2) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl_t + 8 * (j / 4) + c2);
        da[j / 8][(j % 8) / 2] = pack_bf16x2(s[j] * (dp[j] - d2.x), s[j + 1] * (dp[j + 1] - d2.y));
      }

      // dK += dS^T Q (Q transposed from shared memory)
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk)
        Wgmma<DP>::rs_trans_b(dk, da[kk], desc_mn<D>(q_addr, kQTile, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }

    // after the last wgmma, and under no branch that encloses one; the D
    // real columns only (15 of the 16 column groups at D 120, 10 at D 80)
    const size_t kv_stride = (size_t)p.K * D;
    bf16* dkb = static_cast<bf16*>(p.dk) + ((size_t)w.b * p.T * p.K + w.kh) * D;
    bf16* dvb = static_cast<bf16*>(p.dv) + ((size_t)w.b * p.T * p.K + w.kh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int key = key_lo + 8 * hi;
        if (key < p.T) {
          const size_t at = (size_t)key * kv_stride + j * 8 + c2;
          *reinterpret_cast<uint32_t*>(dkb + at) =
              pack_bf16x2(dk[4 * j + 2 * hi] * p.scale, dk[4 * j + 2 * hi + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(dvb + at) =
              pack_bf16x2(dv[4 * j + 2 * hi], dv[4 * j + 2 * hi + 1]);
        }
      }
    }
  }
}

// dK, dV at D 256, where one warpgroup cannot hold both accumulators of 64
// keys (2 x 128 fp32 registers a thread). Both consumer warpgroups own the
// block's 64 keys and split D: warpgroup wg accumulates columns 128 wg ..
// 128 wg + 127 of dK and dV (128 registers). Per step, warpgroup 0 computes
// S^T = K Q^T and warpgroup 1 dP^T = V dO^T (one product each, on the same
// instructions with the operands picked by wg: no wgmma under a branch);
// warpgroup 1 writes dP^T - Delta to shared memory in fp32, warpgroup 0
// forms P^T and dS^T from it and writes both as bf16 A fragments; then each
// warpgroup reads them back (thread t of either warpgroup holds the same
// fragment elements, so the exchange is indexed by thread) and runs dV +=
// P^T dO and dK += dS^T Q on its 128 columns. So no product is done twice.
// Two named-barrier waits a step order the exchange: each buffer is
// rewritten only after both warpgroups have passed the barrier that
// follows its last read.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkdv_split_wgmma(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, Params p) {
  using Lay = DkdvSplitLayout<D>;
  using L = Panels<D>;
  constexpr int kKeys = Lay::kKeys, kStages = Lay::kStages, HALF = L::DP / 2;
  static_assert(kKeys == 64 && HALF == 128, "the split is of 64 keys at D 256");
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* base = align_1024(smem_tiles);
  const float* lse_s = reinterpret_cast<const float*>(base + Lay::LSE_OFF);
  const float* dl_s = reinterpret_cast<const float*>(base + Lay::DL_OFF);
  float* xs = reinterpret_cast<float*>(base + Lay::X_OFF);
  uint32_t* pds = reinterpret_cast<uint32_t*>(base + Lay::PD_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + Lay::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  const DkdvWork<kKeys> w(p);
  dkdv_init_barriers<Lay>(base);

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  if (wg == 2) {
    setmaxnreg_dec<kDkdvProducerRegs>();
    if (warp == 0 && w.n_steps > 0)
      dkdv_producer<D, Lay>(p, w, base, &tm_q, &tm_do, &tm_k, &tm_v, lane);
  } else {
    setmaxnreg_inc<kDkdvConsumerRegs>();
    const Logits lg(p);
    const int tid = threadIdx.x % 128, c2 = (lane % 4) * 2;
    const int key_lo = w.t0 + 16 * warp + lane / 4;
    // this warpgroup's product: S^T from K and Q (wg 0), dP^T from V and dO
    const uint32_t a_addr = smem_addr(base + (wg == 0 ? Lay::K_OFF : Lay::V_OFF));
    const int b_off = wg == 0 ? Lay::Q_OFF : Lay::DO_OFF;
    // its columns of dO and Q: panels 2 wg and 2 wg + 1
    const uint32_t half_off = wg * 2 * kQTile * L::ROW;

    float dk[HALF / 2], dv[HALF / 2];
#pragma unroll
    for (int j = 0; j < HALF / 2; ++j) dk[j] = dv[j] = 0.f;

    if (w.n_steps > 0) mbar_wait(kv_full, 0);
    int qi = 0;
    for (int i = 0; i < w.n_steps; ++i) {
      const int stage = i % kStages, r0 = w.r_begin + qi * kQTile;
      if (++qi == w.n_q) qi = 0;
      const uint32_t q_addr = smem_addr(base + Lay::Q_OFF + stage * Lay::QT_BYTES);
      const uint32_t do_addr = smem_addr(base + Lay::DO_OFF + stage * Lay::QT_BYTES);
      const uint32_t b_addr = smem_addr(base + b_off + stage * Lay::QT_BYTES);
      mbar_wait(&full[stage], (i / kStages) & 1);

      // S^T (wg 0) or dP^T (wg 1): 64 keys x 64 query rows
      float x[kQTile / 2];
      fence_regs(x);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::KSTEPS; ++kk)
        Wgmma<kQTile>::ss(x, desc_k<D>(a_addr, kKeys, 0, kk), desc_k<D>(b_addr, kQTile, 0, kk),
                          kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);

      // Element 4 jj + e of x: key key_lo (e < 2) or key_lo + 8, query row
      // r0 + 8 jj + c2 + (e & 1); pair (j, j + 1) is A register
      // [j / 8][(j % 8) / 2] of the m16n8k16 layout, exchanged at j / 2.
      if (wg == 1) {
        const float* dl_t = dl_s + stage * kQTile;
#pragma unroll
        for (int j = 0; j < kQTile / 2; ++j)
          xs[j * 128 + tid] = x[j] - dl_t[8 * (j / 4) + c2 + (j & 1)];
      }
      named_barrier_sync(1, 256);
      if (wg == 0) {
        const float* lse_t = lse_s + stage * kQTile;
        const bool edge = edge_tile(p, r0, kQTile, w.t0, kKeys);
#pragma unroll
        for (int j = 0; j < kQTile / 2; j += 2) {
          const int col = 8 * (j / 4) + c2, key = j % 4 ? key_lo + 8 : key_lo;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
          float d0, d1;
          float p0 = lg.prob(x[j], l2.x, d0), p1 = lg.prob(x[j + 1], l2.y, d1);
          if (edge) {
            if (!visible(p, r0 + col, key)) p0 = 0.f;
            if (!visible(p, r0 + col + 1, key)) p1 = 0.f;
          }
          pds[(j / 2) * 128 + tid] = pack_bf16x2(p0, p1);
          pds[(16 + j / 2) * 128 + tid] =
              pack_bf16x2(p0 * d0 * xs[j * 128 + tid], p1 * d1 * xs[(j + 1) * 128 + tid]);
        }
      }
      named_barrier_sync(1, 256);
      uint32_t pa[kQTile / 16][4], da[kQTile / 16][4];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        pa[r / 4][r % 4] = pds[r * 128 + tid];
        da[r / 4][r % 4] = pds[(16 + r) * 128 + tid];
      }

      // dV += P^T dO and dK += dS^T Q on this warpgroup's 128 columns
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk)
        Wgmma<HALF>::rs_trans_b(dv, pa[kk], desc_mn<D>(do_addr + half_off, kQTile, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk)
        Wgmma<HALF>::rs_trans_b(dk, da[kk], desc_mn<D>(q_addr + half_off, kQTile, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }

    // after the last wgmma, and under no branch that encloses one; at D 224
    // warpgroup 1's column groups from 224 on are TMA's zero padding
    const size_t kv_stride = (size_t)p.K * D;
    bf16* dkb = static_cast<bf16*>(p.dk) + ((size_t)w.b * p.T * p.K + w.kh) * D + HALF * wg;
    bf16* dvb = static_cast<bf16*>(p.dv) + ((size_t)w.b * p.T * p.K + w.kh) * D + HALF * wg;
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int key = key_lo + 8 * hi;
        if (key < p.T && HALF * wg + j * 8 < D) {
          const size_t at = (size_t)key * kv_stride + j * 8 + c2;
          *reinterpret_cast<uint32_t*>(dkb + at) =
              pack_bf16x2(dk[4 * j + 2 * hi] * p.scale, dk[4 * j + 2 * hi + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(dvb + at) =
              pack_bf16x2(dv[4 * j + 2 * hi], dv[4 * j + 2 * hi + 1]);
        }
      }
    }
  }
}

// ---- 3. dQ --------------------------------------------------------------------

template <int D>
struct DqLayout {
  static constexpr int KT = Tiles<D>::KT;
  static constexpr int Q_BYTES = kRows * Panels<D>::DP * 2;
  static constexpr int KV_BYTES = KT * Panels<D>::DP * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;                      // [stage] K tile
  static constexpr int V_OFF = K_OFF + kDqStages * KV_BYTES;     // [stage] V tile
  static constexpr int BAR_OFF = V_OFF + kDqStages * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * kDqStages) * 8;
  static constexpr int LAUNCH_BYTES = BYTES + 1024;   // room to align the base
  static_assert(LAUNCH_BYTES <= 232448, "over the 227 KB a block may use");
};

// One block's work: 128 query rows of one (b, h), over key tiles of kKTile.
// Blocks are numbered heaviest first: the last query tile of every (b, h),
// then the one before, ...
template <int kKTile>
struct DqWork {
  int q0, h, b, t_begin, n_tiles;
  __device__ explicit DqWork(const Params& p) {
    const int nq = (p.S + kRows - 1) / kRows, hb = blockIdx.x % (p.H * p.B);
    q0 = (nq - 1 - blockIdx.x / (p.H * p.B)) * kRows;
    h = hb % p.H;
    b = hb / p.H;
    int t_end;
    key_range(p, q0, min(q0 + kRows, p.S), kKTile, t_begin, t_end);
    n_tiles = t_end > t_begin ? (t_end - t_begin + kKTile - 1) / kKTile : 0;
  }
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, Params p) {
  using Lay = DqLayout<D>;
  using L = Panels<D>;
  constexpr int kKTile = Lay::KT, DP = L::DP;
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  unsigned char* base = align_1024(smem_tiles);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + Lay::BAR_OFF);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kDqStages;
  const DqWork<kKTile> w(p);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 8);   // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    setmaxnreg_dec<kDqProducerRegs>();
    if (threadIdx.x == 256) {
      const int kh = w.h / (p.H / p.K);
      mbar_arrive_expect_tx(q_full, 2 * Lay::Q_BYTES);
      load_tile<D>(base + Lay::Q_OFF, &tm_q, q_full, kRows, w.h, w.q0, w.b);
      load_tile<D>(base + Lay::DO_OFF, &tm_do, q_full, kRows, w.h, w.q0, w.b);
#pragma unroll 1   // unrolled, the loop spills the producer's registers
      for (int i = 0; i < w.n_tiles; ++i) {
        const int stage = i % kDqStages, t0 = w.t_begin + i * kKTile;
        mbar_wait(&kv_empty[stage], ((i / kDqStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&kv_full[stage], 2 * Lay::KV_BYTES);
        load_tile<D>(base + Lay::K_OFF + stage * Lay::KV_BYTES, &tm_k, &kv_full[stage], kKTile,
                     kh, t0, w.b);
        load_tile<D>(base + Lay::V_OFF + stage * Lay::KV_BYTES, &tm_v, &kv_full[stage], kKTile,
                     kh, t0, w.b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    setmaxnreg_inc<kDqConsumerRegs>();
    const Logits lg(p);
    const int c2 = (lane % 4) * 2;
    const int r0 = w.q0 + 64 * wg, row_lo = r0 + 16 * warp + lane / 4;
    const uint32_t q_addr = smem_addr(base + Lay::Q_OFF);
    const uint32_t do_addr = smem_addr(base + Lay::DO_OFF);
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      const size_t idx = ((size_t)w.b * p.H + w.h) * p.S + row;
      lse2[r] = row < p.S ? p.lse[idx] * kLog2e : 0.f;
      dl[r] = row < p.S ? p.delta[idx] : 0.f;
    }
    float dq[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) dq[j] = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < w.n_tiles; ++i) {
      const int stage = i % kDqStages, t0 = w.t_begin + i * kKTile;
      const uint32_t k_addr = smem_addr(base + Lay::K_OFF + stage * Lay::KV_BYTES);
      const uint32_t v_addr = smem_addr(base + Lay::V_OFF + stage * Lay::KV_BYTES);
      mbar_wait(&kv_full[stage], (i / kDqStages) & 1);

      // S = Q K^T, then dP = dO V^T: 64 rows x kKTile keys each
      float s[kKTile / 2], dp[kKTile / 2];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::KSTEPS; ++kk)
        Wgmma<kKTile>::ss(s, desc_k<D>(q_addr, kRows, 64 * wg, kk),
                          desc_k<D>(k_addr, kKTile, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < L::KSTEPS; ++kk)
        Wgmma<kKTile>::ss(dp, desc_k<D>(do_addr, kRows, 64 * wg, kk),
                          desc_k<D>(v_addr, kKTile, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();   // S is done; dP is still on the tensor cores
      fence_regs(s);

      // P dcap in place of S. Element 4 jj + e: row row_lo (e < 2) or
      // row_lo + 8, key t0 + 8 jj + c2 + (e & 1).
      const bool edge = edge_tile(p, r0, 64, t0, kKTile);
#pragma unroll
      for (int j = 0; j < kKTile / 2; ++j) {
        const int hi = (j / 2) & 1;
        float dcap;
        float pe = lg.prob(s[j], lse2[hi], dcap);
        if (edge && !visible(p, row_lo + 8 * hi, t0 + 8 * (j / 4) + c2 + (j & 1))) pe = 0.f;
        s[j] = pe * dcap;
      }
      wgmma_wait<0>();   // dP is done
      fence_regs(dp);

      // dS = P dcap (dP - Delta), bf16: pair (j, j + 1) is A register
      // [j / 8][(j % 8) / 2] of the m16n8k16 layout
      uint32_t da[kKTile / 16][4];
#pragma unroll
      for (int j = 0; j < kKTile / 2; j += 2) {
        const float d = dl[(j / 2) & 1];
        da[j / 8][(j % 8) / 2] = pack_bf16x2(s[j] * (dp[j] - d), s[j + 1] * (dp[j + 1] - d));
      }

      // dQ += dS K (K transposed from shared memory)
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk)
        Wgmma<DP>::rs_trans_b(dq, da[kk], desc_mn<D>(k_addr, kKTile, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[stage]);
    }

    // after the last wgmma, and under no branch that encloses one; the D
    // real columns only
    const size_t q_stride = (size_t)p.H * D;
    bf16* dqb = static_cast<bf16*>(p.dq) + ((size_t)w.b * p.S * p.H + w.h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = row_lo + 8 * hi;
        if (row < p.S)
          *reinterpret_cast<uint32_t*>(dqb + (size_t)row * q_stride + j * 8 + c2) =
              pack_bf16x2(dq[4 * j + 2 * hi] * p.scale, dq[4 * j + 2 * hi + 1] * p.scale);
      }
    }
  }
}

// The bf16 passes: dK/dV, then dQ, on 4-D tensor maps over the inputs. At D
// 256 the dK/dV pass is flash_bwd_dkdv_split_wgmma.
template <int D>
int launch_wgmma(const Params& p, cudaStream_t st) {
  using L = Panels<D>;
  using T = Tiles<D>;
  using DkdvLay = std::conditional_t<(D > 128), DkdvSplitLayout<D>, DkdvPairLayout<D>>;
  const auto dkdv = [] {
    if constexpr (D > 128) return flash_bwd_dkdv_split_wgmma<D>;
    else return flash_bwd_dkdv_wgmma<D>;
  }();
  const CUtensorMapSwizzle swizzle =
      L::PANEL == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap q_tile, do_tile, q_rows, do_rows, k_keys, v_keys, k_tile, v_tile;
  int rc = encode_bf16_4d(&q_tile, p.q, D, p.H, p.S, p.B, L::PANEL, kQTile, swizzle);
  if (rc == 0) rc = encode_bf16_4d(&do_tile, p.dout, D, p.H, p.S, p.B, L::PANEL, kQTile, swizzle);
  if (rc == 0) rc = encode_bf16_4d(&q_rows, p.q, D, p.H, p.S, p.B, L::PANEL, kRows, swizzle);
  if (rc == 0) rc = encode_bf16_4d(&do_rows, p.dout, D, p.H, p.S, p.B, L::PANEL, kRows, swizzle);
  if (rc == 0) rc = encode_bf16_4d(&k_keys, p.k, D, p.K, p.T, p.B, L::PANEL, T::KEYS, swizzle);
  if (rc == 0) rc = encode_bf16_4d(&v_keys, p.v, D, p.K, p.T, p.B, L::PANEL, T::KEYS, swizzle);
  if (rc == 0) rc = encode_bf16_4d(&k_tile, p.k, D, p.K, p.T, p.B, L::PANEL, T::KT, swizzle);
  if (rc == 0) rc = encode_bf16_4d(&v_tile, p.v, D, p.K, p.T, p.B, L::PANEL, T::KT, swizzle);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DkdvLay::LAUNCH_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqLayout<D>::LAUNCH_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_keys = (p.T + T::KEYS - 1) / T::KEYS, n_rows = (p.S + kRows - 1) / kRows;
  dkdv<<<n_keys * p.K * p.B, kWgThreads, DkdvLay::LAUNCH_BYTES, st>>>(q_tile, do_tile, k_keys,
                                                                      v_keys, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma<D><<<n_rows * p.H * p.B, kWgThreads, DqLayout<D>::LAUNCH_BYTES, st>>>(
      q_rows, do_rows, k_tile, v_tile, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_all(const Params& p, cudaStream_t st) {
  const int rows = p.B * p.S * p.H;
  flash_bwd_preprocess<bf16, D><<<(rows + 7) / 8, 256, 0, st>>>(p);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_wgmma<D>(p, st);
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` and returns a CUDA error code (0 on
// success). q, k, v, o, dout, dq, dk and dv are bf16. window <= 0 and
// softcap <= 0 mean "none". delta is an fp32 (B, H, S) scratch. The caller
// checks shapes, types, contiguity and 16-byte alignment.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
                        void* dv, int B, int S, int T, int H, int K, int D,
                        int causal, int window, float softcap, float scale, void* stream) {
  Params p{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
           dq, dk, dv, B, S, T, H, K, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_all<32>(p, st);
    case 64: return launch_all<64>(p, st);
    case 80: return launch_all<80>(p, st);
    case 120: return launch_all<120>(p, st);
    case 128: return launch_all<128>(p, st);
    case 224: return launch_all<224>(p, st);
    case 256: return launch_all<256>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
