// Causal depthwise conv + SiLU of the Mamba-2 mixer for Hopper (sm_90a),
// forward and backward, each over all of a layer's conv inputs (x, B and C)
// in one launch, bound to Python with ctypes.
//
// Replaces no TPU kernel: the JAX package's repro.models.ssm._causal_conv is
// plain jnp, which XLA fuses. The port's eager form (models/ssm.py, whose
// _causal_conv is kernels/conv/ref.py::causal_conv, kept as the plain
// version, the CPU path and decode's one-token step) runs about 16 kernels
// a tensor forward and 40 in autograd's backward, most of them bf16
// products of a strided slice and a broadcast weight row.
//
// For one tensor x (B, L, C) with weights w (K, C), K = kTaps = 4 (every
// configuration's ssm_conv):
//   s[t] = sum_{i<K} w[i] x[t - K + 1 + i]       (x before t = 0 is zero)
//   y[t] = s[t] * (1 / (1 + exp(-s[t])))
// x, w and y are bf16, summed in fp32 in the plain version's order (i = 0
// first), SiLU in fp32, rounded once to bf16. The backward, from dy,
// recomputes s from x (nothing but the inputs is saved):
//   ds[t] = dy[t] sig (1 + s (1 - sig)),  sig = 1 / (1 + exp(-s[t]))
//   dx[t] = sum_i w[i] ds[t + K - 1 - i]    (ds past L - 1 is zero)
//   dw[i] = sum_{b, t} ds[t] x[t - K + 1 + i]
//
// What bounds it on the H100: bytes. The forward reads x and writes y, the
// backward reads x and dy and writes dx: 4 and 6 bytes an element
// (176.2 and 264.3 MB a mamba2-2.7b layer at 4 x 2048, C = 5,376; 52.6 and
// 78.9 us at 3.35 TB/s), against about 2K + 4 and 6K + 9 operations an
// element (the SiLU by the SFU's exponential and reciprocal). So each pass
// is one sweep over time: a thread owns the channels of 16 bytes (forward)
// or 8 bytes (backward) of one batch row and walks a run of time steps,
// the last K - 1 input rows (and, backward, the last K - 1 rows of ds)
// held in registers beside the weights. Its rows stream through a ring of
// kRing slots of its own in shared memory, filled by cp.async kRing - 1
// rows ahead of the row in use: the loads in flight hold no registers, so
// an SM keeps some 60 KB (backward) to 110 KB (forward) of reads in
// flight, which the memory's latency asks for. Rows before t = 0 or past the run are zero-filled by
// the copy itself. A block is one warp of 32 channel groups by kRuns
// consecutive runs of one batch row, so a run's halo (K - 1 rows before
// it; backward also K - 1 rows after it) is rows its neighbouring warp
// reads at about the same time, from L2. A tensor whose width is not a
// multiple of 8, or one of whose pointers is not 16-byte aligned, takes
// plain loads a channel at a time.
//
// dw is deterministic: each block sums its runs' fp32 products in a fixed
// order in shared memory and writes one partial row per (batch row, block
// of runs); causal_conv_dw_sum then sums those rows in a fixed order in one
// thread per weight and rounds once to bf16. There are no
// float atomics: a rerun on the same inputs gives the same bits.
//
// The argument table (pointers, widths, each tensor's first block) is a
// kernel parameter: nothing is copied to the device and nothing waits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

constexpr int kMaxTensors = 4;   // tensors in one launch's table
constexpr int kTaps = 4;         // taps taken (K)
constexpr int kLanes = 32;       // channel groups of a block: one warp
constexpr int kRuns = 8;         // runs of a block: one a warp
constexpr int kThreads = kLanes * kRuns;
constexpr int kFwdBytes = 16;    // bytes of a row a thread owns, forward
constexpr int kBwdBytes = 8;     // ... backward (x and dy each)
constexpr int kFwdRun = 16;      // time steps of a forward run
constexpr int kBwdRun = 32;      // time steps of a backward run
constexpr int kRing = 8;         // rows of a thread's ring (each input)
constexpr int kSumThreads = 256;

struct Table {
  const void* x[kMaxTensors];
  const void* w[kMaxTensors];
  const void* dy[kMaxTensors];   // backward: the gradient of y
  void* out[kMaxTensors];        // forward: y; backward: dx
  void* dw[kMaxTensors];         // backward: the gradient of w
  float* part[kMaxTensors];      // backward: dw partials (rows, K, C)
  int c[kMaxTensors];
  int vec[kMaxTensors];          // 1: the vector path (a row of 8 or 16
                                 // bytes a thread), else a channel
  int block0[kMaxTensors + 1];   // each tensor's first block; [count] all
  int count;
  int len;
  int rows;                      // backward: partial rows a tensor
};

static_assert(sizeof(Table) < 4096, "a launch's parameters hold 4 KB");

// Rows of V bf16 elements as fp32, and back.
template <int V>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&f)[V]) {
  if constexpr (V == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 v = __bfloat1622float2(h[j]);
      f[2 * j] = v.x; f[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = __bfloat162float(p[j]);
  }
}

template <int V>
__device__ __forceinline__ void store_row(__nv_bfloat16* p,
                                          const float (&f)[V]) {
  if constexpr (V == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else if constexpr (V == 4) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = __float2bfloat16_rn(f[j]);
  }
}

template <int V>
__device__ __forceinline__ void zero_row(float (&f)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = 0.f;
}

// A row of V channels held in registers as floats, widened as loaded.
template <typename T, int V>
struct FloatRow {
  float f[V];
  __device__ __forceinline__ void load(const T* p) { load_row(p, f); }
  __device__ __forceinline__ void zero() { zero_row(f); }
  __device__ __forceinline__ float get(int j) const { return f[j]; }
};

// The forward's bf16 row of 8 channels kept packed two to a register as
// loaded, each element widened where it is used: half the registers of a
// FloatRow, which leaves room for a fourth block an SM (the backward,
// whose arithmetic an element is three times the forward's, keeps
// FloatRows: widening each use there costs more instructions than the
// registers save).
struct PackedRow8 {
  unsigned w[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = 0u;
  }
  // element j: the low half of word j / 2 for even j, the high for odd
  __device__ __forceinline__ float get(int j) const {
    const unsigned u = w[j >> 1];
    return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};

template <typename T, int V>
using FwdRow = std::conditional_t<std::is_same_v<T, __nv_bfloat16> && V == 8,
                                  PackedRow8, FloatRow<T, V>>;

// 1 / (1 + e^-s) by the SFU's exponential and reciprocal: four
// instructions an element where expf and an IEEE division take some
// thirty, which left both passes bound by instructions, not by bytes.
// Relative error a few 1e-6 for |s| < 20; 0 at s = -inf, 1 at +inf.
__device__ __forceinline__ float sigmoid(float s) {
  return __fdividef(1.f, 1.f + __expf(-s));
}

// The tile of this block: its tensor, batch row, first run and channel
// group, for runs of `run` steps and `vec`-channel groups (1 where the
// tensor does not take the vector path).
struct Tile {
  int tensor, b, run0, g0, groups;
};

__device__ __forceinline__ Tile tile_of(const Table& t, int run, int vec) {
  Tile tile;
  int i = 0;
  while (i + 1 < t.count && t.block0[i + 1] <= static_cast<int>(blockIdx.x))
    ++i;
  const int local = static_cast<int>(blockIdx.x) - t.block0[i];
  tile.tensor = i;
  tile.groups = t.vec[i] ? t.c[i] / vec : t.c[i];
  const int gtiles = (tile.groups + kLanes - 1) / kLanes;
  const int runs = (t.len + run - 1) / run;
  const int rblocks = (runs + kRuns - 1) / kRuns;
  const int gt = local % gtiles, rest = local / gtiles;
  tile.b = rest / rblocks;
  tile.run0 = (rest % rblocks) * kRuns;
  tile.g0 = gt * kLanes;
  return tile;
}

// 8-byte asynchronous copy to shared memory (hopper.cuh has the 16-byte
// one); valid false zero-fills it and src is not read.
__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               ::"r"(hopper::smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// Row r of `src` (rows c elements apart, B bytes of them) into a ring
// slot, zeros where !valid.
template <int B, typename T>
__device__ __forceinline__ void fetch(T* slot, const T* src, long long r,
                                      long long c, bool valid) {
  const T* from = valid ? src + r * c : src;
  if constexpr (B == 16)
    hopper::cp_async_16(slot, from, valid ? 16 : 0);
  else
    cp_async_8(slot, from, valid);
}

// A thread's ring: slot j of thread `tid` at ring + (j * kThreads + tid) *
// B bytes, so the lanes of a warp take consecutive chunks.
template <int B, typename T>
__device__ __forceinline__ T* slot_of(unsigned char* ring, int j) {
  return reinterpret_cast<T*>(
      ring + (static_cast<long long>(j) * kThreads + threadIdx.x) * B);
}

// s = sum_i w[i] x[t - K + 1 + i] for channel v, from the window of the K -
// 1 rows before t and row t.
template <int K, typename R>
__device__ __forceinline__ float preact(const R (&wr)[K], const R (&win)[K - 1],
                                        const R& cur, int v) {
  float acc = wr[0].get(v) * win[0].get(v);
#pragma unroll
  for (int i = 1; i < K - 1; ++i) acc = fmaf(wr[i].get(v), win[i].get(v), acc);
  return fmaf(wr[K - 1].get(v), cur.get(v), acc);
}

// One forward run on the vector path: rows [t0, end) of one batch row,
// V = kFwdBytes / sizeof(T) channels at x, w, y (each already at the
// thread's first channel; rows c elements apart), through the thread's
// ring. Row first + j sits in slot j % kRing; each row is read once the
// groups after it, at most kRing - 1, are all that is left in flight. Only
// rows the run reads are fetched (the groups past them are empty), so no
// copy is in flight when the thread returns.
template <typename T, int K>
__device__ __forceinline__ void fwd_ring(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         T* __restrict__ y, long long c,
                                         int t0, int end,
                                         unsigned char* ring) {
  constexpr int V = kFwdBytes / sizeof(T);
  FwdRow<T, V> wr[K], win[K - 1];
#pragma unroll
  for (int i = 0; i < K; ++i) wr[i].load(w + i * c);
  const int first = t0 - (K - 1);
  const int n = end - first;
#pragma unroll
  for (int j = 0; j < kRing; ++j) {
    const int r = first + j;
    if (r < end)
      fetch<kFwdBytes>(slot_of<kFwdBytes, T>(ring, j), x, r, c, r >= 0);
    hopper::cp_async_commit();
  }
  for (int j = 0; j < n; ++j) {
    hopper::cp_async_wait<kRing - 1>();
    T* slot = slot_of<kFwdBytes, T>(ring, j % kRing);
    FwdRow<T, V> cur;
    cur.load(slot);
    const int r = first + j + kRing;   // the slot's next row
    if (r < end) fetch<kFwdBytes>(slot, x, r, c, true);
    hopper::cp_async_commit();
    if (j >= K - 1) {
      float out[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float s = preact<K>(wr, win, cur, v);
        out[v] = s * sigmoid(s);
      }
      store_row(y + static_cast<long long>(first + j) * c, out);
    }
#pragma unroll
    for (int i = 0; i < K - 2; ++i) win[i] = win[i + 1];
    win[K - 2] = cur;
  }
}

// The same run a channel at a time, with plain loads (the scalar path).
template <typename T, int K>
__device__ __forceinline__ void fwd_scalar(const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           T* __restrict__ y, long long c,
                                           int t0, int end) {
  FloatRow<T, 1> wr[K], win[K - 1];
#pragma unroll
  for (int i = 0; i < K; ++i) wr[i].load(w + i * c);
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int r = t0 - (K - 1) + j;
    if (r >= 0) win[j].load(x + r * c); else win[j].zero();
  }
  for (int r = t0; r < end; ++r) {
    FloatRow<T, 1> cur;
    cur.load(x + r * c);
    const float s = preact<K>(wr, win, cur, 0);
    const float out[1] = {s * sigmoid(s)};
    store_row(y + r * c, out);
#pragma unroll
    for (int i = 0; i < K - 2; ++i) win[i] = win[i + 1];
    win[K - 2] = cur;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    causal_conv_silu_fwd(__grid_constant__ const Table t) {
  __shared__ __align__(16) unsigned char ring[kRing * kThreads * kFwdBytes];
  constexpr int V = kFwdBytes / sizeof(T);
  const Tile tile = tile_of(t, kFwdRun, V);
  const int g = tile.g0 + static_cast<int>(threadIdx.x) % kLanes;
  const int t0 = (tile.run0 + static_cast<int>(threadIdx.x) / kLanes)
                 * kFwdRun;
  if (g >= tile.groups || t0 >= t.len) return;
  const int end = min(t0 + kFwdRun, t.len);
  const int i = tile.tensor;
  const long long c = t.c[i];
  const long long base = static_cast<long long>(tile.b) * t.len * c;
  const T* x = static_cast<const T*>(t.x[i]) + base;
  const T* w = static_cast<const T*>(t.w[i]);
  T* y = static_cast<T*>(t.out[i]) + base;
  if (t.vec[i]) {
    const long long ch = static_cast<long long>(g) * V;
    fwd_ring<T, K>(x + ch, w + ch, y + ch, c, t0, end, ring);
  } else {
    fwd_scalar<T, K>(x + g, w + g, y + g, c, t0, end);
  }
}

// The backward's step at row r = first + j of a run [t0, end), from x's
// row `cur` and dy's row `dcur` (V channels each): ds[r] from the
// recomputed pre-activation, its share of dw (rows of the run), and dx of
// row r - K + 1 once complete (rows of the run), from the ds of the K - 1
// rows before (dsw). Then the windows move on by one row.
template <typename T, int K, int V, typename R>
__device__ __forceinline__ void bwd_step(const R (&wr)[K], R (&win)[K - 1],
                                         float (&dsw)[K - 1][V],
                                         float (&dw)[K][V], const R& cur,
                                         const R& dcur, int r, int t0,
                                         int end, int len,
                                         T* __restrict__ dx, long long c) {
  if (r >= t0) {
    float ds[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float s = preact<K>(wr, win, cur, v);
      const float sig = sigmoid(s);
      ds[v] = r < len ? dcur.get(v) * (sig * (1.f + s * (1.f - sig))) : 0.f;
    }
    if (r < end) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int i = 0; i < K - 1; ++i)
          dw[i][v] = fmaf(ds[v], win[i].get(v), dw[i][v]);
        dw[K - 1][v] = fmaf(ds[v], cur.get(v), dw[K - 1][v]);
      }
    }
    const int tx = r - (K - 1);   // the row whose dx is now complete
    if (tx >= t0 && tx < end) {
      float g[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = wr[0].get(v) * ds[v];
#pragma unroll
        for (int i = 1; i < K; ++i)
          acc = fmaf(wr[i].get(v), dsw[K - 1 - i][v], acc);
        g[v] = acc;
      }
      store_row(dx + static_cast<long long>(tx) * c, g);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int i = 0; i < K - 2; ++i) dsw[i][v] = dsw[i + 1][v];
      dsw[K - 2][v] = ds[v];
    }
  }
#pragma unroll
  for (int i = 0; i < K - 2; ++i) win[i] = win[i + 1];
  win[K - 2] = cur;
}

// One backward run on the vector path: dx for rows [t0, end) and the run's
// share of dw (into dw), V = kBwdBytes / sizeof(T) channels at x, w, dy,
// dx as in fwd_ring; x's and dy's rows stream through two rings, row
// first + j of both in slot j % kRing, one copy group a row. Rows
// t0 - K + 1 .. end + K - 2 of x and t0 .. end + K - 2 of dy are read; ds
// of the rows past len is zero.
template <typename T, int K>
__device__ __forceinline__ void bwd_ring(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         const T* __restrict__ dy,
                                         T* __restrict__ dx, long long c,
                                         int t0, int end, int len,
                                         unsigned char* xring,
                                         unsigned char* dring,
                                         float (&dw)[K][kBwdBytes / sizeof(T)]) {
  constexpr int V = kBwdBytes / sizeof(T);
  FloatRow<T, V> wr[K], win[K - 1];
  float dsw[K - 1][V];
#pragma unroll
  for (int i = 0; i < K; ++i) wr[i].load(w + i * c);
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    win[i].zero();
    zero_row(dsw[i]);
  }
  const int first = t0 - (K - 1);
  const int avail = min(end + K - 1, len);   // rows read: [first, avail)
  const int n = end + K - 1 - first;         // steps: through end + K - 2
  auto fetch_row = [&](int j, int r) {
    fetch<kBwdBytes>(slot_of<kBwdBytes, T>(xring, j), x, r, c,
                     r >= 0 && r < avail);
    fetch<kBwdBytes>(slot_of<kBwdBytes, T>(dring, j), dy, r, c,
                     r >= t0 && r < avail);
    hopper::cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kRing; ++j) fetch_row(j, first + j);
  for (int j = 0; j < n; ++j) {
    hopper::cp_async_wait<kRing - 1>();
    const int k = j % kRing;
    FloatRow<T, V> cur, dcur;
    cur.load(slot_of<kBwdBytes, T>(xring, k));
    dcur.load(slot_of<kBwdBytes, T>(dring, k));
    fetch_row(k, first + j + kRing);
    bwd_step<T, K, V>(wr, win, dsw, dw, cur, dcur, first + j, t0, end, len,
                      dx, c);
  }
}

// The same run a channel at a time, with plain loads (the scalar path).
template <typename T, int K>
__device__ __forceinline__ void bwd_scalar(const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           const T* __restrict__ dy,
                                           T* __restrict__ dx, long long c,
                                           int t0, int end, int len,
                                           float (&dw)[K][1]) {
  FloatRow<T, 1> wr[K], win[K - 1];
  float dsw[K - 1][1];
#pragma unroll
  for (int i = 0; i < K; ++i) wr[i].load(w + i * c);
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    win[i].zero();
    zero_row(dsw[i]);
  }
  const int avail = min(end + K - 1, len);
  for (int r = t0 - (K - 1); r < end + K - 1; ++r) {
    FloatRow<T, 1> cur, dcur;
    if (r >= 0 && r < avail) cur.load(x + r * c); else cur.zero();
    if (r >= t0 && r < avail) dcur.load(dy + r * c); else dcur.zero();
    bwd_step<T, K, 1>(wr, win, dsw, dw, cur, dcur, r, t0, end, len, dx, c);
  }
}

// The block's runs' dw (each thread's dw for its V channels) summed over
// the block's warps in a fixed order, through `red` (shared memory of
// kRuns * K * kLanes * V floats), into the partial row of (batch row,
// block of runs): part[row][i][ch] for the block's `width` channels from
// ch0. Every thread of the block calls it.
template <int K, int V>
__device__ __forceinline__ void block_dw(const float (&dw)[K][V],
                                         float* __restrict__ red,
                                         float* __restrict__ part,
                                         long long c, int row, int ch0,
                                         int width) {
  constexpr int kCols = kLanes * V;
  const int lane = static_cast<int>(threadIdx.x) % kLanes;
  const int warp = static_cast<int>(threadIdx.x) / kLanes;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v)
      red[(warp * K + i) * kCols + lane * V + v] = dw[i][v];
  __syncthreads();
  for (int e = static_cast<int>(threadIdx.x); e < K * kCols; e += kThreads) {
    const int i = e / kCols, col = e % kCols;
    if (col >= width) continue;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kRuns; ++r) acc += red[(r * K + i) * kCols + col];
    part[(static_cast<long long>(row) * K + i) * c + ch0 + col] = acc;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    causal_conv_silu_bwd(__grid_constant__ const Table t) {
  constexpr int V = kBwdBytes / sizeof(T);
  constexpr int kRingBytes = kRing * kThreads * kBwdBytes;
  static_assert(kRuns * K * kLanes * V * sizeof(float) <= 2 * kRingBytes,
                "dw's reduction fits in the rings' memory");
  // x's and dy's rings; after the runs (all copies waited for and a
  // barrier), the block's dw reduction
  __shared__ __align__(16) unsigned char rings[2 * kRingBytes];
  const Tile tile = tile_of(t, kBwdRun, V);
  const int i = tile.tensor;
  const bool vec = t.vec[i] != 0;
  const int g = tile.g0 + static_cast<int>(threadIdx.x) % kLanes;
  const int t0 = (tile.run0 + static_cast<int>(threadIdx.x) / kLanes)
                 * kBwdRun;
  const bool active = g < tile.groups && t0 < t.len;
  const int end = min(t0 + kBwdRun, t.len);
  const long long c = t.c[i];
  const long long base = static_cast<long long>(tile.b) * t.len * c;
  const T* x = static_cast<const T*>(t.x[i]) + base;
  const T* w = static_cast<const T*>(t.w[i]);
  const T* dy = static_cast<const T*>(t.dy[i]) + base;
  T* dx = static_cast<T*>(t.out[i]) + base;
  const int runs = (t.len + kBwdRun - 1) / kBwdRun;
  const int row = tile.b * ((runs + kRuns - 1) / kRuns) + tile.run0 / kRuns;
  const int per = vec ? V : 1;
  const int ch0 = tile.g0 * per;
  const int width = static_cast<int>(
      min(c - ch0, static_cast<long long>(kLanes * per)));
  float* red = reinterpret_cast<float*>(rings);
  if (vec) {
    float dw[K][V] = {};
    if (active) {
      const long long ch = static_cast<long long>(g) * V;
      bwd_ring<T, K>(x + ch, w + ch, dy + ch, dx + ch, c, t0, end, t.len,
                     rings, rings + kRingBytes, dw);
    }
    hopper::cp_async_wait<0>();
    __syncthreads();
    block_dw<K, V>(dw, red, t.part[i], c, row, ch0, width);
  } else {
    float dw[K][1] = {};
    if (active) bwd_scalar<T, K>(x + g, w + g, dy + g, dx + g, c, t0, end,
                                 t.len, dw);
    block_dw<K, 1>(dw, red, t.part[i], c, row, ch0, width);
  }
}

__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// dw[i][ch] of every tensor: its t.rows partial rows summed in order. One
// thread a weight; block0 holds each tensor's first weight here.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    causal_conv_dw_sum(__grid_constant__ const Table t, int k) {
  const long long e = static_cast<long long>(blockIdx.x) * kSumThreads
                      + threadIdx.x;
  if (e >= t.block0[t.count]) return;
  int i = 0;
  while (i + 1 < t.count && t.block0[i + 1] <= e) ++i;
  const long long j = e - t.block0[i];      // i * c + ch of this tensor
  const long long kc = static_cast<long long>(k) * t.c[i];
  const float* part = t.part[i] + j;
  float acc = 0.f;
  for (int r = 0; r < t.rows; ++r) acc += part[r * kc];
  store_one(static_cast<T*>(t.dw[i]) + j, acc);
}

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

static long long row_blocks(int len, int run) {
  const long long runs = (static_cast<long long>(len) + run - 1) / run;
  return (runs + kRuns - 1) / kRuns;
}

// Fills the table's tensors, widths, vector flags and blocks for runs of
// `run` steps and `vec`-channel groups. A tensor takes the vector path
// where its width is a multiple of 8 and x, w, out and (where `dy` is not
// null) dy are 16-byte aligned. cudaErrorInvalidValue for sizes it does not
// take.
static int fill(Table& t, int count, const void* const* x,
                const void* const* w, const void* const* dy,
                void* const* out, const int* c, int batch, int len, int k,
                int run, int vec) {
  if (count < 1 || count > kMaxTensors || batch < 1 || len < 1
      || k != kTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  t.count = count;
  t.len = len;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (c[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    t.x[i] = x[i];
    t.w[i] = w[i];
    t.dy[i] = dy != nullptr ? dy[i] : nullptr;
    t.out[i] = out[i];
    t.c[i] = c[i];
    t.vec[i] = c[i] % 8 == 0 && aligned16(x[i]) && aligned16(w[i])
               && aligned16(out[i]) && (dy == nullptr || aligned16(dy[i]));
    const long long groups = t.vec[i] ? c[i] / vec : c[i];
    t.block0[i] = static_cast<int>(blocks);
    blocks += batch * row_blocks(len, run) * ((groups + kLanes - 1) / kLanes);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.block0[count] = static_cast<int>(blocks);
  return 0;
}

// One launch of `kernel` over the table's blocks.
template <typename Kernel>
static void launch(Kernel kernel, const Table& t, cudaStream_t st) {
  kernel<<<static_cast<unsigned>(t.block0[t.count]), kThreads, 0, st>>>(t);
}

extern "C" {

// The backward's run length and the runs of a block, which the Python
// wrapper mirrors (it allocates the backward's partials).
int causal_conv_bwd_run() { return kBwdRun; }
int causal_conv_block_runs() { return kRuns; }

// y_i = silu(causal_conv(x_i, w_i)) for tensors i < count: x_i and y_i
// (batch, len, c[i]), w_i (k, c[i]) with k = kTaps, all bf16, contiguous.
// One launch on `stream`. Returns the CUDA error code (0 on success).
int causal_conv_fwd(int count, const void* const* x, const void* const* w,
                    void* const* y, const int* c, int batch, int len, int k,
                    void* stream) {
  Table t{};
  const int rc = fill(t, count, x, w, nullptr, y, c, batch, len, k,
                      kFwdRun, kFwdBytes / 2);
  if (rc != 0) return rc;
  launch(causal_conv_silu_fwd<__nv_bfloat16, kTaps>, t,
         static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// From dy_i, the gradient of y_i: dx_i (as x_i) and dw_i (as w_i) for
// tensors i < count, through `partials`: batch * (len / kBwdRun / kRuns,
// rounded up at each step) * k * c[i] floats a tensor, one after another. Two launches on
// `stream`: causal_conv_silu_bwd, then causal_conv_dw_sum. Returns the CUDA
// error code (0 on success).
int causal_conv_bwd(int count, const void* const* x, const void* const* w,
                    const void* const* dy, void* const* dx, void* const* dw,
                    const int* c, int batch, int len, int k,
                    float* partials, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Table t{};
  int rc = fill(t, count, x, w, dy, dx, c, batch, len, k, kBwdRun,
                kBwdBytes / 2);
  if (rc != 0) return rc;
  t.rows = static_cast<int>(batch * row_blocks(len, kBwdRun));
  long long offset = 0, weights = 0;
  for (int i = 0; i < count; ++i) {
    t.dw[i] = dw[i];
    t.part[i] = partials + offset;
    offset += static_cast<long long>(t.rows) * k * c[i];
  }
  launch(causal_conv_silu_bwd<__nv_bfloat16, kTaps>, t, st);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  Table s = t;
  for (int i = 0; i < count; ++i) {
    s.block0[i] = static_cast<int>(weights);
    weights += static_cast<long long>(k) * c[i];
  }
  s.block0[count] = static_cast<int>(weights);
  const unsigned sum_blocks =
      static_cast<unsigned>((weights + kSumThreads - 1) / kSumThreads);
  causal_conv_dw_sum<__nv_bfloat16><<<sum_blocks, kSumThreads, 0, st>>>(s, k);
  return static_cast<int>(cudaGetLastError());
}

const char* causal_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
