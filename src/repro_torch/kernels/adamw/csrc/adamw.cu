// Fused AdamW for Hopper (sm_90a): the global gradient norm and the update
// of every leaf in a few multi-tensor launches, bound to Python with ctypes.
//
// Replaces no TPU kernel: the JAX package leaves repro.optim.adamw's update
// to XLA, which fuses it. The port's eager form (optim/adamw.py, kept as
// the plain version and the CPU path) runs about 18 ops a leaf, each one
// reading and writing device memory: about 150 bytes a parameter.
//
// A tree is a list of leaves, each a contiguous run of n elements: the
// gradient g (bf16 or fp32) and the fp32 master p and moments mu and nu.
//   adamw_norm: the sum of g * g over every leaf, in fp32. Deterministic:
//     adamw_norm_partials writes one partial per chunk of kNormChunk
//     elements (a fixed tree inside the block), adamw_norm_total sums the
//     partials in a fixed order in one block. No float atomics: a rerun on
//     the same inputs gives the same bits.
//   adamw_update: per element, in the plain version's order,
//     scale = min((1 / max(sqrt(sumsq), 1e-9)) * clip, 1)   (on the device)
//     g  = g * scale
//     mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
//     p  = p - lr ((mu / b1c) / (sqrt(nu / b2c) + eps) + wd p)
//   with the sum of squares read from device memory (the norm pass's, or
//   its all-reduce over a mesh), so the host waits for nothing. The first
//   launch also writes the norm.
//
// What bounds it on the H100: bytes. The update reads g, p, mu and nu and
// writes p, mu and nu: 26 bytes a parameter with a bf16 gradient (28 with
// fp32), the norm 2 (4). For mamba2-2.7b's 2.83 B parameters that is 79.3
// GB, 23.7 ms at 3.35 TB/s; 17 operations an element are far below the
// card's rate. So each pass is one streaming sweep: 16-byte loads and
// stores (8 elements a thread and step: one 16-byte load of a bf16 g, two
// of each fp32 array), evict-first cache hints (nothing is read twice),
// and enough blocks in flight to cover the memory's latency. A leaf whose
// pointers are not all 16-byte aligned takes the scalar loop; the last
// n mod 8 elements of a leaf take it too.
//
// The leaf table (pointers, sizes, each leaf's first chunk) is a kernel
// parameter of at most kLeaves leaves, under the 4 KB of a launch's
// parameters; a tree takes one launch per kLeaves leaves of one gradient
// dtype (one template each), by one batching rule for both passes
// (for_each_batch). The host builds it from the pointers it holds:
// nothing is copied to the device and nothing waits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kLeaves = 64;         // leaves in one launch's table
constexpr int kThreads = 256;       // threads of a norm or update block
constexpr int kVec = 8;             // elements a thread takes at a step
constexpr int kChunk = kThreads * kVec * 4;        // an update block's
constexpr int kNormChunk = kThreads * kVec * 16;   // a norm block's
constexpr int kTotalThreads = 1024;  // the block that sums the partials

// The leaves of one launch, each split in chunks of one block: the
// gradients, their sizes, each leaf's first chunk ([count]: the total) and
// bit i set where all of leaf i's pointers are 16-byte aligned.
struct Batch {
  const void* g[kLeaves];
  long long n[kLeaves];
  int chunk0[kLeaves + 1];
  unsigned long long aligned;
  int count;
};

struct NormTable {
  Batch b;
  int partial0;              // this launch's first partial
};

struct UpdateTable {
  Batch b;
  float* p[kLeaves];
  float* m[kLeaves];
  float* v[kLeaves];
};

struct Hyper {
  const float* sumsq;   // the sum of squares over the whole tree
  float* norm_out;      // its square root, written by the first launch
  float lr, b1, b2, one_minus_b1, one_minus_b2, eps, wd, clip, b1c, b2c;
};

static_assert(sizeof(UpdateTable) + sizeof(Hyper) < 4096,
              "a launch's parameters hold at most 4 KB");

// Block c's leaf and its elements [start, end): the last leaf whose first
// chunk is at or before c (leaves of no elements are left out of a batch).
__device__ __forceinline__ int chunk_range(const Batch& b, int chunk,
                                           long long& start,
                                           long long& end) {
  const int c = blockIdx.x;
  int lo = 0, hi = b.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (b.chunk0[mid] <= c) lo = mid; else hi = mid - 1;
  }
  start = static_cast<long long>(c - b.chunk0[lo]) * chunk;
  end = min(start + static_cast<long long>(chunk), b.n[lo]);
  return lo;
}

// A block's sweep over [start, end): vec(i) for each group of kVec
// elements a thread takes where the leaf is aligned (16-byte accesses),
// then one(i) for each element left (all of them where it is not).
template <typename Vec, typename One>
__device__ __forceinline__ void sweep(long long start, long long end,
                                      bool aligned, Vec vec, One one) {
  long long tail = start;
  if (aligned) {
    for (long long i = start + static_cast<long long>(threadIdx.x) * kVec;
         i + kVec <= end; i += kThreads * kVec)
      vec(i);
    tail = start + (end - start) / kVec * kVec;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) one(i);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&x)[kVec]) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(src));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(src) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(dst) + 1,
         make_float4(x[4], x[5], x[6], x[7]));
}

// Thread 0 gets the block's sum, in a fixed order: each warp by shuffles,
// then the warps' sums by the first warp. Every thread must call it.
__device__ __forceinline__ float block_sum(float x, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = 0.f;
  if (warp == 0) {
    x = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
    adamw_norm_partials(__grid_constant__ const NormTable t,
                        float* __restrict__ partials) {
  long long start, end;
  const int leaf = chunk_range(t.b, kNormChunk, start, end);
  const G* __restrict__ g = static_cast<const G*>(t.b.g[leaf]);
  float acc = 0.f;
  sweep(start, end, (t.b.aligned >> leaf) & 1ull,
        [&](long long i) {
          float x[kVec];
          load8(g + i, x);
#pragma unroll
          for (int k = 0; k < kVec; ++k) acc += x[k] * x[k];
        },
        [&](long long i) {
          const float x = to_float(g[i]);
          acc += x * x;
        });
  __shared__ float warp_sums[kThreads / 32];
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) partials[t.partial0 + blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kTotalThreads)
    adamw_norm_total(const float* __restrict__ partials, int count,
                     float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < count; i += kTotalThreads) acc += partials[i];
  __shared__ float warp_sums[kTotalThreads / 32];
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) *out = acc;
}

// torch's clamp: NaN passes through (fmaxf and fminf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

__device__ __forceinline__ void adamw_element(float g, float& p, float& m,
                                              float& v, float scale,
                                              const Hyper& h) {
  g = g * scale;
  m = m * h.b1 + h.one_minus_b1 * g;
  v = v * h.b2 + h.one_minus_b2 * (g * g);
  const float denom = sqrtf(v / h.b2c) + h.eps;
  const float step = (m / h.b1c) / denom + h.wd * p;
  p = p - h.lr * step;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
    adamw_update_pass(__grid_constant__ const UpdateTable t,
                      __grid_constant__ const Hyper h) {
  // the plain version's clip: (1 / max(norm, 1e-9)) * clip, at most 1
  const float norm = sqrtf(*h.sumsq);
  const float scale = clamp_max((1.0f / clamp_min(norm, 1e-9f)) * h.clip,
                                1.0f);
  if (h.norm_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *h.norm_out = norm;
  if (t.b.count == 0) return;   // the launch that only writes the norm
  long long start, end;
  const int leaf = chunk_range(t.b, kChunk, start, end);
  const G* __restrict__ g = static_cast<const G*>(t.b.g[leaf]);
  float* __restrict__ p = t.p[leaf];
  float* __restrict__ m = t.m[leaf];
  float* __restrict__ v = t.v[leaf];
  sweep(start, end, (t.b.aligned >> leaf) & 1ull,
        [&](long long i) {
          float gx[kVec], px[kVec], mx[kVec], vx[kVec];
          load8(g + i, gx);
          load8(p + i, px);
          load8(m + i, mx);
          load8(v + i, vx);
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            adamw_element(gx[k], px[k], mx[k], vx[k], scale, h);
          store8(p + i, px);
          store8(m + i, mx);
          store8(v + i, vx);
        },
        [&](long long i) {
          float pi = p[i], mi = m[i], vi = v[i];
          adamw_element(to_float(g[i]), pi, mi, vi, scale, h);
          p[i] = pi;
          m[i] = mi;
          v[i] = vi;
        });
}

static bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

static long long chunks_of(long long n, int chunk) {
  return (n + chunk - 1) / chunk;
}

// The batching rule of both passes: the leaves i < count with elements,
// those with a bf16 gradient (g_bf16[i]) apart from those with an fp32
// one, at most kLeaves to a batch, each cut in chunks of `chunk`
// elements, and fn(bf16, batch, leaf) called for each batch in order
// (leaf[j]: batch leaf j's index in the tree). Returns fn's first nonzero
// return, cudaErrorInvalidValue where a batch's chunks overflow an int,
// else 0.
template <typename Fn>
static int for_each_batch(int count, const void* const* g,
                          const long long* n, const int* g_bf16, int chunk,
                          Fn fn) {
  for (int bf16 = 0; bf16 < 2; ++bf16) {
    Batch b{};
    int leaf[kLeaves];
    long long chunks = 0;
    for (int i = 0; i <= count; ++i) {
      const bool last = i == count;
      if (!last && ((g_bf16[i] != 0) != (bf16 != 0) || n[i] == 0)) continue;
      if (last || b.count == kLeaves) {
        if (b.count > 0) {
          b.chunk0[b.count] = static_cast<int>(chunks);
          const int rc = fn(bf16 != 0, b, leaf);
          if (rc != 0) return rc;
        }
        if (last) break;
        b = Batch{};
        chunks = 0;
      }
      if (chunks + chunks_of(n[i], chunk) > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
      leaf[b.count] = i;
      b.g[b.count] = g[i];
      b.n[b.count] = n[i];
      b.chunk0[b.count] = static_cast<int>(chunks);
      if (aligned16(g[i])) b.aligned |= 1ull << b.count;
      chunks += chunks_of(n[i], chunk);
      ++b.count;
    }
  }
  return 0;
}

extern "C" {

// The partial's size, which the Python wrapper mirrors (it allocates the
// partials).
int adamw_norm_chunk() { return kNormChunk; }

// The sum of g[i] * g[i] over leaves i < count (n[i] elements, bf16 where
// g_bf16[i], else fp32) into out[0], through partials: one float per
// kNormChunk-element chunk of each leaf. Launches on `stream`: one
// adamw_norm_partials per batch (for_each_batch), then adamw_norm_total.
// Returns the CUDA error code (0 on success).
int adamw_norm(int count, const void* const* g, const long long* n,
               const int* g_bf16, float* partials, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long slot = 0;
  const int rc = for_each_batch(
      count, g, n, g_bf16, kNormChunk,
      [&](bool bf16, const Batch& b, const int*) {
        const int blocks = b.chunk0[b.count];
        if (slot + blocks > 0x7fffffffLL)
          return static_cast<int>(cudaErrorInvalidValue);
        const NormTable t{b, static_cast<int>(slot)};
        if (bf16)
          adamw_norm_partials<__nv_bfloat16>
              <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(t,
                                                                   partials);
        else
          adamw_norm_partials<float>
              <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(t,
                                                                   partials);
        slot += blocks;
        return static_cast<int>(cudaGetLastError());
      });
  if (rc != 0) return rc;
  adamw_norm_total<<<1, kTotalThreads, 0, st>>>(partials,
                                                 static_cast<int>(slot), out);
  return static_cast<int>(cudaGetLastError());
}

// One AdamW step in place on leaves i < count: g[i] (bf16 where g_bf16[i],
// else fp32) and fp32 p[i], m[i], v[i], n[i] elements each; the clip's
// scale from sumsq (one float in device memory), the norm written to
// norm_out. Launches on `stream`: one adamw_update_pass per batch
// (for_each_batch), or one block that only writes the norm where no leaf
// has an element. Returns the CUDA error code (0 on success).
int adamw_update(int count, const void* const* g, float* const* p,
                 float* const* m, float* const* v, const long long* n,
                 const int* g_bf16, const float* sumsq, float* norm_out,
                 float lr, float b1, float b2, float one_minus_b1,
                 float one_minus_b2, float eps, float wd, float clip,
                 float b1c, float b2c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Hyper h{sumsq, norm_out, lr, b1, b2, one_minus_b1, one_minus_b2, eps, wd,
          clip, b1c, b2c};
  bool wrote_norm = false;
  const int rc = for_each_batch(
      count, g, n, g_bf16, kChunk,
      [&](bool bf16, const Batch& b, const int* leaf) {
        UpdateTable t{};
        t.b = b;
        for (int j = 0; j < b.count; ++j) {
          const int i = leaf[j];
          t.p[j] = p[i];
          t.m[j] = m[i];
          t.v[j] = v[i];
          if (!(aligned16(p[i]) && aligned16(m[i]) && aligned16(v[i])))
            t.b.aligned &= ~(1ull << j);
        }
        h.norm_out = wrote_norm ? nullptr : norm_out;
        const unsigned blocks = static_cast<unsigned>(b.chunk0[b.count]);
        if (bf16)
          adamw_update_pass<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(t, h);
        else
          adamw_update_pass<float><<<blocks, kThreads, 0, st>>>(t, h);
        wrote_norm = true;
        return static_cast<int>(cudaGetLastError());
      });
  if (rc != 0 || wrote_norm) return rc;
  adamw_update_pass<float><<<1, kThreads, 0, st>>>(UpdateTable{}, h);
  return static_cast<int>(cudaGetLastError());
}

const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
