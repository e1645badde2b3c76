// The attention mask of the flash kernels, shared by the forward
// (flash_fwd.cu) and the backward (flash_bwd.cu) so that the backward
// differentiates the mask the forward applies. Ends are aligned: query row r
// sees keys t <= r + (T - S), and with a window only the last `window` of
// them. The helpers take the kernel's own Params (fields S, T, causal,
// window) and read them where they are used: taking the fields as scalar
// arguments, or testing the row bound apart from the key bound, changed the
// kernels' SASS and made them slower on the H100 (PERF.md).

#pragma once

#include <cuda_runtime.h>

namespace flash_mask {

// Whether query row r sees key t. With kRows, rows past S (a ragged tile's
// zero-filled rows) see nothing. window <= 0: no window.
template <bool kRows, class P>
__device__ __forceinline__ bool visible(const P& p, int r, int t) {
  if ((kRows && r >= p.S) || t >= p.T) return false;
  if (!p.causal) return true;
  const int last = r + (p.T - p.S);
  if (t > last) return false;
  return p.window <= 0 || t > last - p.window;
}

// Key range [t0, t1) that queries [q0, q1) can see, t0 rounded down to a tile.
template <class P>
__device__ __forceinline__ void key_range(const P& p, int q0, int q1, int tile,
                                          int& t0, int& t1) {
  t0 = 0;
  t1 = p.T;
  if (p.causal) {
    const int shift = p.T - p.S;
    t1 = min(p.T, q1 + shift);
    if (p.window > 0) t0 = max(0, q0 + shift - p.window + 1);
  }
  t0 = (t0 / tile) * tile;
}

// Query range [r0, r1) whose rows see some key of [t0, t1), r0 rounded down
// to a tile.
template <class P>
__device__ __forceinline__ void query_range(const P& p, int t0, int t1, int tile,
                                            int& r0, int& r1) {
  r0 = 0;
  r1 = p.S;
  if (p.causal) {
    const int shift = p.T - p.S;
    r0 = max(0, t0 - shift);   // row r sees t <= r + shift
    if (p.window > 0) r1 = min(p.S, t1 - 1 - shift + p.window);   // and t > r + shift - window
  }
  r0 = (r0 / tile) * tile;
}

}  // namespace flash_mask
