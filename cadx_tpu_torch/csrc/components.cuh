// Shared block-level device code for the connected-component kernels:
// CCL, the largest label, the border-flood hole fill, and separable window
// min (erode / dilate / opening of a 0/1 plane).
//
// Every function here is called by all threads of one block, which works on
// one image whose planes live in global memory (a 256x256 int32 plane is
// 256 KiB, beyond a block's shared memory; the 50 MB L2 holds them). Pixels
// are distributed over the block in a strided loop, and each function ends
// with a __syncthreads(), so its output plane is complete when it returns.
// Loops that run to a fixpoint decide with __syncthreads_or whether any
// thread changed anything, so no sweep goes back to the host.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace cadx {

constexpr int kThreads = 1024;
constexpr int kNoLabel = INT_MAX;

// Loads of planes that other threads update with atomics in the same phase
// go to L2, so a reader always sees the latest value there.
static __device__ __forceinline__ int ld_l2(const int* p) { return __ldcg(p); }

// Connected-component labels of the 0/1 plane `fg` into `lab`: each
// foreground pixel gets the minimum raster index of its component
// (4- or 8-connected), background gets kNoLabel.
//
// Union-find that always links to the smaller root: a label is always the
// index of a pixel of the same component and never above the pixel's own
// index, so once no pixel sees a smaller label among its neighbours the
// labels are constant on each component and equal to its minimum index.
static __device__ void ccl(const int* fg, int* lab, int H, int W, int conn) {
  const int n = H * W;
  for (int p = threadIdx.x; p < n; p += blockDim.x) lab[p] = fg[p] ? p : kNoLabel;
  __syncthreads();
  while (true) {
    bool changed = false;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      if (!fg[p]) continue;
      const int y = p / W, x = p - y * W;
      const int l = ld_l2(lab + p);
      int mn = l;
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          if (conn == 4 && dy != 0 && dx != 0) continue;
          const int xx = x + dx;
          if (xx < 0 || xx >= W) continue;
          const int q = yy * W + xx;
          if (fg[q]) mn = min(mn, ld_l2(lab + q));
        }
      }
      if (mn < l) {
        atomicMin(lab + l, mn);  // link the old root to the smaller label
        atomicMin(lab + p, mn);
        changed = true;
      }
    }
    changed = __syncthreads_or(changed);
    // path compression: point every pixel at the root of its chain
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      if (!fg[p]) continue;
      int l = ld_l2(lab + p);
      int r = ld_l2(lab + l);
      while (r != l) {
        l = r;
        r = ld_l2(lab + l);
      }
      atomicMin(lab + p, l);
    }
    __syncthreads();
    if (!changed) break;
  }
}

// out = fg & (lab == L), L the label of the largest area, the smallest
// label on ties; all zero for an empty fg. `area` is a scratch plane.
static __device__ void largest_from_labels(const int* fg, const int* lab,
                                           int* area, int* out, int H, int W) {
  const int n = H * W;
  __shared__ unsigned long long best;
  for (int p = threadIdx.x; p < n; p += blockDim.x) area[p] = 0;
  if (threadIdx.x == 0) best = 0ull;
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    if (fg[p]) atomicAdd(area + ld_l2(lab + p), 1);
  __syncthreads();
  // key = (area << 32) | ~label: the max key has the largest area and,
  // among equal areas, the smallest label
  unsigned long long mine = 0ull;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int a = ld_l2(area + p);
    if (a > 0) {
      const unsigned long long key =
          (static_cast<unsigned long long>(a) << 32) | (0xFFFFFFFFu - static_cast<unsigned>(p));
      mine = key > mine ? key : mine;
    }
  }
  atomicMax(&best, mine);
  __syncthreads();
  const int bl = best ? static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull)) : -1;
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    out[p] = fg[p] && ld_l2(lab + p) == bl;
  __syncthreads();
}

// out = m | holes, holes = background pixels whose 4-connected background
// component touches no border pixel (the flood from the border cannot reach
// them). `out` may alias `m`; inv, lab and touch are scratch planes.
static __device__ void fill_holes(const int* m, int* out, int* inv, int* lab,
                                  int* touch, int H, int W) {
  const int n = H * W;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    inv[p] = !m[p];
    touch[p] = 0;
  }
  __syncthreads();
  ccl(inv, lab, H, W, 4);
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = p / W, x = p - y * W;
    if (inv[p] && (y == 0 || y == H - 1 || x == 0 || x == W - 1))
      touch[ld_l2(lab + p)] = 1;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    out[p] = m[p] || (inv[p] && !touch[ld_l2(lab + p)]);
  __syncthreads();
}

// dst = min of src over the window [c - lo, c + k - 1 - lo] along one axis
// (0: rows, 1: columns); a window that leaves the image also takes `fill`.
static __device__ void window_min(const int* src, int* dst, int H, int W,
                                  int k, int lo, int fill, int axis) {
  const int n = H * W;
  const int len = axis == 0 ? H : W;
  const int stride = axis == 0 ? W : 1;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = p / W, x = p - y * W;
    const int c = axis == 0 ? y : x;
    const int base = p - c * stride;
    const int a = c - lo, b = c + k - 1 - lo;
    int v = (a < 0 || b >= len) ? fill : INT_MAX;
    for (int j = max(a, 0); j <= min(b, len - 1); ++j) v = min(v, src[base + j * stride]);
    dst[p] = v;
  }
  __syncthreads();
}

// Packed geodesic watershed to its fixpoint. `pk` holds (dist << 2) | label
// on entry: labels 1..3 at distance 0 on the markers, kUnreachedPk elsewhere.
// Bellman-Ford: pk = min over 4-neighbours of pk[nb] + ((|dq| * K + 1) << 2),
// K the next power of two >= H + W, q the integer image. That is exactly
// what the JAX line scans add up, and an integer min-plus fixpoint is
// unique, so both reach the same values. Values only fall, and each stays a
// real path value below 2^30 + 2^22, so int32 never overflows for sides
// <= 512 and 8-bit q.
constexpr int kUnreachedPk = 1 << 30;

template <typename Q>
static __device__ void packed_watershed(const Q* q, int* pk, int H, int W) {
  const int n = H * W;
  int K = 1;
  while (K < H + W) K *= 2;
  while (true) {
    bool changed = false;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int y = p / W, x = p - y * W;
      const int qp = static_cast<int>(q[p]);
      const int cur = pk[p];
      int best = cur;
      if (x > 0) best = min(best, pk[p - 1] + ((abs(qp - static_cast<int>(q[p - 1])) * K + 1) << 2));
      if (x < W - 1) best = min(best, pk[p + 1] + ((abs(qp - static_cast<int>(q[p + 1])) * K + 1) << 2));
      if (y > 0) best = min(best, pk[p - W] + ((abs(qp - static_cast<int>(q[p - W])) * K + 1) << 2));
      if (y < H - 1) best = min(best, pk[p + W] + ((abs(qp - static_cast<int>(q[p + W])) * K + 1) << 2));
      if (best < cur) {
        pk[p] = best;
        changed = true;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
}

// 0/1 plane erode (border 1) then dilate (border 0) with a k x k square
// anchored at k / 2, in place in m; t1, t2 are scratch planes.
static __device__ void opening(int* m, int* t1, int* t2, int H, int W, int k) {
  const int n = H * W;
  const int lo = k / 2;
  window_min(m, t1, H, W, k, lo, 1, 0);
  window_min(t1, t2, H, W, k, lo, 1, 1);
  for (int p = threadIdx.x; p < n; p += blockDim.x) t2[p] = 1 - t2[p];
  __syncthreads();
  // dilate(e) = 1 - erode(1 - e), the complement's border being 1
  window_min(t2, t1, H, W, k, lo, 1, 0);
  window_min(t1, t2, H, W, k, lo, 1, 1);
  for (int p = threadIdx.x; p < n; p += blockDim.x) m[p] = 1 - t2[p];
  __syncthreads();
}

}  // namespace cadx
