// Density-seeded largest component of a binary mask as one block per image:
// the kernel that csrc/seeded_component.cu replaced, kept only so that
// timings can set the two side by side (chip_smoke.py
// --flood-seeded-times); no path runs it.
//
// Phases: the k x k mask density as two running-sum passes (one thread per
// line); the seed as a 64-bit (density << 32 | ~index) key reduced with one
// shared atomicMax; the flood from the seed to its fixpoint, each sweep a
// run pass along every row and every column (a thread per line carries the
// reach along a run, both ways) and, 8-connected, one in-place 3x3 pass;
// then the area test, and where the flood holds no strict majority the CCL
// and largest label of components.cuh. A run pass crosses a whole run per
// sweep, so a blob floods in a few sweeps where the CCL's union-find needs
// its own sweeps and the area histogram. Bound: the latency of the
// dependent loads along each line (the row pass strides by W across a
// warp); one block per image.
#include "components.cuh"

namespace {

using namespace cadx;

constexpr int kPlanes = 4;  // scratch int32 planes per image

// dst = sum of src over [c - k/2, c + k - 1 - k/2] along one axis (0: down
// the columns, 1: along the rows), 0 outside the image.
__device__ void window_sum(const int* src, int* dst, int H, int W, int k, int axis) {
  const int lines = axis == 0 ? W : H;
  const int len = axis == 0 ? H : W;
  const int step = axis == 0 ? W : 1;
  const int lo = k / 2, hi = k - 1 - lo;
  for (int l = threadIdx.x; l < lines; l += blockDim.x) {
    const long long base = axis == 0 ? l : static_cast<long long>(l) * W;
    int s = 0;
    for (int j = 0; j <= min(hi, len - 1); ++j) s += src[base + static_cast<long long>(j) * step];
    for (int c = 0; c < len; ++c) {
      dst[base + static_cast<long long>(c) * step] = s;
      if (c + hi + 1 < len) s += src[base + static_cast<long long>(c + hi + 1) * step];
      if (c - lo >= 0) s -= src[base + static_cast<long long>(c - lo) * step];
    }
  }
  __syncthreads();
}

// One pass along every line of one axis: within each run of mask pixels, a
// reached pixel reaches the whole run. Returns whether this thread set any.
__device__ bool run_pass(const int* m, int* r, int H, int W, int axis) {
  const int lines = axis == 0 ? W : H;
  const int len = axis == 0 ? H : W;
  const int step = axis == 0 ? W : 1;
  bool changed = false;
  for (int l = threadIdx.x; l < lines; l += blockDim.x) {
    const long long base = axis == 0 ? l : static_cast<long long>(l) * W;
    int carry = 0;
    for (int c = 0; c < len; ++c) {
      const long long p = base + static_cast<long long>(c) * step;
      if (!m[p]) {
        carry = 0;
      } else if (r[p]) {
        carry = 1;
      } else if (carry) {
        r[p] = 1;
        changed = true;
      }
    }
    carry = 0;
    for (int c = len - 1; c >= 0; --c) {
      const long long p = base + static_cast<long long>(c) * step;
      if (!m[p]) {
        carry = 0;
      } else if (r[p]) {
        carry = 1;
      } else if (carry) {
        r[p] = 1;
        changed = true;
      }
    }
  }
  return changed;
}

__global__ void __launch_bounds__(kThreads)
seeded_component_kernel(const uint8_t* in, uint8_t* out, int* scratch, int H, int W,
                        int conn, int k) {
  const int n = H * W;
  const long long img = blockIdx.x;
  in += img * n;
  out += img * n;
  int* m = scratch + img * kPlanes * n;
  int* t = m + n;     // row sums, then the CCL labels
  int* dens = t + n;  // density, then the areas
  int* r = dens + n;  // reach, then the largest label's mask
  __shared__ unsigned long long best;
  __shared__ long long area, total;

  for (int p = threadIdx.x; p < n; p += blockDim.x) m[p] = in[p] != 0;
  if (threadIdx.x == 0) {
    best = 0ull;
    area = 0;
    total = 0;
  }
  __syncthreads();
  window_sum(m, t, H, W, k, 1);
  window_sum(t, dens, H, W, k, 0);
  // the densest mask pixel, the smallest index on ties; a mask pixel counts
  // itself, so its key is never 0
  unsigned long long mine = 0ull;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    if (m[p]) {
      const unsigned long long key = (static_cast<unsigned long long>(dens[p]) << 32) |
                                     (0xFFFFFFFFu - static_cast<unsigned>(p));
      mine = key > mine ? key : mine;
    }
  }
  atomicMax(&best, mine);
  __syncthreads();
  if (best == 0ull) {  // an empty mask
    for (int p = threadIdx.x; p < n; p += blockDim.x) out[p] = 0;
    return;
  }
  const int seed = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull));
  for (int p = threadIdx.x; p < n; p += blockDim.x) r[p] = p == seed;
  __syncthreads();

  // values of r only rise from 0 to 1 and every pixel set is connected to
  // the seed, so in-place updates reach the same fixpoint as a sweep that
  // reads a copy
  while (true) {
    bool changed = run_pass(m, r, H, W, 1);
    __syncthreads();
    changed |= run_pass(m, r, H, W, 0);
    __syncthreads();
    if (conn == 8) {
      for (int p = threadIdx.x; p < n; p += blockDim.x) {
        if (!m[p] || r[p]) continue;
        const int y = p / W, x = p - y * W;
        bool hit = false;
        for (int dy = -1; dy <= 1 && !hit; ++dy) {
          const int yy = y + dy;
          if (yy < 0 || yy >= H) continue;
          for (int dx = -1; dx <= 1; ++dx) {
            const int xx = x + dx;
            if (xx >= 0 && xx < W && r[yy * W + xx]) {
              hit = true;
              break;
            }
          }
        }
        if (hit) {
          r[p] = 1;
          changed = true;
        }
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  long long my_area = 0, my_total = 0;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    my_area += r[p];
    my_total += m[p];
  }
  atomicAdd(reinterpret_cast<unsigned long long*>(&area), static_cast<unsigned long long>(my_area));
  atomicAdd(reinterpret_cast<unsigned long long*>(&total), static_cast<unsigned long long>(my_total));
  __syncthreads();
  if (area * 2 <= total) {
    // no strict majority: the exact CCL + largest label
    ccl(m, t, H, W, conn);
    largest_from_labels(m, t, dens, r, H, W);
  }
  for (int p = threadIdx.x; p < n; p += blockDim.x) out[p] = static_cast<uint8_t>(r[p]);
}

}  // namespace

// in, out: (B, H, W) bytes 0/1; scratch: (B, 4, H, W) int32; k: the density
// window's side.
extern "C" int cadx_largest_component_seeded_one_block(const void* in, void* out,
                                                       void* scratch, int B, int H, int W,
                                                       int conn, int k, void* stream) {
  seeded_component_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<int*>(scratch), H, W, conn, k);
  return static_cast<int>(cudaGetLastError());
}
