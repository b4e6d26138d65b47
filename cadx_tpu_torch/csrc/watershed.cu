// Geodesic marker watershed in its two forms, plus the ridge boundary.
// Replaces cadx_tpu/kernels/watershed_kernel.py::marker_watershed_pallas;
// see cadx_tpu_torch/kernels/watershed.py for the layouts and their bounds.
//
// Pair form: float32 distance and int32 label planes, relaxed by grid-wide
// directional passes that repeat the plain version's arithmetic op for op
// (the float fixpoint depends on it). Packed form: the block-level
// Bellman-Ford of components.cuh, one block per image.
#include <cmath>

#include "components.cuh"

namespace {

using namespace cadx;

constexpr int kPassThreads = 256;
constexpr float kBig = 1e30f;
constexpr float kEdgeEps = 1e-3f;

// Prefix sums of the step costs |dI| + 1e-3 along one line per block (rows
// for axis 1, columns for axis 0), in the Hillis-Steele order of
// geodesic_scan.doubling_cumsum: x[i] += x[i - k] for k = 1, 2, 4, ... over
// the whole line. Two shared buffers of the line's length, ping-pong.
__global__ void cost_cumsum_kernel(const float* img, float* s, int H, int W, int axis) {
  extern __shared__ float buf[];
  const int len = axis ? W : H;
  long long base;
  int stride;
  if (axis) {
    base = static_cast<long long>(blockIdx.x) * W;  // line = b * H + y
    stride = 1;
  } else {
    const long long b = blockIdx.x / W;
    base = b * H * W + blockIdx.x % W;               // line = b * W + x
    stride = W;
  }
  float* a = buf;
  float* c = buf + len;
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    a[i] = i == 0 ? 0.f
                  : fabsf(img[base + static_cast<long long>(i) * stride] -
                          img[base + static_cast<long long>(i - 1) * stride]) + kEdgeEps;
  __syncthreads();
  for (int k = 1; k < len; k *= 2) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) c[i] = a[i] + (i >= k ? a[i - k] : 0.f);
    __syncthreads();
    float* t = a;
    a = c;
    c = t;
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) s[base + static_cast<long long>(i) * stride] = a[i];
}

__global__ void init_dist_kernel(const int* markers, float* d, long long total) {
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < total;
       p += static_cast<long long>(gridDim.x) * blockDim.x)
    d[p] = markers[p] > 0 ? 0.f : kBig;
}

// One directional pass. For each pixel i, w = min over the window
// j = i, i -/+ 1, ..., i -/+ (win - 1) inside the line of d[j] - s[j]
// (forward) or d[j] + s[j] (reverse), nearest j first and strict <, so
// ties keep the nearest; then cand = w + s[i] (forward) or w - s[i]
// (reverse) replaces (d[i], l[i]) by (cand, label of w) where cand < d[i].
// Reads the pre-pass planes only, so every pixel is independent.
__global__ void pair_pass_kernel(const float* d, const int* l, const float* s,
                                 float* d_out, int* l_out, int* flag, int H, int W,
                                 long long total, int axis, int reverse, int win) {
  const int len = axis ? W : H;
  const long long stride = axis ? 1 : W;
  const int dir = reverse ? 1 : -1;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < total;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int x = static_cast<int>(p % W);
    const int pos = axis ? x : static_cast<int>((p / W) % H);
    const float si = s[p];
    const float di = d[p];
    const int li = l[p];
    float best = reverse ? di + si : di - si;
    int bl = li;
    for (int t = 1; t < win; ++t) {
      const int j = pos + dir * t;
      if (j < 0 || j >= len) break;
      const long long q = p + dir * t * stride;
      const float v = reverse ? d[q] + s[q] : d[q] - s[q];
      if (v < best) {
        best = v;
        bl = l[q];
      }
    }
    const float cand = reverse ? best - si : best + si;
    if (cand < di) {
      d_out[p] = cand;
      l_out[p] = bl;
      *flag = 1;
    } else {
      d_out[p] = di;
      l_out[p] = li;
    }
  }
}

// cv2.watershed's ridge: 4-neighbour disagreement between positive labels,
// plus the 1-px frame of the image.
__global__ void boundary_kernel(const int* labels, uint8_t* boundary, int H, int W,
                                long long total) {
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < total;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int x = static_cast<int>(p % W);
    const int y = static_cast<int>((p / W) % H);
    const int lv = labels[p];
    bool ridge = y == 0 || y == H - 1 || x == 0 || x == W - 1;
    if (!ridge && lv > 0) {
      const int nb[4] = {labels[p - 1], labels[p + 1], labels[p - W], labels[p + W]};
      for (int i = 0; i < 4; ++i) ridge |= nb[i] > 0 && nb[i] != lv;
    }
    boundary[p] = ridge;
  }
}

// Packed form, one block per image: markers equal to values[i] become
// label i + 1 at distance 0, the fixpoint is found by Bellman-Ford, and
// label i + 1 maps back to values[i] (0 where unreached).
__global__ void __launch_bounds__(kThreads)
packed_kernel(const float* img, const int* markers, int* labels, int* scratch, int H,
              int W, int v1, int v2, int v3, int n_values) {
  const int n = H * W;
  const long long im = blockIdx.x;
  img += im * n;
  markers += im * n;
  labels += im * n;
  int* q = scratch + im * 2 * n;
  int* pk = q + n;
  const int values[3] = {v1, v2, v3};
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    q[p] = static_cast<int>(rintf(img[p]));
    int small = 0;
    for (int i = 0; i < n_values; ++i)
      if (markers[p] == values[i]) small = i + 1;
    pk[p] = small ? small : kUnreachedPk;
  }
  __syncthreads();
  packed_watershed(q, pk, H, W);
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int small = pk[p] & 3;
    labels[p] = small ? values[small - 1] : 0;
  }
}

int grid_for(long long total) {
  const long long blocks = (total + kPassThreads - 1) / kPassThreads;
  return static_cast<int>(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

}  // namespace

// img: (B, H, W) float32; markers, labels: (B, H, W) int32; boundary:
// (B, H, W) bytes 0/1; scratch: five (B, H, W) planes of 4-byte words, in
// order srow, scol, d0, d1 (float32) and l1 (int32); flag: one int32.
// Runs sweeps of the four passes (LR, RL, TB, BT) until one changes no
// distance or max_iters sweeps ran; win_row / win_col are the scan windows
// 1 + sum(doubling_steps(min(len, max_scan))). Synchronises the stream once
// per sweep to read the changed flag.
extern "C" int cadx_watershed_pair(const void* img, const void* markers, void* labels,
                                   void* boundary, void* scratch, void* flag, int B, int H,
                                   int W, int max_iters, int win_row, int win_col,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(B) * H * W;
  const float* im = static_cast<const float*>(img);
  float* srow = static_cast<float*>(scratch);
  float* scol = srow + total;
  float* d0 = scol + total;
  float* d1 = d0 + total;
  int* l0 = static_cast<int*>(labels);
  int* l1 = reinterpret_cast<int*>(d1 + total);
  int* fl = static_cast<int*>(flag);
  const int grid = grid_for(total);
  const int threads = 256;

  for (int axis = 1; axis >= 0; --axis) {
    const int len = axis ? W : H;
    const size_t smem = 2 * static_cast<size_t>(len) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(cost_cumsum_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    cost_cumsum_kernel<<<axis ? B * H : B * W, threads, smem, st>>>(im, axis ? srow : scol,
                                                                   H, W, axis);
    if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  }
  cudaMemcpyAsync(l0, markers, total * sizeof(int), cudaMemcpyDeviceToDevice, st);
  init_dist_kernel<<<grid, kPassThreads, 0, st>>>(static_cast<const int*>(markers), d0, total);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);

  for (int it = 0; it < max_iters; ++it) {
    cudaMemsetAsync(fl, 0, sizeof(int), st);
    pair_pass_kernel<<<grid, kPassThreads, 0, st>>>(d0, l0, srow, d1, l1, fl, H, W, total, 1, 0, win_row);
    pair_pass_kernel<<<grid, kPassThreads, 0, st>>>(d1, l1, srow, d0, l0, fl, H, W, total, 1, 1, win_row);
    pair_pass_kernel<<<grid, kPassThreads, 0, st>>>(d0, l0, scol, d1, l1, fl, H, W, total, 0, 0, win_col);
    pair_pass_kernel<<<grid, kPassThreads, 0, st>>>(d1, l1, scol, d0, l0, fl, H, W, total, 0, 1, win_col);
    if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
    int changed = 0;
    cudaMemcpyAsync(&changed, fl, sizeof(int), cudaMemcpyDeviceToHost, st);
    if (cudaError_t e = cudaStreamSynchronize(st); e != cudaSuccess) return static_cast<int>(e);
    if (!changed) break;
  }
  boundary_kernel<<<grid, kPassThreads, 0, st>>>(l0, static_cast<uint8_t*>(boundary), H, W, total);
  return static_cast<int>(cudaGetLastError());
}

// img: (B, H, W) float32 (integer-valued); markers, labels: (B, H, W)
// int32; boundary: (B, H, W) bytes 0/1; scratch: (B, 2, H, W) int32. Up to
// three marker values, v1..v3, in tie order. Runs to the fixpoint.
extern "C" int cadx_watershed_packed(const void* img, const void* markers, void* labels,
                                     void* boundary, void* scratch, int B, int H, int W,
                                     int v1, int v2, int v3, int n_values, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(B) * H * W;
  packed_kernel<<<B, kThreads, 0, st>>>(static_cast<const float*>(img),
                                        static_cast<const int*>(markers),
                                        static_cast<int*>(labels), static_cast<int*>(scratch),
                                        H, W, v1, v2, v3, n_values);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  boundary_kernel<<<grid_for(total), kPassThreads, 0, st>>>(
      static_cast<const int*>(labels), static_cast<uint8_t*>(boundary), H, W, total);
  return static_cast<int>(cudaGetLastError());
}
