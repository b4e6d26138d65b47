// The packed marker watershed's one-block-per-image kernel as it was before
// the tiled relaxation of csrc/watershed.cu (tiled_watershed.cuh) replaced
// it, kept only so that timings can set the two side by side (chip_smoke.py
// --packed-watershed-times); no path runs it. One block of 1024 threads an
// image runs components.cuh's Bellman-Ford over the whole plane in global
// memory, a __syncthreads_or a sweep; a second launch writes the ridge.
#include "components.cuh"

namespace {

using namespace cadx;

// the ridge kernel: a block of kPixX x kPixY pixels, images along the grid's z
constexpr int kPixX = 32, kPixY = 8;
constexpr int kMaxImages = 65535;

dim3 pixel_grid(int B, int H, int W) {
  return dim3((W + kPixX - 1) / kPixX, (H + kPixY - 1) / kPixY, B);
}

// cv2.watershed's ridge: 4-neighbour disagreement between positive labels,
// plus the 1-px frame of the image.
__global__ void boundary_kernel(const int* labels, uint8_t* boundary, int H, int W) {
  const int x = blockIdx.x * kPixX + threadIdx.x, y = blockIdx.y * kPixY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  labels += plane;
  const int p = y * W + x;
  const int lv = labels[p];
  bool ridge = y == 0 || y == H - 1 || x == 0 || x == W - 1;
  if (!ridge && lv > 0) {
    const int nb[4] = {labels[p - 1], labels[p + 1], labels[p - W], labels[p + W]};
    for (int i = 0; i < 4; ++i) ridge |= nb[i] > 0 && nb[i] != lv;
  }
  boundary[plane + p] = ridge;
}

// Markers equal to values[i] become label i + 1 at distance 0, the
// fixpoint is found by Bellman-Ford, and label i + 1 maps back to
// values[i] (0 where unreached).
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

}  // namespace

// img: (B, H, W) float32 (integer-valued); markers, labels: (B, H, W)
// int32; boundary: (B, H, W) bytes 0/1; scratch: (B, 2, H, W) int32. Up to
// three marker values, v1..v3, in tie order. Runs to the fixpoint.
extern "C" int cadx_watershed_packed_one_block(const void* img, const void* markers,
                                               void* labels, void* boundary, void* scratch,
                                               int B, int H, int W, int v1, int v2, int v3,
                                               int n_values, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (H > 512 || W > 512) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  packed_kernel<<<B, kThreads, 0, st>>>(static_cast<const float*>(img),
                                        static_cast<const int*>(markers),
                                        static_cast<int*>(labels), static_cast<int*>(scratch),
                                        H, W, v1, v2, v3, n_values);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  const size_t hw = static_cast<size_t>(H) * W;
  for (int b0 = 0; b0 < B; b0 += kMaxImages)
    boundary_kernel<<<pixel_grid(B - b0 < kMaxImages ? B - b0 : kMaxImages, H, W),
                      dim3(kPixX, kPixY), 0, st>>>(static_cast<const int*>(labels) + b0 * hw,
                                                   static_cast<uint8_t*>(boundary) + b0 * hw,
                                                   H, W);
  return static_cast<int>(cudaGetLastError());
}
