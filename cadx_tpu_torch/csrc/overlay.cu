// JET lookup of a uint8 heatmap blended onto an image, normalised by the
// image's peak. Replaces cadx_tpu/kernels/overlay.py::jet_blend_pallas; see
// cadx_tpu_torch/kernels/overlay.py for the layout and its bound.
#include <cstdint>

#include <cuda_runtime.h>

#include "jet.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 8;
constexpr int kChunk = kThreads * kPixelsPerThread;

__global__ void init_peak_kernel(int* peak, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) peak[b] = __float_as_int(1e-7f);
}

// Pass 1: each block takes one chunk of one image, its blend maximum over
// the chunk's pixels and three channels goes to the image's peak with an
// integer atomicMax (the blends are >= 1e-7 > 0 here, where float order is
// integer order).
__global__ void __launch_bounds__(kThreads)
peak_kernel(const uint8_t* __restrict__ heat, const float* __restrict__ img,
            int* __restrict__ peak, int n, int pix_stride, int ch_stride) {
  __shared__ uint8_t lut[cadx_jet::kLutBytes];
  __shared__ float scratch[32];
  cadx_jet::load_lut(lut);
  __syncthreads();
  const long long b = blockIdx.y;
  const uint8_t* hb = heat + b * n;
  const float* ib = img + b * n * pix_stride;
  const int first = static_cast<int>(blockIdx.x) * kChunk;
  const int end = min(first + kChunk, n);
  float m = 1e-7f;
  for (int p = first + static_cast<int>(threadIdx.x); p < end; p += kThreads) {
    const uint8_t* jet = lut + 3 * hb[p];
    const float* px = ib + static_cast<long long>(p) * pix_stride;
    for (int c = 0; c < 3; ++c) m = fmaxf(m, cadx_jet::blend(jet[c], px[c * ch_stride]));
  }
  m = cadx_jet::block_max(m, scratch);
  if (threadIdx.x == 0) atomicMax(peak + b, __float_as_int(m));
}

// Pass 2: recompute each blend (no scratch plane) and write the overlay.
__global__ void __launch_bounds__(kThreads)
write_kernel(const uint8_t* __restrict__ heat, const float* __restrict__ img,
             const int* __restrict__ peak, uint8_t* __restrict__ out, int n,
             int pix_stride, int ch_stride) {
  __shared__ uint8_t lut[cadx_jet::kLutBytes];
  cadx_jet::load_lut(lut);
  __syncthreads();
  const long long b = blockIdx.y;
  const float pk = __int_as_float(peak[b]);
  const uint8_t* hb = heat + b * n;
  const float* ib = img + b * n * pix_stride;
  uint8_t* ob = out + b * n * 3;
  const int first = static_cast<int>(blockIdx.x) * kChunk;
  const int end = min(first + kChunk, n);
  for (int p = first + static_cast<int>(threadIdx.x); p < end; p += kThreads) {
    const uint8_t* jet = lut + 3 * hb[p];
    const float* px = ib + static_cast<long long>(p) * pix_stride;
    for (int c = 0; c < 3; ++c)
      ob[3LL * p + c] = cadx_jet::overlay_u8(cadx_jet::blend(jet[c], px[c * ch_stride]), pk);
  }
}

}  // namespace

// heat: (B, H, W) uint8; img: float32 in [0, 1], (B, H, W) gray
// (pix_stride 1, ch_stride 0) or (B, H, W, 3) RGB (3, 1); lut_rgb: host
// (256, 3) uint8; peak: (B,) int32 scratch; out: (B, H, W, 3) uint8 RGB.
extern "C" int cadx_jet_blend(const void* heat, const void* img, const void* lut_rgb,
                              void* peak, void* out, int B, int H, int W,
                              int pix_stride, int ch_stride, void* stream) {
  const int n = H * W;
  if (B == 0 || n == 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = cadx_jet::ensure_lut(lut_rgb);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kChunk - 1) / kChunk, B);
  init_peak_kernel<<<(B + 255) / 256, 256, 0, st>>>(static_cast<int*>(peak), B);
  peak_kernel<<<grid, kThreads, 0, st>>>(static_cast<const uint8_t*>(heat),
                                         static_cast<const float*>(img),
                                         static_cast<int*>(peak), n, pix_stride, ch_stride);
  write_kernel<<<grid, kThreads, 0, st>>>(static_cast<const uint8_t*>(heat),
                                          static_cast<const float*>(img),
                                          static_cast<const int*>(peak),
                                          static_cast<uint8_t*>(out), n, pix_stride,
                                          ch_stride);
  return static_cast<int>(cudaGetLastError());
}
