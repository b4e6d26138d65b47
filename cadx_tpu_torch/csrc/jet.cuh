// The JET colormap and the show_cam_on_image blend, shared by the jet_blend
// (overlay.cu) and gradcam_tail (gradcam_tail.cu) kernels.
//
// The table is cv2's COLORMAP_JET as RGB, 256 levels of 3 bytes, taken from
// the Python side's `ops/colormap.py::jet_lut_bgr` (reversed) and uploaded
// once per device into each translation unit's own __constant__ copy. A
// block copies it to shared memory, where the lookups of a warp's
// neighbouring pixels, which differ, do not serialise.
//
// The arithmetic repeats the plain PyTorch version's on the card op for op:
// jet / 255 (CUDA's tensor / scalar is a product with the float32
// reciprocal of the scalar), + the gray or RGB image, then, with the image's
// peak blend (at least 1e-7), trunc(b / peak * 255).
#pragma once

#include <atomic>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace cadx_jet {

constexpr int kLutBytes = 256 * 3;
constexpr int kMaxDevices = 64;

static __constant__ uint8_t kJetRgb[kLutBytes];

// Uploads the table (host memory, kLutBytes) to the current device once.
static int ensure_lut(const void* lut_rgb) {
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && ready[dev].load()) return 0;
  err = cudaMemcpyToSymbol(kJetRgb, lut_rgb, kLutBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) ready[dev].store(true);
  return 0;
}

// Copies the table into shared memory; the caller synchronises the block.
__device__ __forceinline__ void load_lut(uint8_t* lut) {
  for (int i = threadIdx.x; i < kLutBytes; i += blockDim.x) lut[i] = kJetRgb[i];
}

// One channel's blend: jet / 255 + img.
__device__ __forceinline__ float blend(uint8_t jet, float img) {
  return __fadd_rn(__fmul_rn(static_cast<float>(jet), 1.0f / 255.0f), img);
}

// The overlay value: trunc(b / peak * 255), b in [0, peak].
__device__ __forceinline__ uint8_t overlay_u8(float b, float peak) {
  return static_cast<uint8_t>(__fmul_rn(__fdiv_rn(b, peak), 255.0f));
}

// Block-wide reductions over blockDim.x threads (a multiple of 32, at most
// 1024); `scratch` holds 32 floats. Every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < (blockDim.x >> 5) ? scratch[lane] : -INFINITY;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float block_min(float v, float* scratch) {
  return -block_max(-v, scratch);
}

}  // namespace cadx_jet
