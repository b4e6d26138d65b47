// cv2.equalizeHist as one block per image, the kernel that csrc/equalize.cu
// replaced, kept only so that timings can set the two side by side
// (chip_smoke.py --equalize-ccl-times); no path runs it. One block of 1024
// threads reads its image a byte a thread, counts every pixel with a shared
// atomicAdd on one 256-bin histogram, lets thread 0 form the CDF and the LUT
// alone, and maps the image a byte a thread.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
equalize_kernel(const uint8_t* in, uint8_t* out, int n) {
  __shared__ int hist[256];
  __shared__ uint8_t lut[256];
  __shared__ int single_level;
  const long long img = blockIdx.x;
  in += img * n;
  out += img * n;

  for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += blockDim.x) atomicAdd(&hist[in[p]], 1);
  __syncthreads();

  if (threadIdx.x == 0) {
    int first = -1, levels = 0;
    for (int i = 0; i < 256; ++i) {
      if (hist[i] > 0) {
        if (first < 0) first = i;
        ++levels;
      }
    }
    // the CDF at the lowest occupied level is that level's count
    const int cdf_min = hist[first];
    const float denom = static_cast<float>(max(n - cdf_min, 1));
    int cdf = 0;
    for (int i = 0; i < 256; ++i) {
      cdf += hist[i];
      // round((cdf - cdf_min) * 255 / denom) in f32, half to even, in
      // this order and without contraction, as the reference computes it
      float v = __fdiv_rn(__fmul_rn(static_cast<float>(cdf - cdf_min), 255.0f), denom);
      v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
      lut[i] = static_cast<uint8_t>(v);
    }
    single_level = levels <= 1;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < n; p += blockDim.x)
    out[p] = single_level ? in[p] : lut[in[p]];
}

}  // namespace

// in, out: (B, H, W) uint8.
extern "C" int cadx_equalize_hist_one_block(const void* in, void* out, int B, int H,
                                            int W, void* stream) {
  equalize_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), H * W);
  return static_cast<int>(cudaGetLastError());
}
