// Inference batch norm over NCHW float32. Replaces
// cadx_tpu/kernels/nn_kernels.py::batchnorm_pallas; see
// cadx_tpu_torch/kernels/batchnorm.py for the layout and its bound.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

// A block normalises one chunk of one (image, channel) plane: the channel's
// factor is computed once a block, and its threads stride over the chunk,
// four neighbouring elements a thread (a float4 where the plane allows).
// Every operation is a separately rounded IEEE one, in the plain version's
// order: inv = 1 / sqrt(var + eps), then ((x - mean) * inv) * scale + bias.
__global__ void __launch_bounds__(kThreads)
bn_kernel(const float* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ bias, const float* __restrict__ mean,
          const float* __restrict__ var, float* __restrict__ out, int C, int hw,
          float eps, bool vec4) {
  const long long plane = blockIdx.x;
  const int c = static_cast<int>(plane % C);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var[c], eps)));
  const float m = mean[c], s = scale[c], b = bias[c];
  const float* src = x + plane * hw;
  float* dst = out + plane * hw;
  const int chunk = kThreads * kPerThread;
  const int start = blockIdx.y * chunk;
  const int end = min(start + chunk, hw);
  auto norm = [&](float v) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, m), inv), s), b);
  };
  if (vec4) {
    for (int i = start + threadIdx.x * 4; i < end; i += kThreads * 4) {
      float4 v = *reinterpret_cast<const float4*>(src + i);
      v.x = norm(v.x);
      v.y = norm(v.y);
      v.z = norm(v.z);
      v.w = norm(v.w);
      *reinterpret_cast<float4*>(dst + i) = v;
    }
  } else {
    for (int i = start + threadIdx.x; i < end; i += kThreads) dst[i] = norm(src[i]);
  }
}

}  // namespace

// x, out: (B, C, H, W) float32, contiguous; scale, bias, mean, var: (C,).
extern "C" int cadx_batchnorm(const void* x, const void* scale, const void* bias,
                              const void* mean, const void* var, void* out, int B,
                              int C, int H, int W, float eps, void* stream) {
  const int hw = H * W;
  const long long planes = static_cast<long long>(B) * C;
  if (planes == 0 || hw == 0) return 0;
  const int chunks = (hw + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  if (chunks > 65535 || planes > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(planes), chunks);
  // float4 access where every plane starts on a 16-byte boundary
  const bool vec4 = hw % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  bn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<float*>(out), C, hw, eps, vec4);
  return static_cast<int>(cudaGetLastError());
}
