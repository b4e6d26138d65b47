// Non-overlapping window max / mean with the remainder cropped.
// Replaces cadx_tpu/kernels/nn_kernels.py::max_pool_pallas and
// avg_pool_pallas (their _pool_pallas); see cadx_tpu_torch/kernels/pool.py
// for the layout and its bound.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// in (P, H, W) planes -> out (P, H / s, W / s); one thread per output.
// Max keeps the first window element unless a later one is larger or NaN
// (NaN propagates, as torch.amax does); mean sums the window in float32
// in raster order and multiplies by the float32 reciprocal of s * s, as
// XLA compiles JAX's mean and as the plain version does.
template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const T* __restrict__ in, T* __restrict__ out, long long total,
            int H, int W, int OH, int OW, int s) {
  const long long o = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (o >= total) return;
  const int ox = static_cast<int>(o % OW);
  const int oy = static_cast<int>((o / OW) % OH);
  const long long p = o / (static_cast<long long>(OW) * OH);
  const T* win = in + (p * H + static_cast<long long>(oy) * s) * W + static_cast<long long>(ox) * s;
  if (kMax) {
    T best = win[0];
    float bf = to_float(best);
    for (int i = 0; i < s; ++i)
      for (int j = 0; j < s; ++j) {
        const T v = win[static_cast<long long>(i) * W + j];
        const float vf = to_float(v);
        if (vf > bf || vf != vf) {
          best = v;
          bf = vf;
        }
      }
    out[o] = best;
  } else {
    float acc = to_float(win[0]);
    for (int i = 0; i < s; ++i)
      for (int j = (i == 0 ? 1 : 0); j < s; ++j)
        acc = __fadd_rn(acc, to_float(win[static_cast<long long>(i) * W + j]));
    store(out + o, __fmul_rn(acc, __fdiv_rn(1.0f, static_cast<float>(s * s))));
  }
}

template <typename T>
int launch(const void* in, void* out, int P, int H, int W, int s, int mode,
           cudaStream_t stream) {
  const int OH = H / s, OW = W / s;
  const long long total = static_cast<long long>(P) * OH * OW;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  if (mode == 0)
    pool_kernel<T, true><<<blocks, kThreads, 0, stream>>>(src, dst, total, H, W, OH, OW, s);
  else
    pool_kernel<T, false><<<blocks, kThreads, 0, stream>>>(src, dst, total, H, W, OH, OW, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in (P, H, W) -> out (P, H / s, W / s); mode 0 max, 1 mean; dtype 0
// float32, 1 bfloat16.
extern "C" int cadx_pool(const void* in, void* out, int P, int H, int W, int s,
                         int mode, int dtype, void* stream) {
  if (s < 1 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, out, P, H, W, s, mode, st);
  if (dtype == 1) return launch<__nv_bfloat16>(in, out, P, H, W, s, mode, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
