// Inference batch norm over NCHW float32. Replaces
// cadx_tpu/kernels/nn_kernels.py::batchnorm_pallas; see
// cadx_tpu_torch/kernels/batchnorm.py for the layout and its bound.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the most (image, channel) planes a block's elements can span
constexpr int kMaxPlanes = 1040;

// A block normalises kThreads * 4 * V consecutive elements of the flat
// tensor, whatever planes they fall in: several whole planes where a plane
// is small (ResNet-50's layer4 has 256 elements a plane), a chunk of one
// where it is large. The block puts the factors of the planes it spans in
// shared memory, each computed once, and every thread loads its V float4s
// (4 V scalars where a plane's length is not a multiple of 4 or a pointer
// is not 16-byte aligned), neighbouring threads on neighbouring addresses,
// before any thread stores. Every operation is a separately rounded IEEE
// one, in the plain version's order: inv = 1 / sqrt(var + eps), then
// ((x - mean) * inv) * scale + bias.
template <int V, bool kVec>
__global__ void __launch_bounds__(kThreads)
bn_kernel(const float* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ bias, const float* __restrict__ mean,
          const float* __restrict__ var, float* __restrict__ out, long long n, int C, int hw,
          float eps) {
  constexpr int kElems = kThreads * 4 * V;
  __shared__ float s_inv[kMaxPlanes], s_mean[kMaxPlanes], s_scale[kMaxPlanes],
      s_bias[kMaxPlanes];
  const long long start = static_cast<long long>(blockIdx.x) * kElems;
  const int count = static_cast<int>(n - start < kElems ? n - start : kElems);
  const long long p0 = start / hw;
  const int off = static_cast<int>(start - p0 * hw);  // start's place in plane p0
  const int planes = (off + count - 1) / hw + 1;
  float4 v4[kVec ? V : 1];
  float v1[kVec ? 1 : 4 * V];
  auto load = [&] {
    if (kVec) {
      const float4* src = reinterpret_cast<const float4*>(x + start);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int e = (j * kThreads + threadIdx.x) * 4;
        if (e < count) v4[j] = src[e / 4];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4 * V; ++j) {
        const int e = j * kThreads + threadIdx.x;
        if (e < count) v1[j] = x[start + e];
      }
    }
  };
  auto factors = [&] {
    for (int i = threadIdx.x; i < planes; i += kThreads) {
      const int c = static_cast<int>((p0 + i) % C);
      s_inv[i] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var[c], eps)));
      s_mean[i] = mean[c];
      s_scale[i] = scale[c];
      s_bias[i] = bias[c];
    }
    __syncthreads();
  };
  // With one float4 a thread (small planes, where the block spans several)
  // the loads go first and their latency overlaps the factors'; with more,
  // the factors go first, which timed faster on an H100 at those shapes
  // (the ResNet-50 stem's among them).
  if (V == 1) {
    load();
    factors();
  } else {
    factors();
    load();
  }
  auto norm = [&](float v, int i) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, s_mean[i]), s_inv[i]), s_scale[i]),
                     s_bias[i]);
  };
  if (kVec) {
    float4* dst = reinterpret_cast<float4*>(out + start);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int e = (j * kThreads + threadIdx.x) * 4;
      if (e >= count) continue;
      const int i = (off + e) / hw;  // a float4 lies in one plane (hw % 4 == 0)
      float4 v = v4[j];
      v.x = norm(v.x, i);
      v.y = norm(v.y, i);
      v.z = norm(v.z, i);
      v.w = norm(v.w, i);
      dst[e / 4] = v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * V; ++j) {
      const int e = j * kThreads + threadIdx.x;
      if (e < count) out[start + e] = norm(v1[j], (off + e) / hw);
    }
  }
}

template <int V>
cudaError_t launch(bool vec, long long blocks, cudaStream_t s, const float* x,
                   const float* scale, const float* bias, const float* mean, const float* var,
                   float* out, long long n, int C, int hw, float eps) {
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec)
    bn_kernel<V, true><<<grid, kThreads, 0, s>>>(x, scale, bias, mean, var, out, n, C, hw, eps);
  else
    bn_kernel<V, false><<<grid, kThreads, 0, s>>>(x, scale, bias, mean, var, out, n, C, hw, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, C, H, W) float32, contiguous; scale, bias, mean, var: (C,).
extern "C" int cadx_batchnorm(const void* x_, const void* scale, const void* bias,
                              const void* mean, const void* var, void* out_, int B, int C,
                              int H, int W, float eps, void* stream) {
  const int hw = H * W;
  const long long n = static_cast<long long>(B) * C * hw;
  if (n == 0) return 0;
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
  }
  // V float4s a thread: the most (4, 2, 1) that still gives every SM two
  // blocks, and whose block spans at most kMaxPlanes planes
  auto blocks_of = [&](int v) { return (n + kThreads * 4 * v - 1) / (kThreads * 4 * v); };
  int V = 4;
  while (V > 1 && (blocks_of(V) < 2LL * sms || (kThreads * 4 * V - 1) / hw + 2 > kMaxPlanes))
    V /= 2;
  const long long blocks = blocks_of(V);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(x_);
  auto* out = static_cast<float*>(out_);
  // float4 access where every plane starts on a 16-byte boundary
  const bool vec = hw % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* me = static_cast<const float*>(mean);
  const auto* va = static_cast<const float*>(var);
  cudaError_t err;
  if (V == 4)
    err = launch<4>(vec, blocks, s, x, sc, bi, me, va, out, n, C, hw, eps);
  else if (V == 2)
    err = launch<2>(vec, blocks, s, x, sc, bi, me, va, out, n, C, hw, eps);
  else
    err = launch<1>(vec, blocks, s, x, sc, bi, me, va, out, n, C, hw, eps);
  return static_cast<int>(err);
}
