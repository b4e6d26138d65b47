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

// ---------------------------------------------------------------------------
// Training batch norm: the batch's statistics, the running-stat update, the
// normalisation (with the ReLU after it, where fused) and the backward. It
// replaces no TPU kernel (the JAX package trains no network with batch
// norms); see cadx_tpu_torch/kernels/batchnorm.py for its design and bound.
// ---------------------------------------------------------------------------

namespace {

// BatchNorm2d's defaults, the only ones the port trains with
// (kernels/batchnorm.py's MOMENTUM and EPS)
constexpr float kMomentum = 0.1f;
constexpr float kEps = 1e-5f;
constexpr int kRed = 256;      // threads of a reduction block
constexpr int kRedUnroll = 4;  // loads a thread of a reduction block keeps in flight
constexpr int kWarps = kRed / 32;

// Chan, Golub and LeVeque's pairwise update: the moments (n, mean, m2) of a
// set absorb those of another, (nb, mb, m2b). m2 is the sum of squared
// deviations from the mean: no E[x^2] - E[x]^2 cancellation.
template <typename T>
__device__ __forceinline__ void chan(T& n, T& mean, T& m2, T nb, T mb, T m2b) {
  if (nb == T(0)) return;
  if (n == T(0)) {
    n = nb;
    mean = mb;
    m2 = m2b;
    return;
  }
  const T nn = n + nb;
  const T d = mb - mean;
  const T f = nb / nn;
  mean = mean + d * f;
  m2 = m2 + m2b + d * d * n * f;
  n = nn;
}

// The address of element q of channel c's own order (image major, then the
// plane), in units of E (float4 or float) of planes hw_e long.
template <typename E>
__device__ __forceinline__ const E* channel_at(const float* base, unsigned q, unsigned hw_e,
                                               long long plane0, long long stride) {
  const unsigned b = q / hw_e;
  return reinterpret_cast<const E*>(base + static_cast<long long>(b) * stride + plane0) +
         (q - b * hw_e);
}

// Block (s, c) of the grid (S, C) takes channel c's elements [s L, s L + L)
// in the channel's own order. A thread loads kRedUnroll float4s (scalars
// off the vector path) at once, takes their mean and squared deviations in
// registers, and merges them into its moments; the block's threads then
// merge theirs through the warps' shuffles and shared memory.
template <bool kVec>
__global__ void __launch_bounds__(kRed)
bn_stats_partial(const float* __restrict__ x, float2* __restrict__ part, int C, unsigned hw,
                 unsigned n, unsigned L) {
  const int c = blockIdx.y;
  const unsigned lo = blockIdx.x * L;
  const unsigned hi = n - lo < L ? n : lo + L;
  const long long plane0 = static_cast<long long>(c) * hw;
  const long long stride = static_cast<long long>(C) * hw;
  constexpr int kW = kVec ? 4 : 1;  // elements a load
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  for (unsigned q0 = lo / kW + threadIdx.x; q0 < hi / kW; q0 += kRed * kRedUnroll) {
    float v[kRedUnroll][kW];
    int k = 0;  // the loads in range: a prefix of the kRedUnroll
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u) {
      const unsigned q = q0 + u * kRed;
      if (q < hi / kW) {
        if constexpr (kVec) {
          const float4 f = *channel_at<float4>(x, q, hw / 4, plane0, stride);
          v[u][0] = f.x;
          v[u][1] = f.y;
          v[u][2] = f.z;
          v[u][3] = f.w;
        } else {
          v[u][0] = *channel_at<float>(x, q, hw, plane0, stride);
        }
        k = u + 1;
      }
    }
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u)
#pragma unroll
      for (int e = 0; e < kW; ++e)
        if (u < k) s += v[u][e];
    const float gn = static_cast<float>(k * kW);
    const float gm = s / gn;
    float gq = 0.f;
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u)
#pragma unroll
      for (int e = 0; e < kW; ++e)
        if (u < k) {
          const float d = v[u][e] - gm;
          gq += d * d;
        }
    chan(cnt, mean, m2, gn, gm, gq);
  }
  // the block's moments: lane 0 of each warp holds its warp's, then warp 0
  // merges the eight
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, cnt, o);
    const float mb = __shfl_down_sync(0xffffffffu, mean, o);
    const float qb = __shfl_down_sync(0xffffffffu, m2, o);
    chan(cnt, mean, m2, nb, mb, qb);
  }
  __shared__ float s_n[kWarps], s_mean[kWarps], s_m2[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_n[warp] = cnt;
    s_mean[warp] = mean;
    s_m2[warp] = m2;
  }
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kWarps ? s_n[lane] : 0.f;
    mean = lane < kWarps ? s_mean[lane] : 0.f;
    m2 = lane < kWarps ? s_m2[lane] : 0.f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, cnt, o);
      const float mb = __shfl_down_sync(0xffffffffu, mean, o);
      const float qb = __shfl_down_sync(0xffffffffu, m2, o);
      chan(cnt, mean, m2, nb, mb, qb);
    }
    if (lane == 0) part[static_cast<long long>(c) * gridDim.x + blockIdx.x] = make_float2(mean, m2);
  }
}

// A warp a channel merges the S blocks' moments in double (each block's
// count from the split), then lane 0 writes the mean and 1 / sqrt(var +
// eps) (var biased, over the n elements) and updates the running mean and
// the running (unbiased) variance with the momentum, as BatchNorm2d does;
// one thread adds 1 to num_batches_tracked.
__global__ void bn_stats_finalize(const float2* __restrict__ part, int C, int S, long long n,
                                  long long L, float* __restrict__ rmean,
                                  float* __restrict__ rvar, long long* __restrict__ batches,
                                  float* __restrict__ save_mean,
                                  float* __restrict__ save_invstd) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *batches += 1;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (c >= C) return;
  double cnt = 0.0, mean = 0.0, m2 = 0.0;
  for (int s = lane; s < S; s += 32) {
    const long long left = n - static_cast<long long>(s) * L;
    const float2 p = part[static_cast<long long>(c) * S + s];
    chan(cnt, mean, m2, static_cast<double>(left < L ? left : L), static_cast<double>(p.x),
         static_cast<double>(p.y));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double nb = __shfl_down_sync(0xffffffffu, cnt, o);
    const double mb = __shfl_down_sync(0xffffffffu, mean, o);
    const double qb = __shfl_down_sync(0xffffffffu, m2, o);
    chan(cnt, mean, m2, nb, mb, qb);
  }
  if (lane != 0) return;
  const float mu = static_cast<float>(mean);
  const float var = static_cast<float>(m2 / static_cast<double>(n));
  save_mean[c] = mu;
  save_invstd[c] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, kEps)));
  const float unbiased = static_cast<float>(m2 / static_cast<double>(n - 1));
  const float keep = __fsub_rn(1.0f, kMomentum);
  rmean[c] = __fadd_rn(__fmul_rn(rmean[c], keep), __fmul_rn(mu, kMomentum));
  rvar[c] = __fadd_rn(__fmul_rn(rvar[c], keep), __fmul_rn(unbiased, kMomentum));
}

// The backward's two sums of channel c, over its elements [s L, s L + L):
// sum g and sum g * xhat, where xhat = (x - mean) * invstd and g is dy, or
// dy where the fused ReLU passed its input (xhat * weight + bias > 0) and 0
// elsewhere, each recomputed as the forward computed it.
template <bool kVec, bool kRelu>
__global__ void __launch_bounds__(kRed)
bn_grad_partial(const float* __restrict__ dy, const float* __restrict__ x,
                const float* __restrict__ mean, const float* __restrict__ invstd,
                const float* __restrict__ weight, const float* __restrict__ bias,
                float2* __restrict__ part, int C, unsigned hw, unsigned n, unsigned L) {
  const int c = blockIdx.y;
  const unsigned lo = blockIdx.x * L;
  const unsigned hi = n - lo < L ? n : lo + L;
  const long long plane0 = static_cast<long long>(c) * hw;
  const long long stride = static_cast<long long>(C) * hw;
  const float mu = mean[c], inv = invstd[c], w = weight[c], b = bias[c];
  constexpr int kW = kVec ? 4 : 1;
  float sg = 0.f, sgx = 0.f;
  for (unsigned q0 = lo / kW + threadIdx.x; q0 < hi / kW; q0 += kRed * kRedUnroll) {
    float vx[kRedUnroll][kW], vg[kRedUnroll][kW];
    int k = 0;
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u) {
      const unsigned q = q0 + u * kRed;
      if (q < hi / kW) {
        if constexpr (kVec) {
          const float4 fx = *channel_at<float4>(x, q, hw / 4, plane0, stride);
          const float4 fg = *channel_at<float4>(dy, q, hw / 4, plane0, stride);
          vx[u][0] = fx.x;
          vx[u][1] = fx.y;
          vx[u][2] = fx.z;
          vx[u][3] = fx.w;
          vg[u][0] = fg.x;
          vg[u][1] = fg.y;
          vg[u][2] = fg.z;
          vg[u][3] = fg.w;
        } else {
          vx[u][0] = *channel_at<float>(x, q, hw, plane0, stride);
          vg[u][0] = *channel_at<float>(dy, q, hw, plane0, stride);
        }
        k = u + 1;
      }
    }
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u)
#pragma unroll
      for (int e = 0; e < kW; ++e)
        if (u < k) {
          const float xh = __fmul_rn(__fsub_rn(vx[u][e], mu), inv);
          float g = vg[u][e];
          if (kRelu && !(__fadd_rn(__fmul_rn(xh, w), b) > 0.0f)) g = 0.0f;
          sg += g;
          sgx += g * xh;
        }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sg += __shfl_down_sync(0xffffffffu, sg, o);
    sgx += __shfl_down_sync(0xffffffffu, sgx, o);
  }
  __shared__ float s_g[kWarps], s_gx[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_g[warp] = sg;
    s_gx[warp] = sgx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sg = 0.f;
    sgx = 0.f;
    for (int i = 0; i < kWarps; ++i) {
      sg += s_g[i];
      sgx += s_gx[i];
    }
    part[static_cast<long long>(c) * gridDim.x + blockIdx.x] = make_float2(sg, sgx);
  }
}

// A warp a channel sums the S blocks' partial sums in double: dbias = sum g,
// dweight = sum g * xhat; then the factors of dx = ((g - dbias / n) - xhat *
// (dweight / n)) * (weight * invstd), each a separately rounded float32
// operation, into fac (3, C).
__global__ void bn_grad_finalize(const float2* __restrict__ part, int C, int S, long long n,
                                 const float* __restrict__ weight,
                                 const float* __restrict__ invstd, float* __restrict__ dweight,
                                 float* __restrict__ dbias, float* __restrict__ fac) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (c >= C) return;
  double sg = 0.0, sgx = 0.0;
  for (int s = lane; s < S; s += 32) {
    const float2 p = part[static_cast<long long>(c) * S + s];
    sg += p.x;
    sgx += p.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sg += __shfl_down_sync(0xffffffffu, sg, o);
    sgx += __shfl_down_sync(0xffffffffu, sgx, o);
  }
  if (lane != 0) return;
  const float db = static_cast<float>(sg), dw = static_cast<float>(sgx);
  const float nf = static_cast<float>(n);
  dbias[c] = db;
  dweight[c] = dw;
  fac[c] = __fmul_rn(weight[c], invstd[c]);
  fac[C + c] = __fdiv_rn(db, nf);
  fac[2 * C + c] = __fdiv_rn(dw, nf);
}

// The elementwise passes over the flat (B, C, H, W) tensor, laid out as
// bn_kernel's: a block takes kThreads * 4 * V consecutive elements, puts
// the factors of the planes they span in shared memory and loads before it
// stores. Forward: y = ((x - mean) * invstd) * weight + bias, then max(y,
// 0) where the ReLU is fused. Backward: xhat and g as bn_grad_partial
// recomputes them, then dx = ((g - mdy) - xhat * mdyx) * scale with fac's
// (scale, mdy, mdyx).
template <int V, bool kVec, bool kRelu, bool kBack>
__global__ void __launch_bounds__(kThreads)
bn_train_map(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ out,
             const float* __restrict__ mean, const float* __restrict__ invstd,
             const float* __restrict__ weight, const float* __restrict__ bias,
             const float* __restrict__ fac, long long n, int C, int hw) {
  constexpr int kElems = kThreads * 4 * V;
  constexpr int kF = kBack ? 7 : 4;
  __shared__ float s_f[kF][kMaxPlanes];
  const long long start = static_cast<long long>(blockIdx.x) * kElems;
  const int count = static_cast<int>(n - start < kElems ? n - start : kElems);
  const long long p0 = start / hw;
  const int off = static_cast<int>(start - p0 * hw);
  const int planes = (off + count - 1) / hw + 1;
  constexpr int kL = kVec ? V : 4 * V;  // loads a thread
  float4 ax[kVec ? V : 1], ag[kVec && kBack ? V : 1];
  float sx[kVec ? 1 : 4 * V], sg[!kVec && kBack ? 4 * V : 1];
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    if constexpr (kVec) {
      const int e = (j * kThreads + threadIdx.x) * 4;
      if (e < count) {
        ax[j] = reinterpret_cast<const float4*>(x + start)[e / 4];
        if constexpr (kBack) ag[j] = reinterpret_cast<const float4*>(dy + start)[e / 4];
      }
    } else {
      const int e = j * kThreads + threadIdx.x;
      if (e < count) {
        sx[j] = x[start + e];
        if constexpr (kBack) sg[j] = dy[start + e];
      }
    }
  }
  for (int i = threadIdx.x; i < planes; i += kThreads) {
    const int c = static_cast<int>((p0 + i) % C);
    s_f[0][i] = mean[c];
    s_f[1][i] = invstd[c];
    s_f[2][i] = weight[c];
    s_f[3][i] = bias[c];
    if constexpr (kBack) {
      s_f[4][i] = fac[c];
      s_f[5][i] = fac[C + c];
      s_f[6][i] = fac[2 * C + c];
    }
  }
  __syncthreads();
  auto map = [&](float v, float g, int i) {
    const float xh = __fmul_rn(__fsub_rn(v, s_f[0][i]), s_f[1][i]);
    const float y = __fadd_rn(__fmul_rn(xh, s_f[2][i]), s_f[3][i]);
    if constexpr (!kBack) {
      return kRelu ? (y > 0.0f ? y : 0.0f) : y;
    } else {
      if (kRelu && !(y > 0.0f)) g = 0.0f;
      return __fmul_rn(__fsub_rn(__fsub_rn(g, s_f[5][i]), __fmul_rn(xh, s_f[6][i])), s_f[4][i]);
    }
  };
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    if constexpr (kVec) {
      const int e = (j * kThreads + threadIdx.x) * 4;
      if (e >= count) continue;
      const int i = (off + e) / hw;  // a float4 lies in one plane (hw % 4 == 0)
      const float4 v = ax[j];
      float4 g = v;
      if constexpr (kBack) g = ag[j];
      float4 r;
      r.x = map(v.x, g.x, i);
      r.y = map(v.y, g.y, i);
      r.z = map(v.z, g.z, i);
      r.w = map(v.w, g.w, i);
      reinterpret_cast<float4*>(out + start)[e / 4] = r;
    } else {
      const int e = j * kThreads + threadIdx.x;
      if (e >= count) continue;
      float g = 0.0f;
      if constexpr (kBack) g = sg[j];
      out[start + e] = map(sx[j], g, (off + e) / hw);
    }
  }
}

template <int V, bool kVec, bool kRelu, bool kBack>
cudaError_t launch_map(long long blocks, cudaStream_t s, const float* x, const float* dy,
                       float* out, const float* mean, const float* invstd, const float* weight,
                       const float* bias, const float* fac, long long n, int C, int hw) {
  bn_train_map<V, kVec, kRelu, kBack><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      x, dy, out, mean, invstd, weight, bias, fac, n, C, hw);
  return cudaGetLastError();
}

template <bool kRelu, bool kBack>
cudaError_t map_pass(const float* x, const float* dy, float* out, const float* mean,
                     const float* invstd, const float* weight, const float* bias,
                     const float* fac, int B, int C, int hw, cudaStream_t s) {
  const long long n = static_cast<long long>(B) * C * hw;
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return cudaGetLastError();
  }
  auto blocks_of = [&](int v) { return (n + kThreads * 4 * v - 1) / (kThreads * 4 * v); };
  int V = 4;
  while (V > 1 && (blocks_of(V) < 2LL * sms || (kThreads * 4 * V - 1) / hw + 2 > kMaxPlanes))
    V /= 2;
  const long long blocks = blocks_of(V);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = hw % 4 == 0 && aligned(x) && aligned(out) && (!kBack || aligned(dy));
  if (V == 4)
    return vec ? launch_map<4, true, kRelu, kBack>(blocks, s, x, dy, out, mean, invstd, weight,
                                                    bias, fac, n, C, hw)
               : launch_map<4, false, kRelu, kBack>(blocks, s, x, dy, out, mean, invstd,
                                                     weight, bias, fac, n, C, hw);
  if (V == 2)
    return vec ? launch_map<2, true, kRelu, kBack>(blocks, s, x, dy, out, mean, invstd, weight,
                                                    bias, fac, n, C, hw)
               : launch_map<2, false, kRelu, kBack>(blocks, s, x, dy, out, mean, invstd,
                                                     weight, bias, fac, n, C, hw);
  return vec ? launch_map<1, true, kRelu, kBack>(blocks, s, x, dy, out, mean, invstd, weight,
                                                  bias, fac, n, C, hw)
             : launch_map<1, false, kRelu, kBack>(blocks, s, x, dy, out, mean, invstd, weight,
                                                   bias, fac, n, C, hw);
}

// The split of a channel's n elements over S blocks: L = ceil(n / S),
// rounded up to a whole float4.
unsigned split_len(long long n, int S) {
  const long long l = (n + S - 1) / S;
  return static_cast<unsigned>((l + 3) / 4 * 4);
}

// Every block of the split takes at least one element, and every index of
// a channel, with a load's reach past its end, fits in 32 bits.
bool splits_ok(int B, int C, int hw, int S) {
  const long long n = static_cast<long long>(B) * hw;
  return B > 0 && C > 0 && hw > 0 && S > 0 && S <= 65535 && C <= 65535 && n > 1 &&
         n + 4LL * kRed * kRedUnroll < (1LL << 32) &&
         static_cast<long long>(split_len(n, S)) * (S - 1) < n;
}

}  // namespace

// Training forward. x, out: (B, C, H, W) float32, contiguous; weight, bias,
// running_mean, running_var, save_mean, save_invstd: (C,); batches: one
// int64 (num_batches_tracked); part: (C, splits) float2 scratch. Writes out
// (with max(., 0) where relu), save_mean and save_invstd (1 / sqrt(biased
// var + eps)), and updates the running statistics and batches in place.
extern "C" int cadx_batchnorm_train(const void* x, const void* weight, const void* bias,
                                    void* running_mean, void* running_var, void* batches,
                                    void* save_mean, void* save_invstd, void* part, void* out,
                                    int B, int C, int H, int W, int splits, int relu,
                                    void* stream) {
  const int hw = H * W;
  if (!splits_ok(B, C, hw, splits)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * hw;
  const unsigned L = split_len(n, splits);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  auto* pt = static_cast<float2*>(part);
  const bool vec = hw % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(splits, C);
  if (vec)
    bn_stats_partial<true><<<grid, kRed, 0, s>>>(xf, pt, C, hw, static_cast<unsigned>(n), L);
  else
    bn_stats_partial<false><<<grid, kRed, 0, s>>>(xf, pt, C, hw, static_cast<unsigned>(n), L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* mean = static_cast<float*>(save_mean);
  auto* invstd = static_cast<float*>(save_invstd);
  bn_stats_finalize<<<(C + kWarps - 1) / kWarps, kRed, 0, s>>>(
      pt, C, splits, n, L, static_cast<float*>(running_mean), static_cast<float*>(running_var),
      static_cast<long long*>(batches), mean, invstd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* w = static_cast<const float*>(weight);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  err = relu ? map_pass<true, false>(xf, nullptr, o, mean, invstd, w, b, nullptr, B, C, hw, s)
             : map_pass<false, false>(xf, nullptr, o, mean, invstd, w, b, nullptr, B, C, hw, s);
  return static_cast<int>(err);
}

// Training backward. dy, x, dx: (B, C, H, W) float32, contiguous; weight,
// bias, save_mean, save_invstd (the forward's), dweight, dbias: (C,); part:
// (C, splits) float2 and fac: (3, C) float32 scratch. relu: the forward
// fused the ReLU, whose mask is recomputed from x.
extern "C" int cadx_batchnorm_train_backward(const void* dy, const void* x, const void* weight,
                                             const void* bias, const void* save_mean,
                                             const void* save_invstd, void* part, void* fac,
                                             void* dweight, void* dbias, void* dx, int B, int C,
                                             int H, int W, int splits, int relu, void* stream) {
  const int hw = H * W;
  if (!splits_ok(B, C, hw, splits)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * hw;
  const unsigned L = split_len(n, splits);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(dy);
  const auto* xf = static_cast<const float*>(x);
  const auto* mean = static_cast<const float*>(save_mean);
  const auto* invstd = static_cast<const float*>(save_invstd);
  const auto* w = static_cast<const float*>(weight);
  const auto* b = static_cast<const float*>(bias);
  auto* pt = static_cast<float2*>(part);
  auto* f = static_cast<float*>(fac);
  const bool vec = hw % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const dim3 grid(splits, C);
  const auto un = static_cast<unsigned>(n);
  if (vec && relu)
    bn_grad_partial<true, true><<<grid, kRed, 0, s>>>(g, xf, mean, invstd, w, b, pt, C, hw, un, L);
  else if (vec)
    bn_grad_partial<true, false><<<grid, kRed, 0, s>>>(g, xf, mean, invstd, w, b, pt, C, hw, un,
                                                       L);
  else if (relu)
    bn_grad_partial<false, true><<<grid, kRed, 0, s>>>(g, xf, mean, invstd, w, b, pt, C, hw, un,
                                                       L);
  else
    bn_grad_partial<false, false><<<grid, kRed, 0, s>>>(g, xf, mean, invstd, w, b, pt, C, hw, un,
                                                        L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_grad_finalize<<<(C + kWarps - 1) / kWarps, kRed, 0, s>>>(
      pt, C, splits, n, w, invstd, static_cast<float*>(dweight), static_cast<float*>(dbias), f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* o = static_cast<float*>(dx);
  err = relu ? map_pass<true, true>(xf, g, o, mean, invstd, w, b, f, B, C, hw, s)
             : map_pass<false, true>(xf, g, o, mean, invstd, w, b, f, B, C, hw, s);
  return static_cast<int>(err);
}
