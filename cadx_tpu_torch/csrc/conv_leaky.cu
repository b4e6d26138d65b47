// Fused k x k stride-1 convolution + bias + LeakyReLU in float32.
// Replaces cadx_tpu/kernels/nn_kernels.py::conv2d_leaky_pallas; see
// cadx_tpu_torch/kernels/conv_leaky.py for the layout and its bound.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;               // output tile side (pixels)
constexpr int kThreads = kTile * kTile; // one output pixel per thread
constexpr int kFilters = 16;            // filters per block (and per thread)
constexpr int kMaxChunk = 8;            // input channels per shared-memory chunk
constexpr int kSmemLimit = 48 * 1024;   // static limit, no opt-in needed

__host__ __device__ inline int input_tile_floats(int chunk, int k) {
  // rounded up to 4 floats so the weight tile after it is 16-byte aligned
  const int side = kTile + k - 1;
  return (chunk * side * side + 3) & ~3;
}

__host__ __device__ inline int smem_bytes(int chunk, int k) {
  return (input_tile_floats(chunk, k) + chunk * k * k * kFilters) * 4;
}

// x (B, C, H, W), w (F, C, k, k), b (F,), y (B, F, OH, OW), all contiguous.
// Grid: (output tiles, filter groups, B). Each block stages `chunk`
// channels of its (tile + k - 1)^2 input window (zeros outside the image:
// the SAME padding) and the matching weights of its 16 filters, laid out
// [channel][tap][filter] so one float4 load feeds four FMAs.
__global__ void __launch_bounds__(kThreads)
conv_leaky_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y,
                  int C, int H, int W, int F, int k, int pad, int OH, int OW,
                  int tiles_x, int chunk, float alpha) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int side = kTile + k - 1;
  const int kk = k * k;
  float* ws = xs + input_tile_floats(chunk, k);

  const int oy0 = (blockIdx.x / tiles_x) * kTile;
  const int ox0 = (blockIdx.x % tiles_x) * kTile;
  const int f0 = blockIdx.y * kFilters;
  const long long n = blockIdx.z;
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;

  float acc[kFilters];
#pragma unroll
  for (int f = 0; f < kFilters; ++f) acc[f] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += chunk) {
    const int cc = min(chunk, C - c0);
    for (int i = threadIdx.x; i < cc * side * side; i += kThreads) {
      const int c = i / (side * side);
      const int r = (i / side) % side;
      const int q = i % side;
      const int iy = oy0 + r - pad;
      const int ix = ox0 + q - pad;
      float v = 0.0f;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = x[((n * C + c0 + c) * H + iy) * W + ix];
      xs[i] = v;
    }
    // global reads run along (channel, tap) of one filter: contiguous
    for (int i = threadIdx.x; i < kFilters * cc * kk; i += kThreads) {
      const int f = i / (cc * kk);
      const int t = i % (cc * kk);  // c * kk + tap
      ws[t * kFilters + f] =
          f0 + f < F ? w[(static_cast<long long>(f0 + f) * C + c0) * kk + t] : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      for (int di = 0; di < k; ++di) {
        const float* xrow = xs + (c * side + ty + di) * side + tx;
        const float4* wrow =
            reinterpret_cast<const float4*>(ws + (c * kk + di * k) * kFilters);
        for (int dj = 0; dj < k; ++dj) {
          const float v = xrow[dj];
#pragma unroll
          for (int q = 0; q < kFilters / 4; ++q) {
            const float4 wv = wrow[dj * (kFilters / 4) + q];
            acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + ty;
  const int ox = ox0 + tx;
  if (oy >= OH || ox >= OW) return;
#pragma unroll
  for (int f = 0; f < kFilters; ++f) {
    if (f0 + f < F) {
      const float z = acc[f] + b[f0 + f];
      // z == 0 takes the alpha branch, as leaky_relu does
      y[((n * F + f0 + f) * OH + oy) * OW + ox] = z > 0.0f ? z : alpha * z;
    }
  }
}

}  // namespace

// x (B, C, H, W), w (F, C, k, k), b (F,) float32 -> y (B, F, OH, OW) with
// OH = H + 2 * pad - k + 1 (pad 0: VALID; pad k // 2: SAME).
extern "C" int cadx_conv_leaky(const void* x, const void* w, const void* b, void* y,
                               int B, int C, int H, int W, int F, int k, int pad,
                               float alpha, void* stream) {
  const int OH = H + 2 * pad - k + 1;
  const int OW = W + 2 * pad - k + 1;
  int chunk = kMaxChunk;
  while (chunk > 1 && smem_bytes(chunk, k) > kSmemLimit) chunk /= 2;
  if (OH < 1 || OW < 1 || B > 65535 || smem_bytes(chunk, k) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (OW + kTile - 1) / kTile;
  const int tiles_y = (OH + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, (F + kFilters - 1) / kFilters, B);
  conv_leaky_kernel<<<grid, kThreads, smem_bytes(chunk, k),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), C, H, W, F, k, pad,
      OH, OW, tiles_x, chunk, alpha);
  return static_cast<int>(cudaGetLastError());
}
