// Fused k x k stride-1 convolution + bias + LeakyReLU in bfloat16 on the
// tensor cores: the bfloat16 form of conv_leaky.cu, for the classifiers'
// opt-in mixed precision (models/cnn.py::conv_stack(..., compute_dtype=)).
// Replaces cadx_tpu/kernels/nn_kernels.py::conv2d_leaky_pallas at
// bfloat16 (JAX runs cnn.conv_stack's bf16 convs through XLA); see
// cadx_tpu_torch/kernels/conv_leaky.py for the contract and its bound.
//
// A direct implicit GEMM, M = output pixels, N = filters, K = C * k * k,
// on mma.sync.m16n8k16 (bf16 operands, float32 accumulators):
// - a block of 4 warps computes an 8-row x 16-column tile of one image's
//   output pixels by BN filters (32 or 64; more filters take more blocks
//   along the grid's y), a warp two rows of 16 pixels (two m16 tiles) by
//   BN / 8 n8 tiles;
// - K runs as chunks of 16 channels: the block stages the input window of
//   the chunk ((8 + k - 1) x (16 + k - 1) pixels, zeros outside the image:
//   the SAME padding) pixel-major, 16 channels a pixel at a pitch of 24
//   bf16 (the fragment loads of a warp fall in 32 banks), and the weights
//   of the chunk [tap][filter][16 channels] at the same pitch; then each
//   tap is one k16 step: the A fragment of a pixel row is the window's row
//   shifted by the tap, the B fragment the tap's filters;
// - x is read in place in both layouts the float32 form takes (NCHW
//   contiguous, or the NHWC view, whose 16 channels of a pixel are two
//   16-byte loads where C is a multiple of 8); the weights come
//   transposed to (k, k, F, C) by the wrapper.
// - The epilogue repeats JAX's rounding order: the sum rounded to bf16
//   (XLA's conv result type), plus the float32 bias, rounded to bf16, then
//   LeakyReLU in bf16 (alpha rounded to bf16, the product rounded), the
//   output NCHW bf16.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTH = 8, kTW = 16;    // output tile: rows x columns
constexpr int kChunk = 16;          // channels a K step
constexpr int kPitch = 24;          // bf16 a staged pixel or filter row

struct Shape {
  int B, C, H, W, F, k, pad, OH, OW, layout, tiles_x;
};

// mma.sync m16n8k16, row-major A (16 x 16), column-major B (16 x 8), float32
// accumulators in place
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, Shape s,
                 float alpha) {
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int k = s.k, PR = kTH + k - 1, PW = kTW + k - 1, PP = PR * PW, taps = k * k;
  __nv_bfloat16* wsm = patch + PP * kPitch;
  const int img = blockIdx.z, fb = blockIdx.y * BN;
  const int oy0 = blockIdx.x / s.tiles_x * kTH, ox0 = blockIdx.x % s.tiles_x * kTW;
  const int iy0 = oy0 - s.pad, ix0 = ox0 - s.pad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  // 16-byte loads where 8 channels start 16-byte aligned
  const bool vec_w = (s.C & 7) == 0;
  const bool vec_x = vec_w && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long hw = static_cast<long long>(s.H) * s.W;
  const __nv_bfloat16* xi = x + static_cast<long long>(img) * s.C * hw;

  float acc[2][BN / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;

  for (int c0 = 0; c0 < s.C; c0 += kChunk) {
    // stage the input window of channels c0 .. c0 + 15
    if (s.layout == 1 && vec_x) {
      for (int i = threadIdx.x; i < PP * 2; i += kThreads) {
        const int p = i >> 1, half = i & 1;
        const int y = iy0 + p / PW, xx = ix0 + p % PW, c = c0 + half * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (y >= 0 && y < s.H && xx >= 0 && xx < s.W && c < s.C)
          v = *reinterpret_cast<const uint4*>(xi + (static_cast<long long>(y) * s.W + xx) * s.C +
                                              c);
        *reinterpret_cast<uint4*>(patch + p * kPitch + half * 8) = v;
      }
    } else {
      for (int i = threadIdx.x; i < PP * kChunk; i += kThreads) {
        const int cc = i / PP, p = i - cc * PP;
        const int y = iy0 + p / PW, xx = ix0 + p % PW, c = c0 + cc;
        __nv_bfloat16 v = zero;
        if (y >= 0 && y < s.H && xx >= 0 && xx < s.W && c < s.C)
          v = s.layout == 1 ? xi[(static_cast<long long>(y) * s.W + xx) * s.C + c]
                            : xi[c * hw + static_cast<long long>(y) * s.W + xx];
        patch[p * kPitch + cc] = v;
      }
    }
    // stage the chunk's weights: [tap][filter][16 channels]
    if (vec_w) {
      for (int i = threadIdx.x; i < taps * BN * 2; i += kThreads) {
        const int half = i & 1, row = i >> 1, tap = row / BN, f = row - tap * BN;
        const int c = c0 + half * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (fb + f < s.F && c < s.C)
          v = *reinterpret_cast<const uint4*>(
              wt + (static_cast<long long>(tap) * s.F + fb + f) * s.C + c);
        *reinterpret_cast<uint4*>(wsm + row * kPitch + half * 8) = v;
      }
    } else {
      for (int i = threadIdx.x; i < taps * BN * kChunk; i += kThreads) {
        const int cc = i & (kChunk - 1), row = i >> 4, tap = row / BN, f = row - tap * BN;
        const int c = c0 + cc;
        wsm[row * kPitch + cc] =
            fb + f < s.F && c < s.C ? wt[(static_cast<long long>(tap) * s.F + fb + f) * s.C + c]
                                    : zero;
      }
    }
    __syncthreads();
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(patch);
    const uint32_t* ww = reinterpret_cast<const uint32_t*>(wsm);
    for (int tap = 0; tap < taps; ++tap) {
      const int ky = tap / k, kx = tap - ky * k;
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int base = ((warp * 2 + m + ky) * PW + kx) * (kPitch / 2) + t;
        a[m][0] = pw[base + g * (kPitch / 2)];
        a[m][1] = pw[base + (g + 8) * (kPitch / 2)];
        a[m][2] = pw[base + g * (kPitch / 2) + 4];
        a[m][3] = pw[base + (g + 8) * (kPitch / 2) + 4];
      }
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int wb = (tap * BN + n * 8 + g) * (kPitch / 2) + t;
        const uint32_t b[2] = {ww[wb], ww[wb + 4]};
        mma16816(acc[0][n], a[0], b);
        mma16816(acc[1][n], a[1], b);
      }
    }
    __syncthreads();
  }

  // epilogue: rint to bf16, + bias (float32), rint to bf16, LeakyReLU in bf16
  const float alpha_b = __bfloat162float(__float2bfloat16_rn(alpha));
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int oy = oy0 + warp * 2 + m;
    if (oy >= s.OH) continue;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int f = fb + n * 8 + 2 * t + (r & 1), ox = ox0 + g + (r >> 1) * 8;
        if (f >= s.F || ox >= s.OW) continue;
        const float z = __bfloat162float(__float2bfloat16_rn(acc[m][n][r]));
        const float v = __bfloat162float(__float2bfloat16_rn(z + bias[f]));
        const __nv_bfloat16 y = __float2bfloat16_rn(v > 0.f ? v : v * alpha_b);
        out[((static_cast<long long>(img) * s.F + f) * s.OH + oy) * s.OW + ox] = y;
      }
  }
}

template <int BN>
size_t smem_bytes(int k) {
  return static_cast<size_t>((kTH + k - 1) * (kTW + k - 1) + k * k * BN) * kPitch * 2;
}

template <int BN>
int launch(const void* x, const void* wt, const void* bias, void* out, const Shape& s,
           float alpha, cudaStream_t st) {
  const size_t smem = smem_bytes<BN>(s.k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(conv_bf16_kernel<BN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles = static_cast<long long>(s.tiles_x) * ((s.OH + kTH - 1) / kTH);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), (s.F + BN - 1) / BN, s.B);
  conv_bf16_kernel<BN><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), s, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, C, H, W) bf16, NCHW contiguous (layout 0) or the NHWC view
// (layout 1, a contiguous (B, H, W, C) buffer); wt: (k, k, F, C) bf16
// contiguous; bias: (F,) float32; out: (B, F, OH, OW) bf16 contiguous, OH =
// H + 2 pad - k + 1, OW likewise. Images along the grid's z (B <= 65535).
extern "C" int cadx_conv_leaky_bf16(const void* x, const void* wt, const void* bias, void* out,
                                    int B, int C, int H, int W, int F, int k, int pad,
                                    int layout, float alpha, void* stream) {
  const int OH = H + 2 * pad - k + 1, OW = W + 2 * pad - k + 1;
  if (B <= 0 || F <= 0 || OH <= 0 || OW <= 0) return 0;
  if (B > 65535 || C <= 0 || k <= 0 || (layout != 0 && layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, C, H, W, F, k, pad, OH, OW, layout, (OW + kTW - 1) / kTW};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 64 filters a block where that fits the block's shared memory, else 32
  if (F > 32 && smem_bytes<64>(k) <= 227 * 1024)
    return launch<64>(x, wt, bias, out, s, alpha, st);
  if (smem_bytes<32>(k) > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  return launch<32>(x, wt, bias, out, s, alpha, st);
}
