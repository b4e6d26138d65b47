// JET lookup of a uint8 heatmap blended onto an image, normalised by the
// image's peak, in two forms chosen by shape. Replaces
// cadx_tpu/kernels/overlay.py::jet_blend_pallas; see
// cadx_tpu_torch/kernels/overlay.py for the layout and its bound.
//
// A thread takes a group of 16 pixels: their heat as one 16-byte load, the
// gray image as four float4 (RGB: twelve), and their 48 overlay bytes as
// three 16-byte stores. Image b starts at pixel b * H * W, which need not be
// 16-byte aligned: its groups start at its first pixel whose heat byte is,
// and the pixels before that (the head) and after its last whole group (the
// tail), fewer than 16 each, go one a thread to threads 0-15 and 16-31 of
// the image's first block. Where the heat, the image or the output does not
// start on a 16-byte boundary, the same groups load and store a scalar at a
// time.
//
// The one-launch form, wherever the images fit one block an SM at up to
// 512 threads a block (every path's overlays but the pipeline's B=64
// batch; at 1,024 threads it measured slower than the wide form): a
// cooperative launch, a group a thread. Each thread keeps its group's
// inputs in registers (at 512 threads a block a thread may have 128, room
// for an RGB group's 48 floats). It takes its blends' maximum, the block takes the block's and writes it to its slot of a
// scratch of a float a block; after the grid's barrier every block takes
// its image's peak from its image's slots, and every thread recomputes its
// blends from what it holds (the same operations, so the same floats) and
// writes them. The inputs are read once; no memset, no atomic.
//
// The wide form, for the rest: a memset of the (B,) int32 peaks, then
// two passes over chunks x images: the first takes each block's maximum to
// its image's peak with an integer atomicMax (the blends are >= 1e-7 > 0
// there, where float order is integer order); the second reads the inputs
// again, recomputes each blend and writes it.
//
// The arithmetic a channel is cut to the bone: the table is four planes of
// floats in shared memory (jet / 255 per channel, as the plain version
// computes it, and their maximum: adding the image
// value is monotone, so a gray pixel's largest blend is its largest
// channel's, one lookup and one add); a blend's quotient by the peak is
// q0 = b * r with r = 1 / peak rounded, corrected once by the exact residual
// b - q0 * peak (an FMA), which gives the rounded quotient exactly
// (Markstein's theorem: r within half an ulp of 1 / peak and q0 within an
// ulp of b / peak; the step of IEEE division itself); and the truncation of
// q * 255 in [0, 255] is an add of 2^23 rounding down, whose low byte it
// is. That path holds for blends of 0 or in [2^-40, peak] with the peak
// at most 2^40; a thread that holds any other finite value (a negative, a
// tiny or a huge image value) divides with __fdiv_rn and converts through
// int64, as PyTorch does. For finite image values every float is the plain
// version's, in its order; the maximum does not depend on order, so the
// output is bit-exact and the same on every run. A NaN is outside the
// contract ([0, 1]): fmaxf drops it from the peak, where the plain
// version's amax keeps it.
#include <atomic>
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "jet.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kLevels = 256;
constexpr int kPlanes = 4;                         // red, green, blue, their maximum
constexpr int kGroup = 16;                         // pixels a thread: one 16-byte heat load
constexpr int kOutWords = 3 * kGroup / 4;          // a group's overlay bytes as 32-bit words
constexpr int kOnceThreads = 512;                  // the one-launch form's largest block
constexpr int kRgbVecs = 3 * kGroup / 4;           // float4 of an RGB group
constexpr int kWideThreads = 256;
constexpr long long kTargetBlocks = 4 * 132;       // about four blocks an SM
constexpr int kMaxGroupsPerThread = 16;
constexpr float kFastLo = 0x1p-40f;                // the exact quotient path's range
constexpr float kFastHi = 0x1p40f;

// The table's planes: jet / 255 per channel and their maximum, uploaded once
// a device from the host's RGB table.
__device__ __align__(16) float kTable[kPlanes][kLevels];

int ensure_table(const void* lut_rgb) {
  static std::atomic<bool> ready[cadx_jet::kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < cadx_jet::kMaxDevices && ready[dev].load()) return 0;
  const auto* rgb = static_cast<const uint8_t*>(lut_rgb);
  float host[kPlanes][kLevels];
  for (int i = 0; i < kLevels; ++i) {
    float m = 0.0f;
    for (int c = 0; c < 3; ++c) {
      // a float product rounded to nearest, as the card's __fmul_rn
      host[c][i] = static_cast<float>(rgb[3 * i + c]) * (1.0f / 255.0f);
      m = host[c][i] > m ? host[c][i] : m;
    }
    host[3][i] = m;
  }
  err = cudaMemcpyToSymbol(kTable, host, sizeof(host));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < cadx_jet::kMaxDevices) ready[dev].store(true);
  return 0;
}

// Copies the table to shared memory, 16 bytes a thread; the caller
// synchronises the block.
__device__ __forceinline__ void load_table(float (*tab)[kLevels]) {
  const auto* src = reinterpret_cast<const float4*>(&kTable[0][0]);
  auto* dst = reinterpret_cast<float4*>(&tab[0][0]);
  for (int i = threadIdx.x; i < kPlanes * kLevels / 4; i += blockDim.x) dst[i] = __ldg(src + i);
}

// Whether image value x keeps its blends on the exact quotient path: 0, or
// in [kFastLo, kFastHi] (a blend is then 0 or in [kFastLo, peak]).
__device__ __forceinline__ bool fast_value(float x) {
  return (x == 0.0f) | ((x >= kFastLo) & (x <= kFastHi));
}

// The general path: RN(RN(b / peak) * 255) to uint8 through int64, as
// PyTorch converts a float to uint8 (a negative product wraps; in [0, 256)
// it is jet.cuh::overlay_u8's truncation).
__device__ __forceinline__ unsigned general_byte(float b, float peak) {
  return static_cast<unsigned>(
             static_cast<long long>(__fmul_rn(__fdiv_rn(b, peak), 255.0f))) & 0xffu;
}

// trunc(RN(RN(b / peak) * 255)) on the exact path (see above); rcp =
// RN(1 / peak).
__device__ __forceinline__ unsigned fast_byte(float b, float peak, float rcp) {
  const float q0 = __fmul_rn(b, rcp);
  const float q = __fmaf_rn(__fmaf_rn(-q0, peak, b), rcp, q0);
  return __float_as_uint(__fadd_rd(__fmul_rn(q, 255.0f), 0x1p23f)) & 0xffu;
}

// Where image b's pixels go: [first, first + head) and the tail after the
// groups one a thread, `groups` groups of kGroup between.
struct Split {
  long long first, groups;
  int head, tail;
};

__device__ __forceinline__ Split split_image(long long b, long long n, bool vec) {
  const long long first = b * n;
  const int head = vec ? static_cast<int>(min((kGroup - first % kGroup) % kGroup, n)) : 0;
  const long long groups = (n - head) / kGroup;
  return Split{first, groups, head, static_cast<int>(n - head - groups * kGroup)};
}

// The pixel that thread t of an image's first block takes one a thread: the
// head on threads 0-15, the tail on 16-31; -1 for none.
__device__ __forceinline__ long long scalar_pixel(const Split& s, int t) {
  if (t < s.head) return s.first + t;
  if (t >= kGroup && t < kGroup + s.tail)
    return s.first + s.head + s.groups * kGroup + (t - kGroup);
  return -1;
}

__device__ __forceinline__ uint4 load_heat(const uint8_t* heat, long long p0, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(heat + p0));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    w[j >> 2] |= static_cast<unsigned>(heat[p0 + j]) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned heat_byte(const uint4& h, int j) {
  const unsigned w = j < 4 ? h.x : j < 8 ? h.y : j < 12 ? h.z : h.w;
  return (w >> (8 * (j & 3))) & 0xffu;
}

// float4 k of the image values of the group at pixel p0 (C channels).
template <int C>
__device__ __forceinline__ float4 load_values(const float* img, long long p0, int k, bool vec) {
  const float* src = img + p0 * C + 4 * k;
  return vec ? __ldg(reinterpret_cast<const float4*>(src))
             : make_float4(src[0], src[1], src[2], src[3]);
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A group's largest blend (at least m), and whether all its values keep the
// exact path (fast &= ...); get(k) is the group's float4 k of image values.
template <bool kRgb, class Get>
__device__ __forceinline__ float group_max(const float (*tab)[kLevels], const uint4& h,
                                           const Get& get, float m, bool& fast) {
#pragma unroll
  for (int k = 0; k < (kRgb ? kRgbVecs : kGroup / 4); ++k) {
    const float4 v = get(k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * k + i;  // gray: pixel q; RGB: pixel q / 3, channel q % 3
      const float x = component(v, i);
      fast &= fast_value(x);
      const float t = kRgb ? tab[q % 3][heat_byte(h, q / 3)] : tab[3][heat_byte(h, q)];
      m = fmaxf(m, __fadd_rn(t, x));
    }
  }
  return m;
}

// Writes a group's 48 overlay bytes at pixel p0, on the exact quotient path
// where kFast.
template <bool kRgb, bool kFast, class Get>
__device__ __forceinline__ void write_group(const float (*tab)[kLevels], const uint4& h,
                                            const Get& get, float peak, float rcp, uint8_t* out,
                                            long long p0, bool vec) {
  unsigned w[kOutWords];
#pragma unroll
  for (int i = 0; i < kOutWords; ++i) w[i] = 0u;
#pragma unroll
  for (int k = 0; k < (kRgb ? kRgbVecs : kGroup / 4); ++k) {
    const float4 v = get(k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = component(v, i);
#pragma unroll
      for (int c = 0; c < (kRgb ? 1 : 3); ++c) {
        // the output byte q = 3 * pixel + channel
        const int q = kRgb ? 4 * k + i : 3 * (4 * k + i) + c;
        const float b = __fadd_rn(tab[q % 3][heat_byte(h, q / 3)], x);
        const unsigned v8 = kFast ? fast_byte(b, peak, rcp) : general_byte(b, peak);
        w[q >> 2] |= v8 << (8 * (q & 3));
      }
    }
  }
  uint8_t* dst = out + 3 * p0;
  if (vec) {
    auto* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
    d[2] = make_uint4(w[8], w[9], w[10], w[11]);
  } else {
#pragma unroll
    for (int q = 0; q < 3 * kGroup; ++q) dst[q] = (w[q >> 2] >> (8 * (q & 3))) & 0xffu;
  }
}

// write_group on the path the group's values allow.
template <bool kRgb, class Get>
__device__ __forceinline__ void write_group_on(bool fast, const float (*tab)[kLevels],
                                               const uint4& h, const Get& get, float peak,
                                               float rcp, uint8_t* out, long long p0, bool vec) {
  if (fast && peak <= kFastHi) {
    write_group<kRgb, true>(tab, h, get, peak, rcp, out, p0, vec);
  } else {
    write_group<kRgb, false>(tab, h, get, peak, rcp, out, p0, vec);
  }
}

// One pixel's heat and image values (a gray value in all three).
struct Pixel {
  long long p;
  unsigned heat;
  float x[3];
};

template <int C>
__device__ __forceinline__ Pixel load_pixel(const uint8_t* heat, const float* img, long long p) {
  Pixel px{p, 0u, {0.0f, 0.0f, 0.0f}};
  if (p < 0) return px;
  px.heat = heat[p];
#pragma unroll
  for (int c = 0; c < 3; ++c) px.x[c] = img[p * C + (C == 3 ? c : 0)];
  return px;
}

__device__ __forceinline__ float pixel_max(const float (*tab)[kLevels], const Pixel& px, float m) {
  if (px.p < 0) return m;
#pragma unroll
  for (int c = 0; c < 3; ++c) m = fmaxf(m, __fadd_rn(tab[c][px.heat], px.x[c]));
  return m;
}

__device__ __forceinline__ void write_pixel(const float (*tab)[kLevels], const Pixel& px,
                                            float peak, uint8_t* out) {
  if (px.p < 0) return;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[3 * px.p + c] = general_byte(__fadd_rn(tab[c][px.heat], px.x[c]), peak);
}

// Whether all of a group's image values keep the exact quotient path.
template <bool kRgb, class Get>
__device__ __forceinline__ bool group_fast(const Get& get) {
  bool fast = true;
#pragma unroll
  for (int k = 0; k < (kRgb ? kRgbVecs : kGroup / 4); ++k) {
    const float4 v = get(k);
    fast &= fast_value(v.x) & fast_value(v.y) & fast_value(v.z) & fast_value(v.w);
  }
  return fast;
}

// The one-launch form (see above): block r of image b = blockIdx.x /
// per_image takes groups r * T ... r * T + T - 1, a group a thread, and
// writes its maximum to partial[blockIdx.x]; after the grid's barrier each
// block takes its image's peak from the image's per_image partials.
template <bool kRgb>
__global__ void __launch_bounds__(kOnceThreads)
jet_once(const uint8_t* __restrict__ heat, const float* __restrict__ img, float* partial,
         uint8_t* __restrict__ out, long long n, int per_image, bool vec) {
  constexpr int C = kRgb ? 3 : 1;
  constexpr int kVecs = kRgb ? kRgbVecs : kGroup / 4;
  __shared__ __align__(16) float tab[kPlanes][kLevels];
  __shared__ float scratch[32];
  const long long b = blockIdx.x / per_image;
  const int r = static_cast<int>(blockIdx.x - b * per_image);
  const int t = threadIdx.x, T = blockDim.x;
  const Split s = split_image(b, n, vec);
  const long long gi = static_cast<long long>(r) * T + t;
  const bool has = gi < s.groups;
  const long long p0 = s.first + s.head + gi * kGroup;
  uint4 h = make_uint4(0u, 0u, 0u, 0u);
  float4 vals[kVecs];
  if (has) {
    h = load_heat(heat, p0, vec);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) vals[k] = load_values<C>(img, p0, k, vec);
  }
  const Pixel px = load_pixel<C>(heat, img, r == 0 ? scalar_pixel(s, t) : -1);
  load_table(tab);
  __syncthreads();
  const auto get = [&](int k) { return vals[k]; };
  bool fast = true;
  float m = pixel_max(tab, px, 1e-7f);
  if (has) m = group_max<kRgb>(tab, h, get, m, fast);
  m = cadx_jet::block_max(m, scratch);
  if (t == 0) partial[blockIdx.x] = m;
  cg::this_grid().sync();  // every block's maximum in place
  float v = 1e-7f;
  for (int i = t; i < per_image; i += T) v = fmaxf(v, __ldcg(partial + b * per_image + i));
  const float peak = cadx_jet::block_max(v, scratch), rcp = __frcp_rn(peak);
  if (has) write_group_on<kRgb>(fast, tab, h, get, peak, rcp, out, p0, vec);
  write_pixel(tab, px, peak, out);
}

struct Wide {
  long long n;
  int per_image;  // blocks an image
  int passes;     // groups a thread
  bool vec;
};

// The wide form's passes: block b of the grid takes passes x kWideThreads
// groups of image b / per_image, thread t the groups t, t + kWideThreads,
// ... of them; the image's first block also takes its head and tail. The
// first pass (kWrite false) takes the peak, the second writes.
template <bool kRgb, bool kWrite>
__global__ void __launch_bounds__(kWideThreads)
wide_kernel(const uint8_t* __restrict__ heat, const float* __restrict__ img,
            int* __restrict__ peaks, uint8_t* __restrict__ out, Wide g) {
  constexpr int C = kRgb ? 3 : 1;
  __shared__ __align__(16) float tab[kPlanes][kLevels];
  __shared__ float scratch[32];
  const long long b = blockIdx.x / g.per_image;
  const long long c = blockIdx.x - b * g.per_image;
  const Split s = split_image(b, g.n, g.vec);
  const int t = threadIdx.x;
  const Pixel px = load_pixel<C>(heat, img, c == 0 ? scalar_pixel(s, t) : -1);
  load_table(tab);
  __syncthreads();
  const float peak = kWrite ? __int_as_float(peaks[b]) : 0.0f;
  const float rcp = kWrite ? __frcp_rn(peak) : 0.0f;
  float m = pixel_max(tab, px, 1e-7f);
  bool fast = true;
  for (int u = 0; u < g.passes; ++u) {
    const long long gi = (c * g.passes + u) * kWideThreads + t;
    if (gi >= s.groups) break;
    const long long p0 = s.first + s.head + gi * kGroup;
    const uint4 h = load_heat(heat, p0, g.vec);
    float4 v[kRgb ? kRgbVecs : kGroup / 4];
#pragma unroll
    for (int k = 0; k < (kRgb ? kRgbVecs : kGroup / 4); ++k)
      v[k] = load_values<C>(img, p0, k, g.vec);
    const auto get = [&](int k) { return v[k]; };
    if (kWrite) {
      write_group_on<kRgb>(group_fast<kRgb>(get), tab, h, get, peak, rcp, out, p0, g.vec);
    } else {
      m = group_max<kRgb>(tab, h, get, m, fast);
    }
  }
  if (kWrite) {
    write_pixel(tab, px, peak, out);
    return;
  }
  m = cadx_jet::block_max(m, scratch);
  if (t == 0) atomicMax(peaks + b, __float_as_int(m));
}

// Threads a block for the one-launch form at B images of `groups` groups:
// the fewest from 128 to kOnceThreads that put the images on at most `sms`
// blocks (one an SM, so the grid is co-resident), fewer where an image has
// fewer groups (at least a warp, for its head and tail); 0 where
// kOnceThreads do not.
int once_threads(int B, long long groups, int sms) {
  for (long long t = 128; t <= kOnceThreads; t *= 2) {
    if (B * max(1ll, (groups + t - 1) / t) <= sms)
      return static_cast<int>(min(t, max(32ll, (groups + 31) / 32 * 32)));
  }
  return 0;
}

template <bool kRgb>
cudaError_t launch_once(const uint8_t* heat, const float* img, float* partial, uint8_t* out,
                        int B, long long n, int sms, bool vec, cudaStream_t s) {
  const long long groups = n / kGroup;
  const int threads = once_threads(B, groups, sms);
  if (!threads) return cudaErrorInvalidValue;
  int per_image = static_cast<int>(max(1ll, (groups + threads - 1) / threads));
  void* args[] = {&heat, &img, &partial, &out, &n, &per_image, &vec};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(jet_once<kRgb>), dim3(static_cast<unsigned>(B * per_image)),
      dim3(threads), args, 0, s);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <bool kRgb>
cudaError_t launch_wide(const uint8_t* heat, const float* img, int* peaks, uint8_t* out, int B,
                        long long n, bool vec, cudaStream_t s) {
  const long long groups = n / kGroup, total = groups * B;
  const long long passes = min(max((total + kTargetBlocks * kWideThreads - 1) /
                                       (kTargetBlocks * kWideThreads), 1ll),
                               static_cast<long long>(kMaxGroupsPerThread));
  const long long per_image = max(1ll, (groups + passes * kWideThreads - 1) /
                                           (passes * kWideThreads));
  if (per_image * B > INT_MAX) return cudaErrorInvalidValue;
  const Wide g{n, static_cast<int>(per_image), static_cast<int>(passes), vec};
  const auto grid = static_cast<unsigned>(per_image * B);
  cudaMemsetAsync(peaks, 0, static_cast<size_t>(B) * sizeof(int), s);
  wide_kernel<kRgb, false><<<grid, kWideThreads, 0, s>>>(heat, img, peaks, out, g);
  wide_kernel<kRgb, true><<<grid, kWideThreads, 0, s>>>(heat, img, peaks, out, g);
  return cudaGetLastError();
}

}  // namespace

// heat: (B, H, W) uint8; img: float32 in [0, 1], (B, H, W) gray (rgb 0) or
// (B, H, W, 3) RGB (rgb 1); lut_rgb: host (256, 3) uint8; out: (B, H, W, 3)
// uint8 RGB; scratch: max(B, sms) int32. The one-launch form where `once`
// is set, which needs the images on at most `sms` blocks of kOnceThreads
// threads (sms: the card's SMs); else the wide form.
extern "C" int cadx_jet_blend(const void* heat, const void* img, const void* lut_rgb,
                              void* scratch, void* out, int B, int H, int W, int rgb, int once,
                              int sms, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (!scratch) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(H) * W;
  const int rc = ensure_table(lut_rgb);
  if (rc != 0) return rc;
  const auto* h = static_cast<const uint8_t*>(heat);
  const auto* x = static_cast<const float*>(img);
  auto* o = static_cast<uint8_t*>(out);
  const bool vec = ((reinterpret_cast<uintptr_t>(heat) | reinterpret_cast<uintptr_t>(img) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (once) {
    auto* partial = static_cast<float*>(scratch);
    e = rgb ? launch_once<true>(h, x, partial, o, B, n, sms, vec, s)
            : launch_once<false>(h, x, partial, o, B, n, sms, vec, s);
  } else {
    auto* peaks = static_cast<int*>(scratch);
    e = rgb ? launch_wide<true>(h, x, peaks, o, B, n, vec, s)
            : launch_wide<false>(h, x, peaks, o, B, n, vec, s);
  }
  return static_cast<int>(e);
}
