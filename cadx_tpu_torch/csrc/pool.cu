// Non-overlapping window max / mean with the remainder cropped, and the
// max pool's backward.
// The forward replaces cadx_tpu/kernels/nn_kernels.py::max_pool_pallas and
// avg_pool_pallas (their _pool_pallas); the backward replaces no
// pallas_call (JAX leaves the max pool's VJP to XLA). See
// cadx_tpu_torch/kernels/pool.py for the layouts and the bounds.
//
// Backward: dx = g at the selected elements of each window and 0 elsewhere,
// the dropped trailing rows and columns included, in one pass: x, the
// pooled max and g read once, dx written once. An element is selected where
// it equals its window's max (a NaN window selects nothing; -0.0 ties with
// +0.0); the "first" rule keeps only the first such element in raster
// order. dx holds g's bits or +0, so it is bit-exact to the plain version.
// Bound: bytes. The 2x2 form reads a 16-byte chunk of each of a window
// row pair's two rows (4 windows in float32, 8 in bfloat16), the chunk's
// max and g as one 8-byte load each, and stores two 16-byte chunks;
// neighbouring threads take neighbouring chunks, so every warp access is
// contiguous. Other sizes and widths take a scalar form, a thread a window.
// An x in channels-last order (the U-Net's first skip, from cuDNN) takes a
// form that reads it, and writes dx, in that order, the channel fastest
// across a warp, so that the forward's contiguous copy of x need not
// outlive the forward: at s=2 a thread takes 8 neighbouring windows of one
// channel (out and g as whole 16-byte loads), otherwise one window.
#include <climits>
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

// ---- backward -------------------------------------------------------------

// An element's bits as float: exact for both element types.
__device__ __forceinline__ float bits_float(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ float bits_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// g as (N, C, OH, OW) with element strides; plane p of x is (p / C, p % C).
struct Grad {
  long long sn, sc, sh, sw;
  int C;
  __device__ __forceinline__ long long at(long long p, int oy, int ox) const {
    return (p / C) * sn + (p % C) * sc + oy * sh + ox * sw;
  }
};

// The 2x2 form, W a multiple of a chunk (so no dropped column). Grid: x
// over a plane's (OHe = ceil(H / 2)) x (W / kElems) chunks, y (striding)
// over the P planes. A thread of row oy == OH (odd H) zeroes its chunk of
// the dropped last row.
template <typename B, bool kFirst>
__global__ void __launch_bounds__(kThreads)
max_pool2_backward(const B* __restrict__ x, const B* __restrict__ out,
                   const B* __restrict__ g, B* __restrict__ dx, long long P, int H, int W,
                   Grad gs, bool g_vec) {
  constexpr int kElems = 16 / sizeof(B);   // x elements in 16 bytes
  constexpr int kWin = kElems / 2;         // their windows
  union Chunk { uint4 v; B e[kElems]; };
  union Half { uint2 v; B e[kWin]; };
  const int G = W / kElems, OH = H / 2, OW = W / 2;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= ((H + 1) / 2) * G) return;
  const int k = i % G, oy = i / G;
  for (long long p = blockIdx.y; p < P; p += gridDim.y) {
    B* d0 = dx + (p * H + 2 * oy) * W + k * kElems;
    if (oy == OH) {
      __stcs(reinterpret_cast<uint4*>(d0), make_uint4(0, 0, 0, 0));
      continue;
    }
    const B* x0 = x + (p * H + 2 * oy) * W + k * kElems;
    Chunk a, b, r0, r1;
    Half m, gv;
    a.v = __ldcs(reinterpret_cast<const uint4*>(x0));
    b.v = __ldcs(reinterpret_cast<const uint4*>(x0 + W));
    m.v = __ldcs(reinterpret_cast<const uint2*>(out + (p * OH + oy) * OW + k * kWin));
    const long long go = gs.at(p, oy, k * kWin);
    if (g_vec) {
      gv.v = __ldcs(reinterpret_cast<const uint2*>(g + go));
    } else {
#pragma unroll
      for (int w = 0; w < kWin; ++w) gv.e[w] = g[go + w * gs.sw];
    }
#pragma unroll
    for (int w = 0; w < kWin; ++w) {
      const float mv = bits_float(m.e[w]);
      bool h00 = bits_float(a.e[2 * w]) == mv, h01 = bits_float(a.e[2 * w + 1]) == mv;
      bool h10 = bits_float(b.e[2 * w]) == mv, h11 = bits_float(b.e[2 * w + 1]) == mv;
      if (kFirst) {
        h01 = h01 && !h00;
        h10 = h10 && !(h00 || h01);
        h11 = h11 && !(h00 || h01 || h10);
      }
      r0.e[2 * w] = h00 ? gv.e[w] : B(0);
      r0.e[2 * w + 1] = h01 ? gv.e[w] : B(0);
      r1.e[2 * w] = h10 ? gv.e[w] : B(0);
      r1.e[2 * w + 1] = h11 ? gv.e[w] : B(0);
    }
    __stcs(reinterpret_cast<uint4*>(d0), r0.v);
    __stcs(reinterpret_cast<uint4*>(d0 + W), r1.v);
  }
}

// Any size and width: a thread a cell of the plane's ceil(H / s) x
// ceil(W / s) grid of windows; a cell past the last whole window zeroes
// its part of the dropped rows and columns.
template <typename B, bool kFirst>
__global__ void __launch_bounds__(kThreads)
max_pool_backward(const B* __restrict__ x, const B* __restrict__ out,
                  const B* __restrict__ g, B* __restrict__ dx, long long P, int H, int W,
                  int s, Grad gs) {
  const int OH = H / s, OW = W / s, OWe = (W + s - 1) / s;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= ((H + s - 1) / s) * OWe) return;
  const int ox = i % OWe, oy = i / OWe;
  const int rows = min(s, H - oy * s), cols = min(s, W - ox * s);
  for (long long p = blockIdx.y; p < P; p += gridDim.y) {
    const long long base = (p * H + oy * s) * W + ox * s;
    if (oy >= OH || ox >= OW) {
      for (int r = 0; r < rows; ++r)
        for (int c = 0; c < cols; ++c) dx[base + r * W + c] = B(0);
      continue;
    }
    const float mv = bits_float(__ldcs(out + (p * OH + oy) * OW + ox));
    const B gb = g[gs.at(p, oy, ox)];
    bool found = false;
    for (int r = 0; r < s; ++r)
      for (int c = 0; c < s; ++c) {
        const long long e = base + r * W + c;
        bool hit = bits_float(__ldcs(x + e)) == mv;
        if (kFirst) {
          hit = hit && !found;
          found = found || hit;
        }
        dx[e] = hit ? gb : B(0);
      }
  }
}

// x and dx channels-last ((N, H, W, C) in memory), out (N, C, OH, OW)
// contiguous, g any strides. Grid: x over an image's ceil(H / s) x
// ceil(W / s) window cells times C, the channel fastest (a warp's x and dx
// accesses contiguous; out's and g's reach the same sectors from the
// neighbouring window cells' warps, through L2), y (striding) over the N
// images. A cell past the last whole window zeroes its part of the dropped
// rows and columns.
template <typename B, bool kFirst>
__global__ void __launch_bounds__(kThreads)
max_pool_backward_nhwc(const B* __restrict__ x, const B* __restrict__ out,
                       const B* __restrict__ g, B* __restrict__ dx, int N, int C, int H,
                       int W, int s, Grad gs) {
  const int OH = H / s, OW = W / s, OWe = (W + s - 1) / s;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= ((H + s - 1) / s) * OWe * C) return;
  const int c = i % C, ox = (i / C) % OWe, oy = i / C / OWe;
  const int rows = min(s, H - oy * s), cols = min(s, W - ox * s);
  for (long long n = blockIdx.y; n < N; n += gridDim.y) {
    const long long base = ((n * H + oy * s) * W + ox * s) * C + c;
    if (oy >= OH || ox >= OW) {
      for (int r = 0; r < rows; ++r)
        for (int q = 0; q < cols; ++q) dx[base + (static_cast<long long>(r) * W + q) * C] = B(0);
      continue;
    }
    const long long p = n * C + c;
    const float mv = bits_float(__ldg(out + (p * OH + oy) * OW + ox));
    const B gb = __ldg(g + gs.at(p, oy, ox));
    bool found = false;
    for (int r = 0; r < s; ++r)
      for (int q = 0; q < s; ++q) {
        const long long e = base + (static_cast<long long>(r) * W + q) * C;
        bool hit = bits_float(__ldcs(x + e)) == mv;
        if (kFirst) {
          hit = hit && !found;
          found = found || hit;
        }
        dx[e] = hit ? gb : B(0);
      }
  }
}

// The 2x2 form of the above, W a multiple of 2 * kGroup (no dropped
// column): a thread kGroup neighbouring windows of one channel, so that
// its out and g are kGroup neighbours of an (OH, OW) plane, read as whole
// 16-byte loads; each of its x and dx accesses is one element of a warp's
// contiguous run over channels. A thread of row oy == OH (odd H) zeroes its
// part of the dropped last row.
constexpr int kGroup = 8;

template <typename B, bool kFirst>
__global__ void __launch_bounds__(kThreads)
max_pool2_backward_nhwc(const B* __restrict__ x, const B* __restrict__ out,
                        const B* __restrict__ g, B* __restrict__ dx, int N, int C, int H,
                        int W, Grad gs, bool g_vec) {
  constexpr int kVec = kGroup * sizeof(B) / 16;  // 16-byte loads of kGroup elements
  union Group { uint4 v[kVec]; B e[kGroup]; };
  const int OH = H / 2, OW = W / 2, G = OW / kGroup;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= ((H + 1) / 2) * G * C) return;
  const int c = i % C, k = (i / C) % G, oy = i / C / G;
  const long long row = static_cast<long long>(W) * C;
  for (long long n = blockIdx.y; n < N; n += gridDim.y) {
    const long long base = ((n * H + 2 * oy) * W + 2 * k * kGroup) * C + c;
    if (oy == OH) {
#pragma unroll
      for (int q = 0; q < 2 * kGroup; ++q) dx[base + static_cast<long long>(q) * C] = B(0);
      continue;
    }
    const long long p = n * C + c;
    Group m, gv;
    const uint4* mo = reinterpret_cast<const uint4*>(out + (p * OH + oy) * OW + k * kGroup);
#pragma unroll
    for (int v = 0; v < kVec; ++v) m.v[v] = __ldcs(mo + v);
    const long long go = gs.at(p, oy, k * kGroup);
    if (g_vec) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) gv.v[v] = __ldcs(reinterpret_cast<const uint4*>(g + go) + v);
    } else {
#pragma unroll
      for (int w = 0; w < kGroup; ++w) gv.e[w] = g[go + w * gs.sw];
    }
#pragma unroll
    for (int w = 0; w < kGroup; ++w) {
      const long long e = base + 2LL * w * C;
      const float mv = bits_float(m.e[w]);
      bool h00 = bits_float(__ldcs(x + e)) == mv, h01 = bits_float(__ldcs(x + e + C)) == mv;
      bool h10 = bits_float(__ldcs(x + e + row)) == mv;
      bool h11 = bits_float(__ldcs(x + e + row + C)) == mv;
      if (kFirst) {
        h01 = h01 && !h00;
        h10 = h10 && !(h00 || h01);
        h11 = h11 && !(h00 || h01 || h10);
      }
      dx[e] = h00 ? gv.e[w] : B(0);
      dx[e + C] = h01 ? gv.e[w] : B(0);
      dx[e + row] = h10 ? gv.e[w] : B(0);
      dx[e + row + C] = h11 ? gv.e[w] : B(0);
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename B, bool kFirst>
int launch_backward(const void* x, const void* out, const void* g, void* dx, int N, int C,
                    int H, int W, int s, bool x_nhwc, const Grad& gs, cudaStream_t stream) {
  constexpr int kElems = 16 / sizeof(B), kWin = kElems / 2;
  const B* xs = static_cast<const B*>(x);
  const B* os = static_cast<const B*>(out);
  const B* gp = static_cast<const B*>(g);
  B* d = static_cast<B*>(dx);
  const long long P = static_cast<long long>(N) * C;
  const unsigned planes = static_cast<unsigned>(P < 65535 ? P : 65535);
  const unsigned images = static_cast<unsigned>(N < 65535 ? N : 65535);
  if (x_nhwc && s == 2 && W % (2 * kGroup) == 0 && aligned(out, 16)) {
    const bool g_vec = gs.sw == 1 && aligned(g, 16) && gs.sh % kGroup == 0 &&
                       gs.sc % kGroup == 0 && gs.sn % kGroup == 0;
    const int items = ((H + 1) / 2) * (W / (2 * kGroup)) * C;
    const dim3 grid((items + kThreads - 1) / kThreads, images);
    max_pool2_backward_nhwc<B, kFirst><<<grid, kThreads, 0, stream>>>(xs, os, gp, d, N, C, H,
                                                                      W, gs, g_vec);
  } else if (x_nhwc) {
    const int items = ((H + s - 1) / s) * ((W + s - 1) / s) * C;
    const dim3 grid((items + kThreads - 1) / kThreads, images);
    max_pool_backward_nhwc<B, kFirst><<<grid, kThreads, 0, stream>>>(xs, os, gp, d, N, C, H,
                                                                     W, s, gs);
  } else if (s == 2 && W % kElems == 0 && aligned(x, 16) && aligned(dx, 16) && aligned(out, 8)) {
    const bool g_vec = gs.sw == 1 && aligned(g, 8) && gs.sh % kWin == 0 &&
                       gs.sc % kWin == 0 && gs.sn % kWin == 0;
    const int items = ((H + 1) / 2) * (W / kElems);
    const dim3 grid((items + kThreads - 1) / kThreads, planes);
    max_pool2_backward<B, kFirst><<<grid, kThreads, 0, stream>>>(xs, os, gp, d, P, H, W, gs,
                                                                 g_vec);
  } else {
    const int items = ((H + s - 1) / s) * ((W + s - 1) / s);
    const dim3 grid((items + kThreads - 1) / kThreads, planes);
    max_pool_backward<B, kFirst><<<grid, kThreads, 0, stream>>>(xs, os, gp, d, P, H, W, s, gs);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename B>
int dispatch_backward(const void* x, const void* out, const void* g, void* dx, int N, int C,
                      int H, int W, int s, int first, bool x_nhwc, const Grad& gs,
                      cudaStream_t stream) {
  return first ? launch_backward<B, true>(x, out, g, dx, N, C, H, W, s, x_nhwc, gs, stream)
               : launch_backward<B, false>(x, out, g, dx, N, C, H, W, s, x_nhwc, gs, stream);
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

// The max pool's backward: x (N, C, H, W), contiguous (the tensor the
// forward pooled) or, x_nhwc 1, channels-last (the forward's input; dx then
// channels-last too), out (N, C, H / s, W / s) contiguous, its pooled max,
// g (N, C, H / s, W / s) with element strides gsn, gsc, gsh, gsw; writes
// every element of dx. first 1: the first maximum of a window in raster
// order takes g, 0: every maximum does. dtype 0 float32, 1 bfloat16.
extern "C" int cadx_pool_backward(const void* x, const void* out, const void* g, void* dx,
                                  int N, int C, int H, int W, int s, int first, int dtype,
                                  int x_nhwc, long long gsn, long long gsc, long long gsh,
                                  long long gsw, void* stream) {
  if (s < 1 || N < 0 || C < 1 || H < 0 || W < 0 ||
      static_cast<long long>(H + s) * (W + s) > INT_MAX ||
      (x_nhwc && static_cast<long long>((H + s - 1) / s) * ((W + s - 1) / s) * C >
                     INT_MAX - kThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || H == 0 || W == 0) return 0;
  const Grad gs{gsn, gsc, gsh, gsw, C};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_backward<uint32_t>(x, out, g, dx, N, C, H, W, s, first, x_nhwc, gs, st);
  if (dtype == 1)
    return dispatch_backward<uint16_t>(x, out, g, dx, N, C, H, W, s, first, x_nhwc, gs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
