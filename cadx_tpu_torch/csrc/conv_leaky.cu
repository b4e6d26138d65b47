// Fused k x k stride-1 convolution + bias + LeakyReLU in float32, a direct
// implicit GEMM: M = B*OH*OW output pixels, N = F filters, K = C*k*k.
// Replaces cadx_tpu/kernels/nn_kernels.py::conv2d_leaky_pallas; see
// cadx_tpu_torch/kernels/conv_leaky.py for the contract and its bound.
//
// - Register tiles: a thread holds TM = 8 (or 4) consecutive output pixels
//   of one row by TN = 8 (or 4) filters, 64 accumulators at most. Per
//   (channel, kernel row) it loads the TM + k - 1 input values of its row
//   once and slides them across the k taps; per tap one or two float4
//   weight loads feed TM * TN FMAs.
// - Block tiles: 32 filters (BN = TN * PF), 32 or 16 pixels wide (TM * PX),
//   PY rows high. The host picks the tile from the output's width and the
//   grid it gives (dispatch).
// - Stages: the input window (PY + k - 1 rows, TM * PX + k - 1 columns,
//   zeros outside the image: the SAME padding) and the weights of CK
//   channels go by cp.async into a ring of 3 (8 x 8 tile) or 2 stages in
//   dynamic shared memory, so the next chunks load while one computes,
//   with one barrier a stage. NCHW rows
//   whose width is a multiple of 4 copy 16 bytes at a time (a 4-aligned
//   group is wholly inside the image or wholly outside it: src-size 0 then
//   fills the zeros). NHWC pixels of a multiple of 4 channels copy 16 bytes
//   (4 channels) into a pixel-major buffer, which the threads move into the
//   channel planes once it has landed (a second barrier). Anything else
//   copies 4 bytes. Where a thread's input window starts 16-byte aligned
//   (NHWC, and NCHW at pad 0), it is loaded as float4s and floats.
// - Weights: the kernel stages them transposed, from the caller's
//   (F, C, k, k) into [channel][tap][filter] rows (K-major, F contiguous,
//   rows padded by 4 floats), so the wrapper makes no copy. Threads walk a
//   filter's contiguous (channel, tap) run, so the global reads coalesce.
// - Layouts: x is NCHW contiguous (layout 0; M runs along W) or the NHWC
//   channels-last view (layout 1; K runs along C, the TPU kernel's own
//   layout), read in place either way.
// - Sums: each output adds its C*k*k products in one thread, in the order
//   (channel, kernel row, kernel column), then the bias; no split-K, no
//   atomics, so a run repeats bit for bit. Every product is an fmaf.
#include <cstdint>

#include <cuda_runtime.h>

// Tuning knobs (tools/tune_conv.py builds variants with -D): the least
// resident blocks an SM asked of the compiler for 256-thread blocks (3 for
// the 128-thread ones); CADX_CONV_STAGES and CADX_CONV_STAGE_KB, the ring's
// stages and the kilobytes a stage may take, for every tile.
#ifndef CADX_CONV_MINB256
#define CADX_CONV_MINB256 2
#endif

namespace {

constexpr int kSmemMax = 200 * 1024;

// The ring a tile runs: 3 stages of up to 36 KB for the 8 x 8 thread tile,
// 2 of up to 48 KB for the others, each measured spill-free at the
// registers its launch bounds give (tools/tune_conv.py).
template <int TM, int TN>
struct Ring {
#ifdef CADX_CONV_STAGES
  static constexpr int stages = CADX_CONV_STAGES;
  static constexpr int bytes = CADX_CONV_STAGE_KB * 1024;
#else
  static constexpr int stages = TM * TN >= 64 ? 3 : 2;
  static constexpr int bytes = (TM * TN >= 64 ? 36 : 48) * 1024;
#endif
};

__device__ inline void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ inline void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// the group of the chunk about to be computed has landed
template <int kStages>
__device__ inline void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// Shared-memory geometry of one stage, the same on host and device; with
// constant arguments (the K > 0 kernels) all but CK fold to constants, and
// so do the divisions of the staging loops (CK, a power of two, is used
// through shifts).
struct Geometry {
  int R;     // input rows staged: PY + k - 1
  int cols;  // input columns a tile reads: TW + k - 1
  int padl;  // NCHW: smem column 0 holds input column ox0 - padl (a multiple
             // of 4, so 16-byte groups line up); NHWC: input column ox0 - pad
             // sits at smem column 4, so the compute's loads line up
  int RS;    // row stride in floats, a multiple of 4 that is 4 mod 8 (no bank
             // conflicts between the two rows a warp reads)
  int PS;    // channel plane stride: R * RS, plus 4 for NHWC (the stores of
             // one pixel's channels spread over the banks)
  int WR;    // weight row stride: BN + 4 (4-way bank conflicts at most when
             // a warp stores 32 rows of one filter)
  int WS;    // weight floats a channel: k * k * WR
  int RAW;   // NHWC only: floats a channel of the pixel-major copy (R * cols)
  int ck_shift;  // CK = 1 << ck_shift channels a stage
  // a stage: weights (16-byte aligned), input planes, then the NHWC
  // pixel-major copy (16-byte aligned), each part a multiple of 4 floats,
  // so every stage starts 16-byte aligned
  __host__ __device__ int raw_at() const { return ((PS + WS) << ck_shift) + 3 & ~3; }
  __host__ __device__ int stage_floats() const {
    return raw_at() + ((RAW << ck_shift) + 3 & ~3);
  }
};

__host__ __device__ inline Geometry geometry(int PY, int BN, int TW, int k, int padl,
                                             int layout, int stage_bytes) {
  Geometry g;
  g.R = PY + k - 1;
  g.cols = TW + k - 1;
  g.padl = padl;
  g.RS = ((padl > 4 ? padl : 4) + TW + k - 1 + 3) & ~3;
  if (g.RS % 8 == 0) g.RS += 4;
  g.PS = g.R * g.RS + 4 * layout;
  g.WR = BN + 4;
  g.WS = k * k * g.WR;
  g.RAW = layout == 1 ? g.R * g.cols : 0;
  g.ck_shift = 4;
  while (g.ck_shift > 0 && (g.PS + g.WS + g.RAW) * 4 << g.ck_shift > stage_bytes)
    --g.ck_shift;
  return g;
}

// K: the kernel side as a constant (3, the classifiers', with pad <= 4), or
// 0 for any k and pad at run time. L: the layout of x, 0 NCHW or 1 NHWC (a
// constant, so the K = 3 kernels' geometry and staging divisions fold). A
// thread holds TM (8 or 4) pixels of a row by TN (8 or 4) filters; PF
// threads along the filters (BN = TN * PF), PX along a row (TW = TM * PX
// pixels), PY rows a block.
template <int K, int L, int TM, int TN, int PF, int PX, int PY>
__global__ void __launch_bounds__(PF * PX * PY,
                                  PF * PX * PY >= 256 ? CADX_CONV_MINB256 : 3)
conv_leaky_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ b, float* __restrict__ y, int C, int H, int W,
                  int F, int k_rt, int pad, int OH, int OW, int tiles_x, float alpha) {
  constexpr int BN = TN * PF;
  constexpr int TW = TM * PX;
  constexpr int kThreads = PF * PX * PY;
  constexpr int kStages = Ring<TM, TN>::stages;
  const int k = K ? K : k_rt;
  const int kk = k * k;
  const Geometry g = geometry(PY, BN, TW, k, K ? 4 : (pad + 3) & ~3, L, Ring<TM, TN>::bytes);
  const int CK = 1 << g.ck_shift;
  const int SF = g.stage_floats();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int tf = tid % PF;
  const int tx = (tid / PF) % PX;
  const int ty = tid / (PF * PX);
  const int oy0 = (blockIdx.x / tiles_x) * PY;
  const int ox0 = (blockIdx.x % tiles_x) * TW;
  const int f0 = blockIdx.y * BN;
  const long long n = blockIdx.z;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // 16-byte copies: NCHW rows of a multiple of 4 floats; NHWC pixels of a
  // multiple of 4 channels, CK of them a stage
  const bool vec_nchw = L == 0 && W % 4 == 0 && aligned;
  const bool vec_nhwc = L == 1 && C % 4 == 0 && CK % 4 == 0 && aligned;
  const int iy0 = oy0 - pad;
  // smem column of the tile's first input column (ox0 - pad), and the input
  // column of smem column 0
  const int sc0 = L == 1 ? 4 : g.padl - pad;
  const int ixs = ox0 - pad - sc0;
  // a thread's input window starts 16-byte aligned: vector loads
  const bool xvec = (sc0 & 3) == 0;
  const int n_chunks = (C + CK - 1) >> g.ck_shift;

  auto stage = [&](int chunk) {
    float* ws = smem + (chunk % kStages) * SF;
    float* xs = ws + (g.WS << g.ck_shift);
    const int c0 = chunk << g.ck_shift;
    const int cc = min(CK, C - c0);
    if (vec_nchw) {
      // 16-byte groups of every smem column: 4-aligned input columns, each
      // group wholly inside the image or wholly outside (W % 4 == 0)
      const int groups = g.RS / 4;
      for (int i = tid; i < (g.R * groups << g.ck_shift); i += kThreads) {
        const int c = i / (g.R * groups), rem = i % (g.R * groups);
        const int r = rem / groups, q = rem % groups;
        if (c >= cc) break;
        const int iy = iy0 + r, ix = ixs + 4 * q;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const float* src = ok ? x + ((n * C + c0 + c) * H + iy) * W + ix : x;
        cp_async16(xs + c * g.PS + r * g.RS + 4 * q, src, ok);
      }
    } else if (vec_nhwc) {
      // 4 channels of a pixel a copy, pixel-major; `transpose` below moves
      // them into the planes once they have landed
      float* raw = smem + (chunk % kStages) * SF + g.raw_at();
      const int quads = CK / 4;
      for (int i = tid; i < g.R * g.cols * quads; i += kThreads) {
        const int qd = i & (quads - 1), pix = i >> (g.ck_shift - 2);
        const int q = pix % g.cols, r = pix / g.cols;
        if (4 * qd >= cc) continue;
        const int iy = iy0 + r, ix = ixs + sc0 + q;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const float* src = ok ? x + ((n * H + iy) * W + ix) * C + c0 + 4 * qd : x;
        cp_async16(raw + (pix << g.ck_shift) + 4 * qd, src, ok);
      }
    } else {
      // 4-byte copies of the columns the tile reads
      for (int i = tid; i < (g.R * g.cols << g.ck_shift); i += kThreads) {
        int c, r, q;
        if (L == 1) {  // channels fastest: neighbouring threads, neighbouring floats
          c = i & (CK - 1);
          const int pix = i >> g.ck_shift;
          q = pix % g.cols;
          r = pix / g.cols;
        } else {
          c = i / (g.R * g.cols);
          const int rem = i % (g.R * g.cols);
          r = rem / g.cols;
          q = rem % g.cols;
        }
        if (c >= cc) continue;
        const int iy = iy0 + r, ix = ixs + sc0 + q;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const float* src = x;
        if (ok)
          src = L == 1 ? x + ((n * H + iy) * W + ix) * C + c0 + c
                            : x + ((n * C + c0 + c) * H + iy) * W + ix;
        cp_async4(xs + c * g.PS + r * g.RS + sc0 + q, src, ok);
      }
    }
    // row = c * kk + tap: a filter's rows are contiguous in (F, C, k, k)
    for (int i = tid; i < (kk * BN << g.ck_shift); i += kThreads) {
      const int row = i % (kk << g.ck_shift), j = i / (kk << g.ck_shift);
      if (row >= cc * kk) continue;
      const bool ok = f0 + j < F;
      const float* src =
          ok ? wt + (static_cast<long long>(f0 + j) * C + c0) * kk + row : wt;
      cp_async4(ws + row * g.WR + j, src, ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int p = 0; p < TM; ++p)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[p][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) stage(s);
    cp_async_commit();
  }
  const int xoff = ty * g.RS + TM * tx + sc0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait_stage<kStages>();
    __syncthreads();
    // the stage computed last iteration is free now: refill it
    if (chunk + kStages - 1 < n_chunks) stage(chunk + kStages - 1);
    cp_async_commit();
    const float* ws = smem + (chunk % kStages) * SF;
    float* xs = smem + (chunk % kStages) * SF + (g.WS << g.ck_shift);
    const int cc = min(CK, C - (chunk << g.ck_shift));
    if (vec_nhwc) {
      // pixel-major copy -> channel planes: neighbouring threads read
      // neighbouring floats and store to planes an odd stride apart
      const float* raw = smem + (chunk % kStages) * SF + g.raw_at();
      for (int i = tid; i < (g.R * g.cols << g.ck_shift); i += kThreads) {
        const int c = i & (CK - 1), pix = i >> g.ck_shift;
        const int q = pix % g.cols, r = pix / g.cols;
        xs[c * g.PS + r * g.RS + sc0 + q] = raw[i];
      }
      __syncthreads();
    }
    for (int c = 0; c < cc; ++c) {
      // rolled: unrolled, the 8 x 8 tile spills at 128 registers
#pragma unroll 1
      for (int di = 0; di < k; ++di) {
        const float* xr = xs + c * g.PS + di * g.RS + xoff;
        const float4* wr = reinterpret_cast<const float4*>(ws + (c * kk + di * k) * g.WR);
        constexpr int NX = K > 0 ? TM + K - 1 : TM;
        float xv[NX];
        if constexpr (K > 0) {
          if (xvec) {
#pragma unroll
            for (int v = 0; v < TM / 4; ++v) {
              const float4 q4 = reinterpret_cast<const float4*>(xr)[v];
              xv[4 * v] = q4.x; xv[4 * v + 1] = q4.y; xv[4 * v + 2] = q4.z; xv[4 * v + 3] = q4.w;
            }
#pragma unroll
            for (int j = TM; j < NX; ++j) xv[j] = xr[j];
          } else {
#pragma unroll
            for (int j = 0; j < NX; ++j) xv[j] = xr[j];
          }
        }
#pragma unroll
        for (int dj = 0; dj < (K > 0 ? K : 1); ++dj) {
          for (int dr = 0; dr < (K > 0 ? 1 : k); ++dr) {
            // K > 0: tap dj of the window loaded above; K == 0: tap dr,
            // loaded here
            const int tap = K > 0 ? dj : dr;
            if constexpr (K == 0) {
#pragma unroll
              for (int p = 0; p < TM; ++p) xv[p] = xr[tap + p];
            }
            float wv[TN];
            const float4 wa = wr[tap * (g.WR / 4) + tf];
            wv[0] = wa.x; wv[1] = wa.y; wv[2] = wa.z; wv[3] = wa.w;
            if constexpr (TN == 8) {
              const float4 wb = wr[tap * (g.WR / 4) + BN / 8 + tf];
              wv[4] = wb.x; wv[5] = wb.y; wv[6] = wb.z; wv[7] = wb.w;
            }
#pragma unroll
            for (int p = 0; p < TM; ++p)
#pragma unroll
              for (int q = 0; q < TN; ++q)
                acc[p][q] = fmaf(xv[K > 0 ? p + dj : p], wv[q], acc[p][q]);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  const int oy = oy0 + ty;
  const int ox = ox0 + TM * tx;
  if (oy >= OH || ox >= OW) return;
  const bool vec_y = OW % 4 == 0 && ox + TM <= OW &&
                     (reinterpret_cast<uintptr_t>(y) & 15) == 0;
#pragma unroll
  for (int q = 0; q < TN; ++q) {
    // filters 4 tf + q (q < 4) and BN / 2 + 4 tf + q - 4 (q >= 4)
    const int f = f0 + (q < 4 ? 4 * tf + q : BN / 2 + 4 * tf + q - 4);
    if (f >= F) continue;
    const float bias = b[f];
    float z[TM];
#pragma unroll
    for (int p = 0; p < TM; ++p) {
      const float v = acc[p][q] + bias;
      z[p] = v > 0.0f ? v : alpha * v;  // z == 0 takes the alpha branch
    }
    float* dst = y + ((n * F + f) * OH + oy) * OW + ox;
    if (vec_y) {
#pragma unroll
      for (int v = 0; v < TM / 4; ++v)
        reinterpret_cast<float4*>(dst)[v] =
            make_float4(z[4 * v], z[4 * v + 1], z[4 * v + 2], z[4 * v + 3]);
    } else {
#pragma unroll
      for (int p = 0; p < TM; ++p)
        if (ox + p < OW) dst[p] = z[p];
    }
  }
}

struct Shape {
  int B, C, H, W, F, k, pad, OH, OW, layout;
};

template <int K, int L, int TM, int TN, int PF, int PX, int PY>
int launch_layout(const float* x, const float* wt, const float* b, float* y, const Shape& s,
                  float alpha, cudaStream_t stream) {
  constexpr int TW = TM * PX;
  const Geometry g = geometry(PY, TN * PF, TW, s.k, K ? 4 : (s.pad + 3) & ~3, L,
                              Ring<TM, TN>::bytes);
  const int smem = Ring<TM, TN>::stages * g.stage_floats() * 4;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(conv_leaky_kernel<K, L, TM, TN, PF, PX, PY>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int tiles_x = (s.OW + TW - 1) / TW;
  const int tiles_y = (s.OH + PY - 1) / PY;
  const dim3 grid(tiles_x * tiles_y, (s.F + TN * PF - 1) / (TN * PF), s.B);
  conv_leaky_kernel<K, L, TM, TN, PF, PX, PY><<<grid, PF * PX * PY, smem, stream>>>(
      x, wt, b, y, s.C, s.H, s.W, s.F, s.k, s.pad, s.OH, s.OW, tiles_x, alpha);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int TM, int TN, int PF, int PX, int PY>
int launch(const float* x, const float* wt, const float* b, float* y, const Shape& s,
           float alpha, cudaStream_t stream) {
  return s.layout ? launch_layout<K, 1, TM, TN, PF, PX, PY>(x, wt, b, y, s, alpha, stream)
                  : launch_layout<K, 0, TM, TN, PF, PX, PY>(x, wt, b, y, s, alpha, stream);
}

// Tiles of 32 filters (TN * PF): a layer of F > 32 stages its input F / 32
// times, which measured faster on the card than 64- and 128-filter tiles
// (tools/tune_conv.py; PERF.md, row 11). Rows of up to 16 outputs take 16 x
// 8-pixel tiles of 4 pixels x 4 filters a thread; wider rows the 32 x
// 16-pixel tile of 8 x 8 a thread where it gives two blocks for each of the
// 132 SMs, else (the small batches) 16 x 16-pixel tiles of 4 x 8.
template <int K>
int dispatch(const float* x, const float* wt, const float* b, float* y, const Shape& s,
             float alpha, cudaStream_t stream) {
#ifdef CADX_CONV_TN  // one tile, for tuning builds
  return launch<K, CADX_CONV_TM, CADX_CONV_TN, CADX_CONV_PF, CADX_CONV_PX, CADX_CONV_PY>(
      x, wt, b, y, s, alpha, stream);
#else
  if (s.OW <= 16) return launch<K, 4, 4, 8, 4, 8>(x, wt, b, y, s, alpha, stream);
  const long long tall_blocks = static_cast<long long>(s.B) * ((s.OW + 31) / 32) *
                                ((s.OH + 15) / 16) * ((s.F + 31) / 32);
  if (tall_blocks >= 2 * 132) return launch<K, 8, 8, 4, 4, 16>(x, wt, b, y, s, alpha, stream);
  return launch<K, 4, 8, 4, 4, 16>(x, wt, b, y, s, alpha, stream);
#endif
}

}  // namespace

// x (B, C, H, W) float32, NCHW contiguous (layout 0) or the NHWC view
// (layout 1: element (n, c, h, w) at ((n * H + h) * W + w) * C + c); wt
// (F, C, k, k) contiguous; b (F,) -> y (B, F, OH, OW) contiguous,
// OH = H + 2 * pad - k + 1 (pad 0: VALID; pad k // 2: SAME).
extern "C" int cadx_conv_leaky(const void* x, const void* wt, const void* b, void* y, int B,
                               int C, int H, int W, int F, int k, int pad, int layout,
                               float alpha, void* stream) {
  const Shape s{B, C, H, W, F, k, pad, H + 2 * pad - k + 1, W + 2 * pad - k + 1, layout};
  if (s.OH < 1 || s.OW < 1 || B < 1 || B > 65535 || C < 1 || F < 1 || k < 1 || pad < 0 ||
      (layout != 0 && layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wt);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  if (k == 3 && pad <= 4) return dispatch<3>(xf, wf, bf, yf, s, alpha, st);
  return dispatch<0>(xf, wf, bf, yf, s, alpha, st);
}
