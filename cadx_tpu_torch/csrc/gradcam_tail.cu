// The Grad-CAM tail of the fused pipeline over row bands of each image.
// Replaces cadx_tpu/kernels/nn_kernels.py::gradcam_tail_pallas; see
// cadx_tpu_torch/kernels/gradcam_tail.py for the layout and its bound.
//
// Three launches: cam_kernel, a block an image, stages the image's
// activations and gradients in shared memory and writes its weights'
// normalised CAM to scratch; then two over one flat grid of bands x images:
// heat_kernel takes R @ cam for its band's rows, writes the band's heat
// levels and folds the band's peak blend into the image's with one
// atomicMax on its bits (positive floats order as their bits do, and a max
// does not depend on order); overlay_kernel rereads the band's heat and
// writes the overlay with the image's peak.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "jet.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSplit = 32;
constexpr int kBatch = 8;   // global loads a thread keeps in flight while staging

// sum_{i < n} term(i) in the order torch's CUDA reduction adds a float32
// reduction over a non-innermost dimension: the n terms are split over
// `ny` (a power of two) threads, thread y taking terms y, y + ny, ...;
// each thread keeps four accumulators (the k-th term of its sequence into
// k % 4), added in order; the ny partials then meet in a halving tree.
template <typename Term>
__device__ float torch_order_sum(int n, int ny, Term term) {
  float part[kMaxSplit];
  for (int y = 0; y < ny; ++y) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int i = y;
    for (; i + 3 * ny < n; i += 4 * ny) {
      a0 = __fadd_rn(a0, term(i));
      a1 = __fadd_rn(a1, term(i + ny));
      a2 = __fadd_rn(a2, term(i + 2 * ny));
      a3 = __fadd_rn(a3, term(i + 3 * ny));
    }
    if (i < n) a0 = __fadd_rn(a0, term(i));
    if (i + ny < n) a1 = __fadd_rn(a1, term(i + ny));
    if (i + 2 * ny < n) a2 = __fadd_rn(a2, term(i + 2 * ny));
    part[y] = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
  }
  for (int off = ny / 2; off > 0; off >>= 1)
    for (int y = 0; y < off; ++y) part[y] = __fadd_rn(part[y], part[y + off]);
  return part[0];
}

// src (one image's (h, w, F) at element strides s1, s2, s3) into dst
// channel-major at pitch cp, dst[f * cp + c]; read in the order of memory
// (by cell where the channels are adjacent, by channel otherwise), kBatch
// loads a thread in flight
__device__ void stage(const float* __restrict__ src, float* dst, int cp, int cells, int w, int F,
                      long long s1, long long s2, long long s3) {
  const bool by_cell = s3 < s2;
  const int total = F * cells;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
    float v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      at[u] = -1;
      if (e < total) {
        const int f = by_cell ? e % F : e / cells, c = by_cell ? e / F : e % cells;
        const int y = c / w, x = c - y * w;
        v[u] = src[y * s1 + x * s2 + f * s3];
        at[u] = f * cp + c;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (at[u] >= 0) dst[at[u]] = v[u];
  }
}

// The normalised CAM of one image into cam (h * w cells), from its
// activations sA and gradients sG staged in shared memory channel-major at
// pitch cp; its GAP weights into wts (F): the sum over the cells times the
// float32 factor CUDA's mean scales its sum by; cam = relu(sum_f w_f A_f),
// each product rounded; then min-max with + 1e-7. Every thread of the
// block calls it; cam is complete when it returns.
__device__ void image_cam(const float* sA, const float* sG, int cp, float* wts, float* cam,
                          int cells, int F, int ny_gap, int ny_sum, float gap_factor,
                          float* scratch) {
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const float* g = sG + f * cp;
    wts[f] = __fmul_rn(torch_order_sum(cells, ny_gap, [&](int c) { return g[c]; }), gap_factor);
  }
  __syncthreads();
  float lo = INFINITY, hi = -INFINITY;
  for (int p = threadIdx.x; p < cells; p += blockDim.x) {
    float s = torch_order_sum(F, ny_sum, [&](int f) { return __fmul_rn(wts[f], sA[f * cp + p]); });
    s = s > 0.0f ? s : 0.0f;
    cam[p] = s;
    lo = fminf(lo, s);
    hi = fmaxf(hi, s);
  }
  lo = cadx_jet::block_min(lo, scratch);
  hi = cadx_jet::block_max(hi, scratch);
  const float denom = __fadd_rn(__fsub_rn(hi, lo), 1e-7f);
  for (int p = threadIdx.x; p < cells; p += blockDim.x)
    cam[p] = __fdiv_rn(__fsub_rn(cam[p], lo), denom);
  __syncthreads();
}

// The heat level at column j of a band row: row @ ct over the column's
// nk nonzero weights (cidx, cval: (nk, ow), ascending k, padded with weight
// 0), each a fused multiply-add in the order cuBLAS accumulates the plain
// version's product (the terms it skips are products with 0, which leave a
// nonnegative sum as it is); clamped, trunc(* 255).
__device__ __forceinline__ uint8_t heat_at(const float* row, const int* cidx, const float* cval,
                                           int nk, int j, int ow) {
  float acc = 0.0f;
  for (int t = 0; t < nk; ++t) acc = fmaf(row[cidx[t * ow + j]], cval[t * ow + j], acc);
  return static_cast<uint8_t>(__fmul_rn(fminf(fmaxf(acc, 0.0f), 1.0f), 255.0f));
}

// The normalised CAM of each image, a block an image: acts, grads (B, h, w,
// F) float32 at the given element strides -> cams (B, h * w) float32.
// Dynamic shared memory: the image's activations and gradients (2 F (h*w +
// 1) floats), F weights and h*w CAM cells.
__global__ void __launch_bounds__(kThreads)
cam_kernel(const float* __restrict__ acts, const float* __restrict__ grads,
           float* __restrict__ cams, int h, int w, int F, long long as0, long long as1,
           long long as2, long long as3, long long gs0, long long gs1, long long gs2,
           long long gs3, int ny_gap, int ny_sum, float gap_factor) {
  extern __shared__ float smem[];
  const int cells = h * w, cp = cells + 1;
  float* sA = smem;
  float* sG = sA + F * cp;
  float* wts = sG + F * cp;
  float* cam = wts + F;
  __shared__ float scratch[32];
  const long long b = blockIdx.x;
  stage(acts + b * as0, sA, cp, cells, w, F, as1, as2, as3);
  stage(grads + b * gs0, sG, cp, cells, w, F, gs1, gs2, gs3);
  __syncthreads();
  image_cam(sA, sG, cp, wts, cam, cells, F, ny_gap, ny_sum, gap_factor, scratch);
  for (int p = threadIdx.x; p < cells; p += blockDim.x) cams[b * cells + p] = cam[p];
}

// cams: (B, h * w) the normalised CAMs; img: (B, oh, ow) float32; r: (oh,
// h) the row sampling matrix; cidx, cval: (nk, ow) the column sampling
// matrix's nonzero weights; heat (B, oh, ow) uint8; peaks: B int32, zeroed,
// each image's peak blend as float bits. Block x: band x % bands of image x
// / bands, the rows [band * band_rows, + band_rows) cut to oh. Dynamic
// shared memory: h*w CAM cells, band_rows*w rows of R @ cam, the column
// weights (2 nk ow). vec: ow % 4 == 0 and img 16-byte aligned, so a thread
// takes four pixels at once.
__global__ void __launch_bounds__(kThreads, 4)
heat_kernel(const float* __restrict__ cams, const float* __restrict__ img,
            const float* __restrict__ r, const int* __restrict__ cidx,
            const float* __restrict__ cval, uint8_t* __restrict__ heat, int* peaks, int h, int w,
            int oh, int ow, int nk, int band_rows, int bands, int vec) {
  extern __shared__ float smem[];
  const int cells = h * w;
  float* cam = smem;
  float* rows = cam + cells;
  float* sval = rows + band_rows * w;
  int* sidx = reinterpret_cast<int*>(sval + nk * ow);
  __shared__ __align__(4) uint8_t lut[cadx_jet::kLutBytes];
  __shared__ uint8_t top[256];  // each level's largest channel
  __shared__ float scratch[32];
  cadx_jet::load_lut(lut);
  const long long b = blockIdx.x / bands;
  const int i0 = (blockIdx.x - b * bands) * band_rows;
  const int nr = min(band_rows, oh - i0);
  for (int p = threadIdx.x; p < cells; p += blockDim.x) cam[p] = cams[b * cells + p];
  for (int e = threadIdx.x; e < nk * ow; e += blockDim.x) {
    sval[e] = cval[e];
    sidx[e] = cidx[e];
  }
  __syncthreads();
  for (int v = threadIdx.x; v < 256; v += blockDim.x)
    top[v] = max(max(lut[3 * v], lut[3 * v + 1]), lut[3 * v + 2]);

  // the band's rows of R @ cam, fused multiply-adds in ascending k
  for (int q = threadIdx.x; q < nr * w; q += blockDim.x) {
    const int i = i0 + q / w, j = q % w;
    float acc = 0.0f;
    for (int k = 0; k < h; ++k) acc = fmaf(r[i * h + k], cam[k * w + j], acc);
    rows[q] = acc;
  }
  __syncthreads();

  // heat for the band's pixels; the band's peak blend, the largest of a
  // pixel's three channels being the blend of its largest (the blend is
  // monotone in the level)
  const long long first = b * oh * ow + static_cast<long long>(i0) * ow;
  const float* ib = img + first;
  uint8_t* hb = heat + first;
  float peak = 1e-7f;
  if (vec) {
    for (int t = threadIdx.x; t < nr * ow / 4; t += blockDim.x) {
      const int i = 4 * t / ow, j = 4 * t - i * ow;
      const float4 iv = reinterpret_cast<const float4*>(ib)[t];
      const float* row = rows + i * w;
      const uchar4 hv = make_uchar4(heat_at(row, sidx, sval, nk, j, ow),
                                    heat_at(row, sidx, sval, nk, j + 1, ow),
                                    heat_at(row, sidx, sval, nk, j + 2, ow),
                                    heat_at(row, sidx, sval, nk, j + 3, ow));
      reinterpret_cast<uchar4*>(hb)[t] = hv;
      peak = fmaxf(fmaxf(fmaxf(fmaxf(peak, cadx_jet::blend(top[hv.x], iv.x)),
                               cadx_jet::blend(top[hv.y], iv.y)),
                         cadx_jet::blend(top[hv.z], iv.z)),
                   cadx_jet::blend(top[hv.w], iv.w));
    }
  } else {
    for (int p = threadIdx.x; p < nr * ow; p += blockDim.x) {
      const int i = p / ow, j = p - i * ow;
      const uint8_t hv = heat_at(rows + i * w, sidx, sval, nk, j, ow);
      hb[p] = hv;
      peak = fmaxf(peak, cadx_jet::blend(top[hv], ib[p]));
    }
  }
  peak = cadx_jet::block_max(peak, scratch);
  if (threadIdx.x == 0) atomicMax(peaks + b, __float_as_int(peak));
}

// overlay (B, oh, ow, 3) uint8 for the band of heat_kernel's block of the
// same index, blended again and scaled by the image's peak (through its
// reciprocal in double, cadx_jet::overlay_u8_recip); vec: four pixels a
// thread, written as three 32-bit words
__global__ void __launch_bounds__(kThreads, 4)
overlay_kernel(const float* __restrict__ img, const uint8_t* __restrict__ heat,
               const int* __restrict__ peaks, uint8_t* __restrict__ overlay, int oh, int ow,
               int band_rows, int bands, int vec) {
  __shared__ __align__(4) uint8_t lut[cadx_jet::kLutBytes];
  cadx_jet::load_lut(lut);
  const long long b = blockIdx.x / bands;
  const int i0 = (blockIdx.x - b * bands) * band_rows;
  const int nr = min(band_rows, oh - i0);
  const double rpeak = __drcp_rn(static_cast<double>(__int_as_float(peaks[b])));
  const long long first = b * oh * ow + static_cast<long long>(i0) * ow;
  const float* ib = img + first;
  const uint8_t* hb = heat + first;
  uint8_t* ob = overlay + 3 * first;
  __syncthreads();
  const auto value = [&](uint8_t hv, float x, int c) {
    return static_cast<unsigned>(cadx_jet::overlay_u8_recip(cadx_jet::blend(lut[3 * hv + c], x),
                                                           rpeak));
  };
  if (vec) {
    for (int t = threadIdx.x; t < nr * ow / 4; t += blockDim.x) {
      const uchar4 hv = reinterpret_cast<const uchar4*>(hb)[t];
      const float4 iv = reinterpret_cast<const float4*>(ib)[t];
      unsigned* o = reinterpret_cast<unsigned*>(ob) + 3 * t;
      o[0] = value(hv.x, iv.x, 0) | value(hv.x, iv.x, 1) << 8 | value(hv.x, iv.x, 2) << 16 |
             value(hv.y, iv.y, 0) << 24;
      o[1] = value(hv.y, iv.y, 1) | value(hv.y, iv.y, 2) << 8 | value(hv.z, iv.z, 0) << 16 |
             value(hv.z, iv.z, 1) << 24;
      o[2] = value(hv.z, iv.z, 2) | value(hv.w, iv.w, 0) << 8 | value(hv.w, iv.w, 1) << 16 |
             value(hv.w, iv.w, 2) << 24;
    }
  } else {
    for (int p = threadIdx.x; p < nr * ow; p += blockDim.x)
      for (int c = 0; c < 3; ++c) ob[3LL * p + c] = static_cast<uint8_t>(value(hb[p], ib[p], c));
  }
}

}  // namespace

// `lut_rgb` is the host (256, 3) uint8 table; the strides are in elements;
// cidx, cval: (nk, ow) int32 and float32, the nonzero weights of the (w,
// ow) column sampling matrix by column, ascending k, padded with weight 0;
// ny_gap and ny_sum (powers of two up to 32) are the thread splits of the
// GAP's and the channel sum's torch_order_sum; scratch: B * (h * w + 1)
// 4-byte words (the peaks, then the CAMs); band_rows: the rows of a band (a
// block of each band launch), the last band cut to oh.
extern "C" int cadx_gradcam_tail(const void* acts, const void* grads, const void* img,
                                 const void* r, const void* cidx, const void* cval,
                                 const void* lut_rgb, void* overlay, void* heat, void* scratch,
                                 int B, int h, int w, int F, int oh, int ow, int nk,
                                 long long as0, long long as1, long long as2, long long as3,
                                 long long gs0, long long gs1, long long gs2, long long gs3,
                                 int ny_gap, int ny_sum, int band_rows, float gap_factor,
                                 void* stream) {
  if (B == 0 || oh * ow == 0) return 0;
  const auto pow2 = [](int n) { return n >= 1 && n <= kMaxSplit && (n & (n - 1)) == 0; };
  if (h * w == 0 || F == 0 || nk <= 0 || !pow2(ny_gap) || !pow2(ny_sum) || band_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bands = (oh + band_rows - 1) / band_rows;
  const long long blocks = static_cast<long long>(B) * bands;
  const size_t cells = static_cast<size_t>(h) * w;
  const size_t cam_smem = sizeof(float) * (2 * F * (cells + 1) + F + cells);
  const size_t heat_smem =
      sizeof(float) * (cells + static_cast<size_t>(band_rows < oh ? band_rows : oh) * w +
                       2 * static_cast<size_t>(nk) * ow);
  // 227 KB less the kernels' static shared memory
  const size_t most = 227 * 1024 - cadx_jet::kLutBytes - 256 - 32 * sizeof(float);
  if (blocks > INT_MAX || cam_smem > most || heat_smem > most)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = cadx_jet::ensure_lut(lut_rgb);
  if (rc != 0) return rc;
  if (cam_smem > 48 * 1024)
    rc = static_cast<int>(cudaFuncSetAttribute(
        cam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(cam_smem)));
  if (rc == 0 && heat_smem > 48 * 1024)
    rc = static_cast<int>(cudaFuncSetAttribute(
        heat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(heat_smem)));
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* peaks = static_cast<int*>(scratch);
  float* cams = static_cast<float*>(scratch) + B;
  cudaMemsetAsync(peaks, 0, B * sizeof(int), s);
  const unsigned grid = static_cast<unsigned>(blocks);
  const auto aligned = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const int vec = ow % 4 == 0 && aligned(img, 16) && aligned(heat, 4) && aligned(overlay, 4);
  cam_kernel<<<B, kThreads, cam_smem, s>>>(
      static_cast<const float*>(acts), static_cast<const float*>(grads), cams, h, w, F, as0, as1,
      as2, as3, gs0, gs1, gs2, gs3, ny_gap, ny_sum, gap_factor);
  heat_kernel<<<grid, kThreads, heat_smem, s>>>(
      cams, static_cast<const float*>(img), static_cast<const float*>(r),
      static_cast<const int*>(cidx), static_cast<const float*>(cval),
      static_cast<uint8_t*>(heat), peaks, h, w, oh, ow, nk, band_rows, bands, vec);
  overlay_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(img), static_cast<const uint8_t*>(heat), peaks,
      static_cast<uint8_t*>(overlay), oh, ow, band_rows, bands, vec);
  return static_cast<int>(cudaGetLastError());
}
