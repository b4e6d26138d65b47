// The Grad-CAM tail of the fused pipeline, one block per image. Replaces
// cadx_tpu/kernels/nn_kernels.py::gradcam_tail_pallas; see
// cadx_tpu_torch/kernels/gradcam_tail.py for the layout and its bound.
#include <cstdint>

#include <cuda_runtime.h>

#include "jet.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSplit = 32;

// sum_{i < n} term(i) in the order torch's CUDA reduction adds a float32
// reduction over a non-innermost dimension: the n terms are split over
// `ny` (a power of two) threads, thread y taking terms y, y + ny, ...;
// each thread keeps four accumulators (the k-th term of its sequence into
// k % 4), added in order; the ny partials then meet in a halving tree.
template <typename Term>
__device__ float torch_order_sum(int n, int ny, Term term) {
  float part[kMaxSplit];
  for (int y = 0; y < ny; ++y) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k = 0;
    for (int i = y; i < n; i += ny, ++k) acc[k & 3] = __fadd_rn(acc[k & 3], term(i));
    part[y] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  }
  for (int off = ny / 2; off > 0; off >>= 1)
    for (int y = 0; y < off; ++y) part[y] = __fadd_rn(part[y], part[y + off]);
  return part[0];
}

// acts, grads: (B, h, w, F) float32 at the given element strides; img:
// (B, oh, ow) float32; r: (oh, h) and ct: (w, ow) the bilinear sampling
// matrices; overlay (B, oh, ow, 3) and heat (B, oh, ow) uint8. Dynamic
// shared memory: F weights, h*w CAM cells, oh*w rows of R @ cam.
__global__ void __launch_bounds__(kThreads)
tail_kernel(const float* __restrict__ acts, const float* __restrict__ grads,
            const float* __restrict__ img, const float* __restrict__ r,
            const float* __restrict__ ct, uint8_t* __restrict__ overlay,
            uint8_t* __restrict__ heat, int h, int w, int F, int oh, int ow,
            long long as0, long long as1, long long as2, long long as3,
            long long gs0, long long gs1, long long gs2, long long gs3, int ny_gap,
            int ny_sum, float gap_factor) {
  extern __shared__ float smem[];
  float* wts = smem;
  float* cam = wts + F;
  float* rows = cam + h * w;
  __shared__ uint8_t lut[cadx_jet::kLutBytes];
  __shared__ float scratch[32];
  cadx_jet::load_lut(lut);
  const long long b = blockIdx.x;
  const float* A = acts + b * as0;
  const float* G = grads + b * gs0;
  const int cells = h * w;

  // GAP of the gradients: the sum over the cells, times the float32 factor
  // CUDA's mean scales its sum by
  for (int f = threadIdx.x; f < F; f += kThreads) {
    const float* g = G + f * gs3;
    const float s = torch_order_sum(cells, ny_gap, [&](int c) {
      return g[(c / w) * gs1 + (c % w) * gs2];
    });
    wts[f] = __fmul_rn(s, gap_factor);
  }
  __syncthreads();

  // cam = relu(sum_f w_f A_f), each product rounded
  float lo = INFINITY, hi = -INFINITY;
  for (int p = threadIdx.x; p < cells; p += kThreads) {
    const float* a = A + (p / w) * as1 + (p % w) * as2;
    float s = torch_order_sum(F, ny_sum, [&](int f) { return __fmul_rn(wts[f], a[f * as3]); });
    s = s > 0.0f ? s : 0.0f;
    cam[p] = s;
    lo = fminf(lo, s);
    hi = fmaxf(hi, s);
  }
  lo = cadx_jet::block_min(lo, scratch);
  hi = cadx_jet::block_max(hi, scratch);
  const float denom = __fadd_rn(__fsub_rn(hi, lo), 1e-7f);
  for (int p = threadIdx.x; p < cells; p += kThreads)
    cam[p] = __fdiv_rn(__fsub_rn(cam[p], lo), denom);
  __syncthreads();

  // rows = R @ cam, each a chain of fused multiply-adds in ascending k,
  // as cuBLAS accumulates the plain version's matrix product
  for (int q = threadIdx.x; q < oh * w; q += kThreads) {
    const int i = q / w, j = q % w;
    float acc = 0.0f;
    for (int k = 0; k < h; ++k) acc = fmaf(r[i * h + k], cam[k * w + j], acc);
    rows[q] = acc;
  }
  __syncthreads();

  // pass 1: cam_up = rows @ ct, clamp, trunc(* 255) -> heat; the peak blend
  const int n = oh * ow;
  const float* ib = img + b * n;
  uint8_t* hb = heat + b * n;
  float peak = 1e-7f;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int i = p / ow, j = p % ow;
    float acc = 0.0f;
    for (int k = 0; k < w; ++k) acc = fmaf(rows[i * w + k], ct[k * ow + j], acc);
    const float v = fminf(fmaxf(acc, 0.0f), 1.0f);
    const uint8_t hv = static_cast<uint8_t>(__fmul_rn(v, 255.0f));
    hb[p] = hv;
    const uint8_t* jet = lut + 3 * hv;
    for (int c = 0; c < 3; ++c) peak = fmaxf(peak, cadx_jet::blend(jet[c], ib[p]));
  }
  peak = cadx_jet::block_max(peak, scratch);

  // pass 2: each thread rereads the heat levels it wrote and blends again
  uint8_t* ob = overlay + b * n * 3;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const uint8_t* jet = lut + 3 * hb[p];
    for (int c = 0; c < 3; ++c)
      ob[3LL * p + c] = cadx_jet::overlay_u8(cadx_jet::blend(jet[c], ib[p]), peak);
  }
}

}  // namespace

// One block per image. `lut_rgb` is the host (256, 3) uint8 table; the
// strides are in elements; ny_gap and ny_sum (powers of two up to 32) are
// the thread splits of the GAP's and the channel sum's torch_order_sum.
extern "C" int cadx_gradcam_tail(const void* acts, const void* grads, const void* img,
                                 const void* r, const void* ct, const void* lut_rgb,
                                 void* overlay, void* heat, int B, int h, int w, int F,
                                 int oh, int ow, long long as0, long long as1,
                                 long long as2, long long as3, long long gs0,
                                 long long gs1, long long gs2, long long gs3,
                                 int ny_gap, int ny_sum, float gap_factor,
                                 void* stream) {
  if (B == 0 || oh * ow == 0) return 0;
  const auto pow2 = [](int n) { return n >= 1 && n <= kMaxSplit && (n & (n - 1)) == 0; };
  if (h * w == 0 || F == 0 || !pow2(ny_gap) || !pow2(ny_sum))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (static_cast<size_t>(F) + h * w +
                                       static_cast<size_t>(oh) * w);
  // 227 KB less the kernel's static shared memory
  if (smem > 227 * 1024 - cadx_jet::kLutBytes - 32 * sizeof(float))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = cadx_jet::ensure_lut(lut_rgb);
  if (rc != 0) return rc;
  if (smem > 48 * 1024) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (rc != 0) return rc;
  }
  tail_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acts), static_cast<const float*>(grads),
      static_cast<const float*>(img), static_cast<const float*>(r),
      static_cast<const float*>(ct), static_cast<uint8_t*>(overlay),
      static_cast<uint8_t*>(heat), h, w, F, oh, ow, as0, as1, as2, as3, gs0, gs1, gs2,
      gs3, ny_gap, ny_sum, gap_factor);
  return static_cast<int>(cudaGetLastError());
}
