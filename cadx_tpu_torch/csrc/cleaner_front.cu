// The cleaner's front, suppress_artifacts then segment_breast, in one launch
// with one block per image. Replaces
// cadx_tpu/kernels/cleaner_front.py::cleaner_front_pallas; see
// cadx_tpu_torch/kernels/cleaner_front.py for the contract and its bounds.
//
// It chains the phases of largest_obj.cu over a per-image global-memory
// scratch of 5 int32 planes: stage 1 thresholds the raw image at
// table[max], takes the largest 8-connected component, fills its holes and
// opens it; stage 2 rescales the suppressed image to 8 bits exactly as
// to_uint8 does (a float32 division by the max, then a product with 255,
// each rounded alone: the build passes --fmad=false), thresholds at
// table[max] again, fills the holes and takes the largest component. The
// thresholds come from the host's float64 truncation table, indexed at the
// image's max. Labels are union-find pixel indices (int), so any H * W
// below 2^31 works.
#include "components.cuh"

namespace {

using namespace cadx;

constexpr int kPlanes = 5;  // scratch int32 planes per image

// The largest v over the block's threads (all v >= 0).
__device__ int block_max(int v) {
  __shared__ int best;
  if (threadIdx.x == 0) best = 0;
  __syncthreads();
  atomicMax(&best, v);
  __syncthreads();
  const int r = best;
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads)
cleaner_front_kernel(const uint8_t* raw, const int* table, uint8_t* breast_only,
                     uint8_t* mask1, uint8_t* contour, int* scratch, int H, int W,
                     int smooth_k) {
  const int n = H * W;
  const long long img = blockIdx.x;
  raw += img * n;
  breast_only += img * n;
  mask1 += img * n;
  contour += img * n;
  int* m = scratch + img * kPlanes * n;
  int* lab = m + n;
  int* aux = lab + n;
  int* t1 = aux + n;
  int* t2 = t1 + n;

  // ---- stage 1: suppress_artifacts ----
  int mx = 0;
  for (int p = threadIdx.x; p < n; p += blockDim.x) mx = max(mx, static_cast<int>(raw[p]));
  const int low1 = table[block_max(mx)];
  for (int p = threadIdx.x; p < n; p += blockDim.x) m[p] = raw[p] > low1;
  __syncthreads();
  ccl(m, lab, H, W, 8);
  largest_from_labels(m, lab, aux, t2, H, W);
  fill_holes(t2, t2, t1, lab, aux, H, W);
  if (smooth_k > 0) opening(t2, t1, m, H, W, smooth_k);
  // the suppressed image (raw where the mask holds) into t1
  int smax = 0;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    mask1[p] = static_cast<uint8_t>(t2[p]);
    const int s = t2[p] ? static_cast<int>(raw[p]) : 0;
    t1[p] = s;
    smax = max(smax, s);
  }
  const float maxv = fmaxf(static_cast<float>(block_max(smax)), 1e-12f);

  // ---- stage 2: segment_breast ----
  // to_uint8: (img / max * 255) truncated, the division and the product
  // each rounded to float32
  int m8 = 0;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int v = static_cast<int>(__fmul_rn(__fdiv_rn(static_cast<float>(t1[p]), maxv), 255.0f));
    t2[p] = v;
    m8 = max(m8, v);
  }
  const int low2 = table[block_max(m8)];
  for (int p = threadIdx.x; p < n; p += blockDim.x) m[p] = t2[p] > low2;
  __syncthreads();
  fill_holes(m, m, t2, lab, aux, H, W);
  ccl(m, lab, H, W, 8);
  largest_from_labels(m, lab, aux, t2, H, W);
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    contour[p] = static_cast<uint8_t>(t2[p]);
    breast_only[p] = static_cast<uint8_t>(t2[p] ? t1[p] : 0);
  }
}

}  // namespace

// raw, breast_only, mask1, contour: (B, H, W) bytes; table: 256 int32
// thresholds indexed by an image's max; scratch: (B, 5, H, W) int32.
extern "C" int cadx_cleaner_front(const void* raw, const void* table, void* breast_only,
                                  void* mask1, void* contour, void* scratch, int B, int H,
                                  int W, int smooth_k, void* stream) {
  cleaner_front_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<const int*>(table),
      static_cast<uint8_t*>(breast_only), static_cast<uint8_t*>(mask1),
      static_cast<uint8_t*>(contour), static_cast<int*>(scratch), H, W, smooth_k);
  return static_cast<int>(cudaGetLastError());
}
