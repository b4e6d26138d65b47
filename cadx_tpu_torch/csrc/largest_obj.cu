// Largest object of a binary mask, optional hole fill and opening, one block
// per image. Replaces cadx_tpu/kernels/largest_obj.py::largest_obj_pallas;
// see cadx_tpu_torch/kernels/largest_obj.py for the layout and its bounds.
#include "components.cuh"

namespace {

using namespace cadx;

constexpr int kPlanes = 5;  // scratch int32 planes per image

__global__ void __launch_bounds__(kThreads)
largest_obj_kernel(const uint8_t* in, uint8_t* out, int* scratch, int H, int W,
                   int conn, int fill, int smooth_k, int fill_first) {
  const int n = H * W;
  const long long img = blockIdx.x;
  in += img * n;
  out += img * n;
  int* m = scratch + img * kPlanes * n;
  int* lab = m + n;
  int* aux = lab + n;
  int* t1 = aux + n;
  int* t2 = t1 + n;

  for (int p = threadIdx.x; p < n; p += blockDim.x) m[p] = in[p] != 0;
  __syncthreads();
  if (fill_first) fill_holes(m, m, t1, lab, aux, H, W);
  ccl(m, lab, H, W, conn);
  largest_from_labels(m, lab, aux, t2, H, W);
  if (fill && !fill_first) fill_holes(t2, t2, t1, lab, aux, H, W);
  if (smooth_k > 0) opening(t2, t1, m, H, W, smooth_k);
  for (int p = threadIdx.x; p < n; p += blockDim.x) out[p] = static_cast<uint8_t>(t2[p]);
}

}  // namespace

// in, out: (B, H, W) bytes 0/1; scratch: (B, 5, H, W) int32.
extern "C" int cadx_largest_obj(const void* in, void* out, void* scratch, int B,
                                int H, int W, int conn, int fill, int smooth_k,
                                int fill_first, void* stream) {
  largest_obj_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<int*>(scratch), H, W, conn, fill, smooth_k, fill_first);
  return static_cast<int>(cudaGetLastError());
}
