// Connected-component labels as one block per image, the kernel that
// csrc/ccl.cu replaced, kept only so that timings can set the two side by
// side (chip_smoke.py --equalize-ccl-times); no path runs it. One block of
// 1024 threads copies its mask to a 0/1 int32 plane in global memory and
// loops the block-level union-find of components.cuh to its fixpoint there.
#include "components.cuh"

namespace {

using namespace cadx;

__global__ void __launch_bounds__(kThreads)
ccl_kernel(const uint8_t* mask, int* labels, int* scratch, int H, int W,
           int conn, int background) {
  const int n = H * W;
  const long long img = blockIdx.x;
  mask += img * n;
  labels += img * n;
  int* fg = scratch + img * n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) fg[p] = mask[p] != 0;
  __syncthreads();
  ccl(fg, labels, H, W, conn);
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    if (!fg[p]) labels[p] = background;
}

}  // namespace

// mask: (B, H, W) bytes 0/1; labels: (B, H, W) int32; scratch: (B, H, W)
// int32. Foreground gets its component's minimum raster index, background
// the value `background`.
extern "C" int cadx_ccl_one_block(const void* mask, void* labels, void* scratch, int B,
                                  int H, int W, int conn, int background, void* stream) {
  ccl_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<int*>(labels),
      static_cast<int*>(scratch), H, W, conn, background);
  return static_cast<int>(cudaGetLastError());
}
