// Mask of the largest-area label as one block per image, the kernel that
// csrc/mode.cu replaced, kept only so that timings can set the two side by
// side (chip_smoke.py --mode-jet-times); no path runs it. One block of 1024
// threads writes a 0/1 foreground plane, counts areas with global atomics
// into a second plane and the result into a third, then copies it out.
#include "components.cuh"

namespace {

using namespace cadx;

constexpr int kPlanes = 3;  // scratch int32 planes per image

__global__ void __launch_bounds__(kThreads)
mode_kernel(const int* labels, const uint8_t* mask, uint8_t* out, int* scratch,
            int H, int W) {
  const int n = H * W;
  const long long img = blockIdx.x;
  labels += img * n;
  mask += img * n;
  out += img * n;
  int* fg = scratch + img * kPlanes * n;
  int* area = fg + n;
  int* res = area + n;
  // a foreground label outside [0, H*W) is no component's raster index: it
  // is not counted and never chosen
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int l = labels[p];
    fg[p] = mask[p] != 0 && l >= 0 && l < n;
  }
  __syncthreads();
  largest_from_labels(fg, labels, area, res, H, W);
  for (int p = threadIdx.x; p < n; p += blockDim.x) out[p] = static_cast<uint8_t>(res[p]);
}

}  // namespace

// labels: (B, H, W) int32; mask, out: (B, H, W) bytes 0/1; scratch:
// (B, 3, H, W) int32.
extern "C" int cadx_largest_component_mask_one_block(const void* labels, const void* mask,
                                                     void* out, void* scratch, int B,
                                                     int H, int W, void* stream) {
  mode_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(labels), static_cast<const uint8_t*>(mask),
      static_cast<uint8_t*>(out), static_cast<int*>(scratch), H, W);
  return static_cast<int>(cudaGetLastError());
}
