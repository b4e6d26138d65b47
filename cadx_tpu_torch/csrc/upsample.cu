// Nearest-neighbour upsample by an integer factor.
// Replaces cadx_tpu/kernels/nn_kernels.py::upsample_nearest_pallas; see
// cadx_tpu_torch/kernels/upsample.py for the layout and its bound.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// in (P, h, w) -> out (P, h * f, w * f). One block per output row (a grid
// of P * h * f blocks), its threads striding along the row, so
// neighbouring threads write neighbouring addresses and the index math
// per element is one 32-bit division. The values are copied as raw bits
// of their width.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_kernel(const T* __restrict__ in, T* __restrict__ out, int h, int w, int f) {
  const long long row = blockIdx.x;           // p * (h * f) + y
  const int oh = h * f, ow = w * f;
  const long long p = row / oh;
  const int y = static_cast<int>(row - p * oh);
  const T* src = in + (p * h + y / f) * w;
  T* dst = out + row * ow;
  for (int x = threadIdx.x; x < ow; x += kThreads) dst[x] = src[x / f];
}

template <typename T>
int launch(const void* in, void* out, int P, int h, int w, int f, cudaStream_t stream) {
  const long long rows = static_cast<long long>(P) * h * f;
  if (rows == 0 || w == 0) return 0;
  upsample_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), h, w, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in (P, h, w) -> out (P, h * f, w * f), elements of `elem_bytes` (1, 2,
// 4 or 8) bytes.
extern "C" int cadx_upsample_nearest(const void* in, void* out, int P, int h, int w,
                                     int f, int elem_bytes, void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(in, out, P, h, w, f, st);
    case 2: return launch<uint16_t>(in, out, P, h, w, f, st);
    case 4: return launch<uint32_t>(in, out, P, h, w, f, st);
    case 8: return launch<uint64_t>(in, out, P, h, w, f, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
