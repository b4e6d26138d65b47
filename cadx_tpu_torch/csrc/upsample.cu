// Nearest-neighbour upsample by an integer factor.
// Replaces cadx_tpu/kernels/nn_kernels.py::upsample_nearest_pallas; see
// cadx_tpu_torch/kernels/upsample.py for the layout and its bound.
//
// The grid runs over source elements, so each is read once. Factor 2 on
// rows whose bytes are a multiple of 16 (the U-Net's only factor) is a
// fast path: a thread loads 16 bytes of consecutive source elements, builds
// their doubled copies in registers and writes them as two 16-byte stores
// to each of the two output rows. Any other factor, and rows that are not
// 16-byte aligned (odd widths, narrow types), take the scalar path: a
// thread a source element, f x f stores. Values are copied as raw bits.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// in (rows, w) -> out (rows * 2, w * 2); nv 16-byte vectors a source row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2_vec_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                     long long total, long long nv) {
  constexpr int V = 16 / sizeof(T);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long row = i / nv, v = i - row * nv;
  const uint4 src = in[i];
  T s[V];
  memcpy(s, &src, 16);
  T d[2 * V];
#pragma unroll
  for (int e = 0; e < V; ++e) d[2 * e] = d[2 * e + 1] = s[e];
  uint4 lo, hi;
  memcpy(&lo, d, 16);
  memcpy(&hi, d + V, 16);
  uint4* top = out + (2 * row) * (2 * nv) + 2 * v;   // output row 2 row
  uint4* bottom = top + 2 * nv;                       // output row 2 row + 1
  top[0] = lo;
  top[1] = hi;
  bottom[0] = lo;
  bottom[1] = hi;
}

// in (rows, w) -> out (rows * f, w * f), a thread a source element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_kernel(const T* __restrict__ in, T* __restrict__ out, long long total, int w,
                int f) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long row = i / w;
  const int x = static_cast<int>(i - row * w);
  const T v = in[i];
  const long long ow = static_cast<long long>(w) * f;
  T* dst = out + row * f * ow + static_cast<long long>(x) * f;
  for (int r = 0; r < f; ++r, dst += ow)
    for (int s = 0; s < f; ++s) dst[s] = v;
}

template <typename T>
int launch(const void* in, void* out, long long rows, int w, int f, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(w) * sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) &
                        15) == 0;
  if (f == 2 && row_bytes % 16 == 0 && aligned) {
    const long long nv = row_bytes / 16;
    const long long total = rows * nv;
    upsample2_vec_kernel<T><<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), total, nv);
  } else {
    const long long total = rows * w;
    upsample_kernel<T><<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), total, w, f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in (P, h, w) -> out (P, h * f, w * f), elements of `elem_bytes` (1, 2,
// 4 or 8) bytes.
extern "C" int cadx_upsample_nearest(const void* in, void* out, int P, int h, int w,
                                     int f, int elem_bytes, void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(P) * h;
  if (rows == 0 || w == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(in, out, rows, w, f, st);
    case 2: return launch<uint16_t>(in, out, rows, w, f, st);
    case 4: return launch<uint32_t>(in, out, rows, w, f, st);
    case 8: return launch<uint64_t>(in, out, rows, w, f, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
