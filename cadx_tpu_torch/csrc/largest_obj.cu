// Largest object of a binary mask, optional hole fill and opening, spread
// over the whole card. Replaces
// cadx_tpu/kernels/largest_obj.py::largest_obj_pallas; see
// cadx_tpu_torch/kernels/largest_obj.py for the contract and its bounds.
//
// One C call issues a short sequence of launches on one stream with no host
// sync, each covering tiles x images (tiled_components.cuh, whose select,
// fill and opening plans pectoral.cu runs too), as cleaner_front.cu does:
//   fill_first   the background's 4-connected CCL with border marks, then
//                fill_unmarked (the input's holes filled);
//   select       the conn-connected CCL with areas, largest_key (each
//                image's (area, ~label) max into a uint64 a memset clears
//                first), select_label;
//   fill         (not with fill_first) the selection's background CCL and
//                fill_unmarked;
//   smooth_k     the opening: erode along y and x, then dilate along y and
//                x, the window anchored at smooth_k / 2.
// Roots end as each component's smallest raster index whatever order the
// atomics take, so ties go to the smallest index, across tiles too, and the
// bytes are the same on every run.
//
// Scratch: B uint64 keys, then two int32 planes (labels; areas or border
// marks at the roots) and two uint8 mask planes: 8 * B + 10 * B * H * W
// bytes.
#include "tiled_components.cuh"

using namespace cadx_tiled;

// in, out: (B, H, W) bytes 0/1; scratch: 8-byte aligned, 8 * B + 10 * B * H
// * W bytes (the keys, then lab and aux, then the masks a and b).
extern "C" int cadx_largest_obj(const void* in_, void* out_, void* scratch, int B, int H,
                                int W, int conn, int fill, int smooth_k, int fill_first,
                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (conn != 4 && conn != 8) return static_cast<int>(cudaErrorInvalidValue);
  const Tiles g = make_tiles(H, W);
  const long long blocks = static_cast<long long>(B) * g.per_image;
  if (blocks > INT_MAX || g.n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * g.n;
  auto* keys = static_cast<unsigned long long*>(scratch);
  int* lab = reinterpret_cast<int*>(keys + B);
  const Planes p{lab, lab + n, keys, g, static_cast<unsigned>(blocks),
                 static_cast<cudaStream_t>(stream)};
  uint8_t* a = reinterpret_cast<uint8_t*>(p.aux + n);
  uint8_t* b = a + n;
  auto* out = static_cast<uint8_t*>(out_);
  auto other = [&](const uint8_t* q) { return q == a ? b : a; };
  cudaMemsetAsync(keys, 0, static_cast<size_t>(B) * sizeof(unsigned long long), p.s);

  const bool fill_after = fill && !fill_first, smooth = smooth_k > 0;
  const uint8_t* cur = static_cast<const uint8_t*>(in_);
  if (fill_first) {
    fill_holes(cur, a, p);
    cur = a;
  }
  uint8_t* dst = fill_after || smooth ? other(cur) : out;
  if (conn == 4) {
    select_largest<4>(cur, dst, p);
  } else {
    select_largest<8>(cur, dst, p);
  }
  if (fill_after) {
    uint8_t* filled = smooth ? other(dst) : out;
    fill_holes(dst, filled, p);
    dst = filled;
  }
  // dst is a or b here
  if (smooth) opening(dst, other(dst), out, smooth_k, p);
  return static_cast<int>(cudaGetLastError());
}
