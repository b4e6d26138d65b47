// The pectoral-removal tail after equalization, spread over the whole card.
// Replaces cadx_tpu/kernels/pectoral.py::pectoral_tail_pallas; see
// cadx_tpu_torch/kernels/pectoral.py for the contract, the layout and its
// bounds.
//
// One C call issues a short plan of launches on one stream, each covering
// tiles x images, so that one image fills the card as a batch does:
//   1. object    the largest 8-connected object of bin with its holes
//                filled: tiled_components.cuh's select_largest<8> and
//                fill_holes plans (largest_obj.cu's "fill" ordering);
//   2. markers   the bands: erode and dilate with the composed window
//                (k - 1) * n + 1, anchored at its half, a window_pass
//                launch along y then one along x each; then one launch
//                writes the packed markers;
//   3. watershed the packed (dist << 2) | label relaxation as JAX's sweeps,
//                until one changes nothing or ws_max_iters ran, at
//                max_scan, all in one cooperative launch with grid syncs
//                between the sweeps (tiled_watershed.cuh's relax_capped,
//                which watershed.cu's packed form runs too);
//   4. ridge     one launch writes the labels, the ridge and the breast
//                label off the ridge, then the opening's four window
//                passes write the mask.
// Nothing reads back to the host: the call returns as soon as the plan is
// queued.
#include "tiled_watershed.cuh"

namespace {

using namespace cadx_tiled;

// pk = the markers' packed labels at distance 0: 1 on the eroded object, 2
// outside the dilated one, 3 outside the breast (later ones win), else
// kUnreachedPk; and the first sweep's changed flag zeroed.
__global__ void __launch_bounds__(kTileThreads)
write_markers(const uint8_t* __restrict__ eroded, const uint8_t* __restrict__ dilated,
              const uint8_t* __restrict__ breast, int* __restrict__ pk,
              int* __restrict__ changed, Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  if (px.inside) {
    const long long q = tile.img * g.n + px.p;
    int s = eroded[q] ? 1 : 0;
    if (!dilated[q]) s = 2;
    if (!breast[q]) s = 3;
    pk[q] = s ? s : kUnreachedPk;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) changed[0] = 0;
}

// labels = 255 / 128 / 64 / 0 from pk's label bits; boundary = a
// 4-neighbour disagreement between positive labels, plus the 1-px frame;
// kept = no ridge and label 128
__global__ void __launch_bounds__(kTileThreads)
write_ridge(const int* __restrict__ pk, int* __restrict__ labels, uint8_t* __restrict__ boundary,
            uint8_t* __restrict__ kept, Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  if (!px.inside) return;
  const int* c = pk + tile.img * g.n;
  const int l = c[px.p] & 3;
  bool ridge = px.y == 0 || px.y == g.H - 1 || px.x == 0 || px.x == g.W - 1;
  if (!ridge && l) {
    const int nb[4] = {c[px.p - 1] & 3, c[px.p + 1] & 3, c[px.p - g.W] & 3, c[px.p + g.W] & 3};
    for (int k = 0; k < 4; ++k) ridge |= nb[k] && nb[k] != l;
  }
  const long long q = tile.img * g.n + px.p;
  labels[q] = l == 1 ? 255 : l == 2 ? 128 : l == 3 ? 64 : 0;
  boundary[q] = ridge;
  kept[q] = !ridge && l == 2;
}

}  // namespace

// equ, bin, breast: (B, H, W) uint8 (bin and breast nonzero where set);
// labels: (B, H, W) int32; boundary, mask: (B, H, W) bytes 0/1; scratch:
// 8-byte aligned, kernels/pectoral.py::scratch_bytes; sweeps: a device
// int32 that receives the watershed's sweeps, or null (then a slot of
// scratch does). ws_max_iters and max_scan: the watershed's sweep cap and
// scan window, as JAX's pectoral_tail_pallas takes them.
//
// Scratch: B uint64 keys, four int32 (the sweeps' three changed flags and
// the sweeps slot), four int32 planes (the CCL's labels and roots, then pk
// twice, srow and scol), three byte planes and two bytes a 32 x 32 tile
// (the sweeps' tile flags).
extern "C" int cadx_pectoral_tail(const void* equ, const void* bin, const void* breast,
                                  void* labels, void* boundary, void* mask, void* scratch,
                                  void* sweeps, int B, int H, int W, int morph_k, int n_morph,
                                  int sm_k, int ws_max_iters, int max_scan, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (H > 512 || W > 512 || ws_max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Tiles g = make_tiles(H, W);
  const long long blocks = static_cast<long long>(B) * g.per_image;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * g.n;
  auto* keys = static_cast<unsigned long long*>(scratch);
  int* changed = reinterpret_cast<int*>(keys + B);
  int* lab = changed + 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Planes p{lab, lab + n, keys, g, static_cast<unsigned>(blocks), s};
  uint8_t* a = reinterpret_cast<uint8_t*>(lab + 4 * n);
  uint8_t* obj = a + n;
  uint8_t* c = obj + n;
  uint8_t* tile_fell = c + n;

  // 1. the largest 8-connected object, holes filled -> obj
  cudaMemsetAsync(keys, 0, static_cast<size_t>(B) * sizeof(unsigned long long), s);
  select_largest<8>(static_cast<const uint8_t*>(bin), a, p);
  fill_holes(a, obj, p);

  // 2. eroded -> c, dilated -> obj (n_morph k x k steps compose into one
  // (k - 1) * n + 1 window), then the packed markers in lab
  const int keff = (morph_k - 1) * n_morph + 1;
  const unsigned grid = p.grid;
  window_pass<true, true><<<grid, kTile, 0, s>>>(obj, a, keff, nullptr, nullptr, 0, 0, g);
  window_pass<false, true><<<grid, kTile, 0, s>>>(a, c, keff, nullptr, nullptr, 0, 0, g);
  window_pass<true, false><<<grid, kTile, 0, s>>>(obj, a, keff, nullptr, nullptr, 0, 0, g);
  window_pass<false, false><<<grid, kTile, 0, s>>>(a, obj, keff, nullptr, nullptr, 0, 0,
                                                          g);
  int* pk = lab;
  write_markers<<<grid, kTileThreads, 0, s>>>(c, obj, static_cast<const uint8_t*>(breast), pk,
                                              changed, g);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);

  // 3. the packed watershed's sweeps; the result in pk
  int* sweeps_at = sweeps ? static_cast<int*>(sweeps) : changed + 3;
  if (cudaError_t e = relax_capped(static_cast<const uint8_t*>(equ), pk, lab + n, lab + 2 * n,
                                   lab + 3 * n, changed, tile_fell, sweeps_at, B, H, W,
                                   ws_max_iters, max_scan, s);
      e != cudaSuccess)
    return static_cast<int>(e);

  // 4. labels, the ridge and the kept breast label -> a; its opening -> mask
  write_ridge<<<grid, kTileThreads, 0, s>>>(pk, static_cast<int*>(labels),
                                            static_cast<uint8_t*>(boundary), a, g);
  opening(a, c, static_cast<uint8_t*>(mask), sm_k, p);
  return static_cast<int>(cudaGetLastError());
}
