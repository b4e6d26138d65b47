// The cleaner's front, suppress_artifacts then segment_breast, spread over
// the whole card. Replaces
// cadx_tpu/kernels/cleaner_front.py::cleaner_front_pallas; see
// cadx_tpu_torch/kernels/cleaner_front.py for the contract and its bounds.
//
// One C call issues the phases as ~25 launches on one stream, with no host
// sync: each launch covers tiles x images (tiled_components.cuh), so a
// single large image fills every SM, and each phase that needs a whole
// image finished (a max, a component key, the joins across tiles) ends
// with its launch. One launch a phase was chosen over a cooperative launch
// with grid.sync(): a cooperative grid is capped at the blocks that fit on
// the card at once, so every phase would loop over tiles, and the phases
// want different blocks (1024 threads a tile, 64 for the merge).
//
// Stage 1 thresholds the raw image at table[max], labels it 8-connected,
// keeps the largest component (ties to the smallest raster index), fills
// its holes (4-connected background that reaches no border) and opens it
// with a smooth_k square (a separable erosion and dilation, the window cut
// to the image). Stage 2 rescales the suppressed image to 8 bits exactly as
// to_uint8 does (a float32 division by the max, then a product with 255,
// each rounded alone: the build passes --fmad=false), thresholds at
// table[max] again, fills the holes and keeps the largest 8-connected
// component. The thresholds come from the host's float64 truncation table,
// indexed on the device at each image's max.
//
// Scratch, per image: 8 uint64 statistics (maxima and component keys,
// zeroed by a memset at the start), two int32 planes (labels; areas or
// border marks at the roots) and three uint8 mask planes: 11 bytes a pixel.
#include "tiled_components.cuh"

namespace {

using namespace cadx_tiled;

// per-image statistics: slots of stats[img * kStats]
constexpr int kStats = 8;
constexpr int kRawMax = 0, kKey1 = 1, kSuppressedMax = 2, kU8Max = 3, kKey2 = 4;

// stats[slot] = the image's max of src
__global__ void __launch_bounds__(kTileThreads)
image_max(const uint8_t* __restrict__ src, unsigned long long* stats, int slot, Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  const unsigned v = px.inside ? src[tile.img * g.n + px.p] : 0u;
  block_max_into(stats + tile.img * kStats + slot, v);
}

// dst = src > table[stats[slot]]
__global__ void __launch_bounds__(kTileThreads)
threshold(const uint8_t* __restrict__ src, const int* __restrict__ table,
          const unsigned long long* __restrict__ stats, int slot, uint8_t* __restrict__ dst,
          Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  if (!px.inside) return;
  const long long q = tile.img * g.n + px.p;
  dst[q] = src[q] > table[stats[tile.img * kStats + slot]];
}

// to_uint8 of the suppressed image (raw where mask1 holds): (s / max) * 255
// truncated, the division and the product each rounded to float32; its
// max into stats
__global__ void __launch_bounds__(kTileThreads)
rescale_u8(const uint8_t* __restrict__ raw, const uint8_t* __restrict__ mask1,
           unsigned long long* stats, uint8_t* __restrict__ dst, Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  unsigned long long* st = stats + tile.img * kStats;
  unsigned v = 0u;
  if (px.inside) {
    const long long q = tile.img * g.n + px.p;
    const float maxv = fmaxf(static_cast<float>(st[kSuppressedMax]), 1e-12f);
    const int s = mask1[q] ? raw[q] : 0;
    v = static_cast<unsigned>(__fmul_rn(__fdiv_rn(static_cast<float>(s), maxv), 255.0f));
    dst[q] = static_cast<uint8_t>(v);
  }
  block_max_into(st + kU8Max, v);
}

// contour = filled & (lab == the largest label); breast_only = the
// suppressed image where contour holds
__global__ void __launch_bounds__(kTileThreads)
front_outputs(const uint8_t* __restrict__ filled, const int* __restrict__ lab,
              const unsigned long long* __restrict__ stats, const uint8_t* __restrict__ raw,
              const uint8_t* __restrict__ mask1, uint8_t* __restrict__ contour,
              uint8_t* __restrict__ breast_only, Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  if (!px.inside) return;
  const long long q = tile.img * g.n + px.p;
  const bool c = filled[q] && lab[q] == key_label(stats[tile.img * kStats + kKey2]);
  contour[q] = c;
  breast_only[q] = c && mask1[q] ? raw[q] : 0;
}

}  // namespace

// raw, breast_only, mask1, contour: (B, H, W) bytes; table: 256 int32
// thresholds indexed by an image's max; scratch: 8-byte aligned, B * 64 +
// B * H * W * 11 bytes (the statistics, then lab and aux, then the masks
// a, b and c).
extern "C" int cadx_cleaner_front(const void* raw_, const void* table_, void* breast_only,
                                  void* mask1_, void* contour, void* scratch, int B, int H,
                                  int W, int smooth_k, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const Tiles g = make_tiles(H, W);
  const long long blocks = static_cast<long long>(B) * g.per_image;
  if (blocks > INT_MAX || g.n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  const long long n = static_cast<long long>(B) * g.n;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* raw = static_cast<const uint8_t*>(raw_);
  const auto* table = static_cast<const int*>(table_);
  auto* mask1 = static_cast<uint8_t*>(mask1_);
  auto* stats = static_cast<unsigned long long*>(scratch);
  int* lab = reinterpret_cast<int*>(stats + static_cast<long long>(B) * kStats);
  int* aux = lab + n;
  uint8_t* a = reinterpret_cast<uint8_t*>(aux + n);
  uint8_t* b = a + n;
  uint8_t* c = b + n;
  cudaMemsetAsync(stats, 0, static_cast<size_t>(B) * kStats * 8, s);

  // ---- stage 1: suppress_artifacts ----
  image_max<<<grid, kTileThreads, 0, s>>>(raw, stats, kRawMax, g);
  threshold<<<grid, kTileThreads, 0, s>>>(raw, table, stats, kRawMax, a, g);
  ccl<8, true>(a, false, lab, aux, g, grid, s);
  largest_key<<<grid, kTileThreads, 0, s>>>(a, false, lab, aux, stats, kStats, kKey1, g);
  select_label<<<grid, kTileThreads, 0, s>>>(a, lab, stats, kStats, kKey1, b, g);
  ccl<4, false>(b, true, lab, aux, g, grid, s);  // the background of b
  if (smooth_k > 0) {
    fill_unmarked<<<grid, kTileThreads, 0, s>>>(b, lab, aux, a, nullptr, nullptr, 0, 0, g);
    // erode (AND) then dilate (OR), each along y then x
    window_pass<true, true><<<grid, kTile, 0, s>>>(a, c, smooth_k, nullptr, nullptr,
                                                          0, 0, g);
    window_pass<false, true><<<grid, kTile, 0, s>>>(c, a, smooth_k, nullptr, nullptr,
                                                           0, 0, g);
    window_pass<true, false><<<grid, kTile, 0, s>>>(a, c, smooth_k, nullptr, nullptr,
                                                           0, 0, g);
    window_pass<false, false><<<grid, kTile, 0, s>>>(c, mask1, smooth_k, raw, stats,
                                                            kStats, kSuppressedMax, g);
  } else {
    fill_unmarked<<<grid, kTileThreads, 0, s>>>(b, lab, aux, mask1, raw, stats, kStats,
                                                 kSuppressedMax, g);
  }

  // ---- stage 2: segment_breast ----
  rescale_u8<<<grid, kTileThreads, 0, s>>>(raw, mask1, stats, c, g);
  threshold<<<grid, kTileThreads, 0, s>>>(c, table, stats, kU8Max, a, g);
  ccl<4, false>(a, true, lab, aux, g, grid, s);  // the background of a
  fill_unmarked<<<grid, kTileThreads, 0, s>>>(a, lab, aux, b, nullptr, nullptr, 0, 0, g);
  ccl<8, true>(b, false, lab, aux, g, grid, s);
  largest_key<<<grid, kTileThreads, 0, s>>>(b, false, lab, aux, stats, kStats, kKey2, g);
  front_outputs<<<grid, kTileThreads, 0, s>>>(b, lab, stats, raw, mask1,
                                              static_cast<uint8_t*>(contour),
                                              static_cast<uint8_t*>(breast_only), g);
  return static_cast<int>(cudaGetLastError());
}
