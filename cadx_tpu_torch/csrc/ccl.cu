// Connected-component labels in two forms, chosen by shape. Replaces
// cadx_tpu/kernels/ccl.py::label_components_pallas; see
// cadx_tpu_torch/kernels/ccl.py for the layout and its bounds.
//
// The tiled form, for any shape: three launches of the tiled union-find of
// tiled_components.cuh over 32x32 tiles x images on one stream, with no
// host sync: ccl_local and ccl_merge as cleaner_front, largest_obj and
// pectoral_tail run them, then flatten_labels, which points every
// foreground pixel at its root and writes the background value where the
// mask is 0.
//
// The cluster form, for planes of at most 64 x 64 (the serving path's CAM
// masks, 62x62 and 6x6): one launch, a thread block cluster an image, the
// image's union-find in the cluster's distributed shared memory, so no link
// waits on a round trip to L2 (the tiled form's ccl_merge follows chains of
// roots there, a dependent L2 access a step). One block an image was tried
// first: with four pixels a thread at 62x62 its union rounds ran one after
// another and it was slower than the tiled form.
//
// In both, every link goes from a larger root to a smaller index of the
// same component, so roots end as each component's smallest raster index
// whatever order the atomics take.
#include <cooperative_groups.h>

#include "tiled_components.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace cadx_tiled;

// lab[p] = the root of p (its component's smallest raster index) where
// the mask is set, else background. Only foreground labels are ever
// followed, so the background writes race with no find.
__global__ void __launch_bounds__(kTileThreads)
flatten_labels(const uint8_t* __restrict__ mask, int* lab, int background, Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  if (!px.inside) return;
  const long long base = tile.img * g.n;
  int* l = lab + base;
  l[px.p] = mask[base + px.p] ? find_global(l, px.p) : background;
}

constexpr int kBands = 4;                       // blocks (bands of rows) an image
constexpr int kBandThreads = 1024;
constexpr int kClusterSide = 64;                // the cluster form's largest side
constexpr int kBandRows = kClusterSide / kBands;

// Union-find over pixel indices whose parent slots `at(q)` gives (a
// block's own shared memory, or a cluster's): path halving, and each link
// from the larger root to the smaller one, a link that lost a race
// retrying from the value it found.
template <class At>
__device__ __forceinline__ int find_at(const At& at, int a) {
  while (true) {
    const int b = *static_cast<volatile int*>(at(a));
    if (b == a) return a;
    const int c = *static_cast<volatile int*>(at(b));
    if (c == b) return b;
    atomicMin(at(a), c);
    a = c;
  }
}

template <class At>
__device__ __forceinline__ void unite_at(const At& at, int a, int b) {
  while (true) {
    a = find_at(at, a);
    b = find_at(at, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(at(b), a);
    if (old == b) return;
    b = old;
  }
}

// The pixels above pixel x of a row (whose run starts at `start`) that it
// joins, as ccl_local chooses them (up, the run above's bits): the first
// pixel of a run joins each run among up-left, up and up-right; a later
// pixel only the run up and to its right that the pixels before it cannot
// reach (4-connected: the run above it where the pixel to its left had
// none). Returns how many of tg it filled, with offsets -1, 0, +1.
template <int kConn>
__device__ __forceinline__ int up_joins(unsigned long long up, int x, int start, int W,
                                        int (&tg)[3]) {
  const auto bit = [&](int i) { return i >= 0 && i < W && ((up >> i) & 1ull); };
  int k = 0;
  if (kConn == 4) {
    if (bit(x) && !(x > start && bit(x - 1))) tg[k++] = 0;
  } else if (x == start) {
    if (bit(x - 1)) tg[k++] = -1;
    if (bit(x) && !bit(x - 1)) tg[k++] = 0;
    if (bit(x + 1) && !bit(x)) tg[k++] = 1;
  } else if (bit(x + 1) && !bit(x)) {
    tg[k++] = 1;
  }
  return k;
}

// The cluster form: a cluster of kBands blocks labels one image, block r
// the band of R = ceil(H / kBands) rows from r * R, one pixel a thread,
// its parents in the block's shared memory (the cluster's distributed
// shared memory holds the image's). Each band row's foreground bits make a
// 64-bit mask (two warp ballots), from which a pixel takes its run's first
// pixel as its parent with no atomics; the band's rows join the rows above
// them in shared memory, and each pixel finds its band root. After a
// cluster barrier each band's first row joins the last row of the band
// above through the other block's shared memory; after another each band
// root finds its image root once, and every pixel takes its band root's.
template <int kConn>
__global__ void __cluster_dims__(kBands, 1, 1) __launch_bounds__(kBandThreads)
ccl_cluster(const uint8_t* __restrict__ mask, int* __restrict__ labels, int H, int W,
            int background) {
  __shared__ int par[kBandRows * kClusterSide];
  __shared__ int root[kBandRows * kClusterSide];   // a band root's image root
  __shared__ unsigned long long rows[kBandRows];
  cg::cluster_group cluster = cg::this_cluster();
  const int band = static_cast<int>(cluster.block_rank());
  const int R = (H + kBands - 1) / kBands, y0 = band * R, y1 = min(y0 + R, H);
  const int off = y0 * W, band_px = max(y1 - y0, 0) * W;
  const long long base = static_cast<long long>(blockIdx.x / kBands) * H * W;
  const auto local = [&](int q) { return par + (q - off); };
  const auto anywhere = [&](int q) {
    const int r = q / (R * W);
    return r == band ? par + (q - off) : cluster.map_shared_rank(par, r) + (q - r * R * W);
  };
  const auto run_start = [&](int yl, int x) {
    const unsigned long long below = ~rows[yl] & (x == 63 ? ~0ull : (2ull << x) - 1ull);
    return below ? 64 - __clzll(below) : 0;
  };
  const int lane = threadIdx.x & 31, t = threadIdx.x;
  for (int yl = t >> 5; yl < y1 - y0; yl += kBandThreads / 32) {
    const uint8_t* row = mask + base + static_cast<long long>(y0 + yl) * W;
    const unsigned lo = __ballot_sync(0xffffffffu, lane < W && row[lane]);
    const unsigned hi = __ballot_sync(0xffffffffu, lane + 32 < W && row[lane + 32]);
    if (lane == 0) rows[yl] = lo | static_cast<unsigned long long>(hi) << 32;
  }
  __syncthreads();
  const int yl = t < band_px ? t / W : 0, x = t - yl * W, q = off + t;
  const bool fg = t < band_px && ((rows[yl] >> x) & 1ull);
  const int start = fg ? run_start(yl, x) : 0;
  if (t < band_px) par[t] = fg ? off + yl * W + start : q;
  __syncthreads();
  int tg[3], k = 0;
  if (fg && yl > 0) k = up_joins<kConn>(rows[yl - 1], x, start, W, tg);
  for (int i = 0; i < k; ++i) unite_at(local, q, q - W + tg[i]);
  __syncthreads();
  const int own = fg ? find_at(local, q) : q;   // the band root
  cluster.sync();
  k = 0;
  if (fg && yl == 0 && band > 0)
    k = up_joins<kConn>(cluster.map_shared_rank(rows, band - 1)[R - 1], x, start, W, tg);
  for (int i = 0; i < k; ++i) unite_at(anywhere, q, q - W + tg[i]);
  cluster.sync();
  if (fg && own == q) root[t] = find_at(anywhere, q);
  __syncthreads();
  if (t < band_px) labels[base + q] = fg ? root[own - off] : background;
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

// mask: (B, H, W) bytes 0/1; labels: (B, H, W) int32. The cluster form
// where allow_cluster is set and H, W <= kClusterSide, else the tiled
// form, whose scratch is a (B, H, W) int32 plane (ccl_local's root marks,
// which this CCL does not read). Foreground gets its component's minimum
// raster index, background the value `background`.
extern "C" int cadx_ccl(const void* mask, void* labels, void* scratch, int B, int H, int W,
                        int conn, int background, int allow_cluster, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (conn != 4 && conn != 8) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* lab = static_cast<int*>(labels);
  if (allow_cluster && H <= kClusterSide && W <= kClusterSide) {
    const unsigned grid = static_cast<unsigned>(B) * kBands;
    if (conn == 4) {
      ccl_cluster<4><<<grid, kBandThreads, 0, s>>>(m, lab, H, W, background);
    } else {
      ccl_cluster<8><<<grid, kBandThreads, 0, s>>>(m, lab, H, W, background);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const Tiles g = make_tiles(H, W);
  const long long blocks = static_cast<long long>(B) * g.per_image;
  if (!scratch || blocks > INT_MAX || g.n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  auto* aux = static_cast<int*>(scratch);
  if (conn == 4) {
    ccl_local<4><<<grid, kTileThreads, 0, s>>>(m, false, lab, aux, g);
    ccl_merge<4><<<grid, kEdgeThreads, 0, s>>>(m, false, lab, g);
  } else {
    ccl_local<8><<<grid, kTileThreads, 0, s>>>(m, false, lab, aux, g);
    ccl_merge<8><<<grid, kEdgeThreads, 0, s>>>(m, false, lab, g);
  }
  flatten_labels<<<grid, kTileThreads, 0, s>>>(m, lab, background, g);
  return static_cast<int>(cudaGetLastError());
}
