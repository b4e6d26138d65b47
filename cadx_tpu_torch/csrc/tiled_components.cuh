// Tiled device code for connected components spread over the whole card:
// a block-based union-find CCL (Playne & Hawick, IEEE TPDS 2018; Allegretti,
// Bolelli & Grana, IEEE TPDS 2020), the per-image reductions it feeds, the
// selection and hole fill built on it, and the separable window pass of a
// 0/1 opening. cleaner_front.cu, largest_obj.cu and pectoral.cu launch
// these kernels.
//
// A batch of (B, H, W) planes is cut into kTile x kTile tiles, and the grid
// covers tiles x images in one flat dimension, so any B runs and at B = 1 a
// large image still fills every SM. Each phase is one launch; phases that
// need a whole image finished (the joins across tiles, the per-image keys)
// follow in the next launch on the same stream, so nothing waits on the
// host. Masks are uint8 planes; labels are int32 pixel indices within the
// image (any H * W below 2^31).
//
// The CCL runs in three launches:
//   ccl_local   a block labels its tile in shared memory (union-find with
//               atomicMin-linked roots), then writes each pixel the global
//               index of its tile root;
//   ccl_merge   one thread per pixel of a tile's bottom row and right
//               column joins it with its neighbours in the next tiles
//               (atomicMin on the roots in global memory);
//   ccl_flatten every pixel points at its root, and the block adds its
//               pixels to their roots' areas (one atomic per root a block)
//               or marks the roots that reach the image border.
// Every link goes from a larger root to a smaller index of the same
// component, so each root ends as its component's smallest raster index,
// whatever order the atomics run in: the labels, and everything chosen by
// them, are the same on every run.
//
// The launch plans that more than one source runs (the largest component,
// the hole fill and the opening) are host functions here too. Kernels and
// plans have internal linkage (static), so each source that includes this
// header holds its own instances.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace cadx_tiled {

constexpr int kTile = 32;                     // tile side in pixels
constexpr int kTileThreads = kTile * kTile;   // one thread a pixel of a tile
constexpr int kEdgeThreads = 2 * kTile;       // ccl_merge: bottom row, right column
constexpr int kCountSlots = 256;              // ccl_flatten's per-block root table

// Tiles of a (B, H, W) batch.
struct Tiles {
  int H, W, tiles_x, per_image;
  long long n;  // H * W
};

inline Tiles make_tiles(int H, int W) {
  const int tx = (W + kTile - 1) / kTile, ty = (H + kTile - 1) / kTile;
  return Tiles{H, W, tx, tx * ty, static_cast<long long>(H) * W};
}

// This block's tile: its image and its top-left pixel.
struct Tile {
  long long img;
  int y0, x0;
};

static __device__ __forceinline__ Tile this_tile(const Tiles& g) {
  const unsigned b = blockIdx.x, per = g.per_image, tx = g.tiles_x;  // 32-bit division
  const unsigned img = b / per, t = b - img * per, ty = t / tx;
  return Tile{img, static_cast<int>(ty) * kTile, static_cast<int>(t - ty * tx) * kTile};
}

// The pixel of thread threadIdx.x in a kTile x kTile block.
struct Pixel {
  int y, x, p;  // p = y * W + x, within the image
  bool inside;
};

static __device__ __forceinline__ Pixel tile_pixel(const Tiles& g, const Tile& t) {
  const int y = t.y0 + static_cast<int>(threadIdx.x) / kTile;
  const int x = t.x0 + static_cast<int>(threadIdx.x) % kTile;
  const bool inside = y < g.H && x < g.W;
  return Pixel{y, x, inside ? y * g.W + x : 0, inside};
}

// A pixel is foreground where its mask byte is nonzero, or zero when
// `inv` (the background components of a hole fill).
static __device__ __forceinline__ bool is_fg(const uint8_t* m, int p, bool inv) {
  return (m[p] != 0) != inv;
}

// ---- union-find ---------------------------------------------------------

static __device__ __forceinline__ int find_shared(volatile int* par, int a) {
  int b;
  while ((b = par[a]) != a) a = b;
  return a;
}

// Join the sets of a and b: the larger root is linked to the smaller one.
// A link that lost a race (the root was linked meanwhile) retries from the
// value it found.
static __device__ void unite_shared(int* par, int a, int b) {
  while (true) {
    a = find_shared(par, a);
    b = find_shared(par, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(par + b, a);
    if (old == b) return;
    b = old;
  }
}

// Labels in global memory change under other blocks' atomics during the
// merge, so they are read from L2 (__ldcg), never from a stale L1 line.
// Path halving with atomicMin: a pointer only ever moves to an ancestor.
static __device__ int find_global(int* lab, int a) {
  while (true) {
    const int b = __ldcg(lab + a);
    if (b == a) return a;
    const int c = __ldcg(lab + b);
    if (c == b) return b;
    atomicMin(lab + a, c);
    a = c;
  }
}

static __device__ void unite_global(int* lab, int a, int b) {
  while (true) {
    a = find_global(lab, a);
    b = find_global(lab, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(lab + b, a);
    if (old == b) return;
    b = old;
  }
}

// ---- per-block reductions -----------------------------------------------

// The block's largest v, maxed atomically into *dst. Every thread of the
// block calls it once a kernel.
static __device__ void block_max_into(unsigned long long* dst, unsigned long long v) {
  __shared__ unsigned long long warp_best[32];
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_best[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
      v = u > v ? u : v;
    }
    if (lane == 0 && v) atomicMax(dst, v);
  }
}

// Add each thread's pixel (root r >= 0; r < 0 counts nothing) to area[r]:
// a warp's pixels of one root are counted together (__match_any_sync), the
// warps' counts gathered in a shared table, and each root the block holds
// gets one global atomicAdd (a root the full table has no room for gets
// the warp's). Every thread of the block calls it.
static __device__ void block_count(int* area, int r) {
  __shared__ int keys[kCountSlots];
  __shared__ int counts[kCountSlots];
  for (int s = threadIdx.x; s < kCountSlots; s += blockDim.x) {
    keys[s] = -1;
    counts[s] = 0;
  }
  __syncthreads();
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  if (r >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    const int c = __popc(peers);
    int s = static_cast<int>((static_cast<unsigned>(r) * 2654435761u) >> 24);
    bool placed = false;
    for (int probe = 0; probe < kCountSlots; ++probe) {
      const int k = atomicCAS(keys + s, -1, r);
      if (k == -1 || k == r) {
        atomicAdd(counts + s, c);
        placed = true;
        break;
      }
      s = (s + 1) & (kCountSlots - 1);
    }
    if (!placed) atomicAdd(area + r, c);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < kCountSlots; s += blockDim.x)
    if (keys[s] >= 0) atomicAdd(area + keys[s], counts[s]);
}

// The key of a component: (area << 32) | ~label. The largest key has the
// largest area and, among equal areas, the smallest label.
static __device__ __forceinline__ unsigned long long component_key(int area, int label) {
  return (static_cast<unsigned long long>(area) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(label));
}

// The label a key names; -1 for the empty key 0 (no component).
static __device__ __forceinline__ int key_label(unsigned long long key) {
  return key ? static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull)) : -1;
}

// ---- the CCL's three launches ---------------------------------------------

// Label each tile in shared memory; lab[p] = the image index of p's tile
// root for a foreground p (background is left as it was). `aux` is zeroed at
// the tile roots, which include every final root, for ccl_flatten's counts
// or marks. kConn is 4 or 8.
//
// A warp is a tile row: a ballot gives each pixel its run's first pixel as
// its parent, with no atomics. Then only the first pixel of a run joins
// the runs above it, and a later pixel only the run up and to its right
// that the pixels before it cannot reach (4-connected: the run above it
// where the pixel to its left had none), so each pair of touching runs is
// joined about once and the trees stay shallow.
template <int kConn>
static __global__ void __launch_bounds__(kTileThreads)
ccl_local(const uint8_t* __restrict__ mask, bool inv, int* __restrict__ lab,
          int* __restrict__ aux, Tiles g) {
  __shared__ int par[kTileThreads];
  __shared__ unsigned rows[kTile];  // each row's foreground bits
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  const long long base = tile.img * g.n;
  const int t = threadIdx.x, lx = t % kTile, ly = t / kTile;
  const bool f = px.inside && is_fg(mask + base, px.p, inv);
  const unsigned bits = __ballot_sync(0xffffffffu, f);
  // the run's first pixel: one past the highest background bit at or below lx
  const unsigned below = ~bits & (lx == 31 ? 0xffffffffu : (2u << lx) - 1u);
  const int start = below ? 32 - __clz(below) : 0;
  par[t] = f ? ly * kTile + start : t;
  if (lx == 0) rows[ly] = bits;
  __syncthreads();
  if (f && ly > 0) {
    const unsigned up = rows[ly - 1];
    auto bit = [&](int x) { return x >= 0 && x < kTile && ((up >> x) & 1u); };
    const int above = t - kTile;
    if (kConn == 4) {
      if (bit(lx) && !(lx > start && bit(lx - 1))) unite_shared(par, t, above);
    } else if (lx == start) {
      // the first pixel: each run among up-left, up and up-right
      if (bit(lx - 1)) unite_shared(par, t, above - 1);
      if (bit(lx) && !bit(lx - 1)) unite_shared(par, t, above);
      if (bit(lx + 1) && !bit(lx)) unite_shared(par, t, above + 1);
    } else if (bit(lx + 1) && !bit(lx)) {
      unite_shared(par, t, above + 1);
    }
  }
  __syncthreads();
  if (!f) return;
  // a tile's raster order is the image's, so the tile root (the smallest
  // local index) is the smallest image index of its piece
  const int r = find_shared(par, t);
  lab[base + px.p] = (tile.y0 + r / kTile) * g.W + tile.x0 + r % kTile;
  if (r == t) aux[base + px.p] = 0;
}

// Join each tile with its neighbours: a bottom-row pixel with the three
// (4-connected: one) below it, a right-column pixel with the three (one) to
// its right. Every pair of neighbours in two tiles is one of these.
template <int kConn>
static __global__ void __launch_bounds__(kEdgeThreads)
ccl_merge(const uint8_t* __restrict__ mask, bool inv, int* lab, Tiles g) {
  const Tile tile = this_tile(g);
  const int i = threadIdx.x % kTile;
  const bool bottom = threadIdx.x < kTile;
  const int y = bottom ? tile.y0 + kTile - 1 : tile.y0 + i;
  const int x = bottom ? tile.x0 + i : tile.x0 + kTile - 1;
  if (y >= g.H || x >= g.W) return;
  const uint8_t* m = mask + tile.img * g.n;
  int* l = lab + tile.img * g.n;
  const int p = y * g.W + x;
  if (!is_fg(m, p, inv)) return;
  if (bottom) {
    if (y + 1 >= g.H) return;
    for (int dx = (kConn == 8 ? -1 : 0); dx <= (kConn == 8 ? 1 : 0); ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= g.W) continue;
      const int q = p + g.W + dx;
      if (is_fg(m, q, inv)) unite_global(l, p, q);
    }
  } else {
    if (x + 1 >= g.W) return;
    for (int dy = (kConn == 8 ? -1 : 0); dy <= (kConn == 8 ? 1 : 0); ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= g.H) continue;
      const int q = p + dy * g.W + 1;
      if (is_fg(m, q, inv)) unite_global(l, p, q);
    }
  }
}

// Point every foreground pixel at its root. kCount: add the pixels to
// their roots' areas in aux; otherwise mark in aux the roots of the
// components that reach the image border.
template <bool kCount>
static __global__ void __launch_bounds__(kTileThreads)
ccl_flatten(const uint8_t* __restrict__ mask, bool inv, int* lab, int* aux, Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  const long long base = tile.img * g.n;
  int* l = lab + base;
  int r = -1;
  if (px.inside && is_fg(mask + base, px.p, inv)) {
    r = find_global(l, px.p);
    l[px.p] = r;
  }
  if (kCount) {
    block_count(aux + base, r);
  } else if (r >= 0 && (px.y == 0 || px.y == g.H - 1 || px.x == 0 || px.x == g.W - 1)) {
    aux[base + r] = 1;
  }
}

// The largest component's key of each image into stats[img * stride + slot]
// (zeroed before): every root offers its (area, label) key.
static __global__ void __launch_bounds__(kTileThreads)
largest_key(const uint8_t* __restrict__ mask, bool inv, const int* __restrict__ lab,
            const int* __restrict__ area, unsigned long long* stats, int stride, int slot,
            Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  const long long base = tile.img * g.n;
  unsigned long long key = 0ull;
  if (px.inside && is_fg(mask + base, px.p, inv) && lab[base + px.p] == px.p)
    key = component_key(area[base + px.p], px.p);
  block_max_into(stats + tile.img * stride + slot, key);
}

// The CCL of mask (its zeros where inv) into lab, in three launches; kCount:
// component areas at the roots in aux, else border marks.
template <int kConn, bool kCount>
static void ccl(const uint8_t* mask, bool inv, int* lab, int* aux, const Tiles& g,
                unsigned grid, cudaStream_t s) {
  ccl_local<kConn><<<grid, kTileThreads, 0, s>>>(mask, inv, lab, aux, g);
  ccl_merge<kConn><<<grid, kEdgeThreads, 0, s>>>(mask, inv, lab, g);
  ccl_flatten<kCount><<<grid, kTileThreads, 0, s>>>(mask, inv, lab, aux, g);
}

// ---- selection, hole fill and the opening's window pass -----------------------

// dst = mask & (lab == the label of the key in stats[img * stride + slot])
static __global__ void __launch_bounds__(kTileThreads)
select_label(const uint8_t* __restrict__ mask, const int* __restrict__ lab,
             const unsigned long long* __restrict__ stats, int stride, int slot,
             uint8_t* __restrict__ dst, Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  if (!px.inside) return;
  const long long q = tile.img * g.n + px.p;
  dst[q] = mask[q] && lab[q] == key_label(stats[tile.img * stride + slot]);
}

// dst = m | holes, a hole being background whose 4-connected component
// (labelled in lab) is not marked as reaching the border. With raw, the
// image's max of raw where dst holds goes into stats[img * stride + slot].
static __global__ void __launch_bounds__(kTileThreads)
fill_unmarked(const uint8_t* __restrict__ m, const int* __restrict__ lab,
              const int* __restrict__ marks, uint8_t* __restrict__ dst,
              const uint8_t* __restrict__ raw, unsigned long long* stats, int stride,
              int slot, Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  const long long base = tile.img * g.n, q = base + px.p;
  bool v = false;
  if (px.inside) {
    v = m[q] || !marks[base + lab[q]];
    dst[q] = v;
  }
  if (raw) block_max_into(stats + tile.img * stride + slot, v ? raw[q] : 0u);
}

// One axis of a 0/1 erosion (kAnd) or dilation: dst = AND (OR) of src over
// the window [c - k/2, c + k - 1 - k/2] along y (kAlongY) or x, cut to the
// image (a window that leaves the image takes 1 for the erosion and 0 for
// the dilation there, so only its pixels inside count). A warp takes a
// kTile x kTile tile, lane l its l-th column, so every load and store of
// the warp is one run of 32 bytes. Along y a lane slides the window down its
// column, keeping the count of set pixels in it (two reads an output, not
// k); along x the warp goes row by row, turning the row's pixels around the
// tile into bit masks with ballots (k / 32 + 2 of them) and counting each
// lane's window with popcounts. With raw, the image's max of raw where dst
// holds goes into stats[img * stride + slot].
template <bool kAlongY, bool kAnd>
static __global__ void __launch_bounds__(kTile)
window_pass(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int k,
            const uint8_t* __restrict__ raw, unsigned long long* stats, int stride, int slot,
            Tiles g) {
  const Tile tile = this_tile(g);
  const int lo = k / 2, hi = k - 1 - lo;
  const int lane = static_cast<int>(threadIdx.x), x = tile.x0 + lane;
  const int y1 = min(tile.y0 + kTile, g.H);
  const long long base = tile.img * g.n;
  unsigned best = 0u;
  const auto put = [&](long long q, bool v) {
    dst[q] = v;
    if (raw && v) best = max(best, static_cast<unsigned>(raw[q]));
  };
  if (kAlongY) {
    if (x < g.W) {
      const uint8_t* s = src + base + x;
      int a = max(tile.y0 - lo, 0), b = min(tile.y0 + hi, g.H - 1), count = 0;
      for (int j = a; j <= b; ++j) count += s[static_cast<long long>(j) * g.W] != 0;
      for (int y = tile.y0; y < y1; ++y) {
        put(base + static_cast<long long>(y) * g.W + x, kAnd ? count == b - a + 1 : count > 0);
        if (y - lo >= 0) {  // pixel y - lo leaves the window of y + 1
          count -= s[static_cast<long long>(y - lo) * g.W] != 0;
          a = y - lo + 1;
        }
        if (y + 1 + hi < g.H) {  // pixel y + 1 + hi enters it
          count += s[static_cast<long long>(y + 1 + hi) * g.W] != 0;
          b = y + 1 + hi;
        }
      }
    }
  } else {
    // bit i of word w: pixel wbase + 32 w + i of the row; the words cover
    // every window of the tile, [x0 - lo, x0 + kTile - 1 + hi]
    const int wbase = tile.x0 - (lo + 31) / 32 * 32;
    const int words = (lo + 31) / 32 + 1 + (hi + 31) / 32;
    const int a = max(x - lo, 0), b = min(x + hi, g.W - 1);
    for (int y = tile.y0; y < y1; ++y) {
      const uint8_t* row = src + base + static_cast<long long>(y) * g.W;
      int count = 0;
      for (int w = 0; w < words; ++w) {
        const int p0 = wbase + 32 * w, xw = p0 + lane;
        const unsigned m = __ballot_sync(0xffffffffu, xw >= 0 && xw < g.W && row[xw] != 0);
        const int l0 = max(a - p0, 0), h0 = min(b - p0, 31);
        if (l0 <= h0)
          count += __popc(m & (h0 == 31 ? 0xffffffffu : (2u << h0) - 1u) & ~((1u << l0) - 1u));
      }
      if (x < g.W) put(base + static_cast<long long>(y) * g.W + x,
                       kAnd ? count == b - a + 1 : count > 0);
    }
  }
  if (raw) block_max_into(stats + tile.img * stride + slot, best);
}

// ---- launch plans shared by largest_obj.cu and pectoral.cu -----------------------

// What a plan launches on: the CCL's label and root planes, a uint64 key an
// image (zeroed before), the tiles and the stream.
struct Planes {
  int* lab;
  int* aux;
  unsigned long long* keys;
  Tiles g;
  unsigned grid;
  cudaStream_t s;
};

// dst = the largest kConn-connected component of src (the smallest label on
// ties; empty for an empty src): 5 launches.
template <int kConn>
static void select_largest(const uint8_t* src, uint8_t* dst, const Planes& p) {
  ccl<kConn, true>(src, false, p.lab, p.aux, p.g, p.grid, p.s);
  largest_key<<<p.grid, kTileThreads, 0, p.s>>>(src, false, p.lab, p.aux, p.keys, 1, 0, p.g);
  select_label<<<p.grid, kTileThreads, 0, p.s>>>(src, p.lab, p.keys, 1, 0, dst, p.g);
}

// dst = src with its holes filled: background whose 4-connected component
// reaches no border pixel: 4 launches.
static void fill_holes(const uint8_t* src, uint8_t* dst, const Planes& p) {
  ccl<4, false>(src, true, p.lab, p.aux, p.g, p.grid, p.s);
  fill_unmarked<<<p.grid, kTileThreads, 0, p.s>>>(src, p.lab, p.aux, dst, nullptr, nullptr, 0,
                                                   0, p.g);
}

// dst = the k x k opening of src (erode along y and x, then dilate along y
// and x, the window anchored at k / 2 and cut to the image): 4 launches;
// tmp is a scratch plane, and src is overwritten.
static void opening(uint8_t* src, uint8_t* tmp, uint8_t* dst, int k, const Planes& p) {
  window_pass<true, true><<<p.grid, kTile, 0, p.s>>>(src, tmp, k, nullptr, nullptr, 0,
                                                            0, p.g);
  window_pass<false, true><<<p.grid, kTile, 0, p.s>>>(tmp, src, k, nullptr, nullptr, 0,
                                                             0, p.g);
  window_pass<true, false><<<p.grid, kTile, 0, p.s>>>(src, tmp, k, nullptr, nullptr, 0,
                                                             0, p.g);
  window_pass<false, false><<<p.grid, kTile, 0, p.s>>>(tmp, dst, k, nullptr, nullptr, 0,
                                                              0, p.g);
}

}  // namespace cadx_tiled
