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
//                writes the packed markers and the watershed's first
//                dirty tiles;
//   3. watershed the packed (dist << 2) | label relaxation, a tile a block
//                (relax_one), in rounds until no tile is dirty, all in one
//                cooperative launch (relax_rounds) with grid syncs
//                between the rounds;
//   4. ridge     one launch writes the labels, the ridge and the breast
//                label off the ridge, then the opening's four window
//                passes write the mask.
// Nothing reads back to the host: the call returns as soon as the plan is
// queued.
#include <cooperative_groups.h>

#include "tiled_components.cuh"

namespace {

using namespace cadx_tiled;

// (dist << 2) | label of a pixel no marker reaches; its label bits are 0
constexpr int kUnreachedPk = 1 << 30;

// pk = the markers' packed labels at distance 0: 1 on the eroded object, 2
// outside the dilated one, 3 outside the breast (later ones win), else
// kUnreachedPk; and the watershed's first dirty flags: a tile is dirty if
// it holds an unreached pixel (a tile of markers alone never changes). The
// watershed relaxes the same kTile x kTile tiles, so a tile's flag is its
// block's.
__global__ void __launch_bounds__(kTileThreads)
write_markers(const uint8_t* __restrict__ eroded, const uint8_t* __restrict__ dilated,
              const uint8_t* __restrict__ breast, int* __restrict__ pk, uint8_t* dirty,
              Tiles g) {
  const Tile tile = this_tile(g);
  const Pixel px = tile_pixel(g, tile);
  bool open = false;
  if (px.inside) {
    const long long q = tile.img * g.n + px.p;
    int s = eroded[q] ? 1 : 0;
    if (!dilated[q]) s = 2;
    if (!breast[q]) s = 3;
    pk[q] = s ? s : kUnreachedPk;
    open = s == 0;
  }
  if (__syncthreads_or(open) && threadIdx.x == 0) dirty[blockIdx.x] = 1;
}

// The cost of a step between two neighbours of values a and b, packed:
// (|a - b| * K + 1) << 2, K = 1 << log_k.
static __device__ __forceinline__ int step_cost(int a, int b, int log_k) {
  return ((abs(a - b) << log_k) + 1) << 2;
}

// One directional scan of a line of a tile in shared memory: its pixels
// line[t * step], t < n (the rest of the kT lie outside the image), each
// relaxed from its predecessor in the scan, forward from line[-step] or
// backward from line[n * step]; returns whether a value fell. Unrolled
// over kT, so its loads are issued ahead of the chain of mins.
template <int kT, bool kBack>
static __device__ __forceinline__ bool scan(int* line, const int* ql, int step, int n,
                                            int log_k) {
  bool fell = false;
  int prev = line[(kBack ? kT : -1) * step], qp = ql[(kBack ? kT : -1) * step];
#pragma unroll
  for (int u = 0; u < kT; ++u) {
    const int t = kBack ? kT - 1 - u : u;
    const int qx = ql[t * step];
    int v = line[t * step];
    if (t < n) {
      const int cand = prev + step_cost(qx, qp, log_k);
      if (cand < v) {
        v = cand;
        line[t * step] = v;
        fell = true;
      }
    }
    prev = v;
    qp = qx;
  }
  return fell;
}

// One relaxation of tile b of the header's flat grid over tiles x images,
// kTile x kTile pixels, by a block of kTile threads (s and sq its shared
// regions): if the tile is dirty (dirty_in), copy its pk and q with a
// 1-pixel halo to shared memory, relax the tile to its fixpoint under that
// halo (a thread a row scanning left to right then back, then a thread a
// column down then up, until a round changes nothing), write back the
// pixels that fell, and mark dirty (dirty_out) each neighbour along an edge
// where a pixel fell, setting *changed. Values only fall and each stays a
// real path value, so a halo read while its tile is being written is an
// upper bound that the neighbour's mark corrects in the next round.
constexpr int kRegion = kTile + 2, kPitch = kTile + 3;  // pitch odd: no bank conflicts

static __device__ void relax_one(unsigned b, const uint8_t* __restrict__ q, int* pk,
                                 uint8_t* dirty_in, uint8_t* dirty_out, int* changed,
                                 const Tiles& g, int log_k, int* s, int* sq, int& edges) {
  constexpr int kT = kTile, R = kRegion, P = kPitch;
  if (!__ldcg(dirty_in + b)) return;
  const int H = g.H, W = g.W, tiles_x = g.tiles_x, tiles_y = g.per_image / g.tiles_x;
  const unsigned img = b / static_cast<unsigned>(g.per_image), t = b - img * g.per_image;
  const int ty = static_cast<int>(t) / tiles_x, tx = static_cast<int>(t) % tiles_x;
  const int y0 = ty * kT, x0 = tx * kT;
  const int rows = min(kT, H - y0), cols = min(kT, W - x0);
  const long long base = static_cast<long long>(img) * g.n;
  const int i = threadIdx.x;
  // the region kBatch rows at a time, every load of a batch in flight
  // before its stores
  constexpr int kBatch = 8, kSpan = (R + kT - 1) / kT;
#pragma unroll
  for (int r0 = 0; r0 < R; r0 += kBatch) {
    int pv[kBatch][kSpan], qv[kBatch][kSpan];
#pragma unroll
    for (int rr = 0; rr < kBatch; ++rr)
#pragma unroll
      for (int u = 0; u < kSpan; ++u) {
        const int y = y0 - 1 + r0 + rr, x = x0 - 1 + i + u * kT;
        const bool in = r0 + rr < R && i + u * kT < R && y >= 0 && y < H && x >= 0 && x < W;
        const long long gq = base + static_cast<long long>(y) * W + x;
        pv[rr][u] = in ? __ldcg(pk + gq) : kUnreachedPk;
        qv[rr][u] = in ? q[gq] : 0;
      }
#pragma unroll
    for (int rr = 0; rr < kBatch; ++rr)
#pragma unroll
      for (int u = 0; u < kSpan; ++u)
        if (r0 + rr < R && i + u * kT < R) {
          s[(r0 + rr) * P + i + u * kT] = pv[rr][u];
          sq[(r0 + rr) * P + i + u * kT] = qv[rr][u];
        }
  }
  if (i == 0) edges = 0;
  __syncthreads();
  // pixels of the tile outside the image stay kUnreachedPk and are never
  // relaxed; a source of kUnreachedPk relaxes nothing
  bool more = true;
  while (more) {
    bool fell = false;
    if (i < rows) {
      int* line = s + (i + 1) * P + 1;
      const int* ql = sq + (i + 1) * P + 1;
      fell |= scan<kT, false>(line, ql, 1, cols, log_k);
      fell |= scan<kT, true>(line, ql, 1, cols, log_k);
    }
    __syncthreads();
    if (i < cols) {
      int* line = s + P + 1 + i;
      const int* ql = sq + P + 1 + i;
      fell |= scan<kT, false>(line, ql, P, rows, log_k);
      fell |= scan<kT, true>(line, ql, P, rows, log_k);
    }
    more = __syncthreads_or(fell);
  }
  // write back what fell; note the edges it fell on (1 top, 2 bottom, 4
  // left, 8 right)
  int mine = 0;
  if (i < cols) {
    // every load before any store: the stores could alias later loads
    int orig[kT];
#pragma unroll
    for (int r = 0; r < kT; ++r)
      orig[r] = r < rows ? __ldcg(pk + base + static_cast<long long>(y0 + r) * W + x0 + i) : 0;
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      const int v = s[(r + 1) * P + 1 + i];
      if (r < rows && v < orig[r]) {
        pk[base + static_cast<long long>(y0 + r) * W + x0 + i] = v;
        mine |= (r == 0 ? 1 : 0) | (r == kT - 1 ? 2 : 0) | (i == 0 ? 4 : 0) |
                (i == kT - 1 ? 8 : 0);
      }
    }
  }
  if (mine) atomicOr(&edges, mine);
  // after this, the block's next tile may refill s: every read of it is done
  __syncthreads();
  if (i != 0) return;
  dirty_in[b] = 0;
  bool marked = false;
  const auto mark = [&](bool on, unsigned nb) {
    if (on) {
      dirty_out[nb] = 1;
      marked = true;
    }
  };
  mark((edges & 1) && ty > 0, b - tiles_x);
  mark((edges & 2) && ty < tiles_y - 1, b + tiles_x);
  mark((edges & 4) && tx > 0, b - 1);
  mark((edges & 8) && tx < tiles_x - 1, b + 1);
  if (marked) *changed = 1;
}

// The packed watershed to its fixpoint in one cooperative launch, so that
// the host never waits on it: a persistent grid of co-resident blocks, each
// relaxing tiles blockIdx.x, + gridDim.x, ... (relax_one) in rounds
// separated by grid syncs. Round r reads the dirty flags of parity r & 1
// and marks the other's; its changed flag is changed[r % 3], zeroed by
// block 0 two rounds ahead (changed[0] by the memset before the launch),
// so no block still reads a flag that is being zeroed. The rounds end with
// the first that marks no tile, their count written to *rounds. A round that
// marks a tile lowered a pixel, so H * W + 1 rounds bound any image; a
// count past that traps, a launch failure the next synchronising call
// reports.
__global__ void __launch_bounds__(kTile)
relax_rounds(const uint8_t* __restrict__ q, int* pk, uint8_t* dirty, int* changed, int* rounds,
             Tiles g, unsigned tiles, int log_k, long long cap) {
  // the image as int too: a byte store to shared memory could alias any
  // int load after it, which would keep the scans from loading ahead
  __shared__ int s[kRegion * kPitch], sq[kRegion * kPitch];
  __shared__ int edges;
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  long long r = 0;
  for (;; ++r) {
    uint8_t* in = dirty + static_cast<size_t>(r & 1) * tiles;
    uint8_t* out = dirty + static_cast<size_t>((r + 1) & 1) * tiles;
    int* flag = changed + r % 3;
    if (blockIdx.x == 0 && threadIdx.x == 0) changed[(r + 1) % 3] = 0;
    for (unsigned b = blockIdx.x; b < tiles; b += gridDim.x)
      relax_one(b, q, pk, in, out, flag, g, log_k, s, sq, edges);
    grid.sync();
    if (!__ldcg(flag)) break;
    if (r + 1 >= cap) __trap();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *rounds = static_cast<int>(r + 1);
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

// The watershed's one cooperative launch: as many blocks as the card holds
// at once (relax_rounds loops over the rest), at most one a tile.
cudaError_t watershed(const uint8_t* q, int* pk, uint8_t* dirty, int* changed, int* rounds,
                      const Planes& p, int log_k) {
  cudaError_t e = cudaFuncSetAttribute(relax_rounds,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, relax_rounds, kTile, 0);
  if (e != cudaSuccess) return e;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  Tiles g = p.g;
  unsigned tiles = p.grid;
  long long cap = g.n + 1;
  const unsigned resident = static_cast<unsigned>(per_sm) * static_cast<unsigned>(sms);
  const unsigned grid = tiles < resident ? tiles : resident;
  e = cudaMemsetAsync(changed, 0, 3 * sizeof(int), p.s);
  if (e != cudaSuccess) return e;
  void* args[] = {&q, &pk, &dirty, &changed, &rounds, &g, &tiles, &log_k, &cap};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(relax_rounds), grid, kTile,
                                     args, 0, p.s);
}

}  // namespace

// equ, bin, breast: (B, H, W) uint8 (bin and breast nonzero where set);
// labels: (B, H, W) int32; boundary, mask: (B, H, W) bytes 0/1; scratch:
// 8-byte aligned, kernels/pectoral.py::scratch_bytes; rounds: a device int32
// that receives the watershed's rounds, or null (then a slot of scratch
// does). steps: 1-4 runs the plan up to and including that step (the
// outputs are whole only at 4).
//
// Scratch: B uint64 keys, four int32 (the rounds' three changed flags and
// the rounds slot), two int32 planes (the CCL's labels and roots, then pk
// in the first), three byte planes and two dirty flags a tile.
extern "C" int cadx_pectoral_tail(const void* equ, const void* bin, const void* breast,
                                  void* labels, void* boundary, void* mask, void* scratch,
                                  void* rounds, int B, int H, int W, int morph_k, int n_morph,
                                  int sm_k, int steps, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (H > 512 || W > 512) return static_cast<int>(cudaErrorInvalidValue);
  const Tiles g = make_tiles(H, W);
  const long long blocks = static_cast<long long>(B) * g.per_image;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * g.n;
  auto* keys = static_cast<unsigned long long*>(scratch);
  int* changed = reinterpret_cast<int*>(keys + B);
  int* lab = changed + 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Planes p{lab, lab + n, keys, g, static_cast<unsigned>(blocks), s};
  uint8_t* a = reinterpret_cast<uint8_t*>(p.aux + n);
  uint8_t* obj = a + n;
  uint8_t* c = obj + n;
  uint8_t* dirty = c + n;

  // 1. the largest 8-connected object, holes filled -> obj
  cudaMemsetAsync(keys, 0, static_cast<size_t>(B) * sizeof(unsigned long long), s);
  select_largest<8>(static_cast<const uint8_t*>(bin), a, p);
  fill_holes(a, obj, p);
  if (steps <= 1) return static_cast<int>(cudaGetLastError());

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
  cudaMemsetAsync(dirty, 0, 2 * static_cast<size_t>(blocks), s);
  write_markers<<<grid, kTileThreads, 0, s>>>(c, obj, static_cast<const uint8_t*>(breast), pk,
                                              dirty, g);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess || steps <= 2)
    return static_cast<int>(e);

  // 3. the packed watershed to its fixpoint
  int log_k = 0;
  while ((1 << log_k) < H + W) ++log_k;
  int* rounds_at = rounds ? static_cast<int*>(rounds) : changed + 3;
  if (cudaError_t e = watershed(static_cast<const uint8_t*>(equ), pk, dirty, changed, rounds_at,
                                p, log_k);
      e != cudaSuccess || steps <= 3)
    return static_cast<int>(e);

  // 4. labels, the ridge and the kept breast label -> a; its opening -> mask
  write_ridge<<<grid, kTileThreads, 0, s>>>(pk, static_cast<int*>(labels),
                                            static_cast<uint8_t*>(boundary), a, g);
  opening(a, c, static_cast<uint8_t*>(mask), sm_k, p);
  return static_cast<int>(cudaGetLastError());
}
