// The packed marker watershed relaxed a tile at a time, spread over the
// whole card: the relaxation that pectoral.cu runs on its uint8 equalized
// image and watershed.cu's packed form on the int32 rint of a float image
// (Q, the cost plane's type). pk holds (dist << 2) | label, labels 1..3 at
// distance 0 on the markers and kUnreachedPk elsewhere; a step between
// 4-neighbours of values a and b costs ((|a - b| * K + 1) << 2), K the next
// power of two >= H + W. That is what the JAX line scans add up
// (ops/geodesic_scan.py::axis_costs_packed), and an integer min-plus
// fixpoint is unique, so any relaxation order reaches the plain version's
// values.
//
// relax_to_fixpoint is one cooperative launch (relax_rounds): a persistent
// grid of co-resident blocks of one warp, each relaxing its 32 x 32 tiles
// (relax_one) to their local fixpoint in shared memory under a 1-pixel
// halo, in rounds separated by grid syncs, with dirty flags a tile in two
// parities, until a round marks no tile. The caller writes pk and the
// first round's dirty flags (a tile is dirty where it holds an unreached
// pixel: a tile of markers alone never changes) and zeroes the second
// parity and the rounds' changed flags. Nothing waits on the host. Kernels and the launcher have
// internal linkage, so each source that includes this header holds its own
// instances.
#pragma once

#include <cooperative_groups.h>

#include "tiled_components.cuh"

namespace cadx_tiled {

// (dist << 2) | label of a pixel no marker reaches; its label bits are 0
constexpr int kUnreachedPk = 1 << 30;

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

// One relaxation of tile b of the flat grid over tiles x images,
// kTile x kTile pixels, by a block of kTile threads (s and sq its shared
// regions): if the tile is dirty (dirty_in), copy its pk and q with a
// 1-pixel halo to shared memory, relax the tile to its fixpoint under that
// halo (passes alternate: a thread a row scanning left to right then back,
// then a thread a column down then up; a forward and a backward scan leave
// each line at its own fixpoint, so the tile is at its fixpoint once a pass
// after the first changes nothing), write back the
// pixels that fell, and mark dirty (dirty_out) each neighbour along an edge
// where a pixel fell, setting *changed. Values only fall and each stays a
// real path value, so a halo read while its tile is being written is an
// upper bound that the neighbour's mark corrects in the next round.
constexpr int kRegion = kTile + 2, kPitch = kTile + 3;  // pitch odd: no bank conflicts

template <typename Q>
static __device__ void relax_one(unsigned b, const Q* __restrict__ q, int* pk,
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
  constexpr int kBatch = 12, kSpan = (R + kT - 1) / kT;
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
  for (int pass = 0;; ++pass) {
    bool fell = false;
    if (pass & 1) {
      if (i < cols) {
        int* line = s + P + 1 + i;
        const int* ql = sq + P + 1 + i;
        fell |= scan<kT, false>(line, ql, P, rows, log_k);
        fell |= scan<kT, true>(line, ql, P, rows, log_k);
      }
    } else if (i < rows) {
      int* line = s + (i + 1) * P + 1;
      const int* ql = sq + (i + 1) * P + 1;
      fell |= scan<kT, false>(line, ql, 1, cols, log_k);
      fell |= scan<kT, true>(line, ql, 1, cols, log_k);
    }
    if (!__syncthreads_or(fell) && pass) break;
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
// block 0 two rounds ahead (changed[0] by the marker launch before it),
// so no block still reads a flag that is being zeroed. The rounds end with
// the first that marks no tile, their count written to *rounds. A round that
// marks a tile lowered a pixel, so H * W + 1 rounds bound any image; a
// count past that traps, a launch failure the next synchronising call
// reports.
template <typename Q>
static __global__ void __launch_bounds__(kTile)
relax_rounds(const Q* __restrict__ q, int* pk, uint8_t* dirty, int* changed, int* rounds,
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

// The watershed's one cooperative launch over the `tiles` tiles of g's
// images (B * g.per_image): as many blocks as the card holds at once
// (relax_rounds loops over the rest), at most one a tile. dirty holds two
// flags a tile (the first round's parity written, the other zeroed),
// changed three int32 (zeroed, like dirty, by the caller's marker launch,
// so no memset runs), rounds an int32 that receives the rounds run.
template <typename Q>
static cudaError_t relax_to_fixpoint(const Q* q, int* pk, uint8_t* dirty, int* changed,
                                     int* rounds, Tiles g, unsigned tiles, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(relax_rounds<Q>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, relax_rounds<Q>, kTile, 0);
  if (e != cudaSuccess) return e;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  int log_k = 0;
  while ((1 << log_k) < g.H + g.W) ++log_k;
  long long cap = g.n + 1;
  const unsigned resident = static_cast<unsigned>(per_sm) * static_cast<unsigned>(sms);
  const unsigned grid = tiles < resident ? tiles : resident;
  void* args[] = {&q, &pk, &dirty, &changed, &rounds, &g, &tiles, &log_k, &cap};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(relax_rounds<Q>), grid,
                                     kTile, args, 0, s);
}

}  // namespace cadx_tiled
