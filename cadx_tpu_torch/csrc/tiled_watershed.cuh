// The packed marker watershed's sweeps spread over the whole card, as JAX
// runs them (cadx_tpu/ops/geodesic_scan.py::relax_to_fixpoint_packed):
// Gauss-Seidel sweeps until one changes nothing or max_iters ran, each
// sweep four directional passes (left to right, right to left, top to
// bottom, bottom to top), each pass a windowed min over max_scan. The
// relaxation that pectoral.cu runs on its uint8 equalized image and
// watershed.cu's packed form on the rint of a float image (Q, the cost
// plane's type). pk holds (dist << 2) | label, labels 1..3 at distance 0
// on the markers and kUnreachedPk elsewhere.
//
// A pass along a line of length L takes, at each pixel i, the min of
// t = pk - s (forward) or pk + s (backward) over the window i, i -/+ 1,
// ..., i -/+ (win - 1) of the pre-pass values, win = 1 + sum of the
// doubling steps below min(L, max_scan), with kUnreachedPk standing for
// every position outside the line (JAX's shift fill), and writes
// min(pk, w +/- s). s is the line's prefix sum of the packed step costs
// ((|dq| * K + 1) << 2, K the next power of two >= H + W; 0 at the line's
// start). The arithmetic is int32 and exact, so every order of the mins
// inside a pass gives JAX's values; only the pass structure must be
// JAX's, and it is: after sweep n the planes hold what JAX's hold after
// sweep n, unreached pixels lowered by the fill included.
//
// relax_capped is one cooperative launch (relax_sweeps): a persistent grid
// of co-resident blocks first writes the prefix sums srow and scol (a warp
// a row, a warp 32 columns), then runs the sweeps with a grid sync after
// each, reading the changed flag on the device: nothing waits on the host.
// Where both windows are at most 8 (max_scan <= 8), a sweep is one pass
// over 64 x 64 tiles (32 x 32 where there would be fewer 64 x 64 tiles than
// SMs): a block copies its tile of
// pk, srow and scol with a halo of win - 1 pixels, cut to the image, to
// shared memory, runs the four passes there (each leaving valid a region
// smaller by its halo on the side it reads from), and writes its own
// pixels to the other plane. Wider
// windows take the line form: each pass a warp a line, the line in shared
// memory, JAX's doubling mins there, a grid sync between passes. A sweep
// changed something iff some pass lowered a pixel (values only fall), which
// is what each block flags. The result ends in the first plane. Kernels and
// the launcher have internal linkage, so each source that includes this
// header holds its own instances.
#pragma once

#include <cooperative_groups.h>

#include "tiled_components.cuh"

namespace cadx_tiled {

// (dist << 2) | label of a pixel no marker reaches; its label bits are 0
constexpr int kUnreachedPk = 1 << 30;

constexpr int kSweepHalo = 7;        // the widest halo (window 8: max_scan <= 8)
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kSweepSeg = 16;        // outputs a lane walks along a line
constexpr int kLineMax = 512;        // the longest line (sides <= 512)
// a line form's shared memory: two buffers a warp
constexpr size_t kLineSweepSmem = 2 * sizeof(int) * kLineMax * kSweepWarps;

// A tiled sweep's tile of kT x kT pixels: its region with the widest halo,
// the region's pitch (odd: no bank conflicts), and its shared memory (pk
// twice, the passes ping-ponging, srow and scol).
template <int kT>
struct SweepTile {
  static constexpr int R = kT + 2 * kSweepHalo, P = R | 1;
  static constexpr size_t smem = 4 * sizeof(int) * R * P;
};

struct SweepGeom {
  int B, H, W, log_k;
  int tiles_x, per_image;
  unsigned tiles;
  long long n;          // H * W
  int win_row, win_col;  // the windows along rows and along columns
  int tiled;
};

static __device__ __forceinline__ int cost_value(uint8_t v) { return v; }
static __device__ __forceinline__ int cost_value(float v) {
  return static_cast<int>(rintf(v));
}

// srow and scol: inclusive prefix sums of the packed step costs along each
// row and each column of q, 0 at the line's first pixel. A warp takes a
// row, its (at most kLineMax / 32) loads all in flight before the scans;
// a warp takes 32 columns, a lane a column, 32 rows of loads in flight at
// a time.
template <typename Q>
static __device__ void prefix_costs(const Q* __restrict__ q, int* srow, int* scol,
                                    const SweepGeom& g) {
  constexpr int kChunks = kLineMax / 32, kRows = 32;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int H = g.H, W = g.W;
  for (long long r = warp; r < static_cast<long long>(g.B) * H; r += warps) {
    const long long base = r * W;
    int v[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int x = j * 32 + lane;
      v[j] = x < W ? cost_value(q[base + x]) : 0;
    }
    int carry = 0, last = 0;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (j * 32 >= W) break;
      const int x = j * 32 + lane;
      int left = __shfl_up_sync(0xffffffffu, v[j], 1);
      if (lane == 0) left = last;
      int c = x > 0 && x < W ? (abs(v[j] - left) << g.log_k) + 1 : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, c, d);
        if (lane >= d) c += t;
      }
      c += carry;
      if (x < W) srow[base + x] = c << 2;
      carry = __shfl_sync(0xffffffffu, c, 31);
      last = __shfl_sync(0xffffffffu, v[j], 31);
    }
  }
  const int groups = (W + 31) / 32;
  for (long long gi = warp; gi < static_cast<long long>(g.B) * groups; gi += warps) {
    const long long img = gi / groups;
    const int x = static_cast<int>(gi % groups) * 32 + lane;
    if (x >= W) continue;
    const long long base = img * g.n + x;
    int acc = 0, prev = cost_value(q[base]);
    scol[base] = 0;
    for (int y0 = 1; y0 < H; y0 += kRows) {
      int v[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        v[u] = y0 + u < H ? cost_value(q[base + static_cast<long long>(y0 + u) * W]) : 0;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (y0 + u >= H) break;
        acc += (abs(v[u] - prev) << g.log_k) + 1;
        scol[base + static_cast<long long>(y0 + u) * W] = acc << 2;
        prev = v[u];
      }
    }
  }
}

// One lane's walk along a line of a pass on a tile's region: outputs at
// positions [o, o + kSweepSeg) below o1, from a[] and s[] at pitch P
// (kAlongY: the line is a column), into out at out_pitch. The walk starts
// kSweepHalo positions early to fill the doubling mins of windows 2, 4
// and 8 (levels 1-3 of them taken); positions outside [0, len) stand for
// kUnreachedPk. Returns whether an own pixel ([own0, own1) of an own
// line) fell.
template <bool kAlongY, bool kReverse>
static __device__ __forceinline__ bool sweep_walk(const int* __restrict__ a,
                                                  const int* __restrict__ s,
                                                  int* __restrict__ out, int P, int out_pitch, int line, int o, int o1,
                                                  int len, int levels, bool own_line, int own0,
                                                  int own1) {
  const int step = kAlongY ? P : 1, base = kAlongY ? line : line * P;
  const int ostep = kAlongY ? out_pitch : 1, obase = kAlongY ? line : line * out_pitch;
  const int first = kReverse ? o + kSweepSeg - 1 + kSweepHalo : o - kSweepHalo;
  int h0 = kUnreachedPk;
  int h1[2] = {kUnreachedPk, kUnreachedPk};
  int h2[4] = {kUnreachedPk, kUnreachedPk, kUnreachedPk, kUnreachedPk};
  bool fell = false;
#pragma unroll
  for (int k = 0; k < kSweepHalo + kSweepSeg; ++k) {
    const int pos = kReverse ? first - k : first + k;
    int x = kUnreachedPk, pv = kUnreachedPk, sv = 0;
    if (pos >= 0 && pos < len) {
      pv = a[base + pos * step];
      sv = s[base + pos * step];
      x = kReverse ? pv + sv : pv - sv;
    }
    const int a1 = levels >= 1 ? min(x, h0) : x;
    const int a2 = levels >= 2 ? min(a1, h1[1]) : a1;
    const int w = levels >= 3 ? min(a2, h2[3]) : a2;
    h0 = x;
    h1[1] = h1[0];
    h1[0] = a1;
    h2[3] = h2[2];
    h2[2] = h2[1];
    h2[1] = h2[0];
    h2[0] = a2;
    if (k < kSweepHalo || pos >= o1) continue;
    const int nv = min(pv, kReverse ? w - sv : w + sv);
    fell |= own_line && pos >= own0 && pos < own1 && nv < pv;
    out[obase + pos * ostep] = nv;
  }
  return fell;
}

// One pass over lines [p0, p1) of the region, outputs [o0, o1) of each: a
// warp 32 lines (a lane a line) by kSweepSeg outputs an item.
template <bool kAlongY, bool kReverse>
static __device__ bool sweep_pass(const int* a, const int* s, int* out, int P, int out_pitch,
                                  int p0, int p1, int o0, int o1, int len, int levels, int l0,
                                  int l1, int own0, int own1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (p1 - p0 + 31) >> 5, segs = (o1 - o0 + kSweepSeg - 1) / kSweepSeg;
  bool fell = false;
  for (int item = warp; item < groups * segs; item += kSweepWarps) {
    const int line = p0 + (item % groups) * 32 + lane;
    if (line >= p1) continue;
    const int o = o0 + (item / groups) * kSweepSeg;
    fell |= sweep_walk<kAlongY, kReverse>(a, s, out, P, out_pitch, line, o, o1, len, levels,
                                          line >= l0 && line < l1, own0, own1);
  }
  return fell;
}

static __device__ __forceinline__ int levels_of(int win) { return __ffs(win) - 1; }

// One sweep of tile t (of the flat tiles x images): pk_in -> pk_out at the
// tile's pixels. The region is the tile and a halo of hr = win_row - 1
// columns and hc = win_col - 1 rows on each side, cut to the image. Left
// to right is needed at the region's columns from the tile's first on,
// right to left at the tile's columns, top to bottom at the tile's columns
// from its first row on, bottom to top at the tile's pixels, written to
// global memory. Returns whether a pixel of the tile fell (the same value
// on every thread of the block).
template <int kT>
static __device__ bool sweep_tile(unsigned t, const int* pk_in, int* pk_out, const int* srow,
                                  const int* scol, const SweepGeom& g, int* sm) {
  constexpr int P = SweepTile<kT>::P, R = SweepTile<kT>::R;
  const int H = g.H, W = g.W;
  const unsigned img = t / static_cast<unsigned>(g.per_image);
  const int tt = static_cast<int>(t - img * g.per_image);
  const int y0 = tt / g.tiles_x * kT, x0 = tt % g.tiles_x * kT;
  const int hr = g.win_row - 1, hc = g.win_col - 1;
  const int ry0 = max(y0 - hc, 0), rx0 = max(x0 - hr, 0);
  const int RH = min(y0 + kT + hc, H) - ry0, RW = min(x0 + kT + hr, W) - rx0;
  const int oy0 = y0 - ry0, oy1 = min(y0 + kT, H) - ry0;
  const int ox0 = x0 - rx0, ox1 = min(x0 + kT, W) - rx0;
  int* A = sm;
  int* Bf = A + R * P;
  int* SR = Bf + R * P;
  int* SC = SR + R * P;
  const long long base = img * g.n + static_cast<long long>(ry0) * W + rx0;
  // the region kLoadBatch elements a thread at a time, every load of a
  // batch in flight before its stores
  constexpr int kLoadBatch = 8;
  const int n_el = RH * RW;
  for (int i0 = 0; i0 < n_el; i0 += kSweepThreads * kLoadBatch) {
    int at[kLoadBatch], pv[kLoadBatch], sr[kLoadBatch], sc[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kSweepThreads + static_cast<int>(threadIdx.x);
      at[u] = -1;
      if (i < n_el) {
        const int r = i / RW, c = i - r * RW;
        const long long q = base + static_cast<long long>(r) * W + c;
        const bool own = c >= ox0 && c < ox1;
        at[u] = (r * P + c) | (own ? 1 << 30 : 0);
        pv[u] = __ldcg(pk_in + q);
        sr[u] = __ldcg(srow + q);
        sc[u] = own ? __ldcg(scol + q) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      if (at[u] < 0) continue;
      const int k = at[u] & ((1 << 30) - 1);
      A[k] = pv[u];
      SR[k] = sr[u];
      if (at[u] >> 30) SC[k] = sc[u];
    }
  }
  __syncthreads();
  const int lr = levels_of(g.win_row), lc = levels_of(g.win_col);
  bool fell = sweep_pass<false, false>(A, SR, Bf, P, P, 0, RH, ox0, RW, RW, lr, oy0, oy1, ox0,
                                       ox1);
  __syncthreads();
  fell |= sweep_pass<false, true>(Bf, SR, A, P, P, 0, RH, ox0, ox1, RW, lr, oy0, oy1, ox0, ox1);
  __syncthreads();
  fell |= sweep_pass<true, false>(A, SC, Bf, P, P, ox0, ox1, oy0, RH, RH, lc, ox0, ox1, oy0,
                                  oy1);
  __syncthreads();
  fell |= sweep_pass<true, true>(Bf, SC, pk_out + base, P, W, ox0, ox1, oy0, oy1, RH, lc, ox0,
                                 ox1, oy0, oy1);
  // the block's next tile refills the region: every read of it is done
  return __syncthreads_or(fell);
}

// One pass of the line form: a warp a line of every image, the line's t
// in shared memory (buf, two kLineMax buffers of this warp), JAX's
// doubling mins t = min(t, shift(t, k)) for k = 1, 2, 4, ... below n, the
// positions shifted in from outside the line kUnreachedPk; then pk_out =
// min(pk_in, t -/+ s). Returns whether a value fell.
static __device__ bool line_pass(const int* pk_in, int* pk_out, const int* s, const SweepGeom& g,
                                 bool rows, bool reverse, int n, int* buf) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int L = rows ? g.W : g.H, lines = rows ? g.H : g.W, stride = rows ? 1 : g.W;
  bool fell = false;
  for (long long li = warp; li < static_cast<long long>(g.B) * lines; li += warps) {
    const long long img = li / lines;
    const int l = static_cast<int>(li - img * lines);
    const long long base = img * g.n + (rows ? static_cast<long long>(l) * g.W : l);
    int* cur = buf;
    int* nxt = buf + kLineMax;
    for (int i = lane; i < L; i += 32) {
      const long long q = base + static_cast<long long>(i) * stride;
      const int pv = __ldcg(pk_in + q), sv = __ldcg(s + q);
      cur[i] = reverse ? pv + sv : pv - sv;
    }
    __syncwarp();
    for (int k = 1; k < n; k <<= 1) {
      for (int i = lane; i < L; i += 32) {
        const int j = reverse ? i + k : i - k;
        nxt[i] = min(cur[i], j >= 0 && j < L ? cur[j] : kUnreachedPk);
      }
      __syncwarp();
      int* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    for (int i = lane; i < L; i += 32) {
      const long long q = base + static_cast<long long>(i) * stride;
      const int pv = __ldcg(pk_in + q), sv = __ldcg(s + q);
      const int nv = min(pv, reverse ? cur[i] - sv : cur[i] + sv);
      fell |= nv < pv;
      pk_out[q] = nv;
    }
    __syncwarp();
  }
  return fell;
}

// Whether tile t or one of its 8 neighbours (a region's halo reaches no
// further) had a pixel fall in the last sweep: `fell` holds a flag a tile.
// Threads 0-8 read one flag each; the block's barrier ORs them, so every
// thread gets the same answer.
static __device__ bool region_fell(const uint8_t* fell, unsigned t, const SweepGeom& g) {
  bool mine = false;
  if (threadIdx.x < 9) {
    const unsigned img = t / static_cast<unsigned>(g.per_image);
    const int tt = static_cast<int>(t - img * g.per_image);
    const int y = tt / g.tiles_x + static_cast<int>(threadIdx.x) / 3 - 1;
    const int x = tt % g.tiles_x + static_cast<int>(threadIdx.x) % 3 - 1;
    if (y >= 0 && y < g.per_image / g.tiles_x && x >= 0 && x < g.tiles_x)
      mine = __ldcg(fell + img * g.per_image + y * g.tiles_x + x) != 0;
  }
  return __syncthreads_or(mine);
}

// The sweeps in one cooperative launch: the prefix sums, then sweeps with
// a grid sync after each until one changes nothing or max_iters ran, the
// count written to *sweeps. Sweep r flags changed[r % 3], zeroed by block 0
// in sweep r - 1 (changed[0] by the marker launch before this one), so no
// block still reads a flag that is being zeroed. Tiled sweeps ping-pong
// pk0 and pk1 and the result is copied back to pk0 after an odd count;
// the line form's four passes a sweep end in pk0.
//
// A tiled sweep skips a tile whose region no pixel fell in during the
// previous sweep: a sweep's output on a tile is a function of the input on
// its region alone, so with that input unchanged the output is the tile's
// current values, which the output plane already holds (it held the
// previous sweep's input, equal to them since the tile itself did not
// change). Sweep r reads the tiles' flags of parity (r + 1) & 1 and writes
// those of parity r & 1 (tile_fell, two bytes a tile); sweep 0 runs every
// tile.
template <typename Q, int kT>
static __global__ void __launch_bounds__(kSweepThreads)
relax_sweeps(const Q* __restrict__ q, int* pk0, int* pk1, int* srow, int* scol, int* changed,
             uint8_t* tile_fell, int* sweeps, SweepGeom g, int max_iters, int n_row,
             int n_col) {
  extern __shared__ int sm[];
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  prefix_costs(q, srow, scol, g);
  grid.sync();
  int* planes[2] = {pk0, pk1};
  int r = 0;
  while (r < max_iters) {
    int* flag = changed + r % 3;
    if (blockIdx.x == 0 && threadIdx.x == 0) changed[(r + 1) % 3] = 0;
    bool fell = false;
    if (g.tiled) {
      const uint8_t* before = tile_fell + static_cast<size_t>((r + 1) & 1) * g.tiles;
      uint8_t* now = tile_fell + static_cast<size_t>(r & 1) * g.tiles;
      for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const bool f = (r == 0 || region_fell(before, t, g)) &&
                       sweep_tile<kT>(t, planes[r & 1], planes[(r + 1) & 1], srow, scol, g, sm);
        if (threadIdx.x == 0) now[t] = f;
        fell |= f;
      }
    } else {
      int* buf = sm + (threadIdx.x >> 5) * 2 * kLineMax;
      for (int p = 0; p < 4; ++p) {
        const bool rows = p < 2;
        fell |= line_pass(planes[p & 1], planes[(p + 1) & 1], rows ? srow : scol, g, rows,
                          p & 1, rows ? n_row : n_col, buf);
        if (p < 3) grid.sync();
      }
    }
    if (__syncthreads_or(fell) && threadIdx.x == 0) *flag = 1;
    grid.sync();
    ++r;
    if (!__ldcg(flag)) break;
  }
  if (g.tiled && (r & 1)) {
    const long long total = static_cast<long long>(g.B) * g.n;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += static_cast<long long>(gridDim.x) * blockDim.x)
      pk0[i] = __ldcg(pk1 + i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *sweeps = r;
}

// The window of a pass along lines of `len` at max_scan: 1 + the doubling
// steps 1, 2, 4, ... below min(len, max_scan).
static int scan_window(int len, int max_scan) {
  const int n = len < max_scan ? len : max_scan;
  int win = 1;
  for (int k = 1; k < n; k <<= 1) win += k;
  return win;
}

// The tiles the sweeps' flags are kept for: B images' 32 x 32 tiles (more
// than the 64 x 64 tiles' count); tile_fell is twice as many bytes.
static long long sweep_scratch_tiles(int B, int H, int W) {
  return static_cast<long long>(B) * ((H + 31) / 32) * ((W + 31) / 32);
}

// relax_sweeps<Q, kT>'s co-resident blocks at `smem` bytes of dynamic
// shared memory.
template <typename Q, int kT>
static cudaError_t resident_blocks(size_t smem, unsigned* resident) {
  cudaError_t e = cudaFuncSetAttribute(relax_sweeps<Q, kT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, relax_sweeps<Q, kT>,
                                                      kSweepThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  *resident = static_cast<unsigned>(per_sm) * static_cast<unsigned>(sms);
  return cudaSuccess;
}

template <int kT>
static unsigned long long tiles_of(SweepGeom& g) {
  g.tiles_x = (g.W + kT - 1) / kT;
  g.per_image = g.tiles_x * ((g.H + kT - 1) / kT);
  return static_cast<unsigned long long>(g.B) * g.per_image;
}

template <typename Q, int kT>
static cudaError_t launch_sweeps(const Q* q, int* pk0, int* pk1, int* srow, int* scol,
                                 int* changed, uint8_t* tile_fell, int* sweeps, SweepGeom g,
                                 int max_iters, int n_row, int n_col, cudaStream_t s) {
  const unsigned long long tiles = tiles_of<kT>(g);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  g.tiles = static_cast<unsigned>(tiles);
  const size_t smem = g.tiled ? SweepTile<kT>::smem : kLineSweepSmem;
  unsigned resident = 0;
  if (cudaError_t e = resident_blocks<Q, kT>(smem, &resident); e != cudaSuccess) return e;
  const unsigned grid = g.tiled && g.tiles < resident ? g.tiles : resident;
  void* args[] = {&q,     &pk0, &pk1,       &srow,  &scol, &changed,
                  &tile_fell, &sweeps, &g, &max_iters, &n_row, &n_col};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(relax_sweeps<Q, kT>), grid,
                                     kSweepThreads, args, smem, s);
}

// The sweeps' one cooperative launch over B images of H x W (sides <= 512):
// pk0 holds the packed markers and receives the result, pk1, srow and
// scol are scratch planes, changed three int32 of which the caller zeroed
// the first, tile_fell two bytes a 32 x 32 tile (sweep_scratch_tiles),
// sweeps an int32 that receives the sweeps run. As many blocks
// as the card holds at once (a tiled sweep at most one a tile); 64 x 64
// tiles where there are at least as many as SMs, else 32 x 32 (an A/B of
// both at the paths' shapes chose that rule).
template <typename Q>
static cudaError_t relax_capped(const Q* q, int* pk0, int* pk1, int* srow, int* scol,
                                int* changed, uint8_t* tile_fell, int* sweeps, int B, int H,
                                int W, int max_iters, int max_scan, cudaStream_t s) {
  if (H > kLineMax || W > kLineMax) return cudaErrorInvalidValue;
  SweepGeom g{};
  g.B = B;
  g.H = H;
  g.W = W;
  while ((1 << g.log_k) < H + W) ++g.log_k;
  g.n = static_cast<long long>(H) * W;
  g.win_row = scan_window(W, max_scan);
  g.win_col = scan_window(H, max_scan);
  g.tiled = g.win_row <= kSweepHalo + 1 && g.win_col <= kSweepHalo + 1;
  const int n_row = W < max_scan ? W : max_scan, n_col = H < max_scan ? H : max_scan;
  bool wide = false;
  if (g.tiled) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    SweepGeom probe = g;
    wide = tiles_of<64>(probe) >= static_cast<unsigned long long>(sms);
  }
  return wide ? launch_sweeps<Q, 64>(q, pk0, pk1, srow, scol, changed, tile_fell, sweeps, g,
                                     max_iters, n_row, n_col, s)
              : launch_sweeps<Q, 32>(q, pk0, pk1, srow, scol, changed, tile_fell, sweeps, g,
                                     max_iters, n_row, n_col, s);
}

}  // namespace cadx_tiled
