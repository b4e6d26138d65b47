// Geodesic marker watershed in its two forms, plus the ridge boundary.
// Replaces cadx_tpu/kernels/watershed_kernel.py::marker_watershed_pallas;
// see cadx_tpu_torch/kernels/watershed.py for the layouts and their bounds.
//
// Pair form: float32 distance and int32 label planes, relaxed by sweeps of
// four directional passes (LR, RL, TB, BT) that repeat the plain version's
// arithmetic op for op (the float fixpoint depends on it). A sweep is one
// launch over 2-D tiles: a block loads its tile and a halo of win - 1
// pixels on every side into shared memory, runs the four passes there and
// writes its own pixels back. Windows too wide for a halo tile take one
// launch a pass instead. No sweep waits on the host: a sweep whose
// predecessor changed no distance returns at once, and the host reads the
// per-sweep flags once every check_every sweeps; the tiled sweeps are
// programmatic dependent launches, so a sweep's blocks copy the costs
// while the sweep before it ends.
//
// Packed form: three launches over the images, none of which waits on the
// host: a prologue writes the packed markers; tiled_watershed.cuh's
// relax_capped runs JAX's sweeps (the prefix sums, then sweeps over 64 x 64
// tiles, or a warp a line where the window is wider than 8) until one
// changes nothing or max_iters ran, in one cooperative launch; an epilogue
// writes the labels and the ridge.
#include <cmath>

#include "tiled_watershed.cuh"

namespace {

constexpr float kBig = 1e30f;
constexpr float kEdgeEps = 1e-3f;
constexpr int kLineThreads = 256;
// per-pixel kernels: a block of kPixX x kPixY pixels, images along the grid's z
constexpr int kPixX = 32, kPixY = 8;
// images a launch: the grids' z (and cost_cumsum's y) extent
constexpr int kMaxImages = 65535;
// the widest halo of the tiled sweep (win <= 8: max_scan <= 8)
constexpr int kMaxHalo = 7;

dim3 pixel_grid(int B, int H, int W) {
  return dim3((W + kPixX - 1) / kPixX, (H + kPixY - 1) / kPixY, B);
}

// Prefix sums of the step costs |dI| + 1e-3 along one line per block (rows
// for axis 1, columns for axis 0; the image along the grid's y), in the
// Hillis-Steele order of geodesic_scan.doubling_cumsum: x[i] += x[i - k]
// for k = 1, 2, 4, ... over the whole line. Two shared buffers of the
// line's length, ping-pong.
__global__ void cost_cumsum_kernel(const float* img, float* s, int H, int W, int axis) {
  extern __shared__ float buf[];
  const int len = axis ? W : H;
  const int stride = axis ? 1 : W;
  const size_t first = static_cast<size_t>(blockIdx.y) * H * W +
                       (axis ? static_cast<size_t>(blockIdx.x) * W : blockIdx.x);
  img += first;
  s += first;
  float* a = buf;
  float* c = buf + len;
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    a[i] = i == 0 ? 0.f : fabsf(img[i * stride] - img[(i - 1) * stride]) + kEdgeEps;
  __syncthreads();
  for (int k = 1; k < len; k *= 2) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) c[i] = a[i] + (i >= k ? a[i - k] : 0.f);
    __syncthreads();
    float* t = a;
    a = c;
    c = t;
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) s[i * stride] = a[i];
}

// d = 0 on the markers, kBig elsewhere; l = the markers
__global__ void init_pair_kernel(const int* markers, float* d, int* l, int H, int W) {
  const int x = blockIdx.x * kPixX + threadIdx.x, y = blockIdx.y * kPixY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t q = static_cast<size_t>(blockIdx.z) * H * W + y * W + x;
  const int m = markers[q];
  d[q] = m > 0 ? 0.f : kBig;
  l[q] = m;
}

// ---- the tiled sweep ----------------------------------------------------------

// A pixel's candidate in a window min: its value d -/+ s and its label.
struct Cand {
  float v;
  int l;
};

// One step of the doubling min, nearest first: the far candidate only where
// it is strictly smaller.
static __device__ __forceinline__ Cand nearest_min(const Cand& near, const Cand& far) {
  return far.v < near.v ? far : near;
}

static __device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// A kTH x kTW tile and its halo, relaxed by kThreads threads (kMinBlocks
// blocks an SM asked of the compiler), each thread walking kSeg pixels of
// one line a pass.
template <int kTH, int kTW, int kThreads, int kMinBlocks, int kSeg>
struct TileShape {
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSegment = kSeg;
  // a pass's items (32 lines x kSeg pixels) at the widest halo, over the warps
  static constexpr int kRowItems = (kTH + 2 * kMaxHalo + 31) / 32 *
                                   ((kTW + kMaxHalo + kSeg - 1) / kSeg);
  static constexpr int kColItems = (kTW + 31) / 32 * ((kTH + kMaxHalo + kSeg - 1) / kSeg);
  static constexpr int kItems =
      ((kRowItems > kColItems ? kRowItems : kColItems) + kWarps - 1) / kWarps;
};

// The region's pitch in shared memory: odd, so that the 32 lines a warp
// walks along rows fall in 32 banks.
static __host__ __device__ __forceinline__ int region_pitch(int tw, int hr) {
  return (tw + 2 * hr) | 1;
}

// A thread's walk along one line of a pass (see tile_pass) over kSeg
// outputs from o, the first kMaxHalo pixels of the walk filling the
// doubling steps. Outputs that no other walk reads are written at once (to
// the global planes where kLast); the kMaxHalo the neighbouring walk reads
// before them go to held_d, held_l. kChecked: positions outside [0, len)
// may occur (nothing is taken from them), and the window may be narrower
// than 8 (levels < 3). Returns whether a distance fell.
template <int kSeg, bool kAlongY, bool kReverse, bool kLast, bool kChecked>
__device__ __forceinline__ bool walk(float2* dl, const float* s, int P, int line, int o, int o1,
                                     int len, int levels, float* held_d, int* held_l, float* gd,
                                     int* gl, int g0, int W) {
  const Cand none{INFINITY, 0};
  const int step = kAlongY ? P : 1;
  const int base = kAlongY ? line : line * P;
  const int first = kReverse ? o + kSeg - 1 + kMaxHalo : o - kMaxHalo;
  Cand h0 = none, h1[2] = {none, none}, h2[4] = {none, none, none, none};
  bool fell = false;
#pragma unroll
  for (int k = 0; k < kMaxHalo + kSeg; ++k) {
    const int pos = kReverse ? first - k : first + k;
    const int i = base + pos * step;
    Cand x = none;
    float dp = 0.f, sp = 0.f;
    if (!kChecked || (pos >= 0 && pos < len)) {
      const float2 e = dl[i];
      dp = e.x;
      sp = s[i];
      x = Cand{kReverse ? dp + sp : dp - sp, __float_as_int(e.y)};
    }
    // windows of 2, 4, 8: the doubling steps 1, 2, 4
    const Cand a1 = !kChecked || levels >= 1 ? nearest_min(x, h0) : x;
    const Cand a2 = !kChecked || levels >= 2 ? nearest_min(a1, h1[1]) : a1;
    const Cand w = !kChecked || levels >= 3 ? nearest_min(a2, h2[3]) : a2;
    h0 = x;
    h1[1] = h1[0];
    h1[0] = a1;
    h2[3] = h2[2];
    h2[2] = h2[1];
    h2[1] = h2[0];
    h2[0] = a2;
    const int m = k - kMaxHalo;  // the output's index in the walk
    if (m < 0 || pos >= o1) continue;
    const float cand = kReverse ? w.v - sp : w.v + sp;
    const bool take = cand < dp;
    const float dn = take ? cand : dp;
    const int ln = take ? w.l : x.l;
    fell |= take;
    if (kLast) {
      const int q = g0 + (kAlongY ? pos * W + line : line * W + pos);
      gd[q] = dn;
      gl[q] = ln;
    } else if (m < kSeg - kMaxHalo) {
      dl[i] = make_float2(dn, __int_as_float(ln));
    } else {
      held_d[m - (kSeg - kMaxHalo)] = dn;
      held_l[m - (kSeg - kMaxHalo)] = ln;
    }
  }
  return fell;
}

// One directional pass on the region's shared planes (dl: (d, l) pairs, s:
// the costs along the pass, both at pitch P), op for op the plain pass:
// along each line [p0, p1) (rows of the region where !kAlongY, columns
// where kAlongY), for each pixel i of [o0, o1), w = the min of v = d - s
// (forward) or d + s (reverse) over the window i, i -/+ 1, ..., i -/+
// (2^levels - 1), by the doubling steps of scan_min_carry (nearest first,
// strict <; nothing is taken from outside [0, len)), and cand = w + s
// (forward) or w - s (reverse) replaces (d, l) by (cand, the label of w)
// where cand < d. A thread walks 32 lines (its lane) by kSeg pixels a
// step; a walk's last kMaxHalo outputs, which the next walk along the line
// reads first, wait in registers for a barrier. kLast writes the results
// to the global planes gd, gl at g0 + row * W + column. Returns whether a
// distance fell. Every pixel a pass relaxes, halo or not, reads only
// pixels the previous pass left valid, so its result is the one the pixel's
// own tile computes: a distance that falls here falls in the sweep.
template <class S, bool kAlongY, bool kReverse, bool kLast>
__device__ __forceinline__ bool tile_pass(float2* dl, const float* s, int P, int p0, int p1,
                                          int o0, int o1, int len, int levels, float* gd,
                                          int* gl, int g0, int W) {
  constexpr int kSeg = S::kSegment;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (p1 - p0 + 31) >> 5;
  const int items = groups * ((o1 - o0 + kSeg - 1) / kSeg);
  float held_d[S::kItems][kMaxHalo];
  int held_l[S::kItems][kMaxHalo];
  bool fell = false;
#pragma unroll
  for (int it = 0; it < S::kItems; ++it) {
    const int item = warp + it * S::kWarps;
    if (item >= items) continue;
    const int line = p0 + (item % groups) * 32 + lane;
    const int o = o0 + (item / groups) * kSeg;
    if (line >= p1) continue;
    const int lo = kReverse ? o : o - kMaxHalo, hi = lo + kSeg + kMaxHalo;
    if (lo >= 0 && hi <= len && levels == 3) {
      fell |= walk<kSeg, kAlongY, kReverse, kLast, false>(dl, s, P, line, o, o1, len, levels,
                                                         held_d[it], held_l[it], gd, gl, g0, W);
    } else {
      fell |= walk<kSeg, kAlongY, kReverse, kLast, true>(dl, s, P, line, o, o1, len, levels,
                                                        held_d[it], held_l[it], gd, gl, g0, W);
    }
  }
  if (kLast) return fell;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < S::kItems; ++it) {
    const int item = warp + it * S::kWarps;
    if (item >= items) continue;
    const int line = p0 + (item % groups) * 32 + lane;
    const int o = o0 + (item / groups) * kSeg;
    if (line >= p1) continue;
    const int base = kAlongY ? line : line * P;
#pragma unroll
    for (int j = 0; j < kMaxHalo; ++j) {
      // the walk's outputs kSeg - kMaxHalo + j
      const int pos = kReverse ? o + kMaxHalo - 1 - j : o + kSeg - kMaxHalo + j;
      if (pos < o1)
        dl[base + pos * (kAlongY ? P : 1)] =
            make_float2(held_d[it][j], __int_as_float(held_l[it][j]));
    }
  }
  __syncthreads();
  return fell;
}

// One sweep of a kTH x kTW tile of image blockIdx.z: (d_in, l_in) ->
// (d_out, l_out) for the tile's own pixels. The region is the tile and a
// halo of hr = win_row - 1 columns and hc = win_col - 1 rows on each side,
// cut to the image, copied to shared memory with cp.async: srow, and scol
// at the tile's columns (the column passes read no other), which no sweep
// changes, as soon as the block starts, d and l once the previous sweep
// has finished (griddepcontrol.wait: the sweeps are programmatic dependent
// launches, so a block may start while the sweep before it ends). Each
// pass leaves valid a region smaller by its halo on the side it reads
// from: LR is needed at columns [x0, x1 + hr), RL at the tile's columns,
// TB at rows [y0, y1 + hc), BT at the tile's rows. Returns at once if the
// previous sweep changed no distance; sets changed[sweep] if a distance
// it relaxed fell. win_row and win_col are powers of two, at most
// kMaxHalo + 1.
template <int kTH, int kTW, int kThreads, int kMinBlocks, int kSeg>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sweep_tile_kernel(const float* __restrict__ d_in, const int* __restrict__ l_in,
                  const float* __restrict__ srow, const float* __restrict__ scol,
                  float* __restrict__ d_out, int* __restrict__ l_out, int* changed, int sweep,
                  int H, int W, int win_row, int win_col) {
  using S = TileShape<kTH, kTW, kThreads, kMinBlocks, kSeg>;
  // the next sweep's blocks may start on the SMs this launch frees
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  extern __shared__ float4 smem[];
  const int hr = win_row - 1, hc = win_col - 1;
  const int P = region_pitch(kTW, hr), rows = kTH + 2 * hc;
  float2* dl = reinterpret_cast<float2*>(smem);
  float* s = reinterpret_cast<float*>(dl + rows * P);
  float* sc = s + rows * P;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int ry0 = max(y0 - hc, 0), rx0 = max(x0 - hr, 0);
  const int RH = min(y0 + kTH + hc, H) - ry0, RW = min(x0 + kTW + hr, W) - rx0;
  // the tile's own rows and columns in the region
  const int oy0 = y0 - ry0, oy1 = min(y0 + kTH, H) - ry0;
  const int ox0 = x0 - rx0, ox1 = min(x0 + kTW, W) - rx0;
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  const int g0 = ry0 * W + rx0;  // the region's first pixel
  d_in += plane + g0;
  l_in += plane + g0;
  srow += plane + g0;
  scol += plane + g0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the costs, which no sweep changes, are copied before the previous
  // sweep has finished (scol only at the tile's columns, the column
  // passes' own); d and l after it
  for (int r = warp; r < RH; r += S::kWarps) {
    for (int c = lane; c < RW; c += 32) cp_async4(s + r * P + c, srow + r * W + c);
    for (int c = ox0 + lane; c < ox1; c += 32) cp_async4(sc + r * P + c, scol + r * W + c);
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (sweep > 0 && __ldcg(changed + sweep - 1) == 0) {
    asm volatile("cp.async.wait_all;\n" ::);
    return;
  }
  for (int r = warp; r < RH; r += S::kWarps)
    for (int c = lane; c < RW; c += 32) {
      const int q = r * W + c, i = r * P + c;
      cp_async4(&dl[i].x, d_in + q);
      cp_async4(&dl[i].y, l_in + q);
    }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const int levels_r = __ffs(win_row) - 1, levels_c = __ffs(win_col) - 1;
  bool fell = tile_pass<S, false, false, false>(dl, s, P, 0, RH, ox0, RW, RW, levels_r, nullptr,
                                                nullptr, 0, W);
  fell |= tile_pass<S, false, true, false>(dl, s, P, 0, RH, ox0, ox1, RW, levels_r, nullptr,
                                           nullptr, 0, W);
  fell |= tile_pass<S, true, false, false>(dl, sc, P, ox0, ox1, oy0, RH, RH, levels_c, nullptr,
                                           nullptr, 0, W);
  fell |= tile_pass<S, true, true, true>(dl, sc, P, ox0, ox1, oy0, oy1, RH, levels_c,
                                         d_out + plane, l_out + plane, g0, W);
  if (__syncthreads_or(fell) && threadIdx.x == 0) changed[sweep] = 1;
}

// Shared memory of a tile's region: (d, l), srow and scol, 16 bytes a pixel.
size_t tile_smem(int th, int tw, int win_row, int win_col) {
  return 16 * static_cast<size_t>(th + 2 * (win_col - 1)) * region_pitch(tw, win_row - 1);
}

struct PairPlanes {
  float* d[2];
  int* l[2];
  const float* srow;
  const float* scol;
  int* changed;
  int B, H, W, win_row, win_col;
  cudaStream_t st;
};

template <int kTH, int kTW, int kThreads, int kMinBlocks, int kSeg>
struct TiledSweep {
  static cudaError_t prepare(size_t smem) {
    auto* k = sweep_tile_kernel<kTH, kTW, kThreads, kMinBlocks, kSeg>;
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }
  // sweep `it` reads the planes of parity it & 1 and writes the others; a
  // programmatic dependent launch, so its blocks start copying the costs
  // while the sweep before it finishes
  static cudaError_t launch(const PairPlanes& p, int it, size_t smem) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((p.W + kTW - 1) / kTW, (p.H + kTH - 1) / kTH, p.B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = p.st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int i = it & 1;
    return cudaLaunchKernelEx(&cfg, sweep_tile_kernel<kTH, kTW, kThreads, kMinBlocks, kSeg>,
                              static_cast<const float*>(p.d[i]),
                              static_cast<const int*>(p.l[i]), p.srow, p.scol, p.d[i ^ 1],
                              p.l[i ^ 1], p.changed, it, p.H, p.W, p.win_row, p.win_col);
  }
};

// ---- one launch a pass, for windows too wide for a halo tile ---------------------

// One directional pass, a thread a pixel, reading the pre-pass planes from
// global memory: the arithmetic of tile_pass. Returns at once if the
// previous sweep changed no distance; sets changed[sweep] where a distance
// fell.
__global__ void __launch_bounds__(kPixX * kPixY)
pair_pass_kernel(const float* __restrict__ d, const int* __restrict__ l,
                 const float* __restrict__ s, float* __restrict__ d_out,
                 int* __restrict__ l_out, int* changed, int sweep, int H, int W, int axis,
                 int reverse, int win) {
  if (sweep > 0 && __ldcg(changed + sweep - 1) == 0) return;
  const int x = blockIdx.x * kPixX + threadIdx.x, y = blockIdx.y * kPixY + threadIdx.y;
  bool fell = false;
  if (x < W && y < H) {
    const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
    d += plane;
    l += plane;
    s += plane;
    const int p = y * W + x;
    const int len = axis ? W : H, pos = axis ? x : y, stride = axis ? 1 : W;
    const int dir = reverse ? 1 : -1;
    const float si = s[p];
    const float di = d[p];
    const int li = l[p];
    float best = reverse ? di + si : di - si;
    int bl = li;
    for (int t = 1; t < win; ++t) {
      const int j = pos + dir * t;
      if (j < 0 || j >= len) break;
      const int q = p + dir * t * stride;
      const float v = reverse ? d[q] + s[q] : d[q] - s[q];
      if (v < best) {
        best = v;
        bl = l[q];
      }
    }
    const float cand = reverse ? best - si : best + si;
    fell = cand < di;
    d_out[plane + p] = fell ? cand : di;
    l_out[plane + p] = fell ? bl : li;
  }
  if (__syncthreads_or(fell) && threadIdx.x == 0 && threadIdx.y == 0) changed[sweep] = 1;
}

// the four passes of sweep `it`, (d0, l0) -> (d1, l1) -> (d0, l0) -> ...,
// so every sweep ends in the planes of parity 0
void launch_pass_sweep(const PairPlanes& p, int it) {
  const dim3 grid = pixel_grid(p.B, p.H, p.W), block(kPixX, kPixY);
  const struct { int axis, reverse, from; } passes[4] = {{1, 0, 0}, {1, 1, 1}, {0, 0, 0},
                                                         {0, 1, 1}};
  for (const auto& ps : passes) {
    const int f = ps.from;
    pair_pass_kernel<<<grid, block, 0, p.st>>>(
        p.d[f], p.l[f], ps.axis ? p.srow : p.scol, p.d[f ^ 1], p.l[f ^ 1], p.changed, it, p.H,
        p.W, ps.axis, ps.reverse, ps.axis ? p.win_row : p.win_col);
  }
}

// cv2.watershed's ridge: 4-neighbour disagreement between positive labels,
// plus the 1-px frame of the image.
__global__ void boundary_kernel(const int* labels, uint8_t* boundary, int H, int W) {
  const int x = blockIdx.x * kPixX + threadIdx.x, y = blockIdx.y * kPixY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  labels += plane;
  const int p = y * W + x;
  const int lv = labels[p];
  bool ridge = y == 0 || y == H - 1 || x == 0 || x == W - 1;
  if (!ridge && lv > 0) {
    const int nb[4] = {labels[p - 1], labels[p + 1], labels[p - W], labels[p + W]};
    for (int i = 0; i < 4; ++i) ridge |= nb[i] > 0 && nb[i] != lv;
  }
  boundary[plane + p] = ridge;
}

// ---- the packed form --------------------------------------------------------

namespace ct = cadx_tiled;

// The small label (1..3, later values winning ties; 0 for none) of a
// marker, and the value it maps back to; selects on constant indices, so
// the values stay in registers.
struct Values {
  int v[3];
  int n;
  __device__ __forceinline__ int small_of(int m) const {
    int s = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < n && m == v[i]) s = i + 1;
    return s;
  }
  __device__ __forceinline__ int value_of(int pk) const {
    const int s = pk & 3;
    return s == 1 ? v[0] : s == 2 ? v[1] : s == 3 ? v[2] : 0;
  }
};

// pk = the packed markers at distance 0, kUnreachedPk elsewhere, and the
// first sweep's changed flag zeroed, so no memset runs.
__global__ void __launch_bounds__(ct::kTileThreads)
packed_prologue(const int* __restrict__ markers, int* __restrict__ pk,
                int* __restrict__ changed, ct::Tiles g, Values values) {
  const ct::Tile tile = ct::this_tile(g);
  const ct::Pixel px = ct::tile_pixel(g, tile);
  if (px.inside) {
    const long long i = tile.img * g.n + px.p;
    const int s = values.small_of(markers[i]);
    pk[i] = s ? s : ct::kUnreachedPk;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) changed[0] = 0;
}

// labels = the values of pk's label bits (0 where unreached); boundary =
// a 4-neighbour disagreement between positive labels, plus the 1-px frame.
__global__ void __launch_bounds__(ct::kTileThreads)
packed_epilogue(const int* __restrict__ pk, int* __restrict__ labels,
                uint8_t* __restrict__ boundary, ct::Tiles g, Values values) {
  const ct::Tile tile = ct::this_tile(g);
  const ct::Pixel px = ct::tile_pixel(g, tile);
  if (!px.inside) return;
  const int* c = pk + tile.img * g.n;
  const int lv = values.value_of(c[px.p]);
  bool ridge = px.y == 0 || px.y == g.H - 1 || px.x == 0 || px.x == g.W - 1;
  if (!ridge && lv > 0) {
    const int nb[4] = {values.value_of(c[px.p - 1]), values.value_of(c[px.p + 1]),
                       values.value_of(c[px.p - g.W]), values.value_of(c[px.p + g.W])};
    for (int k = 0; k < 4; ++k) ridge |= nb[k] > 0 && nb[k] != lv;
  }
  const long long i = tile.img * g.n + px.p;
  labels[i] = lv;
  boundary[i] = ridge;
}

bool shape_ok(int H, int W) {
  return H <= 65535 * kPixY && static_cast<long long>(H) * W <= INT_MAX;
}

// The pair form on B <= kMaxImages images (see cadx_watershed_pair): srow,
// scol, d0, d1 and l1 are the images' planes of the scratch, l0 their
// labels; adds its host synchronisations to *syncs and the sweeps it
// launched to *sweeps.
int pair_images(const float* im, const int* markers, int* l0, uint8_t* boundary, float* srow,
                float* scol, float* d0, float* d1, int* l1, int* flags, int* host, int* syncs,
                int* sweeps, int B, int H, int W, int max_iters, int win_row, int win_col,
                int tile_h, int tile_w, int check_every, cudaStream_t st) {
  const size_t total = static_cast<size_t>(B) * H * W;
  PairPlanes p{{d0, d1}, {l0, l1}, srow, scol, flags, B, H, W, win_row, win_col, st};

  for (int axis = 1; axis >= 0; --axis) {
    const int len = axis ? W : H;
    const size_t smem = 2 * static_cast<size_t>(len) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(cost_cumsum_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    cost_cumsum_kernel<<<dim3(axis ? H : W, B), kLineThreads, smem, st>>>(
        im, axis ? srow : scol, H, W, axis);
    if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 pgrid = pixel_grid(B, H, W), pblock(kPixX, kPixY);
  init_pair_kernel<<<pgrid, pblock, 0, st>>>(markers, d0, l0, H, W);
  if (max_iters > 0)
    cudaMemsetAsync(p.changed, 0, static_cast<size_t>(max_iters) * sizeof(int), st);

  // the tiled sweep, where the halo fits
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = tile_smem(tile_h, tile_w, win_row, win_col);
  cudaError_t (*tiled)(const PairPlanes&, int, size_t) = nullptr;
  cudaError_t (*prepare)(size_t) = nullptr;
  if (tile_h == 64 && tile_w == 64) {
    tiled = TiledSweep<64, 64, 512, 2, 16>::launch;
    prepare = TiledSweep<64, 64, 512, 2, 16>::prepare;
  } else if (tile_h == 64 && tile_w == 128) {
    tiled = TiledSweep<64, 128, 1024, 1, 16>::launch;
    prepare = TiledSweep<64, 128, 1024, 1, 16>::prepare;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto halo_fits = [](int win) { return win - 1 <= kMaxHalo && (win & (win - 1)) == 0; };
  if (!halo_fits(win_row) || !halo_fits(win_col) || smem > static_cast<size_t>(smem_max)) {
    tiled = nullptr;
  } else if (cudaError_t e = prepare(smem); e != cudaSuccess) {
    return static_cast<int>(e);
  }

  cudaEvent_t ev[2];
  for (auto& e : ev) cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
  int launched = 0;
  for (int chunk = 0; launched < max_iters; ++chunk) {
    const int end = launched + check_every < max_iters ? launched + check_every : max_iters;
    cudaError_t e = cudaSuccess;
    for (; launched < end && e == cudaSuccess; ++launched) {
      if (tiled) {
        e = tiled(p, launched, smem);
      } else {
        launch_pass_sweep(p, launched);
      }
    }
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) {
      for (auto& e2 : ev) cudaEventDestroy(e2);
      return static_cast<int>(e);
    }
    const bool more = launched < max_iters;
    if (more) {
      cudaMemcpyAsync(host + chunk, p.changed + launched - 1, sizeof(int),
                      cudaMemcpyDeviceToHost, st);
      cudaEventRecord(ev[chunk & 1], st);
    }
    if (chunk == 0) continue;
    // the previous chunk's flag: its copy was queued before this chunk
    cudaEventSynchronize(ev[(chunk - 1) & 1]);
    ++*syncs;
    if (host[chunk - 1] == 0) {
      if (more) {  // let the copy in flight land before host_flags is released
        cudaEventSynchronize(ev[chunk & 1]);
        ++*syncs;
      }
      break;
    }
  }
  for (auto& e : ev) cudaEventDestroy(e);
  *sweeps += launched;
  // a tiled sweep ends in the planes of parity (its index + 1) & 1; once a
  // sweep changed nothing, both parities hold the same planes
  if (tiled && (launched & 1))
    cudaMemcpyAsync(l0, l1, total * sizeof(int), cudaMemcpyDeviceToDevice, st);
  boundary_kernel<<<pgrid, pblock, 0, st>>>(l0, boundary, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: (B, H, W) float32; markers, labels: (B, H, W) int32; boundary:
// (B, H, W) bytes 0/1; scratch: five (B, H, W) planes of 4-byte words, in
// order srow, scol, d0, d1 (float32) and l1 (int32); flags: max(max_iters,
// 1) int32 on the device, one a sweep; host_flags: ceil(max_iters /
// check_every) int32 of pinned host memory; host_syncs, host_sweeps: ints
// the numbers of host synchronisations and of sweeps launched are written
// to.
//
// Runs sweeps of the four passes (LR, RL, TB, BT) until one changes no
// distance or max_iters sweeps ran; win_row / win_col are the scan windows
// 1 + sum(doubling_steps(min(len, max_scan))). A sweep is one launch over
// tile_h x tile_w tiles (64x64 or 64x128) while both windows are
// at most 8 (max_scan <= 8) and the region fits the block's shared memory,
// else four launches. Every sweep launch returns at once when the one
// before it changed nothing, so the sweeps after the first unchanged one
// change nothing either; the host copies the flag of every check_every-th
// sweep to host_flags and waits for the copy only after it queued the next
// check_every sweeps, and launches no more once one reads 0. Images go
// kMaxImages at a time (the grids' images axis), each group swept until it
// settles: a settled image stays as it is, so each gets the labels of a
// call on all B.
extern "C" int cadx_watershed_pair(const void* img, const void* markers, void* labels,
                                   void* boundary, void* scratch, void* flags, void* host_flags,
                                   void* host_syncs, void* host_sweeps, int B, int H, int W,
                                   int max_iters, int win_row, int win_col, int tile_h,
                                   int tile_w, int check_every, void* stream) {
  int* syncs = static_cast<int*>(host_syncs);
  int* sweeps = static_cast<int*>(host_sweeps);
  *syncs = 0;
  *sweeps = 0;
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (!shape_ok(H, W) || check_every <= 0 || win_row < 1 || win_col < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t hw = static_cast<size_t>(H) * W, total = B * hw;
  float* plane = static_cast<float*>(scratch);
  for (int b0 = 0; b0 < B; b0 += kMaxImages) {
    const size_t o = b0 * hw;
    const int rc = pair_images(
        static_cast<const float*>(img) + o, static_cast<const int*>(markers) + o,
        static_cast<int*>(labels) + o, static_cast<uint8_t*>(boundary) + o, plane + o,
        plane + total + o, plane + 2 * total + o, plane + 3 * total + o,
        reinterpret_cast<int*>(plane + 4 * total) + o, static_cast<int*>(flags),
        static_cast<int*>(host_flags), syncs, sweeps, B - b0 < kMaxImages ? B - b0 : kMaxImages,
        H, W, max_iters, win_row, win_col, tile_h, tile_w, check_every,
        static_cast<cudaStream_t>(stream));
    if (rc != 0) return rc;
  }
  return 0;
}

// img: (B, H, W) float32 (integer-valued); markers, labels: (B, H, W)
// int32; boundary: (B, H, W) bytes 0/1; scratch: 4-byte aligned,
// kernels/watershed.py::packed_scratch_bytes: four (B, H, W) int32 planes
// (pk twice, srow, scol), four int32 (the sweeps' three changed flags and
// a sweeps slot) and two bytes a 32 x 32 tile (the tiles' flags); sweeps: a device int32 that receives the sweeps run,
// or null (then the scratch's slot does). Up to three marker values,
// v1..v3, in tie order. Sides up to 512 (the packed distances' int32
// range). Runs JAX's sweeps at max_scan until one changes nothing or
// max_iters ran; nothing waits on the host.
extern "C" int cadx_watershed_packed(const void* img, const void* markers, void* labels,
                                     void* boundary, void* scratch, void* sweeps, int B, int H,
                                     int W, int v1, int v2, int v3, int n_values, int max_iters,
                                     int max_scan, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (H > 512 || W > 512 || n_values < 0 || n_values > 3 || max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ct::Tiles g = ct::make_tiles(H, W);
  const long long blocks = static_cast<long long>(B) * g.per_image;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * g.n;
  int* pk = static_cast<int*>(scratch);
  int* changed = pk + 4 * n;
  uint8_t* tile_fell = reinterpret_cast<uint8_t*>(changed + 4);
  int* sweeps_at = sweeps ? static_cast<int*>(sweeps) : changed + 3;
  const Values values{{v1, v2, v3}, n_values};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned tiles = static_cast<unsigned>(blocks);
  packed_prologue<<<tiles, ct::kTileThreads, 0, st>>>(static_cast<const int*>(markers), pk,
                                                      changed, g, values);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  if (cudaError_t e = ct::relax_capped(static_cast<const float*>(img), pk, pk + n, pk + 2 * n,
                                       pk + 3 * n, changed, tile_fell, sweeps_at, B, H, W,
                                       max_iters, max_scan, st);
      e != cudaSuccess)
    return static_cast<int>(e);
  packed_epilogue<<<tiles, ct::kTileThreads, 0, st>>>(pk, static_cast<int*>(labels),
                                                      static_cast<uint8_t*>(boundary), g,
                                                      values);
  return static_cast<int>(cudaGetLastError());
}
