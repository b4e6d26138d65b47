// Binary flood fill from a seed within a mask, 4- or 8-connected, as one
// cooperative launch over the whole card. Replaces
// cadx_tpu/kernels/flood.py::flood_from_pallas; see
// cadx_tpu_torch/kernels/flood.py for the contract and its bound.
//
// The sweep is the plain version's, in its order: reach spreads over each
// row run of the mask, then over each column run, then (8-connected) to the
// 3x3 neighbourhood within the mask; sweeps repeat until one changes nothing
// or max_iters have run, so a capped run stops at the same state. A
// union-find reaches the fixpoint but not the state after k sweeps, so the
// kernel runs the sweeps themselves.
//
// Bound: the mask and seed read once and the reach written once, 3 bytes a
// pixel; a sweep itself is a few bit operations a word. What costs is
// latency: the carries along each row and column run, and the barriers
// between the steps, which need the whole batch finished.
//
// Design. The planes are bit-packed, 32 pixels a word, in global scratch
// that L2 holds (240 KB a plane at 1536 x 1280). Row words (bit k of word j
// of row y: pixel (y, 32 j + k)) of the mask, the reach and, 8-connected,
// the column step's output are stored word-major, (B, nw, H): a word's 32
// rows are one 128-byte line. Column words (bit k of word i of column x:
// pixel (32 i + k, x)) of the mask and the row step's output are stored
// band-major, (B, nh, W): a band's 32 columns are one line. So every step
// reads and writes whole lines. One persistent grid of co-resident blocks
// runs every sweep, with one grid barrier a step:
//   pack    a block 32 rows x 32 words: a warp packs a row's 32 words (32
//           loads of 32 contiguous bytes, a bit a load in each lane, then a
//           transpose), shared memory turns them word-major (the
//           column-packed mask comes from the first row step);
//   rows    a block a band of 32 rows of one image: the band's words into
//           shared memory (a line of 32 rows a warp load), then a warp a
//           row: the run fill of a row is a segmented scan over its words
//           (a carry enters a word at bit 0 if the word before ends
//           reached, and passes through an all-mask word), done 32 words at
//           a time by a Kogge-Stone fill inside each word and one over the
//           warp's ballots of "ends reached" and "all mask" bits, forward
//           then backward; where a row holds at most 16 words, a warp fills
//           several rows in one pass, the carries kept inside each row's
//           segment of lanes; then 32 x 32 bit transposes (a warp a tile,
//           five shuffles) write the band's column words, a line a tile;
//   columns the same, a block a band of 32 columns, transposed back into
//           row words; 4-connected these are the new reach, compared with
//           the old as they are written;
//   3x3     (8-connected) folded into the next sweep's row step: a word's
//           3x3 maximum is the OR of the rows above and below, shifted a
//           bit each way with its neighbours' edge bits, and with the mask;
//           it reads the column step's plane and writes the reach, so no
//           word sees a neighbour the same step has already spread;
//   unpack  a block 32 rows x 32 words: word-major lines into shared
//           memory, then a warp a row, a word's 32 pixels in one store.
// Every block reads the same "changed" flag after the same barrier, so all
// stop together; a sweep's flag is changed[sweep % 3], zeroed by block 0
// two steps ahead (all three by the pack step), so no block still reads a
// flag that is being zeroed. Shared memory holds 32 lines of odd stride
// twice, so a warp's transpose reads 32 lines in 32 banks. One call is one
// launch with no memset and no host synchronisation.
#include <cooperative_groups.h>

#include <cstdint>

#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

// threads a block: lines of up to 16 words take several a warp pass, so
// more warps a block would only idle; longer lines go a warp a line
constexpr int kShortThreads = 256, kLongThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFlags = 3;  // the rotating changed flags before the planes

// Shared memory a block: two sets of 32 lines of this odd stride, long
// enough for a band's lines and for pack's 32 x 32 blocks.
__host__ __device__ inline int line_stride(int nw, int nh) {
  const int n = nw > nh ? nw : nh;
  return (n > 32 ? n : 32) | 1;
}

// One batch's packed planes.
struct Planes {
  int B, H, W, nw, nh;  // nw words a row line, nh a column line
  uint32_t* mr;         // mask by rows, word-major (B, nw, H)
  uint32_t* rr;         // reach by rows, the state
  uint32_t* ur;         // the column step's output by rows (8-connected)
  uint32_t* mc;         // mask by columns, band-major (B, nh, W)
  uint32_t* tc;         // the row step's output by columns
};

// spread r (a subset of m) towards higher bits along the runs of m
__device__ __forceinline__ uint32_t fill_up(uint32_t r, uint32_t m) {
  r |= m & (r << 1); m &= m << 1;
  r |= m & (r << 2); m &= m << 2;
  r |= m & (r << 4); m &= m << 4;
  r |= m & (r << 8); m &= m << 8;
  return r | (m & (r << 16));
}

__device__ __forceinline__ uint32_t fill_down(uint32_t r, uint32_t m) {
  r |= m & (r >> 1); m &= m >> 1;
  r |= m & (r >> 2); m &= m >> 2;
  r |= m & (r >> 4); m &= m >> 4;
  r |= m & (r >> 8); m &= m >> 8;
  return r | (m & (r >> 16));
}

// Lane i holds word i of a 32 x 32 bit tile (bit k: column k); returns to
// lane k the tile's column k (bit i: word i's bit k). Five exchanges with
// the lane s apart (s = 16, 8, 4, 2, 1) swap the off-diagonal s x s blocks
// of every 2s x 2s block: a lane of the upper half takes its partner's
// left half into its right, a lane of the lower half its partner's right
// half into its left. (32 ballots, one a column, would do the same with a
// vote a column, and the votes of a whole block's warps queue on the SM.)
__device__ __forceinline__ uint32_t transpose32(uint32_t v, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const uint32_t right = s == 16 ? 0xffff0000u : s == 8 ? 0xff00ff00u
                         : s == 4 ? 0xf0f0f0f0u : s == 2 ? 0xccccccccu : 0xaaaaaaaau;
    const uint32_t p = __shfl_xor_sync(kFull, v, s);
    v = (lane & s) ? (v & right) | ((p & right) >> s) : (v & ~right) | ((p & ~right) << s);
  }
  return v;
}

// A warp fills one line of n words in shared memory, r (reach, a subset of
// the mask m), in place: every run of m that holds a bit of r is set in
// full. Forward, a word's carry-in is the previous word's bit 31 after its
// own fill; it enters at bit 0 where m is set, and a word passes it on when
// its own fill ends reached (G) or it is all mask and a carry enters (P).
// Over the warp's 32 words that is X = fill_up(G, G | P) on the ballots:
// lane k's carry-in is X's bit k - 1 (the chunk's carry-in at lane 0), and
// X's bit 31 goes to the next 32 words. Backward the same on bit-reversed
// ballots, from the last chunk.
__device__ __forceinline__ void fill_line(const uint32_t* m, uint32_t* r, int n, int lane) {
  uint32_t cin = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const uint32_t mm = j < n ? m[j] : 0u;
    uint32_t v = fill_up(j < n ? r[j] : 0u, mm);
    const uint32_t p = __ballot_sync(kFull, mm == kFull);
    const uint32_t g = __ballot_sync(kFull, v >> 31);
    const uint32_t x = fill_up(g | (cin & p), g | p);
    if ((((x << 1) | cin) >> lane) & 1u) v = fill_up(v | (mm & 1u), mm);
    if (j < n) r[j] = v;
    cin = x >> 31;
  }
  cin = 0;
  for (int j0 = (n - 1) / 32 * 32; j0 >= 0; j0 -= 32) {
    const int j = j0 + lane;
    const uint32_t mm = j < n ? m[j] : 0u;
    uint32_t v = fill_down(j < n ? r[j] : 0u, mm);
    const uint32_t p = __brev(__ballot_sync(kFull, mm == kFull));
    const uint32_t g = __brev(__ballot_sync(kFull, v & 1u));
    const uint32_t x = fill_up(g | (cin & p), g | p);
    if ((((x << 1) | cin) >> (31 - lane)) & 1u) v = fill_down(v | (mm & 0x80000000u), mm);
    if (j < n) r[j] = v;
    cin = x >> 31;
  }
}

// The same for up to 32 / kWarps lines of n <= 16 words, a warp's lines
// k = warp + i * kWarps of a band (sm, sr: lines of `stride` words), in
// passes of 32 / S lines, S the power of two >= n: lane l takes word l % S
// of line l / S. The ballots then hold several lines, so a carry must not
// cross from one line's segment of lanes into the next: the first lane of
// a segment takes no carry forward, the last none backward, and neither
// passes one through.
template <int kWarps>
__device__ __forceinline__ void fill_short(uint32_t* sm, uint32_t* sr, int stride, int n,
                                           int lane, int warp) {
  constexpr int kLines = 32 / kWarps;
  const int S = n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
  const uint32_t starts = S == 1 ? kFull : S == 2 ? 0x55555555u : S == 4 ? 0x11111111u
                        : S == 8 ? 0x01010101u : 0x00010001u;
  const uint32_t ends_rev = __brev(starts << (S - 1));
  for (int i0 = 0; i0 < kLines; i0 += 32 / S) {
    const int i = i0 + lane / S, j = lane % S;
    const bool on = i < kLines && j < n;
    const int at = (warp + i * kWarps) * stride + j;
    const uint32_t mm = on ? sm[at] : 0u;
    uint32_t v = fill_up(on ? sr[at] : 0u, mm);
    const uint32_t p = __ballot_sync(kFull, mm == kFull);
    uint32_t g = __ballot_sync(kFull, v >> 31);
    uint32_t x = fill_up(g, g | (p & ~starts));
    if ((((x << 1) & ~starts) >> lane) & 1u) v = fill_up(v | (mm & 1u), mm);
    v = fill_down(v, mm);
    const uint32_t pr = __brev(p);
    g = __brev(__ballot_sync(kFull, v & 1u));
    x = fill_up(g, g | (pr & ~ends_rev));
    if ((((x << 1) & ~ends_rev) >> (31 - lane)) & 1u) v = fill_down(v | (mm & 0x80000000u), mm);
    if (on) sr[at] = v;
  }
}

// A warp fills its lines of a band: fill_short where a line holds up to 16
// words, else fill_line a line at a time (lines past the image hold 0).
template <int kWarps>
__device__ __forceinline__ void fill_band(uint32_t* sm, uint32_t* sr, int stride, int n,
                                          int lane, int warp) {
  if (n <= 16) {
    fill_short<kWarps>(sm, sr, stride, n, lane, warp);
    return;
  }
  for (int k = warp; k < 32; k += kWarps) fill_line(sm + k * stride, sr + k * stride, n, lane);
}

// The 3x3 maximum of the column step's output at word j of row y, within
// the mask (u, m: one image's word-major planes of H rows): rows y - 1..y +
// 1 ORed, then the word and its neighbours' edge bits shifted in.
__device__ __forceinline__ uint32_t dilate3(const uint32_t* u, const uint32_t* m, int H,
                                            int nw, int y, int j) {
  uint32_t v[3];
#pragma unroll
  for (int d = -1; d <= 1; ++d) {
    const int jj = j + d;
    uint32_t o = 0;
    if (jj >= 0 && jj < nw) {
      const uint32_t* line = u + static_cast<long long>(jj) * H;
      o = __ldcg(line + y);
      if (y > 0) o |= __ldcg(line + y - 1);
      if (y + 1 < H) o |= __ldcg(line + y + 1);
    }
    v[d + 1] = o;
  }
  const uint32_t h = v[1] | (v[1] << 1) | (v[0] >> 31) | (v[1] >> 1) | (v[2] << 31);
  return h & __ldcg(m + static_cast<long long>(j) * H + y);
}

// mask, seed -> mr, rr (seed & mask) for one block of 32 rows (band i) x
// 32 words (from j0) of image b: a warp packs a row's words (load k, 32
// contiguous bytes, a byte a lane, gives bit k of each lane's word, and a
// transpose turns those into words j0 + k), into sm / sr as (word, row);
// then a warp stores a word's 32 rows as one line. sm, sr: 32 lines of
// stride >= 33 words.
template <int kWarps>
__device__ void pack(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ seed,
                     const Planes& q, long long b, int band, int j0, uint32_t* sm, uint32_t* sr,
                     int stride, int lane, int warp) {
  // bit k of u[i]: pixel `lane` of word j0 + k of the warp's row i (warp +
  // i * kWarps); transposed, lane k holds the row's word j0 + k. The loads
  // of all the warp's rows go out together.
  constexpr int kLines = 32 / kWarps;
  const int count = q.nw - j0 < 32 ? q.nw - j0 : 32;
  uint32_t um[kLines] = {}, ur[kLines] = {};
#pragma unroll 4
  for (int k = 0; k < count; ++k) {
    const int x = 32 * (j0 + k) + lane;
#pragma unroll
    for (int i = 0; i < kLines; ++i) {
      const int y = 32 * band + warp + i * kWarps;
      const long long p = (b * q.H + y) * q.W + x;
      const bool in = y < q.H && x < q.W;
      const uint32_t mv = in && mask[p] != 0, sv = in && seed[p] != 0;
      um[i] |= mv << k;
      ur[i] |= (mv & sv) << k;
    }
  }
#pragma unroll
  for (int i = 0; i < kLines; ++i) {
    sm[lane * stride + warp + i * kWarps] = transpose32(um[i], lane);
    sr[lane * stride + warp + i * kWarps] = transpose32(ur[i], lane);
  }
  __syncthreads();
  for (int w = warp; w < count; w += kWarps) {
    const int y = 32 * band + lane;
    if (y < q.H) {
      const long long o = (b * q.nw + j0 + w) * q.H + y;
      q.mr[o] = sm[w * stride + lane];
      q.rr[o] = sr[w * stride + lane];
    }
  }
  __syncthreads();
}

// rr -> out bytes for one block of 32 rows x 32 words: a warp loads a
// word's 32 rows as one line into sm as (word, row), then a warp takes a row
// (lane k word j0 + k, transposed so that lane i holds pixel i of each word)
// and stores each word's 32 pixels as 32 contiguous bytes.
template <int kWarps>
__device__ void unpack(uint8_t* __restrict__ out, const Planes& q, long long b, int band,
                       int j0, uint32_t* sm, int stride, int lane, int warp) {
  const int count = q.nw - j0 < 32 ? q.nw - j0 : 32;
  for (int w = warp; w < count; w += kWarps) {
    const int y = 32 * band + lane;
    sm[w * stride + lane] = y < q.H ? __ldcg(q.rr + (b * q.nw + j0 + w) * q.H + y) : 0u;
  }
  __syncthreads();
  for (int r = warp; r < 32; r += kWarps) {
    const int y = 32 * band + r;
    if (y >= q.H) break;
    // lane k holds word j0 + k; transposed, bit k of lane i is pixel i of
    // word j0 + k
    const uint32_t t = transpose32(lane < count ? sm[lane * stride + r] : 0u, lane);
    uint8_t* orow = out + (b * q.H + y) * q.W;
    for (int k = 0; k < count; ++k) {
      const int x = 32 * (j0 + k) + lane;
      if (x < q.W) orow[x] = static_cast<uint8_t>((t >> k) & 1u);
    }
  }
  __syncthreads();
}

// The row step for one band of 32 rows: the reach of each row (rr, or with
// dilate the 3x3 step on ur, written to rr and compared with it), its run
// fill, and the band's column words into tc (with write_mc, the mask's
// into mc too). sm, sr: 32 lines of `stride` words in shared memory.
// Returns whether this thread changed a reach word.
template <int kWarps>
__device__ bool row_band(const Planes& q, long long b, int band, bool dilate, bool write_mc,
                         uint32_t* sm, uint32_t* sr, int stride, int lane, int warp) {
  // word j of the band's 32 rows is one line of the word-major planes: a
  // warp loads it, lane k row k; rows past the image stay zero
  bool changed = false;
  const int nw = q.nw;
  const uint32_t* mr = q.mr + b * nw * q.H;
  uint32_t* rr = q.rr + b * nw * q.H;
  const int y = 32 * band + lane;
#pragma unroll 4
  for (int j = warp; j < nw; j += kWarps) {
    uint32_t m = 0, v = 0;
    if (y < q.H) {
      const long long o = static_cast<long long>(j) * q.H + y;
      m = __ldcg(mr + o);
      if (dilate) {
        v = dilate3(q.ur + b * nw * q.H, mr, q.H, nw, y, j);
        if (v != __ldcg(rr + o)) {
          changed = true;
          rr[o] = v;
        }
      } else {
        v = __ldcg(rr + o);
      }
    }
    sm[lane * stride + j] = m;
    sr[lane * stride + j] = v;
  }
  __syncthreads();
  fill_band<kWarps>(sm, sr, stride, nw, lane, warp);
  __syncthreads();
  uint32_t* mc = q.mc + (b * q.nh + band) * q.W;
  uint32_t* tc = q.tc + (b * q.nh + band) * q.W;
  for (int j = warp; j < nw; j += kWarps) {
    const int x = 32 * j + lane;
    if (write_mc) {  // the first sweep: the band's mask by columns, once
      const uint32_t col = transpose32(sm[lane * stride + j], lane);
      if (x < q.W) mc[x] = col;
    }
    const uint32_t col = transpose32(sr[lane * stride + j], lane);
    if (x < q.W) tc[x] = col;
  }
  __syncthreads();
  return changed;
}

// The column step for one band of 32 columns: each column's run fill of tc
// within mc, transposed back into row words: the new reach (compared with
// rr and written there) or, with to_ur, the 3x3 step's input.
template <int kWarps>
__device__ bool column_band(const Planes& q, long long b, int band, bool to_ur, uint32_t* sm,
                            uint32_t* sr, int stride, int lane, int warp) {
  bool changed = false;
  const int nh = q.nh;
  const int x = 32 * band + lane;
#pragma unroll 4
  for (int i = warp; i < nh; i += kWarps) {
    uint32_t m = 0, v = 0;
    if (x < q.W) {
      const long long o = (b * nh + i) * q.W + x;
      m = __ldcg(q.mc + o);
      v = __ldcg(q.tc + o);
    }
    sm[lane * stride + i] = m;
    sr[lane * stride + i] = v;
  }
  __syncthreads();
  fill_band<kWarps>(sm, sr, stride, nh, lane, warp);
  __syncthreads();
  const long long line = (b * q.nw + band) * q.H;  // word `band` of every row
#pragma unroll 4
  for (int i = warp; i < nh; i += kWarps) {
    const uint32_t row_word = transpose32(sr[lane * stride + i], lane);
    const int y = 32 * i + lane;
    if (y < q.H) {
      if (to_ur) {
        q.ur[line + y] = row_word;
      } else if (row_word != __ldcg(q.rr + line + y)) {
        changed = true;
        q.rr[line + y] = row_word;
      }
    }
  }
  __syncthreads();
  return changed;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
flood_sweeps(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ seed,
             uint8_t* __restrict__ out, Planes q, int* flags, int* sweeps, int max_iters,
             int conn) {
  extern __shared__ uint32_t smem[];
  const int stride = line_stride(q.nw, q.nh);
  uint32_t* sm = smem;
  uint32_t* sr = smem + 32 * stride;
  constexpr int kWarps = kThreads / 32;
  const cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const long long row_bands = static_cast<long long>(q.B) * q.nh;
  const long long col_bands = static_cast<long long>(q.B) * q.nw;
  const int chunks = (q.nw + 31) / 32;  // of 32 words a row band

  for (long long u = blockIdx.x; u < row_bands * chunks; u += gridDim.x)
    pack<kWarps>(mask, seed, q, u / chunks / q.nh, static_cast<int>(u / chunks % q.nh),
                 static_cast<int>(u % chunks) * 32, sm, sr, stride, lane, warp);
  if (lead) flags[0] = flags[1] = flags[2] = 0;
  grid.sync();

  // sweep s: the row step (8-connected from s = 2, first the 3x3 step of
  // sweep s - 1, whose flag it raises), then the column step (4-connected:
  // the new reach, and sweep s's flag)
  int s = 0;
  for (int t = 1; max_iters > 0; ++t) {
    const bool dilate = conn == 8 && t >= 2;
    if (lead) flags[(t + 1) % 3] = 0;
    bool changed = false;
    for (long long u = blockIdx.x; u < row_bands; u += gridDim.x)
      changed |= row_band<kWarps>(q, u / q.nh, static_cast<int>(u % q.nh), dilate, t == 1, sm,
                                  sr, stride, lane, warp);
    if (__syncthreads_or(changed) && threadIdx.x == 0) flags[(t - 1) % 3] = 1;
    grid.sync();
    if (dilate && (!__ldcg(flags + (t - 1) % 3) || t - 1 >= max_iters)) {
      s = t - 1;
      break;
    }
    changed = false;
    for (long long u = blockIdx.x; u < col_bands; u += gridDim.x)
      changed |= column_band<kWarps>(q, u / q.nw, static_cast<int>(u % q.nw), conn == 8, sm,
                                     sr, stride, lane, warp);
    if (__syncthreads_or(changed) && threadIdx.x == 0) flags[t % 3] = 1;
    grid.sync();
    if (conn == 4 && (!__ldcg(flags + t % 3) || t >= max_iters)) {
      s = t;
      break;
    }
  }

  for (long long u = blockIdx.x; u < row_bands * chunks; u += gridDim.x)
    unpack<kWarps>(out, q, u / chunks / q.nh, static_cast<int>(u / chunks % q.nh),
                   static_cast<int>(u % chunks) * 32, sm, stride, lane, warp);
  if (lead && sweeps) *sweeps = s;
}

// One cooperative launch of flood_sweeps<kThreads>: as many blocks as the
// card holds at once, and no more than the largest step has work for
// (bands of columns, or bands of rows by 32-word chunks).
template <int kThreads>
cudaError_t launch(const void* mask, const void* seed, void* out, const Planes& planes,
                   int* flags, int* sweeps, int max_iters, int conn, size_t smem, int sms,
                   cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t e = cudaSuccess;
  static size_t attr_bytes = 0;
  if (smem > attr_bytes) {
    e = cudaFuncSetAttribute(flood_sweeps<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess) attr_bytes = smem;
  }
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flood_sweeps<kThreads>, kThreads,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long B = planes.B;
  long long want = B * planes.nh * ((planes.nw + 31) / 32);
  if (B * planes.nw > want) want = B * planes.nw;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(want < resident ? want : resident);
  Planes q = planes;
  void* args[] = {const_cast<void**>(&mask), const_cast<void**>(&seed), &out, &q, &flags,
                  &sweeps, &max_iters, &conn};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(flood_sweeps<kThreads>), grid,
                                     kThreads, args, smem, stream);
}

}  // namespace

// mask, seed, out: (B, H, W) bytes 0/1. scratch: int32 words, 3 + B * (3 *
// H * ceil(W / 32) + 2 * W * ceil(H / 32)) (kernels/flood.py::scratch_words;
// the changed flags first). sweeps: a device int32 that receives the sweeps
// run, or null. conn 4 or 8; at most max_iters sweeps. Shared memory: 2 * 32 * line_stride
// words a block, refused beyond the card's opt-in limit.
extern "C" int cadx_flood_from(const void* mask, const void* seed, void* out, void* scratch,
                               void* sweeps, int B, int H, int W, int max_iters, int conn,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (conn != 4 && conn != 8) return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (W + 31) / 32, nh = (H + 31) / 32;
  const int longest = nw > nh ? nw : nh;
  const size_t smem = 2 * 32 * static_cast<size_t>(line_stride(nw, nh)) * sizeof(uint32_t);
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > static_cast<size_t>(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  int* flags = static_cast<int*>(scratch);
  uint32_t* words = reinterpret_cast<uint32_t*>(flags + kFlags);
  const long long rows = static_cast<long long>(B) * H * nw;
  const long long cols = static_cast<long long>(B) * W * nh;
  const Planes q{B, H, W, nw, nh, words, words + rows, words + 2 * rows, words + 3 * rows,
                 words + 3 * rows + cols};
  int* sweeps_out = static_cast<int*>(sweeps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      longest <= 16
          ? launch<kShortThreads>(mask, seed, out, q, flags, sweeps_out, max_iters, conn, smem,
                                  sms, s)
          : launch<kLongThreads>(mask, seed, out, q, flags, sweeps_out, max_iters, conn, smem,
                                 sms, s));
}
