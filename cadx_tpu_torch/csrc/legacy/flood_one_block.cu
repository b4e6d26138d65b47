// Binary flood fill from a seed within a mask, 4- or 8-connected, as one
// block per image: the kernel that csrc/flood.cu replaced, kept only so that
// timings can set the two side by side (chip_smoke.py
// --flood-seeded-times); no path runs it. Its wrapper allocated the planes'
// global scratch where they passed 200 KB (kSmemLimit).
//
// The sweep is the plain version's, in its order: reach spreads over each
// row run of the mask, then over each column run, then (8-connected) to
// the 3x3 neighbourhood within the mask; sweeps repeat until one changes
// nothing or max_iters have run, so a capped run stops at the same state.
//
// The planes are bit-packed, 32 pixels a word: the mask and the reach by
// rows (bit k of word j of a row is pixel 32 j + k) and the mask and a
// temporary by columns. A row run fill is a Kogge-Stone fill inside each
// word with the carry passed from word to word, forward then backward, one
// thread a row; the column pass is the same on the column-packed words, one
// thread a column, after a 32x32 bit transpose (32 warp ballots a block).
// Line strides are odd so a warp's 32 lines fall in 32 shared-memory banks.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// the planes live in dynamic shared memory up to this size, else in the
// caller's global scratch (kept equal to kernels/flood.py::_SMEM_LIMIT)
constexpr int kSmemLimit = 200 * 1024;

__host__ __device__ inline int odd(int n) { return n | 1; }

__host__ __device__ inline long long plane_words(int H, int W) {
  const int nw = (W + 31) / 32, nh = (H + 31) / 32;
  return 3LL * H * odd(nw) + 2LL * W * odd(nh);
}

// spread r (a subset of m) towards higher bits along the runs of m
__device__ inline uint32_t fill_up(uint32_t r, uint32_t m) {
  r |= m & (r << 1); m &= m << 1;
  r |= m & (r << 2); m &= m << 2;
  r |= m & (r << 4); m &= m << 4;
  r |= m & (r << 8); m &= m << 8;
  return r | (m & (r << 16));
}

__device__ inline uint32_t fill_down(uint32_t r, uint32_t m) {
  r |= m & (r >> 1); m &= m >> 1;
  r |= m & (r >> 2); m &= m >> 2;
  r |= m & (r >> 4); m &= m >> 4;
  r |= m & (r >> 8); m &= m >> 8;
  return r | (m & (r >> 16));
}

// One line of n words: every run of m that holds a bit of rin is set in
// rout (rin == rout allowed). Words are loaded 8 at a time ahead of the
// carry chain, so their loads overlap.
__device__ inline void fill_line(const uint32_t* m, const uint32_t* rin, uint32_t* rout,
                                 int n) {
  constexpr int kBatch = 8;
  uint32_t carry = 0;
  for (int j0 = 0; j0 < n; j0 += kBatch) {
    uint32_t mm[kBatch], rr[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      mm[e] = j0 + e < n ? m[j0 + e] : 0u;
      rr[e] = j0 + e < n ? rin[j0 + e] : 0u;
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const uint32_t r = fill_up((rr[e] | carry) & mm[e], mm[e]);
      if (j0 + e < n) rout[j0 + e] = r;
      carry = r >> 31;
    }
  }
  carry = 0;
  for (int j1 = n - 1; j1 >= 0; j1 -= kBatch) {
    uint32_t mm[kBatch], rr[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      mm[e] = j1 - e >= 0 ? m[j1 - e] : 0u;
      rr[e] = j1 - e >= 0 ? rout[j1 - e] : 0u;
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const uint32_t r = fill_down((rr[e] | (carry << 31)) & mm[e], mm[e]);
      if (j1 - e >= 0) rout[j1 - e] = r;
      carry = r & 1u;
    }
  }
}

// Bit transpose of a plane of n_src lines (stride ss words) of n_dst bits
// into n_dst lines (stride ds) of n_src bits, one warp per 32x32 block. With
// `track`, the destination is compared before it is written; returns
// whether this thread wrote a changed word.
template <bool track>
__device__ int transpose(const uint32_t* src, int ss, int n_src, uint32_t* dst, int ds,
                         int n_dst) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int a_blocks = (n_src + 31) / 32, b_blocks = (n_dst + 31) / 32;
  int changed = 0;
  for (int blk = warp; blk < a_blocks * b_blocks; blk += nwarps) {
    const int a = blk / b_blocks, b = blk % b_blocks;
    const int line = 32 * a + lane;
    const uint32_t v = line < n_src ? src[line * ss + b] : 0u;
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t t = __ballot_sync(0xffffffffu, (v >> k) & 1u);
      if (lane == k) mine = t;
    }
    const int out_line = 32 * b + lane;
    if (out_line < n_dst) {
      uint32_t* p = dst + out_line * ds + a;
      if (track) changed |= *p != mine;
      *p = mine;
    }
  }
  return changed;
}

__global__ void __launch_bounds__(1024)
flood_kernel(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ seed,
             uint8_t* __restrict__ out, uint32_t* scratch, int H, int W,
             int max_iters, int conn) {
  extern __shared__ uint32_t smem[];
  const long long img = blockIdx.x;
  const long long n = static_cast<long long>(H) * W;
  mask += img * n;
  seed += img * n;
  out += img * n;
  const int nw = (W + 31) / 32, nh = (H + 31) / 32;
  const int rs = odd(nw), cs = odd(nh);
  uint32_t* mrow = scratch ? scratch + img * plane_words(H, W) : smem;
  uint32_t* reach = mrow + H * rs;
  uint32_t* tmp = reach + H * rs;
  uint32_t* mcol = tmp + H * rs;
  uint32_t* ccol = mcol + W * cs;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // pack: one warp a word, 32 coalesced bytes
  for (int wi = warp; wi < H * nw; wi += nwarps) {
    const int r = wi / nw, j = wi % nw, x = 32 * j + lane;
    const bool m = x < W && mask[static_cast<long long>(r) * W + x] != 0;
    const bool s = m && seed[static_cast<long long>(r) * W + x] != 0;
    const uint32_t mw = __ballot_sync(0xffffffffu, m);
    const uint32_t sw = __ballot_sync(0xffffffffu, s);
    if (lane == 0) {
      mrow[r * rs + j] = mw;
      reach[r * rs + j] = sw;
    }
  }
  __syncthreads();
  transpose<false>(mrow, rs, H, mcol, cs, W);
  __syncthreads();

  bool changed = true;
  for (int it = 0; changed && it < max_iters; ++it) {
    for (int r = threadIdx.x; r < H; r += blockDim.x)
      fill_line(mrow + r * rs, reach + r * rs, tmp + r * rs, nw);
    __syncthreads();
    transpose<false>(tmp, rs, H, ccol, cs, W);
    __syncthreads();
    for (int c = threadIdx.x; c < W; c += blockDim.x)
      fill_line(mcol + c * cs, ccol + c * cs, ccol + c * cs, nh);
    __syncthreads();
    int local = 0;
    if (conn == 4) {
      local = transpose<true>(ccol, cs, W, reach, rs, H);
    } else {
      transpose<false>(ccol, cs, W, tmp, rs, H);
      __syncthreads();
      // the 3x3 max within the mask: rows r-1..r+1 ORed, then the word and
      // its neighbours' edge bits shifted in
      for (int wi = threadIdx.x; wi < H * nw; wi += blockDim.x) {
        const int r = wi / nw, j = wi % nw;
        uint32_t v[3];
#pragma unroll
        for (int d = -1; d <= 1; ++d) {
          const int jj = j + d;
          uint32_t o = 0;
          if (jj >= 0 && jj < nw) {
            o = tmp[r * rs + jj];
            if (r > 0) o |= tmp[(r - 1) * rs + jj];
            if (r + 1 < H) o |= tmp[(r + 1) * rs + jj];
          }
          v[d + 1] = o;
        }
        const uint32_t h = v[1] | (v[1] << 1) | (v[0] >> 31) | (v[1] >> 1) | (v[2] << 31);
        const uint32_t nv = h & mrow[r * rs + j];
        local |= reach[r * rs + j] != nv;
        reach[r * rs + j] = nv;
      }
    }
    changed = __syncthreads_or(local) != 0;
  }

  // unpack: one warp a word
  for (int wi = warp; wi < H * nw; wi += nwarps) {
    const int r = wi / nw, j = wi % nw, x = 32 * j + lane;
    if (x < W)
      out[static_cast<long long>(r) * W + x] =
          static_cast<uint8_t>((reach[r * rs + j] >> lane) & 1u);
  }
}

}  // namespace

// mask, seed, out: (B, H, W) bytes 0/1. scratch: B * plane_words(H, W)
// uint32 words in global memory, or null when the planes fit in shared
// memory (kSmemLimit). conn 4 or 8; at most max_iters sweeps.
extern "C" int cadx_flood_from_one_block(const void* mask, const void* seed, void* out,
                                         void* scratch, int B, int H, int W, int max_iters,
                                         int conn, void* stream) {
  if (B < 1 || H < 1 || W < 1 || (conn != 4 && conn != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = plane_words(H, W) * 4;
  const int smem = scratch ? 0 : static_cast<int>(bytes);
  if (!scratch && bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flood_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int threads = (H <= 256 && W <= 256) ? 256 : 1024;
  flood_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(seed),
      static_cast<uint8_t*>(out), static_cast<uint32_t*>(scratch), H, W, max_iters, conn);
  return static_cast<int>(cudaGetLastError());
}
