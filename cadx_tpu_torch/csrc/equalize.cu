// cv2.equalizeHist over chunks x images. Replaces
// cadx_tpu/kernels/equalize.py::equalize_hist_pallas; see
// cadx_tpu_torch/kernels/equalize.py for the layout and its bounds.
//
// One C call queues, on the caller's stream and with no host sync:
//   a memset   of the (B, 256) int32 histogram scratch;
//   histogram  each block counts its chunk of one image with 16-byte loads
//              into per-warp shared histograms, merges them and adds each
//              nonzero bin to the image's histogram with one global atomic;
//   lut_map    each block rebuilds its image's LUT from the finished
//              histogram (a block-wide prefix sum of the 256 bins, then
//              each bin's value on its own thread) and maps its chunk
//              through the LUT in shared memory, 16 bytes a load and store.
// The grid of both launches covers chunks x images in one flat dimension,
// so one large image fills the card as a batch of small ones does. A chunk
// is 1-16 passes of 4 KB (a block's 256 threads, 16 bytes each), as many as
// give about four blocks an SM of an H100 over the whole batch. Image b
// starts at byte b * H * W, which need not be 16-byte aligned: a block
// takes the bytes of its chunk before the first and after the last 16-byte
// boundary one a thread.
//
// The hot bin: a mammogram's zero background is about half its pixels, so
// a shared atomic a pixel would serialise most lanes of most warps on bin
// 0. Instead a thread whose 16 bytes hold one value joins the lanes of its
// warp that hold the same value (__match_any_sync) and their leader adds
// 16 times their count once; a thread whose 16 bytes differ adds each run
// of equal bytes once, counted in a register. The warps count into their
// own histograms, so warps never contend either.
//
// Integer atomics are exact in any order, so the histogram, and the LUT
// and output built from it, are the same on every run.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // one thread a bin in lut_map
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kVec = 16;                      // bytes a load
constexpr int kPass = kThreads * kVec;        // bytes a block reads a pass: 4 KB
constexpr int kMaxPasses = 16;                // a chunk of at most 64 KB
constexpr int kUnroll = 2;                    // loads a thread keeps in flight
constexpr long long kTargetBlocks = 4 * 132;  // about four blocks an SM

struct Chunks {
  long long n;    // H * W
  int chunk;      // bytes a block, a multiple of kPass
  int per_image;  // chunks an image
};

// This block's bytes [lo, hi) of the batch, cut at the 16-byte boundaries
// of the absolute address: a head [lo, mid0), the aligned body [mid0,
// mid1) and a tail [mid1, hi), head and tail under 16 bytes each.
struct Range {
  long long img, lo, mid0, mid1, hi;
};

__device__ __forceinline__ Range block_range(const Chunks& g, const void* base) {
  const unsigned b = blockIdx.x, per = g.per_image;
  const unsigned img = b / per, c = b - img * per;
  const long long start = img * g.n;
  const long long lo = start + static_cast<long long>(c) * g.chunk;
  const long long hi = min(lo + g.chunk, start + g.n);
  const long long mis = static_cast<long long>(reinterpret_cast<uintptr_t>(base) & 15u);
  const long long up = ((lo + mis + 15) & ~15ll) - mis, down = ((hi + mis) & ~15ll) - mis;
  const long long mid0 = min(up, hi), mid1 = max(down, mid0);
  return Range{img, lo, mid0, mid1, hi};
}

// The scalar bytes of the range (head, then tail): thread t < 32 takes one.
__device__ __forceinline__ long long scalar_byte(const Range& r) {
  const long long t = threadIdx.x, head = r.mid0 - r.lo;
  if (t < head) return r.lo + t;
  if (t >= 16 && t - 16 < r.hi - r.mid1) return r.mid1 + (t - 16);
  return -1;
}

// Count 16 bytes (valid where ok) into the warp's histogram h. Every lane
// of the warp calls it.
__device__ __forceinline__ void count16(uint4 v, bool ok, int* h) {
  const unsigned b0 = v.x & 0xffu, rep = b0 * 0x01010101u;
  const bool uniform = ok && v.x == rep && v.y == rep && v.z == rep && v.w == rep;
  const unsigned same = __ballot_sync(0xffffffffu, uniform);
  if (uniform) {
    const unsigned peers = __match_any_sync(same, b0);
    if (static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(h + b0, kVec * __popc(peers));
  } else if (ok) {
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
    unsigned cur = b0;
    int run = 0;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const unsigned byte = (words[k >> 2] >> (8 * (k & 3))) & 0xffu;
      if (byte != cur) {
        atomicAdd(h + cur, run);
        cur = byte;
        run = 0;
      }
      ++run;
    }
    atomicAdd(h + cur, run);
  }
}

// Load the vectors i0, i0 + kThreads, ... of a group (ok where they exist).
__device__ __forceinline__ void load_group(const uint4* __restrict__ src, long long nvec,
                                           long long i0, uint4 (&v)[kUnroll],
                                           bool (&ok)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = i0 + static_cast<long long>(u) * kThreads;
    ok[u] = i < nvec;
    v[u] = ok[u] ? __ldg(src + i) : make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint8_t* __restrict__ in, int* __restrict__ hist, Chunks g) {
  __shared__ int warp_hist[kWarps * kBins];
  const Range r = block_range(g, in);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint4* body = reinterpret_cast<const uint4*>(in + r.mid0);
  const long long nvec = (r.mid1 - r.mid0) / kVec;
  // the first loads fly while the histograms are cleared; the group's
  // start is the same for the warp's lanes, so all of them reach
  // count16's warp-wide votes
  long long base = warp * 32;
  uint4 v[kUnroll];
  bool ok[kUnroll];
  load_group(body, nvec, base + lane, v, ok);
  const long long s = scalar_byte(r);
  const int byte = s >= 0 ? in[s] : -1;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) warp_hist[i] = 0;
  __syncthreads();
  int* h = warp_hist + warp * kBins;
  if (byte >= 0) atomicAdd(h + byte, 1);
  while (true) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count16(v[u], ok[u], h);
    base += kThreads * kUnroll;
    if (base >= nvec) break;
    load_group(body, nvec, base + lane, v, ok);
  }
  __syncthreads();
  int c = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) c += warp_hist[w * kBins + threadIdx.x];
  if (c) atomicAdd(hist + r.img * kBins + threadIdx.x, c);
}

__device__ __forceinline__ unsigned map4(const uint8_t* lut, unsigned x) {
  return lut[x & 0xffu] | lut[(x >> 8) & 0xffu] << 8 | lut[(x >> 16) & 0xffu] << 16 |
         static_cast<unsigned>(lut[x >> 24]) << 24;
}

__global__ void __launch_bounds__(kThreads)
lut_map_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               const int* __restrict__ hist, Chunks g) {
  __shared__ int warp_sum[kWarps];
  __shared__ int cdf_min;
  __shared__ uint8_t lut[kBins];
  const Range r = block_range(g, in);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the chunk's first loads fly while the LUT is built
  const uint4* src = reinterpret_cast<const uint4*>(in + r.mid0);
  uint4* dst = reinterpret_cast<uint4*>(out + r.mid0);
  const long long nvec = (r.mid1 - r.mid0) / kVec;
  long long base = t;
  uint4 x[kUnroll];
  bool ok[kUnroll];
  load_group(src, nvec, base, x, ok);
  const long long s = scalar_byte(r);
  const int byte = s >= 0 ? in[s] : 0;
  // the CDF: an inclusive scan of the 256 bins, one a thread
  const int count = hist[r.img * kBins + t];
  int cdf = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, cdf, o);
    if (lane >= o) cdf += y;
  }
  if (lane == 31) warp_sum[warp] = cdf;
  if (t == 0) cdf_min = INT_MAX;
  __syncthreads();
  for (int w = 0; w < warp; ++w) cdf += warp_sum[w];
  // the CDF at the lowest occupied level, its smallest over the occupied
  // levels (it never falls), is that level's count
  if (count) atomicMin(&cdf_min, cdf);
  const int levels = __syncthreads_count(count > 0);
  // round((cdf - cdf_min) * 255 / denom) in f32, half to even, in this
  // order and without contraction, as the reference computes it; a
  // single-level image passes through unchanged
  const float denom = static_cast<float>(max(static_cast<int>(g.n) - cdf_min, 1));
  float v = __fdiv_rn(__fmul_rn(static_cast<float>(cdf - cdf_min), 255.0f), denom);
  v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  lut[t] = levels <= 1 ? static_cast<uint8_t>(t) : static_cast<uint8_t>(v);
  __syncthreads();
  if (s >= 0) out[s] = lut[byte];
  while (true) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (ok[u])
        dst[base + u * kThreads] = make_uint4(map4(lut, x[u].x), map4(lut, x[u].y),
                                              map4(lut, x[u].z), map4(lut, x[u].w));
    base += kThreads * kUnroll;
    if (base >= nvec) break;
    load_group(src, nvec, base, x, ok);
  }
}

}  // namespace

// in, out: (B, H, W) uint8 whose addresses agree modulo 16; hist: (B, 256)
// int32 scratch.
extern "C" int cadx_equalize_hist(const void* in, void* out, void* hist, int B, int H, int W,
                                  void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (((reinterpret_cast<uintptr_t>(in) ^ reinterpret_cast<uintptr_t>(out)) & 15u) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long n = static_cast<long long>(H) * W, total = n * B;
  const long long per_block = (total + kTargetBlocks - 1) / kTargetBlocks;
  const long long passes = min(max((per_block + kPass - 1) / kPass, 1ll),
                               static_cast<long long>(kMaxPasses));
  const int chunk = static_cast<int>(passes) * kPass;
  const long long per_image = (n + chunk - 1) / chunk, blocks = per_image * B;
  if (n > INT_MAX || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Chunks g{n, chunk, static_cast<int>(per_image)};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(hist, 0, static_cast<size_t>(B) * kBins * sizeof(int), s);
  const auto* src = static_cast<const uint8_t*>(in);
  histogram_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      src, static_cast<int*>(hist), g);
  lut_map_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      src, static_cast<uint8_t*>(out), static_cast<const int*>(hist), g);
  return static_cast<int>(cudaGetLastError());
}
