// Mask of the largest-area label in three forms, chosen by shape. Replaces
// cadx_tpu/kernels/mode.py::largest_component_mask_pallas; see
// cadx_tpu_torch/kernels/mode.py for the layout and its bounds.
//
// All forms take the argmax from the adds themselves: an atomic add returns
// the area before it, so the area after it is a lower bound on its label's
// final area, and the last add to a label gives exactly that. The largest
// (area << 32) | ~label key over all adds is therefore the key of the label
// with the largest area, the smallest such label on ties, with no pass over
// the areas. The lanes of a warp that hold one label add once together
// (__match_any_sync), so a blob's pixels do not queue on one address.
//
// The cluster form, for planes of at most 64 x 64 (the serving path's CAM
// labels at 62x62): one launch, a thread block cluster of kClusterBlocks
// blocks an image; the block form, which the wrapper takes up to 1,024
// pixels (the 6x6 CAM labels), the same kernel at one block an image in a
// plain launch with no cluster barrier (a cluster launch's barriers cost
// more there than the split saves). Block r owns the
// labels and the pixels in [r * per, (r + 1) * per), per = ceil(H * W / K):
// the labels' areas are a histogram in its shared memory, and a pixel whose
// label another block owns adds there through the cluster's distributed
// shared memory. Each block takes the largest key of its adds, warp 0
// reduces the cluster's keys through distributed shared memory, and each
// block writes its pixels of the output from the labels it still holds in
// registers. No global scratch.
//
// The wide form, for any shape: a memset of the (B,) 64-bit keys and the
// (B, H * W) int32 area plane, then two launches over chunks x images:
// count_kernel adds each pixel to its label's area in the plane and takes
// each block's largest key to its image's with one 64-bit atomicMax;
// select_kernel writes mask & (label == the key's label).
//
// Integer atomics are exact in any order, so the output is the same on
// every run.
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kClusterSide = 64;        // the block and cluster forms' largest side
constexpr int kClusterThreads = 1024;
constexpr int kClusterBlocks = 8;
constexpr int kMaxPix = kClusterSide * kClusterSide / kClusterThreads;  // pixels a thread
constexpr int kWideThreads = 256;
constexpr long long kTargetBlocks = 4 * 132;  // about four blocks an SM
constexpr int kMaxChunk = 16 * 1024;

// (area, ~label): the larger key has the larger area and, among equal areas,
// the smaller label; 0 is no label.
__device__ __forceinline__ unsigned long long key_of(int area, int label) {
  return (static_cast<unsigned long long>(area) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(label));
}

__device__ __forceinline__ int label_of(unsigned long long key) {
  return key ? static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull)) : -1;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// Adds a counted pixel (fg) to the area of its label through add(label,
// count), which returns the area before the add; the warp's lanes of one
// label add once, by their first lane. Returns the key of the area after
// the add to that lane, else 0. Every lane of the warp calls it.
template <class Add>
__device__ __forceinline__ unsigned long long add_pixel(bool fg, int label, const Add& add) {
  const int lane = threadIdx.x & 31;
  // a lane with no pixel gets a value no label has
  const unsigned peers = __match_any_sync(0xffffffffu, fg ? label : -1 - lane);
  if (!fg || lane != __ffs(peers) - 1) return 0ull;
  const int count = __popc(peers);
  return key_of(add(label, count) + count, label);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cluster form (see above) where kCluster; else the block form (K = 1,
// a plain launch, no cluster barrier). Dynamic shared memory: per ints.
template <bool kCluster>
__global__ void __launch_bounds__(kClusterThreads)
mode_cluster(const int* __restrict__ labels, const uint8_t* __restrict__ mask,
             uint8_t* __restrict__ out, int n, int per) {
  extern __shared__ int area[];
  __shared__ unsigned long long block_key, image_key;
  const int K = kCluster ? static_cast<int>(cg::this_cluster().num_blocks()) : 1;
  const int r = kCluster ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long base = static_cast<long long>(blockIdx.x / K) * n;
  const int lo = r * per, hi = min(lo + per, n), t = threadIdx.x;
  const int iters = (hi - lo + static_cast<int>(blockDim.x) - 1) / static_cast<int>(blockDim.x);
  const auto sync = [] {
    if constexpr (kCluster) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  };
  int lab[kMaxPix];
  bool fg[kMaxPix];
  // a foreground label outside [0, H*W) is no component's raster index: it
  // is not counted and never chosen
#pragma unroll
  for (int i = 0; i < kMaxPix; ++i) {
    const int p = lo + t + i * static_cast<int>(blockDim.x);
    const bool in = i < iters && p < hi;
    lab[i] = in ? labels[base + p] : -1;
    fg[i] = in && mask[base + p] != 0 && lab[i] >= 0 && lab[i] < n;
  }
  for (int i = t; i < per; i += blockDim.x) area[i] = 0;
  if (t == 0) block_key = 0ull;
  sync();  // every histogram cleared before any add
  const auto add = [&](int label, int count) {
    const int owner = label / per;
    int* slot = area;
    if constexpr (kCluster) {
      if (owner != r) slot = cg::this_cluster().map_shared_rank(area, owner);
    }
    return atomicAdd(slot + (label - owner * per), count);
  };
  unsigned long long best = 0ull;
#pragma unroll
  for (int i = 0; i < kMaxPix; ++i) {
    if (i >= iters) break;  // the same for every thread of the block
    const unsigned long long k = add_pixel(fg[i], lab[i], add);
    best = k > best ? k : best;
  }
  best = warp_max(best);
  if ((t & 31) == 0 && best) atomicMax(&block_key, best);
  sync();  // every add made, every block's key in place
  if constexpr (kCluster) {
    if (t < 32) {
      const unsigned long long k =
          t < K ? *cg::this_cluster().map_shared_rank(&block_key, t) : 0ull;
      const unsigned long long m = warp_max(k);
      if (t == 0) image_key = m;
    }
    cluster_arrive();  // this block reads no other block's shared memory now
    __syncthreads();
  }
  const int L = label_of(kCluster ? image_key : block_key);
#pragma unroll
  for (int i = 0; i < kMaxPix; ++i) {
    const int p = lo + t + i * static_cast<int>(blockDim.x);
    if (i < iters && p < hi) out[base + p] = fg[i] && lab[i] == L;
  }
  if constexpr (kCluster) cluster_wait();  // no block leaves while another may read its key
}

struct Chunks {
  long long n;    // H * W
  int chunk;      // pixels a block, a multiple of kWideThreads
  int per_image;  // chunks an image
};

// The wide form's count: block b of the grid takes chunk b % per_image of
// image b / per_image, a pixel a thread a pass.
__global__ void __launch_bounds__(kWideThreads)
count_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ mask,
             int* __restrict__ area, unsigned long long* __restrict__ keys, Chunks g) {
  __shared__ unsigned long long block_key;
  const long long img = blockIdx.x / g.per_image;
  const long long lo = (blockIdx.x - img * g.per_image) * static_cast<long long>(g.chunk);
  const long long hi = min(lo + g.chunk, g.n), base = img * g.n;
  int* a = area + base;
  const auto add = [&](int label, int count) { return atomicAdd(a + label, count); };
  if (threadIdx.x == 0) block_key = 0ull;
  __syncthreads();
  unsigned long long best = 0ull;
  for (long long p = lo + threadIdx.x; p < lo + g.chunk; p += kWideThreads) {
    const bool in = p < hi;
    const int l = in ? labels[base + p] : -1;
    const bool fg = in && mask[base + p] != 0 && l >= 0 && l < g.n;
    const unsigned long long k = add_pixel(fg, l, add);
    best = k > best ? k : best;
  }
  best = warp_max(best);
  if ((threadIdx.x & 31) == 0 && best) atomicMax(&block_key, best);
  __syncthreads();
  if (threadIdx.x == 0 && block_key) atomicMax(keys + img, block_key);
}

__global__ void __launch_bounds__(kWideThreads)
select_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ mask,
              const unsigned long long* __restrict__ keys, uint8_t* __restrict__ out,
              Chunks g) {
  const long long img = blockIdx.x / g.per_image;
  const long long lo = (blockIdx.x - img * g.per_image) * static_cast<long long>(g.chunk);
  const long long hi = min(lo + g.chunk, g.n), base = img * g.n;
  // L is -1 or a label in [0, H*W), so label == L holds only for counted
  // pixels
  const int L = label_of(keys[img]);
  for (long long p = lo + threadIdx.x; p < hi; p += kWideThreads)
    out[base + p] = mask[base + p] != 0 && labels[base + p] == L;
}

}  // namespace

// labels: (B, H, W) int32; mask, out: (B, H, W) bytes 0/1. form: 0 the
// wide form, whose scratch is B 64-bit keys followed by a (B, H, W) int32
// plane (8 B + 4 B H W bytes, 8-byte aligned); 1 the block form and 2 the
// cluster form, which need H, W <= kClusterSide.
extern "C" int cadx_largest_component_mask(const void* labels, const void* mask, void* out,
                                           void* scratch, int B, int H, int W, int form,
                                           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* lab = static_cast<const int*>(labels);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<uint8_t*>(out);
  const long long n = static_cast<long long>(H) * W;
  if (form == 1 || form == 2) {
    const int K = form == 2 ? kClusterBlocks : 1;
    if (H > kClusterSide || W > kClusterSide || static_cast<long long>(B) * K > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    const int per = static_cast<int>((n + K - 1) / K);
    const unsigned threads = min(kClusterThreads, (per + 31) / 32 * 32);
    const size_t smem = static_cast<size_t>(per) * sizeof(int);
    if (K == 1) {
      mode_cluster<false><<<B, threads, smem, s>>>(lab, m, o, static_cast<int>(n), per);
      return static_cast<int>(cudaGetLastError());
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(B) * K);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, mode_cluster<true>, lab, m, o, static_cast<int>(n), per);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : last);
  }
  if (form != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = n * B;
  const long long per_block = (total + kTargetBlocks - 1) / kTargetBlocks;
  const long long chunk = min(max((per_block + 1023) / 1024 * 1024, 1024ll),
                              static_cast<long long>(kMaxChunk));
  const long long per_image = (n + chunk - 1) / chunk, blocks = per_image * B;
  if (!scratch || n > INT_MAX || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Chunks g{n, static_cast<int>(chunk), static_cast<int>(per_image)};
  auto* keys = static_cast<unsigned long long*>(scratch);
  auto* area = reinterpret_cast<int*>(keys + B);
  cudaMemsetAsync(scratch, 0, static_cast<size_t>(B) * (sizeof(unsigned long long) +
                                                        sizeof(int) * static_cast<size_t>(n)),
                  s);
  const auto grid = static_cast<unsigned>(blocks);
  count_kernel<<<grid, kWideThreads, 0, s>>>(lab, m, area, keys, g);
  select_kernel<<<grid, kWideThreads, 0, s>>>(lab, m, keys, o, g);
  return static_cast<int>(cudaGetLastError());
}
