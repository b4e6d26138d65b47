// Adam's update over all of a model's parameter tensors in one launch.
// Replaces no pallas_call: the JAX package leaves Adam to optax under XLA;
// see cadx_tpu_torch/kernels/adam.py for the arithmetic and its bound.
//
// Bound: bytes. An element reads p, g, mu and nu once and writes p, mu and
// nu once (28 bytes); the arithmetic, three IEEE divisions and a square
// root, is far below the card's rate. So the kernel streams: 16-byte loads
// and stores a thread, kUnroll vectors of each tensor in flight before any
// arithmetic, g read with an evict-first load.
//
// The leaves' pointers and sizes travel in the kernel's by-value parameter
// struct (at most kMaxLeaves a launch, 3 KB of the 4 KB limit), so there is
// no device table and no host-to-device copy. Blocks map to leaves by a
// prefix over each leaf's block count. A leaf whose four tensors share
// their offset from 16-byte alignment runs its aligned body as float4s,
// with its 0-3 head and 0-3 tail elements taken by its first block; any
// other leaf runs a scalar loop over the same element ranges.
//
// Arithmetic is float32 with the round-to-nearest intrinsics, in optax's
// order and as PyTorch's eager ops round it (the plain version in
// kernels/adam.py), so the result is bit-exact to it.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kVecPerBlock = kThreads * kUnroll;   // float4s a block
constexpr int kElemsPerBlock = kVecPerBlock * 4;   // elements a block
constexpr int kMaxLeaves = 64;

struct Leaf {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  long long n;       // elements
  int head;          // elements before the first 16-byte-aligned one, or -1: scalar
  int first_block;   // the leaf's first block in the launch
};

struct Hyper {
  float b1, c1, b2, c2, eps, neg_lr, bc1, bc2;
};

struct Params {
  Leaf leaf[kMaxLeaves];
  Hyper h;
  int leaves;
};
static_assert(sizeof(Params) <= 4096, "kernel parameters exceed 4 KB");

// mu = mu*b1 + (1-b1)*g; nu = nu*b2 + (1-b2)*(g*g); mu_hat = mu / bc1;
// nu_hat = nu / bc2; p = p + (-lr) * (mu_hat / (sqrt(nu_hat) + eps)).
__device__ __forceinline__ void update(float& p, float g, float& mu, float& nu,
                                       const Hyper& h) {
  mu = __fadd_rn(__fmul_rn(mu, h.b1), __fmul_rn(h.c1, g));
  nu = __fadd_rn(__fmul_rn(nu, h.b2), __fmul_rn(h.c2, __fmul_rn(g, g)));
  const float mu_hat = __fdiv_rn(mu, h.bc1);
  const float nu_hat = __fdiv_rn(nu, h.bc2);
  p = __fadd_rn(p, __fmul_rn(h.neg_lr,
                             __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), h.eps))));
}

__device__ __forceinline__ void update_at(const Leaf& L, long long i, const Hyper& h) {
  float p = L.p[i], mu = L.mu[i], nu = L.nu[i];
  update(p, __ldcs(L.g + i), mu, nu, h);
  L.p[i] = p;
  L.mu[i] = mu;
  L.nu[i] = nu;
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& mu, float4& nu,
                                        const Hyper& h) {
  update(p.x, g.x, mu.x, nu.x, h);
  update(p.y, g.y, mu.y, nu.y, h);
  update(p.z, g.z, mu.z, nu.z, h);
  update(p.w, g.w, mu.w, nu.w, h);
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const __grid_constant__ Params P) {
  // the leaf whose blocks hold this one: the last with first_block <= blockIdx.x
  int lo = 0, hi = P.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (P.leaf[mid].first_block <= static_cast<int>(blockIdx.x)) lo = mid;
    else hi = mid - 1;
  }
  const Leaf& L = P.leaf[lo];
  const Hyper& h = P.h;
  const long long blk = static_cast<long long>(blockIdx.x) - L.first_block;

  if (L.head < 0) {
    const long long base = blk * kElemsPerBlock + threadIdx.x;
#pragma unroll 4
    for (int k = 0; k < 4 * kUnroll; ++k) {
      const long long i = base + static_cast<long long>(k) * kThreads;
      if (i < L.n) update_at(L, i, h);
    }
    return;
  }

  const long long nvec = (L.n - L.head) >> 2;
  float4* p4 = reinterpret_cast<float4*>(L.p + L.head);
  const float4* g4 = reinterpret_cast<const float4*>(L.g + L.head);
  float4* mu4 = reinterpret_cast<float4*>(L.mu + L.head);
  float4* nu4 = reinterpret_cast<float4*>(L.nu + L.head);
  const long long v0 = blk * kVecPerBlock + threadIdx.x;
  float4 p[kUnroll], g[kUnroll], mu[kUnroll], nu[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long v = v0 + u * kThreads;
    if (v < nvec) {
      g[u] = __ldcs(g4 + v);
      p[u] = p4[v];
      mu[u] = mu4[v];
      nu[u] = nu4[v];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long v = v0 + u * kThreads;
    if (v < nvec) {
      update4(p[u], g[u], mu[u], nu[u], h);
      p4[v] = p[u];
      mu4[v] = mu[u];
      nu4[v] = nu[u];
    }
  }
  if (blk == 0) {
    // the head (elements 0 .. head-1) and the tail (after the last float4)
    const long long tail = L.head + (nvec << 2);
    const int t = threadIdx.x;
    if (t < L.head) update_at(L, t, h);
    else if (t - L.head < L.n - tail) update_at(L, tail + (t - L.head), h);
  }
}

}  // namespace

// One Adam step over `leaves` parameter tensors, each of n[i] contiguous
// float32 elements: p[i] += ..., mu[i] and nu[i] updated in place, from the
// gradient g[i]. The pointer and size arrays are host memory, read before
// this returns. b1, c1 = 1 - b1, b2, c2 = 1 - b2, eps and neg_lr = -lr are
// the Python scalars rounded to float32; bc1 and bc2 the step's bias
// corrections 1 - b^t. One launch a kMaxLeaves non-empty leaves, their
// number written to the host int *launches; no host sync.
extern "C" int cadx_adam_step(const void* const* p, const void* const* g,
                              const void* const* mu, const void* const* nu,
                              const long long* n, int leaves, float b1, float c1, float b2,
                              float c2, float eps, float neg_lr, float bc1, float bc2,
                              int* launches, void* stream) {
  *launches = 0;
  if (leaves < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params P;
  P.h = Hyper{b1, c1, b2, c2, eps, neg_lr, bc1, bc2};
  int i = 0;
  while (i < leaves) {
    P.leaves = 0;
    long long blocks = 0;
    for (; i < leaves && P.leaves < kMaxLeaves; ++i) {
      if (n[i] <= 0) continue;
      Leaf& L = P.leaf[P.leaves++];
      L.p = static_cast<float*>(const_cast<void*>(p[i]));
      L.g = static_cast<const float*>(g[i]);
      L.mu = static_cast<float*>(const_cast<void*>(mu[i]));
      L.nu = static_cast<float*>(const_cast<void*>(nu[i]));
      L.n = n[i];
      const uintptr_t off = reinterpret_cast<uintptr_t>(p[i]) & 15;
      const bool shared = ((reinterpret_cast<uintptr_t>(g[i]) & 15) == off &&
                           (reinterpret_cast<uintptr_t>(mu[i]) & 15) == off &&
                           (reinterpret_cast<uintptr_t>(nu[i]) & 15) == off);
      const long long head = static_cast<long long>((16 - off) & 15) / 4;
      L.head = shared ? static_cast<int>(head < L.n ? head : L.n) : -1;
      L.first_block = static_cast<int>(blocks);
      blocks += (L.n + kElemsPerBlock - 1) / kElemsPerBlock;
      if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    }
    if (P.leaves == 0) break;
    adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}
