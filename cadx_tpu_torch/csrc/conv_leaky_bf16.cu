// Fused k x k stride-1 convolution + bias + LeakyReLU in bfloat16 on the
// tensor cores: the bfloat16 form of conv_leaky.cu, for the classifiers'
// opt-in mixed precision (models/cnn.py::conv_stack(..., compute_dtype=)).
// Replaces cadx_tpu/kernels/nn_kernels.py::conv2d_leaky_pallas (its
// pallas_call at :63) at bfloat16, which JAX leaves to XLA's conv in
// cnn.conv_stack; see cadx_tpu_torch/kernels/conv_leaky.py for the
// contract.
//
// Bound. 2 B OH OW F C k^2 operations at 989 TFLOP/s (dense bf16) against
// x, w, b read once and the output written once at 3.35 TB/s (H100 SXM).
// At the shapes of the bf16 training path (chip_smoke.py phase 11) the
// bytes bound it: advanced layer 1 at B=32 (x 32x64x256x256 on the NHWC
// view, 32 filters) moves 402.7 MB, 0.1202 ms, against 77.3 GFLOP, 0.0782
// ms; advanced layer 2 at B=32 (the pool's NCHW 32x32x128x128, 64 filters)
// 100.7 MB, 0.0301 ms, against 0.0195 ms; at B=16 half of each; basic
// layer 1 at B=8 (8x64x32x32, 128 filters, VALID) is bound by its 1.06
// GFLOP, 0.00107 ms (bytes 0.00091), basic layer 2 at B=8 (8x128x15x15, 64
// filters) by its 0.78 MB, 0.00023 ms.
//
// Design: a direct implicit GEMM, M = output pixels, N = filters, K = C k^2,
// in persistent blocks of 8 warps that keep their operands on chip. It
// answers the four findings against the design it replaced (8 x 16 pixels
// a block, weights staged again by every block, plain loads between two
// barriers, two-byte stores; its last record 0.6003 ms against this
// kernel's 0.2975 at advanced layer 1, B=32, PERF.md section 6 row 11):
// - Weights stay on chip. A block works for one group of BN filters (32,
//   or 64 where F > 32; grid y is the group) and, where they fit, stages
//   all of that group's k^2 BN C weights once (36.9 KB at both advanced
//   layers; basic layer 1's 128 filters are two groups of 73.7 KB) for
//   every tile it walks; the replaced design read 604 MB of weights from
//   L2 at advanced layer 1. Where they do not fit beside the ring, each
//   ring stage carries its chunk's weights.
// - Larger output tiles, walked persistently: a block computes TM output
//   pixels (TR rows x TC columns; TM = 512 at BN = 32, 256 at BN = 64; TC
//   64, or 32 or 16 for narrow images) by BN filters, and walks tiles
//   b, b + G, ... of images x tile rows x tile columns, G blocks a filter
//   group, one block an SM. An 8 x 64 tile's 10 x 66 halo window reads
//   1.29 x the input at k = 3 (1.41 x at 8 x 16).
// - Copies run ahead asynchronously in a ring. K runs in chunks of KC = 32
//   channels (16 where 32 does not fit); a step is one chunk of one tile.
//   A ring of 2-3 stages holds the halo windows of the next steps, each
//   one TMA box issued by one thread and counted on the stage's mbarrier,
//   while this step's MMAs run: on the NHWC view a 4-D tensor map over
//   (C, W, H, B), 64-byte swizzle, zeros outside the image (the SAME
//   padding comes free); on NCHW (W a multiple of 8) one over (W, H, C,
//   B) whose box starts on a 16-byte boundary of the row, transposed to
//   pixel-major in shared memory when its step comes. Other inputs (C or W
//   not a multiple of 8, unaligned) are staged with plain loads, eight in
//   flight a thread. Resident or streamed weights come by cp.async. A
//   barrier a step releases the slot that the next copy refills.
// - The MMA is mma.sync m16n8k16 (bf16 operands, float32 sums) from
//   ldmatrix: a warp's 64 pixels x 32 filters do 16 MMAs for 6 ldmatrix.x4
//   a 16-channel step, the taps unrolled at k = 3. The A operand (16
//   pixels x 16 channels, shifted by the tap) and B (the tap's filters)
//   sit in shared memory whose 16-byte units are XOR-swizzled by row,
//   TMA's own 64-byte swizzle, so the 8 rows of every 8 x 8 matrix fall
//   in different banks whatever the tap's shift. wgmma m64n32k16, its A
//   from the same ldmatrix fragments and B by descriptor, was built and
//   timed in turns with this kernel on an H100 and was not faster: the
//   tensor cores are not what bounds it, so mma.sync stays. (wgmma's A
//   from shared memory needs a descriptor, whose start cannot follow a
//   one-pixel shift inside a swizzled tile.)
// - A coalesced epilogue. The block rounds its sums as JAX does (the sum to
//   bf16, XLA's conv result type; plus the float32 bias, to bf16; LeakyReLU
//   in bf16, alpha rounded to bf16, the product rounded), writes the bf16
//   tile to shared memory filter-major, and one thread stores it with one
//   TMA box (its parts outside the output unwritten), which runs while the
//   block goes on; where OW is not a multiple of 8, 16-byte runs byte by
//   byte. The next tile's epilogue waits for the store to have read.
#include <algorithm>
#include <atomic>
#include <cstdint>

#include <cuda.h>             // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>     // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWN = 32;                 // filters a warp: four n8 tiles
constexpr int kWM = 64;                 // pixels a warp: four m16 tiles
constexpr int kMaxSmem = 227 * 1024;    // a block's shared memory on an H100
constexpr int kAlign = 1024;            // stage alignment: TMA's swizzle repeats within it

enum Path { kNhwcTma = 0, kNchwTma = 1, kPlainLoads = 2 };

struct Plan {
  int B, C, C8, H, W, F, k, pad, OH, OW, layout, path, tma_out;
  int TC, TR, tiles_x, tiles_y;    // output tile columns and rows; tiles a row, a column
  int WR, WC, WCa, lead;           // the halo window: rows, columns; NCHW stage row, lead
  int nchunk, resident, stages;    // channel chunks; all weights staged once; ring stages
  long long items;                 // tiles of a filter group: B x tiles_y x tiles_x
  int in_bytes;                    // a TMA stage's bytes
  int off_ring, ring_in, stage_bytes, off_comp, off_out, out_pitch, smem;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most n of this thread's groups are pending (n = stages - 2)
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a 4-D box of the tensor map to shared memory, its bytes counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// a 4-D box from shared memory to the tensor map's global tensor
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                          uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3, %4}], "
      "[%5];\n" ::"l"(map),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the last store has read its shared memory
__device__ __forceinline__ void tma_store_drained() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// mma.sync m16n8k16, row-major A (16 x 16), column-major B (16 x 8), float32
// accumulators in place
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of 16-byte unit u of row `row` (a pixel's or a filter's KC
// channels, 2 KC bytes): the unit XORed with the row's place among the
// rows that share a 128-byte line of banks, so any 8 consecutive rows at
// one unit fall in 8 different 16-byte bank groups. It is TMA's 64-byte
// swizzle at KC = 32 and its 32-byte one at KC = 16, from a base aligned
// to kAlign.
template <int KC>
__device__ __forceinline__ int swz(int row, int u) {
  constexpr int U = KC / 8, shift = U == 4 ? 1 : 2;
  return row * (KC * 2) + ((u ^ ((row >> shift) & (U - 1))) << 4);
}

// A step's tile: image, tile row and column.
struct Tile {
  long long img;
  int ty, tx;
};

__device__ __forceinline__ Tile tile_of(const Plan& p, long long item) {
  const long long rest = item / p.tiles_x;
  return {rest / p.tiles_y, static_cast<int>(rest % p.tiles_y),
          static_cast<int>(item % p.tiles_x)};
}

template <int BN, int KC>
struct Kernel {
  static constexpr int kWarpsN = BN / kWN, kWarpsM = kWarps / kWarpsN, TM = kWarpsM * kWM;
  static constexpr int U = KC / 8;    // 16-byte units a staged row

  // Stage step `step` of this block (chunk j of its tile step / nchunk)
  // into ring slot step % stages: its halo window (one TMA box, or plain
  // loads) and, where the weights are not resident, the chunk's weights.
  static __device__ void stage(const Plan& p, long long step, const __nv_bfloat16* x,
                               const __nv_bfloat16* wt, const CUtensorMap* tin,
                               unsigned char* smem, uint32_t bars) {
    const Tile tl = tile_of(p, blockIdx.x + step / p.nchunk * gridDim.x);
    const int j = static_cast<int>(step % p.nchunk), c0 = j * KC;
    const int iy0 = tl.ty * p.TR - p.pad, ix0 = tl.tx * p.TC - p.pad;
    const int slot_i = static_cast<int>(step % p.stages);
    unsigned char* slot = smem + p.off_ring + slot_i * p.stage_bytes;
    const uint32_t sslot = smem_addr(slot);
    if (p.path != kPlainLoads) {
      if (threadIdx.x == 0) {
        const uint32_t bar = bars + slot_i * 8;
        mbar_expect(bar, p.in_bytes);
        if (p.path == kNhwcTma)
          tma_load(sslot, tin, c0, ix0, iy0, static_cast<int>(tl.img), bar);
        else
          tma_load(sslot, tin, ix0 - p.lead, iy0, c0, static_cast<int>(tl.img), bar);
      }
    } else {
      // kBatch loads in flight a thread, then their stores
      constexpr int kBatch = 8;
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      const int wpx = p.WR * p.WC, total = wpx * KC;
      for (int first = threadIdx.x; first < total; first += kThreads * kBatch) {
        __nv_bfloat16 v[kBatch];
        int at[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int i = first + b * kThreads;
          v[b] = zero;
          at[b] = -1;
          if (i >= total) continue;
          // NHWC: a pixel's channels on neighbouring threads; NCHW: pixels
          int px, cc;
          if (p.layout == 1) {
            px = i / KC;
            cc = i - px * KC;
          } else {
            cc = i / wpx;
            px = i - cc * wpx;
          }
          const int wy = px / p.WC, y = iy0 + wy, xx = ix0 + px - wy * p.WC, c = c0 + cc;
          at[b] = swz<KC>(px, cc >> 3) + (cc & 7) * 2;
          if (static_cast<unsigned>(y) < static_cast<unsigned>(p.H) &&
              static_cast<unsigned>(xx) < static_cast<unsigned>(p.W) && c < p.C)
            v[b] = p.layout == 1
                       ? x[((tl.img * p.H + y) * p.W + xx) * static_cast<long long>(p.C) + c]
                       : x[((tl.img * p.C + c) * p.H + y) * static_cast<long long>(p.W) + xx];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (at[b] >= 0) *reinterpret_cast<__nv_bfloat16*>(slot + at[b]) = v[b];
      }
    }
    if (!p.resident) stage_weights(p, j, wt, sslot + p.ring_in);
  }

  // The weights of chunk j of this block's filters, [tap][filter][KC], to
  // shared memory at dst; rows past F and units past C8 zero-filled. wt is
  // (k, k, F, C8), C8 = C rounded up to 8.
  static __device__ void stage_weights(const Plan& p, int j, const __nv_bfloat16* wt,
                                       uint32_t dst) {
    const int f0 = blockIdx.y * BN, c0 = j * KC, rows = p.k * p.k * BN;
    for (int i = threadIdx.x; i < rows * U; i += kThreads) {
      const int q = i / U, u = i - q * U, tap = q / BN, f = f0 + q - tap * BN, c = c0 + u * 8;
      const bool ok = f < p.F && c < p.C8;
      const __nv_bfloat16* src = ok ? wt + (static_cast<long long>(tap) * p.F + f) * p.C8 + c : wt;
      cp16(dst + swz<KC>(q, u), src, ok);
    }
  }

  // The channel-major NCHW stage of a step ([channel][row][WCa columns],
  // from `lead` columns left of the window, where a 16-byte boundary of
  // the row falls: TMA's boxes start there) to the pixel-major window that
  // the MMAs read: a thread a (pixel, 8 channels), one 16-byte store.
  static __device__ void transpose(const Plan& p, const unsigned char* slot, unsigned char* comp) {
    const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(slot);
    const int wpx = p.WR * p.WC, plane = p.WR * p.WCa;
    for (int i = threadIdx.x; i < wpx * U; i += kThreads) {
      const int px = i % wpx, u = i / wpx, wy = px / p.WC;
      const __nv_bfloat16* s = src + u * 8 * plane + wy * p.WCa + p.lead + px - wy * p.WC;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = __bfloat16_as_ushort(s[(2 * e) * plane]);
        const uint32_t hi = __bfloat16_as_ushort(s[(2 * e + 1) * plane]);
        v[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(comp + swz<KC>(px, u)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
};

// One tap's products: for each 16 channels of the chunk, the B fragments of
// the warp's 32 filters (two ldmatrix.x4) and, for each of its four m16
// tiles, the A fragment of the window shifted by the tap (`shift` pixels)
// and four MMAs.
template <int BN, int KC>
__device__ __forceinline__ void tap_mma(float (&acc)[kWM / 16][4][4], uint32_t abuf,
                                        uint32_t wbuf, const int (&pxb)[kWM / 16], int shift,
                                        int tap, int lane, int wn) {
#pragma unroll
  for (int h = 0; h < KC / 16; ++h) {
    uint32_t b[2][4];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int q = tap * BN + wn * kWN + nn * 16 + (lane >> 4) * 8 + (lane & 7);
      ldsm4(b[nn], wbuf + swz<KC>(q, h * 2 + ((lane >> 3) & 1)));
    }
#pragma unroll
    for (int mt = 0; mt < kWM / 16; ++mt) {
      uint32_t a[4];
      ldsm4(a, abuf + swz<KC>(pxb[mt] + shift, h * 2 + (lane >> 4)));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma16816(acc[mt][nt], a, &b[nt >> 1][(nt & 1) * 2]);
    }
  }
}

// KK: 3 where k = 3 (the taps unrolled), else 0 (any k). tin: the input's
// tensor map (NHWC: (C, W, H, B), boxes of KC x WC x WR x 1, swizzled;
// NCHW: (W, H, C, B), boxes of WCa x WR x KC x 1); tout: the output's, (OW,
// OH, F, B), boxes of TC x TR x BN x 1. Each is read only where its path
// takes it.
template <int BN, int KC, int KK>
__global__ void __launch_bounds__(kThreads, 1)
conv_bf16_persistent(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, Plan p,
                     float alpha, const __grid_constant__ CUtensorMap tin,
                     const __grid_constant__ CUtensorMap tout) {
  using K = Kernel<BN, KC>;
  constexpr int MT = kWM / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the layout's base, aligned for TMA's swizzle; the ring's full barriers
  // sit just below it
  unsigned char* smem = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const uint32_t sbase = smem_addr(smem);
  const uint32_t bars = sbase + p.off_ring - 8 * p.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / K::kWarpsN, wn = warp - wm * K::kWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.y * BN, taps = p.k * p.k;
  const long long mine =
      p.items > blockIdx.x ? (p.items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = mine * p.nchunk;

  // this thread's filters' biases; the window offsets of its m16 tiles
  float bz[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = f0 + wn * kWN + nt * 8 + 2 * t + e;
      bz[nt][e] = f < p.F ? bias[f] : 0.f;
    }
  int pxb[MT];    // the window pixel of this lane's A row at tap (0, 0)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = wm * kWM + mt * 16, row = m / p.TC;
    pxb[mt] = row * p.WC + m - row * p.TC + (lane & 15);
  }
  const float alpha_b = __bfloat162float(__float2bfloat16_rn(alpha));

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // prologue: the resident weights and the first stages - 1 steps, the
  // weights in the first step's cp.async group; a group a step, empty past
  // the end
  if (p.resident)
    for (int j = 0; j < p.nchunk; ++j)
      K::stage_weights(p, j, wt, sbase + j * taps * BN * KC * 2);
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < steps) K::stage(p, s, x, wt, &tin, smem, bars);
    cp_commit();
  }

  float acc[MT][4][4];
  for (long long s = 0; s < steps; ++s) {
    const int slot = static_cast<int>(s % p.stages), j = static_cast<int>(s % p.nchunk);
    cp_wait(p.stages - 2);
    if (p.path != kPlainLoads) mbar_wait(bars + 8 * slot, static_cast<uint32_t>(s / p.stages) & 1);
    __syncthreads();    // step s landed for all; every warp is past step s - 1
    if (s + p.stages - 1 < steps) K::stage(p, s + p.stages - 1, x, wt, &tin, smem, bars);
    cp_commit();
    unsigned char* sslot = smem + p.off_ring + slot * p.stage_bytes;
    uint32_t abuf = smem_addr(sslot);
    if (p.path == kNchwTma) {
      K::transpose(p, sslot, smem + p.off_comp);
      __syncthreads();
      abuf = sbase + p.off_comp;
    }
    const uint32_t wbuf =
        p.resident ? sbase + j * taps * BN * KC * 2 : smem_addr(sslot + p.ring_in);
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
    }
    if (KK == 3) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        tap_mma<BN, KC>(acc, abuf, wbuf, pxb, tap / 3 * p.WC + tap % 3, tap, lane, wn);
    } else {
      for (int tap = 0; tap < taps; ++tap) {
        const int ky = tap / p.k;
        tap_mma<BN, KC>(acc, abuf, wbuf, pxb, ky * p.WC + tap - ky * p.k, tap, lane, wn);
      }
    }
    if (j != p.nchunk - 1) continue;

    // epilogue: JAX's rounding, the tile to shared memory filter-major
    // ([filter][row][column], a row of TC), then one TMA store of it (the
    // box's parts outside the output are not written) or, where OW is not
    // a multiple of 8, each filter's rows in 16-byte runs
    if (p.tma_out && threadIdx.x == 0) tma_store_drained();    // the last tile's store
    __syncthreads();
    __nv_bfloat16* otile = reinterpret_cast<__nv_bfloat16*>(smem + p.off_out);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = wm * kWM + mt * 16 + g + (r >> 1) * 8;
          const int fl = wn * kWN + nt * 8 + 2 * t + (r & 1);
          const float z = __bfloat162float(__float2bfloat16_rn(acc[mt][nt][r]));
          const float v = __bfloat162float(__float2bfloat16_rn(z + bz[nt][r & 1]));
          otile[fl * p.out_pitch + m] = __float2bfloat16_rn(v > 0.f ? v : v * alpha_b);
        }
    const Tile tl = tile_of(p, blockIdx.x + s / p.nchunk * gridDim.x);
    if (p.tma_out) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0)
        tma_store(&tout, tl.tx * p.TC, tl.ty * p.TR, f0, static_cast<int>(tl.img),
                  sbase + p.off_out);
      continue;
    }
    __syncthreads();
    const int runs = p.TC / 8, per_f = p.TR * runs;
    for (int i = threadIdx.x; i < BN * per_f; i += kThreads) {
      const int fl = i / per_f, r = i - fl * per_f, wy = r / runs, q = r - wy * runs;
      const int f = f0 + fl, oy = tl.ty * p.TR + wy, ox = tl.tx * p.TC + q * 8;
      if (f >= p.F || oy >= p.OH || ox >= p.OW) continue;
      const __nv_bfloat16* src = otile + fl * p.out_pitch + wy * p.TC + q * 8;
      __nv_bfloat16* dst =
          out + ((tl.img * p.F + f) * p.OH + oy) * static_cast<long long>(p.OW) + ox;
      for (int e = 0; e < 8 && ox + e < p.OW; ++e) dst[e] = src[e];
    }
  }
  if (p.tma_out && threadIdx.x == 0) tma_store_drained();
}

constexpr long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// Lay out shared memory for tile columns tc, resident weights or not, and
// `stages` ring stages; false where it exceeds a block's shared memory.
// From the aligned base: resident weights, the full barriers (in the last
// 8 x stages bytes before the ring), the ring, the NCHW transpose's
// window, the output tile.
template <int BN, int KC>
bool lay_out(Plan& p, int tc, bool resident, int stages) {
  constexpr int TM = Kernel<BN, KC>::TM;
  p.TC = tc;
  p.TR = TM / tc;
  p.tiles_x = (p.OW + tc - 1) / tc;
  p.tiles_y = (p.OH + p.TR - 1) / p.TR;
  p.WR = p.TR + p.k - 1;
  p.WC = tc + p.k - 1;
  p.lead = ((-p.pad) % 8 + 8) % 8;    // tile column starts are multiples of 8
  p.WCa = static_cast<int>(round_up(p.lead + p.WC, 8));
  p.nchunk = (p.C8 + KC - 1) / KC;
  p.resident = resident;
  p.stages = stages;
  const long long wchunk = static_cast<long long>(p.k) * p.k * BN * KC * 2;
  const long long window = static_cast<long long>(p.WR) * p.WC * KC * 2;
  const long long ring_in =
      p.path == kNchwTma ? static_cast<long long>(KC) * p.WR * p.WCa * 2 : window;
  const long long off_ring = round_up((resident ? p.nchunk * wchunk : 0) + 8 * stages, kAlign);
  const long long stage_bytes = round_up(ring_in + (resident ? 0 : wchunk), kAlign);
  const long long comp = p.path == kNchwTma ? round_up(window, 128) : 0;
  p.out_pitch = p.tma_out ? TM : TM + 8;
  const long long out = static_cast<long long>(BN) * p.out_pitch * 2;
  const long long total = off_ring + stages * stage_bytes + comp + out + kAlign;
  if (total > kMaxSmem || p.WC > 256 || p.WR > 256) return false;
  p.in_bytes = static_cast<int>(ring_in);
  p.ring_in = static_cast<int>(ring_in);
  p.stage_bytes = static_cast<int>(stage_bytes);
  p.off_ring = static_cast<int>(off_ring);
  p.off_comp = static_cast<int>(off_ring + stages * stage_bytes);
  p.off_out = static_cast<int>(p.off_comp + comp);
  p.smem = static_cast<int>(total);
  p.items = static_cast<long long>(p.B) * p.tiles_x * p.tiles_y;
  return true;
}

// The first layout that fits: resident weights before streamed ones, the
// widest tile columns that the output's width uses, 3 stages before 2.
template <int BN, int KC>
bool plan(Plan& p) {
  const int widths[3] = {64, 32, 16};
  const int first = p.OW <= 16 ? 2 : p.OW <= 32 ? 1 : 0;
  for (int resident = 1; resident >= 0; --resident)
    for (int w = first; w < 3; ++w)
      for (int stages = 3; stages >= 2; --stages)
        if (lay_out<BN, KC>(p, widths[w], resident == 1, stages)) return true;
  return false;
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A 4-D bf16 tensor map: dims innermost first, strides of dims 1-3 in
// bytes, the box, its swizzle; zeros read outside the tensor.
bool tensor_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4],
                CUtensorMapSwizzle swizzle) {
  const auto fn = encode_tiled();
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                  strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int KC, int KK>
int launch(const void* x, const void* wt, const void* bias, void* out, const Plan& p,
           float alpha, cudaStream_t st) {
  auto* kernel = conv_bf16_persistent<BN, KC, KK>;
  alignas(64) CUtensorMap tin{}, tout{};
  using u64 = cuuint64_t;
  const u64 B = p.B, C = p.C, H = p.H, W = p.W, F = p.F, OH = p.OH, OW = p.OW;
  bool ok = true;
  if (p.path == kNhwcTma)
    ok = tensor_map(&tin, x, {C, W, H, B}, {C * 2, W * C * 2, H * W * C * 2},
                    {KC, static_cast<cuuint32_t>(p.WC), static_cast<cuuint32_t>(p.WR), 1},
                    KC == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  else if (p.path == kNchwTma)
    ok = tensor_map(&tin, x, {W, H, C, B}, {W * 2, H * W * 2, C * H * W * 2},
                    {static_cast<cuuint32_t>(p.WCa), static_cast<cuuint32_t>(p.WR), KC, 1},
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (ok && p.tma_out)
    ok = tensor_map(&tout, out, {OW, OH, F, B}, {OW * 2, OH * OW * 2, F * OH * OW * 2},
                    {static_cast<cuuint32_t>(p.TC), static_cast<cuuint32_t>(p.TR), BN, 1},
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // The kernel's shared-memory limit and the grid's blocks an SM, kept per
  // instance from the last call (a call's host work is most of a small
  // layer's time): (device << 48) | (smem << 16) | blocks an SM.
  static std::atomic<unsigned long long> last{0};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long key = (static_cast<unsigned long long>(dev) << 48) |
                                 (static_cast<unsigned long long>(p.smem) << 16);
  const unsigned long long seen = last.load(std::memory_order_relaxed);
  if ((seen & ~0xFFFFull) == key && (seen & 0xFFFF)) {
    per_sm = static_cast<int>(seen & 0xFFFF);
  } else {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMaxSmem)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p.smem)) !=
            cudaSuccess)
      return static_cast<int>(e);
    last.store(key | static_cast<unsigned long long>(per_sm & 0xFFFF),
               std::memory_order_relaxed);
  }
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  const int groups = (p.F + BN - 1) / BN;
  if (per_sm < 1 || groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      std::min<long long>(p.items, std::max(1, sms * per_sm / groups));
  const dim3 grid(static_cast<unsigned>(blocks), groups);
  kernel<<<grid, kThreads, p.smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), p, alpha, tin, tout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, C, H, W) bf16, NCHW contiguous (layout 0) or the NHWC view
// (layout 1, a contiguous (B, H, W, C) buffer); wt: (k, k, F, C8) bf16
// contiguous, C8 = C rounded up to 8, channels past C zero; bias: (F,)
// float32; out: (B, F, OH, OW) bf16 contiguous, OH = H + 2 pad - k + 1, OW
// likewise.
extern "C" int cadx_conv_leaky_bf16(const void* x, const void* wt, const void* bias, void* out,
                                    int B, int C, int H, int W, int F, int k, int pad,
                                    int layout, float alpha, void* stream) {
  const int OH = H + 2 * pad - k + 1, OW = W + 2 * pad - k + 1;
  if (B <= 0 || F <= 0 || OH <= 0 || OW <= 0) return 0;
  if (C <= 0 || k <= 0 || pad < 0 || (layout != 0 && layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  Plan p{};
  p.B = B, p.C = C, p.C8 = static_cast<int>(round_up(C, 8)), p.H = H, p.W = W, p.F = F, p.k = k;
  p.pad = pad, p.OH = OH, p.OW = OW, p.layout = layout;
  p.path = layout == 1 && C % 8 == 0 && aligned   ? kNhwcTma
           : layout == 0 && W % 8 == 0 && aligned ? kNchwTma
                                                  : kPlainLoads;
  p.tma_out = OW % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 64 filters a block where F > 32, else 32; 32 channels a chunk, else 16
  if (F > 32) {
    if (plan<64, 32>(p))
      return k == 3 ? launch<64, 32, 3>(x, wt, bias, out, p, alpha, st)
                    : launch<64, 32, 0>(x, wt, bias, out, p, alpha, st);
    if (plan<64, 16>(p)) return launch<64, 16, 0>(x, wt, bias, out, p, alpha, st);
  }
  if (plan<32, 32>(p))
    return k == 3 ? launch<32, 32, 3>(x, wt, bias, out, p, alpha, st)
                  : launch<32, 32, 0>(x, wt, bias, out, p, alpha, st);
  if (plan<32, 16>(p)) return launch<32, 16, 0>(x, wt, bias, out, p, alpha, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
