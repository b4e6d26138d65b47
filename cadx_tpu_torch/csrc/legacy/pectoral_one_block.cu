// The pectoral tail's one-block-per-image kernel as it was before the tiled
// plan of csrc/pectoral.cu replaced it, kept only so that timings can set the
// two side by side (chip_smoke.py --tail-device-times); no path runs it.
// One block of 1024 threads per image over six int32 planes in global
// memory, each step looped to its fixpoint inside the block with the
// block-level code of components.cuh. stop_after (1-4) ends the kernel after
// that step: 1 the object, 2 the bands and markers, 3 the watershed, 4 the
// ridge and opening (the whole tail), so a timing of each prefix splits the
// kernel's time by step.
#include "components.cuh"

namespace {

using namespace cadx;

constexpr int kPlanes = 6;        // scratch int32 planes per image

__global__ void __launch_bounds__(kThreads)
pectoral_kernel(const uint8_t* equ, const uint8_t* bin, const uint8_t* breast,
                int* labels, uint8_t* boundary, uint8_t* mask, int* scratch,
                int H, int W, int morph_k, int n_morph, int sm_k, int stop_after) {
  const int n = H * W;
  const long long img = blockIdx.x;
  equ += img * n;
  bin += img * n;
  breast += img * n;
  labels += img * n;
  boundary += img * n;
  mask += img * n;
  int* m = scratch + img * kPlanes * n;
  int* lab = m + n;
  int* aux = lab + n;
  int* t1 = aux + n;
  int* t2 = t1 + n;
  int* pk = t2 + n;

  // 1. largest 8-connected component of the high-threshold mask, filled
  for (int p = threadIdx.x; p < n; p += blockDim.x) m[p] = bin[p] != 0;
  __syncthreads();
  ccl(m, lab, H, W, 8);
  largest_from_labels(m, lab, aux, t2, H, W);
  fill_holes(t2, t2, t1, lab, aux, H, W);  // t2 = pectoral object
  if (stop_after <= 1) return;

  // 2. marker bands: n_morph iterations of a k x k element compose into one
  // (k-1)*n+1 window, centred for odd k
  const int keff = (morph_k - 1) * n_morph + 1;
  const int lo = keff / 2;
  window_min(t2, t1, H, W, keff, lo, 1, 0);
  window_min(t1, m, H, W, keff, lo, 1, 1);  // m = eroded core
  for (int p = threadIdx.x; p < n; p += blockDim.x) aux[p] = 1 - t2[p];
  __syncthreads();
  window_min(aux, t1, H, W, keff, lo, 1, 0);
  window_min(t1, lab, H, W, keff, lo, 1, 1);  // lab = 1 - dilated core

  // 3. markers 255 / 128 / 64 as packed labels 1 / 2 / 3 at distance 0
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    int s = 0;
    if (m[p] > 0) s = 1;
    if (lab[p] == 1) s = 2;
    if (breast[p] == 0) s = 3;
    pk[p] = s ? s : kUnreachedPk;
  }
  __syncthreads();
  if (stop_after <= 2) return;

  // 4. packed watershed to its fixpoint (components.cuh)
  packed_watershed(equ, pk, H, W);
  if (stop_after <= 3) return;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int s = pk[p] & 3;
    labels[p] = s == 1 ? 255 : s == 2 ? 128 : s == 3 ? 64 : 0;
  }
  __syncthreads();

  // ridge: 4-neighbour disagreement between positive labels, plus the frame
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = p / W, x = p - y * W;
    const int l = labels[p];
    bool ridge = y == 0 || y == H - 1 || x == 0 || x == W - 1;
    if (!ridge && l > 0) {
      const int nb[4] = {labels[p - 1], labels[p + 1], labels[p - W], labels[p + W]};
      for (int i = 0; i < 4; ++i) ridge |= nb[i] > 0 && nb[i] != l;
    }
    boundary[p] = ridge;
    t2[p] = !ridge && l == 128;
  }
  __syncthreads();

  // 5. opening of the ridge-free breast label
  opening(t2, t1, aux, H, W, sm_k);
  for (int p = threadIdx.x; p < n; p += blockDim.x) mask[p] = static_cast<uint8_t>(t2[p]);
}

}  // namespace

// equ, bin, breast: (B, H, W) uint8; labels: (B, H, W) int32; boundary,
// mask: (B, H, W) bytes 0/1; scratch: (B, 6, H, W) int32.
extern "C" int cadx_pectoral_tail_one_block(const void* equ, const void* bin,
                                            const void* breast, void* labels,
                                            void* boundary, void* mask, void* scratch,
                                            int B, int H, int W, int morph_k, int n_morph,
                                            int sm_k, int stop_after, void* stream) {
  pectoral_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(equ), static_cast<const uint8_t*>(bin),
      static_cast<const uint8_t*>(breast), static_cast<int*>(labels),
      static_cast<uint8_t*>(boundary), static_cast<uint8_t*>(mask),
      static_cast<int*>(scratch), H, W, morph_k, n_morph, sm_k, stop_after);
  return static_cast<int>(cudaGetLastError());
}
