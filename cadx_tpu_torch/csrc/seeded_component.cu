// Largest component of a binary mask (the density-seeded component's
// result), spread over the whole card. Replaces
// cadx_tpu/kernels/largest_obj.py::largest_component_mask; see
// cadx_tpu_torch/kernels/largest_obj.py for the contract.
//
// JAX floods from the mask pixel with the densest 17 x 17 neighbourhood and
// keeps the flood where it holds a strict majority of the mask, else it
// takes the CCL and the largest label: a seed that spares the TPU its CCL
// on a dominant blob, and lost even there. The result is each mask's
// largest component at the fixpoint, the smallest label on ties, empty for
// an empty mask, which is largest_obj.cu's selection with the fill and the
// opening off: the tiled union-find of tiled_components.cuh (ccl_local,
// ccl_merge, ccl_flatten with areas, largest_key, select_label; a memset
// and 5 launches over 32 x 32 tiles x images, no host sync). No seed and no
// flood: roots end as each component's smallest raster index, which is the
// plain version's label, so the largest (area, ~label) key picks its
// component on ties too, and key 0 (an empty mask) selects nothing.
//
// Bound: bytes, the mask in and the component out (2 bytes a pixel); the
// launches move ~20 bytes a pixel through L2 and HBM (a label plane
// written, merged, flattened and read) plus the union-find's dependent
// accesses along chains of tile roots.
#include <cuda_runtime.h>

extern "C" int cadx_largest_obj(const void* in, void* out, void* scratch, int B, int H, int W,
                                int conn, int fill, int smooth_k, int fill_first,
                                void* stream);

// in, out: (B, H, W) bytes 0/1; scratch: 8-byte aligned, 8 * B + 10 * B * H
// * W bytes (largest_obj.cu's); conn 4 or 8.
extern "C" int cadx_largest_component_seeded(const void* in, void* out, void* scratch, int B,
                                             int H, int W, int conn, void* stream) {
  return cadx_largest_obj(in, out, scratch, B, H, W, conn, 0, 0, 0, stream);
}
