"""PyTorch + CUDA port of the CADx pipeline, beside the JAX package.

The JAX package (`cadx_tpu`) is the reference; this package mirrors its
module paths (`ops/`, `kernels/`, `preprocess/`, `models/`, `xai/`,
`pipeline/`) so each counterpart is easy to find. It imports torch and
numpy only, never jax and never `cadx_tpu`.

Slice ported so far: the batched 256² pipeline of
`pipeline/fused.py::run_pipeline` — clean (suppress, segment, pectoral
removal, boundary gray) -> resnet conv1 -> bilinear resize -> CNN ->
guarded softmax -> Grad-CAM per class -> JET overlay. The three kernels on
its clean stage (`kernels/largest_obj.py`, `kernels/equalize.py`,
`kernels/pectoral.py`) are hand-written CUDA for Hopper (`csrc/`); on a
CUDA tensor they always run, on a CPU tensor their plain PyTorch version
runs.
"""
