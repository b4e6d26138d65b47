"""PyTorch + CUDA port of the CADx pipeline, beside the JAX package.

The JAX package (`cadx_tpu`) is the reference; this package mirrors its
module paths (`ops/`, `kernels/`, `preprocess/`, `models/`, `xai/`,
`pipeline/`, `serve/`, `train/`, `tools/`, `utils/`, `compat/`,
`checkpoint.py`) so
each counterpart is easy to find. It imports torch and numpy only, never
jax and never `cadx_tpu`.

Slices ported so far:
- the batched 256² pipeline of `pipeline/fused.py::run_pipeline` — clean
  (suppress, segment, pectoral removal, boundary gray) -> resnet conv1 ->
  bilinear resize -> CNN -> guarded softmax -> Grad-CAM per class -> JET
  overlay;
- the serving engine, `serve/engine.py::InferenceEngine`, and its
  micro-batcher, `serve/batcher.py`: single uploads cleaned at native
  resolution (or a bucketed shape), classify with per-class CAM ROI
  boxes, bulk classify, Grad-CAM PNGs;
- training: `train/step.py::fit` (SGD or Adam), `train/crossval.py`,
  `checkpoint.py` (the reference npz schema and resumable train states),
  `train/metrics.py`, `train/summary.py`, the U-Nets of `models/unet.py`
  and `train/segmentation.py::fit_segmentation`, `tools/bench_train.py`;
- explainability and the weight artifacts: the reference resnet50
  Grad-CAM (`models/resnet.py`, `xai/gradcam.py`), saliency
  (`xai/saliency.py`), and the engine's `.npz`/`.pth` loaders
  (`compat/adcnnm.py` for the advanced model);
- the rest of the cleaner (`preprocess/cleaner.py::process`,
  `clean_for_unet`, `ops/morphology.py::median_blur`), the data layer
  (`data/dicom.py` for the uncompressed transfer syntaxes,
  `data/dataset.py`) and the training CLI, `tools/train.py`, whose
  encoder-features mode cleans each image at its native shape.

Every TPU kernel of the JAX package has its counterpart here
(`kernels/largest_obj.py`, `equalize.py`, `pectoral.py`, `ccl.py`,
`mode.py`, `watershed.py`, `conv_leaky.py`, `pool.py`, `upsample.py`,
`batchnorm.py`, `overlay.py`, `gradcam_tail.py`, `cleaner_front.py` and
the density-seeded component in `largest_obj.py`, which no path runs, as
in JAX): hand-written CUDA for Hopper (`csrc/`); on a CUDA tensor they
always run, on a CPU tensor their plain PyTorch version runs. The entry
points run on the card unless given `device="cpu"` (`device.py`).
"""
