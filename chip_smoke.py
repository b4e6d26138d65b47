#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`cadx_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):
1. build the sixteen CUDA sources from `cadx_tpu_torch/csrc` (the
   fifteen kernels and conv_leaky's bfloat16 form; one nvcc per source,
   all at once);
2. hold each kernel bit-exact against its plain PyTorch version on the
   card (the plain versions' CCLs run uncapped, max_iters = H*W, since
   those kernels run to the fixpoint; both watershed forms run JAX's
   sweeps to the same cap as the plain version, 256 unless a case says
   otherwise, and the packed form at max_scan 8 and 256):
   - equalize, largest_obj, pectoral_tail: synthetic mammograms (B=16,
     256²) and random masks; pectoral_tail also on
     `synthetic.pectoral_tile_edge_inputs` at the six shapes below and at
     the serving shapes (B=1 and B=8 at 512²), each twice to the same
     bytes; at B=1 512² the profiler trace must hold every launch of its
     plan, each covering at least 132 blocks or the image's tile count,
     and no synchronising runtime call (its watershed loops on the card);
     cleaner_front on B=16 256² (synthetic
     mammograms, noise, dark images) and on `synthetic.tile_edge_cases`
     (shapes on the edges and corners of its 32x32 tiles, ties across
     tiles, border gaps; B=12 at 64², 256², 45x70, 1x70, 70x1, 333x257)
     with smooth_k 0, 3 and 15; largest_obj on the same cases, 4- and
     8-connected, in five orderings (plain, fill, fill + opening 15,
     fill_first, fill_first + opening 4), and the pair-form watershed on
     them with max_scan 8 (the halo-tiled sweep) and 256 (a launch a
     pass), capped at 1, 2, 17 and 256 sweeps; every cleaner_front,
     largest_obj and pair-form watershed case runs twice and must give
     the same bytes; at B=1 the front's CCL grid and every largest_obj
     launch at the CLI's 3328x2560 (from profiler traces) must cover the
     image's tile count, and a 256-sweep pair-form watershed call there
     may synchronise the host at most ceil(256 / CHECK_EVERY) + 1 times
     (its own count, and the trace's synchronising runtime calls where
     the trace holds them);
   - the cleaner's inputs at every shape the serving phase gives the
     kernels, made from the same images: the 3328x2560 upload bucketed to
     1536x1280 and the 1024x832 upload (B=1; cleaner_front, equalize,
     largest_obj at its three sites, pair-form watershed, ccl and mode),
     the 512² upload (B=1) and the classify_batch batch (B=8, 512²;
     cleaner_front, equalize, largest_obj at its two sites,
     pectoral_tail); at the training CLI's native shapes (3328x2560 and
     4608x2656) each kernel its path launches there: cleaner_front,
     equalize, largest_obj at the pectoral select, pair-form watershed;
   - the density-seeded largest component (off every path, as in JAX)
     against its plain version, `largest_component_plain` and
     `largest_obj` without fill or opening (the same launches) on blobs,
     ties, random and empty masks at 256² B=16 and 1536x1280, twice to the
     same bytes, with the count that JAX's algorithm sends to its flood and
     to its fallback;
   - the flood: fill_holes' border flood on suppress-site backgrounds
     (256² B=12, the 1536x1280 bucket and the 3328x2560 native, B=1),
     serpentines (256² B=4) and random masks across the packed words'
     borders (B=3 37x31, 37x32, 37x33), 4- and 8-connected, uncapped and
     capped (2, 40 and 128 sweeps, which the serpentines hit), bit-exact,
     twice to the same bytes; the dispatching
     `ops.components.fill_holes` and `flood_from` launch it; the plain
     versions of largest_obj, the seeded component, cleaner_front and
     pectoral_tail launch no kernel on the card;
   - ccl, mode and watershed (packed and pair form, twice each) on random
     masks and markers at 256² (B=16), and ccl and mode at the serving CAM shapes
     (B=3 and B=8 at 6x6, B=3 62x62; ccl in its cluster form and its
     tiled form, mode in its block, cluster and wide forms, twice each);
     mode in each form on labels out of range, an exact tie and an empty
     mask, twice; ccl 4- and 8-connected on
     `synthetic.tile_edge_cases` at the six shapes, plain uncapped, twice;
   - the packed watershed (prologue, cooperative tile relaxation,
     epilogue) at B = 1, 8 and 16 on sides 1x1, 31x33, 32x32, 33x31,
     200x136, 511x512 and 512x512 with one, two and three marker values,
     and with markers that leave nothing unreached or none at all, on
     float images up to 1000 with half-integer values, against its plain
     version uncapped, twice to the same bytes;
   - equalize twice to the same bytes at every shape a path gives it
     (run_pipeline's B=64 256², the serving uploads' 512², 1024x832 and
     1536x1280 bucket, classify_batch's B=8 512², the CLI's 3328x2560 and
     4608x2656) and on `synthetic.equalize_edge_cases` (zero background,
     all zero, one level, one pixel, a ramp, LUT entries on .5, an odd-n
     batch) and a view 1 byte past a 16-byte boundary;
   - conv_leaky at the shapes of the training, pipeline and serving
     classifiers' conv layers (VALID and SAME), layer 1 also through the
     NHWC view conv_stack hands it, and at ragged shapes (C = 3, F = 5 and
     40, k = 1, 5, 7, B = 1), to max |d| <= 1e-5 * max |plain| + 1e-6
     (float32 sums of <= 1,152 terms in another order); on the advanced
     B=32 NHWC view the call raises the peak device memory by no more than
     its output; the pool kernel (max and mean, sizes 2 and 3, odd sides,
     float32 and bfloat16) and upsample (factors 2 and 3, elements of 1, 2,
     4 and 8 bytes) bit-exact; both max-pool backward
     rules (tie-broadcast, first maximum) on the card against the CPU,
     bit-exact;
   - batchnorm at every distinct input shape of the ResNet-50 at a 512²
     display (the path's own inputs) and at planes of 1, 3, 4, 256 and
     65,536 elements (B=2, C up to 2048, contiguous and 4 bytes off a
     16-byte boundary), and jet_blend at 256² B=64, 512² B=1, the
     1536x1280 display cap and B=3 37x53 (images off 16-byte
     boundaries), gray and RGB, on random heat, a dark image and all-255
     heat, in its one-launch form (where the images fit one block an SM)
     and its wide form, each twice
     to the same bytes, bit-exact; gradcam_tail at the pipeline's shapes,
     (64, 6, 6, 64) -> 256², bit-exact, twice to the same bytes;
3. the fused pipeline: `run_pipeline` at 256² with the full-width
   classifier on seeded weights, three batches of B=64; launches 1
   (cleaner_front), 1 (equalize), 1 (pectoral_tail), 4 (conv_leaky), 4
   (pool) and 2 (gradcam_tail, one per explained class) per batch and
   none of the other kernels (the flood lies on no path);
4. the fused pipeline on a B=2 batch on the card and on the CPU: clean_u8
   exact, probs 2e-5, features 1e-5, heatmaps and overlays +-2 u8;
4b. the even-kernel pectoral path, `cleaner.process(x, pect_removal=True,
   morph_kn_size=4, n_morph_op=7)` at the serving segment shape (B=8
   512²) and the pipeline's B=64 256²: remove_pectoral's composed branch,
   one packed watershed launch a call, pectoral_tail none; the packed
   watershed's inputs on the way bit-exact against its plain version
   uncapped, a second run the same bytes, every output equal to the CPU
   `process`, and each call's wall p50;
5. serving at full width, `EngineConfig()` defaults, seeded weights:
   warmup, then uploads of a 3328x2560 uint16 native (cleaned at the
   1536x1280 bucket, pair-form watershed), a 1024x832 uint8 native
   (cleaned at native size, composed pectoral branch) and a 512² image
   (fused tail); per pipeline classify, classify_and_roi (0, 1) and the
   overlay PNGs; eight concurrent micro-batched classify calls;
   classify_batch on B=8 at 512². The exact launch count of each of the
   fifteen kernels, and of the packed watershed's and conv_leaky's bf16
   forms apart, is asserted
   (cleaner_front once per cleaned batch, largest_obj once per composed
   pectoral branch, jet_blend once per overlay class);
6. one 640x544 request on the card and on a CPU engine with the same
   weights: clean exact, features 1e-5, probs 2e-5, ROI boxes within one
   CAM cell, heatmaps +-2 u8, overlays +-2 u8 where the heatmaps agree,
   within the bound the JET table's slope gives at a heatmap step, and
   +-2 u8 at the 99th percentile of all overlay values;
6b. the reference Grad-CAM and the weight loaders: seeded torchvision-
   layout files (a ResNet-50 with its 1000-class fc and randomised batch
   norms, a resnet34 under smp's `encoder.` prefix, a basic cnn_model
   npz, an ADCNNM summary JSON and `.pth`) in a temporary directory; an
   engine built from them on the card (the fc-less file as gradcam_pth
   raises; each loaded weight equals the saved one); one
   `write_gradcam_overlays` at the 512² display for classes (0, 1) with
   exact launch counts (53 batchnorm for its one ResNet-50 forward, 2
   jet_blend); card against a CPU engine built from the same files:
   features 1e-5, probs 2e-5, layer4 activations to 1e-4 of their
   largest, CAMs 2e-3, heatmaps +-2 u8, overlays under phase 6's rule;
6c. saliency (`xai/saliency.py::generate_dual_class_overlays`) of both
   engine classifiers at the 512² display, card against CPU: heatmaps and
   overlays +-1 u8;
7. training at full width through `fit` and `fit_segmentation` on the
   card: the basic classifier (SGD, batch 8) and the advanced one (Adam,
   batch 32), 2 epochs each on 64 train / 16 test samples of bench_train's
   generator, and `UNetConfig()` (Adam, batch 8) 2 epochs on 32 images at
   256², with the exact launch counts of conv_leaky, pool and upsample;
   one basic SGD step (B=8) and one advanced Adam step (B=2) on the card
   and on the CPU from the same weights and batch, dropout 0: loss to 1e-5
   relative; the CPU's gradients recomputed through the card's derivative
   switches (LeakyReLU masks, max-pool selections) to 1e-5 of each
   tensor's largest, with the switches taken otherwise on the two devices
   counted; the CPU's own gradients to 1e-2 in relative L2 per tensor
   (one switch taken otherwise moves a conv gradient by a whole term) and
   to 1e-5 of each tensor's largest for the basic step; parameters after
   the update from the card's gradients on both devices to 1e-5, and
   after the update from each device's own gradients to 1e-5 for SGD and,
   for Adam (whose first update is lr * g / (|g| + eps)), to 1e-5 above
   the gap Adam makes of the two gradients where they agree in sign and
   to 2 lr where they straddle 0; a save_npz -> load_npz round trip;
7b. the training CLI at full width: 12 synthetic uint16 DICOMs in two
   classes at two native full-field shapes (3328x2560 and 4608x2656),
   written by the port's `dcmwrite_minimal` with a mapping CSV in a
   temporary directory; `tools.train.main` on the card with `--features
   encoder --feature-size 32 --conv-layers 128x3,64x3 --hidden-units
   256,128` (bench.py's full-width classifier), 2 epochs, batch 8: the
   artifacts exist; per image cleaner_front 1, equalize 1, largest_obj 1
   (the composed pectoral branch), watershed 1 (pair form), ccl, mode and
   pectoral_tail 0; conv_leaky and pool 2 per conv stack of `fit` and the
   final prediction; one 640x544 image's `clean_for_unet` and features on
   the card against the CPU (clean exact, features 1e-5); the featurize
   p50 per native shape and the CLI's wall time;
8. batchnorm's device time (profiler) at every distinct input shape of
   the ResNet-50 forward at the 512² display beside F.batch_norm's, with
   each bound and the sums over the forward's 53 launches; largest_obj
   at the pectoral select of every B=1 shape beyond 512 (1536x1280,
   1024x832, 3328x2560, 4608x2656) and the pair-form watershed at both
   serving shapes and the CLI's native shapes, each beside its plain
   version (the watershed 10 calls a timing after 5, also with each tile
   of its sweep kernel, checked bit-exact; its bound: its inputs and
   outputs once against the plain version's operations for the sweeps its
   inputs need, counted by the plain sweeps; beside it the floor of one
   read and write of the planes a sweep, 24 bytes a pixel); the CLI's
   featurize p50 split by stage (cleaner_front, pectoral removal with its
   equalize, largest_obj and watershed, the resizes, conv1); equalize at
   every path shape and ccl at its serving shapes (both forms) and B=16
   256² random masks beside the one-block kernels they replaced (kept in
   `csrc/legacy/`; `python3 chip_smoke.py --equalize-ccl-times`, in a fresh
   process: events and profiler device time in turns old, new, new, old,
   equalize also on an all-zero and a random 3328x2560 image), and the
   trace of one B=1 3328x2560 equalize call: a memset and two launches of
   more than 132 blocks, no synchronising runtime call; mode (the serving
   CAM shapes, B=16 256² random masks) and jet_blend (512² gray and RGB,
   1024x832, the 1536x1280 cap, B=64 256², B=3 37x53, smooth heat) beside
   the kernels they replaced and their other forms (`python3 chip_smoke.py
   --mode-jet-times`, in a fresh process: events and profiler device time
   in turns old, new, other forms, new, old) and the traces of one mode
   call at B=3 62x62 and one jet_blend call at B=1 512²: one launch, no
   memset, no synchronising runtime call; the flood (fill_holes' border
   flood at B=64 256², B=1 1536x1280 and 3328x2560, serpentines into the
   128-sweep cap; its sweeps a call and the time a sweep) and the seeded
   component (phase 2's B=16 256² masks, 1536x1280 generated masks, B=16
   256² random masks at density 0.45; beside ccl + mode and largest_obj)
   beside the one-block kernels they replaced (`python3 chip_smoke.py
   --flood-seeded-times`, in a fresh process: events and profiler device
   time in turns old, new, other launches, new, old), and the traces of
   one flood call at B=64 256² and at B=1 1536x1280 (one launch, at most
   one memset, no synchronising runtime call) and of one seeded call (no
   flood, every grid larger than the batch); the packed watershed beside
   the rounds-to-the-fixpoint form it replaced and its plain version (B=1
   512², B=8 512², B=16 256², cleaner markers; the record's row is B=1
   512²) and on serpentines where the cap binds, with its sweeps beside
   the plain version's, bound, design floor and the rounds form's records, the trace
   of one B=1 512² call (three launches, no synchronising call), and
   pectoral_tail at B=64 256² and B=1 512² beside its records from the rounds design
   (`python3 chip_smoke.py --packed-watershed-times`, in a fresh
   process); pectoral_tail and
   gradcam_tail beside the one-block kernels they replaced (kept in
   `csrc/legacy/`; `python3 chip_smoke.py --tail-device-times`, in a
   fresh process): pectoral_tail by step (object, bands and markers,
   watershed with its rounds, ridge and opening) at B=64 256², B=1 512²
   and B=8 512², also beside its plain version, and its bound (its inputs
   and outputs once against the ONCE_OPS operations a pixel it does once)
   beside the floor of this design and, for information, the plain
   version's sweep operations on its inputs; gradcam_tail's device time
   beside the old kernel's; then times with CUDA
   events: each kernel beside its plain version (256²
   B=64 for the fused-pipeline kernels and gradcam_tail, the serving
   shapes for ccl, mode and watershed, the training shapes for
   conv_leaky (all six path shapes, layer 1 on the NHWC view), pool and
   upsample, fill_holes' border flood at 256² B=64 and 1536x1280 for the
   flood, the ResNet-50 stem for batchnorm, the
   512² display for jet_blend, 256² B=64, 1536x1280 and the training
   CLI's native shapes for cleaner_front, also beside the old front it
   replaces (suppress_artifacts + segment_breast_mask: two largest_obj
   launches and the glue), phase 2's
   256² B=16 masks for the seeded component, also beside the ccl + mode
   pair) and, for conv_leaky (under full float32), pool, upsample and
   batchnorm, beside the one
   PyTorch call that computes the same function, and the device time of
   each from torch.profiler (a small kernel's back-to-back calls are bound
   by the host); each kernel's bound on this card (the larger of its
   bytes over 3.35 TB/s and its operations over 67 TFLOP/s, the H100
   SXM's HBM3 rate and float32 peak); ms per training step of each
   configuration; the pipeline's images per second and device time; and the p50 of
   process_single_image per upload shape (the 512² upload also split by
   stage: cleaner_front, pectoral removal with its equalize and
   pectoral_tail, the resize, conv1), of classify_and_roi per
   pipeline and of the reference `write_gradcam_overlays` over 10
   requests after warmup;
9. the HTTP front: the port's `serve.app.make_server` with warmup on
   127.0.0.1, port 0, its own `InferenceEngine()` at `EngineConfig()`
   defaults on the card with seeded weights, driven over a socket with
   uploads of a 512² u8 PNG, a 1024x832 16-bit PNG, a 3328x2560 u16
   image as explicit VR little endian, JPEG lossless SV1 and RLE DICOMs
   (written by the port's `dcmwrite_minimal`), a 512² progressive JPEG
   (`tests/data/upload_progressive.jpg`) and a 512² 24-bit BMP named
   `.png`; per upload /upload-single,
   /view_segmentation (64 masks), /classify and /roi for both pipelines;
   then a zip of 8 PNGs through /upload-bulk, /bulk-classify for both
   pipelines and /upload-bulk-image. Every answer is held against the
   same engine called directly on the decoded image: the stored upload
   equal to the image written (for the JPEG and the BMP, the reader's
   image of the file), features to 1e-6, probabilities to 1e-6,
   ROI boxes, clean, overlay and heatmap PNGs equal, bulk rows equal to
   `classify_batch` on the same resized stack; an HTTP 500, an "error"
   field or an exception stored by an artifact job fails the phase. The
   launch counters over each upload's round (upload, masks, classify,
   roi, the Grad-CAM jobs) and the bulk round make the record's "front"
   path: cleaner_front, equalize, conv_leaky, pool, ccl, mode and
   jet_blend launch in every upload's round, pectoral_tail at the 512²
   upload and in bulk, largest_obj and the pair-form watershed at every
   upload beyond 512. Then each route's p50 over 10 requests on the host
   clock around the HTTP call, beside the engine's own p50 on the same
   image and phase 8's for the same shape, and each upload's decode p50
   by decoder (native or Python, with the native loader's state).
10. the packed watershed's sweep cap: serpentines at SERPENTINE_SIDES
   (a 1-pixel corridor where JAX's 256-sweep cap binds) through
   `packed_form` and through the pectoral tail's relaxation (the
   serpentine as its equalized image, caps 1, 3 and 256), and phase
   4b's cleaner markers through `packed_form`, each bit-exact against
   the plain version at the same cap; the sweeps run beside the plain
   version's count;
11. bf16 training at full width: one epoch (two Adam steps, B=32) of
   the advanced configuration with `compute_dtype` and
   `device_data_dtype` bfloat16 beside the same epoch in float32 on the
   card, its launches exact (the record's "training_bf16" path:
   conv_leaky_bf16 twice a step); at the epoch's initial weights the bf16
   loss within 1e-3 of float32's and the logits within 2e-2 of their
   largest; a basic SGD epoch in bf16 within 2e-3 of float32's loss; the bf16
   conv_leaky form against its plain version at every layer shape of
   that run and the basic classifier's (to 2^-6 of the plain output's
   largest value: both round float32 sums taken in other orders to bf16,
   twice) and its times beside the plain version, cuDNN's bf16
   `F.conv2d` and the bound (bytes or dense bf16 operations); the
   training CLI with --bf16-compute for one epoch on 24 small DICOMs;
12. the compat API on the card: `CNNModel` train, predict, save_model
   and `load_weights`, `ModelTrainer.cross_validate` (2 folds, 1 epoch),
   `TinyUNetModel.fit` (2 steps), `ExplainableAI.generate_heatmap` and
   `overlay_heatmap`, the ADCNNM exporter's round trip through the loader
   (bit-exact at the advanced configuration); `utils.profiling.trace()`
   of one run_pipeline batch summarised by `tools.trace_summary`, its
   table and the window's completeness printed.

The last line of standard output is {"ok": true, "device": {...}}; the
line before it is the per-kernel JSON record: the fifteen kernels, the
packed watershed's form ("watershed_packed", its launches those of phase
4b's path), which shares watershed.cu, and conv_leaky's bfloat16 form
("conv_leaky_bf16", its launches those of phase 11's path). Imports
torch, numpy and the port only.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import http.client
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

BATCH = 64
HW = 256
N_MAIN_BATCHES = 3
UPLOADS = {"3328x2560 u16": (3328, 2560, np.uint16),
           "1024x832 u8": (1024, 832, np.uint8),
           "512x512 u8": (512, 512, np.uint8)}
N_BATCHED = 8
N_TIMED = 10
# the training CLI phase: native full-field shapes (the serving phase's
# 3328x2560 upload and a taller one), images in all, and the command
CLI_SHAPES = ((3328, 2560), (4608, 2656))
N_CLI = 12
# the HTTP front phase: bulk images in the zip, and their shape
N_FRONT_BULK = 8
FRONT_BULK_HW = (1024, 832)
CLI_ARGS = ["--features", "encoder", "--feature-size", "32", "--conv-layers", "128x3,64x3",
            "--hidden-units", "256,128", "--epochs", "2", "--batch-size", "8"]
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM3 bytes/s and float32
# FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
TRACE_ATTEMPTS = 3
FP32_OPS_PER_S = 67e12
# dense bf16 on the tensor cores (the same data sheet)
BF16_OPS_PER_S = 989e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, iters: int) -> list:
    """torch.profiler's averages of the card's kernels (and memsets and
    copies) over iters calls of fn, after one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, iters: int) -> float | None:
    """Mean device milliseconds per call: the kernel time torch.profiler
    records on the card (host overhead, which bounds a small kernel's
    back-to-back calls, excluded). None where the window lost records:
    every call launches the same kernels, so each kernel's record count is
    a multiple of iters; late in a long run the profiler has kept only
    some of the port's own launches (1 of 10 of a 3 ms kernel)."""
    kernels = device_kernels(fn, iters)
    if not kernels or any(e.count % iters for e in kernels):
        return None
    return sum(e.self_device_time_total for e in kernels) / 1e3 / iters


def device_ms_by_kernel(fn, iters: int = 3) -> dict:
    """Kernel name -> its launches and device milliseconds a call of fn."""
    return {e.key[:72]: {"calls": e.count / iters, "ms": e.self_device_time_total / 1e3 / iters}
            for e in device_kernels(fn, iters)}


def trace_events(fn) -> list:
    """The events of a torch.profiler trace (host and card) of one call of
    fn. Late in a long process the profiler can drop the card's records of
    the port's ctypes launches (PERF.md §7): a trace whose host side holds
    launch calls but whose card side holds no kernel is taken again, up to
    TRACE_ATTEMPTS times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        if any(e.get("cat") == "kernel" for e in events) or not runtime_calls(
                events, ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel")):
            break
    return events


def kernel_grids(fn, name_part: str) -> list:
    """The grid ([x, y, z]) of each launch, in one call of fn, of a kernel
    whose name holds name_part, from a torch.profiler trace; empty where
    the trace kept none."""
    return [e["args"]["grid"] for e in trace_events(fn)
            if e.get("cat") == "kernel" and name_part in e.get("name", "")
            and "grid" in e.get("args", {})]


def runtime_calls(events: list, names: tuple) -> int:
    """How many CUDA runtime calls of the given names a trace holds."""
    return sum(1 for e in events if e.get("cat") == "cuda_runtime" and e.get("name") in names)


def captured_mean(*runs):
    """The mean of the runs the profiler captured (None where it kept none)."""
    kept = [ms for ms in runs if ms is not None]
    return sum(kept) / len(kept) if kept else None


def ms_text(ms: float | None) -> str:
    return "not captured" if ms is None else f"{ms:.4f}"


def turns_ms(kernel_fn, plain_fn, k_iters: int, p_iters: int, library_fn=None, warmup=1):
    """Kernel, plain and library times, in turns plain, library, kernel,
    kernel, library, plain (library None where there is no library_fn);
    the kernel and library timings after `warmup` calls."""
    p1 = cuda_ms(plain_fn, p_iters)
    l1 = cuda_ms(library_fn, k_iters, warmup) if library_fn else None
    k1 = cuda_ms(kernel_fn, k_iters, warmup)
    k2 = cuda_ms(kernel_fn, k_iters, warmup)
    l2 = cuda_ms(library_fn, k_iters, warmup) if library_fn else None
    p2 = cuda_ms(plain_fn, p_iters)
    lib = (l1 + l2) / 2 if library_fn else None
    return (k1 + k2) / 2, (p1 + p2) / 2, lib, (k1, k2, p1, p2, l1, l2)


def p50_ms(fn, n: int) -> float:
    """Median wall milliseconds of n calls, the card synchronised after
    each."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def nbytes(obj) -> int:
    """Bytes of every tensor in obj (a tensor or a tuple of them)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return sum(nbytes(o) for o in obj)


def numel(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel()
    return sum(numel(o) for o in obj)


def bound(bytes_moved: int, ops: int):
    """(least ms on the card, "bytes" or "operations")."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def blobs(rng, n: int, hw: int):
    """(n, hw, hw, 1) images in [0, 1] with a bright disk, and its mask."""
    X = rng.random((n, hw, hw, 1)).astype(np.float32) * 0.3
    Y = np.zeros((n, hw, hw, 1), np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw]
    for i in range(n):
        cy, cx = rng.integers(hw // 4, 3 * hw // 4, 2)
        disk = (yy - cy) ** 2 + (xx - cx) ** 2 < rng.integers(hw // 12, hw // 5) ** 2
        X[i, disk, 0] += 0.6
        Y[i, disk, 0] = 1.0
    return X, Y


def seeded_masks(rng, h: int, w: int) -> np.ndarray:
    """Masks for the density-seeded largest component: two disc blobs with
    a small extra component (a strict majority: the flood), two exact ties
    of two squares (the fallback), random masks at densities 0.3, 0.45
    (256² only: near the percolation threshold the plain CCL needs
    hundreds of sweeps) and 0.7, and an empty mask."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for cy, cx, r in ((h // 2, 3 * w // 4, min(h, w) // 3), (h // 3, w // 3, min(h, w) // 4)):
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        blob[2:6, 2:6] = True
        out.append(blob)
    for s in (5, 9):
        tie = np.zeros((h, w), bool)
        tie[s:s + 10, s:s + 10] = True
        tie[h - s - 10:h - s, w - s - 10:w - s] = True
        out.append(tie)
    for density in ((0.3, 0.45, 0.7) if h * w <= 1 << 16 else (0.3, 0.7)):
        out.append(rng.random((h, w)) < density)
    out.append(np.zeros((h, w), bool))
    return np.stack(out)


def classifier_switches(model, x: torch.Tensor):
    """The derivative switches of one classifier forward on x's device:
    per conv block the LeakyReLU mask (z > 0) and the max-pool selection
    (the inputs equal to their window's max, remainder cropped), per dense
    layer the LeakyReLU mask."""
    from cadx_tpu_torch.ops.conv import conv2d_leaky, leaky_relu
    from cadx_tpu_torch.ops.pool import max_pool_ties

    cfg = model.config
    out, conv_sw, dense_sw = x.permute(0, 3, 1, 2), [], []
    with torch.no_grad():
        for w, b in zip(model.conv_w, model.conv_b):
            y = conv2d_leaky(out, w, b, cfg.leaky_alpha, cfg.conv_padding)
            out = max_pool_ties(y, 2)
            up = out.repeat_interleave(2, 2).repeat_interleave(2, 3)
            conv_sw.append((y > 0, y[..., :up.shape[2], :up.shape[3]] == up))
        h = out.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for w, b in zip(model.dense_w, model.dense_b):
            z = h @ w + b
            dense_sw.append(z > 0)
            h = leaky_relu(z, cfg.leaky_alpha)
    return conv_sw, dense_sw


def pinned_grads(model, x: torch.Tensor, y_onehot: torch.Tensor, switches):
    """(loss, grads) of the classifier's training loss on x's device with
    its derivative switches pinned to `switches` (taken on another device):
    every value is computed here, every gradient passes the given LeakyReLU
    masks and max-pool selections (tie-broadcast) instead of this device's
    own."""
    import torch.nn.functional as F

    cfg = model.config
    alpha = cfg.leaky_alpha
    conv_sw, dense_sw = switches

    def leaky(z, mask):
        slope = torch.where(mask.to(z.device), torch.ones_like(z), torch.full_like(z, alpha))
        return torch.where(z > 0, z, alpha * z).detach() + (z - z.detach()) * slope

    with torch.enable_grad():
        out = x.permute(0, 3, 1, 2)
        for w, b, (mask, sel) in zip(model.conv_w, model.conv_b, conv_sw):
            pad = 0 if cfg.conv_padding == "VALID" else w.shape[-1] // 2
            y = leaky(F.conv2d(out, w, b, padding=pad), mask)
            bsz, c, h2, w2 = sel.shape[0], sel.shape[1], sel.shape[2] // 2, sel.shape[3] // 2
            crop = y[..., :2 * h2, :2 * w2]
            windows = (bsz, c, h2, 2, w2, 2)
            out = (crop.detach().reshape(windows).amax(dim=(3, 5))
                   + ((crop - crop.detach()) * sel.to(y.device)).reshape(windows).sum(dim=(3, 5)))
        h = out.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for w, b, mask in zip(model.dense_w, model.dense_b, dense_sw):
            h = leaky(h @ w + b, mask)
        logp = torch.log_softmax(h @ model.out_w + model.out_b, dim=-1)
        loss = -(y_onehot * logp).sum(dim=-1).mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), list(grads)


def randomize_bn(model, generator: torch.Generator):
    """Seeded batch-norm statistics and affine terms, as a trained network
    has them (the init's are the identity)."""
    from cadx_tpu_torch.models.unet import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.randn(c, generator=generator) * 0.3)
                m.running_var.copy_(torch.rand(c, generator=generator) + 0.5)
                m.weight.copy_(1.0 + torch.randn(c, generator=generator) * 0.2)
                m.bias.copy_(torch.randn(c, generator=generator) * 0.2)
    return model


def adcnnm_state_dict(model) -> dict:
    """A port CNN as the reference ADCNNM torch state dict: convs.{i}, and
    fc.{3 j} Linear layers (out, in) whose first takes torch's (C, H, W)
    flatten order."""
    h, w, f = model.config.conv_output_shapes()[-1]
    h, w = h // 2, w // 2
    sd = {}
    for i, (wt, b) in enumerate(zip(model.conv_w, model.conv_b)):
        sd[f"convs.{i}.weight"] = wt.detach().cpu().clone()
        sd[f"convs.{i}.bias"] = b.detach().cpu().clone()
    dense = list(zip(model.dense_w, model.dense_b)) + [(model.out_w, model.out_b)]
    for pos, (wt, b) in enumerate(dense):
        wt = wt.detach().cpu().T
        if pos == 0:
            wt = wt.reshape(-1, h, w, f).permute(0, 3, 1, 2).reshape(wt.shape[0], -1)
        sd[f"fc.{3 * pos}.weight"] = wt.contiguous().clone()
        sd[f"fc.{3 * pos}.bias"] = b.detach().cpu().clone()
    return sd


def overlay_checks(what: str, ov_a, hm_a, ov_b, hm_b, img_u8, heat_tol: int,
                   jet_slope: int):
    """Checks (name, err, tolerance) of overlays and heatmaps made on two
    devices or by two implementations, CPU tensors, (B, H, W, 3) and (B, H,
    W), of gray images `img_u8` (B, H, W). Heatmaps within heat_tol. The
    overlay is trunc((jet + img) * 255 / peak), peak the largest jet + img
    of its image, so where the heatmaps differ by dh levels it may move by
    floor(jet_slope * dh * 255 / peak) + 1 counts; where they agree it is
    held to +-2, and so is the 99th percentile of all its values
    (tests/test_xai.py:78-81)."""
    from cadx_tpu_torch.ops.colormap import apply_jet

    dhm = (hm_a.int() - hm_b.int()).abs()
    dov = (ov_a.int() - ov_b.int()).abs()
    same = (dhm == 0)[..., None].expand(dov.shape)
    checks = [(f"{what} heatmap", float(dhm.max()), heat_tol),
              (f"{what} overlay where heatmaps agree",
               float(dov[same].max()) if bool(same.any()) else 0.0, 2),
              (f"{what} overlay, 99th percentile",
               float(torch.quantile(dov.double().flatten()[:1 << 24], 0.99)), 2)]
    steps = int((dhm > 0).sum())
    worst = None      # (err, tol, dh, peak) of the image with the least margin
    for i in range(dhm.shape[0]):
        if not bool((dhm[i] > 0).any()):
            continue
        peak = int((apply_jet(hm_b[i]).int() + img_u8[i].int()[..., None]).max())
        dh = int(dhm[i].max())
        tol = jet_slope * dh * 255 // peak + 1
        err = float(dov[i][~same[i]].max())
        if worst is None or err - tol > worst[0] - worst[1]:
            worst = (err, tol, dh, peak)
    err, tol, dh, peak = worst or (0.0, 1, 0, 0)
    checks.append((f"{what} overlay at the {steps} heatmap pixels that differ (slope "
                   f"{jet_slope}, least-margin image dh {dh}, peak {peak})", err, tol))
    return checks


def resnet50_bn_inputs(dev, side: int):
    """The seeded ResNet-50 (fc 1000, batch norms randomised) and, for each
    distinct batch-norm input shape of one forward at a side x side
    display, (an input, its batch-norm module) and how many of the
    forward's batch norms take that shape, recorded on the way through
    `resnet.bn_apply`."""
    from cadx_tpu_torch.models import resnet as TR
    from cadx_tpu_torch.synthetic import synthetic_mammograms
    from cadx_tpu_torch.xai import gradcam as TG

    r50 = randomize_bn(TR.init_resnet(torch.Generator().manual_seed(50),
                                      TR.RESNET50_CLASSIFIER), torch.Generator().manual_seed(51))
    display = torch.from_numpy(synthetic_mammograms(1, side, seed=5)[0]).to(dev)
    inputs, calls = {}, {}
    bn_apply = TR.bn_apply

    def recording_bn_apply(bn, x, eps=1e-5):
        inputs.setdefault(tuple(x.shape), (x.clone(), bn))
        calls[tuple(x.shape)] = calls.get(tuple(x.shape), 0) + 1
        return bn_apply(bn, x, eps)

    TR.bn_apply = recording_bn_apply
    try:
        TR.layer4_features(copy.deepcopy(r50).to(dev), TG.imagenet_input_from_gray(display))
    finally:
        TR.bn_apply = bn_apply
    return r50, inputs, calls


def batchnorm_device_times() -> int:
    """`--batchnorm-device-times`: batchnorm's and F.batch_norm's device
    time (torch.profiler) at every distinct input shape of one ResNet-50
    forward at the serving display, in turns kernel, library, library,
    kernel, with each shape's bound and the sums over the forward's
    launches. Phase 8 runs it in a fresh process: late in a long run the
    profiler keeps only some records of small kernels (and now and then
    drops a window even here, so each time is the mean of the runs it
    kept). Prints one line a shape, then one JSON line."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.nn.functional as F

    from cadx_tpu_torch.kernels import batchnorm as KBN
    from cadx_tpu_torch.serve import engine as E

    dev = torch.device("cuda", 0)
    card = card_line()
    side = E.EngineConfig().segment_hw[0]
    _, inputs, calls = resnet50_bn_inputs(dev, side)
    rows, sums = [], {"device_ms": 0.0, "library_device_ms": 0.0, "bound_ms": 0.0}
    with torch.no_grad():
        for shape, (x, bn) in inputs.items():
            vec = tuple(t.detach() for t in (bn.weight, bn.bias, bn.running_mean,
                                             bn.running_var))

            def kernel(x=x, vec=vec):
                return KBN.batchnorm(x, *vec)

            def library(x=x, vec=vec):
                return F.batch_norm(x, vec[2], vec[3], vec[0], vec[1], training=False, eps=1e-5)

            k1, l1, l2, k2 = (device_ms(kernel, 20), device_ms(library, 20),
                              device_ms(library, 20), device_ms(kernel, 20))
            b_ms, b_by = bound(nbytes((x,) + vec) + nbytes(x), 4 * x.numel())
            row = {"shape": list(shape), "launches_per_forward": calls[shape],
                   "device_ms": captured_mean(k1, k2),
                   "library_device_ms": captured_mean(l1, l2),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            for key in sums:
                sums[key] = None if row[key] is None or sums[key] is None else \
                    sums[key] + calls[shape] * row[key]
            print(f"time batchnorm ResNet-50 input {shape}, {calls[shape]} of the forward's "
                  f"launches: device time (profiler) kernel {ms_text(k1)} / {ms_text(k2)} ms, "
                  f"F.batch_norm {ms_text(l1)} / {ms_text(l2)} ms, bound {b_ms:.4f} ms by "
                  f"{b_by} on {card}", flush=True)
    print(f"time batchnorm, the sum over one ResNet-50 forward's {sum(calls.values())} "
          f"launches at a {side}x{side} display: device time (profiler) kernel "
          f"{ms_text(sums['device_ms'])} ms, F.batch_norm {ms_text(sums['library_device_ms'])} "
          f"ms, bound {sums['bound_ms']:.4f} ms on {card}", flush=True)
    print(json.dumps({"rows": rows, "sums": sums, "launches": sum(calls.values())}), flush=True)
    return 0


TAIL_ITERS, TAIL_WARMUP = 10, 5      # calls a timing of the tails, and before it
TAIL_STEPS = ("object", "bands and markers", "watershed", "ridge and opening")


def pectoral_path_inputs(dev) -> dict:
    """Shape name -> (img_equ, img_bin, breast_mask) as `clean_boundary_gray`
    hands them to pectoral_tail, at the three shapes its paths give it: a
    run_pipeline batch (B=64 at 256², `synthetic_mammograms` seed 10), the
    512² upload (B=1, `synthetic_native_mammogram` seed 7) and
    classify_batch's batch (B=8 at 512², seeds 30-37)."""
    from cadx_tpu_torch.kernels.cleaner_front import cleaner_front
    from cadx_tpu_torch.ops.histogram import equalize_hist
    from cadx_tpu_torch.ops.threshold import (binary_threshold, relative_threshold_value,
                                              to_uint8)
    from cadx_tpu_torch.synthetic import synthetic_mammograms, synthetic_native_mammogram

    raws = {"B=64 256x256 (run_pipeline)": synthetic_mammograms(64, 256, seed=10),
            "B=1 512x512 (the 512x512 upload)": synthetic_native_mammogram(
                512, 512, seed=7, dtype=np.uint8, top=250)[None],
            "B=8 512x512 (classify_batch)": np.stack(
                [synthetic_mammograms(1, 512, seed=30 + i)[0] for i in range(8)])}
    out = {}
    for name, raw in raws.items():
        breast_only, breast, _ = cleaner_front(to_uint8(torch.from_numpy(raw).to(dev)), 15, 0.05)
        equ = equalize_hist(breast_only)
        high = binary_threshold(equ, relative_threshold_value(breast_only, 0.8), 255)
        out[name] = (equ, high, breast.to(torch.uint8) * 255)
    return out


def old_pectoral(lib, equ, high, breast, stop_after: int = 4):
    """The replaced one-block pectoral kernel (`csrc/legacy/`), stopped after
    `stop_after` steps, as a callable on preallocated outputs."""
    from cadx_tpu_torch.kernels import _build

    b, h, w = equ.shape
    labels = torch.empty((b, h, w), dtype=torch.int32, device=equ.device)
    boundary = torch.empty((b, h, w), dtype=torch.bool, device=equ.device)
    mask = torch.empty_like(boundary)
    scratch = torch.empty((b, 6, h, w), dtype=torch.int32, device=equ.device)

    def run():
        rc = lib.cadx_pectoral_tail_one_block(
            equ.data_ptr(), high.data_ptr(), breast.data_ptr(), labels.data_ptr(),
            boundary.data_ptr(), mask.data_ptr(), scratch.data_ptr(), b, h, w, 3, 7, 25,
            stop_after, _build.stream_ptr(equ.device))
        _build.check(rc, "cadx_pectoral_tail_one_block")
        return labels, boundary, mask
    return run


def old_gradcam(lib, acts, grads, img01, out_hw):
    """The replaced one-block Grad-CAM tail (`csrc/legacy/`) on preallocated
    outputs, called as `gradcam_tail` calls its kernel."""
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import gradcam_tail as KGT
    from cadx_tpu_torch.ops.resize import _interp_matrix

    b, h, w, f = acts.shape
    oh, ow = out_hw
    overlay = torch.empty((b, oh, ow, 3), dtype=torch.uint8, device=acts.device)
    heat = torch.empty((b, oh, ow), dtype=torch.uint8, device=acts.device)
    r = torch.as_tensor(_interp_matrix(oh, h), device=acts.device)
    ct = torch.as_tensor(np.ascontiguousarray(_interp_matrix(ow, w).T), device=acts.device)
    ny_gap = KGT._reduce_split(b * f, f, h * w)
    ny_sum = KGT._reduce_split(b * h * w, h * w, f) if acts.stride(3) == h * w else 1
    lut = KGT.jet_lut_rgb()

    def run():
        rc = lib.cadx_gradcam_tail_one_block(
            acts.data_ptr(), grads.data_ptr(), img01.data_ptr(), r.data_ptr(), ct.data_ptr(),
            lut.ctypes.data, overlay.data_ptr(), heat.data_ptr(), b, h, w, f, oh, ow,
            *acts.stride(), *grads.stride(), ny_gap, ny_sum,
            float(np.float32(b * f) / np.float32(b * f * h * w)), _build.stream_ptr(acts.device))
        _build.check(rc, "cadx_gradcam_tail_one_block")
        return overlay, heat
    return run


def tail_device_times() -> int:
    """`--tail-device-times`: the pectoral tail and the Grad-CAM tail beside
    the one-block kernels they replaced, kept in `csrc/legacy/` for this
    and built apart (`_build.load_legacy`). Phase 8 runs it in a fresh
    process, where the profiler keeps every record.

    The pectoral tail at `pectoral_path_inputs`' three shapes: both kernels
    bit-exact against the plain version uncapped; each prefix of the steps
    (TAIL_STEPS; all four are the whole tail) in turns old, new, new, old,
    TAIL_ITERS calls a timing after TAIL_WARMUP (CUDA events), each step's
    time its prefix's less the one before; the plan's tile and blocks, its
    watershed rounds; the plain version; device time by
    kernel. The Grad-CAM tail at the pipeline's (64, 6, 6, 64) -> 256²:
    bit-exact to its old kernel, CUDA events in turns old, new, new, old,
    and each one's device time. Prints one JSON line a row, then one with
    all of them."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import gradcam_tail as KGT
    from cadx_tpu_torch.kernels import pectoral as KP
    from cadx_tpu_torch.kernels import watershed as KW
    from cadx_tpu_torch.synthetic import synthetic_mammograms

    dev = torch.device("cuda", 0)
    card = card_line()
    legacy = _build.load_legacy()

    def timed(fn):
        return cuda_ms(fn, TAIL_ITERS, TAIL_WARMUP)

    rows = []
    for name, inputs in pectoral_path_inputs(dev).items():
        b, h, w = inputs[0].shape
        plain = KP.pectoral_tail_reference(*inputs, max_iters=h * w)
        for what, got in (("old one-block kernel", old_pectoral(legacy, *inputs)()),
                          ("tiled plan", KP.run_plan(*inputs))):
            torch.cuda.synchronize()
            for part, a, c in zip(("labels", "boundary", "mask"), got, plain):
                if not torch.equal(a, c):
                    raise AssertionError(f"pectoral_tail [{part}, {what}, {name}] disagrees "
                                         f"with its plain version")
        sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
        KP.run_plan(*inputs, sweeps=sweeps)
        watershed = {"tile": KW.sweep_tile(b, h, w), "tiles": KW.sweep_tiles(b, h, w),
                     "sweeps": int(sweeps.item())}
        runs = {"old": ([], []), "new": ([], [])}
        for steps in range(1, len(TAIL_STEPS) + 1):
            old = old_pectoral(legacy, *inputs, steps)

            def new(steps=steps):
                return KP.run_plan(*inputs, steps=steps)
            runs["old"][0].append(timed(old))
            runs["new"][0].append(timed(new))
            runs["new"][1].append(timed(new))
            runs["old"][1].append(timed(old))
        prefix = {k: [(x + y) / 2 for x, y in zip(*v)] for k, v in runs.items()}
        by_step = {k: {step: v[i] - (v[i - 1] if i else 0.0) for i, step in enumerate(TAIL_STEPS)}
                   for k, v in prefix.items()}
        row = {"kernel": "pectoral_tail", "shape": name, "card": card,
               "ms": prefix["new"][-1], "old_ms": prefix["old"][-1],
               "plain_ms": cuda_ms(lambda: KP.pectoral_tail_reference(*inputs), 3, 1),
               "by_step_ms": by_step["new"], "old_by_step_ms": by_step["old"],
               "runs_ms": runs, "watershed": watershed,
               "device_ms_by_kernel": device_ms_by_kernel(lambda: KP.run_plan(*inputs))}
        print(json.dumps(row), flush=True)
        rows.append(row)

    rng = np.random.default_rng(3)
    acts = torch.from_numpy(np.abs(rng.standard_normal((64, 64, 6, 6))).astype(np.float32))
    acts = acts.to(dev).permute(0, 2, 3, 1)
    grads = torch.from_numpy(rng.standard_normal((64, 6, 6, 64)).astype(np.float32)).to(dev)
    img01 = torch.from_numpy(synthetic_mammograms(64, 256, seed=3)).to(dev).float() / 255.0
    args = (acts, grads, img01, (256, 256))
    old = old_gradcam(legacy, *args)

    def new():
        return KGT.gradcam_tail(*args)
    for a, c in zip(new(), old()):
        torch.cuda.synchronize()
        if not torch.equal(a, c):
            raise AssertionError("gradcam_tail disagrees with its one-block kernel")
    o1, n1, n2, o2 = timed(old), timed(new), timed(new), timed(old)
    row = {"kernel": "gradcam_tail", "shape": "B=64 (6, 6, 64) -> 256x256 (run_pipeline)",
           "card": card, "ms": (n1 + n2) / 2, "old_ms": (o1 + o2) / 2,
           "runs_ms": [o1, n1, n2, o2], "device_ms": device_ms(new, TAIL_ITERS),
           "old_device_ms": device_ms(old, TAIL_ITERS), "band_rows": KGT.band_rows(64, 256),
           "device_ms_by_kernel": device_ms_by_kernel(new),
           "old_device_ms_by_kernel": device_ms_by_kernel(old)}
    print(json.dumps(row), flush=True)
    print(json.dumps({"card": card, "pectoral_tail": rows, "gradcam_tail": row}), flush=True)
    return 0


# equalize's path shapes: (what, B, H, W)
EQ_SHAPES = (("B=64 256x256 (run_pipeline)", 64, 256, 256),
             ("B=1 512x512 (the 512x512 upload)", 1, 512, 512),
             ("B=8 512x512 (classify_batch)", 8, 512, 512),
             ("B=1 1024x832 (the 1024x832 upload)", 1, 1024, 832),
             ("B=1 1536x1280 (the 3328x2560 upload's bucket)", 1, 1536, 1280),
             ("B=1 3328x2560 (training CLI)", 1, 3328, 2560),
             ("B=1 4608x2656 (training CLI)", 1, 4608, 2656))
# ccl's: (what, B, side); CAM masks at the serving shapes, random masks
CCL_SHAPES = (("B=3 62x62 CAM masks (advanced classify_and_roi)", 3, 62),
              ("B=1 6x6 CAM mask (basic classify)", 1, 6),
              ("B=16 256x256 random masks, density 0.45", 16, 256))
EQ_ITERS = 20


def equalize_path_input(b: int, h: int, w: int, dev) -> torch.Tensor:
    """The image `remove_pectoral` hands equalize at (b, h, w): the breast
    of cleaner_front's output, from `synthetic_mammograms` (seed 10, as
    run_pipeline's first batch; seeds 30-37 at classify_batch's B=8) or,
    at B=1, a `synthetic_native_mammogram` (seed 7) of that shape."""
    from cadx_tpu_torch.kernels.cleaner_front import cleaner_front
    from cadx_tpu_torch.ops.threshold import to_uint8
    from cadx_tpu_torch.synthetic import synthetic_mammograms, synthetic_native_mammogram

    if b == 1:
        raw = synthetic_native_mammogram(h, w, seed=7).astype(np.float32)[None]
    elif b == 8:
        raw = np.stack([synthetic_mammograms(1, h, seed=30 + i)[0] for i in range(b)])
    else:
        raw = synthetic_mammograms(b, h, seed=10)
    return cleaner_front(to_uint8(torch.from_numpy(raw).to(dev)), 15, 0.05)[0].contiguous()


def cam_masks(rng, b: int, side: int, dev) -> torch.Tensor:
    """Grad-CAM hot masks as `xai/roi.py` forms them: CAM >= 0.6 of its
    peak."""
    cams = torch.from_numpy(rng.random((b, side, side)).astype(np.float32)).to(dev)
    return cams >= 0.6 * cams.amax(dim=(1, 2), keepdim=True)


def in_form(module, form: str, fn):
    """fn() with module.form_for answering `form` whatever the shape (the
    C entry point refuses a form beyond its size)."""
    shipped = module.form_for
    module.form_for = lambda *shape: form
    try:
        return fn()
    finally:
        module.form_for = shipped


def old_equalize(lib, x):
    """The replaced one-block equalize (`csrc/legacy/`) on a preallocated
    output."""
    from cadx_tpu_torch.kernels import _build

    out = torch.empty_like(x)

    def run():
        rc = lib.cadx_equalize_hist_one_block(x.data_ptr(), out.data_ptr(), *x.shape,
                                              _build.stream_ptr(x.device))
        _build.check(rc, "cadx_equalize_hist_one_block")
        return out
    return run


def old_ccl(lib, m, conn: int = 8):
    """The replaced one-block CCL (`csrc/legacy/`) on preallocated planes."""
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.ops.components import background_label

    b, h, w = m.shape
    labels = torch.empty((b, h, w), dtype=torch.int32, device=m.device)
    scratch = torch.empty_like(labels)

    def run():
        rc = lib.cadx_ccl_one_block(m.data_ptr(), labels.data_ptr(), scratch.data_ptr(), b, h,
                                    w, conn, background_label(h, w), _build.stream_ptr(m.device))
        _build.check(rc, "cadx_ccl_one_block")
        return labels
    return run


def equalize_ccl_times() -> int:
    """`--equalize-ccl-times`: equalize at every path shape (EQ_SHAPES) and
    ccl at CCL_SHAPES beside the one-block kernels they replaced (kept in
    `csrc/legacy/`, built apart by `_build.load_legacy`), in a fresh
    process, where the profiler keeps every record. Each kernel and its old
    one bit-exact against the plain version (ccl's uncapped) and twice to
    the same bytes; then CUDA events in turns old, new, new, old (EQ_ITERS
    calls a timing after one) and the device time of each (torch.profiler:
    the memset and every launch of a call), each the mean of two windows in
    the same turns. Equalize also on an all-zero and a uniform-random
    3328x2560 image (one hot bin against none) and a trace of one B=1
    3328x2560 call: its launches' grids, memsets and synchronising runtime
    calls. Each row's bound: its inputs and outputs once over the HBM rate
    (one operation an output element, below it); equalize's design floor: 3
    bytes a pixel (read, read again, write). Prints one JSON line a row,
    then one with all of them."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import ccl as KC
    from cadx_tpu_torch.kernels import equalize as KE

    dev = torch.device("cuda", 0)
    card = card_line()
    legacy = _build.load_legacy()

    def same(a, b, what):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{what} disagrees")

    def row_of(kernel, shape, x, new, old, plain, floor_bytes=None, other=None):
        """new and old (and other, (its name, its call)) checked, then timed
        in turns old, new, [other,] [other,] new, old."""
        out = plain()
        runs = (("new", new), ("old", old)) + ((other,) if other else ())
        for name, fn in runs:
            same(fn().clone(), out, f"{kernel} [{name}, {shape}] against its plain version")
            same(fn().clone(), fn().clone(), f"{kernel} [{name}, {shape}] on a second run")
        order = [old, new] + ([other[1]] * 2 if other else []) + [new, old]
        ev = [cuda_ms(fn, EQ_ITERS) for fn in order]
        dv = [device_ms(fn, EQ_ITERS) for fn in order]
        b_ms, b_by = bound(nbytes(x) + nbytes(out), numel(out))
        row = {"kernel": kernel, "shape": shape, "card": card, "ms": (ev[1] + ev[-2]) / 2,
               "old_ms": (ev[0] + ev[-1]) / 2, "runs_ms": ev,
               "device_ms": captured_mean(dv[1], dv[-2]),
               "old_device_ms": captured_mean(dv[0], dv[-1]), "device_runs_ms": dv,
               "bound_ms": b_ms, "bound_by": b_by,
               "device_ms_by_kernel": device_ms_by_kernel(new)}
        if other:
            row[other[0]] = {"ms": (ev[2] + ev[3]) / 2, "device_ms": captured_mean(*dv[2:4]),
                             "device_ms_by_kernel": device_ms_by_kernel(other[1])}
        if floor_bytes is not None:
            row["design_floor_ms"] = floor_bytes / HBM_BYTES_PER_S * 1e3
        print(json.dumps(row), flush=True)
        return row

    # the trace first, while the profiler keeps every record of the process
    h, w = 3328, 2560
    x = equalize_path_input(1, h, w, dev)
    KE.equalize(x)
    events = trace_events(lambda: KE.equalize(x))
    trace = {"shape": f"B=1 {h}x{w}",
             "grids": [e["args"]["grid"] for e in events
                       if e.get("cat") == "kernel" and "grid" in e.get("args", {})],
             "memsets": sum(1 for e in events if e.get("cat") == "gpu_memset"),
             "launch_calls": runtime_calls(events, ("cudaLaunchKernel", "cudaLaunchKernelExC")),
             "sync_calls": runtime_calls(events, ("cudaEventSynchronize",
                                                  "cudaStreamSynchronize", "cudaMemcpy"))}
    print(json.dumps({"equalize_trace": trace}), flush=True)

    eq_rows = []
    for shape, b, h, w in EQ_SHAPES:
        x = equalize_path_input(b, h, w, dev)
        eq_rows.append(row_of("equalize", shape, x, lambda x=x: KE.equalize(x),
                              old_equalize(legacy, x), lambda x=x: KE.equalize_reference(x),
                              3 * x.numel()))
    h, w = 3328, 2560
    rng = np.random.default_rng(4)
    for shape, x in (
            (f"B=1 {h}x{w} all zero (every pixel in one bin)",
             torch.zeros((1, h, w), dtype=torch.uint8, device=dev)),
            (f"B=1 {h}x{w} uniform random bytes (no hot bin)",
             torch.from_numpy(rng.integers(0, 256, (1, h, w), dtype=np.uint8)).to(dev))):
        eq_rows.append(row_of("equalize", shape, x, lambda x=x: KE.equalize(x),
                              old_equalize(legacy, x), lambda x=x: KE.equalize_reference(x),
                              3 * x.numel()))

    # ccl; where the cluster form runs, the tiled form too ("tiled_form")
    ccl_rows = []
    rng = np.random.default_rng(5)
    for shape, b, side in CCL_SHAPES:
        m = (torch.from_numpy(rng.random((b, side, side)) < 0.45).to(dev) if b == 16
             else cam_masks(rng, b, side, dev))
        other = (("tiled_form", lambda m=m: in_form(KC, "tiled", lambda: KC.label_components(m, 8)))
                 if KC.form_for(side, side) == "cluster" else None)
        ccl_rows.append(row_of("ccl", shape, m, lambda m=m: KC.label_components(m, 8),
                               old_ccl(legacy, m),
                               lambda m=m: KC.label_components_reference(m, 8, m[0].numel()),
                               other=other))
    print(json.dumps({"card": card, "equalize": eq_rows, "equalize_trace": trace,
                      "ccl": ccl_rows}), flush=True)
    return 0


# mode's: (what, B, side); CAM labels at the serving shapes, random masks
MODE_SHAPES = (("B=3 62x62 CAM labels (advanced classify_and_roi)", 3, 62),
               ("B=1 6x6 CAM labels (basic classify)", 1, 6),
               ("B=16 256x256 random masks, density 0.45", 16, 256))
# jet_blend's: (what, B, H, W, RGB)
JET_SHAPES = (("B=1 512x512 gray (the reference Grad-CAM display, segment_hw)", 1, 512, 512,
               False),
              ("B=1 512x512 RGB", 1, 512, 512, True),
              ("B=1 1024x832 gray (the one-launch form at 512 threads a block)", 1, 1024, 832,
               False),
              ("B=1 1536x1280 gray (the display cap)", 1, 1536, 1280, False),
              ("B=64 256x256 gray (the pipeline's heatmaps)", 64, 256, 256, False),
              ("B=3 37x53 gray (images off 16-byte boundaries)", 3, 37, 53, False))
def clean_stage_inputs(batch):
    """The inputs the cleaner hands each kernel (launches not counted):
    suppress-site and segment-site masks, the segmented image, its
    equalized image, the high-threshold pectoral mask and the breast."""
    from cadx_tpu_torch.kernels import equalize as KE
    from cadx_tpu_torch.ops.threshold import (binary_threshold,
                                              relative_threshold_value, to_uint8)
    from cadx_tpu_torch.preprocess import cleaner

    raw8 = to_uint8(batch)
    th = relative_threshold_value(raw8, 0.05)
    suppress_bin = binary_threshold(raw8, th, 255) > 0
    sup, breast = cleaner.suppress_artifacts(raw8, 0.05, 15)
    img8 = to_uint8(sup)
    segment_bin = binary_threshold(img8, relative_threshold_value(img8, 0.05), 255) > 0
    seg, _ = cleaner.segment_breast_mask(sup, 0.05)
    seg = seg.to(torch.uint8)
    equ = KE.equalize(seg)
    high = binary_threshold(equ, relative_threshold_value(seg, 0.8), 255)
    return suppress_bin, segment_bin, seg, equ, high, breast


def pectoral_markers(equ, high, breast):
    """The composed remove_pectoral branch's watershed markers."""
    from cadx_tpu_torch.ops.morphology import dilate, erode
    from cadx_tpu_torch.preprocess import cleaner

    pect = cleaner.select_largest_obj(high, 255, fill_holes_=True)
    markers = torch.zeros(equ.shape, dtype=torch.int32, device=equ.device)
    markers = torch.where(erode(pect, 3, 7) > 0, 255, markers)
    markers = torch.where(dilate(pect, 3, 7) == 0, 128, markers)
    return torch.where(breast == 0, 64, markers)


def serpentine(h: int, w: int, step: int) -> np.ndarray:
    """A corridor that doubles back every `step` rows: a flood from (0, 0)
    needs one sweep a turn."""
    m = np.zeros((h, w), bool)
    for r in range(0, h, step):
        m[r, :] = True
        m[r + 1:r + step, w - 1 if (r // step) % 2 == 0 else 0] = True
    return m


def border_flood(masks):
    """(mask, seed) of fill_holes' flood: the background, seeded where it
    meets the image border."""
    inv = ~masks
    edge = torch.zeros_like(inv)
    edge[:, 0], edge[:, -1], edge[:, :, 0], edge[:, :, -1] = True, True, True, True
    return inv.contiguous(), (edge & inv).contiguous()


MJ_ITERS = 20


def smooth_heat(rng, b: int, h: int, w: int) -> torch.Tensor:
    """Grad-CAM-like uint8 heatmaps on the CPU: 6x6 random maps resized
    bilinearly to (h, w), as the pipeline's CAMs are."""
    import torch.nn.functional as F

    cams = torch.from_numpy(rng.random((b, 1, 6, 6)).astype(np.float32))
    up = F.interpolate(cams, size=(h, w), mode="bilinear", align_corners=False)
    return (up[:, 0] * 255).to(torch.uint8).contiguous()


def old_mode(lib, labels, m):
    """The replaced one-block mode (`csrc/legacy/`) through the body of its
    former wrapper: the same input checks and per-call allocations (the
    output and three int32 scratch planes), so that CUDA events compare
    wrapper with wrapper."""
    from cadx_tpu_torch.kernels import _build

    def run():
        _build.check_input(labels, torch.int32, "largest_component_mask labels")
        _build.check_input(m, torch.bool, "largest_component_mask mask")
        b, h, w = labels.shape
        out = torch.empty_like(m)
        scratch = torch.empty((b, 3, h, w), dtype=torch.int32, device=m.device)
        rc = lib.cadx_largest_component_mask_one_block(labels.data_ptr(), m.data_ptr(),
                                                       out.data_ptr(), scratch.data_ptr(), b, h,
                                                       w, _build.stream_ptr(m.device))
        _build.check(rc, "cadx_largest_component_mask_one_block")
        return out
    return run


def old_jet(lib, heat, img01):
    """The replaced three-launch jet_blend (`csrc/legacy/`) through the body
    of its former wrapper: the same input checks and per-call allocations
    (the output and a (B,) int32 peak), so that CUDA events compare wrapper
    with wrapper."""
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import overlay as KOv

    def run():
        _build.check_input(heat, torch.uint8, "jet_blend heat")
        rgb = img01.ndim == 4
        _build.check_input(img01, torch.float32, "jet_blend image", ndim=4 if rgb else 3)
        b, h, w = heat.shape
        out = torch.empty((b, h, w, 3), dtype=torch.uint8, device=heat.device)
        peak = torch.empty(b, dtype=torch.int32, device=heat.device)
        rc = lib.cadx_jet_blend_two_pass(heat.data_ptr(), img01.data_ptr(),
                                         KOv.jet_lut_rgb().ctypes.data, peak.data_ptr(),
                                         out.data_ptr(), b, h, w, 3 if rgb else 1,
                                         1 if rgb else 0, _build.stream_ptr(heat.device))
        _build.check(rc, "cadx_jet_blend_two_pass")
        return out
    return run


def one_call_trace(fn) -> dict:
    """Kernel launches (with grids), memsets and synchronising runtime calls
    of one call of fn, from a torch.profiler trace."""
    events = trace_events(fn)
    return {"grids": [e["args"].get("grid") for e in events if e.get("cat") == "kernel"],
            "names": [e.get("name", "")[:60] for e in events if e.get("cat") == "kernel"],
            "memsets": sum(1 for e in events if e.get("cat") == "gpu_memset"),
            "launch_calls": runtime_calls(events, ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                                   "cudaLaunchCooperativeKernel")),
            "sync_calls": runtime_calls(events, ("cudaEventSynchronize", "cudaStreamSynchronize",
                                                 "cudaMemcpy"))}


def mode_jet_times() -> int:
    """`--mode-jet-times`: mode at MODE_SHAPES and jet_blend at JET_SHAPES
    beside the kernels they replaced (kept in `csrc/legacy/`, built apart
    by `_build.load_legacy`), in a fresh process, where the profiler keeps
    every record. Each kernel, its old one and its other forms (mode at the
    CAM shapes: the other two of the block, cluster and wide forms;
    jet_blend where it takes the one-launch form: the wide form) bit-exact
    against the plain version and twice to the same bytes; then CUDA events
    in turns old, new, other forms twice, new, old (MJ_ITERS calls a timing
    after one) and the device time of each (torch.profiler), the mean of the two
    new and the two old windows. The heatmaps are smooth (6x6 maps resized
    bilinearly, as the paths' CAMs), the images random bytes / 255. Each
    row's bound: its inputs and outputs once over the HBM rate (mode one
    operation, jet_blend 4, an output element). The trace of one mode
    call at B=3 62x62 and one jet_blend call at B=1 512x512 gray must hold
    one kernel launch, no memset and no synchronising runtime call. Prints
    one JSON line a row, then one with all of them."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import ccl as KC
    from cadx_tpu_torch.kernels import mode as KM
    from cadx_tpu_torch.kernels import overlay as KOv

    dev = torch.device("cuda", 0)
    card = card_line()
    legacy = _build.load_legacy()

    def same(a, b, what):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{what} disagrees")

    def row_of(kernel, shape, inputs, new, old, plain, others, ops_per_out):
        out = plain()
        for name, fn in (("new", new), ("old", old)) + others:
            same(fn().clone(), out, f"{kernel} [{name}, {shape}] against its plain version")
            same(fn().clone(), fn().clone(), f"{kernel} [{name}, {shape}] on a second run")
        order = [old, new] + [fn for _, fn in others for _ in (0, 1)] + [new, old]
        ev = [cuda_ms(fn, MJ_ITERS) for fn in order]
        dv = [device_ms(fn, MJ_ITERS) for fn in order]
        b_ms, b_by = bound(nbytes(inputs) + nbytes(out), ops_per_out * numel(out))
        row = {"kernel": kernel, "shape": shape, "card": card, "ms": (ev[1] + ev[-2]) / 2,
               "old_ms": (ev[0] + ev[-1]) / 2, "runs_ms": ev,
               "device_ms": captured_mean(dv[1], dv[-2]),
               "old_device_ms": captured_mean(dv[0], dv[-1]), "device_runs_ms": dv,
               "bound_ms": b_ms, "bound_by": b_by,
               "device_ms_by_kernel": device_ms_by_kernel(new),
               "old_device_ms_by_kernel": device_ms_by_kernel(old)}
        for i, (name, fn) in enumerate(others):
            row[name] = {"ms": (ev[2 + 2 * i] + ev[3 + 2 * i]) / 2,
                         "device_ms": captured_mean(dv[2 + 2 * i], dv[3 + 2 * i]),
                         "device_ms_by_kernel": device_ms_by_kernel(fn)}
        print(json.dumps(row), flush=True)
        return row

    rng = np.random.default_rng(11)
    mode_rows, traces = [], {}
    for shape, b, side in MODE_SHAPES:
        m = (torch.from_numpy(rng.random((b, side, side)) < 0.45).to(dev) if b == 16
             else cam_masks(rng, b, side, dev))
        labels = KC.label_components(m, 8)
        shipped = KM.form_for(side, side)
        others = tuple((f"{form}_form", lambda m=m, labels=labels, form=form: in_form(
            KM, form, lambda: KM.largest_component_mask(labels, m)))
            for form in (("block", "cluster", "wide") if shipped != "wide" else ())
            if form != shipped)
        mode_rows.append(row_of("mode", shape, (labels, m),
                                lambda m=m, labels=labels: KM.largest_component_mask(labels, m),
                                old_mode(legacy, labels, m),
                                lambda m=m, labels=labels: KM.largest_component_mask_reference(
                                    labels, m), others, 1))
        if b == 3:
            traces["mode"] = {"shape": shape, **one_call_trace(
                lambda m=m, labels=labels: KM.largest_component_mask(labels, m))}
    jet_rows = []
    for shape, b, h, w, rgb in JET_SHAPES:
        heat = smooth_heat(rng, b, h, w).to(dev)
        img = torch.from_numpy(rng.integers(0, 256, (b, h, w) + ((3,) if rgb else ()))
                               .astype(np.float32)).to(dev) / 255.0
        others = ((("wide_form", lambda heat=heat, img=img: in_form(
            KOv, "wide", lambda: KOv.jet_blend(heat, img))),)
            if KOv.form_for(b, h, w) == "once" else ())
        jet_rows.append(row_of("jet_blend", shape, (heat, img),
                               lambda heat=heat, img=img: KOv.jet_blend(heat, img),
                               old_jet(legacy, heat, img),
                               lambda heat=heat, img=img: KOv.jet_blend_reference(heat, img),
                               others, 4))
        if (b, h, w, rgb) == (1, 512, 512, False):
            traces["jet_blend"] = {"shape": shape, **one_call_trace(
                lambda heat=heat, img=img: KOv.jet_blend(heat, img))}
    for name, trace in traces.items():
        print(json.dumps({f"{name}_trace": trace}), flush=True)
        if len(trace["grids"]) != 1 or trace["memsets"] or trace["sync_calls"]:
            raise AssertionError(f"{name}'s trace at {trace['shape']} is not one launch with no "
                                 f"memset and no synchronising call: {trace}")
    print(json.dumps({"card": card, "mode": mode_rows, "jet_blend": jet_rows,
                      "traces": traces}), flush=True)
    return 0


FS_ITERS = 20          # most calls a timing of a kernel, after one
FS_WINDOW_S = 0.25     # fewer calls where one takes longer than this / FS_ITERS
FS_PLAIN_ITERS = 3     # calls a timing of a plain version


def old_flood(lib, mask, seed, max_iters: int, conn: int):
    """The replaced one-block flood (`csrc/legacy/`) through the body of its
    former wrapper: the same checks and per-call allocations (the output
    and, where a block's planes pass 200 KB of shared memory, their global
    scratch), so that CUDA events compare wrapper with wrapper."""
    from cadx_tpu_torch.kernels import _build

    def run():
        _build.check_input(mask, torch.bool, "flood_from")
        _build.check_input(seed, torch.bool, "flood_from")
        b, h, w = mask.shape
        out = torch.empty_like(mask)
        words = 3 * h * (-(-w // 32) | 1) + 2 * w * (-(-h // 32) | 1)
        scratch = (torch.empty(b * words, dtype=torch.int32, device=mask.device)
                   if 4 * words > 200 * 1024 else None)
        rc = lib.cadx_flood_from_one_block(mask.data_ptr(), seed.data_ptr(), out.data_ptr(),
                                           None if scratch is None else scratch.data_ptr(), b,
                                           h, w, max_iters, conn, _build.stream_ptr(mask.device))
        _build.check(rc, "cadx_flood_from_one_block")
        return out
    return run


def old_seeded(lib, masks, conn: int):
    """The replaced one-block seeded component (`csrc/legacy/`) through the
    body of its former wrapper: its checks, the output and a (B, 4, H, W)
    int32 scratch."""
    from cadx_tpu_torch.kernels import _build

    def run():
        _build.check_input(masks, torch.bool, "largest_component_seeded")
        b, h, w = masks.shape
        out = torch.empty_like(masks)
        scratch = torch.empty((b, 4, h, w), dtype=torch.int32, device=masks.device)
        rc = lib.cadx_largest_component_seeded_one_block(
            masks.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, h, w, conn, 17,
            _build.stream_ptr(masks.device))
        _build.check(rc, "cadx_largest_component_seeded_one_block")
        return out
    return run


def same_bytes(a, b, what):
    """Raise unless the tensors (or tuples of them) a and b are equal."""
    torch.cuda.synchronize()
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what} disagrees")


def cloned(out):
    return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


def calls_for(fn):
    """FS_ITERS calls, fewer where a call takes more than FS_WINDOW_S /
    FS_ITERS, at least 3."""
    return max(3, min(FS_ITERS, int(FS_WINDOW_S * 1e3 / max(cuda_ms(fn, 1), 1e-3))))


def timing_row(card, kernel, shape, inputs, new, old, plain, exact, others=(), extra=None):
    """Check new, old and others against `exact` (twice each), then time
    them in turns (old, new, each other twice, new, old: CUDA events, then
    profiler device time) and the plain version before and after; print
    and return the row. Bound: inputs and outputs once over the HBM rate,
    at least one operation an output element."""
    for name, fn in (("new", new),) + ((("old", old),) if old else ()) + others:
        same_bytes(cloned(fn()), exact, f"{kernel} [{name}, {shape}] against its plain version")
        same_bytes(cloned(fn()), cloned(fn()), f"{kernel} [{name}, {shape}] on a second run")
    out = new()
    fns = [fn for fn in (old, new) if fn] + [fn for _, fn in others for _ in (0, 1)] \
        + [fn for fn in (new, old) if fn]
    iters = [calls_for(fn) for fn in fns]
    p1 = cuda_ms(plain, FS_PLAIN_ITERS)
    ev = [cuda_ms(fn, n) for fn, n in zip(fns, iters)]
    p2 = cuda_ms(plain, FS_PLAIN_ITERS)
    dv = [device_ms(fn, n) for fn, n in zip(fns, iters)]
    first, last = (1, -2) if old else (0, -1)
    b_ms, b_by = bound(nbytes(inputs) + nbytes(out), numel(out[0] if isinstance(out, tuple)
                                                        else out))
    row = {"kernel": kernel, "shape": shape, "card": card,
           "ms": (ev[first] + ev[last]) / 2, "device_ms": captured_mean(dv[first], dv[last]),
           "plain_ms": (p1 + p2) / 2, "plain_runs_ms": [p1, p2], "runs_ms": ev,
           "device_runs_ms": dv, "calls": iters, "bound_ms": b_ms, "bound_by": b_by,
           "device_ms_by_kernel": device_ms_by_kernel(new)}
    if old:
        row.update(old_ms=(ev[0] + ev[-1]) / 2, old_device_ms=captured_mean(dv[0], dv[-1]),
                   old_device_ms_by_kernel=device_ms_by_kernel(old))
    for i, (name, _) in enumerate(others):
        k = (2 if old else 1) + 2 * i
        row[name] = {"ms": (ev[k] + ev[k + 1]) / 2,
                     "device_ms": captured_mean(dv[k], dv[k + 1])}
    row.update(extra or {})
    if row.get("sweeps"):
        per = row["device_ms"] if row["device_ms"] is not None else row["ms"]
        row["ms_a_sweep"] = per / row["sweeps"]
    print(json.dumps(row), flush=True)
    return row


def flood_seeded_times() -> int:
    """`--flood-seeded-times`: the flood and the seeded component beside the
    one-block kernels they replaced (kept in `csrc/legacy/`, built apart by
    `_build.load_legacy`), in a fresh process, where the profiler keeps
    every record.

    - flood, 4-connected: fill_holes' border flood of suppress-site
      backgrounds (run_pipeline's B=64 256² batch; B=1 1536x1280 and
      3328x2560 synthetic natives) at the default 128 sweeps, and four
      serpentines (B=4 256²) that run into that cap; the sweeps a call
      (the kernel's own count) and the device time a sweep;
    - the seeded component, 8-connected: generated masks (blobs, ties,
      random, empty) with 8 suppress-site masks at B=16 256², generated
      masks at 1536x1280, random masks at density 0.45 (B=16 256²), also
      beside ccl + mode and largest_obj without fill or opening.

    Each kernel, and its old one, bit-exact against the plain version (the
    seeded component uncapped) and twice to the same bytes; CUDA events and
    profiler device time in turns old, new, other launches twice, new, old,
    up to FS_ITERS calls a timing after one; the plain version
    FS_PLAIN_ITERS calls before and after (`timing_row`). Traces of one
    call: the flood at B=1 1536x1280 and B=64
    256² must be one launch, at most one memset, no synchronising runtime
    call; the seeded component at B=16 256² launches no flood and nothing
    of one block an image (every grid holds more blocks than images). Prints
    one JSON line a row, then one with all of them."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import ccl as KC
    from cadx_tpu_torch.kernels import flood as KFl
    from cadx_tpu_torch.kernels import largest_obj as KL
    from cadx_tpu_torch.kernels import mode as KM
    from cadx_tpu_torch.ops import components as TC
    from cadx_tpu_torch.synthetic import synthetic_mammograms, synthetic_native_mammogram

    dev = torch.device("cuda", 0)
    card = card_line()
    legacy = _build.load_legacy()

    def row_of(*args, **kwargs):
        return timing_row(card, *args, **kwargs)

    def suppress_site(batch):
        return clean_stage_inputs(batch)[0]

    rng = np.random.default_rng(12)
    # the flood: fill_holes' border flood (4-connected, 128 sweeps at most)
    pipe = torch.from_numpy(synthetic_mammograms(64, 256, seed=10)).to(dev)
    natives = {(h, w): torch.from_numpy(synthetic_native_mammogram(h, w, seed=21).astype(
        np.float32)).to(dev)[None] for h, w in ((1536, 1280), (3328, 2560))}
    serp = torch.from_numpy(np.stack([serpentine(256, 256, st) for st in (2, 3, 4, 8)])).to(dev)
    serp_seed = torch.zeros_like(serp)
    serp_seed[:, 0, 0] = True
    flood_in = [("B=64 256x256 border flood of suppress-site backgrounds (run_pipeline's batch)",
                 border_flood(suppress_site(pipe)))]
    flood_in += [(f"B=1 {h}x{w} border flood of a suppress-site background",
                  border_flood(suppress_site(x))) for (h, w), x in natives.items()]
    flood_in.append(("B=4 256x256 serpentines (steps 2, 3, 4, 8), into the 128-sweep cap",
                     (serp, serp_seed)))
    flood_rows, traces = [], {}
    sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
    for shape, (m, seed) in flood_in:
        exact = KFl.flood_from_reference(m, seed, 128, 4)
        KFl.flood_from(m, seed, 128, 4, sweeps=sweeps)
        n = int(sweeps.item())
        row = row_of("flood", shape, (m, seed),
                     lambda m=m, seed=seed: KFl.flood_from(m, seed, 128, 4),
                     old_flood(legacy, m, seed, 128, 4),
                     lambda m=m, seed=seed: KFl.flood_from_reference(m, seed, 128, 4), exact,
                     extra={"sweeps": n})
        flood_rows.append(row)
        if m.shape[0] == 64 or m.shape[1:] == (1536, 1280):
            traces[f"flood {tuple(m.shape)}"] = {"shape": shape, **one_call_trace(
                lambda m=m, seed=seed: KFl.flood_from(m, seed, 128, 4))}
    del natives

    # the seeded component, 8-connected, beside ccl + mode and largest_obj
    small = torch.from_numpy(synthetic_mammograms(16, 256, seed=1)).to(dev)
    seeded_in = [
        ("B=16 256x256: 8 generated (blobs, ties, random, empty) + 8 suppress-site masks",
         torch.from_numpy(np.concatenate([seeded_masks(rng, 256, 256),
                                          suppress_site(small)[:8].cpu().numpy()])).to(dev)),
        ("B=7 1536x1280 generated masks (blobs, ties, random, empty)",
         torch.from_numpy(seeded_masks(rng, 1536, 1280)).to(dev)),
        ("B=16 256x256 random masks, density 0.45",
         torch.from_numpy(rng.random((16, 256, 256)) < 0.45).to(dev))]
    seeded_rows = []
    for shape, m in seeded_in:
        exact = TC.largest_component_plain(m, 8, m.shape[1] * m.shape[2])
        seeded_rows.append(row_of(
            "largest_component_seeded", shape, (m,),
            lambda m=m: KL.largest_component_seeded(m, 8), old_seeded(legacy, m, 8),
            lambda m=m: KL.largest_component_seeded_reference(m, 8), exact,
            (("ccl_mode", lambda m=m: KM.largest_component_mask(KC.label_components(m, 8), m)),
             ("largest_obj", lambda m=m: KL.largest_obj(m, 8)))))
        if m.shape == (16, 256, 256) and "seeded" not in traces:
            traces["seeded"] = {"shape": shape, "images": m.shape[0], **one_call_trace(
                lambda m=m: KL.largest_component_seeded(m, 8))}

    for name, trace in traces.items():
        print(json.dumps({f"{name}_trace": trace}), flush=True)
        if name.startswith("flood") and (len(trace["grids"]) != 1 or trace["memsets"] > 1
                                         or trace["sync_calls"]):
            raise AssertionError(f"{name}'s trace is not one launch with at most one memset "
                                 f"and no synchronising call: {trace}")
        if name == "seeded" and (trace["sync_calls"] or any(
                "flood" in k or g[0] * g[1] * g[2] <= trace["images"]
                for k, g in zip(trace["names"], trace["grids"]))):
            raise AssertionError(f"the seeded component launched a flood, a grid of one block "
                                 f"an image or a synchronising call: {trace}")
    print(json.dumps({"card": card, "flood": flood_rows, "largest_component_seeded": seeded_rows,
                      "traces": traces}), flush=True)
    return 0


# the packed watershed's shapes: (B, H, W) of the timings (cleaner markers),
# and the sides phase 2 and the card tests hold it at, for B = 1, 8 and 16
PACKED_TIMED = ((1, 512, 512), (8, 512, 512), (16, 256, 256))
PACKED_SIDES = ((1, 1), (31, 33), (32, 32), (33, 31), (63, 65), (200, 136), (511, 512),
                (512, 512))
# serpentine sides where JAX's 256-sweep cap binds (phase 10 and the timings)
SERPENTINE_SIDES = (128, 512)
# the packed form's and pectoral_tail's times before the sweeps were held
# to JAX's cap (PERF.md rows 3 and 7, the rounds design's last records; NVIDIA H100
# 80GB HBM3, 700 W): device time from the profiler, in ms
PACKED_RECORDS_MS = {(1, 512, 512): 0.0978, (8, 512, 512): 0.1736, (16, 256, 256): 0.1469}
PECTORAL_RECORDS_MS = {"B=64 256x256 (run_pipeline)": (0.7071, 0.7302),
                       "B=1 512x512 (the 512x512 upload)": (0.2624, 0.2910)}


def packed_inputs(rng, b: int, h: int, w: int, n_values: int, case: str, dev):
    """(image, markers, values) for the packed watershed: float images (a
    smooth field with noise up to 1000, half of the pixels at x.5) and
    markers of the first n_values of (255, 128, 64): discs and a band
    ("some"), every pixel a marker ("all") or none ("none")."""
    yy, xx = np.mgrid[0:h, 0:w]
    field = 500 + 500 * np.sin(xx / (3 + w / 9)) * np.cos(yy / (4 + h / 11))
    img = np.clip(field + rng.normal(0, 50, (b, h, w)), 0, 1000)
    img = (np.floor(img) + np.where(rng.random((b, h, w)) < 0.5, 0.5, 0.0)).astype(np.float32)
    values = (255, 128, 64)[:n_values]
    mk = np.zeros((b, h, w), np.int32)
    if case == "all":
        mk[:] = values[-1]
        mk[:, : h // 2] = values[0]
    elif case == "some":
        for i in range(b):
            for v in values:
                cy, cx = rng.integers(0, h), rng.integers(0, w)
                mk[i][(yy - cy) ** 2 + (xx - cx) ** 2 < (min(h, w) // 8 + 1) ** 2] = v
        mk[:, -1, : w // 3] = values[-1]
    return torch.from_numpy(img).to(dev), torch.from_numpy(mk).to(dev), values


def watershed_serpentine(side: int, dev):
    """(image, markers) (1, side, side): a 1-pixel corridor of value 0
    winding down rows 0, 2, 4, ... (joined at alternate ends) between walls
    of 200, marker 255 at its start and 128 beside it, where JAX's
    256-sweep cap stops the relaxation before the corridor is flooded."""
    img = np.full((side, side), 200, np.float32)
    img[::2] = 0
    for r in range(1, side, 2):
        img[r, side - 1 if (r // 2) % 2 == 0 else 0] = 0
    mk = np.zeros((side, side), np.int32)
    mk[0, 0], mk[1, 0] = 255, 128
    return torch.from_numpy(img)[None].to(dev), torch.from_numpy(mk)[None].to(dev)


def plain_packed_sweeps(img, mk, values, max_iters: int, max_scan: int) -> int:
    """The sweeps the plain packed relaxation runs on a batch: up to the
    first that changes no image, at most max_iters."""
    from cadx_tpu_torch.ops import geodesic_scan as G

    h, w = img.shape[-2:]
    k, big = G._pack_params(h, w)
    srow, scol = G.axis_costs_packed(img, k)
    small = torch.zeros_like(mk)
    for i, v in enumerate(values):
        small = torch.where(mk == v, i + 1, small)
    pk = torch.where(small > 0, small, big)
    for n in range(1, max_iters + 1):
        new = G.sweep_packed(pk, srow, scol, max_scan, big)
        if not bool((new != pk).any()):
            return n
        pk = new
    return max_iters


def old_packed(lib, img, mk, values):
    """The replaced packed form that relaxed tiles to the fixpoint in
    rounds (`csrc/legacy/watershed_packed_rounds.cu`) on preallocated
    outputs, as its wrapper called it; `run.rounds` holds its rounds."""
    from cadx_tpu_torch.kernels import _build

    b, h, w = img.shape
    labels = torch.empty((b, h, w), dtype=torch.int32, device=img.device)
    boundary = torch.empty((b, h, w), dtype=torch.bool, device=img.device)
    tiles = b * -(-h // 32) * -(-w // 32)
    scratch = torch.empty((8 * b * h * w + 16 + 2 * tiles,), dtype=torch.uint8,
                          device=img.device)
    rounds = torch.zeros(1, dtype=torch.int32, device=img.device)
    v = values + (0,) * (3 - len(values))

    def run():
        rc = lib.cadx_watershed_packed_rounds(
            img.data_ptr(), mk.data_ptr(), labels.data_ptr(), boundary.data_ptr(),
            scratch.data_ptr(), rounds.data_ptr(), b, h, w, v[0], v[1], v[2], len(values),
            _build.stream_ptr(img.device))
        _build.check(rc, "cadx_watershed_packed_rounds")
        return labels, boundary
    run.rounds = rounds
    return run


def packed_watershed_times() -> int:
    """`--packed-watershed-times`: the packed marker watershed, its sweeps
    held to JAX's cap, beside the form it replaced that relaxed tiles to
    the fixpoint in rounds (`csrc/legacy/watershed_packed_rounds.cu`, built
    apart by `_build.load_legacy`) and beside its plain version, and
    pectoral_tail, which runs the same sweeps, beside its records; in a
    fresh process, where the profiler keeps every record.

    - the packed watershed on the equalized images and cleaner markers of
      synthetic mammograms at PACKED_TIMED (seed 30), as the cleaner's
      composed branch calls it (max_scan 8, 256 sweeps at most): new and
      old bit-exact against the plain version at that cap and twice to the
      same bytes, then CUDA events and profiler device time in turns old,
      new, new, old (`timing_row`), the plain version before and after; the
      sweeps the kernel ran beside the plain version's and the old form's
      rounds, the bound (13 bytes a pixel: image and markers in, labels and
      boundary out), this design's floor (`packed_floor_bytes` over the HBM
      rate) and the rounds design's record (PACKED_RECORDS_MS);
    - the serpentines at SERPENTINE_SIDES, where the cap binds: bit-exact
      against the plain version at 256 sweeps (max_scan 8), the sweeps run
      and the times (the old form's fixpoint differs from them);
    - a trace of one call at B=1 512²: three launches (prologue, the
      cooperative sweeps, epilogue), none of one block an image, no
      synchronising runtime call;
    - pectoral_tail at `pectoral_path_inputs`' B=64 256² and B=1 512²:
      bit-exact to its plain version at its 256-sweep cap, its sweeps,
      CUDA events and device time over TAIL_ITERS calls after TAIL_WARMUP,
      beside PECTORAL_RECORDS_MS.

    Prints one JSON line a row, then one with all of them."""
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import pectoral as KP
    from cadx_tpu_torch.kernels import watershed as KW
    from cadx_tpu_torch.synthetic import synthetic_mammograms

    dev = torch.device("cuda", 0)
    card = card_line()
    legacy = _build.load_legacy()
    values = (255, 128, 64)
    packed_in = {}
    for b, h, w in PACKED_TIMED:
        batch = torch.from_numpy(synthetic_mammograms(b, h, seed=30)).to(dev)
        _, _, _, equ, high, breast = clean_stage_inputs(batch)
        packed_in[(b, h, w)] = (equ.to(torch.float32), pectoral_markers(equ, high, breast))
    # the trace first, while the profiler keeps every record of the process
    img, mk = packed_in[PACKED_TIMED[0]]
    KW.marker_watershed(img, mk, max_scan=8, marker_label_values=values)
    trace = {"shape": "B=1 512x512 cleaner markers", "images": 1, **one_call_trace(
        lambda: KW.marker_watershed(img, mk, max_scan=8, marker_label_values=values))}

    def kernel_sweeps(img, mk):
        sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
        KW.packed_form(img, mk, values, torch.empty_like(mk),
                       torch.empty(img.shape, dtype=torch.bool, device=dev), 256, 8,
                       sweeps=sweeps)
        return int(sweeps.item())

    rows = []
    for b, h, w in PACKED_TIMED:
        img, mk = packed_in[(b, h, w)]
        capped = KW.marker_watershed_reference(img, mk, max_iters=256, max_scan=8,
                                               marker_label_values=values)
        n_sweeps = kernel_sweeps(img, mk)
        old = old_packed(legacy, img, mk, values)
        old()
        floor_ms = KW.packed_floor_bytes(b, h, w, n_sweeps) / HBM_BYTES_PER_S * 1e3
        rows.append(timing_row(
            card, "watershed_packed", f"B={b} {h}x{w} cleaner markers", (img, mk),
            lambda img=img, mk=mk: KW.marker_watershed(img, mk, max_scan=8,
                                                       marker_label_values=values),
            old, lambda img=img, mk=mk: KW.marker_watershed_reference(
                img, mk, max_scan=8, marker_label_values=values), capped,
            extra={"sweeps": n_sweeps,
                   "plain_sweeps": plain_packed_sweeps(img, mk, values, 256, 8),
                   "old_rounds": int(old.rounds.item()), "tiles": KW.sweep_tiles(b, h, w),
                   "floor_ms": floor_ms, "floor_bytes_a_pixel": 29 + 16 * n_sweeps,
                   "record_device_ms": PACKED_RECORDS_MS[(b, h, w)]}))
    for side in SERPENTINE_SIDES:
        img, mk = watershed_serpentine(side, dev)
        capped = KW.marker_watershed_reference(img, mk, max_iters=256, max_scan=8,
                                               marker_label_values=values)
        rows.append(timing_row(
            card, "watershed_packed", f"B=1 {side}x{side} serpentine (the 256-sweep cap binds)",
            (img, mk), lambda img=img, mk=mk: KW.marker_watershed(
                img, mk, max_scan=8, marker_label_values=values), None,
            lambda img=img, mk=mk: KW.marker_watershed_reference(
                img, mk, max_scan=8, marker_label_values=values), capped,
            extra={"sweeps": kernel_sweeps(img, mk),
                   "plain_sweeps": plain_packed_sweeps(img, mk, values, 256, 8)}))
    print(json.dumps({"watershed_packed_trace": trace}), flush=True)
    if (len(trace["grids"]) != 3 or trace["sync_calls"]
            or any(g[0] * g[1] * g[2] <= trace["images"] for g in trace["grids"])):
        raise AssertionError(f"the packed watershed's call is not three launches over tiles "
                             f"x images without a synchronising call: {trace}")

    tail_rows = []
    for name, inputs in pectoral_path_inputs(dev).items():
        if name not in PECTORAL_RECORDS_MS:
            continue
        h, w = inputs[0].shape[1:]
        plain = KP.pectoral_tail_reference(*inputs, max_iters=h * w)
        same_bytes(KP.run_plan(*inputs), plain, f"pectoral_tail [{name}]")
        sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
        KP.run_plan(*inputs, sweeps=sweeps)

        def plan(inputs=inputs):
            return KP.run_plan(*inputs)
        ev = [cuda_ms(plan, TAIL_ITERS, TAIL_WARMUP) for _ in range(2)]
        dv = [device_ms(plan, TAIL_ITERS) for _ in range(2)]
        rec_device, rec_ms = PECTORAL_RECORDS_MS[name]
        row = {"kernel": "pectoral_tail", "shape": name, "card": card,
               "ms": sum(ev) / 2, "runs_ms": ev, "device_ms": captured_mean(*dv),
               "device_runs_ms": dv, "sweeps": int(sweeps.item()),
               "record_device_ms": rec_device, "record_ms": rec_ms,
               "device_ms_by_kernel": device_ms_by_kernel(plan)}
        print(json.dumps(row), flush=True)
        tail_rows.append(row)
    print(json.dumps({"card": card, "watershed_packed": rows, "trace": trace,
                      "pectoral_tail": tail_rows}), flush=True)
    return 0


def bmp24_bytes(bgr: np.ndarray) -> bytes:
    """A bottom-up 24-bit BMP (BITMAPINFOHEADER) of (h, w, 3) BGR bytes."""
    h, w, _ = bgr.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = bgr[::-1].reshape(h, 3 * w)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + info + rows.tobytes()


def png16_bytes(img: np.ndarray) -> bytes:
    """A 16-bit gray PNG of `img` (filter 0 on every row), in the chunks of
    the port's `xai/png.py`."""
    from cadx_tpu_torch.xai import png

    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.astype(">u2").view(np.uint8).reshape(h, 2 * w)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0,
                                                                    0, 0))
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + png._chunk(b"IEND", b""))


class FrontClient:
    """HTTP calls to the front on 127.0.0.1; any 500 or "error" field raises."""

    def __init__(self, port: int):
        self.port = port

    def _call(self, method: str, path: str, body: bytes = b"", headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            data = r.read()
            return r.status, dict(r.getheaders()), data
        finally:
            conn.close()

    def get(self, path: str) -> dict:
        status, _, data = self._call("GET", path)
        out = json.loads(data)
        if status != 200 or "error" in out:
            raise AssertionError(f"GET {path}: HTTP {status} {str(out)[:300]}")
        return out

    def post(self, path: str, fields: dict, files: dict, location: str) -> None:
        boundary = "CADXFRONTBOUNDARY"
        parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
                 f"{v}\r\n".encode() for k, v in fields.items()]
        parts += [(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; '
                   f'filename="{name}"\r\nContent-Type: application/octet-stream\r\n\r\n'
                   ).encode() + data + b"\r\n" for k, (name, data) in files.items()]
        body = b"".join(parts) + f"--{boundary}--\r\n".encode()
        status, headers, data = self._call(
            "POST", path, body, {"Content-Type": f"multipart/form-data; boundary={boundary}"})
        if status != 302 or headers.get("Location") != location:
            raise AssertionError(f"POST {path}: HTTP {status} {headers.get('Location')} "
                                 f"{data[:300]!r}")


def front_phase(uploads: dict, engine_p50: dict, zero_counts, read_counts, card: str) -> dict:
    """Phase 9: the port's HTTP front on the card, over a socket. Returns
    the launch counts of its counted rounds, summed (the record's "front"
    path)."""
    from cadx_tpu_torch.data import dicom as TDicom
    from cadx_tpu_torch.data import imageio, native_loader
    from cadx_tpu_torch.serve import app as A
    from cadx_tpu_torch.synthetic import synthetic_native_mammogram
    from cadx_tpu_torch.xai import png as TPng

    big = uploads["3328x2560 u16"]
    deep = synthetic_native_mammogram(1024, 832, seed=7, dtype=np.uint16, top=60000)
    # kind -> (file name, bytes, the image written, phase 8's shape)
    files = {"512x512 u8 PNG": ("case512.png", TPng.encode_png(uploads["512x512 u8"]),
                                uploads["512x512 u8"], "512x512 u8"),
             "1024x832 u16 PNG": ("deep1024.png", png16_bytes(deep), deep, "1024x832 u8")}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, ts, fname in (("3328x2560 u16 DICOM explicit LE", TDicom.TS_EXPLICIT_LE,
                                 "scan_le.dcm"),
                                ("3328x2560 u16 DICOM JPEG lossless SV1",
                                 TDicom.TS_JPEG_LOSSLESS_SV1, "scan_sv1.dcm"),
                                ("3328x2560 u16 DICOM RLE", TDicom.TS_RLE, "scan_rle.dcm")):
            t = time.perf_counter()
            path = os.path.join(tmp, fname)
            TDicom.dcmwrite_minimal(path, big, "FRONT", transfer_syntax=ts)
            with open(path, "rb") as fh:
                files[kind] = (fname, fh.read(), big, "3328x2560 u16")
            print(f"front: {kind} written by dcmwrite_minimal in "
                  f"{time.perf_counter() - t:.2f} s, {len(files[kind][1])} bytes", flush=True)
    try:
        native_loader.get_lib()
        native = "built"
    except native_loader.NativeUnavailable as e:
        native = f"unavailable ({str(e)[:200]})"
    print(f"front: the native DICOM decoder (native/cadx_io.cc, g++) is {native}", flush=True)
    # a progressive JPEG (libjpeg-turbo's full progression as cv2 writes it,
    # quality 75, of the 512x512 upload's synthetic image:
    # tests/data/upload_progressive.jpg) and a 24-bit BMP under a .png name;
    # the image each upload should store is the reader's
    prog = (Path(__file__).resolve().parent / "tests" / "data" /
            "upload_progressive.jpg").read_bytes()
    u8 = uploads["512x512 u8"]
    bgr = np.stack([u8, u8[::-1], 255 - u8], axis=-1)
    with tempfile.TemporaryDirectory() as tmp:
        for kind, fname, data in (("512x512 progressive JPEG", "case512p.jpg", prog),
                                  ("512x512 BMP named .png", "case512b.png", bmp24_bytes(bgr))):
            path = os.path.join(tmp, fname)
            with open(path, "wb") as fh:
                fh.write(data)
            files[kind] = (fname, data, imageio.imread_gray(path), "512x512 u8")
            check_read = files[kind][2]
            if check_read is None or check_read.shape != u8.shape:
                raise AssertionError(f"front: the reader cannot read the {kind}")

    front = {}
    ws_root = tempfile.TemporaryDirectory()
    t = time.perf_counter()
    srv = A.make_server(ws_root.name, "127.0.0.1", 0, warmup=True)
    eng, ws = srv.app.engine, srv.app.ws
    print(f"front: make_server with warmup in {time.perf_counter() - t:.2f} s, engine on "
          f"{eng.device}", flush=True)
    if eng.device.type != "cuda":
        raise AssertionError(f"the front's engine is on {eng.device}")
    jobs = []
    submit = ws.submit

    def tracked_submit(key, fn, *args):
        fut = submit(key, fn, *args)
        jobs.append((key, fut))
        return fut
    ws.submit = tracked_submit
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    client = FrontClient(srv.server_address[1])
    seg_hw = tuple(eng.config.segment_hw)
    expl_names = [f"gradcam_{k}_class_{c}.png" for k in ("overlay", "heatmap") for c in (0, 1)]

    def check(what: str, ok: bool, detail=""):
        if not ok:
            raise AssertionError(f"front {what}: {detail}")

    def close_probs(a, b, what):
        err = float(np.abs(np.subtract(a, b)).max())
        check(what, err <= 1e-6, f"probabilities differ by {err} > 1e-6")
        return err

    def add(counts):
        for k, v in counts.items():
            front[k] = front.get(k, 0) + v

    try:
        # ---- one counted round per upload, each answer against the engine
        for kind, (fname, data, img, _) in files.items():
            zero_counts()
            client.post("/upload-single", {"body_part1": "Left breast", "modality1": "Mammogram"},
                        {"image1": (fname, data)}, "/diagnosis")
            masks = client.get("/view_segmentation")["masks"]
            check(f"{kind} masks", len(masks) == 64, f"{len(masks)} masks")
            answers, overlays = {}, {}
            for pipeline in ("basic", "advanced"):
                answers[("classify", pipeline)] = client.get(f"/classify?pipeline={pipeline}")
                ws.wait("gradcam")
                overlays[pipeline] = {}
                for name in expl_names:
                    with open(os.path.join(ws.folder("explainability"), name), "rb") as fh:
                        overlays[pipeline][name] = fh.read()
            for pipeline in ("basic", "advanced"):
                answers[("roi", pipeline)] = client.get(f"/roi?pipeline={pipeline}")
            ws.wait("save_masks")
            counts = read_counts()
            add(counts)
            need = ["cleaner_front", "equalize", "conv_leaky", "pool", "ccl", "mode", "jet_blend"]
            need += ["largest_obj", "watershed"] if max(img.shape) > 512 else ["pectoral_tail"]
            missing = [k for k in need if counts[k] == 0]
            print(f"front launches, {kind} round (upload, masks, classify and roi x 2 "
                  f"pipelines, Grad-CAM jobs): {({k: v for k, v in counts.items() if v})}",
                  flush=True)
            check(f"{kind} launches", not missing, f"no launch of {missing}")

            (case,) = ws.read_cases()
            check(f"{kind} case", case["image_name"] == fname, case)
            decoded = A._imread_gray(case["dicom_file_path"])
            stored = np.load(case["preprocessed_file_path"])
            check(f"{kind} decode", decoded is not None and decoded.dtype == img.dtype
                  and np.array_equal(decoded, img) and np.array_equal(stored, img),
                  "the stored upload is not the image written")
            feats_d, clean_d = eng.process_single_image(decoded)
            feats_f = np.load(case["segmented_images_file_path"])
            f_err = float(np.abs(feats_f - feats_d).max())
            check(f"{kind} features", feats_f.shape == feats_d.shape and f_err <= 1e-6,
                  f"differ by {f_err}")
            with open(case["clean_image_path"], "rb") as fh:
                clean_f = imageio.png_gray(fh.read())
            check(f"{kind} clean PNG", np.array_equal(clean_f, clean_d), "differs")
            p_errs = []
            for pipeline in ("basic", "advanced"):
                route = answers[("classify", pipeline)]["classificationData"][0]
                direct = eng.classify(feats_d, pipeline)
                p_errs.append(close_probs(route["prediction_probabilities"],
                                          direct["prediction_probabilities"],
                                          f"{kind} /classify {pipeline}"))
                check(f"{kind} /classify {pipeline}",
                      route["predicted_class"] == direct["predicted_class"]
                      and route["roiCoords"] == direct["roiCoords"], (route, direct))
                base, coords = eng.classify_and_roi(feats_d, pipeline, (0, 1))
                roi_rows = answers[("roi", pipeline)]["classificationData"]
                check(f"{kind} /roi {pipeline} boxes",
                      [r["roiCoords"] for r in roi_rows] == coords, (roi_rows, coords))
                for r in roi_rows:
                    p_errs.append(close_probs(r["prediction_probabilities"],
                                              base["prediction_probabilities"],
                                              f"{kind} /roi {pipeline}"))
                with tempfile.TemporaryDirectory() as od:
                    eng.write_gradcam_overlays(feats_d, clean_d, od, (0, 1), pipeline)
                    for name in expl_names:
                        with open(os.path.join(od, name), "rb") as fh:
                            check(f"{kind} {pipeline} {name}",
                                  fh.read() == overlays[pipeline][name], "differs")
            print(f"front {kind}: stored upload equal to the image written, features "
                  f"max_abs_err {f_err}, clean PNG equal, probabilities max_abs_err "
                  f"{max(p_errs)}, ROI boxes, overlay and heatmap PNGs equal to the engine "
                  f"called directly", flush=True)

        # ---- bulk: a zip of PNGs, each against classify_batch
        bulk_imgs = [synthetic_native_mammogram(*FRONT_BULK_HW, seed=40 + i, dtype=np.uint8,
                                                top=250) for i in range(N_FRONT_BULK)]
        names = [f"bulk{i}.png" for i in range(N_FRONT_BULK)]
        zbuf = io.BytesIO()
        with zipfile.ZipFile(zbuf, "w") as zf:
            for name, im in zip(names, bulk_imgs):
                zf.writestr(name, TPng.encode_png(im))
        zip_bytes = zbuf.getvalue()
        client.post("/upload-bulk", {}, {"bulk_images_zip": ("bulk.zip", zip_bytes)},
                    "/bulk-select-parameters")
        check("bulk list", client.get("/bulk-select-parameters")["images"] == names, names)
        zero_counts()
        bulk_rows = {p: client.get(f"/bulk-classify?pipeline={p}")["classificationData"]
                     for p in ("basic", "advanced")}
        counts = read_counts()
        add(counts)
        print(f"front launches, bulk round (/bulk-classify x 2 pipelines, B={N_FRONT_BULK}): "
              f"{({k: v for k, v in counts.items() if v})}", flush=True)
        missing = [k for k in ("cleaner_front", "equalize", "pectoral_tail", "conv_leaky", "pool")
                   if counts[k] == 0]
        check("bulk launches", not missing, f"no launch of {missing}")
        stack = np.stack([A._resize_area_like(
            A._imread_gray(os.path.join(ws.folder("bulk"), n)), seg_hw, eng.device)
            for n in names])
        b_errs = []
        for pipeline, rows in bulk_rows.items():
            direct = eng.classify_batch(stack, pipeline)
            check(f"bulk {pipeline} rows", [r["image_name"] for r in rows] == names
                  and len(direct) == len(rows), rows)
            for r, d in zip(rows, direct):
                b_errs.append(close_probs(r["prediction_probabilities"],
                                          d["prediction_probabilities"], f"bulk {pipeline}"))
                check(f"bulk {pipeline} row", all(r[k] == d[k] for k in (
                    "sample", "predicted_class", "diagnosis")), (r, d))
        client.post("/upload-bulk-image", {"bulk_image_name": names[0], "modality1": "MG"}, {},
                    "/diagnosis")
        (case,) = ws.read_cases()
        check("/upload-bulk-image", case["image_name"] == names[0]
              and np.array_equal(np.load(case["preprocessed_file_path"]), bulk_imgs[0]), case)
        print(f"front bulk: {N_FRONT_BULK} PNGs at {FRONT_BULK_HW}, rows equal to "
              f"classify_batch on the same resized stack (probabilities max_abs_err "
              f"{max(b_errs)}); /upload-bulk-image stored {names[0]}", flush=True)

        # ---- times: each route's p50 on the host clock around the HTTP call
        def route_p50(fn, n=N_TIMED):
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        for kind, (fname, data, img, shape) in files.items():
            up_ms = route_p50(lambda: client.post(
                "/upload-single", {"modality1": "MG"}, {"image1": (fname, data)}, "/diagnosis"))
            raw = ws.read_cases()[0]["dicom_file_path"]
            before = dict(TDicom.DECODER_RUNS)
            imageio.imread_gray(raw)
            used = sorted(f"{c} {how}" for (c, how), v in TDicom.DECODER_RUNS.items()
                          if v != before.get((c, how), 0))
            decoder = ", ".join(used) if used else {
                b"\x89P": "PNG, Python (numpy, zlib)", b"\xff\xd8": "JPEG, Python (numpy)",
                b"BM": "BMP, Python (numpy)"}.get(data[:2], "uncompressed")
            dec_ms = route_p50(lambda: imageio.imread_gray(raw))
            eng_ms = p50_ms(lambda: eng.process_single_image(img), N_TIMED)
            # the route's other host stages, each alone on the same data
            feats_d, clean_d = eng.process_single_image(img)
            with tempfile.TemporaryDirectory() as st:
                png_ms = route_p50(lambda: A._imwrite(os.path.join(st, "c.png"), clean_d))
                npy_ms = route_p50(lambda: (np.save(os.path.join(st, "i.npy"), img),
                                            np.save(os.path.join(st, "f.npy"), feats_d)))
                masks_ms = route_p50(lambda: A.save_masks(feats_d, fname, st))
            print(f"time front /upload-single {kind} ({len(data)} bytes): p50 {up_ms:.3f} ms "
                  f"over {N_TIMED} requests; its decode ({decoder}) p50 {dec_ms:.3f} ms; the "
                  f"engine's process_single_image on the same image p50 {eng_ms:.3f} ms, phase "
                  f"8's for {shape} "
                  f"{engine_p50[f'process_single_image {shape}']:.3f} ms; the clean PNG "
                  f"{png_ms:.3f} ms, the two .npy writes {npy_ms:.3f} ms, the 64 mask PNGs "
                  f"(the save_masks job, which the next upload waits on) {masks_ms:.3f} ms, "
                  f"each alone; on {card}", flush=True)
        ws.wait("save_masks")
        for route, direct in (("/view_segmentation", srv.app.view_segmentation),
                              ("/classify?pipeline=basic", lambda: srv.app.classify("basic")),
                              ("/classify?pipeline=advanced",
                               lambda: srv.app.classify("advanced")),
                              ("/roi?pipeline=basic", lambda: srv.app.roi("basic")),
                              ("/roi?pipeline=advanced", lambda: srv.app.roi("advanced"))):
            ms = route_p50(lambda: client.get(route))
            app_ms = route_p50(direct)
            pipeline = route.rsplit("=", 1)[-1]
            beside = (f"; phase 8's engine classify_and_roi {pipeline} p50 "
                      f"{engine_p50[f'classify_and_roi {pipeline}']:.3f} ms"
                      if "pipeline" in route else "")
            print(f"time front GET {route} (3328x2560 RLE upload's features): p50 {ms:.3f} ms "
                  f"over {N_TIMED} requests; the route's method called without HTTP "
                  f"{app_ms:.3f} ms{beside}; on {card}", flush=True)
        ws.wait("gradcam")
        ms = route_p50(lambda: client.post("/upload-bulk", {}, {
            "bulk_images_zip": ("bulk.zip", zip_bytes)}, "/bulk-select-parameters"))
        print(f"time front POST /upload-bulk ({N_FRONT_BULK} PNGs, {len(zip_bytes)} bytes): p50 "
              f"{ms:.3f} ms over {N_TIMED} requests on {card}", flush=True)
        for pipeline in ("basic", "advanced"):
            ms = route_p50(lambda: client.get(f"/bulk-classify?pipeline={pipeline}"))
            direct_ms = p50_ms(lambda: eng.classify_batch(stack, pipeline), N_TIMED)
            print(f"time front GET /bulk-classify?pipeline={pipeline} (B={N_FRONT_BULK} "
                  f"{FRONT_BULK_HW[0]}x{FRONT_BULK_HW[1]} PNGs, read and resized on each "
                  f"request): p50 {ms:.3f} ms over {N_TIMED} requests; the engine's "
                  f"classify_batch on the resized stack p50 {direct_ms:.3f} ms; on {card}",
                  flush=True)
        for key in ("save_masks", "gradcam"):
            ws.wait(key)
        failed = [(key, fut.exception()) for key, fut in jobs if fut.exception() is not None]
        check("artifact jobs", not failed, failed)
        print(f"front: {len(jobs)} artifact jobs, none raised", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
        ws.close()
        for b in eng._batchers.values():
            b.close()
        ws_root.cleanup()
    return front


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.nn.functional as F

    from cadx_tpu_torch import checkpoint
    from cadx_tpu_torch.compat import adcnnm
    from cadx_tpu_torch.data import dicom as TDicom
    from cadx_tpu_torch.data import imageio, native_loader
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import batchnorm as KBN
    from cadx_tpu_torch.kernels import ccl as KC
    from cadx_tpu_torch.kernels import cleaner_front as KF
    from cadx_tpu_torch.kernels import conv_leaky as KCL
    from cadx_tpu_torch.kernels import equalize as KE
    from cadx_tpu_torch.kernels import flood as KFl
    from cadx_tpu_torch.kernels import gradcam_tail as KGT
    from cadx_tpu_torch.kernels import largest_obj as KL
    from cadx_tpu_torch.kernels import mode as KM
    from cadx_tpu_torch.kernels import overlay as KOv
    from cadx_tpu_torch.kernels import pectoral as KP
    from cadx_tpu_torch.kernels import pool as KPool
    from cadx_tpu_torch.kernels import upsample as KUp
    from cadx_tpu_torch.kernels import watershed as KW
    from cadx_tpu_torch.models import cnn, unet
    from cadx_tpu_torch.models import resnet as TR
    from cadx_tpu_torch.ops import components as TC
    from cadx_tpu_torch.ops import geodesic_scan as TGS
    from cadx_tpu_torch.ops import pool as TPool
    from cadx_tpu_torch.ops.colormap import apply_jet
    from cadx_tpu_torch.ops.resize import resize_area
    from cadx_tpu_torch.ops.threshold import to_uint8
    from cadx_tpu_torch.pipeline import fused
    from cadx_tpu_torch.precision import full_fp32
    from cadx_tpu_torch.preprocess import cleaner
    from cadx_tpu_torch.serve import app as A
    from cadx_tpu_torch.serve import engine as E
    from cadx_tpu_torch.synthetic import (equalize_edge_cases, pectoral_tile_edge_inputs,
                                          synthetic_mammograms, synthetic_native_mammogram,
                                          tile_edge_cases)
    from cadx_tpu_torch.tools import bench_train as BT
    from cadx_tpu_torch.tools import train as TT
    from cadx_tpu_torch.train import optim, segmentation, step
    from cadx_tpu_torch.xai import gradcam as TG
    from cadx_tpu_torch.xai import saliency as TS

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    modules = {"largest_obj": KL, "equalize": KE, "pectoral_tail": KP,
               "ccl": KC, "mode": KM, "watershed": KW, "conv_leaky": KCL,
               "pool": KPool, "upsample": KUp, "batchnorm": KBN, "jet_blend": KOv,
               "gradcam_tail": KGT, "cleaner_front": KF, "flood": KFl}
    # kernel -> (source, the TPU kernel it replaces)
    sources = {name: (mod.SOURCE, mod.REPLACES) for name, mod in modules.items()}
    sources["largest_component_seeded"] = (KL.SEEDED_SOURCE, KL.SEEDED_REPLACES)
    sources["watershed_packed"] = (KW.SOURCE, KW.REPLACES)
    sources["conv_leaky_bf16"] = (KCL.BF16_SOURCE, KCL.REPLACES)
    wrappers = {"largest_obj": KL.largest_obj, "equalize": KE.equalize,
                "pectoral_tail": KP.pectoral_tail, "ccl": KC.label_components,
                "mode": KM.largest_component_mask, "watershed": KW.marker_watershed,
                "conv_leaky": KCL.conv_leaky, "pool": KPool.pool,
                "upsample": KUp.upsample_nearest, "batchnorm": KBN.batchnorm,
                "jet_blend": KOv.jet_blend, "gradcam_tail": KGT.gradcam_tail,
                "cleaner_front": KF.cleaner_front,
                "largest_component_seeded": KL.largest_component_seeded,
                "flood": KFl.flood_from, "watershed_packed": KW.packed_form,
                "conv_leaky_bf16": KCL.conv_leaky_bf16}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in wrappers.items()}

    t_start = time.perf_counter()

    def phase_done(label):
        print(f"phase {label} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    n_sources = len(list(_build.CSRC.glob("*.cu")))
    print(f"build: {n_sources} sources in {time.perf_counter() - t0:.2f} s -> {lib_path.name}",
          flush=True)
    if n_sources != len({src for src, _ in sources.values()}):
        raise AssertionError(f"{n_sources} kernel sources for the kernels' "
                             f"{len({src for src, _ in sources.values()})}")

    phase_done("1")

    # ---- 2. each kernel against its plain version, on the card --------------
    errs = {name: 0.0 for name in wrappers}

    def agree(name, kernel_out, plain_out, what):
        torch.cuda.synchronize()
        err = max_abs_err(kernel_out, plain_out)
        errs[name] = max(errs[name], err)
        print(f"check {name} [{what}]: max_abs_err {err} (tolerance 0, bit-exact)",
              flush=True)
        if err != 0.0:
            raise AssertionError(f"{name} [{what}] disagrees with its plain version")

    def agree_twice(name, kernel_fn, plain_out, what, parts=("",)):
        """The kernel's outputs (named by parts) against its plain version's,
        and a second run of the kernel giving the same bytes."""
        first, second = kernel_fn(), kernel_fn()
        if len(parts) == 1:
            first, second, plain_out = (first,), (second,), (plain_out,)
        for part, a, b, c in zip(parts, first, plain_out, second):
            label = f"{part}, {what}" if part else what
            agree(name, a, b, label)
            if not torch.equal(a, c):
                raise AssertionError(f"{name} [{label}]: two runs differ")
        print(f"check {name} [{what}]: two runs gave identical bytes", flush=True)

    rng = np.random.default_rng(0)
    small = torch.from_numpy(synthetic_mammograms(16, HW, seed=1)).to(dev)
    rand_masks = torch.from_numpy(rng.random((16, HW, HW)) > 0.55).to(dev)
    rand_u8 = torch.from_numpy(rng.integers(0, 256, (16, HW, HW)).astype(np.uint8)).to(dev)
    s_bin, g_bin, seg, equ, high, breast = clean_stage_inputs(small)

    for x, what in ((seg, "segmented synthetic B=16"), (rand_u8, "random u8 B=16")):
        agree_twice("equalize", lambda x=x: KE.equalize(x), KE.equalize_reference(x), what)
    # The kernel runs to the true fixpoint. The plain version mirrors the
    # JAX sweep cap of 128, which the random masks exceed (a spanning
    # 8-connected component needs ~180 sweeps at 256²), so there it runs
    # uncapped: H*W sweeps bound any labelling.
    uncapped = HW * HW
    for m, what, cap in ((s_bin, "suppress-site synthetic", 128),
                         (rand_masks, "random masks, plain uncapped", uncapped)):
        agree_twice("largest_obj", lambda m=m: KL.largest_obj(m, 8, fill=True, smooth_k=15),
                    KL.largest_obj_reference(m, 8, fill=True, smooth_k=15, max_iters=cap),
                    f"fill + opening(15), {what}")
    for m, what, cap in ((g_bin, "segment-site synthetic", 128),
                         (rand_masks, "random masks, plain uncapped", uncapped)):
        agree_twice("largest_obj", lambda m=m: KL.largest_obj(m, 8, fill_first=True),
                    KL.largest_obj_reference(m, 8, fill_first=True, max_iters=cap),
                    f"fill_first, {what}")
    pect_parts = ("labels", "boundary", "mask")
    agree_twice("pectoral_tail", lambda: KP.pectoral_tail(equ, high, breast),
                KP.pectoral_tail_reference(equ, high, breast), "cleaner inputs B=16", pect_parts)

    def agree_front(raw8, what, smooth_k=15):
        """cleaner_front on the uint8 batch clean_boundary_gray hands it,
        against its plain version uncapped, twice."""
        h, w = raw8.shape[1:]
        agree_twice("cleaner_front", lambda: KF.cleaner_front(raw8, smooth_k),
                    KF.cleaner_front_reference(raw8, smooth_k, max_iters=h * w),
                    f"{what}, smooth_k {smooth_k}, plain uncapped",
                    ("breast_only", "breast_mask", "contour_fill"))

    agree_front(to_uint8(torch.cat([small[:12], rand_u8[:2], torch.zeros_like(small[:2])])),
                f"12 synthetic mammograms, 2 noise, 2 dark, B=16 {HW}x{HW}")
    # the inputs that break a tiled CCL: shapes on tile edges and corners,
    # ties across tiles, border gaps, sides that are multiples of no tile
    # largest_obj in each ordering and connectivity, and the pair-form
    # watershed on the same images (markers at their corners and centre)
    # capped at 1, 2, 17 and 256 sweeps with the halo tile (max_scan 8) and
    # a launch a pass (256), at the same shapes
    orderings = (dict(), dict(fill=True), dict(fill=True, smooth_k=15),
                 dict(fill_first=True), dict(fill_first=True, smooth_k=4))
    for h, w in ((64, 64), (HW, HW), (45, 70), (1, 70), (70, 1), (333, 257)):
        edge_cases = torch.from_numpy(tile_edge_cases(h, w)).to(dev)
        what = f"tile_edge_cases B={edge_cases.shape[0]} {h}x{w}"
        for k in (0, 3, 15):
            agree_front(edge_cases, what, k)
        m = edge_cases > 0
        for conn in (4, 8):
            agree_twice("ccl", lambda c=conn: KC.label_components(m, c),
                        KC.label_components_reference(m, conn, max_iters=h * w),
                        f"{what}, {conn}-conn, {KC.form_for(h, w)} form, plain uncapped")
            for opts in orderings:
                agree_twice("largest_obj", lambda o=opts, c=conn: KL.largest_obj(m, c, **o),
                            KL.largest_obj_reference(m, conn, **opts, max_iters=h * w),
                            f"{what}, {conn}-conn, {opts or 'default'}, plain uncapped")
        # the pectoral tail on the same objects as its high-threshold mask,
        # noise costs and a corner of background (the third marker)
        p_in = tuple(torch.from_numpy(a).to(dev) for a in pectoral_tile_edge_inputs(h, w))
        agree_twice("pectoral_tail", lambda: KP.pectoral_tail(*p_in),
                    KP.pectoral_tail_reference(*p_in, max_iters=h * w),
                    f"pectoral_tile_edge_inputs B=12 {h}x{w}, plain uncapped, its watershed "
                    f"at the 256-sweep cap", pect_parts)
        ws_marks = torch.zeros(edge_cases.shape, dtype=torch.int32, device=dev)
        ws_marks[:, :max(h // 5, 1), :max(w // 5, 1)] = 255
        ws_marks[:, -max(h // 5, 1):, -max(w // 5, 1):] = 128
        ws_marks[:, h // 2, w // 2] = 64
        for max_scan in (8, 256):
            for cap in (1, 2, 17, 256):
                agree_twice("watershed", lambda s=max_scan, c=cap: KW.marker_watershed(
                                edge_cases, ws_marks, max_iters=c, max_scan=s),
                            KW.marker_watershed_reference(edge_cases, ws_marks, max_iters=cap,
                                                          max_scan=max_scan),
                            f"pair form, {what}, max_scan {max_scan}, max_iters {cap} each",
                            ("labels", "boundary"))

    # the serving shapes: the cleaner's inputs of the serving phase's own
    # uploads (as process_single_image hands them over) and of its
    # classify_batch batch; every plain version runs uncapped except the
    # pair-form watershed
    uploads = {name: synthetic_native_mammogram(h, w, seed=7, dtype=dt,
                                                top=60000 if dt == np.uint16 else 250)
               for name, (h, w, dt) in UPLOADS.items()}
    seg_h, seg_w = E.EngineConfig().segment_hw
    clean_cap = E.EngineConfig().native_clean_max_side
    bulk = np.stack([synthetic_mammograms(1, seg_h, seed=30 + i)[0] for i in range(N_BATCHED)])

    def upload_cleaner_input(img):
        x = torch.as_tensor(E._host_image(img), device=dev)
        if max(x.shape) > clean_cap:
            x = resize_area(x[None].to(torch.float32),
                            E.bucket_clean_hw(*x.shape, clean_cap))[0]
        return x[None]

    pect_masks = {}   # (h, w) -> the B=1 pectoral select's mask, for phase 8

    def agree_pectoral_select(high_, what):
        """largest_obj at the composed pectoral branch's select (sides > 512),
        plain uncapped, twice."""
        cap = high_.shape[1] * high_.shape[2]
        m = high_ > 0
        if m.shape[0] == 1:
            pect_masks[tuple(m.shape[1:])] = m
        agree_twice("largest_obj", lambda: KL.largest_obj(m, 8, fill=True),
                    KL.largest_obj_reference(m, 8, fill=True, max_iters=cap),
                    f"pectoral site, {what}, plain uncapped")

    def agree_pair_watershed(equ_, markers, what):
        # The pair form has no float32 fixpoint at these sizes (rounding of
        # d - s + s drifts distances down every sweep), so kernel and plain
        # version run the same max_iters sweeps, as the cleaner calls them.
        agree_twice("watershed", lambda: KW.marker_watershed(
                        equ_, markers, max_scan=8, marker_label_values=(255, 128, 64)),
                    KW.marker_watershed_reference(equ_, markers, max_scan=8,
                                                  marker_label_values=(255, 128, 64)),
                    f"pair form, {what}, 256 sweeps each", ("labels", "boundary"))

    serving_inputs = {name: upload_cleaner_input(img) for name, img in uploads.items()}
    border_masks = {}   # (h, w) -> a B=1 suppress-site mask, for the flood
    serving_inputs[f"classify_batch B={N_BATCHED}"] = torch.from_numpy(bulk).to(dev)
    composed = {}   # upload -> (equalized image, watershed markers, label)
    for name, x in serving_inputs.items():
        b, h, w = x.shape
        s_bin_, g_bin_, seg_, equ_, high_, breast_ = clean_stage_inputs(x)
        if b == 1:
            border_masks[(h, w)] = s_bin_
        cap = h * w
        what = f"cleaner inputs of {name}, {h}x{w} B={b}"
        agree_front(to_uint8(x), what)
        agree_twice("equalize", lambda x=seg_: KE.equalize(x), KE.equalize_reference(seg_), what)
        agree_twice("largest_obj",
                    lambda m=s_bin_: KL.largest_obj(m, 8, fill=True, smooth_k=15),
                    KL.largest_obj_reference(s_bin_, 8, fill=True, smooth_k=15, max_iters=cap),
                    f"suppress site, {what}, plain uncapped")
        agree_twice("largest_obj", lambda m=g_bin_: KL.largest_obj(m, 8, fill_first=True),
                    KL.largest_obj_reference(g_bin_, 8, fill_first=True, max_iters=cap),
                    f"segment site, {what}, plain uncapped")
        if cleaner.use_packed((h, w), 3):
            p_in = (equ_, high_, breast_)
            agree_twice("pectoral_tail", lambda p_in=p_in: KP.pectoral_tail(*p_in),
                        KP.pectoral_tail_reference(*p_in, max_iters=cap),
                        f"{what}, plain uncapped, its watershed at the 256-sweep cap",
                        pect_parts)
            if b == 1:
                pect_b1 = p_in
            continue
        agree_pectoral_select(high_, what)
        for m, site in ((s_bin_, "suppress mask"), (high_ > 0, "pectoral mask")):
            labels = KC.label_components(m, 8)
            agree("ccl", labels, KC.label_components_reference(m, 8, max_iters=cap),
                  f"{site}, {what}")
            agree("mode", KM.largest_component_mask(labels, m),
                  KM.largest_component_mask_reference(labels, m), f"{site}, {what}")
        markers = pectoral_markers(equ_, high_, breast_)
        composed[name] = (equ_, markers, what)
        agree_pair_watershed(equ_, markers, what)

    # the training CLI's native shapes, cleaned at full size: each kernel
    # its path launches there (the front, equalize, the composed pectoral
    # branch's select and pair-form watershed)
    cli_front = {}   # native shape -> the uint8 image cleaner_front is handed
    cli_pectoral = {}   # native shape -> the pair-form watershed's inputs
    for h, w in CLI_SHAPES:
        x = torch.from_numpy(synthetic_native_mammogram(h, w, seed=21).astype(np.float32))
        x = x.to(dev)[None]
        what = f"training CLI upload {h}x{w} u16"
        cli_front[(h, w)] = to_uint8(x)
        agree_front(cli_front[(h, w)], what)
        border_masks[(h, w)], _, seg_, equ_, high_, breast_ = clean_stage_inputs(x)
        agree_twice("equalize", lambda x=seg_: KE.equalize(x), KE.equalize_reference(seg_), what)
        agree_pectoral_select(high_, what)
        markers = pectoral_markers(equ_, high_, breast_)
        agree_pair_watershed(equ_, markers, what)
        cli_pectoral[(h, w)] = (equ_, markers)   # phase 8 times the watershed here
        del x, seg_, equ_, high_, breast_, markers

    # equalize at run_pipeline's B=64 batch, on the inputs that break an
    # equalize kernel and on a view that starts 1 byte past a 16-byte
    # boundary (the output is placed at the same offset), twice each
    seg64 = clean_stage_inputs(
        torch.from_numpy(synthetic_mammograms(BATCH, HW, seed=10)).to(dev))[2]
    eq_cases = {f"run_pipeline's batch B={BATCH} {HW}x{HW}": seg64}
    eq_cases.update({name: torch.from_numpy(a).to(dev)
                     for name, a in equalize_edge_cases().items()})
    eq_rng = np.random.default_rng(8)
    odd = torch.from_numpy(eq_rng.integers(0, 256, (4, 37, 53)).astype(np.uint8)).to(dev)
    eq_cases["a (3, 37, 53) view 1 byte past a 16-byte boundary"] = \
        odd.view(-1)[1:1 + 3 * 37 * 53].view(3, 37, 53)
    for name, x in eq_cases.items():
        agree_twice("equalize", lambda x=x: KE.equalize(x), KE.equalize_reference(x), name)
    del seg64

    # at B=1 the front spreads one image over many blocks: the grid of its
    # CCL launches, from a profiler trace of one call at the serving bucket
    bucket = to_uint8(serving_inputs["3328x2560 u16"])
    tiles = KF.tiles_per_image(*bucket.shape[1:])
    grids = kernel_grids(lambda: KF.cleaner_front(bucket), "ccl_local")
    print(f"cleaner_front at B=1 {tuple(bucket.shape[1:])}: {tiles} tiles of "
          f"{KF.TILE}x{KF.TILE}; ccl_local grids in the profiler trace "
          f"{grids if grids else 'not captured'}", flush=True)
    if grids and any(g[0] != tiles for g in grids):
        raise AssertionError(f"cleaner_front's CCL ran grids {grids}, not {tiles} blocks")
    # largest_obj at the CLI's B=1 3328x2560 pectoral select: every launch
    # of the call covers the image's tiles
    pect_big = pect_masks[CLI_SHAPES[0]]
    tiles = KF.tiles_per_image(*pect_big.shape[1:])
    events = trace_events(lambda: KL.largest_obj(pect_big, 8, fill=True))
    lo_grids = [e["args"]["grid"] for e in events
                if e.get("cat") == "kernel" and "grid" in e.get("args", {})]
    print(f"largest_obj at B=1 {tuple(pect_big.shape[1:])}: {tiles} tiles of {KF.TILE}x{KF.TILE}; "
          f"{len(lo_grids)} kernel launches in the profiler trace, grids "
          f"{sorted(set(str(g) for g in lo_grids)) if lo_grids else 'not captured'}",
          flush=True)
    if lo_grids and any(g[0] * g[1] * g[2] != tiles for g in lo_grids):
        raise AssertionError(f"largest_obj launched grids {lo_grids}, not {tiles} blocks each")
    # pectoral_tail at the 512² upload (B=1): the trace holds every launch
    # of its plan, each covers at least 132 blocks or the image's tile
    # count, and the call never waits on the host (its watershed loops on
    # the card)
    tiles = KF.tiles_per_image(*pect_b1[0].shape[1:])
    ws_sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
    events = trace_events(lambda: KP.run_plan(*pect_b1, sweeps=ws_sweeps))
    p_grids = [e["args"]["grid"] for e in events
               if e.get("cat") == "kernel" and "grid" in e.get("args", {})]
    p_blocks = [g[0] * g[1] * g[2] for g in p_grids]
    waits = runtime_calls(events, ("cudaEventSynchronize", "cudaStreamSynchronize", "cudaMemcpy"))
    print(f"pectoral_tail at B=1 {tuple(pect_b1[0].shape[1:])}: {tiles} tiles of "
          f"{KF.TILE}x{KF.TILE}; {len(p_blocks)} kernel launches in the profiler trace of the "
          f"plan's {KP.PLAN_LAUNCHES}, blocks {sorted(set(p_blocks))}; the watershed took "
          f"{int(ws_sweeps.item())} sweeps in one launch; {waits} synchronising runtime calls "
          f"in the trace", flush=True)
    if len(p_blocks) != KP.PLAN_LAUNCHES:
        raise AssertionError(f"pectoral_tail's trace holds {len(p_blocks)} kernel launches, "
                             f"its plan {KP.PLAN_LAUNCHES}")
    if any(n < min(132, tiles) for n in p_blocks):
        raise AssertionError(f"pectoral_tail launched grids {p_grids}, some under "
                             f"{min(132, tiles)} blocks")
    if waits or int(ws_sweeps.item()) < 1:
        raise AssertionError(f"pectoral_tail synchronised the host {waits} times, its watershed "
                             f"ran {int(ws_sweeps.item())} sweeps")
    # a 256-sweep pair-form watershed call at the same shape waits on the
    # host once every CHECK_EVERY sweeps, not once a sweep
    ws_equ, ws_markers = cli_pectoral[CLI_SHAPES[0]]
    events = trace_events(lambda: KW.marker_watershed(ws_equ, ws_markers, max_scan=8,
                                                      marker_label_values=(255, 128, 64)))
    most = -(-256 // KW.CHECK_EVERY) + 1
    launched = runtime_calls(events, ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    waits = runtime_calls(events, ("cudaEventSynchronize", "cudaStreamSynchronize", "cudaMemcpy"))
    print(f"watershed pair form, B=1 {tuple(ws_equ.shape[1:])}, 256 sweeps: "
          f"{KW.marker_watershed.host_syncs} host synchronisations by the kernel's own count; "
          f"the profiler trace holds {launched} kernel launches and {waits} synchronising "
          f"runtime calls{'' if launched >= 256 else ' (runtime calls not captured)'}; at most "
          f"{most} allowed", flush=True)
    if KW.marker_watershed.host_syncs > most or (launched >= 256 and waits > most):
        raise AssertionError("the pair-form watershed synchronised the host too often")

    # the density-seeded largest component, off every path: against its
    # plain version and the plain CCL + largest label, both uncapped, and
    # largest_obj with neither fill nor opening (the same launches), twice
    def seeded_paths(m):
        """(flood, fallback) image counts of the plain algorithm (JAX's),
        8-connected, by its seed: the densest mask pixel, the smallest
        raster index on ties (a 64-bit key; the plain version's 20-bit
        packing is exact only up to 2**20 pixels). The kernel takes neither
        path: it runs the tiled CCL."""
        b, h, w = m.shape
        k = KL._DENSITY_K
        dens = KL._axis_window_sum(KL._axis_window_sum(m.to(torch.int32), k, -2), k, -1)
        idx = torch.arange(h * w, dtype=torch.int64, device=m.device).view(h, w)
        key = torch.where(m, (dens.to(torch.int64) << 32) | (0xFFFFFFFF - idx), -1)
        seed = (key == key.amax(dim=(1, 2), keepdim=True)) & m
        comp = TC.flood_from_plain(m, seed, h * w, 8)
        flood = comp.sum(dim=(1, 2)) * 2 > m.sum(dim=(1, 2))
        return int(flood.sum()), int((~flood).sum())

    seeded_in = torch.from_numpy(np.concatenate([
        seeded_masks(rng, HW, HW), s_bin[:8].cpu().numpy()])).to(dev)
    seeded_big = torch.from_numpy(seeded_masks(rng, 1536, 1280)).to(dev)
    for m, conns, what in ((seeded_in, (8, 4), f"8 generated + 8 suppress-site masks, B=16 "
                                               f"{HW}x{HW}"),
                           (seeded_big, (8,), f"generated masks, B={seeded_big.shape[0]} "
                                              f"1536x1280")):
        cap = m.shape[1] * m.shape[2]
        for conn in conns:
            agree_twice("largest_component_seeded",
                        lambda m=m, c=conn: KL.largest_component_seeded(m, c),
                        KL.largest_component_seeded_reference(m, conn, cap),
                        f"{what}, {conn}-conn, plain uncapped")
            got = KL.largest_component_seeded(m, conn)
            agree("largest_component_seeded", got, TC.largest_component_plain(m, conn, cap),
                  f"{what}, {conn}-conn, against largest_component_plain uncapped")
            agree("largest_component_seeded", got, KL.largest_obj(m, conn),
                  f"{what}, {conn}-conn, against largest_obj without fill or opening")
        flood, fallback = seeded_paths(m)
        print(f"seeded component [{what}, 8-conn, JAX's algorithm by its seed]: {flood} take "
              f"the flood, {fallback} the CCL + largest label", flush=True)

    # the flood: the border flood of fill_holes (the background of a
    # suppress-site mask, seeded on the image border), serpentines (a
    # corridor that doubles back every `step` rows, one sweep a turn) and
    # runs across the packed words' borders at W = 31, 32, 33, 4- and
    # 8-connected, uncapped (H*W sweeps bound any flood) and capped short of
    # the serpentines' fixpoints (2, 40 and the default 128); bit-exact, the
    # state after a capped run too, twice to the same bytes
    serp = torch.from_numpy(np.stack([serpentine(HW, HW, st) for st in (2, 3, 4, 8)])).to(dev)
    serp_seed = torch.zeros_like(serp)
    serp_seed[:, 0, 0] = True
    inv12, seed12 = border_flood(s_bin[:12])
    flood_cases = [(torch.cat([inv12, serp]), torch.cat([seed12, serp_seed]),
                    f"12 suppress-site backgrounds + 4 serpentines, B=16 {HW}x{HW}", (2, 40, 128))]
    for w in (31, 32, 33):
        m = torch.from_numpy(rng.random((3, 37, w)) < 0.7).to(dev)
        m[0, 5] = True
        seed = torch.zeros_like(m)
        seed[:, :, 0] = True
        flood_cases.append((m, seed, f"random masks, B=3 37x{w}", (2,)))
    for (h, w) in ((1536, 1280), CLI_SHAPES[0]):
        flood_cases.append(border_flood(border_masks[(h, w)])
                           + (f"suppress-site background, B=1 {h}x{w}", (2,)))
    for m, seed, what, caps in flood_cases:
        for conn in (4, 8):
            for cap in (m.shape[1] * m.shape[2],) + caps:
                agree_twice("flood", lambda m=m, seed=seed, cap=cap, conn=conn: KFl.flood_from(
                                m, seed, cap, conn),
                            KFl.flood_from_reference(m, seed, cap, conn),
                            f"{what}, {conn}-conn, max_iters {cap}")
    # the dispatching ops launch the flood kernel on the card
    before = KFl.flood_from.launches
    agree("flood", TC.fill_holes(rand_masks), TC.fill_holes_plain(rand_masks, uncapped),
          f"ops.components.fill_holes, random masks B=16 {HW}x{HW}, plain uncapped")
    agree("flood", TC.flood_from(serp, serp_seed, uncapped),
          TC.flood_from_plain(serp, serp_seed, uncapped),
          f"ops.components.flood_from, serpentines B=4 {HW}x{HW}, uncapped")
    dispatched = KFl.flood_from.launches - before
    print(f"flood: ops.components.fill_holes and flood_from on the card launched the kernel "
          f"{dispatched} times (expected 2)", flush=True)
    if dispatched != 2:
        raise AssertionError("the dispatching flood ops did not launch the flood kernel")
    # the plain versions launch nothing on the card
    zero_counts()
    KL.largest_obj_reference(s_bin, 8, fill=True, smooth_k=15)
    KL.largest_obj_reference(g_bin, 8, fill_first=True)
    KL.largest_component_seeded_reference(s_bin, 8)
    KF.cleaner_front_reference(to_uint8(small))
    KP.pectoral_tail_reference(equ, high, breast)
    plain_launches = read_counts()
    print(f"plain versions on the card (largest_obj, largest_component_seeded, cleaner_front, "
          f"pectoral_tail): launches {plain_launches}", flush=True)
    if any(plain_launches.values()):
        raise AssertionError(f"a plain version launched a kernel: {plain_launches}")

    # random masks and markers at 256², B=16, and the CAM shapes (ccl in
    # both its forms: the cluster form the wrapper picks there and the
    # tiled form)
    for conn in (4, 8):
        labels = KC.label_components(rand_masks, conn)
        agree("ccl", labels, KC.label_components_reference(rand_masks, conn, uncapped),
              f"random masks {conn}-conn B=16, plain uncapped")
        agree("mode", KM.largest_component_mask(labels, rand_masks),
              KM.largest_component_mask_reference(labels, rand_masks),
              f"random masks {conn}-conn B=16")
    for b, h in ((3, 6), (N_BATCHED, 6), (3, 62)):
        cams = torch.from_numpy(rng.random((b, h, h)).astype(np.float32)).to(dev)
        hot = cams >= 0.6 * cams.amax(dim=(1, 2), keepdim=True)
        for form in ("cluster", "tiled"):
            agree_twice("ccl", lambda f=form: in_form(KC, f, lambda: KC.label_components(hot, 8)),
                        KC.label_components_reference(hot, 8, h * h),
                        f"CAM masks B={b} {h}x{h}, {form} form, plain uncapped")
        labels = KC.label_components(hot, 8)
        for form in ("block", "cluster", "wide"):
            agree_twice("mode", lambda f=form: in_form(
                KM, f, lambda: KM.largest_component_mask(labels, hot)),
                KM.largest_component_mask_reference(labels, hot),
                f"CAM masks B={b} {h}x{h}, {form} form")
    # mode's edge inputs in each form: labels out of range (negative, H*W,
    # beyond), an exact tie, an empty mask
    edge = torch.zeros((4, 12, 12), dtype=torch.bool, device=dev)
    edge[0, 1:3, 1:3] = edge[0, 8:10, 8:10] = edge[2, :, :6] = edge[3, 5, 5] = True
    edge_labels = KC.label_components(edge, 8)
    edge_labels[2, :, :3], edge_labels[2, :2, 3:6], edge_labels[3, 5, 5] = -5, 144, 1000
    for form in ("block", "cluster", "wide"):
        agree_twice("mode", lambda f=form: in_form(
            KM, f, lambda: KM.largest_component_mask(edge_labels, edge)),
            KM.largest_component_mask_reference(edge_labels, edge),
            f"labels out of range, a tie, an empty mask, {form} form")
    ws_img = torch.from_numpy(rng.integers(0, 256, (16, HW, HW)).astype(np.float32)).to(dev)
    ws_mk = torch.zeros((16, HW, HW), dtype=torch.int32, device=dev)
    ws_mk[:, :50, :50], ws_mk[:, -50:, -50:], ws_mk[:, :4, -4:] = 255, 128, 64
    ws_mk[:, 120:124, 7:11] = 7
    # the packed form's plain version runs uncapped; the pair form's runs
    # the kernel's 256 sweeps (see above)
    markers16 = pectoral_markers(equ, high, breast)
    for img_, mk_, values, max_scan, what in (
            (ws_img, ws_mk, (255, 128, 64), 8, "packed form, random B=16"),
            (ws_img, ws_mk, (), 8, "pair form, random B=16"),
            (ws_img, ws_mk, (), 256, "pair form, random B=16"),
            (equ, markers16, (255, 128, 64), 8, f"packed form, cleaner markers B=16 {HW}x{HW}"),
            (equ, markers16, (), 8, f"pair form, cleaner markers B=16 {HW}x{HW}")):
        cap = 256
        agree_twice("watershed_packed" if values else "watershed",
                    lambda i=img_, k=mk_, s_=max_scan, v=values: KW.marker_watershed(
                        i, k, max_scan=s_, marker_label_values=v),
                    KW.marker_watershed_reference(img_, mk_, max_iters=cap, max_scan=max_scan,
                                                  marker_label_values=values),
                    f"{what}, max_scan {max_scan}, plain cap {cap}", ("labels", "boundary"))
    # the packed form over tiles x images at B = 1, 8, 16 on both sides of
    # its 32 x 32 and 64 x 64 tiles up to 512 x 512, with one, two and three
    # marker values, and markers that leave nothing unreached or that are
    # absent, at max_scan 8 (tiled sweeps) and 256 (the line form) and the
    # default 256-sweep cap, the plain version at the same cap; caps of 1,
    # 2 and 17 sweeps at B=1 and B=8
    packed_cases = [(b, hw, n, "some") for b in (1, 8, 16) for hw in PACKED_SIDES
                    for n in (1, 2, 3)]
    packed_cases += [(b, hw, 3, case) for b in (1, 8, 16) for hw in PACKED_SIDES
                     for case in ("all", "none")]
    for b, (h, w), n_values, case in packed_cases:
        img_, mk_, values = packed_inputs(rng, b, h, w, n_values, case, dev)
        runs = [(256, 8), (256, 256)]
        if n_values == 3 and case == "some" and b < 16:
            runs += [(1, 8), (2, 8), (17, 8), (2, 256)]
        for cap, scan in runs:
            agree_twice("watershed_packed",
                        lambda i=img_, k=mk_, v=values, c=cap, s_=scan: KW.marker_watershed(
                            i, k, max_iters=c, max_scan=s_, marker_label_values=v),
                        KW.marker_watershed_reference(img_, mk_, max_iters=cap, max_scan=scan,
                                                      marker_label_values=values),
                        f"B={b} {h}x{w}, {n_values} values, markers {case}, max_scan {scan}, "
                        f"plain cap {cap}", ("labels", "boundary"))

    # the training slice's kernels, at the shapes of the conv layers of the
    # basic (B=8 training, B=64 pipeline) and advanced (B=32 training, B=1
    # serving) classifiers, the pools after them and the U-Net's
    tgen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=tgen, device=dev) * scale

    # (x shape, F, pad, k, NHWC view, what): the six path shapes, layer 1
    # also as conv_stack hands it over (the channels-last view of NHWC
    # features, read in place), and ragged shapes (C = 3, F = 5 and 40, k =
    # 1, 5, 7, sides that are multiples of no tile, B = 1)
    conv_cases = [((8, 64, 32, 32), 128, 0, 3, False, "basic layer 1, training B=8"),
                  ((8, 128, 15, 15), 64, 0, 3, False, "basic layer 2, training B=8"),
                  ((64, 64, 32, 32), 128, 0, 3, False, "basic layer 1, pipeline B=64"),
                  ((32, 64, 256, 256), 32, 1, 3, False, "advanced layer 1, training B=32"),
                  ((32, 32, 128, 128), 64, 1, 3, False, "advanced layer 2, training B=32"),
                  ((1, 64, 256, 256), 32, 1, 3, False, "advanced layer 1, serving B=1"),
                  ((8, 64, 32, 32), 128, 0, 3, True, "basic layer 1, training B=8, NHWC view"),
                  ((64, 64, 32, 32), 128, 0, 3, True, "basic layer 1, pipeline B=64, NHWC view"),
                  ((32, 64, 256, 256), 32, 1, 3, True,
                   "advanced layer 1, training B=32, NHWC view"),
                  ((1, 64, 256, 256), 32, 1, 3, True, "advanced layer 1, serving B=1, NHWC view"),
                  ((1, 3, 37, 53), 5, 0, 1, False, "ragged C=3 F=5 k=1, B=1"),
                  ((1, 3, 37, 53), 40, 2, 5, True, "ragged C=3 F=40 k=5, B=1, NHWC view"),
                  ((2, 3, 45, 29), 40, 3, 7, False, "ragged C=3 F=40 k=7"),
                  ((1, 5, 19, 70), 5, 0, 5, True, "ragged C=5 F=5 k=5, B=1, NHWC view"),
                  ((3, 3, 33, 35), 40, 1, 3, False, "ragged C=3 F=40 k=3"),
                  ((2, 7, 30, 33), 5, 3, 7, True, "ragged C=7 F=5 k=7, NHWC view")]
    for (b, c, h, w), f, pad, k, nhwc, what in conv_cases:
        x = randn(b, h, w, c).permute(0, 3, 1, 2) if nhwc else randn(b, c, h, w)
        x[:, :, : h // 4] = 0.0                       # z == 0 rows
        wt, bias = randn(f, c, k, k, scale=(2.0 / (k * k * c)) ** 0.5), randn(f, scale=0.1)
        bias[0] = 0.0
        kern = KCL.conv_leaky(x, wt, bias, 0.01, pad)
        plain = KCL.conv_leaky_reference(x, wt, bias, 0.01, pad)
        torch.cuda.synchronize()
        err = max_abs_err(kern, plain)
        tol = 1e-5 * float(plain.abs().max()) + 1e-6
        errs["conv_leaky"] = max(errs["conv_leaky"], err)
        print(f"check conv_leaky [{what}, {tuple(x.shape)} -> F={f}, k={k}, pad {pad}]: "
              f"max_abs_err {err} (tolerance {tol:.3g})", flush=True)
        if err > tol:
            raise AssertionError(f"conv_leaky [{what}] disagrees with its plain version")
        del x, kern, plain
    # no copy of the NHWC view: the call allocates its output and nothing else
    xv = randn(32, HW, HW, 64).permute(0, 3, 1, 2)
    wv, bv = randn(32, 64, 3, 3, scale=(2.0 / 576) ** 0.5), randn(32, scale=0.1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    yv = KCL.conv_leaky(xv, wv, bv, 0.01, 1)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    print(f"conv_leaky on the NHWC view {tuple(xv.shape)} (advanced layer 1, B=32): peak "
          f"device memory rose by {rise} bytes, the output holds {nbytes(yv)}", flush=True)
    if rise > nbytes(yv):
        raise AssertionError("conv_leaky copied its NHWC input")
    del xv, yv
    for shape, dtype, size in (((32, 32, 256, 256), torch.float32, 2),
                               ((8, 16, 256, 256), torch.float32, 2),
                               ((8, 64, 30, 30), torch.float32, 2),
                               ((3, 5, 37, 53), torch.float32, 3),
                               ((3, 5, 37, 53), torch.bfloat16, 2),
                               ((4, 7, 64, 65), torch.bfloat16, 3)):
        x = torch.relu(randn(*shape)).to(dtype)        # ReLU zeros tie
        for mode in ("max", "mean"):
            agree("pool", KPool.pool(x, size, mode), KPool.pool_reference(x, size, mode),
                  f"{mode} size {size}, {tuple(shape)} {dtype}")
    # the U-Net's shapes, then factor 3 and 1- and 8-byte elements (both the
    # 16-byte path and the scalar one: rows of 16, 32 and odd widths)
    for shape, dtype, fac in (((8, 128, 32, 32), torch.float32, 2),
                              ((8, 32, 128, 128), torch.float32, 2),
                              ((3, 5, 37, 53), torch.bfloat16, 2),
                              ((4, 8, 64, 64), torch.float32, 3),
                              ((3, 5, 37, 53), torch.bfloat16, 3),
                              ((2, 3, 16, 32), torch.uint8, 2), ((2, 3, 9, 13), torch.uint8, 2),
                              ((2, 3, 9, 13), torch.uint8, 3), ((2, 3, 16, 8), torch.float64, 2),
                              ((2, 3, 9, 13), torch.float64, 2),
                              ((2, 3, 9, 13), torch.float64, 3)):
        x = (randn(*shape).abs() * 60).to(dtype)
        agree("upsample", KUp.upsample_nearest(x, fac), KUp.upsample_nearest_reference(x, fac),
              f"factor {fac}, {tuple(shape)} {dtype}")
    ties = torch.relu(torch.round(randn(8, 16, 64, 63)))
    g = randn(8, 16, 32, 31)
    for rule, fn in (("tie-broadcast", TPool.max_pool_ties),
                     ("first maximum", TPool.max_pool_first)):
        grads = []
        for d in (dev, "cpu"):
            t = ties.detach().to(d).requires_grad_(True)
            fn(t, 2).backward(g.to(d))
            grads.append(t.grad.cpu())
        err = max_abs_err(*grads)
        print(f"check pool backward [{rule}, (8, 16, 64, 63)], card vs CPU: max_abs_err "
              f"{err} (tolerance 0, bit-exact)", flush=True)
        if err != 0.0:
            raise AssertionError(f"the {rule} pool backward differs between card and CPU")

    # the explainability slice's kernels. batchnorm: the inputs of every
    # distinct shape that phase 6b's ResNet-50 (seeded, batch norms
    # randomised) gives it at a 512² display, recorded on the way through
    # `resnet.bn_apply`
    r50, bn_inputs, _ = resnet50_bn_inputs(dev, seg_h)
    with torch.no_grad():
        for shape, (x, bn) in bn_inputs.items():
            vec = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
            agree("batchnorm", KBN.batchnorm(x, *vec), KBN.batchnorm_reference(x, *vec),
                  f"ResNet-50 input {shape} at a {seg_h}x{seg_w} display")
        # planes of 1, 3, 4, 256 and 65,536 elements, B=2, C up to 2048, on
        # a contiguous tensor and on a view 4 bytes off a 16-byte boundary
        for c in (3, 64, 2048):
            for hh, ww in ((1, 1), (1, 3), (2, 2), (16, 16)) + (((HW, HW),) if c <= 64 else ()):
                shape, n = (2, c, hh, ww), 2 * c * hh * ww
                flat = randn(n + 1)
                vec = (1.0 + randn(c, scale=0.2), randn(c, scale=0.2), randn(c, scale=0.3),
                       0.5 + torch.rand(c, generator=tgen, device=dev))
                for x, how in ((flat[:n].view(shape), "contiguous"),
                               (flat[1:].view(shape), "a view 4 bytes off 16")):
                    agree("batchnorm", KBN.batchnorm(x, *vec), KBN.batchnorm_reference(x, *vec),
                          f"B=2 C={c} {hh}x{ww}, {how}")
    # jet_blend at the paths' shapes (the pipeline's B=64 256², the 512²
    # display), the display cap and images off 16-byte boundaries, in each
    # form that takes the shape (the one-launch form where the images fit
    # one block an SM), on
    # random heat, a dark image and all-255 heat, twice to the same bytes
    for b, h, w in ((BATCH, HW, HW), (1, seg_h, seg_w), (1, 1536, 1280), (3, 37, 53)):
        heat = torch.from_numpy(rng.integers(0, 256, (b, h, w)).astype(np.uint8)).to(dev)
        forms = ("once", "wide") if KOv.form_for(b, h, w) == "once" else ("wide",)
        for shape, kind in (((b, h, w), "gray"), ((b, h, w, 3), "RGB")):
            img01 = torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32)).to(dev) / 255.0
            for heat_, img_, case in ((heat, img01, "random"),
                                      (heat, torch.zeros_like(img01), "dark"),
                                      (torch.full_like(heat, 255), img01, "all-255 heat")):
                for form in forms:
                    agree_twice("jet_blend", lambda f=form, x=heat_, y=img_: in_form(
                        KOv, f, lambda: KOv.jet_blend(x, y)), KOv.jet_blend_reference(heat_, img_),
                        f"B={b} {h}x{w} {kind}, {case}, {form} form")
    # gradcam_tail at the pipeline's shapes: channel-last views of
    # channel-first activations, as conv_stack returns them
    jet_levels = apply_jet(torch.arange(256, dtype=torch.uint8)).int()
    jet_slope = int((jet_levels[1:] - jet_levels[:-1]).abs().max())
    tail_img = torch.from_numpy(synthetic_mammograms(BATCH, HW, seed=3)).to(dev)
    tail_in = (torch.relu(randn(BATCH, 64, 6, 6)).permute(0, 2, 3, 1), randn(BATCH, 6, 6, 64),
               tail_img.to(torch.float32) / 255.0)
    tail_k = KGT.gradcam_tail(*tail_in, (HW, HW))
    tail_p = KGT.gradcam_tail_reference(*tail_in, (HW, HW))
    agree_twice("gradcam_tail", lambda: KGT.gradcam_tail(*tail_in, (HW, HW)), tail_p,
                f"B={BATCH} (6, 6, 64) -> {HW}x{HW}, {KGT.band_rows(BATCH, HW)} rows a band",
                ("overlay", "heatmap"))

    phase_done("2")

    # ---- 3. the fused pipeline, with launch counts ----------------------------
    config = fused.PipelineConfig(image_hw=(HW, HW))
    params = fused.init_pipeline_params(torch.Generator().manual_seed(0), config,
                                        device=dev)
    batches = [torch.from_numpy(synthetic_mammograms(BATCH, HW, seed=10 + i)).to(dev)
               for i in range(N_MAIN_BATCHES)]
    zero_counts()
    outs = [fused.run_pipeline(params, x, config) for x in batches]
    pipe_launches = read_counts()
    # conv_leaky and pool: two conv blocks in each of two conv stacks a
    # batch (the forward and the Grad-CAM activations)
    expected = {"largest_obj": 0, "equalize": N_MAIN_BATCHES,
                "pectoral_tail": N_MAIN_BATCHES, "ccl": 0, "mode": 0, "watershed": 0,
                "conv_leaky": 4 * N_MAIN_BATCHES, "pool": 4 * N_MAIN_BATCHES,
                "upsample": 0, "batchnorm": 0, "jet_blend": 0,
                "gradcam_tail": 2 * N_MAIN_BATCHES, "cleaner_front": N_MAIN_BATCHES,
                "largest_component_seeded": 0, "flood": 0, "watershed_packed": 0,
                "conv_leaky_bf16": 0}
    print(f"fused pipeline: {N_MAIN_BATCHES} batches of B={BATCH} at {HW}x{HW}, "
          f"launches {pipe_launches}", flush=True)
    if pipe_launches != expected:
        raise AssertionError(f"kernel launches {pipe_launches}, expected {expected}")
    for out in outs:
        if out.probs.shape != (BATCH, 2) or not bool(torch.isfinite(out.probs).all()):
            raise AssertionError("probs are not finite (B, 2)")
        if float((out.probs.sum(dim=1) - 1).abs().max()) > 1e-5:
            raise AssertionError("probs do not sum to 1")
        if (out.overlays.shape != (BATCH, 2, HW, HW, 3)
                or out.heatmaps.shape != (BATCH, 2, HW, HW)
                or out.features.shape != (BATCH, 32, 32, 64)
                or not bool(torch.isfinite(out.features).all())):
            raise AssertionError("pipeline output shapes or features are wrong")
        if int(out.clean_u8.amax()) == 0:
            raise AssertionError("cleaned images are empty")

    phase_done("3")

    # ---- 4. the fused pipeline: the card against the CPU ------------------------
    x2 = synthetic_mammograms(2, HW, seed=99)
    gpu = fused.run_pipeline(params, torch.from_numpy(x2).to(dev), config)
    cpu_params = fused.PipelineParams(copy.deepcopy(params.encoder).cpu(),
                                      copy.deepcopy(params.classifier).cpu())
    cpu = fused.run_pipeline(cpu_params, torch.from_numpy(x2), config)
    tolerances = {"clean_u8": 0, "probs": 2e-5, "features": 1e-5,
                  "heatmaps": 2, "overlays": 2, "predicted": 0}
    for name, tol in tolerances.items():
        err = max_abs_err(getattr(gpu, name).cpu(), getattr(cpu, name))
        print(f"cuda vs cpu {name}: max_abs_err {err} (tolerance {tol})", flush=True)
        if err > tol:
            raise AssertionError(f"{name}: card and CPU differ by {err} > {tol}")

    phase_done("4")

    # ---- 4b. the even-kernel pectoral path, through the packed watershed -------
    # process(..., pect_removal=True, morph_kn_size=4, n_morph_op=7) takes
    # remove_pectoral's composed branch (the fused tail does not anchor an
    # even window with repeats): select_largest_obj, erode and dilate, the
    # packed watershed, the ridge, the opening
    even_kw = dict(pect_removal=True, morph_kn_size=4, n_morph_op=7)
    even_in = {"B=8 512x512 (the serving segment shape)": torch.from_numpy(
                   synthetic_mammograms(8, 512, seed=40)).to(dev),
               f"B={BATCH} {HW}x{HW} (the pipeline's batch)": torch.from_numpy(
                   synthetic_mammograms(BATCH, HW, seed=50)).to(dev)}
    zero_counts()
    even_out = {name: cleaner.process(x, **even_kw) for name, x in even_in.items()}
    even_launches = read_counts()
    print(f"even-kernel process path: {len(even_in)} calls "
          f"({', '.join(even_in)}), launches {even_launches}", flush=True)
    n_even = len(even_in)
    if (even_launches["watershed_packed"] != n_even or even_launches["watershed"] != n_even
            or even_launches["pectoral_tail"]):
        raise AssertionError(f"the even-kernel path launched the packed watershed "
                             f"{even_launches['watershed_packed']} times for {n_even} calls "
                             f"(pectoral_tail {even_launches['pectoral_tail']}): "
                             f"{even_launches}")
    # the packed watershed's inputs on the way through a second run, against
    # its plain version at the same cap; the second run's bytes equal the
    # first's
    seen = []
    ws_fn = cleaner.marker_watershed

    def recording_watershed(img, mk, *args, **kwargs):
        out = ws_fn(img, mk, *args, **kwargs)
        seen.append((img, mk, kwargs, out))
        return out
    cleaner.marker_watershed = recording_watershed
    try:
        again = {name: cleaner.process(x, **even_kw) for name, x in even_in.items()}
    finally:
        cleaner.marker_watershed = ws_fn
    for (img_, mk_, kwargs, (labels, boundary)), name in zip(seen, even_in):
        h, w = img_.shape[1:]
        plain_l, plain_b = KW.marker_watershed_reference(
            img_.to(torch.float32), mk_, max_iters=kwargs.get("max_iters", 256),
            max_scan=kwargs["max_scan"], marker_label_values=kwargs["marker_label_values"])
        agree("watershed_packed", labels, plain_l, f"even-kernel process, {name}, labels")
        agree("watershed_packed", boundary, plain_b, f"even-kernel process, {name}, boundary")
    for name, x in even_in.items():
        (img_a, res_a), (img_b, res_b) = even_out[name], again[name]
        cpu_img, cpu_res = cleaner.process(x.cpu(), **even_kw)
        for field, a, b, c in [("image", img_a, img_b, cpu_img)] + [
                (f, getattr(res_a, f), getattr(res_b, f), getattr(cpu_res, f))
                for f in cpu_res._fields]:
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"even-kernel process [{name}, {field}]: two runs differ")
            err = max_abs_err(a.cpu(), c)
            print(f"check even-kernel process [{name}, {field}], card vs CPU: max_abs_err "
                  f"{err} (tolerance 0, bit-exact)", flush=True)
            if err != 0.0:
                raise AssertionError(f"even-kernel process [{name}, {field}]: card and CPU "
                                     f"differ")
        ms = p50_ms(lambda x=x: cleaner.process(x, **even_kw), N_TIMED)
        print(f"time even-kernel process {name}: wall p50 {ms:.3f} ms over {N_TIMED} calls "
              f"on {card}", flush=True)
    del even_in, even_out, again, seen

    phase_done("4b")

    # ---- 5. serving at full width --------------------------------------------
    eng = E.InferenceEngine(E.EngineConfig(), seed=0, device=dev)
    t0 = time.perf_counter()
    eng.warmup()
    print(f"serving warmup: {time.perf_counter() - t0:.2f} s", flush=True)
    batcher = eng.dynamic_batcher("basic")
    flushes_before = batcher.n_flushes
    zero_counts()
    feats = {}
    for name, img in uploads.items():
        f, clean = eng.process_single_image(img, cache_token=name)
        feats[name] = f
        if f.shape != (64, seg_h // 2, seg_w // 2) or not np.isfinite(f).all():
            raise AssertionError(f"{name}: features {f.shape} are wrong")
        if clean.shape != (seg_h, seg_w) or clean.dtype != np.uint8 or (clean > 0).mean() < 0.1:
            raise AssertionError(f"{name}: clean image is wrong or empty")
    token = "3328x2560 u16"
    with tempfile.TemporaryDirectory() as tmp:
        for pipeline in ("basic", "advanced"):
            row = eng.classify(feats[token], pipeline, cache_token=token)
            row2, coords = eng.classify_and_roi(feats[token], pipeline, (0, 1),
                                                cache_token=token)
            for r in (row, row2):
                if abs(sum(r["prediction_probabilities"]) - 1) > 1e-5:
                    raise AssertionError(f"{pipeline}: probs do not sum to 1")
            for c in [row["roiCoords"], row2["roiCoords"]] + coords:
                if not all(0.0 <= v <= 1.0 for v in c.values()) or c["width"] <= 0:
                    raise AssertionError(f"{pipeline}: ROI {c} is not a box in [0, 1]")
            out_dir = os.path.join(tmp, pipeline)
            eng.write_gradcam_overlays(feats[token], np.zeros((seg_h, seg_w), np.uint8),
                                       out_dir, (0, 1), pipeline)
            for c in (0, 1):
                for kind in ("overlay", "heatmap"):
                    with open(os.path.join(out_dir, f"gradcam_{kind}_class_{c}.png"), "rb") as fh:
                        if fh.read(8) != b"\x89PNG\r\n\x1a\n":
                            raise AssertionError(f"{pipeline}: {kind} {c} is not a PNG")
    with concurrent.futures.ThreadPoolExecutor(max_workers=N_BATCHED) as ex:
        requests = ([feats[name] for name in uploads] * N_BATCHED)[:N_BATCHED]
        rows = list(ex.map(eng.dynamic_batcher("basic").classify, requests))
    n_flushes = batcher.n_flushes - flushes_before
    bulk_rows = eng.classify_batch(bulk, "basic")
    serve_launches = read_counts()
    # conv stacks (two conv blocks each): per pipeline 2 for classify, 2
    # for classify_and_roi, 1 per overlay class; 2 per micro-batch flush;
    # 1 for classify_batch. jet_blend: one per overlay class and pipeline.
    # One cleaner_front per cleaned batch (3 uploads, classify_batch);
    # largest_obj once in each composed pectoral branch (the two uploads
    # cleaned beyond 512)
    stacks = 2 * (2 + 2 + 2) + 2 * n_flushes + 1
    expected = {"largest_obj": 2, "equalize": 4, "pectoral_tail": 2,
                "watershed": 2, "ccl": 4 + n_flushes, "mode": 4 + n_flushes,
                "conv_leaky": 2 * stacks, "pool": 2 * stacks, "upsample": 0,
                "batchnorm": 0, "jet_blend": 2 * 2, "gradcam_tail": 0, "cleaner_front": 4,
                "largest_component_seeded": 0, "flood": 0, "watershed_packed": 0,
                "conv_leaky_bf16": 0}
    print(f"serving path: 3 uploads, 2 pipelines, {N_BATCHED} batched requests in "
          f"{n_flushes} flushes, classify_batch B={N_BATCHED}; launches {serve_launches}",
          flush=True)
    if serve_launches != expected:
        raise AssertionError(f"serving launches {serve_launches}, expected {expected}")
    if len(rows) != N_BATCHED or len(bulk_rows) != N_BATCHED:
        raise AssertionError("batched results are missing")
    for r in rows + bulk_rows:
        if abs(sum(r["prediction_probabilities"]) - 1) > 1e-5:
            raise AssertionError("batched probs do not sum to 1")

    phase_done("5")

    # ---- 6. serving: the card against the CPU ---------------------------------
    state = E.EngineState(copy.deepcopy(eng.encoder_params).cpu(),
                          copy.deepcopy(eng.basic_params).cpu(),
                          copy.deepcopy(eng.advanced_params).cpu())
    cpu_eng = E.InferenceEngine(eng.config, state=state, device="cpu")
    img = synthetic_native_mammogram(640, 544, seed=11)
    fg, cg = eng.process_single_image(img)
    fc, cc = cpu_eng.process_single_image(img)
    checks = [("clean", max_abs_err(torch.from_numpy(cg), torch.from_numpy(cc)), 0),
              ("features", max_abs_err(torch.from_numpy(fg), torch.from_numpy(fc)), 1e-5)]
    with tempfile.TemporaryDirectory() as tmp:
        for pipeline, cam_h in (("basic", 6), ("advanced", 62)):
            rg, coords_g = eng.classify_and_roi(fg, pipeline, (0, 1))
            rc, coords_c = cpu_eng.classify_and_roi(fc, pipeline, (0, 1))
            checks.append((f"{pipeline} probs", float(np.abs(
                np.subtract(rg["prediction_probabilities"], rc["prediction_probabilities"])).max()),
                2e-5))
            roi_err = max(abs(a[k] - b[k]) for a, b in zip([rg["roiCoords"]] + coords_g,
                                                           [rc["roiCoords"]] + coords_c)
                          for k in a)
            checks.append((f"{pipeline} roi boxes", roi_err, 1.0 / cam_h))
            og = eng.write_gradcam_overlays(fg, cg, os.path.join(tmp, "g"), (0, 1), pipeline)
            oc = cpu_eng.write_gradcam_overlays(fc, cc, os.path.join(tmp, "c"), (0, 1), pipeline)
            # The CAMs differ by float ulps between the devices, so a
            # heatmap pixel may truncate to the next level (overlay_checks)
            for c in (0, 1):
                checks += overlay_checks(
                    f"{pipeline} class {c}", *(torch.from_numpy(a)[None] for a in og[c]),
                    *(torch.from_numpy(a)[None] for a in oc[c]), torch.from_numpy(cc)[None], 2,
                    jet_slope)
    for name, err, tol in checks:
        print(f"serving cuda vs cpu {name}: max_abs_err {err} (tolerance {tol})", flush=True)
        if err > tol:
            raise AssertionError(f"serving {name}: card and CPU differ by {err} > {tol}")

    phase_done("6")

    # ---- 6b. the reference Grad-CAM and the weight loaders ------------------------
    cfg0 = E.EngineConfig()
    summary = {"dataset": {"input_shape": list(cfg0.advanced_classifier.input_shape),
                           "num_classes": cfg0.advanced_classifier.num_classes},
               "model": {"conv_layers": [list(c) for c in cfg0.advanced_classifier.conv_layers],
                         "hidden_units": list(cfg0.advanced_classifier.hidden_units),
                         "dropout_rate": cfg0.advanced_classifier.dropout_rate}}
    r34 = randomize_bn(TR.init_resnet(torch.Generator().manual_seed(34),
                                      dataclasses.replace(TR.RESNET34, in_channels=1)),
                       torch.Generator().manual_seed(35))
    basic_src = cnn.init_params(torch.Generator().manual_seed(60), cfg0.basic_classifier)
    adv_src = cnn.init_params(torch.Generator().manual_seed(61),
                              adcnnm.advanced_config_from_summary(summary))
    with tempfile.TemporaryDirectory() as art:
        files = {k: os.path.join(art, n) for k, n in (
            ("gradcam_pth", "resnet50.pth"), ("encoder_pth", "unet_resnet34.pth"),
            ("basic_npz", "cnn_model.npz"),
            ("advanced_summary_json", "training_summary_advanced.json"),
            ("advanced_pth", "best_model.pth"))}
        torch.save(r50.state_dict(), files["gradcam_pth"])
        torch.save({f"encoder.{k}": v for k, v in r34.state_dict().items()},
                   files["encoder_pth"])
        checkpoint.save_npz(basic_src, files["basic_npz"])
        with open(files["advanced_summary_json"], "w") as fh:
            json.dump(summary, fh)
        torch.save(adcnnm_state_dict(adv_src), files["advanced_pth"])
        try:
            E.InferenceEngine(cfg0, device=dev, gradcam_pth=files["encoder_pth"])
        except ValueError as e:
            print(f"loaders: an fc-less gradcam_pth raises ValueError: {e}", flush=True)
        else:
            raise AssertionError("an fc-less gradcam_pth did not raise")
        ref_eng = E.InferenceEngine(cfg0, seed=0, device=dev, **files)
        cpu_ref = E.InferenceEngine(cfg0, seed=0, device="cpu", **files)
    loaded = {
        "encoder conv1": torch.equal(ref_eng.encoder_params.conv1.cpu(), r34.conv1.weight),
        "resnet50": all(torch.equal(a.cpu(), b) for a, b in zip(
            ref_eng.gradcam_resnet[1].state_dict().values(), r50.state_dict().values())),
        "basic": all(torch.equal(a.cpu(), b) for a, b in zip(ref_eng.basic_params.parameters(),
                                                             basic_src.parameters())),
        "advanced": all(torch.equal(a.cpu(), b) for a, b in zip(
            ref_eng.advanced_params.parameters(), adv_src.parameters())),
        "advanced padding SAME": ref_eng.config.advanced_classifier.conv_padding == "SAME"}
    print(f"loaders: loaded weights equal the saved ones {loaded}", flush=True)
    if not all(loaded.values()):
        raise AssertionError(f"a loaded artifact differs from the saved weights: {loaded}")
    ref_upload = uploads["512x512 u8"]
    fg, cg = ref_eng.process_single_image(ref_upload)
    fc, cc = cpu_ref.process_single_image(ref_upload)
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts()
        ref_g = ref_eng.write_gradcam_overlays(fg, cg, os.path.join(tmp, "g"), (0, 1))
        ref_launches = read_counts()
        ref_c = cpu_ref.write_gradcam_overlays(fc, cg, os.path.join(tmp, "c"), (0, 1))
    # one ResNet-50 forward for both classes: 53 batch norms; one jet_blend
    # a class
    expected = {name: 0 for name in wrappers}
    expected.update(batchnorm=53, jet_blend=2)
    print(f"reference Grad-CAM: write_gradcam_overlays at {seg_h}x{seg_w}, classes (0, 1), "
          f"ResNet-50 (fc 1000) from gradcam_pth; launches {ref_launches}", flush=True)
    if ref_launches != expected:
        raise AssertionError(f"reference launches {ref_launches}, expected {expected}")
    x_g = TG.imagenet_input_from_gray(torch.from_numpy(cg).to(dev))
    x_c = TG.imagenet_input_from_gray(torch.from_numpy(cg))
    l4_g = TR.layer4_features(ref_eng.gradcam_resnet[1], x_g).cpu()
    l4_c = TR.layer4_features(cpu_ref.gradcam_resnet[1], x_c)
    cams_g = TG.resnet_gradcam_cams(ref_eng.gradcam_resnet[1], x_g, (0, 1)).cpu()
    cams_c = TG.resnet_gradcam_cams(cpu_ref.gradcam_resnet[1], x_c, (0, 1))
    checks = [("clean", max_abs_err(torch.from_numpy(cg), torch.from_numpy(cc)), 0),
              ("features (encoder_pth)", max_abs_err(torch.from_numpy(fg),
                                                     torch.from_numpy(fc)), 1e-5),
              (f"layer4 activations {tuple(l4_c.shape)}, relative to their largest "
               f"{float(l4_c.abs().max()):.4g}",
               max_abs_err(l4_g, l4_c) / float(l4_c.abs().max()), 1e-4),
              ("CAMs (16x16)", max_abs_err(cams_g, cams_c), 2e-3)]
    for pipeline in ("basic", "advanced"):
        pg = ref_eng.classify(fg, pipeline)["prediction_probabilities"]
        pc = cpu_ref.classify(fg, pipeline)["prediction_probabilities"]
        checks.append((f"{pipeline} probs (loaded classifier)",
                       float(np.abs(np.subtract(pg, pc)).max()), 2e-5))
    for c in (0, 1):
        checks += overlay_checks(f"reference class {c}",
                                 *(torch.from_numpy(a)[None] for a in ref_g[c]),
                                 *(torch.from_numpy(a)[None] for a in ref_c[c]),
                                 torch.from_numpy(cg)[None], 2, jet_slope)
    for name, err, tol in checks:
        print(f"reference cuda vs cpu {name}: max_abs_err {err} (tolerance {tol})", flush=True)
        if err > tol:
            raise AssertionError(f"reference {name}: card and CPU differ by {err} > {tol}")

    phase_done("6b")

    # ---- 6c. saliency of both classifiers ------------------------------------------
    # A saliency level is a truncation of the normalised gradient, so an
    # ulp between the devices may move a pixel to the next level, and JET
    # then moves its colour by up to jet_slope counts: heatmaps +-1 and
    # overlays +-1 outside the bilinear footprint of the saliency pixels
    # that differ, within jet_slope * dsal + 1 (heatmap) and half of that
    # + 1 (overlay, a 0.5 / 0.5 blend) inside it.
    checks = []
    # cuDNN's deterministic algorithms, so that the saliency maps taken
    # apart below are the ones the entry point drew
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        for pipeline in ("basic", "advanced"):
            sal, maps = {}, {}
            for d, engine in ((dev, ref_eng), ("cpu", cpu_ref)):
                if pipeline == "basic":
                    x_in, model = engine.process_bottleneck_features(fc), engine.basic_params
                else:
                    x_in, model = engine._to_hwc(np.array(fc)), engine.advanced_params
                sal[d] = TS.generate_dual_class_overlays(model, x_in, cg, (0, 1),
                                                         os.path.join(tmp, f"{pipeline}{d}"))
                xt = torch.as_tensor(x_in, device=d)
                maps[d] = [TS.saliency_map_u8(TS.input_gradient(model, xt, c)).cpu()
                           for c in (0, 1)]
            for c in (0, 1):
                dsal = (maps[dev][c].int() - maps["cpu"][c].int()).abs()
                foot = torch.nn.functional.interpolate(
                    (dsal > 0).to(torch.float32)[None, None], size=(seg_h, seg_w),
                    mode="bilinear", align_corners=False)[0, 0] > 0
                foot = foot[..., None].expand(seg_h, seg_w, 3)
                inner = jet_slope * int(dsal.max()) + 1
                for i, kind in enumerate(("overlay", "heatmap")):
                    diff = (torch.from_numpy(sal[dev][c][i]).int()
                            - torch.from_numpy(sal["cpu"][c][i]).int()).abs()
                    checks.append((f"{pipeline} class {c} {kind} outside the footprint of the "
                                   f"{int((dsal > 0).sum())} saliency pixels that differ",
                                   float(diff[~foot].max()) if bool((~foot).any()) else 0.0, 1))
                    checks.append((f"{pipeline} class {c} {kind} inside it",
                                   float(diff[foot].max()) if bool(foot.any()) else 0.0,
                                   inner if kind == "heatmap" else inner // 2 + 1))
    torch.backends.cudnn.deterministic = deterministic
    for name, err, tol in checks:
        print(f"saliency cuda vs cpu {name}: max_abs_err {err} (tolerance {tol})", flush=True)
        if err > tol:
            raise AssertionError(f"saliency {name}: card and CPU differ by {err} > {tol}")

    phase_done("6c")

    # ---- 7. training at full width ----------------------------------------------
    trng = np.random.default_rng(0)
    eye = np.eye(2, dtype=np.float32)
    Xb, yb = BT.synthetic_features(trng, 80, BT.BASIC.input_shape, signal=0.08,
                                   label_noise=0.1)
    Xa, ya = BT.synthetic_features(trng, 80, BT.ADVANCED.input_shape, label_noise=0.12)
    Xu, Yu = blobs(trng, 40, HW)
    zero_counts()
    t0 = time.perf_counter()
    fits = {
        "basic SGD": step.fit(cnn.init_params(torch.Generator().manual_seed(1), BT.BASIC),
                              Xb[:64], eye[yb[:64]], Xb[64:], yb[64:], epochs=2, lr=0.01,
                              batch_size=8, optimizer="sgd", device=dev),
        "advanced Adam": step.fit(cnn.init_params(torch.Generator().manual_seed(0),
                                                  BT.ADVANCED),
                                  Xa[:64], eye[ya[:64]], Xa[64:], ya[64:], epochs=2,
                                  lr=1e-3, batch_size=32, optimizer="adam", device=dev),
    }
    seg_fit = segmentation.fit_segmentation(
        unet.init_unet(torch.Generator().manual_seed(2), BT.UNET), Xu[:32], Yu[:32],
        Xu[32:], Yu[32:], epochs=2, lr=1e-3, batch_size=8, device=dev)
    train_launches = read_counts()
    train_s = time.perf_counter() - t0
    # a forward is one conv stack of two conv blocks: per epoch, basic 64/8
    # steps + 1 test batch, advanced 64/32 + 1; the U-Net's forward has 3
    # pools and 3 upsamples: 32/8 steps + 1 validation forward an epoch
    n_stacks = 2 * (8 + 1) + 2 * (2 + 1)
    n_unet = 2 * (4 + 1)
    expected = {name: 0 for name in wrappers}
    expected.update(conv_leaky=2 * n_stacks, pool=2 * n_stacks + 3 * n_unet,
                    upsample=3 * n_unet)
    print(f"training: basic SGD and advanced Adam 2 epochs on 64/16, U-Net 2 epochs on "
          f"32 images at {HW}x{HW}, {train_s:.1f} s; launches {train_launches}", flush=True)
    if train_launches != expected:
        raise AssertionError(f"training launches {train_launches}, expected {expected}")
    for name, res in fits.items():
        print(f"training {name}: history {res.history}", flush=True)
        if len(res.history) != 2 or not all(
                np.isfinite(r["loss"]) and 0.0 <= r["val_acc"] <= 1.0 for r in res.history):
            raise AssertionError(f"{name}: the history is wrong")
    print(f"training U-Net: history {seg_fit.history}", flush=True)
    if len(seg_fit.history) != 2 or not all(
            np.isfinite(r["loss"]) and 0.0 <= r["val_dice"] <= 1.0 for r in seg_fit.history):
        raise AssertionError("U-Net: the history is wrong")

    # one step on the card and on the CPU, same weights and batch, no
    # dropout. The loss to 1e-5 relative. The gradients: the CPU's,
    # recomputed through the card's derivative switches (LeakyReLU masks
    # and max-pool selections, `pinned_grads`), to 1e-5 of each tensor's
    # largest value + 1e-6, which shows that the switches an activation
    # within rounding of them takes otherwise on the other device are what
    # separates the two; the CPU's own to that for the basic step and, for
    # both, to 1e-2 in relative L2 per tensor, 3.4x the largest measured
    # (2.93e-3, advanced conv_b.0 at B=2): one switch taken otherwise moves
    # a conv gradient by a whole term of its sum over B*H*W positions. The
    # update from the card's gradients applied on both devices to 1e-5; the
    # update from each device's own gradients to 1e-5 for SGD. Adam's first
    # update is lr * g / (|g| + eps): where the two gradients agree in sign
    # it differs by lr * eps * |g1 - g2| / ((|g1| + eps) (|g2| + eps)), held
    # to 1e-5 above that; where they straddle 0 by up to 2 lr, held to that.
    srng = np.random.default_rng(1)
    lr_adam, eps_adam = 1e-3, 1e-8
    for name, cfg, b, seed in (("basic SGD", BT.BASIC, 8, 1),
                               ("advanced Adam", BT.ADVANCED, 2, 0)):
        sgd = name == "basic SGD"
        cfg0 = dataclasses.replace(cfg, dropout_rate=0.0)
        x, labels = BT.synthetic_features(srng, b, cfg.input_shape)
        xs = {d: torch.from_numpy(x).to(d) for d in (dev, "cpu")}
        ys = {d: torch.from_numpy(eye[labels]).to(d) for d in (dev, "cpu")}
        models = {d: cnn.init_params(torch.Generator().manual_seed(seed), cfg0, device=d)
                  for d in (dev, "cpu")}
        losses, grads, switches, updated, from_card = {}, {}, {}, {}, {}
        for d in (dev, "cpu"):
            with full_fp32():
                losses[d], grads[d] = cnn.grads_fn(models[d], xs[d], ys[d])
                switches[d] = classifier_switches(models[d], xs[d])
        _, pinned = pinned_grads(models["cpu"], xs["cpu"], ys["cpu"], switches[dev])
        for d in (dev, "cpu"):
            for out, gs in ((updated, grads[d]), (from_card, [g.to(d) for g in grads[dev]])):
                m = cnn.init_params(torch.Generator().manual_seed(seed), cfg0, device=d)
                plist = list(m.parameters())
                if sgd:
                    optim.sgd_reference_update(plist, gs, 0.01)
                else:
                    tx = optim.adam(lr_adam)
                    tx.step(plist, gs, tx.init(plist))
                out[d] = [(n, p.detach().cpu()) for n, p in m.named_parameters()]
        loss_g, loss_c = float(losses[dev]), float(losses["cpu"])
        loss_rel = abs(loss_g - loss_c) / abs(loss_c)
        names = [n for n, _ in updated["cpu"]]
        g_card = [g.cpu() for g in grads[dev]]
        grad_err = {n: max_abs_err(g, c) for n, g, c in zip(names, g_card, grads["cpu"])}
        pinned_err = {n: max_abs_err(g, c) for n, g, c in zip(names, g_card, pinned)}
        grad_tol = {n: 1e-5 * float(c.abs().max()) + 1e-6
                    for n, c in zip(names, grads["cpu"])}
        grad_rel = {n: float((g.double() - c.double()).norm()
                             / c.double().norm().clamp_min(1e-30))
                    for n, g, c in zip(names, g_card, grads["cpu"])}
        (conv_card, dense_card), (conv_cpu, dense_cpu) = switches[dev], switches["cpu"]
        switched = {}
        for i, ((mg, sg), (mc, sc)) in enumerate(zip(conv_card, conv_cpu)):
            h2, w2 = sg.shape[2] // 2, sg.shape[3] // 2
            switched[f"conv {i} LeakyReLU"] = int((mg.cpu() != mc).sum())
            switched[f"conv {i} pool windows"] = int(
                (sg.cpu() != sc).reshape(b, -1, h2, 2, w2, 2).any(dim=5).any(dim=3).sum())
        for i, (mg, mc) in enumerate(zip(dense_card, dense_cpu)):
            switched[f"dense {i} LeakyReLU"] = int((mg.cpu() != mc).sum())
        card_err = {n: max_abs_err(a, c) for (n, a), (_, c) in zip(from_card[dev],
                                                                   from_card["cpu"])}
        own_err, own_over, straddle = {}, {}, {}
        for (n, a), (_, c), g1, g2 in zip(updated[dev], updated["cpu"], g_card, grads["cpu"]):
            diff = (a.double() - c.double()).abs()
            own_err[n] = float(diff.max())
            if sgd:
                tol = 1e-5
            else:
                g1, g2 = g1.double(), g2.double()
                across = g1 * g2 <= 0
                straddle[n] = int(across.sum())
                tol = torch.where(across, 2 * lr_adam + 1e-6,
                                  lr_adam * eps_adam * (g1 - g2).abs()
                                  / ((g1.abs() + eps_adam) * (g2.abs() + eps_adam)) + 1e-5)
            own_over[n] = int((diff > tol).sum())
        print(f"training cuda vs cpu, one {name} step B={b}: loss {loss_g} vs {loss_c}, "
              f"relative {loss_rel} (tolerance 1e-5); gradients recomputed on the CPU "
              f"through the card's switches max_abs_err {pinned_err} (tolerance 1e-5 of "
              f"the largest + 1e-6: {grad_tol}); switches taken otherwise on the two "
              f"devices {switched}; the CPU's own gradients max_abs_err {grad_err}, "
              f"relative L2 error {grad_rel} (tolerance 1e-2); parameters after the "
              f"update from the card's gradients on both devices max_abs_err {card_err} "
              f"(tolerance 1e-5); after the update from each device's own gradients "
              f"max_abs_err {own_err}, entries whose gradients straddle 0 {straddle}, "
              f"entries over their tolerance {own_over}", flush=True)
        if (loss_rel > 1e-5 or any(pinned_err[n] > grad_tol[n] for n in names)
                or max(grad_rel.values()) > 1e-2
                or (sgd and any(grad_err[n] > grad_tol[n] for n in names))
                or max(card_err.values()) > 1e-5 or sum(own_over.values())):
            raise AssertionError(f"one {name} step: card and CPU differ")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "basic.npz")
        trained = fits["basic SGD"].model
        checkpoint.save_npz(trained, path)
        cfg_back, back = checkpoint.load_npz(path, device=dev)
        same = cfg_back == BT.BASIC and all(
            torch.equal(a, c) for a, c in zip(back.parameters(), trained.parameters()))
        same_preds = np.array_equal(step.predict_classes(back, Xb[64:]),
                                    step.predict_classes(trained, Xb[64:]))
        print(f"save_npz -> load_npz on the card: parameters equal {same}, predictions "
              f"equal {same_preds}", flush=True)
        if not (same and same_preds):
            raise AssertionError("the npz round trip changed the model")

    phase_done("7")

    # ---- 7b. the training CLI at full width --------------------------------------
    featurize = TT.featurize
    feat_ms = {}    # native shape -> wall ms of each featurize (ends in a host fetch)

    def timed_featurize(stem, img, feature_hw, device):
        t = time.perf_counter()
        out = featurize(stem, img, feature_hw, device)
        feat_ms.setdefault(f"{img.shape[0]}x{img.shape[1]}", []).append(
            (time.perf_counter() - t) * 1e3)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        rows = []
        for i in range(N_CLI):
            h, w = CLI_SHAPES[i % 2]
            label = (i // 2) % 2
            img = synthetic_native_mammogram(h, w, seed=40 + i)
            if label:   # a bright mass inside the breast
                yy, xx = np.ogrid[0:h, 0:w]
                disk = (yy - h // 2) ** 2 + (xx - 3 * w // 4) ** 2 < (min(h, w) // 12) ** 2
                img[disk] = np.maximum(img[disk], 52000)
            path = os.path.join(tmp, f"case{i}.dcm")
            TDicom.dcmwrite_minimal(path, img, f"P{i}")
            rows.append(f"{path},{'MALIGNANT' if label else 'BENIGN'}")
        csv_path = os.path.join(tmp, "mapping.csv")
        with open(csv_path, "w") as fh:
            fh.write("dicom_file_path,pathology\n" + "\n".join(rows) + "\n")
        out_dir = os.path.join(tmp, "out")
        zero_counts()
        TT.featurize = timed_featurize
        t0 = time.perf_counter()
        try:
            cli_summary = TT.main(["--csv", csv_path, "--out-dir", out_dir] + CLI_ARGS)
        finally:
            TT.featurize = featurize
        cli_s = time.perf_counter() - t0
        cli_launches = read_counts()
        artifacts = {n: os.path.exists(os.path.join(out_dir, n)) for n in (
            "cnn_model_basic.npz", "train_state.pkl", "training_History_basic.json",
            "training_summary_basic.json")}
    n_train = cli_summary["dataset"]["train_split"]
    n_test = cli_summary["dataset"]["test_split"]
    # a conv stack (two conv blocks) per training step and per test batch of
    # each of the 2 epochs, and one for the final prediction
    eval_batches = -(-n_test // 64)
    cli_stacks = 2 * (-(-n_train // 8) + eval_batches) + eval_batches
    expected = {name: 0 for name in wrappers}
    expected.update(cleaner_front=N_CLI, equalize=N_CLI, largest_obj=N_CLI, watershed=N_CLI,
                    conv_leaky=2 * cli_stacks, pool=2 * cli_stacks)
    print(f"training CLI: {N_CLI} DICOMs at {CLI_SHAPES}, {' '.join(CLI_ARGS)}; "
          f"{n_train} train / {n_test} test, {cli_s:.1f} s wall on {card}; input shape "
          f"{cli_summary['dataset']['input_shape']}, device {cli_summary['training']['device']}, "
          f"history best_val_acc {cli_summary['training']['best_val_acc']}; artifacts "
          f"{artifacts}; launches {cli_launches}", flush=True)
    if cli_launches != expected:
        raise AssertionError(f"training CLI launches {cli_launches}, expected {expected}")
    if not all(artifacts.values()) or cli_summary["training"]["device"] != "cuda":
        raise AssertionError("the training CLI's artifacts or summary are wrong")
    if cli_summary["dataset"]["input_shape"] != [32, 32, 64]:
        raise AssertionError("the CLI's encoder features have the wrong shape")
    for shape, ms in feat_ms.items():
        print(f"time training CLI featurize {shape} u16 (clean_for_unet at native size, conv1, "
              f"resize): p50 {statistics.median(ms):.1f} ms over {len(ms)} images on {card}",
              flush=True)
    # one image's clean_for_unet and features, card against CPU
    img = torch.from_numpy(synthetic_native_mammogram(640, 544, seed=11).astype(np.float32))[None]
    stem = unet.init_resnet_stem(torch.Generator().manual_seed(0))
    with full_fp32(), torch.no_grad():
        clean_g = cleaner.clean_for_unet(img.to(dev)).cpu()
    clean_c = cleaner.clean_for_unet(img)
    feat_g = TT.featurize(copy.deepcopy(stem).to(dev), img[0].numpy(), (32, 32), dev)
    feat_c = TT.featurize(stem, img[0].numpy(), (32, 32), "cpu")
    checks = [("clean_for_unet", max_abs_err(clean_g, clean_c), 0),
              ("features", max_abs_err(torch.from_numpy(feat_g), torch.from_numpy(feat_c)), 1e-5)]
    for name, err, tol in checks:
        print(f"training CLI cuda vs cpu, 640x544 u16 {name}: max_abs_err {err} (tolerance "
              f"{tol})", flush=True)
        if err > tol:
            raise AssertionError(f"training CLI {name}: card and CPU differ by {err} > {tol}")

    phase_done("7b")

    # ---- 8. times -----------------------------------------------------------
    big_batch = batches[0]
    s_bin, g_bin, seg, equ, high, breast = clean_stage_inputs(big_batch)
    cam3 = torch.from_numpy(rng.random((3, 62, 62)).astype(np.float32)).to(dev)
    hot3 = cam3 >= 0.6 * cam3.amax(dim=(1, 2), keepdim=True)
    lab3 = KC.label_components(hot3, 8)
    # the training shapes: the advanced classifier's first conv layer and
    # the pool after it at B=32, the U-Net's last upsample at B=8
    xa, wa, ba = (randn(32, 64, HW, HW), randn(32, 64, 3, 3, scale=(2.0 / 576) ** 0.5),
                  randn(32, scale=0.1))
    pa = torch.relu(randn(32, 32, HW, HW))
    ua = randn(8, 32, HW // 2, HW // 2)

    # layer 1 as conv_stack hands it over: the channels-last view of NHWC
    # features
    xa_v = xa.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)

    def library_conv():
        with full_fp32():
            return F.conv2d(xa_v, wa, ba, padding=1)

    # the flood of fill_holes: the suppress-site masks' background, seeded
    # on the border
    fl_mask, fl_seed = border_flood(s_bin)

    # the explainability kernels at their paths' shapes: the ResNet-50
    # stem's batch norm, one reference overlay, the pipeline's tail
    bn_x, bn_m = bn_inputs[(1, 64, seg_h // 2, seg_w // 2)]
    bn_vec = tuple(t.detach() for t in (bn_m.weight, bn_m.bias, bn_m.running_mean,
                                        bn_m.running_var))
    jb_heat = torch.from_numpy(ref_g[0][1])[None].to(dev)
    jb_img = torch.from_numpy(cg)[None].to(dev).to(torch.float32) / 255.0

    raw8_64 = to_uint8(big_batch)
    raw8_big = to_uint8(serving_inputs[token])

    def old_front(raw8):
        """The front clean_boundary_gray ran before cleaner_front: two
        largest_obj launches and the plain glue around them."""
        sup, mask = cleaner.suppress_artifacts(raw8, 0.05, 15)
        return cleaner.segment_breast_mask(sup, 0.05), mask

    def ccl_mode(m):
        return KM.largest_component_mask(KC.label_components(m, 8), m)

    def pectoral_sweep_ops(equ_, high_, breast_):
        """The operations of the plain pectoral tail's sweeps on these
        inputs, image by image with the sweeps each needs (uncapped),
        counted as its CCL, flood and packed-watershed sweeps run: 22 a
        pixel a CCL sweep (along rows and columns, two segmented cummin
        scans of an or, a scan and an and, then a min and a select; the 3x3
        min of two 3-windows, a min and a select), 20 a flood sweep, 24 a
        watershed sweep at max_scan 8 (four passes of pk -/+ s, three
        doubling mins, the candidate and a min). Information only: the
        result is a unique fixpoint, so these sweeps are the plain
        algorithm's, and the bound counts `KP.ONCE_OPS` a pixel."""
        counted = {"ccl": 0, "flood": 0, "watershed": 0}
        run, sweep_packed = TC._run_to_fixpoint, TGS.sweep_packed

        def counting_run(sweep, state, max_iters):
            kind = "flood" if "flood" in sweep.__qualname__ else "ccl"

            def counted_sweep(x):
                counted[kind] += x.numel()
                return sweep(x)
            return run(counted_sweep, state, max_iters)

        def counting_packed(pk, *args):
            counted["watershed"] += pk.numel()
            return sweep_packed(pk, *args)

        TC._run_to_fixpoint, TGS.sweep_packed = counting_run, counting_packed
        try:
            for i in range(equ_.shape[0]):
                n = equ_[i].numel()
                KP.pectoral_tail_reference(equ_[i:i + 1], high_[i:i + 1], breast_[i:i + 1],
                                           max_iters=n)
        finally:
            TC._run_to_fixpoint, TGS.sweep_packed = run, sweep_packed
        return 22 * counted["ccl"] + 20 * counted["flood"] + 24 * counted["watershed"]

    # name -> (kernel call, plain call, shape, inputs, operations, library call)
    timed = {
        "equalize": (lambda: KE.equalize(seg), lambda: KE.equalize_reference(seg),
                     f"B={BATCH} {HW}x{HW}", (seg,), None, None),
        "largest_obj": (
            lambda: (KL.largest_obj(s_bin, 8, fill=True, smooth_k=15),
                     KL.largest_obj(g_bin, 8, fill_first=True)),
            lambda: (KL.largest_obj_reference(s_bin, 8, fill=True, smooth_k=15),
                     KL.largest_obj_reference(g_bin, 8, fill_first=True)),
            f"B={BATCH} {HW}x{HW}, both cleaner sites", (s_bin, g_bin), None, None),
        "pectoral_tail": (lambda: KP.pectoral_tail(equ, high, breast),
                          lambda: KP.pectoral_tail_reference(equ, high, breast),
                          f"B={BATCH} {HW}x{HW}", (equ, high, breast),
                          KP.ONCE_OPS * equ.numel(), None),
        "ccl": (lambda: KC.label_components(hot3, 8),
                lambda: KC.label_components_reference(hot3, 8),
                "B=3 62x62 CAM masks (advanced classify_and_roi)", (hot3,), None, None),
        "mode": (lambda: KM.largest_component_mask(lab3, hot3),
                 lambda: KM.largest_component_mask_reference(lab3, hot3),
                 "B=3 62x62 CAM labels (advanced classify_and_roi)", (lab3, hot3), None,
                 None),
        "conv_leaky": (lambda: KCL.conv_leaky(xa_v, wa, ba, 0.01, 1),
                       lambda: KCL.conv_leaky_reference(xa_v, wa, ba, 0.01, 1),
                       f"advanced layer 1, B=32 {HW}x{HW}x64 -> 32, SAME, NHWC view (training)",
                       (xa_v, wa, ba), 2 * 32 * HW * HW * 32 * 64 * 9, library_conv),
        "flood": (lambda: KFl.flood_from(fl_mask, fl_seed),
                  lambda: KFl.flood_from_reference(fl_mask, fl_seed),
                  f"border flood of fill_holes, B={BATCH} {HW}x{HW} suppress-site backgrounds",
                  (fl_mask, fl_seed), None, None),
        "pool": (lambda: KPool.pool(pa, 2, "max"), lambda: KPool.pool_reference(pa, 2, "max"),
                 f"max 2x2 after advanced layer 1, B=32 32x{HW}x{HW}", (pa,), pa.numel(),
                 lambda: F.max_pool2d(pa, 2)),
        "upsample": (lambda: KUp.upsample_nearest(ua, 2),
                     lambda: KUp.upsample_nearest_reference(ua, 2),
                     f"U-Net last upsample, B=8 32x{HW // 2}x{HW // 2} x2", (ua,), 0,
                     lambda: F.interpolate(ua, scale_factor=2, mode="nearest")),
        # 4 operations an element
        "batchnorm": (lambda: KBN.batchnorm(bn_x, *bn_vec),
                      lambda: KBN.batchnorm_reference(bn_x, *bn_vec),
                      f"ResNet-50 stem, {tuple(bn_x.shape)}", (bn_x,) + bn_vec,
                      4 * bn_x.numel(), lambda: F.batch_norm(
                          bn_x, bn_vec[2], bn_vec[3], bn_vec[0], bn_vec[1], training=False,
                          eps=1e-5)),
        # mul, add, div, mul a channel
        "jet_blend": (lambda: KOv.jet_blend(jb_heat, jb_img), lambda: KOv.jet_blend_reference(
            jb_heat, jb_img), f"reference overlay, B=1 {seg_h}x{seg_w} gray", (jb_heat, jb_img),
            12 * jb_heat.numel(), None),
        # the two resize products (2 operations a multiply-add) and the blend
        "gradcam_tail": (lambda: KGT.gradcam_tail(*tail_in, (HW, HW)),
                         lambda: KGT.gradcam_tail_reference(*tail_in, (HW, HW)),
                         f"pipeline, B={BATCH} (6, 6, 64) -> {HW}x{HW}", tail_in,
                         BATCH * (2 * HW * 6 * 6 + 2 * HW * HW * 6 + 12 * HW * HW), None),
    }
    def watershed_bound(inputs, outputs):
        """The pair form's bound at max_scan 8: its inputs and outputs once
        over the HBM rate, against the plain version's operations on them
        over the float32 peak (the costs: |dI| + 1e-3 and an add a doubling
        step along each axis; then, for each sweep these inputs need, counted
        by the plain sweeps, four passes of a pixel's d -/+ s, a compare and
        two selects a doubling step, w +/- s, a compare and two selects).
        Also the sweeps, and the floor of a design that reads and writes its
        planes once a sweep, 24 bytes a pixel a sweep (d, l, srow and scol
        read, d and l written), which is not the function's bound: a launch
        that ran several sweeps on a wider halo would move fewer bytes."""
        img, markers = inputs
        h, w = img.shape[-2:]
        sweeps = TGS.sweeps_to_fixpoint(img, markers, 256, 8)
        steps = [len(TGS.doubling_steps(n)) for n in (min(w, 8), min(h, 8), w, h)]
        per_sweep = 2 * (5 + 3 * steps[0]) + 2 * (5 + 3 * steps[1])
        ops = img.numel() * (6 + steps[2] + steps[3] + sweeps * per_sweep)
        b_ms, b_by = bound(nbytes(inputs) + nbytes(outputs), ops)
        return b_ms, b_by, sweeps, 24 * img.numel() * sweeps / HBM_BYTES_PER_S * 1e3

    def tile_ms(kernel_fn, outputs, iters, warmup):
        """The watershed with each of its sweep kernel's tiles in turn (the
        wrapper's tile_for replaced for the call), bit-exact against the
        shipped choice's outputs, timed forward and back over the tiles:
        {"THxTW": mean ms}."""
        shipped, runs = KW.tile_for, {t: [] for t in KW.TILES}
        try:
            for order in (KW.TILES, KW.TILES[::-1]):
                for t in order:
                    KW.tile_for = lambda *_, t=t: t
                    for part, a, c in zip(("labels", "boundary"), kernel_fn(), outputs):
                        agree("watershed", a, c, f"{part}, tile {t[0]}x{t[1]}")
                    runs[t].append(cuda_ms(kernel_fn, iters, warmup))
        finally:
            KW.tile_for = shipped
        return {f"{t[0]}x{t[1]}": sum(ms) / len(ms) for t, ms in runs.items()}

    times, bounds, dev_times = {}, {}, {}
    compared = {}
    # batchnorm at every distinct input shape of one ResNet-50 forward at the
    # display: device times from a fresh process (batchnorm_device_times)
    bn_run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                             "--batchnorm-device-times"], capture_output=True, text=True,
                            timeout=600)
    if bn_run.returncode != 0:
        raise AssertionError(f"the batchnorm device-time run failed:\n{bn_run.stderr[-4000:]}")
    bn_lines = bn_run.stdout.strip().splitlines()
    print("\n".join(bn_lines[:-1]), flush=True)
    bn_table = json.loads(bn_lines[-1])
    compared["batchnorm"] = bn_table["rows"] + [{"shape": f"sum over the ResNet-50 forward's "
                                                          f"{bn_table['launches']} launches",
                                                 **bn_table["sums"]}]

    # cleaner_front and the seeded component, each beside its plain version
    # and the launches it replaces on the same inputs, in turns plain,
    # other, kernel, kernel, other, plain; a kernel's first row is its
    # record's
    def kernel_rows(name, fn, plain_fn, other, other_fn):
        return [(name, shape, (x,), iters, lambda x=x: fn(x), lambda x=x: plain_fn(x), other,
                 lambda x=x: other_fn(x)) for shape, x, iters in cases[name]]

    # (shape, input, calls a timing of the kernel and of the launches it
    # replaces; 3 of the plain version)
    cases = {"cleaner_front": [(f"B={BATCH} {HW}x{HW} (run_pipeline's front)", raw8_64, 10),
                               ("B=1 1536x1280 (the 3328x2560 upload's bucket)", raw8_big, 10)]
             + [(f"B=1 {h}x{w} (training CLI native)", x, 3) for (h, w), x in cli_front.items()],
             "largest_component_seeded": [
                 (f"phase 2's B=16 {HW}x{HW} masks (blobs, ties, random, empty, "
                  f"suppress-site)", seeded_in, 10),
                 (f"B={BATCH} {HW}x{HW} suppress-site masks (majority blobs: the flood)", s_bin,
                  10),
                 (f"B=16 {HW}x{HW} random masks, density 0.45", rand_masks, 10)]}
    for name, shape, inputs, iters, kernel_fn, plain_fn, other, other_fn in (
            kernel_rows("cleaner_front", KF.cleaner_front, KF.cleaner_front_reference,
                        "old front", old_front)
            + kernel_rows("largest_component_seeded", KL.largest_component_seeded,
                          KL.largest_component_seeded_reference, "ccl + mode", ccl_mode)):
        outputs = kernel_fn()
        b_ms, b_by = bound(nbytes(inputs) + nbytes(outputs), numel(outputs))
        k, p, o, runs = turns_ms(kernel_fn, plain_fn, iters, 3, other_fn)
        dk, dp, do = (device_ms(kernel_fn, iters), device_ms(plain_fn, 3),
                      device_ms(other_fn, iters))
        if name not in compared:
            times[name], bounds[name], dev_times[name] = (k, p, None), (b_ms, b_by), (dk, dp, None)
        compared.setdefault(name, []).append({
            "shape": shape, "ms": k, "plain_ms": p, "bound_ms": b_ms, "bound_by": b_by,
            "other": other, "other_ms": o, "device_ms": dk, "plain_device_ms": dp,
            "other_device_ms": do})
        print(f"time {name} {shape}: kernel {k:.4f} ms (runs {runs[0]:.4f}, {runs[1]:.4f}), "
              f"plain {p:.4f} ms (runs {runs[2]:.4f}, {runs[3]:.4f}), {other} {o:.4f} ms (runs "
              f"{runs[4]:.4f}, {runs[5]:.4f}), bound {b_ms:.4f} ms by {b_by}; device time "
              f"(profiler) kernel {ms_text(dk)}, plain {ms_text(dp)}, {other} {ms_text(do)} ms "
              f"on {card}", flush=True)

    # the pectoral branch's two kernels where a B=1 image runs them: the
    # select at every shape beyond 512 (serving and CLI), the watershed at
    # both serving shapes (the 1536x1280 bucket first: the record's row) and
    # the CLI's native shapes, also with each tile of its sweep; in turns
    # with their plain versions, the watershed 10 calls a timing after 5
    # (one call of a few ms does not bring the card up to speed after the
    # plain version's small launches)
    ws_sites = [(f"pair form, {composed[name][2]}", *composed[name][:2])
                for name in sorted(composed, key=lambda name: name != token)]
    ws_sites += [(f"pair form, B=1 {h}x{w} (training CLI)", e, mk)
                 for (h, w), (e, mk) in cli_pectoral.items()]
    branch = [("largest_obj", lambda m=m: KL.largest_obj(m, 8, fill=True),
               lambda m=m: KL.largest_obj_reference(m, 8, fill=True),
               f"pectoral select, B=1 {h}x{w}", (m,), 10) for (h, w), m in pect_masks.items()]
    branch += [("watershed", lambda e=e, mk=mk: KW.marker_watershed(
                    e, mk, max_scan=8, marker_label_values=(255, 128, 64)),
                lambda e=e, mk=mk: KW.marker_watershed_reference(
                    e, mk, max_scan=8, marker_label_values=(255, 128, 64)),
                shape, (e, mk), 10) for shape, e, mk in ws_sites]
    for name, kernel_fn, plain_fn, shape, inputs, iters in branch:
        outputs = kernel_fn()
        extra, text = {}, ""
        warmup = 5 if name == "watershed" else 1
        if name == "watershed":
            b_ms, b_by, sweeps, floor_ms = watershed_bound(inputs, outputs)
            shape = f"{shape}, {sweeps} sweeps"
            tiles = tile_ms(kernel_fn, outputs, iters, warmup)
            extra = {"sweep_floor_ms": floor_ms, "tile_ms": tiles}
            picked = "x".join(map(str, KW.tile_for(1, *inputs[0].shape[-2:])))
            text = (f"; a read and write of the planes a sweep {floor_ms:.4f} ms; by tile "
                    + ", ".join(f"{t} {ms:.4f}" for t, ms in tiles.items())
                    + f" ms (tile_for picks {picked})")
        else:
            b_ms, b_by = bound(nbytes(inputs) + nbytes(outputs), numel(outputs))
        k, p, _, runs = turns_ms(kernel_fn, plain_fn, iters, 1, warmup=warmup)
        dk = device_ms(kernel_fn, iters)
        if name == "watershed" and name not in times:
            times[name], bounds[name] = (k, p, None), (b_ms, b_by)
            dev_times[name] = (dk, device_ms(plain_fn, 1), None)
        compared.setdefault(name, []).append({
            "shape": shape, "ms": k, "plain_ms": p, "bound_ms": b_ms, "bound_by": b_by,
            "device_ms": dk, **extra})
        print(f"time {name} {shape}: kernel {k:.4f} ms (runs {runs[0]:.4f}, {runs[1]:.4f}, "
              f"apart {abs(runs[0] - runs[1]) / k * 100:.1f}%), plain {p:.4f} ms (runs "
              f"{runs[2]:.4f}, {runs[3]:.4f}), bound {b_ms:.4f} ms by {b_by}{text}; device time "
              f"(profiler) kernel {ms_text(dk)} ms on {card}", flush=True)
    del outputs, branch

    # the training CLI's featurize split by stage: each stage's function
    # wrapped by a synchronised host clock, 5 images a native shape after a
    # warmup, p50 of each; "the rest" is the total's p50 less the stages'
    from cadx_tpu_torch.ops import resize as TResize

    stage_ms = {}

    def staged(module, attr, stage):
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_ms.setdefault(stage, []).append((time.perf_counter() - t) * 1e3)
            return out
        setattr(module, attr, wrapped)
        return module, attr, fn

    stem_dev = unet.init_resnet_stem(torch.Generator().manual_seed(0)).to(dev)
    top_stages = ("cleaner_front", "pectoral removal", "resize_area to 512x512", "conv1",
                  "resize to 32x32")
    for h, w in CLI_SHAPES:
        img = synthetic_native_mammogram(h, w, seed=40)
        TT.featurize(stem_dev, img, (32, 32), dev)
        stage_ms.clear()
        totals = []
        patched = [staged(cleaner, "cleaner_front", "cleaner_front"),
                   staged(cleaner, "remove_pectoral", "pectoral removal"),
                   staged(cleaner, "equalize_hist", "pectoral removal: equalize"),
                   staged(cleaner, "select_largest_obj", "pectoral removal: largest_obj"),
                   staged(cleaner, "marker_watershed", "pectoral removal: pair-form watershed"),
                   staged(cleaner, "resize_area", "resize_area to 512x512"),
                   staged(unet, "encoder_first_features", "conv1"),
                   staged(TResize, "resize_linear", "resize to 32x32")]
        try:
            for _ in range(5):
                t = time.perf_counter()
                TT.featurize(stem_dev, img, (32, 32), dev)
                totals.append((time.perf_counter() - t) * 1e3)
        finally:
            for module, attr, fn in reversed(patched):
                setattr(module, attr, fn)
        p50 = {stage: statistics.median(ms) for stage, ms in stage_ms.items()}
        total = statistics.median(totals)
        rest = total - sum(p50[stage] for stage in top_stages)
        # each stage, then the stages inside it ("stage: part")
        parts = ", ".join(f"{stage} {p50[stage]:.2f}" for stage in sorted(
            p50, key=lambda st: (top_stages.index(st.split(":")[0]), st)))
        print(f"time training CLI featurize {h}x{w} u16 by stage (p50 ms over 5 images, "
              f"synchronised at each stage): total {total:.2f}; {parts}; the rest (uint8 "
              f"rescale, boundary gray, fetch, host) {rest:.2f} on {card}", flush=True)

    heavy = {"conv_leaky": (10, 2), "pool": (20, 3), "upsample": (20, 3)}
    for name, (kernel_fn, plain_fn, shape, inputs, ops, library_fn) in timed.items():
        outputs = kernel_fn()
        # the integer kernels: one operation per output element, a floor
        # (they sweep to a fixpoint) that leaves them bound by their bytes
        bounds[name] = bound(nbytes(inputs) + nbytes(outputs),
                             numel(outputs) if ops is None else ops)
        k_iters, p_iters = heavy.get(name, (20, 3))
        k, p, lib, runs = turns_ms(kernel_fn, plain_fn, k_iters, p_iters, library_fn)
        times[name] = (k, p, lib)
        dev_times[name] = (device_ms(kernel_fn, k_iters), device_ms(plain_fn, p_iters),
                           device_ms(library_fn, k_iters) if library_fn else None)
        lib_text = (f", library {lib:.4f} ms (runs {runs[4]:.4f}, {runs[5]:.4f})"
                    if lib is not None else "")
        dk, dp, dl = dev_times[name]
        dl_text = f", library {ms_text(dl)}" if library_fn else ""
        print(f"time {name} {shape}: kernel {k:.4f} ms (runs {runs[0]:.4f}, "
              f"{runs[1]:.4f}), plain {p:.4f} ms (runs {runs[2]:.4f}, {runs[3]:.4f})"
              f"{lib_text}, bound {bounds[name][0]:.4f} ms by {bounds[name][1]}; device "
              f"time (profiler) kernel {ms_text(dk)}, plain {ms_text(dp)}{dl_text} ms on {card}",
              flush=True)
    # pectoral_tail's bound (its I/O once against the operations it does
    # once) beside its design's floor and, for information, the plain
    # version's sweeps on these inputs; then both redesigned tails by step
    # and beside the one-block kernels they replaced, from a fresh process
    # (tail_device_times)
    floor_ms = KP.PLAN_BYTES * equ.numel() / HBM_BYTES_PER_S * 1e3
    sweep_ops = pectoral_sweep_ops(equ, high, breast)
    print(f"pectoral_tail B={BATCH} {HW}x{HW}: bound {bounds['pectoral_tail'][0]:.4f} ms by "
          f"{bounds['pectoral_tail'][1]} ({KP.ONCE_OPS} operations a pixel); the floor of this "
          f"design, {KP.PLAN_BYTES} bytes a pixel, {floor_ms:.4f} ms; the plain version's "
          f"sweeps on these inputs, information only: {sweep_ops} operations, "
          f"{sweep_ops / FP32_OPS_PER_S * 1e3:.4f} ms at the float32 peak, on {card}", flush=True)
    tail_run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--tail-device-times"], capture_output=True, text=True,
                              timeout=600)
    if tail_run.returncode != 0:
        raise AssertionError(f"the tails' device-time run failed:\n{tail_run.stderr[-4000:]}")
    tail_lines = tail_run.stdout.strip().splitlines()
    print("\n".join(tail_lines[:-1]), flush=True)
    tails = json.loads(tail_lines[-1])
    compared["pectoral_tail"] = [{"design_floor_ms": floor_ms,
                                  "plain_sweep_ops": sweep_ops}] + tails["pectoral_tail"]
    compared["gradcam_tail"] = [tails["gradcam_tail"]]
    # equalize and ccl at every path shape beside the one-block kernels they
    # replaced, from a fresh process (equalize_ccl_times); one B=1 3328x2560
    # equalize call's trace: its launches cover more than the card's 132
    # SMs, with one memset and no synchronising runtime call
    eqccl_run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                "--equalize-ccl-times"], capture_output=True, text=True,
                               timeout=600)
    if eqccl_run.returncode != 0:
        raise AssertionError(f"the equalize/ccl timing run failed:\n{eqccl_run.stderr[-4000:]}")
    eqccl_lines = eqccl_run.stdout.strip().splitlines()
    print("\n".join(eqccl_lines[:-1]), flush=True)
    eqccl = json.loads(eqccl_lines[-1])
    compared["equalize"] = eqccl["equalize"] + [{"trace": eqccl["equalize_trace"]}]
    compared["ccl"] = eqccl["ccl"]
    trace = eqccl["equalize_trace"]
    print(f"equalize at {trace['shape']}: the trace holds {len(trace['grids'])} kernel launches "
          f"with grids {trace['grids']}, {trace['memsets']} memset and {trace['launch_calls']} "
          f"launch and {trace['sync_calls']} synchronising runtime calls", flush=True)
    if (len(trace["grids"]) != 2 or trace["memsets"] != 1 or trace["sync_calls"]
            or any(g[0] * g[1] * g[2] <= 132 for g in trace["grids"])):
        raise AssertionError(f"equalize's trace at {trace['shape']} is not a memset and two "
                             f"launches of more than 132 blocks with no host sync: {trace}")
    # mode and jet_blend beside the kernels they replaced, from a fresh
    # process (mode_jet_times), which also asserts that one mode call at
    # B=3 62x62 and one jet_blend call at B=1 512x512 are one launch each
    # with no memset and no synchronising runtime call
    mj_run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--mode-jet-times"],
                            capture_output=True, text=True, timeout=600)
    if mj_run.returncode != 0:
        raise AssertionError(f"the mode/jet_blend timing run failed:\n{mj_run.stderr[-4000:]}")
    mj_lines = mj_run.stdout.strip().splitlines()
    print("\n".join(mj_lines[:-1]), flush=True)
    mj = json.loads(mj_lines[-1])
    compared["mode"] = mj["mode"] + [{"trace": mj["traces"]["mode"]}]
    compared["jet_blend"] = mj["jet_blend"] + [{"trace": mj["traces"]["jet_blend"]}]
    for name, trace in mj["traces"].items():
        print(f"{name} at {trace['shape']}: the trace holds {len(trace['grids'])} kernel launch "
              f"with grid {trace['grids']}, {trace['memsets']} memsets and {trace['sync_calls']} "
              f"synchronising runtime calls", flush=True)
    # the flood and the seeded component beside the one-block kernels they
    # replaced, from a fresh process (flood_seeded_times), which also
    # asserts that one flood call is one launch with no synchronising call
    # and that the seeded component launches no flood and nothing of one
    # block an image
    fs_run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                             "--flood-seeded-times"], capture_output=True, text=True,
                            timeout=900)
    if fs_run.returncode != 0:
        raise AssertionError(f"the flood/seeded timing run failed:\n{fs_run.stderr[-4000:]}")
    fs_lines = fs_run.stdout.strip().splitlines()
    print("\n".join(fs_lines[:-1]), flush=True)
    fs = json.loads(fs_lines[-1])
    compared.setdefault("flood", []).extend(fs["flood"])
    compared["flood"].append({"traces": {k: v for k, v in fs["traces"].items()
                                         if k.startswith("flood")}})
    compared.setdefault("largest_component_seeded", []).extend(
        fs["largest_component_seeded"] + [{"trace": fs["traces"]["seeded"]}])
    for name, trace in fs["traces"].items():
        print(f"{name} at {trace['shape']}: the trace holds {len(trace['grids'])} kernel "
              f"launches with grids {trace['grids']}, {trace['memsets']} memsets and "
              f"{trace['sync_calls']} synchronising runtime calls", flush=True)
    # the packed watershed beside its one-block kernel and its plain version,
    # and pectoral_tail beside its records, from a fresh process
    # (packed_watershed_times), which also asserts that a B=1 512x512 call
    # is three launches over tiles x images with no synchronising call; the
    # packed form's record row is its first (B=1 512x512)
    pw_run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                             "--packed-watershed-times"], capture_output=True, text=True,
                            timeout=900)
    if pw_run.returncode != 0:
        raise AssertionError(f"the packed watershed timing run failed:\n"
                             f"{pw_run.stderr[-4000:]}")
    pw_lines = pw_run.stdout.strip().splitlines()
    print("\n".join(pw_lines[:-1]), flush=True)
    pw = json.loads(pw_lines[-1])
    compared["watershed_packed"] = pw["watershed_packed"] + [{"trace": pw["trace"]}]
    compared.setdefault("pectoral_tail", []).extend(pw["pectoral_tail"])
    wp = pw["watershed_packed"][0]
    times["watershed_packed"] = (wp["ms"], wp["plain_ms"], None)
    bounds["watershed_packed"] = (wp["bound_ms"], wp["bound_by"])
    dev_times["watershed_packed"] = (wp["device_ms"], None, None)
    for row in pw["watershed_packed"]:
        old = (f", the rounds form to the fixpoint device {ms_text(row['old_device_ms'])}, "
               f"events {row['old_ms']:.4f} ({row['old_rounds']} rounds; its record "
               f"{row['record_device_ms']})" if "old_ms" in row else "")
        floor = f", floor {row['floor_ms']:.4f}" if "floor_ms" in row else ""
        print(f"time watershed_packed {row['shape']}: device {ms_text(row['device_ms'])} ms, "
              f"events {row['ms']:.4f}{old}, plain {row['plain_ms']:.4f}; {row['sweeps']} "
              f"sweeps (plain {row['plain_sweeps']}), bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}){floor} on {card}", flush=True)
    for row in pw["pectoral_tail"]:
        print(f"time pectoral_tail {row['shape']} with JAX's sweeps ({row['sweeps']}): device "
              f"{ms_text(row['device_ms'])} ms (rounds design {row['record_device_ms']}), events "
              f"{row['ms']:.4f} (rounds design {row['record_ms']}) on {card}", flush=True)
    cam6 = torch.from_numpy(rng.random((1, 6, 6)).astype(np.float32)).to(dev)
    hot6 = cam6 >= 0.6 * cam6.amax(dim=(1, 2), keepdim=True)
    lab6 = KC.label_components(hot6, 8)
    # conv_leaky at the other path shapes: (x, w, b, pad, what)
    conv_rows = []
    for (b, c, h, w), f, pad, nhwc, what in (
            ((8, 64, 32, 32), 128, 0, True, "basic layer 1, B=8, NHWC view (training)"),
            ((8, 64, 32, 32), 128, 0, False, "basic layer 1, B=8, NCHW"),
            ((8, 128, 15, 15), 64, 0, False, "basic layer 2, B=8 (training)"),
            ((64, 64, 32, 32), 128, 0, True, "basic layer 1, B=64, NHWC view (run_pipeline)"),
            ((64, 64, 32, 32), 128, 0, False, "basic layer 1, B=64, NCHW"),
            ((64, 128, 15, 15), 64, 0, False, "basic layer 2, B=64 (run_pipeline)"),
            ((32, 64, HW, HW), 32, 1, False, "advanced layer 1, B=32, SAME, NCHW"),
            ((32, 32, HW // 2, HW // 2), 64, 1, False, "advanced layer 2, B=32, SAME (training)"),
            ((1, 64, HW, HW), 32, 1, True, "advanced layer 1, B=1, SAME, NHWC view (serving)")):
        x = randn(b, h, w, c).permute(0, 3, 1, 2) if nhwc else randn(b, c, h, w)
        conv_rows.append((x, randn(f, c, 3, 3, scale=(2.0 / (9 * c)) ** 0.5),
                          randn(f, scale=0.1), pad, what))
    fl_big = border_flood(border_masks[(1536, 1280)])
    pu = torch.relu(randn(8, 16, HW, HW))
    l4_shape = (1, 2048, seg_h // 32, seg_w // 32)
    l4_x, l4_m = bn_inputs[l4_shape]
    l4_vec = tuple(t.detach() for t in (l4_m.weight, l4_m.bias, l4_m.running_mean,
                                        l4_m.running_var))
    extra = [
        ("ccl", lambda: KC.label_components(hot6, 8),
         lambda: KC.label_components_reference(hot6, 8), "B=1 6x6 (basic classify)", None),
        ("mode", lambda: KM.largest_component_mask(lab6, hot6),
         lambda: KM.largest_component_mask_reference(lab6, hot6), "B=1 6x6 (basic classify)",
         None),
    ] + [
        ("conv_leaky", lambda r=r: KCL.conv_leaky(r[0], r[1], r[2], 0.01, r[3]),
         lambda r=r: KCL.conv_leaky_reference(r[0], r[1], r[2], 0.01, r[3]),
         f"{r[4]}, {tuple(r[0].shape)} -> {r[1].shape[0]}",
         lambda r=r: F.conv2d(r[0], r[1], r[2], padding=r[3]), r[:3],
         2 * r[0].shape[0] * r[0].shape[1] * 9 * r[1].shape[0]
         * (r[0].shape[2] + 2 * r[3] - 2) * (r[0].shape[3] + 2 * r[3] - 2))
        for r in conv_rows
    ] + [
        ("flood", lambda: KFl.flood_from(*fl_big), lambda: KFl.flood_from_reference(*fl_big),
         "border flood of fill_holes, B=1 1536x1280 suppress-site background", None,
         fl_big, None),
        ("pool", lambda: KPool.pool(pa, 2, "mean"), lambda: KPool.pool_reference(pa, 2, "mean"),
         f"mean 2x2, B=32 32x{HW}x{HW}", lambda: F.avg_pool2d(pa, 2)),
        ("pool", lambda: KPool.pool(pu, 2, "max"), lambda: KPool.pool_reference(pu, 2, "max"),
         f"max 2x2, U-Net first level B=8 16x{HW}x{HW}", lambda: F.max_pool2d(pu, 2)),
        ("batchnorm", lambda: KBN.batchnorm(l4_x, *l4_vec),
         lambda: KBN.batchnorm_reference(l4_x, *l4_vec), f"ResNet-50 layer4, {l4_shape}",
         lambda: F.batch_norm(l4_x, l4_vec[2], l4_vec[3], l4_vec[0], l4_vec[1],
                              training=False, eps=1e-5)),
        ("jet_blend", lambda: KOv.jet_blend(tail_k[1], tail_in[2]),
         lambda: KOv.jet_blend_reference(tail_k[1], tail_in[2]),
         f"B={BATCH} {HW}x{HW} gray (the pipeline's heatmaps)", None),
    ]
    # a row of 7 fields also gives its inputs and operations, for its bound
    for name, kernel_fn, plain_fn, shape, library_fn, *bound_of in extra:
        with full_fp32():
            k, p, lib, runs = turns_ms(kernel_fn, plain_fn, 20, 3, library_fn)
            dk, dp = device_ms(kernel_fn, 20), device_ms(plain_fn, 3)
            dl = device_ms(library_fn, 20) if library_fn else None
        lib_text = f", library {lib:.4f} ms" if lib is not None else ""
        dl_text = f", library {ms_text(dl)}" if library_fn else ""
        bound_text = ""
        if bound_of:
            outputs = kernel_fn()
            b_ms, b_by = bound(nbytes(bound_of[0]) + nbytes(outputs),
                               numel(outputs) if bound_of[1] is None else bound_of[1])
            bound_text = f", bound {b_ms:.4f} ms by {b_by}"
        print(f"time {name} {shape}: kernel {k:.4f} ms (runs {runs[0]:.4f}, "
              f"{runs[1]:.4f}), plain {p:.4f} ms (runs {runs[2]:.4f}, {runs[3]:.4f})"
              f"{lib_text}{bound_text}; device time (profiler) kernel {ms_text(dk)}, plain "
              f"{ms_text(dp)}{dl_text} ms on {card}", flush=True)

    # ms per training step of each configuration, after warmup
    step_cases = {}
    for name, cfg, b in (("basic SGD", BT.BASIC, 8), ("advanced Adam", BT.ADVANCED, 32)):
        m = cnn.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
        x = torch.from_numpy(Xb[:b] if cfg is BT.BASIC else Xa[:b]).to(dev)
        y = torch.from_numpy(eye[(yb if cfg is BT.BASIC else ya)[:b]]).to(dev)
        mask = torch.ones(b, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        if cfg is BT.BASIC:
            step_cases[name] = (lambda m=m, x=x, y=y, mask=mask, gen=gen:
                                step.sgd_train_step(m, x, y, mask, 0.01, gen), b, 20)
        else:
            tx = optim.adam(1e-3)
            adam_step, state = step.make_adam_train_step(tx), [tx.init(m.parameters())]

            def run_adam(m=m, x=x, y=y, mask=mask, gen=gen, adam_step=adam_step,
                         state=state):
                state[0], _ = adam_step(m, state[0], x, y, mask, gen)
            step_cases[name] = (run_adam, b, 5)
    um = unet.init_unet(torch.Generator().manual_seed(0), BT.UNET, device=dev)
    utx = optim.adam(1e-3)
    useg, ustate = segmentation.make_seg_train_step(utx), [utx.init(um.parameters())]
    xu8, yu8 = torch.from_numpy(Xu[:8]).to(dev), torch.from_numpy(Yu[:8]).to(dev)

    def run_unet():
        ustate[0], _ = useg(um, ustate[0], xu8, yu8)
    step_cases["U-Net Adam"] = (run_unet, 8, 10)
    step_ms = {}
    for name, (fn, b, iters) in step_cases.items():
        step_ms[name] = cuda_ms(fn, iters, warmup=2)
        print(f"time training step {name} B={b}: {step_ms[name]:.3f} ms/step on {card}",
              flush=True)

    pipe_ms = cuda_ms(lambda: fused.run_pipeline(params, big_batch, config), 5)
    pipe_dev = device_ms(lambda: fused.run_pipeline(params, big_batch, config), 5)
    print(f"time run_pipeline B={BATCH} {HW}x{HW}: {pipe_ms:.3f} ms/batch, "
          f"{BATCH / (pipe_ms / 1e3):.1f} img/s, device time (profiler) {ms_text(pipe_dev)} "
          f"ms/batch on {card}", flush=True)
    engine_p50 = {}   # phase 9 prints the front's route p50s beside these
    for name, img in uploads.items():
        ms = p50_ms(lambda: eng.process_single_image(img, cache_token=name), N_TIMED)
        engine_p50[f"process_single_image {name}"] = ms
        print(f"time process_single_image {name}: p50 {ms:.3f} ms over {N_TIMED} "
              f"requests on {card}", flush=True)
    # the 512² upload split by stage, as the CLI's featurize above
    img512 = uploads["512x512 u8"]
    eng.process_single_image(img512)
    stage_ms.clear()
    totals = []
    patched = [staged(cleaner, "cleaner_front", "cleaner_front"),
               staged(cleaner, "remove_pectoral", "pectoral removal"),
               staged(cleaner, "equalize_hist", "pectoral removal: equalize"),
               staged(cleaner, "pectoral_tail", "pectoral removal: pectoral_tail"),
               staged(E, "resize_area", "resize_area to 512x512"),
               staged(unet, "encoder_first_features", "conv1")]
    try:
        for _ in range(N_TIMED):
            t = time.perf_counter()
            eng.process_single_image(img512)
            totals.append((time.perf_counter() - t) * 1e3)
    finally:
        for module, attr, fn in reversed(patched):
            setattr(module, attr, fn)
    p50 = {stage: statistics.median(ms) for stage, ms in stage_ms.items()}
    total = statistics.median(totals)
    rest = total - sum(ms for stage, ms in p50.items() if ":" not in stage)
    print(f"time process_single_image 512x512 u8 by stage (p50 ms over {N_TIMED} requests, "
          f"synchronised at each stage): total {total:.3f}; "
          + ", ".join(f"{stage} {ms:.3f}" for stage, ms in p50.items())
          + f"; the rest (upload, uint8 rescale, boundary gray, fetches, host) {rest:.3f} on "
          f"{card}", flush=True)
    for pipeline in ("basic", "advanced"):
        ms = p50_ms(lambda: eng.classify_and_roi(feats[token], pipeline, (0, 1),
                                                 cache_token=token), N_TIMED)
        engine_p50[f"classify_and_roi {pipeline}"] = ms
        print(f"time classify_and_roi {pipeline} (0, 1), cached features: p50 "
              f"{ms:.3f} ms over {N_TIMED} requests on {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ms = p50_ms(lambda: ref_eng.write_gradcam_overlays(fg, cg, tmp, (0, 1)), N_TIMED)
    print(f"time write_gradcam_overlays, reference ResNet-50 Grad-CAM (fc 1000), "
          f"{seg_h}x{seg_w} display, classes (0, 1), PNGs included: p50 {ms:.3f} ms over "
          f"{N_TIMED} requests on {card}", flush=True)
    # the same request's device work alone (forward, head backwards,
    # resizes, jet_blends; no host fetch, no PNG)
    r50_dev, disp_dev = ref_eng.gradcam_resnet[1], torch.from_numpy(cg).to(dev)

    def reference_compute():
        cams = TG.resnet_gradcam_cams(r50_dev, TG.imagenet_input_from_gray(disp_dev), (0, 1))
        return [TG._reference_tail(cam, disp_dev, (seg_h, seg_w)) for cam in cams]

    ms = p50_ms(reference_compute, N_TIMED)
    print(f"time reference Grad-CAM compute only (no fetch, no PNG): p50 {ms:.3f} ms, "
          f"device time (profiler) {ms_text(device_ms(reference_compute, N_TIMED))} ms on {card}",
          flush=True)
    for b in eng._batchers.values():
        b.close()

    phase_done("8")

    # ---- 9. the HTTP front ------------------------------------------------------
    t9 = time.perf_counter()
    front_launches = front_phase(uploads, engine_p50, zero_counts, read_counts, card)
    print(f"front phase: {time.perf_counter() - t9:.1f} s", flush=True)
    phase_done("9")

    # ---- 10. the packed watershed's sweep cap ------------------------------------
    # serpentines where JAX's 256-sweep cap binds, through the packed form
    # and through the pectoral tail's relaxation (the same sweeps on a
    # uint8 image): bit-exact against the plain version capped at 256
    # sweeps, the sweeps run printed
    values = (255, 128, 64)
    for side in SERPENTINE_SIDES:
        s_img, s_mk = watershed_serpentine(side, dev)
        sweeps_t = torch.zeros(1, dtype=torch.int32, device=dev)
        out_l = torch.empty_like(s_mk)
        out_b = torch.empty(s_img.shape, dtype=torch.bool, device=dev)
        KW.packed_form(s_img, s_mk, values, out_l, out_b, 256, 8, sweeps=sweeps_t)
        plain = KW.marker_watershed_reference(s_img, s_mk, 256, 8, values)
        agree("watershed_packed", out_l, plain[0], f"serpentine {side}x{side}, labels, cap 256")
        agree("watershed_packed", out_b, plain[1], f"serpentine {side}x{side}, ridge, cap 256")
        n_plain = plain_packed_sweeps(s_img, s_mk, values, 256, 8)
        print(f"sweep cap: serpentine {side}x{side} packed form ran {int(sweeps_t.item())} "
              f"sweeps, the plain version {n_plain}", flush=True)
        if int(sweeps_t.item()) != n_plain:
            raise AssertionError("the packed form's sweeps differ from the plain version's")
        # the pectoral tail on the serpentine as its equalized image: its
        # markers from a top-left quarter object, breast all but a column
        equ_s = s_img.to(torch.uint8)
        bin_s = torch.zeros_like(equ_s)
        bin_s[:, : side // 2, : side // 2] = 255
        breast_s = torch.full_like(equ_s, 255)
        breast_s[:, :, -1] = 0
        for cap in (1, 3, 256):
            got = KP.run_plan(equ_s, bin_s, breast_s, ws_max_iters=cap, sweeps=sweeps_t)
            want = KP.pectoral_tail_reference(equ_s, bin_s, breast_s, max_iters=side * side,
                                              ws_max_iters=cap)
            for part, a, b in zip(("labels", "boundary", "mask"), got, want):
                agree("pectoral_tail", a, b, f"serpentine {side}x{side}, {part}, ws cap {cap}")
            print(f"sweep cap: pectoral_tail on the {side}x{side} serpentine, cap {cap}: "
                  f"{int(sweeps_t.item())} sweeps", flush=True)
    # phase 4b's inputs' cleaner markers: the packed form at the cleaner's cap
    for name, (b, side, seed) in {"B=8 512x512": (8, 512, 40),
                                  f"B={BATCH} {HW}x{HW}": (BATCH, HW, 50)}.items():
        x = torch.from_numpy(synthetic_mammograms(b, side, seed=seed)).to(dev)
        _, _, _, equ_e, high_e, breast_e = clean_stage_inputs(x)
        mk_e = pectoral_markers(equ_e, high_e, breast_e)
        img_e = equ_e.to(torch.float32)
        sweeps_t = torch.zeros(1, dtype=torch.int32, device=dev)
        out_l = torch.empty_like(mk_e)
        out_b = torch.empty(img_e.shape, dtype=torch.bool, device=dev)
        KW.packed_form(img_e, mk_e, values, out_l, out_b, 256, 8, sweeps=sweeps_t)
        plain = KW.marker_watershed_reference(img_e, mk_e, 256, 8, values)
        agree("watershed_packed", out_l, plain[0], f"cleaner markers {name}, labels")
        agree("watershed_packed", out_b, plain[1], f"cleaner markers {name}, ridge")
        print(f"sweep cap: cleaner markers {name}: {int(sweeps_t.item())} sweeps, the plain "
              f"version {plain_packed_sweeps(img_e, mk_e, values, 256, 8)}", flush=True)
    phase_done("10")

    # ---- 11. bfloat16 training at full width -------------------------------------
    # one epoch (two Adam steps, B=32) of the advanced configuration with
    # the conv stack and the device dataset in bf16, beside the same epoch
    # in float32 on the card, its launches exact. Adam's first update moves
    # every parameter by about lr * sign(g), so where a gradient's bf16
    # rounding straddles 0 the two runs part, and across the 67M-weight
    # dense layer the second step's loss differs by whole units (3.82
    # against 4.99 on an H100): the losses are printed, and held where the
    # two runs start from the same weights. At those initial
    # weights the bf16 forward's loss on the epoch's first batch within
    # 1e-3 of float32's (measured 3.6e-5 and 7.8e-5 on two batches; JAX's
    # own bf16-against-f32 bound is 0.05), its logits within 2e-2 of their
    # largest magnitude (measured 0.5%); a basic SGD epoch (B=8, 8 steps) in
    # bf16 within 2e-3 of float32's loss (measured 3.3e-4). The bf16 conv
    # form against its plain version at every layer shape of that run and
    # the basic classifier's (to 2^-6 of the plain output's largest value:
    # both round float32 sums taken in other orders to bf16, twice, so an
    # output may land a bf16 step or two away); the training CLI with
    # --bf16-compute
    n11 = 64
    cfg11 = dataclasses.replace(BT.ADVANCED, dropout_rate=0.0)
    init11 = cnn.init_params(torch.Generator().manual_seed(0), cfg11, device=dev)
    x11 = torch.from_numpy(Xa[:32]).to(dev)
    y11 = torch.from_numpy(eye[ya[:32]]).to(dev)
    with torch.no_grad(), full_fp32():
        logit_f, logit_b = (cnn.apply(init11, x11, compute_dtype=dt) for dt in (None, torch.bfloat16))
        first_f, first_b = (float(cnn.loss_fn(init11, x11, y11, compute_dtype=dt))
                            for dt in (None, torch.bfloat16))
    logit_err = float((logit_f - logit_b).abs().max())
    logit_top = float(logit_f.abs().max())
    del init11, x11, y11
    fits11 = {}
    zero_counts()
    for dt in (torch.bfloat16, None):
        fits11[dt] = step.fit(
            cnn.init_params(torch.Generator().manual_seed(0), cfg11),
            Xa[:n11], eye[ya[:n11]], Xa[n11:], ya[n11:], epochs=1, lr=1e-3, batch_size=32,
            optimizer="adam", device_data=True, device_data_dtype=dt, compute_dtype=dt,
            device=dev)
        if dt is not None:
            bf16_launches = read_counts()
    basic11 = {dt: step.fit(cnn.init_params(torch.Generator().manual_seed(1),
                                            dataclasses.replace(BT.BASIC, dropout_rate=0.0)),
                            Xb[:n11], eye[yb[:n11]], Xb[n11:], yb[n11:], epochs=1, lr=0.01,
                            batch_size=8, optimizer="sgd", compute_dtype=dt, device=dev)
               for dt in (torch.bfloat16, None)}
    loss_b, loss_f = fits11[torch.bfloat16].history[0]["loss"], fits11[None].history[0]["loss"]
    basic_b, basic_f = (basic11[dt].history[0]["loss"] for dt in (torch.bfloat16, None))
    print(f"bf16 training: advanced at its initial weights, B=32: loss bf16 {first_b} vs "
          f"float32 {first_f} (tolerance 1e-3), logits max_abs_err {logit_err} of "
          f"{logit_top} (tolerance 2e-2 of it); one advanced Adam epoch ({n11 // 32} steps): "
          f"loss bf16 {loss_b}, float32 {loss_f} (apart after Adam's first update); one basic "
          f"SGD epoch (B=8): loss bf16 {basic_b} vs float32 {basic_f} (tolerance 2e-3); "
          f"launches of the bf16 Adam epoch {bf16_launches}", flush=True)
    # a conv stack (two conv blocks) a step and one for the test batch
    want11 = {name: 0 for name in wrappers}
    want11.update(conv_leaky_bf16=2 * (n11 // 32), conv_leaky=2, pool=2 * (n11 // 32 + 1))
    if bf16_launches != want11:
        raise AssertionError(f"bf16 training launches {bf16_launches}, expected {want11}")
    if not (abs(first_b - first_f) <= 1e-3 and logit_err <= 2e-2 * logit_top
            and abs(basic_b - basic_f) <= 2e-3 and np.isfinite(loss_b)):
        raise AssertionError("bf16 training is not within its tolerances of float32")
    for a in fits11[torch.bfloat16].model.parameters():
        if a.dtype != torch.float32 or not bool(torch.isfinite(a).all()):
            raise AssertionError("bf16 training left parameters not float32 or not finite")
    bgen = torch.Generator(device=dev).manual_seed(11)

    def brandn(*shape, scale=1.0):
        return torch.randn(shape, generator=bgen, device=dev) * scale

    # (what, x, F, k, pad, the function's operations): the advanced layers
    # at B=32 (layer 1 on the NHWC view of the device batch, layer 2 on the
    # pool's NCHW output), the test batch's B=16, and the basic layers at B=8
    bf16_shapes = []
    for what, shape, f, k, pad, nhwc in (
            ("advanced layer 1, B=32 (training)", (32, 256, 256, 64), 32, 3, 1, True),
            ("advanced layer 2, B=32 (training)", (32, 32, 128, 128), 64, 3, 1, False),
            ("advanced layer 1, B=16 (the test batch)", (16, 256, 256, 64), 32, 3, 1, True),
            ("advanced layer 2, B=16 (the test batch)", (16, 32, 128, 128), 64, 3, 1, False),
            ("basic layer 1, B=8", (8, 32, 32, 64), 128, 3, 0, True),
            ("basic layer 2, B=8", (8, 128, 15, 15), 64, 3, 0, False)):
        x = brandn(*shape).to(torch.bfloat16)
        x = x.permute(0, 3, 1, 2) if nhwc else x
        c = x.shape[1]
        w = brandn(f, c, k, k, scale=(2.0 / (c * k * k)) ** 0.5).to(torch.bfloat16)
        b = brandn(f, scale=0.1)
        got = KCL.conv_leaky_bf16(x, w, b, 0.01, pad)
        want = KCL.conv_leaky_bf16_reference(x, w, b, 0.01, pad)
        torch.cuda.synchronize()
        err = max_abs_err(got.float(), want.float())
        tol = 2.0 ** -6 * float(want.float().abs().max())
        errs["conv_leaky_bf16"] = max(errs["conv_leaky_bf16"], err)
        differ = float((got != want).float().mean())
        print(f"check conv_leaky_bf16 [{what}]: max_abs_err {err} (tolerance 2^-6 of the plain "
              f"output's largest, {tol}); outputs that differ {differ}", flush=True)
        if err > tol or got.dtype != torch.bfloat16:
            raise AssertionError(f"conv_leaky_bf16 [{what}] disagrees with its plain version")
        oh, ow = got.shape[2:]
        ops = 2 * shape[0] * oh * ow * f * c * k * k
        bf16_shapes.append((what, x, w, b, pad, got, ops))
    bf16_rows = []
    for what, x, w, b, pad, out, ops in bf16_shapes:
        if "test batch" in what:
            continue
        k_ms, p_ms, l_ms, runs = turns_ms(
            lambda: KCL.conv_leaky_bf16(x, w, b, 0.01, pad),
            lambda: KCL.conv_leaky_bf16_reference(x, w, b, 0.01, pad), 10, 3,
            lambda: F.conv2d(x, w, padding=pad))
        t_bytes = (nbytes((x, w, b)) + nbytes(out)) / HBM_BYTES_PER_S
        t_ops = ops / BF16_OPS_PER_S
        row = {"shape": what, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "device_ms": device_ms(lambda: KCL.conv_leaky_bf16(x, w, b, 0.01, pad), 5),
               "library_device_ms": device_ms(lambda: F.conv2d(x, w, padding=pad), 5),
               "runs_ms": runs, "card": card}
        bf16_rows.append(row)
        print(f"time conv_leaky_bf16 {what}: {k_ms:.4f} ms (device {ms_text(row['device_ms'])}), "
              f"plain {p_ms:.4f}, F.conv2d bf16 {l_ms:.4f} (device "
              f"{ms_text(row['library_device_ms'])}), bound {row['bound_ms']:.4f} by "
              f"{row['bound_by']} on {card}", flush=True)
    top11 = bf16_rows[0]
    times["conv_leaky_bf16"] = (top11["ms"], top11["plain_ms"], top11["library_ms"])
    bounds["conv_leaky_bf16"] = (top11["bound_ms"], top11["bound_by"])
    dev_times["conv_leaky_bf16"] = (top11["device_ms"], None, top11["library_device_ms"])
    compared["conv_leaky_bf16"] = bf16_rows
    # the training CLI with --bf16-compute, one epoch on small DICOMs
    with tempfile.TemporaryDirectory() as tmp:
        rows_csv = ["dicom_file_path,pathology"]
        crng = np.random.default_rng(5)
        for i in range(24):
            im = crng.normal(1000, 150, (48, 48)).clip(0, 4095)
            if i % 2:
                im[14:34, 14:34] += 1200
            pth = os.path.join(tmp, f"c{i}.dcm")
            TDicom.dcmwrite_minimal(pth, im.clip(0, 4095).astype(np.uint16), f"P{i}")
            rows_csv.append(f"{pth},{'MALIGNANT' if i % 2 else 'BENIGN'}")
        csv_path = os.path.join(tmp, "mapping.csv")
        Path(csv_path).write_text("\n".join(rows_csv) + "\n")
        zero_counts()
        cli11 = TT.main(["--csv", csv_path, "--out-dir", os.path.join(tmp, "out"),
                         "--pipeline", "advanced", "--features", "raw", "--resize", "24",
                         "--epochs", "1", "--batch-size", "8", "--conv-layers", "4x3",
                         "--hidden-units", "16", "--dropout", "0.0", "--bf16-compute"])
        cli11_launches = read_counts()
        print(f"training CLI --bf16-compute: 1 epoch on 24 DICOMs at 48x48, device "
              f"{cli11['training']['device']}, test accuracy "
              f"{cli11['evaluation']['test_accuracy']}; launches {cli11_launches}", flush=True)
        if (not cli11_launches["conv_leaky_bf16"] or cli11["training"]["device"] != "cuda"
                or not os.path.exists(os.path.join(tmp, "out", "cnn_model_advanced.npz"))):
            raise AssertionError("the training CLI's --bf16-compute run is wrong")
    phase_done("11")

    # ---- 12. the compat API and the profiling tools on the card -------------------
    from cadx_tpu_torch import compat as TCompat
    from cadx_tpu_torch.compat import adcnnm as TAD
    from cadx_tpu_torch.tools import trace_summary as TTS
    from cadx_tpu_torch.utils import profiling as TProf

    crng = np.random.default_rng(12)
    yc = crng.integers(0, 2, 48)
    Xc = crng.standard_normal((48, 12, 12, 2)).astype(np.float32) * 0.1
    Xc[yc == 1, 3:7, 3:7, :] += 2.0
    cm = TCompat.CNNModel(input_shape=(12, 12, 2), num_classes=2, conv_layers=[(4, 3)],
                          hidden_units=[16], dropout_rate=0.0)
    res12 = cm.train(Xc, eye[yc], Xc[:16], yc[:16], epochs=3, lr=0.05, batch_size=16,
                     log=lambda m: None)
    cls12, probs12 = cm.predict(Xc[0])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cnn_model.npz")
        cm.save_model(path)
        back12 = TCompat.load_weights(TCompat.CNNModel, path)
        same12 = np.array_equal(back12.forward(Xc[0], training=False),
                                cm.forward(Xc[0], training=False))
        trainer = TCompat.ModelTrainer(cm)
        cv12 = trainer.cross_validate(Xc, yc, n_splits=2, epochs=1, lr=0.05, batch_size=8)
        tu = TCompat.tiny_unet((16, 16, 1))
        tu.compile(learning_rate=3e-3)
        hist12 = tu.fit(np.random.default_rng(3).random((16, 16, 16, 1)).astype(np.float32),
                        epochs=1, batch_size=8)
        xai = TCompat.ExplainableAI(cm)
        hm12 = xai.generate_heatmap(Xc[1], class_idx=1)
        ov12 = xai.overlay_heatmap(crng.integers(0, 256, (32, 32), dtype=np.uint8))
        # the advanced exporter's round trip through the loader
        adv_cfg = dataclasses.replace(BT.ADVANCED, dropout_rate=0.0)
        adv = cnn.init_params(torch.Generator().manual_seed(4), adv_cfg, device=dev)
        pth = os.path.join(tmp, "advanced.pth")
        TAD.save_trained_model(adv, adv_cfg, pth)
        adv_back = TAD.params_from_torch_state_dict(torch.load(pth, weights_only=True),
                                                    adv_cfg, dev)
        same_adv = all(torch.equal(a, c) for a, c in zip(adv_back.parameters(),
                                                         adv.parameters()))
        # one run_pipeline batch in a trace() window, summarised
        trace_dir = os.path.join(tmp, "trace")
        with TProf.trace(trace_dir):
            fused.run_pipeline(params, batches[0], config)
        rows12, total12 = TTS.summarize(trace_dir, top=8)
        whole12 = TTS.completeness(TTS.load_events(trace_dir))
    print(f"compat: CNNModel trained 3 epochs on the card, best_val_acc {res12.best_val_acc}, "
          f"predict {cls12} {probs12}; save_model -> load_weights same output {same12}; "
          f"ModelTrainer.cross_validate 2 folds {cv12.fold_accuracies}; TinyUNetModel.fit "
          f"2 steps mse {hist12}; ExplainableAI heatmap {hm12.shape} in "
          f"[{hm12.min()}, {hm12.max()}], overlay {ov12.shape} {ov12.dtype}; the advanced "
          f"exporter's round trip bit-exact {same_adv}", flush=True)
    print(f"trace_summary of one run_pipeline batch (B={BATCH} {HW}x{HW}) on {card}: total "
          f"device {total12:.3f} ms; window {'complete' if whole12['complete'] else 'incomplete'}"
          f" ({whole12['launches']} launches, {whole12['kernels']} kernel records)", flush=True)
    for name, ms, n in rows12:
        print(f"  {ms:10.3f} ms {n:5d}  {name[:90]}", flush=True)
    if not (same12 and same_adv and res12.best_val_acc >= 0.9 and len(hist12) == 1
            and np.isfinite(hist12[0]) and hm12.min() >= 0.0 and hm12.max() <= 1.0
            and ov12.shape == (32, 32, 3) and len(cv12.fold_accuracies) == 2
            and total12 > 0 and rows12):
        raise AssertionError("the compat API or the profiling tools failed on the card")
    phase_done("12")
    by_path = {"pipeline": pipe_launches, "serving": serve_launches,
               "reference_gradcam": ref_launches, "training": train_launches,
               "training_cli": cli_launches, "front": front_launches,
               "even_kernel_process": even_launches, "training_bf16": bf16_launches}
    # the seeded component lies on no path (as in JAX): 0 on each
    own_path = {"conv_leaky": "training", "pool": "training", "upsample": "training",
                "batchnorm": "reference_gradcam", "jet_blend": "reference_gradcam",
                "gradcam_tail": "pipeline", "cleaner_front": "training_cli",
                "largest_component_seeded": "training_cli",
                "watershed_packed": "even_kernel_process",
                "conv_leaky_bf16": "training_bf16"}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1],
         "launches": by_path[own_path.get(name, "serving")][name],
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
         "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": times[name][2], "device_ms": dev_times[name][0],
         "plain_device_ms": dev_times[name][1], "library_device_ms": dev_times[name][2],
         **({"compared_with": compared[name]} if name in compared else {})}
        for name in wrappers]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--batchnorm-device-times"]:
        sys.exit(batchnorm_device_times())
    if sys.argv[1:] == ["--tail-device-times"]:
        sys.exit(tail_device_times())
    if sys.argv[1:] == ["--equalize-ccl-times"]:
        sys.exit(equalize_ccl_times())
    if sys.argv[1:] == ["--mode-jet-times"]:
        sys.exit(mode_jet_times())
    if sys.argv[1:] == ["--flood-seeded-times"]:
        sys.exit(flood_seeded_times())
    if sys.argv[1:] == ["--packed-watershed-times"]:
        sys.exit(packed_watershed_times())
    sys.exit(main())
