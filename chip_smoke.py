#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`cadx_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):
1. build the nine CUDA kernels from `cadx_tpu_torch/csrc` (one nvcc per
   source, all at once);
2. hold each kernel bit-exact against its plain PyTorch version on the
   card (the plain versions run uncapped, max_iters = H*W, since the
   kernels run to the fixpoint; the pair-form watershed, which has no
   float32 fixpoint at real sizes, runs the same 256 sweeps in both):
   - equalize, largest_obj, pectoral_tail: synthetic mammograms (B=16,
     256²) and random masks;
   - the cleaner's inputs at every shape the serving phase gives the
     kernels, made from the same images: the 3328x2560 upload bucketed to
     1536x1280 and the 1024x832 upload (B=1; equalize, largest_obj at its
     three sites, pair-form watershed, ccl and mode), the 512² upload
     (B=1) and the classify_batch batch (B=8, 512²; equalize, largest_obj
     at its two sites, pectoral_tail);
   - ccl, mode and watershed (packed and pair form) on random masks and
     markers at 256² (B=16), and ccl and mode at the serving CAM shapes;
   - conv_leaky at the shapes of the training, pipeline and serving
     classifiers' conv layers (VALID and SAME), to max |d| <= 1e-5 *
     max |plain| + 1e-6 (float32 sums of <= 1,152 terms in another order);
     the pool kernel (max and mean, sizes 2 and 3, odd sides, float32 and
     bfloat16) and upsample (factor 2) bit-exact; both max-pool backward
     rules (tie-broadcast, first maximum) on the card against the CPU,
     bit-exact;
3. the fused pipeline: `run_pipeline` at 256² with the full-width
   classifier on seeded weights, three batches of B=64; launches 2
   (largest_obj), 1 (equalize), 1 (pectoral_tail), 4 (conv_leaky) and 4
   (pool) per batch and none of the serving kernels or upsample;
4. the fused pipeline on a B=2 batch on the card and on the CPU: clean_u8
   exact, probs 2e-5, features 1e-5, heatmaps and overlays +-2 u8;
5. serving at full width, `EngineConfig()` defaults, seeded weights:
   warmup, then uploads of a 3328x2560 uint16 native (cleaned at the
   1536x1280 bucket, pair-form watershed), a 1024x832 uint8 native
   (cleaned at native size, composed pectoral branch) and a 512² image
   (fused tail); per pipeline classify, classify_and_roi (0, 1) and the
   overlay PNGs; eight concurrent micro-batched classify calls;
   classify_batch on B=8 at 512². The exact launch count of each of the
   nine kernels is asserted;
6. one 640x544 request on the card and on a CPU engine with the same
   weights: clean exact, features 1e-5, probs 2e-5, ROI boxes within one
   CAM cell, heatmaps +-2 u8, overlays +-2 u8 where the heatmaps agree,
   within the bound the JET table's slope gives at a heatmap step, and
   +-2 u8 at the 99th percentile of all overlay values;
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
8. times with CUDA events: each kernel beside its plain version (256²
   B=64 for the fused-pipeline kernels, the serving shapes for ccl, mode
   and watershed, the training shapes for conv_leaky, pool and upsample)
   and, for the last three, beside the one PyTorch call that computes
   the same function; each kernel's bound on this card (the larger of
   its bytes over 3.35 TB/s and its operations over 67 TFLOP/s, the
   H100 SXM's HBM3 rate and float32 peak); ms per training step of each
   configuration; the pipeline's images per second; and the p50 of
   process_single_image per upload shape and of classify_and_roi per
   pipeline over 10 requests after warmup.

The last line of standard output is {"ok": true, "device": {...}}; the
line before it is the per-kernel JSON record. Imports torch, numpy and
the port only.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
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
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM3 bytes/s and float32
# FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


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


def turns_ms(kernel_fn, plain_fn, k_iters: int, p_iters: int, library_fn=None):
    """Kernel, plain and library times, in turns plain, library, kernel,
    kernel, library, plain (library None where there is no library_fn)."""
    p1 = cuda_ms(plain_fn, p_iters)
    l1 = cuda_ms(library_fn, k_iters) if library_fn else None
    k1 = cuda_ms(kernel_fn, k_iters)
    k2 = cuda_ms(kernel_fn, k_iters)
    l2 = cuda_ms(library_fn, k_iters) if library_fn else None
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.nn.functional as F

    from cadx_tpu_torch import checkpoint
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import ccl as KC
    from cadx_tpu_torch.kernels import conv_leaky as KCL
    from cadx_tpu_torch.kernels import equalize as KE
    from cadx_tpu_torch.kernels import largest_obj as KL
    from cadx_tpu_torch.kernels import mode as KM
    from cadx_tpu_torch.kernels import pectoral as KP
    from cadx_tpu_torch.kernels import pool as KPool
    from cadx_tpu_torch.kernels import upsample as KUp
    from cadx_tpu_torch.kernels import watershed as KW
    from cadx_tpu_torch.models import cnn, unet
    from cadx_tpu_torch.ops import pool as TPool
    from cadx_tpu_torch.ops.colormap import apply_jet
    from cadx_tpu_torch.ops.morphology import dilate, erode
    from cadx_tpu_torch.ops.resize import resize_area
    from cadx_tpu_torch.ops.threshold import (binary_threshold,
                                              relative_threshold_value, to_uint8)
    from cadx_tpu_torch.pipeline import fused
    from cadx_tpu_torch.precision import full_fp32
    from cadx_tpu_torch.preprocess import cleaner
    from cadx_tpu_torch.serve import engine as E
    from cadx_tpu_torch.synthetic import (synthetic_mammograms,
                                          synthetic_native_mammogram)
    from cadx_tpu_torch.tools import bench_train as BT
    from cadx_tpu_torch.train import optim, segmentation, step

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    modules = {"largest_obj": KL, "equalize": KE, "pectoral_tail": KP,
               "ccl": KC, "mode": KM, "watershed": KW, "conv_leaky": KCL,
               "pool": KPool, "upsample": KUp}
    wrappers = {"largest_obj": KL.largest_obj, "equalize": KE.equalize,
                "pectoral_tail": KP.pectoral_tail, "ccl": KC.label_components,
                "mode": KM.largest_component_mask, "watershed": KW.marker_watershed,
                "conv_leaky": KCL.conv_leaky, "pool": KPool.pool,
                "upsample": KUp.upsample_nearest}

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
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}", flush=True)

    phase_done("1")

    # ---- 2. each kernel against its plain version, on the card --------------
    def clean_stage_inputs(batch):
        """The inputs the cleaner hands each kernel (launches not counted)."""
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
        pect = cleaner.select_largest_obj(high, 255, fill_holes_=True)
        markers = torch.zeros(equ.shape, dtype=torch.int32, device=equ.device)
        markers = torch.where(erode(pect, 3, 7) > 0, 255, markers)
        markers = torch.where(dilate(pect, 3, 7) == 0, 128, markers)
        return torch.where(breast == 0, 64, markers)

    errs = {name: 0.0 for name in wrappers}

    def agree(name, kernel_out, plain_out, what):
        torch.cuda.synchronize()
        err = max_abs_err(kernel_out, plain_out)
        errs[name] = max(errs[name], err)
        print(f"check {name} [{what}]: max_abs_err {err} (tolerance 0, bit-exact)",
              flush=True)
        if err != 0.0:
            raise AssertionError(f"{name} [{what}] disagrees with its plain version")

    rng = np.random.default_rng(0)
    small = torch.from_numpy(synthetic_mammograms(16, HW, seed=1)).to(dev)
    rand_masks = torch.from_numpy(rng.random((16, HW, HW)) > 0.55).to(dev)
    rand_u8 = torch.from_numpy(rng.integers(0, 256, (16, HW, HW)).astype(np.uint8)).to(dev)
    s_bin, g_bin, seg, equ, high, breast = clean_stage_inputs(small)

    for x, what in ((seg, "segmented synthetic B=16"), (rand_u8, "random u8 B=16")):
        agree("equalize", KE.equalize(x), KE.equalize_reference(x), what)
    # The kernel runs to the true fixpoint. The plain version mirrors the
    # JAX sweep cap of 128, which the random masks exceed (a spanning
    # 8-connected component needs ~180 sweeps at 256²), so there it runs
    # uncapped: H*W sweeps bound any labelling.
    uncapped = HW * HW
    for m, what, cap in ((s_bin, "suppress-site synthetic", 128),
                         (rand_masks, "random masks, plain uncapped", uncapped)):
        agree("largest_obj", KL.largest_obj(m, 8, fill=True, smooth_k=15),
              KL.largest_obj_reference(m, 8, fill=True, smooth_k=15, max_iters=cap),
              f"fill + opening(15), {what}")
    for m, what, cap in ((g_bin, "segment-site synthetic", 128),
                         (rand_masks, "random masks, plain uncapped", uncapped)):
        agree("largest_obj", KL.largest_obj(m, 8, fill_first=True),
              KL.largest_obj_reference(m, 8, fill_first=True, max_iters=cap),
              f"fill_first, {what}")
    kern = KP.pectoral_tail(equ, high, breast)
    plain = KP.pectoral_tail_reference(equ, high, breast)
    for name, a, b in zip(("labels", "boundary", "mask"), kern, plain):
        agree("pectoral_tail", a, b, f"{name}, cleaner inputs B=16")

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

    serving_inputs = {name: upload_cleaner_input(img) for name, img in uploads.items()}
    serving_inputs[f"classify_batch B={N_BATCHED}"] = torch.from_numpy(bulk).to(dev)
    composed = {}   # upload -> (equalized image, watershed markers, label)
    for name, x in serving_inputs.items():
        b, h, w = x.shape
        s_bin_, g_bin_, seg_, equ_, high_, breast_ = clean_stage_inputs(x)
        cap = h * w
        what = f"cleaner inputs of {name}, {h}x{w} B={b}"
        agree("equalize", KE.equalize(seg_), KE.equalize_reference(seg_), what)
        agree("largest_obj", KL.largest_obj(s_bin_, 8, fill=True, smooth_k=15),
              KL.largest_obj_reference(s_bin_, 8, fill=True, smooth_k=15, max_iters=cap),
              f"suppress site, {what}, plain uncapped")
        agree("largest_obj", KL.largest_obj(g_bin_, 8, fill_first=True),
              KL.largest_obj_reference(g_bin_, 8, fill_first=True, max_iters=cap),
              f"segment site, {what}, plain uncapped")
        if cleaner.use_packed((h, w), 3):
            kern = KP.pectoral_tail(equ_, high_, breast_)
            plain = KP.pectoral_tail_reference(equ_, high_, breast_, max_iters=cap,
                                               ws_max_iters=cap)
            for part, a, b_ in zip(("labels", "boundary", "mask"), kern, plain):
                agree("pectoral_tail", a, b_, f"{part}, {what}, plain uncapped")
            continue
        agree("largest_obj", KL.largest_obj(high_ > 0, 8, fill=True),
              KL.largest_obj_reference(high_ > 0, 8, fill=True, max_iters=cap),
              f"pectoral site, {what}, plain uncapped")
        for m, site in ((s_bin_, "suppress mask"), (high_ > 0, "pectoral mask")):
            labels = KC.label_components(m, 8)
            agree("ccl", labels, KC.label_components_reference(m, 8, max_iters=cap),
                  f"{site}, {what}")
            agree("mode", KM.largest_component_mask(labels, m),
                  KM.largest_component_mask_reference(labels, m), f"{site}, {what}")
        # The pair form has no float32 fixpoint at these sizes (rounding of
        # d - s + s drifts distances down every sweep), so kernel and plain
        # version run the same max_iters sweeps, as the cleaner calls them.
        markers = pectoral_markers(equ_, high_, breast_)
        composed[name] = (equ_, markers, what)
        for a, b_, part in zip(
                KW.marker_watershed(equ_, markers, max_scan=8,
                                    marker_label_values=(255, 128, 64)),
                KW.marker_watershed_reference(equ_, markers, max_scan=8,
                                              marker_label_values=(255, 128, 64)),
                ("labels", "boundary")):
            agree("watershed", a, b_, f"pair form {part}, {what}, 256 sweeps each")

    # random masks and markers at 256², B=16, and the CAM shapes
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
        labels = KC.label_components(hot, 8)
        agree("ccl", labels, KC.label_components_reference(hot, 8, h * h),
              f"CAM masks B={b} {h}x{h}")
        agree("mode", KM.largest_component_mask(labels, hot),
              KM.largest_component_mask_reference(labels, hot), f"CAM masks B={b} {h}x{h}")
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
        cap = uncapped if values else 256
        for a, b, part in zip(
                KW.marker_watershed(img_, mk_, max_scan=max_scan, marker_label_values=values),
                KW.marker_watershed_reference(img_, mk_, max_iters=cap, max_scan=max_scan,
                                              marker_label_values=values),
                ("labels", "boundary")):
            agree("watershed", a, b, f"{what} {part}, max_scan {max_scan}, plain cap {cap}")

    # the training slice's kernels, at the shapes of the conv layers of the
    # basic (B=8 training, B=64 pipeline) and advanced (B=32 training, B=1
    # serving) classifiers, the pools after them and the U-Net's
    tgen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=tgen, device=dev) * scale

    conv_cases = [((8, 64, 32, 32), 128, 0, "basic layer 1, training B=8"),
                  ((8, 128, 15, 15), 64, 0, "basic layer 2, training B=8"),
                  ((64, 64, 32, 32), 128, 0, "basic layer 1, pipeline B=64"),
                  ((32, 64, 256, 256), 32, 1, "advanced layer 1, training B=32"),
                  ((32, 32, 128, 128), 64, 1, "advanced layer 2, training B=32"),
                  ((1, 64, 256, 256), 32, 1, "advanced layer 1, serving B=1")]
    for (b, c, h, w), f, pad, what in conv_cases:
        x = randn(b, c, h, w)
        x[:, :, : h // 4] = 0.0                       # z == 0 rows
        wt, bias = randn(f, c, 3, 3, scale=(2.0 / (9 * c)) ** 0.5), randn(f, scale=0.1)
        bias[0] = 0.0
        kern = KCL.conv_leaky(x, wt, bias, 0.01, pad)
        plain = KCL.conv_leaky_reference(x, wt, bias, 0.01, pad)
        torch.cuda.synchronize()
        err = max_abs_err(kern, plain)
        tol = 1e-5 * float(plain.abs().max()) + 1e-6
        errs["conv_leaky"] = max(errs["conv_leaky"], err)
        print(f"check conv_leaky [{what}, pad {pad}]: max_abs_err {err} (tolerance {tol:.3g})",
              flush=True)
        if err > tol:
            raise AssertionError(f"conv_leaky [{what}] disagrees with its plain version")
        del x, kern, plain
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
    for shape, dtype in (((8, 128, 32, 32), torch.float32), ((8, 32, 128, 128), torch.float32),
                         ((3, 5, 37, 53), torch.bfloat16)):
        x = randn(*shape).to(dtype)
        agree("upsample", KUp.upsample_nearest(x, 2), KUp.upsample_nearest_reference(x, 2),
              f"factor 2, {tuple(shape)} {dtype}")
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
    expected = {"largest_obj": 2 * N_MAIN_BATCHES, "equalize": N_MAIN_BATCHES,
                "pectoral_tail": N_MAIN_BATCHES, "ccl": 0, "mode": 0, "watershed": 0,
                "conv_leaky": 4 * N_MAIN_BATCHES, "pool": 4 * N_MAIN_BATCHES,
                "upsample": 0}
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
    # 1 for classify_batch
    stacks = 2 * (2 + 2 + 2) + 2 * n_flushes + 1
    expected = {"largest_obj": 3 + 3 + 2 + 2, "equalize": 4, "pectoral_tail": 2,
                "watershed": 2, "ccl": 4 + n_flushes, "mode": 4 + n_flushes,
                "conv_leaky": 2 * stacks, "pool": 2 * stacks, "upsample": 0}
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
    jet_levels = apply_jet(torch.arange(256, dtype=torch.uint8)).int()
    jet_slope = int((jet_levels[1:] - jet_levels[:-1]).abs().max())
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
            # heatmap pixel may truncate to the next level. The overlay is
            # trunc((jet + img) * 255 / peak), peak the largest jet + img
            # of the image, so where the heatmaps differ by dh levels it
            # may move by floor(jet_slope * dh * 255 / peak) + 1 counts;
            # where they agree it is held to +-2, and so is the 99th
            # percentile of all its values (tests/test_xai.py:78-81).
            for c in (0, 1):
                (ov_g, hm_g), (ov_c, hm_c) = og[c], oc[c]
                hm_c_t = torch.from_numpy(hm_c)
                dhm = (torch.from_numpy(hm_g).int() - hm_c_t.int()).abs()
                dov = (torch.from_numpy(ov_g).int() - torch.from_numpy(ov_c).int()).abs()
                same = (dhm == 0)[..., None].expand(dov.shape)
                checks.append((f"{pipeline} heatmap {c}", float(dhm.max()), 2))
                checks.append((f"{pipeline} overlay {c} where heatmaps agree",
                               float(dov[same].max()), 2))
                checks.append((f"{pipeline} overlay {c}, 99th percentile",
                               float(torch.quantile(dov.double().flatten(), 0.99)), 2))
                peak = int((apply_jet(hm_c_t).int() + torch.from_numpy(cc).int()[..., None]).max())
                dh = int(dhm.max())
                steps = int((dhm > 0).sum())
                checks.append((f"{pipeline} overlay {c} at the {steps} heatmap steps "
                               f"(slope {jet_slope}, dh {dh}, peak {peak})",
                               float(dov[~same].max()) if steps else 0.0,
                               jet_slope * dh * 255 // peak + 1))
    for name, err, tol in checks:
        print(f"serving cuda vs cpu {name}: max_abs_err {err} (tolerance {tol})", flush=True)
        if err > tol:
            raise AssertionError(f"serving {name}: card and CPU differ by {err} > {tol}")

    phase_done("6")

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

    def library_conv():
        with full_fp32():
            return F.conv2d(xa, wa, ba, padding=1)

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
                          f"B={BATCH} {HW}x{HW}", (equ, high, breast), None, None),
        "ccl": (lambda: KC.label_components(hot3, 8),
                lambda: KC.label_components_reference(hot3, 8),
                "B=3 62x62 CAM masks (advanced classify_and_roi)", (hot3,), None, None),
        "mode": (lambda: KM.largest_component_mask(lab3, hot3),
                 lambda: KM.largest_component_mask_reference(lab3, hot3),
                 "B=3 62x62 CAM labels (advanced classify_and_roi)", (lab3, hot3), None,
                 None),
        "conv_leaky": (lambda: KCL.conv_leaky(xa, wa, ba, 0.01, 1),
                       lambda: KCL.conv_leaky_reference(xa, wa, ba, 0.01, 1),
                       f"advanced layer 1, B=32 {HW}x{HW}x64 -> 32, SAME", (xa, wa, ba),
                       2 * 32 * HW * HW * 32 * 64 * 9, library_conv),
        "pool": (lambda: KPool.pool(pa, 2, "max"), lambda: KPool.pool_reference(pa, 2, "max"),
                 f"max 2x2 after advanced layer 1, B=32 32x{HW}x{HW}", (pa,), pa.numel(),
                 lambda: F.max_pool2d(pa, 2)),
        "upsample": (lambda: KUp.upsample_nearest(ua, 2),
                     lambda: KUp.upsample_nearest_reference(ua, 2),
                     f"U-Net last upsample, B=8 32x{HW // 2}x{HW // 2} x2", (ua,), 0,
                     lambda: F.interpolate(ua, scale_factor=2, mode="nearest")),
    }
    watershed_fns = {}   # upload -> the same fields, for the pair-form watershed
    for name, (equ_, markers, what) in composed.items():
        watershed_fns[name] = (
            lambda e=equ_, m=markers: KW.marker_watershed(
                e, m, max_scan=8, marker_label_values=(255, 128, 64)),
            lambda e=equ_, m=markers: KW.marker_watershed_reference(
                e, m, max_scan=8, marker_label_values=(255, 128, 64)),
            f"pair form, {what}", (equ_, markers), None, None)
    timed["watershed"] = watershed_fns.pop(token)
    times, bounds = {}, {}
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
        lib_text = (f", library {lib:.4f} ms (runs {runs[4]:.4f}, {runs[5]:.4f})"
                    if lib is not None else "")
        print(f"time {name} {shape}: kernel {k:.4f} ms (runs {runs[0]:.4f}, "
              f"{runs[1]:.4f}), plain {p:.4f} ms (runs {runs[2]:.4f}, {runs[3]:.4f})"
              f"{lib_text}, bound {bounds[name][0]:.4f} ms by {bounds[name][1]} on {card}",
              flush=True)
    cam6 = torch.from_numpy(rng.random((1, 6, 6)).astype(np.float32)).to(dev)
    hot6 = cam6 >= 0.6 * cam6.amax(dim=(1, 2), keepdim=True)
    lab6 = KC.label_components(hot6, 8)
    xb8, wb8, bb8 = (randn(8, 64, 32, 32), randn(128, 64, 3, 3, scale=(2.0 / 576) ** 0.5),
                     randn(128, scale=0.1))
    xp64 = randn(64, 64, 32, 32)
    pu = torch.relu(randn(8, 16, HW, HW))
    extra = [
        ("ccl", lambda: KC.label_components(hot6, 8),
         lambda: KC.label_components_reference(hot6, 8), "B=1 6x6 (basic classify)", None),
        ("mode", lambda: KM.largest_component_mask(lab6, hot6),
         lambda: KM.largest_component_mask_reference(lab6, hot6), "B=1 6x6 (basic classify)",
         None),
        ("conv_leaky", lambda: KCL.conv_leaky(xb8, wb8, bb8, 0.01, 0),
         lambda: KCL.conv_leaky_reference(xb8, wb8, bb8, 0.01, 0),
         "basic layer 1, B=8 32x32x64 -> 128, VALID (training)",
         lambda: F.conv2d(xb8, wb8, bb8)),
        ("conv_leaky", lambda: KCL.conv_leaky(xp64, wb8, bb8, 0.01, 0),
         lambda: KCL.conv_leaky_reference(xp64, wb8, bb8, 0.01, 0),
         "basic layer 1, B=64 (run_pipeline)", lambda: F.conv2d(xp64, wb8, bb8)),
        ("pool", lambda: KPool.pool(pa, 2, "mean"), lambda: KPool.pool_reference(pa, 2, "mean"),
         f"mean 2x2, B=32 32x{HW}x{HW}", lambda: F.avg_pool2d(pa, 2)),
        ("pool", lambda: KPool.pool(pu, 2, "max"), lambda: KPool.pool_reference(pu, 2, "max"),
         f"max 2x2, U-Net first level B=8 16x{HW}x{HW}", lambda: F.max_pool2d(pu, 2)),
    ] + [("watershed",) + fns[:3] + (None,) for fns in watershed_fns.values()]
    for name, kernel_fn, plain_fn, shape, library_fn in extra:
        with full_fp32():
            k, p, lib, runs = turns_ms(kernel_fn, plain_fn, 20, 3, library_fn)
        lib_text = f", library {lib:.4f} ms" if lib is not None else ""
        print(f"time {name} {shape}: kernel {k:.4f} ms (runs {runs[0]:.4f}, "
              f"{runs[1]:.4f}), plain {p:.4f} ms (runs {runs[2]:.4f}, {runs[3]:.4f})"
              f"{lib_text} on {card}", flush=True)

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
    print(f"time run_pipeline B={BATCH} {HW}x{HW}: {pipe_ms:.3f} ms/batch, "
          f"{BATCH / (pipe_ms / 1e3):.1f} img/s on {card}", flush=True)
    for name, img in uploads.items():
        ms = p50_ms(lambda: eng.process_single_image(img, cache_token=name), N_TIMED)
        print(f"time process_single_image {name}: p50 {ms:.3f} ms over {N_TIMED} "
              f"requests on {card}", flush=True)
    for pipeline in ("basic", "advanced"):
        ms = p50_ms(lambda: eng.classify_and_roi(feats[token], pipeline, (0, 1),
                                                 cache_token=token), N_TIMED)
        print(f"time classify_and_roi {pipeline} (0, 1), cached features: p50 "
              f"{ms:.3f} ms over {N_TIMED} requests on {card}", flush=True)
    for b in eng._batchers.values():
        b.close()

    phase_done("8")
    by_path = {"pipeline": pipe_launches, "serving": serve_launches,
               "training": train_launches}
    own_path = {"conv_leaky": "training", "pool": "training", "upsample": "training"}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": modules[name].SOURCE,
         "replaces": modules[name].REPLACES,
         "launches": by_path[own_path.get(name, "serving")][name],
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
         "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": times[name][2]}
        for name in wrappers]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
