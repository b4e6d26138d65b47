#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`cadx_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):
1. build the fourteen CUDA kernels from `cadx_tpu_torch/csrc` (one nvcc
   per source, all at once);
2. hold each kernel bit-exact against its plain PyTorch version on the
   card (the plain versions run uncapped, max_iters = H*W, since the
   kernels run to the fixpoint; the pair-form watershed, which has no
   float32 fixpoint at real sizes, runs the same 256 sweeps in both):
   - equalize, largest_obj, pectoral_tail: synthetic mammograms (B=16,
     256²) and random masks; cleaner_front on B=16 256² (synthetic
     mammograms, noise, dark images);
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
     against its plain version and `largest_component_plain` on blobs,
     ties, random and empty masks at 256² B=16 and 1536x1280, with the
     count that took the flood and the fallback by the kernel's own seed;
   - ccl, mode and watershed (packed and pair form) on random masks and
     markers at 256² (B=16), and ccl and mode at the serving CAM shapes;
   - conv_leaky at the shapes of the training, pipeline and serving
     classifiers' conv layers (VALID and SAME), to max |d| <= 1e-5 *
     max |plain| + 1e-6 (float32 sums of <= 1,152 terms in another order);
     the pool kernel (max and mean, sizes 2 and 3, odd sides, float32 and
     bfloat16) and upsample (factor 2) bit-exact; both max-pool backward
     rules (tie-broadcast, first maximum) on the card against the CPU,
     bit-exact;
   - batchnorm at every distinct input shape of the ResNet-50 at a 512²
     display (the path's own inputs) and jet_blend at 256² B=64 and 512²
     B=1, gray and RGB, bit-exact; gradcam_tail at the pipeline's shapes,
     (64, 6, 6, 64) -> 256², heat +-1 and overlay +-2 where the heat
     agrees, within the heatmap-step bound of phase 6 where it does not
     (its GAP and channel sums round otherwise than torch's reductions);
3. the fused pipeline: `run_pipeline` at 256² with the full-width
   classifier on seeded weights, three batches of B=64; launches 1
   (cleaner_front), 1 (equalize), 1 (pectoral_tail), 4 (conv_leaky), 4
   (pool) and 2 (gradcam_tail, one per explained class) per batch and
   none of the other kernels;
4. the fused pipeline on a B=2 batch on the card and on the CPU: clean_u8
   exact, probs 2e-5, features 1e-5, heatmaps and overlays +-2 u8;
5. serving at full width, `EngineConfig()` defaults, seeded weights:
   warmup, then uploads of a 3328x2560 uint16 native (cleaned at the
   1536x1280 bucket, pair-form watershed), a 1024x832 uint8 native
   (cleaned at native size, composed pectoral branch) and a 512² image
   (fused tail); per pipeline classify, classify_and_roi (0, 1) and the
   overlay PNGs; eight concurrent micro-batched classify calls;
   classify_batch on B=8 at 512². The exact launch count of each of the
   fourteen kernels is asserted (cleaner_front once per cleaned batch,
   largest_obj once per composed pectoral branch, jet_blend once per
   overlay class);
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
8. times with CUDA events: each kernel beside its plain version (256²
   B=64 for the fused-pipeline kernels and gradcam_tail, the serving
   shapes for ccl, mode and watershed, the training shapes for
   conv_leaky, pool and upsample, the ResNet-50 stem for batchnorm, the
   512² display for jet_blend, 256² B=64, 1536x1280 and the training
   CLI's native shapes for cleaner_front, also beside the old front it
   replaces (suppress_artifacts + segment_breast_mask: two largest_obj
   launches and the glue), phase 2's
   256² B=16 masks for the seeded component, also beside the ccl + mode
   pair) and, for conv_leaky, pool, upsample and batchnorm, beside the one
   PyTorch call that computes the same function, and the device time of
   each from torch.profiler (a small kernel's back-to-back calls are bound
   by the host); each kernel's bound on this card (the larger of its
   bytes over 3.35 TB/s and its operations over 67 TFLOP/s, the H100
   SXM's HBM3 rate and float32 peak); ms per training step of each
   configuration; the pipeline's images per second; and the p50 of
   process_single_image per upload shape, of classify_and_roi per
   pipeline and of the reference `write_gradcam_overlays` over 10
   requests after warmup.

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
# the training CLI phase: native full-field shapes (the serving phase's
# 3328x2560 upload and a taller one), images in all, and the command
CLI_SHAPES = ((3328, 2560), (4608, 2656))
N_CLI = 12
CLI_ARGS = ["--features", "encoder", "--feature-size", "32", "--conv-layers", "128x3,64x3",
            "--hidden-units", "256,128", "--epochs", "2", "--batch-size", "8"]
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


def device_ms(fn, iters: int) -> float | None:
    """Mean device milliseconds per call: the kernel time torch.profiler
    records on the card (host overhead, which bounds a small kernel's
    back-to-back calls, excluded). None where the window lost records:
    every call launches the same kernels, so each kernel's record count is
    a multiple of iters; late in a long run the profiler has kept only
    some of the port's own launches (1 of 10 of a 3 ms kernel)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels or any(e.count % iters for e in kernels):
        return None
    return sum(e.self_device_time_total for e in kernels) / 1e3 / iters


def ms_text(ms: float | None) -> str:
    return "not captured" if ms is None else f"{ms:.4f}"


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.nn.functional as F

    from cadx_tpu_torch import checkpoint
    from cadx_tpu_torch.compat import adcnnm
    from cadx_tpu_torch.data import dicom as TDicom
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import batchnorm as KBN
    from cadx_tpu_torch.kernels import ccl as KC
    from cadx_tpu_torch.kernels import cleaner_front as KF
    from cadx_tpu_torch.kernels import conv_leaky as KCL
    from cadx_tpu_torch.kernels import equalize as KE
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
               "gradcam_tail": KGT, "cleaner_front": KF}
    # kernel -> (source, the TPU kernel it replaces)
    sources = {name: (mod.SOURCE, mod.REPLACES) for name, mod in modules.items()}
    sources["largest_component_seeded"] = (KL.SEEDED_SOURCE, KL.SEEDED_REPLACES)
    wrappers = {"largest_obj": KL.largest_obj, "equalize": KE.equalize,
                "pectoral_tail": KP.pectoral_tail, "ccl": KC.label_components,
                "mode": KM.largest_component_mask, "watershed": KW.marker_watershed,
                "conv_leaky": KCL.conv_leaky, "pool": KPool.pool,
                "upsample": KUp.upsample_nearest, "batchnorm": KBN.batchnorm,
                "jet_blend": KOv.jet_blend, "gradcam_tail": KGT.gradcam_tail,
                "cleaner_front": KF.cleaner_front,
                "largest_component_seeded": KL.largest_component_seeded}

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
    if n_sources != len(wrappers):
        raise AssertionError(f"{n_sources} kernel sources for {len(wrappers)} kernels")

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

    def agree_front(raw8, what):
        """cleaner_front on the uint8 batch clean_boundary_gray hands it."""
        h, w = raw8.shape[1:]
        for part, a, b in zip(("breast_only", "breast_mask", "contour_fill"),
                              KF.cleaner_front(raw8),
                              KF.cleaner_front_reference(raw8, max_iters=h * w)):
            agree("cleaner_front", a, b, f"{part}, {what}, plain uncapped")

    agree_front(to_uint8(torch.cat([small[:12], rand_u8[:2], torch.zeros_like(small[:2])])),
                f"12 synthetic mammograms, 2 noise, 2 dark, B=16 {HW}x{HW}")

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

    def agree_pectoral_select(high_, what):
        """largest_obj at the composed pectoral branch's select (sides > 512),
        plain uncapped."""
        cap = high_.shape[1] * high_.shape[2]
        agree("largest_obj", KL.largest_obj(high_ > 0, 8, fill=True),
              KL.largest_obj_reference(high_ > 0, 8, fill=True, max_iters=cap),
              f"pectoral site, {what}, plain uncapped")

    def agree_pair_watershed(equ_, markers, what):
        # The pair form has no float32 fixpoint at these sizes (rounding of
        # d - s + s drifts distances down every sweep), so kernel and plain
        # version run the same max_iters sweeps, as the cleaner calls them.
        for a, b_, part in zip(
                KW.marker_watershed(equ_, markers, max_scan=8,
                                    marker_label_values=(255, 128, 64)),
                KW.marker_watershed_reference(equ_, markers, max_scan=8,
                                              marker_label_values=(255, 128, 64)),
                ("labels", "boundary")):
            agree("watershed", a, b_, f"pair form {part}, {what}, 256 sweeps each")

    serving_inputs = {name: upload_cleaner_input(img) for name, img in uploads.items()}
    serving_inputs[f"classify_batch B={N_BATCHED}"] = torch.from_numpy(bulk).to(dev)
    composed = {}   # upload -> (equalized image, watershed markers, label)
    for name, x in serving_inputs.items():
        b, h, w = x.shape
        s_bin_, g_bin_, seg_, equ_, high_, breast_ = clean_stage_inputs(x)
        cap = h * w
        what = f"cleaner inputs of {name}, {h}x{w} B={b}"
        agree_front(to_uint8(x), what)
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
    for h, w in CLI_SHAPES:
        x = torch.from_numpy(synthetic_native_mammogram(h, w, seed=21).astype(np.float32))
        x = x.to(dev)[None]
        what = f"training CLI upload {h}x{w} u16"
        cli_front[(h, w)] = to_uint8(x)
        agree_front(cli_front[(h, w)], what)
        _, _, seg_, equ_, high_, breast_ = clean_stage_inputs(x)
        agree("equalize", KE.equalize(seg_), KE.equalize_reference(seg_), what)
        agree_pectoral_select(high_, what)
        agree_pair_watershed(equ_, pectoral_markers(equ_, high_, breast_), what)
        del x, seg_, equ_, high_, breast_

    # the density-seeded largest component, off every path: against its
    # plain version and the plain CCL + largest label, both uncapped
    def seeded_paths(m):
        """(flood, fallback) image counts of the 8-connected kernel, by its
        own seed: the densest mask pixel, the smallest raster index on ties
        (its 64-bit key; the plain version's 20-bit packing is exact only
        up to 2**20 pixels)."""
        b, h, w = m.shape
        k = KL._DENSITY_K
        dens = KL._axis_window_sum(KL._axis_window_sum(m.to(torch.int32), k, -2), k, -1)
        idx = torch.arange(h * w, dtype=torch.int64, device=m.device).view(h, w)
        key = torch.where(m, (dens.to(torch.int64) << 32) | (0xFFFFFFFF - idx), -1)
        seed = (key == key.amax(dim=(1, 2), keepdim=True)) & m
        comp = TC.flood_from(m, seed, h * w, 8)
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
            got = KL.largest_component_seeded(m, conn)
            agree("largest_component_seeded", got,
                  KL.largest_component_seeded_reference(m, conn, cap),
                  f"{what}, {conn}-conn, plain uncapped")
            agree("largest_component_seeded", got, TC.largest_component_plain(m, conn, cap),
                  f"{what}, {conn}-conn, against largest_component_plain uncapped")
        flood, fallback = seeded_paths(m)
        print(f"seeded component [{what}, 8-conn, by the kernel's seed]: {flood} took the "
              f"flood, {fallback} fell back to the CCL + largest label", flush=True)

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

    # the explainability slice's kernels. batchnorm: the inputs of every
    # distinct shape that phase 6b's ResNet-50 (seeded, batch norms
    # randomised) gives it at a 512² display, recorded on the way through
    # `resnet.bn_apply`
    r50 = randomize_bn(TR.init_resnet(torch.Generator().manual_seed(50),
                                      TR.RESNET50_CLASSIFIER), torch.Generator().manual_seed(51))
    display = torch.from_numpy(synthetic_mammograms(1, seg_h, seed=5)[0]).to(dev)
    bn_inputs = {}
    bn_apply = TR.bn_apply

    def recording_bn_apply(bn, x, eps=1e-5):
        bn_inputs.setdefault(tuple(x.shape), (x.clone(), bn))
        return bn_apply(bn, x, eps)

    TR.bn_apply = recording_bn_apply
    try:
        TR.layer4_features(copy.deepcopy(r50).to(dev), TG.imagenet_input_from_gray(display))
    finally:
        TR.bn_apply = bn_apply
    with torch.no_grad():
        for shape, (x, bn) in bn_inputs.items():
            vec = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
            agree("batchnorm", KBN.batchnorm(x, *vec), KBN.batchnorm_reference(x, *vec),
                  f"ResNet-50 input {shape} at a {seg_h}x{seg_w} display")
    for b, side in ((BATCH, HW), (1, seg_h)):
        heat = torch.from_numpy(rng.integers(0, 256, (b, side, side)).astype(np.uint8)).to(dev)
        for shape, kind in (((b, side, side), "gray"), ((b, side, side, 3), "RGB")):
            img01 = torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32)).to(dev) / 255.0
            agree("jet_blend", KOv.jet_blend(heat, img01), KOv.jet_blend_reference(heat, img01),
                  f"B={b} {side}x{side} {kind}")
    # gradcam_tail at the pipeline's shapes: channel-last views of
    # channel-first activations, as conv_stack returns them
    jet_levels = apply_jet(torch.arange(256, dtype=torch.uint8)).int()
    jet_slope = int((jet_levels[1:] - jet_levels[:-1]).abs().max())
    tail_img = torch.from_numpy(synthetic_mammograms(BATCH, HW, seed=3)).to(dev)
    tail_in = (torch.relu(randn(BATCH, 64, 6, 6)).permute(0, 2, 3, 1), randn(BATCH, 6, 6, 64),
               tail_img.to(torch.float32) / 255.0)
    tail_k = KGT.gradcam_tail(*tail_in, (HW, HW))
    tail_p = KGT.gradcam_tail_reference(*tail_in, (HW, HW))
    torch.cuda.synchronize()
    errs["gradcam_tail"] = max(max_abs_err(a, b) for a, b in zip(tail_k, tail_p))
    for name, err, tol in overlay_checks(
            f"B={BATCH} (6, 6, 64) -> {HW}x{HW}", tail_k[0].cpu(), tail_k[1].cpu(),
            tail_p[0].cpu(), tail_p[1].cpu(), tail_img.cpu(), 1, jet_slope):
        print(f"check gradcam_tail [{name}]: max_abs_err {err} (tolerance {tol})", flush=True)
        if err > tol:
            raise AssertionError(f"gradcam_tail [{name}] disagrees with its plain version")

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
                "largest_component_seeded": 0}
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
    # 1 for classify_batch. jet_blend: one per overlay class and pipeline.
    # One cleaner_front per cleaned batch (3 uploads, classify_batch);
    # largest_obj once in each composed pectoral branch (the two uploads
    # cleaned beyond 512)
    stacks = 2 * (2 + 2 + 2) + 2 * n_flushes + 1
    expected = {"largest_obj": 2, "equalize": 4, "pectoral_tail": 2,
                "watershed": 2, "ccl": 4 + n_flushes, "mode": 4 + n_flushes,
                "conv_leaky": 2 * stacks, "pool": 2 * stacks, "upsample": 0,
                "batchnorm": 0, "jet_blend": 2 * 2, "gradcam_tail": 0, "cleaner_front": 4,
                "largest_component_seeded": 0}
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

    def library_conv():
        with full_fp32():
            return F.conv2d(xa, wa, ba, padding=1)

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
    watershed_fns = {}   # upload -> the same fields, for the pair-form watershed
    for name, (equ_, markers, what) in composed.items():
        watershed_fns[name] = (
            lambda e=equ_, m=markers: KW.marker_watershed(
                e, m, max_scan=8, marker_label_values=(255, 128, 64)),
            lambda e=equ_, m=markers: KW.marker_watershed_reference(
                e, m, max_scan=8, marker_label_values=(255, 128, 64)),
            f"pair form, {what}", (equ_, markers), None, None)
    timed["watershed"] = watershed_fns.pop(token)
    times, bounds, dev_times = {}, {}, {}
    # this slice's two kernels first, while the profiler still keeps every
    # record (see device_ms), each beside its plain version and the launches it
    # replaces on the same inputs, in turns plain, other, kernel, kernel,
    # other, plain; a kernel's first row is its record's
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
    compared = {}
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
    cam6 = torch.from_numpy(rng.random((1, 6, 6)).astype(np.float32)).to(dev)
    hot6 = cam6 >= 0.6 * cam6.amax(dim=(1, 2), keepdim=True)
    lab6 = KC.label_components(hot6, 8)
    xb8, wb8, bb8 = (randn(8, 64, 32, 32), randn(128, 64, 3, 3, scale=(2.0 / 576) ** 0.5),
                     randn(128, scale=0.1))
    xp64 = randn(64, 64, 32, 32)
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
        ("batchnorm", lambda: KBN.batchnorm(l4_x, *l4_vec),
         lambda: KBN.batchnorm_reference(l4_x, *l4_vec), f"ResNet-50 layer4, {l4_shape}",
         lambda: F.batch_norm(l4_x, l4_vec[2], l4_vec[3], l4_vec[0], l4_vec[1],
                              training=False, eps=1e-5)),
        ("jet_blend", lambda: KOv.jet_blend(tail_k[1], tail_in[2]),
         lambda: KOv.jet_blend_reference(tail_k[1], tail_in[2]),
         f"B={BATCH} {HW}x{HW} gray (the pipeline's heatmaps)", None),
    ] + [("watershed",) + fns[:3] + (None,) for fns in watershed_fns.values()]
    for name, kernel_fn, plain_fn, shape, library_fn in extra:
        with full_fp32():
            k, p, lib, runs = turns_ms(kernel_fn, plain_fn, 20, 3, library_fn)
            dk, dp = device_ms(kernel_fn, 20), device_ms(plain_fn, 3)
            dl = device_ms(library_fn, 20) if library_fn else None
        lib_text = f", library {lib:.4f} ms" if lib is not None else ""
        dl_text = f", library {ms_text(dl)}" if library_fn else ""
        print(f"time {name} {shape}: kernel {k:.4f} ms (runs {runs[0]:.4f}, "
              f"{runs[1]:.4f}), plain {p:.4f} ms (runs {runs[2]:.4f}, {runs[3]:.4f})"
              f"{lib_text}; device time (profiler) kernel {ms_text(dk)}, plain {ms_text(dp)}"
              f"{dl_text} ms on {card}", flush=True)

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
    by_path = {"pipeline": pipe_launches, "serving": serve_launches,
               "reference_gradcam": ref_launches, "training": train_launches,
               "training_cli": cli_launches}
    # the seeded component lies on no path (as in JAX): 0 on each
    own_path = {"conv_leaky": "training", "pool": "training", "upsample": "training",
                "batchnorm": "reference_gradcam", "jet_blend": "reference_gradcam",
                "gradcam_tail": "pipeline", "cleaner_front": "training_cli",
                "largest_component_seeded": "training_cli"}
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
    sys.exit(main())
