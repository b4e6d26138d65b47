#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`cadx_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):
1. build the six CUDA kernels from `cadx_tpu_torch/csrc` (one nvcc per
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
3. the fused pipeline: `run_pipeline` at 256² with the full-width
   classifier on seeded weights, three batches of B=64; launches 2
   (largest_obj), 1 (equalize), 1 (pectoral_tail) per batch and none of
   the serving kernels;
4. the fused pipeline on a B=2 batch on the card and on the CPU: clean_u8
   exact, probs 2e-5, features 1e-5, heatmaps and overlays +-2 u8;
5. serving at full width, `EngineConfig()` defaults, seeded weights:
   warmup, then uploads of a 3328x2560 uint16 native (cleaned at the
   1536x1280 bucket, pair-form watershed), a 1024x832 uint8 native
   (cleaned at native size, composed pectoral branch) and a 512² image
   (fused tail); per pipeline classify, classify_and_roi (0, 1) and the
   overlay PNGs; eight concurrent micro-batched classify calls;
   classify_batch on B=8 at 512². The exact launch count of each of the
   six kernels is asserted;
6. one 640x544 request on the card and on a CPU engine with the same
   weights: clean exact, features 1e-5, probs 2e-5, ROI boxes within one
   CAM cell, heatmaps +-2 u8, overlays +-2 u8 where the heatmaps agree,
   within the bound the JET table's slope gives at a heatmap step, and
   +-2 u8 at the 99th percentile of all overlay values;
7. times with CUDA events: each kernel beside its plain version (256²
   B=64 for the fused-pipeline kernels, the serving shapes for the
   others), the pipeline's images per second, and the p50 of
   process_single_image per upload shape and of classify_and_roi per
   pipeline over 10 requests after warmup.

The last line of standard output is {"ok": true, "device": {...}}; the
line before it is the per-kernel JSON record. Imports torch, numpy and
the port only.
"""

from __future__ import annotations

import concurrent.futures
import copy
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


def turns_ms(kernel_fn, plain_fn, k_iters: int, p_iters: int):
    """Kernel and plain times, in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, p_iters)
    k1 = cuda_ms(kernel_fn, k_iters)
    k2 = cuda_ms(kernel_fn, k_iters)
    p2 = cuda_ms(plain_fn, p_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import ccl as KC
    from cadx_tpu_torch.kernels import equalize as KE
    from cadx_tpu_torch.kernels import largest_obj as KL
    from cadx_tpu_torch.kernels import mode as KM
    from cadx_tpu_torch.kernels import pectoral as KP
    from cadx_tpu_torch.kernels import watershed as KW
    from cadx_tpu_torch.ops.colormap import apply_jet
    from cadx_tpu_torch.ops.morphology import dilate, erode
    from cadx_tpu_torch.ops.resize import resize_area
    from cadx_tpu_torch.ops.threshold import (binary_threshold,
                                              relative_threshold_value, to_uint8)
    from cadx_tpu_torch.pipeline import fused
    from cadx_tpu_torch.preprocess import cleaner
    from cadx_tpu_torch.serve import engine as E
    from cadx_tpu_torch.synthetic import (synthetic_mammograms,
                                          synthetic_native_mammogram)

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    modules = {"largest_obj": KL, "equalize": KE, "pectoral_tail": KP,
               "ccl": KC, "mode": KM, "watershed": KW}
    wrappers = {"largest_obj": KL.largest_obj, "equalize": KE.equalize,
                "pectoral_tail": KP.pectoral_tail, "ccl": KC.label_components,
                "mode": KM.largest_component_mask, "watershed": KW.marker_watershed}

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
    expected = {"largest_obj": 2 * N_MAIN_BATCHES, "equalize": N_MAIN_BATCHES,
                "pectoral_tail": N_MAIN_BATCHES, "ccl": 0, "mode": 0, "watershed": 0}
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
    expected = {"largest_obj": 3 + 3 + 2 + 2, "equalize": 4, "pectoral_tail": 2,
                "watershed": 2, "ccl": 4 + n_flushes, "mode": 4 + n_flushes}
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

    # ---- 7. times -----------------------------------------------------------
    big_batch = batches[0]
    s_bin, g_bin, seg, equ, high, breast = clean_stage_inputs(big_batch)
    cam3 = torch.from_numpy(rng.random((3, 62, 62)).astype(np.float32)).to(dev)
    hot3 = cam3 >= 0.6 * cam3.amax(dim=(1, 2), keepdim=True)
    lab3 = KC.label_components(hot3, 8)
    timed = {
        "equalize": (lambda: KE.equalize(seg), lambda: KE.equalize_reference(seg),
                     f"B={BATCH} {HW}x{HW}"),
        "largest_obj": (
            lambda: (KL.largest_obj(s_bin, 8, fill=True, smooth_k=15),
                     KL.largest_obj(g_bin, 8, fill_first=True)),
            lambda: (KL.largest_obj_reference(s_bin, 8, fill=True, smooth_k=15),
                     KL.largest_obj_reference(g_bin, 8, fill_first=True)),
            f"B={BATCH} {HW}x{HW}, both cleaner sites"),
        "pectoral_tail": (lambda: KP.pectoral_tail(equ, high, breast),
                          lambda: KP.pectoral_tail_reference(equ, high, breast),
                          f"B={BATCH} {HW}x{HW}"),
        "ccl": (lambda: KC.label_components(hot3, 8),
                lambda: KC.label_components_reference(hot3, 8),
                "B=3 62x62 CAM masks (advanced classify_and_roi)"),
        "mode": (lambda: KM.largest_component_mask(lab3, hot3),
                 lambda: KM.largest_component_mask_reference(lab3, hot3),
                 "B=3 62x62 CAM labels (advanced classify_and_roi)"),
    }
    watershed_fns = {}   # upload -> (kernel call, plain call, shape)
    for name, (equ_, markers, what) in composed.items():
        watershed_fns[name] = (
            lambda e=equ_, m=markers: KW.marker_watershed(
                e, m, max_scan=8, marker_label_values=(255, 128, 64)),
            lambda e=equ_, m=markers: KW.marker_watershed_reference(
                e, m, max_scan=8, marker_label_values=(255, 128, 64)),
            f"pair form, {what}")
    timed["watershed"] = watershed_fns.pop(token)
    times = {}
    for name, (kernel_fn, plain_fn, shape) in timed.items():
        k, p, runs = turns_ms(kernel_fn, plain_fn, 20, 3)
        times[name] = (k, p)
        print(f"time {name} {shape}: kernel {k:.4f} ms (runs {runs[0]:.4f}, "
              f"{runs[1]:.4f}), plain {p:.4f} ms (runs {runs[2]:.4f}, {runs[3]:.4f}) "
              f"on {card}", flush=True)
    cam6 = torch.from_numpy(rng.random((1, 6, 6)).astype(np.float32)).to(dev)
    hot6 = cam6 >= 0.6 * cam6.amax(dim=(1, 2), keepdim=True)
    lab6 = KC.label_components(hot6, 8)
    for name, kernel_fn, plain_fn, shape in [
            ("ccl", lambda: KC.label_components(hot6, 8),
             lambda: KC.label_components_reference(hot6, 8), "B=1 6x6 (basic classify)"),
            ("mode", lambda: KM.largest_component_mask(lab6, hot6),
             lambda: KM.largest_component_mask_reference(lab6, hot6), "B=1 6x6 (basic classify)"),
    ] + [("watershed",) + fns for fns in watershed_fns.values()]:
        k, p, runs = turns_ms(kernel_fn, plain_fn, 20, 3)
        print(f"time {name} {shape}: kernel {k:.4f} ms (runs {runs[0]:.4f}, "
              f"{runs[1]:.4f}), plain {p:.4f} ms (runs {runs[2]:.4f}, {runs[3]:.4f}) "
              f"on {card}", flush=True)
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

    phase_done("7")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": modules[name].SOURCE,
         "replaces": modules[name].REPLACES, "launches": serve_launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in wrappers]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
