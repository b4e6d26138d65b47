#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`cadx_tpu_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):
1. build the three CUDA kernels from `cadx_tpu_torch/csrc` with nvcc;
2. hold each kernel bit-exact against its plain PyTorch version on the
   card: synthetic mammograms (B=16, 256²) and random masks;
3. drive `run_pipeline` at 256² with the full-width classifier (32x32x64
   input, conv (128,3),(64,3), hidden (256,128), 2 classes, both classes
   explained) on seeded random weights, three batches of B=64, and check
   that the kernels were launched 2 (largest_obj), 1 (equalize) and 1
   (pectoral_tail) times per batch;
4. run the same pipeline on a B=2 batch on the card and on the CPU and
   compare: clean_u8 exact, probs 2e-5, features 1e-5, heatmaps and
   overlays +-2 u8;
5. time each kernel beside its plain version at B=64, 256², and the
   pipeline's images per second at B=64, with CUDA events.

The last line of standard output is {"ok": true, "device": {...}}; the
line before it is the per-kernel JSON record. Imports torch, numpy and
the port only.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 64
HW = 256
N_MAIN_BATCHES = 3


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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cadx_tpu_torch.kernels import _build
    from cadx_tpu_torch.kernels import equalize as KE
    from cadx_tpu_torch.kernels import largest_obj as KL
    from cadx_tpu_torch.kernels import pectoral as KP
    from cadx_tpu_torch.ops.threshold import (binary_threshold,
                                              relative_threshold_value, to_uint8)
    from cadx_tpu_torch.pipeline import fused
    from cadx_tpu_torch.preprocess import cleaner
    from cadx_tpu_torch.synthetic import synthetic_mammograms

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}", flush=True)

    # ---- 2. each kernel against its plain version, on the card --------------
    def clean_stage_inputs(batch_u8):
        """The inputs the cleaner hands each kernel (launches not counted)."""
        raw8 = to_uint8(batch_u8)
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

    rng = np.random.default_rng(0)
    small = torch.from_numpy(synthetic_mammograms(16, HW, seed=1)).to(dev)
    rand_masks = torch.from_numpy(rng.random((16, HW, HW)) > 0.55).to(dev)
    rand_u8 = torch.from_numpy(rng.integers(0, 256, (16, HW, HW)).astype(np.uint8)).to(dev)
    s_bin, g_bin, seg, equ, high, breast = clean_stage_inputs(small)

    errs = {"equalize": 0.0, "largest_obj": 0.0, "pectoral_tail": 0.0}

    def agree(name, kernel_out, plain_out, what):
        torch.cuda.synchronize()
        err = max_abs_err(kernel_out, plain_out)
        errs[name] = max(errs[name], err)
        print(f"check {name} [{what}]: max_abs_err {err} (tolerance 0, bit-exact)",
              flush=True)
        if err != 0.0:
            raise AssertionError(f"{name} [{what}] disagrees with its plain version")

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

    # ---- 3. the main path, with launch counts --------------------------------
    config = fused.PipelineConfig(image_hw=(HW, HW))
    params = fused.init_pipeline_params(torch.Generator().manual_seed(0), config,
                                        device=dev)
    batches = [torch.from_numpy(synthetic_mammograms(BATCH, HW, seed=10 + i)).to(dev)
               for i in range(N_MAIN_BATCHES)]
    wrappers = {"largest_obj": KL.largest_obj, "equalize": KE.equalize,
                "pectoral_tail": KP.pectoral_tail}
    for fn in wrappers.values():
        fn.launches = 0
    outs = [fused.run_pipeline(params, x, config) for x in batches]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expected = {"largest_obj": 2 * N_MAIN_BATCHES, "equalize": N_MAIN_BATCHES,
                "pectoral_tail": N_MAIN_BATCHES}
    print(f"main path: {N_MAIN_BATCHES} batches of B={BATCH} at {HW}x{HW}, "
          f"launches {launches}", flush=True)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
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

    # ---- 4. the card against the CPU on a small batch -------------------------
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

    # ---- 5. timing at B=64, 256² ---------------------------------------------
    big = batches[0]
    s_bin, g_bin, seg, equ, high, breast = clean_stage_inputs(big)
    timed = {
        "equalize": (lambda: KE.equalize(seg), lambda: KE.equalize_reference(seg)),
        "largest_obj": (
            lambda: (KL.largest_obj(s_bin, 8, fill=True, smooth_k=15),
                     KL.largest_obj(g_bin, 8, fill_first=True)),
            lambda: (KL.largest_obj_reference(s_bin, 8, fill=True, smooth_k=15),
                     KL.largest_obj_reference(g_bin, 8, fill_first=True))),
        "pectoral_tail": (lambda: KP.pectoral_tail(equ, high, breast),
                          lambda: KP.pectoral_tail_reference(equ, high, breast)),
    }
    times = {}
    for name, (kernel_fn, plain_fn) in timed.items():
        # turns: plain, kernel, kernel, plain
        p1 = cuda_ms(plain_fn, 3)
        k1 = cuda_ms(kernel_fn, 20)
        k2 = cuda_ms(kernel_fn, 20)
        p2 = cuda_ms(plain_fn, 3)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"time {name} B={BATCH} {HW}x{HW}: kernel {times[name][0]:.4f} ms "
              f"(runs {k1:.4f}, {k2:.4f}), plain {times[name][1]:.4f} ms "
              f"(runs {p1:.4f}, {p2:.4f}) on {card}", flush=True)
    pipe_ms = cuda_ms(lambda: fused.run_pipeline(params, big, config), 5)
    print(f"time run_pipeline B={BATCH} {HW}x{HW}: {pipe_ms:.3f} ms/batch, "
          f"{BATCH / (pipe_ms / 1e3):.1f} img/s on {card}", flush=True)

    modules = {"equalize": KE, "largest_obj": KL, "pectoral_tail": KP}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": modules[name].SOURCE,
         "replaces": modules[name].REPLACES, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in ("largest_obj", "equalize", "pectoral_tail")]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
