"""Time `run_pipeline` on one card: the fused 256² pipeline at B=64 with
the full-width classifier on seeded weights, CUDA events around whole
calls after warmup.

`--root` picks the checkout whose `cadx_tpu_torch` is timed (default: the
one holding this file), so two trees can be compared on one card in
turns, each in its own process. Run it as a file, so that nothing of the
package is imported before `--root` is on the path:

    python3 cadx_tpu_torch/tools/time_pipeline.py [--root DIR] [--profile]
        [--iters N] [--repeats R]

Prints one JSON line: root, ms per batch (the median of R windows of N
back-to-back batches each, every window's mean beside it), images per
second, the card; with --profile also the device kernel time per batch
and its largest kernels, from `torch.profiler` over another N batches
(device time varies less than the host's wall clock between runs). Batch
and size are chip_smoke.py's: B=64 at 256²; by default one window of ten
batches.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BATCH = 64
HW = 256


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--iters", type=int, default=10, help="batches a window")
    parser.add_argument("--repeats", type=int, default=1, help="timed windows")
    args = parser.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)

    import torch

    from cadx_tpu_torch.pipeline import fused
    from cadx_tpu_torch.synthetic import synthetic_mammograms

    if not torch.cuda.is_available():
        raise RuntimeError("time_pipeline needs a CUDA device")
    dev = torch.device("cuda", 0)
    config = fused.PipelineConfig(image_hw=(HW, HW))
    params = fused.init_pipeline_params(torch.Generator().manual_seed(0), config, device=dev)
    x = torch.from_numpy(synthetic_mammograms(BATCH, HW, seed=10)).to(dev)
    for _ in range(3):
        fused.run_pipeline(params, x, config)
    torch.cuda.synchronize()
    windows = []
    for _ in range(args.repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fused.run_pipeline(params, x, config)
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / args.iters)
    ms = statistics.median(windows)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"root": root, "batch": BATCH, "hw": HW, "ms_per_batch": ms,
              "img_per_s": BATCH / (ms / 1e3), "window_ms": windows, "iters": args.iters,
              "card": card,
              "package": str(Path(fused.__file__).resolve().parents[1])}
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fused.run_pipeline(params, x, config)
            torch.cuda.synchronize()
        per_kernel = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per_kernel[e.key] = e.self_device_time_total / 1e3 / args.iters
        result["device_ms_per_batch"] = sum(per_kernel.values())
        result["top_kernels_ms_per_batch"] = dict(
            sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12])
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
