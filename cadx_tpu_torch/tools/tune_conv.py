"""Tile and pipeline variants of the conv_leaky kernel, timed on one card.

Each variant is `csrc/conv_leaky.cu` built alone with one tile forced and
the kernel's tuning knobs set (`-D` macros at the top of the source), into
its own library under `build/cadx_tpu_torch/tune/`, all nvcc processes
started together. Every variant is checked against F.conv2d with TF32 off
(1e-5 * max |plain| + 1e-6) and timed with CUDA events at the classifiers'
conv shapes, layer 1 also on the NHWC view conv_stack hands over, beside
F.conv2d itself. Run it as a file on the card:

    python3 cadx_tpu_torch/tools/tune_conv.py [VARIANT ...]

A variant is TM,TN,PF,PX,PY[,MINB256[,STAGES,STAGE_KB]]: pixels and
filters a thread, threads along the filters, threads along a row, rows a
block, the blocks an SM asked of the compiler for a 256-thread block, the
ring's stages and the kilobytes a stage may take (defaults: the
source's). Each variant's kernels are listed with their register range
and any spill `ptxas -v` reports. With no arguments the
shipped dispatch (no tile forced) is timed beside a few others. Prints one
line per shape, the variants fastest first, and the card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KNOBS = ("CADX_CONV_TM", "CADX_CONV_TN", "CADX_CONV_PF", "CADX_CONV_PX", "CADX_CONV_PY",
         "CADX_CONV_MINB256", "CADX_CONV_STAGES", "CADX_CONV_STAGE_KB")
DEFAULT_VARIANTS = ("shipped", "8,8,4,4,16", "8,8,4,4,16,2,2,48", "8,8,4,4,16,1",
                    "4,8,4,4,16", "4,4,8,4,8", "8,4,8,4,8", "8,4,8,2,8", "8,8,8,4,8",
                    "8,8,16,4,4")
# (label, (B, C, H, W), F, pad, NHWC view)
SHAPES = (("basic layer 1, B=8, NHWC view (training)", (8, 64, 32, 32), 128, 0, True),
          ("basic layer 2, B=8 (training)", (8, 128, 15, 15), 64, 0, False),
          ("basic layer 1, B=64, NHWC view (run_pipeline)", (64, 64, 32, 32), 128, 0, True),
          ("basic layer 1, B=64, NCHW", (64, 64, 32, 32), 128, 0, False),
          ("basic layer 2, B=64 (run_pipeline)", (64, 128, 15, 15), 64, 0, False),
          ("advanced layer 1, B=32, NHWC view (training)", (32, 64, 256, 256), 32, 1, True),
          ("advanced layer 1, B=32, NCHW", (32, 64, 256, 256), 32, 1, False),
          ("advanced layer 2, B=32 (training)", (32, 32, 128, 128), 64, 1, False),
          ("advanced layer 1, B=1, NHWC view (serving)", (1, 64, 256, 256), 32, 1, True))


def build(variants):
    """variant -> ctypes entry point, or the nvcc output where it failed."""
    sys.path.insert(0, str(ROOT))
    from cadx_tpu_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        defs = [] if v == "shipped" else [f"-D{k}={n}" for k, n in zip(KNOBS, v.split(","))]
        so = out_dir / f"conv_{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *defs, "-o", str(so),
               str(_build.CSRC / "conv_leaky.cu")]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True))
    built = {}
    for v, (so, proc) in procs.items():
        out, err = proc.communicate()
        regs, spills, name = [], [], ""
        for line in (out + err).splitlines():
            if "Function properties for " in line:
                name = line.split("Function properties for ")[-1].strip()
            elif "spill stores" in line:
                stores = int(line.split(" bytes spill stores")[0].split(",")[-1])
                loads = int(line.split(" bytes spill loads")[0].split(",")[-1])
                if stores or loads:
                    spills.append(f"{name}: {line.strip()}")
            elif "Used " in line and " registers" in line:
                regs.append(int(line.split("Used ")[1].split()[0]))
        print(f"variant {v}: nvcc {proc.returncode}; {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}; spills: "
              f"{'; '.join(spills) or 'none'}", flush=True)
        if proc.returncode:
            print((out + err)[-2000:], flush=True)
            built[v] = out + err
            continue
        fn = ctypes.CDLL(str(so)).cadx_conv_leaky
        fn.argtypes = list(_build._SIGNATURES["cadx_conv_leaky"])
        fn.restype = ctypes.c_int
        built[v] = fn
    return built


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    variants = tuple(argv if argv else sys.argv[1:]) or DEFAULT_VARIANTS
    if not torch.cuda.is_available():
        raise RuntimeError("tune_conv needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from cadx_tpu_torch.precision import full_fp32

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    built = build(variants)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ms(fn, n):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    failed = False
    for label, (bsz, c, h, w), f, pad, nhwc in SHAPES:
        x = torch.randn((bsz, h, w, c) if nhwc else (bsz, c, h, w), generator=gen, device=dev)
        x = x.permute(0, 3, 1, 2) if nhwc else x
        wt = torch.randn((f, c, 3, 3), generator=gen, device=dev) * (2.0 / (9 * c)) ** 0.5
        bias = torch.randn(f, generator=gen, device=dev) * 0.1
        y = torch.empty((bsz, f, h + 2 * pad - 2, w + 2 * pad - 2), device=dev)
        with full_fp32():
            z = F.conv2d(x, wt, bias, padding=pad)
            ref = torch.where(z > 0, z, 0.01 * z)
            lib_ms = ms(lambda: F.conv2d(x, wt, bias, padding=pad), 10)
        iters = 5 if bsz * h * w > 1e6 else 20
        rows = []
        for v, fn in built.items():
            if not callable(fn):
                rows.append((float("inf"), f"{v} did not build"))
                continue
            def call(fn=fn):
                return fn(x.data_ptr(), wt.data_ptr(), bias.data_ptr(), y.data_ptr(), bsz, c,
                          h, w, f, 3, pad, int(nhwc), 0.01, stream)
            rc = call()
            torch.cuda.synchronize()
            if rc:
                rows.append((float("inf"), f"{v} cudaError {rc}"))
                continue
            err = float((y - ref).abs().max())
            ok = err <= 1e-5 * float(ref.abs().max()) + 1e-6
            failed |= not ok
            t = ms(call, iters)
            rows.append((t, f"{v} {t:.4f}" + ("" if ok else f" WRONG ({err})")))
        rows.sort(key=lambda r: r[0])
        print(f"tune {label} {tuple(x.shape)} -> {f}: F.conv2d {lib_ms:.4f} ms; "
              + "; ".join(r[1] for r in rows) + f" (ms, on {card})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
