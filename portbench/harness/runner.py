"""One run of one cell: set up, measure for `--seconds`, optionally trace,
check the outputs against the plain reference, print the result line.

Everything a cell needs is found by name from `BENCHMARK.json`: the
configuration's file, `traffic/<traffic>.json` (whose "kind" names the
module `kinds/<kind>.py` that drives the port), `limits/<cell>.json`
(the limit of each compared number) and, for the traced run,
`metrics/<metric>.py` (each per-layer metric's reader).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "cadx_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `cadx_tpu_torch` is not `cadx_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass
class Spec:
    """A cell and what BENCHMARK.json says of it."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list     # the manifest's end-to-end metric entries of this cell
    per_layer: list      # the per-layer metric entries of this cell


def _applies(metric: dict, cell: str, e2e_names: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_spec(root: Path, bench: Path, cell: str) -> Spec:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell not in cells:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    w = cells[cell]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _applies(m, cell, names)]
    return Spec(cell, w["chips"], json.loads((root / conf["file"]).read_text()),
                json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
                json.loads((bench / "limits" / f"{cell}.json").read_text()), e2e, per_layer)


def make_cell(spec: Spec, seed: int, device):
    """The cell (`kinds/<kind>.py` of its traffic's kind), not set up."""
    import torch

    from harness.cell import Context

    kind = importlib.import_module(f"harness.kinds.{spec.traffic['kind']}")
    return kind.Cell(Context(spec.name, spec.config, spec.traffic, spec.limits, seed,
                             torch.device(device)))


def load_reader(bench: Path, name: str):
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or
    "not read"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads: the window's host spans (seconds),
    the traced window (`trace.TraceStats`, complete or not), the counted
    work of its units, and the window's rate of work."""
    spans: dict
    trace: object
    work: dict
    window_units: int
    window_s: float
    model_flops_per_unit: float


def run(args, root: Path, bench: Path, t_start: float, device=None) -> dict:
    """One run; returns the result object. `device` overrides the card
    (the CPU tests pass "cpu"); on the card the run needs `chips` of them."""
    import torch

    from harness import trace as tracing

    spec = load_spec(root, bench, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
            raise NoDevice(f"{spec.name} needs {spec.chips} CUDA device(s); "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                           " visible")
        device = "cuda:0"
    dev = torch.device(device)
    cell = make_cell(spec, args.seed, dev)
    if dev.type == "cuda":
        torch.cuda.init()
    t_setup = time.perf_counter()
    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    steps, last = [], t_setup
    for name, t in cell.marks + [("warm-up", time.perf_counter())]:
        steps.append(f"{name} {t - last:.3f}")
        last = t
    print(f"portbench: set-up {setup_s:.3f} s: torch and the device {t_setup - t_start:.3f}, "
          + ", ".join(steps), file=sys.stderr)

    cell.spans.clear()
    t0 = time.perf_counter()
    cell.start_window(t0, args.seconds)
    units = 0
    while time.perf_counter() - t0 < args.seconds:
        cell.unit()
        units += 1
    cell.finish()
    window_s = time.perf_counter() - t0
    e2e = cell.end_to_end(window_s)
    e2e["setup_s"] = setup_s

    metrics = {}
    breakdown = None
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": spec.chips}
    if args.trace:
        stats = tracing.profile(cell.profiled, spec.traffic["profile_units"])
        readings = Readings(dict(cell.spans), stats, cell.work(stats.units), units, window_s,
                            cell.model_flops_per_unit())
        for m in spec.per_layer:
            value = load_reader(bench, m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = stats.busy_s
        device_info["window_s"] = stats.window_s
        device_info["trace_complete"] = stats.complete
        breakdown = stats.breakdown()
    else:
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                        if dev.type == "cuda" else 0)
    if dev.type == "cuda":
        device_info["power"] = power_limit()

    cell.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = cell.check()
    correct = all(c.ok for c in compared) and cell.failed == 0
    result = {"correct": correct, "attempted": cell.attempted, "failed": cell.failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    return result


class NoDevice(RuntimeError):
    pass


def main(argv, root: Path, bench: Path, t_start: float) -> int:
    args = parse(argv)
    try:
        result = run(args, root, bench, t_start)
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded forbidden modules: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        v = c["value"]
        print(f"compared {name}: {v!r} limit {c['limit']!r}"
              f"{'' if math.isfinite(v) and v <= c['limit'] else '  FAILS'}", file=sys.stderr)
    print(json.dumps(result))
    return 0
