"""The traced window: `torch.profiler` over a bounded number of units of
work, reduced to device time by kernel group, busy and idle time, and the
breakdown the result line carries.

The profiler can lose the card's records of the port's ctypes launches
late in a long process, so a window is used only when it is complete:
the CUDA runtime and driver API launch records on the host equal the kernel
records on the card (`completeness`, a copy of the port's
`tools/trace_summary.py::completeness` that also counts driver-API
launches, which cuDNN and cuBLAS make). Kernel names are reduced to their
function's base name (`base_name`) and grouped by `kernel_groups.json`.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import tempfile
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memset", "gpu_memcpy")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchCooperativeKernelMultiDevice")
WINDOW_SPAN = "portbench.window"
GROUPS_FILE = Path(__file__).with_name("kernel_groups.json")
ATTEMPTS = 3   # traced windows tried before the last, incomplete or not, is kept


def completeness(events: list) -> dict:
    """{"launches": the host's kernel launch records, "kernels": the card's
    kernel records, "complete": whether the two agree}."""
    launches = sum(1 for e in events
                   if e.get("cat") in LAUNCH_CATEGORIES and e.get("name") in LAUNCH_CALLS)
    kernels = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
    return {"launches": launches, "kernels": kernels, "complete": launches == kernels}


def base_name(name: str) -> str:
    """A kernel record's function name without its return type, namespace,
    template arguments and parameters: "void (anonymous
    namespace)::ccl_local<8>(int*, ...)" -> "ccl_local"."""
    s = re.sub(r"\(anonymous namespace\)", "anon", name)
    depth, out = 0, []
    for ch in s:                      # drop <...> and (...) at any depth
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip().split()[-1] if "".join(out).strip() else name
    return s.split("::")[-1]


def load_groups() -> dict[str, set[str]]:
    return {g: set(names) for g, names in json.loads(GROUPS_FILE.read_text()).items()}


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class TraceStats:
    complete: bool
    launches: int
    kernels: int
    units: int                     # units of work in the window
    window_s: float
    busy_s: float
    device_s: dict                 # kernel base name -> device seconds
    group_s: dict                  # group -> device seconds
    idle_by_span: dict             # host span open during an idle gap -> seconds

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def reduce_events(events: list, units: int, groups: dict[str, set[str]]) -> TraceStats:
    """Device time by kernel and group, busy time (the union of the card's
    records) and idle time by open host span, inside the window span."""
    comp = completeness(events)
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    device_s: collections.Counter = collections.Counter()
    intervals = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        if b <= a:
            continue
        name = base_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        device_s[name] += (b - a) * 1e-6
        intervals.append((a, b))
    busy = _merge(intervals)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    group_s = {g: sum(device_s.get(n, 0.0) for n in names) for g, names in groups.items()}
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") != WINDOW_SPAN]
    idle: collections.Counter = collections.Counter()
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [s for s in spans if s["ts"] <= mid <= s["ts"] + s["dur"]]
        # the innermost span open at the gap's middle names what the host did
        name = min(open_, key=lambda s: s["dur"])["name"] if open_ else "no span"
        idle[name] += (b - a) * 1e-6
    return TraceStats(comp["complete"], comp["launches"], comp["kernels"], units,
                      (w1 - w0) * 1e-6, busy_s, dict(device_s), group_s, dict(idle))


def profile(run_units, units: int) -> TraceStats:
    """Profile `run_units(units)` (which ends in a synchronise) inside the
    window span, up to ATTEMPTS times until a window is complete; the last
    window is returned either way."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    groups = load_groups()
    stats = None
    for _ in range(ATTEMPTS):
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with record_function(WINDOW_SPAN):
                run_units(units)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        stats = reduce_events(events, units, groups)
        if stats.complete:
            break
    return stats
