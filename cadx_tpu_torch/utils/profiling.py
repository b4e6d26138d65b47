"""Tracing and profiling utilities.

Port of `cadx_tpu/utils/profiling.py` (the reference has none, only a
wall-clock "Training Time" string):

- StageTimer: per-stage wall times; each stage synchronises the card
  before it reads the clock, so a stage owns the device work it queued.
- trace(): a torch.profiler window (host and card) written as a Chrome
  trace, `trace_<pid>_<n>.json` under `log_dir`, which
  `tools/trace_summary.py` reads.
- throughput(): calls queued back to back and one synchronisation at the
  end, so the host's enqueue overlaps the card's work.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Callable

import torch

_TRACES = itertools.count()


def _sync(value=None) -> None:
    """Wait for the card: the devices of `value`'s CUDA tensors (a tensor
    or a list, tuple or dict of them), or the current one when `value` is
    None and CUDA is in use."""
    if value is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                torch.cuda.synchronize(v.device)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)


class StageTimer:
    """Collects {stage: seconds}; every stage's exit waits for the card."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync_value)
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k}: {v*1000:.1f} ms ({v/max(total,1e-12)*100:.0f}%)"
                 for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])]
        lines.append(f"total: {total*1000:.1f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler window over the block (the card's activity too
    where CUDA is available), exported as a Chrome trace under `log_dir`;
    yields the profiler. The card is synchronised before the window
    closes."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json"))


def throughput(fn: Callable, *args, iters: int = 10, items_per_call: int = 1):
    """(items/sec, sec/call): one warm call, then `iters` calls queued
    back to back and one synchronisation at the end."""
    _sync(fn(*args))
    _sync()
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    _sync()
    per_call = (time.perf_counter() - t0) / iters
    return items_per_call / per_call, per_call
