"""Tracing and profiling utilities.

Port of `cadx_tpu/utils/profiling.py` (the reference has none, only a
wall-clock "Training Time" string), with the port's own spans and
counters:

- trace(): a torch.profiler window (host and card) written as a Chrome
  trace, `trace_<pid>_<n>.json` under `log_dir`, which
  `tools/trace_summary.py` reads.
- span(name): a stage of the program. While a torch.profiler session
  records, it is a `record_function` range named "cadx.<name>" on the
  profiler's own timeline (the clock of the card's records), and its host
  seconds, self seconds (less its child spans) and the counts bumped
  inside it add to per-name stats (`span_stats`); the calling thread's
  open spans give each its parent. Otherwise it is one shared null
  context: one `_profiler_enabled()` check and nothing more.
- count(name, n): a program counter, always added to the process's
  totals (`counts`) and, while spans record, to every open span's counts.
  `host_sync(device, n)` counts `host_syncs`, the places where the port
  blocks the host on the card, for a CUDA device only.
- reset(): clears the stats and the totals.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch

_TRACES = itertools.count()
SPAN_PREFIX = "cadx."
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()        # .stack: the thread's open spans, innermost last
_totals: collections.Counter = collections.Counter()
_stats: dict = {}                 # span name -> _Stats


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
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json"))


class _Stats:
    __slots__ = ("calls", "total_s", "self_s", "counts", "parents")

    def __init__(self):
        self.calls = 0
        self.total_s = 0.0
        self.self_s = 0.0
        self.counts: collections.Counter = collections.Counter()
        self.parents: set = set()


class _Span:
    """One open span while the profiler records (see `span`)."""
    __slots__ = ("name", "rf", "t0", "child_s", "counts")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self.rf.__enter__()
        self.child_s = 0.0
        self.counts: collections.Counter = collections.Counter()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter() - self.t0
        stack = _local.stack
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_s += total
        with _lock:
            s = _stats.get(self.name)
            if s is None:
                s = _stats[self.name] = _Stats()
            s.calls += 1
            s.total_s += total
            s.self_s += total - self.child_s
            s.counts.update(self.counts)
            s.parents.add(parent.name if parent is not None else None)
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """The program stage `name` as a context manager: a profiler range
    "cadx.<name>" and per-name stats while a torch.profiler session
    records, else a shared null context."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`: to the process's totals, and to every
    span open on this thread."""
    with _lock:
        _totals[name] += n
    for s in getattr(_local, "stack", ()):
        s.counts[name] += n


def host_sync(device: torch.device, n: int = 1) -> None:
    """Count n places where the host waits for the card (`host_syncs`):
    a blocking copy between the card and pageable host memory, or a wait
    on an event. Nothing for a device other than CUDA."""
    if device.type == "cuda":
        count("host_syncs", n)


def counts() -> dict:
    """The process's counter totals since the last `reset`."""
    with _lock:
        return dict(_totals)


def span_stats() -> dict:
    """{span name: {"calls", "total_s", "self_s", "counts" (the counts
    bumped while it was open), "parents" (the names of the spans it was
    opened inside; None at the top)}} of the spans recorded since the last
    `reset`."""
    with _lock:
        return {k: {"calls": s.calls, "total_s": s.total_s, "self_s": s.self_s,
                    "counts": dict(s.counts), "parents": set(s.parents)}
                for k, s in _stats.items()}


def reset() -> None:
    with _lock:
        _totals.clear()
        _stats.clear()
