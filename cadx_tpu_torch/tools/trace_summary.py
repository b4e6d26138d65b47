"""Summarise a torch.profiler Chrome trace into a per-kernel device-time
table.

Port of `cadx_tpu/tools/trace_summary.py`: which kernels own the card's
time, as one command over the trace that `utils/profiling.py::trace`
writes (`*.json`, or a gzipped `*.json.gz`; the newest by name under the
directory):

    python -m cadx_tpu_torch.tools.trace_summary TRACE_DIR

Device time is the card's records: kernels (category "kernel"), memsets
and copies. The profiler can lose the card's records of the port's
ctypes launches late in a long process (PERF.md §7), so the table says
whether the window is whole: the runtime's launch records (host side)
against the kernel records (card side); where they differ it reads
"incomplete".

Where the trace holds the port's own spans (`utils/profiling.py::span`,
ranges named "cadx.*"), two tables follow: each span's calls, host ms and
self ms (less its child spans), and the card's idle ms by the innermost
span open at each idle gap's middle.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys

# the card's record categories, and the runtime calls that launch a kernel
DEVICE_CATEGORIES = ("kernel", "gpu_memset", "gpu_memcpy")
SPAN_PREFIX = "cadx."   # utils/profiling.py::SPAN_PREFIX
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx")


def latest_trace(trace_dir: str) -> str:
    """The newest (by name) Chrome trace under trace_dir, or trace_dir
    itself when it is a file."""
    if os.path.isfile(trace_dir):
        return trace_dir
    paths = sorted(glob.glob(f"{trace_dir}/**/*.json", recursive=True)
                   + glob.glob(f"{trace_dir}/**/*.json.gz", recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *.json or *.json.gz trace under {trace_dir}")
    return paths[-1]


def load_events(trace_dir: str) -> list:
    path = latest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def completeness(events: list) -> dict:
    """{"launches": the runtime's kernel launch records, "kernels": the
    card's kernel records, "complete": whether the two agree}."""
    launches = sum(1 for e in events
                   if e.get("cat") == "cuda_runtime" and e.get("name") in LAUNCH_CALLS)
    kernels = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
    return {"launches": launches, "kernels": kernels, "complete": launches == kernels}


def summarize(trace_dir: str, top: int = 25) -> tuple[list[tuple[str, float, int]], float]:
    """([(kernel name, total device ms, count)] sorted by total time,
    total device ms across ALL of the card's records, not just the top-N
    shown)."""
    tot: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in load_events(trace_dir):
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        tot[e["name"]] += e.get("dur", 0)
        cnt[e["name"]] += 1
    total_ms = sum(tot.values()) / 1000.0
    return ([(name, us / 1000.0, cnt[name]) for name, us in tot.most_common(top)],
            total_ms)


def _program_spans(events: list) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(SPAN_PREFIX)]


def program_spans(events: list) -> list[tuple[str, int, float, float]]:
    """[(span, calls, total ms, self ms)] of the port's spans, by total;
    self time is less the time its child spans on the same thread cover."""
    threads = collections.defaultdict(list)
    for e in _program_spans(events):
        threads[(e.get("pid"), e.get("tid"))].append(e)
    calls: collections.Counter = collections.Counter()
    total: collections.Counter = collections.Counter()
    own: collections.Counter = collections.Counter()

    def close(frame):
        e, child_us = frame
        calls[e["name"]] += 1
        total[e["name"]] += e["dur"]
        own[e["name"]] += e["dur"] - child_us

    for evs in threads.values():
        stack: list = []        # [span, its children's us], outermost first
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            while stack and e["ts"] >= stack[-1][0]["ts"] + stack[-1][0]["dur"]:
                close(stack.pop())
            if stack:
                stack[-1][1] += e["dur"]
            stack.append([e, 0.0])
        while stack:
            close(stack.pop())
    return [(n, calls[n], us / 1e3, own[n] / 1e3) for n, us in total.most_common()]


def idle_by_span(events: list) -> dict[str, float]:
    """{span: ms} of the card's idle time between the first program span's
    start and the last one's end, each idle gap filed under the innermost
    program span open at its middle ("no span" where none is)."""
    spans = _program_spans(events)
    if not spans:
        return {}
    w0 = min(e["ts"] for e in spans)
    w1 = max(e["ts"] + e["dur"] for e in spans)
    busy: list[list[float]] = []
    for a, b in sorted((max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1))
                       for e in events
                       if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES):
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    idle: collections.Counter = collections.Counter()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [e for e in spans if e["ts"] <= mid <= e["ts"] + e["dur"]]
        idle[min(open_, key=lambda e: e["dur"])["name"] if open_ else "no span"] += (b - a) / 1e3
    return dict(idle.most_common())


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__)
        return 2
    rows, total = summarize(argv[1])
    # percent of TOTAL device time (all kernels), not of the top-N sum,
    # else every row's share is overstated when the tail is long
    shown = sum(ms for _, ms, _ in rows)
    print(f"{'device ms':>10}  {'%':>5}  {'count':>5}  kernel")
    for name, ms, n in rows:
        print(f"{ms:10.2f}  {100 * ms / max(total, 1e-9):5.1f}  {n:5d}  {name[:90]}")
    if total > shown:
        print(f"{total - shown:10.2f}  {100 * (total - shown) / total:5.1f}  "
              f"{'':>5}  (other kernels below top-{len(rows)})")
    events = load_events(argv[1])
    c = completeness(events)
    state = "complete" if c["complete"] else "incomplete"
    print(f"window {state}: {c['launches']} kernel launches on the host, "
          f"{c['kernels']} kernel records on the card")
    spans = program_spans(events)
    if spans:
        print(f"{'calls':>6}  {'host ms':>10}  {'self ms':>10}  program span")
        for name, n, ms, own in spans:
            print(f"{n:6d}  {ms:10.3f}  {own:10.3f}  {name}")
        print(f"{'idle ms':>10}  card idle under the innermost program span")
        for name, ms in idle_by_span(events).items():
            print(f"{ms:10.3f}  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
