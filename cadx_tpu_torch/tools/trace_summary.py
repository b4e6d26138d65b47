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
    c = completeness(load_events(argv[1]))
    state = "complete" if c["complete"] else "incomplete"
    print(f"window {state}: {c['launches']} kernel launches on the host, "
          f"{c['kernels']} kernel records on the card")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
