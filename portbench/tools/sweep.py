"""The highest arrival rate an open-loop cell sustains, found once by a
sweep: one process sets the cell up, then runs a window at each rate and
prints, per rate, the requests served, the latency p50 and p95 (from
arrival) and how late the last request started. A rate is sustained when
the last request starts about as late as a typical one, so the backlog
does not grow over the window.

    python3 portbench/tools/sweep.py --workload advanced-upload-ffdm \\
        --seed 7 --seconds 20 --rates 10 12 14 16 18
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv) -> int:
    from harness import runner
    from harness.kinds.upload import nearest_rank

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = runner.load_spec(ROOT, BENCH, args.workload)
    cell = runner.make_cell(spec, args.seed, "cuda:0")
    cell.setup()
    for rate in args.rates:
        cell.traffic = dict(cell.traffic, rate_per_s=rate)
        cell.latencies, cell.late, cell.n = [], [], 0
        t0 = time.perf_counter()
        cell.start_window(t0, args.seconds)
        while time.perf_counter() - t0 < args.seconds:
            cell.unit()
        cell.finish()
        lat = cell.latencies
        print(json.dumps({"rate_per_s": rate, "served": len(lat),
                          "p50_ms": nearest_rank(lat, 0.5) * 1e3,
                          "p95_ms": nearest_rank(lat, 0.95) * 1e3,
                          "late_median_ms": nearest_rank(cell.late, 0.5) * 1e3,
                          "last_late_ms": cell.late[-1] * 1e3,
                          "drain_s": time.perf_counter() - t0 - args.seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
