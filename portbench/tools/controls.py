"""Readings that set the limits of `correct`: the program's compared
numbers on many seeds, and the control's (the plain reference in TF32,
the precision below the configuration's float32, in the program's place)
and, for training, a fault's (half of each batch left out), on the same
inputs, each in one process at the cell's own size:

    python3 portbench/tools/controls.py --workload <cell> --seconds 2 \\
        --seeds 11 12 ... --control-seeds 11 12 13 [--variants tf32 half_batch]

Prints one JSON line a seed. The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def readings(spec, seed: int, seconds: float, variants, device) -> dict:
    from harness import runner

    cell = runner.make_cell(spec, seed, device)
    cell.setup()
    t0 = time.perf_counter()
    cell.start_window(t0, seconds)
    while time.perf_counter() - t0 < seconds:
        cell.unit()
    cell.finish()
    cell.release()
    gc.collect()
    out = {"seed": seed, "program": {c.name: c.value for c in cell.check()}}
    for v in variants:
        out[v] = cell.control(v)
    return out


def main(argv) -> int:
    from harness import runner

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--variants", nargs="*", default=["tf32"])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    spec = runner.load_spec(ROOT, BENCH, args.workload)
    for seed in args.seeds:
        variants = args.variants if seed in args.control_seeds else []
        print(json.dumps(readings(spec, seed, args.seconds, variants, args.device)), flush=True)
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
