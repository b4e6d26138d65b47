"""CPU tests of the benchmark harness.

    python -m pytest portbench/tests -q

`tiny_root` makes a checkout of the benchmark in a temporary directory
whose BENCHMARK.json adds the four CPU-sized cells of `tiny/cells.json`
to the real manifest from data files alone (`tiny/configs`,
`tiny/traffic`, `tiny/limits`), each listed wherever the real cell it is
`like` is listed, so that it reports the same metrics. The upload cell's
metrics, which the manifest does not list (PERF.md says why), come as new
entries from the same file, the tiny upload cell in their `workloads`.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = Path(__file__).resolve().parent / "tiny"
sys.path[:0] = [str(BENCH), str(ROOT)]


def make_tiny_root(dest: Path) -> Path:
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    extra = json.loads((TINY / "cells.json").read_text())
    manifest["configs"] += extra["configs"]
    manifest["end_to_end"] += extra["end_to_end"]
    manifest["per_layer"] += extra["per_layer"]
    for w in extra["workloads"]:
        like = w.pop("like")
        manifest["workloads"].append(w)
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(w["name"])
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    bench = dest / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
        if (TINY / sub).is_dir():
            for f in (TINY / sub).iterdir():
                shutil.copy(f, bench / sub / f.name)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))


def run_cell(root: Path, cell: str, seed: int = 2**33 + 5, seconds: float = 0.5,
             trace: int = 0) -> dict:
    """One run of a cell on the CPU (the look for a card skipped)."""
    import time

    from harness import runner

    args = runner.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                         "--trace", str(trace)])
    return runner.run(args, root, root / "portbench", time.perf_counter(), device="cpu")
