"""Run one cell of the benchmark of `cadx_tpu_torch` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints the result as one JSON object, the last line of standard
output, and each compared number beside its limit as the last lines of
standard error. Exits non-zero, printing no result, without a CUDA card,
without the port beside this folder, or if JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()   # set-up counts from here: imports, build, warm-up

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# every build and kernel cache inside the checkout, at fixed paths, so that
# only a checkout's first run builds; no library loads JAX behind our back
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], ROOT, BENCH, T_START))
