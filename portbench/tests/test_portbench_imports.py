"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from harness.runner import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _imports(path: Path) -> set[str]:
    """Top-level names of every absolute import in a file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["cadx_tpu_torch", "cadx_tpu_torch.kernels", "jaxtyping",
                              "flaxen", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "cadx_tpu.ops", "jaxlib", "flax.linen"]) == \
        ["cadx_tpu", "flax", "jax", "jaxlib"]


@pytest.mark.parametrize("path", sorted((BENCH / "harness" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert _imports(path) <= {"__future__", "contextlib", "dataclasses", "functools", "math",
                              "typing", "numpy", "torch"}


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py")
                                        if "__pycache__" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    assert not _imports(path) & set(FORBIDDEN)


_BLOCKED_RUN = r"""
import importlib.abc, json, sys, time
from pathlib import Path
BLOCK = ("jax", "jaxlib", "flax", "cadx_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1], sys.argv[2]]
sys.path.insert(0, sys.argv[3])
from conftest import make_tiny_root, run_cell
root = make_tiny_root(Path(sys.argv[4]))
for cell in ("basic-bulk-tiny", "advanced-upload-tiny", "advanced-train-tiny",
             "advanced-featurize-tiny"):
    assert run_cell(root, cell, seconds=1.0)["correct"], cell
from harness.runner import forbidden_modules
print(json.dumps({"forbidden": forbidden_modules(),
                  "port": sorted(m for m in sys.modules if m.startswith("cadx_tpu_torch"))[:3]}))
"""


def test_a_run_loads_no_jax(tmp_path):
    """Every kind of cell, run in a process where importing JAX or the JAX
    package fails, loads neither."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(BENCH), str(ROOT),
                          str(Path(__file__).parent), str(tmp_path)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["forbidden"] == [] and result["port"]


def test_run_py_refuses_without_a_card_or_the_port(tmp_path):
    """No card: a non-zero exit and no result line. A checkout holding only
    BENCHMARK.json and the benchmark's folder: the same."""
    cmd = [sys.executable, str(BENCH / "run.py"), "--workload", "basic-bulk256", "--seed",
           str(2**33), "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and '"correct"' not in out.stdout
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(BENCH), str(bare / "portbench")], check=True)
    cmd[1] = str(bare / "portbench" / "run.py")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=bare)
    assert out.returncode != 0 and '"correct"' not in out.stdout
