"""The port imports nothing of JAX, nothing of the JAX package, and
neither cv2 nor PIL.

Every module of `cadx_tpu_torch` (the compat classes, the DICOM demo
loader, the profiling tools, the trace summary and the stdout tee among
them), and every import statement of `chip_smoke.py`, is imported in a
fresh interpreter in which `jax`,
`jaxlib`, `cadx_tpu`, `cv2` and `PIL` cannot be imported
(`sys.modules[name] = None` makes any such import raise ImportError).
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import ast, importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "cadx_tpu", "cv2", "PIL")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import cadx_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cadx_tpu_torch.__path__, "cadx_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("cadx_tpu_torch.compat.classes", "cadx_tpu_torch.compat.load",
             "cadx_tpu_torch.utils.profiling", "cadx_tpu_torch.tools.trace_summary",
             "cadx_tpu_torch.utils.logging"):
    assert name in names, name
tree = ast.parse(open(sys.argv[1] + "/chip_smoke.py").read())
n = 0
for node in ast.walk(tree):
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), {})
        n += 1
print(len(names), n)
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    modules, imports = (int(v) for v in out.stdout.split())
    assert modules >= 84 and imports > 30
