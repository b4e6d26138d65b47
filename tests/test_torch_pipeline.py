"""Port parity for the whole slice, and the port's import guard.

`cadx_tpu_torch.pipeline.fused.run_pipeline` against
`cadx_tpu.pipeline.fused.run_pipeline` at 64² with the full-width
classifier (its 32x32x64 input does not depend on the image size), B=2,
on converted JAX weights. Every `PipelineOutput` field is checked:
clean_u8 exact, probs 2e-5, features 1e-5, heatmaps and overlays +-2 u8.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.pipeline import fused as JF
from cadx_tpu_torch import convert
from cadx_tpu_torch.pipeline import fused as TF
from cadx_tpu_torch.synthetic import synthetic_mammograms
from synthetic_mammo import make_mammo

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def setup():
    jcfg = JF.PipelineConfig(image_hw=(64, 64))
    jp = JF.init_pipeline_params(jax.random.key(0), jcfg)
    tp = convert.convert_pipeline_params(jax.tree_util.tree_map(np.asarray, jp),
                                         TF.PipelineConfig(image_hw=(64, 64)))
    return jcfg, jp, tp


def _batch(kind):
    if kind == "bench":
        return synthetic_mammograms(2, 64, seed=11)
    return np.stack([make_mammo(s, h=64, w=64) for s in (5, 6)])


def _check_outputs(out, ref, *, features_atol=1e-5):
    np.testing.assert_array_equal(out.clean_u8.numpy(), np.asarray(ref.clean_u8))
    np.testing.assert_allclose(out.probs.numpy(), np.asarray(ref.probs), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(out.predicted.numpy(), np.asarray(ref.predicted))
    np.testing.assert_allclose(out.features.numpy(), np.asarray(ref.features),
                               rtol=0, atol=features_atol)
    for name in ("heatmaps", "overlays"):
        a = getattr(out, name).numpy().astype(np.int32)
        b = np.asarray(getattr(ref, name)).astype(np.int32)
        assert a.shape == b.shape
        assert np.abs(a - b).max(initial=0) <= 2, name


@pytest.mark.parametrize("kind", ["bench", "mammo"])
def test_run_pipeline_matches_jax(setup, kind):
    jcfg, jp, tp = setup
    x = _batch(kind)
    ref = JF.run_pipeline(jp, jnp.asarray(x), jcfg)
    out = TF.run_pipeline(tp, torch.from_numpy(x), TF.PipelineConfig(image_hw=(64, 64)))
    assert out.overlays.shape == (2, 2, 64, 64, 3)
    assert out.heatmaps.dtype == torch.uint8 and out.overlays.dtype == torch.uint8
    _check_outputs(out, ref)
    csum = TF.run_pipeline_checksum(tp, torch.from_numpy(x),
                                    TF.PipelineConfig(image_hw=(64, 64)))
    np.testing.assert_allclose(float(csum),
                               float(JF.run_pipeline_checksum(jp, jnp.asarray(x), jcfg)),
                               rtol=1e-4)


def test_run_pipeline_bfloat16_features(setup):
    _, jp, tp = setup
    x = _batch("bench")
    jcfg = JF.PipelineConfig(image_hw=(64, 64), feature_dtype="bfloat16")
    ref = JF.run_pipeline(jp, jnp.asarray(x), jcfg)
    out = TF.run_pipeline(tp, torch.from_numpy(x),
                          TF.PipelineConfig(image_hw=(64, 64), feature_dtype="bfloat16"))
    # one bf16 rounding of the conv1 features; a 1-ulp flip of a value
    # near 1 is 2**-8
    _check_outputs(out, ref, features_atol=4e-3)


def test_run_pipeline_without_explanations(setup):
    _, jp, tp = setup
    x = _batch("bench")
    jcfg = JF.PipelineConfig(image_hw=(64, 64), classes_to_explain=())
    ref = JF.run_pipeline(jp, jnp.asarray(x), jcfg)
    out = TF.run_pipeline(tp, torch.from_numpy(x),
                          TF.PipelineConfig(image_hw=(64, 64), classes_to_explain=()))
    assert out.overlays.shape == (2, 0, 64, 64, 3)
    assert out.heatmaps.shape == (2, 0, 64, 64)
    _check_outputs(out, ref)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("target", ["cadx_tpu_torch", "chip_smoke.py"])
def test_port_imports_neither_jax_nor_the_jax_package(target):
    path = ROOT / target
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "cadx_tpu")]
    assert not bad, bad
