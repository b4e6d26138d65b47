"""Each kind of cell end to end at a tiny size on the CPU, where the port's
kernels take their plain versions; its control (the reference in TF32)
and the faults the comparison has to reject."""

from __future__ import annotations

import dataclasses
import importlib
import time

import pytest
import torch
from conftest import run_cell

TINY = ["basic-bulk-tiny", "advanced-upload-tiny", "advanced-train-tiny",
        "advanced-featurize-tiny"]
E2E = {"basic-bulk-tiny": "bulk_img_per_s", "advanced-upload-tiny": "upload_p95_ms",
       "advanced-train-tiny": "train_samples_per_s",
       "advanced-featurize-tiny": "featurize_img_per_s"}


@pytest.mark.parametrize("cell", TINY)
def test_cell_runs_and_is_correct(tiny_root, cell):
    r = run_cell(tiny_root, cell)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {E2E[cell], "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "compared"
    assert r["device"]["platform"] == "cpu" and r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", TINY)
def test_traced_run_reads_host_metrics(tiny_root, cell):
    r = run_cell(tiny_root, cell, trace=1)
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device records on the CPU: device metrics are left out, never 0
    assert not any(k.startswith(("idle_share", "clean_device_ms", "conv_leaky_roofline",
                                 "watershed_pair_roofline")) for k in r["metrics"])


def _cell(tiny_root, name, seed=2**33 + 7):
    from harness import runner

    spec = runner.load_spec(tiny_root, tiny_root / "portbench", name)
    cell = runner.make_cell(spec, seed, "cpu")
    cell.setup()
    t0 = time.perf_counter()
    cell.start_window(t0, 0.5)
    while time.perf_counter() - t0 < 0.5:
        cell.unit()
    cell.finish()
    cell.release()
    return cell, spec


@pytest.mark.parametrize("cell", TINY)
def test_control_is_not_correct(tiny_root, cell):
    """The reference in TF32 in the program's place fails a limit."""
    c, spec = _cell(tiny_root, cell)
    assert all(x.ok for x in c.check())
    readings = c.control("tf32")
    assert any(v > spec.limits[k] for k, v in readings.items()), readings


def test_half_batch_fault_is_not_correct(tiny_root):
    c, spec = _cell(tiny_root, "advanced-train-tiny")
    readings = c.control("half_batch")
    assert any(v > spec.limits[k] for k, v in readings.items()), readings


def _alter_first(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    flat = t.view(-1)
    flat[0] = flat[0] + (1 if not t.dtype.is_floating_point else 0.5)
    return t


def test_bulk_faults(tiny_root, monkeypatch):
    """An answer altered where the pipeline produces it: a cleaned pixel,
    a probability, a heatmap, an overlay."""
    from cadx_tpu_torch.pipeline import fused

    real = fused.run_pipeline
    for field in ("clean_u8", "probs", "heatmaps", "overlays", "features"):
        def broken(params, batch, config, field=field):
            out = real(params, batch, config)
            if field in ("heatmaps", "overlays"):   # the whole explanation of image 0
                return out._replace(**{field: getattr(out, field) ^ 1})
            return out._replace(**{field: _alter_first(getattr(out, field))})
        monkeypatch.setattr(fused, "run_pipeline", broken)
        assert not run_cell(tiny_root, "basic-bulk-tiny")["correct"], field
    monkeypatch.setattr(fused, "run_pipeline", real)


def test_upload_faults(tiny_root, monkeypatch):
    from cadx_tpu_torch.serve import engine

    real_seg = engine.InferenceEngine.process_single_image
    real_roi = engine.InferenceEngine.classify_and_roi

    def bad_clean(self, img, cache_token=None):
        feats, clean = real_seg(self, img, cache_token)
        clean = clean.copy()
        clean[0, 0] ^= 1
        return feats, clean

    def bad_roi(self, *a, **k):
        res, coords = real_roi(self, *a, **k)
        coords = [dict(c) for c in coords]
        coords[0]["top"] = round(coords[0]["top"] + 0.0156, 4)
        return res, coords

    def bad_probs(self, *a, **k):
        res, coords = real_roi(self, *a, **k)
        res = dict(res, prediction_probabilities=[p + 1e-3 for p in
                                                  res["prediction_probabilities"]])
        return res, coords

    for name, fn in (("process_single_image", bad_clean), ("classify_and_roi", bad_roi),
                     ("classify_and_roi", bad_probs)):
        monkeypatch.setattr(engine.InferenceEngine, name, fn)
        assert not run_cell(tiny_root, "advanced-upload-tiny")["correct"], fn.__name__
        monkeypatch.setattr(engine.InferenceEngine, "process_single_image", real_seg)
        monkeypatch.setattr(engine.InferenceEngine, "classify_and_roi", real_roi)


def test_train_faults(tiny_root, monkeypatch):
    """A step that leaves its state unchanged; a step that leaves half of
    the batch out and takes the mean over the rest."""
    from cadx_tpu_torch.train import step

    real = step.make_adam_train_step

    def unchanged(tx, compute_dtype=None):
        def fn(model, opt_state, x, y, mask, generator):
            return opt_state, torch.zeros(())
        return fn

    def half(tx, compute_dtype=None):
        inner = real(tx, compute_dtype)

        def fn(model, opt_state, x, y, mask, generator):
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0.0
            return inner(model, opt_state, x, y, mask, generator)
        return fn

    for fault in (unchanged, half):
        monkeypatch.setattr(step, "make_adam_train_step", fault)
        assert not run_cell(tiny_root, "advanced-train-tiny")["correct"], fault.__name__
    monkeypatch.setattr(step, "make_adam_train_step", real)


def test_featurize_fault(tiny_root, monkeypatch):
    from cadx_tpu_torch.tools import train

    real = train.featurize

    def altered(*a, **k):
        f = real(*a, **k).copy()
        f[0, 0, 0] += 1e-3 * abs(f).max()
        return f

    monkeypatch.setattr(train, "featurize", altered)
    assert not run_cell(tiny_root, "advanced-featurize-tiny")["correct"]


def test_missing_answers_are_not_correct(tiny_root, monkeypatch):
    """A window too short to reach the answers drawn for the check."""
    from harness import runner

    real = runner.load_spec

    def short(root, bench, cell):
        spec = real(root, bench, cell)
        return dataclasses.replace(spec, traffic=dict(spec.traffic, check_within=10_000,
                                                      check_requests=1))
    monkeypatch.setattr(runner, "load_spec", short)
    assert not run_cell(tiny_root, "advanced-upload-tiny", seconds=0.01)["correct"]


@pytest.mark.cuda
def test_controls_on_the_card_at_cell_size():
    """The control at the cells' own sizes: run on the card by
    `python3 portbench/tools/controls.py` (see PERF.md); here it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cells' sizes runs on the card")
    from harness import runner

    spec = runner.load_spec(runner.Path(__file__).resolve().parents[2],
                            runner.Path(__file__).resolve().parents[1], "basic-bulk256")
    controls = importlib.import_module("tools.controls")
    out = controls.readings(spec, 2**31 + 11, 2.0, ["tf32"], "cuda:0")
    assert all(v <= spec.limits[k] for k, v in out["program"].items())
    assert any(v > spec.limits[k] for k, v in out["tf32"].items())
