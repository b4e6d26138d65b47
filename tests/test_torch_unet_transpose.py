"""Ronneberger's U-Net in the port (`UNetConfig(up="transpose")`): the
forward, the Dice + BCE loss, every gradient and one Adam step of
`make_seg_train_step` against the plain reference `tests/reference_unet.py`
on seeded random weights under `full_fp32`; the nearest U-Net's draws left
as they were; the two plain references against each other; the
segmentation step's spans; and the benchmark's segmentation cell at a
CPU size, with its controls.

Tolerances (float32 on the CPU; the port runs its convs on channel-last
views and its pool through the pool kernel's plain version, the reference
on channel-first tensors through `F.max_pool2d`, so sums run in another
order; "measured" is the largest over 12 seeds of weights and data):
- forward, absolute 2e-6 on probabilities in (0, 1): float32 round-off
  through ten conv layers (measured 8.3e-7);
- loss, relative 1e-6: a mean of about 2,000 float32 terms (measured
  9.0e-8);
- gradients, max |d| / max |ref| per tensor 1e-5: sums over 2 x 32^2
  positions in another order, and where two pool inputs tie within
  rounding one term goes elsewhere (measured 8.2e-6, 1.2e-6 at the
  tested seed);
- Adam's first step, the norm of the update's difference over the
  update's norm, per tensor, 1e-3: an element moves by lr * g / (|g| +
  eps), so where |g| is within a few eps of 0 a gradient's round-off moves
  it by a large share of lr (measured 3.7e-4, 1.7e-6 at the tested seed).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import reference_unet as RU
from cadx_tpu_torch import convert
from cadx_tpu_torch.models import unet as TU
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.train import optim as TOpt
from cadx_tpu_torch.train import segmentation as TSeg
from cadx_tpu_torch.utils import profiling as TProf

ROOT = Path(__file__).resolve().parents[1]
FEATURES = (8, 16, 32)
LEVELS = len(FEATURES) - 1


def _model(seed=0, features=FEATURES, up="transpose"):
    return TU.init_unet(torch.Generator().manual_seed(seed),
                        TU.UNetConfig(features=features, up=up))


def _data(seed=1, b=2, hw=32):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, hw, hw, 1), generator=g)
    y = (torch.rand((b, hw, hw, 1), generator=g) > 0.8).to(torch.float32)
    return x, y


def _nchw(t):
    return t.permute(0, 3, 1, 2).contiguous()


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_forward_matches_reference():
    model = _model()
    x, _ = _data()
    with torch.no_grad(), full_fp32():
        ours = TU.unet_apply(model, x)
        ref = RU.unet(_params(model), _nchw(x), LEVELS)
    assert ours.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(_nchw(ours).numpy(), ref.numpy(), rtol=0, atol=2e-6)


def test_loss_and_every_gradient_match_reference():
    model = _model()
    x, y = _data()
    params = list(model.parameters())
    with full_fp32():
        loss = TSeg.dice_bce_loss(model, x, y)
        grads = torch.autograd.grad(loss, params)
        ref_params = {n: p.requires_grad_(True) for n, p in _params(model).items()}
        ref_loss = RU.dice_bce(ref_params, _nchw(x), _nchw(y), LEVELS)
        ref_grads = torch.autograd.grad(ref_loss, list(ref_params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss.detach()), rtol=1e-6)
    # every conv's weight and bias: 2 x (4 LEVELS + 2) convs and up-convolutions, the head
    assert len(grads) == 2 * (4 * LEVELS + 2 + LEVELS + 1)
    for (name, _), g, r in zip(model.named_parameters(), grads, ref_grads, strict=True):
        assert g.shape == r.shape
        assert float(r.abs().max()) > 0, name
        assert _rel(g, r) <= 1e-5, name


def test_seg_train_step_matches_reference():
    model = _model()
    x, y = _data()
    before = _params(model)
    ref_params = {n: p.clone().requires_grad_(True) for n, p in before.items()}
    with full_fp32():
        ref_loss = RU.dice_bce(ref_params, _nchw(x), _nchw(y), LEVELS)
        ref_grads = dict(zip(ref_params, torch.autograd.grad(ref_loss,
                                                             list(ref_params.values()))))
    expected = RU.adam({n: p.detach() for n, p in ref_params.items()}, ref_grads)
    tx = TOpt.adam(1e-3)
    state, loss = TSeg.make_seg_train_step(tx)(model, tx.init(model.parameters()), x, y)
    assert state.count == 1
    np.testing.assert_allclose(float(loss), float(ref_loss.detach()), rtol=1e-6)
    for name, p in model.named_parameters():
        ours, ref = p.detach() - before[name], expected[name] - before[name]
        assert float(ours.abs().max()) > 0, name
        assert float((ours - ref).norm() / ref.norm()) <= 1e-3, name


def test_fit_segmentation_trains_the_transpose_unet():
    """`fit_segmentation` takes the new mode unchanged: a copy trains (a
    tail batch of 1 wraps to 4), the caller's model is untouched."""
    model = _model(seed=2)
    before = _params(model)
    x, y = _data(seed=3, b=5)
    res = TSeg.fit_segmentation(model, x.numpy(), y.numpy(), x[:2].numpy(), y[:2].numpy(),
                                epochs=2, batch_size=4, device="cpu")
    assert [r["epoch"] for r in res.history] == [1, 2]
    assert all(np.isfinite(r["loss"]) and 0 <= r["val_dice"] <= 1 for r in res.history)
    assert res.model.config.up == "transpose"
    assert not torch.equal(res.model.up[0].weight.detach(), before["up.0.weight"])
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n])


def test_fit_segmentation_mesh_takes_the_transpose_unet():
    """Over a mesh of 4 CPU shards the batch's rows split and the gradients
    sum: the losses within 1e-5 of the one-device run (sums in another
    order), as the nearest U-Net's mesh test holds them."""
    from cadx_tpu_torch.parallel import mesh as M

    model = _model(seed=4)
    x, y = _data(seed=5, b=8)
    kw = dict(epochs=1, lr=3e-3, batch_size=8, device="cpu")
    res = TSeg.fit_segmentation(model, x.numpy(), y.numpy(), x[:2].numpy(), y[:2].numpy(),
                                mesh=M.make_mesh(devices=[torch.device("cpu")] * 4), **kw)
    ref = TSeg.fit_segmentation(model, x.numpy(), y.numpy(), x[:2].numpy(), y[:2].numpy(),
                                **kw)
    np.testing.assert_allclose(res.history[0]["loss"], ref.history[0]["loss"], rtol=0,
                               atol=1e-5)
    for a, b in zip(res.model.parameters(), ref.model.parameters(), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-5)


def test_published_widths_size():
    """Ronneberger's widths: 31,030,593 parameters in 46 tensors; the
    up-convolutions halve the channels and the decoder's first conv reads
    2f of them."""
    model = _model(features=(64, 128, 256, 512, 1024))
    params = list(model.parameters())
    assert len(params) == 46 and sum(p.numel() for p in params) == 31_030_593
    assert tuple(model.up[0].weight.shape) == (1024, 512, 2, 2)
    assert tuple(model.dec[0].conv1.weight.shape) == (512, 1024, 3, 3)
    assert abs(float(model.up[0].weight.std()) / (2.0 / 1024) ** 0.5 - 1) < 0.01
    assert all(float(u.bias.abs().max()) == 0 for u in model.up)


def _nearest_draws(seed, features):
    """The nearest U-Net's draws as they were before `up` existed."""
    g = torch.Generator().manual_seed(seed)

    def he(cin, f):
        return [torch.randn((f, cin, 3, 3), generator=g) * (2.0 / (9 * cin)) ** 0.5,
                torch.zeros(f)]

    out, cin = [], 1
    for f in features[:-1]:
        out += he(cin, f) + he(f, f)
        cin = f
    out += he(cin, features[-1]) + he(features[-1], features[-1])
    cin = features[-1]
    for f in reversed(features[:-1]):
        out += he(cin + f, f) + he(f, f)
        cin = f
    limit = (6.0 / (cin + 1)) ** 0.5
    return out + [(torch.rand((1, cin, 1, 1), generator=g) * 2 - 1) * limit, torch.zeros(1)]


def test_nearest_unet_draws_as_before():
    assert TU.UNetConfig() == TU.UNetConfig(up="nearest")
    model = _model(seed=3, up="nearest")
    assert not any(n.startswith("up.") for n, _ in model.named_parameters())
    for p, q in zip(model.parameters(), _nearest_draws(3, FEATURES), strict=True):
        assert torch.equal(p.detach(), q)
    # the encoder and bottleneck are drawn first, alike in both decoders
    t = _model(seed=3)
    for (n, p), (m, q) in zip(model.named_parameters(), t.named_parameters()):
        if n.startswith("dec."):
            break
        assert n == m and torch.equal(p, q)


def test_unknown_up_mode_raises():
    with pytest.raises(ValueError, match="nearest' or 'transpose"):
        TU.UNetConfig(up="bilinear")


def test_convert_unet_params_refuses_transpose():
    with pytest.raises(ValueError, match="up='transpose'"):
        convert.convert_unet_params({}, TU.UNetConfig(up="transpose"))


# ---- the benchmark's plain reference ---------------------------------------

@pytest.fixture(scope="module")
def portbench_modules():
    """`portbench/`'s harness and tiny-cell helpers on the path while the
    module's tests run."""
    saved = list(sys.path)
    sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]
    spec = importlib.util.spec_from_file_location(
        "portbench_tiny_conftest_unet", ROOT / "portbench" / "tests" / "conftest.py")
    tiny = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tiny)
    from harness.kinds import seg_train
    from harness.reference import unet as bench_ref
    yield tiny, bench_ref, seg_train
    sys.path[:] = saved


def _bench_cfg(features=FEATURES, hw=32):
    cfg = json.loads((ROOT / "portbench" / "configs" / "unet-ronneberger.json").read_text())
    return dict(cfg, features=list(features), image_hw=hw)


def test_the_two_references_agree(portbench_modules):
    """`tests/reference_unet.py` and `portbench/harness/reference/unet.py`
    (two implementations, the latter's pool an argmax and a scatter) give
    the same loss and gradients: the same float32 ops in the same order but
    the pool, so 1e-6 relative."""
    _, bench_ref, _ = portbench_modules
    params = _params(_model(seed=4))
    assert [n for n, _ in bench_ref.param_shapes(_bench_cfg())] == list(params)
    x, y = _data(seed=5)
    out = []
    for loss_fn in (lambda p: RU.dice_bce(p, _nchw(x), _nchw(y), LEVELS),
                    lambda p: bench_ref.dice_bce_loss(p, _bench_cfg(), _nchw(x), _nchw(y))):
        p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
        with full_fp32():
            loss = loss_fn(p)
            out.append((loss, torch.autograd.grad(loss, list(p.values()))))
    np.testing.assert_allclose(float(out[0][0]), float(out[1][0]), rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1], strict=True):
        assert _rel(b, a) <= 1e-6


def test_bench_weights_build_the_port(portbench_modules):
    """The benchmark's seeded weights name the port's parameters in its
    order, and the port's model over them computes the reference's
    forward."""
    _, bench_ref, seg_train = portbench_modules
    cfg = _bench_cfg()
    params = seg_train.init_params(torch.Generator().manual_seed(6), cfg)
    model = seg_train.port_unet(params, cfg)
    assert model.config.up == "transpose"
    x, _ = _data(seed=7)
    with torch.no_grad(), full_fp32():
        np.testing.assert_allclose(_nchw(TU.unet_apply(model, x)).numpy(),
                                   bench_ref.forward(params, cfg, _nchw(x)).numpy(),
                                   rtol=0, atol=2e-6)


def test_bench_masks_cover_their_share(portbench_modules):
    _, _, seg_train = portbench_modules
    X, Y = seg_train.make_data(torch.Generator().manual_seed(8), 20, 64, 128, [1, 3],
                               [0.01, 0.1])
    assert X.shape == Y.shape == (20, 64, 64, 1)
    assert float(X.min()) >= 0 and float(X.max()) <= 1
    share = Y.mean(dim=(1, 2, 3))
    assert set(Y.unique().tolist()) == {0.0, 1.0}
    assert float(share.min()) > 0.005 and float(share.max()) <= 0.11
    # brighter inside the ellipses than around them
    assert float((X * Y).sum() / Y.sum()) > float((X * (1 - Y)).sum() / (1 - Y).sum())


def test_bench_counting_at_published_widths(portbench_modules):
    from harness import unet_counting

    cfg = _bench_cfg(features=(64, 128, 256, 512, 1024), hw=512)
    assert unet_counting.forward_flops(cfg) == 384_735_117_312
    assert unet_counting.train_step_flops(cfg, 8) == 3 * 8 * 384_735_117_312


# ---- the benchmark's cell at a CPU size -------------------------------------

TINY_TRAFFIC = {"kind": "seg_train", "samples": 10, "batch": 4, "source_hw": 64,
                "lesions": [1, 3], "lesion_share": [0.01, 0.1], "steps_ahead": 2,
                "checked_steps": 3, "profile_units": 2}


@pytest.fixture(scope="module")
def seg_root(portbench_modules, tmp_path_factory):
    """A checkout of the benchmark whose BENCHMARK.json adds `unet-seg-tiny`:
    the configuration at features (4, 8, 16) and 32^2, 10 samples, B=4,
    under the real cell's limits and listed wherever the real cell is."""
    tiny, _, _ = portbench_modules
    root = tiny.make_tiny_root(tmp_path_factory.mktemp("seg_checkout"))
    bench = root / "portbench"
    cfg = dict(_bench_cfg(features=(4, 8, 16)), name="unet-tiny")
    (bench / "configs" / "unet-tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "seg-tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    shutil.copy(bench / "limits" / "unet-seg-train-b8.json",
                bench / "limits" / "unet-seg-tiny.json")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "unet-tiny", "source": "a CPU-sized unet-ronneberger",
                         "file": "portbench/configs/unet-tiny.json",
                         "reduced": ["features", "image_hw"], "why": "CPU tests"})
    m["workloads"].append({"name": "unet-seg-tiny", "config": "unet-tiny",
                           "traffic": "seg-tiny", "chips": 1, "why": "CPU tests"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "unet-seg-train-b8" in metric.get("workloads", []):
            metric["workloads"].append("unet-seg-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_seg_cell_runs_and_is_correct(portbench_modules, seg_root, trace):
    """Untraced: the end-to-end metrics. Traced: the metrics that read the
    host and the program (no card: `idle_share.seg` and
    `program_idle_ms.seg` left out, `adam_fused_leaves.seg` and
    `pool_bwd_kernel.seg` 0, since the CPU takes the plain Adam and the
    plain pool backward)."""
    tiny, _, _ = portbench_modules
    TProf.reset()
    r = tiny.run_cell(seg_root, "unet-seg-tiny", seconds=1.0, trace=trace)
    assert r["correct"], r["compared"]
    assert set(r["compared"]) == {"loss_rel_gap", "grad_norm_gap", "update_norm_gap"}
    assert r["attempted"] > 0 and r["failed"] == 0
    if trace:
        assert set(r["metrics"]) == {"mfu.seg", "enqueue_ms.seg", "adam_fused_leaves.seg",
                                     "pool_bwd_kernel.seg"}
        assert r["metrics"]["adam_fused_leaves.seg"]["value"] == 0
        assert r["metrics"]["pool_bwd_kernel.seg"]["value"] == 0
        assert r["metrics"]["mfu.seg"]["value"] > 0
    else:
        assert set(r["metrics"]) == {"train_samples_per_s", "setup_s"}
    TProf.reset()


@pytest.mark.parametrize("variant", ["tf32", "half_batch"])
def test_seg_cell_controls_fail(portbench_modules, seg_root, variant):
    """The reference in TF32, and the reference with half of each batch
    left out, in the program's place: each fails a limit of the cell."""
    import time

    from harness import runner

    spec = runner.load_spec(seg_root, seg_root / "portbench", "unet-seg-tiny")
    cell = runner.make_cell(spec, 2**33 + 9, "cpu")
    cell.setup()
    t0 = time.perf_counter()
    cell.start_window(t0, 0.5)
    while time.perf_counter() - t0 < 0.5:
        cell.unit()
    cell.finish()
    cell.release()
    assert all(c.ok for c in cell.check())
    readings = cell.control(variant)
    assert any(v > spec.limits[k] for k, v in readings.items()), readings


def test_seg_cell_refuses_a_port_without_up(portbench_modules, monkeypatch):
    """A port whose UNetConfig lacks `up` (the nearest decoder only) is
    refused before any step, never run with the nearest decoder."""
    _, _, seg_train = portbench_modules

    @dataclasses.dataclass(frozen=True)
    class OldConfig:
        in_channels: int = 1
        out_channels: int = 1
        features: tuple = (16, 32, 64, 128)
        final_activation: str = "sigmoid"

    monkeypatch.setattr(TU, "UNetConfig", OldConfig)
    cfg = _bench_cfg()
    with pytest.raises(RuntimeError, match="no `up`"):
        seg_train.port_unet(seg_train.init_params(torch.Generator().manual_seed(0), cfg), cfg)


# ---- the segmentation step's spans ------------------------------------------

def test_seg_step_spans_under_the_profiler():
    """One step under torch.profiler on the CPU records `train.step` ⊃
    `train.forward`, `.backward`, `.optimizer`, and `unet.encode` and
    `unet.decode` inside the forward, once each."""
    model = _model()
    x, y = _data()
    tx = TOpt.adam(1e-3)
    step = TSeg.make_seg_train_step(tx)
    state = tx.init(model.parameters())
    TProf.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(model, state, x, y)
    stats = TProf.span_stats()
    assert {k: v["parents"] for k, v in stats.items()} == {
        "train.step": {None}, "train.forward": {"train.step"},
        "train.backward": {"train.step"}, "train.optimizer": {"train.step"},
        "unet.encode": {"train.forward"}, "unet.decode": {"train.forward"}}
    assert all(v["calls"] == 1 and 0 <= v["self_s"] <= v["total_s"] for v in stats.values())
    TProf.reset()


def test_seg_step_records_nothing_outside_a_profiler():
    model = _model()
    x, y = _data()
    tx = TOpt.adam(1e-3)
    TProf.reset()
    TSeg.make_seg_train_step(tx)(model, tx.init(model.parameters()), x, y)
    assert TProf.span_stats() == {}
