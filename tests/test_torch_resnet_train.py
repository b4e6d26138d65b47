"""ResNet training in the port (`models/resnet.py::train_logits`,
`train/classifier.py`, the training batch norm of `kernels/batchnorm.py`)
against the plain reference `tests/reference_resnet.py` on seeded random
weights, on the CPU (the kernels' plain versions), in float32 with TF32
off; the plain batch norm against `F.batch_norm(training=True)`; the
inference path on the running statistics a training step leaves.

Every comparison is with a float64 run of the reference: in float32 the
reference's autograd through its written-out statistics strays by itself
(one small net's projection gradient by 0.38 of its largest element,
where the port's is within 1.7e-6 of float64). Tolerances:
- the small net (bottleneck, layers (1, 1, 1, 1), widths 8-64, 64x48,
  B=4), "measured" the largest over 8 seeds: loss relative 5e-6 (a mean of 4 log-softmaxes after 17 float32
  conv and batch-norm layers; measured 1.6e-6); each gradient max |d| /
  max |ref| 5e-5 (float32 sums over (B, H, W) through 17 layers; measured
  1.3e-5); the running statistics max |d| / max |ref| 5e-6 (measured
  1.6e-6);
- the published widths ((3, 4, 6, 3), 64-512, 64x64, B=2) are
  ill-conditioned in float32: layer4's batch norms see 8 values a
  channel, layer3's 32, and a float32 run of the reference strays from
  the float64 one by up to 1.1e-4 in the loss and 4.4e-2 in the
  gradients' norm (8 seeds). So the port is held to it as a float32
  implementation can be: loss relative 5e-4 (measured 1.14e-4), all
  gradients' norm relative 0.1 (measured 3.3e-2), the running statistics'
  norm relative 5e-5 (measured 7.0e-6);
- Adam's first step: against the reference's update from the port's own
  gradients, each parameter within 4 float32 ulps of itself plus 1e-9
  (the same few operations; a batch norm's weight at 1.0 moved by lr =
  1e-3 is known to 1.2e-4 of its step); against the reference's update
  from the float64 gradients, the norm of the steps' difference over the
  step's norm a tensor 3e-4 (measured 9.1e-5) on the elements whose
  gradient is at least 1e-5 of its tensor's largest: Adam moves an element
  by lr g / (|g| + 1e-8), and a gradient that is a cancellation at
  round-off level takes any step in [-lr, lr];
- the plain batch norm against `F.batch_norm(training=True)`: outputs
  2e-6 absolute (normalised values of a few units), the running
  statistics 1e-6 relative, the gradients max |d| / max |ref| 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import reference_resnet as RR
from cadx_tpu_torch.kernels import batchnorm as KBN
from cadx_tpu_torch.models import resnet as TR
from cadx_tpu_torch.models import unet as TU
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.train import classifier as TC
from cadx_tpu_torch.train import optim as TOpt

SMALL = dict(layers=(1, 1, 1, 1), widths=(8, 16, 32, 64), hw=(64, 48), b=4)
PUBLISHED = dict(layers=(3, 4, 6, 3), widths=(64, 128, 256, 512), hw=(64, 64), b=2)


def _model(layers, widths, seed=0, block="bottleneck"):
    return TR.init_resnet(torch.Generator().manual_seed(seed),
                          TR.ResNetConfig(block, layers, widths, 1, 2))


def _data(hw, b, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, hw[0], hw[1], 1), generator=g)
    return x, torch.arange(b) % 2


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _stats(model):
    return {n: t.clone() for n, t in model.named_buffers()
            if not n.endswith("num_batches_tracked")}


def _reference(model, x, y, dtype=torch.float64):
    """(loss, gradients in the port's order, running statistics after the
    step) of the reference, its parameters and inputs in `dtype`."""
    p = {k: v.to(dtype).requires_grad_(True) for k, v in _params(model).items()}
    stats = {k: v.to(dtype) for k, v in _stats(model).items()}
    with full_fp32():
        loss = RR.cross_entropy(RR.logits(p, stats, x.permute(0, 3, 1, 2).to(dtype),
                                          model.config.layers), y)
        grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), [g.detach() for g in grads], stats


def _port_step(model, x, y):
    """One `make_resnet_train_step` step: (loss, the step's gradients from
    Adam's first moment, the optimiser state)."""
    tx = TOpt.adam(1e-3)
    state, loss = TC.make_resnet_train_step(tx)(model, tx.init(model.parameters()), x, y)
    assert state.count == 1
    return float(loss), [m / (1 - tx.b1) for m in state.mu], state


def _rel_max(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def _rel_norm(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _flat(ts):
    return torch.cat([t.double().reshape(-1) for t in ts])


def _close_to_own(p, own, name):
    """The port's parameter after Adam's step against the reference's
    update from the same gradients: within 4 float32 ulps of the parameter
    (the last add rounds to the parameter's ulp, 2^-23 of it), plus 1e-9
    for the update's own rounding near 0."""
    assert bool((p - own).abs().le(4 * 2.0 ** -23 * own.abs() + 1e-9).all()), name


def _check_adam(model, before, grads, ref_grads):
    names = list(before)
    own = RR.adam(before, dict(zip(names, grads)))
    ref = RR.adam({k: v.double() for k, v in before.items()}, dict(zip(names, ref_grads)))
    for (name, p), r in zip(model.named_parameters(), ref_grads, strict=True):
        step = p.detach() - before[name]
        assert float(step.abs().max()) > 0, name
        _close_to_own(p.detach(), own[name], name)
        big = r.abs() >= 1e-5 * r.abs().max()
        assert _rel_norm(step[big], (ref[name] - before[name])[big]) <= 3e-4, name


def test_small_net_step_matches_reference():
    model = _model(SMALL["layers"], SMALL["widths"])
    x, y = _data(SMALL["hw"], SMALL["b"])
    before = _params(model)
    ref_loss, ref_grads, ref_stats = _reference(model, x, y)
    loss, grads, _ = _port_step(model, x, y)
    assert abs(loss - ref_loss) / abs(ref_loss) <= 5e-6
    # 161 leaves at the published depth; here 1 + 4 x 10 + 2 = conv1, bn1, the
    # blocks' 3 convs, 3 batch norms and projections, fc
    assert len(grads) == len(before) == 1 + 2 + 4 * (3 + 3 * 2 + 1 + 2) + 2
    for (name, _), g, r in zip(model.named_parameters(), grads, ref_grads, strict=True):
        assert g.shape == r.shape and float(r.abs().max()) > 0, name
        assert _rel_max(g, r) <= 5e-5, name
    for name, t in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            assert int(t) == 1, name
        else:
            assert _rel_max(t, ref_stats[name]) <= 5e-6, name
    _check_adam(model, before, grads, ref_grads)


def test_published_widths_step_matches_float64_reference():
    model = _model(PUBLISHED["layers"], PUBLISHED["widths"], seed=3)
    x, y = _data(PUBLISHED["hw"], PUBLISHED["b"], seed=4)
    before = _params(model)
    assert len(before) == 161
    assert sum(isinstance(m, TU.BatchNorm) for m in model.modules()) == 53
    loss64, grads64, stats64 = _reference(model, x, y, torch.float64)
    loss, grads, _ = _port_step(model, x, y)
    assert abs(loss - loss64) / loss64 <= 5e-4
    assert _rel_norm(_flat(grads), _flat(grads64)) <= 0.1
    stats = [t for n, t in model.named_buffers() if not n.endswith("num_batches_tracked")]
    assert _rel_norm(_flat(stats), _flat(stats64.values())) <= 5e-5
    own = RR.adam(before, dict(zip(before, grads)))
    for name, p in model.named_parameters():
        _close_to_own(p.detach(), own[name], name)


def test_train_logits_refuses_basic_blocks():
    model = _model(SMALL["layers"], SMALL["widths"], block="basic")
    with pytest.raises(ValueError, match="bottleneck"):
        TR.train_logits(model, _data(SMALL["hw"], 2)[0])


def test_inference_after_training_uses_the_running_statistics():
    """After a training step, `stage_features` and `forward` (the inference
    path, unchanged) compute the reference's inference forward on the
    running statistics the step left."""
    model = _model(SMALL["layers"], SMALL["widths"], seed=7)
    x, y = _data(SMALL["hw"], SMALL["b"], seed=8)
    _port_step(model, x, y)
    with torch.no_grad(), full_fp32():
        ref = RR.logits(_params(model), _stats(model), x.permute(0, 3, 1, 2), SMALL["layers"],
                        training=False)
        feats = TR.stage_features(model, x)
        ours = TR.forward(model, x)
        head = TR.head_logits(model, feats[-1])
    assert len(feats) == 8 and not any(t.requires_grad for t in feats)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(head, ours)


def test_train_logits_updates_the_running_statistics_once():
    model = _model(SMALL["layers"], SMALL["widths"], seed=9)
    x, _ = _data(SMALL["hw"], SMALL["b"])
    with torch.no_grad():
        TR.train_logits(model, x)
    counts = {n: int(t) for n, t in model.named_buffers() if n.endswith("num_batches_tracked")}
    assert len(counts) == 1 + 4 * 4 and set(counts.values()) == {1}
    assert float(model.bn1.running_mean.abs().max()) > 0


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(4, 8, 9, 7), (2, 16, 2, 2), (3, 5, 1, 1)])
def test_plain_batchnorm_train_matches_torch(relu, shape):
    """`batchnorm_train` on the CPU (the plain version, through its
    autograd Function) against `F.batch_norm(training=True)` (+ ReLU):
    outputs, running statistics, num_batches_tracked, every gradient."""
    rng = np.random.default_rng(sum(shape) + relu)
    c = shape[1]
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.5).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal(c) * 0.3 + 1).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(c) * 0.2).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    rm0 = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    rv0 = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    outs = []
    for ours in (True, False):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        rm, rv, nbt = rm0.clone(), rv0.clone(), torch.tensor(3)
        if ours:
            y = KBN.batchnorm_train(xs, ws, bs, rm, rv, nbt, relu=relu)
        else:
            y = F.batch_norm(xs, rm, rv, ws, bs, training=True, momentum=0.1, eps=1e-5)
            y = torch.relu(y) if relu else y
            nbt += 1
        grads = torch.autograd.grad(y, (xs, ws, bs), dy)
        outs.append((y.detach(), rm, rv, int(nbt), grads))
    (y, rm, rv, nbt, grads), (y_t, rm_t, rv_t, nbt_t, grads_t) = outs
    np.testing.assert_allclose(y.numpy(), y_t.numpy(), rtol=0, atol=2e-6)
    assert _rel_max(rm, rm_t) <= 1e-6 and _rel_max(rv, rv_t) <= 1e-6 and nbt == nbt_t == 4
    for g, gt in zip(grads, grads_t):
        assert _rel_max(g, gt) <= 1e-5


def test_plain_batchnorm_train_parts_agree():
    """The plain version's parts: the backward's elementwise pass given the
    sums is the backward's own, and the forward's given the statistics the
    forward's own; a channel of one value is refused."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 4, 5, 6)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((3, 4, 5, 6)).astype(np.float32))
    w, b = torch.ones(4) * 1.5, torch.full((4,), -0.25)
    rm, rv, nbt = torch.zeros(4), torch.ones(4), torch.tensor(0)
    y, mean, invstd = KBN.batchnorm_train_reference(x, w, b, rm, rv, nbt, relu=True)
    assert torch.equal(y, KBN.batchnorm_train_apply_reference(x, mean, invstd, w, b, True))
    dx, dw, db = KBN.batchnorm_train_backward_reference(dy, x, mean, invstd, w, b, True)
    assert torch.equal(dx, KBN.batchnorm_train_dx_reference(dy, x, mean, invstd, w, b, dw, db,
                                                            True))
    with pytest.raises(ValueError, match="more than one value"):
        KBN.batchnorm_train_reference(x[:1, :, :1, :1], w, b, rm, rv, nbt)


def test_fit_resnet_trains_a_copy():
    """`fit_resnet` on the CPU: a tail batch of 1 wraps to 4, two epochs of
    history, the copy's weights and running statistics move, the caller's
    model is untouched."""
    model = _model(SMALL["layers"], SMALL["widths"], seed=10)
    before = _params(model)
    x, y = _data(SMALL["hw"], 5, seed=11)
    res = TC.fit_resnet(model, x.numpy(), y.numpy(), x[:3].numpy(), y[:3].numpy(), epochs=2,
                        batch_size=4, device="cpu")
    assert [r["epoch"] for r in res.history] == [1, 2]
    assert all(np.isfinite(r["loss"]) and 0 <= r["val_acc"] <= 1 for r in res.history)
    assert int(res.model.bn1.num_batches_tracked) == 4       # 2 steps an epoch
    assert not torch.equal(res.model.fc.weight.detach(), before["fc.weight"])
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n])
    assert int(model.bn1.num_batches_tracked) == 0


# ---- the benchmark's plain reference and cell ---------------------------------

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

from cadx_tpu_torch.utils import profiling as TProf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = "resnet50-mammo-train-b16"


@pytest.fixture(scope="module")
def portbench_modules():
    """`portbench/`'s harness and tiny-cell helpers on the path while the
    module's tests run."""
    saved = list(sys.path)
    sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]
    spec = importlib.util.spec_from_file_location(
        "portbench_tiny_conftest_resnet", ROOT / "portbench" / "tests" / "conftest.py")
    tiny = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tiny)
    from harness.kinds import resnet_train
    from harness.reference import resnet as bench_ref
    yield tiny, bench_ref, resnet_train
    sys.path[:] = saved


def _bench_cfg(**kw):
    cfg = json.loads((ROOT / "portbench" / "configs" / "resnet50-mammo.json").read_text())
    return dict(cfg, **kw)


def _tiny_cfg():
    return _bench_cfg(layers=list(SMALL["layers"]), widths=list(SMALL["widths"]),
                      image_hw=list(SMALL["hw"]))


def test_the_two_references_agree(portbench_modules):
    """`tests/reference_resnet.py` (batch norm written out) and
    `portbench/harness/reference/resnet.py` (`F.batch_norm`) in float64:
    the same loss, gradients and running statistics to 1e-10 relative
    (float64 rounding of two formulas of the same statistics)."""
    _, bench_ref, _ = portbench_modules
    cfg = _tiny_cfg()
    model = _model(SMALL["layers"], SMALL["widths"], seed=12)
    assert [n for n, _ in bench_ref.param_shapes(cfg)] == list(_params(model))
    assert len(bench_ref.batch_norms(cfg)) == 17
    x, y = _data(SMALL["hw"], SMALL["b"], seed=13)
    out = []
    for bench in (False, True):
        p = {k: v.double().requires_grad_(True) for k, v in _params(model).items()}
        stats = {k: v.double() for k, v in _stats(model).items()}
        xt = x.permute(0, 3, 1, 2).double()
        loss = (bench_ref.cross_entropy_loss(p, stats, cfg, xt, y) if bench else
                RR.cross_entropy(RR.logits(p, stats, xt, SMALL["layers"]), y))
        out.append((loss, torch.autograd.grad(loss, list(p.values())), stats))
    (l0, g0, s0), (l1, g1, s1) = out
    assert abs(float((l0 - l1).detach())) <= 1e-10 * abs(float(l0.detach()))
    for a, b in zip(g0, g1, strict=True):
        assert _rel_max(b, a) <= 1e-10
    for k in s0:
        assert _rel_max(s1[k], s0[k]) <= 1e-10, k


def test_bench_weights_build_the_port(portbench_modules):
    """The benchmark's seeded weights name the port's parameters in its
    order, and the port's training forward over them computes the
    reference's."""
    _, bench_ref, resnet_train = portbench_modules
    cfg = _tiny_cfg()
    params = resnet_train.init_params(torch.Generator().manual_seed(14), cfg)
    model = resnet_train.port_resnet(params, cfg)
    x, _ = _data(SMALL["hw"], SMALL["b"], seed=15)
    stats = bench_ref.init_stats(cfg, "cpu")
    with torch.no_grad(), full_fp32():
        ours = TR.train_logits(model, x)
        ref = bench_ref.logits(params, stats, cfg, x.permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    for name, t in model.named_buffers():
        if name in stats:
            assert _rel_max(t, stats[name]) <= 5e-6, name


def test_bench_data_is_balanced_and_marked(portbench_modules):
    _, _, resnet_train = portbench_modules
    X, y = resnet_train.make_data(torch.Generator().manual_seed(16), 20, (72, 56), 128, [1, 3],
                                  [0.01, 0.1])
    assert X.shape == (20, 72, 56, 1) and y.shape == (20,) and y.dtype == torch.int64
    assert int(y.sum()) == 10 and float(X.min()) >= 0 and float(X.max()) <= 1
    # a label-1 image is brightened inside its ellipses: its mean exceeds the
    # same image's unmarked mean, which the label-0 draw keeps
    again, _ = resnet_train.make_data(torch.Generator().manual_seed(16), 20, (72, 56), 128,
                                      [1, 3], [0.0, 0.0])
    lift = (X - again).mean(dim=(1, 2, 3))
    assert bool((lift[y == 0] == 0).all()) and bool((lift[y == 1] > 0).all())


def test_bench_counting_at_published_widths(portbench_modules):
    from harness import resnet_counting

    cfg = _bench_cfg()
    assert len(resnet_counting.conv_layers(cfg)) == 53
    assert resnet_counting.forward_flops(cfg) == 164_919_517_184
    assert resnet_counting.train_step_flops(cfg, 16) == 3 * 16 * 164_919_517_184
    assert resnet_counting.bn_elements(cfg) == 228_630_528
    assert resnet_counting.bn_train_bound_s(cfg, 16) == pytest.approx(0.0218393, rel=1e-5)


TINY_TRAFFIC = {"kind": "resnet_train", "samples": 10, "batch": 4, "source_hw": 64,
                "lesions": [1, 3], "lesion_share": [0.01, 0.1], "steps_ahead": 2,
                "checked_steps": 3, "profile_units": 2}


@pytest.fixture(scope="module")
def resnet_root(portbench_modules, tmp_path_factory):
    """A checkout of the benchmark whose BENCHMARK.json adds
    `resnet-train-tiny`: the configuration at layers (1, 1, 1, 1), widths
    8-64 and 64x48, 10 samples, B=4, under the real cell's limits and
    listed wherever the real cell is."""
    tiny, _, _ = portbench_modules
    root = tiny.make_tiny_root(tmp_path_factory.mktemp("resnet_checkout"))
    bench = root / "portbench"
    (bench / "configs" / "resnet-tiny.json").write_text(json.dumps(dict(_tiny_cfg(),
                                                                        name="resnet-tiny")))
    (bench / "traffic" / "resnet-tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    shutil.copy(bench / "limits" / f"{CELL}.json", bench / "limits" / "resnet-train-tiny.json")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "resnet-tiny", "source": "a CPU-sized resnet50-mammo",
                         "file": "portbench/configs/resnet-tiny.json",
                         "reduced": ["layers", "widths", "image_hw"], "why": "CPU tests"})
    m["workloads"].append({"name": "resnet-train-tiny", "config": "resnet-tiny",
                           "traffic": "resnet-tiny", "chips": 1, "why": "CPU tests"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append("resnet-train-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_resnet_cell_runs_and_is_correct(portbench_modules, resnet_root, trace):
    """Untraced: the end-to-end metrics. Traced: the metrics that read the
    host and the program (no card: the device metrics left out,
    `adam_fused_leaves.resnet` and `bn_train_kernel.resnet` 0, since the
    CPU takes the plain Adam and the plain batch norm)."""
    tiny, _, _ = portbench_modules
    TProf.reset()
    r = tiny.run_cell(resnet_root, "resnet-train-tiny", seconds=1.0, trace=trace)
    assert r["correct"], r["compared"]
    assert set(r["compared"]) == {"loss_rel_gap", "grad_norm_gap", "update_norm_gap",
                                  "running_stats_gap", "adam_state_gap"}
    assert r["attempted"] > 0 and r["failed"] == 0
    if trace:
        assert set(r["metrics"]) == {"mfu.resnet", "enqueue_ms.resnet",
                                     "adam_fused_leaves.resnet", "bn_train_kernel.resnet"}
        assert r["metrics"]["adam_fused_leaves.resnet"]["value"] == 0
        assert r["metrics"]["bn_train_kernel.resnet"]["value"] == 0
        assert r["metrics"]["mfu.resnet"]["value"] > 0
    else:
        assert set(r["metrics"]) == {"train_samples_per_s", "setup_s"}
    TProf.reset()


def _tiny_cell(resnet_root, seed=2**33 + 9):
    from harness import runner

    spec = runner.load_spec(resnet_root, resnet_root / "portbench", "resnet-train-tiny")
    cell = runner.make_cell(spec, seed, "cpu")
    cell.setup()
    t0 = time.perf_counter()
    cell.start_window(t0, 0.3)
    while time.perf_counter() - t0 < 0.3:
        cell.unit()
    cell.finish()
    cell.release()
    return cell, spec


@pytest.mark.parametrize("variant", ["tf32", "half_batch"])
def test_resnet_cell_controls_fail(portbench_modules, resnet_root, variant):
    """The reference in TF32, and the reference with half of each batch
    left out, in the program's place: each fails a limit of the cell."""
    cell, spec = _tiny_cell(resnet_root)
    assert all(c.ok for c in cell.check())
    readings = cell.control(variant)
    assert any(v > spec.limits[k] for k, v in readings.items()), readings


def test_resnet_cell_rejects_stale_running_statistics(portbench_modules, resnet_root):
    """A program whose batch norms leave the running statistics alone
    fails `running_stats_gap`."""
    cell, spec = _tiny_cell(resnet_root)
    got = cell.got()
    stale = [cell.states[0]["stats"]] * len(got["stats"])
    readings = cell.judge(dict(got, stats=stale), cell.reference())
    assert readings["running_stats_gap"] > spec.limits["running_stats_gap"]


def test_resnet_cell_rejects_an_unchanged_state(portbench_modules, resnet_root):
    """A program whose steps leave the parameters where they were fails
    `update_norm_gap` (it reads 1)."""
    cell, spec = _tiny_cell(resnet_root)
    got = cell.got()
    readings = cell.judge(dict(got, after=[cell.states[0]["params"]] * len(got["after"])),
                          cell.reference())
    assert readings["update_norm_gap"] > spec.limits["update_norm_gap"]


def _keep_nu(step):
    """Adam that updates with the new second moment but stores the old."""
    def faulty(self, params, grads, state):
        kept = [v.clone() for v in state.nu]
        out = step(self, params, grads, state)
        for v, k in zip(out.nu, kept):
            v.copy_(k)
        return out
    return faulty


def _keep_count(step):
    """Adam whose step count never advances."""
    def faulty(self, params, grads, state):
        return dataclasses.replace(step(self, params, grads, state), count=state.count)
    return faulty


@pytest.mark.parametrize("fault", [_keep_nu, _keep_count], ids=["nu", "count"])
def test_resnet_cell_rejects_a_lost_adam_state(portbench_modules, resnet_root, monkeypatch,
                                               fault):
    """A program whose Adam keeps its second moment unchanged, or never
    advances its count, fails `adam_state_gap`, though the re-anchored
    reference takes both from the program."""
    monkeypatch.setattr(TOpt.Adam, "step", fault(TOpt.Adam.step))
    cell, spec = _tiny_cell(resnet_root)
    checks = {c.name: c for c in cell.check()}
    assert checks["adam_state_gap"].value > spec.limits["adam_state_gap"]
    assert not checks["adam_state_gap"].ok


def test_resnet_cell_refuses_other_batch_norm_settings(portbench_modules):
    """A configuration whose batch norms ask for another momentum or eps
    than the port trains with is refused before any step."""
    _, _, resnet_train = portbench_modules
    for bn in ({"eps": 1e-5, "momentum": 0.01}, {"eps": 1e-3, "momentum": 0.1}):
        cfg = dict(_tiny_cfg(), batch_norm=bn)
        with pytest.raises(RuntimeError, match="momentum"):
            resnet_train.port_resnet(resnet_train.init_params(
                torch.Generator().manual_seed(0), cfg), cfg)


def test_resnet_cell_refuses_a_port_that_cannot_train(portbench_modules, monkeypatch):
    """A port whose resnet has no training forward is refused before any
    step."""
    _, _, resnet_train = portbench_modules
    monkeypatch.delattr(TR, "train_logits")
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="train_logits"):
        resnet_train.port_resnet(resnet_train.init_params(torch.Generator().manual_seed(0),
                                                          cfg), cfg)
