"""Port parity: the opt-in bfloat16 training options against the JAX
package's on the CPU.

`models/cnn.py::conv_stack` and `apply` with `compute_dtype`, one SGD and
one Adam step, `fit` with `compute_dtype` and `device_data_dtype`,
`cross_validate` with `compute_dtype`, and `--bf16-compute` through the
training CLI, each on JAX weights carried across by `convert.py` and the
same numpy data. Dropout is 0 wherever the two are compared.

Measured on a CPU (torch 2.13, JAX's XLA:CPU): the bf16 conv stack and
the plain bf16 conv block are bit-exact to JAX's (both round each conv's
float32 sum to bf16, add the float32 bias, round again); the float32
head's logits differ by <= 9e-7. The conv transposes round their float32
sums to bf16 after sums taken in another order, so a weight gradient may
land one bf16 step away: after one SGD step (lr 0.05) the parameters
differ by <= 5.2e-5; Adam moves a parameter by about lr * sign(g), so
where a gradient's rounding straddles 0 two steps (lr 1e-3) differ by <=
1.4e-3; after fit's two epochs and the folds' by <= 1.5e-3, losses by <=
9.6e-4. Tolerances, a few times those and under JAX's own bf16-against-
f32 bounds (`tests/test_train.py::test_fit_bf16_compute_learns_and_
tracks_f32`: loss 0.05, parameters 2e-2): logits and first losses
LOGIT_TOL 5e-6; SGD step parameters and later losses STEP_TOL 2e-4; Adam
steps ADAM_TOL 4e-3 (two steps of at most 2 lr); fit and folds FIT_TOL
5e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.models import cnn as JCNN
from cadx_tpu.ops import conv as JConv
from cadx_tpu.train import crossval as JCV
from cadx_tpu.train import optim as JOpt
from cadx_tpu.train import step as JS
from cadx_tpu_torch import convert
from cadx_tpu_torch.kernels import conv_leaky as KCL
from cadx_tpu_torch.models import cnn as TCNN
from cadx_tpu_torch.ops import conv as TConv
from cadx_tpu_torch.tools import train as TT
from cadx_tpu_torch.train import crossval as TCV
from cadx_tpu_torch.train import optim as TOpt
from cadx_tpu_torch.train import step as TS

BF16 = dict(jax=jnp.bfloat16, torch=torch.bfloat16)
VALID = dict(input_shape=(12, 12, 2), num_classes=2, conv_layers=[(4, 3)],
             hidden_units=[16], dropout_rate=0.0, leaky_alpha=0.01)
SAME = dict(input_shape=(16, 16, 8), num_classes=3, conv_layers=[(6, 3), (5, 3)],
            hidden_units=[12, 8], dropout_rate=0.0, leaky_alpha=0.02,
            conv_padding="SAME")
LOGIT_TOL = 5e-6
STEP_TOL = 2e-4
FIT_TOL = 5e-3
ADAM_TOL = 4e-3


def _pair(cfg_dict, seed=0):
    """(JAX config, numpy JAX params, port config, port model)."""
    jcfg = JCNN.CNNConfig.from_json_dict(cfg_dict)
    jp = jax.tree_util.tree_map(np.asarray, JCNN.init_params(jax.random.key(seed), jcfg))
    tcfg = convert.convert_cnn_config(jcfg)
    return jcfg, jp, tcfg, convert.convert_classifier(jp, tcfg)


def _params(jparams, tcfg):
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return [p.detach() for p in convert.convert_classifier(tree, tcfg).parameters()]


def _close(model, jparams, tcfg, atol):
    for a, b in zip(model.parameters(), _params(jparams, tcfg)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=atol, rtol=0)


def _data(cfg, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + tuple(cfg["input_shape"])).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(int)
    return x, y, np.eye(cfg["num_classes"], dtype=np.float32)[y % cfg["num_classes"]]


@pytest.mark.parametrize("cfg", [VALID, SAME], ids=["valid", "same"])
def test_conv_stack_and_apply_bf16_match_jax(cfg):
    """The bf16 conv stack bit-exact to JAX's; the float32 logits within
    LOGIT_TOL; the activations stay bf16 until the head."""
    jcfg, jp, _, model = _pair(cfg)
    x, _, _ = _data(cfg, 4, 1)
    jf = JCNN.conv_stack(jp, jnp.asarray(x), jcfg, compute_dtype=BF16["jax"])
    tf = TCNN.conv_stack(model, torch.from_numpy(x), compute_dtype=BF16["torch"])
    assert tf.dtype == torch.bfloat16 and jf.dtype == jnp.bfloat16
    np.testing.assert_array_equal(tf.detach().float().numpy(),
                                  np.asarray(jf.astype(jnp.float32)))
    jl = np.asarray(JCNN.apply(jp, jnp.asarray(x), jcfg, compute_dtype=BF16["jax"]))
    tl = TCNN.apply(model, torch.from_numpy(x), compute_dtype=BF16["torch"])
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.detach().numpy(), jl, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_conv_leaky_bf16_plain_matches_jax_rounding(padding):
    """The bf16 form's plain version (F.conv2d in bf16, + float32 bias,
    rounded, LeakyReLU with alpha as a bf16 scalar) equals JAX's
    conv2d_leaky on bf16 operands bit for bit, in both layouts the kernel
    reads; a CPU call launches nothing."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 9, 11, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 7)).astype(np.float32) * 0.3
    b = rng.standard_normal((7,)).astype(np.float32)
    want = JConv.conv2d_leaky(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                              jnp.asarray(b), alpha=0.01,
                              padding=padding if padding == "VALID" else 1)
    pad = 0 if padding == "VALID" else 1
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = convert.hwio_to_oihw(w).to(torch.bfloat16)
    before = KCL.conv_leaky_bf16.launches
    for view in (xt.permute(0, 3, 1, 2), xt.permute(0, 3, 1, 2).contiguous()):
        got = KCL.conv_leaky_bf16(view, wt, torch.from_numpy(b), 0.01, pad)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    assert KCL.conv_leaky_bf16.launches == before


def test_conv2d_leaky_bf16_backward_matches_jax():
    """The conv block's gradients in bf16 (the transposes with bf16
    results, the bias sum in float32) against JAX's VJP, on the same
    upstream gradient."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32) * 0.3
    b = rng.standard_normal((6,)).astype(np.float32) * 0.1
    g = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)

    def jfn(w_, b_):
        return JConv.conv2d_leaky(jnp.asarray(x, jnp.bfloat16), w_.astype(jnp.bfloat16), b_,
                                  alpha=0.01, padding=1)
    out, vjp = jax.vjp(jfn, jnp.asarray(w), jnp.asarray(b))
    jdw, jdb = vjp(jnp.asarray(g, jnp.bfloat16))
    wt = convert.hwio_to_oihw(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = TConv.conv2d_leaky(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2), wt, bt,
                           0.01, "SAME")
    np.testing.assert_array_equal(y.permute(0, 2, 3, 1).detach().float().numpy(),
                                  np.asarray(out.astype(jnp.float32)))
    tdw, tdb = torch.autograd.grad(y, (wt, bt), torch.from_numpy(g).to(torch.bfloat16)
                                   .permute(0, 3, 1, 2))
    np.testing.assert_allclose(tdw.permute(2, 3, 1, 0).numpy(), np.asarray(jdw),
                               atol=STEP_TOL, rtol=2 ** -7)
    np.testing.assert_allclose(tdb.numpy(), np.asarray(jdb), atol=STEP_TOL, rtol=0)


@pytest.mark.parametrize("cfg", [VALID, SAME], ids=["valid", "same"])
def test_sgd_step_bf16_matches_jax(cfg):
    jcfg, jp, tcfg, model = _pair(cfg)
    x, _, y1h = _data(cfg, 8, 4)
    mask = np.ones((8,), np.float32)
    mask[-2:] = 0.0
    jp2, jloss = JS.sgd_train_step(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(y1h),
        jnp.asarray(mask), jnp.float32(0.05), jax.random.key(1), jcfg,
        compute_dtype=BF16["jax"])
    tloss = TS.sgd_train_step(model, torch.from_numpy(x), torch.from_numpy(y1h),
                              torch.from_numpy(mask), 0.05, None,
                              compute_dtype=BF16["torch"])
    assert abs(float(tloss) - float(jloss)) <= LOGIT_TOL
    _close(model, jp2, tcfg, STEP_TOL)


def test_adam_step_bf16_matches_jax():
    jcfg, jp, tcfg, model = _pair(SAME)
    x, _, y1h = _data(SAME, 8, 5)
    mask = np.ones((8,), np.float32)
    jtx = JOpt.adam(1e-3)
    jstep = JS.make_adam_train_step(jcfg, jtx, compute_dtype=BF16["jax"])
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate = jtx.init(jparams)
    ttx = TOpt.adam(1e-3)
    tstep = TS.make_adam_train_step(ttx, compute_dtype=BF16["torch"])
    tstate = ttx.init(list(model.parameters()))
    for i in range(2):
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(x), jnp.asarray(y1h),
                                       jnp.asarray(mask), jax.random.key(0))
        tstate, tloss = tstep(model, tstate, torch.from_numpy(x), torch.from_numpy(y1h),
                              torch.from_numpy(mask), None)
        assert abs(float(tloss) - float(jloss)) <= (STEP_TOL if i else LOGIT_TOL)
    _close(model, jparams, tcfg, ADAM_TOL)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_fit_bf16_options_match_jax(optimizer):
    """fit with compute_dtype and device_data_dtype bf16 (the dataset
    stored in bf16, each batch cast to float32): JAX's history, accuracy
    and final parameters, the caller's model untouched."""
    jcfg, jp, tcfg, model = _pair(SAME)
    x, y, y1h = _data(SAME, 20, 6)
    kw = dict(epochs=2, lr=0.05 if optimizer == "sgd" else 1e-3, batch_size=8,
              optimizer=optimizer, seed=0, device_data=True)
    jres = JS.fit(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, x, y1h, x[:8], y[:8],
                  device_data_dtype=BF16["jax"], compute_dtype=BF16["jax"], **kw)
    before = [p.detach().clone() for p in model.parameters()]
    tres = TS.fit(model, x, y1h, x[:8], y[:8], device_data_dtype=BF16["torch"],
                  compute_dtype=BF16["torch"], device="cpu", **kw)
    for a, b in zip(model.parameters(), before):
        assert torch.equal(a.detach(), b)
    assert [h["val_acc"] for h in tres.history] == [h["val_acc"] for h in jres.history]
    for th, jh in zip(tres.history, jres.history):
        assert abs(th["loss"] - jh["loss"]) <= FIT_TOL
    _close(tres.model, jres.params, tcfg, FIT_TOL)


def test_fit_device_data_dtype_rounds_the_inputs():
    """device_data_dtype alone: the steps see the inputs rounded to bf16
    and nothing else changes, as fitting the rounded inputs in float32."""
    _, _, _, model = _pair(VALID)
    x, y, y1h = _data(VALID, 16, 7)
    kw = dict(epochs=1, lr=0.05, batch_size=8, seed=0, device="cpu", device_data=True)
    a = TS.fit(model, x, y1h, x[:8], y[:8], device_data_dtype=torch.bfloat16, **kw)
    x_r = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    b = TS.fit(model, x_r, y1h, x[:8], y[:8], **kw)
    assert a.history == b.history
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


def test_cross_validate_bf16_matches_jax(monkeypatch):
    """Two folds with compute_dtype bf16, each fold starting from the
    carried JAX weights of its seed."""
    jcfg = JCNN.CNNConfig.from_json_dict(VALID)
    tcfg = convert.convert_cnn_config(jcfg)
    x, y, _ = _data(VALID, 16, 8)
    folds = {}

    def carried(generator, config, device=None):
        seed = generator.initial_seed()
        jp = jax.tree_util.tree_map(np.asarray, JCNN.init_params(jax.random.key(seed), jcfg))
        folds[seed] = True
        return convert.convert_classifier(jp, tcfg).to(device)
    monkeypatch.setattr(TCV.cnn, "init_params", carried)
    kw = dict(n_splits=2, epochs=2, lr=0.05, batch_size=4, optimizer="sgd", seed=3)
    jres = JCV.cross_validate(jcfg, x, y, compute_dtype=BF16["jax"], **kw)
    tres = TCV.cross_validate(tcfg, x, y, compute_dtype=BF16["torch"], device="cpu", **kw)
    assert sorted(folds) == [3, 4]
    assert tres.fold_accuracies == jres.fold_accuracies
    for tf, jf in zip(tres.fold_results, jres.fold_results):
        for th, jh in zip(tf.history, jf.history):
            assert abs(th["loss"] - jh["loss"]) <= FIT_TOL
        _close(tf.model, jf.params, tcfg, FIT_TOL)


def _make_dataset(tmp_path, rng, n=24):
    """A tiny DICOM dataset and its CSV mapping, a bright square for class
    1, as tests/test_train_cli.py makes it (with the port's DICOM
    writer)."""
    import csv

    from cadx_tpu_torch.data import dicom

    paths = []
    for i in range(n):
        y = i % 2
        img = rng.normal(1000, 150, (48, 48)).clip(0, 4095)
        if y:
            img[14:34, 14:34] += 1200
        p = str(tmp_path / f"c{i}.dcm")
        dicom.dcmwrite_minimal(p, img.clip(0, 4095).astype(np.uint16), f"P{i}")
        paths.append((p, "MALIGNANT" if y else "BENIGN"))
    cp = str(tmp_path / "mapping.csv")
    with open(cp, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dicom_file_path", "pathology"])
        w.writerows(paths)
    return cp


def test_train_cli_bf16_compute(tmp_path, rng):
    """--bf16-compute end to end through the port's CLI (advanced/Adam
    path) on the CPU, as JAX's tests/test_train_cli.py runs it: artifacts
    written, the model still learns the bright-square task."""
    cp = _make_dataset(tmp_path, rng)
    out = str(tmp_path / "out_bf16")
    s = TT.main([
        "--csv", cp, "--out-dir", out, "--pipeline", "advanced",
        "--features", "raw", "--resize", "24", "--epochs", "5",
        "--batch-size", "8", "--conv-layers", "4x3",
        "--hidden-units", "16", "--dropout", "0.0", "--bf16-compute", "--device", "cpu",
    ])
    assert os.path.exists(os.path.join(out, "cnn_model_advanced.npz"))
    assert s["evaluation"]["test_accuracy"] >= 0.8
