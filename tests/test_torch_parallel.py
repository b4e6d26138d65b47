"""Port parity: `cadx_tpu_torch/parallel/` on a local mesh of 8 CPU
devices against the JAX flows of `tests/test_parallel.py` and
`tests/test_segmentation.py` on conftest's 8 virtual CPU devices.

Weights come from JAX through `cadx_tpu_torch.convert`, data from seeded
numpy. Tolerances: the data-parallel updates 1e-5 (JAX's own, float32
sums reordered across shards) against JAX's single-device and
data-parallel steps with dropout 0, and against the port's single-device
step with dropout 0.3 (JAX's random stream differs from torch's); the
replicas bit-identical; the spatial encoder 1e-5, the spatial cleaner
bit-exact. The gloo worlds of more than one process are in
`test_torch_parallel_world.py`.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.models import cnn as JCNN
from cadx_tpu.models import unet as JU
from cadx_tpu.parallel import data_parallel as JDP
from cadx_tpu.parallel import mesh as JMesh
from cadx_tpu.parallel import spatial as JSP
from cadx_tpu.train import crossval as JCV
from cadx_tpu.train import step as JS
from cadx_tpu_torch import convert
from cadx_tpu_torch.compat import classes as TClasses
from cadx_tpu_torch.models import cnn as TCNN
from cadx_tpu_torch.models import unet as TU
from cadx_tpu_torch.parallel import data_parallel as DP
from cadx_tpu_torch.parallel import mesh as M
from cadx_tpu_torch.parallel import spatial as SP
from cadx_tpu_torch.train import crossval as TCV
from cadx_tpu_torch.train import optim as TOpt
from cadx_tpu_torch.train import segmentation as TSeg
from cadx_tpu_torch.train import step as TS

CPU8 = [torch.device("cpu")] * 8
CFG = dict(input_shape=(12, 12, 2), num_classes=2, conv_layers=[(4, 3)],
           hidden_units=[16], dropout_rate=0.0, leaky_alpha=0.01)


def _pair(cfg_dict, seed=0):
    jcfg = JCNN.CNNConfig.from_json_dict(cfg_dict)
    jp = jax.tree_util.tree_map(np.asarray, JCNN.init_params(jax.random.key(seed), jcfg))
    tcfg = convert.convert_cnn_config(jcfg)
    return jcfg, jp, tcfg, convert.convert_classifier(jp, tcfg)


def _data(rng, n=64):
    """tests/test_parallel.py's task: noise, a bright square for class 1."""
    y = rng.integers(0, 2, n)
    X = rng.standard_normal((n, 12, 12, 2)).astype(np.float32) * 0.1
    X[y == 1, 3:7, 3:7, :] += 2.0
    return X, y


def _close(a, b, atol=1e-5):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_allclose(np.asarray(x.detach() if torch.is_tensor(x) else x),
                                   np.asarray(y.detach() if torch.is_tensor(y) else y),
                                   rtol=0, atol=atol)


def _identical_replicas(update_fn):
    models = update_fn.replicas.models
    assert len(models) == 8
    for m in models[1:]:
        for a, b in zip(models[0].parameters(), m.parameters(), strict=True):
            assert torch.equal(a, b)


def test_mesh_shapes():
    m = M.make_mesh(devices=CPU8)
    assert m.shape == {"data": 8, "model": 1} and not m.distributed
    assert M.make_mesh(n_data=4, n_model=2, devices=CPU8).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        M.make_mesh(n_data=16, devices=CPU8)
    with pytest.raises(ValueError):
        M.shard_batch(m, np.zeros((6, 3), np.float32))
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    xs, ys = M.shard_batch(m, x, x[:, 0])
    assert len(xs) == 8 and all(p.shape == (2, 3) for p in xs)
    np.testing.assert_array_equal(torch.cat(xs).numpy(), x)
    np.testing.assert_array_equal(torch.cat(ys).numpy(), x[:, 0])
    assert all(torch.equal(p, torch.from_numpy(x)) for p in M.replicated(m).place(x))
    # no process group here: make_mesh() wants the cards, which this machine lacks
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            M.make_mesh()
    with pytest.raises(ValueError):
        M.make_mesh(devices=CPU8, device="cpu")
    # a world of one process names no world: initialize_distributed is a no-op
    M.initialize_distributed()
    assert not torch.distributed.is_initialized()


def _batch(rng, b=16, real=13):
    X, y = _data(rng, b)
    mask = np.ones(b, np.float32)
    mask[real:] = 0.0                           # a padded tail
    return X, np.eye(2, dtype=np.float32)[y], mask


def test_dp_updates_match_jax(rng):
    """Dropout 0: two SGD steps and two Adam steps on the 8-device mesh,
    against JAX's single-device and data-parallel steps."""
    jcfg, jp, tcfg, model = _pair(CFG)
    jmesh = JMesh.make_mesh()
    mesh = M.make_mesh(devices=CPU8)
    batches = [_batch(rng) for _ in range(2)]
    lr = 0.05

    def jnp_tree(t):
        return jax.tree_util.tree_map(jnp.array, t)

    # SGD: JAX single device, JAX dp, port dp
    single = jnp_tree(jp)
    jdp = jnp_tree(jp)
    jupdate = JDP.make_dp_sgd_update(jcfg, jmesh)
    port = copy.deepcopy(model)
    update = DP.make_dp_sgd_update(tcfg, mesh)
    for X, Y, mask in batches:
        single, jloss = JS.sgd_train_step(single, jnp.asarray(X), jnp.asarray(Y),
                                          jnp.asarray(mask), jnp.float32(lr),
                                          jax.random.key(1), jcfg, training=False)
        jdp, _, jdp_loss = jupdate(jdp, None, jnp.asarray(X), jnp.asarray(Y),
                                   jnp.asarray(mask), jnp.float32(lr), jax.random.key(1))
        _, loss = update(port, None, torch.from_numpy(X), torch.from_numpy(Y),
                         torch.from_numpy(mask), lr, torch.Generator().manual_seed(1))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(loss), float(jdp_loss), rtol=1e-5)
    for ref in (single, jdp):
        _close(port.parameters(),
               convert.convert_classifier(jax.tree_util.tree_map(np.asarray, ref),
                                          tcfg).parameters())
    _identical_replicas(update)

    # Adam
    jupdate, jinit = JDP.make_dp_adam_update(jcfg, jmesh, 1e-3)
    jdp = jnp_tree(jp)
    jstate = jinit(jdp)
    port = copy.deepcopy(model)
    update, init = DP.make_dp_adam_update(tcfg, mesh, 1e-3)
    state = init(port.parameters())
    for X, Y, mask in batches:
        jdp, jstate, jloss = jupdate(jdp, jstate, jnp.asarray(X), jnp.asarray(Y),
                                     jnp.asarray(mask), None, jax.random.key(1))
        state, loss = update(port, state, torch.from_numpy(X), torch.from_numpy(Y),
                             torch.from_numpy(mask), 1e-3, torch.Generator().manual_seed(1))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    conv = lambda t: convert.convert_classifier(t, tcfg)  # noqa: E731
    _close(port.parameters(), conv(jax.tree_util.tree_map(np.asarray, jdp)).parameters())
    ref_state = convert.convert_adam_state(jax.tree_util.tree_map(np.asarray, jstate), conv)
    assert state.count == ref_state.count == 2
    _close(state.mu, ref_state.mu)
    _close(state.nu, ref_state.nu)
    _identical_replicas(update)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_dp_updates_with_dropout_match_single_device(rng, optimizer):
    """Dropout 0.3: each shard keeps its rows of the whole batch's
    uniforms, so two data-parallel steps equal two single-device steps."""
    cfg = TCNN.CNNConfig(input_shape=(12, 12, 2), num_classes=2, conv_layers=((4, 3),),
                         hidden_units=(16, 8), dropout_rate=0.3)
    model = TCNN.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = M.make_mesh(devices=CPU8)
    single, port = copy.deepcopy(model), copy.deepcopy(model)
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    if optimizer == "sgd":
        update = DP.make_dp_sgd_update(cfg, mesh)
        s1 = s2 = None
    else:
        update, init = DP.make_dp_adam_update(cfg, mesh, 1e-3)
        tx = TOpt.adam(1e-3)
        adam_step = TS.make_adam_train_step(tx)
        s1, s2 = tx.init(single.parameters()), init(port.parameters())
    for _ in range(2):
        X, Y, mask = (torch.from_numpy(a) for a in _batch(rng))
        if optimizer == "sgd":
            loss1 = TS.sgd_train_step(single, X, Y, mask, 0.05, g1)
        else:
            s1, loss1 = adam_step(single, s1, X, Y, mask, g1)
        s2, loss2 = update(port, s2, X, Y, mask, 0.05, g2)
        np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-5)
    _close(port.parameters(), single.parameters())
    # the shared generator advanced as the single device's did
    assert torch.equal(g1.get_state(), g2.get_state())
    _identical_replicas(update)


def test_dp_grads_match_single_device(rng):
    """make_dp_grads: the shards' summed gradients of the batch's masked
    loss, dropout 0.3, against one device's at the same weights."""
    cfg = TCNN.CNNConfig(input_shape=(12, 12, 2), num_classes=2, conv_layers=((4, 3),),
                         hidden_units=(16, 8), dropout_rate=0.3)
    model = TCNN.init_params(torch.Generator().manual_seed(0), cfg)
    X, Y, mask = (torch.from_numpy(a) for a in _batch(rng))
    with torch.enable_grad():
        loss = TS.masked_loss_fn(model, X, Y, mask, training=True,
                                 generator=torch.Generator().manual_seed(3))
        want = torch.autograd.grad(loss, list(model.parameters()))
    got_loss, got = DP.make_dp_grads(cfg, M.make_mesh(devices=CPU8))(
        model, X, Y, mask, torch.Generator().manual_seed(3))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-6)
    _close(got, want, atol=1e-6)


def test_dp_fit_learns(rng):
    _, _, tcfg, model = _pair(CFG)
    X, y = _data(rng)
    Xt, yt = _data(rng, 32)
    update_fn = DP.make_dp_sgd_update(tcfg, M.make_mesh(devices=CPU8))
    res = TS.fit(model, X, np.eye(2)[y], Xt, yt, epochs=6, lr=0.05, batch_size=16,
                 update_fn=update_fn, seed=0, device="cpu")
    assert res.best_val_acc >= 0.9


def test_dp_eval(rng):
    _, _, tcfg, model = _pair(CFG)
    X, _ = _data(rng, 16)
    preds = DP.make_dp_eval(tcfg, M.make_mesh(devices=CPU8))(model, torch.from_numpy(X))
    assert preds.shape == (16,)
    assert torch.equal(preds, TS.eval_step(model, torch.from_numpy(X)))


def _check_crossval(res, single, n_test):
    assert len(res.fold_accuracies) == 2
    agg = res.aggregate_metrics()
    assert agg["n_splits"] == 2
    assert 0.0 <= agg["mean_accuracy"] <= 1.0
    assert set(res.fold_evaluations[0]) == {
        "test_accuracy", "confusion_matrix", "classification_report"}
    for a, b, n in zip(res.fold_accuracies, single.fold_accuracies, n_test, strict=True):
        assert abs(a - b) <= 1.0 / n + 1e-12


def test_cross_validate_mesh(rng):
    """tests/test_parallel.py::test_cross_validate_mesh's assertions; the
    folds within one test sample of the port's single-device folds (the
    port draws fold weights from torch.Generator, not from JAX's keys)."""
    mesh = M.make_mesh(devices=CPU8)
    X, y = _data(rng, 48)
    tcfg = convert.convert_cnn_config(JCNN.CNNConfig.from_json_dict(CFG))
    kw = dict(n_splits=2, epochs=3, lr=0.05, batch_size=8, seed=0)
    single = TCV.cross_validate(tcfg, X, y, device="cpu", **kw)
    n_test = [len(te) for _, te in TCV.KFold(2).split(len(X))]
    _check_crossval(TCV.cross_validate(tcfg, X, y, mesh=mesh, **kw), single, n_test)
    cv = TClasses.CrossValidator(2, device="cpu")
    res = cv.cross_validate(tcfg, X, y, epochs=3, lr=0.05, batch_size=8, mesh=mesh)
    _check_crossval(res, single, n_test)
    assert cv.aggregate_metrics() == res.aggregate_metrics()
    # the JAX flow on its 8-device mesh gives the same kind of result
    jres = JCV.cross_validate(JCNN.CNNConfig.from_json_dict(CFG), X, y, mesh=JMesh.make_mesh(),
                              **kw)
    assert set(jres.fold_evaluations[0]) == set(res.fold_evaluations[0])


def _blob_data(rng, n=16, hw=32):
    """tests/test_segmentation.py's images: a bright disk, its mask."""
    X = rng.random((n, hw, hw, 1)).astype(np.float32) * 0.3
    Y = np.zeros((n, hw, hw, 1), np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw]
    for i in range(n):
        cy, cx = rng.integers(8, hw - 8, 2)
        r = rng.integers(4, 8)
        disk = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        X[i, disk, 0] += 0.6
        Y[i, disk, 0] = 1.0
    return X, Y


def test_fit_segmentation_mesh(rng):
    """tests/test_segmentation.py::test_unet_segmentation_on_mesh on the
    port; the losses within 1e-5 of the single-device run."""
    config = TU.UNetConfig(features=(8, 16))
    model = TU.init_unet(torch.Generator().manual_seed(0), config)
    X, Y = _blob_data(rng)
    kw = dict(epochs=2, lr=3e-3, batch_size=8, device="cpu")
    res = TSeg.fit_segmentation(model, X, Y, X[:8], Y[:8],
                                mesh=M.make_mesh(devices=CPU8), **kw)
    ref = TSeg.fit_segmentation(model, X, Y, X[:8], Y[:8], **kw)
    assert len(res.history) == 2
    assert np.isfinite(res.history[-1]["loss"])
    for a, b in zip(res.history, ref.history, strict=True):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=0, atol=1e-5)
    _close(res.model.parameters(), ref.model.parameters())


def test_bulk_classify_mesh_dp_matches_single(rng):
    """tests/test_parallel.py::test_bulk_classify_mesh_dp_matches_single on
    the port: 5 images over 8 shards pad and trim."""
    from cadx_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    cfg = EngineConfig(
        segment_hw=(64, 64), feature_resize=(16, 16),
        basic_classifier=TCNN.CNNConfig(
            input_shape=(16, 16, 64), num_classes=2,
            conv_layers=((8, 3),), hidden_units=(32,), dropout_rate=0.0))
    imgs = (rng.random((5, 64, 64)) * 255).astype(np.uint8)   # 5 % 8 != 0
    eng_dp = InferenceEngine(cfg, seed=3, device="cpu", mesh=M.make_mesh(devices=CPU8))
    rows_dp = eng_dp.classify_batch(imgs)
    assert eng_dp.last_bulk_devices == 8
    eng_1 = InferenceEngine(dataclasses.replace(cfg, bulk_data_parallel=False), seed=3,
                            device="cpu", mesh=M.make_mesh(devices=CPU8))
    rows_1 = eng_1.classify_batch(imgs)
    assert eng_1.last_bulk_devices == 1
    # a CPU engine without a mesh keeps the plain path
    eng_0 = InferenceEngine(cfg, seed=3, device="cpu")
    eng_0.classify_batch(imgs[:2])
    assert eng_0.last_bulk_devices == 1
    assert len(rows_dp) == len(rows_1) == 5
    for a, b in zip(rows_dp, rows_1):
        assert a["predicted_class"] == b["predicted_class"]
        assert a["sample"] == b["sample"]
        np.testing.assert_allclose(a["prediction_probabilities"],
                                   b["prediction_probabilities"], rtol=0, atol=1e-5)


def test_dp_pipeline_matches_run_pipeline(rng):
    """make_dp_pipeline's whole-batch output against run_pipeline's, CAMs
    on: the cleaner is per image (exact), the rest 1e-5 or +-2 u8."""
    from cadx_tpu_torch.pipeline import fused

    pcfg = fused.PipelineConfig(
        image_hw=(64, 64), feature_hw=(16, 16),
        classifier=TCNN.CNNConfig(input_shape=(16, 16, 64), num_classes=2,
                                  conv_layers=((8, 3),), hidden_units=(16,)))
    params = fused.init_pipeline_params(torch.Generator().manual_seed(2), pcfg)
    batch = torch.from_numpy((rng.random((4, 64, 64)) * 255).astype(np.uint8))
    got = DP.make_dp_pipeline(pcfg, M.make_mesh(devices=[torch.device("cpu")] * 4))(
        params, batch)
    want = fused.run_pipeline(params, batch, pcfg)
    assert torch.equal(got.clean_u8, want.clean_u8)
    assert torch.equal(got.predicted, want.predicted)
    _close([got.probs, got.features], [want.probs, want.features])
    for a, b in ((got.heatmaps, want.heatmaps), (got.overlays, want.overlays)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert int((a.int() - b.int()).abs().max()) <= 2


def _encoder():
    """The resnet encoder's conv1, all that encoder_first_features reads
    (He-normal, as JU.init_resnet_encoder draws it)."""
    kernel = np.random.default_rng(0).standard_normal((7, 7, 1, 64)).astype(np.float32)
    jp = {"conv1": {"kernel": kernel * np.float32(np.sqrt(2.0 / 49))}}
    return jp, convert.convert_encoder(jp)


@pytest.mark.parametrize("shards", [2, 4])
def test_spatial_encoder_matches_jax(rng, shards):
    jp, stem = _encoder()
    img = rng.random((2, 128, 96, 1)).astype(np.float32)
    ref = np.asarray(JU.encoder_first_features(jp, jnp.asarray(img)))
    mesh = M.make_mesh(devices=[torch.device("cpu")] * shards)
    out = SP.make_spatial_encoder(mesh)(stem, torch.from_numpy(img))
    assert out.shape == ref.shape == (2, 64, 48, 64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # JAX's own H-sharded encoder on its mesh agrees too
    jrun = JSP.make_spatial_encoder(JMesh.make_mesh(n_data=shards))
    np.testing.assert_allclose(out.numpy(), np.asarray(jrun(jp, jnp.asarray(img))),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        SP.make_spatial_encoder(mesh)(stem, torch.zeros((1, 6 * shards + 2, 16, 1)))


def test_2d_data_by_spatial_sharding(rng):
    """tests/test_segmentation.py::test_2d_data_by_spatial_sharding: batch
    rows on "data" (4), H on "model" (2), the halo helper composed over
    each data row's model axis."""
    jp, stem = _encoder()
    img = rng.random((4, 128, 128, 1)).astype(np.float32)
    ref = np.asarray(JU.encoder_first_features(jp, jnp.asarray(img)))
    mesh = M.make_mesh(n_data=4, n_model=2, devices=CPU8)
    batch_parts = M.data_sharding(mesh).place(img)
    rows = []
    for i, part in enumerate(batch_parts):
        axis = mesh.axis("model", at=i)
        h_parts = [part.narrow(1, 64 * k, 64) for k in range(axis.size)]
        out = SP.encoder_first_features_sharded(stem, h_parts, axis)
        rows.append(DP.gather_rows(axis, out, mesh.home, dim=1))
    out = torch.cat(rows)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shards", [2, 8])
def test_spatial_cleaner_matches_jax(rng, shards):
    """Bit-exact to JAX's H-sharded cleaner stages, the image's max in one
    shard only (the global max must be all-reduced) and a bright row on
    a shard border (the median's halo)."""
    img = rng.integers(0, 3000, (64, 48)).astype(np.uint16)
    img[5, 7] = 60000                           # the max, in the first shard
    img[31:33, 10:30] = 2500                    # across the 2-shard border
    ref = np.asarray(JSP.make_spatial_cleaner(JMesh.make_mesh())(jnp.asarray(img)))
    mesh = M.make_mesh(devices=[torch.device("cpu")] * shards)
    out = SP.make_spatial_cleaner(mesh)(torch.from_numpy(img))
    assert out.dtype == torch.uint8 and out.shape == (64, 48)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ref.any() and not ref.all()
