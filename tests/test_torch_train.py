"""Port parity: the classifier trainer (`cadx_tpu_torch/train/`,
`checkpoint.py`, `utils/tree.py`, the training half of `models/cnn.py`)
against the JAX package on the same weights and numpy data.

JAX weights and optax states go through `cadx_tpu_torch.convert`. Dropout
is 0 wherever the two packages are compared (their random streams
differ). Tolerances: loss 1e-5 relative, parameters, gradients and Adam
moments 1e-5 absolute (PARITY.md:87, the training-update tolerance);
validation accuracy, KFold splits, checkpoints, metrics and summaries
exact.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu import checkpoint as JCK
from cadx_tpu.models import cnn as JCNN
from cadx_tpu.train import crossval as JCV
from cadx_tpu.train import metrics as JM
from cadx_tpu.train import optim as JOpt
from cadx_tpu.train import step as JS
from cadx_tpu.train import summary as JSum
from cadx_tpu.utils import tree as JTree
from cadx_tpu_torch import checkpoint as TCK
from cadx_tpu_torch import convert
from cadx_tpu_torch.models import cnn as TCNN
from cadx_tpu_torch.train import crossval as TCV
from cadx_tpu_torch.train import metrics as TM
from cadx_tpu_torch.train import optim as TOpt
from cadx_tpu_torch.train import step as TS
from cadx_tpu_torch.train import summary as TSum
from cadx_tpu_torch.utils import tree as TTree

VALID = dict(input_shape=(12, 12, 2), num_classes=2, conv_layers=[(4, 3)],
             hidden_units=[16], dropout_rate=0.0, leaky_alpha=0.01)
SAME = dict(input_shape=(10, 10, 3), num_classes=3, conv_layers=[(6, 3), (5, 3)],
            hidden_units=[12, 8], dropout_rate=0.0, leaky_alpha=0.02,
            conv_padding="SAME")


def _pair(cfg_dict, seed=0):
    """(JAX config, numpy JAX params, port config, port model)."""
    jcfg = JCNN.CNNConfig.from_json_dict(cfg_dict)
    jp = jax.tree_util.tree_map(np.asarray, JCNN.init_params(jax.random.key(seed), jcfg))
    tcfg = convert.convert_cnn_config(jcfg)
    return jcfg, jp, tcfg, convert.convert_classifier(jp, tcfg)


def _params(jparams, tcfg):
    """JAX params (or a params-shaped tree) in the port's order and layout."""
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return [p.detach() for p in convert.convert_classifier(tree, tcfg).parameters()]


def _close_params(a, b, atol=1e-5):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=0, atol=atol)


def _data(rng, n, shape, classes=2):
    y = rng.integers(0, classes, n)
    X = rng.standard_normal((n,) + tuple(shape)).astype(np.float32) * 0.1
    X[y == 1, 2:6, 2:6, :] += 2.0
    return X, y


def test_config_json_and_layout():
    for d in (VALID, SAME):
        jcfg = JCNN.CNNConfig.from_json_dict(d)
        tcfg = TCNN.CNNConfig.from_json_dict(d)
        assert tcfg.to_json_dict() == jcfg.to_json_dict()
        assert TCNN.CNNConfig.from_json_dict(tcfg.to_json_dict()) == tcfg
        assert tcfg.conv_output_shapes() == jcfg.conv_output_shapes()
        assert tcfg.layer_indices() == jcfg.layer_indices()
        assert convert.convert_cnn_config(jcfg) == tcfg
    _, jp, _, model = _pair(SAME)
    assert TCNN.num_params(model) == JCNN.num_params(jp)


@pytest.mark.parametrize("cfg", [VALID, SAME], ids=["valid", "same"])
def test_loss_and_grads_match_jax(rng, cfg):
    jcfg, jp, tcfg, model = _pair(cfg, seed=3)
    x = rng.standard_normal((5,) + tuple(cfg["input_shape"])).astype(np.float32)
    y = np.eye(cfg["num_classes"], dtype=np.float32)[rng.integers(0, cfg["num_classes"], 5)]
    jloss, jgrads = JCNN.grads_fn(jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    loss, grads = TCNN.grads_fn(model, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _close_params(grads, _params(jgrads, tcfg))
    probs = JCNN.forward(jp, jnp.asarray(x), jcfg)
    tprobs = TCNN.forward(model, torch.from_numpy(x))
    np.testing.assert_allclose(float(TCNN.cross_entropy(tprobs, torch.from_numpy(y))),
                               float(JCNN.cross_entropy(probs, jnp.asarray(y))), rtol=1e-5)
    np.testing.assert_allclose(
        TCNN.cross_entropy(tprobs[0], torch.from_numpy(y[0])).detach().numpy(),
        np.asarray(JCNN.cross_entropy(probs[0], jnp.asarray(y[0]))), rtol=1e-5)


def test_clip_matches_jax(rng):
    for scale in (0.1, 10.0):
        g = (rng.standard_normal((7, 5)) * scale).astype(np.float32)
        np.testing.assert_allclose(
            TTree.clip_tensor_by_norm(torch.from_numpy(g)).numpy(),
            np.asarray(JTree.clip_tensor_by_norm(jnp.asarray(g))), rtol=0, atol=1e-7)
    assert torch.equal(TTree.clip_grads_per_leaf([torch.ones(2)])[0], torch.ones(2))


@pytest.mark.parametrize("cfg", [VALID, SAME], ids=["valid", "same"])
def test_sgd_step_matches_jax(rng, cfg):
    jcfg, jp, tcfg, model = _pair(cfg, seed=1)
    b = 6
    x = rng.standard_normal((b,) + tuple(cfg["input_shape"])).astype(np.float32)
    y = np.eye(cfg["num_classes"], dtype=np.float32)[rng.integers(0, cfg["num_classes"], b)]
    mask = np.ones(b, np.float32)
    mask[-2:] = 0.0                             # a padded tail
    lr = 0.05
    # x50: gradient norms above 5, so the per-tensor clip engages
    for x_ in (x, x * 50):
        _, jp_, _, model_ = _pair(cfg, seed=1)
        new, jloss = JS.sgd_train_step(
            jax.tree_util.tree_map(jnp.asarray, jp_), jnp.asarray(x_), jnp.asarray(y),
            jnp.asarray(mask), jnp.float32(lr), jax.random.key(0), jcfg, training=False)
        loss = TS.sgd_train_step(model_, torch.from_numpy(x_), torch.from_numpy(y),
                                 torch.from_numpy(mask), lr, None, training=False)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _close_params(model_.parameters(), _params(new, tcfg))


@pytest.mark.parametrize("cfg", [VALID, SAME], ids=["valid", "same"])
def test_adam_steps_match_jax(rng, cfg):
    """Two JAX Adam steps; the port takes the second from the converted
    state after the first, and one from its own init."""
    jcfg, jp, tcfg, model = _pair(cfg, seed=2)
    tx = JOpt.adam(1e-3)
    jstep = JS.make_adam_train_step(jcfg, tx)
    batches = []
    for _ in range(2):
        x = rng.standard_normal((4,) + tuple(cfg["input_shape"])).astype(np.float32)
        y = np.eye(cfg["num_classes"], dtype=np.float32)[rng.integers(0, cfg["num_classes"], 4)]
        batches.append((x, y, np.ones(4, np.float32)))
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    opt_state = tx.init(params)
    states = []
    for x, y, m in batches:
        params, opt_state, loss = jstep(params, opt_state, jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(m), jax.random.key(0))
        states.append((jax.tree_util.tree_map(np.asarray, params),
                       jax.tree_util.tree_map(np.asarray, opt_state), float(loss)))

    def conv(t):
        return convert.convert_classifier(t, tcfg)

    port_tx = TOpt.adam(1e-3)
    tstep = TS.make_adam_train_step(port_tx)
    # from the port's own init: step 1
    st = port_tx.init(model.parameters())
    x, y, m = (torch.from_numpy(a) for a in batches[0])
    st, loss = tstep(model, st, x, y, m, None)
    np.testing.assert_allclose(float(loss), states[0][2], rtol=1e-5)
    _close_params(model.parameters(), _params(states[0][0], tcfg))
    ref_state = convert.convert_adam_state(states[0][1], conv)
    assert st.count == ref_state.count == 1
    _close_params(st.mu, ref_state.mu)
    _close_params(st.nu, ref_state.nu)
    # from the converted JAX state: step 2
    model2 = conv(states[0][0])
    st2 = convert.convert_adam_state(states[0][1], conv)
    x, y, m = (torch.from_numpy(a) for a in batches[1])
    st2, loss = tstep(model2, st2, x, y, m, None)
    np.testing.assert_allclose(float(loss), states[1][2], rtol=1e-5)
    _close_params(model2.parameters(), _params(states[1][0], tcfg))
    ref_state = convert.convert_adam_state(states[1][1], conv)
    assert st2.count == 2
    _close_params(st2.mu, ref_state.mu)
    _close_params(st2.nu, ref_state.nu)


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.05), ("adam", 3e-3)])
@pytest.mark.parametrize("device_data", [True, False])
def test_fit_history_matches_jax(rng, optimizer, lr, device_data):
    """n=20, batch 8: every epoch ends on a masked partial batch."""
    jcfg, jp, tcfg, model = _pair(VALID, seed=4)
    X, y = _data(rng, 20, VALID["input_shape"])
    Xt, yt = _data(rng, 12, VALID["input_shape"])
    ref = JS.fit(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, X, np.eye(2)[y], Xt, yt,
                 epochs=2, lr=lr, batch_size=8, optimizer=optimizer, seed=0)
    before = [p.detach().clone() for p in model.parameters()]
    res = TS.fit(model, X, np.eye(2)[y], Xt, yt, epochs=2, lr=lr, batch_size=8,
                 optimizer=optimizer, seed=0, device_data=device_data, device="cpu")
    for a, b in zip(model.parameters(), before):
        assert torch.equal(a, b)                # the caller's model is untouched
    assert len(res.history) == len(ref.history) == 2
    for r, j in zip(res.history, ref.history):
        assert r["epoch"] == j["epoch"] and r["val_acc"] == j["val_acc"]
        np.testing.assert_allclose(r["loss"], j["loss"], rtol=1e-5)
    assert res.best_val_acc == ref.best_val_acc
    assert res.epoch_accuracy == ref.epoch_accuracy
    _close_params(res.model.parameters(), _params(ref.params, tcfg), atol=1e-4)
    assert TS.evaluate(res.model, Xt, yt) == pytest.approx(
        JS.evaluate(ref.params, Xt, yt, jcfg))
    np.testing.assert_array_equal(TS.predict_classes(res.model, Xt, batch_size=5),
                                  JS.predict_classes(ref.params, Xt, jcfg))


def test_resume_equals_uninterrupted(rng, tmp_path):
    """Adam with dropout: the resumed run restores the parameters, the
    optimizer state, the shuffle and the dropout generator."""
    cfg = TCNN.CNNConfig.from_json_dict(dict(VALID, dropout_rate=0.3))
    model = TCNN.init_params(torch.Generator().manual_seed(0), cfg)
    X, y = _data(rng, 20, VALID["input_shape"])
    kw = dict(lr=3e-3, batch_size=8, optimizer="adam", seed=5, device="cpu")
    full = TS.fit(model, X, np.eye(2)[y], X[:8], y[:8], epochs=3, **kw)
    path = str(tmp_path / "state.pkl")
    lines = []
    TS.fit(model, X, np.eye(2)[y], X[:8], y[:8], epochs=2, state_path=path, **kw)
    resumed = TS.fit(model, X, np.eye(2)[y], X[:8], y[:8], epochs=3, state_path=path,
                     resume=True, log_fn=lines.append, **kw)
    assert lines[0].startswith("[RESUME]") and len(lines) == 2
    assert resumed.history == full.history
    for a, b in zip(resumed.model.parameters(), full.model.parameters()):
        assert torch.equal(a, b)
    state = TCK.load_train_state(path)
    assert state["epoch"] == 3 and state["generator_state"].dtype == np.uint8


def test_train_state_unpickler_rejects_code(tmp_path):
    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:
        pickle.dump({"x": pickle.loads}, f)
    with pytest.raises(pickle.UnpicklingError):
        TCK.load_train_state(path)
    TCK.save_train_state(path, {"a": [torch.ones(2), np.zeros(3, np.int32)], "b": (1.5, "s")})
    back = TCK.load_train_state(path)
    np.testing.assert_array_equal(back["a"][0], np.ones(2, np.float32))
    assert back["b"] == (1.5, "s")


@pytest.mark.parametrize("cfg", [VALID, SAME], ids=["valid", "same"])
def test_npz_cross_loads_both_ways(tmp_path, cfg):
    jcfg, jp, tcfg, model = _pair(cfg, seed=6)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    JCK.save_npz(jp, jcfg, jpath)
    cfg_t, loaded = TCK.load_npz(jpath)
    assert cfg_t == tcfg
    for a, b in zip(loaded.parameters(), model.parameters()):
        assert torch.equal(a, b)
    TCK.save_npz(model, tpath)
    cfg_j, back = JCK.load_npz(tpath)
    assert cfg_j == jcfg
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with np.load(tpath) as t, np.load(jpath) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])
    with open(tpath, "wb") as f:
        f.write(b"not a zip")
    with pytest.raises(ValueError):
        TCK.load_npz(tpath)


@pytest.mark.parametrize("n,k,shuffle", [(23, 5, False), (10, 3, True), (7, 7, False)])
def test_kfold_matches_jax(n, k, shuffle):
    ours = list(TCV.KFold(k, shuffle=shuffle, seed=3).split(n))
    ref = list(JCV.KFold(k, shuffle=shuffle, seed=3).split(n))
    assert len(ours) == len(ref) == k
    for (a, b), (c, d) in zip(ours, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError):
        TCV.KFold(1)


def test_metrics_and_summary_match_jax(rng, tmp_path):
    y_true = rng.integers(0, 3, 40)
    y_pred = np.where(rng.random(40) < 0.6, y_true, rng.integers(0, 3, 40))
    y_pred[y_pred == 2] = 1                      # class 2 is never predicted
    np.testing.assert_array_equal(TM.confusion_matrix(y_true, y_pred, 3).numpy(),
                                  np.asarray(JM.confusion_matrix(jnp.asarray(y_true),
                                                                 jnp.asarray(y_pred), 3)))
    assert TM.classification_report(y_true, y_pred, 3) == JM.classification_report(
        y_true, y_pred, 3)
    assert TM.evaluation_block(y_true, y_pred, 3) == JM.evaluation_block(y_true, y_pred, 3)
    jcfg = JCNN.CNNConfig.from_json_dict(SAME)
    kw = dict(num_samples=50, train_split=40, test_split=10, epochs=3, batch_size=8,
              learning_rate=0.01, device="cpu", best_val_acc=0.7, y_true=y_true,
              y_pred=y_pred, label_encoder={"A": 0, "B": 1, "C": 2}, train_seconds=3725.4)
    ours = TSum.build_summary(config=convert.convert_cnn_config(jcfg), **kw)
    assert ours == JSum.build_summary(config=jcfg, **kw)
    assert ours["Training Time"] == "01:02:05"
    TSum.write_summary(ours, str(tmp_path / "s" / "summary.json"))
    back = TSum.load_summary(str(tmp_path / "s" / "summary.json"))
    assert TSum.config_from_summary(back) == TCNN.CNNConfig.from_json_dict(
        dict(SAME, conv_padding="VALID"))     # the summary has no padding key, as in JAX
    hist = [{"epoch": 1, "loss": 0.5, "val_acc": 0.75}]
    TSum.write_history(hist, str(tmp_path / "h.json"))
    assert TSum.load_history(str(tmp_path / "h.json")) == JSum.load_history(
        str(tmp_path / "h.json")) == hist


def test_dropout_keep_rate_scaling_and_determinism():
    cfg = TCNN.CNNConfig(input_shape=(4, 4, 1), num_classes=2, conv_layers=((2, 1),),
                         hidden_units=(1,), dropout_rate=0.3)
    model = TCNN.init_params(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        model.dense_w[0].fill_(0.0)
        model.dense_b[0].fill_(1.0)              # the hidden unit is 1 before dropout
        model.out_w.zero_()
        model.out_w[0, 0] = 1.0                  # logit 0 is the hidden unit
    x = torch.zeros((20000, 4, 4, 1))

    def logits(seed, training=True):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return TCNN.apply(model, x, training, g)[:, 0]

    out = logits(1)
    scaled = torch.ones(()) / (1.0 - 0.3)        # a kept unit is 1 / (1 - rate)
    kept = out == scaled
    assert bool((kept | (out == 0)).all())
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.equal(out, logits(1))           # deterministic under a seed
    assert not torch.equal(out, logits(2))
    assert torch.equal(logits(1, training=False), torch.ones(20000))


def test_stats_lines_and_cross_validate(rng):
    jcfg, jp, tcfg, model = _pair(VALID)
    lines = TS.weight_stats(model)
    assert len(lines) == len(JS.weight_stats(jp)) == 3
    assert lines[0].startswith("Layer conv_w.0: mean=")
    x = rng.standard_normal((3, 12, 12, 2)).astype(np.float32)
    _, grads = TCNN.grads_fn(model, torch.from_numpy(x), torch.eye(2)[[0, 1, 1]])
    assert len(TS.grad_stats(model, grads)) == 6
    X, y = _data(rng, 15, VALID["input_shape"])
    cv = TCV.cross_validate(tcfg, X, y, n_splits=3, epochs=1, batch_size=4, device="cpu")
    assert len(cv.fold_results) == 3 and 0.0 <= cv.mean_accuracy <= 1.0
    assert cv.aggregate_metrics()["n_splits"] == 3
    assert set(cv.fold_evaluations[0]) == {"test_accuracy", "confusion_matrix",
                                           "classification_report"}


def test_entry_points_need_a_card_unless_told_cpu(rng):
    """Without a GPU the trainers and the engine raise unless given
    device="cpu"; with one they run there (test_torch_cuda.py)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cadx_tpu_torch.serve.engine import EngineConfig, InferenceEngine
    from cadx_tpu_torch.tools import bench_train

    _, _, tcfg, model = _pair(VALID)
    X, y = _data(rng, 4, VALID["input_shape"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.fit(model, X, np.eye(2)[y], X, y, epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TCV.cross_validate(tcfg, X, y, n_splits=2, epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(EngineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_train.main([])


def test_fit_logging_checkpoint_and_update_fn(rng, tmp_path):
    """eval_every_batch and log_weight_stats log as JAX does, checkpoint_path
    writes the best model in the npz schema, update_fn replaces the step."""
    jcfg, jp, tcfg, model = _pair(VALID, seed=7)
    X, y = _data(rng, 12, VALID["input_shape"])
    ours, ref = [], []
    path = str(tmp_path / "best.npz")
    kw = dict(epochs=2, lr=0.05, batch_size=8, eval_every_batch=True, log_weight_stats=True)
    res = TS.fit(model, X, np.eye(2)[y], X, y, log_fn=ours.append, checkpoint_path=path,
                 device="cpu", **kw)
    JS.fit(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, X, np.eye(2)[y], X, y,
           log_fn=ref.append, **kw)
    assert len(ours) == len(ref)

    def heads(lines):   # the epoch/batch tags; stats lines name layers per package
        return [line.split("]")[0] for line in lines if not line.startswith("    Layer ")]

    assert heads(ours) == heads(ref)
    assert sum(line.startswith("    Layer ") for line in ours) == 2 * 3
    _, best = TCK.load_npz(path)
    best_acc = max(r["val_acc"] for r in res.history)
    assert TS.evaluate(best, X, y) == pytest.approx(best_acc)

    calls = []

    def update_fn(m, opt_state, xb, yb, mb, lr, generator):
        calls.append((tuple(xb.shape), float(mb.sum()), lr))
        return opt_state, TS.sgd_train_step(m, xb, yb, mb, lr, generator)

    plain = TS.fit(model, X, np.eye(2)[y], X, y, epochs=2, lr=0.05, batch_size=8,
                   device="cpu")
    via = TS.fit(model, X, np.eye(2)[y], X, y, epochs=2, lr=0.05, batch_size=8,
                 update_fn=update_fn, device="cpu")
    assert [c[:2] for c in calls] == [((8, 12, 12, 2), 8.0), ((8, 12, 12, 2), 4.0)] * 2
    assert calls[2][2] == pytest.approx(0.05 * 0.98)
    assert via.history == plain.history
