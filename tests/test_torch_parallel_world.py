"""Port parity: `cadx_tpu_torch/parallel/` on a distributed mesh, gloo
worlds of 2 and 4 CPU processes spawned by `run_world` below,
against the JAX flows and the port's single-device steps.

The ranks run the functions of this module, which import neither jax nor
cadx_tpu (JAX is imported inside the tests, in the parent process). Every
rank runs the same program on the same seeded inputs; each takes its rows
and the collectives combine them. Tolerances as in
`test_torch_parallel.py`: 1e-5 against JAX (dropout 0) and against the
port's single-device step (dropout 0.3); the ranks' replicas
bit-identical; the spatial cleaner bit-exact. Each world has a timeout,
so a hung rendezvous fails its test.
"""

import csv
import os
import pickle
import socket
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

CFG = dict(input_shape=(12, 12, 2), num_classes=2, conv_layers=[(4, 3)],
           hidden_units=[16], dropout_rate=0.0, leaky_alpha=0.01)
DROP_CFG = dict(CFG, hidden_units=[16, 8], dropout_rate=0.3)
LR = 0.05


def _batches(seed=0, b=16, real=13):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        y = rng.integers(0, 2, b)
        X = rng.standard_normal((b, 12, 12, 2)).astype(np.float32) * 0.1
        X[y == 1, 3:7, 3:7, :] += 2.0
        mask = np.ones(b, np.float32)
        mask[real:] = 0.0
        out.append((X, np.eye(2, dtype=np.float32)[y], mask))
    return out


def _world_rank(rank, fn, args, nprocs, port, out_dir):
    """A spawned rank: torchrun's environment, then `fn(*args)`, its
    result pickled into `out_dir`."""
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    result = fn(*args)
    Path(out_dir, f"{rank}.pkl").write_bytes(pickle.dumps(result))
    if dist.is_initialized():
        dist.destroy_process_group()


def run_world(fn, nprocs, args=(), timeout=120.0):
    """Each rank's `fn(*args)`, in rank order, from `nprocs` spawned
    processes on a free localhost port. A rank that fails raises here with
    its traceback; a world that outlasts `timeout` seconds is killed and
    raises, so a hung rendezvous fails the test."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_world_rank, (fn, args, nprocs, port, tmp), nprocs=nprocs,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{fn.__name__} on {nprocs} ranks outlasted {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [pickle.loads(Path(tmp, f"{r}.pkl").read_bytes()) for r in range(nprocs)]


def _model(cfg_dict, arrays=None):
    from cadx_tpu_torch.models import cnn

    cfg = cnn.CNNConfig.from_json_dict(cfg_dict)
    model = cnn.init_params(torch.Generator().manual_seed(0), cfg)
    if arrays is not None:
        with torch.no_grad():
            for p, a in zip(model.parameters(), arrays, strict=True):
                p.copy_(torch.from_numpy(a))
    return cfg, model


def _steps(model, update, state, seed=7):
    """Two updates on _batches' rows; the losses, as floats."""
    g = torch.Generator().manual_seed(seed)
    losses = []
    for X, Y, mask in _batches():
        state, loss = update(model, state, torch.from_numpy(X), torch.from_numpy(Y),
                             torch.from_numpy(mask), LR, g)
        losses.append(float(loss))
    return losses


def _numpy(model):
    return [p.detach().numpy().copy() for p in model.parameters()]


def _images(seed=3):
    rng = np.random.default_rng(seed)
    enc_img = rng.random((2, 64, 48, 1)).astype(np.float32)
    u16 = rng.integers(0, 3000, (64, 48)).astype(np.uint16)
    u16[5, 7] = 60000
    return enc_img, u16


def world_checks(arrays):
    """One rank's data-parallel runs; `arrays` are the classifier's
    starting weights (JAX's, converted)."""
    import torch.distributed as dist

    from cadx_tpu_torch.models import unet
    from cadx_tpu_torch.parallel import data_parallel as DP
    from cadx_tpu_torch.parallel import mesh as M
    from cadx_tpu_torch.parallel import spatial as SP
    from cadx_tpu_torch.pipeline import fused
    from cadx_tpu_torch.train import segmentation as seg

    M.initialize_distributed(backend="gloo")
    mesh = M.make_mesh(device="cpu")
    out = {"rank": dist.get_rank(), "shape": mesh.shape, "distributed": mesh.distributed}
    cfg, model = _model(CFG, arrays)
    out["sgd_loss"] = _steps(model, DP.make_dp_sgd_update(cfg, mesh), None)
    out["sgd"] = _numpy(model)
    cfg, model = _model(CFG, arrays)
    update, init = DP.make_dp_adam_update(cfg, mesh, 1e-3)
    out["adam_loss"] = _steps(model, update, init(model.parameters()))
    out["adam"] = _numpy(model)
    for name in ("sgd", "adam"):
        cfg, model = _model(DROP_CFG)
        if name == "sgd":
            _steps(model, DP.make_dp_sgd_update(cfg, mesh), None)
        else:
            update, init = DP.make_dp_adam_update(cfg, mesh, 1e-3)
            _steps(model, update, init(model.parameters()))
        out[f"{name}_dropout"] = _numpy(model)
    out["eval"] = DP.make_dp_eval(cfg, mesh)(model, torch.from_numpy(_batches()[0][0])).numpy()

    enc_img, u16 = _images()
    stem = unet.init_resnet_stem(torch.Generator().manual_seed(1))
    out["encoder"] = SP.make_spatial_encoder(mesh)(stem, torch.from_numpy(enc_img)).numpy()
    out["cleaner"] = SP.make_spatial_cleaner(mesh)(torch.from_numpy(u16)).numpy()

    pcfg = fused.PipelineConfig(image_hw=(32, 32), feature_hw=(8, 8), classifier=cfg.__class__(
        input_shape=(8, 8, 64), num_classes=2, conv_layers=((4, 3),), hidden_units=(8,)))
    params = fused.init_pipeline_params(torch.Generator().manual_seed(2), pcfg)
    batch = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (4, 32, 32),
                                                               dtype=np.uint8))
    got = DP.make_dp_pipeline(pcfg, mesh)(params, batch)
    want = fused.run_pipeline(params, batch, pcfg)
    out["pipeline"] = {f: (getattr(got, f).numpy(), getattr(want, f).numpy())
                       for f in got._fields}

    ucfg = unet.UNetConfig(features=(4, 8))
    umodel = unet.init_unet(torch.Generator().manual_seed(0), ucfg)
    rng = np.random.default_rng(5)
    X = rng.random((8, 16, 16, 1)).astype(np.float32)
    Y = (X > 0.6).astype(np.float32)
    res = seg.fit_segmentation(umodel, X, Y, X[:4], Y[:4], epochs=1, batch_size=4,
                               mesh=mesh, device="cpu")
    out["seg_loss"] = res.history[0]["loss"]
    return out


@pytest.mark.parametrize("nprocs", [2, 4])
def test_dp_world_matches_jax_and_single_device(nprocs):
    import jax
    import jax.numpy as jnp

    from cadx_tpu.models import cnn as JCNN
    from cadx_tpu.models import unet as JU
    from cadx_tpu.parallel import data_parallel as JDP
    from cadx_tpu.parallel import mesh as JMesh
    from cadx_tpu.parallel import spatial as JSP
    from cadx_tpu.train import step as JS
    from cadx_tpu_torch import convert
    from cadx_tpu_torch.models import unet
    from cadx_tpu_torch.train import optim as TOpt
    from cadx_tpu_torch.train import segmentation as seg
    from cadx_tpu_torch.train import step as TS

    jcfg = JCNN.CNNConfig.from_json_dict(CFG)
    jp = jax.tree_util.tree_map(np.asarray, JCNN.init_params(jax.random.key(0), jcfg))
    tcfg = convert.convert_cnn_config(jcfg)
    arrays = _numpy(convert.convert_classifier(jp, tcfg))
    ranks = run_world(world_checks, nprocs, args=(arrays,), timeout=240)
    assert [r["rank"] for r in ranks] == list(range(nprocs))
    assert all(r["distributed"] and r["shape"] == {"data": nprocs, "model": 1}
               for r in ranks)

    def conv(tree):
        return _numpy(convert.convert_classifier(jax.tree_util.tree_map(np.asarray, tree),
                                                 tcfg))

    # JAX, dropout 0: single-device SGD and the data-parallel Adam
    single = jax.tree_util.tree_map(jnp.array, jp)
    jdp = jax.tree_util.tree_map(jnp.array, jp)
    jupdate, jinit = JDP.make_dp_adam_update(jcfg, JMesh.make_mesh(), 1e-3)
    jstate = jinit(jdp)
    for X, Y, mask in _batches():
        single, jloss = JS.sgd_train_step(single, jnp.asarray(X), jnp.asarray(Y),
                                          jnp.asarray(mask), jnp.float32(LR),
                                          jax.random.key(1), jcfg, training=False)
        jdp, jstate, _ = jupdate(jdp, jstate, jnp.asarray(X), jnp.asarray(Y),
                                 jnp.asarray(mask), None, jax.random.key(1))
    # the port on one device, dropout 0.3
    ref_drop = {}
    for name in ("sgd", "adam"):
        cfg, model = _model(DROP_CFG)
        if name == "sgd":
            _steps(model, lambda m, s, x, y, mk, lr, g: (
                s, TS.sgd_train_step(m, x, y, mk, lr, g)), None)
        else:
            tx = TOpt.adam(1e-3)
            step = TS.make_adam_train_step(tx)
            _steps(model, lambda m, s, x, y, mk, lr, g: step(m, s, x, y, mk, g),
                   tx.init(model.parameters()))
        ref_drop[name] = _numpy(model)

    for r in ranks:
        np.testing.assert_allclose(r["sgd_loss"][-1], float(jloss), rtol=1e-5)
        for got, want in (("sgd", conv(single)), ("adam", conv(jdp)),
                          ("sgd_dropout", ref_drop["sgd"]),
                          ("adam_dropout", ref_drop["adam"])):
            for a, b in zip(r[got], want, strict=True):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=got)
            for a, b in zip(r[got], ranks[0][got], strict=True):
                np.testing.assert_array_equal(a, b, err_msg=f"{got}: replicas differ")
    # eval, the encoder and the cleaner on the whole batch, on every rank
    _, model = _model(DROP_CFG, ref_drop["adam"])
    want_eval = TS.eval_step(model, torch.from_numpy(_batches()[0][0])).numpy()
    enc_img, u16 = _images()
    stem = unet.init_resnet_stem(torch.Generator().manual_seed(1))
    jkernel = stem.conv1.detach().permute(2, 3, 1, 0).numpy()
    want_enc = np.asarray(JU.encoder_first_features({"conv1": {"kernel": jkernel}},
                                                    jnp.asarray(enc_img)))
    want_clean = np.asarray(JSP.make_spatial_cleaner(JMesh.make_mesh())(jnp.asarray(u16)))
    ucfg = unet.UNetConfig(features=(4, 8))
    rng = np.random.default_rng(5)
    X = rng.random((8, 16, 16, 1)).astype(np.float32)
    Y = (X > 0.6).astype(np.float32)
    seg_ref = seg.fit_segmentation(unet.init_unet(torch.Generator().manual_seed(0), ucfg),
                                   X, Y, X[:4], Y[:4], epochs=1, batch_size=4, device="cpu")
    for r in ranks:
        np.testing.assert_array_equal(r["eval"], want_eval)
        np.testing.assert_allclose(r["encoder"], want_enc, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(r["cleaner"], want_clean)
        np.testing.assert_allclose(r["seg_loss"], seg_ref.history[0]["loss"], rtol=0,
                                   atol=1e-5)
        p = r["pipeline"]
        for f in ("clean_u8", "predicted"):
            np.testing.assert_array_equal(*p[f], err_msg=f)
        for f in ("probs", "features"):
            np.testing.assert_allclose(*p[f], rtol=0, atol=1e-5, err_msg=f)
        for f in ("heatmaps", "overlays"):
            assert np.abs(p[f][0].astype(int) - p[f][1].astype(int)).max() <= 2, f


def cli_rank(argv):
    """One rank of the training CLI under a torchrun-like environment (the
    CLI joins the group itself); the files it wrote, by path."""
    from cadx_tpu_torch import checkpoint
    from cadx_tpu_torch.tools import train
    from cadx_tpu_torch.train import summary

    written = []

    def recording(fn):
        def wrapper(*args, **kwargs):
            written.append(os.path.basename(str(args[1] if fn.__name__ != "save_train_state"
                                                else args[0])))
            return fn(*args, **kwargs)
        return wrapper

    checkpoint.save_npz = recording(checkpoint.save_npz)
    checkpoint.save_train_state = recording(checkpoint.save_train_state)
    summary.write_summary = recording(summary.write_summary)
    summary.write_history = recording(summary.write_history)
    s = train.main(argv)
    return {"rank": int(os.environ["RANK"]), "written": sorted(set(written)),
            "test_accuracy": s["evaluation"]["test_accuracy"],
            "device": s["training"]["device"]}


def test_train_cli_data_parallel_world(tmp_path):
    """`--data-parallel` on a 2-rank gloo world: both ranks train the same
    model, only rank 0 writes --out-dir."""
    from cadx_tpu_torch.data import dicom

    rng = np.random.default_rng(0)
    rows = []
    for i in range(16):
        img = rng.normal(1000, 150, (48, 48)).clip(0, 4095)
        if i % 2:
            img[14:34, 14:34] += 1200
        p = str(tmp_path / f"c{i}.dcm")
        dicom.dcmwrite_minimal(p, img.clip(0, 4095).astype(np.uint16), f"P{i}")
        rows.append((p, "MALIGNANT" if i % 2 else "BENIGN"))
    cp = str(tmp_path / "mapping.csv")
    with open(cp, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dicom_file_path", "pathology"])
        w.writerows(rows)
    out = str(tmp_path / "out")
    argv = ["--csv", cp, "--out-dir", out, "--pipeline", "basic", "--features", "raw",
            "--resize", "24", "--epochs", "2", "--lr", "0.05", "--batch-size", "4",
            "--conv-layers", "4x3", "--hidden-units", "16", "--dropout", "0.3",
            "--device", "cpu", "--data-parallel"]
    ranks = run_world(cli_rank, 2, args=(argv,), timeout=180)
    files = ["cnn_model_basic.npz", "train_state.pkl", "training_History_basic.json",
             "training_summary_basic.json"]
    assert ranks[0]["written"] == sorted(files)
    assert ranks[1]["written"] == []
    assert ranks[0]["test_accuracy"] == ranks[1]["test_accuracy"]
    assert ranks[0]["device"] == "cpu"
    assert sorted(os.listdir(out)) == sorted(files)
    # the world's model equals the one-process local mesh's over two CPU devices
    from cadx_tpu_torch import checkpoint
    from cadx_tpu_torch.tools import train

    local = str(tmp_path / "local")
    train.main([a if a != out else local for a in argv[:-3]]
               + ["--device", "cpu,cpu", "--data-parallel"])
    _, world_model = checkpoint.load_npz(os.path.join(out, "cnn_model_basic.npz"))
    _, local_model = checkpoint.load_npz(os.path.join(local, "cnn_model_basic.npz"))
    for a, b in zip(world_model.parameters(), local_model.parameters(), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-6)
    assert ranks[0]["written"] == sorted(os.listdir(local))
