"""Port parity: the `Classes/` compat API (`cadx_tpu_torch/compat/`)
against the JAX package's (`cadx_tpu/compat/`), flow by flow as
`tests/test_compat.py` runs JAX's, on the CPU.

Seeds draw other weights in the two packages, so every model the two
share is JAX's, carried across by `convert.py` (or through the npz
format). Tolerances: float32 forward paths (probs, the
encoder, heatmaps) 1e-5; anything trained (losses, parameters) 1e-4
after a few epochs of float32 sums taken in another order; uint8
overlays +-1 where a resize lands within rounding of .5; labels, shapes,
file formats, accuracies and metric blocks exact. Also the advanced
exporter: the port's state dict equals JAX's `torch_state_dict_from_params`
bit for bit and round-trips through the port's loader.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

import cadx_tpu.compat as J
from cadx_tpu.compat import adcnnm as JAD
from cadx_tpu.compat.load import load_dicom as j_load_dicom
from cadx_tpu.data import dicom as JDicom
from cadx_tpu.models import cnn as JCNN
import cadx_tpu_torch.compat as T
from cadx_tpu_torch import convert
from cadx_tpu_torch.compat import adcnnm as TAD
from cadx_tpu_torch.data import dicom as TDicom
from cadx_tpu_torch.models import cnn as TCNN

CPU = "cpu"
FWD_TOL = 1e-5
TRAIN_TOL = 1e-4


def _carry(jmodel, tmodel):
    """JAX CNNModel weights into the port's CNNModel."""
    tmodel.params = convert.convert_classifier(
        jax.tree_util.tree_map(np.asarray, jmodel.params), tmodel.config)


def _same_params(tmodel, jmodel, atol):
    want = convert.convert_classifier(jax.tree_util.tree_map(np.asarray, jmodel.params),
                                      tmodel.config)
    for a, b in zip(tmodel.params.parameters(), want.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=atol, rtol=0)


@pytest.fixture
def dicom_dataset(tmp_path, rng):
    """Three synthetic DICOMs + a mapping CSV (one path intentionally bad)."""
    paths = []
    for i, label in enumerate(["BENIGN", "MALIGNANT", "BENIGN"]):
        img = rng.integers(0, 4096, (32, 24), dtype=np.uint16)
        p = str(tmp_path / f"case{i}.dcm")
        JDicom.dcmwrite_minimal(p, img, patient_id=f"P{i:04d}.dcm")
        paths.append((p, label))
    csv_path = str(tmp_path / "mapping.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dicom_file_path", "pathology"])
        for p, label in paths:
            w.writerow([p, label])
        w.writerow([str(tmp_path / "missing.dcm"), "BENIGN"])  # graceful skip
    return csv_path


def test_dicom_roundtrip(tmp_path, rng):
    """Each package's writer read back by the other's reader."""
    img = rng.integers(0, 65535, (16, 20), dtype=np.uint16)
    for write, read in ((JDicom.dcmwrite_minimal, TDicom.dcmread),
                        (TDicom.dcmwrite_minimal, JDicom.dcmread)):
        p = str(tmp_path / "x.dcm")
        write(p, img, patient_id="HELLO")
        ds = read(p)
        np.testing.assert_array_equal(ds.pixel_array, img)
        assert ds.PatientID == "HELLO"
    with pytest.raises(TDicom.DicomError):
        TDicom.dcmread(b"\x00" * 200)


def test_preprocessing_loads_and_encodes(dicom_dataset):
    logs_j, logs_t = [], []
    jp = J.Preprocessing(dicom_dataset, log=logs_j.append)
    tp = T.Preprocessing(dicom_dataset, log=logs_t.append, device=CPU)
    assert tp.data_set_size == jp.data_set_size == 3
    assert [r["PatientID"] for r in tp.data_set] == [r["PatientID"] for r in jp.data_set]
    for a, b in zip(tp.raw_images, jp.raw_images):
        np.testing.assert_array_equal(a, b)
    jp.fit_label_encoder()
    tp.fit_label_encoder()
    assert tp.label_encoder == jp.label_encoder == {"BENIGN": 0, "MALIGNANT": 1}
    assert tp.raw_classes == jp.raw_classes == [0, 1, 0]
    assert logs_t == logs_j
    resized = tp.resize_images(tp.raw_images, (16, 16))
    np.testing.assert_allclose(resized, jp.resize_images(jp.raw_images, (16, 16)),
                               atol=FWD_TOL * 4096)
    norm = tp.normalize_images(resized)
    np.testing.assert_allclose(norm, jp.normalize_images(resized), atol=FWD_TOL)
    got = tp.split_train_test(norm, np.array(tp.raw_classes), 0.34)
    want = jp.split_train_test(norm, np.array(jp.raw_classes), 0.34)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_image_segmentation_contract(rng):
    """The encoder on JAX's own random weights (drawn from its seed) gives
    JAX's features; the ops and the contract's shapes and errors agree."""
    jseg, tseg = J.ImageSegmentation(seed=0), T.ImageSegmentation(seed=0, device=CPU)
    img = rng.random((24, 24, 1)).astype(np.float32)
    jseg.load_image(img)
    tseg.load_image(img)
    assert tseg.original_image.shape == (1, 24, 24, 1)
    jout = jseg.unet()
    keys = jax.random.split(jax.random.key(0), 3)
    ws = [np.asarray(jax.random.normal(k, s)) for k, s in
          zip(keys, ((3, 3, 1, 16), (3, 3, 16, 32), (3, 3, 32, 64)))]
    tout = tseg.encode(tseg.original_image, *ws)
    assert tout.shape == jout.shape == (1, 2, 2, 64)
    np.testing.assert_allclose(tout, jout, atol=FWD_TOL * max(1.0, np.abs(jout).max()), rtol=0)
    assert tseg.unet().shape == (1, 2, 2, 64)      # its own seeded weights
    with pytest.raises(ValueError):
        tseg.load_image(rng.random((2, 3)))
    np.testing.assert_array_equal(tseg.upsample(jout), jseg.upsample(jout))
    tseg.preprocessed_image = jseg.preprocessed_image = np.asarray(jout)
    np.testing.assert_allclose(tseg.postprocess_segmented_image(),
                               jseg.postprocess_segmented_image(), atol=FWD_TOL)
    x = rng.random((2, 10, 12, 3)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(tseg.conv2d(x, k), jseg.conv2d(x, k), atol=FWD_TOL)
    np.testing.assert_allclose(tseg.conv2d(x, k, "valid"), jseg.conv2d(x, k, "valid"),
                               atol=FWD_TOL)
    np.testing.assert_array_equal(tseg.max_pool(x), jseg.max_pool(x))
    np.testing.assert_allclose(tseg.average_pool(x, 5), jseg.average_pool(x, 5), atol=FWD_TOL)


def test_tiny_unet_wrapper(rng):
    """fit (Adam on the MSE), predict and the bottleneck on JAX's initial
    weights carried across: the same loss history and outputs."""
    jm = J.tiny_unet((16, 16, 1))
    tm = T.tiny_unet((16, 16, 1), device=CPU)
    tm.params = convert.convert_tiny_unet_params(jax.tree_util.tree_map(np.asarray, jm.params))
    for m in (jm, tm):
        m.compile(optimizer="adam", loss="mse", learning_rate=3e-3)
    yy, xx = np.mgrid[0:16, 0:16] / 16.0
    x = np.stack([0.5 + 0.4 * np.sin(3 * xx + p) for p in np.linspace(0, 3, 8)])[..., None]
    jh = jm.fit(x, epochs=6, batch_size=4)
    th = tm.fit(x, epochs=6, batch_size=4)
    assert th[-1] < th[0]
    np.testing.assert_allclose(th, jh, atol=TRAIN_TOL, rtol=0)
    pred = tm.predict(x)
    assert pred.shape == x.shape
    np.testing.assert_allclose(pred, jm.predict(x), atol=TRAIN_TOL)
    bn = tm.bottleneck_features(x)
    assert bn.shape == (8, 4, 4, 64)
    np.testing.assert_allclose(bn, jm.bottleneck_features(x), atol=TRAIN_TOL * 10)


def test_cnn_model_class_surface(tmp_path, rng):
    kw = dict(input_shape=(12, 12, 2), num_classes=2, conv_layers=[(4, 3)],
              hidden_units=[16], dropout_rate=0.0)
    jm, tm = J.CNNModel(**kw), T.CNNModel(**kw, device=CPU)
    _carry(jm, tm)
    x = rng.standard_normal((12, 12, 2)).astype(np.float32)
    probs = tm.forward(x, training=False)
    assert probs.shape == (2,) and abs(probs.sum() - 1) < 1e-5
    np.testing.assert_allclose(probs, jm.forward(x, training=False), atol=FWD_TOL)
    assert tm.predict(x)[0] == jm.predict(x)[0]

    y = rng.integers(0, 2, 48)
    X = rng.standard_normal((48, 12, 12, 2)).astype(np.float32) * 0.1
    X[y == 1, 3:7, 3:7, :] += 2.0
    logs = []
    jres = jm.train(X, np.eye(2)[y], X[:16], y[:16], epochs=5, lr=0.05, batch_size=16,
                    log=logs.append)
    tres = tm.train(X, np.eye(2)[y], X[:16], y[:16], epochs=5, lr=0.05, batch_size=16,
                    log=logs.append)
    assert tres.best_val_acc == jres.best_val_acc >= 0.9
    assert tm.epoch_accuracy == jm.epoch_accuracy and len(tm.epoch_accuracy) == 5
    for a, b in zip(tm.history, jm.history):
        assert abs(a["loss"] - b["loss"]) <= TRAIN_TOL
    _same_params(tm, jm, TRAIN_TOL)
    jlogs, tlogs = [], []
    assert (tm.get_training_metrics(X[:16], y[:16], log=tlogs.append)
            == jm.get_training_metrics(X[:16], y[:16], log=jlogs.append))
    assert tlogs == jlogs

    # save / module-level load_weights, across the two packages' npz
    path = str(tmp_path / "cnn_model.npz")
    tm.save_model(path)
    m2 = T.load_weights(T.CNNModel, path, device=CPU)
    np.testing.assert_array_equal(m2.forward(x, training=False), tm.forward(x, training=False))
    jm2 = J.load_weights(J.CNNModel, path)
    np.testing.assert_allclose(jm2.forward(x, training=False), tm.forward(x, training=False),
                               atol=FWD_TOL)
    assert tm.summary() == jm.summary()


def test_cross_validator(rng, monkeypatch):
    """Two folds, each from JAX's initial weights of its seed."""
    from cadx_tpu_torch.train import crossval as TCV

    cv_j, cv_t = J.CrossValidator(n_splits=2), T.CrossValidator(n_splits=2, device=CPU)
    y = rng.integers(0, 2, 32)
    X = rng.standard_normal((32, 12, 12, 2)).astype(np.float32) * 0.1
    X[y == 1, 3:7, 3:7, :] += 2.0
    for (a, b), (c, d) in zip(cv_t.split_data(X, y), cv_j.split_data(X, y)):
        np.testing.assert_array_equal(a[0], c[0])
        np.testing.assert_array_equal(b[1], d[1])
    jcfg = JCNN.CNNConfig(input_shape=(12, 12, 2), num_classes=2, conv_layers=((4, 3),),
                          hidden_units=(16,), dropout_rate=0.0)
    tcfg = convert.convert_cnn_config(jcfg)

    def carried(generator, config, device=None):
        jp = jax.tree_util.tree_map(
            np.asarray, JCNN.init_params(jax.random.key(generator.initial_seed()), jcfg))
        return convert.convert_classifier(jp, tcfg).to(device)
    monkeypatch.setattr(TCV.cnn, "init_params", carried)
    cv_j.cross_validate(jcfg, X, y, epochs=2, lr=0.05, batch_size=8)
    cv_t.cross_validate(tcfg, X, y, epochs=2, lr=0.05, batch_size=8)
    agg_t, agg_j = cv_t.aggregate_metrics(), cv_j.aggregate_metrics()
    assert agg_t["n_splits"] == 2 and 0 <= agg_t["mean_accuracy"] <= 1
    assert agg_t["fold_accuracies"] == agg_j["fold_accuracies"]
    with pytest.raises(NotImplementedError):
        cv_t.cross_validate(tcfg, X, y, mesh=object())


def test_model_evaluator_predictor_trainer(tmp_path, rng):
    kw = dict(input_shape=(12, 12, 2), num_classes=2, conv_layers=[(4, 3)],
              hidden_units=[16], dropout_rate=0.0)
    jm, tm = J.CNNModel(**kw), T.CNNModel(**kw, device=CPU)
    _carry(jm, tm)
    X = rng.standard_normal((16, 12, 12, 2)).astype(np.float32)
    y = rng.integers(0, 2, 16)
    tb, jb = T.ModelEvaluator(tm).evaluate(X, y), J.ModelEvaluator(jm).evaluate(X, y)
    assert set(tb) == {"test_accuracy", "confusion_matrix", "classification_report"}
    assert tb == jb
    ev = T.ModelEvaluator(tm)
    assert ev.accuracy(X, y) == jb["test_accuracy"]
    np.testing.assert_array_equal(ev.confusion_matrix(X, y), np.asarray(jb["confusion_matrix"]))
    tpr, jpr = T.ModelPredictor(tm), J.ModelPredictor(jm)
    assert tpr.predict(X[0])[0] == jpr.predict(X[0])[0]
    np.testing.assert_array_equal(tpr.predict_batch(X), jpr.predict_batch(X))
    ttr, jtr = T.ModelTrainer(tm), J.ModelTrainer(jm)
    for tr in (ttr, jtr):
        tr.compile(optimizer="sgd", learning_rate=0.02)
        tr.train(X, np.eye(2)[y], X, y, epochs=1, batch_size=8)
    _same_params(tm, jm, TRAIN_TOL)
    path = str(tmp_path / "m.npz")
    ttr.save(path)
    assert os.path.exists(path)
    wrapper = T.Model(path, device=CPU)
    assert "CNNModel" in wrapper.summary()
    assert wrapper.summary() == J.Model(path).summary()


def test_explainable_ai(rng):
    kw = dict(input_shape=(16, 16, 3), num_classes=2, conv_layers=[(4, 3)],
              hidden_units=[16], dropout_rate=0.0)
    jm, tm = J.CNNModel(**kw), T.CNNModel(**kw, device=CPU)
    _carry(jm, tm)
    jx, tx = J.ExplainableAI(jm), T.ExplainableAI(tm)
    img = rng.standard_normal((16, 16, 3)).astype(np.float32)
    hm = tx.generate_heatmap(img, class_idx=1)
    assert hm.min() >= 0.0 and hm.max() <= 1.0
    np.testing.assert_allclose(hm, jx.generate_heatmap(img, class_idx=1), atol=FWD_TOL)
    display = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    overlay = tx.overlay_heatmap(display)
    assert overlay.shape == (32, 32, 3) and overlay.dtype == np.uint8
    diff = np.abs(overlay.astype(int) - jx.overlay_heatmap(display).astype(int))
    assert diff.max() <= 1
    sal = tx.generate_heatmap(img, class_idx=0, method="saliency")
    assert sal.shape == (16, 16)
    np.testing.assert_allclose(sal, jx.generate_heatmap(img, class_idx=0, method="saliency"),
                               atol=1.0 / 255 + FWD_TOL)
    vis = tx.visualize_prediction(img, class_idx=1)
    assert vis.shape == (16, 16, 3)


def test_load_dicom_demo(tmp_path, rng, capsys):
    img = rng.integers(0, 4096, (16, 16), dtype=np.uint16)
    p = str(tmp_path / "demo.dcm")
    TDicom.dcmwrite_minimal(p, img, patient_id="DEMO1")
    ds = T.load_dicom(p, show=False)
    out = capsys.readouterr().out
    assert "DEMO1" in out and "Pixel array" in out
    np.testing.assert_array_equal(ds.pixel_array, img)
    j_load_dicom(p, show=False)
    assert capsys.readouterr().out == out


@pytest.mark.parametrize("hidden", [(16,), (12, 8)])
def test_adcnnm_exporter_matches_jax_and_round_trips(tmp_path, hidden):
    """The port's state dict equals JAX's `torch_state_dict_from_params`
    on the same weights bit for bit (keys, shapes, values), and
    `save_trained_model` round-trips through the port's loader."""
    jcfg = JCNN.CNNConfig(input_shape=(16, 16, 3), num_classes=2,
                          conv_layers=((4, 3), (6, 3)), hidden_units=hidden,
                          dropout_rate=0.0, conv_padding="SAME")
    jp = jax.tree_util.tree_map(np.asarray, JCNN.init_params(jax.random.key(3), jcfg))
    tcfg = convert.convert_cnn_config(jcfg)
    model = convert.convert_classifier(jp, tcfg)
    got = T.torch_state_dict_from_params(model, tcfg)
    want = JAD.torch_state_dict_from_params(jp, jcfg)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == torch.float32 and got[key].shape == want[key].shape
        assert torch.equal(got[key], want[key].to(torch.float32)), key
    path = str(tmp_path / "adv.pth")
    T.save_trained_model(model, tcfg, path)
    back = TAD.params_from_torch_state_dict(torch.load(path, weights_only=True), tcfg)
    for a, b in zip(back.parameters(), model.parameters()):
        assert torch.equal(a, b)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 16, 3))
                         .astype(np.float32))
    assert torch.equal(TCNN.apply(back, x), TCNN.apply(model, x))
