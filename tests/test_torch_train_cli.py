"""The port's training CLI (`cadx_tpu_torch/tools/train.py`) on the CPU:
mapping CSV in, the reference artifacts out, on `tests/test_train_cli.py`'s
dataset; the encoder-features path against JAX's `build_features`."""

import csv
import json
import os

import jax
import numpy as np
import pytest

from cadx_tpu.compat import CNNModel, load_weights
from cadx_tpu.models import unet as JU
from cadx_tpu.tools import train as JT
from cadx_tpu_torch import convert
from cadx_tpu_torch.data import dicom
from cadx_tpu_torch.tools import train as TT
from cadx_tpu_torch.train import summary


def _make_dataset(tmp_path, rng, n=24):
    """tests/test_train_cli.py's task: 48x48 uint16 noise, a bright square
    for class 1."""
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


SMALL = ["--conv-layers", "4x3", "--hidden-units", "16", "--dropout", "0.0",
         "--device", "cpu"]


def test_train_cli_raw_artifacts(tmp_path, rng):
    cp = _make_dataset(tmp_path, rng)
    out = str(tmp_path / "out")
    s = TT.main(["--csv", cp, "--out-dir", out, "--pipeline", "basic", "--features", "raw",
                 "--resize", "24", "--epochs", "4", "--lr", "0.05", "--batch-size", "8"]
                + SMALL)
    for name in ("cnn_model_basic.npz", "train_state.pkl", "training_History_basic.json",
                 "training_summary_basic.json"):
        assert os.path.exists(os.path.join(out, name)), name
    hist = summary.load_history(os.path.join(out, "training_History_basic.json"))
    assert len(hist) == 4 and set(hist[0]) == {"epoch", "loss", "val_acc"}
    loaded = summary.load_summary(os.path.join(out, "training_summary_basic.json"))
    assert list(loaded) == ["dataset", "model", "training", "evaluation",
                            "label_encoder", "Training Time"]
    assert loaded["label_encoder"] == {"BENIGN": 0, "MALIGNANT": 1}
    assert loaded["training"]["device"] == "cpu" == s["training"]["device"]
    assert loaded["dataset"]["input_shape"] == [24, 24, 1]
    # the bright-square task is easy: the model must learn it
    assert loaded["evaluation"]["test_accuracy"] >= 0.8
    # the npz loads through the JAX package's compat loader
    m = load_weights(CNNModel, os.path.join(out, "cnn_model_basic.npz"))
    assert m.config.conv_layers == ((4, 3),)


def test_train_cli_kfold(tmp_path, rng):
    cp = _make_dataset(tmp_path, rng, n=16)
    out = str(tmp_path / "outcv")
    agg = TT.main(["--csv", cp, "--out-dir", out, "--kfolds", "2", "--epochs", "2",
                   "--features", "raw", "--resize", "24", "--lr", "0.05",
                   "--batch-size", "8"] + SMALL)
    assert agg["n_splits"] == 2 and len(agg["fold_accuracies"]) == 2
    with open(os.path.join(out, "crossval_summary.json")) as f:
        assert json.load(f) == agg


def test_build_features_encoder_matches_jax(tmp_path, rng):
    cp = _make_dataset(tmp_path, rng, n=3)
    images, labels, encoder = TT.load_images(cp)
    ref_images, ref_labels, _ = JT.load_images(cp)
    np.testing.assert_array_equal(labels, ref_labels)
    ref = JT.build_features(ref_images, "encoder", (24, 24), (16, 16))
    stem = convert.convert_encoder(JU.init_resnet_encoder(jax.random.key(0)))
    ours = TT.build_features(images, "encoder", (24, 24), (16, 16), encoder=stem,
                             device="cpu")
    assert ours.shape == ref.shape == (3, 16, 16, 64) and ours.dtype == np.float32
    # conv1 over the cleaned 512² image and a bilinear resize, float32
    # sums in another order than XLA's
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_train_cli_encoder_features(tmp_path, rng):
    cp = _make_dataset(tmp_path, rng, n=8)
    out = str(tmp_path / "enc")
    s = TT.main(["--csv", cp, "--out-dir", out, "--pipeline", "advanced",
                 "--features", "encoder", "--feature-size", "8", "--epochs", "1",
                 "--batch-size", "4"] + SMALL)
    assert s["dataset"]["input_shape"] == [8, 8, 64]
    assert os.path.exists(os.path.join(out, "cnn_model_advanced.npz"))


# --bf16-compute trains since the bf16 slice (tests/test_torch_bf16.py::
# test_train_cli_bf16_compute); --data-parallel waits on parallel/
@pytest.mark.parametrize("flag,where", [("--data-parallel", r"Queue 1 item 4\)")])
def test_unported_flags_raise(tmp_path, flag, where):
    with pytest.raises(SystemExit, match=where):
        TT.main(["--csv", str(tmp_path / "none.csv"), "--out-dir", str(tmp_path / "o"),
                 flag] + SMALL)
    assert not os.path.exists(tmp_path / "o")
