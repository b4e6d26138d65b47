"""Reference-compatible public API (`Classes/` module surface).

Port of `cadx_tpu/compat/classes.py`: drop-in equivalents of the
reference's research-stack classes, backed by the port. A user of the
reference's `Classes/` modules finds the same constructors, methods and
file formats (npz through `checkpoint.py`) here; every compute path runs
the port's models and kernels on `device` (the card unless the caller
passes "cpu", through `device.resolve`). JAX's `jax.random.key(seed)`
becomes a seeded `torch.Generator`, so a seed gives other weights than
JAX's: compare the two on weights carried across by `convert.py`.

Covered (reference file -> here):
- Classes/Preprocessing.py  -> Preprocessing, tiny_unet (+ its stubs
  resize/normalize/augment/split implemented for real)
- Classes/ImageSegmentation.py -> ImageSegmentation
- Classes/CNNModel.py       -> CNNModel, load_weights
- Classes/CrossValidator.py -> CrossValidator (stubs implemented)
- Classes/Model.py          -> Model, ModelEvaluator, ModelPredictor,
  ModelTrainer (abstract surface implemented)
- Classes/ExplainableAI.py  -> ExplainableAI (stub implemented)

Known reference defects stay fixed, as in the JAX package: no
import-time weight loads or stdout hijacking, save_model has no syntax
error, get_training_metrics takes its data explicitly,
ImageSegmentation's 'same' conv returns input-sized output, and
postprocess_segmented_image returns its result. The mesh-sharded
cross-validation waits on the port's `parallel/` slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from cadx_tpu_torch import checkpoint as _ckpt
from cadx_tpu_torch.data import dataset as _dataset
from cadx_tpu_torch.device import resolve
from cadx_tpu_torch.models import cnn as _cnn
from cadx_tpu_torch.models import unet as _unet
from cadx_tpu_torch.ops import pool as _pool
from cadx_tpu_torch.ops.conv import conv2d as _conv2d
from cadx_tpu_torch.ops.resize import resize_linear as _resize_linear
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.train import crossval as _crossval
from cadx_tpu_torch.train import metrics as _metrics
from cadx_tpu_torch.train import optim as _optim
from cadx_tpu_torch.train import step as _step


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Preprocessing (Classes/Preprocessing.py:28-170)
# ---------------------------------------------------------------------------

class Preprocessing:
    """DICOM dataset loader + label encoder (reference Preprocessing).

    Same constructor contract: loads the mapping CSV and extracts
    features immediately. The reference's unimplemented hooks
    (resize/normalize/augment/split) are implemented here; resizing runs
    on `device`.
    """

    def __init__(self, parent_dir: str, log=print, device=None):
        self._log = log
        self.device = resolve(device)
        self.data_set: list[dict] = []
        self.raw_images: list[np.ndarray] = []
        self.raw_classes_str: list[str] = []
        self.raw_classes: list[int] = []
        self.processed_images = None
        self.feature_data = None
        self.augmentation_params = None
        self.normalization_params = None
        self.resize_shape = None
        self.image_modality = None
        self.data_set_size = 0
        self.label_encoder: dict[str, int] | None = None

        self.load_data(parent_dir)
        self.extract_features()

    def load_data(self, mapping_csv_path: str) -> None:
        ds = _dataset.load_mapping_csv(mapping_csv_path, log=self._log)
        self.data_set = ds.records
        self.data_set_size = len(ds.records)
        self._loaded = ds

    def extract_features(self) -> None:
        ds = getattr(self, "_loaded", None)
        if ds is None:
            return
        self.features = list(zip(ds.raw_images, ds.raw_classes_str))
        self.raw_images = ds.raw_images
        self.raw_classes_str = ds.raw_classes_str
        self._log(f"Extracted features from {len(self.features)} DICOM files.")

    def fit_label_encoder(self) -> None:
        self.label_encoder = _dataset.fit_label_encoder(self.raw_classes_str)
        self.raw_classes = [self.label_encoder[c] for c in self.raw_classes_str]
        self._log(f"Label Encoder Mapping: {self.label_encoder}")

    # -- hooks the reference declared but left unimplemented ---------------
    def resize_images(self, images, target_shape):
        self.resize_shape = tuple(target_shape)
        return _dataset.resize_images(images, self.resize_shape, device=self.device)

    def normalize_images(self, images, mode: str = "unit"):
        self.normalization_params = {"mode": mode}
        return _dataset.normalize_images(np.asarray(images), mode)

    def augment_images(self, images, params=None):
        params = params or {}
        self.augmentation_params = params
        labels = np.asarray(params.get("labels", np.zeros(len(images))))
        return _dataset.augment_images(np.asarray(images), labels,
                                       seed=params.get("seed", 0))

    def prepare_for_segmentation(self, images):
        x = np.asarray(images, dtype=np.float32)
        if x.ndim == 3:
            x = x[..., None]
        return x

    def prepare_for_classification(self, images):
        return np.asarray(images, dtype=np.float32)

    def split_train_test(self, images, labels, test_size):
        return _dataset.split_train_test(images, labels, test_size)

    def view_DICOM_image(self, instance) -> None:
        import matplotlib.pyplot as plt

        from cadx_tpu_torch.data import dicom as _dicom

        plt.imshow(_dicom.primary_frame(instance["DICOM"]))
        plt.title(f"DICOM Image : {instance['PatientID']}")
        plt.show()


def tiny_unet(input_shape, device=None):
    """Reference tiny_unet factory (Preprocessing.py:176-204) returning a
    keras-like model object with compile/fit/predict/bottleneck access."""
    return TinyUNetModel(input_shape, device=device)


class TinyUNetModel:
    """Minimal keras-Model-like wrapper over models.unet TinyUNet."""

    def __init__(self, input_shape, seed: int = 0, device=None):
        self.input_shape = tuple(input_shape)
        self.device = resolve(device)
        self.params = _unet.init_tiny_unet(torch.Generator().manual_seed(seed),
                                           in_channels=self.input_shape[-1],
                                           device=self.device)
        self._lr = 1e-3

    def compile(self, optimizer: str = "adam", loss: str = "mse",
                learning_rate: float = 1e-3) -> None:
        if loss != "mse":
            raise ValueError("TinyUNetModel supports the reference's MSE loss")
        self._lr = learning_rate

    def fit(self, x, y=None, epochs: int = 5, batch_size: int = 8,
            verbose: bool = False):
        """Keras-style fit with Adam on the MSE. y defaults to x (the
        reference trains the autoencoder against its input,
        Preprocessing.py:241-245) but an explicit target (e.g. denoising)
        is honored, not ignored. Returns the per-epoch mean losses."""
        x = np.asarray(x, dtype=np.float32)
        y = x if y is None else np.asarray(y, dtype=np.float32)
        if y.shape != x.shape:
            raise ValueError(f"y shape {y.shape} != x shape {x.shape}")
        if len(x) == 0:
            return []
        tx = _optim.Adam(lr=self._lr)
        params = list(self.params.parameters())
        state = tx.init(params)
        history = []
        with full_fp32():
            for epoch in range(epochs):
                losses, weights = [], []
                for i in range(0, len(x), batch_size):
                    xb = torch.from_numpy(x[i:i + batch_size]).to(self.device)
                    yb = torch.from_numpy(y[i:i + batch_size]).to(self.device)
                    with torch.enable_grad():
                        loss = ((_unet.tiny_unet_apply(self.params, xb) - yb) ** 2).mean()
                        grads = torch.autograd.grad(loss, params)
                    state = tx.step(params, grads, state)
                    losses.append(loss.detach())      # device scalars; fetched once an epoch
                    weights.append(float(len(xb)))
                w = torch.tensor(weights, dtype=torch.float32, device=self.device)
                history.append(float(torch.stack(losses) @ w) / max(len(x), 1))
                if verbose:
                    print(f"[tiny_unet] epoch {epoch+1}/{epochs} mse={history[-1]:.5f}")
        return history

    def _batched(self, fn, x, batch_size: int, empty_shape):
        x = np.asarray(x, dtype=np.float32)
        with torch.no_grad(), full_fp32():
            outs = [_np(fn(self.params, torch.from_numpy(x[i:i + batch_size]).to(self.device)))
                    for i in range(0, len(x), batch_size)]
        return np.concatenate(outs) if outs else np.zeros(empty_shape(x), np.float32)

    def predict(self, x, batch_size: int = 32):
        return self._batched(_unet.tiny_unet_apply, x, batch_size,
                             lambda a: (0,) + tuple(a.shape[1:]))

    def bottleneck_features(self, x, batch_size: int = 32):
        """The reference's bottleneck_model.predict (Preprocessing.py:247-248)."""
        return self._batched(_unet.tiny_unet_bottleneck, x, batch_size, lambda a: (0,))


# ---------------------------------------------------------------------------
# ImageSegmentation (Classes/ImageSegmentation.py:33-210)
# ---------------------------------------------------------------------------

def _nchw(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device).permute(0, 3, 1, 2)


def _nhwc_np(t: torch.Tensor) -> np.ndarray:
    return _np(t.permute(0, 2, 3, 1))


class ImageSegmentation:
    """Simulated U-Net encoder on random weights: the reference contract,
    every op one of the port's batched ops (the pools on the card's
    kernels) instead of Python loops. Arrays are NHWC numpy in and out."""

    def __init__(self, seed: int = 0, device=None):
        self.original_image = None
        self.preprocessed_image = None
        self.segmented_mask = None
        self._seed = seed
        self.device = resolve(device)

    def load_image(self, image_data) -> None:
        image_data = np.asarray(image_data)
        if image_data.ndim == 3:
            image_data = np.expand_dims(image_data, axis=0)
        elif image_data.ndim != 4:
            raise ValueError("Invalid image array shape.")
        self.original_image = image_data

    # -- ops (batched NHWC) -------------------------------------------------
    def conv2d(self, input, kernel, padding="same"):
        """SAME-padded conv, kernel HWIO. (The reference's 'same' returned
        a zero-ringed (H+2p, W+2p) array by bug; this returns (H, W).)"""
        pad = "SAME" if padding == "same" else "VALID"
        w = torch.as_tensor(np.asarray(kernel, np.float32)).to(self.device).permute(3, 2, 0, 1)
        with full_fp32():
            return _nhwc_np(_conv2d(_nchw(input, self.device), w, padding=pad))

    def max_pool(self, input):
        return _nhwc_np(_pool.max_pool_ties(_nchw(input, self.device), 2))

    def upsample(self, input):
        x = torch.from_numpy(np.array(input)).to(self.device).permute(0, 3, 1, 2)
        return _nhwc_np(_pool.upsample_nearest(x, 2))

    def average_pool(self, input, pool_size: int = 5):
        return _nhwc_np(_pool.avg_pool(_nchw(input, self.device), pool_size))

    def relu(self, x):
        return np.maximum(0, x)

    def sigmoid(self, x):
        return 1.0 / (1.0 + np.exp(-x))

    def postprocess_segmented_image(self):
        """Downscale to nearest lower power-of-two dims (16..512) — and,
        unlike the reference (which dropped the result,
        ImageSegmentation.py:116-143), store + return it."""
        if self.preprocessed_image is None or np.asarray(self.preprocessed_image).ndim != 4:
            raise ValueError("Expected image with shape (batch, height, width, channels)")
        x = torch.as_tensor(np.asarray(self.preprocessed_image, np.float32)).to(self.device)
        _, h, w, _ = x.shape

        def nearest_power_of_two(v):
            powers = [2 ** i for i in range(4, 10) if 2 ** i <= v]
            return max(powers) if powers else v

        self.preprocessed_image = _np(_resize_linear(x, (nearest_power_of_two(h),
                                                         nearest_power_of_two(w))))
        return self.preprocessed_image

    def encoder_weights(self, c_in: int):
        """The encoder's random weights (HWIO, unit normal), drawn from a
        generator seeded with the instance's seed."""
        g = torch.Generator().manual_seed(self._seed)
        return [torch.randn(shape, generator=g).numpy()
                for shape in ((3, 3, c_in, 16), (3, 3, 16, 32), (3, 3, 32, 64))]

    def encode(self, x, w1, w2, w3):
        """Conv->Pool->Conv->Pool->Bottleneck->AveragePool(3) of NHWC x with
        the HWIO weights w1..w3 (ImageSegmentation.unet, :163-186)."""
        ws = [torch.from_numpy(np.array(w, np.float32)).to(self.device).permute(3, 2, 0, 1)
              for w in (w1, w2, w3)]
        with torch.no_grad(), full_fp32():
            c1 = torch.relu(_conv2d(_nchw(x, self.device), ws[0], padding="SAME"))
            c2 = torch.relu(_conv2d(_pool.max_pool_ties(c1, 2), ws[1], padding="SAME"))
            bn = torch.relu(_conv2d(_pool.max_pool_ties(c2, 2), ws[2], padding="SAME"))
            return _nhwc_np(_pool.avg_pool(bn, 3))

    def unet(self):
        """The encoder on random weights (`encoder_weights`)."""
        x = np.asarray(self.original_image, np.float32)
        self.preprocessed_image = self.encode(x, *self.encoder_weights(x.shape[-1]))
        return self.preprocessed_image

    def display_segmented_image(self, image_segmented) -> None:
        import matplotlib.pyplot as plt

        num_channels = image_segmented.shape[-1]
        cols = 8
        rows = num_channels // cols + (num_channels % cols > 0)
        plt.figure(figsize=(15, rows * 2))
        for i in range(num_channels):
            plt.subplot(rows, cols, i + 1)
            plt.imshow(image_segmented[:, :, i], cmap="gray")
            plt.axis("off")
            plt.title(f"Ch {i + 1}")
        plt.tight_layout()
        plt.show()


# ---------------------------------------------------------------------------
# CNNModel (Classes/CNNModel.py:67-585) + load_weights (:30-60)
# ---------------------------------------------------------------------------

class CNNModel:
    """Reference CNN classifier surface over the port's model; `params` is
    the `models.cnn.CNN` on `device`."""

    def __init__(self, input_shape, num_classes,
                 conv_layers=[(8, 3), (16, 3)], hidden_units=[128, 64],
                 dropout_rate=0.3, leaky_alpha=0.01, seed: int = 0, device=None):
        self.config = _cnn.CNNConfig(
            input_shape=tuple(input_shape),
            num_classes=int(num_classes),
            conv_layers=tuple(tuple(c) for c in conv_layers),
            hidden_units=tuple(hidden_units),
            dropout_rate=float(dropout_rate),
            leaky_alpha=float(leaky_alpha),
        )
        self.device = resolve(device)
        self.params = _cnn.init_params(torch.Generator().manual_seed(seed), self.config,
                                       device=self.device)
        self.epoch_accuracy: list[float] = []
        self.history: list[dict] = []

    # reference-style attribute accessors
    @property
    def input_shape(self):
        return self.config.input_shape

    @property
    def num_classes(self):
        return self.config.num_classes

    @property
    def conv_layers_config(self):
        return [list(c) for c in self.config.conv_layers]

    @property
    def hidden_units(self):
        return list(self.config.hidden_units)

    @property
    def dropout_rate(self):
        return self.config.dropout_rate

    @property
    def leaky_alpha(self):
        return self.config.leaky_alpha

    def forward(self, x, training: bool = True, seed: int = 0):
        """Single-sample forward -> probs (reference forward, :162-198);
        in training, dropout draws from a generator seeded with `seed`."""
        xt = torch.from_numpy(np.asarray(x, np.float32)[None]).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed) if training else None
        with torch.no_grad(), full_fp32():
            logits = _cnn.apply(self.params, xt, training, gen)
        return _np(_cnn.reference_softmax(logits)[0])

    def predict(self, X):
        """Single sample -> (argmax class, probs) (reference :524-526)."""
        probs = self.forward(X, training=False)
        return int(np.argmax(probs)), probs

    def predict_batch(self, X, batch_size: int = 64):
        return _step.predict_classes(self.params, np.asarray(X, np.float32), batch_size)

    def cross_entropy(self, probs, y_true):
        return float(_cnn.cross_entropy(torch.as_tensor(np.asarray(probs, np.float32)),
                                        torch.as_tensor(np.asarray(y_true, np.float32))))

    def train(self, X, y_onehot, X_test, y_test, epochs=10, lr=0.01,
              batch_size=8, optimizer="sgd", log=print):
        """Reference train loop semantics (shuffle/batch/clip/decay/best-
        weights restore), as batched steps on the model's device."""
        y_test = np.asarray(y_test)
        y_test_labels = y_test if y_test.ndim == 1 else np.argmax(y_test, -1)
        res = _step.fit(
            self.params,
            np.asarray(X, np.float32), np.asarray(y_onehot, np.float32),
            np.asarray(X_test, np.float32), y_test_labels,
            epochs=epochs, lr=lr, batch_size=batch_size, optimizer=optimizer,
            log_fn=log, device=self.device,
        )
        self.params = res.model
        self.epoch_accuracy = res.epoch_accuracy
        self.history = res.history
        log(f"[TRAIN] Best accuracy: {res.best_val_acc:.4f}")
        return res

    def get_training_metrics(self, X_test, y_test, log=print) -> float:
        """Accuracy + confusion matrix + per-class report (reference
        :560-585, with its undefined-global bugs fixed)."""
        y_test = np.asarray(y_test)
        y_labels = y_test if y_test.ndim == 1 else np.argmax(y_test, -1)
        y_pred = self.predict_batch(X_test)
        acc = float(np.mean(y_pred == y_labels))
        cm = _metrics.confusion_matrix(y_labels, y_pred, self.config.num_classes).numpy()
        log(f"[Test Accuracy] {acc:.4f}")
        log(f"Confusion Matrix:\n{cm}")
        for cls in range(self.config.num_classes):
            total = int(cm[cls].sum())
            correct = int(cm[cls, cls])
            log(f"Class {cls}: Total={total}, Correct={correct}, Wrong={total-correct}")
        return acc

    def save_model(self, path="trained_model/cnn_model.npz") -> None:
        _ckpt.save_npz(self.params, path)

    def summary(self) -> str:
        lines = [f"CNNModel(input_shape={self.config.input_shape}, "
                 f"num_classes={self.config.num_classes})"]
        for i, (f, k) in enumerate(self.config.conv_layers):
            lines.append(f"  conv{i}: {f} filters, {k}x{k} VALID + LeakyReLU + maxpool2")
        for i, u in enumerate(self.config.hidden_units):
            lines.append(f"  dense{i}: {u} units + LeakyReLU + dropout")
        lines.append(f"  output: {self.config.num_classes} classes (softmax)")
        lines.append(f"  params: {_cnn.num_params(self.params):,}")
        return "\n".join(lines)


def load_weights(cls=CNNModel, path: str = "trained_model/cnn_model.npz", device=None):
    """Reference module-level loader (Classes/CNNModel.py:30-60): rebuild
    the model from the npz's embedded config and inject weights."""
    config, params = _ckpt.load_npz(path, device=resolve(device))
    model = cls(
        input_shape=config.input_shape,
        num_classes=config.num_classes,
        conv_layers=[list(c) for c in config.conv_layers],
        hidden_units=list(config.hidden_units),
        dropout_rate=config.dropout_rate,
        leaky_alpha=config.leaky_alpha,
        device=device,
    )
    model.params = params
    return model


# ---------------------------------------------------------------------------
# CrossValidator (Classes/CrossValidator.py) — stubs implemented
# ---------------------------------------------------------------------------

class CrossValidator:
    def __init__(self, n_splits: int = 5, device=None):
        self.n_splits = n_splits
        self.kfold = _crossval.KFold(n_splits=n_splits)
        self.last_result: _crossval.CrossValResult | None = None
        self.device = resolve(device)

    def split_data(self, data, labels=None):
        data = np.asarray(data)
        return [
            ((data[tr], None if labels is None else np.asarray(labels)[tr]),
             (data[te], None if labels is None else np.asarray(labels)[te]))
            for tr, te in self.kfold.split(len(data))
        ]

    def cross_validate(self, config: _cnn.CNNConfig, X, y_labels, *,
                       epochs=10, lr=0.01, batch_size=8, optimizer="sgd",
                       mesh=None, log=None):
        self.last_result = _crossval.cross_validate(
            config, X, y_labels, n_splits=self.n_splits, epochs=epochs,
            lr=lr, batch_size=batch_size, optimizer=optimizer, mesh=mesh, log_fn=log,
            device=None if mesh is not None else self.device,
        )
        return self.last_result

    def aggregate_metrics(self, result=None):
        result = result or self.last_result
        if result is None:
            raise ValueError("run cross_validate first")
        return result.aggregate_metrics()


# ---------------------------------------------------------------------------
# Model / ModelEvaluator / ModelPredictor / ModelTrainer (Classes/Model.py)
# ---------------------------------------------------------------------------

class Model:
    """Reference abstract Model (load/summary) — implemented."""

    def __init__(self, model_path: str | None = None, device=None):
        self.model_path = model_path
        self.model: CNNModel | None = None
        self.device = device
        if model_path:
            self.load_model(model_path)

    def load_model(self, path: str) -> CNNModel:
        self.model = load_weights(CNNModel, path, device=self.device)
        self.model_path = path
        return self.model

    def summary(self) -> str:
        if self.model is None:
            return "Model(unloaded)"
        return self.model.summary()


class ModelEvaluator:
    def __init__(self, model: CNNModel):
        self.model = model
        self._cache: tuple | None = None  # (X, y, result) by identity

    def evaluate(self, X_test, y_test) -> dict:
        # identity-keyed memo (strong refs keep ids valid): the three
        # reference-style accessors on one test set run inference once
        if (self._cache is not None and self._cache[0] is X_test
                and self._cache[1] is y_test):
            return self._cache[2]
        y_arr = np.asarray(y_test)
        y_labels = y_arr if y_arr.ndim == 1 else np.argmax(y_arr, -1)
        y_pred = self.model.predict_batch(X_test)
        result = _metrics.evaluation_block(y_labels, y_pred, self.model.config.num_classes)
        self._cache = (X_test, y_test, result)
        return result

    def accuracy(self, X_test, y_test) -> float:
        return self.evaluate(X_test, y_test)["test_accuracy"]

    def confusion_matrix(self, X_test, y_test):
        return np.asarray(self.evaluate(X_test, y_test)["confusion_matrix"])

    def classification_report(self, X_test, y_test) -> dict:
        return self.evaluate(X_test, y_test)["classification_report"]


class ModelPredictor:
    def __init__(self, model: CNNModel):
        self.model = model

    def predict(self, X):
        return self.model.predict(X)

    def predict_batch(self, X, batch_size: int = 64):
        return self.model.predict_batch(X, batch_size)


class ModelTrainer:
    def __init__(self, model: CNNModel):
        self.model = model
        self._compiled: dict[str, Any] = {"optimizer": "sgd", "lr": 0.01}

    def compile(self, optimizer: str = "sgd", learning_rate: float = 0.01):
        self._compiled = {"optimizer": optimizer, "lr": learning_rate}

    def train(self, X, y_onehot, X_test, y_test, epochs=10, batch_size=8):
        return self.model.train(X, y_onehot, X_test, y_test, epochs=epochs,
                                lr=self._compiled["lr"], batch_size=batch_size,
                                optimizer=self._compiled["optimizer"])

    def cross_validate(self, X, y_labels, n_splits: int = 5, **kw):
        cv = CrossValidator(n_splits, device=self.model.device)
        return cv.cross_validate(self.model.config, X, y_labels, **kw)

    def save(self, path: str):
        self.model.save_model(path)


# ---------------------------------------------------------------------------
# ExplainableAI (Classes/ExplainableAI.py) — stub implemented
# ---------------------------------------------------------------------------

class ExplainableAI:
    """Reference XAI surface: heatmap generation + overlay + visualize, on
    the port's Grad-CAM and saliency (the conv and pool kernels forward,
    on the model's device) and JET colormap."""

    def __init__(self, model: CNNModel | None = None, colormap: str = "jet"):
        self.model = model
        self.heatmap = None
        self.last_conv_layer = None
        self.colormap = colormap

    def generate_heatmap(self, image, class_idx: int = 0, method: str = "gradcam"):
        from cadx_tpu_torch.xai import gradcam, saliency

        if self.model is None:
            raise ValueError("attach a CNNModel first")
        x = torch.from_numpy(np.asarray(image, np.float32)).to(self.model.device)
        with full_fp32():
            if method == "gradcam":
                self.heatmap = _np(gradcam.gradcam_map(self.model.params, x, class_idx))
            else:
                d = saliency.input_gradient(self.model.params, x, class_idx)
                self.heatmap = _np(saliency.saliency_map_u8(d)) / 255.0
        return self.heatmap

    def overlay_heatmap(self, image, heatmap=None, alpha: float = 0.5):
        """RGB uint8 overlay. Float images in [0,1] (the normalized model
        input this class operates on) are scaled to 0-255 first — a raw
        uint8 truncation would blank the base image entirely."""
        from cadx_tpu_torch.ops.colormap import add_weighted, apply_jet, normalize_to_u8

        hm = torch.as_tensor(np.asarray(heatmap if heatmap is not None else self.heatmap))
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.asarray(img, np.float64)
            if img.size and img.max() <= 1.0 + 1e-6:
                img = img * 255.0
            img = np.clip(img, 0, 255).astype(np.uint8)
        heat = apply_jet(normalize_to_u8(hm)).flip(-1)  # BGR LUT -> RGB for display
        heat = torch.clamp(torch.round(_resize_linear(heat.to(torch.float32)[None],
                                                      img.shape[:2])[0]), 0, 255)
        img3 = torch.from_numpy(img if img.ndim == 3 else np.stack([img] * 3, -1))
        return _np(add_weighted(img3, 1 - alpha, heat.to(torch.uint8), alpha))

    def visualize_prediction(self, image, class_idx: int = 0):
        self.generate_heatmap(image, class_idx)
        display = np.asarray(image)
        if display.ndim == 3:
            display = display.max(axis=-1)
        return self.overlay_heatmap(display)
