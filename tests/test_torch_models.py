"""Port parity: parameter conversion, encoder conv1, the CNN and the CAM core.

JAX weights from `init_pipeline_params(jax.random.key(0), ...)` go
through `cadx_tpu_torch.convert`; the same numpy inputs then run through
both packages. Tolerances: conv1 features 1e-5, probabilities 2e-5 (the
JAX forward tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.models import cnn as JCNN
from cadx_tpu.models import unet as JU
from cadx_tpu.ops import conv as JConv
from cadx_tpu.pipeline import fused as JF
from cadx_tpu.xai import gradcam as JG
from cadx_tpu_torch import convert
from cadx_tpu_torch.models import cnn as TCNN
from cadx_tpu_torch.models import unet as TU
from cadx_tpu_torch.ops import conv as TConv
from cadx_tpu_torch.xai import gradcam as TG


@pytest.fixture(scope="module")
def params():
    cfg = JF.PipelineConfig(image_hw=(64, 64))
    jp = jax.tree_util.tree_map(np.asarray,
                                JF.init_pipeline_params(jax.random.key(0), cfg))
    from cadx_tpu_torch.pipeline.fused import PipelineConfig
    return jp, convert.convert_pipeline_params(jp, PipelineConfig(image_hw=(64, 64)))


def test_convert_layouts(params):
    jp, tp = params
    np.testing.assert_array_equal(tp.encoder.conv1.detach().numpy(),
                                  jp.encoder["conv1"]["kernel"].transpose(3, 2, 0, 1))
    assert tuple(tp.encoder.conv1.shape) == (64, 1, 7, 7)
    # the rest of the encoder is carried untouched
    np.testing.assert_array_equal(
        tp.encoder.rest["stages"][1][0]["downsample"]["kernel"].numpy(),
        jp.encoder["stages"][1][0]["downsample"]["kernel"])
    clf = tp.classifier
    for w, layer in zip(clf.conv_w, jp.classifier["conv"]):
        np.testing.assert_array_equal(w.detach().numpy(),
                                      layer["kernel"].transpose(3, 2, 0, 1))
    for w, layer in zip(clf.dense_w, jp.classifier["dense"]):
        np.testing.assert_array_equal(w.detach().numpy(), layer["kernel"])
    np.testing.assert_array_equal(clf.out_w.detach().numpy(),
                                  jp.classifier["output"]["kernel"])


def test_encoder_first_features(params, rng):
    jp, tp = params
    img = rng.random((2, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(JU.encoder_first_features(jp.encoder, jnp.asarray(img)))
    with torch.no_grad():
        ours = TU.encoder_first_features(tp.encoder, torch.from_numpy(img)).numpy()
    assert ours.shape == (2, 32, 32, 64)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_conv2d_leaky(rng, padding):
    x = rng.standard_normal((2, 9, 11, 4)).astype(np.float32)
    k = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    pad = padding if padding == "VALID" else 1
    ref = np.asarray(JConv.conv2d_leaky(jnp.asarray(x), jnp.asarray(k),
                                        jnp.asarray(b), padding=pad))
    out = TConv.leaky_relu(TConv.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), convert.hwio_to_oihw(k),
        torch.from_numpy(b), padding=padding))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)
    zero = TConv.leaky_relu(torch.tensor([0.0, -2.0, 3.0]))
    np.testing.assert_array_equal(
        zero.numpy(), np.array([0.0, -0.02, 3.0], np.float32))


def _cnn_pair(padding, seed=1):
    cfg = JCNN.CNNConfig(input_shape=(16, 16, 8), num_classes=3,
                         conv_layers=((12, 3), (10, 3)), hidden_units=(32, 16),
                         conv_padding=padding)
    jparams = jax.tree_util.tree_map(
        np.asarray, JCNN.init_params(jax.random.key(seed), cfg))
    tcfg = TCNN.CNNConfig(**{f: getattr(cfg, f) for f in
                             ("input_shape", "num_classes", "conv_layers",
                              "hidden_units", "leaky_alpha", "conv_padding")})
    return cfg, jparams, convert.convert_classifier(jparams, tcfg)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_cnn_forward_probs(rng, padding):
    cfg, jparams, model = _cnn_pair(padding)
    x = rng.standard_normal((4, 16, 16, 8)).astype(np.float32)
    ref_cls, ref = JCNN.predict(jparams, jnp.asarray(x), cfg)
    with torch.no_grad():
        cls, probs = TCNN.predict(model, torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(ref_cls))


def test_full_width_classifier_probs(params, rng):
    jp, tp = params
    cfg = JF.PipelineConfig().classifier
    x = rng.random((2, 32, 32, 64)).astype(np.float32)
    ref = np.asarray(JCNN.forward(jp.classifier, jnp.asarray(x), cfg))
    with torch.no_grad():
        ours = tp.classifier(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)


def test_reference_softmax_guards():
    z = torch.tensor([[1000.0, -1000.0], [0.0, 0.0]])
    ref = np.asarray(JCNN.reference_softmax(jnp.asarray(z.numpy())))
    np.testing.assert_allclose(TCNN.reference_softmax(z).numpy(), ref, atol=1e-7)


def test_init_params_distributions():
    cfg = TCNN.CNNConfig(input_shape=(32, 32, 64), num_classes=2,
                         conv_layers=((128, 3), (64, 3)), hidden_units=(256, 128))
    model = TCNN.init_params(torch.Generator().manual_seed(0), cfg)
    w0 = model.conv_w[0].detach()
    assert tuple(w0.shape) == (128, 64, 3, 3)
    assert abs(float(w0.std()) - (2.0 / (9 * 64)) ** 0.5) < 2e-3
    limit = (6.0 / (cfg.flatten_size() + 256)) ** 0.5
    d0 = model.dense_w[0].detach()
    assert tuple(d0.shape) == (cfg.flatten_size(), 256)
    assert float(d0.abs().max()) <= limit and float(d0.abs().max()) > 0.99 * limit
    again = TCNN.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again.dense_w[1], model.dense_w[1])


def test_cam_from_acts_grads(rng):
    acts = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)
    grads = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)
    ref = np.asarray(JG.cam_from_acts_grads(jnp.asarray(acts), jnp.asarray(grads)))
    ours = TG.cam_from_acts_grads(torch.from_numpy(acts), torch.from_numpy(grads))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)


def test_gradcam_gradient_through_head(rng):
    cfg, jparams, model = _cnn_pair("VALID", seed=2)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    acts = JG.conv_features(jparams, jnp.asarray(x), cfg)
    _, vjp_fn = jax.vjp(lambda f: JG.head_logits(jparams, f, cfg), acts)
    (ref,) = vjp_fn(jnp.zeros((2, 3)).at[:, 1].set(1.0))
    with torch.no_grad():
        tacts = TG.conv_features(model, torch.from_numpy(x))
    tacts.requires_grad_(True)
    logits = TG.head_logits(model, tacts)
    seed = torch.zeros_like(logits)
    seed[:, 1] = 1.0
    (grads,) = torch.autograd.grad(logits, tacts, grad_outputs=seed)
    np.testing.assert_allclose(tacts.detach().numpy(), np.asarray(acts), atol=1e-5)
    np.testing.assert_allclose(grads.numpy(), np.asarray(ref), atol=1e-6)
