"""Port parity: the explainability slice against the JAX package on the CPU
— the colormap helpers, the jet_blend and gradcam_tail kernels' plain
versions (what their wrappers run on CPU tensors) against the Pallas
kernels in interpret mode, the reference resnet Grad-CAM, saliency, the
files each entry point writes, and the serving engine built from the
reference deployment's weight artifacts.

Tolerances: the JET table, add_weighted, normalize_to_u8 and jet_blend
exact (the JAX docstring's bit-identity claim); gradcam_tail heat +-1 and
overlay +-2 where the heat agrees (the Pallas kernel's own tolerances
against the XLA tail, tests/test_kernels.py:406-416); the pipeline's tail
bit for bit against its earlier op-for-op form; resnet CAMs 2e-3 and
heatmaps +-2 u8 (tests/test_resnet.py); input gradients 1e-5; saliency
heatmaps and overlays +-1 u8; engine probabilities 2e-5.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu import checkpoint as JCk
from cadx_tpu.compat import adcnnm as JAd
from cadx_tpu.kernels import nn_kernels as nk
from cadx_tpu.kernels.overlay import jet_blend_pallas
from cadx_tpu.models import cnn as JC
from cadx_tpu.models import resnet as JR
from cadx_tpu.ops import colormap as JCol
from cadx_tpu.serve import engine as JE
from cadx_tpu.xai import gradcam as JG
from cadx_tpu.xai import saliency as JS
from cadx_tpu_torch import convert
from cadx_tpu_torch.compat import adcnnm as TAd
from cadx_tpu_torch.kernels import batchnorm as KBN
from cadx_tpu_torch.kernels import gradcam_tail as KGT
from cadx_tpu_torch.kernels import overlay as KOv
from cadx_tpu_torch.models import cnn as TC
from cadx_tpu_torch.models import resnet as TR
from cadx_tpu_torch.ops import colormap as TCol
from cadx_tpu_torch.ops.resize import resize_linear_mxu
from cadx_tpu_torch.pipeline import fused
from cadx_tpu_torch.serve import engine as TE
from cadx_tpu_torch.xai import gradcam as TG
from cadx_tpu_torch.xai import saliency as TS
from test_resnet import _torch_resnet


def _diff(a, b) -> np.ndarray:
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


def _overlay_close(ov, hm, ov_ref, hm_ref, heat_tol):
    """Heatmaps within heat_tol; overlays +-2 where the heatmaps agree."""
    dh = _diff(hm, hm_ref)
    assert dh.max() <= heat_tol, dh.max()
    same = np.broadcast_to((dh == 0)[..., None], np.shape(ov))
    assert _diff(ov, ov_ref)[same].max() <= 2


def _bgr_png(path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


def _rgb_png(path) -> np.ndarray:
    img = _bgr_png(path)
    return img if img.ndim == 2 else img[..., ::-1]


# ---- colormap helpers and the two blend kernels' plain versions --------------

def test_colormap_helpers_match_jax(rng):
    assert np.array_equal(TCol.jet_lut_bgr(), JCol.jet_lut_bgr())
    assert np.array_equal(KOv.jet_lut_rgb(), JCol.jet_lut_bgr()[:, ::-1])
    a = rng.integers(0, 256, (40, 30, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (40, 30, 3)).astype(np.uint8)
    b[:5] = a[:5] + 1                      # x.5 sums: half to even
    for alpha, beta, gamma in ((0.5, 0.5, 0.0), (0.3, 0.9, 7.0), (1.5, 1.0, -3.0)):
        ours = TCol.add_weighted(torch.from_numpy(a), alpha, torch.from_numpy(b), beta, gamma)
        ref = JCol.add_weighted(jnp.asarray(a), alpha, jnp.asarray(b), beta, gamma)
        assert np.array_equal(ours.numpy(), np.asarray(ref))
    for x in (rng.standard_normal((17, 23)).astype(np.float32) * 3,
              np.abs(rng.standard_normal((8, 8, 4))).astype(np.float32) * 1e-3,
              np.zeros((5, 5), np.float32)):
        assert np.array_equal(TCol.normalize_to_u8(torch.from_numpy(x)).numpy(),
                              np.asarray(JCol.normalize_to_u8(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 64, 64), (3, 17, 29)])
def test_jet_blend_plain_matches_pallas(rng, shape):
    heat = rng.integers(0, 256, shape).astype(np.uint8)
    img = rng.random(shape).astype(np.float32)
    img[0] = rng.integers(0, 256, shape[1:]) / np.float32(255)
    pallas = np.asarray(jet_blend_pallas(jnp.asarray(heat), jnp.asarray(img), interpret=True))
    before = KOv.jet_blend.launches
    ours = KOv.jet_blend(torch.from_numpy(heat), torch.from_numpy(img))
    assert KOv.jet_blend.launches == before
    assert np.array_equal(ours.numpy(), pallas)


def test_jet_blend_rgb_matches_jax_overlay_tail(rng):
    """The (H, W, 3) display form: JAX gradcam_overlay's tail, op for op."""
    heat = rng.integers(0, 256, (1, 40, 36)).astype(np.uint8)
    rgb = rng.integers(0, 256, (1, 40, 36, 3)).astype(np.uint8)
    img01 = rgb.astype(np.float32) / np.float32(255)
    ours = KOv.jet_blend(torch.from_numpy(heat), torch.from_numpy(img01))
    jet = JCol.apply_jet(jnp.asarray(heat[0])).astype(jnp.float32) / 255.0
    cam_img = jet[..., ::-1] + jnp.asarray(rgb[0]).astype(jnp.float32) / 255.0
    cam_img = cam_img / jnp.maximum(cam_img.max(), 1e-7)
    assert np.array_equal(ours[0].numpy(), np.asarray((cam_img * 255).astype(jnp.uint8)))


@pytest.mark.parametrize("acts_shape,out_hw", [((2, 6, 6, 64), (64, 64)),
                                               ((2, 8, 8, 4), (32, 32)),
                                               ((1, 5, 7, 8), (40, 56))])
def test_gradcam_tail_plain_matches_pallas(rng, acts_shape, out_hw):
    acts = np.abs(rng.standard_normal(acts_shape)).astype(np.float32)
    grads = rng.standard_normal(acts_shape).astype(np.float32)
    img01 = rng.random((acts_shape[0],) + out_hw).astype(np.float32)
    ov_p, hm_p = nk.gradcam_tail_pallas(jnp.asarray(acts), jnp.asarray(grads),
                                        jnp.asarray(img01), out_hw, interpret=True)
    before = KGT.gradcam_tail.launches
    ov, hm = KGT.gradcam_tail(torch.from_numpy(acts), torch.from_numpy(grads),
                              torch.from_numpy(img01), out_hw)
    assert KGT.gradcam_tail.launches == before
    assert ov.shape == (acts_shape[0],) + out_hw + (3,) and ov.dtype == torch.uint8
    _overlay_close(ov.numpy(), hm.numpy(), ov_p, hm_p, heat_tol=1)


def test_pipeline_tail_is_the_earlier_tail_bit_for_bit(rng):
    """On the CPU the pipeline's tail is the plain version, the earlier
    op-for-op tail: channel-last views of channel-first activations."""
    acts = torch.from_numpy(np.abs(rng.standard_normal((3, 64, 6, 6))).astype(np.float32))
    acts = acts.permute(0, 2, 3, 1)
    grads = torch.from_numpy(rng.standard_normal((3, 6, 6, 64)).astype(np.float32))
    clean01 = torch.from_numpy(rng.integers(0, 256, (3, 48, 48)).astype(np.float32)) / 255.0
    ov, hm = fused._gradcam_tail(acts, grads, clean01, fused.PipelineConfig(image_hw=(48, 48)))
    cam_big = resize_linear_mxu(TG.cam_from_acts_grads(acts, grads), (48, 48))
    heat_u8 = (torch.clamp(cam_big, 0.0, 1.0) * 255).to(torch.uint8)
    jet_rgb = (TCol.apply_jet(heat_u8).to(torch.float32) / 255.0).flip(-1)
    over = jet_rgb + clean01[..., None]
    over = over / torch.clamp_min(over.amax(dim=(1, 2, 3), keepdim=True), 1e-7)
    assert torch.equal(hm, heat_u8)
    assert torch.equal(ov, (over * 255).to(torch.uint8))


# ---- the reference resnet Grad-CAM ---------------------------------------------

@pytest.fixture(scope="module")
def resnet_pair():
    net = _torch_resnet(torch, "bottleneck", layers=(1, 1, 1, 1), widths=(8, 16, 16, 32),
                        num_classes=5, seed=3)
    jcfg, jparams = JR.params_from_state_dict(net.state_dict())
    _, model = TR.params_from_state_dict(net.state_dict())
    return jcfg, jparams, model


def test_resnet_gradcam_map_and_overlay_match_jax(resnet_pair):
    jcfg, jparams, model = resnet_pair
    img = np.random.default_rng(2).integers(0, 256, (96, 96)).astype(np.uint8)
    x = TG.imagenet_input_from_gray(torch.from_numpy(img))
    jx = JG.imagenet_input_from_gray(jnp.asarray(img))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    cams = TG.resnet_gradcam_cams(model, x, (0, 1))
    for class_idx in (0, 1):
        ref = np.asarray(JG.resnet_gradcam_map(jparams, jx, class_idx, jcfg))
        np.testing.assert_allclose(TG.resnet_gradcam_map(model, x, class_idx).numpy(), ref,
                                   rtol=0, atol=2e-3)
        np.testing.assert_array_equal(cams[class_idx].numpy(),
                                      TG.resnet_gradcam_map(model, x, class_idx).numpy())
        ov, hm = TG.resnet_gradcam_overlay(model, torch.from_numpy(img), class_idx, (96, 96))
        ov_j, hm_j = JG.resnet_gradcam_overlay(jparams, jnp.asarray(img), class_idx, jcfg,
                                               (96, 96))
        _overlay_close(ov.numpy(), hm.numpy(), ov_j, hm_j, heat_tol=2)


def test_reference_gradcam_files(resnet_pair, tmp_path):
    jcfg, jparams, model = resnet_pair
    img = np.random.default_rng(3).integers(0, 256, (64, 80)).astype(np.uint8)
    before = KBN.batchnorm.launches, KOv.jet_blend.launches
    ours = TG.generate_reference_gradcam_overlays(model, img, (0, 1), str(tmp_path / "t"))
    assert (KBN.batchnorm.launches, KOv.jet_blend.launches) == before   # CPU: plain
    ref = JG.generate_reference_gradcam_overlays(jparams, jcfg, img, (0, 1),
                                                 str(tmp_path / "j"))
    for c in (0, 1):
        ov, hm = ours[c]
        assert ov.shape == (64, 80, 3) and hm.shape == (64, 80) and ov.dtype == np.uint8
        for kind, arr in (("overlay", ov), ("heatmap", hm)):
            name = f"gradcam_{kind}_class_{c}.png"
            assert np.array_equal(_rgb_png(tmp_path / "t" / name), arr)
            assert os.path.exists(tmp_path / "j" / name)
        _overlay_close(ov, hm, _rgb_png(tmp_path / "j" / f"gradcam_overlay_class_{c}.png"),
                       _bgr_png(tmp_path / "j" / f"gradcam_heatmap_class_{c}.png"), 2)
    assert ours[0][0].max() == 255       # show_cam_on_image: u8(255 (jet + img) / max)


# ---- the classifier Grad-CAM with an RGB display, and saliency ------------------

def _classifier(seed, input_shape, padding="VALID"):
    cfg = JC.CNNConfig(input_shape=input_shape, num_classes=2, conv_layers=((6, 3), (8, 3)),
                       hidden_units=(16,), dropout_rate=0.0, conv_padding=padding)
    params = JC.init_params(jax.random.key(seed), cfg)
    model = convert.convert_classifier(jax.tree_util.tree_map(np.asarray, params),
                                       convert.convert_cnn_config(cfg))
    return cfg, params, model


def test_gradcam_overlay_rgb_display_matches_jax(rng):
    cfg, params, model = _classifier(0, (16, 16, 8))
    x = rng.standard_normal((16, 16, 8)).astype(np.float32)
    disp = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)
    for c in (0, 1):
        ov, hm = TG.gradcam_overlay(model, torch.from_numpy(x), torch.from_numpy(disp), c,
                                    (40, 48))
        ov_j, hm_j = JG.gradcam_overlay(params, jnp.asarray(x), jnp.asarray(disp), c, cfg,
                                        (40, 48))
        _overlay_close(ov.numpy(), hm.numpy(), ov_j, hm_j, heat_tol=2)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_input_gradient_and_saliency_match_jax(rng, padding):
    cfg, params, model = _classifier(1, (20, 20, 6), padding)
    x = rng.standard_normal((20, 20, 6)).astype(np.float32)
    for c in (0, 1):
        g = TS.input_gradient(model, torch.from_numpy(x), c)
        gj = np.asarray(JS.input_gradient(params, jnp.asarray(x), c, cfg))
        np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                                   atol=1e-5 * max(float(np.abs(gj).max()), 1.0))
        assert _diff(TS.saliency_map_u8(g).numpy(), JS.saliency_map_u8(jnp.asarray(gj))).max() <= 1
        for disp in (rng.integers(0, 256, (50, 44)).astype(np.uint8),
                     rng.integers(0, 256, (50, 44, 3)).astype(np.uint8)):
            ov, hm = TS.saliency_overlay(model, torch.from_numpy(x), torch.from_numpy(disp), c,
                                         (50, 44))
            ov_j, hm_j = JS.saliency_overlay(params, jnp.asarray(x), jnp.asarray(disp), c,
                                             cfg, (50, 44))
            assert _diff(hm.numpy(), hm_j).max() <= 1
            assert _diff(ov.numpy(), ov_j).max() <= 1


def test_saliency_files(rng, tmp_path):
    cfg, params, model = _classifier(2, (16, 16, 4))
    x = rng.standard_normal((16, 16, 4)).astype(np.float32)
    disp = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    ours = TS.generate_dual_class_overlays(model, x, disp, (0, 1), str(tmp_path / "t"))
    ref = JS.generate_dual_class_overlays(params, cfg, x, disp, (0, 1), str(tmp_path / "j"))
    for c in (0, 1):
        for i, kind in enumerate(("overlay", "heatmap")):
            name = f"{kind}_class_{c}.png"
            got = _bgr_png(tmp_path / "t" / name)      # BGR arrays, as cv2 reads them
            assert np.array_equal(got, ours[c][i])
            assert _diff(got, _bgr_png(tmp_path / "j" / name)).max() <= 1
            assert _diff(ours[c][i], ref[c][i]).max() <= 1


# ---- the slice as a whole: engines built from the same artifact files ----------

def _engine_configs():
    basic = dict(input_shape=(16, 16, 64), num_classes=2, conv_layers=((8, 3),),
                 hidden_units=(32,), dropout_rate=0.0)
    advanced = dict(input_shape=(32, 32, 64), num_classes=2, conv_layers=((8, 3),),
                    hidden_units=(32,), dropout_rate=0.0)
    j = JE.EngineConfig(segment_hw=(64, 64), feature_resize=(16, 16),
                        basic_classifier=JC.CNNConfig(**basic),
                        advanced_classifier=JC.CNNConfig(**advanced))
    t = TE.EngineConfig(segment_hw=(64, 64), feature_resize=(16, 16),
                        basic_classifier=TC.CNNConfig(**basic),
                        advanced_classifier=TC.CNNConfig(**advanced))
    return j, t


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Seeded weight files in the reference deployment's formats."""
    d = tmp_path_factory.mktemp("artifacts")
    enc = _torch_resnet(torch, "basic", layers=(1, 1, 1, 1), widths=(8, 8, 8, 8),
                        in_channels=1, seed=5)
    r50 = _torch_resnet(torch, "bottleneck", layers=(1, 1, 1, 1), widths=(8, 8, 16, 16),
                        num_classes=4, seed=6)
    paths = {k: str(d / n) for k, n in (("encoder", "enc.pth"), ("gradcam", "r50.pth"),
                                        ("basic", "cnn_model.npz"),
                                        ("summary", "training_summary_advanced.json"),
                                        ("advanced", "best_model.pth"))}
    torch.save({f"encoder.{k}": v for k, v in enc.state_dict().items()}, paths["encoder"])
    torch.save(r50.state_dict(), paths["gradcam"])
    jcfg, _ = _engine_configs()
    basic = jcfg.basic_classifier
    JCk.save_npz(JC.init_params(jax.random.key(7), basic), basic, paths["basic"])
    adv = JAd.advanced_config_from_summary({
        "dataset": {"input_shape": [32, 32, 64], "num_classes": 2},
        "model": {"conv_layers": [[8, 3]], "hidden_units": [32], "dropout_rate": 0.0}})
    with open(paths["summary"], "w") as f:
        json.dump({"dataset": {"input_shape": [32, 32, 64], "num_classes": 2},
                   "model": {"conv_layers": [[8, 3]], "hidden_units": [32],
                             "dropout_rate": 0.0}}, f)
    JAd.save_trained_model(JC.init_params(jax.random.key(8), adv), adv, paths["advanced"])
    return paths


def _engine_kwargs(paths):
    return dict(basic_npz=paths["basic"], advanced_summary_json=paths["summary"],
                advanced_pth=paths["advanced"], encoder_pth=paths["encoder"],
                gradcam_pth=paths["gradcam"])


def test_engines_from_the_same_artifacts_agree(artifacts, tmp_path):
    jcfg, tcfg = _engine_configs()
    jeng = JE.InferenceEngine(jcfg, **_engine_kwargs(artifacts))
    teng = TE.InferenceEngine(tcfg, device="cpu", **_engine_kwargs(artifacts))
    assert teng.config.advanced_classifier.conv_padding == "SAME"
    assert teng.gradcam_resnet[0].num_classes == 4
    img = np.random.default_rng(4).integers(0, 256, (128, 128)).astype(np.uint8)
    fj, cj = jeng.process_single_image(img)
    ft, ct = teng.process_single_image(img)
    assert np.array_equal(cj, ct)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)
    for pipeline in ("basic", "advanced"):
        pj = jeng.classify(fj, pipeline)["prediction_probabilities"]
        pt = teng.classify(fj, pipeline)["prediction_probabilities"]
        np.testing.assert_allclose(pt, pj, rtol=0, atol=2e-5)
    out_t = teng.write_gradcam_overlays(fj, cj, str(tmp_path / "t"), (0, 1))
    out_j = jeng.write_gradcam_overlays(fj, cj, str(tmp_path / "j"), (0, 1))
    for c in (0, 1):
        _overlay_close(*out_t[c], *out_j[c], heat_tol=2)
        for kind, arr in zip(("overlay", "heatmap"), out_t[c]):
            assert np.array_equal(_rgb_png(tmp_path / "t" / f"gradcam_{kind}_class_{c}.png"),
                                  arr)
    teng.warmup()


def test_engine_artifact_rules(artifacts):
    _, tcfg = _engine_configs()
    with pytest.raises(ValueError, match="fc"):
        TE.InferenceEngine(tcfg, device="cpu", gradcam_pth=artifacts["encoder"])
    # missing files keep the seeded weights
    seeded = TE.InferenceEngine(tcfg, seed=3, device="cpu")
    missing = TE.InferenceEngine(tcfg, seed=3, device="cpu", basic_npz="/nonexistent.npz",
                                 gradcam_pth="/nonexistent.pth", encoder_pth="",
                                 advanced_summary_json=artifacts["summary"],
                                 advanced_pth="/nonexistent.pth")
    assert missing.gradcam_resnet is None
    for a, b in ((seeded.basic_params, missing.basic_params),
                 (seeded.advanced_params, missing.advanced_params),
                 (seeded.encoder_params, missing.encoder_params)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)
    # the loaders by themselves
    cfg, model = TAd.load_trained_model(artifacts["summary"], artifacts["advanced"])
    jc, jp = JAd.load_trained_model(artifacts["summary"], artifacts["advanced"])
    assert cfg.conv_padding == jc.conv_padding == "SAME"
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 64)).astype(np.float32)
    np.testing.assert_allclose(TC.forward(model, torch.from_numpy(x)).detach().numpy(),
                               np.asarray(JC.forward(jp, jnp.asarray(x), jc)), rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="3x3"):
        TAd.advanced_config_from_summary({
            "dataset": {"input_shape": [8, 8, 2], "num_classes": 2},
            "model": {"conv_layers": [[4, 5]], "hidden_units": [4], "dropout_rate": 0.0}})
