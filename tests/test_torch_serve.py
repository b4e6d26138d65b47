"""Port parity: the serving slice (ROI, Grad-CAM artifacts, the engine and
its micro-batcher) against the JAX package, and the unchanged JAX HTTP
front serving the port's engine.

Engines are built with the small configurations of `test_serve.py` and
`test_serve_fullres.py`; the port's weights are the JAX engine's,
converted by `convert.convert_engine_params`. Tolerances:
- ROI boxes, predicted class: exact;
- probabilities: 2e-5;
- overlay and heatmap PNGs: +-2 u8 (read back with cv2);
- features and the clean image after a non-integer INTER_AREA resize:
  1e-4 and 1 u8, the resize's summation order being the port's (it is
  held to 1e-4 of JAX on a [0, 255] scale, and the clean image rounds it).
"""

import concurrent.futures
import io
import os
import threading
import zipfile

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.models.cnn import CNNConfig
from cadx_tpu.serve import engine as JE
from cadx_tpu.serve.app import make_server
from cadx_tpu.xai import gradcam as JG
from cadx_tpu.xai import roi as JRoi
from cadx_tpu_torch.convert import convert_cnn_config, convert_classifier, convert_engine_params
from cadx_tpu_torch.serve import engine as TE
from cadx_tpu_torch.synthetic import synthetic_native_mammogram
from cadx_tpu_torch.xai import gradcam as TG
from cadx_tpu_torch.xai import png
from cadx_tpu_torch.xai import roi as TRoi
from test_serve import _get, _mammo_png, _post_multipart, _small_engine


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_of(jax_engine) -> TE.InferenceEngine:
    cfg, state = convert_engine_params(
        _numpy(jax_engine.encoder_params), _numpy(jax_engine.basic_params),
        _numpy(jax_engine.advanced_params), jax_engine.config)
    return TE.InferenceEngine(cfg, state=state, device="cpu")


def _fullres_jax_engine():
    """test_serve_fullres.py's engine: segment 128, cap 256."""
    return JE.InferenceEngine(JE.EngineConfig(
        segment_hw=(128, 128), feature_resize=(8, 8), native_clean_max_side=256,
        basic_classifier=CNNConfig(input_shape=(8, 8, 64), num_classes=2,
                                   conv_layers=((4, 3),), hidden_units=(8,),
                                   dropout_rate=0.0)))


@pytest.fixture(scope="module")
def engines():
    j = _small_engine()
    return j, _port_of(j)


@pytest.fixture(scope="module")
def upload():
    return cv2.imdecode(np.frombuffer(_mammo_png(), np.uint8), cv2.IMREAD_UNCHANGED)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol)


# ---- pure pieces --------------------------------------------------------------

def test_bucket_clean_hw_and_defaults():
    for h, w in [(4096, 3328), (3328, 2560), (2560, 3328), (4000, 4000),
                 (10000, 500), (2000, 1700), (5000, 900), (2080, 1696)]:
        for cap in (256, 1536):
            assert TE.bucket_clean_hw(h, w, cap) == JE.bucket_clean_hw(h, w, cap)
    ours, ref = TE.EngineConfig(), JE.EngineConfig()
    assert (ours.segment_hw, ours.feature_resize, ours.native_clean_max_side) == (
        ref.segment_hw, ref.feature_resize, ref.native_clean_max_side)
    assert ours.basic_classifier == convert_cnn_config(ref.basic_classifier)
    assert ours.advanced_classifier == convert_cnn_config(ref.advanced_classifier)
    assert TE.CLASS_MAP == JE.CLASS_MAP


def _cams(rng, n, h, w):
    cams = rng.random((n, h, w)).astype(np.float32)
    cams[0] = 0.0                                   # an all-zero CAM
    cams[1] = 0.0
    cams[1, 1:3, 1:3] = 1.0                         # two equal hot blobs
    cams[1, -3:-1, -3:-1] = 1.0
    return cams


@pytest.mark.parametrize("hw", [(6, 6), (62, 62)])
def test_roi_from_cam_exact(rng, hw):
    cams = _cams(rng, 5, *hw)
    ours = TRoi.roi_from_cam(torch.from_numpy(cams)).numpy()
    for i, cam in enumerate(cams):
        ref = np.array([float(v) for v in JRoi.roi_from_cam(jnp.asarray(cam))], np.float32)
        np.testing.assert_array_equal(ours[i], ref)
        assert TRoi.roi_coords_dict(torch.from_numpy(cam)) == JRoi.roi_coords_dict(cam)


@pytest.mark.parametrize("img", [np.arange(35, dtype=np.uint8).reshape(5, 7),
                                 np.arange(105, dtype=np.uint8).reshape(5, 7, 3)])
def test_png_round_trip(tmp_path, img):
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back if img.ndim == 2 else back[..., ::-1], img)


@pytest.mark.parametrize("pipeline", ["basic", "advanced"])
def test_overlay_pngs_match(engines, rng, tmp_path, pipeline):
    j, _ = engines
    cfg = j.config.basic_classifier if pipeline == "basic" else j.config.advanced_classifier
    params = j.basic_params if pipeline == "basic" else j.advanced_params
    model = convert_classifier(_numpy(params), convert_cnn_config(cfg))
    feats = rng.random(cfg.input_shape).astype(np.float32)
    display = rng.integers(0, 256, (48, 40)).astype(np.uint8)
    JG.generate_dual_class_gradcam_overlays(params, cfg, feats, display, (0, 1),
                                            str(tmp_path / "jax"))
    out = TG.generate_dual_class_gradcam_overlays(model, feats, display, (0, 1),
                                                  str(tmp_path / "port"))
    for c in (0, 1):
        for kind in ("overlay", "heatmap"):
            name = f"gradcam_{kind}_class_{c}.png"
            a = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED)
            assert a.shape == b.shape
            _close(a, b, 2)
        assert out[c][0].shape == (48, 40, 3)


# ---- the engine against the JAX engine ----------------------------------------

def test_engine_single_image_requests(engines, upload):
    j, t = engines
    fj, cj = j.process_single_image(upload, cache_token="u")
    ft, ct = t.process_single_image(upload, cache_token="u")
    assert ft.shape == fj.shape == (64, 32, 32) and ct.dtype == np.uint8
    _close(ft, fj, 1e-4)
    _close(ct, cj, 1)
    for pipeline in ("basic", "advanced"):
        for token in ("u", None):
            rj, coords_j = j.classify_and_roi(fj, pipeline, cache_token=token)
            before = (t.dispatch_count, t.fetch_count)
            rt, coords_t = t.classify_and_roi(fj, pipeline, cache_token=token)
            assert (t.dispatch_count, t.fetch_count) == (before[0] + 1, before[1] + 1)
            _close(rt["prediction_probabilities"], rj["prediction_probabilities"], 2e-5)
            assert rt["predicted_class"] == rj["predicted_class"]
            assert rt["roiCoords"] == rj["roiCoords"] and coords_t == coords_j
            assert set(rt) == set(rj)
        assert t.roi_coords_per_class(fj, pipeline) == coords_t
        assert t.classify(fj, pipeline)["roiCoords"] == rt["roiCoords"]
    _close(t.process_bottleneck_features(fj), j.process_bottleneck_features(fj), 1e-6)


@pytest.mark.parametrize("pipeline", ["basic", "advanced"])
def test_classify_and_roi_raises_when_the_cam_roi_tail_fails(engines, upload, monkeypatch,
                                                             pipeline):
    """A failing fused CAM/ROI tail: the port raises and answers nothing,
    for classify_and_roi and the calls built on it. The JAX engine, under
    the same injected failure, answers a plain forward with the reference's
    fixed box; the port departs from it on purpose (a fallback would hide a
    failed kernel on the card)."""
    j, t = engines
    fj, _ = j.process_single_image(upload)

    def failing_tail(*args, **kwargs):
        raise RuntimeError("injected CAM/ROI tail failure")

    monkeypatch.setattr(TE, "_fused_request", failing_tail)
    before = t.fetch_count
    for call in (lambda: t.classify_and_roi(fj, pipeline), lambda: t.classify(fj, pipeline),
                 lambda: t.roi_coords_per_class(fj, pipeline)):
        with pytest.raises(RuntimeError, match="injected CAM/ROI tail failure"):
            call()
    assert t.fetch_count == before

    fixed = {"top": 0.20, "left": 0.30, "width": 0.40, "height": 0.35}
    healthy, _ = j.classify_and_roi(fj, pipeline)
    monkeypatch.setattr(JE, "_fused_request", failing_tail)
    rj, coords_j = j.classify_and_roi(fj, pipeline)
    assert rj["roiCoords"] == fixed and coords_j == [fixed, fixed]
    assert rj["predicted_class"] == healthy["predicted_class"]
    _close(rj["prediction_probabilities"], healthy["prediction_probabilities"], 1e-5)


def test_engine_bucketed_uint16_upload():
    """A 2080x1696 uint16 native is area-downscaled to the 256 bucket, then
    cleaned and classified. The downscale agrees with JAX's within 1e-4 on
    a [0, 255] scale; the few of its values that land on the other side of
    an integer after the uint8 rescale move a handful of clean pixels (a
    JAX-downscaled input cleans bit-exact)."""
    j = _fullres_jax_engine()
    t = _port_of(j)
    img = synthetic_native_mammogram(2080, 1696, seed=0)
    down_j = np.array(j._downscale_jit(jnp.asarray(img), (256, 256)))
    down_t = TE.resize_area(torch.from_numpy(img.astype(np.float32))[None], (256, 256))[0]
    _close(down_t.numpy(), down_j, 1e-4 * float(down_j.max()) / 255.0)
    fj, cj = (np.asarray(a) for a in j._segment_jit(jnp.asarray(down_j)))
    ft, ct = (a.numpy() for a in t._segment(torch.from_numpy(down_j)))
    np.testing.assert_array_equal(ct, cj)
    _close(ft, fj, 1e-5)

    fj, cj = j.process_single_image(img, cache_token="big")
    ft, ct = t.process_single_image(img, cache_token="big")
    assert ft.shape == (64, 64, 64) and ct.shape == (128, 128)
    assert (ct > 0).mean() > 0.1
    assert (ct != cj).mean() < 1e-3
    rj = j.classify(fj, "basic", cache_token="big")
    rt = t.classify(fj, "basic")
    _close(rt["prediction_probabilities"], rj["prediction_probabilities"], 2e-5)
    assert rt["roiCoords"] == rj["roiCoords"]
    # a cache hit serves the port's own features, as the same features do
    assert t.classify(ft, "basic", cache_token="big") == t.classify(ft, "basic")


def test_feature_cache_lru(engines, upload):
    _, t = engines
    feats, _ = t.process_single_image(upload, cache_token="p")
    t.finalize_feature_token("p", ("path", 1.0))
    assert t._cached_device_features(feats, "p") is None
    assert t._cached_device_features(feats, ("path", 1.0)) is not None
    dev = t._cached_device_features(feats, ("path", 1.0))
    for i in range(t._FEATS_CACHE_SLOTS):
        t._feats_cache_put(("other", i), dev)
    assert t._cached_device_features(feats, ("path", 1.0)) is None   # evicted
    assert t._cached_device_features(feats[:, :2], ("other", 0)) is None  # shape


@pytest.mark.parametrize("pipeline", ["basic", "advanced"])
def test_micro_batcher_matches_and_batches(engines, upload, rng, pipeline):
    j, t = engines
    feats = [t.process_single_image(upload)[0] + rng.normal(0, 0.05, (64, 32, 32)).astype(np.float32)
             for _ in range(2)] * 3
    jb, tb = j.dynamic_batcher(pipeline), t.dynamic_batcher(pipeline)
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as ex:
        ours = list(ex.map(tb.classify, feats))
    assert t.dynamic_batcher(pipeline) is tb
    assert tb.n_flushes < tb.n_samples
    for f, row in zip(feats, ours):
        ref = jb.classify(f)
        _close(row["prediction_probabilities"], ref["prediction_probabilities"], 2e-5)
        assert row["roiCoords"] == ref["roiCoords"]
        assert row["predicted_class"] == ref["predicted_class"]


def test_micro_batcher_isolation_and_close(engines, upload):
    _, t = engines
    from cadx_tpu_torch.serve.batcher import MicroBatcher

    mb = MicroBatcher(t, "basic", max_batch=4, max_wait_ms=50.0)
    good = t.process_single_image(upload)[0]
    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as ex:
        futs = [ex.submit(mb.classify, x) for x in (good, np.zeros((5, 5)), good)]
    assert futs[0].result()["predicted_class"] in ("Benign", "Malignant")
    assert futs[2].result() == futs[0].result()
    with pytest.raises(ValueError):
        futs[1].result()
    mb.close()
    with pytest.raises(RuntimeError):
        mb.classify(good)


@pytest.mark.parametrize("pipeline", ["basic", "advanced"])
def test_classify_batch_matches(engines, upload, pipeline):
    j, t = engines
    imgs = np.stack([cv2.resize(upload, (64, 64), interpolation=cv2.INTER_AREA),
                     cv2.resize(upload[::-1], (64, 64), interpolation=cv2.INTER_AREA)])
    rows_j, rows_t = j.classify_batch(imgs, pipeline), t.classify_batch(imgs, pipeline)
    for a, b in zip(rows_j, rows_t):
        assert set(a) == set(b) and a["sample"] == b["sample"]
        _close(b["prediction_probabilities"], a["prediction_probabilities"], 2e-5)
        assert a["predicted_class"] == b["predicted_class"]


def test_warmup_and_overlays(engines, upload, tmp_path):
    j, t = engines
    t.warmup(native_shapes=[(80, 72)])
    fj, cj = j.process_single_image(upload)
    for pipeline in ("basic", "advanced"):
        j.write_gradcam_overlays(fj, cj, str(tmp_path / "j" / pipeline), pipeline=pipeline)
        t.write_gradcam_overlays(fj, cj, str(tmp_path / "t" / pipeline), pipeline=pipeline)
        for name in sorted(os.listdir(tmp_path / "j" / pipeline)):
            a = cv2.imread(str(tmp_path / "j" / pipeline / name), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(tmp_path / "t" / pipeline / name), cv2.IMREAD_UNCHANGED)
            _close(a, b, 2)


def test_full_fp32_is_safe_across_threads():
    """The engine's threads enter and leave full_fp32 concurrently: TF32
    must stay off for every thread inside, and the last one out restores
    the settings."""
    import sys

    from cadx_tpu_torch.precision import full_fp32

    def flags():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    before, seen_on = flags(), []

    def worker():
        for _ in range(300):
            with full_fp32():
                if any(flags()):
                    seen_on.append(flags())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not seen_on
    assert flags() == before


# ---- the unchanged JAX HTTP front, serving the port's engine --------------------

@pytest.fixture(scope="module")
def server(tmp_path_factory, engines):
    ws = tmp_path_factory.mktemp("workspace")
    srv = make_server(str(ws), port=0, engine=engines[1])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    srv.shutdown()


def test_http_single_image_flow(server):
    base, srv = server
    status, headers = _post_multipart(
        base + "/upload-single", {"body_part1": "Left breast", "modality1": "Mammogram"},
        {"image1": ("case1.png", _mammo_png())})
    assert status == 302 and headers.get("Location") == "/diagnosis"
    status, body = _get(base + "/view_segmentation")
    assert status == 200 and len(body["masks"]) == 64
    for pipeline in ("basic", "advanced"):
        status, body = _get(base + f"/classify?pipeline={pipeline}")
        assert status == 200
        row = body["classificationData"][0]
        assert abs(sum(row["prediction_probabilities"]) - 1.0) < 1e-4
    status, body = _get(base + "/roi?pipeline=basic")
    assert status == 200 and len(body["classificationData"]) == 2
    for k in ("top", "left", "width", "height"):
        assert 0.0 <= body["classificationData"][0]["roiCoords"][k] <= 1.0
    expl = srv.app.ws.folder("explainability")
    for c in (0, 1):
        with open(os.path.join(expl, f"gradcam_overlay_class_{c}.png"), "rb") as f:
            assert f.read(4) == b"\x89PNG"


def test_http_bulk_flow(server):
    base, _ = server
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for i in range(3):
            zf.writestr(f"b{i}.png", _mammo_png(seed=20 + i))
    status, _ = _post_multipart(base + "/upload-bulk", {},
                                {"bulk_images_zip": ("batch.zip", buf.getvalue())})
    assert status == 302
    status, body = _get(base + "/bulk-classify?pipeline=basic")
    assert status == 200
    rows = body["classificationData"]
    assert {r["image_name"] for r in rows} == {"b0.png", "b1.png", "b2.png"}
    for r in rows:
        assert abs(sum(r["prediction_probabilities"]) - 1.0) < 1e-4
    status, headers = _post_multipart(
        base + "/upload-bulk-image", {"bulk_image_name": "b1.png", "body_part1": "R",
                                      "modality1": "MG"}, {})
    assert status == 302 and headers.get("Location") == "/diagnosis"
