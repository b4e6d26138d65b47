"""The port's HTTP front (`cadx_tpu_torch/serve/app.py`) driven over a real
socket: `tests/test_serve.py`'s flows against the port's front and a small
port engine on the CPU (landing and home, the single-image flow, bulk,
error paths, HTML and static, concurrent requests, upload failure
injection, DICOM upload with bulk classify, 16-bit PNG, 16-bit DICOM depth,
every compressed DICOM syntax, the review-fix regressions, the upload
waiting on in-flight jobs), and the entry point's device rule.

The engine's numbers against the JAX front's are in
test_torch_app_parity.py.
"""

import concurrent.futures
import glob
import io
import json
import os
import re
import threading
import time
import urllib.request
import zipfile

import cv2
import numpy as np
import pytest

from cadx_tpu.data import dicom as JD
from cadx_tpu_torch.data import dicom as TD
from cadx_tpu_torch.models.cnn import CNNConfig
from cadx_tpu_torch.serve import app as A
from cadx_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from test_serve import _get, _mammo_png, _post_multipart


def small_engine():
    """test_serve.py's `_small_engine`, seeded in the port on the CPU."""
    return InferenceEngine(EngineConfig(
        segment_hw=(64, 64), feature_resize=(16, 16),
        basic_classifier=CNNConfig(input_shape=(16, 16, 64), num_classes=2,
                                   conv_layers=((8, 3),), hidden_units=(32,),
                                   dropout_rate=0.0),
        advanced_classifier=CNNConfig(input_shape=(32, 32, 64), num_classes=2,
                                      conv_layers=((8, 3),), hidden_units=(32,),
                                      dropout_rate=0.0)), device="cpu")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    ws = tmp_path_factory.mktemp("workspace")
    srv = A.make_server(str(ws), port=0, engine=small_engine())
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    srv.shutdown()


def _upload(base, name, data, fields=None):
    return _post_multipart(base + "/upload-single", fields or {"modality1": "MG"},
                           {"image1": (name, data)})


def _dicom_bytes(tmp_path, img, ts=TD.TS_EXPLICIT_LE, writer=TD):
    path = str(tmp_path / "x.dcm")
    writer.dcmwrite_minimal(path, img, "PDCM", transfer_syntax=ts)
    with open(path, "rb") as f:
        return f.read()


def test_landing_and_home(server):
    base, _ = server
    status, body = _get(base + "/")
    assert status == 200 and body["pipelines"] == ["basic", "advanced"]
    status, body = _get(base + "/home?pipeline=advanced")
    assert body["pipeline"] == "advanced"


def test_full_single_image_flow(server):
    base, srv = server
    status, headers = _upload(base, "case1.png", _mammo_png(),
                              {"body_part1": "Left breast", "modality1": "Mammogram"})
    assert status == 302 and headers.get("Location") == "/diagnosis"
    status, body = _get(base + "/diagnosis")
    assert len(body["cases"]) == 1
    case = body["cases"][0]
    assert case["image_name"] == "case1.png" and case["breast"] == "Left breast"
    pid = case["patient_id"]
    status, body = _get(base + f"/view/{pid}")
    assert body["patient_id"] == pid
    status, body = _get(base + "/view_segmentation")
    assert status == 200 and len(body["masks"]) == 64
    assert body["masks"][0].startswith("case1_mask_")
    status, body = _get(base + "/classify?pipeline=basic")
    assert status == 200
    row = body["classificationData"][0]
    assert row["predicted_class"] in ("Benign", "Malignant")
    assert abs(sum(row["prediction_probabilities"]) - 1.0) < 1e-4
    status, body = _get(base + "/roi?pipeline=basic")
    assert status == 200 and len(body["classificationData"]) == 2
    assert body["class_0_image_path"].endswith("gradcam_overlay_class_0.png")
    coords0 = body["classificationData"][0]["roiCoords"]
    for k in ("top", "left", "width", "height"):
        assert 0.0 <= coords0[k] <= 1.0
    status, ref_body = _get(base + "/roi?pipeline=basic&reference_parity=1")
    assert ref_body["classificationData"][0]["roiCoords"] == {
        "top": 0.20, "left": 0.30, "width": 0.20, "height": 0.175}
    expl = srv.app.ws.folder("explainability")
    for c in (0, 1):
        overlay = cv2.imread(os.path.join(expl, f"gradcam_overlay_class_{c}.png"))
        assert overlay is not None and overlay.shape == (64, 64, 3)
    srv.app.ws.wait("gradcam")   # the artifact job stored no exception
    _upload(base, "case_roi2.png", _mammo_png(seed=7))
    status, body2 = _get(base + "/roi?pipeline=basic")
    assert (body2["classificationData"][0]["roiCoords"] != coords0
            or body2["classificationData"][1]["roiCoords"]
            != body["classificationData"][1]["roiCoords"])
    status, body = _get(base + "/classify?pipeline=advanced")
    assert status == 200


def test_bulk_flow(server):
    base, srv = server
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("imgs/bulk1.png", _mammo_png(seed=1))
        zf.writestr("imgs/bulk2.png", _mammo_png(seed=2))
        zf.writestr("notes.txt", b"ignored")
    status, _ = _post_multipart(base + "/upload-bulk", {},
                                {"bulk_images_zip": ("batch.zip", buf.getvalue())})
    assert status == 302
    status, body = _get(base + "/bulk-select-parameters")
    assert body["images"] == ["bulk1.png", "bulk2.png"]
    status, headers = _post_multipart(
        base + "/upload-bulk-image", {"bulk_image_name": "bulk1.png",
                                      "body_part1": "Right breast", "modality1": "Mammogram"}, {})
    assert status == 302 and headers.get("Location") == "/diagnosis"
    status, body = _get(base + "/diagnosis")
    assert body["cases"][0]["image_name"] == "bulk1.png"
    outside = os.path.join(srv.app.ws.root, "secret.png")
    with open(outside, "wb") as f:
        f.write(_mammo_png(seed=9))
    for evil in ("../secret.png", outside, "a/../../secret.png"):
        assert srv.app.upload_bulk_image(evil).get("error") == "invalid image name", evil
    out = srv.app.upload_bulk_image(".")
    assert "error" in out and "redirect" in out


def test_error_paths(server):
    base, srv = server
    status, body = _get(base + "/view/NOPE")
    assert "error" in body
    status, body = _get(base + "/nonexistent", expect_status=404)
    assert status == 404
    srv.app.ws.clear_folder("segmentation")
    status, body = _get(base + "/classify", expect_status=404)
    assert status == 404 and "No .npy" in body["error"]
    srv.app.ws.clear_folder("bulk")
    status, body = _get(base + "/bulk-classify", expect_status=404)
    assert body["error"] == "no bulk images"


def test_html_rendering_and_static(server):
    base, srv = server
    _upload(base, "case_html.png", _mammo_png(seed=5))

    def get_html(path):
        req = urllib.request.Request(base + path, headers={"Accept": "text/html"})
        with urllib.request.urlopen(req) as r:
            return r.status, r.read().decode(), r.headers.get("Content-Type", "")

    for path, marker in [("/", "Basic Pipeline"), ("/home", "Add New Case"),
                         ("/diagnosis", "Case History"),
                         ("/view_segmentation", "Segmentation Masks"),
                         ("/classify", "Classification Results"),
                         ("/roi", "Regions of Interest"),
                         ("/bulk-select-parameters", "Bulk Diagnosis"),
                         ("/sample", "Example Diagnosis")]:
        status, html_body, ctype = get_html(path)
        assert status == 200 and "text/html" in ctype, path
        assert marker in html_body and "<html" in html_body, path
        assert "Visual-Based Computer-Aided Breast Cancer Diagnosis" in html_body
    status, roi_html, _ = get_html("/roi")
    for control in ("classSelect", "predictionProbability", "originalOpacity",
                    "overlayOpacity", "zoomControl", "updateUIForClass"):
        assert control in roi_html, control
    status, body = _get(base + "/diagnosis")
    assert "cases" in body
    status, html_body, _ = get_html("/view_segmentation")
    m = re.search(r"/static/segmentation_image/([\w.]+\.png)", html_body)
    assert m
    with urllib.request.urlopen(base + m.group(0)) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "image/png"
        assert r.read()[:4] == b"\x89PNG"
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/static/../Uploads/prediction_data.csv")
    assert e.value.code in (403, 404)


def test_concurrent_requests(server):
    base, _ = server
    _upload(base, "conc.png", _mammo_png(seed=9))
    paths = (["/classify?pipeline=basic", "/classify?pipeline=advanced", "/diagnosis",
              "/roi?pipeline=basic", "/view_segmentation"] * 3)
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        results = list(ex.map(lambda p: _get(base + p), paths))
    for (status, body), path in zip(results, paths):
        assert status == 200, (path, body)
    basic = [b for (s, b), p in zip(results, paths) if p == "/classify?pipeline=basic"]
    adv = [b for (s, b), p in zip(results, paths) if p == "/classify?pipeline=advanced"]
    assert all(b == basic[0] for b in basic) and all(a == adv[0] for a in adv)
    assert basic[0] != adv[0]


def test_upload_failure_injection(server):
    base, srv = server
    status, headers = _upload(base, "broken.png", b"this is not an image at all")
    assert status == 302 and headers.get("Location") == "/diagnosis"
    assert srv.app.upload_single(b"this is not an image at all", "b.png") == {
        "error": "Could not read image", "redirect": "/diagnosis"}
    status, _ = _get(base + "/")
    assert status == 200
    status, _ = _post_multipart(base + "/upload-single", {"body_part1": "L"}, {})
    assert status == 302


def test_dicom_upload_and_bulk_classify(server, tmp_path):
    base, srv = server
    img = np.random.default_rng(3).integers(0, 4096, (96, 96), dtype=np.uint16)
    status, headers = _upload(base, "scan.dcm", _dicom_bytes(tmp_path, img))
    assert status == 302 and headers.get("Location") == "/diagnosis"
    status, _ = _get(base + "/classify?pipeline=basic")
    assert status == 200
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for i in range(3):
            zf.writestr(f"b{i}.png", _mammo_png(seed=20 + i))
        zf.writestr("d3.dcm", _dicom_bytes(tmp_path, img, TD.TS_RLE))
    _post_multipart(base + "/upload-bulk", {}, {"bulk_images_zip": ("batch.zip", buf.getvalue())})
    status, body = _get(base + "/bulk-classify?pipeline=basic")
    assert status == 200
    rows = body["classificationData"]
    assert [r["image_name"] for r in rows] == ["b0.png", "b1.png", "b2.png", "d3.dcm"]
    for r in rows:
        assert abs(sum(r["prediction_probabilities"]) - 1.0) < 1e-4


def test_16bit_png_upload(server):
    base, srv = server
    img16 = np.random.default_rng(11).normal(2000, 400, (96, 96)).clip(0, 65535).astype(np.uint16)
    status, _ = _upload(base, "deep.png", cv2.imencode(".png", img16)[1].tobytes())
    assert status == 302
    arr = np.load(glob.glob(str(srv.app.ws.folder("preprocessed")) + "/*.npy")[0])
    assert arr.dtype == np.uint16 and arr.max() > 255
    np.testing.assert_array_equal(arr, img16)
    status, _ = _get(base + "/classify?pipeline=basic")
    assert status == 200


def test_16bit_dicom_upload_preserves_depth(server, tmp_path):
    base, srv = server
    img16 = np.random.default_rng(21).integers(0, 4096, (96, 96), dtype=np.uint16)
    data = _dicom_bytes(tmp_path, img16)
    arr = A._imread_gray(str(tmp_path / "x.dcm"))
    assert arr.dtype == np.uint16
    np.testing.assert_array_equal(arr, img16)
    status, _ = _upload(base, "deep.dcm", data)
    assert status == 302
    stored = np.load(sorted(glob.glob(str(srv.app.ws.folder("preprocessed")) + "/*.npy"))[-1])
    assert stored.dtype == np.uint16 and stored.max() > 255
    status, _ = _get(base + "/classify?pipeline=basic")
    assert status == 200


_COMPRESSED = sorted(TD._ENCAPSULATED_TS - {TD.TS_JPEG_EXTENDED})


@pytest.mark.parametrize("ts", _COMPRESSED)
def test_compressed_dicom_upload(server, tmp_path, ts):
    """Every encapsulated syntax the JAX package decodes is accepted end to
    end, its pixels the ones written (lossless) or the JAX reader's (lossy).
    The port writes all but JPEG 2000 and JPEG baseline, which come from
    the JAX writer (cv2's OpenJPEG and libjpeg)."""
    base, srv = server
    img = np.random.default_rng(22).integers(0, 4096, (96, 96), dtype=np.uint16)
    if ts == TD.TS_JPEG_BASELINE:
        img = (img >> 4).astype(np.uint8)
    writer = JD if ts in (TD.TS_J2K_LOSSLESS, TD.TS_J2K, TD.TS_JPEG_BASELINE) else TD
    data = _dicom_bytes(tmp_path, img, ts, writer)
    status, _ = _upload(base, "compressed.dcm", data)
    assert status == 302
    stored = np.load(glob.glob(str(srv.app.ws.folder("preprocessed")) + "/*.npy")[0])
    np.testing.assert_array_equal(stored, JD.dcmread(data).pixel_array)
    status, _ = _get(base + "/classify?pipeline=basic")
    assert status == 200, ts


def test_review_fixes_regressions(server):
    base, srv = server
    payload = b"\x89PNGdata-ending-in-newlines\r\n\n\r\n"
    body = (b"--BB\r\nContent-Disposition: form-data; name=\"f\"; "
            b"filename=\"x.bin\"\r\n\r\n" + payload + b"\r\n--BB--\r\n")
    assert A._parse_multipart("multipart/form-data; boundary=BB", body)["f"][1] == payload
    req = urllib.request.Request(base + "/home?pipeline=basic%0d%0aSet-Cookie:%20evil%3D1")
    with urllib.request.urlopen(req) as r:
        assert all("evil" not in c for c in (r.headers.get_all("Set-Cookie") or []))
        assert json.loads(r.read())["pipeline"] == "basic"
    status, _ = _upload(base, "evil.html", b"<script>1</script>")
    assert status == 302
    assert not os.path.exists(os.path.join(srv.app.ws.folder("raw"), "evil.html"))
    status, _ = _upload(base, "..", _mammo_png(seed=30))
    assert status == 302
    _upload(base, "ord.png", _mammo_png(seed=31))
    status, body = _get(base + "/view_segmentation")
    idx = [int(m.split("_mask_")[1].split(".")[0]) for m in body["masks"]]
    assert idx == sorted(idx) == list(range(1, 65))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("huge.png", b"\0" * (140 * 1024 * 1024))
    status, _ = _post_multipart(base + "/upload-bulk", {},
                                {"bulk_images_zip": ("bomb.zip", buf.getvalue())})
    assert status == 302 and "huge.png" not in srv.app.bulk_images()
    overlay = os.path.join(srv.app.ws.folder("explainability"), "gradcam_overlay_class_0.png")
    firsts = []
    for seed in (40, 41):
        _upload(base, "same.png", _mammo_png(seed=seed))
        _get(base + "/classify?pipeline=basic")
        srv.app.ws.wait("gradcam")
        firsts.append(open(overlay, "rb").read())
    assert firsts[0] != firsts[1]


def test_upload_waits_for_inflight_artifact_jobs(tmp_path):
    app = A.CADxApp(str(tmp_path), engine=small_engine())
    marker = os.path.join(app.ws.folder("explainability"), "late.png")

    def slow_overlay_job():
        time.sleep(1.0)
        with open(marker, "wb") as f:
            f.write(b"old patient artifact")

    app.ws.submit("gradcam", slow_overlay_job)
    out = app.upload_single(cv2.imencode(".png", np.full((64, 64), 128, np.uint8))[1].tobytes(),
                            "new.png")
    assert "error" not in out
    assert not os.path.exists(marker)


def test_main_serves_on_the_card_or_on_cpu_when_asked(tmp_path, monkeypatch):
    """`python -m cadx_tpu_torch.serve.app` builds its engine on the card;
    without one it raises, and `--device cpu` serves from the CPU (the
    engine's configuration cut to the test's size)."""
    cfg = small_engine().config
    monkeypatch.setattr(A, "InferenceEngine",
                        lambda config=None, device=None: InferenceEngine(cfg, device=device))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A.main(["--workspace", str(tmp_path), "--no-warmup"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A.make_server(str(tmp_path))
    served = []
    monkeypatch.setattr(A.ThreadingHTTPServer, "serve_forever",
                        lambda self: served.append(self.app.engine.device))
    A.main(["--workspace", str(tmp_path), "--port", "0", "--device", "cpu", "--no-warmup"])
    assert [d.type for d in served] == ["cpu"]
