"""The serving slice as a whole: the same upload bytes go through the JAX
package's front with a JAX engine and through the port's front with the
port's engine, whose weights are the JAX engine's carried across by
`convert.convert_engine_params`, both over a real socket.

For PNG, 16-bit PNG, GIF, uncompressed DICOM and compressed DICOM uploads
(RLE, JPEG lossless SV1, JPEG-LS, JPEG 2000, HTJ2K), the answers agree
to test_torch_serve.py's tolerances:
- the case CSV rows, but for the uuid of the patient id: equal;
- the features: 1e-4;
- the clean PNG's pixels: +-1;
- the probabilities: 2e-5, the predicted class equal;
- the ROI boxes: equal.

The bulk rows are held in test_torch_app_bulk_parity.py.
"""

import io
import os
import threading

import cv2
import numpy as np
import pytest
from PIL import Image

from cadx_tpu.data import dicom as JD
from cadx_tpu.serve.app import make_server as jax_make_server
from cadx_tpu_torch.serve.app import make_server as port_make_server
from test_serve import _get, _mammo_png, _post_multipart, _small_engine
from test_torch_serve import _port_of


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    j = _small_engine()
    servers = [jax_make_server(str(tmp_path_factory.mktemp("jax")), port=0, engine=j),
               port_make_server(str(tmp_path_factory.mktemp("port")), port=0, engine=_port_of(j))]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield [(f"http://127.0.0.1:{s.server_address[1]}", s) for s in servers]
    for srv in servers:
        srv.shutdown()


def _mammo16(seed=0):
    img = cv2.imdecode(np.frombuffer(_mammo_png(seed=seed), np.uint8), cv2.IMREAD_GRAYSCALE)
    return img.astype(np.uint16) * 16 + (np.arange(96)[None, :] % 16).astype(np.uint16)


def _dicom(tmp_path, img, ts):
    path = str(tmp_path / "u.dcm")
    JD.dcmwrite_minimal(path, img, "PDCM", transfer_syntax=ts)
    return open(path, "rb").read()


def _gif():
    buf = io.BytesIO()
    img = cv2.imdecode(np.frombuffer(_mammo_png(seed=3), np.uint8), cv2.IMREAD_GRAYSCALE)
    Image.fromarray(img).save(buf, "GIF")
    return buf.getvalue()


UPLOADS = {
    "png": lambda tmp: ("case.png", _mammo_png(seed=0)),
    "png16": lambda tmp: ("deep.png", cv2.imencode(".png", _mammo16(1))[1].tobytes()),
    "gif": lambda tmp: ("pal.gif", _gif()),
    "dcm": lambda tmp: ("scan.dcm", _dicom(tmp, _mammo16(2), JD.TS_EXPLICIT_LE)),
    "rle": lambda tmp: ("rle.dcm", _dicom(tmp, _mammo16(4), JD.TS_RLE)),
    "sv1": lambda tmp: ("sv1.dcm", _dicom(tmp, _mammo16(5), JD.TS_JPEG_LOSSLESS_SV1)),
    "jls": lambda tmp: ("jls.dcm", _dicom(tmp, _mammo16(6), JD.TS_JPEG_LS)),
    "j2k": lambda tmp: ("j2k.dcm", _dicom(tmp, _mammo16(7), JD.TS_J2K_LOSSLESS)),
    "htj2k": lambda tmp: ("ht.dcm", _dicom(tmp, _mammo16(8), JD.TS_HTJ2K_LOSSLESS)),
}


def _case_row(srv):
    (row,) = srv.app.ws.read_cases()
    out = {}
    for k, v in row.items():
        if k.endswith("_path"):
            v = os.path.relpath(v, srv.app.ws.root)
        elif k == "patient_id":
            v = v.split("_", 1)[1]   # drop the uuid
        out[k] = v
    return out, row


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol)


def _same_rows(rows_j, rows_t):
    assert len(rows_j) == len(rows_t)
    for a, b in zip(rows_j, rows_t):
        assert set(a) == set(b)
        _close(b["prediction_probabilities"], a["prediction_probabilities"], 2e-5)
        for k in a:
            if k not in ("prediction_probabilities", "accuracy", "confidence"):
                assert a[k] == b[k], k


@pytest.mark.parametrize("kind", sorted(UPLOADS))
def test_upload_classify_roi_agree(fronts, tmp_path, kind):
    name, data = UPLOADS[kind](tmp_path)
    rows = []
    for base, srv in fronts:
        status, headers = _post_multipart(base + "/upload-single",
                                          {"body_part1": "Left breast", "modality1": "MG"},
                                          {"image1": (name, data)})
        assert status == 302 and headers.get("Location") == "/diagnosis"
        rows.append(_case_row(srv))
    (row_j, raw_j), (row_t, raw_t) = rows
    assert row_j == row_t
    np.testing.assert_array_equal(np.load(raw_t["preprocessed_file_path"]),
                                  np.load(raw_j["preprocessed_file_path"]))
    _close(np.load(raw_t["segmented_images_file_path"]),
           np.load(raw_j["segmented_images_file_path"]), 1e-4)
    clean_j = cv2.imread(raw_j["clean_image_path"], cv2.IMREAD_UNCHANGED)
    clean_t = cv2.imread(raw_t["clean_image_path"], cv2.IMREAD_UNCHANGED)
    assert clean_t.dtype == clean_j.dtype and clean_t.shape == clean_j.shape
    _close(clean_t, clean_j, 1)
    for pipeline in ("basic", "advanced"):
        (sj, cls_j), (st, cls_t) = (_get(b + f"/classify?pipeline={pipeline}") for b, _ in fronts)
        assert sj == st == 200
        assert cls_j["image_filename"] == cls_t["image_filename"]
        _same_rows(cls_j["classificationData"], cls_t["classificationData"])
        (sj, roi_j), (st, roi_t) = (_get(b + f"/roi?pipeline={pipeline}") for b, _ in fronts)
        assert sj == st == 200
        assert {k: v for k, v in roi_j.items() if k != "classificationData"} == {
            k: v for k, v in roi_t.items() if k != "classificationData"}
        _same_rows(roi_j["classificationData"], roi_t["classificationData"])
    for _, srv in fronts:
        srv.app.ws.wait("gradcam")
