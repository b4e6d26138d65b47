"""The serving slice's bulk path as a whole: one zip of PNG, 16-bit PNG and
RLE DICOM images goes through the JAX package's front with a JAX engine
and through the port's front with the port's engine (the JAX engine's
weights, `convert.convert_engine_params`). /bulk-classify answers the
same rows for both pipelines: names and classes equal, probabilities
within 2e-5. The port resizes each image with `resize_area_cv2`, bit for
bit the JAX front's cv2 INTER_AREA, so the classifier inputs are equal.
"""

import io
import zipfile

import cv2

from cadx_tpu.data import dicom as JD
from test_serve import _get, _mammo_png, _post_multipart
from test_torch_app_parity import _dicom, _mammo16, _same_rows, fronts  # noqa: F401


def test_bulk_rows_agree(fronts, tmp_path):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for i in range(3):
            zf.writestr(f"b{i}.png", _mammo_png(seed=20 + i))
        zf.writestr("b3.dcm", _dicom(tmp_path, _mammo16(23), JD.TS_RLE))
        zf.writestr("b4.png", cv2.imencode(".png", _mammo16(24))[1].tobytes())
    for base, _ in fronts:
        status, _ = _post_multipart(base + "/upload-bulk", {},
                                    {"bulk_images_zip": ("batch.zip", buf.getvalue())})
        assert status == 302
    for pipeline in ("basic", "advanced"):
        (sj, bj), (st, bt) = (_get(b + f"/bulk-classify?pipeline={pipeline}") for b, _ in fronts)
        assert sj == st == 200
        assert [r["image_name"] for r in bt["classificationData"]] == [
            "b0.png", "b1.png", "b2.png", "b3.dcm", "b4.png"]
        _same_rows(bj["classificationData"], bt["classificationData"])
