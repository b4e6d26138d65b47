"""Writes the HTTP front's upload fixtures in the formats cv2 reads through
libwebp and libtiff, each beside cv2's gray decode of it as a PNG:

- upload_lossy.webp: cv2's lossy WebP (quality 90) of the 512 x 512
  upload's synthetic image, `synthetic_native_mammogram(512, 512, seed=7,
  dtype=uint8, top=250)`;
- upload_jpeg_ycbcr.tif: the same image tinted (R, 0.9 G, 0.8 B of it), in
  JPEG-compressed strips of 64 rows, YCbCr subsampled 2 x 2 (cv2's JPEG
  encoder, quality 90, the tables moved to the JPEGTables tag and each
  strip's stream abbreviated, as libtiff writes them);
- upload_g4.tif: a CCITT group 4 TIFF (PIL through libtiff) of
  `synthetic_native_mammogram(1024, 832, seed=7, dtype=uint8, top=250)`
  thresholded at 96.

`X.png` beside each is `cv2.imread(X, IMREAD_GRAYSCALE | IMREAD_ANYDEPTH)`.
The card's machine has neither cv2 nor PIL, so chip_smoke.py phase 9 reads
these files and holds the port's decode to the PNGs. Run from the repo
root: `python tests/data/make_upload_fixtures.py`.
"""

import io
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent.parent), str(HERE.parent)]

from cadx_tpu_torch.synthetic import synthetic_native_mammogram  # noqa: E402
from test_torch_upload_formats import jpeg_ycbcr_tiff  # noqa: E402

FLAGS = cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH


def fixtures() -> dict:
    """File name -> bytes."""
    u8 = synthetic_native_mammogram(512, 512, seed=7, dtype=np.uint8, top=250)
    webp = cv2.imencode(".webp", u8, [cv2.IMWRITE_WEBP_QUALITY, 90])[1].tobytes()
    rgb = np.dstack([u8, (u8 * 0.9).astype(np.uint8), (u8 * 0.8).astype(np.uint8)])
    big = synthetic_native_mammogram(1024, 832, seed=7, dtype=np.uint8, top=250)
    buf = io.BytesIO()
    Image.fromarray(big > 96).save(buf, "TIFF", compression="group4")
    return {"upload_lossy.webp": webp, "upload_jpeg_ycbcr.tif": jpeg_ycbcr_tiff(rgb),
            "upload_g4.tif": buf.getvalue()}


def main() -> None:
    for name, data in fixtures().items():
        path = HERE / name
        path.write_bytes(data)
        gray = cv2.imread(str(path), FLAGS)
        assert gray is not None, name
        cv2.imwrite(str(HERE / (name + ".png")), gray)
        print(name, len(data), "bytes;", gray.shape, gray.dtype)


if __name__ == "__main__":
    main()
