"""The TIFF fax codes (`data/ccitt.py`, through `data/tiff.py`) against
`cv2.imread(path, IMREAD_GRAYSCALE | IMREAD_ANYDEPTH)`, the JAX front's
reader, on the same bytes: bit-exact.

The files are PIL's, written through libtiff's own fax encoders:
`tiff_ccitt` (compression 2, Modified Huffman), `group3` (compression 3,
1-D, or 2-D with T4Options bit 0, with fill bits before each EOL with bit
2) and `group4` (compression 4). Rows of widths that are not multiples of
8, all white, all black, random, blocks, runs longer than 2560 (the
extended make-up codes, several to a run), min-is-white and min-is-black,
fill order 2 (libtiff writes and reads each byte's bits reversed), strips
of a few rows; and a 1024 x 832 thresholded mammogram, the size of the
front's fax fixture.
"""

import io
import time

import cv2
import numpy as np
import pytest
from PIL import Image

from cadx_tpu_torch.data import ccitt, imageio, tiff
from cadx_tpu_torch.synthetic import synthetic_native_mammogram

FLAGS = cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH
CODES = {"tiff_ccitt": 2, "group3": 3, "group3 2-D": 3, "group3 2-D fill": 3, "group4": 4}


def _fax(bits: np.ndarray, kind: str, info=None) -> bytes:
    """A 1-bit TIFF of bool pixels, PIL's `kind` encoder through libtiff,
    with the directory entries of `info` ({tag: value})."""
    info = dict(info or {})
    t4 = {"group3 2-D": 1, "group3 2-D fill": 5}.get(kind)
    if t4 is not None:
        info[292] = t4
    buf = io.BytesIO()
    Image.fromarray(bits).save(buf, "TIFF", compression=kind.split()[0], tiffinfo=info)
    return buf.getvalue()


def _same(tmp_path, data: bytes) -> np.ndarray:
    path = str(tmp_path / "f.tif")
    with open(path, "wb") as f:
        f.write(data)
    ref, got = cv2.imread(path, FLAGS), imageio.imread_gray(path)
    assert ref is not None and got is not None
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return ref


def _pattern(rng, name: str) -> np.ndarray:
    return {"random": lambda: rng.random((23, 77)) > 0.5,
            "all white": lambda: np.zeros((9, 13), bool),
            "all black": lambda: np.ones((7, 29), bool),
            "blocks": lambda: np.kron(rng.random((8, 15)) > 0.5, np.ones((3, 7), bool)),
            "sparse": lambda: rng.random((30, 101)) > 0.97,
            "one column": lambda: rng.random((17, 1)) > 0.5,
            "runs past 2560": lambda: np.stack([np.arange(6000) >= k for k in
                                                (0, 1, 2561, 2623, 2624, 5000, 6000)])}[name]()


@pytest.mark.parametrize("kind", list(CODES))
@pytest.mark.parametrize("pattern", ["random", "all white", "all black", "blocks", "sparse",
                                     "one column", "runs past 2560"])
def test_fax_codes(tmp_path, rng, kind, pattern):
    """Each encoder on each pattern, min-is-black as PIL writes it; the
    strip's compression and T4Options are the ones asked for."""
    data = _fax(_pattern(rng, pattern), kind)
    _, tags = tiff._ifd(data)
    assert tags[259] == (CODES[kind],)
    assert tags.get(292, (0,))[0] == {"group3 2-D": 1, "group3 2-D fill": 5}.get(kind, 0)
    ref = _same(tmp_path, data)
    assert set(np.unique(ref)) <= {0, 255}


@pytest.mark.parametrize("kind", list(CODES))
@pytest.mark.parametrize("case", ["min-is-white", "fill order 2", "strips of 5 rows",
                                  "min-is-white, fill order 2, strips"])
def test_fax_layouts(tmp_path, rng, kind, case):
    """Min-is-white (PIL writes the bits inverted, libtiff's RGBA interface
    inverts them back), fill order 2, and several strips, each a fax stream
    of its own: the picture comes back as written."""
    info = {"min-is-white": {262: 0}, "fill order 2": {266: 2}, "strips of 5 rows": {278: 5},
            "min-is-white, fill order 2, strips": {262: 0, 266: 2, 278: 4}}[case]
    bits = rng.random((21, 45)) > 0.6
    data = _fax(bits, kind, info)
    _, tags = tiff._ifd(data)
    assert all(tags[t] == (v,) for t, v in info.items())
    ref = _same(tmp_path, data)
    np.testing.assert_array_equal(ref == 255, bits)


@pytest.mark.parametrize("width", [1, 7, 8, 9, 63, 64, 65, 1728, 2561])
def test_fax_widths(tmp_path, rng, width):
    """Widths around byte and code boundaries, group 4 and 2-D group 3."""
    bits = rng.random((6, width)) > 0.5
    for kind in ("group4", "group3 2-D", "tiff_ccitt"):
        _same(tmp_path, _fax(bits, kind))


def test_fax_mammogram_in_seconds(tmp_path):
    """A 1024 x 832 thresholded synthetic mammogram in group 4 (the front's
    fixture is this shape): exact, well under 10 s here."""
    bits = synthetic_native_mammogram(1024, 832, seed=3, dtype=np.uint8, top=250) > 96
    data = _fax(bits, "group4")
    t0 = time.perf_counter()
    got = tiff.tiff_gray(data)
    assert time.perf_counter() - t0 < 10
    np.testing.assert_array_equal(got, np.where(bits, 255, 0))
    _same(tmp_path, data)


def test_ccitt_decode_rows(rng):
    """`ccitt_decode` gives TIFF's packed 1-bit rows, a 1 for each black
    pixel, for each code; a stream cut short and a bad mode code raise."""
    bits = rng.random((12, 37)) > 0.5
    for kind, comp in CODES.items():
        data = _fax(bits, kind)
        _, tags = tiff._ifd(data)
        (off,), (cnt,) = tags[273], tags[279]
        raw = ccitt.ccitt_decode(data[off:off + cnt], 37, 12, comp, tags.get(292, (0,))[0])
        rows = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(12, -1), axis=1)[:, :37]
        np.testing.assert_array_equal(rows, bits)
        with pytest.raises(ccitt.CcittError):
            ccitt.ccitt_decode(data[off:off + cnt // 3], 37, 12, comp, tags.get(292, (0,))[0])
    with pytest.raises(ccitt.CcittError):
        ccitt.ccitt_decode(b"\x00\x00\x00\x00", 8, 1, 4)
    with pytest.raises(ccitt.CcittError):
        ccitt.ccitt_decode(b"\xff", 8, 1, 5)


@pytest.mark.parametrize("photometric", [0, 1])
def test_fax_strip_under_another_directory(tmp_path, rng, photometric):
    """libtiff's group 4 and 2-D group 3 strips moved into a directory
    written by hand with either photometric: the same bits read as
    min-is-white invert (1 is black), as cv2 gets them."""
    from test_torch_upload_formats import _tiff

    bits = rng.random((19, 50)) > 0.5
    for kind in ("group4", "group3 2-D"):
        data = _fax(bits, kind)
        _, tags = tiff._ifd(data)
        (off,), (cnt,) = tags[273], tags[279]
        extra = {292: (4, [tags[292][0]])} if 292 in tags else {}
        hand = _tiff(bits.astype(np.uint8), bits=1, compression=CODES[kind],
                     photometric=photometric, tags=extra,
                     encoder=lambda block: data[off:off + cnt])
        ref = _same(tmp_path, hand)
        np.testing.assert_array_equal(ref == (0 if photometric == 0 else 255), bits)
