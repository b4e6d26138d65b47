"""The upload reader's formats against `cv2.imread(path, IMREAD_GRAYSCALE |
IMREAD_ANYDEPTH)`, the JAX front's reader, on the inputs where the two
used to differ.

- JPEG (`data/jpg.py::jpeg_luma_decode`): progressive (spectral selection
  and successive approximation, restart intervals) in gray and YCbCr at
  the chroma subsamplings PIL and cv2 write, within +-2 codes (the bound
  of a float IDCT; the upload path now runs libjpeg-turbo's integer one
  and meets it with 0); a 3328 x 2560 frame under 10 s; Adobe RGB (APP14
  transform 0), CMYK and YCCK: the colour to gray formulas exact on
  images of flat 8 x 8 blocks, +-2 codes end to end.
- PNG: 16-bit colour with gAMA/sRGB (libpng's 16-bit gamma tables, with
  sBIT's shift), eXIf orientations 1-8 wherever the chunk sits, APNG
  (the IDAT image), all exact.
- GIF: the first frame off the screen's origin, on the background colour,
  with a transparent index; cv2's refusals (a background index past the
  global table, a frame outside the screen). Exact.
- BMP (every depth, OS/2 and V4/V5 headers, top-down, BITFIELDS, RLE8 and
  RLE4 streams from a seeded generator) and PBM/PGM/PPM (ASCII and
  binary, 8 and 16 bits), read whatever the extension. Exact, None where
  cv2 gives None.
- `resize_area_cv2` zooming a uint8 axis, cv2's fixed point, exact.
- TIFF (`data/tiff.py`; files written here by hand: strips and tiles,
  planar 1 and 2, little- and big-endian, none/LZW/Deflate/PackBits,
  predictor 2, 1/4/8/16-bit, palette, min-is-white, alpha, float and
  integer samples, orientations), lossless WebP (`data/webp.py`; cv2's
  encodes, which use the predictor, colour and colour-indexing
  transforms), JPEG 2000 (JP2 boxes and raw codestreams), lossless JPEG
  (SOF3), PAM, Sun raster, Radiance HDR and PFM: the port against cv2 on
  the same bytes, exact but for JP2's irreversible streams (the DICOM J2K
  tests' tolerance) and HDR (1e-6 relative: the order of the float32 sums
  of the gray), None where cv2 gives None.
- A float32 upload (HDR, PFM, float TIFF) through both engines: the same
  features and clean image.
- JPEG inside TIFF (PIL's libtiff files, gray, RGB and YCbCr; hand-made
  YCbCr ones of cv2's streams subsampled 2x2, 2x1 and 1x2, strips and
  tiles, with and without JPEGTables; libtiff's refusals), RGB TIFF at
  10-14 bits, fill order 2 under every compression, and RGB, CMYK and
  YCCK JPEGs with subsampled components: exact, libjpeg's integer IDCT
  and upsampling being the port's now. The fax codes and lossy WebP have
  files of their own (test_torch_ccitt.py, test_torch_vp8.py).
- The front's fixtures in these formats (tests/data/upload_*), each the
  PNG of cv2's decode committed beside it.
- The formats left open: AVIF; cv2 reads it, the port gives None (ROADMAP
  Queue 3). The four once open read as cv2 reads them.
"""

import io
import math
import struct
import time
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from cadx_tpu_torch.data import codecs, imageio, jpg
from cadx_tpu_torch.ops.resize import resize_area_cv2
from cadx_tpu_torch.synthetic import synthetic_native_mammogram

FLAGS = cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH


def _read_both(tmp_path, name, data: bytes):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return cv2.imread(path, FLAGS), imageio.imread_gray(path)


def _same(tmp_path, name, data: bytes, atol: int = 0):
    """cv2 and the port give the same image (within atol), or both None."""
    ref, got = _read_both(tmp_path, name, data)
    if ref is None:
        assert got is None, name
        return
    assert got is not None, name
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= atol, name


def _scene(rng, h=67, w=93):
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((xx * 3 + yy * 2) % 256).astype(np.uint8)
    noise = rng.integers(0, 256, (h, w)).astype(np.uint8)
    nat = (smooth * 0.8 + noise * 0.2).astype(np.uint8)
    return nat, np.dstack([nat, smooth, 255 - nat])


# ---- JPEG --------------------------------------------------------------------

def _pil_jpeg(arr, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("q", [95, 75, 30])
@pytest.mark.parametrize("kind", ["cv2 gray", "cv2 ycc", "cv2 ycc restart 3", "cv2 gray restart 1",
                                  "pil 4:4:4", "pil 4:2:2", "pil 4:2:0", "pil gray"])
def test_progressive_jpeg_within_two_codes(tmp_path, rng, kind, q):
    gray, rgb = _scene(rng)
    flags = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if kind.startswith("cv2"):
        if "restart" in kind:
            flags += [cv2.IMWRITE_JPEG_RST_INTERVAL, int(kind[-1])]
        data = cv2.imencode(".jpg", gray if "gray" in kind else rgb, flags)[1].tobytes()
    elif kind == "pil gray":
        data = _pil_jpeg(gray, quality=q, progressive=True)
    else:
        sub = {"pil 4:4:4": 0, "pil 4:2:2": 1, "pil 4:2:0": 2}[kind]
        data = _pil_jpeg(rgb, quality=q, subsampling=sub, progressive=True)
    assert data[:2] == b"\xff\xd8" and b"\xff\xc2" in data
    assert ("restart" not in kind) or b"\xff\xdd" in data
    _same(tmp_path, "p.jpg", data, atol=2)


@pytest.mark.parametrize("hw", [(1, 1), (8, 8), (13, 9), (17, 33), (64, 48)])
def test_progressive_jpeg_sizes(tmp_path, rng, hw):
    _, rgb = _scene(rng, *hw)
    data = cv2.imencode(".jpg", np.ascontiguousarray(rgb), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
    _same(tmp_path, "s.jpg", data.tobytes(), atol=2)


def test_progressive_jpeg_full_frame_in_seconds(tmp_path):
    """A 3328 x 2560 u8 mammogram-like frame (the synthetic native image,
    detector blur of sigma 1.2 px: 0.7 MB at quality 90), progressive:
    the decoder is linear in the file, well under 10 s here."""
    img = cv2.GaussianBlur(synthetic_native_mammogram(3328, 2560, seed=1, dtype=np.uint8,
                                                      top=250), (0, 0), 1.2)
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                      cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    t0 = time.perf_counter()
    got = jpg.jpeg_luma_decode(data)[0]
    seconds = time.perf_counter() - t0
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    assert got.shape == (3328, 2560)
    assert np.abs(got.astype(np.int64) - ref).max() <= 2
    assert seconds < 10.0, seconds


def test_progressive_upload_fixture(tmp_path):
    """tests/data/upload_progressive.jpg, the progressive upload of
    chip_smoke.py's phase 9 (cv2's encode, quality 75 and its full
    progression of six scans, of `synthetic_native_mammogram(512, 512,
    seed=7, dtype=uint8, top=250)`), reads within +-2 codes of cv2."""
    from pathlib import Path

    data = (Path(__file__).parent / "data" / "upload_progressive.jpg").read_bytes()
    assert b"\xff\xc2" in data and data.count(b"\xff\xda") == 6
    ref, got = _read_both(tmp_path, "f.jpg", data)
    assert got.shape == (512, 512)
    assert np.abs(got.astype(np.int64) - ref).max() <= 2
    src = synthetic_native_mammogram(512, 512, seed=7, dtype=np.uint8, top=250)
    assert np.abs(got.astype(np.int64) - src).mean() < 4


def _flat_blocks(rng, channels, blocks=(32, 32)):
    """An image of flat 8 x 8 blocks: every block's IDCT is its DC alone,
    which libjpeg's integer IDCT and the port's float one give exactly."""
    v = rng.integers(0, 256, blocks + (channels,)).astype(np.uint8)
    return np.kron(v, np.ones((8, 8, 1), np.uint8))


def _with_adobe_transform(data: bytes, transform: int) -> bytes:
    at = data.index(b"Adobe")
    assert data[at - 4:at - 2] == b"\xff\xee"
    return data[:at + 11] + bytes([transform]) + data[at + 12:]


@pytest.mark.parametrize("space", ["rgb", "cmyk", "ycck"])
@pytest.mark.parametrize("progressive", [False, True])
def test_adobe_colour_spaces_exact_on_flat_blocks(tmp_path, rng, space, progressive):
    """libjpeg-turbo's rgb_gray_convert, its ycck_cmyk_convert and cv2's
    icvCvt_CMYK2Gray_8u_C4C1R, exact on the same decoded samples: PIL
    writes Adobe RGB (keep_rgb) and Adobe CMYK (transform 0), and the
    CMYK file with its transform set to 2 reads as YCCK."""
    for seed in range(3):
        img = _flat_blocks(np.random.default_rng(seed), 3 if space == "rgb" else 4)
        mode = "RGB" if space == "rgb" else "CMYK"
        kw = dict(quality=100, subsampling=0, progressive=progressive)
        data = _pil_jpeg(img, mode, keep_rgb=True, **kw) if space == "rgb" else _pil_jpeg(
            img, mode, **kw)
        if space == "ycck":
            data = _with_adobe_transform(data, 2)
        ref, got = _read_both(tmp_path, "a.jpg", data)
        assert ref is not None and got is not None
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("space", ["rgb", "cmyk", "ycck"])
def test_adobe_colour_spaces_within_two_codes(tmp_path, rng, space):
    gray, rgb = _scene(rng)
    for q in (90, 50):
        if space == "rgb":
            data = _pil_jpeg(rgb, quality=q, keep_rgb=True)
        else:
            cmyk = np.dstack([rgb, gray[::-1]])
            data = _pil_jpeg(cmyk, "CMYK", quality=q)
            if space == "ycck":
                data = _with_adobe_transform(data, 2)
        _same(tmp_path, "c.jpg", data, atol=2)


def test_jpeg_colour_space_rule():
    """libjpeg's guess: JFIF means YCbCr; else Adobe's transform; else the
    component ids ('R', 'G', 'B' means RGB); four components are CMYK
    unless Adobe says YCCK."""
    def frame(ids):
        seg = struct.pack(">BHHB", 8, 8, 8, len(ids)) + b"".join(
            bytes([i, 0x11, 0]) for i in ids)
        return jpg._Frame(seg, False, {})
    assert jpg._colour_space(frame([1]), False, None) == "gray"
    assert jpg._colour_space(frame([1, 2, 3]), False, None) == "ycc"
    assert jpg._colour_space(frame([82, 71, 66]), False, None) == "rgb"
    assert jpg._colour_space(frame([82, 71, 66]), True, 0) == "ycc"
    assert jpg._colour_space(frame([1, 2, 3]), False, 0) == "rgb"
    assert jpg._colour_space(frame([1, 2, 3, 4]), False, None) == "cmyk"
    assert jpg._colour_space(frame([1, 2, 3, 4]), False, 2) == "ycck"


# ---- PNG ---------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _png16(samples: np.ndarray, ctype: int, early: bytes = b"") -> bytes:
    h, w, n = samples.shape
    rows = samples.astype(">u2").reshape(h, w * n).view(np.uint8)
    raw = b"".join(b"\x00" + r.tobytes() for r in rows)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, ctype, 0, 0, 0))
            + early + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("sbit", [None, 16, 12, 10, 8, 5])
@pytest.mark.parametrize("gamma", [45455, 30000, 97000, 220000, "sRGB"])
@pytest.mark.parametrize("ctype", [2, 6])
def test_png_16bit_colour_gamma(tmp_path, rng, ctype, gamma, sbit):
    """png_do_rgb_to_gray at 16 bits with libpng's gamma_16 tables, which
    take the insignificant bits of sBIT as their shift; a gray pixel (r ==
    g == b) through the file-to-screen table. Exact."""
    n = 3 if ctype == 2 else 4
    samples = rng.integers(0, 65536, (21, 26, n))
    samples[0] = samples[0, :, :1]
    early = (_chunk(b"sRGB", b"\x00") if gamma == "sRGB"
             else _chunk(b"gAMA", struct.pack(">I", gamma)))
    if sbit:
        early += _chunk(b"sBIT", bytes([sbit] * n))
    _same(tmp_path, "g16.png", _png16(samples, ctype, early))


def _exif_block(orientation: int, big_endian: bool) -> bytes:
    bo = ">" if big_endian else "<"
    return ((b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(bo + "I", 8)
            + struct.pack(bo + "H", 1) + struct.pack(bo + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(bo + "I", 0))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation(tmp_path, rng, orientation):
    """cv2 turns a PNG by its eXIf orientation as it turns a JPEG: PIL's
    chunk before IDAT, and the same block big-endian after IDAT."""
    img = rng.integers(0, 256, (20, 31)).astype(np.uint8)
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG", exif=exif.tobytes())
    _same(tmp_path, "o.png", buf.getvalue())
    plain = io.BytesIO()
    Image.fromarray(img).save(plain, "PNG")
    data = plain.getvalue()
    end = data.index(b"IEND") - 4
    late = data[:end] + _chunk(b"eXIf", _exif_block(orientation, True)) + data[end:]
    ref, got = _read_both(tmp_path, "late.png", late)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == ((31, 20) if orientation >= 5 else (20, 31))


def test_png_exif_not_a_tiff_block(tmp_path, rng):
    """An eXIf chunk that does not start with a TIFF header ("Exif\\0\\0"
    first, as JPEG's APP1 has it) is dropped: orientation 1."""
    img = rng.integers(0, 256, (20, 31)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    data = buf.getvalue()
    bad = _chunk(b"eXIf", b"Exif\x00\x00" + _exif_block(6, True))
    ref, got = _read_both(tmp_path, "x.png", data[:33] + bad + data[33:])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("default_image", [False, True])
def test_apng_reads_its_idat_image(tmp_path, rng, default_image):
    img = rng.integers(0, 256, (20, 31)).astype(np.uint8)
    frames = [Image.fromarray(img), Image.fromarray(255 - img), Image.fromarray(img[::-1].copy())]
    buf = io.BytesIO()
    frames[0].save(buf, "PNG", save_all=True, append_images=frames[1:],
                   default_image=default_image)
    data = buf.getvalue()
    assert b"acTL" in data and b"fdAT" in data
    ref, got = _read_both(tmp_path, "a.png", data)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


# ---- GIF ---------------------------------------------------------------------

def _gif(rng, screen=(20, 16), at=(5, 3), bg=7, transparency=None, local_only=False) -> bytes:
    """PIL's GIF of a 12 x 10 palette frame, the logical screen and the
    frame's place rewritten; with local_only the global table moves into
    the image descriptor."""
    rgb = rng.integers(0, 256, (10, 12, 3)).astype(np.uint8)
    pim = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=16)
    buf = io.BytesIO()
    pim.save(buf, "GIF", **({} if transparency is None else {"transparency": transparency}))
    data = bytearray(buf.getvalue())
    struct.pack_into("<HH", data, 6, *screen)
    data[11] = bg
    ncol = 2 << (data[10] & 7)
    table = bytes(data[13:13 + 3 * ncol])
    desc = data.index(b"\x2c", 13 + 3 * ncol)
    struct.pack_into("<HH", data, desc + 1, *at)
    if not local_only:
        return bytes(data)
    head = bytearray(data[:13])
    head[10] &= 0x7F
    image = bytearray(data[desc:desc + 10])
    image[9] |= 0x80 | (data[10] & 7)
    return bytes(head) + bytes(data[13 + 3 * ncol:desc]) + bytes(image) + table + bytes(
        data[desc + 10:])


@pytest.mark.parametrize("case", ["off origin", "transparent", "transparent is background",
                                  "local table only", "at origin, transparent",
                                  "background past the table", "frame outside the screen"])
def test_gif_canvas(tmp_path, rng, case):
    """The screen starts as the global table's background colour (black
    without a global table), transparent pixels leave it; cv2 refuses a
    background index past the global table and a frame outside the
    screen."""
    kw = {"off origin": {}, "transparent": dict(transparency=3),
          "transparent is background": dict(transparency=3, bg=3),
          "local table only": dict(transparency=3, local_only=True),
          "at origin, transparent": dict(screen=(12, 10), at=(0, 0), transparency=5),
          "background past the table": dict(bg=200),
          "frame outside the screen": dict(screen=(14, 8))}[case]
    data = _gif(rng, **kw)
    ref, got = _read_both(tmp_path, "g.gif", data)
    if case in ("background past the table", "frame outside the screen"):
        assert ref is None and got is None
        return
    np.testing.assert_array_equal(got, ref)


# ---- BMP ---------------------------------------------------------------------

def _bmp(pixels, bpp, palette=None, top_down=False, compression=0, masks=None, header=40,
         rle=None, clrused=None) -> bytes:
    """A BMP file: (h, w) indices at 1-8 bits, 16-bit words, or BGR(A)
    bytes at 24/32; an RLE stream in place of the rows; BITFIELDS masks
    inside a header of 56 bytes or more, else after it; OS/2 headers of
    12 bytes."""
    h, w = pixels.shape[:2]
    if rle is not None:
        body = rle
    else:
        rows = []
        for row in pixels:
            if bpp in (1, 4):
                idx = np.zeros(-(-w * bpp // 8) * 8 // bpp, np.uint8)
                idx[:w] = row
                b = (np.packbits(idx) if bpp == 1 else (idx[0::2] << 4) | idx[1::2]).tobytes()
            else:
                b = row.astype({8: np.uint8, 16: "<u2"}.get(bpp, np.uint8)).tobytes()
            rows.append(b + b"\0" * (-len(b) % 4))
        body = b"".join(rows if top_down else rows[::-1])
    if header == 12:
        info, extra = struct.pack("<IHHHH", 12, w, h, 1, bpp), b""
        pal = b"" if palette is None else bytes(np.asarray(palette)[:, ::-1].astype(
            np.uint8).tobytes())
    else:
        n_pal = 0 if palette is None else len(palette)
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bpp, compression,
                           len(body), 2835, 2835, clrused if clrused is not None else n_pal, 0)
        extra = b""
        mk = b"" if masks is None else b"".join(struct.pack("<I", m) for m in masks)
        if header >= 56:
            info += mk + b"\0" * (header - 40 - len(mk))
        else:
            extra = mk
        pal = b"" if palette is None else bytes(np.concatenate(
            [np.asarray(palette)[:, ::-1], np.zeros((n_pal, 1), int)], 1).astype(
            np.uint8).tobytes())
    off = 14 + len(info) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info + extra + pal + body


@pytest.mark.parametrize("hw", [(5, 7), (1, 1), (3, 33), (17, 2)])
def test_bmp_depths_and_headers(tmp_path, hw):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    h, w = hw
    for bpp in (1, 4, 8):
        pal = rng.integers(0, 256, (1 << bpp, 3))
        idx = rng.integers(0, 1 << bpp, (h, w))
        for top_down in (False, True):
            _same(tmp_path, "p.bmp", _bmp(idx, bpp, pal, top_down=top_down))
        _same(tmp_path, "os2.bmp", _bmp(idx, bpp, pal, header=12))
        short = pal[:max(1, (1 << bpp) // 2)]   # indices past it read 0
        _same(tmp_path, "short.bmp", _bmp(idx, bpp, short))
    bgr, bgra = rng.integers(0, 256, (h, w, 3)), rng.integers(0, 256, (h, w, 4))
    words = rng.integers(0, 65536, (h, w))
    for top_down in (False, True):
        _same(tmp_path, "24.bmp", _bmp(bgr, 24, top_down=top_down))
        _same(tmp_path, "32.bmp", _bmp(bgra, 32, top_down=top_down))
        _same(tmp_path, "16.bmp", _bmp(words, 16, top_down=top_down))
    _same(tmp_path, "v5.bmp", _bmp(bgr, 24, header=124))
    _same(tmp_path, "24os2.bmp", _bmp(bgr, 24, header=12))
    for masks in ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F), (0xF00, 0xF0, 0xF)):
        for header in (40, 108):   # a V4 header's masks are not where cv2 reads them
            _same(tmp_path, "bf16.bmp", _bmp(words, 16, compression=3, masks=masks,
                                             header=header))
    for masks in ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF, 0xFF00, 0xFF0000, 0),
                  (0x3FF00000, 0xFFC00, 0x3FF, 0), (0xF00, 0xF0, 0xF, 0xF000),
                  (0, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF)):
        for header in (40, 56, 108, 124):
            _same(tmp_path, "bf32.bmp", _bmp(bgra, 32, compression=3,
                                             masks=masks[:3] if header == 40 else masks,
                                             header=header))


def _rle8_stream(rng, w, h) -> bytes:
    """Runs, absolute runs, end of line, delta, end of bitmap (sometimes
    absent or early), now and then two random bytes."""
    out, x, y = [], 0, 0
    while y < h:
        c = rng.integers(0, 10)
        if c < 4 and x < w:
            n = int(rng.integers(1, w - x + 1))
            out += [n, int(rng.integers(0, 20))]
            x += n
            if x == w:
                x, y = 0, y + 1
        elif c < 6 and w - x >= 3:
            n = int(rng.integers(3, w - x + 1))
            out += [0, n] + list(rng.integers(0, 20, n)) + [0] * (n % 2)
            x += n
        elif c < 8:
            out += [0, 0]
            x, y = 0, y + 1
        elif c < 9:
            dx, dy = int(rng.integers(0, 4)), int(rng.integers(0, 2))
            out += [0, 2, dx, dy]
            x, y = (x + dx) % w, y + dy + (x + dx) // w
        else:
            out += [0, 1]
            break
        if rng.random() < 0.02:
            out += [int(v) for v in rng.integers(0, 256, 2)]
    return bytes(out + ([0, 1] if rng.random() < 0.7 else []))


def _rle4_stream(rng, w, h) -> bytes:
    out, x, y = [], 0, 0
    while y < h:
        c = rng.integers(0, 10)
        if c < 4 and x < w:
            n = int(rng.integers(1, w - x + 1))
            out += [n, int(rng.integers(0, 256))]
            x += n
        elif c < 6 and w - x >= 3:
            n = int(rng.integers(3, w - x + 1))
            out += [0, n] + list(rng.integers(0, 256, (((n + 1) >> 1) + 1) & ~1))
            x += n
        elif c < 9:
            out += [0, 0]
            x, y = 0, y + 1
        else:
            dx = int(rng.integers(0, 3))
            out += [0, 2, dx, int(rng.integers(0, 2))]
            x += dx
            if x >= w:
                x, y = 0, y + 1
        if rng.random() < 0.02:
            out += [0, 1]
    return bytes(out + [0, 1])


@pytest.mark.parametrize("seed", range(4))
def test_bmp_rle_streams(tmp_path, seed):
    """cv2's RLE8 (runs that end a line move on, end of line right after
    is skipped, delta of dx + dy lines, fills with entry 0) and RLE4 (only
    escapes move on, delta drops dy, an early end of bitmap runs out of
    data): 100 seeded streams each, some refused by cv2, top-down too."""
    rng = np.random.default_rng(seed)
    refused = 0
    for _ in range(50):
        w, h = int(rng.integers(3, 12)), int(rng.integers(1, 6))
        pal4 = rng.integers(0, 256, (16, 3))
        pal8 = rng.integers(0, 256, (int(rng.integers(1, 30)), 3))
        blank = np.zeros((h, w), int)
        for data in (_bmp(blank, 8, pal8, compression=1, rle=_rle8_stream(rng, w, h),
                          top_down=bool(rng.random() < 0.2)),
                     _bmp(blank, 4, pal4, compression=2, rle=_rle4_stream(rng, w, h))):
            ref, got = _read_both(tmp_path, "r.bmp", data)
            if ref is None:
                refused += 1
                assert got is None
            else:
                np.testing.assert_array_equal(got, ref)
    assert 0 < refused < 100


def test_bmp_and_pxm_under_another_extension(tmp_path, rng):
    """The format comes from the first bytes, as cv2 takes it."""
    bgr = rng.integers(0, 256, (9, 11, 3))
    ref, got = _read_both(tmp_path, "upload.png", _bmp(bgr, 24))
    assert ref is not None
    np.testing.assert_array_equal(got, ref)
    pgm = b"P5\n11 9\n255\n" + rng.integers(0, 256, (9, 11)).astype(np.uint8).tobytes()
    ref, got = _read_both(tmp_path, "upload.jpg", pgm)
    assert ref is not None
    np.testing.assert_array_equal(got, ref)


# ---- PBM, PGM, PPM -------------------------------------------------------------

def _ascii(a, sep=" ") -> bytes:
    return (sep.join(map(str, np.ravel(a))) + "\n").encode()


@pytest.mark.parametrize("maxval", [1, 7, 100, 255, 256, 1000, 4095, 65535])
def test_pxm_gray_and_colour(tmp_path, maxval):
    """Binary samples as they are (uint16 above 255, big-endian); ASCII
    ones clamped to maxval and, at 8 bits, scaled by 255 / maxval; colour
    with cv2's weights; a last ASCII number without a byte after it, and
    short binary data, give None."""
    rng = np.random.default_rng(maxval)
    for h, w in ((5, 7), (1, 1), (3, 17)):
        v, rgb = rng.integers(0, maxval + 1, (h, w)), rng.integers(0, maxval + 1, (h, w, 3))
        dt = ">u2" if maxval > 255 else np.uint8
        head = f"{w} {h}\n{maxval}\n".encode()
        _same(tmp_path, "a.pgm", b"P5\n" + head + v.astype(dt).tobytes())
        _same(tmp_path, "b.pgm", b"P2\n" + head + _ascii(v))
        _same(tmp_path, "c.pgm", b"P2\n" + head + _ascii(np.minimum(v + maxval // 2, 65535)))
        _same(tmp_path, "d.ppm", b"P6\n" + head + rgb.astype(dt).tobytes())
        _same(tmp_path, "e.ppm", b"P3\n" + head + _ascii(rgb, "\n"))
        _same(tmp_path, "f.pgm", b"P2\n" + head + _ascii(v)[:-1])
        _same(tmp_path, "g.pgm", b"P5\n" + head + v.astype(dt).tobytes()[:-1])


def test_pxm_bitmaps_comments_and_refusals(tmp_path, rng):
    for h, w in ((5, 7), (1, 1), (3, 17)):
        bits = rng.integers(0, 2, (h, w))
        _same(tmp_path, "a.pbm", f"P1\n{w} {h}\n".encode() + _ascii(bits))
        _same(tmp_path, "b.pbm", f"P1\n{w} {h}\n".encode() + "".join(map(str, bits.ravel())).encode())
        _same(tmp_path, "c.pbm", f"P4\n{w} {h}\n".encode()
              + np.packbits(bits.astype(np.uint8), axis=1).tobytes())
        _same(tmp_path, "d.pgm", f"P5\n# c\n{w} # x\n{h}\n#y\n255\n".encode()
              + rng.integers(0, 256, (h, w)).astype(np.uint8).tobytes())
        _same(tmp_path, "e.pgm", f"P2 {w} {h} 200 # note\n".encode()
              + _ascii(rng.integers(0, 201, (h, w))))
    for data in (b"P2\n2 2\n255\n1 2 x 4\n", b"P2\n2 2\n255\n1 -2 3 4\n", b"P5\n0 2\n255\n",
                 b"P5\n2 2\n0\n\0\0\0\0", b"P5\n2 2\n70000\n\0\0\0\0", b"P52 2 255\n\0\0\0\0",
                 b"P2\n2 2\n255"):
        ref, got = _read_both(tmp_path, "x.pgm", data)
        assert ref is None and got is None


# ---- resize_area_cv2 zooming at uint8 ------------------------------------------

@pytest.mark.parametrize("shapes", [(7, 9, 20, 31), (64, 64, 100, 100), (45, 62, 97, 200),
                                    (100, 40, 100, 90), (30, 200, 70, 200), (100, 40, 50, 90),
                                    (40, 100, 90, 50), (3, 3, 1000, 7), (1, 5, 4, 13),
                                    (97, 61, 98, 62)])
def test_resize_area_cv2_zoom_uint8(rng, shapes):
    """cv2's INTER_AREA where an axis zooms, at uint8: its linear resize on
    the area taps in fixed point (weights of 1/2048, its 8-bit vertical
    pass's shifts); exact. uint16 (float32 there) stays exact too."""
    h, w, oh, ow = shapes
    for dtype in (np.uint8, np.uint16):
        img = rng.integers(0, np.iinfo(dtype).max + 1, (h, w)).astype(dtype)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA)
        x = torch.from_numpy(img) if dtype == np.uint8 else torch.from_numpy(
            img.astype(np.float32))
        got = resize_area_cv2(x, (oh, ow)).numpy()
        np.testing.assert_array_equal(got, ref.astype(np.float32))




# ---- TIFF ----------------------------------------------------------------------

def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: a clear code first, codes MSB-first,
    the width growing when the next code would not fit, an end code."""
    out = bytearray()
    acc = nacc = 0

    def put(code, width):
        nonlocal acc, nacc
        acc, nacc = (acc << width) | code, nacc + width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    table, nxt, width = {bytes([i]): i for i in range(256)}, 258, 9
    put(256, width)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            put(256, width)
            table, nxt, width = {bytes([i]): i for i in range(256)}, 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        w = bytes([c])
    if w:
        put(table[w], width)
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    put(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _tiff(arr, *, bits=None, compression=1, predictor=1, photometric=None, tile=None,
          rows_per_strip=None, planar=1, big=False, cmap=None, orientation=None,
          extra_samples=None, tags=None, encoder=None) -> bytes:
    """A TIFF of arr ((h, w) or (h, w, samples)) written by hand; `tags`
    adds or replaces directory entries ({tag: (type, [values])}), and
    `encoder` (a strip's or tile's (rows, cols, samples) array -> bytes)
    replaces the compressions written here."""
    bo = ">" if big else "<"
    tags_in = tags or {}
    a = np.asarray(arr)
    a = a[..., None] if a.ndim == 2 else a
    h, w, spp = a.shape
    bits = bits or a.dtype.itemsize * 8
    fmt = {"f": 3, "i": 2}.get(a.dtype.kind, 1)
    photometric = photometric if photometric is not None else 2 if spp >= 3 else 1

    def encode(block):
        rows, cols, s = block.shape
        if encoder is not None:
            return encoder(block)
        if predictor == 2:
            block = block.copy()
            block[:, 1:] = (block[:, 1:].astype(np.int64) - block[:, :-1]).astype(a.dtype)
        if bits % 8:
            v = block.reshape(rows, cols * s).astype(np.uint16)
            planes = ((v[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(rows, -1)
            raw = np.packbits(planes, axis=1).tobytes()
        else:
            raw = block.astype(a.dtype.newbyteorder(bo) if a.dtype.itemsize > 1
                               else a.dtype).tobytes()
        if compression == 5:
            return _lzw_encode(raw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        if compression == 32773:
            step = len(raw) // rows
            return b"".join(codecs._packbits_encode(raw[r * step:(r + 1) * step])
                            for r in range(rows))
        return raw

    planes = [a[..., i:i + 1] for i in range(spp)] if planar == 2 else [a]
    chunks = []
    if tile:
        tw, th = tile
        for pl in planes:
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, pl.shape[2]), a.dtype)
                    part = pl[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
    else:
        rps = rows_per_strip or h
        chunks = [encode(pl[y:y + rps]) for pl in planes for y in range(0, h, rps)]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar]), 339: (3, [fmt] * spp)}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if orientation:
        tags[274] = (3, [orientation])
    if cmap is not None:
        tags[320] = (3, [int(c) for c in np.asarray(cmap).reshape(-1)])
    if extra_samples is not None:
        tags[338] = (3, list(extra_samples))
    if tile:
        tags[322], tags[323] = (4, [tile[0]]), (4, [tile[1]])
        off_tag, cnt_tag = 324, 325
    else:
        tags[278] = (4, [rows_per_strip or h])
        off_tag, cnt_tag = 273, 279
    tags.update(tags_in)
    body = bytearray(b"MM\0*" if big else b"II*\0") + b"\0\0\0\0"
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\0" * (len(c) % 2)
    tags[off_tag], tags[cnt_tag] = (4, offsets), (4, [len(c) for c in chunks])
    blobs = {}
    # type -> struct code; a RATIONAL's values are numerator, denominator, ...
    codes = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B"}

    def packed(typ, vals):
        return struct.pack(bo + codes[typ] * len(vals), *vals)
    for t in sorted(tags):
        typ, vals = tags[t]
        if len(packed(typ, vals)) > 4:
            blobs[t] = len(body)
            body += packed(typ, vals)
            body += b"\0" * (len(body) % 2)
    body[4:8] = struct.pack(bo + "I", len(body))
    body += struct.pack(bo + "H", len(tags))
    for t in sorted(tags):
        typ, vals = tags[t]
        count = len(vals) // 2 if typ == 5 else len(vals)
        if t in blobs:
            body += struct.pack(bo + "HHII", t, typ, count, blobs[t])
        else:
            body += struct.pack(bo + "HHI", t, typ, count) + packed(typ, vals).ljust(4, b"\0")
    return bytes(body + b"\0\0\0\0")


def _samples(rng, kind, h=37, w=53):
    return {"u8": lambda: rng.integers(0, 256, (h, w)).astype(np.uint8),
            "u16": lambda: rng.integers(0, 65536, (h, w)).astype(np.uint16),
            "rgb": lambda: rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
            "rgb16": lambda: rng.integers(0, 65536, (h, w, 3)).astype(np.uint16)}[kind]()


@pytest.mark.parametrize("kind", ["u8", "u16", "rgb", "rgb16"])
@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
def test_tiff_compressions_and_predictor(tmp_path, rng, kind, compression):
    """Strips of 10 rows, predictor 1 and 2 (libtiff applies 2 only under
    LZW and Deflate), little- and big-endian; uint8 (RGB through libtiff's
    RGBA interface and cv2's 14-bit weights) and uint16 (kept, RGB to
    uint16 gray), exact."""
    arr = _samples(rng, kind)
    for predictor in (1, 2):
        for big in (False, True):
            data = _tiff(arr, compression=compression, predictor=predictor, big=big,
                         rows_per_strip=10)
            ref, got = _read_both(tmp_path, "t.tif", data)
            assert ref is not None and ref.dtype == (np.uint16 if "16" in kind else np.uint8)
            _same(tmp_path, "t.tif", data)


@pytest.mark.parametrize("case", ["cv2 u8", "cv2 u16", "cv2 bgr", "cv2 f32", "tiles", "tiles MM lzw",
                                  "planar rgb", "planar rgb tiles", "min-is-white", "min-is-white 16",
                                  "1-bit", "1-bit min-is-white", "1-bit palette",
                                  "4-bit palette", "palette 8-bit map", "palette 16-bit map",
                                  "rgba", "rgba associated", "rgba unassociated", "rgba16",
                                  "gray alpha", "float", "float MM deflate", "int32", "uint32",
                                  "2-bit", "4-bit gray", "10-bit", "12-bit min-is-white",
                                  "14-bit tiles"])
def test_tiff_layouts_and_samples(tmp_path, rng, case):
    """Every layout and sample kind the reader takes, against cv2 (gray
    10-14-bit samples shifted up to 16 bits); cv2's refusals (2-bit
    samples, 4 bits without a palette) give None both ways."""
    u8, u16 = _samples(rng, "u8"), _samples(rng, "u16")
    rgb = _samples(rng, "rgb")
    rgba = rng.integers(0, 256, (37, 53, 4)).astype(np.uint8)
    idx = {b: rng.integers(0, 1 << b, (37, 53)).astype(np.uint8) for b in (1, 2, 4)}
    f32 = (rng.random((37, 53)) * 100 - 50).astype(np.float32)
    data = {
        "cv2 u8": lambda: cv2.imencode(".tiff", u8)[1].tobytes(),
        "cv2 u16": lambda: cv2.imencode(".tiff", u16)[1].tobytes(),
        "cv2 bgr": lambda: cv2.imencode(".tiff", rgb)[1].tobytes(),
        "cv2 f32": lambda: cv2.imencode(".tiff", f32)[1].tobytes(),
        "tiles": lambda: _tiff(u16, tile=(16, 32), compression=32773),
        "tiles MM lzw": lambda: _tiff(u8, tile=(32, 16), big=True, compression=5, predictor=2),
        "planar rgb": lambda: _tiff(rgb, planar=2, compression=5, rows_per_strip=8),
        "planar rgb tiles": lambda: _tiff(rgb, planar=2, tile=(16, 16), compression=8),
        "min-is-white": lambda: _tiff(u8, photometric=0),
        "min-is-white 16": lambda: _tiff(u16, photometric=0),
        "1-bit": lambda: _tiff(idx[1], bits=1),
        "1-bit min-is-white": lambda: _tiff(idx[1], bits=1, photometric=0, compression=32773),
        "1-bit palette": lambda: _tiff(idx[1], bits=1, photometric=3,
                                       cmap=rng.integers(0, 65536, 6)),
        "4-bit palette": lambda: _tiff(idx[4], bits=4, photometric=3,
                                       cmap=rng.integers(0, 65536, 48)),
        "palette 8-bit map": lambda: _tiff(u8, photometric=3, cmap=rng.integers(0, 256, 768)),
        "palette 16-bit map": lambda: _tiff(u8, photometric=3,
                                            cmap=rng.integers(0, 65536, 768)),
        "rgba": lambda: _tiff(rgba),
        "rgba associated": lambda: _tiff(rgba, extra_samples=(1,)),
        "rgba unassociated": lambda: _tiff(rgba, extra_samples=(2,)),
        "rgba16": lambda: _tiff(rgba.astype(np.uint16) * 257, extra_samples=(2,)),
        "gray alpha": lambda: _tiff(rgba[..., :2], extra_samples=(2,)),
        "float": lambda: _tiff(f32),
        "float MM deflate": lambda: _tiff(f32, big=True, compression=8),
        "int32": lambda: _tiff(rng.integers(-5000, 5000, (37, 53)).astype(np.int32)),
        "uint32": lambda: _tiff(rng.integers(0, 5000, (37, 53)).astype(np.uint32)),
        "2-bit": lambda: _tiff(idx[2], bits=2),
        "4-bit gray": lambda: _tiff(idx[4], bits=4),
        "10-bit": lambda: _tiff(u16 >> 6, bits=10, rows_per_strip=9),
        "12-bit min-is-white": lambda: _tiff(u16 >> 4, bits=12, photometric=0),
        "14-bit tiles": lambda: _tiff(u16 >> 2, bits=14, tile=(16, 16)),
    }[case]()
    ref, got = _read_both(tmp_path, "t.tiff", data)
    assert (ref is None) == (case in ("2-bit", "4-bit gray")), case
    _same(tmp_path, "t.tiff", data)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation(tmp_path, rng, orientation):
    """Tag 274 turns the image as cv2 turns it; cv2 5.0 gives no image for
    the transposing orientations 5-8 unless the image is square."""
    img = _samples(rng, "u8")
    for arr in (img, img[:37, :37]):
        _same(tmp_path, "o.tif", _tiff(arr, orientation=orientation))
    ref, got = _read_both(tmp_path, "o.tif", _tiff(img, orientation=orientation))
    assert (got is None) == (orientation >= 5)


def test_tiff_16bit_mammogram_and_refusals(tmp_path):
    """A 1024 x 832 16-bit mammogram as cv2 writes it (LZW, predictor 2)
    comes back uint16, exact, in seconds; 16-bit colour planes (cv2 reads
    them past their strips' ends, into uninitialised memory) raise."""
    img = synthetic_native_mammogram(1024, 832, seed=3)
    data = cv2.imencode(".tiff", img)[1].tobytes()
    t0 = time.perf_counter()
    ref, got = _read_both(tmp_path, "m.tiff", data)
    assert time.perf_counter() - t0 < 10
    assert got.dtype == np.uint16 and np.array_equal(got, ref)
    from cadx_tpu_torch.data import tiff

    rgb16 = np.zeros((8, 8, 3), np.uint16)
    with pytest.raises(tiff.TiffError):
        tiff.tiff_gray(_tiff(rgb16, planar=2))
    assert imageio.imread_gray(str(tmp_path / "missing.tif")) is None


# ---- JPEG 2000 and lossless JPEG ---------------------------------------------------

def _jp2_sources(rng):
    yy, xx = np.mgrid[0:48, 0:64]
    smooth = ((xx * 3 + yy * 2) % 256).astype(np.uint8)
    noisy = (smooth * 0.7 + rng.integers(0, 256, smooth.shape) * 0.3).astype(np.uint8)
    return {"gray": noisy, "u16": noisy.astype(np.uint16) * 257,
            "12-bit": noisy.astype(np.uint16) * 16,
            "colour": np.dstack([noisy, smooth, 255 - smooth])}


@pytest.mark.parametrize("kind", ["gray", "u16", "12-bit", "colour"])
@pytest.mark.parametrize("raw", [False, True])
def test_jp2_and_j2k_codestreams(tmp_path, rng, kind, raw):
    """JP2 box files and their raw codestreams (the `jp2c` box alone). A
    reversible stream (cv2's compression 1000) reads exactly as cv2 reads
    it, colour through cvtColor's weights; an irreversible one (cv2's
    default and 200) decodes with other float rounding than OpenJPEG, so
    it is held to the DICOM J2K tests' rule (test_j2k.py: the port's RMSE
    against the source within max(1.3 x, + 1) of cv2's), its dtype and
    shape equal to cv2's, and closer to cv2's decode than cv2's is to the
    source."""
    from cadx_tpu_torch.data.j2k import _unwrap_jp2

    src = _jp2_sources(rng)[kind]
    for q in (1000, None, 200):
        data = cv2.imencode(".jp2", src, [] if q is None else
                            [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, q])[1].tobytes()
        data = _unwrap_jp2(data) if raw else data
        if q == 1000:
            _same(tmp_path, "r.jp2", data)
            continue
        ref, got = _read_both(tmp_path, "r.jp2", data)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        gray_src = cv2.cvtColor(src, cv2.COLOR_BGR2GRAY) if src.ndim == 3 else src
        rmse = {k: float(np.sqrt(((v.astype(np.float64) - gray_src) ** 2).mean()))
                for k, v in (("cv2", ref), ("port", got))}
        assert rmse["port"] < max(rmse["cv2"] * 1.3, rmse["cv2"] + 1.0), rmse
        apart = float(np.sqrt(((got.astype(np.float64) - ref) ** 2).mean()))
        assert apart <= rmse["cv2"] + 1.0, (apart, rmse)


def _with_exif(jpeg: bytes, orientation: int) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = orientation
    body = exif.tobytes()
    body = body if body.startswith(b"Exif\x00\x00") else b"Exif\x00\x00" + body
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]


@pytest.mark.parametrize("precision", [2, 4, 8, 12, 16])
def test_lossless_jpeg_sof3(tmp_path, rng, precision):
    """A lossless (SOF3) JPEG read as cv2's libjpeg reads it: 2-8 bits
    exact and unscaled, uint8; above 8 bits cv2 gives no image and neither
    does the port; an EXIF orientation turns it as any JPEG."""
    img = rng.integers(0, 1 << precision, (37, 53)).astype(
        np.uint16 if precision > 8 else np.uint8)
    data = codecs.jpeg_lossless_encode(img, precision=precision)
    ref, got = _read_both(tmp_path, "l.jpg", data)
    assert (ref is None) == (precision > 8)
    _same(tmp_path, "l.jpg", data)
    for orientation in (3, 6):
        _same(tmp_path, "l.jpg", _with_exif(data, orientation))


# ---- lossless WebP -------------------------------------------------------------

@pytest.mark.parametrize("case", ["smooth gray", "noise gray", "natural", "colour", "colour alpha",
                                  "2 colours", "4 colours", "16 colours", "100 colours",
                                  "wide", "quality 101"])
def test_webp_lossless(tmp_path, rng, case, monkeypatch):
    """cv2's lossless encodes (its default), read exactly as cv2 reads them:
    the predictor transform on smooth and natural images, the colour and
    subtract-green transforms on colour ones, colour indexing with pixel
    bundling on palettes of 2, 4 and 16 colours and without it on 100, the
    alpha dropped; each transform the stream holds is undone."""
    from cadx_tpu_torch.data import webp

    nat, bgr = _scene(rng)
    noise = rng.integers(0, 256, nat.shape).astype(np.uint8)
    img = {"smooth gray": lambda: bgr[..., 1], "noise gray": lambda: noise,
           "natural": lambda: nat, "colour": lambda: bgr,
           "colour alpha": lambda: np.dstack([bgr, noise]),
           "2 colours": lambda: (noise > 128).astype(np.uint8) * 255,
           "4 colours": lambda: noise // 64 * 80, "16 colours": lambda: noise // 16 * 16,
           "100 colours": lambda: np.dstack([noise % 10 * 25, noise // 26 * 7, 255 - noise % 10]),
           "wide": lambda: cv2.resize(nat, (400, 300)),
           "quality 101": lambda: bgr}[case]()
    params = [cv2.IMWRITE_WEBP_QUALITY, 101] if case == "quality 101" else []
    data = cv2.imencode(".webp", np.ascontiguousarray(img).astype(np.uint8), params)[1].tobytes()
    assert data[12:16] == b"VP8L"
    undone = []
    for name in ("_undo_predictor", "_undo_color", "_undo_index"):
        orig = getattr(webp, name)
        monkeypatch.setattr(webp, name, lambda *a, _o=orig, _n=name: undone.append(_n) or _o(*a))
    _same(tmp_path, "w.webp", data)
    expect = {"2 colours": "_undo_index", "4 colours": "_undo_index", "16 colours": "_undo_index",
              "smooth gray": "_undo_predictor", "natural": "_undo_predictor",
              "colour": "_undo_color"}.get(case)
    assert expect is None or expect in undone, (case, undone)


# ---- PAM, Sun raster, HDR, PFM ---------------------------------------------------

def _pam(w, h, depth, maxval, tupltype, samples: bytes) -> bytes:
    return (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n"
            + (f"TUPLTYPE {tupltype}\n" if tupltype else "") + "ENDHDR\n").encode() + samples


@pytest.mark.parametrize("maxval", [1, 100, 255, 1000, 65535])
def test_pam_depths(tmp_path, rng, maxval):
    """PAM as cv2's PAMDecoder reads it: DEPTH 1 as stored (16-bit samples
    big-endian above MAXVAL 255, unscaled), RGB through cv2's 14-bit
    weights, BLACKANDWHITE, MAXVAL 1 as packed bits, no TUPLTYPE (cv2
    guesses DEPTH 1 and 3 below 256 only, else gives None). RGB_ALPHA: cv2
    writes only the first 3 ceil(W / 4) columns of a row (the rest is
    whatever its buffer held), so those are compared. GRAYSCALE_ALPHA is
    not read through cv2 here: cv2 writes past its image's buffer."""
    w, h = 53, 37
    for depth, tupl in ((1, "GRAYSCALE"), (1, "BLACKANDWHITE"), (3, "RGB"), (4, "RGB_ALPHA"),
                        (1, None), (3, None)):
        v = rng.integers(0, maxval + 1, (h, w, depth))
        data = _pam(w, h, depth, maxval, tupl, v.astype(">u2" if maxval > 255 else np.uint8)
                    .tobytes())
        ref, got = _read_both(tmp_path, "p.pam", data)
        assert (ref is None) == (tupl is None and maxval > 255), (depth, tupl)
        if ref is None:
            assert got is None
            continue
        cols = 3 * -(-w // 4) if depth == 4 and maxval > 1 else w
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got[:, :cols], ref[:, :cols])


def test_pam_headers_and_cv2_files(tmp_path, rng):
    """Comments, spaces, decimal numbers only (cv2's ParseInt), a TUPLTYPE
    that does not fit DEPTH, a field without a value; cv2's own files."""
    px = bytes(range(8))
    for head in (b"P7\n# c\nWIDTH 4\n  HEIGHT   2\nDEPTH 1\n#x\nMAXVAL 010\nENDHDR\n",
                 b"P7\nWIDTH 4 \nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE \nENDHDR\n",
                 b"P7\nWIDTH 4\nHEIGHT 2\nDEPTH 1\nMAXVAL 0x10\nENDHDR\n",
                 b"P7\nWIDTH\n4\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
                 b"P7\nWIDTH 4\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n",
                 b"P7\nWIDTH 4\nHEIGHT 2\nDEPTH 1\nENDHDR\n"):
        _same(tmp_path, "h.pam", head + px)
    for arr in (rng.integers(0, 256, (37, 53)), rng.integers(0, 256, (37, 53, 3))):
        _same(tmp_path, "c.pam", cv2.imencode(".pam", arr.astype(np.uint8))[1].tobytes())


def _ras(w, h, depth, kind, cmap: bytes, body: bytes) -> bytes:
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), kind, 1 if cmap else 0,
                       len(cmap)) + cmap + body


def _ras_rle(rng, w, h) -> bytes:
    """A byte-encoded stream of rows of w bytes: runs (0x80 n v) and 0x80 0
    escapes among literals."""
    out = bytearray()
    for _ in range(h):
        x = 0
        while x < w:
            r = rng.integers(0, 4)
            if r == 0 and w - x >= 3:
                n = int(rng.integers(2, min(w - x, 20) + 1))
                out += bytes([0x80, n - 1, int(rng.integers(0, 256))])
                x += n
            else:
                out += b"\x80\x00" if r == 1 else bytes([int(rng.integers(0, 128))])
                x += 1
    return bytes(out)


@pytest.mark.parametrize("depth", [1, 8, 24, 32])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_sun_raster(tmp_path, rng, depth, kind):
    """Sun rasters as cv2's SunRasterDecoder reads them: types old and
    standard (byte-encoded RLE and RGB rasters give None, as in cv2 5.0),
    with and without a colour map (without one cv2's gray table is zero:
    1 and 8-bit pixels read 0), 24-bit BGR and 32-bit XBGR, rows padded to
    16 bits."""
    w, h = 53, 37
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    body = _ras_rle(rng, w, h) if kind == 2 else rng.integers(0, 256, pitch * h).astype(
        np.uint8).tobytes()
    for cmap in (b"", rng.integers(0, 256, 3 << min(depth, 8)).astype(np.uint8).tobytes()):
        data = _ras(w, h, depth, kind, cmap, body)
        ref, got = _read_both(tmp_path, "s.ras", data)
        assert (ref is None) == (kind >= 2 or (depth > 8 and bool(cmap)))
        _same(tmp_path, "s.ras", data)


def test_sun_raster_cv2_files(tmp_path, rng):
    """cv2's own rasters: 8-bit gray without a map (reads 0: the probe's
    250-code difference from the source) and 24-bit colour; a map shorter
    than its depth's."""
    for arr in (rng.integers(0, 256, (37, 53)), rng.integers(0, 256, (37, 53, 3))):
        data = cv2.imencode(".ras", arr.astype(np.uint8))[1].tobytes()
        _same(tmp_path, "c.ras", data)
    gray_map = np.tile(np.arange(256, dtype=np.uint8), 3).tobytes()[:300]
    _same(tmp_path, "m.ras", _ras(53, 37, 8, 1, gray_map, bytes(54 * 37)))


def _same_float(tmp_path, name, data, rel):
    ref, got = _read_both(tmp_path, name, data)
    if ref is None:
        assert got is None
        return
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got.astype(np.float64) - ref).max() <= rel * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("case", ["colour", "gray", "narrow", "wide", "flat", "no FORMAT", "black"])
def test_radiance_hdr(tmp_path, rng, case):
    """Radiance HDR as cv2's HdrDecoder reads it: new-style RLE scanlines
    (cv2's writes), flat ones (hand-written, and where W < 8), RGBE to
    float without rgbe.c's 0.5 offset, gray from R, G, B; within 1e-6 of
    the largest value: cv2's cvtColor may fuse the float32 products of its
    gray sum, numpy rounds each. A header without FORMAT gives None."""
    f = (rng.random((37, 53, 3)) * 4).astype(np.float32)
    flat = rng.integers(0, 256, (37, 53, 4)).astype(np.uint8)
    flat[..., 3] = rng.integers(120, 140, (37, 53))
    data = {"colour": lambda: cv2.imencode(".hdr", f)[1].tobytes(),
            "gray": lambda: cv2.imencode(".hdr", f[..., 0].copy())[1].tobytes(),
            "narrow": lambda: cv2.imencode(".hdr", f[:, :5].copy())[1].tobytes(),
            "wide": lambda: cv2.imencode(".hdr", cv2.resize(f, (300, 37)) * 1000)[1].tobytes(),
            "flat": lambda: b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 37 +X 53\n" + flat.tobytes(),
            "no FORMAT": lambda: b"#?RADIANCE\n\n-Y 37 +X 53\n" + flat.tobytes(),
            "black": lambda: cv2.imencode(".hdr", f * 0)[1].tobytes()}[case]()
    _same_float(tmp_path, "r.hdr", data, 1e-6)


@pytest.mark.parametrize("scale", [-1.0, 1.0, -2.5, 3.0, -0.1])
def test_pfm(tmp_path, rng, scale):
    """PFM as cv2's PFMDecoder reads it: little-endian where the scale is
    negative, rows bottom up, values times 1 / |scale| in float32, exact;
    a colour PFM gives None (cv2 cannot make one channel of it)."""
    g = (rng.random((37, 53)) * 10 - 5).astype(np.float32)
    dt = "<f4" if scale < 0 else ">f4"
    head = b"Pf\n53 37\n%s\n" % repr(scale).encode()
    _same_float(tmp_path, "g.pfm", head + g[::-1].astype(dt).tobytes(), 0.0)
    colour = b"PF\n53 37\n%s\n" % repr(scale).encode()
    _same_float(tmp_path, "c.pfm", colour + np.dstack([g] * 3)[::-1].astype(dt).tobytes(), 0.0)
    _same_float(tmp_path, "e.pfm", cv2.imencode(".pfm", g)[1].tobytes(), 0.0)


# ---- a float32 upload through both engines ---------------------------------------

@pytest.fixture(scope="module")
def engines():
    """test_serve.py's small JAX engine and the port's engine on its
    weights (test_torch_serve.py's `_port_of`), built once."""
    from test_serve import _small_engine
    from test_torch_serve import _port_of

    j = _small_engine()
    return j, _port_of(j)


@pytest.mark.parametrize("kind", ["hdr", "pfm", "float tiff"])
def test_float32_upload_through_both_engines(tmp_path, engines, kind):
    """A float32 upload (HDR, PFM with negative values, float TIFF) goes to
    process_single_image in both fronts; the port's engine gives JAX's
    answer: features 1e-4, clean image +-1 (test_torch_serve.py's
    tolerances). JAX's uint8 rescale saturates negative values to 0, and
    so does the port's `to_uint8`."""
    from test_serve import _mammo_png

    up = cv2.imdecode(np.frombuffer(_mammo_png(), np.uint8), cv2.IMREAD_GRAYSCALE)
    f = up.astype(np.float32)
    data = {"hdr": lambda: cv2.imencode(".hdr", np.dstack([f / 64] * 3))[1].tobytes(),
            "pfm": lambda: cv2.imencode(".pfm", f / 50 - 2)[1].tobytes(),
            "float tiff": lambda: cv2.imencode(".tiff", f / 255 * 4 - 1)[1].tobytes()}[kind]()
    ref, img = _read_both(tmp_path, "f.png", data)
    assert img.dtype == np.float32 and ref.dtype == np.float32
    j, t = engines
    fj, cj = j.process_single_image(ref)
    ft, ct = t.process_single_image(img)
    np.testing.assert_allclose(ft, np.asarray(fj), rtol=0, atol=1e-4)
    assert np.abs(ct.astype(np.int64) - np.asarray(cj)).max() <= 1


# ---- the formats left open -------------------------------------------------------

def _open_format_files() -> dict:
    """One small file of each format cv2 reads here that the port left open
    until the lossy WebP, JPEG and fax TIFF readers came (AVIF stays open,
    ROADMAP Queue 3): AVIF, lossy WebP (VP8), the TIFF compressions JPEG and
    CCITT group 4, and colour TIFF samples of 12 bits."""
    img = (np.arange(48 * 64) % 251).reshape(48, 64).astype(np.uint8)
    files = {".avif": cv2.imencode(".avif", img)[1].tobytes(),
             ".webp (lossy)": cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 90])[1]
             .tobytes()}
    for name, mode, comp in ((".tiff (JPEG)", "L", "jpeg"), (".tiff (CCITT G4)", "1", "group4")):
        buf = io.BytesIO()
        Image.fromarray(img if mode == "L" else img > 128).save(buf, "TIFF", compression=comp)
        files[name] = buf.getvalue()
    files[".tiff (12-bit RGB)"] = _tiff(np.dstack([img, img, 255 - img]).astype(np.uint16) * 16,
                                        bits=12)
    return files


@pytest.mark.parametrize("name", [".avif"])
def test_open_formats_cv2_reads_the_port_does_not(tmp_path, name):
    """The standing gaps (ROADMAP Queue 3): cv2 reads each of these here,
    the port answers None, as /upload-single answers "Could not read
    image"."""
    data = _open_format_files()[name]
    ref, got = _read_both(tmp_path, "open" + name.split()[0], data)
    assert ref is not None and ref.shape[:2] == (48, 64)
    assert got is None
    assert math.isfinite(float(ref.astype(np.float64).mean()))


@pytest.mark.parametrize("name", [".webp (lossy)", ".tiff (JPEG)", ".tiff (CCITT G4)",
                                  ".tiff (12-bit RGB)"])
def test_formats_once_open_read_as_cv2_reads_them(tmp_path, name):
    """The four formats the port used to leave open now read as cv2 reads
    them, exact."""
    ref, got = _read_both(tmp_path, "open" + name.split()[0], _open_format_files()[name])
    assert ref is not None and got is not None and ref.shape[:2] == (48, 64)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ---- JPEG inside TIFF, colour TIFF at 10-14 bits, fill order 2 --------------------

def split_tables(jpeg: bytes) -> tuple[bytes, bytes]:
    """A JPEG stream -> (a tables-only stream of its DQT and DHT segments,
    the abbreviated image stream without them or its APPn segments), as
    libtiff keeps them apart."""
    pos, tables, rest = 2, [], []
    while True:
        marker = jpeg[pos + 1]
        (n,) = struct.unpack(">H", jpeg[pos + 2:pos + 4])
        seg = jpeg[pos:pos + 2 + n]
        if marker in (0xC4, 0xDB):
            tables.append(seg)
        elif marker == 0xDA:
            rest.append(jpeg[pos:])
            break
        elif not 0xE0 <= marker <= 0xEF:
            rest.append(seg)
        pos += 2 + n
    return b"\xff\xd8" + b"".join(tables) + b"\xff\xd9", b"\xff\xd8" + b"".join(rest)


_SAMPLING = {(2, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             (2, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             (1, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             (1, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def jpeg_ycbcr_tiff(rgb: np.ndarray, rows_per_strip: int = 64, quality: int = 90,
                    sampling=(2, 2), tile=None, abbreviated: bool = True) -> bytes:
    """A YCbCr JPEG TIFF of (h, w, 3) RGB written by hand: each strip or
    tile cv2's JPEG (YCbCr, component 0 at `sampling`); abbreviated, the
    tables in tag 347 (JPEGTables), or whole streams."""
    tables = []

    def encode(block):
        jpeg = cv2.imencode(".jpg", np.ascontiguousarray(block[..., ::-1]),
                            [cv2.IMWRITE_JPEG_QUALITY, quality,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[sampling]])[1].tobytes()
        t, body = split_tables(jpeg)
        tables.append(t)
        return body if abbreviated else jpeg

    tags = {530: (3, list(sampling)),
            532: (5, [0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1])}
    _tiff(rgb, compression=7, photometric=6, rows_per_strip=rows_per_strip, tile=tile,
          tags=tags, encoder=encode)
    assert len(set(tables)) == 1
    if abbreviated:
        tags[347] = (7, list(tables[0]))
    return _tiff(rgb, compression=7, photometric=6, rows_per_strip=rows_per_strip, tile=tile,
                 tags=tags, encoder=encode)


@pytest.mark.parametrize("mode", ["L", "RGB", "YCbCr"])
@pytest.mark.parametrize("layout", ["one strip", "strips of 16", "strips of 32", "fill order 2"])
def test_tiff_jpeg_pil(tmp_path, rng, mode, layout):
    """PIL's JPEG TIFFs (libtiff's codec: JPEGTables and abbreviated
    strips or tiles): gray, RGB (photometric 2, the components as decoded)
    and YCbCr (photometric 6, which libtiff has libjpeg turn to RGB), then
    libtiff's RGBA interface and cv2's 14-bit gray weights, exact; fill
    order 2 leaves a JPEG stream as it is. (PIL writes no tiles; the
    hand-made files below have them.)"""
    gray, rgb = _scene(rng, 67, 93)
    img = Image.fromarray(gray if mode == "L" else rgb)
    if mode == "YCbCr":
        img = img.convert("YCbCr")
    info = {"one strip": {}, "strips of 16": {278: 16}, "strips of 32": {278: 32},
            "fill order 2": {266: 2}}[layout]
    buf = io.BytesIO()
    img.save(buf, "TIFF", compression="jpeg", tiffinfo=info)
    from cadx_tpu_torch.data import tiff

    _, tags = tiff._ifd(buf.getvalue())
    assert tags[259] == (7,) and 347 in tags and all(tags[t] == (v,) for t, v in info.items())
    _same(tmp_path, "j.tif", buf.getvalue())


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 2), (1, 1)])
@pytest.mark.parametrize("layout", ["strips", "tiles", "strips, whole streams"])
def test_tiff_jpeg_ycbcr_subsampled(tmp_path, rng, sampling, layout):
    """YCbCr JPEG TIFFs with subsampled chroma (cv2's encoder; tag 530 at
    the stream's factors): libjpeg's fancy upsampling and YCbCr to RGB,
    per strip or tile, exact; with and without JPEGTables."""
    _, rgb = _scene(rng, 67, 93)
    data = jpeg_ycbcr_tiff(rgb, rows_per_strip=16, sampling=sampling,
                           tile=(32, 32) if layout == "tiles" else None,
                           abbreviated=layout != "strips, whole streams")
    _same(tmp_path, "y.tif", data)


def test_tiff_jpeg_refusals(tmp_path, rng):
    """What libtiff refuses, the port refuses: YCbCr subsampling other than
    the stream's, an RGB TIFF whose stream is subsampled, a JPEG strip of
    another size than the strip; None both ways."""
    from cadx_tpu_torch.data import tiff

    _, rgb = _scene(rng, 32, 48)
    sub = jpeg_ycbcr_tiff(rgb, rows_per_strip=32, sampling=(2, 2))
    wrong = sub.replace(struct.pack("<HHIHH", 530, 3, 2, 2, 2), struct.pack("<HHIHH", 530, 3,
                                                                         2, 1, 1))
    assert wrong != sub
    whole = cv2.imencode(".jpg", rgb, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])[1].tobytes()
    rgb_sub = _tiff(rgb, compression=7, encoder=lambda block: whole)
    small = cv2.imencode(".jpg", rgb[:16])[1].tobytes()
    short = _tiff(rgb, compression=7, photometric=6, tags={530: (3, [1, 1])},
                  encoder=lambda block: small)
    for data in (wrong, rgb_sub, short):
        ref, got = _read_both(tmp_path, "r.tif", data)
        assert ref is None and got is None
        with pytest.raises(tiff.TiffError):
            tiff.tiff_gray(data)


@pytest.mark.parametrize("bits", [10, 12, 14])
@pytest.mark.parametrize("case", ["strips", "big-endian tiles", "LZW", "alpha", "planar",
                                  "gray + alpha"])
def test_tiff_colour_10_to_14_bits(tmp_path, rng, bits, case):
    """RGB samples of 10, 12 and 14 bits: cv2 weighs them as stored with
    its 14-bit weights and shifts the gray up to 16 bits (uint16), exact;
    separate planes (which cv2 reads past their strips) and gray with
    alpha (which libtiff's RGBA check refuses) give None."""
    a = rng.integers(0, 1 << bits, (37, 53, 4)).astype(np.uint16)
    data = {"strips": lambda: _tiff(a[..., :3], bits=bits, rows_per_strip=9),
            "big-endian tiles": lambda: _tiff(a[..., :3], bits=bits, tile=(16, 16), big=True),
            "LZW": lambda: _tiff(a[..., :3], bits=bits, compression=5),
            "alpha": lambda: _tiff(a, bits=bits, extra_samples=(2,)),
            "planar": lambda: _tiff(a[..., :3], bits=bits, planar=2),
            "gray + alpha": lambda: _tiff(a[..., :2], bits=bits, extra_samples=(2,))}[case]()
    ref, got = _read_both(tmp_path, "c.tif", data)
    if case == "planar":
        assert ref is not None and got is None
        return
    if case == "gray + alpha":
        assert ref is None and got is None
        return
    assert ref.dtype == np.uint16
    _same(tmp_path, "c.tif", data)
    w = a[..., :3].astype(np.int64)
    want = ((4899 * w[..., 0] + 9617 * w[..., 1] + 1868 * w[..., 2] + 8192) >> 14) << (16 - bits)
    np.testing.assert_array_equal(got, want)


_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("kind", ["u8", "u16"])
def test_tiff_fill_order_2(tmp_path, rng, compression, kind):
    """Fill order 2: libtiff reverses each byte's bits before it decodes a
    strip (none, LZW, Deflate, PackBits), so a writer that reversed them
    reads back as written."""
    arr = _samples(rng, kind)
    plain = _tiff(arr, compression=compression, rows_per_strip=10)
    chunks = []

    def reversed_chunk(block):
        data = _tiff(block, compression=compression)
        from cadx_tpu_torch.data import tiff

        _, tags = tiff._ifd(data)
        (off,), (cnt,) = tags[273], tags[279]
        chunks.append(data[off:off + cnt])
        return bytes(_REVERSE[np.frombuffer(chunks[-1], np.uint8)])

    data = _tiff(arr, compression=compression, rows_per_strip=10, tags={266: (3, [2])},
                 encoder=reversed_chunk)
    ref, got = _read_both(tmp_path, "f.tif", data)
    np.testing.assert_array_equal(got, _read_both(tmp_path, "p.tif", plain)[1])
    _same(tmp_path, "f.tif", data)


# ---- subsampled colour JPEG ---------------------------------------------------------

def _adobe_rgb(jpeg: bytes) -> bytes:
    """cv2's JFIF YCbCr stream relabelled as Adobe RGB (APP0 dropped, an
    APP14 of transform 0 in its place): libjpeg then reads the same
    subsampled components as R, G and B."""
    assert jpeg[2:4] == b"\xff\xe0"
    (n,) = struct.unpack(">H", jpeg[4:6])
    return jpeg[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00" + jpeg[4 + n:]


@pytest.mark.parametrize("space", ["rgb", "cmyk", "ycck"])
@pytest.mark.parametrize("sampling", ["2x1", "2x2"])
@pytest.mark.parametrize("hw", [(67, 93), (17, 33), (1, 1), (2, 3)])
def test_subsampled_colour_jpeg(tmp_path, rng, space, sampling, hw):
    """RGB, CMYK and YCCK JPEGs with subsampled components (libjpeg-turbo's
    fancy upsampling, then rgb_gray_convert or ycck_cmyk_convert and cv2's
    CMYK gray), baseline and progressive, exact."""
    gray, rgb = _scene(rng, *hw)
    for progressive in (False, True):
        if space == "rgb":
            factor = {"2x1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                      "2x2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}[sampling]
            data = _adobe_rgb(cv2.imencode(".jpg", rgb, [
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])[1].tobytes())
        else:
            data = _pil_jpeg(np.dstack([rgb, gray[::-1]]), "CMYK", quality=80,
                             subsampling={"2x1": 1, "2x2": 2}[sampling],
                             progressive=progressive)
            if space == "ycck":
                data = _with_adobe_transform(data, 2)
        frame = jpg._read_frame(data)[0]
        assert frame.sampling[0] == {"2x1": (2, 1), "2x2": (2, 2)}[sampling]
        assert jpg._colour_space(frame, False, 0 if space == "rgb" else
                                 2 if space == "ycck" else None) == space
        _same(tmp_path, "s.jpg", data)


# ---- the front's fixtures -----------------------------------------------------------

@pytest.mark.parametrize("name", ["upload_lossy.webp", "upload_jpeg_ycbcr.tif",
                                  "upload_g4.tif"])
def test_front_fixtures(tmp_path, name):
    """chip_smoke.py phase 9's uploads in the formats of this reader
    (tests/data/make_upload_fixtures.py made them): the port's read equals
    cv2's, and both equal the PNG committed beside the file, which is what
    phase 9 holds the card's read to."""
    from pathlib import Path

    here = Path(__file__).parent / "data"
    data = (here / name).read_bytes()
    want = imageio.png_gray((here / (name + ".png")).read_bytes())
    ref, got = _read_both(tmp_path, name, data)
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and got.shape == ((1024, 832) if "g4" in name else (512, 512))
