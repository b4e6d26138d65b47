"""The upload reader's formats against `cv2.imread(path, IMREAD_GRAYSCALE |
IMREAD_ANYDEPTH)`, the JAX front's reader, on the inputs where the two
used to differ.

- JPEG (`data/jpg.py::jpeg_luma_decode`): progressive (spectral selection
  and successive approximation, restart intervals) in gray and YCbCr at
  the chroma subsamplings PIL and cv2 write, within +-2 codes (a float
  IDCT against libjpeg-turbo's integer one); a 3328 x 2560 frame under
  10 s; Adobe RGB (APP14 transform 0), CMYK and YCCK: the colour to gray
  formulas exact on images of flat 8 x 8 blocks (whose IDCT both decoders
  give exactly), +-2 codes end to end.
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
- The formats left open: cv2 reads each, the port gives None (ROADMAP
  Queue 3).
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


# ---- the formats left open -------------------------------------------------------

def _open_format_files() -> dict:
    """One small file of each format cv2 reads here that the port leaves
    open, in ROADMAP Queue 3's order."""
    img = (np.arange(48 * 64) % 251).reshape(48, 64).astype(np.uint8)
    files = {ext: cv2.imencode(ext, img)[1].tobytes()
             for ext in (".tiff", ".webp", ".avif", ".jp2", ".ras", ".pam")}
    files[".jpg (lossless, SOF3)"] = codecs.jpeg_lossless_encode(img)
    f32 = img.astype(np.float32) / 255
    files[".hdr"] = cv2.imencode(".hdr", np.dstack([f32] * 3))[1].tobytes()
    files[".pfm"] = cv2.imencode(".pfm", f32)[1].tobytes()
    return files


@pytest.mark.parametrize("name", [".tiff", ".webp", ".avif", ".jp2", ".jpg (lossless, SOF3)",
                                  ".ras", ".hdr", ".pfm", ".pam"])
def test_open_formats_cv2_reads_the_port_does_not(tmp_path, name):
    """The standing gaps (ROADMAP Queue 3): cv2 reads each of these here,
    the port answers None, as /upload-single answers "Could not read
    image"."""
    data = _open_format_files()[name]
    ref, got = _read_both(tmp_path, "open" + name.split()[0], data)
    assert ref is not None and ref.shape[:2] == (48, 64)
    assert got is None
    assert math.isfinite(float(ref.astype(np.float64).mean()))
