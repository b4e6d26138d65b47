"""The port's cv2-free upload reader (`data/imageio.py`) against
`cv2.imread(path, IMREAD_GRAYSCALE | IMREAD_ANYDEPTH)`, the reader of the
JAX package's front, on files that cv2, PIL and a test-local PNG encoder
(every filter type, Adam7, every colour type and depth) write.

Tolerances: PNG and GIF bit-exact (gray, 16-bit, palette, RGB and RGBA,
with and without gAMA/sRGB chunks: the reader uses libpng's and
cvtColor's own fixed point and gamma tables); JPEG within +-2 codes
(float IDCT against libjpeg's integer one), turned by its EXIF
orientation as cv2 turns it; None where cv2 gives None. DICOM uploads
read as the JAX front's `_imread_gray` reads them.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from cadx_tpu.data import dicom as JD
from cadx_tpu.serve.app import _imread_gray as jax_imread_gray
from cadx_tpu_torch.data import dicom as TD
from cadx_tpu_torch.data import imageio

FLAGS = cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH


def _write(tmp_path, name, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _check(path, atol=0):
    ref = cv2.imread(path, FLAGS)
    got = imageio.imread_gray(path)
    assert ref is not None and got is not None
    assert got.dtype == ref.dtype and got.shape == ref.shape
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64)).max()
    assert diff <= atol, diff


def _scene(rng, h=45, w=62):
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (xx * 3 + yy * 2) % 256
    noise = rng.integers(0, 256, (h, w))
    return smooth, noise


# ---- a test-local PNG encoder: every filter type, Adam7 ---------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack(sub, depth):
    h, w, n = sub.shape
    if depth == 16:
        return sub.astype(">u2").reshape(h, w * n).view(np.uint8)
    if depth == 8:
        return sub.astype(np.uint8).reshape(h, w * n)
    bits = ((sub.reshape(h, w * n, 1) >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filter_rows(rows, bpp, rng):
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        kind = int(rng.integers(0, 5))
        pred = [0, a, b, (a + b) // 2, paeth][kind]
        out.append(bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _png(samples, ctype, depth, rng, interlace=False, palette=None, extra=b"", early=b""):
    h, w, n = samples.shape
    bpp = max(1, n * depth // 8)
    if interlace:
        raw = b"".join(_filter_rows(_pack(samples[ys::dy, xs::dx], depth), bpp, rng)
                       for xs, ys, dx, dy in _ADAM7
                       if samples[ys::dy, xs::dx].size)
    else:
        raw = _filter_rows(_pack(samples, depth), bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))) + early
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + extra + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


_LOCAL_CASES = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16), (3, 1), (3, 2),
                                                     (3, 4), (3, 8), (4, 8), (4, 16),
                                                     (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", _LOCAL_CASES)
def test_png_every_filter_colour_type_and_depth(tmp_path, rng, ctype, depth, interlace):
    n = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for h, w in ((13, 11), (1, 9), (9, 1), (29, 37)):
        samples = rng.integers(0, 1 << depth, (h, w, n))
        palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
        data = _png(samples, ctype, depth, rng, interlace, palette)
        _check(_write(tmp_path, f"l{h}x{w}.png", data))


def test_png_palette_short_and_transparent(tmp_path, rng):
    """A palette shorter than the indices (unlisted entries read black) and
    tRNS chunks, which cv2 drops with the alpha."""
    samples = rng.integers(0, 16, (20, 24, 1))
    short = rng.integers(0, 256, (10, 3))
    trns = _chunk(b"tRNS", bytes(range(0, 200, 20)))
    _check(_write(tmp_path, "pal.png", _png(samples, 3, 4, rng, palette=short, extra=trns)))
    gray = rng.integers(0, 256, (20, 24, 1))
    trns = _chunk(b"tRNS", struct.pack(">H", 7))
    _check(_write(tmp_path, "g.png", _png(gray, 0, 8, rng, extra=trns)))


@pytest.mark.parametrize("gamma", [45455, 30000, 97000, 220000, "sRGB"])
@pytest.mark.parametrize("ctype,depth", [(2, 8), (6, 8), (3, 8), (3, 4), (0, 8)])
def test_png_gamma_and_srgb_chunks(tmp_path, rng, gamma, ctype, depth):
    """libpng linearises 8-bit colour before its rgb_to_gray where the
    gamma is significant, and takes gAMA/sRGB only before PLTE and IDAT."""
    n = {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    samples = rng.integers(0, 1 << depth, (21, 26, n))
    samples[0] = samples[0, :, :1]   # a row of gray pixels (r == g == b)
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    chunk = (_chunk(b"sRGB", b"\x00") if gamma == "sRGB"
             else _chunk(b"gAMA", struct.pack(">I", gamma)))
    _check(_write(tmp_path, "early.png", _png(samples, ctype, depth, rng, palette=palette,
                                              early=chunk)))
    _check(_write(tmp_path, "late.png", _png(samples, ctype, depth, rng, palette=palette,
                                             extra=chunk)))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation(tmp_path, rng, orientation):
    smooth, noise = _scene(rng, 40, 56)
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(np.dstack([smooth, noise, 255 - smooth]).astype(np.uint8)).save(
        buf, "JPEG", exif=exif.tobytes())
    _check(_write(tmp_path, "o.jpg", buf.getvalue()), atol=2)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "1", "I;16"])
def test_png_written_by_pil(tmp_path, rng, mode):
    smooth, noise = _scene(rng)
    arrays = {"L": noise.astype(np.uint8),
              "RGB": np.dstack([smooth, noise, 255 - smooth]).astype(np.uint8),
              "RGBA": np.dstack([smooth, noise, smooth, noise]).astype(np.uint8),
              "LA": np.dstack([smooth, noise]).astype(np.uint8),
              "1": noise > 128,
              "I;16": (noise * 257).astype(np.uint16)}  # PIL writes a 16-bit gray PNG
    im = Image.fromarray(arrays[mode])
    buf = io.BytesIO()
    im.save(buf, "PNG")
    _check(_write(tmp_path, f"{mode}.png", buf.getvalue()))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_png_palette_written_by_pil(tmp_path, rng, bits):
    _, noise = _scene(rng)
    rgb = np.dstack([noise, noise[::-1], noise[:, ::-1]]).astype(np.uint8)
    im = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=1 << bits)
    buf = io.BytesIO()
    im.save(buf, "PNG", bits=bits)
    _check(_write(tmp_path, "p.png", buf.getvalue()))


@pytest.mark.parametrize("shape,dtype", [((45, 62), np.uint8), ((45, 62), np.uint16),
                                         ((45, 62, 3), np.uint8), ((45, 62, 3), np.uint16),
                                         ((45, 62, 4), np.uint8), ((45, 62, 4), np.uint16)])
def test_png_written_by_cv2(tmp_path, rng, shape, dtype):
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    _check(_write(tmp_path, "c.png", buf.tobytes()))


@pytest.mark.parametrize("kind", ["gray", "rgb", "interlaced", "two_frames"])
def test_gif(tmp_path, rng, kind):
    smooth, noise = _scene(rng)
    rgb = np.dstack([smooth, noise, 255 - smooth]).astype(np.uint8)
    buf = io.BytesIO()
    if kind == "gray":
        Image.fromarray(smooth.astype(np.uint8)).save(buf, "GIF")
    elif kind == "two_frames":
        frames = [Image.fromarray(rgb), Image.fromarray(rgb[::-1].copy())]
        frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:])
    else:
        Image.fromarray(rgb).save(buf, "GIF", interlace=kind == "interlaced")
    _check(_write(tmp_path, "g.gif", buf.getvalue()))


@pytest.mark.parametrize("kind", ["gray", "rgb420", "rgb422", "rgb444", "cv2_rgb",
                                  "cv2_rgb_restart", "odd_size"])
def test_jpeg_within_two_codes(tmp_path, rng, kind):
    smooth, noise = _scene(rng, 67, 93)
    nat = (smooth * 0.8 + noise * 0.2).astype(np.uint8)
    rgb = np.dstack([nat, smooth.astype(np.uint8), 255 - nat])
    buf = io.BytesIO()
    if kind == "gray":
        Image.fromarray(nat).save(buf, "JPEG", quality=90)
        data = buf.getvalue()
    elif kind.startswith("rgb"):
        sub = {"rgb420": 2, "rgb422": 1, "rgb444": 0}[kind]
        Image.fromarray(rgb).save(buf, "JPEG", quality=85, subsampling=sub)
        data = buf.getvalue()
    elif kind == "cv2_rgb":
        data = cv2.imencode(".jpg", rgb)[1].tobytes()
    elif kind == "cv2_rgb_restart":
        data = cv2.imencode(".jpg", rgb, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes()
        assert b"\xff\xdd" in data
    else:
        data = cv2.imencode(".jpg", rgb[:13, :9].copy())[1].tobytes()
    _check(_write(tmp_path, "j.jpg", data), atol=2)


def test_none_where_cv2_gives_none(tmp_path, rng):
    png = cv2.imencode(".png", rng.integers(0, 256, (30, 30)).astype(np.uint8))[1].tobytes()
    bad_crc = bytearray(png)
    bad_crc[40] ^= 0xFF   # inside IDAT
    cases = {"text.png": b"this is not an image at all", "empty.png": b"",
             "truncated.png": png[:60], "bad_crc.png": bytes(bad_crc),
             "not_a_gif.gif": b"GIF89a\x00", "not_a_jpeg.jpg": b"\xff\xd8\xff\xe0\x00"}
    for name, data in cases.items():
        path = _write(tmp_path, name, data)
        assert cv2.imread(path, FLAGS) is None, name
        assert imageio.imread_gray(path) is None, name
    assert imageio.imread_gray(str(tmp_path / "missing.png")) is None


def _dicom_cases(rng):
    mammo = rng.integers(0, 4096, (40, 36)).astype(np.uint16)
    return {"u16": (mammo, JD.TS_EXPLICIT_LE), "u8": ((mammo >> 4).astype(np.uint8),
                                                      JD.TS_EXPLICIT_LE),
            "frames": (np.stack([mammo, mammo[::-1]]), JD.TS_EXPLICIT_LE),
            "rle": (mammo, JD.TS_RLE), "sv1": (mammo, JD.TS_JPEG_LOSSLESS_SV1),
            "jls": (mammo, JD.TS_JPEG_LS), "j2k": (mammo, JD.TS_J2K_LOSSLESS),
            "htj2k": (mammo, JD.TS_HTJ2K_LOSSLESS)}


@pytest.mark.parametrize("case", ["u16", "u8", "frames", "rle", "sv1", "jls", "j2k", "htj2k",
                                  "signed"])
def test_dicom_reads_as_the_jax_front_reads_it(tmp_path, rng, case):
    path = str(tmp_path / "x.dcm")
    if case == "signed":
        img = rng.integers(0, 4096, (40, 36)).astype(np.uint16)
        TD.dcmwrite_minimal(path, img)
        data = bytearray(open(path, "rb").read())
        tag = struct.pack("<HH", 0x0028, 0x0103) + b"US" + struct.pack("<H", 2)
        at = data.index(tag) + len(tag)
        data[at:at + 2] = struct.pack("<H", 1)   # PixelRepresentation = 1
        open(path, "wb").write(bytes(data))
    else:
        img, ts = _dicom_cases(rng)[case]
        JD.dcmwrite_minimal(path, img, transfer_syntax=ts)
    want = jax_imread_gray(path)
    got = imageio.imread_gray(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
