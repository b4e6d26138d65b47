"""A grayscale image reader on numpy and zlib, for the HTTP front's uploads.

`imread_gray(path)` stands in for `cv2.imread(path, IMREAD_GRAYSCALE |
IMREAD_ANYDEPTH)`, the only image reader the JAX package's front has; the
machine with the card has neither cv2 nor PIL. The format is taken from
the file's first bytes, as cv2 takes it:

- PNG: bit depths 1-16; gray, gray + alpha, RGB, RGBA and palette; filters
  0-4; Adam7. Gray below 8 bits scales to 8 (x255, x85, x17) and 16 bits
  stay 16, as ANYDEPTH keeps them. Alpha is dropped. Colour goes to gray
  as libpng's `png_set_rgb_to_gray(1, 0.299, 0.587)` does it, in its
  fixed point: (9797 R + 19234 G + 3737 B) >> 15 at 8 bits, the same +
  16384 at 16; where a gAMA or sRGB chunk gives a gamma libpng counts as
  significant, colour goes through libpng's gamma tables (to linear, the
  sum rounded, back): its 8-bit tables, or at 16 bits its 16-bit ones,
  indexed with sBIT's shift. An eXIf chunk's orientation turns the image
  as cv2 turns a JPEG; an APNG reads as its IDAT image. iCCP profiles
  are ignored, as libpng ignores them.
- GIF: the first frame, LZW, interlaced or not, on the logical screen
  (`gif_gray`: cv2's background and transparency); palette to gray as
  cv2.cvtColor's RGB2GRAY: (9798 R + 19235 G + 3735 B + 16384) >> 15.
- JPEG: baseline, extended sequential and progressive, through
  `data/jpg.py`'s `jpeg_luma_decode` (libjpeg's grayscale output: the Y
  plane of YCbCr; RGB, CMYK and YCCK, subsampled or not, upsampled as
  libjpeg-turbo's jdsample.c does and converted as libjpeg and cv2
  convert them); 8-bit frames bit-exact through libjpeg's integer IDCT,
  12-bit ones within +-2 codes; lossless (SOF3) frames of 2-8 bits
  through `codecs.jpeg_lossless_decode`, exact (cv2 reads none above 8
  bits); either turned as its EXIF orientation says, as cv2.imread turns
  it.
- BMP (`bmp_gray`) and PBM/PGM/PPM (`pxm_gray`) as cv2's own decoders
  read them, and PAM (`pam_gray`), Sun raster (`ras_gray`), Radiance HDR
  (`hdr_gray`) and gray PFM (`pfm_gray`) likewise.
- TIFF (`data/tiff.py`): the first page, uint8, uint16 or float32 (and
  32-bit integers) as libtiff and cv2 give it, JPEG-compressed (with
  JPEGTables, YCbCr subsampled) and the CCITT fax codes (`data/ccitt.py`)
  included, and colour samples of 10-14 bits.
- WebP (`data/webp.py`): lossless (VP8L) and lossy (`data/vp8.py`, VP8 as
  libwebp decodes it, bit-exact), still or the first frame of an
  animation.
- JPEG 2000, JP2 boxes or a raw codestream, through `data/j2k.py`: exact
  on reversible streams, an irreversible (9/7) one within the DICOM J2K
  tests' tolerance of cv2's OpenJPEG decode.
- DICOM: `dicom.primary_frame(dicom.dcmread(path))`, uint8/uint16 kept,
  signed data shifted to start at 0, as the JAX front does.

What comes back is (H, W) uint8, uint16 or float32 (HDR, PFM, float
TIFF), as cv2 gives it. What it cannot read gives None, as cv2.imread
does. cv2 reads two more kinds that stay unread here (ROADMAP Queue 3):
AVIF, which needs an AV1 intra decoder, and arithmetic-coded JPEG
(SOF9-11), which no encoder here writes to hold a decoder against.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x start, y start, x step, y step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_MAX_PIXELS = 1 << 28  # the codecs' decode-size bound
_SPACE = b" \t\n\r\x0b\x0c"


class ImageError(ValueError):
    """Malformed or unsupported image file."""


def imread_gray(path: str) -> np.ndarray | None:
    """(H, W) uint8, uint16 or float32 (TIFF also int32 or uint32, as cv2
    gives them) of any image the module reads, else None: the dtype and
    values cv2.imread(path, IMREAD_GRAYSCALE | IMREAD_ANYDEPTH) gives."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        if data.startswith(_PNG_SIG):
            return png_gray(data)
        if data[:6] in (b"GIF87a", b"GIF89a"):
            return gif_gray(data)
        if data[:3] == b"\xff\xd8\xff":
            return _orient(jpeg_gray(data), _exif_orientation(data))
        if data[:2] == b"BM":
            return bmp_gray(data)
        if len(data) >= 3 and data[0] == 0x50 and 0x31 <= data[1] <= 0x36 and data[2] in _SPACE:
            return pxm_gray(data)
        if data[:4] in (b"II*\x00", b"MM\x00*"):
            from cadx_tpu_torch.data.tiff import tiff_gray

            return tiff_gray(data)
        if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
            from cadx_tpu_torch.data.webp import webp_gray

            return webp_gray(data)
        if data[:12] == _JP2_SIG or data[:4] == b"\xff\x4f\xff\x51":
            return jp2_gray(data)
        if data[:2] == b"P7":
            return pam_gray(data)
        if data[:4] == b"\x59\xa6\x6a\x95":
            return ras_gray(data)
        if data[:10] == b"#?RADIANCE" or data[:6] == b"#?RGBE":
            return hdr_gray(data)
        if data[:2] in (b"Pf", b"PF"):
            return pfm_gray(data)
    except Exception:  # noqa: BLE001 — unreadable upload -> None like cv2
        pass
    try:
        from cadx_tpu_torch.data import dicom

        # frame 0 of multi-frame files, rec601 luma of RGB: the 2D
        # pipeline's contract
        arr = dicom.primary_frame(dicom.dcmread(data))
        if arr.dtype in (np.uint8, np.uint16):
            return arr
        # signed pixel data (PixelRepresentation=1): shift to unsigned,
        # preserving relative intensities
        a = arr.astype(np.int32)
        a -= int(a.min())
        return np.clip(a, 0, 65535).astype(np.uint16)
    except Exception:  # noqa: BLE001 — unreadable upload -> None like cv2
        return None


# ---- PNG ---------------------------------------------------------------------

def png_gray(data: bytes) -> np.ndarray:
    """A PNG file's pixels as cv2's IMREAD_GRAYSCALE | IMREAD_ANYDEPTH,
    turned as its eXIf orientation says (an APNG reads as its IDAT
    image, the default image)."""
    chunks = _png_chunks(data)
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ImageError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ImageError(f"PNG colour type {ctype} at depth {depth}")
    if comp or filt or interlace > 1 or w == 0 or h == 0 or w * h > _MAX_PIXELS:
        raise ImageError("PNG header out of range")
    palette = None
    orientation = 1
    gamma = None   # the file's gamma, in libpng's units of 1e-5
    sig_bit = 0    # sBIT's most significant bits of a colour channel
    idat = []
    for kind, body in chunks:
        # libpng takes gAMA, sRGB and sBIT only before PLTE and IDAT; sRGB's
        # gamma overrides gAMA's
        early = palette is None and not idat
        if kind == b"gAMA" and len(body) == 4 and gamma is None and early:
            gamma = struct.unpack(">I", body)[0] or None
        elif kind == b"sRGB" and early:
            gamma = 45455
        elif kind == b"sBIT" and early and ctype in (2, 6) and len(body) >= 3:
            sig_bit = max(body[:3])
        elif kind == b"PLTE":
            if len(body) % 3 or len(body) > 768:
                raise ImageError("bad PLTE")
            palette = np.zeros((256, 3), np.uint8)  # unlisted indices read black
            palette[:len(body) // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":  # anywhere before IEND; libpng keeps a TIFF block
            try:
                orientation = _tiff_orientation(body)
            except struct.error:
                pass
    if ctype == 3 and palette is None:
        raise ImageError("palette PNG without PLTE")
    raw = zlib.decompress(b"".join(idat))
    nch = _CHANNELS[ctype]
    if interlace:
        samples = np.zeros((h, w, nch), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for xs, ys, dx, dy in _ADAM7:
            pw, ph = (w - xs + dx - 1) // dx, (h - ys + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            sub, off = _png_pass(raw, off, pw, ph, nch, depth)
            samples[ys::dy, xs::dx] = sub
    else:
        samples, _ = _png_pass(raw, 0, w, h, nch, depth)
    return _orient(_png_to_gray(samples, ctype, depth, palette, gamma, sig_bit), orientation)


def _png_to_gray(samples: np.ndarray, ctype: int, depth: int, palette, gamma, sig_bit: int):
    """(h, w, channels) samples -> gray as libpng's transforms under cv2
    give it: low-bit gray scaled to 8 bits, alpha dropped, colour through
    png_do_rgb_to_gray, with gamma tables where `gamma` is significant."""
    if ctype == 0:
        gray = samples[..., 0]
        return gray * np.uint8(255 // ((1 << depth) - 1)) if depth < 8 else gray
    if ctype == 4:
        return samples[..., 0]
    rgb = palette[samples[..., 0]] if ctype == 3 else samples[..., :3]
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    if depth == 16 and gamma is not None and _significant(gamma):
        # png_do_rgb_to_gray with libpng's 16-bit tables (png_build_16bit_table),
        # indexed by the value's low byte shifted by the insignificant bits
        # (from sBIT) and its high byte
        shift = min(16 - sig_bit, 8) if 0 < sig_bit < 16 else 0
        screen = _reciprocal(gamma)
        same = _gamma16_table(shift, int(math.floor(1e15 / gamma / screen + 0.5)))
        to_1, from_1 = _gamma16_table(shift, screen), _gamma16_table(shift, _reciprocal(screen))

        def look(table, v):
            return table[(v & 0xFF) >> shift, v >> 8]
        lin = (9797 * look(to_1, r) + 19234 * look(to_1, g) + 3737 * look(to_1, b)
               + 16384) >> 15
        return np.where((r == g) & (g == b), look(same, r), look(from_1, lin)).astype(np.uint16)
    if depth == 16:
        return ((9797 * r + 19234 * g + 3737 * b + 16384) >> 15).astype(np.uint16)
    if gamma is not None and _significant(gamma):
        # png_do_rgb_to_gray with gamma tables: gray pixels through the
        # file-to-screen table, others to linear, summed, and back
        screen = _reciprocal(gamma)
        to_1, from_1 = _gamma_table(screen), _gamma_table(_reciprocal(screen))
        same = _gamma_table(int(math.floor(1e15 / gamma / screen + 0.5)))
        lin = (9797 * to_1[r] + 19234 * to_1[g] + 3737 * to_1[b] + 16384) >> 15
        return np.where((r == g) & (g == b), same[r], from_1[lin]).astype(np.uint8)
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def _reciprocal(a: int) -> int:
    """libpng's png_reciprocal of a gamma in units of 1e-5."""
    return int(math.floor(1e10 / a + 0.5))


def _significant(gamma: int) -> bool:
    """libpng builds its gamma tables for rgb_to_gray when the file's
    gamma or the screen's (its reciprocal) is 5% or more from 1."""
    return any(abs(g - 100000) > 5000 for g in (gamma, _reciprocal(gamma)))


def _gamma_table(g: int) -> np.ndarray:
    """png_build_8bit_table: floor(255 (i / 255)^(g / 1e5) + 0.5)."""
    i = np.arange(256)
    if g == 100000:
        return i
    return np.floor(255 * np.power(i / 255.0, g * 1e-5) + 0.5).astype(np.int64)


def _gamma16_table(shift: int, g: int) -> np.ndarray:
    """png_build_16bit_table: (2^(8 - shift), 256) entries, [i][j] the
    output for the input whose top 16 - shift bits are (j << (8 - shift))
    + i: floor(65535 (ig / max)^(g / 1e5) + 0.5) where g is significant
    (5% or more from 1), else ig rescaled to 16 bits."""
    max_ig = (1 << (16 - shift)) - 1
    ig = (np.arange(256)[None, :] << (8 - shift)) + np.arange(1 << (8 - shift))[:, None]
    if abs(g - 100000) > 5000:
        return np.floor(65535.0 * np.power(ig * (1.0 / max_ig), g * 0.00001) + 0.5).astype(
            np.int64)
    return ig if shift == 0 else (ig * 65535 + (1 << (15 - shift))) // max_ig


def _png_chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    """(type, body) up to IEND; a critical chunk's CRC is checked, as
    libpng checks it."""
    out, pos = [], len(_PNG_SIG)
    while True:
        if pos + 12 > len(data):
            raise ImageError("truncated PNG")
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ImageError("truncated PNG chunk")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if kind[0] < 0x61 and zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ImageError(f"bad CRC in {kind!r}")
        pos += 12 + n
        if kind == b"IEND":
            return out
        out.append((kind, body))


def _png_pass(raw: bytes, off: int, w: int, h: int, nch: int, depth: int):
    """Unfilter one (sub)image of `raw` from `off` -> ((h, w, nch) samples,
    offset after it)."""
    stride = (w * nch * depth + 7) // 8
    bpp = max(1, nch * depth // 8)
    end = off + h * (stride + 1)
    if end > len(raw):
        raise ImageError("PNG image data too short")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1), off).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = _unsub(line, bpp)
        elif kind == 2:
            cur = line + prev
        elif kind == 3:
            cur = _unaverage(line, prev, bpp)
        elif kind == 4:
            cur = _unpaeth(line, prev, bpp)
        else:
            raise ImageError(f"PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    if depth == 16:
        flat = out.view(">u2").astype(np.uint16)
    elif depth == 8:
        flat = out
    else:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        flat = ((out[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, stride * per)
    return flat[:, :w * nch].reshape(h, w, nch), end


def _unsub(line: np.ndarray, bpp: int) -> np.ndarray:
    n = len(line)
    pad = (-n) % bpp
    x = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
    return np.cumsum(x, axis=0, dtype=np.uint8).reshape(-1)[:n]


def _unaverage(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(min(bpp, len(out))):
        out[i] = (out[i] + (up[i] >> 1)) & 0xFF
    for i in range(bpp, len(out)):
        out[i] = (out[i] + ((out[i - bpp] + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unpaeth(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(min(bpp, len(out))):  # a = c = 0: the predictor is b
        out[i] = (out[i] + up[i]) & 0xFF
    for i in range(bpp, len(out)):
        a, b, c = out[i - bpp], up[i], up[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
        out[i] = (out[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


# ---- JPEG orientation ----------------------------------------------------------

def _exif_orientation(data: bytes) -> int:
    """The orientation tag (0x0112) of a JPEG's EXIF APP1 segment, 1 where
    there is none."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF and data[pos + 1] not in (0xDA, 0xD9):
        (n,) = struct.unpack_from(">H", data, pos + 2)
        seg = data[pos + 4:pos + 2 + n]
        if data[pos + 1] == 0xE1 and seg[:6] == b"Exif\x00\x00" and len(seg) >= 14:
            return _tiff_orientation(seg[6:])
        pos += 2 + n
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112) in the first IFD of an EXIF block (a
    TIFF header, "II*\\0" or "MM\\0*", and its directory), 1 where there is
    none."""
    if tiff[:4] not in (b"II*\x00", b"MM\x00*") or len(tiff) < 8:
        return 1
    bo = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(bo + "I", tiff, 4)
    (count,) = struct.unpack_from(bo + "H", tiff, ifd)
    for k in range(count):
        tag, kind, _, value = struct.unpack_from(bo + "HHIH", tiff, ifd + 2 + 12 * k)
        if tag == 0x0112 and kind == 3:
            return value
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform: flips and transposes for orientations 2-8."""
    t = img.T
    return {2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1], 5: t, 6: t[:, ::-1],
            7: t[::-1, ::-1], 8: t[::-1]}.get(orientation, img).copy()


def _gray15(r, g, b) -> np.ndarray:
    """cv2.cvtColor's RGB to gray: (9798 R + 19235 G + 3735 B + 16384) >> 15."""
    r, g, b = (np.asarray(c, np.int64) for c in (r, g, b))
    return (9798 * r + 19235 * g + 3735 * b + 16384) >> 15


# ---- JPEG, lossless JPEG, JPEG 2000 -------------------------------------------

_JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"


def jpeg_gray(data: bytes) -> np.ndarray:
    """A JPEG's gray, unturned: a lossless (SOF3) frame through
    `codecs.jpeg_lossless_decode`, kept at its precision as cv2's 8-bit
    libjpeg reads it (2-8 bits, uint8; cv2 gives no image above 8 bits,
    nor does this reader), one component only; any other frame through
    `jpg.jpeg_luma_decode`."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xC3:
            from cadx_tpu_torch.data.codecs import jpeg_lossless_decode

            if not 2 <= data[pos + 4] <= 8:
                raise ImageError(f"lossless JPEG of {data[pos + 4]} bits")
            return jpeg_lossless_decode(data)[0].astype(np.uint8)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC) or marker == 0xDA:
            break
        (n,) = struct.unpack_from(">H", data, pos + 2)
        pos += 2 + n
    from cadx_tpu_torch.data.jpg import jpeg_luma_decode

    return jpeg_luma_decode(data)[0]


def jp2_gray(data: bytes) -> np.ndarray:
    """A JP2 file or a raw J2K codestream through `j2k.j2k_decode`, as cv2's
    OpenJPEG reader gives it in gray: one component as decoded (uint8 up
    to 8 bits, else uint16), three or more through cvtColor's 15-bit
    weights on the first three, R first."""
    from cadx_tpu_torch.data.j2k import j2k_decode

    img = j2k_decode(data)
    if img.ndim == 2:
        return img
    return _gray15(img[..., 0], img[..., 1], img[..., 2]).astype(img.dtype)


# ---- GIF ---------------------------------------------------------------------

def gif_gray(data: bytes) -> np.ndarray:
    """A GIF file's first frame, on its logical screen, as cv2's
    IMREAD_GRAYSCALE returns it: the screen starts as the global table's
    background colour (black without a global table; a background index
    past the table reads as nothing), the frame must lie within it, and
    its transparent index (from the graphic control extension) leaves
    the background."""
    sw, sh, packed, bg, _aspect = struct.unpack_from("<HHBBB", data, 6)
    if sw == 0 or sh == 0 or sw * sh > _MAX_PIXELS:
        raise ImageError("GIF screen out of range")
    pos = 13
    table = None
    background = np.zeros(3, np.uint8)
    if packed & 0x80:
        n = 3 << ((packed & 7) + 1)
        table = np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3)
        pos += n
        if bg >= len(table):
            raise ImageError("GIF background index past the global table")
        background = table[bg]
    transparent = None
    while True:
        intro = data[pos]
        if intro == 0x21:  # extension: label, then sub-blocks
            body, end = _gif_blocks(data, pos + 2)
            if data[pos + 1] == 0xF9 and len(body) >= 4:  # graphic control
                transparent = body[3] if body[0] & 1 else None
            pos = end
        elif intro == 0x2C:
            break
        else:
            raise ImageError("GIF without an image")
    left, top, w, h, ipacked = struct.unpack_from("<HHHHB", data, pos + 1)
    if w == 0 or h == 0 or left + w > sw or top + h > sh:
        raise ImageError("GIF frame outside its screen")
    pos += 10
    if ipacked & 0x80:
        n = 3 << ((ipacked & 7) + 1)
        table = np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3)
        pos += n
    if table is None:
        raise ImageError("GIF without a colour table")
    min_code = data[pos]
    if not 2 <= min_code <= 11:
        raise ImageError("bad LZW code size")
    stream, _ = _gif_blocks(data, pos + 1)
    idx = np.frombuffer(_lzw_decode(stream, min_code, w * h), np.uint8)
    if len(idx) < w * h:
        raise ImageError("GIF image data too short")
    idx = idx[:w * h].reshape(h, w)
    if ipacked & 0x40:  # interlaced: rows in passes of 8, 8, 4, 2
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        deinterlaced = np.empty_like(idx)
        deinterlaced[order] = idx
        idx = deinterlaced
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(table)] = table
    rgb = np.empty((sh, sw, 3), np.uint8)
    rgb[:] = background
    frame = rgb[top:top + h, left:left + w]
    drawn = idx != transparent if transparent is not None else slice(None)
    frame[drawn] = pal[idx[drawn]]
    return _gray15(rgb[..., 0], rgb[..., 1], rgb[..., 2]).astype(np.uint8)


def _gif_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """Concatenated data sub-blocks from `pos` up to the 0 terminator."""
    parts = []
    while True:
        n = data[pos]
        if n == 0:
            return b"".join(parts), pos + 1
        parts.append(data[pos + 1:pos + 1 + n])
        if pos + 1 + n > len(data):
            raise ImageError("truncated GIF block")
        pos += 1 + n


def _lzw_decode(stream: bytes, min_code: int, limit: int) -> bytes:
    """GIF's variable-width LSB-first LZW, up to `limit` output bytes."""
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    out = bytearray()
    acc = nbits = 0
    width = min_code + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    prev = None
    it = iter(stream)
    while len(out) < limit:
        while nbits < width:
            try:
                acc |= next(it) << nbits
            except StopIteration:
                return bytes(out)
            nbits += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        if code == clear:
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            width, prev = min_code + 1, None
            continue
        if code == eoi:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ImageError("bad LZW code")
        out += entry
        prev = entry
        if len(table) == (1 << width) and width < 12:
            width += 1
    return bytes(out)


# ---- BMP ---------------------------------------------------------------------

_CB, _CG, _CR = 1868, 9617, 4899   # cv2's BGR -> gray weights at 14 bits


def _gray14(b, g, r) -> np.ndarray:
    """cv2's icvCvt_BGR2Gray: 14-bit weights, rounded."""
    t = _CB * b.astype(np.int64) + _CG * g.astype(np.int64) + _CR * r.astype(np.int64)
    return ((t + (1 << 13)) >> 14).astype(np.uint8)


def bmp_gray(data: bytes) -> np.ndarray:
    """A BMP file as cv2's built-in BmpDecoder reads it in gray: 1, 4 and 8
    bits through the palette's gray (entries past the palette read 0), RLE8
    and RLE4 (`_rle8`, `_rle4`: cv2's fills with entry 0, its wraps and its
    refusals), 15/16 bits as 555 (or 565 with BITFIELDS masks, read after
    the header), 24 and 32 bits as BGR(A); a 32-bit BITFIELDS file with a
    header of 56 bytes or more goes through its masks, each channel scaled
    by 255 over its maximum and the sum truncated. A positive height is
    bottom-up; OS/2 headers (12 bytes) take 3-byte palette entries. The
    masked path's gray is float32, 0.299 R + 0.587 G then + 0.114 B,
    truncated."""
    if len(data) < 26:
        raise ImageError("truncated BMP")
    (offset,) = struct.unpack_from("<I", data, 10)
    (size,) = struct.unpack_from("<I", data, 14)
    masks = None
    pos = 14 + size
    if size >= 36:
        w, h, _planes, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
        (clrused,) = struct.unpack_from("<I", data, 46)
        if comp > 3:
            raise ImageError(f"BMP compression {comp}")
        if bpp == 32 and comp == 3 and size >= 56:
            masks = struct.unpack_from("<4I", data, 54)
        if bpp <= 8:
            if clrused > 256:
                raise ImageError("BMP palette of more than 256 colours")
            n = clrused or 1 << bpp
            pal = np.zeros((256, 4), np.uint8)
            pal[:n] = np.frombuffer(data, np.uint8, 4 * n, pos).reshape(n, 4)
        elif bpp == 16 and comp == 3:
            r, g, b = struct.unpack_from("<3I", data, pos)
            if (r, g, b) == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif (r, g, b) != (0xF800, 0x7E0, 0x1F):
                raise ImageError("BMP 16-bit masks other than 555 and 565")
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
        comp = 0
        if bpp <= 8:
            n = 1 << bpp
            pal = np.zeros((256, 4), np.uint8)
            pal[:n, :3] = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
    else:
        raise ImageError(f"BMP header of {size} bytes")
    ok = w > 0 and h != 0 and (
        (bpp in (1, 4, 8, 15, 16, 24, 32) and comp == 0) or (bpp in (15, 16, 32) and comp == 3)
        or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1))
    if not ok or w * abs(h) > _MAX_PIXELS:
        raise ImageError(f"BMP of {bpp} bits, compression {comp}, {w}x{h}")
    rows_h = abs(h)
    if bpp <= 8:
        gray_pal = _gray14(pal[:, 0], pal[:, 1], pal[:, 2])
    if comp in (1, 2):
        idx = (_rle8 if comp == 1 else _rle4)(data, offset, w, rows_h)
        img = gray_pal[idx]
    else:
        stride = (w * (16 if bpp == 15 else bpp) + 31) // 32 * 4
        if offset + stride * rows_h > len(data):
            raise ImageError("BMP pixel data too short")
        rows = np.frombuffer(data, np.uint8, stride * rows_h, offset).reshape(rows_h, stride)
        if bpp <= 8:
            bits = np.unpackbits(rows, axis=1) if bpp < 8 else rows
            if bpp == 4:
                bits = np.stack([rows >> 4, rows & 15], axis=-1).reshape(rows_h, -1)
            img = gray_pal[bits[:, :w]]
        elif bpp in (15, 16):
            t = rows[:, :2 * w].view("<u2").astype(np.int64)
            if bpp == 15:
                img = _gray14((t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8)
            else:
                img = _gray14((t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8)
        else:
            px = rows[:, :w * bpp // 8].reshape(rows_h, w, bpp // 8)
            if masks is not None and all(masks[:3]):
                word = px.view("<u4")[..., 0].astype(np.int64)
                b, g, r = (_mask_channel(word, m) for m in (masks[2], masks[1], masks[0]))
                f32 = np.float32
                img = (f32(0.299) * r + f32(0.587) * g + f32(0.114) * b).astype(np.uint8)
            else:
                img = _gray14(px[..., 0], px[..., 1], px[..., 2])
    return np.ascontiguousarray(img[::-1] if h > 0 else img)


def _mask_channel(word: np.ndarray, mask: int) -> np.ndarray:
    """A BITFIELDS channel scaled to 8 bits as cv2 scales it: value * 255 //
    its maximum, as float32."""
    shift = (mask & -mask).bit_length() - 1
    return (((word & mask) >> shift) * 255 // (mask >> shift)).astype(np.float32)


def _rle8(data: bytes, pos: int, w: int, h: int) -> np.ndarray:
    """cv2's BMP RLE8 decode into (h, w) palette indices, line 0 first: a
    run or an absolute run may not pass its line's end; a run that ends on
    it moves to the next line, where an end of line right after it is
    skipped; end of line, delta (dx + dy lines) and end of bitmap fill
    with entry 0; the data must reach the last line."""
    out = np.zeros(h * w, np.int64)
    x = y = 0
    wrapped = False

    def fill(count: int) -> None:   # cv2's FillUniGray with entry 0
        nonlocal x, y
        while True:
            take = min(count, w - x)
            x += take
            count -= take
            if x >= w:
                x, y = 0, y + 1
                if y >= h:
                    return
            if count <= 0:
                return

    while y < h:
        if pos + 2 > len(data):
            raise ImageError("BMP RLE8 data too short")
        n, code = data[pos], data[pos + 1]
        pos += 2
        if n:
            if x + n > w:
                raise ImageError("BMP RLE8 run past its line")
            out[y * w + x:y * w + x + n] = code
            x += n
            wrapped = x == w
            if wrapped:
                x, y = 0, y + 1
        elif code > 2:
            if x + code > w or pos + code > len(data):
                raise ImageError("BMP RLE8 absolute run past its line")
            out[y * w + x:y * w + x + code] = np.frombuffer(data, np.uint8, code, pos)
            pos += (code + 1) & ~1
            x += code
            wrapped = False
        else:
            if code or not wrapped or x > 0:
                shift = w - x
                if code == 2:
                    if pos + 2 > len(data):
                        raise ImageError("BMP RLE8 data too short")
                    shift, dy = data[pos], data[pos + 1]
                    pos += 2
                    shift += dy * w
                elif code == 1:
                    shift += (h - y) * w
                fill(shift)
            wrapped = False
    return out.reshape(h, w)


def _rle4(data: bytes, pos: int, w: int, h: int) -> np.ndarray:
    """cv2's BMP RLE4 decode into (h, w) palette indices, line 0 first: runs
    (two alternating nibbles) and absolute runs may not pass their line's
    end and never leave it; only escapes move on: end of line and end of
    bitmap fill the rest of the line with entry 0, delta fills dx pixels
    (cv2 drops its dy); the data must reach the last line."""
    out = np.zeros(h * w, np.int64)
    x = y = 0
    while y < h:
        if pos + 2 > len(data):
            raise ImageError("BMP RLE4 data too short")
        n, code = data[pos], data[pos + 1]
        pos += 2
        if n:
            if x + n > w:
                raise ImageError("BMP RLE4 run past its line")
            out[y * w + x:y * w + x + n] = np.resize([code >> 4, code & 15], n)
            x += n
        elif code > 2:
            size = (((code + 1) >> 1) + 1) & ~1
            if x + code > w or pos + size > len(data):
                raise ImageError("BMP RLE4 absolute run past its line")
            nib = np.frombuffer(data, np.uint8, size, pos)
            out[y * w + x:y * w + x + code] = np.stack([nib >> 4, nib & 15], -1).reshape(-1)[:code]
            pos += size
            x += code
        else:
            count = w - x
            if code == 2:
                if pos + 2 > len(data):
                    raise ImageError("BMP RLE4 data too short")
                count = data[pos]
                pos += 2
            while True:   # cv2's FillUniGray with entry 0
                take = min(count, w - x)
                x += take
                count -= take
                if x >= w:
                    x, y = 0, y + 1
                    if y >= h:
                        break
                if count <= 0:
                    break
    return out.reshape(h, w)


# ---- PBM, PGM, PPM -----------------------------------------------------------

def pxm_gray(data: bytes) -> np.ndarray:
    """A PBM, PGM or PPM file (P1-P6) as cv2's PxMDecoder reads it in gray
    with ANYDEPTH: bitmaps 1 -> 0 and 0 -> 255; maxval above 255 gives
    uint16 samples (big-endian in binary files); ASCII samples are clamped
    to maxval and, at 8 bits, scaled by 255 / maxval (floor), binary ones
    kept as they are; colour goes to gray with cv2's RGB weights (rounded,
    at 16 bits too). A number must end before the end of the file."""
    kind = data[1] - ord("0")
    pos = 2
    w, pos = _pxm_number(data, pos)
    h, pos = _pxm_number(data, pos)
    maxval = 1
    if kind not in (1, 4):
        maxval, pos = _pxm_number(data, pos)
    if w <= 0 or h <= 0 or not 0 < maxval < 65536 or w * h > _MAX_PIXELS:
        raise ImageError("PxM header out of range")
    channels = 3 if kind in (3, 6) else 1
    n = w * h * channels
    wide = maxval > 255
    if kind == 4:
        stride = (w + 7) // 8
        if pos + stride * h > len(data):
            raise ImageError("PBM data too short")
        bits = np.unpackbits(np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride),
                             axis=1)[:, :w]
        return np.where(bits == 1, 0, 255).astype(np.uint8)
    if kind in (5, 6):
        dtype = np.dtype(">u2") if wide else np.dtype(np.uint8)
        if pos + n * dtype.itemsize > len(data):
            raise ImageError("PxM data too short")
        v = np.frombuffer(data, dtype, n, pos).astype(np.int64)
    else:
        v = np.empty(n, np.int64)
        for i in range(n):
            v[i], pos = _pxm_number(data, pos, kind == 1)
        if kind == 1:
            return np.where(v.reshape(h, w) != 0, 0, 255).astype(np.uint8)
        v = np.minimum(v, maxval)
        if not wide:
            v = v * 255 // maxval
    v = v.reshape(h, w, channels)
    if channels == 3:
        t = _CR * v[..., 0] + _CG * v[..., 1] + _CB * v[..., 2]
        v = (t + (1 << 13)) >> 14
    else:
        v = v[..., 0]
    return v.astype(np.uint16 if wide else np.uint8)


def _pxm_number(data: bytes, pos: int, one_digit: bool = False) -> tuple[int, int]:
    """cv2's ReadNumber: skip whitespace and '#' comments, read digits (one
    for an ASCII bitmap), and the byte after them, which must exist."""
    n = len(data)
    while True:
        if pos >= n:
            raise ImageError("PxM data too short")
        c = data[pos]
        if c == 0x23:   # '#': to the end of the line
            while pos < n and data[pos] not in (0x0A, 0x0D):
                pos += 1
            pos += 1
        elif c in _SPACE:
            pos += 1
        elif 0x30 <= c <= 0x39:
            break
        else:
            raise ImageError("PxM: not a number")
    val = 0
    while pos < n and 0x30 <= data[pos] <= 0x39:
        val = val * 10 + data[pos] - 0x30
        pos += 1
        if one_digit:
            return val, pos
        if val > 0x7FFFFFFF:
            raise ImageError("PxM number too large")
    if pos >= n:
        raise ImageError("PxM data too short")
    return val, pos + 1


# ---- PAM ---------------------------------------------------------------------

_PAM_FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")
# TUPLTYPE -> the DEPTH cv2 requires of it
_PAM_TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
                  b"RGB_ALPHA": 4}


def _pam_int(text: bytes) -> int:
    """cv2's ParseInt: decimal digits, spaces around them allowed."""
    t = text.strip(_SPACE)
    if not t.isdigit():
        raise ImageError("PAM: not a number")
    return int(t)


def pam_gray(data: bytes) -> np.ndarray | None:
    """A PAM (P7) file as cv2's PAMDecoder reads it in gray with ANYDEPTH:
    the WIDTH, HEIGHT, DEPTH, MAXVAL, ENDHDR header (each once, decimal
    numbers; TUPLTYPE, if any, one of cv2's five and matching
    DEPTH; without it DEPTH 1 or 3 at MAXVAL below 256); MAXVAL above 255
    gives big-endian uint16 samples, kept as stored (no scaling to MAXVAL).
    DEPTH 1 reads as it is; RGB through cv2's 14-bit weights (R first);
    GRAYSCALE_ALPHA and RGB_ALPHA through cv2's basic_conversion, which
    writes sample DEPTH (j // 3) of a row to its column j while it reads
    the row's first W samples: at DEPTH 2 past the row's end (cv2 then
    writes past its image's buffer), at DEPTH 4 short of it, leaving the
    columns from 3 ceil(W / 4) on unwritten (this reader gives 0 there,
    cv2 whatever its buffer held); MAXVAL 1 reads each row's bytes as
    packed bits, 0 and 255, as cv2's bit mode does."""
    if len(data) < 3 or data[:2] != b"P7" or data[2] not in (0x0A, 0x0D):
        raise ImageError("not a PAM")
    pos, n = 3, len(data)
    fields: dict[bytes, bytes] = {}
    while b"ENDHDR" not in fields:
        while pos < n and data[pos] in _SPACE:
            pos += 1
        if pos >= n:
            raise ImageError("PAM header too short")
        if data[pos] == 0x23:    # '#': to the end of the line
            while pos < n and data[pos] not in (0x0A, 0x0D):
                pos += 1
            pos += 1
            continue
        start = pos
        while pos < n and data[pos] not in _SPACE:
            pos += 1
        ident = data[start:pos]
        if ident not in _PAM_FIELDS or ident in fields or pos >= n:
            raise ImageError("bad PAM header field")
        end = data[pos]
        pos += 1
        value = b""
        if end not in (0x0A, 0x0D):
            while pos < n and data[pos] in _SPACE:
                pos += 1
            start = pos
            while pos < n and data[pos] not in (0x0A, 0x0D):
                pos += 1
            value = data[start:pos]
            pos += 1
        fields[ident] = value
    if not all(f in fields for f in _PAM_FIELDS if f != b"TUPLTYPE"):
        raise ImageError("PAM header without a required field")
    w, h = _pam_int(fields[b"WIDTH"]), _pam_int(fields[b"HEIGHT"])
    depth, maxval = _pam_int(fields[b"DEPTH"]), _pam_int(fields[b"MAXVAL"])
    tupl = fields[b"TUPLTYPE"].strip(_SPACE) if b"TUPLTYPE" in fields else None
    if tupl is None:
        if depth not in (1, 3) or maxval >= 256:
            raise ImageError("PAM without TUPLTYPE")
        tupl = b"GRAYSCALE" if depth == 1 else b"RGB"
    if _PAM_TUPLTYPES.get(tupl) != depth:
        raise ImageError(f"PAM TUPLTYPE {tupl!r} at DEPTH {depth}")
    if w <= 0 or h <= 0 or not 0 <= maxval <= 65535 or w * h > _MAX_PIXELS:
        raise ImageError("PAM header out of range")
    wide = maxval > 255
    size = w * h * depth * (2 if wide else 1)
    if pos + size > n:
        raise ImageError("PAM data too short")
    raw = data[pos:pos + size]
    if maxval == 1:      # bit mode: a row's bytes read as packed bits
        rows = np.frombuffer(raw, np.uint8).reshape(h, w * depth)
        return np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    v = np.frombuffer(raw, ">u2" if wide else np.uint8).reshape(h, w, depth).astype(np.int64)
    if depth == 1:
        out = v[..., 0]
    elif depth == 3:
        out = (_CR * v[..., 0] + _CG * v[..., 1] + _CB * v[..., 2] + (1 << 13)) >> 14
    else:
        flat = v.reshape(h, w * depth)
        cols = np.arange(w)
        src = depth * (cols // 3)
        out = np.where(src < w, flat[:, np.minimum(src, w - 1)], 0)
    return out.astype(np.uint16 if wide else np.uint8)


# ---- Sun raster ------------------------------------------------------------------

def ras_gray(data: bytes) -> np.ndarray:
    """A Sun raster file as cv2's SunRasterDecoder reads it in gray: depths
    1, 8, 24 and 32 of types old (0) and standard (1) (cv2 5.0 refuses the
    byte-encoded and RGB types); no colour map, or an RGB one of at most
    2^depth entries at depths 1 and 8. Depths 1 and 8 go through the map's
    gray (cv2's 14-bit weights; entries past the map 0); without a map cv2's
    gray table stays zero, so every pixel reads 0. 24 bits are BGR, 32 bits
    XBGR, gray with the same weights. Rows are padded to 16 bits."""
    if len(data) < 32:
        raise ImageError("truncated Sun raster")
    _, w, h, depth, _, kind, maptype, maplen = struct.unpack_from(">8I", data, 0)
    pal_size = 3 << depth if 0 < depth <= 8 else 0
    if w <= 0 or h <= 0 or depth not in (1, 8, 24, 32) or w * h > _MAX_PIXELS:
        raise ImageError("Sun raster header out of range")
    if kind not in (0, 1):
        raise ImageError(f"Sun raster type {kind}")
    if not ((maptype == 0 and maplen == 0)
            or (maptype == 1 and 0 < maplen <= pal_size and depth <= 8)):
        raise ImageError("Sun raster colour map")
    pos = 32
    gray_pal = np.zeros(256, np.uint8)
    if maplen:
        if pos + maplen > len(data):
            raise ImageError("Sun raster colour map too short")
        k = maplen // 3
        cmap = np.frombuffer(data, np.uint8, 3 * k, pos).reshape(3, k)  # R, G, B planes
        gray_pal[:k] = _gray14(cmap[2], cmap[1], cmap[0])
        pos += maplen
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    if pos + pitch * h > len(data):
        raise ImageError("Sun raster data too short")
    rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
    if depth == 1:
        return gray_pal[np.unpackbits(rows, axis=1)[:, :w]]
    if depth == 8:
        return gray_pal[rows[:, :w]]
    px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)[..., depth // 8 - 3:]
    return _gray14(px[..., 0], px[..., 1], px[..., 2])


# ---- Radiance HDR and PFM ------------------------------------------------------

def _gray_f32(r, g, b) -> np.ndarray:
    """cv2.cvtColor's RGB to gray on float32 channels: 0.299 R + 0.587 G +
    0.114 B in float32 (cv2 may fuse the products, so the two agree to a
    float32 rounding of the sum)."""
    f = np.float32
    return (b * f(0.114) + g * f(0.587) + r * f(0.299)).astype(np.float32)


def hdr_gray(data: bytes) -> np.ndarray:
    """A Radiance RGBE file as cv2's HdrDecoder reads it in gray: "#?RADIANCE"
    or "#?RGBE", header lines up to an empty one, among them
    "FORMAT=32-bit_rle_rgbe" (cv2 refuses a header without it), then "-Y H
    +X W"; scanlines flat or new-style RLE
    (2 2 and the width, then each of the four channels as runs: n > 128
    repeats the next byte n - 128 times, else n bytes follow), flat where W
    is under 8 or over 32767 or a scanline does not start 2 2; each pixel
    m * 2^(e - 136), 0 where e = 0 (rgbe.c's rgbe2float, no 0.5 offset);
    gray from R, G, B as cvtColor takes it. (H, W) float32."""
    end = data.find(b"\n\n")
    if end < 0 or b"FORMAT=32-bit_rle_rgbe" not in data[:end].split(b"\n")[1:]:
        raise ImageError("HDR header without FORMAT=32-bit_rle_rgbe")
    pos = end + 2
    nl = data.find(b"\n", pos)
    dims = data[pos:nl].split() if nl >= 0 else []
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise ImageError("HDR without -Y H +X W")
    h, w = int(dims[1]), int(dims[3])
    if w <= 0 or h <= 0 or w * h > _MAX_PIXELS:
        raise ImageError("HDR size out of range")
    pos = nl + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    flat_from = None     # the first pixel read flat
    if w < 8 or w > 0x7FFF:
        flat_from = 0
    else:
        for y in range(h):
            head = data[pos:pos + 4]
            if len(head) < 4:
                raise ImageError("HDR data too short")
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                flat_from = y * w
                break
            if (head[2] << 8 | head[3]) != w:
                raise ImageError("HDR scanline of the wrong width")
            pos += 4
            for ch in range(4):
                x = 0
                while x < w:
                    if pos + 2 > len(data):
                        raise ImageError("HDR data too short")
                    count = data[pos]
                    if count > 128:
                        count -= 128
                        if count > w - x:
                            raise ImageError("bad HDR scanline data")
                        rgbe[y, x:x + count, ch] = data[pos + 1]
                        pos += 2
                    else:
                        if count == 0 or count > w - x or pos + 1 + count > len(data):
                            raise ImageError("bad HDR scanline data")
                        rgbe[y, x:x + count, ch] = np.frombuffer(data, np.uint8, count, pos + 1)
                        pos += 1 + count
                    x += count
    if flat_from is not None:
        need = (h * w - flat_from) * 4
        if pos + need > len(data):
            raise ImageError("HDR data too short")
        rgbe.reshape(-1, 4)[flat_from:] = np.frombuffer(data, np.uint8, need, pos).reshape(-1, 4)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    c = [rgbe[..., i].astype(np.float32) * scale for i in range(3)]
    return _gray_f32(c[0], c[1], c[2])


def _pfm_token(data: bytes, pos: int) -> tuple[bytes, int]:
    """cv2's read_number: the bytes up to the next whitespace, which is
    consumed."""
    end = pos
    while end < len(data) and data[end] not in _SPACE:
        end += 1
    if end >= len(data):
        raise ImageError("PFM header too short")
    return data[pos:end], end + 1


def pfm_gray(data: bytes) -> np.ndarray:
    """A PFM file as cv2's PFMDecoder reads it in gray: "Pf" and a line
    break, then width, height and scale, each ended by one whitespace byte;
    float32 samples, little-endian where the scale is negative, rows bottom
    up, times 1 / |scale| in float32. A colour file ("PF") gives no image
    (cv2 cannot convert it to one channel), nor does any other."""
    if data[:3] != b"Pf\n":
        raise ImageError("not a gray PFM")
    tok, pos = _pfm_token(data, 3)
    w = int(tok) if tok.isdigit() else 0
    tok, pos = _pfm_token(data, pos)
    h = int(tok) if tok.isdigit() else 0
    tok, pos = _pfm_token(data, pos)
    scale = float(tok)
    if w <= 0 or h <= 0 or scale == 0 or w * h > _MAX_PIXELS:
        raise ImageError("PFM header out of range")
    if pos + 4 * w * h > len(data):
        raise ImageError("PFM data too short")
    v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h, pos).reshape(h, w)[::-1]
    return (v.astype(np.float32) * np.float32(1.0 / abs(scale))).astype(np.float32)
