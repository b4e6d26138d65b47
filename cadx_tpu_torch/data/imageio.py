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
  significant, 8-bit colour goes through its 8-bit tables (to linear,
  the sum rounded, back). 16-bit colour with such a gamma, and iCCP
  profiles, read as without one (ROADMAP, known gaps).
- GIF: the first frame, LZW, interlaced or not, on the logical screen;
  palette to gray as cv2.cvtColor's RGB2GRAY: (9798 R + 19235 G + 3735 B
  + 16384) >> 15.
- JPEG: baseline and extended sequential, through `data/jpg.py`'s
  `jpeg_luma_decode` (the Y plane of a colour file, libjpeg's grayscale
  output), within +-2 codes of libjpeg's integer IDCT, turned as its
  EXIF orientation says, as cv2.imread turns it.
- DICOM: `dicom.primary_frame(dicom.dcmread(path))`, uint8/uint16 kept,
  signed data shifted to start at 0, as the JAX front does.

What it cannot read gives None, as cv2.imread does.
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


class ImageError(ValueError):
    """Malformed or unsupported image file."""


def imread_gray(path: str) -> np.ndarray | None:
    """(H, W) uint8 or uint16 of any image the module reads, else None."""
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
            from cadx_tpu_torch.data.jpg import jpeg_luma_decode

            return _orient(jpeg_luma_decode(data)[0], _exif_orientation(data))
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
    """A PNG file's pixels as cv2's IMREAD_GRAYSCALE | IMREAD_ANYDEPTH."""
    chunks = _png_chunks(data)
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ImageError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ImageError(f"PNG colour type {ctype} at depth {depth}")
    if comp or filt or interlace > 1 or w == 0 or h == 0 or w * h > _MAX_PIXELS:
        raise ImageError("PNG header out of range")
    palette = None
    gamma = None   # the file's gamma, in libpng's units of 1e-5
    idat = []
    for kind, body in chunks:
        # libpng takes gAMA and sRGB only before PLTE and IDAT; sRGB's
        # gamma overrides gAMA's
        early = palette is None and not idat
        if kind == b"gAMA" and len(body) == 4 and gamma is None and early:
            gamma = struct.unpack(">I", body)[0] or None
        elif kind == b"sRGB" and early:
            gamma = 45455
        elif kind == b"PLTE":
            if len(body) % 3 or len(body) > 768:
                raise ImageError("bad PLTE")
            palette = np.zeros((256, 3), np.uint8)  # unlisted indices read black
            palette[:len(body) // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
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
    if ctype == 0:
        gray = samples[..., 0]
        return gray * np.uint8(255 // ((1 << depth) - 1)) if depth < 8 else gray
    if ctype == 4:
        return samples[..., 0]
    rgb = palette[samples[..., 0]] if ctype == 3 else samples[..., :3]
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
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
            tiff = seg[6:]
            bo = "<" if tiff[:2] == b"II" else ">"
            (ifd,) = struct.unpack_from(bo + "I", tiff, 4)
            (count,) = struct.unpack_from(bo + "H", tiff, ifd)
            for k in range(count):
                tag, kind, _, value = struct.unpack_from(bo + "HHIH", tiff, ifd + 2 + 12 * k)
                if tag == 0x0112 and kind == 3:
                    return value
        pos += 2 + n
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform: flips and transposes for orientations 2-8."""
    t = img.T
    return {2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1], 5: t, 6: t[:, ::-1],
            7: t[::-1, ::-1], 8: t[::-1]}.get(orientation, img).copy()


# ---- GIF ---------------------------------------------------------------------

def gif_gray(data: bytes) -> np.ndarray:
    """A GIF file's first frame, on its logical screen, as cv2's
    IMREAD_GRAYSCALE returns it."""
    sw, sh, packed, _bg, _aspect = struct.unpack_from("<HHBBB", data, 6)
    if sw == 0 or sh == 0 or sw * sh > _MAX_PIXELS:
        raise ImageError("GIF screen out of range")
    pos = 13
    table = None
    if packed & 0x80:
        n = 3 << ((packed & 7) + 1)
        table = np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3)
        pos += n
    while True:
        intro = data[pos]
        if intro == 0x21:  # extension: label, then sub-blocks
            _, pos = _gif_blocks(data, pos + 2)
        elif intro == 0x2C:
            break
        else:
            raise ImageError("GIF without an image")
    left, top, w, h, ipacked = struct.unpack_from("<HHHHB", data, pos + 1)
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
    rgb = np.zeros((sh, sw, 3), np.uint8)
    vis_h, vis_w = max(0, min(h, sh - top)), max(0, min(w, sw - left))
    rgb[top:top + vis_h, left:left + vis_w] = pal[idx[:vis_h, :vis_w]]
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + 16384) >> 15).astype(np.uint8)


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
