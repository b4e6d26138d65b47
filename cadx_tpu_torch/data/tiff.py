"""TIFF's first page in gray, as cv2.imread(path, IMREAD_GRAYSCALE |
IMREAD_ANYDEPTH) reads it through libtiff.

What is read: strips or tiles, planar configuration 1 (samples of a pixel
together) or 2 (a plane a sample); compression none (1), LZW (5; codes
MSB-first, the width growing one code early, as libtiff writes it),
Deflate (8 and 32946), PackBits (32773), the CCITT fax codes (2 Modified
Huffman, 3 T.4 1-D or 2-D, 4 T.6; `data/ccitt.py`) on 1-bit samples, and
JPEG (7; `data/jpg.py`, the JPEGTables of tag 347 read before each strip's
or tile's abbreviated stream); predictor 2 (horizontal differencing) at 8
and 16 bits under LZW and Deflate (libtiff ignores it elsewhere); fill
order 2 (tag 266: libtiff reverses each byte's bits before decoding,
except under JPEG, whose codec reads the bytes as stored); 1, 8 and
16-bit unsigned samples, 10, 12 and 14-bit gray and RGB ones, 4-bit
palette indices, 32-bit floats (sample format 3) and 32-bit integers;
photometric 0 (min-is-white), 1 (min-is-black), 2 (RGB, with or without an
alpha sample), 3 (palette) and 6 (YCbCr, under JPEG with contiguous
samples). cv2 refuses 2-bit samples and 4-bit ones without a palette, and
so does this reader.

What comes back follows cv2's paths:

- 1-8 bits: cv2 reads through libtiff's RGBA interface, so the samples
  go to 8 bits as libtiff maps them ((v * 255) // (2^bits - 1), inverted
  for min-is-white; a palette through its colour map, 16-bit entries
  shifted down 8 unless every entry is below 256), an unassociated alpha
  (extra sample 2) premultiplies the colour ((v * a + 127) // 255), and
  the RGB goes to gray as cv2's icvCvt_BGRA2Gray: (4899 R + 9617 G + 1868
  B + 8192) >> 14. uint8. Under JPEG, libtiff has libjpeg convert YCbCr
  (subsampled at tag 530's factors, upsampled as libjpeg does) to RGB and
  takes any other photometric's components as decoded.
- 16 bits: the samples as stored, gray kept (min-is-white not inverted,
  as cv2 copies them), RGB through the same 14-bit weights. uint16. Gray
  samples of 10, 12 and 14 bits are shifted up to 16, as cv2 shifts them;
  RGB ones go through the 14-bit weights as stored and the gray is
  shifted up to 16.
- 32 bits: one sample a pixel, float32, int32 or uint32 as stored; cv2
  refuses more.

Tag 274 (orientation) turns the image as cv2's EXIF transform turns it;
cv2 5.0 gives no image for orientations 5-8 (those that transpose) unless
the image is square, and neither does this reader. Old-style JPEG (6),
which no encoder here writes, YCbCr without JPEG and the rest of what
libtiff reads stay open: `tiff_gray` raises TiffError for them, and the
upload reader answers None. So do strips cv2 reads into memory it never
wrote (colour planes above 8 bits) and fax or JPEG data cut short (libtiff
then hands cv2 whatever its buffer held past the rows it decoded).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from cadx_tpu_torch.data.codecs import _packbits_decode

_MAX_PIXELS = 1 << 28  # the codecs' decode-size bound
# TIFF field types -> struct code
_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i",
          10: "ii", 11: "f", 12: "d"}
_OPEN_COMPRESSIONS = {6: "old-style JPEG"}
_FAX = (2, 3, 4)
_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))   # fill order 2


class TiffError(ValueError):
    """A TIFF this reader does not read."""


def _ifd(data: bytes) -> tuple[str, dict]:
    """The byte order and the first directory: tag -> tuple of values."""
    if len(data) < 8 or data[:4] not in (b"II*\x00", b"MM\x00*"):
        raise TiffError("not a classic TIFF")
    bo = "<" if data[:2] == b"II" else ">"
    (pos,) = struct.unpack_from(bo + "I", data, 4)
    (count,) = struct.unpack_from(bo + "H", data, pos)
    tags = {}
    for k in range(count):
        tag, kind, n = struct.unpack_from(bo + "HHI", data, pos + 2 + 12 * k)
        if kind not in _TYPES:
            continue
        code = _TYPES[kind]
        size = struct.calcsize(bo + code) * n if code != "s" else n
        at = pos + 10 + 12 * k
        if size > 4:
            (at,) = struct.unpack_from(bo + "I", data, at)
        if at + size > len(data):
            raise TiffError(f"tag {tag} outside the file")
        if code == "s":
            tags[tag] = (data[at:at + n],)
        else:
            tags[tag] = struct.unpack_from(bo + code * n, data, at)
    return bo, tags


def _one(tags: dict, tag: int, default=None):
    if tag in tags:
        return tags[tag][0]
    if default is None:
        raise TiffError(f"TIFF without tag {tag}")
    return default


def lzw_decode(data: bytes, limit: int) -> bytes:
    """TIFF's LZW: codes MSB-first from 9 to 12 bits, 256 clear and 257 end
    of information, the width growing when the table reaches one below a
    power of two (libtiff's early change); at most `limit` bytes out."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, prev = 9, None
    acc = nbits = 0
    pos, n = 0, len(data)
    while len(out) < limit:
        while nbits < width:
            if pos >= n:
                return bytes(out)
            acc = (acc << 8) | data[pos]
            pos += 1
            nbits += 8
        nbits -= width
        code = (acc >> nbits) & ((1 << width) - 1)
        acc &= (1 << nbits) - 1
        if code == 256:
            table = table[:258]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise TiffError("bad LZW code")
        out += entry
        prev = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _decompress(comp: int, chunk: bytes, size: int) -> bytes:
    if comp == 1:
        return chunk[:size]
    if comp == 5:
        return lzw_decode(chunk, size)
    if comp in (8, 32946):
        return zlib.decompressobj().decompress(chunk, size)
    if comp == 32773:
        return _packbits_decode(chunk, size)
    raise TiffError(f"TIFF compression {comp} ({_OPEN_COMPRESSIONS.get(comp, 'unknown')})")


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int, dtype) -> np.ndarray:
    """A strip's or tile's decoded bytes as (rows, cols, spp) samples; rows
    short of data are zero (libtiff's reads leave them so)."""
    row_bytes = (cols * spp * bits + 7) // 8
    buf = np.zeros(rows * row_bytes, np.uint8)
    got = np.frombuffer(raw, np.uint8)[:rows * row_bytes]
    buf[:len(got)] = got
    if bits % 8:        # packed MSB first
        bitrows = np.unpackbits(buf.reshape(rows, row_bytes), axis=1)
        bitrows = bitrows[:, :cols * spp * bits].reshape(rows, cols * spp, bits)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
        v = (bitrows * weights).sum(axis=2, dtype=np.uint16)
        return v.astype(dtype).reshape(rows, cols, spp)
    return buf.view(dtype).reshape(rows, cols, spp)


def _undo_predictor(a: np.ndarray, bits: int) -> np.ndarray:
    """Predictor 2: each sample is the difference from its left neighbour's
    same sample, modulo 2^bits."""
    if bits not in (8, 16):
        raise TiffError(f"TIFF predictor 2 at {bits} bits")
    return np.cumsum(a, axis=1, dtype=a.dtype)


def _jpeg_chunk(chunk: bytes, tags: dict, rows: int, cols: int, spp: int,
                last_strip: bool) -> np.ndarray:
    """A strip's or tile's JPEG stream (compression 7, after the JPEGTables
    of tag 347) as libtiff's JPEG codec gives it to TIFFReadRGBA*: YCbCr
    (photometric 6, contiguous) converted to RGB by libjpeg, anything else
    as the components decode, each upsampled to the stream's size.
    libtiff's checks: the components and precision the directory says,
    component 0 at the YCbCrSubsampling factors (1, 1 unless YCbCr) and
    the others at 1, 1; a stream of the strip's or tile's size (the last
    strip's may be taller: it is cut to the rows left)."""
    from cadx_tpu_torch.data.jpg import _read_frame, frame_planes

    tables = bytes(tags.get(347, ()))
    ycc = _one(tags, 262, 2 if spp >= 3 else 1) == 6 and _one(tags, 284, 1) == 1
    f, _ = _read_frame(chunk, tables, every=True)
    want = tuple(tags.get(530, (2, 2))) if ycc else (1, 1)
    if (len(f.comps) != spp or f.precision != 8 or f.sampling[0] != want[:2]
            or any(hv != (1, 1) for hv in f.sampling[1:])):
        raise TiffError("JPEG stream unlike its TIFF directory")
    if f.w != cols or f.h < rows or (f.h > rows and not last_strip):
        raise TiffError("JPEG stream of another size than its strip or tile")
    return np.stack(frame_planes(f, ycc), axis=-1)[:rows].astype(np.uint8)


def _pixels(data: bytes, bo: str, tags: dict, w: int, h: int, spp: int, bits: int,
            dtype) -> np.ndarray:
    """(h, w, spp) samples of the first page, in their stored type."""
    comp = _one(tags, 259, 1)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    reverse = _one(tags, 266, 1) == 2
    if predictor not in (1, 2):
        raise TiffError(f"TIFF predictor {predictor}")
    if comp in _FAX and (bits != 1 or spp != 1):
        raise TiffError("fax codes of more than one bit a pixel")
    if comp == 7 and bits != 8:
        raise TiffError(f"JPEG TIFF of {bits}-bit samples")
    if 322 in tags:
        cw, ch = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324, ()), tags.get(325, ())
    else:
        cw, ch = w, min(_one(tags, 278, 2 ** 32 - 1), h)
        offsets, counts = tags.get(273, ()), tags.get(279, ())
    if cw <= 0 or ch <= 0 or len(offsets) != len(counts):
        raise TiffError("TIFF strips or tiles out of range")
    planes = spp if planar == 2 else 1
    per_chunk = 1 if planar == 2 else spp
    across, down = -(-w // cw), -(-h // ch)
    if len(offsets) < across * down * planes:
        raise TiffError("TIFF with too few strips or tiles")
    out = np.zeros((h, w, spp), dtype)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                off, cnt = offsets[k], counts[k]
                k += 1
                chunk = data[off:off + cnt]
                # a strip holds only the rows left; a tile is always whole
                rows = ch if 322 in tags else min(ch, h - ty * ch)
                if comp == 7:       # libtiff's JPEG codec reads its bits as stored
                    a = _jpeg_chunk(chunk, tags, rows, cw, per_chunk,
                                    322 not in tags and ty == down - 1)
                else:
                    if reverse:     # libtiff reverses each byte's bits first
                        chunk = chunk.translate(_REVERSED)
                    if comp in _FAX:
                        from cadx_tpu_torch.data.ccitt import CcittError, ccitt_decode

                        try:
                            raw = ccitt_decode(chunk, cw, rows, comp, _one(tags, 292, 0))
                        except CcittError as e:
                            raise TiffError(str(e)) from e
                    else:
                        size = rows * ((cw * per_chunk * bits + 7) // 8)
                        raw = _decompress(comp, chunk, size)
                    a = _samples(raw, rows, cw, per_chunk, bits, dtype)
                    if predictor == 2 and comp in (5, 8, 32946):   # libtiff's codecs with one
                        a = _undo_predictor(a, bits)
                y0, x0 = ty * ch, tx * cw
                y1, x1 = min(y0 + rows, h), min(x0 + cw, w)
                dst = out[y0:y1, x0:x1]
                if planar == 2:
                    dst[..., p] = a[:y1 - y0, :x1 - x0, 0]
                else:
                    dst[...] = a[:y1 - y0, :x1 - x0]
    return out


def _gray14(r, g, b) -> np.ndarray:
    """cv2's icvCvt_BGRA2Gray with R and B swapped (libtiff's RGBA order):
    (4899 R + 9617 G + 1868 B + 8192) >> 14."""
    r, g, b = (np.asarray(c, np.int64) for c in (r, g, b))
    return (4899 * r + 9617 * g + 1868 * b + 8192) >> 14


def _rgba8(px: np.ndarray, tags: dict, photometric: int, bits: int, spp: int) -> np.ndarray:
    """libtiff's TIFFReadRGBA* of 1-8 bit samples, to gray as cv2 takes it."""
    v = px.astype(np.int64)
    top = (1 << bits) - 1
    extra = tags.get(338, ())
    if photometric in (0, 1):
        level = v[..., 0] * 255 // top
        return (255 - level if photometric == 0 else level).astype(np.uint8)
    if photometric == 3:
        cmap = np.asarray(tags.get(320, ()), np.int64)
        if len(cmap) != 3 * (1 << bits):
            raise TiffError("TIFF palette without its colour map")
        if cmap.max(initial=0) >= 256:
            cmap = cmap >> 8
        r, g, b = cmap.reshape(3, -1)
        idx = v[..., 0]
        return _gray14(r[idx], g[idx], b[idx]).astype(np.uint8)
    if photometric == 2 and spp >= 3:
        rgb = v[..., :3] * 255 // top
        if spp >= 4 and extra[:1] == (2,):   # unassociated alpha: premultiplied
            a = v[..., 3:4] * 255 // top
            rgb = (rgb * a + 127) // 255
        return _gray14(rgb[..., 0], rgb[..., 1], rgb[..., 2]).astype(np.uint8)
    raise TiffError(f"TIFF photometric {photometric} with {spp} samples")


def tiff_gray(data: bytes) -> np.ndarray | None:
    """The first page of a TIFF file as cv2.imread(IMREAD_GRAYSCALE |
    IMREAD_ANYDEPTH) reads it: uint8 (1-8 bits), uint16 (16 bits), float32,
    int32 or uint32 (32 bits); None where cv2 gives none (a transposing
    orientation of a non-square image). Raises TiffError for what the
    reader leaves open."""
    bo, tags = _ifd(data)
    w, h = _one(tags, 256), _one(tags, 257)
    bits_all = tags.get(258, (1,))
    bits = bits_all[0]
    spp = _one(tags, 277, 1)
    fmt = _one(tags, 339, 1)
    photometric = _one(tags, 262, 2 if spp >= 3 else 1)
    if w <= 0 or h <= 0 or w * h > _MAX_PIXELS or spp < 1 or any(b != bits for b in bits_all):
        raise TiffError("TIFF header out of range")
    if _one(tags, 266, 1) not in (1, 2):
        raise TiffError("TIFF fill order other than 1 or 2")
    if bits == 2 or (bits == 4 and photometric != 3):
        raise TiffError(f"{bits}-bit TIFF (cv2 reads 4 bits only through a palette)")
    comp = _one(tags, 259, 1)
    if photometric == 6 and not (comp == 7 and _one(tags, 284, 1) == 1):
        raise TiffError("YCbCr TIFF other than contiguous JPEG")
    if bits in (1, 4, 8) and fmt in (1, 2):
        px = _pixels(data, bo, tags, w, h, spp, bits, np.uint8)
        # libtiff's RGBA interface has libjpeg convert YCbCr to RGB
        img = _rgba8(px, tags, 2 if photometric == 6 else photometric, bits, spp)
    elif bits == 16 and fmt in (1, 2) and photometric in (0, 1, 2):
        px = _pixels(data, bo, tags, w, h, spp, bits, np.dtype(bo + "u2")).astype(np.uint16)
        if spp == 1:
            img = px[..., 0]
        elif _one(tags, 284, 1) == 2:
            # cv2 reads the first plane's strips as if they held whole
            # pixels and converts past their end: no image to match
            raise TiffError("16-bit TIFF of separate colour planes")
        elif spp >= 3:
            img = _gray14(px[..., 0], px[..., 1], px[..., 2]).astype(np.uint16)
        else:
            raise TiffError(f"16-bit TIFF with {spp} samples")
    elif bits in (10, 12, 14) and spp == 1 and fmt in (1, 2) and photometric in (0, 1):
        px = _pixels(data, bo, tags, w, h, 1, bits, np.uint16)[..., 0]
        img = (px << (16 - bits)).astype(np.uint16)
    elif bits in (10, 12, 14) and spp >= 3 and fmt in (1, 2) and photometric == 2:
        if _one(tags, 284, 1) == 2:
            # as at 16 bits: cv2 reads separate planes past their strips' ends
            raise TiffError(f"{bits}-bit TIFF of separate colour planes")
        # cv2 weighs the samples as stored, then shifts the gray up to 16 bits
        px = _pixels(data, bo, tags, w, h, spp, bits, np.uint16)
        img = (_gray14(px[..., 0], px[..., 1], px[..., 2]) << (16 - bits)).astype(np.uint16)
    elif bits == 32 and spp == 1 and fmt in (1, 2, 3):
        kind = {1: "u4", 2: "i4", 3: "f4"}[fmt]
        img = _pixels(data, bo, tags, w, h, 1, 32, np.dtype(bo + kind))[..., 0]
        img = img.astype(np.dtype(kind))
    else:
        raise TiffError(f"TIFF of {spp} x {bits}-bit samples, format {fmt}")
    orientation = _one(tags, 274, 1)
    if orientation in (5, 6, 7, 8) and w != h:
        return None
    t = img.T
    return np.ascontiguousarray({2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1], 5: t,
                                 6: t[:, ::-1], 7: t[::-1, ::-1], 8: t[::-1]}.get(orientation, img))
