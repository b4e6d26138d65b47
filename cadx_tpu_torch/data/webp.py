"""WebP to gray, as cv2.imread(path, IMREAD_GRAYSCALE | IMREAD_ANYDEPTH)
reads it.

The container is `RIFF....WEBP` with a `VP8L` (lossless) or `VP8 ` (lossy)
chunk, directly or after a `VP8X` header (an `ALPH` chunk beside a lossy
image does not change the gray); an animation reads as its first frame on
a canvas of zeros, as cv2's WebPAnimDecoder path gives it. Lossy frames go
to `data/vp8.py` (libwebp's decode, bit-exact). The lossless decoder
follows the RFC:
prefix codes (simple and normal, canonical, read bit by bit from an
LSB-first stream), LZ77 backward references with the 120 short-distance
plane codes, the colour cache, meta prefix codes over an entropy image,
and the four transforms (predictor with its 14 modes, colour, subtract
green, colour indexing with pixel bundling), undone in reverse order.

cv2 decodes to BGR and drops the alpha (libwebp's RGB modes neither blend
nor premultiply), then converts to gray with cvtColor's 15-bit weights:
(9798 R + 19235 G + 3735 B + 16384) >> 15. uint8.
"""

from __future__ import annotations

import struct

import numpy as np

_MAX_PIXELS = 1 << 28
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# the 120 short distance codes: (dy << 4) | (8 - dx)
_CODE_TO_PLANE = (
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39,
    0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a,
    0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e,
    0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72,
    0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70)


class WebPError(ValueError):
    """A WebP this reader does not read."""


class _Bits:
    """LSB-first bit reader over bytes."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.acc, self.n = data, 0, 0, 0

    def _fill(self, k: int) -> None:
        while self.n < k:
            byte = self.data[self.pos] if self.pos < len(self.data) else 0
            if self.pos >= len(self.data) + 8:
                raise WebPError("VP8L stream too short")
            self.acc |= byte << self.n
            self.pos += 1
            self.n += 8

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        self._fill(k)
        v = self.acc & ((1 << k) - 1)
        self.acc >>= k
        self.n -= k
        return v

    def peek(self, k: int) -> int:
        self._fill(k)
        return self.acc & ((1 << k) - 1)

    def skip(self, k: int) -> None:
        self.acc >>= k
        self.n -= k


class _Code:
    """A canonical prefix code: a table indexed by the next `bits` bits of
    the stream (LSB first), each entry (symbol, length)."""

    def __init__(self, lengths: list[int]):
        used = [(n, s) for s, n in enumerate(lengths) if n]
        if not used:
            raise WebPError("empty prefix code")
        if len(used) == 1:       # one symbol: no bits
            self.bits, self.table = 0, [(used[0][1], 0)]
            return
        self.bits = max(n for n, _ in used)
        if self.bits > 15:
            raise WebPError("prefix code longer than 15 bits")
        table = [None] * (1 << self.bits)
        code = 0
        prev = 0
        for n, s in sorted(used):
            code <<= n - prev
            prev = n
            if code >= 1 << n:
                raise WebPError("over-subscribed prefix code")
            rev = int(format(code, f"0{n}b")[::-1], 2)
            for t in range(rev, 1 << self.bits, 1 << n):
                table[t] = (s, n)
            code += 1
        if code != 1 << prev:
            raise WebPError("incomplete prefix code")
        self.table = table

    def read(self, br: _Bits) -> int:
        if self.bits == 0:
            return self.table[0][0]
        s, n = self.table[br.peek(self.bits)]
        br.skip(n)
        return s


def _read_code(br: _Bits, alphabet: int) -> _Code:
    lengths = [0] * alphabet
    if br.read(1):                                  # simple code
        n_symbols = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        if first >= alphabet:
            raise WebPError("simple code symbol out of range")
        lengths[first] = 1
        if n_symbols == 2:
            second = br.read(8)
            if second >= alphabet:
                raise WebPError("simple code symbol out of range")
            lengths[second] = 1
        return _Code(lengths)
    cl_lengths = [0] * 19
    for i in range(br.read(4) + 4):
        cl_lengths[_CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = _Code(cl_lengths)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise WebPError("max_symbol past the alphabet")
    else:
        max_symbol = alphabet
    symbol, prev = 0, 8
    while symbol < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = cl_code.read(br)
        if c < 16:
            lengths[symbol] = c
            symbol += 1
            if c:
                prev = c
            continue
        extra, offset = {16: (2, 3), 17: (3, 3), 18: (7, 11)}[c]
        repeat = br.read(extra) + offset
        if symbol + repeat > alphabet:
            raise WebPError("code lengths past the alphabet")
        value = prev if c == 16 else 0
        lengths[symbol:symbol + repeat] = [value] * repeat
        symbol += repeat
    return _Code(lengths)


def _prefix_value(br: _Bits, prefix: int) -> int:
    """A length or distance from its prefix symbol and extra bits."""
    if prefix < 4:
        return prefix + 1
    extra = (prefix - 2) >> 1
    return ((2 + (prefix & 1)) << extra) + br.read(extra) + 1


def _decode_image(br: _Bits, w: int, h: int, top: bool) -> np.ndarray:
    """An entropy-coded image of w x h ARGB pixels (uint32); `top` for the
    main image, the only one that may carry meta prefix codes."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise WebPError("colour cache size out of range")
    groups_image, prefix_bits = None, 0
    if top and br.read(1):
        prefix_bits = br.read(3) + 2
        bw = -(-w // (1 << prefix_bits))
        groups_image = (_decode_image(br, bw, -(-h // (1 << prefix_bits)), False) >> 8) & 0xFFFF
        n_groups = int(groups_image.max()) + 1
    else:
        n_groups = 1
    cache_size = 1 << cache_bits if cache_bits else 0
    groups = [[_read_code(br, a) for a in (256 + 24 + cache_size, 256, 256, 256, 40)]
              for _ in range(n_groups)]
    out = [0] * (w * h)
    cache = [0] * cache_size
    shift = 32 - cache_bits
    n = w * h
    i = 0
    while i < n:
        if groups_image is not None:
            y, x = divmod(i, w)
            green, red, blue, alpha, dist = groups[groups_image[y >> prefix_bits,
                                                               x >> prefix_bits]]
        else:
            green, red, blue, alpha, dist = groups[0]
        s = green.read(br)
        if s < 256:
            r = red.read(br)
            b = blue.read(br)
            a = alpha.read(br)
            argb = (a << 24) | (r << 16) | (s << 8) | b
            out[i] = argb
            if cache_size:
                cache[((0x1E35A7BD * argb) & 0xFFFFFFFF) >> shift] = argb
            i += 1
        elif s < 256 + 24:
            length = _prefix_value(br, s - 256)
            code = _prefix_value(br, dist.read(br))
            if code > 120:
                d = code - 120
            else:
                plane = _CODE_TO_PLANE[code - 1]
                d = max(1, (plane >> 4) * w + 8 - (plane & 15))
            if d > i or i + length > n:
                raise WebPError("backward reference out of the image")
            for k in range(length):
                argb = out[i - d]
                out[i] = argb
                if cache_size:
                    cache[((0x1E35A7BD * argb) & 0xFFFFFFFF) >> shift] = argb
                i += 1
        else:
            k = s - 280
            if k >= cache_size:
                raise WebPError("colour cache index out of range")
            out[i] = cache[k]
            i += 1
    return np.array(out, np.uint32).reshape(h, w)


def _channels(img: np.ndarray) -> tuple[np.ndarray, ...]:
    """(a, r, g, b) int64 planes of ARGB pixels."""
    v = img.astype(np.int64)
    return (v >> 24) & 255, (v >> 16) & 255, (v >> 8) & 255, v & 255


def _pack(a, r, g, b) -> np.ndarray:
    return (((a & 255) << 24) | ((r & 255) << 16) | ((g & 255) << 8) | (b & 255)).astype(np.uint32)


def _avg(p, q):
    return [(x + y) >> 1 for x, y in zip(p, q)]


def _predict(mode: int, left, top, tl, tr):
    """The predictor of one mode on (a, r, g, b) lists of ints."""
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg(_avg(left, tr), top)
    if mode == 6:
        return _avg(left, tl)
    if mode == 7:
        return _avg(left, top)
    if mode == 8:
        return _avg(tl, top)
    if mode == 9:
        return _avg(top, tr)
    if mode == 10:
        return _avg(_avg(left, tl), _avg(top, tr))
    if mode == 11:
        est = [lc + tc - tlc for lc, tc, tlc in zip(left, top, tl)]
        p_l = sum(abs(e - c) for e, c in zip(est, left))
        p_t = sum(abs(e - c) for e, c in zip(est, top))
        return left if p_l < p_t else top
    if mode == 12:
        return [min(255, max(0, lc + tc - tlc)) for lc, tc, tlc in zip(left, top, tl)]
    if mode == 13:
        avg = _avg(left, top)
        # C's (a - b) / 2 truncates toward zero
        return [min(255, max(0, a + int((a - b) / 2))) for a, b in zip(avg, tl)]
    return [255, 0, 0, 0]


def _undo_predictor(img: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    h, w = img.shape
    res = [[list(px) for px in zip(*(c.ravel().tolist() for c in _channels(img[y])))]
           for y in range(h)]
    out = [[None] * w for _ in range(h)]
    for y in range(h):
        row, cur = res[y], out[y]
        for x in range(w):
            if y == 0:
                pred = [255, 0, 0, 0] if x == 0 else cur[x - 1]
            elif x == 0:
                pred = out[y - 1][0]
            else:
                top_row = out[y - 1]
                tr = top_row[x + 1] if x + 1 < w else cur[0]
                pred = _predict(int(modes[y >> bits, x >> bits]), cur[x - 1], top_row[x],
                                top_row[x - 1], tr)
            cur[x] = [(r + p) & 255 for r, p in zip(row[x], pred)]
    a, r, g, b = (np.array([[px[c] for px in row] for row in out], np.int64) for c in range(4))
    return _pack(a, r, g, b)


def _undo_color(img: np.ndarray, bits: int, elems: np.ndarray) -> np.ndarray:
    h, w = img.shape
    ys, xs = np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits
    e = elems[ys, xs].astype(np.int64)

    def s8(v):
        return ((v & 255) ^ 128) - 128

    g2r, g2b, r2b = s8(e), s8(e >> 8), s8(e >> 16)
    a, r, g, b = _channels(img)
    green = s8(g)
    r = (r + ((g2r * green) >> 5)) & 255
    b = (b + ((g2b * green) >> 5) + ((r2b * s8(r)) >> 5)) & 255
    return _pack(a, r, g, b)


def _undo_index(img: np.ndarray, width_bits: int, w: int, table: np.ndarray) -> np.ndarray:
    h = img.shape[0]
    idx = ((img >> 8) & 255).astype(np.int64)
    if width_bits:
        per = 1 << width_bits
        bpp = 8 >> width_bits
        xs = np.arange(w)
        idx = (idx[:, xs >> width_bits] >> ((xs & (per - 1)) * bpp)) & ((1 << bpp) - 1)
    pal = np.zeros(256, np.uint32)
    pal[:len(table)] = table
    return pal[idx].reshape(h, w)


def vp8l_decode(data: bytes) -> np.ndarray:
    """A VP8L bitstream to (H, W) uint32 ARGB pixels."""
    if len(data) < 5 or data[0] != 0x2F:
        raise WebPError("not a VP8L stream")
    br = _Bits(data[1:])
    w, h = br.read(14) + 1, br.read(14) + 1
    br.read(1)                            # alpha_is_used: a hint only
    if br.read(3) != 0:
        raise WebPError("VP8L version other than 0")
    if w * h > _MAX_PIXELS:
        raise WebPError("VP8L image too large")
    transforms = []
    xsize = w
    seen = set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise WebPError("a VP8L transform twice")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _decode_image(br, -(-xsize // (1 << bits)), -(-h // (1 << bits)), False)
            transforms.append((kind, bits, sub, xsize))
        elif kind == 2:
            transforms.append((2, 0, None, xsize))
        else:
            n = br.read(8) + 1
            table = _decode_image(br, n, 1, False)[0]
            a, r, g, b = _channels(table)
            table = _pack(*(np.cumsum(c) for c in (a, r, g, b)))
            width_bits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
            transforms.append((3, width_bits, table, xsize))
            xsize = -(-xsize // (1 << width_bits))
    img = _decode_image(br, xsize, h, True)
    for kind, bits, sub, size in reversed(transforms):
        if kind == 0:
            img = _undo_predictor(img, bits, (sub >> 8) & 15)
        elif kind == 1:
            img = _undo_color(img, bits, sub)
        elif kind == 2:
            a, r, g, b = _channels(img)
            img = _pack(a, r + g, g, b + g)
        else:
            img = _undo_index(img, bits, size, sub)
    return img


def _chunks(data: bytes, pos: int, end: int) -> list[tuple[bytes, bytes]]:
    """The (tag, body) chunks of data[pos:end], each padded to even size."""
    out = []
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + size > end:
            raise WebPError(f"WebP chunk {tag!r} past the file")
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _image_gray(chunks: list) -> np.ndarray:
    """The gray of the first `VP8 ` or `VP8L` chunk: a lossy frame through
    `vp8.vp8_gray`, a lossless one's RGB through cvtColor's weights. An
    `ALPH` chunk beside a lossy frame leaves the gray as it is (libwebp's
    BGRA output is not premultiplied), so it is not decoded."""
    from cadx_tpu_torch.data.imageio import _gray15

    for tag, body in chunks:
        if tag == b"VP8L":
            _, r, g, b = _channels(vp8l_decode(body))
            return _gray15(r, g, b).astype(np.uint8)
        if tag == b"VP8 ":
            from cadx_tpu_torch.data.vp8 import VP8Error, vp8_gray

            try:
                return vp8_gray(body)
            except VP8Error as e:
                raise WebPError(str(e)) from e
    raise WebPError("WebP without a VP8 or VP8L chunk")


def _int24(b: bytes) -> int:
    return b[0] | (b[1] << 8) | (b[2] << 16)


def webp_gray(data: bytes) -> np.ndarray:
    """A WebP file as cv2 reads it in gray: uint8 (H, W). A still image is
    libwebp's decode of its `VP8 ` or `VP8L` chunk (directly or after a
    `VP8X` header, whose canvas must be the image's size); an animation
    (VP8X's animation flag) reads as cv2 reads it through WebPAnimDecoder:
    the first frame on a canvas of zeros, at its offset."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise WebPError("not a WebP file")
    (riff,) = struct.unpack_from("<I", data, 4)
    if 8 + riff > len(data):
        raise WebPError("WebP file shorter than its RIFF size")   # libwebp refuses it
    chunks = _chunks(data, 12, 8 + riff)
    if not chunks:
        raise WebPError("WebP without chunks")
    if chunks[0][0] != b"VP8X":
        return _image_gray(chunks[:1])
    head = chunks[0][1]
    if len(head) < 10:
        raise WebPError("short VP8X chunk")
    cw, ch = 1 + _int24(head[4:7]), 1 + _int24(head[7:10])
    if cw * ch > _MAX_PIXELS:
        raise WebPError("WebP canvas too large")
    if not head[0] & 0x02:
        img = _image_gray(chunks[1:])
        if img.shape != (ch, cw):
            raise WebPError("VP8X canvas and image sizes differ")
        return img
    frames = [body for tag, body in chunks if tag == b"ANMF"]
    if not frames or len(frames[0]) < 16:
        raise WebPError("animated WebP without a frame")
    f = frames[0]
    x, y = 2 * _int24(f[0:3]), 2 * _int24(f[3:6])
    fw, fh = 1 + _int24(f[6:9]), 1 + _int24(f[9:12])
    if x + fw > cw or y + fh > ch:
        raise WebPError("WebP frame outside its canvas")
    img = _image_gray(_chunks(f, 16, len(f)))
    if img.shape != (fh, fw):
        raise WebPError("WebP frame and image sizes differ")
    canvas = np.zeros((ch, cw), np.uint8)
    canvas[y:y + fh, x:x + fw] = img
    return canvas
