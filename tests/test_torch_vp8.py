"""Lossy WebP (`data/vp8.py`, routed by `data/webp.py`) against
`cv2.imread(path, IMREAD_GRAYSCALE | IMREAD_ANYDEPTH)`, the JAX front's
reader, on the same bytes: bit-exact.

cv2's gray of a lossy WebP is libwebp's BGR decode (its fancy chroma
upsampler and VP8YUVToR/G/B) through cvtColor's 15-bit weights, so the
colour decode (`vp8.yuv_to_rgb`) is held to cv2's IMREAD_COLOR as well.
The encoders are cv2's and PIL's (both libwebp): qualities 5-100, sizes
not a multiple of 16, gray and colour sources, flat images (skipped
macroblocks), sharp ones (4 x 4 modes), VP8X files with an ALPH chunk,
animations (the first frame on a canvas of zeros, as cv2 reads it), and
truncated or damaged files (None both ways). What no encoder here writes
is made from what they do: a frame's bits re-encoded with its tokens over
2, 4 or 8 partitions, or with the simple loop filter and other filter
levels and sharpnesses; libvpx's key frame (cv2's VideoWriter) brings loop
filter deltas and the skip flag.
"""

import io
import struct
import time

import cv2
import numpy as np
import pytest
from PIL import Image

from cadx_tpu_torch.data import imageio, vp8, webp

FLAGS = cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH


def _read_both(tmp_path, data: bytes, name="v.webp"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return cv2.imread(path, FLAGS), imageio.imread_gray(path)


def _same(tmp_path, data: bytes):
    ref, got = _read_both(tmp_path, data)
    assert ref is not None and got is not None
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return ref


def _source(rng, h, w, colour: bool) -> np.ndarray:
    """A natural-plus-noise scene: gradients, a disc, texture."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2) % 256 * 0.6 + 80 * (((yy - h / 2) ** 2 + (xx - w / 3) ** 2)
                                                   < (min(h, w) / 3) ** 2)
    noise = rng.normal(0, 18, (h, w, 3 if colour else 1))
    img = np.clip(base[..., None] + noise, 0, 255).astype(np.uint8)
    if colour:
        img[..., 1] = np.clip(img[..., 1].astype(int) * 0.7 + 40, 0, 255)
        img[..., 2] = 255 - img[..., 2]
        return img
    return img[..., 0]


def _chunks(data: bytes) -> list:
    out, pos = [], 12
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from("<I", data, pos + 4)
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


@pytest.mark.parametrize("colour", [False, True])
@pytest.mark.parametrize("quality", [5, 25, 50, 75, 90, 100])
def test_lossy_webp_qualities(tmp_path, rng, quality, colour):
    """cv2's lossy encode at each quality: the gray, and libwebp's colour
    decode against cv2's BGR."""
    img = _source(rng, 67, 93, colour)
    data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()
    assert _chunks(data)[0][0] == b"VP8 "
    _same(tmp_path, data)
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    r, g, b = vp8.yuv_to_rgb(*vp8.vp8_decode(_chunks(data)[0][1]))
    np.testing.assert_array_equal(np.stack([b, g, r], axis=-1), bgr)


@pytest.mark.parametrize("hw", [(1, 1), (17, 33), (67, 93), (16, 16), (2, 31), (40, 1)])
@pytest.mark.parametrize("colour", [False, True])
def test_lossy_webp_sizes(tmp_path, rng, hw, colour):
    """Widths and heights that are not multiples of 16 (a partial last
    macroblock; odd sizes, whose chroma and fancy upsampler end in a single
    sample)."""
    for quality in (30, 95):
        img = _source(rng, *hw, colour)
        _same(tmp_path, cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])[1]
              .tobytes())


@pytest.mark.parametrize("case", ["flat black", "flat grey", "flat with a square", "stripes",
                                  "noise"])
def test_lossy_webp_macroblock_kinds(tmp_path, rng, case):
    """Flat images, a flat one with a square (PIL's fast methods then set
    the skip flag: no residual, no inner-edge filtering), sharp stripes and
    noise (4 x 4 modes, large coefficients)."""
    h, w = 80, 96
    img = {"flat black": lambda: np.zeros((h, w), np.uint8),
           "flat grey": lambda: np.full((h, w, 3), (40, 90, 200), np.uint8),
           "flat with a square": lambda: np.pad(np.full((16, 16), 230, np.uint8),
                                                ((32, 32), (40, 40))),
           "stripes": lambda: np.kron(rng.integers(0, 2, (h // 4, w)) * 255,
                                      np.ones((4, 1))).astype(np.uint8),
           "noise": lambda: rng.integers(0, 256, (h, w, 3)).astype(np.uint8)}[case]()
    for quality in (10, 60, 99):
        data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()
        _same(tmp_path, data)
    hd = vp8._Header(_chunks(data)[0][1])
    _, skip, i4, *_ = vp8._parse_modes(hd)
    if case in ("stripes", "noise"):
        assert i4.any()
    if case == "flat with a square":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "WEBP", quality=30, method=1)
        _same(tmp_path, buf.getvalue())
        hd = vp8._Header(_chunks(buf.getvalue())[0][1])
        assert hd.use_skip and vp8._parse_modes(hd)[1].any()


@pytest.mark.parametrize("method", [0, 3, 6])
def test_lossy_webp_pil_encoder_settings(tmp_path, rng, method):
    """PIL's libwebp encoder at its fastest, default and slowest methods
    (other mode decisions, segment maps and filter strengths)."""
    img = _source(rng, 70, 100, True)
    for quality in (15, 80):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "WEBP", quality=quality, method=method)
        _same(tmp_path, buf.getvalue())


def test_lossy_webp_vp8x_with_alpha(tmp_path, rng):
    """PIL writes an RGBA lossy WebP as VP8X + ALPH + VP8; cv2 decodes BGRA
    (not premultiplied) and converts to gray: the alpha leaves the gray as
    the colour gives it."""
    rgba = np.dstack([_source(rng, 45, 70, True), rng.integers(0, 256, (45, 70))]).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, "WEBP", quality=70)
    data = buf.getvalue()
    assert [t for t, _ in _chunks(data)] == [b"VP8X", b"ALPH", b"VP8 "]
    _same(tmp_path, data)


def _riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _int24(v: int) -> bytes:
    return v.to_bytes(3, "little")


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("place", [(0, 0, 30, 20), (4, 6, 40, 30), (2, 0, 33, 21)])
def test_animated_webp_first_frame(tmp_path, rng, lossless, place):
    """cv2 reads an animation through WebPAnimDecoder: the first frame (lossy
    or lossless) at its offset on a canvas of zeros."""
    x, y, cw, ch = place
    img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    still = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 101 if lossless else 80])[1]
    frame = _chunk(b"ANMF", _int24(x // 2) + _int24(y // 2) + _int24(29) + _int24(19)
                   + _int24(100) + b"\0" + bytes(still)[12:])
    data = _riff(_chunk(b"VP8X", bytes([2, 0, 0, 0]) + _int24(cw - 1) + _int24(ch - 1))
                 + _chunk(b"ANIM", bytes(6)) + frame + frame)
    ref = _same(tmp_path, data)
    assert ref.shape == (ch, cw)


def test_animated_webp_from_pil(tmp_path, rng):
    frames = [Image.fromarray(_source(rng, 40, 50, True)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], quality=60)
    _same(tmp_path, buf.getvalue())


def test_damaged_lossy_webp_gives_none(tmp_path, rng):
    """A truncated partition, a VP8X canvas of another size than its image, a
    frame outside its canvas, a bad start code and a file shorter than its
    RIFF size give no image, as cv2 gives none."""
    img = _source(rng, 48, 64, True)
    data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes()
    tag, vp = _chunks(data)[0]
    cut = _riff(_chunk(b"VP8 ", vp[:len(vp) // 3]))
    canvas = _riff(_chunk(b"VP8X", bytes(4) + _int24(63) + _int24(40)) + _chunk(b"VP8 ", vp))
    outside = _riff(_chunk(b"VP8X", bytes([2, 0, 0, 0]) + _int24(39) + _int24(39))
                    + _chunk(b"ANIM", bytes(6))
                    + _chunk(b"ANMF", bytes(6) + _int24(63) + _int24(47) + bytes(4)
                             + _chunk(b"VP8 ", vp)))
    code = _riff(_chunk(b"VP8 ", vp[:3] + b"\x9d\x01\x2b" + vp[6:]))
    short = data[:-40]
    for bad in (cut, canvas, outside, code, short):
        ref, got = _read_both(tmp_path, bad)
        assert ref is None and got is None
    with pytest.raises(webp.WebPError):
        webp.webp_gray(cut)


def test_lossy_webp_512_in_seconds(tmp_path):
    """A 512 x 512 mammogram-like upload (the front's fixture,
    tests/data/upload_lossy.webp, quality 90) decodes bit-exact well under
    10 s here."""
    from pathlib import Path

    data = (Path(__file__).parent / "data" / "upload_lossy.webp").read_bytes()
    t0 = time.perf_counter()
    got = webp.webp_gray(data)
    seconds = time.perf_counter() - t0
    ref, _ = _read_both(tmp_path, data)
    np.testing.assert_array_equal(got, ref)
    assert seconds < 10, seconds


def test_boolean_decoder_and_tables():
    """The RFC's quantiser tables at their ends, the probability tables'
    sizes, and the boolean decoder reading back the bits RFC 6386 7.3's
    encoder (`_bool_encode`) wrote at random probabilities."""
    assert len(vp8._DC_Q) == len(vp8._AC_Q) == 128
    assert (vp8._DC_Q[0], vp8._DC_Q[-1], vp8._AC_Q[0], vp8._AC_Q[-1]) == (4, 157, 4, 284)
    assert len(vp8._COEFF_PROBA0) == len(vp8._COEFF_UPDATE) == 4 * 8 * 3 * 11
    assert len(vp8._BMODE_PROBA) == 10 * 10 * 9

    r = np.random.default_rng(5)
    seq = [(int(b), int(p)) for b, p in zip(r.integers(0, 2, 500), r.integers(1, 256, 500))]
    data = _bool_encode(seq)
    br = vp8._BoolReader(data, 0, len(data))
    assert [br.bit(p) for _, p in seq] == [b for b, _ in seq]


# ---- streams no encoder here writes, made from ones it does --------------------

def _bool_encode(seq) -> bytes:
    """RFC 6386 7.3's boolean encoder over (bit, probability) pairs, flushed."""
    out, lo, rng_, count = bytearray(), 0, 255, -24

    def carry():
        i = len(out) - 1
        while out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    def shift(n):
        nonlocal lo, count
        for _ in range(n):
            if lo & (1 << 31):
                carry()
            lo = (lo << 1) & 0xFFFFFFFF
            count += 1
            if count == 0:
                out.append((lo >> 24) & 0xFF)
                lo &= 0xFFFFFF
                count = -8

    for bit, prob in seq:
        split = 1 + (((rng_ - 1) * prob) >> 8)
        if bit:
            lo += split
            rng_ -= split
        else:
            rng_ = split
        while rng_ < 128:
            rng_ <<= 1
            shift(1)
    shift(32)
    return bytes(out)


class _Recorder(vp8._BoolReader):
    """A boolean decoder that logs every (bit, probability) it reads, where
    each header field starts (`fields`: log index, bits) and where each
    macroblock row's tokens start (`rows`: `_residuals` takes `coeffs` once
    a row)."""

    __slots__ = ("log", "fields", "rows")

    def __init__(self, *a):
        super().__init__(*a)
        self.log, self.fields, self.rows = [], [], []

    def bit(self, prob: int) -> int:
        b = super().bit(prob)
        self.log.append((b, prob))
        return b

    def literal(self, n: int) -> int:
        self.fields.append((len(self.log), n))
        return super().literal(n)

    @property
    def coeffs(self):
        self.rows.append(len(self.log))
        return self._coeffs

    def _coeffs(self, bands, ctx, dq0, dq1, n, idx, val, base):
        """libwebp's GetCoeffs through `bit`."""
        p = bands[n][ctx]
        while n < 16:
            if not self.bit(p[0]):
                return n
            while not self.bit(p[1]):
                n += 1
                if n == 16:
                    return 16
                p = bands[n][0]
            if not self.bit(p[2]):
                v, nxt = 1, 1
            else:
                v, nxt = self.large(p), 2
            if self.bit(128):
                v = -v
            idx.append(base + vp8._ZIGZAG[n])
            val.append(v * (dq1 if n else dq0))
            n += 1
            p = bands[n][nxt]
        return 16


def _transcode(frame: bytes, monkeypatch, parts: int = 1, simple=None, level=None,
               sharpness=None, absolute=None) -> bytes:
    """The same key frame re-encoded with another number of token partitions,
    other loop filter fields or its segment values read as deltas
    (`absolute` 0): the first partition's bits re-encoded with those fields
    changed, each macroblock row's token bits moved to partition row %
    parts."""
    with monkeypatch.context() as m:
        m.setattr(vp8, "_BoolReader", _Recorder)
        hd = vp8._Header(frame)
        seg, skip, i4, *_ = vp8._parse_modes(hd)
        vp8._residuals(hd, seg, skip, i4)
    p0 = hd.br
    log = list(p0.log)
    starts = [n for _, n in p0.fields]
    k = next(i for i in range(len(starts) - 2) if starts[i:i + 3] == [1, 6, 3])

    def put(field, value):
        at, n = p0.fields[field]
        for j in range(n):
            log[at + j] = ((value >> (n - 1 - j)) & 1, 128)

    for field, value in ((k, simple), (k + 1, level), (k + 2, sharpness)):
        if value is not None:
            put(field, value)
    if absolute is not None:     # fields 1-4: segments on, map, data, absolute
        assert hd.use_segment and starts[1:5] == [1, 1, 1, 1]
        put(4, absolute)
    put(next(i for i in range(k + 3, len(starts)) if starts[i] == 2), parts.bit_length() - 1)
    (src,) = hd.parts
    bounds = src.rows + [len(src.log)]
    rows = [src.log[a:b] for a, b in zip(bounds, bounds[1:])]
    streams = [_bool_encode([e for y in range(r, len(rows), parts) for e in rows[y]])
               for r in range(parts)]
    first = _bool_encode(log)
    tag = (len(first) << 5) | (1 << 4)
    return (tag.to_bytes(3, "little") + frame[3:10] + first
            + b"".join(len(s).to_bytes(3, "little") for s in streams[:-1]) + b"".join(streams))


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
def test_token_partitions(tmp_path, rng, monkeypatch, parts):
    """A frame's tokens spread over 2, 4 and 8 partitions (libwebp's encoder
    here writes one): libwebp and the port read the same image."""
    img = _source(rng, 150, 70, True)
    data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 60])[1].tobytes()
    frame = _transcode(_chunks(data)[0][1], monkeypatch, parts=parts)
    assert len(vp8._Header(frame).parts) == parts
    ref = _same(tmp_path, _riff(_chunk(b"VP8 ", frame)))
    if parts == 1:   # the same bits: the same image
        np.testing.assert_array_equal(ref, _same(tmp_path, data))


@pytest.mark.parametrize("simple", [0, 1])
@pytest.mark.parametrize("level, sharpness", [(10, 0), (20, 3), (45, 6), (63, 7)])
def test_loop_filter_variants(tmp_path, rng, monkeypatch, simple, level, sharpness):
    """The simple loop filter (no encoder here picks it) and the normal one
    at levels and sharpnesses that change the interior limit and the
    high-edge-variance threshold, on frames whose residuals are cv2's."""
    img = _source(rng, 64, 80, True)
    data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 40])[1].tobytes()
    frame = _transcode(_chunks(data)[0][1], monkeypatch, simple=simple, level=level,
                       sharpness=sharpness)
    hd = vp8._Header(frame)
    assert (hd.simple, hd.level, hd.sharpness) == (simple, level, sharpness)
    _same(tmp_path, _riff(_chunk(b"VP8 ", frame)))


def _vpx_key_frame(tmp_path, img: np.ndarray) -> bytes:
    """The key frame libvpx (through cv2's FFmpeg VideoWriter) writes first
    in a WebM file: a VP8 stream with loop filter deltas and the skip flag,
    which libwebp's encoder does not use."""
    path = str(tmp_path / "v.webm")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"VP80"), 10, img.shape[1::-1])
    assert vw.isOpened()
    for _ in range(2):
        vw.write(img)
    vw.release()
    data = open(path, "rb").read()
    at = data.find(b"\x9d\x01\x2a")
    block = data.rfind(b"\xa3", 0, at - 3)          # the SimpleBlock holding it
    n = 9 - data[block + 1].bit_length()             # its size's vint length
    size = data[block + 1] & ((1 << (8 - n)) - 1)
    for k in range(1, n):
        size = (size << 8) | data[block + 1 + k]
    frame = data[block + 1 + n + 4:block + 1 + n + size]
    assert frame[3:6] == b"\x9d\x01\x2a"
    return frame


def test_libvpx_key_frame(tmp_path, rng):
    img = _source(rng, 72, 100, True)
    frame = _vpx_key_frame(tmp_path, img)
    hd = vp8._Header(frame)
    assert hd.use_lf_delta and any(hd.ref_delta) and any(hd.mode_delta) and hd.use_skip
    _same(tmp_path, _riff(_chunk(b"VP8 ", frame)))


def test_segment_values_as_deltas(tmp_path, rng, monkeypatch):
    """Segment quantisers and filter strengths read as deltas from the
    frame's (libwebp's encoder sends them absolute): the same frame with
    that flag cleared reads the same through libwebp and the port."""
    img = _source(rng, 64, 96, True)
    data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 50])[1].tobytes()
    frame = _transcode(_chunks(data)[0][1], monkeypatch, absolute=0)
    hd = vp8._Header(frame)
    assert hd.use_segment and not hd.absolute
    _same(tmp_path, _riff(_chunk(b"VP8 ", frame)))
