"""JPEG-LS (ITU-T T.87 / ISO-IEC 14495-1) codec — pure Python, self-written.

The port's own copy of `cadx_tpu/data/jls.py`. The reference reads TCIA
DICOMs through pydicom's handler ecosystem
(Classes/Preprocessing.py:149), which decodes the JPEG-LS
transfer syntaxes 1.2.840.10008.1.2.4.80 (lossless) and .81
(near-lossless).  pydicom is absent by design, so this module implements
the LOCO-I algorithm from the public spec text: regular-mode context
modelling (365 contexts, gradient quantization per A.3), MED prediction
with bias correction (A.4/A.6), Golomb-Rice coding with the LIMIT escape
(A.5.3), run mode with the 32-entry J[] code-order table and run
interruption contexts 365/366 (A.7), and the FF bit-stuffing marker
avoidance of the entropy-coded segment (A.1).

Scope: single-component scans (DICOM mammography is SamplesPerPixel=1),
2..16-bit precision, NEAR >= 0, default or LSE-preset coding parameters.
Multi-component interleaves raise JlsError (named, per the reader's
clear-error contract).

Verification (tests/test_jls.py): no JPEG-LS oracle library exists in
this image (charls/imagecodecs/pydicom absent), so — like the RLE and
JPEG-lossless codecs before it — the encoder and decoder are written
independently from the spec's two directions and pinned against each
other with round-trip batteries over 8/12/16-bit random, gradient,
constant, and mammogram-like images, a golden-bytes regression pin, the
near-lossless error bound |x - x'| <= NEAR, and truncation / marker-garbage
error paths.
"""

from __future__ import annotations

import struct

import numpy as np


class JlsError(ValueError):
    """Malformed or unsupported JPEG-LS stream."""


# Code-order table for run lengths (T.87 A.7.1.1).
_J = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
      4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15)

_MIN_C, _MAX_C = -128, 127

# JPEG marker bytes used by T.87 streams.
_SOI, _EOI = 0xD8, 0xD9
_SOF55, _LSE, _SOS, _DNL = 0xF7, 0xF8, 0xDA, 0xDC


# ---------------------------------------------------------------------------
# Coding parameters (T.87 C.2.4.1.1)
# ---------------------------------------------------------------------------

def _default_thresholds(maxval: int, near: int) -> tuple[int, int, int]:
    """Default T1/T2/T3 from MAXVAL and NEAR (C.2.4.1.1.1)."""

    def clamp(i, lo):
        return lo if (i > maxval or i < lo) else i

    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = clamp(factor * (3 - 2) + 2 + 3 * near, near + 1)
        t2 = clamp(factor * (7 - 3) + 3 + 5 * near, t1)
        t3 = clamp(factor * (21 - 4) + 4 + 7 * near, t2)
    else:
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), near + 1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3


class _Params:
    """Derived coding constants shared by encoder and decoder."""

    def __init__(self, maxval: int, near: int, reset: int,
                 thresholds: tuple[int, int, int] | None = None):
        if not 1 <= maxval <= 65535:
            raise JlsError(f"MAXVAL {maxval} out of range")
        if near < 0 or near > min(255, maxval // 2):
            raise JlsError(f"NEAR {near} out of range for MAXVAL {maxval}")
        self.maxval = maxval
        self.near = near
        self.reset = reset
        self.t1, self.t2, self.t3 = (thresholds or
                                     _default_thresholds(maxval, near))
        # A.2.1
        self.range = (maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = max(1, (self.range - 1).bit_length())
        self.bpp = max(2, maxval.bit_length())
        self.limit = 2 * (self.bpp + max(8, self.bpp))

    def init_state(self):
        # A.2.1 / A.7.1: contexts 0..364 regular, 365/366 run interruption.
        a0 = max(2, (self.range + 32) // 64)
        a = [a0] * 367
        b = [0] * 365
        c = [0] * 365
        n = [1] * 367
        nn = [0, 0]
        return a, b, c, n, nn


# ---------------------------------------------------------------------------
# Entropy-coded segment I/O with FF bit stuffing (T.87 A.1)
# ---------------------------------------------------------------------------

class _BitWriter:
    """MSB-first bit writer; after an emitted 0xFF byte the next byte
    carries only 7 data bits with a stuffed 0 MSB, so no marker (FF80+)
    can appear inside the entropy-coded segment."""

    def __init__(self):
        self.out = bytearray()
        self._acc = 0
        self._nbits = 0  # bits accumulated toward the current byte
        self._cap = 8    # capacity of the current byte (7 after an FF)

    def put_bit(self, bit: int):
        self._acc = (self._acc << 1) | bit
        self._nbits += 1
        if self._nbits == self._cap:
            self.out.append(self._acc)
            self._cap = 7 if self._acc == 0xFF else 8
            self._acc = 0
            self._nbits = 0

    def put_bits(self, value: int, nbits: int):
        for shift in range(nbits - 1, -1, -1):
            self.put_bit((value >> shift) & 1)

    def put_zeros(self, count: int):
        for _ in range(count):
            self.put_bit(0)

    def flush(self) -> bytes:
        # Pad the final partial byte with 0 fill bits (a 7-capacity byte
        # keeps its stuffed-0 MSB because _acc is left-shifted, not OR'd
        # into bit 7).
        if self._nbits:
            self.out.append(self._acc << (self._cap - self._nbits))
        return bytes(self.out)


class _BitReader:
    """MSB-first reader mirroring _BitWriter's FF stuffing."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self._acc = 0
        self._nleft = 0
        self._prev_ff = False

    def bit(self) -> int:
        if self._nleft == 0:
            if self.pos >= len(self.data):
                raise JlsError("truncated entropy-coded segment")
            byte = self.data[self.pos]
            self.pos += 1
            if self._prev_ff:
                if byte & 0x80:
                    raise JlsError("marker inside entropy-coded segment")
                self._acc, self._nleft = byte, 7
                self._prev_ff = False
            else:
                self._acc, self._nleft = byte, 8
                self._prev_ff = byte == 0xFF
        self._nleft -= 1
        return (self._acc >> self._nleft) & 1

    def bits(self, nbits: int) -> int:
        value = 0
        for _ in range(nbits):
            value = (value << 1) | self.bit()
        return value


def _golomb_encode(w: _BitWriter, merr: int, k: int, limit: int, qbpp: int):
    """LG(k, limit) mapped-error coding (A.5.3)."""
    high = merr >> k
    if high < limit - qbpp - 1:
        w.put_zeros(high)
        w.put_bit(1)
        if k:
            w.put_bits(merr & ((1 << k) - 1), k)
    else:
        w.put_zeros(limit - qbpp - 1)
        w.put_bit(1)
        w.put_bits(merr - 1, qbpp)


def _golomb_decode(r: _BitReader, k: int, limit: int, qbpp: int) -> int:
    high = 0
    while r.bit() == 0:
        high += 1
        if high > limit:
            raise JlsError("unary prefix exceeds LIMIT")
    if high < limit - qbpp - 1:
        return (high << k) | (r.bits(k) if k else 0)
    if high == limit - qbpp - 1:
        return r.bits(qbpp) + 1
    raise JlsError("invalid LG(k) escape length")


# ---------------------------------------------------------------------------
# Shared per-sample helpers
# ---------------------------------------------------------------------------

def _quantize_gradient(d: int, p: _Params) -> int:
    """A.3.3 gradient quantization to {-4..4}."""
    if d <= -p.t3:
        return -4
    if d <= -p.t2:
        return -3
    if d <= -p.t1:
        return -2
    if d < -p.near:
        return -1
    if d <= p.near:
        return 0
    if d < p.t1:
        return 1
    if d < p.t2:
        return 2
    if d < p.t3:
        return 3
    return 4


def _predict(ra: int, rb: int, rc: int) -> int:
    """MED predictor (A.4.1)."""
    if rc >= max(ra, rb):
        return min(ra, rb)
    if rc <= min(ra, rb):
        return max(ra, rb)
    return ra + rb - rc


def _mod_range(err: int, rng: int) -> int:
    """Reduce a (quantized) prediction error modulo RANGE (A.4.5)."""
    if err < 0:
        err += rng
    if err >= (rng + 1) // 2:
        err -= rng
    return err


def _bias_update(q: int, err: int, a, b, c, n, p: _Params):
    """Variable update + bias cancellation (A.6)."""
    b[q] += err * (2 * p.near + 1)
    a[q] += abs(err)
    if n[q] == p.reset:
        a[q] >>= 1
        b[q] = b[q] >> 1 if b[q] >= 0 else -((1 - b[q]) >> 1)
        n[q] >>= 1
    n[q] += 1
    if b[q] <= -n[q]:
        if c[q] > _MIN_C:
            c[q] -= 1
        b[q] += n[q]
        if b[q] <= -n[q]:
            b[q] = -n[q] + 1
    elif b[q] > 0:
        if c[q] < _MAX_C:
            c[q] += 1
        b[q] -= n[q]
        if b[q] > 0:
            b[q] = 0


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _encode_scan(img: np.ndarray, p: _Params) -> bytes:
    h, w = img.shape
    a, b, c, n, nn = p.init_state()
    out = _BitWriter()
    near, rng, maxval = p.near, p.range, p.maxval
    run_index = 0
    # prev/cur hold the RECONSTRUCTED line with a virtual left column at
    # index 0 and a replicated right column at index w+1, so Ra/Rb/Rc/Rd
    # boundary rules (A.2.2: first-line zeros, Ra(0)=Rb(0), Rc(0)=previous
    # line's Ra(0), Rd(last)=Rb(last)) fall out of plain indexing.
    prev = [0] * (w + 2)
    cur = [0] * (w + 2)
    rows = img.tolist()
    for y in range(h):
        row = rows[y]
        cur[0] = prev[1]
        prev[w + 1] = prev[w]
        i = 1
        while i <= w:
            x = row[i - 1]
            ra, rb, rc, rd = cur[i - 1], prev[i], prev[i - 1], prev[i + 1]
            d1, d2, d3 = rd - rb, rb - rc, rc - ra
            if abs(d1) <= near and abs(d2) <= near and abs(d3) <= near:
                # ---- run mode (A.7) ----
                runval = ra
                cnt = 0
                while i <= w and abs(row[i - 1] - runval) <= near:
                    cur[i] = runval
                    cnt += 1
                    i += 1
                while cnt >= (1 << _J[run_index]):
                    out.put_bit(1)
                    cnt -= 1 << _J[run_index]
                    if run_index < 31:
                        run_index += 1
                if i > w:  # run broken by end of line
                    if cnt > 0:
                        out.put_bit(1)
                    continue
                out.put_bit(0)
                if _J[run_index]:
                    out.put_bits(cnt, _J[run_index])
                # ---- run interruption sample (A.7.2) ----
                x = row[i - 1]
                rb = prev[i]
                ritype = 1 if abs(runval - rb) <= near else 0
                px = runval if ritype else rb
                err = x - px
                sign = -1 if (ritype == 0 and runval > rb) else 1
                if sign < 0:
                    err = -err
                if near:
                    err = ((err + near) // (2 * near + 1) if err > 0
                           else -((near - err) // (2 * near + 1)))
                    rx = px + sign * err * (2 * near + 1)
                    rx = 0 if rx < 0 else (maxval if rx > maxval else rx)
                else:
                    rx = x
                err = _mod_range(err, rng)
                q = 365 + ritype
                temp = a[q] + (n[q] >> 1 if ritype else 0)
                k = 0
                while (n[q] << k) < temp:
                    k += 1
                flip = k == 0 and 2 * nn[ritype] < n[q]
                if err > 0:
                    emap = 1 if flip else 0
                elif err < 0:
                    emap = 0 if flip else 1
                else:
                    emap = 0
                emerr = 2 * abs(err) - ritype - emap
                _golomb_encode(out, emerr, k,
                               p.limit - _J[run_index] - 1, p.qbpp)
                if err < 0:
                    nn[ritype] += 1
                a[q] += (emerr + 1 - ritype) >> 1
                if n[q] == p.reset:
                    a[q] >>= 1
                    n[q] >>= 1
                    nn[ritype] >>= 1
                n[q] += 1
                if run_index > 0:
                    run_index -= 1
                cur[i] = rx
                i += 1
                continue
            # ---- regular mode (A.4-A.6) ----
            q1 = _quantize_gradient(d1, p)
            q2 = _quantize_gradient(d2, p)
            q3 = _quantize_gradient(d3, p)
            q = 81 * q1 + 9 * q2 + q3
            sign = 1
            if q < 0:
                q, sign = -q, -1
            px = _predict(ra, rb, rc) + sign * c[q]
            px = 0 if px < 0 else (maxval if px > maxval else px)
            err = (x - px) * sign
            if near:
                err = ((err + near) // (2 * near + 1) if err > 0
                       else -((near - err) // (2 * near + 1)))
                rx = px + sign * err * (2 * near + 1)
                rx = 0 if rx < 0 else (maxval if rx > maxval else rx)
            else:
                rx = x
            err = _mod_range(err, rng)
            k = 0
            while (n[q] << k) < a[q]:
                k += 1
            if near == 0 and k == 0 and 2 * b[q] <= -n[q]:
                merr = 2 * err + 1 if err >= 0 else -2 * (err + 1)
            else:
                merr = 2 * err if err >= 0 else -2 * err - 1
            _golomb_encode(out, merr, k, p.limit, p.qbpp)
            _bias_update(q, err, a, b, c, n, p)
            cur[i] = rx
            i += 1
        prev, cur = cur, prev
    return out.flush()


def jls_encode(arr: np.ndarray, near: int = 0,
               precision: int | None = None,
               maxval: int | None = None) -> bytes:
    """Encode a 2-D uint8/uint16 array as a single-component JPEG-LS
    stream (SOI / SOF55 / [LSE] / SOS / scan / EOI).

    maxval, when given, is written as an LSE preset-parameter segment
    (C.2.4.1.1) and used as the coding MAXVAL — the form real TCIA
    JPEG-LS files use when BitsStored < BitsAllocated."""
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise JlsError("only single-component (2-D) images supported")
    if arr.dtype not in (np.uint8, np.uint16):
        raise JlsError(f"unsupported dtype {arr.dtype}")
    h, w = arr.shape
    if not (0 < h <= 65535 and 0 < w <= 65535):
        raise JlsError(f"image size {arr.shape} out of range")
    if precision is None:
        precision = max(2, int(arr.max()).bit_length())
    if not 2 <= precision <= 16:
        raise JlsError(f"precision {precision} out of range")
    if maxval is None:
        maxval = (1 << precision) - 1
        lse = b""
    else:
        if not int(arr.max()) <= maxval < (1 << precision):
            raise JlsError(f"preset MAXVAL {maxval} inconsistent with "
                           f"precision {precision} / data")
        lse = struct.pack(">BBHBHHHHH", 0xFF, _LSE, 13, 1,
                          maxval, 0, 0, 0, 0)  # T1-T3/RESET 0 = defaults
    if int(arr.max()) > maxval:
        raise JlsError("sample exceeds declared precision")
    p = _Params(maxval, near, reset=64)
    head = bytearray()
    head += bytes([0xFF, _SOI])
    head += struct.pack(">BBHBHHB", 0xFF, _SOF55, 11, precision, h, w, 1)
    head += bytes([1, 0x11, 0])  # component id / sampling / Tq
    head += lse
    head += struct.pack(">BBHB", 0xFF, _SOS, 8, 1)
    head += bytes([1, 0])        # component selector / mapping table
    head += bytes([near, 0, 0])  # NEAR, ILV=none, Al/Ah=0
    scan = _encode_scan(arr.astype(np.int64), p)
    return bytes(head) + scan + bytes([0xFF, _EOI])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _decode_scan(r: _BitReader, h: int, w: int, p: _Params) -> np.ndarray:
    a, b, c, n, nn = p.init_state()
    near, rng, maxval = p.near, p.range, p.maxval
    wrap = rng * (2 * near + 1)
    run_index = 0
    prev = [0] * (w + 2)
    cur = [0] * (w + 2)
    out = np.empty((h, w), np.int32)
    for y in range(h):
        cur[0] = prev[1]
        prev[w + 1] = prev[w]
        i = 1
        while i <= w:
            ra, rb, rc, rd = cur[i - 1], prev[i], prev[i - 1], prev[i + 1]
            d1, d2, d3 = rd - rb, rb - rc, rc - ra
            if abs(d1) <= near and abs(d2) <= near and abs(d3) <= near:
                # ---- run mode ----
                runval = ra
                interrupted = False
                while True:
                    if r.bit():
                        seg = 1 << _J[run_index]
                        fill = min(seg, w - i + 1)
                        for _ in range(fill):
                            cur[i] = runval
                            i += 1
                        if fill == seg and run_index < 31:
                            run_index += 1
                        if i > w:
                            break
                    else:
                        cnt = r.bits(_J[run_index]) if _J[run_index] else 0
                        if cnt > w - i + 1:
                            raise JlsError("run length exceeds line")
                        for _ in range(cnt):
                            cur[i] = runval
                            i += 1
                        interrupted = True
                        break
                if not interrupted:
                    continue
                # ---- run interruption sample ----
                rb = prev[i]
                ritype = 1 if abs(runval - rb) <= near else 0
                px = runval if ritype else rb
                sign = -1 if (ritype == 0 and runval > rb) else 1
                q = 365 + ritype
                temp = a[q] + (n[q] >> 1 if ritype else 0)
                k = 0
                while (n[q] << k) < temp:
                    k += 1
                emerr = _golomb_decode(r, k, p.limit - _J[run_index] - 1,
                                       p.qbpp)
                t = emerr + ritype
                flip = k == 0 and 2 * nn[ritype] < n[q]
                if flip:
                    err = (t + 1) // 2 if t & 1 else -(t // 2)
                else:
                    err = t // 2 if not t & 1 else -((t + 1) // 2)
                if err < 0:
                    nn[ritype] += 1
                a[q] += (emerr + 1 - ritype) >> 1
                if n[q] == p.reset:
                    a[q] >>= 1
                    n[q] >>= 1
                    nn[ritype] >>= 1
                n[q] += 1
                rx = px + sign * err * (2 * near + 1)
                if rx < -near:
                    rx += wrap
                elif rx > maxval + near:
                    rx -= wrap
                rx = 0 if rx < 0 else (maxval if rx > maxval else rx)
                if run_index > 0:
                    run_index -= 1
                cur[i] = rx
                i += 1
                continue
            # ---- regular mode ----
            q1 = _quantize_gradient(d1, p)
            q2 = _quantize_gradient(d2, p)
            q3 = _quantize_gradient(d3, p)
            q = 81 * q1 + 9 * q2 + q3
            sign = 1
            if q < 0:
                q, sign = -q, -1
            px = _predict(ra, rb, rc) + sign * c[q]
            px = 0 if px < 0 else (maxval if px > maxval else px)
            k = 0
            while (n[q] << k) < a[q]:
                k += 1
            merr = _golomb_decode(r, k, p.limit, p.qbpp)
            if near == 0 and k == 0 and 2 * b[q] <= -n[q]:
                err = (merr - 1) // 2 if merr & 1 else -(merr // 2) - 1
            else:
                err = merr // 2 if not merr & 1 else -((merr + 1) // 2)
            _bias_update(q, err, a, b, c, n, p)
            rx = px + sign * err * (2 * near + 1)
            if rx < -near:
                rx += wrap
            elif rx > maxval + near:
                rx -= wrap
            rx = 0 if rx < 0 else (maxval if rx > maxval else rx)
            cur[i] = rx
            i += 1
        out[y] = cur[1:w + 1]
        prev, cur = cur, prev
    return out


def jls_decode(data: bytes,
               expect_hw: tuple[int, int] | None = None
               ) -> tuple[np.ndarray, int]:
    """Decode a single-component JPEG-LS stream.

    Returns (array, precision); dtype is uint8 for precision <= 8 else
    uint16.  Raises JlsError on malformed, truncated, multi-component,
    or DNL-dependent (Y=0) streams.

    expect_hw: when the container (DICOM Rows/Columns) already knows the
    size, mismatching SOF55 dims fail before the sample loop runs.
    """
    if len(data) < 4 or data[0] != 0xFF or data[1] != _SOI:
        raise JlsError("not a JPEG-LS stream (missing SOI)")
    pos = 2
    precision = h = w = None
    maxval = None
    thresholds = None
    reset = 64
    while True:
        if pos + 4 > len(data):
            raise JlsError("truncated marker segment")
        if data[pos] != 0xFF:
            raise JlsError(f"expected marker, got 0x{data[pos]:02x}")
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1  # optional FF fill bytes before a marker code
        if pos + 1 >= len(data):
            raise JlsError("truncated marker stream")
        marker = data[pos + 1]
        pos += 2
        if marker == _EOI:
            raise JlsError("EOI before scan data")
        if pos + 2 > len(data):
            # FF-fill skipping can outrun the pos+4 loop-top check
            raise JlsError("truncated marker stream")
        (seg_len,) = struct.unpack_from(">H", data, pos)
        if pos + seg_len > len(data):
            raise JlsError("marker segment overruns stream")
        seg = data[pos + 2:pos + seg_len]
        if marker == _SOF55:
            if len(seg) < 6:
                raise JlsError("truncated SOF55 segment")
            precision, h, w, nf = struct.unpack_from(">BHHB", seg, 0)
            if nf != 1:
                raise JlsError(
                    f"multi-component JPEG-LS unsupported (Nf={nf})")
            if h == 0:
                raise JlsError("DNL-deferred height unsupported")
            if not 2 <= precision <= 16:
                raise JlsError(f"precision {precision} out of range")
            if h * w > 1 << 28:
                # decode-size DoS bound (matches j2k/jpg/lossless): fail
                # before the output-plane allocation, not with MemoryError
                raise JlsError(f"implausible frame size {h}x{w}")
        elif marker == _LSE:
            if len(seg) < 1 or (seg[0] == 1 and len(seg) < 11):
                raise JlsError("truncated LSE segment")
            if seg[0] == 1:  # preset coding parameters
                maxval, t1, t2, t3, reset = struct.unpack_from(
                    ">HHHHH", seg, 1)
                thresholds = (t1, t2, t3) if (t1 or t2 or t3) else None
            else:
                raise JlsError(f"unsupported LSE ID {seg[0]}")
        elif marker == _SOS:
            if precision is None:
                raise JlsError("SOS before SOF55")
            if len(seg) < 5:
                raise JlsError("truncated SOS segment")
            ns = seg[0]
            if ns != 1:
                raise JlsError(
                    f"multi-component scan unsupported (Ns={ns})")
            near = seg[1 + 2 * ns]
            ilv = seg[2 + 2 * ns]
            if ilv != 0:
                raise JlsError(f"interleave mode {ilv} unsupported")
            pos += seg_len
            if expect_hw is not None and (h, w) != expect_hw:
                # fail BEFORE the per-sample LOCO-I loop: a hostile
                # stream declaring huge dims against a small DICOM
                # Rows/Columns would otherwise burn minutes of CPU
                # before the caller's post-decode shape check
                raise JlsError(f"SOF55 size {h}x{w} != expected "
                               f"{expect_hw}")
            if maxval is None or maxval == 0:
                maxval = (1 << precision) - 1
            if maxval > (1 << precision) - 1:
                # an oversized LSE MAXVAL would decode samples beyond
                # the declared precision and silently wrap in the final
                # astype (the encoder enforces this same invariant)
                raise JlsError(f"LSE MAXVAL {maxval} exceeds precision "
                               f"{precision}")
            p = _Params(maxval, near, reset or 64, thresholds)
            reader = _BitReader(data, pos)
            img = _decode_scan(reader, h, w, p)
            dtype = np.uint8 if precision <= 8 else np.uint16
            return img.astype(dtype), precision
        elif 0xD0 <= marker <= 0xD7:
            raise JlsError("restart intervals unsupported")
        # APPn / COM / other tables: skip
        pos += seg_len
