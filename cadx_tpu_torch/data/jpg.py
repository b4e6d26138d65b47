"""Baseline / extended sequential JPEG (lossy DCT) decoder — pure Python.

The port's own copy of `cadx_tpu/data/jpg.py`: the DICOM transfer
syntaxes 1.2.840.10008.1.2.4.50 (JPEG baseline, 8-bit) and .51 (JPEG
extended sequential, 12-bit), which the reference's pydicom ecosystem
reads via Pillow (Classes/Preprocessing.py:149). Mammography pixel data
is single-sample, so `jpeg_lossy_decode` (the DICOM path) takes one
component and raises JpegError on multi-component scans;
`jpeg_luma_decode` (the HTTP front's JPEG uploads) returns the first
component of a YCbCr file, which is libjpeg's grayscale output.

Scope: SOF0 (baseline huffman) and SOF1 (extended sequential huffman,
8/12-bit), DHT/DQT/DRI/RSTn, EOB/ZRL AC run-length semantics per ITU
T.81 F.2. The IDCT is the exact float-point 2-D DCT-III (numpy matmul
form); integer-IDCT decoders (libjpeg) may differ by +-1-2 codes, which
is within T.81's decoder accuracy allowance — the tests bound the
difference against cv2/libjpeg on natural images and pin DC-only blocks
exactly.

Verification (tests/test_jpg.py): cv2.imencode produces the fixtures,
so encoder and decoder share no code; plus a self-written minimal
12-bit SOF1 encoder for the .51 path (cv2 cannot emit 12-bit).
"""

from __future__ import annotations

import struct

import numpy as np


class JpegError(ValueError):
    """Malformed or unsupported JPEG stream."""


_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# Exact 1-D DCT-III basis: x = C @ X with C[n,k] = a(k) cos((2n+1)k pi/16)
_IDCT_C = np.zeros((8, 8))
for _n in range(8):
    for _k in range(8):
        a = np.sqrt(0.5) if _k == 0 else 1.0
        _IDCT_C[_n, _k] = 0.5 * a * np.cos((2 * _n + 1) * _k * np.pi / 16)


class _HuffTable:
    """Canonical JPEG huffman table -> (maxcode/mincode/valptr) decoder
    (T.81 F.2.2.3 DECODE procedure)."""

    def __init__(self, bits: list[int], vals: bytes):
        self.vals = vals
        code = 0
        k = 0
        self.mincode = [0] * 17
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        for length in range(1, 17):
            if bits[length - 1]:
                self.valptr[length] = k
                self.mincode[length] = code
                code += bits[length - 1]
                k += bits[length - 1]
                self.maxcode[length] = code - 1
            code <<= 1
        if k != len(vals):
            raise JpegError("DHT count mismatch")


class _BitReader:
    """MSB-first entropy reader with 0xFF00 byte-unstuffing and RSTn
    awareness (T.81 F.2.2.5)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self._acc = 0
        self._n = 0

    def bit(self) -> int:
        if self._n == 0:
            if self.pos >= len(self.data):
                raise JpegError("truncated entropy segment")
            b = self.data[self.pos]
            self.pos += 1
            if b == 0xFF:
                if self.pos >= len(self.data):
                    raise JpegError("truncated after 0xFF")
                m = self.data[self.pos]
                if m == 0x00:
                    self.pos += 1
                else:
                    # a real marker: the scan data is exhausted — pad
                    # with 1-bits like libjpeg so a final partial MCU
                    # fails loudly via huffman misdecode, not silently
                    self.pos -= 1
                    self._acc, self._n = 0xFF, 8
                    self._n -= 1
                    return 1
            self._acc, self._n = b, 8
        self._n -= 1
        return (self._acc >> self._n) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align_and_expect_rst(self, idx: int) -> None:
        self._n = 0
        if (self.pos + 1 >= len(self.data)
                or self.data[self.pos] != 0xFF
                or self.data[self.pos + 1] != 0xD0 + (idx & 7)):
            raise JpegError("missing restart marker")
        self.pos += 2

    def decode_huff(self, tab: _HuffTable) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bit()
            if code <= tab.maxcode[length]:
                return tab.vals[tab.valptr[length]
                                + (code - tab.mincode[length])]
        raise JpegError("invalid huffman code")


def _extend(v: int, t: int) -> int:
    """EXTEND (T.81 F.2.2.1): map t-bit magnitude to signed value."""
    return v - (1 << t) + 1 if t and v < (1 << (t - 1)) else v


def jpeg_lossy_decode(data: bytes,
                      expect_hw: tuple[int, int] | None = None
                      ) -> tuple[np.ndarray, int]:
    """Decode a single-component sequential-huffman JPEG.

    Returns (array, precision); dtype uint8 for precision 8, uint16 for
    12. Raises JpegError on malformed, multi-component, progressive, or
    arithmetic-coded streams.

    expect_hw: when the container (DICOM Rows/Columns) already knows the
    size, mismatching SOF dims fail before the entropy scan runs.
    """
    return _decode(data, expect_hw, luma=False)


def jpeg_luma_decode(data: bytes) -> tuple[np.ndarray, int]:
    """The first component of a sequential-huffman JPEG file: the plane of
    a grayscale file, the Y plane of a YCbCr one (one interleaved scan of
    all three components, any chroma subsampling, or a first scan of Y
    alone). That is libjpeg's grayscale output, what cv2.imread's
    IMREAD_GRAYSCALE returns, up to the IDCT's +-1-2 codes. Adobe RGB
    (transform 0), CMYK/YCCK, and a Y plane subsampled against another
    component raise JpegError, as multi-scan layouts other than the two
    above do."""
    return _decode(data, None, luma=True)


def _decode(data: bytes, expect_hw, luma: bool) -> tuple[np.ndarray, int]:
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError("not a JPEG stream (missing SOI)")
    pos = 2
    qtables: dict[int, np.ndarray] = {}
    htables: dict[tuple[int, int], _HuffTable] = {}  # (class, id)
    precision = h = w = None
    comps: list[tuple[int, int, int, int]] = []  # (id, H, V, Tq)
    adobe_transform = None
    restart_interval = 0
    while True:
        if pos + 4 > len(data):
            raise JpegError("truncated marker stream")
        if data[pos] != 0xFF:
            raise JpegError(f"expected marker, got 0x{data[pos]:02x}")
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1  # FF fill
        if pos + 1 >= len(data):
            raise JpegError("truncated marker stream")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            raise JpegError("EOI before scan data")
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue  # TEM / stray RST: no segment body
        if pos + 2 > len(data):
            # FF-fill skipping can outrun the pos+4 loop-top check
            raise JpegError("truncated marker stream")
        (seg_len,) = struct.unpack_from(">H", data, pos)
        if seg_len < 2 or pos + seg_len > len(data):
            raise JpegError("marker segment overruns stream")
        seg = data[pos + 2:pos + seg_len]
        if marker in (0xC0, 0xC1):  # SOF0 baseline / SOF1 extended
            if len(seg) < 9:
                raise JpegError("truncated SOF segment")
            precision, h, w, nf = struct.unpack_from(">BHHB", seg, 0)
            if nf != 1 and not (luma and nf == 3):
                raise JpegError(
                    f"multi-component JPEG unsupported (Nf={nf})")
            if precision not in (8, 12):
                raise JpegError(f"precision {precision} unsupported")
            if h == 0 or w == 0:
                raise JpegError("DNL-deferred or zero size unsupported")
            if len(seg) < 6 + 3 * nf:
                raise JpegError("truncated SOF segment")
            # seg = P Y Y X X Nf, then per component: Ci, HiVi, Tqi
            if not luma and seg[7] != 0x11:
                raise JpegError("subsampled single component nonsensical")
            if h * w > 1 << 28:
                # decode-size DoS bound (matches j2k/jls/lossless): a
                # hostile SOF would otherwise drive multi-GiB coefficient
                # allocations before the DICOM Rows/Columns check
                raise JpegError(f"implausible frame size {h}x{w}")
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4, seg[7 + 3 * c] & 15,
                      seg[8 + 3 * c]) for c in range(nf)]
            if nf == 1:  # one component: one block an MCU, whatever H, V
                comps = [(comps[0][0], 1, 1, comps[0][3])]
            if any(not (1 <= hv <= 4) for c in comps for hv in c[1:3]):
                raise JpegError("sampling factor outside 1..4")
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise JpegError(
                f"non-sequential-huffman SOF 0x{marker:02x} unsupported")
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xC4:  # DHT
            off = 0
            while off < len(seg):
                tc, th = seg[off] >> 4, seg[off] & 15
                bits = list(seg[off + 1:off + 17])
                if len(bits) < 16:
                    raise JpegError("truncated DHT segment")
                n = sum(bits)
                vals = bytes(seg[off + 17:off + 17 + n])
                htables[(tc, th)] = _HuffTable(bits, vals)
                off += 17 + n
        elif marker == 0xDB:  # DQT
            off = 0
            while off < len(seg):
                pq, tq = seg[off] >> 4, seg[off] & 15
                if pq:
                    if off + 129 > len(seg):
                        raise JpegError("truncated DQT segment")
                    q = np.frombuffer(seg[off + 1:off + 129],
                                      ">u2").astype(np.int32)
                    off += 129
                else:
                    q = np.frombuffer(seg[off + 1:off + 65],
                                      np.uint8).astype(np.int32)
                    off += 65
                if q.size != 64:
                    raise JpegError("short DQT")
                qtables[tq] = q
        elif marker == 0xDD:  # DRI
            if len(seg) < 2:
                raise JpegError("truncated DRI segment")
            (restart_interval,) = struct.unpack_from(">H", seg, 0)
        elif marker == 0xDA:  # SOS
            if precision is None:
                raise JpegError("SOS before SOF")
            ns = seg[0] if seg else 0
            if len(seg) < 4 + 2 * ns:
                raise JpegError("truncated SOS segment")
            if ns != 1 and not (luma and ns == len(comps)):
                raise JpegError(f"multi-component scan unsupported (Ns={ns})")
            scan = [(seg[1 + 2 * k], seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15)
                    for k in range(ns)]
            ss, se, ah_al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            if ss != 0 or se != 63 or ah_al != 0:
                raise JpegError("non-sequential spectral selection")
            pos += seg_len
            break
        pos += seg_len
    if expect_hw is not None and (h, w) != expect_hw:
        # fail before the per-coefficient huffman loop (hostile streams
        # declaring huge dims against a small DICOM Rows/Columns)
        raise JpegError(f"SOF size {h}x{w} != expected {expect_hw}")
    if luma and len(comps) == 3 and (adobe_transform == 0 or bytes(
            c[0] for c in comps) == b"RGB"):
        raise JpegError("RGB-coded JPEG unsupported (no YCbCr transform)")
    ids = [c[0] for c in comps]
    if any(cs not in ids for cs, _, _ in scan):
        raise JpegError("scan names an undeclared component")
    if scan[0][0] != comps[0][0]:
        raise JpegError("first scan does not hold the first component")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if (comps[0][1], comps[0][2]) != (hmax, vmax):
        raise JpegError("first component subsampled against another")
    # per scan component: (H, V, quant, dc table, ac table), Y first
    units = []
    for cs, td, ta in scan:
        _, hi, vi, tq = comps[ids.index(cs)]
        if tq not in qtables:
            raise JpegError(f"quant table {tq} undeclared")
        if (0, td) not in htables or (1, ta) not in htables:
            raise JpegError("huffman tables undeclared")
        units.append((hi, vi, htables[(0, td)], htables[(1, ta)]))
    quant = qtables[comps[0][3]]
    if len(scan) == 1:  # non-interleaved: the first component's own grid
        mcus_x, mcus_y, hy, vy = (w + 7) // 8, (h + 7) // 8, 1, 1
        units = [(1, 1) + units[0][2:]]
    else:
        mcus_x = (w + 8 * hmax - 1) // (8 * hmax)
        mcus_y = (h + 8 * vmax - 1) // (8 * vmax)
        hy, vy = hmax, vmax
    bw, bh = mcus_x * hy, mcus_y * vy
    coefs = np.zeros((bh * bw, 64), np.int32)
    block = np.zeros(64, np.int32)
    r = _BitReader(data, pos)
    preds = [0] * len(units)
    for mi in range(mcus_x * mcus_y):
        if restart_interval and mi and mi % restart_interval == 0:
            r.align_and_expect_rst(mi // restart_interval - 1)
            preds = [0] * len(units)
        my, mx = divmod(mi, mcus_x)
        for u, (hi, vi, dc_tab, ac_tab) in enumerate(units):
            for v in range(vi):
                for hh in range(hi):
                    # only the first component's coefficients are kept
                    out = (coefs[(my * vy + v) * bw + mx * hy + hh] if u == 0
                           else block)
                    preds[u] = _decode_block(r, dc_tab, ac_tab, preds[u], out)

    # dequantize -> de-zigzag -> exact 2-D IDCT -> level shift
    deq = (coefs * quant[None, :]).astype(np.float64)
    blocks = np.zeros((bh * bw, 64), np.float64)
    blocks[:, _ZIGZAG] = deq
    blocks = blocks.reshape(-1, 8, 8)
    spatial = np.einsum("nk,bkl,ml->bnm", _IDCT_C, blocks, _IDCT_C)
    level = 1 << (precision - 1)
    maxval = (1 << precision) - 1
    img = np.rint(spatial + level).clip(0, maxval)
    # blocks -> image plane, crop the right/bottom padding
    img = img.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
        bh * 8, bw * 8)[:h, :w]
    dtype = np.uint8 if precision == 8 else np.uint16
    return img.astype(dtype), precision


def _decode_block(r: _BitReader, dc_tab: _HuffTable, ac_tab: _HuffTable,
                  pred: int, out: np.ndarray) -> int:
    """One block's DC difference and AC run-lengths into `out` (zigzag
    order); returns the new DC predictor."""
    t = r.decode_huff(dc_tab)
    if t > 15:
        raise JpegError("DC magnitude category > 15")
    pred += _extend(r.bits(t), t)
    out[0] = pred
    k = 1
    while k < 64:
        rs = r.decode_huff(ac_tab)
        rr, ssz = rs >> 4, rs & 15
        if ssz == 0:
            if rr == 15:  # ZRL
                k += 16
                continue
            break  # EOB
        k += rr
        if k > 63:
            raise JpegError("AC run past block end")
        out[k] = _extend(r.bits(ssz), ssz)
        k += 1
    return pred
