"""JPEG (lossy DCT) decoders — pure Python on numpy.

Two entry points with two contracts, sharing the IDCT (`_samples`):

- `jpeg_lossy_decode`, the DICOM path: the port's own copy of
  `cadx_tpu/data/jpg.py` for the transfer syntaxes 1.2.840.10008.1.2.4.50
  (JPEG baseline, 8-bit) and .51 (JPEG extended sequential, 12-bit),
  which the reference's pydicom ecosystem reads via Pillow
  (Classes/Preprocessing.py:149). Mammography pixel data is
  single-sample: one component, SOF0/SOF1, DHT/DQT/DRI/RSTn, EOB/ZRL
  run-lengths per ITU T.81 F.2, read a bit at a time; a stream cut short
  raises JpegError where JAX's does, so the two packages agree on every
  hostile frame the DICOM tests feed them.
- `jpeg_luma_decode`, the HTTP front's uploads: what cv2.imread's
  IMREAD_GRAYSCALE returns through libjpeg-turbo, for baseline, extended
  and progressive huffman files, any scan layout, gray, YCbCr, Adobe RGB,
  CMYK and YCCK, subsampled components upsampled as jdsample.c does; a
  segment cut short reads as zeros, as libjpeg reads it; an abbreviated
  stream after its tables-only stream. `frame_planes` gives the
  components themselves (no conversion, or YCbCr to RGB), as libtiff's
  JPEG codec asks libjpeg for them. Their entropy decoders look codes up
  16 bits at a time, so a 3328 x 2560 progressive frame decodes in
  seconds.

The DICOM path's IDCT is the exact floating-point 2-D DCT-III (numpy
matmul form), as JAX's: integer-IDCT decoders (libjpeg) may differ by
+-1-2 codes, within T.81's decoder accuracy allowance. The upload path's
8-bit frames go through libjpeg's own integer IDCT (`_islow`, jidctint.c
with its range limit), so they come out bit-exact to cv2; 12-bit ones
keep the float IDCT.

Verification (tests/test_jpg.py): cv2.imencode produces the fixtures,
so encoder and decoder share no code; plus a self-written minimal
12-bit SOF1 encoder for the .51 path (cv2 cannot emit 12-bit).
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
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
    return _decode(data, expect_hw)


def _decode(data: bytes, expect_hw) -> tuple[np.ndarray, int]:
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError("not a JPEG stream (missing SOI)")
    pos = 2
    qtables: dict[int, np.ndarray] = {}
    htables: dict[tuple[int, int], _HuffTable] = {}  # (class, id)
    precision = h = w = None
    comps: list[tuple[int, int, int, int]] = []  # (id, H, V, Tq)
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
            if nf != 1:
                raise JpegError(
                    f"multi-component JPEG unsupported (Nf={nf})")
            if precision not in (8, 12):
                raise JpegError(f"precision {precision} unsupported")
            if h == 0 or w == 0:
                raise JpegError("DNL-deferred or zero size unsupported")
            if len(seg) < 6 + 3 * nf:
                raise JpegError("truncated SOF segment")
            # seg = P Y Y X X Nf, then per component: Ci, HiVi, Tqi
            if seg[7] != 0x11:
                raise JpegError("subsampled single component nonsensical")
            if h * w > 1 << 28:
                # decode-size DoS bound (matches j2k/jls/lossless): a
                # hostile SOF would otherwise drive multi-GiB coefficient
                # allocations before the DICOM Rows/Columns check
                raise JpegError(f"implausible frame size {h}x{w}")
            comps = [(seg[6], 1, 1, seg[8])]
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise JpegError(
                f"non-sequential-huffman SOF 0x{marker:02x} unsupported")
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
            if ns != 1:
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
    (cs, td, ta), = scan
    if cs != comps[0][0]:
        raise JpegError("scan names an undeclared component")
    tq = comps[0][3]
    if tq not in qtables:
        raise JpegError(f"quant table {tq} undeclared")
    if (0, td) not in htables or (1, ta) not in htables:
        raise JpegError("huffman tables undeclared")
    units = [(1, 1, htables[(0, td)], htables[(1, ta)])]
    quant = qtables[tq]
    mcus_x, mcus_y, hy, vy = (w + 7) // 8, (h + 7) // 8, 1, 1
    bw, bh = mcus_x, mcus_y
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

    return _samples(coefs, quant, bh, bw, h, w, precision), precision


def _samples(coefs: np.ndarray, quant: np.ndarray, bh: int, bw: int, h: int,
             w: int, precision: int, islow: bool = False) -> np.ndarray:
    """(bh * bw, 64) zigzag coefficients of a component -> its (h, w)
    samples: dequantize, de-zigzag, 2-D IDCT, level shift, crop the
    right/bottom padding. The IDCT is the exact float one, or with
    `islow` (8 bits) libjpeg's integer one (`_islow`). The IDCT runs on
    threads over chunks of blocks (numpy releases the GIL; each block's
    result is the same whatever the chunk)."""
    level = 1 << (precision - 1)
    maxval = (1 << precision) - 1
    dtype = np.uint8 if precision == 8 else np.uint16

    def idct(c: np.ndarray) -> np.ndarray:
        if islow:
            return _islow(c, quant)
        blocks = np.zeros((len(c), 64), np.float64)
        blocks[:, _ZIGZAG] = (c * quant[None, :]).astype(np.float64)
        spatial = np.einsum("nk,bkl,ml->bnm", _IDCT_C, blocks.reshape(-1, 8, 8), _IDCT_C)
        return np.rint(spatial + level).clip(0, maxval).astype(dtype)

    chunks = np.array_split(coefs, max(1, min(os.cpu_count() or 1, 8, len(coefs) // 512)))
    with concurrent.futures.ThreadPoolExecutor(len(chunks)) as pool:
        img = np.concatenate(list(pool.map(idct, chunks)))
    return img.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)[:h, :w]


# libjpeg's jidctint.c (jpeg_idct_islow): 13-bit constants, two passes
_FIX = {k: v for k, v in zip(
    ("0_298631336", "0_390180644", "0_541196100", "0_765366865", "0_899976223", "1_175875602",
     "1_501321110", "1_847759065", "1_961570560", "2_053119869", "2_562915447", "3_072711026"),
    (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819, 20995, 25172))}
# the post-IDCT range limit, indexed by the value & 1023: x + 128 clipped for
# |x| < 512 (libjpeg's prepare_range_limit_table)
_RANGE = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                         np.arange(0, 128)]).astype(np.uint8)


def _islow_1d(x: list, shift: int) -> list:
    """One pass of jpeg_idct_islow over the 8 inputs x[0..7] (arrays),
    descaled by `shift` bits."""
    f = _FIX
    z1 = (x[2] + x[6]) * f["0_541196100"]
    tmp2 = z1 - x[6] * f["1_847759065"]
    tmp3 = z1 + x[2] * f["0_765366865"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0, t1, t2, t3 = (t0 * f["0_298631336"], t1 * f["2_053119869"], t2 * f["3_072711026"],
                      t3 * f["1_501321110"])
    z1, z2 = z1 * -f["0_899976223"], z2 * -f["2_562915447"]
    z3, z4 = z3 * -f["1_961570560"] + z5, z4 * -f["0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                          tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _islow(c: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg's integer IDCT of (N, 64) zigzag coefficients -> (N, 8, 8)
    uint8, bit-exact: columns descaled by 11 bits, rows by 18, then the
    range limit."""
    d = np.zeros((len(c), 64), np.int64)
    d[:, _ZIGZAG] = c.astype(np.int64) * quant[None, :]
    d = d.reshape(-1, 8, 8)
    cols = _islow_1d([d[:, k, :] for k in range(8)], 11)     # [n, col] for each row k
    ws = np.stack(cols, axis=1)                                 # [n, row, col]
    rows = _islow_1d([ws[:, :, k] for k in range(8)], 18)      # [n, row] for each col k
    return _RANGE[np.stack(rows, axis=2) & 1023]


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


# ---- the upload reader: every huffman layout cv2 reads, progressive too ------

_SEQUENTIAL, _PROGRESSIVE = (0xC0, 0xC1), 0xC2


@functools.lru_cache(maxsize=64)
def _lookup(counts: bytes, vals: bytes) -> list:
    """A DHT table as 65536 entries indexed by the next 16 bits: (code
    length << 8) | symbol, 0 where no code starts."""
    look = [0] * 65536
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(vals) or code >= 1 << length:
                raise JpegError("bad DHT table")
            lo, n = code << (16 - length), 1 << (16 - length)
            look[lo:lo + n] = [(length << 8) | vals[k]] * n
            code += 1
            k += 1
        code <<= 1
    return look


def _entropy_segments(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """The entropy-coded data of the scan at pos, cut at its RSTn markers
    and unstuffed, and the position of the marker that ends the scan (the
    end of the data where none does, which libjpeg reads as zeros)."""
    segs, start, i = [], pos, pos
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= len(data):
            segs.append(data[start:].replace(b"\xff\x00", b"\xff"))
            return segs, len(data)
        m = data[j + 1]
        if m == 0x00 or m == 0xFF:
            i = j + (2 if m == 0x00 else 1)
        elif 0xD0 <= m <= 0xD7:
            segs.append(data[start:j].replace(b"\xff\x00", b"\xff"))
            start = i = j + 2
        else:
            segs.append(data[start:j].replace(b"\xff\x00", b"\xff"))
            return segs, j


class _Component:
    """A frame component: its sampling factors, its quantization table and
    the block grid its coefficients are stored on (the MCU-padded grid of
    an interleaved frame), at `first` in the frame's coefficient array."""

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None
        self.bw = self.bh = self.first = 0


class _Frame:
    """A frame header, its components and their coefficients; `tables` is
    the file's quantization tables by id, as DQT segments define them."""

    def __init__(self, seg: bytes, progressive: bool, tables: dict):
        if len(seg) < 6:
            raise JpegError("truncated SOF segment")
        self.precision, self.h, self.w, nf = struct.unpack_from(">BHHB", seg, 0)
        if self.precision not in (8, 12):
            raise JpegError(f"precision {self.precision} unsupported")
        if self.h == 0 or self.w == 0:
            raise JpegError("DNL-deferred or zero size unsupported")
        if self.h * self.w > 1 << 28:
            raise JpegError(f"implausible frame size {self.h}x{self.w}")
        if nf not in (1, 3, 4) or len(seg) < 6 + 3 * nf:
            raise JpegError(f"{nf} components unsupported")
        self.progressive, self.tables = progressive, tables
        self.comps = [_Component(seg[6 + 3 * c], seg[7 + 3 * c] >> 4, seg[7 + 3 * c] & 15,
                                 seg[8 + 3 * c]) for c in range(nf)]
        self.sampling = [(c.h, c.v) for c in self.comps]   # as the SOF gives them
        if nf == 1:  # one component: one block an MCU, whatever H, V
            self.comps[0].h = self.comps[0].v = 1
        if any(not (1 <= f <= 4) for c in self.comps for f in (c.h, c.v)):
            raise JpegError("sampling factor outside 1..4")
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcus_x = -(-self.w // (8 * self.hmax))
        self.mcus_y = -(-self.h // (8 * self.vmax))
        first = 0
        for c in self.comps:
            if nf == 1:
                c.bw, c.bh = -(-self.w // 8), -(-self.h // 8)
            else:
                c.bw, c.bh = self.mcus_x * c.h, self.mcus_y * c.v
            c.first = first
            first += c.bw * c.bh
        self.coefs = np.zeros((first, 64), np.int32)

    def comp_dims(self, c: _Component) -> tuple[int, int]:
        """The component's sample rows and columns."""
        return -(-self.h * c.v // self.vmax), -(-self.w * c.h // self.hmax)


def _scan_units(f: _Frame, comps: list) -> tuple[list, list, int]:
    """A scan's blocks in decode order: (global block index, the scan
    component it belongs to) and the blocks an MCU (the restart
    interval's unit). A one-component scan walks that component's own
    block grid in raster order; an interleaved one MCU by MCU."""
    if len(comps) == 1:
        c = comps[0]
        rows, cols = f.comp_dims(c)
        by, bx = -(-rows // 8), -(-cols // 8)
        blocks = (c.first + np.arange(by)[:, None] * c.bw + np.arange(bx)).ravel()
        return blocks.tolist(), [0] * len(blocks), 1
    parts, slots = [], []
    my, mx = np.arange(f.mcus_y)[:, None], np.arange(f.mcus_x)[None, :]
    for k, c in enumerate(comps):
        for v in range(c.v):
            for h in range(c.h):
                parts.append(c.first + (my * c.v + v) * c.bw + mx * c.h + h)
                slots.append(k)
    blocks = np.stack(parts, axis=-1).reshape(-1)
    return blocks.tolist(), slots * (f.mcus_x * f.mcus_y), len(parts)


def _decode_scan(data: bytes, pos: int, f: _Frame, seg: bytes, htables: dict,
                 restart: int, keep: set) -> int:
    """Decode the scan whose SOS body is seg (entropy data at pos) into
    f.coefs; returns the position of the marker after it. Components not
    in `keep` are parsed where they share an MCU with a kept one and
    skipped where a scan holds them alone."""
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
        raise JpegError("bad SOS segment")
    by_id = {c.id: c for c in f.comps}
    comps, dcs, acs = [], [], []
    for k in range(ns):
        c = by_id.get(seg[1 + 2 * k])
        if c is None:
            raise JpegError("scan names an undeclared component")
        comps.append(c)
        dcs.append(htables.get((0, seg[2 + 2 * k] >> 4)))
        acs.append(htables.get((1, seg[2 + 2 * k] & 15)))
    ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
    if f.progressive:
        ok = (ss == 0 and se == 0) or (1 <= ss <= se <= 63 and ns == 1)
        if not ok or al > 13 or (ah and ah != al + 1):
            raise JpegError("bad progressive scan parameters")
    elif ss != 0 or se != 63 or ah or al:
        raise JpegError("non-sequential spectral selection")
    if ns > 1 and sum(c.h * c.v for c in comps) > 10:
        raise JpegError("MCU of more than 10 blocks")
    segs, end = _entropy_segments(data, pos)
    kept = [c.id in keep for c in comps]
    if not any(kept):
        return end
    for c in comps:
        if c.quant is None:  # libjpeg latches a component's table at its first scan
            c.quant = f.tables.get(c.tq)
            if c.quant is None:
                raise JpegError(f"quant table {c.tq} undeclared")
    need_dc = not f.progressive or (ss == 0 and ah == 0)
    need_ac = not f.progressive or ss > 0
    if (need_dc and None in dcs) or (need_ac and None in acs):
        raise JpegError("huffman tables undeclared")
    blocks, slots, per_mcu = _scan_units(f, comps)
    step = restart * per_mcu if restart else max(len(blocks), 1)
    # each restart interval's data, zero-padded, with its blocks
    intervals = [((segs[i] if i < len(segs) else b"") + bytes(8), lo, min(lo + step, len(blocks)))
                 for i, lo in enumerate(range(0, len(blocks), step))]
    flat = f.coefs.reshape(-1)
    idx, val = [], []
    if not f.progressive:
        _sequential(intervals, blocks, slots, kept, dcs, acs, idx, val)
    elif ss == 0 and ah == 0:
        _dc_first(intervals, blocks, slots, kept, dcs, al, idx, val)
    elif ss == 0:
        _dc_refine(intervals, blocks, slots, kept, idx)
        flat[np.asarray(idx, np.int64)] |= 1 << al
        return end
    elif ah == 0:
        _ac_first(intervals, blocks, acs[0], ss, se, al, idx, val)
    else:
        corr = _ac_refine(intervals, blocks, acs[0], ss, se, al, f.coefs, idx, val)
        c = flat[corr]
        p1 = 1 << al
        flat[corr] = np.where(c & p1, c, c + np.where(c >= 0, p1, -p1))
    flat[np.asarray(idx, np.int64)] = np.asarray(val, np.int64)
    return end


# The scan decoders below read bits inline from a local accumulator: acc
# holds the n bits not yet read of buf up to p, refilled 32 bits at a time
# (at least 32 are held before each symbol: a code of at most 16 bits and
# its value of at most 16), since a method call a symbol would double the
# time of a 3328 x 2560 progressive file. A code is looked up by the next
# 16 bits (`_lookup`); an entry under 0x100 is no code.


def _sequential(intervals, blocks, slots, kept, dcs, acs, idx, val) -> None:
    """A sequential scan: each block's DC difference and AC run-lengths."""
    add_i, add_v = idx.append, val.append
    for buf, lo, hi in intervals:
        p = acc = n = 0
        pred = [0] * len(dcs)
        for u in range(lo, hi):
            k = slots[u]
            if n < 32:
                acc = ((acc & ((1 << n) - 1)) << 32) | int.from_bytes(buf[p:p + 4], "big")
                p, n = p + 4, n + 32
            e = dcs[k][(acc >> (n - 16)) & 0xFFFF]
            if e < 0x100 or e & 0xFF > 15:
                raise JpegError("bad DC code")
            n -= e >> 8
            t = e & 0xFF
            if t:
                n -= t
                v = (acc >> n) & ((1 << t) - 1)
                pred[k] += v - (1 << t) + 1 if v < (1 << (t - 1)) else v
            keep, look, base = kept[k], acs[k], blocks[u] * 64
            if keep:
                add_i(base)
                add_v(pred[k])
            z = 1
            while z < 64:
                if n < 32:
                    acc = ((acc & ((1 << n) - 1)) << 32) | int.from_bytes(buf[p:p + 4], "big")
                    p, n = p + 4, n + 32
                e = look[(acc >> (n - 16)) & 0xFFFF]
                if e < 0x100:
                    raise JpegError("invalid huffman code")
                n -= e >> 8
                s = e & 15
                if s:
                    z += (e >> 4) & 15
                    if z > 63:
                        raise JpegError("AC run past block end")
                    n -= s
                    if keep:
                        v = (acc >> n) & ((1 << s) - 1)
                        add_i(base + z)
                        add_v(v - (1 << s) + 1 if v < (1 << (s - 1)) else v)
                    z += 1
                elif e & 0xFF == 0xF0:
                    z += 16
                else:
                    break


def _dc_first(intervals, blocks, slots, kept, dcs, al, idx, val) -> None:
    """A first DC scan (T.81 G.1.2.1): each block's DC difference, the
    value scaled by 2^al."""
    for buf, lo, hi in intervals:
        p = acc = n = 0
        pred = [0] * len(dcs)
        for u in range(lo, hi):
            k = slots[u]
            if n < 32:
                acc = ((acc & ((1 << n) - 1)) << 32) | int.from_bytes(buf[p:p + 4], "big")
                p, n = p + 4, n + 32
            e = dcs[k][(acc >> (n - 16)) & 0xFFFF]
            if e < 0x100 or e & 0xFF > 15:
                raise JpegError("bad DC code")
            n -= e >> 8
            t = e & 0xFF
            if t:
                n -= t
                v = (acc >> n) & ((1 << t) - 1)
                pred[k] += v - (1 << t) + 1 if v < (1 << (t - 1)) else v
            if kept[k]:
                idx.append(blocks[u] * 64)
                val.append(pred[k] << al)


def _dc_refine(intervals, blocks, slots, kept, idx) -> None:
    """A refining DC scan: one bit a block; idx gets the blocks whose bit
    is 1."""
    for buf, lo, hi in intervals:
        bits = np.unpackbits(np.frombuffer(buf, np.uint8))
        idx.extend(blocks[u] * 64 for u in range(lo, hi) if bits[u - lo] and kept[slots[u]])


def _ac_first(intervals, blocks, look, ss, se, al, idx, val) -> None:
    """A first AC scan of one component (T.81 G.1.2.2): run-lengths within
    the band [ss, se], values scaled by 2^al, EOB runs across blocks."""
    add_i, add_v = idx.append, val.append
    for buf, lo, hi in intervals:
        p = acc = n = eobrun = 0
        for u in range(lo, hi):
            if eobrun:
                eobrun -= 1
                continue
            base, z = blocks[u] * 64, ss
            while z <= se:
                if n < 32:
                    acc = ((acc & ((1 << n) - 1)) << 32) | int.from_bytes(buf[p:p + 4], "big")
                    p, n = p + 4, n + 32
                e = look[(acc >> (n - 16)) & 0xFFFF]
                if e < 0x100:
                    raise JpegError("invalid huffman code")
                n -= e >> 8
                rr, s = (e >> 4) & 15, e & 15
                if s:
                    z += rr
                    if z > 63:
                        raise JpegError("AC run past block end")
                    n -= s
                    v = (acc >> n) & ((1 << s) - 1)
                    add_i(base + z)
                    add_v((v - (1 << s) + 1 if v < (1 << (s - 1)) else v) << al)
                    z += 1
                elif rr == 15:
                    z += 16
                else:
                    eobrun = 1 << rr
                    if rr:
                        n -= rr
                        eobrun += (acc >> n) & ((1 << rr) - 1)
                    eobrun -= 1
                    break


def _ac_refine(intervals, blocks, look, ss, se, al, coefs, idx, val) -> np.ndarray:
    """A refining AC scan of one component (T.81 G.1.2.3, libjpeg's
    decode_mcu_AC_refine): new coefficients of +-2^al placed after runs of
    zeros, and a correction bit for each coefficient already nonzero that a
    run or an EOB run passes. Only coefficients nonzero before the scan
    take a correction bit, so their positions are found for all blocks at
    once, a run jumps over its zeros, and the correction bits between two
    symbols are read as one integer, recorded with the index of their
    first coefficient in that list and expanded with numpy at the end.
    New coefficients go to idx and val; returns the flat indices whose
    correction bit is 1."""
    p1, m1 = 1 << al, -(1 << al)
    bl = np.asarray(blocks, np.int64)
    rows, cols_np = np.nonzero(coefs[bl, ss:se + 1])
    starts = np.searchsorted(rows, np.arange(len(bl) + 1)).tolist()
    cols = (cols_np + ss).tolist()
    firsts, counts, words = [], [], []   # correction bits: where, how many, which
    for buf, lo, hi in intervals:
        p = acc = n = eobrun = 0
        for u in range(lo, hi):
            j, end = starts[u], starts[u + 1]
            base, z = blocks[u] * 64, ss
            while not eobrun and z <= se:
                if n < 32:
                    acc = ((acc & ((1 << n) - 1)) << 32) | int.from_bytes(buf[p:p + 4], "big")
                    p, n = p + 4, n + 32
                e = look[(acc >> (n - 16)) & 0xFFFF]
                if e < 0x100:
                    raise JpegError("invalid huffman code")
                n -= e >> 8
                rr, s = (e >> 4) & 15, e & 15
                if s:
                    n -= 1
                    s = p1 if (acc >> n) & 1 else m1
                elif rr != 15:
                    eobrun = 1 << rr
                    if rr:
                        n -= rr
                        eobrun += (acc >> n) & ((1 << rr) - 1)
                    break
                # pass rr zeros and the nonzero coefficients between, which
                # take one correction bit each, read together
                j0 = j
                while True:
                    gap = (cols[j] if j < end else se + 1) - z
                    if rr < gap:
                        z += rr
                        break
                    rr -= gap
                    z += gap + 1
                    if z > se + 1:
                        break
                    j += 1
                cnt = j - j0
                if cnt:
                    while n < cnt:
                        acc = ((acc & ((1 << n) - 1)) << 32) | int.from_bytes(buf[p:p + 4], "big")
                        p, n = p + 4, n + 32
                    n -= cnt
                    firsts.append(j0)
                    counts.append(cnt)
                    words.append((acc >> n) & ((1 << cnt) - 1))
                if s and z <= se:
                    idx.append(base + z)
                    val.append(s)
                z += 1
            if eobrun:
                # in an EOB run (the block that read the EOB is its first): a
                # correction bit for each nonzero coefficient left
                cnt = end - j
                if cnt:
                    while n < cnt:
                        acc = ((acc & ((1 << n) - 1)) << 32) | int.from_bytes(buf[p:p + 4], "big")
                        p, n = p + 4, n + 32
                    n -= cnt
                    firsts.append(j)
                    counts.append(cnt)
                    words.append((acc >> n) & ((1 << cnt) - 1))
                eobrun -= 1
    # bit t of a chunk (from its most significant) is coefficient first + t's
    counts_np = np.asarray(counts, np.int64)
    chunk = np.repeat(np.arange(len(counts_np)), counts_np)
    t = np.arange(len(chunk)) - np.repeat(np.cumsum(counts_np) - counts_np, counts_np)
    shift = (counts_np[chunk] - 1 - t).astype(np.uint64)
    hit = ((np.asarray(words, np.uint64)[chunk] >> shift) & np.uint64(1)) == 1
    at = np.asarray(firsts, np.int64)[chunk][hit] + t[hit]
    return bl[rows[at]] * 64 + cols_np[at] + ss


def _tables_only(tables: bytes, htables: dict, quant: dict) -> None:
    """The DQT and DHT segments of an abbreviated tables-only stream (SOI,
    tables, EOI; TIFF's JPEGTables) into htables and quant, as libjpeg
    keeps them for the image streams read after it."""
    if len(tables) < 4 or tables[0] != 0xFF or tables[1] != 0xD8:
        raise JpegError("JPEG tables without SOI")
    pos = 2
    while pos + 4 <= len(tables) and tables[pos] == 0xFF:
        marker = tables[pos + 1]
        if marker == 0xD9:
            return
        (n,) = struct.unpack_from(">H", tables, pos + 2)
        seg = tables[pos + 4:pos + 2 + n]
        if marker == 0xC4:
            _dht(seg, htables)
        elif marker == 0xDB:
            _dqt(seg, quant)
        elif marker not in (0xDD, 0xFE) and not 0xE0 <= marker <= 0xEF:
            raise JpegError(f"marker 0x{marker:02x} in a tables-only stream")
        pos += 2 + n


def _dht(seg: bytes, htables: dict) -> None:
    off = 0
    while off < len(seg):
        counts = bytes(seg[off + 1:off + 17])
        if len(counts) < 16 or seg[off] >> 4 > 1:
            raise JpegError("bad DHT segment")
        n = sum(counts)
        htables[(seg[off] >> 4, seg[off] & 15)] = _lookup(counts, bytes(seg[off + 17:off + 17 + n]))
        off += 17 + n


def _dqt(seg: bytes, quant: dict) -> None:
    off = 0
    while off < len(seg):
        pq, size = seg[off] >> 4, 129 if seg[off] >> 4 else 65
        if off + size > len(seg):
            raise JpegError("truncated DQT segment")
        quant[seg[off] & 15] = np.frombuffer(
            seg[off + 1:off + size], ">u2" if pq else np.uint8).astype(np.int32)
        off += size


def _read_frame(data: bytes, tables: bytes = b"", every: bool = False) -> tuple:
    """Parse a JPEG stream and decode its scans: (frame, libjpeg's colour
    space guess). `tables` is a tables-only stream read first (a TIFF's
    JPEGTables, for its abbreviated strips and tiles). Only the first
    component's coefficients are decoded for a gray or YCbCr frame unless
    `every`."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError("not a JPEG stream (missing SOI)")
    pos, f, jfif, adobe = 2, None, False, None
    htables: dict = {}
    quant: dict = {}
    if tables:
        _tables_only(tables, htables, quant)
    restart = 0
    keep: set = set()
    space = None
    while pos + 2 <= len(data):
        if data[pos] != 0xFF:
            raise JpegError(f"expected marker, got 0x{data[pos]:02x}")
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 1 >= len(data):
            break
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > len(data):
            raise JpegError("truncated marker stream")
        (seg_len,) = struct.unpack_from(">H", data, pos)
        if seg_len < 2 or pos + seg_len > len(data):
            raise JpegError("marker segment overruns stream")
        seg = data[pos + 2:pos + seg_len]
        pos += seg_len
        if marker in _SEQUENTIAL or marker == _PROGRESSIVE:
            if f is not None:
                raise JpegError("second SOF")
            f = _Frame(seg, marker == _PROGRESSIVE, quant)
            space = _colour_space(f, jfif, adobe)
            keep = ({f.comps[0].id} if space in ("gray", "ycc") and not every
                    else {c.id for c in f.comps})
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise JpegError(f"SOF 0x{marker:02x} unsupported")
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xC4:
            _dht(seg, htables)
        elif marker == 0xDB:
            _dqt(seg, quant)
        elif marker == 0xDD:
            if len(seg) < 2:
                raise JpegError("truncated DRI segment")
            (restart,) = struct.unpack_from(">H", seg, 0)
        elif marker == 0xDA:
            if f is None:
                raise JpegError("SOS before SOF")
            pos = _decode_scan(data, pos, f, seg, htables, restart, keep)
    if f is None or any(c.quant is None for c in f.comps if c.id in keep):
        raise JpegError("no scan data")
    return f, space


def jpeg_luma_decode(data: bytes, tables: bytes = b"") -> tuple[np.ndarray, int]:
    """A JPEG file as libjpeg's grayscale output, what cv2.imread's
    IMREAD_GRAYSCALE returns: baseline, extended sequential (8 and 12
    bits) or progressive huffman, any scan layout and restart interval,
    an abbreviated stream after its `tables`. The colour space is
    libjpeg's guess (`_colour_space`): gray and YCbCr give the first
    component's plane; RGB goes to gray as libjpeg's rgb_gray_convert;
    CMYK and YCCK (YCCK to CMYK as libjpeg's ycck_cmyk_convert) as cv2's
    icvCvt_CMYK2Gray_8u_C4C1R; subsampled components are upsampled first
    as libjpeg's jdsample.c does (`_upsampled`). 8-bit frames go through
    libjpeg's integer IDCT and come out bit-exact; 12-bit ones through the
    float IDCT, within +-2 codes. Arithmetic-coded and lossless frames
    raise JpegError."""
    f, space = _read_frame(data, tables)
    return _to_gray(f, space), f.precision


def frame_planes(f: _Frame, ycc_to_rgb: bool = False) -> list:
    """An 8-bit frame's components (`_read_frame` with `every`), each
    upsampled to the frame's size as libjpeg does (int64 planes), with no
    colour conversion (libjpeg's JCS_UNKNOWN, as libtiff asks for it) or,
    with `ycc_to_rgb`, YCbCr converted to RGB (jdcolor.c's ycc_rgb_convert,
    libtiff's JPEGCOLORMODE_RGB)."""
    if f.precision != 8:
        raise JpegError(f"{f.precision}-bit JPEG components unsupported")
    planes = [_upsampled(f, c).astype(np.int64) for c in f.comps]
    if ycc_to_rgb:
        if len(planes) != 3:
            raise JpegError("YCbCr to RGB needs three components")
        planes = ycc_rgb(*planes)
    return planes


def ycc_rgb(y, cb, cr) -> list:
    """jdcolor.c's ycc_rgb_convert (FIX(1.402), FIX(0.34414), FIX(0.71414),
    FIX(1.772) at 16 bits), clipped to 0..255."""
    cb, cr = cb - 128, cr - 128
    return [np.clip(y + ((91881 * cr + 32768) >> 16), 0, 255),
            np.clip(y + ((-22554 * cb - 46802 * cr + 32768) >> 16), 0, 255),
            np.clip(y + ((116130 * cb + 32768) >> 16), 0, 255)]


def _colour_space(f: _Frame, jfif: bool, adobe) -> str:
    """libjpeg's jpeg_color_space for the frame (jdapimin.c's
    default_decompress_parms): "gray", "ycc", "rgb", "cmyk" or "ycck"."""
    nf = len(f.comps)
    if nf == 1:
        return "gray"
    if nf == 3:
        if jfif:
            return "ycc"
        if adobe is not None:
            return "rgb" if adobe == 0 else "ycc"
        return "rgb" if [c.id for c in f.comps] == [82, 71, 66] else "ycc"
    return "cmyk" if adobe is None or adobe == 0 else "ycck"


def _upsampled(f: _Frame, c: _Component) -> np.ndarray:
    """A component's samples at the frame's size, as libjpeg-turbo's
    jdsample.c gives them with fancy upsampling on (libjpeg's default, and
    cv2's and libtiff's): a full-size component as decoded; h2v1 and h2v2
    (where the component is more than 2 samples wide) through the
    triangle filters (3/4 the nearer sample, 1/4 the further, edges
    repeated; h2v2 vertical then horizontal, +8 and +7 rounding); h1v2
    through its vertical filter; any other integral ratio by replication.
    Other ratios raise, as libjpeg refuses them."""
    rows, cols = f.comp_dims(c)
    x = _samples(f.coefs[c.first:c.first + c.bw * c.bh], c.quant, c.bh, c.bw, rows, cols,
                 f.precision, islow=f.precision == 8)
    hx, vx = f.hmax // c.h, f.vmax // c.v
    if f.hmax % c.h or f.vmax % c.v:
        raise JpegError("fractional sampling ratio")
    if (hx, vx) == (1, 1):
        return x
    v = x.astype(np.int64)
    fancy_h = hx == 2 and cols > 2
    if (hx, vx) == (1, 2) or ((hx, vx) == (2, 2) and fancy_h):
        above = np.concatenate([v[:1], v[:-1]])
        below = np.concatenate([v[1:], v[-1:]])
        if hx == 1:      # h1v2_fancy_upsample
            out = np.empty((2 * rows, cols), np.int64)
            out[0::2], out[1::2] = (3 * v + above + 1) >> 2, (3 * v + below + 2) >> 2
            return out[:f.h, :f.w]
        out = np.empty((2 * rows, 2 * cols), np.int64)   # h2v2_fancy_upsample
        for k, s in ((0, 3 * v + above), (1, 3 * v + below)):
            left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
            right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
            out[k::2, 0::2] = (3 * s + left + 8) >> 4
            out[k::2, 1::2] = (3 * s + right + 7) >> 4
        return out[:f.h, :f.w]
    if (hx, vx) == (2, 1) and fancy_h:                   # h2v1_fancy_upsample
        left = np.concatenate([v[:, :1], v[:, :-1]], axis=1)
        right = np.concatenate([v[:, 1:], v[:, -1:]], axis=1)
        out = np.empty((rows, 2 * cols), np.int64)
        out[:, 0::2], out[:, 1::2] = (3 * v + left + 1) >> 2, (3 * v + right + 2) >> 2
        return out[:f.h, :f.w]
    return np.repeat(np.repeat(v, vx, axis=0), hx, axis=1)[:f.h, :f.w]


def _to_gray(f: _Frame, space: str) -> np.ndarray:
    if space in ("gray", "ycc"):
        g = _upsampled(f, f.comps[0])
        return g.astype(np.uint8 if f.precision == 8 else np.uint16)
    if f.precision != 8:
        raise JpegError(f"{space} at {f.precision} bits unsupported")
    p = [_upsampled(f, c).astype(np.int64) for c in f.comps]
    if space == "rgb":  # jdcolor.c rgb_gray_convert: FIX(0.299, 0.587, 0.114) at 16 bits
        return ((19595 * p[0] + 38470 * p[1] + 7471 * p[2] + 32768) >> 16).astype(np.uint8)
    if space == "ycck":  # jdcolor.c ycck_cmyk_convert: YCC -> RGB, inverted; K kept
        p[:3] = (255 - x for x in ycc_rgb(*p[:3]))
    # cv2's icvCvt_CMYK2Gray_8u_C4C1R on libjpeg's (Adobe-inverted) CMYK
    c, m, y, k = p
    c, m, y = (k - (((255 - x) * k) >> 8) for x in (c, m, y))
    return ((1868 * y + 9617 * m + 4899 * c + 8192) >> 14).astype(np.uint8)
