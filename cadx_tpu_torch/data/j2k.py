"""Self-contained JPEG 2000 Part-1 (ITU-T T.800 / ISO 15444-1) decoder.

The port's own copy of `cadx_tpu/data/j2k.py`. Newer TCIA collections
ship JPEG 2000 transfer syntaxes (1.2.840.10008.1.2.4.90 lossless /
.91), which the reference reads via pydicom's handler ecosystem
(Classes/Preprocessing.py:149). pydicom is absent by design, so — like the RLE / JPEG-lossless /
deflate codecs in data/codecs.py — this is a from-scratch pure-Python
implementation, independently verified against OpenCV's OpenJPEG build
(tests/test_j2k.py encodes fixtures with cv2 and pins bit-identity).

Scope (everything DICOM J2K in the wild needs):
- raw codestreams and JP2-boxed files (the jp2c box is unwrapped)
- reversible 5/3 wavelet (lossless) and irreversible 9/7 (lossy)
- arbitrary decomposition levels, code-block sizes, precincts
- all five progression orders (LRCP/RLCP/RPCL/PCRL/CPRL), multiple
  layers, multiple tiles, SOP/EPH markers, tile-part sequences
- multi-component images with optional RCT/ICT, per-component COC/QCC
- EBCOT tier-1 options: selective arithmetic bypass, reset, termall,
  causal (vertically stripe-causal), segmentation symbols
- High-Throughput (T.814) code-blocks (cbstyle 0x40): tier-2 here,
  block coder in data/htj2k.py (the HTJ2K DICOM syntaxes .201-.203)

Not implemented (raise CodecError): Part-2 extensions (Rsiz caps),
region-of-interest shift (RGN marker).

Organization: MQ arithmetic decoder -> tag trees -> packet headers
(tier-2) -> code-block bit-plane decoding (tier-1) -> dequantization ->
inverse DWT -> component transform. Numpy is used for the transforms;
tier-1 is plain Python over 4-row stripes (fast enough for ingest; the
native C++ loader keeps its own fast paths for the bulk formats).
"""

from __future__ import annotations

import math
import os
import struct

import numpy as np

from cadx_tpu_torch.data.codecs import CodecError

# Native (C++) tier-1 fast path: the EBCOT pass loop below ported to
# native/cadx_io.cc::cadx_j2k_decode_block (pure Python costs ~10s for a
# 512x512 image; mammograms are ~4Kx3K). Bit-identity native==python is
# pinned by tests/test_j2k.py. Set CADX_J2K_NATIVE=0 to force Python.
_NATIVE_J2K = os.environ.get("CADX_J2K_NATIVE", "1") != "0"
_native_j2k_dead = False  # set on first failure (no toolchain): stop retrying

_KIND_CODE = {"LL": 0, "LH": 0, "HL": 1, "HH": 2}


def _native_decode_block(data_iter, w, h, bp_start, kind, cbstyle):
    """Returns int64 signed coefficients (no mid-point) or None."""
    global _native_j2k_dead
    if not _NATIVE_J2K or _native_j2k_dead:
        return None
    try:
        from cadx_tpu_torch.data import native_loader
        return native_loader.decode_j2k_block(
            data_iter, w, h, bp_start, _KIND_CODE[kind], cbstyle)
    except Exception:
        _native_j2k_dead = True
        return None

# ---------------------------------------------------------------------------
# MQ arithmetic decoder (T.800 Annex C)
# ---------------------------------------------------------------------------

# (Qe, NMPS, NLPS, SWITCH)
_QE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]

# context indices (T.800 convention)
_CTX_UNI = 18   # uniform
_CTX_RL = 17    # run-length
_N_CTX = 19


class _MQDecoder:
    """MQ decoder over one code-block's byte stream (Annex C.3)."""

    __slots__ = ("data", "bp", "c", "a", "ct", "idx", "mps")

    def __init__(self, data: bytes):
        self.data = data
        self.bp = 0
        b0 = data[0] if data else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000
        # context states: (index into _QE, mps bit)
        self.idx = [0] * _N_CTX
        self.mps = [0] * _N_CTX
        self.reset_contexts()

    def reset_contexts(self):
        for i in range(_N_CTX):
            self.idx[i] = 0
            self.mps[i] = 0
        self.idx[_CTX_UNI] = 46
        self.idx[_CTX_RL] = 3
        self.idx[0] = 4  # sig context 0 starts at state 4

    def _bytein(self):
        data, bp = self.data, self.bp
        b = data[bp] if bp < len(data) else 0xFF
        if b == 0xFF:
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        qe = _QE[self.idx[cx]][0]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = self.mps[cx]
                self.idx[cx] = _QE[self.idx[cx]][1]  # NMPS
            else:
                d = 1 - self.mps[cx]
                if _QE[self.idx[cx]][3]:
                    self.mps[cx] = 1 - self.mps[cx]
                self.idx[cx] = _QE[self.idx[cx]][2]  # NLPS
            self.a = qe
        else:
            self.c = (self.c - (qe << 16)) & 0xFFFFFFFF
            if self.a & 0x8000:
                return self.mps[cx]
            if self.a < qe:
                d = 1 - self.mps[cx]
                if _QE[self.idx[cx]][3]:
                    self.mps[cx] = 1 - self.mps[cx]
                self.idx[cx] = _QE[self.idx[cx]][2]  # NLPS
            else:
                d = self.mps[cx]
                self.idx[cx] = _QE[self.idx[cx]][1]  # NMPS
        # RENORMD
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


class _RawBitReader:
    """Raw (bypass-mode) bit reader with 0xFF stuffing (Annex D.6)."""

    __slots__ = ("data", "bp", "buf", "ct")

    def __init__(self, data: bytes, bp: int):
        self.data = data
        self.bp = bp
        self.buf = 0
        self.ct = 0

    def read(self) -> int:
        if self.ct == 0:
            prev = self.buf
            self.buf = self.data[self.bp] if self.bp < len(self.data) else 0xFF
            self.bp += 1
            self.ct = 7 if prev == 0xFF else 8
        self.ct -= 1
        return (self.buf >> self.ct) & 1


# ---------------------------------------------------------------------------
# Packet-header bit reader + tag trees (Annex B.10, B.9)
# ---------------------------------------------------------------------------

class _HeaderReader:
    """MSB-first bit reader with the packet-header stuffing rule: a byte
    following 0xFF carries only 7 bits."""

    __slots__ = ("data", "pos", "buf", "ct")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.ct = 0

    def bit(self) -> int:
        if self.ct == 0:
            if self.pos >= len(self.data):
                raise CodecError("J2K: packet header overruns data")
            prev = self.buf
            self.buf = self.data[self.pos]
            self.pos += 1
            self.ct = 7 if prev == 0xFF else 8
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self):
        """End of packet header: skip to byte boundary; a trailing 0xFF
        eats one stuffed 0 bit of the next byte."""
        self.ct = 0
        if self.buf == 0xFF:
            if self.pos < len(self.data):
                self.pos += 1  # the stuffed byte (<= 0x8F) is consumed


class _TagTree:
    """2D tag tree (Annex B.9): decode returns True iff value(i,j) is
    known to be < threshold after reading the needed bits."""

    def __init__(self, w: int, h: int):
        self.sizes = []
        while True:
            self.sizes.append((w, h))
            if w == 1 and h == 1:
                break
            w = (w + 1) // 2
            h = (h + 1) // 2
        self.sizes.reverse()  # root first
        self.val = [np.zeros((sh, sw), np.int32) for sw, sh in self.sizes]
        self.known = [np.zeros((sh, sw), bool) for sw, sh in self.sizes]

    def decode(self, rdr: _HeaderReader, i: int, j: int, threshold: int) -> bool:
        # path from root to leaf
        lo = 0
        for lvl in range(len(self.sizes)):
            shift = len(self.sizes) - 1 - lvl
            y, x = i >> shift, j >> shift
            v = self.val[lvl]
            k = self.known[lvl]
            if v[y, x] < lo:
                v[y, x] = lo
            while not k[y, x] and v[y, x] < threshold:
                if rdr.bit():
                    k[y, x] = True
                else:
                    v[y, x] += 1
            lo = v[y, x]
            if not k[y, x]:
                return False  # threshold reached without resolution
        return self.val[-1][i >> 0, j >> 0] < threshold

    def value(self, i: int, j: int) -> int:
        return int(self.val[-1][i, j])


# ---------------------------------------------------------------------------
# Header parsing (Annex A)
# ---------------------------------------------------------------------------

_SOC, _SIZ, _COD, _COC, _QCD, _QCC = 0xFF4F, 0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D
_RGN, _POC, _TLM, _PLM, _PLT, _PPM, _PPT = (0xFF5E, 0xFF5F, 0xFF55, 0xFF57,
                                            0xFF58, 0xFF60, 0xFF61)
_SOT, _SOD, _EOC, _SOP, _EPH, _CRG, _COM = (0xFF90, 0xFF93, 0xFFD9, 0xFF91,
                                            0xFF92, 0xFF63, 0xFF64)


class _CodingStyle:
    __slots__ = ("levels", "cbw", "cbh", "cbstyle", "transform",
                 "precincts", "prog", "layers", "mct", "sop", "eph")


class _QuantStyle:
    __slots__ = ("style", "guard", "exps", "mants")


def _parse_cod(body: bytes) -> _CodingStyle:
    cs = _CodingStyle()
    scod = body[0]
    cs.sop = bool(scod & 2)
    cs.eph = bool(scod & 4)
    cs.prog = body[1]
    cs.layers = struct.unpack(">H", body[2:4])[0]
    cs.mct = body[4]
    cs.levels = body[5]
    cs.cbw = (body[6] & 0xF) + 2
    cs.cbh = (body[7] & 0xF) + 2
    cs.cbstyle = body[8]
    cs.transform = body[9]
    if scod & 1:
        cs.precincts = [(b & 0xF, b >> 4) for b in body[10:10 + cs.levels + 1]]
    else:
        cs.precincts = [(15, 15)] * (cs.levels + 1)
    return cs


def _parse_coc_into(body: bytes, base: _CodingStyle, n_comp: int):
    """COC: per-component coding style override. Returns (comp_idx, style)."""
    if n_comp < 257:
        ci, off = body[0], 1
    else:
        ci, off = struct.unpack(">H", body[:2])[0], 2
    cs = _CodingStyle()
    scoc = body[off]
    cs.sop, cs.eph = base.sop, base.eph
    cs.prog, cs.layers, cs.mct = base.prog, base.layers, base.mct
    cs.levels = body[off + 1]
    cs.cbw = (body[off + 2] & 0xF) + 2
    cs.cbh = (body[off + 3] & 0xF) + 2
    cs.cbstyle = body[off + 4]
    cs.transform = body[off + 5]
    if scoc & 1:
        cs.precincts = [(b & 0xF, b >> 4)
                        for b in body[off + 6:off + 6 + cs.levels + 1]]
    else:
        cs.precincts = [(15, 15)] * (cs.levels + 1)
    return ci, cs


def _parse_qcd(body: bytes) -> _QuantStyle:
    q = _QuantStyle()
    q.style = body[0] & 0x1F
    q.guard = body[0] >> 5
    q.exps, q.mants = [], []
    if q.style == 0:          # no quantization (reversible): 8-bit exps
        for b in body[1:]:
            q.exps.append(b >> 3)
            q.mants.append(0)
    elif q.style == 1:        # scalar derived: one 16-bit value
        v = struct.unpack(">H", body[1:3])[0]
        q.exps.append(v >> 11)
        q.mants.append(v & 0x7FF)
    else:                     # scalar expounded: 16 bits per subband
        for i in range(1, len(body) - 1, 2):
            v = struct.unpack(">H", body[i:i + 2])[0]
            q.exps.append(v >> 11)
            q.mants.append(v & 0x7FF)
    return q


def _parse_qcc(body: bytes, n_comp: int):
    if n_comp < 257:
        ci, off = body[0], 1
    else:
        ci, off = struct.unpack(">H", body[:2])[0], 2
    return ci, _parse_qcd(body[off:])


# ---------------------------------------------------------------------------
# Geometry: resolutions, precincts, code-blocks (Annex B)
# ---------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _CodeBlock:
    __slots__ = ("x0", "y0", "x1", "y1", "included", "zbp", "lblock",
                 "passes_total", "data_parts", "coefs", "nb_seg_passes")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.included = False
        self.zbp = 0            # missing (zero) bit-planes
        self.lblock = 3
        self.passes_total = 0
        self.data_parts = []    # [(bytes, n_passes)] per signalled chunk
        self.nb_seg_passes = []  # [(nbytes, n_passes)] mirror for tier-1


class _Subband:
    __slots__ = ("kind", "x0", "y0", "x1", "y1", "blocks", "bw", "bh",
                 "inc_tree", "zbp_tree", "eps", "mant", "gain")

    def __init__(self, kind, x0, y0, x1, y1, cbw, cbh):
        self.kind = kind  # "LL", "HL", "LH", "HH"
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        # code-block grid anchored at 0 (Annex B.7)
        if x1 <= x0 or y1 <= y0:
            self.bw = self.bh = 0
            self.blocks = []
            return
        bx0, by0 = x0 >> cbw, y0 >> cbh
        bx1, by1 = _ceil_div(x1, 1 << cbw), _ceil_div(y1, 1 << cbh)
        self.bw, self.bh = bx1 - bx0, by1 - by0
        self.blocks = []
        for by in range(by0, by1):
            row = []
            for bx in range(bx0, bx1):
                row.append(_CodeBlock(
                    max(x0, bx << cbw), max(y0, by << cbh),
                    min(x1, (bx + 1) << cbw), min(y1, (by + 1) << cbh)))
            self.blocks.append(row)


class _Resolution:
    __slots__ = ("r", "x0", "y0", "x1", "y1", "bands", "pw", "ph",
                 "ppx", "ppy", "inc_trees", "zbp_trees")

    def __init__(self, r, x0, y0, x1, y1, ppx, ppy):
        self.r = r
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.ppx, self.ppy = ppx, ppy
        if x1 > x0 and y1 > y0:
            self.pw = _ceil_div(x1, 1 << ppx) - (x0 >> ppx)
            self.ph = _ceil_div(y1, 1 << ppy) - (y0 >> ppy)
        else:
            self.pw = self.ph = 0
        self.bands = []
        self.inc_trees = {}
        self.zbp_trees = {}


class _TileComp:
    __slots__ = ("x0", "y0", "x1", "y1", "resolutions", "style", "quant",
                 "coefs")


# ---------------------------------------------------------------------------
# Tier-1: EBCOT code-block decoding (Annex D)
# ---------------------------------------------------------------------------

# significance context lookup tables, by subband orientation.
# key = (sum_h, sum_v, sum_d) clamped; value = context 0..8 (Table D.1)
def _sig_ctx(kind: str, h: int, v: int, d: int) -> int:
    if kind in ("LL", "LH"):  # LL and LH use the same table
        if h == 2:
            return 8
        if h == 1:
            return 7 if v >= 1 else (6 if d >= 1 else 5)
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else d
    if kind == "HL":          # transposed h<->v
        if v == 2:
            return 8
        if v == 1:
            return 7 if h >= 1 else (6 if d >= 1 else 5)
        if h == 2:
            return 4
        if h == 1:
            return 3
        return 2 if d >= 2 else d
    # HH
    hv = h + v
    if d >= 3:
        return 8
    if d == 2:
        return 7 if hv >= 1 else 6
    if d == 1:
        return 5 if hv >= 2 else (4 if hv == 1 else 3)
    return 2 if hv >= 2 else hv


# sign-decoding contribution table (Table D.3): returns (context, xorbit)
def _sign_ctx(hc: int, vc: int):
    # hc, vc in {-1, 0, 1}
    if hc == 1:
        if vc == 1:
            return 13, 0
        if vc == 0:
            return 12, 0
        return 11, 0
    if hc == 0:
        if vc == 1:
            return 10, 0
        if vc == 0:
            return 9, 0
        return 10, 1
    if vc == 1:
        return 11, 1
    if vc == 0:
        return 12, 1
    return 13, 1


def _decode_block(cb: _CodeBlock, kind: str, mb: int, cbstyle: int,
                  seg_passes=None) -> np.ndarray:
    """Decode one code-block -> int32 signed coefficients (h, w)."""
    w, h = cb.x1 - cb.x0, cb.y1 - cb.y0
    coefs = np.zeros((h, w), np.int32)
    if not cb.data_parts or cb.passes_total == 0:
        return coefs
    sig = np.zeros((h + 2, w + 2), np.uint8)    # significance (padded)
    sgn = np.zeros((h + 2, w + 2), np.int8)     # signs of significant
    visited = np.zeros((h, w), bool)            # coded in current SPP
    refined = np.zeros((h, w), bool)            # has been refined once
    mag = np.zeros((h, w), np.int64)

    bypass = bool(cbstyle & 1)
    reset_ctx = bool(cbstyle & 2)
    termall = bool(cbstyle & 4)
    causal = bool(cbstyle & 8)
    segsym = bool(cbstyle & 32)

    n_passes = cb.passes_total
    bp_start = mb - 1 - cb.zbp
    if bp_start < 0:
        return coefs

    if cbstyle & 0x40:
        # High-Throughput (T.814) code-block: segment 0 is the HT
        # cleanup segment, segment 1 (when present) carries SigProp
        # followed by MagRef. Tier-2 split the chunks on the same
        # boundary (see _segment_lengths), so chunks concatenate into
        # the two HT segments here.
        from cadx_tpu_torch.data.htj2k import ht_decode_block
        if n_passes > 3:
            raise CodecError(f"J2K/HT: {n_passes} passes (max 3)")
        blob_ht = b"".join(c for c, _ in cb.data_parts)
        segs_ht = []
        pos_ht = 0
        passes_left = [1, n_passes - 1]
        cur = b""
        si = 0
        for b_len, b_pass in cb.nb_seg_passes:
            cur += blob_ht[pos_ht:pos_ht + b_len]
            pos_ht += b_len
            passes_left[si] -= b_pass
            if passes_left[si] <= 0:
                segs_ht.append(cur)
                cur = b""
                si += 1
                if si >= 2:
                    break
        if cur:
            segs_ht.append(cur)
        co = ht_decode_block(segs_ht, w, h, mb, cb.zbp, n_passes)
        return co.astype(np.int32)

    if n_passes > 1 + 3 * bp_start:
        # cleanup at bp_start + (SPP,MRP,CUP) per remaining plane is the
        # most a valid stream can carry; more means a corrupt header and
        # would shift by a negative bitplane below (fuzz finding)
        raise CodecError(f"J2K: {n_passes} passes exceeds the "
                         f"{1 + 3 * bp_start} possible at {bp_start + 1} "
                         "bitplanes")

    # Build the pass -> segment mapping. With termall every pass is its
    # own MQ segment; with bypass, raw passes (SPP/MRP beyond the 4th
    # bitplane after the first) are raw segments.
    segments = cb.data_parts  # list of (bytes, n_passes)

    # flatten pass types: pass 0 = cleanup at bp_start, then per plane:
    # SPP, MRP, CUP
    pass_types = [2]
    bp_of_pass = [bp_start]
    bp = bp_start
    while len(pass_types) < n_passes:
        bp -= 1
        for t in (0, 1, 2):
            pass_types.append(t)
            bp_of_pass.append(bp)
            if len(pass_types) >= n_passes:
                break

    # is a pass raw under bypass mode? (T.800 D.7: starting from the 5th
    # significance pass ... i.e. after the 4 first bit-planes' MQ passes)
    def pass_is_raw(k: int) -> bool:
        if not bypass:
            return False
        t = pass_types[k]
        # raw for SPP and MRP once (bp_start - bp_of_pass[k]) >= 4
        return t in (0, 1) and (bp_start - bp_of_pass[k]) >= 4

    # Decoder segments are delimited ONLY by codeword terminations
    # (termall: every pass; bypass: at MQ<->raw transitions) — NOT by
    # packet boundaries: without termination one MQ codeword spans
    # layers, so bytes from consecutive packets concatenate (B.10.7 /
    # D.4.1). Tier-2 recorded (nbytes, npass) per length-signalled chunk;
    # chunks never straddle a termination boundary (tier-2 used the same
    # boundary rules), so a decoder segment = a run of whole chunks.
    seg_bounds = []  # (first_pass, end_pass, raw?)
    start = 0
    for k in range(n_passes):
        last = (k == n_passes - 1)
        boundary = last or termall or (
            bypass and not last and (pass_is_raw(k) != pass_is_raw(k + 1)))
        if boundary:
            seg_bounds.append((start, k + 1, pass_is_raw(k)))
            start = k + 1

    blob = b"".join(c for c, _ in segments)
    chunk_lens = cb.nb_seg_passes  # [(nbytes, npass), ...] from tier-2

    data_iter = []  # (bytes, n_passes, raw?) true decoder segments
    pos = 0
    ci = 0
    for (p0, p1, is_raw_seg) in seg_bounds:
        need = p1 - p0
        nbytes = 0
        while need > 0 and ci < len(chunk_lens):
            b_len, b_pass = chunk_lens[ci]
            nbytes += b_len
            need -= b_pass
            ci += 1
        data_iter.append((blob[pos:pos + nbytes], p1 - p0, is_raw_seg))
        pos += nbytes

    co = _native_decode_block(data_iter, w, h, bp_start, kind, cbstyle)
    if co is not None:
        # mid-point reconstruction, same as the Python tail below (all
        # passes always run: the MQ/raw readers pad past end-of-data)
        p_last = bp_of_pass[n_passes - 1]
        if p_last > 0:
            co = co + np.sign(co) * (1 << (p_last - 1))
        return co.astype(np.int64)

    mq = None
    raw = None
    k = 0  # global pass index

    def run_pass(t: int, bp_i: int, dec_bit, dec_sig_bit, dec_sign_bit,
                 dec_uni):
        nonlocal mag
        one = 1 << (bp_i - 0)
        half = one >> 1
        # stripe loop
        for y0s in range(0, h, 4):
            y1s = min(y0s + 4, h)
            for x in range(w):
                yy = y0s
                if t == 2:
                    # cleanup with run-length mode
                    yy = y0s
                    while yy < y1s:
                        # run-length eligible: full stripe of 4, all ctx 0,
                        # none visited
                        if (t == 2 and yy == y0s and y1s - y0s == 4):
                            all_zero_ctx = True
                            for yk in range(y0s, y1s):
                                # RL mode needs: sample insignificant, not
                                # already coded this plane, and zero context
                                if visited[yk, x] or sig[yk + 1, x + 1]:
                                    all_zero_ctx = False
                                    break
                                # zero-context test with the same VSC
                                # masking as normal context formation
                                hs, vs, ds = _nb_counts(yk, x)
                                if hs or vs or ds:
                                    all_zero_ctx = False
                                    break
                            if all_zero_ctx:
                                if dec_bit(_CTX_RL) == 0:
                                    yy = y1s
                                    continue
                                r2 = (dec_uni() << 1) | dec_uni()
                                yy = y0s + r2
                                # this sample becomes significant, sign next
                                _make_sig(yy, x, bp_i, dec_sign_bit)
                                yy += 1
                                continue
                        # normal cleanup sample
                        if not visited[yy, x] and not sig[yy + 1, x + 1]:
                            hs, vs, ds = _nb_counts(yy, x)
                            cx = _sig_ctx(kind, hs, vs, ds)
                            if dec_sig_bit(cx):
                                _make_sig(yy, x, bp_i, dec_sign_bit)
                        visited[yy, x] = False
                        yy += 1
                    continue
                for yy in range(y0s, y1s):
                    if t == 0:
                        # significance propagation: non-significant with
                        # non-zero context
                        if sig[yy + 1, x + 1] or visited[yy, x]:
                            continue
                        hs, vs, ds = _nb_counts(yy, x)
                        if hs + vs + ds == 0:
                            continue
                        cx = _sig_ctx(kind, hs, vs, ds)
                        if dec_sig_bit(cx):
                            _make_sig(yy, x, bp_i, dec_sign_bit)
                        visited[yy, x] = True
                    elif t == 1:
                        # magnitude refinement
                        if not sig[yy + 1, x + 1] or visited[yy, x]:
                            continue
                        if refined[yy, x]:
                            cx = 16
                        else:
                            hs, vs, ds = _nb_counts(yy, x)
                            cx = 15 if (hs + vs + ds) else 14
                        bit = dec_bit(cx)
                        mag[yy, x] |= bit << bp_i
                        refined[yy, x] = True
                        visited[yy, x] = True

    def _nb_counts(yy, x):
        ys, xs = yy + 1, x + 1
        s = sig
        vn = int(s[ys - 1, xs])
        vs_ = int(s[ys + 1, xs])
        dn = int(s[ys - 1, xs - 1] + s[ys - 1, xs + 1])
        dsn = int(s[ys + 1, xs - 1] + s[ys + 1, xs + 1])
        # VSC (stripe-causal) hides only FUTURE (south) stripes: mask the
        # south contributions at each stripe's last row. The previous
        # stripe (north) is already coded and stays visible (T.800 D.5;
        # OpenJPEG masks SIG_S/SE/SW at j == k+3 only).
        if causal and (yy % 4) == 3:
            vs_ = 0
            dsn = 0
        hs = int(s[ys, xs - 1] + s[ys, xs + 1])
        return hs, vn + vs_, dn + dsn

    def _make_sig(yy, x, bp_i, dec_sign_bit):
        mag[yy, x] |= 1 << bp_i
        # decode sign (Annex D.3.2)
        ys, xs = yy + 1, x + 1
        hleft = int(sig[ys, xs - 1]) * (1 if sgn[ys, xs - 1] >= 0 else -1) \
            if sig[ys, xs - 1] else 0
        hright = int(sig[ys, xs + 1]) * (1 if sgn[ys, xs + 1] >= 0 else -1) \
            if sig[ys, xs + 1] else 0
        vup = int(sig[ys - 1, xs]) * (1 if sgn[ys - 1, xs] >= 0 else -1) \
            if sig[ys - 1, xs] else 0
        vdn = int(sig[ys + 1, xs]) * (1 if sgn[ys + 1, xs] >= 0 else -1) \
            if sig[ys + 1, xs] else 0
        if causal and (yy % 4) == 3:
            vdn = 0  # VSC: south-only masking (see _nb_counts)
        hc = max(-1, min(1, hleft + hright))
        vc = max(-1, min(1, vup + vdn))
        cx, xorbit = _sign_ctx(hc, vc)
        # raw (bypass) segments code the sign directly, no prediction
        # (T.800 D.6; OpenJPEG raw sigpass) — the raw dec_sign_bit
        # ignores both cx and the xorbit it is handed
        negative = dec_sign_bit(cx, xorbit)
        sig[ys, xs] = 1
        sgn[ys, xs] = -1 if negative else 1

    ctx_idx = ctx_mps = None  # context states persist ACROSS segments
    for seg_data, seg_npasses, is_raw in data_iter:
        if is_raw:
            raw = _RawBitReader(seg_data, 0)
        else:
            mq = _MQDecoder(seg_data)
            if ctx_idx is not None:
                # D.4.1: terminations restart the codeword, NOT the
                # probability contexts (unless the reset option fires,
                # handled per-pass below)
                mq.idx = ctx_idx
                mq.mps = ctx_mps
        for _ in range(seg_npasses):
            t = pass_types[k]
            bp_i = bp_of_pass[k]
            if pass_is_raw(k):
                rr = raw

                def dec_bit(cx, rr=rr):
                    return rr.read()

                def dec_sig_bit(cx, rr=rr):
                    return rr.read()

                def dec_sign_bit(cx, xorbit, rr=rr):
                    return rr.read()

                def dec_uni(rr=rr):
                    return rr.read()
            else:
                mm = mq

                def dec_bit(cx, mm=mm):
                    return mm.decode(cx)

                def dec_sig_bit(cx, mm=mm):
                    return mm.decode(cx)

                def dec_sign_bit(cx, xorbit, mm=mm):
                    return mm.decode(cx) ^ xorbit

                def dec_uni(mm=mm):
                    return mm.decode(_CTX_UNI)
            if t == 0:
                run_pass(0, bp_i, dec_bit, dec_sig_bit, dec_sign_bit, dec_uni)
            elif t == 1:
                run_pass(1, bp_i, dec_bit, dec_sig_bit, dec_sign_bit, dec_uni)
            else:
                run_pass(2, bp_i, dec_bit, dec_sig_bit, dec_sign_bit, dec_uni)
                if segsym and not pass_is_raw(k):
                    s = 0
                    for _ in range(4):
                        s = (s << 1) | mq.decode(_CTX_UNI)
                    # spec value 0xA; mismatch = corruption (non-fatal)
            if t == 2:
                # visited persists from SPP through MRP to CUP of the
                # same plane (each marks its own visits), clears after CUP
                visited[:] = False
            if reset_ctx and mq is not None:
                mq.reset_contexts()
            k += 1
        if mq is not None:
            ctx_idx, ctx_mps = mq.idx, mq.mps
        if k >= n_passes:
            break

    # Mid-point reconstruction for truncated streams (rate-controlled
    # lossy): every coded plane stops at p_last; true magnitudes lie in
    # [m, m + 2^p_last), so add the interval midpoint to nonzero samples
    # (what OpenJPEG does). p_last = 0 for complete (lossless) streams,
    # where the integer half is 0 — bit-exactness unaffected.
    p_last = bp_of_pass[min(k, n_passes) - 1] if n_passes else 0
    if p_last > 0:
        mag[mag != 0] += 1 << (p_last - 1)
    signs = sgn[1:h + 1, 1:w + 1].astype(np.int32)
    coefs = mag[:h, :w].astype(np.int64) * np.where(signs < 0, -1, 1)
    return coefs.astype(np.int64)


# ---------------------------------------------------------------------------
# Inverse DWT (Annex F)
# ---------------------------------------------------------------------------

def _sym_ext_idx(i: np.ndarray, n: int) -> np.ndarray:
    """Symmetric (whole-sample) boundary extension indices."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def _idwt53_1d(low: np.ndarray, high: np.ndarray, parity: int, axis: int
               ) -> np.ndarray:
    """1D inverse 5/3 along `axis`. parity = u0 & 1 of the merged signal
    (0: even samples are low)."""
    if (low.ndim == 2 and axis in (0, 1)
            and low.shape[axis] + high.shape[axis] >= 2):
        # native fast path (same CADX_J2K_NATIVE gate / dead-flag as
        # tier-1); numpy below is the reference implementation
        global _native_j2k_dead
        if _NATIVE_J2K and not _native_j2k_dead:
            try:
                from cadx_tpu_torch.data import native_loader
                out = native_loader.idwt53_1d(low, high, parity, axis)
            except Exception:
                _native_j2k_dead = True
            else:
                if out is not None:
                    return out
    low = np.moveaxis(low, axis, 0).astype(np.int64)
    high = np.moveaxis(high, axis, 0).astype(np.int64)
    nl, nh = low.shape[0], high.shape[0]
    n = nl + nh
    out = np.empty((n,) + low.shape[1:], np.int64)
    if n == 1:
        out[0] = low[0] if parity == 0 else high[0] >> 1 if False else high[0]
        # single-sample: if it's a high sample (parity 1, nl==0) the
        # value is x = h / 2 per F.3.7 (2*x one-sample rule): out = h>>1
        if parity == 1 and nl == 0:
            out[0] = high[0] // 2
        return np.moveaxis(out, 0, axis)
    # interleave positions: with parity 0, low at even; parity 1, low at odd
    # Use the standard lifting on the interleaved signal Y:
    # x_even = Y_even - floor((Y[i-1] + Y[i+1] + 2)/4)   (even = low pos)
    # x_odd  = Y_odd + floor((x[i-1] + x[i+1]) / 2)
    # Over indices i-1/i+1 for i in [0, n), the symmetric extension only
    # ever maps -1 -> 1 and n -> n-2 (parity-preserving), so neighbor
    # access is a 1-sample symmetric pad + strided slices — no gathers
    # (full-array fancy indexing was the hot spot at mammogram sizes).
    y = np.empty_like(out)
    if parity == 0:
        y[0::2] = low
        y[1::2] = high
        p_low, p_high = 0, 1
    else:
        y[0::2] = high
        y[1::2] = low
        p_low, p_high = 1, 0
    x = np.empty_like(y)

    def _nbrs(src, p0, m):
        """(left, right) neighbor views for positions p0, p0+2, ... —
        src padded so pad[k] == x_sym_ext[k-1]."""
        pad = np.concatenate([src[1:2], src, src[n - 2:n - 1]], axis=0)
        return pad[p0:p0 + 2 * m:2], pad[p0 + 2:p0 + 2 + 2 * m:2]

    m_low = (n - p_low + 1) // 2
    l1, r1 = _nbrs(y, p_low, m_low)          # high-position neighbors
    x[p_low::2] = y[p_low::2] - ((l1 + r1 + 2) >> 2)
    m_high = (n - p_high + 1) // 2
    l2, r2 = _nbrs(x, p_high, m_high)        # low positions, just written
    x[p_high::2] = y[p_high::2] + ((l2 + r2) >> 1)
    return np.moveaxis(x, 0, axis)


# 9/7 lifting constants (Table F.4)
_A97 = -1.586134342059924
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971
_K97 = 1.230174104914001


def _idwt97_1d(low: np.ndarray, high: np.ndarray, parity: int, axis: int
               ) -> np.ndarray:
    low = np.moveaxis(low, axis, 0).astype(np.float64)
    high = np.moveaxis(high, axis, 0).astype(np.float64)
    nl, nh = low.shape[0], high.shape[0]
    n = nl + nh
    if n == 1:
        out = low if nl else high
        return np.moveaxis(out, 0, axis)
    y = np.empty((n,) + low.shape[1:], np.float64)
    if parity == 0:
        y[0::2] = low * _K97
        y[1::2] = high / _K97
        p_low, p_high = 0, 1
    else:
        y[0::2] = high / _K97
        y[1::2] = low * _K97
        p_low, p_high = 1, 0
    x = y

    def lift(p0, coef):
        # same pad-and-slice neighbor trick as _idwt53_1d (sym ext of
        # i+-1 only maps -1->1, n->n-2; neighbors are the other parity,
        # already holding their current lifting-stage values)
        m = (n - p0 + 1) // 2
        pad = np.concatenate([x[1:2], x, x[n - 2:n - 1]], axis=0)
        x[p0::2] += coef * (pad[p0:p0 + 2 * m:2]
                            + pad[p0 + 2:p0 + 2 + 2 * m:2])

    lift(p_low, -_D97)
    lift(p_high, -_G97)
    lift(p_low, -_B97)
    lift(p_high, -_A97)
    return np.moveaxis(x, 0, axis)


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------

class _Decoder:
    def __init__(self, data: bytes, expect_hw: tuple[int, int] | None = None):
        self.data = data
        self.pos = 0
        self.styles = {}
        self.quants = {}
        self.tiles_done = {}
        self.expect_hw = expect_hw  # fail-fast SIZ check when known

    # --- marker stream ---
    def _u16(self) -> int:
        v = struct.unpack(">H", self.data[self.pos:self.pos + 2])[0]
        self.pos += 2
        return v

    def decode(self) -> np.ndarray:
        d = self.data
        if len(d) < 4:
            raise CodecError("J2K: truncated stream")
        if self._u16() != _SOC:
            raise CodecError("J2K: missing SOC")
        if self._u16() != _SIZ:
            raise CodecError("J2K: SIZ must follow SOC")
        lsiz = self._u16()
        body = d[self.pos:self.pos + lsiz - 2]
        self.pos += lsiz - 2
        (self.rsiz, self.xsiz, self.ysiz, self.xo, self.yo,
         self.xt, self.yt, self.xto, self.yto, self.ncomp) = struct.unpack(
            ">HIIIIIIIIH", body[:36])
        self.comp_depth, self.comp_signed = [], []
        self.comp_dx, self.comp_dy = [], []
        off = 36
        for _ in range(self.ncomp):
            ssiz, xr, yr = body[off], body[off + 1], body[off + 2]
            off += 3
            self.comp_depth.append((ssiz & 0x7F) + 1)
            self.comp_signed.append(bool(ssiz & 0x80))
            self.comp_dx.append(xr)
            self.comp_dy.append(yr)
        if any(r != 1 for r in self.comp_dx + self.comp_dy):
            raise CodecError("J2K: component subsampling unsupported")

        # SIZ sanity (fuzz finding): a corrupt header must fail
        # here with CodecError, not crash later with a 100s-of-GiB
        # allocation (MemoryError) or a zero-tile division
        w, h = self.xsiz - self.xo, self.ysiz - self.yo
        if w <= 0 or h <= 0 or self.xt <= 0 or self.yt <= 0:
            raise CodecError("J2K: bad SIZ geometry "
                             f"({self.xsiz}x{self.ysiz} grid, "
                             f"{self.xt}x{self.yt} tiles)")
        # decode-time DoS bound (fuzz finding): a corrupt SIZ claiming a
        # ~200M-pixel image passes the positivity checks and then burns
        # tens of seconds in giant plane allocations. DICOM Rows/Cols
        # are u16, and real mammograms top out ~24M px; 2^26 is generous.
        if w > 0xFFFF or h > 0xFFFF or w * h > (1 << 26):
            raise CodecError(f"J2K: image {h}x{w} exceeds decoder limits")
        if self.ncomp < 1 or self.ncomp > 16:
            raise CodecError(f"J2K: unsupported component count "
                             f"{self.ncomp}")
        if any(dp > 32 for dp in self.comp_depth):
            # spec allows Ssiz up to 38 bits, but our output containers
            # top out at (u)int32 — a corrupt 33+ bit depth would make
            # the final astype overflow silently (fuzz finding)
            raise CodecError(f"J2K: unsupported bit depth "
                             f"{max(self.comp_depth)}")
        if self.expect_hw is not None and (h, w) != self.expect_hw:
            raise CodecError(f"J2K: SIZ image {h}x{w} != expected "
                             f"{self.expect_hw}")
        if h * w > (1 << 28):  # 268 Mpx ≈ 2 GiB f64/component ceiling
            raise CodecError(f"J2K: image {h}x{w} exceeds sanity bound")

        self.ntx = _ceil_div(self.xsiz - self.xto, self.xt)
        self.nty = _ceil_div(self.ysiz - self.yto, self.yt)
        if self.ntx < 1 or self.nty < 1:
            # tile-grid origin beyond the image grid: zero tiles (fuzz
            # finding — `isot % ntx` would divide by zero)
            raise CodecError("J2K: bad tile grid origin "
                             f"(XTO/YTO {self.xto},{self.yto})")
        n_tiles = self.ntx * self.nty

        # main header
        while True:
            m = self._u16()
            if m == _SOT:
                break
            if m == _EOC:
                raise CodecError("J2K: no tile data")
            ln = self._u16()
            body = d[self.pos:self.pos + ln - 2]
            self.pos += ln - 2
            if m == _COD:
                self.styles["*"] = _parse_cod(body)
            elif m == _COC:
                ci, cs = _parse_coc_into(body, self.styles["*"], self.ncomp)
                self.styles[ci] = cs
            elif m == _QCD:
                self.quants["*"] = _parse_qcd(body)
            elif m == _QCC:
                ci, q = _parse_qcc(body, self.ncomp)
                self.quants[ci] = q
            elif m == _RGN:
                raise CodecError("J2K: RGN (ROI shift) unsupported")
            elif m in (_POC,):
                raise CodecError("J2K: POC progression changes unsupported")
            # COM/TLM/PLM/PPM/CRG ignored
        if "*" not in self.styles or "*" not in self.quants:
            raise CodecError("J2K: missing COD/QCD")

        # image buffer per component
        w, h = self.xsiz - self.xo, self.ysiz - self.yo
        comps = [np.zeros((h, w), np.float64) for _ in range(self.ncomp)]

        # tile loop (we already consumed the first SOT marker)
        while True:
            lsot = self._u16()
            isot = self._u16()
            psot = struct.unpack(">I", d[self.pos:self.pos + 4])[0]
            self.pos += 4
            tpsot, tnsot = d[self.pos], d[self.pos + 1]
            self.pos += 2
            sot_start = self.pos - 12  # position of SOT marker
            tile_end = sot_start + psot if psot else len(d)
            # tile-part header
            t_styles = dict(self.styles)
            t_quants = dict(self.quants)
            while True:
                m = self._u16()
                if m == _SOD:
                    break
                ln = self._u16()
                body = d[self.pos:self.pos + ln - 2]
                self.pos += ln - 2
                if m == _COD:
                    t_styles["*"] = _parse_cod(body)
                elif m == _COC:
                    ci, cs = _parse_coc_into(body, t_styles["*"], self.ncomp)
                    t_styles[ci] = cs
                elif m == _QCD:
                    t_quants["*"] = _parse_qcd(body)
                elif m == _QCC:
                    ci, q = _parse_qcc(body, self.ncomp)
                    t_quants[ci] = q
                elif m == _POC:
                    raise CodecError("J2K: POC unsupported")
            body_bytes = d[self.pos:tile_end]
            self.pos = tile_end
            key = isot
            if tpsot == 0:
                self.tiles_done[key] = {
                    "styles": t_styles, "quants": t_quants,
                    "parts": [body_bytes]}
            else:
                self.tiles_done[key]["parts"].append(body_bytes)
            # next marker
            m = self._u16()
            if m == _EOC:
                break
            if m != _SOT:
                raise CodecError(f"J2K: unexpected marker {m:#x} after tile")

        for isot, rec in self.tiles_done.items():
            self._decode_tile(isot, rec, comps)

        # component transform + level shift
        cs = self.styles["*"]
        if cs.mct and self.ncomp >= 3:
            # codestream comps are (Y, Cb, Cr); output order is (R, G, B)
            c0, c1, c2 = comps[0], comps[1], comps[2]
            if cs.transform == 1:  # RCT inverse (G.2): Cb = B-G, Cr = R-G
                g = c0 - np.floor((c1 + c2) / 4.0)
                r = c2 + g
                b = c1 + g
                comps[0], comps[1], comps[2] = r, g, b
            else:                   # ICT (YCbCr)
                r = c0 + 1.402 * c2
                g = c0 - 0.344136 * c1 - 0.714136 * c2
                b = c0 + 1.772 * c1
                comps[0], comps[1], comps[2] = r, g, b
        out = []
        for ci in range(self.ncomp):
            depth = self.comp_depth[ci]
            a = comps[ci]
            if not self.comp_signed[ci]:
                a = a + (1 << (depth - 1))
                lo, hi = 0, (1 << depth) - 1
            else:
                lo, hi = -(1 << (depth - 1)), (1 << (depth - 1)) - 1
            # corrupt irreversible mantissas can yield inf/NaN; clip after
            # nan_to_num so the cast below never hits an invalid value
            a = np.clip(np.rint(np.nan_to_num(a)), lo, hi)
            dt = (np.int32 if self.comp_signed[ci] else np.uint32)
            if depth <= 8:
                dt = np.int8 if self.comp_signed[ci] else np.uint8
            elif depth <= 16:
                dt = np.int16 if self.comp_signed[ci] else np.uint16
            out.append(a.astype(dt))
        if self.ncomp == 1:
            return out[0]
        return np.stack(out, axis=-1)

    # --- tile decoding ---
    def _decode_tile(self, isot: int, rec: dict, comps: list):
        tx = isot % self.ntx
        ty = isot // self.ntx
        tx0 = max(self.xto + tx * self.xt, self.xo)
        ty0 = max(self.yto + ty * self.yt, self.yo)
        tx1 = min(self.xto + (tx + 1) * self.xt, self.xsiz)
        ty1 = min(self.yto + (ty + 1) * self.yt, self.ysiz)
        if tx1 <= tx0 or ty1 <= ty0:
            return
        styles, quants = rec["styles"], rec["quants"]
        data = b"".join(rec["parts"])

        tcomps = []
        for ci in range(self.ncomp):
            cs = styles.get(ci, styles["*"])
            q = quants.get(ci, quants["*"])
            tc = _TileComp()
            tc.style, tc.quant = cs, q
            tc.x0, tc.y0, tc.x1, tc.y1 = tx0, ty0, tx1, ty1
            tc.resolutions = []
            nl = cs.levels
            for r in range(nl + 1):
                den = 1 << (nl - r)
                rx0, ry0 = _ceil_div(tx0, den), _ceil_div(ty0, den)
                rx1, ry1 = _ceil_div(tx1, den), _ceil_div(ty1, den)
                ppx, ppy = cs.precincts[r]
                # code-block size inside a precinct (B.7): min of cb size
                # and precinct size (halved above res 0 for the band grid)
                res = _Resolution(r, rx0, ry0, rx1, ry1, ppx, ppy)
                if r == 0:
                    cbw = min(cs.cbw, ppx)
                    cbh = min(cs.cbh, ppy)
                    res.bands.append(_Subband(
                        "LL", rx0, ry0, rx1, ry1, cbw, cbh))
                else:
                    cbw = min(cs.cbw, ppx - 1)
                    cbh = min(cs.cbh, ppy - 1)
                    den2 = 1 << (nl - r + 1)
                    # band coordinates (Eq B-15): with xob/yob offsets
                    for kind, xob, yob in (("HL", 1, 0), ("LH", 0, 1),
                                           ("HH", 1, 1)):
                        bx0 = _ceil_div(tx0 - (1 << (nl - r)) * xob, den2)
                        by0 = _ceil_div(ty0 - (1 << (nl - r)) * yob, den2)
                        bx1 = _ceil_div(tx1 - (1 << (nl - r)) * xob, den2)
                        by1 = _ceil_div(ty1 - (1 << (nl - r)) * yob, den2)
                        res.bands.append(_Subband(
                            kind, bx0, by0, bx1, by1, cbw, cbh))
                tc.resolutions.append(res)
            tcomps.append(tc)

        self._read_packets(data, tcomps)

        # tier-1 + dequant + IDWT per component
        for ci, tc in enumerate(tcomps):
            cs, q = tc.style, tc.quant
            reversible = cs.transform == 1
            nl = cs.levels
            # decode every code-block into its subband plane
            band_planes = {}
            sb_index = 0
            for r, res in enumerate(tc.resolutions):
                for band in res.bands:
                    bw, bh = band.x1 - band.x0, band.y1 - band.y0
                    plane = (np.zeros((bh, bw), np.int64) if reversible
                             else np.zeros((bh, bw), np.float64))
                    # quantization parameters for this subband
                    gain = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}[band.kind]
                    if q.style == 1 and sb_index > 0:
                        # scalar derived (E-5): eps_b = eps_0 - NL + n_b
                        # with n_b = NL - r + 1 for r >= 1
                        eps = q.exps[0] + 1 - max(r, 1)
                        mant = q.mants[0]
                    else:
                        idx = min(sb_index, len(q.exps) - 1)
                        eps = q.exps[idx]
                        mant = q.mants[idx]
                    if reversible:
                        mb = q.guard + eps - 1
                    else:
                        rb = self.comp_depth[ci] + gain
                        mb = q.guard + eps - 1
                    for row in band.blocks:
                        for cb in row:
                            co = _decode_block(cb, band.kind, mb, cs.cbstyle)
                            if not reversible:
                                delta = (2.0 ** (rb - eps)) * (
                                    1.0 + mant / 2048.0)
                                cof = co.astype(np.float64)
                                # mid-point reconstruction for truncated
                                # planes is omitted (lossless-grade data)
                                cof *= delta
                            else:
                                cof = co
                            plane[cb.y0 - band.y0:cb.y1 - band.y0,
                                  cb.x0 - band.x0:cb.x1 - band.x0] = cof
                    band_planes[(r, band.kind)] = (band, plane)
                    sb_index += 1
            self.last_band_planes = band_planes  # debug/verification hook

            # inverse DWT (F.3): iterate resolutions upward
            ll_band, ll = band_planes[(0, "LL")]
            cur = ll.astype(np.int64 if reversible else np.float64)
            cur_x0, cur_y0 = ll_band.x0, ll_band.y0
            for r in range(1, nl + 1):
                hl_b, hl = band_planes[(r, "HL")]
                lh_b, lh = band_planes[(r, "LH")]
                hh_b, hh = band_planes[(r, "HH")]
                res = tc.resolutions[r]
                # 2D synthesis (F.3.4): columns then rows of interleaved
                u0, u1 = res.x0, res.x1
                v0, v1 = res.y0, res.y1
                idwt = _idwt53_1d if reversible else _idwt97_1d
                # The forward transform applies the vertical split first,
                # then horizontal (matches OpenJPEG; verified against a
                # forward-5/3 oracle in tests) — so synthesis must merge
                # HORIZONTALLY first. With the nonlinear lifting floors
                # the order is NOT interchangeable (off-by-few-LSB errors
                # otherwise).
                top = idwt(cur, hl, u0 & 1, 1)       # h-merge: LL | HL
                bottom = idwt(lh, hh, u0 & 1, 1)     # h-merge: LH | HH
                full = idwt(top, bottom, v0 & 1, 0)  # v-merge
                cur = full
                cur_x0, cur_y0 = u0, v0
            # place into component canvas
            oy, ox = cur_y0 - self.yo, cur_x0 - self.xo
            comps[ci][oy:oy + cur.shape[0], ox:ox + cur.shape[1]] = cur

    # --- tier-2: packets ---
    def _read_packets(self, data: bytes, tcomps: list):
        cs0 = tcomps[0].style
        layers = cs0.layers
        max_res = max(tc.style.levels for tc in tcomps) + 1
        # iteration order per progression (B.12)
        seq = []
        prog = cs0.prog
        n_prec = {}
        for ci, tc in enumerate(tcomps):
            for r, res in enumerate(tc.resolutions):
                n_prec[(ci, r)] = max(res.pw * res.ph, 0)

        def packets_lrcp():
            for l in range(layers):
                for r in range(max_res):
                    for ci, tc in enumerate(tcomps):
                        if r >= len(tc.resolutions):
                            continue
                        for p in range(n_prec[(ci, r)]):
                            yield (ci, r, p, l)

        def packets_rlcp():
            for r in range(max_res):
                for l in range(layers):
                    for ci, tc in enumerate(tcomps):
                        if r >= len(tc.resolutions):
                            continue
                        for p in range(n_prec[(ci, r)]):
                            yield (ci, r, p, l)

        def packets_pos_outer(order: str):
            # RPCL / PCRL / CPRL need spatial precinct iteration; with
            # the common whole-subband precincts this degenerates to one
            # precinct per resolution. Implement via positional scan over
            # the tile grid in precinct-origin coordinates.
            tx0 = min(tc.x0 for tc in tcomps)
            ty0 = min(tc.y0 for tc in tcomps)
            tx1 = max(tc.x1 for tc in tcomps)
            ty1 = max(tc.y1 for tc in tcomps)
            # step = smallest precinct projection on the image grid
            def prec_geom(tc, r):
                res = tc.resolutions[r]
                nl = tc.style.levels
                den = 1 << (nl - r)
                px = res.ppx + (nl - r)
                py = res.ppy + (nl - r)
                return res, px, py, den
            step = 1 << 30
            for ci, tc in enumerate(tcomps):
                for r in range(len(tc.resolutions)):
                    _, px, py, _ = prec_geom(tc, r)
                    step = min(step, 1 << px, 1 << py)
            ys = range(ty0, ty1 + step, step)
            xs = range(tx0, tx1 + step, step)

            def pos_hits(y, x):
                hits = []
                for ci, tc in enumerate(tcomps):
                    for r in range(len(tc.resolutions)):
                        res, px, py, den = prec_geom(tc, r)
                        if res.pw * res.ph == 0:
                            continue
                        # does a precinct start at (x, y) for this res?
                        ok_x = (x % (1 << px) == 0) or (
                            x == tx0 and (res.x0 << (tc.style.levels - r))
                            % (1 << px) != 0)
                        ok_y = (y % (1 << py) == 0) or (
                            y == ty0 and (res.y0 << (tc.style.levels - r))
                            % (1 << py) != 0)
                        if not (ok_x and ok_y):
                            continue
                        # precinct index at this position
                        rx = _ceil_div(x, den)
                        ry = _ceil_div(y, den)
                        pi = ((ry >> res.ppy) - (res.y0 >> res.ppy)) * res.pw \
                            + ((rx >> res.ppx) - (res.x0 >> res.ppx))
                        if 0 <= pi < res.pw * res.ph:
                            hits.append((ci, r, pi))
                return hits

            seen = set()
            if order == "RPCL":
                for r in range(max_res):
                    for y in ys:
                        for x in xs:
                            for ci, rr, p in pos_hits(y, x):
                                if rr != r or (ci, rr, p) in seen:
                                    continue
                                seen.add((ci, rr, p))
                                for l in range(layers):
                                    yield (ci, rr, p, l)
            elif order == "PCRL":
                for y in ys:
                    for x in xs:
                        for ci, rr, p in pos_hits(y, x):
                            if (ci, rr, p) in seen:
                                continue
                            seen.add((ci, rr, p))
                            for l in range(layers):
                                yield (ci, rr, p, l)
            else:  # CPRL
                for ci in range(len(tcomps)):
                    for y in ys:
                        for x in xs:
                            for ci2, rr, p in pos_hits(y, x):
                                if ci2 != ci or (ci2, rr, p) in seen:
                                    continue
                                seen.add((ci2, rr, p))
                                for l in range(layers):
                                    yield (ci2, rr, p, l)

        if prog == 0:
            seq = packets_lrcp()
        elif prog == 1:
            seq = packets_rlcp()
        elif prog == 2:
            seq = packets_pos_outer("RPCL")
        elif prog == 3:
            seq = packets_pos_outer("PCRL")
        elif prog == 4:
            seq = packets_pos_outer("CPRL")
        else:
            raise CodecError(f"J2K: unknown progression {prog}")

        pos = 0
        for (ci, r, p, l) in seq:
            pos = self._read_one_packet(data, pos, tcomps[ci], r, p, l)
            if pos >= len(data):
                break

    def _read_one_packet(self, data: bytes, pos: int, tc: _TileComp,
                         r: int, p: int, layer: int) -> int:
        cs = tc.style
        res = tc.resolutions[r]
        if cs.sop and pos + 6 <= len(data) and \
                data[pos:pos + 2] == b"\xff\x91":
            pos += 6
        rdr = _HeaderReader(data, pos)
        if rdr.bit() == 0:
            # empty packet
            rdr.align()
            pos = rdr.pos
            if cs.eph and data[pos:pos + 2] == b"\xff\x92":
                pos += 2
            return pos

        contributions = []
        for band in res.bands:
            if band.bw == 0:
                continue
            # precinct-local code-block range
            ppx = res.ppx if r == 0 else res.ppx - 1
            ppy = res.ppy if r == 0 else res.ppy - 1
            pi_x = p % max(res.pw, 1)
            pi_y = p // max(res.pw, 1)
            # precinct bounds on the band grid
            px0 = ((band.x0 >> ppx) + pi_x) << ppx
            py0 = ((band.y0 >> ppy) + pi_y) << ppy
            px1 = min(px0 + (1 << ppx), band.x1)
            py1 = min(py0 + (1 << ppy), band.y1)
            px0 = max(px0, band.x0)
            py0 = max(py0, band.y0)
            if px1 <= px0 or py1 <= py0:
                continue
            inc_key = (id(band), p)
            if inc_key not in res.inc_trees:
                # tag trees sized to the precinct's block grid:
                # determine which blocks fall in this precinct
                cover = []
                for by in range(band.bh):
                    rowc = []
                    for bx in range(band.bw):
                        cb = band.blocks[by][bx]
                        if (cb.x0 < px1 and cb.x1 > px0 and
                                cb.y0 < py1 and cb.y1 > py0):
                            rowc.append((by, bx))
                    if rowc:
                        cover.append(rowc)
                gw = max((len(rw) for rw in cover), default=0)
                gh = len(cover)
                res.inc_trees[inc_key] = (
                    _TagTree(max(gw, 1), max(gh, 1)),
                    _TagTree(max(gw, 1), max(gh, 1)), cover)
            inc_tree, zbp_tree, cover = res.inc_trees[inc_key]
            for gy, rowc in enumerate(cover):
                for gx, (by, bx) in enumerate(rowc):
                    cb = band.blocks[by][bx]
                    if not cb.included:
                        # first inclusion: tag-tree threshold = layer+1
                        # (B.10.4) — the tree is stateful, so a block
                        # first included at layer k consumes its
                        # continuation bits across layers 0..k
                        included = inc_tree.decode(rdr, gy, gx, layer + 1)
                        if not included:
                            continue
                        cb.included = True
                        # zero bit-planes
                        zb = 1
                        while not zbp_tree.decode(rdr, gy, gx, zb):
                            zb += 1
                        cb.zbp = zbp_tree.value(gy, gx)
                        new_inc = True
                    else:
                        if rdr.bit() == 0:
                            continue
                        new_inc = False
                    # number of passes (B.10.6)
                    if rdr.bit() == 0:
                        npass = 1
                    elif rdr.bit() == 0:
                        npass = 2
                    else:
                        v = rdr.bits(2)
                        if v < 3:
                            npass = 3 + v
                        else:
                            v = rdr.bits(5)
                            if v < 31:
                                npass = 6 + v
                            else:
                                npass = 37 + rdr.bits(7)
                    # length: lblock update + segments
                    while rdr.bit():
                        cb.lblock += 1
                    cbstyle = cs.cbstyle
                    segs = self._segment_lengths(cb, npass, cbstyle, rdr)
                    contributions.append((cb, segs))
        rdr.align()
        pos = rdr.pos
        if cs.eph:
            if data[pos:pos + 2] == b"\xff\x92":
                pos += 2
        # packet body
        for cb, segs in contributions:
            for (npass, nbytes) in segs:
                cb.data_parts.append((data[pos:pos + nbytes], npass))
                cb.nb_seg_passes.append((nbytes, npass))
                cb.passes_total += npass
                pos += nbytes
        return pos

    @staticmethod
    def _segment_lengths(cb: _CodeBlock, npass: int, cbstyle: int,
                         rdr: _HeaderReader):
        """Split this packet's passes into coded segments and read each
        segment's byte length (B.10.7)."""
        bypass = bool(cbstyle & 1)
        termall = bool(cbstyle & 4)

        if cbstyle & 0x40:
            # HT (T.814) block: the cleanup pass is its own segment;
            # SigProp+MagRef share the second segment (its length word
            # uses lblock + floor(log2(n_passes_in_segment)) bits, same
            # B.10.7 rule). Pinned against OpenJPEG in tests/test_htj2k.
            start = cb.passes_total
            segs = []
            k = start
            while k < start + npass:
                if k == 0:
                    n_in_seg = 1
                else:
                    n_in_seg = start + npass - k
                nbits = cb.lblock + int(math.floor(math.log2(n_in_seg)))
                segs.append((n_in_seg, rdr.bits(nbits)))
                k += n_in_seg
            return segs

        def pass_type(k: int) -> int:
            # absolute pass index k: 0 = cleanup, then SPP/MRP/CUP triples
            if k == 0:
                return 2
            return (k - 1) % 3

        def is_raw(k: int) -> bool:
            if not bypass:
                return False
            t = pass_type(k)
            # raw from the 10th pass on (4 MQ bit-planes = passes 0..9)
            return t in (0, 1) and k >= 10

        start = cb.passes_total
        segs = []
        seg_start = start
        for k in range(start, start + npass):
            last = (k == start + npass - 1)
            boundary = last or termall or (
                bypass and k + 1 < start + npass and
                (is_raw(k) != is_raw(k + 1)))
            if boundary:
                n_in_seg = k - seg_start + 1
                nbits = cb.lblock + int(math.floor(math.log2(n_in_seg)))
                nbytes = rdr.bits(nbits)
                segs.append((n_in_seg, nbytes))
                seg_start = k + 1
        return segs


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _unwrap_jp2(data: bytes) -> bytes:
    """Accept raw codestreams or JP2 box files (extract the jp2c box)."""
    if data[:2] == b"\xff\x4f":
        return data
    pos = 0
    n = len(data)
    while pos + 8 <= n:
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        typ = data[pos + 4:pos + 8]
        hdr = 8
        if ln == 1:
            (ln,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            hdr = 16
        if typ == b"jp2c":
            end = pos + ln if ln else n
            return data[pos + hdr:end]
        if ln == 0:
            break
        pos += ln
    raise CodecError("J2K: no codestream found (not raw, no jp2c box)")


def j2k_decode(data: bytes,
               expect_hw: tuple[int, int] | None = None) -> np.ndarray:
    """Decode a JPEG 2000 codestream (raw or JP2-boxed) to a numpy array:
    (rows, cols) for single-component, (rows, cols, comps) otherwise.
    Raises CodecError on malformed or unsupported streams.

    expect_hw: when the container (e.g. DICOM Rows/Columns) already knows
    the image size, the SIZ header is validated against it BEFORE any
    image-sized allocation (fuzz finding: a corrupt SIZ otherwise drives
    a multi-GiB np.zeros)."""
    try:
        return _Decoder(_unwrap_jp2(data), expect_hw).decode()
    except (IndexError, KeyError, struct.error, MemoryError) as e:
        # KeyError: corrupt tile headers can reference component styles /
        # quant tables that were never declared (fuzz finding)
        raise CodecError(f"J2K: malformed stream: {e!r}") from e
