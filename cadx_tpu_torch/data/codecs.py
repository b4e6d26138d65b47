"""DICOM compressed pixel-data codecs, self-contained (no pydicom/PIL).

The port's own copy of `cadx_tpu/data/codecs.py`. The reference reads its
CBIS-DDSM dataset with pydicom (Classes/Preprocessing.py:149,
Classes/load.py:10); real TCIA/CBIS-DDSM mammograms ship JPEG-Lossless-compressed
(1.2.840.10008.1.2.4.70), so the framework's reader must decode:

- RLE Lossless (1.2.840.10008.1.2.5) — DICOM PS3.5 Annex G: a 64-byte
  offset header + up to 15 PackBits-compressed byte segments (16-bit
  data splits into an MSB and an LSB plane).
- JPEG Lossless, Non-Hierarchical, First-Order Prediction (Process 14,
  Selection Value 1; 1.2.840.10008.1.2.4.70) — ITU T.81 sections
  covering SOF3 frames: Huffman-coded category + magnitude-extension
  difference bits, predictor Px = Ra (left), first column predicted
  from Rb (above), first sample from 2^(P-1).

Both directions are implemented (encoders exist so tests can round-trip
fixture bytes without any external dependency). Pure NumPy/Python; the
native loader (native/cadx_io.cc) carries a C++ fast path for decode —
these are the reference implementations and the no-toolchain fallback.
"""

from __future__ import annotations

import struct

import numpy as np


class CodecError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Encapsulated pixel-data framing (PS3.5 Annex A.4)
# ---------------------------------------------------------------------------

_ITEM = 0xE000
_SEQ_DELIM = 0xE0DD
_FFFE = 0xFFFE


def _parse_items(raw: bytes):
    """(bot_offsets, fragments, fragment_offsets) of an encapsulated
    PixelData value (the bytes AFTER the undefined-length header). The
    first item is the Basic Offset Table: a list of uint32 byte offsets
    of each frame's first fragment ITEM HEADER, measured from the first
    byte after the BOT item (PS3.5 A.4) — empty when absent."""
    frags: list[bytes] = []
    frag_offs: list[int] = []
    bot: list[int] = []
    off = 0
    buf = memoryview(raw)
    first = True
    base = None  # offset of the first byte after the BOT item
    while off + 8 <= len(buf):
        group, elem = struct.unpack_from("<HH", buf, off)
        length = struct.unpack_from("<I", buf, off + 4)[0]
        off += 8
        if group != _FFFE:
            raise CodecError(f"bad item tag ({group:04x},{elem:04x}) in "
                             "encapsulated pixel data")
        if elem == _SEQ_DELIM:
            break
        if elem != _ITEM:
            raise CodecError(f"unexpected tag ({group:04x},{elem:04x})")
        if off + length > len(buf):
            raise CodecError("encapsulated item overruns pixel data")
        if first:
            first = False  # Basic Offset Table
            if length % 4:
                raise CodecError(f"Basic Offset Table length {length} "
                                 "not a multiple of 4")
            bot = list(struct.unpack_from(f"<{length // 4}I", buf, off))
            base = off + length
        else:
            frag_offs.append(off - 8 - base)
            frags.append(bytes(buf[off:off + length]))
        off += length
    return bot, frags, frag_offs


def parse_fragments(raw: bytes) -> list[bytes]:
    """Fragments of an encapsulated PixelData value (BOT dropped)."""
    return _parse_items(raw)[1]


def split_frames(raw: bytes, n_frames: int) -> list[bytes]:
    """Group an encapsulated PixelData value's fragments into per-frame
    byte streams, pydicom-compatible rules:

    - one frame: all fragments concatenate;
    - a non-empty Basic Offset Table maps frames to fragments exactly
      (offset of each frame's first fragment header);
    - no BOT: only the unambiguous one-fragment-per-frame layout is
      accepted; anything else raises (guessing frame boundaries would
      silently decode garbage)."""
    bot, frags, frag_offs = _parse_items(raw)
    if not frags:
        raise CodecError("encapsulated PixelData has no fragments")
    if n_frames <= 1:
        return [b"".join(frags)]
    if bot:
        if len(bot) != n_frames:
            raise CodecError(
                f"Basic Offset Table has {len(bot)} entries for "
                f"{n_frames} frames")
        if bot[0] != 0 or list(bot) != sorted(bot):
            raise CodecError(f"implausible Basic Offset Table {bot}")
        starts = []
        for i, target in enumerate(bot):
            try:
                starts.append(frag_offs.index(target))
            except ValueError:
                raise CodecError(
                    f"BOT offset {target} does not land on a fragment "
                    f"boundary (fragment offsets {frag_offs})") from None
        starts.append(len(frags))
        return [b"".join(frags[starts[i]:starts[i + 1]])
                for i in range(n_frames)]
    if len(frags) == n_frames:
        return list(frags)
    raise CodecError(
        f"cannot map {len(frags)} fragments to {n_frames} frames "
        "without a Basic Offset Table")


def encapsulate(fragments: list[bytes], bot: bool = False) -> bytes:
    """Build an encapsulated PixelData value: Basic Offset Table item
    (empty unless `bot`, then one frame per fragment) + one item per
    fragment + sequence delimiter."""
    padded = [f + b"\x00" if len(f) % 2 else f for f in fragments]
    if bot:
        offs, pos = [], 0
        for f in padded:
            offs.append(pos)
            pos += 8 + len(f)
        table = struct.pack(f"<{len(offs)}I", *offs)
    else:
        table = b""
    out = [struct.pack("<HHI", _FFFE, _ITEM, len(table)), table]
    for f in padded:
        out.append(struct.pack("<HHI", _FFFE, _ITEM, len(f)))
        out.append(f)
    out.append(struct.pack("<HHI", _FFFE, _SEQ_DELIM, 0))
    return b"".join(out)


# ---------------------------------------------------------------------------
# RLE Lossless (PS3.5 Annex G): PackBits segments
# ---------------------------------------------------------------------------

def _packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 128:                       # literal run of ctrl+1 bytes
            out += data[i:i + ctrl + 1]
            i += ctrl + 1
        elif ctrl > 128:                     # replicate next byte 257-ctrl
            if i >= n:
                break
            out += bytes([data[i]]) * (257 - ctrl)
            i += 1
        # ctrl == 128: no-op
    if len(out) < expected:
        raise CodecError(f"RLE segment short: {len(out)} < {expected}")
    return bytes(out[:expected])


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # find replicate run
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        run = j - i + 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i = j + 1
            continue
        # literal run until next replicate of >=3 (2-runs inside literals
        # are cheaper left literal) or 128 bytes
        j = i
        while j < n and j - i < 128:
            if (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
                break
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def rle_encode(arr: np.ndarray) -> bytes:
    """Encode a (rows, cols) uint8/uint16 array as a DICOM RLE frame."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint8:
        planes = [arr.tobytes()]
    elif arr.dtype == np.uint16:
        be = arr.astype(">u2").tobytes()
        planes = [be[0::2], be[1::2]]        # MSB segment then LSB segment
    else:
        raise CodecError("RLE encoder supports uint8/uint16")
    segs = []
    for p in planes:
        s = _packbits_encode(p)
        if len(s) % 2:
            s += b"\x00"
        segs.append(s)
    header = struct.pack("<I", len(segs))
    off = 64
    offsets = []
    for s in segs:
        offsets.append(off)
        off += len(s)
    offsets += [0] * (15 - len(segs))
    header += struct.pack("<15I", *offsets)
    return header + b"".join(segs)


def rle_decode(frame: bytes, rows: int, cols: int,
               bits_allocated: int) -> np.ndarray:
    """Decode one DICOM RLE frame to (rows, cols) uint8/uint16."""
    if len(frame) < 64:
        raise CodecError("RLE frame shorter than its 64-byte header")
    n_segs = struct.unpack_from("<I", frame, 0)[0]
    offsets = list(struct.unpack_from("<15I", frame, 4))[:n_segs]
    count = rows * cols
    segs = []
    for i, off in enumerate(offsets):
        end = offsets[i + 1] if i + 1 < n_segs else len(frame)
        segs.append(_packbits_decode(frame[off:end], count))
    if bits_allocated == 8:
        if n_segs != 1:
            raise CodecError(f"expected 1 RLE segment for 8-bit, got {n_segs}")
        return np.frombuffer(segs[0], np.uint8).reshape(rows, cols)
    if bits_allocated == 16:
        if n_segs != 2:
            raise CodecError(f"expected 2 RLE segments for 16-bit, got {n_segs}")
        msb = np.frombuffer(segs[0], np.uint8).astype(np.uint16)
        lsb = np.frombuffer(segs[1], np.uint8).astype(np.uint16)
        return ((msb << 8) | lsb).reshape(rows, cols)
    raise CodecError(f"RLE bits_allocated={bits_allocated} unsupported")


# ---------------------------------------------------------------------------
# JPEG Lossless Process 14 / SV1 (ITU T.81, SOF3)
# ---------------------------------------------------------------------------

# canonical Huffman table covering all difference categories 0..16
# (extended JPEG DC-style table; Kraft sum 0.9999…): one 2-bit code for
# the most common small-diff category, five 3-bit codes, then one code
# per length 4..14 for the rare large categories
_ENC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
_ENC_VALS = [1, 0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


def _build_huffman(bits: list[int], vals: list[int]):
    """(code, length) per symbol from a DHT-style BITS/HUFFVAL spec."""
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """The low `lengths[i]` bits of each `values[i]`, MSB first, padded to a
    byte with 1s, every 0xFF byte followed by a stuffed 0x00 (T.81 F.1.2.3)."""
    ends = np.cumsum(lengths)
    total = int(ends[-1]) if len(ends) else 0
    bits = np.ones((total + 7) // 8 * 8, np.uint8)
    starts = ends - lengths
    for b in range(int(lengths.max()) if len(lengths) else 0):
        on = lengths > b
        bits[starts[on] + b] = (values[on] >> (lengths[on] - 1 - b)) & 1
    packed = np.packbits(bits)
    return np.insert(packed, np.flatnonzero(packed == 0xFF) + 1, 0).tobytes()


def jpeg_lossless_encode(arr: np.ndarray, precision: int | None = None,
                         restart_interval: int = 0) -> bytes:
    """Encode (rows, cols) unsigned array as JPEG Lossless SV1 (single
    component, point transform 0). Round-trips with jpeg_lossless_decode
    and with standard DICOM decoders. restart_interval > 0 emits a DRI
    marker and RSTn markers every that many samples (predictor resets at
    each boundary per T.81 H.2.2)."""
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise CodecError("encoder expects a 2-D grayscale array")
    if precision is None:
        precision = 8 if arr.dtype == np.uint8 else 16
    if not 2 <= precision <= 16:
        raise CodecError(f"bad precision {precision}")
    rows, cols = arr.shape
    x = arr.astype(np.int32)

    # SV1 differences: left neighbour; row starts use the pixel above;
    # origin (and every restart boundary) uses 1 << (P-1). Vectorized.
    default = 1 << (precision - 1)
    pred = np.empty_like(x)
    pred[:, 1:] = x[:, :-1]
    pred[1:, 0] = x[:-1, 0]
    pred[0, 0] = default
    flat_pred = pred.ravel().copy()
    if restart_interval:
        flat_pred[::restart_interval] = default
    diff = ((x.ravel() - flat_pred) & 0xFFFF).astype(np.int32)
    diff = np.where(diff >= 32768, diff - 65536, diff)  # mod-2^16 wrap

    # each sample's Huffman code followed by its magnitude bits (category
    # 16, d = -32768, has none), packed MSB first a restart interval at a
    # time; the loop of the JAX package's encoder, vectorized (the same
    # bytes, in time linear in the samples)
    codes = _build_huffman(_ENC_BITS, _ENC_VALS)
    code_of = np.array([codes[k][0] for k in range(17)], np.int64)
    len_of = np.array([codes[k][1] for k in range(17)], np.int64)
    mags = np.abs(diff).astype(np.int64)
    ssss = np.where(mags == 0, 0,
                    np.floor(np.log2(np.maximum(mags, 1))).astype(np.int64) + 1)
    ssss = np.where(diff == -32768, 16, ssss)
    extra = np.where(ssss == 16, 0, ssss)
    magnitude = np.where(diff >= 0, diff, diff + (1 << extra) - 1) & ((1 << extra) - 1)
    values = (code_of[ssss] << extra) | magnitude
    lengths = len_of[ssss] + extra
    step = restart_interval or len(values)
    parts = []
    for k, start in enumerate(range(0, len(values), step)):
        if k:
            parts.append(bytes([0xFF, 0xD0 + ((k - 1) & 7)]))
        parts.append(_pack_bits(values[start:start + step], lengths[start:start + step]))
    scan = b"".join(parts)

    out = bytearray()
    out += b"\xff\xd8"                        # SOI
    # SOF3: precision, rows, cols, 1 component (id 1, sampling 1x1, tq 0)
    out += b"\xff\xc3" + struct.pack(">HBHHB", 8 + 3, precision, rows, cols, 1)
    out += bytes([1, 0x11, 0])
    # DHT: class 0, id 0
    out += b"\xff\xc4" + struct.pack(">H", 2 + 1 + 16 + len(_ENC_VALS))
    out += bytes([0x00]) + bytes(_ENC_BITS) + bytes(_ENC_VALS)
    if restart_interval:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart_interval)
    # SOS: 1 component, selector 1 -> table 0; Ss=1 (predictor), Se=0,
    # Ah=0, Al=0 (point transform)
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2, 1) + bytes([1, 0x00])
    out += bytes([1, 0, 0])
    out += scan
    out += b"\xff\xd9"                        # EOI
    return bytes(out)


class _BitReader:
    """MSB-first bit reader over the RAW scan bytes, de-stuffing FF00
    inline (so restart-marker positions and byte alignment survive)."""

    def __init__(self, data: bytes):
        self.data = data
        self.byte = 0
        self.bit = 0

    def read_bit(self) -> int:
        d = self.data
        if self.byte >= len(d):
            raise IndexError("scan exhausted")
        v = (d[self.byte] >> (7 - self.bit)) & 1
        self.bit += 1
        if self.bit == 8:
            self.bit = 0
            if d[self.byte] == 0xFF:
                if self.byte + 1 < len(d) and d[self.byte + 1] == 0x00:
                    self.byte += 2            # stuffed data byte
                else:
                    self.byte = len(d)        # marker: end of scan
            else:
                self.byte += 1
        return v

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def skip_restart(self) -> None:
        """Byte-align (discard pad bits) and consume an RSTn marker."""
        d = self.data
        if self.bit:
            cur = d[self.byte]
            self.byte += 1
            self.bit = 0
            if cur == 0xFF:
                if self.byte < len(d) and d[self.byte] == 0x00:
                    self.byte += 1            # stuffed data byte
                else:
                    self.byte -= 1            # the FF starts the marker
        if (self.byte + 1 >= len(d) or d[self.byte] != 0xFF
                or not 0xD0 <= d[self.byte + 1] <= 0xD7):
            raise CodecError("expected restart marker")
        self.byte += 2


def jpeg_lossless_decode(data: bytes,
                         expect_hw: tuple[int, int] | None = None
                         ) -> tuple[np.ndarray, int]:
    """Decode a single-component JPEG Lossless (SOF3) stream.

    Supports predictor selection values 1-7 (DICOM's .70 syntax mandates
    SV1; the others come free from the same reconstruction loop) and
    point transform Al. Returns (array int32 (rows, cols), precision).

    expect_hw: when the container (DICOM Rows/Columns) already knows the
    size, mismatching SOF3 dims fail before the huffman scan runs.
    """
    if data[:2] != b"\xff\xd8":
        raise CodecError("missing SOI")
    off = 2
    precision = rows = cols = None
    huff_tables: dict[int, dict] = {}
    predictor = 1
    point_transform = 0
    restart_interval = 0
    scan_data = None
    table_id = 0

    while off + 4 <= len(data):
        if data[off] != 0xFF:
            raise CodecError(f"expected marker at {off}")
        marker = data[off + 1]
        off += 2
        if marker == 0xD9:                    # EOI
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue                          # parameterless
        seglen = struct.unpack_from(">H", data, off)[0]
        seg = data[off + 2: off + seglen]
        if marker == 0xDD:                    # DRI
            if len(seg) < 2:
                raise CodecError("truncated DRI segment")
            restart_interval = struct.unpack_from(">H", seg, 0)[0]
        elif marker == 0xC3:                  # SOF3
            if len(seg) < 6:
                raise CodecError("truncated SOF3 segment")
            precision, rows, cols, ncomp = struct.unpack_from(">BHHB", seg, 0)
            if ncomp != 1:
                raise CodecError(f"only 1-component lossless supported, got {ncomp}")
        elif marker in (0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7,
                        0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise CodecError(f"not a lossless (SOF3) stream: SOF{marker & 0xF:X}")
        elif marker == 0xC4:                  # DHT
            p = 0
            while p < len(seg):
                tc_th = seg[p]
                bits = list(seg[p + 1: p + 17])
                if len(bits) < 16:
                    raise CodecError("truncated DHT segment")
                nv = sum(bits)
                vals = list(seg[p + 17: p + 17 + nv])
                if len(vals) < nv:
                    raise CodecError("truncated DHT segment")
                huff_tables[tc_th & 0x0F] = _build_huffman(bits, vals)
                p += 17 + nv
        elif marker == 0xDA:                  # SOS
            if len(seg) < 6:
                raise CodecError("truncated SOS segment")
            ns = seg[0]
            if ns != 1:
                raise CodecError("multi-component scans unsupported")
            table_id = seg[2] >> 4
            predictor = seg[1 + 2 * ns]       # Ss
            point_transform = seg[3 + 2 * ns] & 0x0F  # Al
            scan_data = data[off + seglen:]
            break
        off += seglen

    if scan_data is None or precision is None:
        raise CodecError("no scan data / SOF3 found")
    if table_id not in huff_tables:
        raise CodecError(f"huffman table {table_id} missing")
    if not 1 <= predictor <= 7:
        raise CodecError(f"bad predictor selection {predictor}")
    if not 2 <= precision <= 16:
        # T.81 B.2.2 lossless allows P in [2, 16]; a hostile byte of 0
        # (or anything out of range) must fail loudly — the default
        # predictor 1 << (P - 1 - Al) would otherwise be a negative
        # shift (raw ValueError here, undefined behavior in C)
        raise CodecError(f"bad SOF3 precision {precision}")
    if point_transform >= precision:
        # T.81 B.2.3: Al must leave at least one magnitude bit
        raise CodecError(
            f"point transform {point_transform} >= precision {precision}")

    if rows * cols > 1 << 28:
        # corrupt/hostile SOF3 dims would otherwise drive a huge
        # allocation before the size check against the DICOM header
        raise CodecError(f"implausible frame size {rows}x{cols}")
    if expect_hw is not None and (rows, cols) != expect_hw:
        # fail before the per-sample huffman loop (hostile streams
        # declaring huge dims against a small DICOM Rows/Columns)
        raise CodecError(f"SOF3 size {rows}x{cols} != expected {expect_hw}")

    # decode-table: (code, len) -> symbol
    dec = {v: k for k, v in huff_tables[table_id].items()}
    r = _BitReader(scan_data)

    n = rows * cols
    diffs = np.empty(n, np.int32)
    read_bit = r.read_bit
    read_bits = r.read_bits
    try:
        for i in range(n):
            if restart_interval and i and i % restart_interval == 0:
                r.skip_restart()
            code = 0
            length = 0
            while True:
                code = (code << 1) | read_bit()
                length += 1
                sym = dec.get((code, length))
                if sym is not None:
                    break
                if length > 16:
                    raise CodecError("invalid huffman code in scan")
            if sym > 16:
                # T.81: SSSS is 0..16 — a hostile DHT value would read
                # up to 255 junk bits per sample (and is UB in the C++
                # fast path, which rejects it identically)
                raise CodecError(f"SSSS category {sym} out of range")
            if sym == 0:
                diffs[i] = 0
            elif sym == 16:
                diffs[i] = 32768
            else:
                v = read_bits(sym)
                if v < (1 << (sym - 1)):      # negative branch
                    v -= (1 << sym) - 1
                diffs[i] = v
    except IndexError as e:
        raise CodecError("truncated scan data") from e

    diffs = diffs.reshape(rows, cols)
    default = 1 << (precision - 1 - point_transform)

    if predictor == 1 and not restart_interval:
        # SV1 (the DICOM .70 case): vectorized cumulative reconstruction
        out = _sv1_reconstruct(diffs, default)
    else:
        out = _reconstruct_scalar(diffs, default, predictor,
                                  restart_interval)

    if point_transform:
        out = out << point_transform
    return out, precision


def _reconstruct_scalar(diffs: np.ndarray, default: int, predictor: int,
                        restart_interval: int) -> np.ndarray:
    """Scalar reconstruction: row 0 and column starts predict SV1-style
    (T.81 H.1.2.2), interior pixels use the selected predictor, and the
    prediction resets to `default` at every restart boundary (H.2.2)."""
    rows, cols = diffs.shape
    out = np.zeros((rows, cols), np.int32)
    for y in range(rows):
        for x in range(cols):
            i = y * cols + x
            if (y == 0 and x == 0) or (
                    restart_interval and i % restart_interval == 0):
                px = default
            elif x == 0:
                px = out[y - 1, 0]
            elif y == 0:
                px = out[0, x - 1]
            elif predictor == 1:
                px = out[y, x - 1]
            elif predictor == 2:
                px = out[y - 1, x]
            elif predictor == 3:
                px = out[y - 1, x - 1]
            elif predictor == 4:
                px = out[y, x - 1] + out[y - 1, x] - out[y - 1, x - 1]
            elif predictor == 5:
                px = out[y, x - 1] + ((out[y - 1, x] - out[y - 1, x - 1]) >> 1)
            elif predictor == 6:
                px = out[y - 1, x] + ((out[y, x - 1] - out[y - 1, x - 1]) >> 1)
            else:
                px = (out[y, x - 1] + out[y - 1, x]) >> 1
            out[y, x] = (px + diffs[y, x]) & 0xFFFF
    return out


def _sv1_reconstruct(diffs: np.ndarray, default: int) -> np.ndarray:
    """Vectorized SV1 reconstruction: first column is a cumsum down rows
    (seeded by 2^(P-1)); each row is a cumsum of diffs from its first
    pixel. All mod 2^16 (uint16 wraparound, matching encoders)."""
    rows, cols = diffs.shape
    d = diffs.astype(np.int64)
    col0 = (default + np.cumsum(d[:, 0])) % 65536
    acc = np.cumsum(d[:, 1:], axis=1)
    out = np.empty((rows, cols), np.int64)
    out[:, 0] = col0
    out[:, 1:] = (col0[:, None] + acc) % 65536
    return out.astype(np.int32)
