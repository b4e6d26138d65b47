"""The bilevel fax codes of TIFF (ITU-T T.4 and T.6), as libtiff's tif_fax3.c
decodes them for cv2.

- Compression 2 (Modified Huffman, "CCITT RLE"): each row 1-D coded, no
  EOLs, the next row starting at the next byte.
- Compression 3 (T.4, group 3): each row after an EOL (eleven or more
  zeros, then a one; fill bits before it are skipped, as libtiff's
  SYNC_EOL skips them); with T4Options bit 0, a tag bit after each EOL says
  whether the row is 1-D or 2-D coded against the row before.
- Compression 4 (T.6, group 4): every row 2-D coded against the row
  before, the first against an all-white row; no EOLs.

A 1-D row alternates white and black runs, white first: make-up codes
(64-1728, and the extended 1792-2560 both colours share) add up until a
terminating code (0-63) ends the run. A 2-D row codes its changes against
the reference row with the pass, horizontal (two 1-D runs) and vertical
(-3..3) modes, as libtiff's EXPAND2D walks them (runs kept as lengths,
b1 found two runs at a time). Each strip or tile starts afresh.

`ccitt_decode` gives the rows as TIFF's 1-bit samples, packed MSB first,
a 1 for each pixel of the odd (black) runs, as libtiff's fill gives them;
`tiff.py`'s 1-bit path then maps them to 0/255 with min-is-white
honoured, as cv2 gets them through TIFFReadRGBA.
"""

from __future__ import annotations

import numpy as np


class CcittError(ValueError):
    """A fax stream this decoder does not read."""


_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100")
_WHITE_MAKEUP = (   # 64, 128, ..., 1728
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 010011011")
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 "
    "00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 "
    "00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 000011010010 "
    "000011010011 000011010100 000011010101 000011010110 000011010111 000001101100 "
    "000001101101 000011011010 000011011011 000001010100 000001010101 000001010110 "
    "000001010111 000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
    "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
    "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
    "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101")
_EXT_MAKEUP = (     # 1792, 1856, ..., 2560, either colour
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
    "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111")
_PEEK = 13              # the longest code (a black make-up) in bits
_TERM, _MAKEUP, _EOL = 0, 1, 2
# 2-D modes: code -> (mode, vertical offset); an extension or an EOL ends
# the decode
_PASS, _HORIZ, _VERT, _EXT = 0, 1, 2, 3
_MODES = {"1": (_VERT, 0), "011": (_VERT, 1), "000011": (_VERT, 2), "0000011": (_VERT, 3),
          "010": (_VERT, -1), "000010": (_VERT, -2), "0000010": (_VERT, -3), "001": (_HORIZ, 0),
          "0001": (_PASS, 0), "0000001": (_EXT, 0), "0000000": (_EXT, 0)}


def _run_table(term: str, makeup: str) -> list:
    """The next 13 bits -> (code length, run, kind), kind -1 where no code
    starts; 000000000001 is the EOL."""
    table = [(0, 0, -1)] * (1 << _PEEK)
    codes = [(c, r, _TERM) for r, c in enumerate(term.split())]
    codes += [(c, 64 * (k + 1), _MAKEUP) for k, c in enumerate(makeup.split())]
    codes += [(c, 1792 + 64 * k, _MAKEUP) for k, c in enumerate(_EXT_MAKEUP.split())]
    codes.append(("000000000001", 0, _EOL))
    for code, run, kind in codes:
        lo = int(code, 2) << (_PEEK - len(code))
        table[lo:lo + (1 << (_PEEK - len(code)))] = [(len(code), run, kind)] * (
            1 << (_PEEK - len(code)))
    return table


def _mode_table() -> list:
    """The next 13 bits -> (code length, mode, offset)."""
    table = [(0, -1, 0)] * (1 << _PEEK)
    for code, (mode, off) in _MODES.items():
        lo = int(code, 2) << (_PEEK - len(code))
        table[lo:lo + (1 << (_PEEK - len(code)))] = [(len(code), mode, off)] * (
            1 << (_PEEK - len(code)))
    return table


_WHITE, _BLACK, _MODE = (_run_table(_WHITE_TERM, _WHITE_MAKEUP),
                         _run_table(_BLACK_TERM, _BLACK_MAKEUP), _mode_table())


class _Bits:
    """MSB-first bits of a strip, read through every 13-bit window."""

    def __init__(self, data: bytes):
        bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.n = len(bits)
        bits = np.concatenate([bits, np.zeros(_PEEK, np.uint8)]).astype(np.uint16)
        win = np.zeros(self.n + 1, np.uint16)
        for k in range(_PEEK):
            win |= bits[k:k + self.n + 1] << (_PEEK - 1 - k)
        self.win = win.tolist()
        self.bits = bits
        self.pos = 0

    def run(self, table: list) -> int:
        """One run: make-up codes added up to a terminating code."""
        total = 0
        while True:
            if self.pos >= self.n:
                raise CcittError("fax strip ends inside a row")
            length, run, kind = table[self.win[self.pos]]
            if kind != _TERM and kind != _MAKEUP:
                raise CcittError("bad run code")
            self.pos += length
            total += run
            if kind == _TERM:
                return total

    def sync_eol(self) -> None:
        """libtiff's SYNC_EOL: skip to where eleven zeros start, past any
        zeros after them, and past the one that ends the EOL."""
        bits, n, pos = self.bits, self.n, self.pos
        while pos + 11 <= n and bits[pos:pos + 11].any():
            pos += 1
        while pos < n and not bits[pos]:
            pos += 1
        if pos >= n:
            raise CcittError("fax strip ends before an EOL")
        self.pos = pos + 1


def _row_1d(br: _Bits, width: int) -> list:
    """A 1-D coded row's runs, white first."""
    runs, a0 = [], 0
    while True:
        r = br.run(_WHITE)
        runs.append(r)
        a0 += r
        if a0 >= width:
            break
        r = br.run(_BLACK)
        runs.append(r)
        a0 += r
        if a0 >= width:
            break
        if runs[-1] == 0 and runs[-2] == 0:     # libtiff drops a pair of empty runs
            del runs[-2:]
    return runs


def _row_2d(br: _Bits, ref: list, width: int) -> list:
    """A 2-D coded row's runs against the reference row's (libtiff's
    EXPAND2D; `ref` ends in zero runs, so b1 never walks past it)."""
    cur: list = []
    a0 = pending = 0          # pending: the current colour's run so far (RunLength)
    b1, pb = ref[0], 1
    win, table = br.win, _MODE
    while a0 < width:
        if br.pos >= br.n:
            raise CcittError("fax strip ends inside a row")
        length, mode, off = table[win[br.pos]]
        if mode < 0 or mode == _EXT:
            raise CcittError("bad 2-D mode code")
        br.pos += length
        if cur:                       # CHECK_b1
            while b1 <= a0 and b1 < width:
                b1 += ref[pb] + ref[pb + 1]
                pb += 2
        if mode == _PASS:
            b1 += ref[pb]
            pending += b1 - a0
            a0 = b1
            b1 += ref[pb + 1]
            pb += 2
        elif mode == _HORIZ:
            first, second = (_BLACK, _WHITE) if len(cur) & 1 else (_WHITE, _BLACK)
            for table_ in (first, second):
                r = br.run(table_)
                cur.append(pending + r)
                a0 += r
                pending = 0
            while b1 <= a0 and b1 < width:
                b1 += ref[pb] + ref[pb + 1]
                pb += 2
        else:
            if off < 0 and b1 < a0 - off:
                raise CcittError("vertical mode left of a0")
            cur.append(pending + b1 - a0 + off)
            a0 = b1 + off
            pending = 0
            if off < 0:
                pb -= 1
                b1 -= ref[pb]
            else:
                b1 += ref[pb]
                pb += 1
    if pending:
        cur.append(pending)
    return cur


def _pixels(runs: list, width: int) -> np.ndarray:
    """Runs (white first) -> a row of 0/1, 1 for the black runs; runs past
    the width are cut and a short row ends white, as libtiff's
    CLEANUP_RUNS leaves it."""
    row = np.zeros(width, np.uint8)
    ends = np.minimum(np.cumsum(runs, dtype=np.int64), width)
    for s, e in zip(ends[0::2].tolist(), ends[1::2].tolist()):
        row[s:e] = 1
    return row


def ccitt_decode(data: bytes, width: int, rows: int, compression: int,
                 t4options: int = 0) -> bytes:
    """One strip or tile of fax codes -> `rows` rows of `width` 1-bit samples,
    packed MSB first (TIFF's 1-bit layout)."""
    if compression not in (2, 3, 4):
        raise CcittError(f"compression {compression} is not a fax code")
    if compression == 3 and t4options & 2:
        raise CcittError("T.4 uncompressed mode")
    br = _Bits(data)
    out = np.zeros((rows, width), np.uint8)
    ref = [width, 0, 0, 0]
    for y in range(rows):
        if compression == 2:
            runs = _row_1d(br, width)
            br.pos = -(-br.pos // 8) * 8
        elif compression == 3:
            br.sync_eol()
            two_d = False
            if t4options & 1:
                if br.pos >= br.n:
                    raise CcittError("fax strip ends inside a row")
                two_d = not br.bits[br.pos]
                br.pos += 1
            runs = _row_2d(br, ref, width) if two_d else _row_1d(br, width)
        else:
            runs = _row_2d(br, ref, width)
        out[y] = _pixels(runs, width)
        ref = runs + [0] * 5           # libtiff's imaginary change, and room
    return np.packbits(out, axis=1).tobytes()
