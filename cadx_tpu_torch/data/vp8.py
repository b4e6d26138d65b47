"""Key-frame lossy VP8 (RFC 6386) as libwebp decodes it, and cv2's gray of
that decode.

`vp8_decode(data)` turns a `VP8 ` chunk's payload into its Y, U and V
planes, bit for bit as libwebp's decoder (src/dec, src/dsp/dec.c) gives
them:

- the boolean decoder (libwebp's: the range held minus one, a split of
  (range * prob) >> 8), over the first partition (frame header, modes)
  and 1, 2, 4 or 8 token partitions, a macroblock row each in turn; a
  partition read past its end fails the decode, as libwebp's eof check
  does;
- the frame header: segments (quantiser and filter strength, absolute or
  delta, the segment map's tree), the filter type, level, sharpness and
  the per-reference and per-mode deltas, the quantiser indices and their
  five deltas (libwebp's tables; y2's AC scaled by 155 / 100, at least
  8), the token-probability updates and the skip probability;
- the intra modes: 16 x 16 DC/V/H/TM (DC without its top or left row at
  the frame's edges), the ten 4 x 4 modes with their above/left
  contexts, chroma DC/V/H/TM;
- the coefficient tokens with their bands and contexts (libwebp's
  GetCoeffs), dequantised at parse time into int16;
- the inverse WHT of the y2 block and the inverse DCT (`TransformOne`,
  20091 / 35468), added to the prediction with clipping; the prediction
  reads the unfiltered reconstruction (127 above the frame, 129 left of
  it, the above-right pixels of a macroblock's last 4 x 4 column copied
  down, the rightmost macroblock's replicated);
- the simple and normal loop filters with libwebp's strengths (the
  per-segment level, the reference and i4x4 mode deltas, sharpness, the
  interior limit and the high-edge-variance threshold), macroblock and
  inner edges, luma and chroma, in libwebp's order.

`vp8_gray(data)` then takes libwebp's `WebPDecodeBGR` output, its fancy
upsampler (`UpsampleBgrLinePair`: the 9-3-3-1 filter in two rounded
steps, the chroma rows mirrored at the top and bottom) and `VP8YUVToR/G/B`
(14-bit fixed point), and cv2's BGR to gray: (9798 R + 19235 G + 3735 B +
16384) >> 15. uint8, bit-exact.

Reconstruction is serial over macroblocks, since intra prediction reads
the neighbours already rebuilt; numpy takes a macroblock row's inverse
transforms at once, and the loop filter runs an edge at a time over a
wavefront of macroblocks (those with x + 2y equal, which touch disjoint
pixels and whose earlier neighbours in libwebp's raster order are all
done), so the result is libwebp's.
"""

from __future__ import annotations

import numpy as np



class VP8Error(ValueError):
    """A VP8 stream this decoder does not read (libwebp refuses it too)."""


# quantiser steps by index (RFC 6386 14.1)
_DC_Q = np.array([
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86,
    87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122,
    124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157])
_AC_Q = np.concatenate([np.arange(4, 59), np.arange(60, 118, 2), [119, 122, 125, 128, 131, 134,
                        137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173],
                        np.arange(177, 230, 4), [234, 239, 245, 249],
                        np.arange(254, 285, 5)])
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)   # position -> band (16: sentinel)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4x4 mode tree (libwebp's enum: DC TM VE HE RD VR LD VL HD HU); i <= 0 is mode -i
_BMODE_TREE = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
_NORM = [0] + [7 - int(r).bit_length() + 1 for r in range(1, 256)]   # 7 ^ log2(r)
_DC_PRED, _TM_PRED, _V_PRED, _H_PRED = 0, 1, 2, 3
# RFC 6386's default token probabilities (13.5), their update probabilities
# (13.4), both [type][band][context][node], and the key frame's 4x4 mode
# probabilities [above][left][node] in libwebp's mode order
_COEFF_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080"
)
_COEFF_UPDATE = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
)
_BMODE_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418"
)


def _edge_weights() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ten 4 x 4 predictions as (16, 13) integer weights on the edge
    E = [L3, L2, L1, L0, X, A0..A7] (left column bottom up, the corner,
    the row above and its right), a rounding term and a shift a pixel:
    AVG3(a, b, c) = (a + 2b + c + 2) >> 2, AVG2(a, b) = (a + b + 1) >> 1
    (libwebp's VP8PredLuma4)."""
    at = {"L": 0, "K": 1, "J": 2, "I": 3, "X": 4}
    at.update({c: 5 + k for k, c in enumerate("ABCDEFGH")})
    lefts = "IJKL"
    w = np.zeros((10, 16, 13), np.int64)
    rnd = np.zeros((10, 16), np.int64)
    sh = np.zeros((10, 16), np.int64)

    def put(mode, x, y, spec):
        k = 4 * y + x
        if len(spec) == 3:           # AVG3
            for c, wt in zip(spec, (1, 2, 1)):
                w[mode, k, at[c]] += wt
            rnd[mode, k], sh[mode, k] = 2, 2
        elif len(spec) == 2:         # AVG2
            for c in spec:
                w[mode, k, at[c]] += 1
            rnd[mode, k], sh[mode, k] = 1, 1
        else:
            w[mode, k, at[spec]] = 1

    for x in range(4):
        for y in range(4):
            for c in "ABCD" + "IJKL":
                w[0, 4 * y + x, at[c]] = 1                             # DC
            rnd[0, 4 * y + x], sh[0, 4 * y + x] = 4, 3
            w[1, 4 * y + x, [at["ABCD"[x]], at[lefts[y]], at["X"]]] = (1, 1, -1)  # TM
            put(2, x, y, ("XABCDE"[x], "ABCD"[x], "BCDE"[x]))         # VE
            put(3, x, y, (("X", "I", "J"), ("I", "J", "K"), ("J", "K", "L"),
                          ("K", "L", "L"))[y])                         # HE
            put(4, x, y, ("JKL", "IJK", "XIJ", "AXI", "BAX", "CBA", "DCB")[x - y + 3])  # RD
            put(6, x, y, ("ABC", "BCD", "CDE", "DEF", "EFG", "FGH", "GHH")[x + y])      # LD
    vr = {(0, 0): "XA", (1, 2): "XA", (1, 0): "AB", (2, 2): "AB", (2, 0): "BC", (3, 2): "BC",
          (3, 0): "CD", (0, 3): "KJI", (0, 2): "JIX", (0, 1): "IXA", (1, 3): "IXA",
          (1, 1): "XAB", (2, 3): "XAB", (2, 1): "ABC", (3, 3): "ABC", (3, 1): "BCD"}
    vl = {(0, 0): "AB", (1, 0): "BC", (0, 2): "BC", (2, 0): "CD", (1, 2): "CD", (3, 0): "DE",
          (2, 2): "DE", (0, 1): "ABC", (1, 1): "BCD", (0, 3): "BCD", (2, 1): "CDE",
          (1, 3): "CDE", (3, 1): "DEF", (2, 3): "DEF", (3, 2): "EFG", (3, 3): "FGH"}
    hd = {(0, 0): "IX", (2, 1): "IX", (0, 1): "JI", (2, 2): "JI", (0, 2): "KJ", (2, 3): "KJ",
          (0, 3): "LK", (3, 0): "ABC", (2, 0): "XAB", (1, 0): "IXA", (3, 1): "IXA",
          (1, 1): "JIX", (3, 2): "JIX", (1, 2): "KJI", (3, 3): "KJI", (1, 3): "LKJ"}
    hu = {(0, 0): "IJ", (2, 0): "JK", (0, 1): "JK", (2, 1): "KL", (0, 2): "KL", (1, 0): "IJK",
          (3, 0): "JKL", (1, 1): "JKL", (3, 1): "KLL", (1, 2): "KLL"}
    for mode, table in ((5, vr), (7, vl), (8, hd), (9, hu)):
        for x in range(4):
            for y in range(4):
                put(mode, x, y, table.get((x, y), "L"))
    return w, rnd, sh


_W4, _R4, _S4 = _edge_weights()


class _BoolReader:
    """libwebp's VP8BitReader over buf[start:end]: `value` holds the bits
    read ahead, the window at `value >> bits`, `rng` the range minus one."""

    __slots__ = ("buf", "pos", "end", "value", "bits", "rng")

    def __init__(self, buf: bytes, start: int, end: int):
        self.buf, self.pos, self.end = buf, start, end
        self.value, self.bits, self.rng = 0, -8, 254

    def load(self) -> None:
        """More bytes, once the window runs out (bits < 0); none left is
        libwebp's eof, which fails the decode."""
        pos, end = self.pos, self.end
        if end - pos >= 7:
            self.value = (self.value << 56) | int.from_bytes(self.buf[pos:pos + 7], "big")
            self.pos, self.bits = pos + 7, self.bits + 56
        elif pos < end:
            self.value = (self.value << 8) | self.buf[pos]
            self.pos, self.bits = pos + 1, self.bits + 8
        else:
            raise VP8Error("VP8 partition read past its end")

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self.load()
        rng, bits = self.rng, self.bits
        split = (rng * prob) >> 8
        if (self.value >> bits) > split:
            rng -= split
            self.value -= (split + 1) << bits
            bit = 1
        else:
            rng = split + 1
            bit = 0
        s = _NORM[rng]
        self.rng, self.bits = (rng << s) - 1, bits - s
        return bit

    def literal(self, n: int) -> int:
        """VP8GetValue: n bits at probability 1/2, the first the highest."""
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        """VP8GetSignedValue: n bits, then the sign."""
        v = self.literal(n)
        return -v if self.bit(128) else v

    def large(self, p) -> int:
        """libwebp's GetLargeValue: a coefficient magnitude of 2 or more."""
        bit = self.bit
        if not bit(p[3]):
            return 2 if not bit(p[4]) else 3 + bit(p[5])
        if not bit(p[6]):
            if not bit(p[7]):
                return 5 + bit(159)
            return 7 + 2 * bit(165) + bit(145)
        b1 = bit(p[8])
        cat = 2 * b1 + bit(p[9 + b1])
        v = 0
        for prob in _CAT3456[cat]:
            v = 2 * v + bit(prob)
        return v + 3 + (8 << cat)

    def coeffs(self, bands, ctx: int, dq0: int, dq1: int, n: int, idx: list, val: list,
               base: int) -> int:
        """libwebp's GetCoeffs: the tokens of one 4 x 4 block from position
        n, each coefficient times its step (dq0 at 0, else dq1) appended to
        idx/val at base + its raster position; returns the position after
        the last nonzero one (n where the block ends at once). The boolean
        decoder is inlined for the three common probabilities."""
        value, bits, rng = self.value, self.bits, self.rng
        p = bands[n][ctx]
        while n < 16:
            if bits < 0:
                self.value, self.bits = value, bits
                self.load()
                value, bits = self.value, self.bits
            split = (rng * p[0]) >> 8
            if (value >> bits) > split:
                rng -= split
                value -= (split + 1) << bits
                s = _NORM[rng]
                rng, bits = (rng << s) - 1, bits - s
            else:
                rng = split + 1
                s = _NORM[rng]
                rng, bits = (rng << s) - 1, bits - s
                break                                   # end of block
            while True:                                 # a run of zeros
                if bits < 0:
                    self.value, self.bits = value, bits
                    self.load()
                    value, bits = self.value, self.bits
                split = (rng * p[1]) >> 8
                if (value >> bits) > split:
                    rng -= split
                    value -= (split + 1) << bits
                    s = _NORM[rng]
                    rng, bits = (rng << s) - 1, bits - s
                    break
                rng = split + 1
                s = _NORM[rng]
                rng, bits = (rng << s) - 1, bits - s
                n += 1
                if n == 16:
                    self.value, self.bits, self.rng = value, bits, rng
                    return 16
                p = bands[n][0]
            if bits < 0:
                self.value, self.bits = value, bits
                self.load()
                value, bits = self.value, self.bits
            split = (rng * p[2]) >> 8
            if (value >> bits) > split:
                rng -= split
                value -= (split + 1) << bits
                s = _NORM[rng]
                rng, bits = (rng << s) - 1, bits - s
                self.value, self.bits, self.rng = value, bits, rng
                v = self.large(p)
                value, bits, rng = self.value, self.bits, self.rng
                nxt = 2
            else:
                rng = split + 1
                s = _NORM[rng]
                rng, bits = (rng << s) - 1, bits - s
                v, nxt = 1, 1
            if bits < 0:                                # the sign, at 1/2
                self.value, self.bits = value, bits
                self.load()
                value, bits = self.value, self.bits
            split = rng >> 1
            if (value >> bits) > split:
                rng -= split
                value -= (split + 1) << bits
                v = -v
            else:
                rng = split + 1
            s = _NORM[rng]
            rng, bits = (rng << s) - 1, bits - s
            idx.append(base + _ZIGZAG[n])
            val.append(v * (dq1 if n else dq0))
            n += 1
            p = bands[n][nxt]
        self.value, self.bits, self.rng = value, bits, rng
        return n


def _int16(a: np.ndarray) -> np.ndarray:
    """Wrap to int16, as libwebp stores coefficients."""
    return ((np.asarray(a, np.int64) + 32768) & 0xFFFF) - 32768


def _iwht(dc: np.ndarray) -> np.ndarray:
    """libwebp's TransformWHT on (N, 16) y2 blocks -> (N, 16) DC values, one
    a luma block in raster order."""
    i = dc.reshape(-1, 4, 4).astype(np.int64)
    a0, a1 = i[:, 0] + i[:, 3], i[:, 1] + i[:, 2]
    a2, a3 = i[:, 1] - i[:, 2], i[:, 0] - i[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1)    # (N, row, col)
    dcv = t[:, :, 0] + 3
    b0, b1 = dcv + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    b2, b3 = t[:, :, 1] - t[:, :, 2], dcv - t[:, :, 3]
    out = np.stack([(b0 + b1) >> 3, (b3 + b2) >> 3, (b0 - b1) >> 3, (b3 - b2) >> 3], axis=2)
    return _int16(out.reshape(-1, 16))


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(coefs: np.ndarray) -> np.ndarray:
    """libwebp's TransformOne on (N, 16) blocks -> (N, 4, 4) residuals (the
    value added to the prediction before clipping)."""
    c = coefs.reshape(-1, 4, 4).astype(np.int64)           # [n, row, col]
    a, b = c[:, 0] + c[:, 2], c[:, 0] - c[:, 2]            # vertical pass, by column
    cc = _mul2(c[:, 1]) - _mul1(c[:, 3])
    d = _mul1(c[:, 1]) + _mul2(c[:, 3])
    t = np.stack([a + d, b + cc, b - cc, a - d], axis=1)   # [n, row, col]
    dc = t[:, :, 0] + 4                                    # horizontal pass, by row
    a, b = dc + t[:, :, 2], dc - t[:, :, 2]
    cc = _mul2(t[:, :, 1]) - _mul1(t[:, :, 3])
    d = _mul1(t[:, :, 1]) + _mul2(t[:, :, 3])
    return np.stack([a + d, b + cc, b - cc, a - d], axis=2) >> 3


class _Header:
    """The frame header and the first partition's global fields."""

    def __init__(self, data: bytes):
        if len(data) < 10:
            raise VP8Error("VP8 frame too short")
        bits = data[0] | (data[1] << 8) | (data[2] << 16)
        if bits & 1:
            raise VP8Error("VP8 inter frame")
        if (bits >> 1) & 7 > 3:
            raise VP8Error("VP8 profile above 3")
        if not (bits >> 4) & 1:
            raise VP8Error("VP8 frame not shown")
        part0 = bits >> 5
        if data[3:6] != b"\x9d\x01\x2a":
            raise VP8Error("VP8 start code missing")
        self.w = (data[6] | (data[7] << 8)) & 0x3FFF
        self.h = (data[8] | (data[9] << 8)) & 0x3FFF
        if self.w == 0 or self.h == 0:
            raise VP8Error("VP8 frame of zero size")
        if part0 > len(data) - 10:
            raise VP8Error("VP8 first partition past the data")
        self.mbw, self.mbh = (self.w + 15) >> 4, (self.h + 15) >> 4
        br = self.br = _BoolReader(data, 10, 10 + part0)
        br.literal(2)                                     # colour space, clamping type
        # segments
        self.use_segment = br.literal(1)
        self.update_map = 0
        self.absolute = 0
        self.seg_q = [0] * 4
        self.seg_f = [0] * 4
        self.seg_proba = [255] * 3
        if self.use_segment:
            self.update_map = br.literal(1)
            if br.literal(1):
                self.absolute = br.literal(1)
                self.seg_q = [br.signed(7) if br.literal(1) else 0 for _ in range(4)]
                self.seg_f = [br.signed(6) if br.literal(1) else 0 for _ in range(4)]
            if self.update_map:
                self.seg_proba = [br.literal(8) if br.literal(1) else 255 for _ in range(3)]
        # loop filter
        self.simple = br.literal(1)
        self.level = br.literal(6)
        self.sharpness = br.literal(3)
        self.ref_delta = [0] * 4
        self.mode_delta = [0] * 4
        self.use_lf_delta = br.literal(1)
        if self.use_lf_delta and br.literal(1):
            for i in range(4):
                if br.literal(1):
                    self.ref_delta[i] = br.signed(6)
            for i in range(4):
                if br.literal(1):
                    self.mode_delta[i] = br.signed(6)
        self.filter_type = 0 if self.level == 0 else 1 if self.simple else 2
        # token partitions
        nparts = 1 << br.literal(2)
        start = 10 + part0
        sizes_end = start + 3 * (nparts - 1)
        if sizes_end > len(data):
            raise VP8Error("VP8 partition sizes past the data")
        self.parts = []
        at = sizes_end
        for p in range(nparts - 1):
            size = int.from_bytes(data[start + 3 * p:start + 3 * p + 3], "little")
            size = min(size, len(data) - at)
            self.parts.append(_BoolReader(data, at, at + size))
            at += size
        if at >= len(data):
            raise VP8Error("VP8 last partition empty")
        self.parts.append(_BoolReader(data, at, len(data)))
        # quantisers
        base_q = br.literal(7)
        dq = [br.signed(4) if br.literal(1) else 0 for _ in range(5)]
        self.quant = []
        for s in range(4):
            if self.use_segment:
                q = self.seg_q[s] + (0 if self.absolute else base_q)
            else:
                q = base_q
            y2_ac = int(_AC_Q[min(max(q + dq[2], 0), 127)]) * 101581 >> 16
            self.quant.append((int(_DC_Q[min(max(q + dq[0], 0), 127)]),
                               int(_AC_Q[min(max(q, 0), 127)]),
                               int(_DC_Q[min(max(q + dq[1], 0), 127)]) * 2, max(y2_ac, 8),
                               int(_DC_Q[min(max(q + dq[3], 0), 117)]),
                               int(_AC_Q[min(max(q + dq[4], 0), 127)])))
        br.literal(1)                                    # refresh entropy probs: ignored
        proba = np.frombuffer(_COEFF_PROBA0, np.uint8).reshape(4, 8, 3, 11).tolist()
        update = _COEFF_UPDATE
        k = 0
        for t in range(4):
            for b in range(8):
                for c in range(3):
                    for p in range(11):
                        if br.bit(update[k]):
                            proba[t][b][c][p] = br.literal(8)
                        k += 1
        # by position: bands[t][n][ctx] -> the 11 probabilities
        self.bands = [[proba[t][_BANDS[n]] for n in range(17)] for t in range(4)]
        self.use_skip = br.literal(1)
        self.skip_p = br.literal(8) if self.use_skip else 0


def _parse_modes(hd: _Header) -> tuple:
    """Every macroblock's segment, skip flag, i4x4 flag, luma modes (one
    16 x 16 mode or sixteen 4 x 4 ones) and chroma mode, from the first
    partition (libwebp's ParseIntraMode)."""
    br, mbw, mbh = hd.br, hd.mbw, hd.mbh
    bit = br.bit
    bm = np.frombuffer(_BMODE_PROBA, np.uint8).reshape(10, 10, 9).tolist()
    seg = np.zeros((mbh, mbw), np.int64)
    skip = np.zeros((mbh, mbw), bool)
    i4 = np.zeros((mbh, mbw), bool)
    ymode = np.zeros((mbh, mbw), np.int64)
    bmodes = np.zeros((mbh, mbw, 16), np.int64)
    uvmode = np.zeros((mbh, mbw), np.int64)
    top = [0] * (4 * mbw)
    sp = hd.seg_proba
    for y in range(mbh):
        left = [0] * 4
        for x in range(mbw):
            if hd.update_map:
                seg[y, x] = bit(sp[1]) if not bit(sp[0]) else 2 + bit(sp[2])
            if hd.use_skip:
                skip[y, x] = bit(hd.skip_p)
            if bit(145):
                m = (_TM_PRED if bit(128) else _H_PRED) if bit(156) else \
                    (_V_PRED if bit(163) else _DC_PRED)
                ymode[y, x] = m
                top[4 * x:4 * x + 4] = [m] * 4
                left = [m] * 4
            else:
                i4[y, x] = True
                modes = bmodes[y, x]
                for j in range(4):
                    lm = left[j]
                    for i in range(4):
                        prob = bm[top[4 * x + i]][lm]
                        t = _BMODE_TREE[bit(prob[0])]
                        while t > 0:
                            t = _BMODE_TREE[2 * t + bit(prob[t])]
                        lm = -t
                        top[4 * x + i] = lm
                        modes[4 * j + i] = lm
                    left[j] = lm
            uvmode[y, x] = (_DC_PRED if not bit(142) else _V_PRED if not bit(114)
                            else _TM_PRED if bit(183) else _H_PRED)
    return seg, skip, i4, ymode, bmodes, uvmode


def _residuals(hd: _Header, seg, skip, i4) -> tuple:
    """Every macroblock's coefficients (mbh, mbw, 25, 16) int16 (16 luma
    blocks, 4 U, 4 V, y2 last, its WHT already spread into the luma DCs)
    and whether it has any (libwebp's ParseResiduals and VP8DecodeMB)."""
    mbw, mbh = hd.mbw, hd.mbh
    b_i16, b_y2, b_uv, b_i4 = hd.bands
    coefs = np.zeros((mbh, mbw, 25, 16), np.int32)
    nz_any = np.zeros((mbh, mbw), bool)
    top_y, top_u, top_v = [0] * (4 * mbw), [0] * (2 * mbw), [0] * (2 * mbw)
    top_dc = [0] * mbw
    nparts = len(hd.parts)
    for y in range(mbh):
        br = hd.parts[y & (nparts - 1)]
        coeffs = br.coeffs
        left_y, left_u, left_v, left_dc = [0] * 4, [0] * 2, [0] * 2, 0
        idx, val = [], []
        blk_nz = np.zeros((mbw, 24), np.int64)
        for x in range(mbw):
            if skip[y, x]:
                top_y[4 * x:4 * x + 4] = [0] * 4
                top_u[2 * x:2 * x + 2] = [0] * 2
                top_v[2 * x:2 * x + 2] = [0] * 2
                left_y, left_u, left_v = [0] * 4, [0] * 2, [0] * 2
                if not i4[y, x]:
                    top_dc[x] = left_dc = 0
                continue
            q = hd.quant[seg[y, x]]
            base = x * 400
            if not i4[y, x]:
                nz = coeffs(b_y2, top_dc[x] + left_dc, q[2], q[3], 0, idx, val, base + 384)
                top_dc[x] = left_dc = int(nz > 0)
                first, bands = 1, b_i16
            else:
                first, bands = 0, b_i4
            nzs = blk_nz[x]
            for j in range(4):
                lft = left_y[j]
                for i in range(4):
                    nz = coeffs(bands, lft + top_y[4 * x + i], q[0], q[1], first, idx, val,
                                base + 64 * j + 16 * i)
                    lft = int(nz > first)
                    top_y[4 * x + i] = lft
                    nzs[4 * j + i] = nz
                left_y[j] = lft
            for ch, (tops, lefts) in enumerate(((top_u, left_u), (top_v, left_v))):
                for j in range(2):
                    lft = lefts[j]
                    for i in range(2):
                        nz = coeffs(b_uv, lft + tops[2 * x + i], q[4], q[5], 0, idx, val,
                                    base + 256 + 64 * ch + 32 * j + 16 * i)
                        lft = int(nz > 0)
                        tops[2 * x + i] = lft
                        nzs[16 + 4 * ch + 2 * j + i] = nz
                    lefts[j] = lft
        row = coefs[y].reshape(-1)
        if idx:
            row[np.asarray(idx, np.int64)] = _int16(np.asarray(val, np.int64))
        row16 = coefs[y]
        i16 = ~i4[y]
        if i16.any():
            row16[i16, :16, 0] = _iwht(row16[i16, 24])
        # libwebp's NzCodeBits: a block counts where its last position is past 1
        # or its DC (after the WHT) is nonzero
        nz_any[y] = ((blk_nz > 1) | (row16[:, :24, 0] != 0)).any(axis=1) & ~skip[y]
    return coefs, nz_any


def _filter_params(hd: _Header) -> np.ndarray:
    """(4 segments, 2 (i16, i4x4)) of (limit, interior limit, hev threshold),
    libwebp's PrecomputeFilterStrengths; limit 0 means no filtering."""
    out = np.zeros((4, 2, 3), np.int64)
    for s in range(4):
        base = hd.level
        if hd.use_segment:
            base = hd.seg_f[s] + (0 if hd.absolute else hd.level)
        for i4x4 in range(2):
            level = base
            if hd.use_lf_delta:
                level += hd.ref_delta[0] + (hd.mode_delta[0] if i4x4 else 0)
            level = min(max(level, 0), 63)
            if level == 0:
                continue
            ilevel = level
            if hd.sharpness > 0:
                ilevel >>= 2 if hd.sharpness > 4 else 1
                ilevel = min(ilevel, 9 - hd.sharpness)
            ilevel = max(ilevel, 1)
            hev = 2 if level >= 40 else 1 if level >= 15 else 0
            out[s, i4x4] = (2 * level + ilevel, ilevel, hev)
    return out


def _predict16(py: np.ndarray, y0: int, x0: int, mode: int, size: int, mbx: int,
               mby: int) -> np.ndarray:
    """A 16 x 16 luma or 8 x 8 chroma prediction at padded (y0, x0) from the
    row above and the column left of it (DC without top or left at the
    frame's edges, as libwebp's CheckMode picks it)."""
    top = py[y0 - 1, x0:x0 + size].astype(np.int64)
    left = py[y0:y0 + size, x0 - 1].astype(np.int64)
    if mode == _DC_PRED:
        shift = 5 if size == 16 else 4
        if mbx == 0 and mby == 0:
            v = 128
        elif mby == 0:
            v = (int(left.sum()) + (size >> 1)) >> (shift - 1)
        elif mbx == 0:
            v = (int(top.sum()) + (size >> 1)) >> (shift - 1)
        else:
            v = (int(top.sum() + left.sum()) + size) >> shift
        return np.full((size, size), v, np.int64)
    if mode == _TM_PRED:
        return np.clip(top[None, :] + left[:, None] - int(py[y0 - 1, x0 - 1]), 0, 255)
    if mode == _V_PRED:
        return np.broadcast_to(top, (size, size))
    return np.broadcast_to(left[:, None], (size, size))


def _reconstruct(hd: _Header, i4, ymode, bmodes, uvmode, coefs) -> tuple:
    """The unfiltered Y, U and V planes, padded: a row of 127 above and a
    column of 129 on the left (127 at the corner), as libwebp's work buffer
    holds them at the frame's edges."""
    mbw, mbh = hd.mbw, hd.mbh
    planes = []
    for size in (16, 8, 8):
        p = np.full((size * mbh + 1, size * mbw + 1), 129, np.uint8)
        p[0] = 127
        planes.append(p)
    py, pu, pv = planes
    for y in range(mbh):
        res = _idct(coefs[y, :, :24].reshape(-1, 16)).reshape(mbw, 24, 4, 4)
        for x in range(mbw):
            y0, x0 = 16 * y + 1, 16 * x + 1
            r = res[x]
            if i4[y, x]:
                # libwebp's work buffer: rows -1..15, columns -1..19; the
                # above-right pixels copied down beside rows 3, 7 and 11
                patch = np.empty((17, 21), np.int64)
                patch[:, :17] = py[y0 - 1:y0 + 16, x0 - 1:x0 + 16]
                if y == 0:
                    tr = np.full(4, 127, np.int64)
                elif x == mbw - 1:
                    tr = np.full(4, int(py[y0 - 1, x0 + 15]), np.int64)
                else:
                    tr = py[y0 - 1, x0 + 16:x0 + 20].astype(np.int64)
                patch[0, 17:] = tr
                patch[4, 17:] = patch[8, 17:] = patch[12, 17:] = tr
                modes = bmodes[y, x]
                for k in range(16):
                    j, i = k >> 2, k & 3
                    r0, c0 = 1 + 4 * j, 1 + 4 * i
                    edge = np.concatenate([patch[r0 + 3:r0 - 1:-1, c0 - 1],
                                           patch[r0 - 1, c0 - 1:c0 + 8]])
                    m = modes[k]
                    pred = np.clip((_W4[m] @ edge + _R4[m]) >> _S4[m], 0, 255)
                    patch[r0:r0 + 4, c0:c0 + 4] = np.clip(pred.reshape(4, 4) + r[k], 0, 255)
                py[y0:y0 + 16, x0:x0 + 16] = patch[1:, 1:17]
            else:
                pred = _predict16(py, y0, x0, int(ymode[y, x]), 16, x, y)
                add = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                py[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + add, 0, 255)
            for ch, pc in enumerate((pu, pv)):
                cy, cx = 8 * y + 1, 8 * x + 1
                pred = _predict16(pc, cy, cx, int(uvmode[y, x]), 8, x, y)
                add = r[16 + 4 * ch:20 + 4 * ch].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3)
                pc[cy:cy + 8, cx:cx + 8] = np.clip(pred + add.reshape(8, 8), 0, 255)
    return py[1:, 1:].copy(), pu[1:, 1:].copy(), pv[1:, 1:].copy()


def _filter_lines(px: np.ndarray, thresh, ithresh, hev_t, kind: str) -> np.ndarray:
    """libwebp's edge filters on (..., 8) lines p3 p2 p1 p0 q0 q1 q2 q3 across
    an edge (int64), thresholds broadcast against the lines: "simple"
    (NeedsFilter, DoFilter2), "mb" (FilterLoop26: DoFilter2 where the edge
    variance is high, else DoFilter6) or "inner" (FilterLoop24, DoFilter4)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (px[..., k] for k in range(8))
    t2 = 2 * thresh + 1
    edge = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    out = px.copy()
    if kind == "simple":
        a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        out[..., 3] = np.where(edge, np.clip(p0 + a2, 0, 255), p0)
        out[..., 4] = np.where(edge, np.clip(q0 - a1, 0, 255), q0)
        return out
    it = ithresh
    edge &= ((np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it) & (np.abs(p1 - p0) <= it)
             & (np.abs(q3 - q2) <= it) & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0) <= it))
    hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    # DoFilter2 where hev
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    f2 = edge & hev
    out[..., 3] = np.where(f2, np.clip(p0 + a2, 0, 255), out[..., 3])
    out[..., 4] = np.where(f2, np.clip(q0 - a1, 0, 255), out[..., 4])
    fo = edge & ~hev
    if kind == "mb":                      # DoFilter6
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        for k, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1), (5, q1 - a2),
                     (6, q2 - a3)):
            out[..., k] = np.where(fo, np.clip(v, 0, 255), out[..., k])
    else:                                 # DoFilter4
        a = 3 * (q0 - p0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        for k, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
            out[..., k] = np.where(fo, np.clip(v, 0, 255), out[..., k])
    return out


def _filter_edges(plane: np.ndarray, ys: np.ndarray, xs: np.ndarray, n: int, vertical: bool,
                  params: np.ndarray, kind: str) -> None:
    """Filter one edge of each listed block: (ys, xs) the first pixel past
    the edge, n lines along it; vertical edges filter along rows. `params`
    (K, 3) per block."""
    k = np.arange(n)
    off = np.arange(-4, 4)
    if vertical:
        rows = (ys[:, None] + k)[:, :, None]
        cols = (xs[:, None, None] + off)
        rows, cols = np.broadcast_arrays(rows, cols)
    else:
        cols = (xs[:, None] + k)[:, :, None]
        rows = (ys[:, None, None] + off)
        rows, cols = np.broadcast_arrays(rows, cols)
    px = plane[rows, cols].astype(np.int64)
    t, it, hv = (params[:, i][:, None] for i in range(3))
    plane[rows, cols] = _filter_lines(px, t, it, hv, kind)


def _loop_filter(hd: _Header, planes: tuple, seg, i4, nz_any) -> None:
    """libwebp's DoFilter for every macroblock, in waves of x + 2y (each wave's
    macroblocks touch disjoint pixels and follow all they depend on in
    raster order): left edge, inner vertical edges, top edge, inner
    horizontal edges; luma, and chroma with the normal filter."""
    if hd.filter_type == 0:
        return
    mbw, mbh = hd.mbw, hd.mbh
    fp = _filter_params(hd)
    par = fp[seg, i4.astype(np.int64)]                  # (mbh, mbw, 3)
    inner = i4 | nz_any
    py, pu, pv = planes
    simple = hd.filter_type == 1
    uv = np.stack([pu, pv]) if not simple else None
    for t in range(mbw + 2 * mbh - 2):
        my = np.arange(max(0, (t - mbw + 2) // 2), min(mbh - 1, t // 2) + 1)
        mx = t - 2 * my
        keep = (mx >= 0) & (mx < mbw)
        my, mx = my[keep], mx[keep]
        pr = par[my, mx]
        on = pr[:, 0] > 0
        my, mx, pr = my[on], mx[on], pr[on]
        if len(my) == 0:
            continue
        inn = inner[my, mx]
        mb = pr.copy()
        mb[:, 0] += 4
        for vertical in (True, False):
            edge_on = (mx > 0) if vertical else (my > 0)
            ys, xs = 16 * my, 16 * mx
            if simple:
                _filter_edges(py, ys[edge_on], xs[edge_on], 16, vertical, mb[edge_on], "simple")
                for e in (4, 8, 12):
                    _filter_edges(py, ys[inn] + (0 if vertical else e),
                                  xs[inn] + (e if vertical else 0), 16, vertical, pr[inn],
                                  "simple")
                continue
            _filter_edges(py, ys[edge_on], xs[edge_on], 16, vertical, mb[edge_on], "mb")
            for plane in uv:
                _filter_edges(plane, 8 * my[edge_on], 8 * mx[edge_on], 8, vertical,
                              mb[edge_on], "mb")
            for e in (4, 8, 12):
                _filter_edges(py, ys[inn] + (0 if vertical else e),
                              xs[inn] + (e if vertical else 0), 16, vertical, pr[inn], "inner")
            for plane in uv:
                _filter_edges(plane, 8 * my[inn] + (0 if vertical else 4),
                              8 * mx[inn] + (4 if vertical else 0), 8, vertical, pr[inn],
                              "inner")
    if uv is not None:
        pu[...], pv[...] = uv


def vp8_decode(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A VP8 key frame (a `VP8 ` chunk's payload) -> its (h, w) Y and
    ((h + 1) // 2, (w + 1) // 2) U and V planes, uint8, as libwebp decodes
    them."""
    hd = _Header(data)
    seg, skip, i4, ymode, bmodes, uvmode = _parse_modes(hd)
    coefs, nz_any = _residuals(hd, seg, skip, i4)
    planes = _reconstruct(hd, i4, ymode, bmodes, uvmode, coefs)
    _loop_filter(hd, planes, seg, i4, nz_any)
    py, pu, pv = planes
    h, w = hd.h, hd.w
    return py[:h, :w], pu[:(h + 1) // 2, :(w + 1) // 2], pv[:(h + 1) // 2, :(w + 1) // 2]


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler (UpsampleRgbLinePair under EmitFancyRGB) of
    one (uvh, uvw) chroma plane to (h, w)."""
    c = c.astype(np.int64)
    uvh = c.shape[0]
    r = np.arange(h)
    near = c[r // 2]
    far = c[np.clip(np.where(r % 2 == 1, r // 2 + 1, r // 2 - 1), 0, uvh - 1)]
    out = np.empty((h, w), np.int64)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    pairs = (w - 1) >> 1
    if pairs:
        n0, n1, f0, f1 = near[:, :pairs], near[:, 1:pairs + 1], far[:, :pairs], far[:, 1:pairs + 1]
        avg = n0 + n1 + f0 + f1 + 8
        out[:, 1:2 * pairs:2] = (((avg + 2 * (n1 + f0)) >> 3) + n0) >> 1
        out[:, 2:2 * pairs + 1:2] = (((avg + 2 * (n0 + f1)) >> 3) + n1) >> 1
    if w % 2 == 0:
        out[:, w - 1] = (3 * near[:, -1] + far[:, -1] + 2) >> 2
    return out


def _clip8(v: np.ndarray) -> np.ndarray:
    """libwebp's VP8Clip8 on 14-bit fixed point."""
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> tuple:
    """libwebp's WebPDecodeBGR colour: the fancy-upsampled chroma and
    VP8YUVToR/G/B -> (R, G, B) int64 planes."""
    h, w = y.shape
    uu, vv = _upsample(u, h, w), _upsample(v, h, w)
    yy = (y.astype(np.int64) * 19077) >> 8
    r = _clip8(yy + ((vv * 26149) >> 8) - 14234)
    g = _clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = _clip8(yy + ((uu * 33050) >> 8) - 17685)
    return r, g, b


def vp8_gray(data: bytes) -> np.ndarray:
    """A VP8 key frame as cv2 reads it in gray: libwebp's BGR decode, then
    cvtColor's (9798 R + 19235 G + 3735 B + 16384) >> 15. (h, w) uint8."""
    r, g, b = yuv_to_rgb(*vp8_decode(data))
    return ((9798 * r + 19235 * g + 3735 * b + 16384) >> 15).astype(np.uint8)
