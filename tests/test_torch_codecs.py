"""Port parity: the DICOM codecs (`data/codecs.py`, `jls.py`, `jpg.py`,
`j2k.py`, `htj2k.py`, `native_loader.py`, `dicom.py`) against the JAX
package's, on the cases of tests/test_{dicom_codecs,jpg,jls,j2k,j2k_tier1,
htj2k,native_loader}.py.

Every stream comes from an independent encoder: the JAX package's own
(`codecs.rle_encode`, `jpeg_lossless_encode`, `jls.jls_encode`,
`htj2k.ht_encode_lossless`, `dcmwrite_minimal` at every encapsulated
syntax, which reaches cv2's OpenJPEG and libjpeg for J2K and JPEG
baseline), cv2, or the JAX tests' hand-built streams. Tolerance: none.
Both packages decode to the same bits, lossless streams to the source
image, the port's encoders write the JAX encoders' bytes, native and
Python decodes are identical, and a corrupt stream fails in the port
where it fails in JAX, always as the package's own error class.
"""

import random
import struct

import cv2
import numpy as np
import pytest

from cadx_tpu.data import codecs as JC
from cadx_tpu.data import dicom as JD
from cadx_tpu.data import htj2k as JH
from cadx_tpu.data import j2k as JJ
from cadx_tpu.data import jls as JL
from cadx_tpu.data import jpg as JP
from cadx_tpu.data import native_loader as JN
from cadx_tpu_torch.data import codecs as TC
from cadx_tpu_torch.data import dicom as TD
from cadx_tpu_torch.data import htj2k as TH
from cadx_tpu_torch.data import j2k as TJ
from cadx_tpu_torch.data import jls as TL
from cadx_tpu_torch.data import jpg as TP
from cadx_tpu_torch.data import native_loader as TN
from test_j2k import LOSSLESS_CASES, _split_passes_stream, _two_layer_stream
from test_j2k_tier1 import _STYLES, _encode_block, _rand_block
from test_jls import _cases as jls_cases
from test_jpg import _minimal_sof1_12bit, _natural


def _mammo16(rng, hw=(96, 80)):
    """test_dicom_codecs.py's mammo16: dark background, textured tissue,
    a bright wedge."""
    img = np.zeros(hw, np.uint16)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    breast = ((xx - hw[1]) ** 2 + (yy - hw[0] // 2) ** 2) < (hw[0] // 2) ** 2
    tissue = rng.normal(1800, 350, hw).clip(0, 4095).astype(np.uint16)
    img[breast] = tissue[breast]
    img[(xx + yy) > (hw[0] + hw[1] - 20)] = 3800
    return img


def _outcome(fn, *args, **kwargs):
    """('ok', result) or ('raise', error class name)."""
    try:
        return "ok", fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — the outcome is the assertion target
        return "raise", type(e).__name__


def _same_outcome(a, b):
    assert a[0] == b[0], (a, b)
    if a[0] == "raise":
        assert a[1] == b[1]
        return
    ra, rb = (a[1] if isinstance(a[1], tuple) else (a[1],)), (
        b[1] if isinstance(b[1], tuple) else (b[1],))
    for x, y in zip(ra, rb):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


_IMAGES = [(name, img) for name, img in jls_cases(np.random.default_rng(1234))] + [
    ("mammo16", _mammo16(np.random.default_rng(0))),
    ("mammo8", (_mammo16(np.random.default_rng(1)) >> 4).astype(np.uint8))]


@pytest.mark.parametrize("name,img", _IMAGES, ids=[n for n, _ in _IMAGES])
def test_encoders_write_the_jax_bytes_and_both_decode_them(name, img):
    prec = 8 if img.dtype == np.uint8 else 16
    rle = JC.rle_encode(img)
    assert TC.rle_encode(img) == rle
    _same_outcome(_outcome(TC.rle_decode, rle, *img.shape, prec),
                  _outcome(JC.rle_decode, rle, *img.shape, prec))
    np.testing.assert_array_equal(TC.rle_decode(rle, *img.shape, prec), img)
    jl = JC.jpeg_lossless_encode(img, precision=prec)
    assert TC.jpeg_lossless_encode(img, precision=prec) == jl
    _same_outcome(_outcome(TC.jpeg_lossless_decode, jl), _outcome(JC.jpeg_lossless_decode, jl))
    np.testing.assert_array_equal(TC.jpeg_lossless_decode(jl)[0], img)
    for near in (0, 2):
        ls = JL.jls_encode(img, near=near, precision=prec)
        assert TL.jls_encode(img, near=near, precision=prec) == ls
        _same_outcome(_outcome(TL.jls_decode, ls), _outcome(JL.jls_decode, ls))
    ht = JH.ht_encode_lossless(img, prec)
    assert TH.ht_encode_lossless(img, prec) == ht
    out = TJ.j2k_decode(ht, expect_hw=img.shape)
    np.testing.assert_array_equal(out, JJ.j2k_decode(ht, expect_hw=img.shape))
    np.testing.assert_array_equal(out.astype(np.int64), img)


_SYNTAXES = sorted(JD._ENCAPSULATED_TS - {JD.TS_JPEG_EXTENDED}) + [
    JD.TS_EXPLICIT_LE, JD.TS_DEFLATED_LE, JD.TS_EXPLICIT_BE]


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("ts", _SYNTAXES)
def test_dcmwrite_every_syntax_decodes_bit_exact_in_both(tmp_path, ts, frames):
    rng = np.random.default_rng(7)
    img = _mammo16(rng, (40, 36))
    if ts == JD.TS_JPEG_BASELINE:
        img = (img >> 4).astype(np.uint8)
    if frames > 1:
        img = np.stack([img, img[::-1], img[:, ::-1]])
    path = str(tmp_path / "j.dcm")
    JD.dcmwrite_minimal(path, img, "PX", transfer_syntax=ts)
    want = JD.dcmread(path).pixel_array
    got = TD.dcmread(path)
    assert got.transfer_syntax == ts and got.PatientID == "PX"
    assert got.pixel_array.dtype == want.dtype
    np.testing.assert_array_equal(got.pixel_array, want)
    np.testing.assert_array_equal(TD.primary_frame(got), JD.primary_frame(JD.dcmread(path)))
    if ts not in (JD.TS_JPEG_BASELINE, JD.TS_J2K, JD.TS_JPEG_LS_NEAR):
        np.testing.assert_array_equal(want, img)   # lossless syntaxes
    if ts in (JD.TS_J2K_LOSSLESS, JD.TS_J2K, JD.TS_JPEG_BASELINE):
        with pytest.raises(TD.DicomError, match="no encoder"):
            TD.dcmwrite_minimal(str(tmp_path / "t.dcm"), img, "PX", transfer_syntax=ts)
        return
    TD.dcmwrite_minimal(str(tmp_path / "t.dcm"), img, "PX", transfer_syntax=ts)
    assert open(str(tmp_path / "t.dcm"), "rb").read() == open(path, "rb").read()


def test_dcmwrite_jpeg_extended_raises(tmp_path):
    img = _mammo16(np.random.default_rng(0))
    with pytest.raises(TD.DicomError, match="extended"):
        TD.dcmwrite_minimal(str(tmp_path / "x.dcm"), img, transfer_syntax=TD.TS_JPEG_EXTENDED)


def _without_native(monkeypatch):
    for fn in ("decode_rle", "decode_jpeg_lossless", "decode_jls"):
        monkeypatch.setattr(TN, fn, lambda *a, **k: None)
    monkeypatch.setattr(TJ, "_NATIVE_J2K", False)


@pytest.mark.parametrize("ts", [JD.TS_RLE, JD.TS_JPEG_LOSSLESS_SV1, JD.TS_JPEG_LOSSLESS_P14,
                                JD.TS_JPEG_LS, JD.TS_JPEG_LS_NEAR, JD.TS_J2K_LOSSLESS,
                                JD.TS_HTJ2K_LOSSLESS])
def test_native_and_python_decodes_are_identical(tmp_path, monkeypatch, ts):
    assert TN.available()
    img = _mammo16(np.random.default_rng(3))
    path = str(tmp_path / "n.dcm")
    JD.dcmwrite_minimal(path, img, transfer_syntax=ts)
    codec = {JD.TS_RLE: "rle", JD.TS_JPEG_LS: "jpeg_ls", JD.TS_JPEG_LS_NEAR: "jpeg_ls",
             JD.TS_J2K_LOSSLESS: "j2k", JD.TS_HTJ2K_LOSSLESS: "j2k"}.get(ts, "jpeg_lossless")
    before = dict(TD.DECODER_RUNS)
    native = TD.dcmread(path).pixel_array
    runs = {k: v - before.get(k, 0) for k, v in TD.DECODER_RUNS.items()}
    assert runs.get((codec, "native" if codec != "j2k" else "python")) == 1
    _without_native(monkeypatch)
    python = TD.dcmread(path).pixel_array
    assert TD.DECODER_RUNS[(codec, "python")] >= 1
    np.testing.assert_array_equal(native, python)
    np.testing.assert_array_equal(python, JD.dcmread(path).pixel_array)


def test_without_a_toolchain_the_python_codecs_decode(tmp_path, monkeypatch):
    """No g++: importing and reading still work, through the Python codecs,
    and the failed build is not retried a frame."""
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_lib_error", None)
    monkeypatch.setattr(TN, "_LIB_PATH", str(tmp_path / "libcadx_io.so"))
    monkeypatch.setattr(TN.subprocess, "run", no_compiler)
    assert not TN.available()
    img = _mammo16(np.random.default_rng(4))
    frames = np.stack([img, img[::-1]])
    path = str(tmp_path / "rle.dcm")
    JD.dcmwrite_minimal(path, frames, transfer_syntax=JD.TS_RLE)
    before = TD.DECODER_RUNS[("rle", "python")]
    np.testing.assert_array_equal(TD.dcmread(path).pixel_array, frames)
    assert TD.DECODER_RUNS[("rle", "python")] == before + 2
    assert isinstance(TN._lib_error, TN.NativeUnavailable)


@pytest.mark.parametrize("name,img", _IMAGES[:8], ids=[n for n, _ in _IMAGES[:8]])
def test_native_jls_and_rle_match_python(name, img):
    prec = 8 if img.dtype == np.uint8 else 16
    for near in (0, 2):
        enc = JL.jls_encode(img, near=near, precision=prec)
        np.testing.assert_array_equal(TN.decode_jls(enc, *img.shape), TL.jls_decode(enc)[0])
    np.testing.assert_array_equal(TN.decode_rle(JC.rle_encode(img), *img.shape, prec), img)
    enc = JL.jls_encode(img, precision=prec)
    _same_outcome(_outcome(TN.decode_jls, enc[:30], *img.shape),
                  _outcome(JN.decode_jls, enc[:30], *img.shape))
    assert TN.decode_jls(b"\x12\x34" * 40, *img.shape) is None


@pytest.mark.parametrize("style", sorted(_STYLES))
def test_j2k_tier1_blocks_native_python_and_jax(monkeypatch, style):
    """test_j2k_tier1.py's EBCOT blocks (every code-block style) through
    the port's tier-1, native and Python, and JAX's."""
    rng = np.random.default_rng(1234)
    for h, w in ((17, 13), (4, 64), (5, 5)):
        coefs = _rand_block(rng, h, w)
        for kind in ("LL", "HL", "HH"):
            segments, bp_start, n_passes = _encode_block(coefs, kind, _STYLES[style])
            outs = []
            for mod, native in ((TJ, True), (TJ, False), (JJ, False)):
                monkeypatch.setattr(mod, "_NATIVE_J2K", native)
                cb = mod._CodeBlock(0, 0, w, h)
                cb.included, cb.zbp, cb.passes_total = True, 0, n_passes
                cb.data_parts = segments
                cb.nb_seg_passes = [(len(d), n) for d, n in segments]
                outs.append(mod._decode_block(cb, kind, bp_start + 1, _STYLES[style]))
            for out in outs:
                np.testing.assert_array_equal(out, coefs)


def test_native_idwt_matches_numpy(monkeypatch):
    rng = np.random.default_rng(5)
    for n_low, n_high, other, parity in ((8, 8, 13, 0), (9, 8, 5, 0), (8, 9, 7, 1),
                                         (1, 2, 3, 1), (50, 50, 33, 1)):
        for axis in (0, 1):
            low = rng.integers(-9999, 9999, (n_low, other) if axis == 0 else (other, n_low))
            high = rng.integers(-9999, 9999, (n_high, other) if axis == 0 else (other, n_high))
            got = TN.idwt53_1d(low, high, parity, axis)
            monkeypatch.setattr(JJ, "_NATIVE_J2K", False)
            np.testing.assert_array_equal(got, JJ._idwt53_1d(low.astype(np.int64),
                                                            high.astype(np.int64), parity, axis))


@pytest.mark.parametrize("name,make", LOSSLESS_CASES, ids=[c[0] for c in LOSSLESS_CASES])
def test_j2k_openjpeg_streams(name, make):
    """test_j2k.py's OpenJPEG (cv2) lossless streams, and a lossy 9/7 one."""
    img = make(np.random.default_rng(1234))
    for q in (1000, 50):
        ok, buf = cv2.imencode(".jp2", img, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, q])
        assert ok
        out = TJ.j2k_decode(bytes(buf))
        np.testing.assert_array_equal(out, JJ.j2k_decode(bytes(buf)))
        if q == 1000:
            np.testing.assert_array_equal(out, img)


def test_j2k_hand_built_layer_streams():
    for stream in (_two_layer_stream(0), _two_layer_stream(1), _split_passes_stream()):
        _same_outcome(_outcome(TJ.j2k_decode, stream), _outcome(JJ.j2k_decode, stream))


@pytest.mark.parametrize("q,rst", [(95, 0), (80, 0), (50, 2), (20, 1)])
def test_jpeg_baseline_from_libjpeg(q, rst):
    """test_jpg.py's cv2 streams: the port's float IDCT is JAX's, bit for bit."""
    img = _natural(np.random.default_rng(0))[:101, :67]
    flags = [cv2.IMWRITE_JPEG_QUALITY, q] + ([cv2.IMWRITE_JPEG_RST_INTERVAL, rst] if rst else [])
    data = cv2.imencode(".jpg", img, flags)[1].tobytes()
    _same_outcome(_outcome(TP.jpeg_lossy_decode, data), _outcome(JP.jpeg_lossy_decode, data))
    np.testing.assert_array_equal(TP.jpeg_luma_decode(data)[0], TP.jpeg_lossy_decode(data)[0])
    colour = cv2.imencode(".jpg", np.dstack([img, img[::-1], img[:, ::-1]]))[1].tobytes()
    _same_outcome(_outcome(TP.jpeg_lossy_decode, colour), _outcome(JP.jpeg_lossy_decode, colour))


def test_jpeg_extended_12bit_sof1():
    rng = np.random.default_rng(3)
    stream = _minimal_sof1_12bit(list(rng.integers(-300, 300, 12)), 4, 3)
    _same_outcome(_outcome(TP.jpeg_lossy_decode, stream), _outcome(JP.jpeg_lossy_decode, stream))
    assert TP.jpeg_lossy_decode(stream)[0].dtype == np.uint16


def test_htj2k_codestreams_and_malformed_segments():
    rng = np.random.default_rng(0x47)
    for h, w, d in [(61, 47, 12), (130, 200, 16), (64, 64, 8), (1, 1, 12), (65, 3, 10)]:
        img = rng.integers(0, 1 << d, (h, w)).astype(np.uint8 if d <= 8 else np.uint16)
        st = JH.ht_encode_lossless(img, d)
        np.testing.assert_array_equal(TJ.j2k_decode(st, expect_hw=(h, w)).astype(np.int64), img)
    seg = JH.ht_encode_cleanup(np.full((4, 4), 900, np.int64))
    for args, kw in (([b"\x00"], {"mb": 11, "zbp": 10}), ([b"\x00\x00\xff\xff"],
                                                       {"mb": 11, "zbp": 10}),
                     ([seg], {"mb": 3, "zbp": 2}), ([seg], {"mb": 11, "zbp": 10})):
        _same_outcome(_outcome(TH.ht_decode_block, args, 4, 4, n_passes=1, **kw),
                      _outcome(JH.ht_decode_block, args, 4, 4, n_passes=1, **kw))


def test_frame_split_and_encapsulation():
    """test_dicom_codecs.py's Basic Offset Table grouping and its refusals."""
    img = _mammo16(np.random.default_rng(0))
    f0, f1 = JC.rle_encode(img), JC.rle_encode(img[::-1])
    frag_a, frag_b = f0[:len(f0) // 2 * 2], f0[len(f0) // 2 * 2:]

    def item(b):
        b += b"\x00" * (len(b) % 2)
        return struct.pack("<HHI", 0xFFFE, 0xE000, len(b)) + b

    items = [item(frag_a), item(frag_b), item(f1)]
    bot = struct.pack("<2I", 0, len(items[0]) + len(items[1]))
    raw = (struct.pack("<HHI", 0xFFFE, 0xE000, len(bot)) + bot + b"".join(items)
           + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    for n in (2, 3):
        _same_outcome(_outcome(TC.split_frames, raw, n), _outcome(JC.split_frames, raw, n))
    assert TC.encapsulate([frag_a, f1], bot=True) == JC.encapsulate([frag_a, f1], bot=True)
    nobot = JC.encapsulate([frag_a, frag_b, f1])
    _same_outcome(_outcome(TC.split_frames, nobot, 2), _outcome(JC.split_frames, nobot, 2))


def _seeds(tmp_path):
    img = _mammo16(np.random.default_rng(0))
    seeds = []
    for i, ts in enumerate([JD.TS_RLE, JD.TS_JPEG_LOSSLESS_SV1, JD.TS_JPEG_LS,
                            JD.TS_JPEG_LS_NEAR, JD.TS_J2K_LOSSLESS, JD.TS_HTJ2K_LOSSLESS,
                            JD.TS_JPEG_BASELINE]):
        p = str(tmp_path / f"seed_{i}.dcm")
        JD.dcmwrite_minimal(p, img if ts != JD.TS_JPEG_BASELINE else (img >> 8).astype(np.uint8),
                            transfer_syntax=ts)
        seeds.append(open(p, "rb").read())
    return seeds


def _mutate(b: bytes, rnd: random.Random) -> bytes:
    """test_dicom_codecs.py's mutations: bit flips, truncation, a 4-byte
    splice, an 8-byte flood."""
    b = bytearray(b)
    op = rnd.randrange(4)
    if op == 0:
        for _ in range(rnd.randrange(1, 8)):
            i = rnd.randrange(len(b))
            b[i] ^= 1 << rnd.randrange(8)
    elif op == 1:
        del b[rnd.randrange(1, len(b)):]
    elif op == 2:
        i = rnd.randrange(len(b) - 4)
        b[i:i + 4] = bytes(rnd.randrange(256) for _ in range(4))
    else:
        i = rnd.randrange(len(b))
        b[i:i + 8] = bytes([rnd.choice([0xFF, 0x00, 0x80])] * 8)
    return bytes(b)


@pytest.mark.parametrize("part", range(3))
def test_mutated_files_fail_where_jax_fails_and_only_with_dicomerror(tmp_path, part):
    rnd = random.Random(42 + part)
    seeds = _seeds(tmp_path)
    for n in range(50):
        blob = _mutate(seeds[n % len(seeds)], rnd)
        got = _outcome(lambda: TD.dcmread(blob).pixel_array)
        want = _outcome(lambda: JD.dcmread(blob).pixel_array)
        assert got[0] != "raise" or got[1] == "DicomError", got
        _same_outcome(got, want)


def test_hostile_geometry_and_expect_hw_fail_fast(tmp_path):
    img = _mammo16(np.random.default_rng(0))
    p = str(tmp_path / "rle.dcm")
    JD.dcmwrite_minimal(p, img, transfer_syntax=JD.TS_RLE)
    blob = bytearray(open(p, "rb").read())
    for elem in (b"\x28\x00\x10\x00US", b"\x28\x00\x11\x00US"):
        at = blob.index(elem)
        blob[at + 8:at + 10] = b"\xff\xff"
    with pytest.raises(TD.DicomError, match="implausible"):
        TD.dcmread(bytes(blob)).pixel_array
    small = (img[:16, :16] >> 8).astype(np.uint8)
    with pytest.raises(TL.JlsError, match="expected"):
        TL.jls_decode(JL.jls_encode(small), expect_hw=(8, 8))
    with pytest.raises(TC.CodecError, match="expected"):
        TC.jpeg_lossless_decode(JC.jpeg_lossless_encode(small), expect_hw=(8, 8))
    with pytest.raises(TP.JpegError, match="expected"):
        TP.jpeg_lossy_decode(cv2.imencode(".jpg", small)[1].tobytes(), expect_hw=(8, 8))


def test_native_loader_reads_and_batches_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    paths, labels = [], []
    for i in range(6):
        img = rng.integers(0, 4096, (40 + i, 32), dtype=np.uint16)
        p = str(tmp_path / f"f{i}.dcm")
        ts = (JD.TS_EXPLICIT_LE, JD.TS_J2K_LOSSLESS, JD.TS_JPEG_LOSSLESS_SV1)[i % 3]
        JD.dcmwrite_minimal(p, img, patient_id=f"P{i}", transfer_syntax=ts)
        paths.append(p)
        labels.append(i)
        if ts == JD.TS_EXPLICIT_LE:
            np.testing.assert_array_equal(TN.read_dicom_pixels(p), JN.read_dicom_pixels(p))
    open(str(tmp_path / "bad.dcm"), "wb").write(b"\x00" * 200)
    paths.append(str(tmp_path / "bad.dcm"))
    labels.append(99)

    def epoch(mod):
        """{label: plane} of the loaded items (batches arrive in the order
        the workers finish them)."""
        loader = mod.NativeBatchLoader(paths, labels, batch_size=3, out_hw=(16, 16), n_workers=2)
        out = {int(lab): plane.copy() for data, labs, ok in loader
               for plane, lab, good in zip(data, labs, ok) if good}
        loader.close()
        return out

    got, want = epoch(TN), epoch(JN)
    assert sorted(got) == sorted(want) == list(range(6))   # J2K rescued, corrupt skipped
    for lab in got:
        np.testing.assert_array_equal(got[lab], want[lab])
    assert TN._LIB_PATH != JN._LIB_PATH and "cadx_tpu_torch" in TN._LIB_PATH
