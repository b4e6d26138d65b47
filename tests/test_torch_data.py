"""Port parity: the DICOM reader and the dataset helpers
(`cadx_tpu_torch/data/`) against the JAX package's `cadx_tpu/data/`.

Files written by either writer read the same through both readers, in
each uncompressed transfer syntax and in the encapsulated ones (the
codecs' own parity is in test_torch_codecs.py).
"""

import csv
import struct

import numpy as np
import pytest

from cadx_tpu.data import dataset as JD
from cadx_tpu.data import dicom as JDicom
from cadx_tpu_torch.data import dataset as TD
from cadx_tpu_torch.data import dicom as TDicom


@pytest.fixture
def mammo16(rng):
    """A 16-bit mammogram-like image (tests/test_dicom_codecs.py's)."""
    hw = (96, 80)
    img = np.zeros(hw, np.uint16)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    breast = ((xx - hw[1]) ** 2 + (yy - hw[0] // 2) ** 2) < (hw[0] // 2) ** 2
    img[breast] = rng.normal(1800, 350, hw).clip(0, 4095).astype(np.uint16)[breast]
    img[(xx + yy) > (hw[0] + hw[1] - 20)] = 3800
    return img


def _same(path):
    a, b = JDicom.dcmread(path), TDicom.dcmread(path)
    assert a.transfer_syntax == b.transfer_syntax and a.PatientID == b.PatientID
    pa, pb = a.pixel_array, b.pixel_array
    assert pa.dtype == pb.dtype
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(JDicom.primary_frame(a), TDicom.primary_frame(b))
    return pb


@pytest.mark.parametrize("ts", [JDicom.TS_EXPLICIT_LE, JDicom.TS_DEFLATED_LE,
                                JDicom.TS_EXPLICIT_BE])
@pytest.mark.parametrize("frames", [1, 3])
def test_writers_cross_read(tmp_path, mammo16, ts, frames):
    arr = mammo16 if frames == 1 else np.stack([mammo16, mammo16[::-1], mammo16 // 2])
    for writer, name in ((JDicom.dcmwrite_minimal, "jax"), (TDicom.dcmwrite_minimal, "port")):
        p = str(tmp_path / f"{name}.dcm")
        writer(p, arr, "P7.dcm", transfer_syntax=ts)
        np.testing.assert_array_equal(_same(p), arr)
    with open(tmp_path / "jax.dcm", "rb") as a, open(tmp_path / "port.dcm", "rb") as b:
        assert a.read() == b.read()


def _elem(tag, value: bytes) -> bytes:
    """An implicit-VR little-endian element."""
    if len(value) % 2:
        value += b"\x00"
    return struct.pack("<HHI", *tag, len(value)) + value


def _implicit_file(path, pixels: bytes, rows, cols, bits, samples):
    ts = JDicom.TS_IMPLICIT_LE.encode() + b"\x00"
    meta = struct.pack("<HH", 2, 0x10) + b"UI" + struct.pack("<H", len(ts)) + ts
    meta = struct.pack("<HH", 2, 0) + b"UL" + struct.pack("<HI", 4, len(meta)) + meta
    us = lambda v: struct.pack("<H", v)  # noqa: E731
    body = (_elem((0x0010, 0x0020), b"PX")
            + _elem((0x0028, 0x0002), us(samples)) + _elem((0x0028, 0x0010), us(rows))
            + _elem((0x0028, 0x0011), us(cols)) + _elem((0x0028, 0x0100), us(bits))
            + _elem((0x0028, 0x0103), us(0)) + _elem((0x7FE0, 0x0010), pixels))
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def test_implicit_le_and_rgb(tmp_path, mammo16, rng):
    p = str(tmp_path / "implicit.dcm")
    _implicit_file(p, mammo16.astype("<u2").tobytes(), *mammo16.shape, 16, 1)
    np.testing.assert_array_equal(_same(p), mammo16)
    rgb = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    p = str(tmp_path / "rgb.dcm")
    _implicit_file(p, rgb.tobytes(), 20, 30, 8, 3)
    np.testing.assert_array_equal(_same(p), rgb)
    gray = TDicom.primary_frame(TDicom.dcmread(p))
    assert gray.shape == (20, 30) and gray.dtype == np.uint8


def test_encapsulated_and_bad_files_raise(tmp_path, mammo16):
    p = str(tmp_path / "rle.dcm")
    JDicom.dcmwrite_minimal(p, mammo16, "P1", transfer_syntax=JDicom.TS_RLE)
    ds = TDicom.dcmread(p)
    assert ds.transfer_syntax == TDicom.TS_RLE and ds.PatientID == "P1"
    np.testing.assert_array_equal(ds.pixel_array, JDicom.dcmread(p).pixel_array)
    TDicom.dcmwrite_minimal(str(tmp_path / "x.dcm"), mammo16, "P1",
                            transfer_syntax=TDicom.TS_RLE)
    assert open(tmp_path / "x.dcm", "rb").read() == open(p, "rb").read()
    with pytest.raises(TDicom.DicomError, match="no encoder"):
        TDicom.dcmwrite_minimal(str(tmp_path / "x.dcm"), mammo16,
                                transfer_syntax=TDicom.TS_J2K_LOSSLESS)
    with pytest.raises(TDicom.DicomError, match="DICM"):
        TDicom.dcmread(b"\x00" * 200)
    # the pixel-data length check
    TDicom.dcmwrite_minimal(str(tmp_path / "raw.dcm"), mammo16)
    with open(tmp_path / "raw.dcm", "rb") as f:
        raw = f.read()
    with pytest.raises(TDicom.DicomError, match="too short"):
        TDicom.dcmread(raw[:-100]).pixel_array


def test_compressed_geometry_bound():
    with pytest.raises(TDicom.DicomError, match="implausible"):
        TDicom._check_compressed_geometry(1 << 15, 1 << 14, 1)
    with pytest.raises(TDicom.DicomError, match="implausible"):
        TDicom._check_compressed_geometry(100, 100, 5000)
    TDicom._check_compressed_geometry(2457, 1890, 130)


def test_load_mapping_csv_matches_jax(tmp_path, mammo16):
    rows = []
    for i in range(5):
        p = str(tmp_path / f"c{i}.dcm")
        TDicom.dcmwrite_minimal(p, (mammo16 // (i + 1)).astype(np.uint16), f"P{i}.dcm")
        rows.append((p, "MALIGNANT" if i % 2 else "BENIGN"))
    rows.insert(2, (str(tmp_path / "missing.dcm"), "BENIGN"))
    rle = str(tmp_path / "rle.dcm")
    JDicom.dcmwrite_minimal(rle, mammo16, "PR", transfer_syntax=JDicom.TS_RLE)
    cp = str(tmp_path / "map.csv")
    with open(cp, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dicom_file_path", "pathology"])
        w.writerows(rows)
    logs = []
    ours = TD.load_mapping_csv(cp, log=logs.append)
    ref = JD.load_mapping_csv(cp, log=lambda s: None)
    assert len(ours) == len(ref) == 5 and any("missing.dcm" in m for m in logs)
    assert ours.raw_classes == ref.raw_classes and ours.label_encoder == ref.label_encoder
    assert [r["PatientID"] for r in ours.records] == [r["PatientID"] for r in ref.records]
    for a, b in zip(ours.raw_images, ref.raw_images):
        np.testing.assert_array_equal(a, b)
    # an encapsulated file decodes, as it does in JAX, and the records
    # stay aligned
    with open(cp, "a", newline="") as f:
        csv.writer(f).writerow([rle, "BENIGN"])
    ours = TD.load_mapping_csv(cp, log=logs.append)
    ref = JD.load_mapping_csv(cp, log=lambda s: None)
    assert len(ours) == len(ours.records) == len(ref) == 6
    np.testing.assert_array_equal(ours.raw_images[-1], ref.raw_images[-1])


def test_split_and_helpers_match_jax(rng):
    x = rng.random((23, 6, 6)).astype(np.float32)
    y = rng.integers(0, 3, 23)
    for stratify in (True, False):
        for a, b in zip(TD.split_train_test(x, y, 0.25, seed=5, stratify=stratify),
                        JD.split_train_test(x, y, 0.25, seed=5, stratify=stratify)):
            np.testing.assert_array_equal(a, b)
    for mode in ("unit", "standard"):
        np.testing.assert_array_equal(TD.normalize_images(x, mode), JD.normalize_images(x, mode))
    for a, b in zip(TD.augment_images(x, y, seed=3), JD.augment_images(x, y, seed=3)):
        np.testing.assert_array_equal(a, b)
    assert TD.fit_label_encoder(["b", "a", "b"]) == {"a": 0, "b": 1}


@pytest.mark.parametrize("interpolation,out_hw,exact", [("area", (24, 24), True),
                                                        ("area", (20, 30), False),
                                                        ("linear", (20, 30), False)])
def test_resize_images_matches_jax(rng, interpolation, out_hw, exact):
    # integer INTER_AREA factors are exact; the antialiased (non-integer
    # area) and bilinear forms add their taps in another order than
    # jax.image: held to 1e-6 relative (float32's 1.2e-7 ulp, a few taps)
    # plus JAX's resize tolerance of 1e-4 (tests/test_torch_watershed.py)
    images = [rng.integers(0, 4096, (48, 48)).astype(np.uint16),
              rng.integers(0, 4096, (72, 96)).astype(np.uint16)]
    images[1] = images[1][:48, :48]
    ours = TD.resize_images(images, out_hw, interpolation, device="cpu")
    ref = JD.resize_images(images, out_hw, interpolation)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-4)


def test_resize_images_needs_a_card_unless_told_cpu(rng):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.resize_images([np.zeros((8, 8), np.uint8)], (4, 4))
