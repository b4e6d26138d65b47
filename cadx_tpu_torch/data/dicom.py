"""Self-contained DICOM reader and a minimal writer, numpy only.

The port's own copy of `cadx_tpu/data/dicom.py`: `DicomFile`, `dcmread`,
`primary_frame`, `dcmwrite_minimal` and `DicomError`, for the training
CLI's data layer and the HTTP front's uploads. It reads the four
uncompressed transfer syntaxes (implicit VR little endian, explicit VR
little endian, deflated explicit VR little endian, explicit VR big
endian) and every encapsulated one the JAX package decodes: RLE, JPEG
lossless (process 14 and SV1), JPEG-LS (lossless and near-lossless), JPEG
baseline and extended, JPEG 2000 (lossless and lossy) and HTJ2K. Pixels
are 8/16-bit monochrome or samples-last color, one or more frames.

The encapsulated frames decode through the port's copies of the JAX
codecs (`data/codecs.py`, `jls.py`, `jpg.py`, `j2k.py`, `htj2k.py`);
RLE, JPEG lossless and JPEG-LS try the native C++ decoder first
(`data/native_loader.py`, bit-identical), and the Python codec runs where
it cannot be built or rejects a stream. `DECODER_RUNS` counts the frames
each decoder took, by (codec, "native" or "python").
"""

from __future__ import annotations

import collections
import dataclasses
import os
import struct
import threading
import zlib

import numpy as np

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN",
                      # newer long-form VRs (PS3.5 6.2): URIs, long code
                      # strings, double/64-bit arrays — misreading their
                      # 4-byte length as reserved bytes desyncs the walk
                      b"UC", b"UR", b"OD", b"OL", b"OV", b"SV", b"UV"}

# transfer syntax UIDs we can decode
TS_IMPLICIT_LE = "1.2.840.10008.1.2"
TS_EXPLICIT_LE = "1.2.840.10008.1.2.1"
TS_DEFLATED_LE = "1.2.840.10008.1.2.1.99"
TS_EXPLICIT_BE = "1.2.840.10008.1.2.2"  # retired, still in old archives
TS_RLE = "1.2.840.10008.1.2.5"
TS_JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"
TS_JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
TS_J2K_LOSSLESS = "1.2.840.10008.1.2.4.90"  # newer TCIA collections
TS_J2K = "1.2.840.10008.1.2.4.91"           # lossy-allowed (same decoder)
TS_JPEG_LS = "1.2.840.10008.1.2.4.80"       # lossless (T.87)
TS_JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"  # near-lossless (same decoder)
TS_JPEG_BASELINE = "1.2.840.10008.1.2.4.50"  # lossy 8-bit (T.81 SOF0)
TS_JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"  # lossy 12-bit (T.81 SOF1)
TS_HTJ2K_LOSSLESS = "1.2.840.10008.1.2.4.201"      # T.814 HT blocks
TS_HTJ2K_LOSSLESS_RPCL = "1.2.840.10008.1.2.4.202"
TS_HTJ2K = "1.2.840.10008.1.2.4.203"               # lossy-allowed

_UNCOMPRESSED_TS = {TS_IMPLICIT_LE, TS_EXPLICIT_LE, TS_DEFLATED_LE,
                    TS_EXPLICIT_BE}
_ENCAPSULATED_TS = {TS_RLE, TS_JPEG_LOSSLESS_P14, TS_JPEG_LOSSLESS_SV1,
                    TS_J2K_LOSSLESS, TS_J2K, TS_JPEG_LS, TS_JPEG_LS_NEAR,
                    TS_JPEG_BASELINE, TS_JPEG_EXTENDED,
                    TS_HTJ2K_LOSSLESS, TS_HTJ2K_LOSSLESS_RPCL, TS_HTJ2K}
_SUPPORTED_TS = _UNCOMPRESSED_TS | _ENCAPSULATED_TS
# JPEG 2000 and JPEG baseline/extended have no encoder in the port
_WRITABLE_TS = _SUPPORTED_TS - {TS_IMPLICIT_LE, TS_J2K_LOSSLESS, TS_J2K,
                                TS_JPEG_BASELINE, TS_JPEG_EXTENDED}

TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_PATIENT_ID = (0x0010, 0x0020)
TAG_NUMBER_OF_FRAMES = (0x0028, 0x0008)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_SAMPLES_PER_PIXEL = (0x0028, 0x0002)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)


class DicomError(ValueError):
    pass


# frames decoded, by (codec, "native" or "python"); the HTTP front's
# threads decode at once
DECODER_RUNS: collections.Counter = collections.Counter()
_DECODER_RUNS_LOCK = threading.Lock()


def _count(codec: str, how: str) -> None:
    with _DECODER_RUNS_LOCK:
        DECODER_RUNS[(codec, how)] += 1


@dataclasses.dataclass
class DicomFile:
    """Parsed DICOM dataset: raw elements + decoded pixel array."""

    elements: dict[tuple[int, int], bytes]
    transfer_syntax: str
    big_endian: bool = False  # Explicit VR Big Endian dataset encoding

    def get(self, tag: tuple[int, int], default=None):
        return self.elements.get(tag, default)

    # --- typed accessors -------------------------------------------------
    def get_str(self, tag, default: str = "") -> str:
        raw = self.elements.get(tag)
        if raw is None:
            return default
        return raw.decode("ascii", errors="replace").strip("\x00 ").strip()

    def get_int(self, tag, default: int = 0) -> int:
        raw = self.elements.get(tag)
        if raw is None:
            return default
        bo = ">" if self.big_endian else "<"
        if len(raw) == 2:
            return struct.unpack(bo + "H", raw)[0]
        if len(raw) == 4:
            return struct.unpack(bo + "I", raw)[0]
        try:
            return int(raw.decode("ascii").strip() or default)
        except ValueError:
            return default

    def get_is(self, tag, default: int = 0) -> int:
        """Integer-String (IS) value, e.g. NumberOfFrames: ASCII digits,
        NOT binary (a 2-byte b"2 " must read as 2, not 0x2032)."""
        raw = self.elements.get(tag)
        if raw is None:
            return default
        try:
            return int(raw.decode("ascii").strip("\x00 ") or default)
        except (UnicodeDecodeError, ValueError):
            return default

    @property
    def PatientID(self) -> str:  # pydicom-style convenience
        return self.get_str(TAG_PATIENT_ID, "Unknown")

    @property
    def pixel_array(self) -> np.ndarray:
        raw = self.elements.get(TAG_PIXEL_DATA)
        if raw is None:
            raise DicomError("no PixelData (7FE0,0010) element")
        rows = self.get_int(TAG_ROWS)
        cols = self.get_int(TAG_COLS)
        bits = self.get_int(TAG_BITS_ALLOCATED, 16)
        signed = self.get_int(TAG_PIXEL_REPRESENTATION, 0) == 1
        samples = max(self.get_int(TAG_SAMPLES_PER_PIXEL, 1), 1)
        if rows <= 0 or cols <= 0:
            raise DicomError("missing Rows/Columns")
        if self.transfer_syntax in _ENCAPSULATED_TS:
            if samples != 1:
                raise DicomError("compressed multi-sample data unsupported")
            return self._decode_compressed(raw, rows, cols, bits, signed)
        bo = ">" if self.big_endian else "<"
        if bits == 8:
            dtype = np.dtype("i1" if signed else "u1")
        elif bits == 16:
            dtype = np.dtype(bo + ("i2" if signed else "u2"))
        else:
            raise DicomError(f"unsupported BitsAllocated={bits}")
        n_frames = max(self.get_is(TAG_NUMBER_OF_FRAMES, 1), 1)
        need = n_frames * rows * cols * samples * (bits // 8)
        if len(raw) < need:
            raise DicomError(f"PixelData too short: {len(raw)} < {need}")
        arr = np.frombuffer(raw[:need], dtype=dtype)
        if self.big_endian and bits == 16:
            arr = arr.astype(arr.dtype.newbyteorder("="))  # native order out
        shape = (rows, cols) if samples == 1 else (rows, cols, samples)
        if n_frames > 1:  # pydicom convention: leading frame axis
            return arr.reshape((n_frames,) + shape)
        return arr.reshape(shape)

    def _decode_compressed(self, raw: bytes, rows: int, cols: int,
                           bits: int, signed: bool) -> np.ndarray:
        from cadx_tpu_torch.data import codecs

        n_frames = max(self.get_is(TAG_NUMBER_OF_FRAMES, 1), 1)
        _check_compressed_geometry(rows, cols, n_frames)
        try:
            frames = codecs.split_frames(raw, n_frames)
            decoded = []
            for frame in frames:
                if self.transfer_syntax == TS_RLE:
                    decoded.append(_rle_pixels(frame, rows, cols, bits))
                elif self.transfer_syntax in (TS_J2K_LOSSLESS, TS_J2K,
                                              TS_HTJ2K_LOSSLESS,
                                              TS_HTJ2K_LOSSLESS_RPCL,
                                              TS_HTJ2K):
                    # HTJ2K (.201/.202/.203) shares the Part-1 tier-2
                    # machinery; the HT block coder lives in data/htj2k.py
                    decoded.append(_j2k_pixels(frame, rows, cols))
                elif self.transfer_syntax in (TS_JPEG_LS, TS_JPEG_LS_NEAR):
                    decoded.append(_jls_pixels(frame, rows, cols))
                elif self.transfer_syntax in (TS_JPEG_BASELINE,
                                              TS_JPEG_EXTENDED):
                    decoded.append(_jpg_pixels(frame, rows, cols))
                else:
                    decoded.append(_jpeg_lossless_pixels(frame, rows, cols))
        except DicomError:
            raise
        except (ValueError, IndexError, KeyError, struct.error, MemoryError,
                OverflowError, ZeroDivisionError) as e:
            # malformed streams may fail mid-parse with raw index/struct/
            # value errors, and corrupt length fields can drive huge
            # allocations (MemoryError): every decode failure surfaces as
            # DicomError, the serving layer's catch contract (ValueError
            # also covers CodecError and JlsError)
            raise DicomError(f"compressed pixel decode failed: {e}") from e
        dtype = (np.int8 if signed else np.uint8) if bits == 8 else (
            np.int16 if signed else np.uint16)
        if n_frames == 1:
            return decoded[0].astype(dtype)
        # pydicom shape convention for multi-frame: (frames, rows, cols)
        return np.stack([d.astype(dtype) for d in decoded])


def _check_compressed_geometry(rows: int, cols: int, n_frames: int) -> None:
    """Compressed payloads expand: a hostile header (Rows and Columns are
    u16) would drive multi-GiB allocations in a decoder, so the geometry
    is bounded before any decode: 2^28 pixels a frame, 4096 frames, 2^31
    pixels in all (a ~130-frame tomosynthesis stack passes)."""
    if rows * cols > 1 << 28 or n_frames > 4096 or rows * cols * n_frames > 1 << 31:
        raise DicomError(f"implausible compressed geometry {rows}x{cols}x{n_frames} frames")


def _native(codec: str, fn, *args):
    """The native decoder's frame, or None where it cannot be built or
    rejects the stream (the caller then runs the Python codec)."""
    try:
        from cadx_tpu_torch.data import native_loader

        arr = getattr(native_loader, fn)(*args)
    except Exception:  # noqa: BLE001 — toolchain missing or native rejected
        return None
    if arr is not None:
        _count(codec, "native")
    return arr


def _rle_pixels(frame: bytes, rows: int, cols: int, bits: int) -> np.ndarray:
    """Decode a DICOM RLE frame, preferring the native (C++) decoder: the
    pure-Python PackBits loop is per byte and costs seconds on a
    full-resolution 16-bit mammogram; the codecs path stays the
    bit-identical fallback (and the parity oracle)."""
    if bits in (8, 16):  # depths the python oracle accepts
        arr = _native("rle", "decode_rle", frame, rows, cols, bits)
        if arr is not None:
            return arr
    from cadx_tpu_torch.data import codecs

    _count("rle", "python")
    return codecs.rle_decode(frame, rows, cols, bits)


def _jpeg_lossless_pixels(frame: bytes, rows: int, cols: int) -> np.ndarray:
    """Decode a JPEG-lossless frame, preferring the native (C++) decoder;
    the pure-Python reference codec is the bit-identical fallback."""
    arr = _native("jpeg_lossless", "decode_jpeg_lossless", frame, rows, cols)
    if arr is not None:
        return arr
    from cadx_tpu_torch.data import codecs

    _count("jpeg_lossless", "python")
    arr, _precision = codecs.jpeg_lossless_decode(frame, expect_hw=(rows, cols))
    if arr.shape != (rows, cols):
        raise DicomError(f"decoded JPEG size {arr.shape} != Rows/Columns {(rows, cols)}")
    return arr


def _jls_pixels(frame: bytes, rows: int, cols: int) -> np.ndarray:
    """Decode a JPEG-LS frame, preferring the native (C++) decoder (the
    pure-Python LOCO-I loop is per sample); data/jls.py is the
    bit-identical fallback."""
    arr = _native("jpeg_ls", "decode_jls", frame, rows, cols)
    if arr is not None:
        return arr
    from cadx_tpu_torch.data.jls import JlsError, jls_decode

    _count("jpeg_ls", "python")
    try:
        arr, _precision = jls_decode(frame, expect_hw=(rows, cols))
    except JlsError as e:
        raise DicomError(f"JPEG-LS decode failed: {e}") from e
    if arr.shape != (rows, cols):
        raise DicomError(f"decoded JPEG-LS size {arr.shape} != Rows/Columns {(rows, cols)}")
    return arr


def _jpg_pixels(frame: bytes, rows: int, cols: int) -> np.ndarray:
    """Decode a lossy sequential JPEG frame (data/jpg.py, one component)."""
    from cadx_tpu_torch.data.jpg import JpegError, jpeg_lossy_decode

    _count("jpeg", "python")
    try:
        arr, _precision = jpeg_lossy_decode(frame, expect_hw=(rows, cols))
    except JpegError as e:
        raise DicomError(f"lossy JPEG decode failed: {e}") from e
    if arr.shape != (rows, cols):
        raise DicomError(f"decoded JPEG size {arr.shape} != Rows/Columns {(rows, cols)}")
    return arr


def _j2k_pixels(frame: bytes, rows: int, cols: int) -> np.ndarray:
    """Decode a JPEG 2000 frame (data/j2k.py; its tier-1 and inverse 5/3
    take the native decoder where it builds)."""
    from cadx_tpu_torch.data.j2k import j2k_decode

    _count("j2k", "python")
    arr = j2k_decode(frame, expect_hw=(rows, cols))
    if arr.ndim != 2:
        raise DicomError("J2K multi-component pixel data in a single-sample DICOM")
    if arr.shape != (rows, cols):
        raise DicomError(f"decoded J2K size {arr.shape} != Rows/Columns {(rows, cols)}")
    return arr


def primary_frame(ds, arr: np.ndarray | None = None) -> np.ndarray:
    """2-D grayscale view of a dataset's pixel data: frame 0 of
    multi-frame files, rec601 luma of samples-last color
    (cv2.imread-grayscale semantics). The frame axis is identified by
    NumberOfFrames, never by ndim alone (an RGB file is also 3-D). Takes
    any object with a pydicom-style `pixel_array`: a DicomFile (get_is) or
    a pydicom dataset (NumberOfFrames attribute). `arr` reuses an
    already-decoded pixel array."""
    arr = np.asarray(ds.pixel_array if arr is None else arr)
    if hasattr(ds, "get_is"):
        n_frames = ds.get_is(TAG_NUMBER_OF_FRAMES, 1)
    else:
        try:
            n_frames = int(getattr(ds, "NumberOfFrames", 1) or 1)
        except (TypeError, ValueError):
            n_frames = 1
    if n_frames > 1 and arr.ndim >= 3:
        arr = arr[0]
    if arr.ndim == 3 and arr.shape[-1] in (3, 4):
        a = arr.astype(np.float64)
        gray = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
        arr = np.round(gray).astype(arr.dtype)
    return arr


def _scan_undefined(buf: memoryview, off: int, bo: str = "<") -> int:
    """Walk item tags from `off` to just past the (FFFE,E0DD) sequence
    delimiter. Handles the flat item layout of encapsulated pixel data
    and defined-length sequence items; undefined-length SQ items (rare
    in image files) are skipped by delimiter scan."""
    n = len(buf)
    while off + 8 <= n:
        group, elem = struct.unpack_from(bo + "HH", buf, off)
        length = struct.unpack_from(bo + "I", buf, off + 4)[0]
        off += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            return off
        if (group, elem) != (0xFFFE, 0xE000):
            raise DicomError(
                f"unexpected tag ({group:04x},{elem:04x}) inside "
                "undefined-length element")
        if length == 0xFFFFFFFF:
            # undefined-length item: scan for its (FFFE,E00D) delimiter
            while off + 8 <= n:
                g2, e2 = struct.unpack_from(bo + "HH", buf, off)
                if (g2, e2) == (0xFFFE, 0xE00D):
                    off += 8
                    break
                off += 2
            else:
                break
        else:
            off += length
    raise DicomError("unterminated undefined-length element")


def _read_element(buf: memoryview, off: int, explicit: bool, bo: str = "<"):
    group, elem = struct.unpack_from(bo + "HH", buf, off)
    off += 4
    vr = b""
    if explicit or group == 0x0002:  # file-meta group is always explicit
        vr = bytes(buf[off : off + 2])
        if vr in _EXPLICIT_LONG_VRS:
            length = struct.unpack_from(bo + "I", buf, off + 4)[0]
            off += 8
        else:
            length = struct.unpack_from(bo + "H", buf, off + 2)[0]
            off += 4
    else:
        length = struct.unpack_from(bo + "I", buf, off)[0]
        off += 4
    if length == 0xFFFFFFFF:
        end = _scan_undefined(buf, off, bo)
        if (group, elem) == TAG_PIXEL_DATA:
            # keep the raw item stream; pixel_array parses the fragments
            return (group, elem), bytes(buf[off:end]), end
        # undefined-length SQ/UN metadata: skipped (value not needed)
        return (group, elem), b"", end
    value = bytes(buf[off : off + length])
    return (group, elem), value, off + length


def dcmread(path_or_bytes) -> DicomFile:
    """Read a DICOM file (path or bytes), pydicom.dcmread's equivalent."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        with open(os.fspath(path_or_bytes), "rb") as f:
            data = f.read()

    if len(data) < 132 or data[128:132] != b"DICM":
        raise DicomError("not a DICOM file (missing DICM magic)")
    buf = memoryview(data)
    off = 132

    elements: dict[tuple[int, int], bytes] = {}
    # file meta group (always explicit VR LE). Prefer the declared
    # FileMetaInformationGroupLength (0002,0000) bound over sniffing the
    # next element's group — for Deflated files the bytes after the meta
    # group are a raw deflate stream that can legitimately start with
    # 02 00 and masquerade as a group-2 tag.
    ts = "1.2.840.10008.1.2.1"
    meta_end = None
    try:
        while off < len(buf) and (meta_end is None or off < meta_end):
            group = struct.unpack_from("<H", buf, off)[0]
            if group != 0x0002:
                break
            tag, value, off = _read_element(buf, off, explicit=True)
            elements[tag] = value
            if tag == (0x0002, 0x0000) and len(value) == 4:
                meta_end = off + struct.unpack("<I", value)[0]
    except (struct.error, IndexError) as e:
        # truncated/garbled meta group: surface the contract error, not
        # a raw parse exception
        raise DicomError(f"truncated file meta group: {e}") from e
    ts = elements.get(TAG_TRANSFER_SYNTAX, ts)
    if isinstance(ts, bytes):
        ts = ts.decode("ascii", errors="replace").strip("\x00 ").strip()
    if ts not in _SUPPORTED_TS:
        raise DicomError(f"unsupported transfer syntax {ts!r} (compressed?)")
    explicit = ts != TS_IMPLICIT_LE  # encapsulated syntaxes are explicit VR
    big_endian = ts == TS_EXPLICIT_BE
    bo = ">" if big_endian else "<"

    if ts == TS_DEFLATED_LE:
        # PS3.5 A.5: everything after the file meta group is one raw
        # deflate stream (RFC 1951, no zlib header) of an explicit-VR-LE
        # dataset. pydicom reads these the same way.
        try:
            inflated = zlib.decompressobj(-zlib.MAX_WBITS).decompress(
                bytes(buf[off:]))
        except zlib.error as e:
            raise DicomError(f"deflated dataset inflate failed: {e}") from e
        buf = memoryview(inflated)
        off = 0

    try:
        while off + 8 <= len(buf):
            tag, value, off = _read_element(buf, off, explicit, bo)
            elements[tag] = value
    except (struct.error, IndexError) as e:
        raise DicomError(f"truncated/garbled data set: {e}") from e
    return DicomFile(elements=elements, transfer_syntax=ts,
                     big_endian=big_endian)


def dcmwrite_minimal(path: str, pixel_array: np.ndarray,
                     patient_id: str = "Unknown",
                     transfer_syntax: str = TS_EXPLICIT_LE) -> None:
    """Write a minimal valid DICOM (for tests and demos): uint8 or uint16,
    (rows, cols) or (frames, rows, cols), as explicit VR little endian
    (default), deflated explicit VR little endian, explicit VR big endian,
    or encapsulated (PS3.5 A.4) with the port's own encoders: RLE, JPEG
    lossless (.57/.70), JPEG-LS (.80/.81 at NEAR 2) and HTJ2K (.201-.203,
    lossless). JPEG 2000 (.90/.91) and JPEG baseline/extended (.50/.51)
    raise DicomError: their encoders are OpenJPEG's and libjpeg's, which
    the port does not use (the JAX package writes them through cv2)."""
    arr = np.ascontiguousarray(pixel_array)
    if arr.dtype == np.uint8:
        bits = 8
    elif arr.dtype == np.uint16:
        bits = 16
    else:
        raise DicomError("writer supports uint8/uint16 only")
    if transfer_syntax not in _WRITABLE_TS:
        raise DicomError(f"writer does not support {transfer_syntax} (no encoder here for "
                         "JPEG 2000 or JPEG baseline/extended)")
    if arr.ndim == 3:   # (frames, rows, cols) multi-frame
        n_frames, rows, cols = arr.shape
    else:
        n_frames, (rows, cols) = 1, arr.shape[:2]
    bo = ">" if transfer_syntax == TS_EXPLICIT_BE else "<"

    def elem_short(group, el, vr: bytes, value: bytes, order: str | None = None) -> bytes:
        order = bo if order is None else order
        if len(value) % 2:
            # PS3.5 6.2: text VRs pad with SPACE, UI (and binary) with NUL
            value += b" " if vr in (b"LO", b"IS", b"SH", b"CS", b"PN") else b"\x00"
        return (struct.pack(order + "HH", group, el) + vr
                + struct.pack(order + "H", len(value)) + value)

    def elem_long(group, el, vr: bytes, value: bytes, order: str | None = None) -> bytes:
        order = bo if order is None else order
        if len(value) % 2:
            value += b"\x00"
        return (struct.pack(order + "HH", group, el) + vr + b"\x00\x00"
                + struct.pack(order + "I", len(value)) + value)

    # the file meta group is always explicit VR little endian; its declared
    # length (0002,0000) bounds it for readers (a deflated payload can start
    # with bytes that look like a group-2 tag)
    meta = elem_short(0x0002, 0x0010, b"UI", transfer_syntax.encode(), "<")
    meta = elem_long(0x0002, 0x0001, b"OB", b"\x00\x01", "<") + meta
    meta = elem_short(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta)), "<") + meta

    def us(v):
        return struct.pack(bo + "H", v)

    body = elem_short(0x0010, 0x0020, b"LO", patient_id.encode())
    if n_frames > 1:
        body += elem_short(0x0028, 0x0008, b"IS", str(n_frames).encode())
    body += elem_short(0x0028, 0x0002, b"US", us(1))
    body += elem_short(0x0028, 0x0010, b"US", us(rows))
    body += elem_short(0x0028, 0x0011, b"US", us(cols))
    body += elem_short(0x0028, 0x0100, b"US", us(bits))
    body += elem_short(0x0028, 0x0103, b"US", us(0))
    if transfer_syntax in _ENCAPSULATED_TS:
        # OB with undefined length + item stream (PS3.5 A.4); multi-frame
        # gets a Basic Offset Table so readers can map fragments to frames
        from cadx_tpu_torch.data import codecs

        body += (struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00"
                 + struct.pack("<I", 0xFFFFFFFF)
                 + codecs.encapsulate(_encode_frames(arr, bits, transfer_syntax),
                                      bot=n_frames > 1))
    else:
        pix = arr.astype(arr.dtype.newbyteorder(">")) if bo == ">" and bits == 16 else arr
        body += elem_long(0x7FE0, 0x0010, b"OW", pix.tobytes())
    if transfer_syntax == TS_DEFLATED_LE:
        # PS3.5 A.5: raw-deflate the whole post-meta dataset
        co = zlib.compressobj(level=6, wbits=-zlib.MAX_WBITS)
        body = co.compress(body) + co.flush()
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def _encode_frames(arr: np.ndarray, bits: int, transfer_syntax: str) -> list[bytes]:
    """Each frame of `arr` as one encoded fragment of `transfer_syntax`."""
    from cadx_tpu_torch.data import codecs

    frames = arr if arr.ndim == 3 else arr[None]
    if transfer_syntax == TS_RLE:
        return [codecs.rle_encode(f) for f in frames]
    if transfer_syntax in (TS_HTJ2K_LOSSLESS, TS_HTJ2K_LOSSLESS_RPCL, TS_HTJ2K):
        from cadx_tpu_torch.data.htj2k import ht_encode_lossless

        return [ht_encode_lossless(f, depth=bits) for f in frames]
    if transfer_syntax in (TS_JPEG_LS, TS_JPEG_LS_NEAR):
        from cadx_tpu_torch.data import jls

        near = 2 if transfer_syntax == TS_JPEG_LS_NEAR else 0
        return [jls.jls_encode(f, near=near, precision=bits) for f in frames]
    # the two JPEG-lossless syntaxes (.57/.70)
    return [codecs.jpeg_lossless_encode(f, precision=bits) for f in frames]
