"""ctypes bindings for the native (C++) data-loading runtime.

The port's own copy of `cadx_tpu/data/native_loader.py`. Builds the
repo's unchanged `native/cadx_io.cc` with g++ on first use (never at
import), cached in `build/cadx_tpu_torch/`, and exposes:
- fast single-file DICOM pixel reads (drop-in for data.dicom on the
  uncompressed formats both support),
- NativeBatchLoader: a multi-threaded prefetching batch iterator that
  parses + resizes + normalizes DICOMs off the Python thread while the
  accelerator consumes previous batches.

Falls back cleanly (raises NativeUnavailable) if no toolchain exists;
callers use the pure-Python loader then.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "cadx_io.cc")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "cadx_tpu_torch")
_LIB_PATH = os.path.join(_BUILD_DIR, "libcadx_io.so")

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    # build under a name of this process's own, then rename: processes
    # that build at once (test workers) never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB_PATH)
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeUnavailable(f"failed to build cadx_io: {detail}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB_PATH


_lib_error: Exception | None = None


def get_lib() -> ctypes.CDLL:
    global _lib, _lib_error
    with _lib_lock:
        if _lib_error is not None:
            # cache build failures: re-running a failed multi-second g++
            # compile per frame/file would dwarf the python fallback
            raise _lib_error
        if _lib is None:
            try:
                path = _build()
            except NativeUnavailable as e:
                _lib_error = e
                raise
            lib = ctypes.CDLL(path)
            lib.cadx_dicom_info.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.cadx_dicom_info.restype = ctypes.c_int
            lib.cadx_dicom_pixels.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                ctypes.c_int]
            lib.cadx_dicom_pixels.restype = ctypes.c_int
            lib.cadx_decode_jpeg_lossless.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                ctypes.c_int, ctypes.c_int]
            lib.cadx_decode_jpeg_lossless.restype = ctypes.c_int
            lib.cadx_decode_jls.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                ctypes.c_int, ctypes.c_int]
            lib.cadx_decode_jls.restype = ctypes.c_int
            lib.cadx_decode_rle.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.cadx_decode_rle.restype = ctypes.c_int
            lib.cadx_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.cadx_loader_create.restype = ctypes.c_void_p
            lib.cadx_loader_next.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
            lib.cadx_loader_next.restype = ctypes.c_int
            lib.cadx_loader_next2.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.POINTER(ctypes.c_int64)]
            lib.cadx_loader_next2.restype = ctypes.c_int
            lib.cadx_j2k_decode_block.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
            lib.cadx_j2k_decode_block.restype = ctypes.c_int
            lib.cadx_idwt53_1d.argtypes = [
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
            lib.cadx_idwt53_1d.restype = ctypes.c_int
            lib.cadx_loader_destroy.argtypes = [ctypes.c_void_p]
            lib.cadx_loader_destroy.restype = None
            _lib = lib
    return _lib


def available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def read_dicom_pixels(path: str) -> np.ndarray:
    """Native single-file DICOM pixel read -> uint16 (rows, cols)."""
    lib = get_lib()
    rows = ctypes.c_int()
    cols = ctypes.c_int()
    bits = ctypes.c_int()
    rc = lib.cadx_dicom_info(path.encode(), ctypes.byref(rows),
                             ctypes.byref(cols), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"cadx_dicom_info({path}) failed rc={rc}")
    out = np.empty((rows.value, cols.value), np.uint16)
    rc = lib.cadx_dicom_pixels(path.encode(), out, out.size)
    if rc != 0:
        raise ValueError(f"cadx_dicom_pixels({path}) failed rc={rc}")
    return out


def decode_jpeg_lossless(frame: bytes, rows: int, cols: int):
    """Native JPEG-lossless (SOF3) frame decode -> int32 (rows, cols),
    or None if the native decoder rejects the stream (caller falls back
    to the pure-Python codec). Raises NativeUnavailable w/o toolchain."""
    lib = get_lib()
    out = np.empty((rows, cols), np.uint16)
    rc = lib.cadx_decode_jpeg_lossless(frame, len(frame), out, rows, cols)
    if rc != 0:
        return None
    return out.astype(np.int32)


def decode_jls(frame: bytes, rows: int, cols: int):
    """Native JPEG-LS (T.87) frame decode -> uint16 (rows, cols), or None
    if the native decoder rejects the stream (caller falls back to the
    pure-Python codec). Raises NativeUnavailable w/o toolchain."""
    lib = get_lib()
    out = np.empty((rows, cols), np.uint16)
    rc = lib.cadx_decode_jls(frame, len(frame), out, rows, cols)
    if rc != 0:
        return None
    return out


def decode_rle(frame: bytes, rows: int, cols: int, bits: int):
    """Native DICOM RLE frame decode -> uint16 (rows, cols) or None."""
    lib = get_lib()
    out = np.empty((rows, cols), np.uint16)
    rc = lib.cadx_decode_rle(frame, len(frame), out, rows, cols, bits)
    if rc != 0:
        return None
    return out


def decode_j2k_block(segments, w: int, h: int, bp_start: int, kind: int,
                     cbstyle: int):
    """Native EBCOT tier-1 decode of one J2K code-block.

    segments: [(bytes, n_passes, is_raw)] decoder segments as computed by
    data/j2k.py. Returns int64 (h, w) signed coefficients (no mid-point),
    or None if the native decoder rejects the block (caller falls back to
    the pure-Python reference). Raises NativeUnavailable w/o toolchain."""
    lib = get_lib()
    blob = b"".join(s[0] for s in segments)
    seg_bytes = np.asarray([len(s[0]) for s in segments], np.int64)
    seg_passes = np.asarray([s[1] for s in segments], np.int32)
    seg_raw = np.asarray([1 if s[2] else 0 for s in segments], np.int32)
    out = np.empty((h, w), np.int64)
    rc = lib.cadx_j2k_decode_block(blob, len(blob), seg_bytes, seg_passes,
                                   seg_raw, len(segments), w, h, bp_start,
                                   kind, cbstyle, out)
    if rc != 0:
        return None
    return out


def idwt53_1d(low: np.ndarray, high: np.ndarray, parity: int, axis: int):
    """Native 1D inverse 5/3 over a 2D plane (bit-identical to the
    numpy lifting in data/j2k.py::_idwt53_1d; pinned by tests/test_j2k.py).
    Returns the merged int64 plane, or None on a native reject.
    Raises NativeUnavailable without a toolchain."""
    lib = get_lib()
    low = np.ascontiguousarray(low, np.int64)
    high = np.ascontiguousarray(high, np.int64)
    if axis == 0:
        n_low, other = low.shape
        n_high = high.shape[0]
        out = np.empty((n_low + n_high, other), np.int64)
    else:
        other, n_low = low.shape
        n_high = high.shape[1]
        out = np.empty((other, n_low + n_high), np.int64)
    rc = lib.cadx_idwt53_1d(low, high, n_low, n_high, other, parity, axis,
                            out)
    return out if rc == 0 else None


def _box_resize(arr: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Exact semantics of the C++ loader's resize_area_f32 (integer bin
    edges, plain box average) so Python-rescued items match native-decoded
    ones bit-for-bit at the f32 output."""
    sh, sw = arr.shape
    dh, dw = out_hw
    # integral image -> box sums at integer edges
    y_edges = np.minimum(np.arange(dh + 1) * sh // dh, sh)
    x_edges = np.minimum(np.arange(dw + 1) * sw // dw, sw)
    y0, y1 = y_edges[:-1], np.maximum(y_edges[1:], y_edges[:-1] + 1)
    x0, x1 = x_edges[:-1], np.maximum(x_edges[1:], x_edges[:-1] + 1)
    ii = np.zeros((sh + 1, sw + 1), np.float64)
    ii[1:, 1:] = arr.astype(np.float64).cumsum(0).cumsum(1)
    sums = (ii[np.ix_(y1, x1)] - ii[np.ix_(y0, x1)]
            - ii[np.ix_(y1, x0)] + ii[np.ix_(y0, x0)])
    areas = (y1 - y0)[:, None] * (x1 - x0)[None, :]
    return (sums / areas).astype(np.float32)


class NativeBatchLoader:
    """Prefetching batch iterator over DICOM files.

    Yields (data float32 (batch, H, W), labels int32 (batch,), ok bool
    (batch,)) with per-item graceful skip (ok=False for unreadable files,
    mirroring the reference's skip-and-warn behavior).
    """

    def __init__(self, paths: list[str], labels, batch_size: int,
                 out_hw: tuple[int, int], n_workers: int = 4,
                 normalize: bool = True):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if out_hw[0] <= 0 or out_hw[1] <= 0:
            raise ValueError(f"out_hw must be positive, got {out_hw}")
        self._lib = get_lib()
        self.batch_size = batch_size
        self.out_hw = out_hw
        self._n = len(paths)
        self._n_workers = n_workers
        self._normalize = normalize
        self._paths = list(paths)
        self._encoded = [p.encode() for p in paths]
        self._labels = np.asarray(labels, np.int32)
        self._exhausted = False
        self._handle = None
        self._start_epoch()

    def _start_epoch(self) -> None:
        if self._handle:
            self._lib.cadx_loader_destroy(self._handle)
        arr = (ctypes.c_char_p * self._n)(*self._encoded)
        self._handle = self._lib.cadx_loader_create(
            arr, self._labels, self._n, self.batch_size,
            self.out_hw[0], self.out_hw[1], self._n_workers,
            int(self._normalize))
        if not self._handle:
            # NativeUnavailable (not ValueError) so callers' native-fallback
            # except clauses still fire on a NULL handle
            raise NativeUnavailable("cadx_loader_create returned NULL")
        self._exhausted = False

    def __iter__(self):
        # a fresh iteration pass restarts the epoch (the worker pool is
        # one-shot on the C side)
        if self._exhausted:
            self._start_epoch()
        return self

    def __next__(self):
        data = np.empty((self.batch_size, *self.out_hw), np.float32)
        labels = np.empty((self.batch_size,), np.int32)
        ok = np.empty((self.batch_size,), np.int32)
        start = ctypes.c_int64(0)
        count = self._lib.cadx_loader_next2(self._handle, data, labels, ok,
                                            ctypes.byref(start))
        if count == 0:
            self._exhausted = True
            raise StopIteration
        for slot in np.flatnonzero(ok[:count] == 0):
            self._rescue_item(int(start.value) + int(slot), data[slot],
                              labels, ok, int(slot))
        return data[:count], labels[:count], ok[:count].astype(bool)

    def _rescue_item(self, index: int, out_plane, labels, ok, slot) -> None:
        """Items the C++ parser can't decode (e.g. JPEG 2000 transfer
        syntaxes) are retried through the pure-Python DICOM reader with
        the same box-average resize + normalize, instead of being
        silently skipped; genuinely corrupt files still come back
        ok=False (the reference's graceful per-item skip)."""
        try:
            from cadx_tpu_torch.data import dicom as _dicom

            ds = _dicom.dcmread(self._paths[index])
            arr = _dicom.primary_frame(ds).astype(np.float64)
            out_plane[:] = _box_resize(arr, self.out_hw)
            if self._normalize:
                out_plane /= max(float(out_plane.max()), 1e-8)
            labels[slot] = self._labels[index]
            ok[slot] = 1
        except Exception:  # noqa: BLE001 — keep the skip contract
            pass

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.cadx_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
