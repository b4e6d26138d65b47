"""Dynamic micro-batching for the serving engine.

Port of `cadx_tpu/serve/batcher.py`: concurrent classify requests enqueue;
a worker thread flushes up to `max_batch` of them after at most
`max_wait_ms` into one padded batch (feature resize, classifier forward,
the predicted class's Grad-CAM and its ROI), then hands each request a
result dict shaped like `InferenceEngine.classify`'s. The batch is always
padded to `max_batch`, so every flush runs the same shapes.

A malformed request fails only its own future; a failing batch is retried
one request at a time so only the offender gets the error. `close()`
fails every request still queued instead of leaving it waiting.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch
import torch.nn.functional as F

from cadx_tpu_torch.models import cnn
from cadx_tpu_torch.ops.resize import resize_linear
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.serve.engine import classify_result_dict
from cadx_tpu_torch.xai.gradcam import class_cams
from cadx_tpu_torch.xai.roi import roi_dict_from_vals, roi_from_cam


def _batched_classify(model: cnn.CNN, feats_hwc: torch.Tensor, fh: int, fw: int):
    """(B, H, W, C) features -> (probs, pred, rois) on the device: bilinear
    resize to (fh, fw), forward, the predicted class's CAM, its ROI."""
    with full_fp32():
        with torch.no_grad():
            fs = resize_linear(feats_hwc.to(torch.float32), (fh, fw))
            probs = cnn.forward(model, fs)
        pred = probs.argmax(dim=-1)
        seed = F.one_hot(pred, model.config.num_classes).to(torch.float32)
        cam = class_cams(model, fs, seed[None])[0]
        with torch.no_grad():
            rois = roi_from_cam(cam)
    return probs, pred, rois


class MicroBatcher:
    """Aggregates concurrent classify() calls into padded batches.
    `n_flushes` / `n_samples` say how well requests were batched."""

    def __init__(self, engine, pipeline: str = "basic", max_batch: int = 8,
                 max_wait_ms: float = 4.0):
        if pipeline == "basic":
            self._model = engine.basic_params
            self._fh, self._fw = engine.config.feature_resize
        else:
            self._model = engine.advanced_params
            self._fh, self._fw = engine.config.advanced_classifier.input_shape[:2]
        self._device = engine.device
        self._to_hwc = engine._to_hwc
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._stop = False
        self.n_flushes = 0
        self.n_samples = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def classify(self, features) -> dict:
        """Blocking per-request entry; the result matches
        InferenceEngine.classify's schema."""
        if self._stop:
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._q.put((np.asarray(features, np.float32), fut))
        if self._stop:
            # close() may have drained before this put landed
            self._drain_queue()
        return fut.result()

    def close(self) -> None:
        self._stop = True
        self._worker.join(timeout=2.0)
        self._drain_queue()

    def _drain_queue(self) -> None:
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("MicroBatcher closed"))

    def _run(self) -> None:
        while not self._stop:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            self._flush(batch)

    def _flush(self, batch) -> None:
        """Convert each request on its own (a bad payload fails only its
        future), group by feature shape, run each group padded."""
        by_shape: dict[tuple, list] = {}
        for f, fut in batch:
            try:
                hwc = self._to_hwc(f)
                if hwc.ndim != 3:
                    raise ValueError(
                        f"features must be rank-3 (HWC), got shape {f.shape}")
            except Exception as e:  # noqa: BLE001 — this request only
                if not fut.done():
                    fut.set_exception(e)
                continue
            by_shape.setdefault(hwc.shape, []).append((hwc, fut))
        for items in by_shape.values():
            self._flush_group(items)

    def _flush_group(self, items) -> None:
        try:
            b = len(items)
            x = np.zeros((self.max_batch,) + items[0][0].shape, np.float32)
            for i, (f, _) in enumerate(items):
                x[i] = f
            probs, pred, rois = _batched_classify(
                self._model, torch.from_numpy(x).to(self._device), self._fh, self._fw)
            fetched = torch.cat([probs, pred[:, None].to(torch.float32), rois],
                                dim=1)[:b].cpu().numpy()
            n = probs.shape[1]
            self.n_flushes += 1
            self.n_samples += b
            for i, (_, fut) in enumerate(items):
                fut.set_result(classify_result_dict(
                    fetched[i, :n], int(fetched[i, n]),
                    roi_dict_from_vals(fetched[i, n + 1:])))
        except Exception as e:  # noqa: BLE001 — the error reaches its caller
            if len(items) > 1:  # isolate the offender, keep the rest
                for item in items:
                    self._flush_group([item])
            else:
                _, fut = items[0]
                if not fut.done():
                    fut.set_exception(e)
