"""Full float32 convolutions and matmuls on the card.

The JAX package runs its convolutions and matmuls at HIGHEST precision;
PyTorch on CUDA runs float32 convolutions in TF32 unless told otherwise.
`full_fp32()` turns TF32 off for cuDNN and for matmuls while any caller is
inside it and restores the previous settings when the last one leaves.
The settings are process-wide, so the entries and exits of concurrent
threads (the serving engine's request handlers and its micro-batcher
worker) are counted under a lock: one thread leaving never turns TF32 back
on under another that is still inside.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0
_saved: tuple[bool, bool] | None = None


@contextlib.contextmanager
def full_fp32():
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _saved
