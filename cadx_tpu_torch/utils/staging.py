"""Host-to-card upload of uint16 scans through a reused page-locked buffer.

A uint16 scan crosses to the card as its own two bytes a pixel: copied
into a page-locked host buffer kept for the card (grown to the largest
scan seen), sent by an asynchronous copy on the current stream, and
widened to float32 on the card, which is exact. The host never waits on
the copy itself: an event recorded after it is queried before the next
scan overwrites the buffer, and waited on (a counted `host_sync`) only
while the copy is still pending. A lock a card keeps two threads from
sharing the buffer between the host copy and the enqueue.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from cadx_tpu_torch.utils.profiling import count, host_sync


class _Stage:
    """A card's page-locked buffer and the event of its last copy."""
    __slots__ = ("lock", "host", "copied")

    def __init__(self):
        self.lock = threading.Lock()
        self.host: torch.Tensor | None = None   # page-locked bytes
        self.copied = torch.cuda.Event()        # no CUDA call until recorded


@functools.cache
def _stage(device: torch.device) -> _Stage:
    return _Stage()


def upload_u16(img: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint16 array -> the same shape in float32 on the CUDA `device`,
    bit for bit `np.asarray(img, np.float32)`, with no blocking copy."""
    src = torch.from_numpy(np.ascontiguousarray(img).view(np.int16))
    nbytes = 2 * src.numel()
    s = _stage(device)
    with s.lock:
        if not s.copied.query():
            host_sync(device)   # the last scan's copy still reads the buffer
            s.copied.synchronize()
        if s.host is None or s.host.numel() < nbytes:
            s.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        staged = s.host[:nbytes].view(torch.int16).view(src.shape)
        staged.copy_(src)
        raw = torch.empty(src.shape, dtype=torch.int16, device=device)
        raw.copy_(staged, non_blocking=True)
        s.copied.record(torch.cuda.current_stream(device))
    count("staged_uploads")
    # CUDA's uint16 support is thin: the int16 bits, sign-extended to
    # int32, masked back to 0..65535, then converted (exact below 2^24)
    return raw.to(torch.int32).bitwise_and_(0xFFFF).to(torch.float32)
