"""Where the port's entry points run.

`InferenceEngine`, `fit`, `fit_segmentation`, `cross_validate` and
`tools.bench_train` run on the card unless the caller passes
`device="cpu"` (as the CPU tests do); without a card they raise rather
than fall back.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device`, or the current CUDA card when it is None. A CUDA device
    on a machine without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run on the CPU")
    return dev
