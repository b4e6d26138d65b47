"""Scans featurize sent to the card through its page-locked staging
buffer, an image (`staged_uploads` inside the `featurize` span, traced
window): 1 where the uint16 upload is staged, 0 on the CPU. Nothing for a
program without the staged upload (no `cadx_tpu_torch.utils.staging`),
which has no such counter."""

import importlib.util

from harness.program import counter_per_call


def read(r):
    if importlib.util.find_spec("cadx_tpu_torch.utils.staging") is None:
        return None
    return counter_per_call("featurize", "staged_uploads")
