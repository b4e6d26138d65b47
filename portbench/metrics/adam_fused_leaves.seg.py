"""Parameter tensors Adam's fused kernel updated, a segmentation step
(`adam_fused_leaves` inside the `train.step` span, traced window)."""

from harness.program import counter_per_call


def read(r):
    return counter_per_call("train.step", "adam_fused_leaves")
