"""Parameter tensors Adam's fused kernel updated, a ResNet training step
(`adam_fused_leaves` inside the `train.step` span, traced window): 161."""

from harness.program import counter_per_call


def read(r):
    return counter_per_call("train.step", "adam_fused_leaves")
