"""Max pools a segmentation step routed to the card's backward kernel
(`pool_bwd_kernel` inside the `train.step` span, traced window): the
U-Net's four."""

from harness.program import counter_per_call


def read(r):
    return counter_per_call("train.step", "pool_bwd_kernel")
