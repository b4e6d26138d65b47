"""Percent of its roofline that conv_leaky reaches: FLOPs at 495 TFLOP/s
(TF32 dense) or bytes at 3.35 TB/s, over its device time."""

from harness.readers import roofline_share


def read(r):
    return roofline_share(r, "conv_leaky")
