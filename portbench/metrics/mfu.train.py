"""Percent of 495 TFLOP/s: the model FLOPs of the measured window over its seconds."""

from harness.readers import mfu


def read(r):
    return mfu(r)
