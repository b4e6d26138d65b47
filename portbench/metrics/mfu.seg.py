"""Percent of 495 TFLOP/s: the U-Net's model FLOPs (`unet_counting`) of the
measured window over its seconds."""

from harness.readers import mfu


def read(r):
    return mfu(r)
