"""Percent of 495 TFLOP/s: ResNet-50's model FLOPs (`resnet_counting`, 3 x
forward a sample) of the measured window over its seconds."""

from harness.readers import mfu


def read(r):
    return mfu(r)
