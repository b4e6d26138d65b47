"""Percent of its roofline that the pair-form watershed reaches: the
sweeps its inputs need (capped at 256) at 56 operations a pixel over 67
TFLOP/s, or 13 bytes a pixel over 3.35 TB/s, over its device time."""

from harness.readers import roofline_share


def read(r):
    return roofline_share(r, "watershed_pair")
