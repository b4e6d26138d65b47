"""Median host ms to enqueue one ResNet training step, no synchronise."""

from harness.readers import span_median_ms


def read(r):
    return span_median_ms(r, "enqueue")
