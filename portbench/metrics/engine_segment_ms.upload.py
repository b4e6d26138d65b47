"""Median host ms of process_single_image a request (its fetch ends it)."""

from harness.readers import span_median_ms


def read(r):
    return span_median_ms(r, "segment")
