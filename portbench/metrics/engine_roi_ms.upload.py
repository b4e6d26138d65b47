"""Median host ms of classify_and_roi a request (its one fetch ends it)."""

from harness.readers import span_median_ms


def read(r):
    return span_median_ms(r, "roi")
