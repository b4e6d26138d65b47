"""Median host ms for run_pipeline to return a batch, no synchronise."""

from harness.readers import span_median_ms


def read(r):
    return span_median_ms(r, "enqueue")
