"""Host ms of featurize's upload, a call: the scan's float32 conversion
and its copy to the card (`featurize.upload` span, traced window)."""

from harness.program import span_ms_per_call


def read(r):
    return span_ms_per_call("featurize.upload")
