"""The arithmetic that per-layer readers share (`metrics/<name>.py` are
one line each over these). Each returns None where it finds nothing to
read: no span, no complete trace, no device time of the kernels; a
share of a roofline or a peak is never given as 0."""

from __future__ import annotations

import statistics

from harness import counting


def span_median_ms(r, span: str):
    vals = r.spans.get(span)
    return statistics.median(vals) * 1e3 if vals else None


def _complete(r):
    return r.trace if r.trace is not None and r.trace.complete and r.trace.units else None


def group_device_ms(r, group: str):
    """Device milliseconds of a kernel group a unit of work."""
    t = _complete(r)
    if t is None or not t.group_s.get(group):
        return None
    return t.group_s[group] / t.units * 1e3


def idle_share(r):
    """Percent of the traced window with nothing running on the card."""
    t = _complete(r)
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_share(r, group: str):
    """Percent: the least time the traced units' counted work could take
    (`r.work[group]`, seconds) over the group's device time."""
    t = _complete(r)
    if t is None or not r.work.get(group) or not t.group_s.get(group):
        return None
    return 100.0 * r.work[group] / t.group_s[group]


def mfu(r):
    """Percent of the TF32 peak: model FLOPs of the measured window's
    units over its seconds."""
    if not r.window_s or not r.window_units:
        return None
    flops = r.window_units * r.model_flops_per_unit
    return 100.0 * flops / r.window_s / counting.TF32_FLOPS
