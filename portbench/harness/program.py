"""The arithmetic of the readers of the port's own spans and counters
(`cadx_tpu_torch/utils/profiling.py`), which record only inside the
traced window's profiler. A per-unit value is a total over the calls of
the cell's top span (`pipeline`, `featurize`, `train.step`) divided by
those calls, so it holds whether the window took one attempt or three.
Each returns None where the port records no such span (a checkout
without them) or the trace has no record of the card."""

from __future__ import annotations

from harness.readers import _complete

PROGRAM_PREFIX = "cadx."


def _span_stats():
    """The port's span stats, or None where the port has no spans."""
    from cadx_tpu_torch.utils import profiling

    read = getattr(profiling, "span_stats", None)
    return read() if read is not None else None


def counter_per_call(span: str, counter: str):
    """The counts of `counter` bumped inside `span`, per call of it."""
    stats = _span_stats()
    s = stats.get(span) if stats else None
    if not s or not s["calls"]:
        return None
    return s["counts"].get(counter, 0) / s["calls"]


def span_ms_per_call(span: str):
    """Host milliseconds of `span` per call."""
    stats = _span_stats()
    s = stats.get(span) if stats else None
    if not s or not s["calls"]:
        return None
    return s["total_s"] / s["calls"] * 1e3


def program_idle_ms(r):
    """Milliseconds a unit of work that the card sat idle while a program
    span was the innermost open one (`TraceStats.idle_by_span`)."""
    t = _complete(r)
    if t is None or t.busy_s <= 0 or not _span_stats():
        return None
    return sum(s for name, s in t.idle_by_span.items()
               if name.startswith(PROGRAM_PREFIX)) / t.units * 1e3
