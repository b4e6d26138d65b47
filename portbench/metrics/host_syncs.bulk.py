"""Places run_pipeline blocked the host on the card, a batch (`host_syncs`
inside the `pipeline` span, traced window)."""

from harness.program import counter_per_call


def read(r):
    return counter_per_call("pipeline", "host_syncs")
