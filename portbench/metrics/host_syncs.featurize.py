"""Places featurize blocked the host on the card, an image (`host_syncs`
inside the `featurize` span, traced window)."""

from harness.program import counter_per_call


def read(r):
    return counter_per_call("featurize", "host_syncs")
