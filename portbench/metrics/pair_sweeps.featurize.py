"""Sweeps the pair-form watershed launched, an image (`pair_sweeps`
inside the `featurize` span, traced window)."""

from harness.program import counter_per_call


def read(r):
    return counter_per_call("featurize", "pair_sweeps")
