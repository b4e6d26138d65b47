"""Percent of the traced window with no kernel, copy or memset on the card."""

from harness.readers import idle_share


def read(r):
    return idle_share(r)
