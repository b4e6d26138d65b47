"""Card idle ms a unit of work, filed under the innermost open program
span ("cadx.*"), in the traced window."""

from harness.program import program_idle_ms


def read(r):
    return program_idle_ms(r)
