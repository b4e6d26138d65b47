"""Card idle ms a ResNet training step, filed under the innermost open
program span ("cadx.train.*", "cadx.resnet.*"), in the traced window."""

from harness.program import program_idle_ms


def read(r):
    return program_idle_ms(r)
