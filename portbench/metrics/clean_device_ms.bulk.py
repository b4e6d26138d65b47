"""Device ms of the cleaner's kernels a unit of work (traced window)."""

from harness.readers import group_device_ms


def read(r):
    return group_device_ms(r, "cleaner")
