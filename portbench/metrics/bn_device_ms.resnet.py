"""Device ms a ResNet training step of the training batch-norm kernels
(`resnet_counting.BN_KERNELS`, forward and backward), traced window."""

from harness import resnet_counting
from harness.readers import _complete


def read(r):
    t = _complete(r)
    if t is None:
        return None
    s = sum(t.device_s.get(k, 0.0) for k in resnet_counting.BN_KERNELS)
    return s / t.units * 1e3 if s > 0 else None
