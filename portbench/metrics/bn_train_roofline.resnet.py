"""Percent of their roofline that the training batch-norm kernels reach:
a step's batch-norm bytes (8 an element forward, 12 backward, at 3.35
TB/s; `resnet_counting.bn_train_bound_s`) over the device time of
`resnet_counting.BN_KERNELS`, traced window."""

from harness import resnet_counting
from harness.readers import _complete


def read(r):
    t = _complete(r)
    if t is None or not r.work.get("bn_train"):
        return None
    s = sum(t.device_s.get(k, 0.0) for k in resnet_counting.BN_KERNELS)
    return 100.0 * r.work["bn_train"] / s if s > 0 else None
