"""Batch-norm passes a ResNet training step launched on the training
batch-norm kernels (`bn_train_kernel` inside the `train.step` span, traced
window): each forward counted at its launch, each backward once autograd
has run it; ResNet-50's 53 each way, 106. A pass is three kernels."""

from harness.program import counter_per_call


def read(r):
    return counter_per_call("train.step", "bn_train_kernel")
