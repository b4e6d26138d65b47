"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with sm_90a and nvcc; every test skips elsewhere.
This file imports torch, numpy and the port only, so on the GPU machine
(which has no jax) it runs with the JAX CPU setup of conftest.py turned
off:

    CADX_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

Shapes are small and include non-power-of-two sides; the plain versions
run uncapped (max_iters = H*W), since the kernels run to the fixpoint.
"""

import numpy as np
import pytest
import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.kernels import equalize as KE
from cadx_tpu_torch.kernels import largest_obj as KL
from cadx_tpu_torch.kernels import pectoral as KP
from cadx_tpu_torch.preprocess import cleaner
from cadx_tpu_torch.ops.threshold import binary_threshold, relative_threshold_value
from cadx_tpu_torch.synthetic import synthetic_mammograms

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _build.load()
    return torch.device("cuda", 0)


def _eq(a, b):
    torch.cuda.synchronize()
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 256, 256), (1, 1, 5)])
def test_equalize_kernel(dev, rng, shape):
    x = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)).to(dev)
    _eq(KE.equalize(x), KE.equalize_reference(x))
    flat = torch.full(shape, 9, dtype=torch.uint8, device=dev)
    _eq(KE.equalize(flat), flat)


@pytest.mark.parametrize("kw", [dict(), dict(fill=True, smooth_k=15),
                                dict(fill_first=True), dict(connectivity=4),
                                dict(fill=True, smooth_k=4)])
@pytest.mark.parametrize("shape", [(2, 45, 70), (2, 128, 128)])
def test_largest_obj_kernel(dev, rng, kw, shape):
    h, w = shape[1:]
    m = torch.from_numpy(rng.random(shape) > 0.55).to(dev)
    m[0] = False                                   # an empty image
    _eq(KL.largest_obj(m, **kw), KL.largest_obj_reference(m, **kw, max_iters=h * w))
    full = torch.ones(shape, dtype=torch.bool, device=dev)
    _eq(KL.largest_obj(full, **kw), KL.largest_obj_reference(full, **kw))


@pytest.mark.parametrize("hw", [128, 256])
def test_pectoral_kernel(dev, hw):
    x = torch.from_numpy(synthetic_mammograms(4, hw, seed=2)).to(dev)
    sup, breast = cleaner.suppress_artifacts(x, 0.05, 15)
    seg, _ = cleaner.segment_breast_mask(sup, 0.05)
    seg = seg.to(torch.uint8)
    equ = KE.equalize(seg)
    high = binary_threshold(equ, relative_threshold_value(seg, 0.8), 255)
    for a, b in zip(KP.pectoral_tail(equ, high, breast),
                    KP.pectoral_tail_reference(equ, high, breast,
                                               max_iters=hw * hw,
                                               ws_max_iters=hw * hw)):
        _eq(a, b)


def test_launch_counters(dev):
    m = torch.zeros((1, 16, 16), dtype=torch.bool, device=dev)
    before = KL.largest_obj.launches
    KL.largest_obj(m)
    assert KL.largest_obj.launches == before + 1
    KL.largest_obj_reference(m)
    assert KL.largest_obj.launches == before + 1


def test_kernels_reject_wrong_inputs(dev):
    with pytest.raises(ValueError):
        KE.equalize(torch.zeros((1, 4, 4), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        KL.largest_obj(torch.zeros((4, 4), dtype=torch.bool, device=dev))
