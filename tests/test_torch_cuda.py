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


# ---- the serving slice's kernels: ccl, mode, watershed ----------------------

from cadx_tpu_torch.kernels import ccl as KC          # noqa: E402
from cadx_tpu_torch.kernels import mode as KM         # noqa: E402
from cadx_tpu_torch.kernels import watershed as KW    # noqa: E402
from cadx_tpu_torch.ops import components as TC       # noqa: E402


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("shape", [(3, 6, 6), (2, 62, 62), (2, 45, 70),
                                   (1, 1024, 1024)])
def test_ccl_kernel(dev, rng, conn, shape):
    h, w = shape[1:]
    m = torch.from_numpy(rng.random(shape) > 0.55).to(dev)
    m[0, : h // 3] = False
    got = KC.label_components(m, conn)
    _eq(got, KC.label_components_reference(m, conn, max_iters=h * w))
    _eq(KM.largest_component_mask(got, m), KM.largest_component_mask_reference(got, m))


def test_mode_kernel_ties_and_empty(dev):
    m = torch.zeros((2, 12, 12), dtype=torch.bool, device=dev)
    m[0, 1:3, 1:3] = True          # two components of area 4: the first wins
    m[0, 8:10, 8:10] = True
    labels = KC.label_components(m, 8)
    out = KM.largest_component_mask(labels, m)
    _eq(out, KM.largest_component_mask_reference(labels, m))
    assert int(out[0].sum()) == 4 and bool(out[0, 1, 1]) and not bool(out[1].any())


def _ws_inputs(rng, b, h, w, dev):
    img = rng.integers(0, 256, (b, h, w)).astype(np.float32)
    img[-1] = np.clip(np.add.outer(np.arange(h), np.arange(w)) * 2, 0, 255)
    mk = np.zeros((b, h, w), np.int32)
    mk[:, : h // 5, : w // 5] = 255
    mk[:, -h // 5:, -w // 5:] = 128
    mk[:, :3, -3:] = 64
    return torch.from_numpy(img).to(dev), torch.from_numpy(mk).to(dev)


@pytest.mark.parametrize("values", [(), (255, 128, 64)])
@pytest.mark.parametrize("max_scan", [8, 256])
@pytest.mark.parametrize("hw", [(64, 48), (96, 80), (520, 544)])
def test_watershed_kernel(dev, rng, values, max_scan, hw):
    """The packed form runs to its fixpoint, so its plain version runs
    uncapped; the pair form's float32 sweeps may never settle at larger
    sizes, so both run the same 256."""
    img, mk = _ws_inputs(rng, 2, *hw, dev)
    kw = dict(max_scan=max_scan, marker_label_values=values)
    cap = hw[0] * hw[1] if values else 256
    for a, b in zip(KW.marker_watershed(img, mk, **kw),
                    KW.marker_watershed_reference(img, mk, max_iters=cap, **kw)):
        _eq(a, b)


def test_dispatching_ops_launch_kernels(dev, rng):
    m = torch.from_numpy(rng.random((2, 20, 24)) > 0.5).to(dev)
    before = (KC.label_components.launches, KM.largest_component_mask.launches)
    _eq(TC.largest_component(m), TC.largest_component_plain(m))
    assert (KC.label_components.launches, KM.largest_component_mask.launches) == (
        before[0] + 1, before[1] + 1)
    KL.largest_obj_reference(m, fill=True)   # plain on the card: no launch
    assert KC.label_components.launches == before[0] + 1


def test_remove_pectoral_composed_branch(dev):
    from cadx_tpu_torch.synthetic import synthetic_native_mammogram

    x = torch.from_numpy(synthetic_native_mammogram(600, 520, seed=3).astype(np.float32))
    ref = cleaner.clean_boundary_gray(x[None])
    before = KW.marker_watershed.launches
    got = cleaner.clean_boundary_gray(x[None].to(dev))
    _eq(got, ref)
    assert KW.marker_watershed.launches == before + 1
