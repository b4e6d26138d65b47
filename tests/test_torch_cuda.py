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


# ---- the training slice's kernels: conv_leaky, pool, upsample -----------------

from cadx_tpu_torch import checkpoint as CK          # noqa: E402
from cadx_tpu_torch.kernels import conv_leaky as KCL  # noqa: E402
from cadx_tpu_torch.kernels import pool as KPool      # noqa: E402
from cadx_tpu_torch.kernels import upsample as KUp    # noqa: E402
from cadx_tpu_torch.models import cnn as TCNN         # noqa: E402
from cadx_tpu_torch.ops import conv as TConv          # noqa: E402
from cadx_tpu_torch.ops import pool as TPool          # noqa: E402
from cadx_tpu_torch.train import step as TS           # noqa: E402


@pytest.mark.parametrize("shape", [(2, 5, 9, 11, 7, 3), (1, 64, 34, 34, 128, 3),
                                   (3, 3, 20, 17, 33, 5), (2, 9, 16, 16, 16, 1)])
@pytest.mark.parametrize("pad", ["VALID", "SAME"])
def test_conv_leaky_kernel(dev, rng, shape, pad):
    """f32 sums of <= C*k*k terms in another order than cuDNN's: max |d|
    <= 1e-5 * max |plain| + 1e-6."""
    b, c, h, w, f, k = shape
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32)).to(dev)
    x[:, :, : h // 2] = 0.0
    wt = torch.from_numpy((rng.standard_normal((f, c, k, k)) * 0.2).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(f).astype(np.float32)).to(dev)
    bias[0] = 0.0
    p = 0 if pad == "VALID" else k // 2
    before = KCL.conv_leaky.launches
    got = KCL.conv_leaky(x, wt, bias, 0.01, p)
    assert KCL.conv_leaky.launches == before + 1
    ref = KCL.conv_leaky_reference(x, wt, bias, 0.01, p)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()) + 1e-6, err
    zero_rows = got[:, 0, : max(0, h // 2 - k + 1 - p)]
    assert bool((zero_rows == 0).all())        # z == 0 -> 0 exactly


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("hw", [(12, 12), (7, 11), (256, 256)])
def test_pool_kernel(dev, rng, dtype, size, hw):
    x = torch.from_numpy(rng.standard_normal((2, 5) + hw).astype(np.float32)).to(dev, dtype)
    x[0, :, :4, :4] = 0.5
    for mode in ("max", "mean"):
        _eq(KPool.pool(x, size, mode), KPool.pool_reference(x, size, mode))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8, torch.bool])
def test_upsample_kernel(dev, rng, dtype):
    x = torch.from_numpy(rng.standard_normal((2, 3, 9, 13)).astype(np.float32) > 0)
    x = x.to(dev, dtype) if dtype == torch.bool else (x.to(dev, torch.float32) * 3).to(dtype)
    for f in (1, 2, 3):
        _eq(KUp.upsample_nearest(x, f), KUp.upsample_nearest_reference(x, f))


@pytest.mark.parametrize("rule", ["ties", "first"])
def test_pool_backward_card_vs_cpu(dev, rng, rule):
    fn = TPool.max_pool_ties if rule == "ties" else TPool.max_pool_first
    x = torch.from_numpy(np.maximum(rng.integers(-2, 3, (2, 3, 9, 10)), 0).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 3, 4, 5)).astype(np.float32))
    grads = []
    for d in ("cpu", dev):
        t = x.detach().to(d).requires_grad_(True)
        fn(t, 2).backward(g.to(d))
        grads.append(t.grad.cpu())
    assert torch.equal(*grads)


def test_conv_leaky_backward_card_vs_cpu(dev, rng):
    x = torch.from_numpy(rng.standard_normal((2, 6, 12, 11)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((9, 6, 3, 3)) * 0.3).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(9).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 9, 12, 11)).astype(np.float32))
    out = []
    for d in ("cpu", dev):
        ts = [t.detach().to(d).requires_grad_(True) for t in (x, w, b)]
        TConv.conv2d_leaky(*ts, 0.01, "SAME").backward(g.to(d))
        out.append([t.grad.cpu() for t in ts])
    for a, c in zip(*out):
        assert float((a - c).abs().max()) <= 1e-5 * float(c.abs().max()) + 1e-6


def test_sgd_step_and_fit_on_the_card(dev, rng, tmp_path):
    cfg = TCNN.CNNConfig(input_shape=(16, 16, 8), num_classes=2, conv_layers=((12, 3),),
                         hidden_units=(16,), dropout_rate=0.0)
    model = TCNN.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(rng.standard_normal((8, 16, 16, 8)).astype(np.float32))
    y = torch.eye(2)[torch.from_numpy(rng.integers(0, 2, 8))]
    mask = torch.ones(8)
    models, losses = [], []
    for d in ("cpu", dev):
        m = TCNN.init_params(torch.Generator().manual_seed(0), cfg, device=d)
        losses.append(float(TS.sgd_train_step(m, x.to(d), y.to(d), mask.to(d), 0.05, None)))
        models.append(m)
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    for a, c in zip(models[0].parameters(), models[1].parameters()):
        assert float((a - c.cpu()).abs().max()) <= 1e-5
    before = (KCL.conv_leaky.launches, KPool.pool.launches)
    X = rng.standard_normal((20, 16, 16, 8)).astype(np.float32)
    labels = rng.integers(0, 2, 20)
    res = TS.fit(model, X, np.eye(2)[labels], X[:6], labels[:6], epochs=2, batch_size=8,
                 device=dev)
    # 3 steps and one evaluation batch per epoch, one conv block each
    assert (KCL.conv_leaky.launches - before[0], KPool.pool.launches - before[1]) == (8, 8)
    assert res.model.out_w.device.type == "cuda" and model.out_w.device.type == "cpu"
    CK.save_npz(res.model, str(tmp_path / "m.npz"))
    _, back = CK.load_npz(str(tmp_path / "m.npz"), device=dev)
    for a, c in zip(res.model.parameters(), back.parameters()):
        assert torch.equal(a, c)


def test_entry_points_default_to_the_card(dev):
    from cadx_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    cfg = EngineConfig(segment_hw=(64, 64), feature_resize=(8, 8),
                       basic_classifier=TCNN.CNNConfig(input_shape=(8, 8, 64), num_classes=2,
                                                       conv_layers=((4, 3),), hidden_units=(8,)),
                       advanced_classifier=TCNN.CNNConfig(input_shape=(32, 32, 64),
                                                          num_classes=2, conv_layers=((4, 3),),
                                                          hidden_units=(8,)))
    assert InferenceEngine(cfg).device.type == "cuda"
