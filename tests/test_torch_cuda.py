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
from cadx_tpu_torch.kernels import cleaner_front as KF
from cadx_tpu_torch.kernels import equalize as KE
from cadx_tpu_torch.kernels import largest_obj as KL
from cadx_tpu_torch.kernels import pectoral as KP
from cadx_tpu_torch.preprocess import cleaner
from cadx_tpu_torch.ops.threshold import binary_threshold, relative_threshold_value
from cadx_tpu_torch.synthetic import (pectoral_tile_edge_inputs, synthetic_mammograms,
                                      synthetic_native_mammogram)

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


def _pectoral_inputs(x):
    """(img_equ, img_bin, breast_mask) the cleaner hands the pectoral tail
    for the raw batch x."""
    sup, breast = cleaner.suppress_artifacts(x, 0.05, 15)
    seg, _ = cleaner.segment_breast_mask(sup, 0.05)
    seg = seg.to(torch.uint8)
    equ = KE.equalize(seg)
    return equ, binary_threshold(equ, relative_threshold_value(seg, 0.8), 255), breast


@pytest.mark.parametrize("hw", [128, 256])
def test_pectoral_kernel(dev, hw):
    x = torch.from_numpy(synthetic_mammograms(4, hw, seed=2)).to(dev)
    equ, high, breast = _pectoral_inputs(x)
    for a, b in zip(KP.pectoral_tail(equ, high, breast),
                    KP.pectoral_tail_reference(equ, high, breast,
                                               max_iters=hw * hw)):
        _eq(a, b)


def _pectoral_agrees_twice(equ, high, breast):
    """The plan bit-exact against the plain version (its CCLs uncapped, its
    watershed at the 256-sweep cap both run), and a second run giving the
    same bytes; one launch a call; the watershed's sweeps counted on the
    card, 1 to 256."""
    h, w = equ.shape[1:]
    before = KP.pectoral_tail.launches
    got = KP.pectoral_tail(equ, high, breast)
    sweeps = torch.zeros(1, dtype=torch.int32, device=equ.device)
    again = KP.run_plan(equ, high, breast, sweeps=sweeps)
    assert KP.pectoral_tail.launches == before + 2
    assert 1 <= int(sweeps.item()) <= 256
    plain = KP.pectoral_tail_reference(equ, high, breast, max_iters=h * w)
    for a, b, c in zip(got, plain, again):
        _eq(a, b)
        _eq(a, c)


@pytest.mark.parametrize("which", [1, 2])
def test_pectoral_kernel_serving_shapes(dev, which):
    """The cleaner's inputs at the 512² upload (B=1) and classify_batch's
    B=8 at 512²."""
    raw = (synthetic_native_mammogram(512, 512, seed=7, dtype=np.uint8, top=250)[None]
           if which == 1 else
           np.stack([synthetic_mammograms(1, 512, seed=30 + i)[0] for i in range(8)]))
    _pectoral_agrees_twice(*_pectoral_inputs(torch.from_numpy(raw).to(dev)))


@pytest.mark.parametrize("hw", [(64, 64), (256, 256), (45, 70), (1, 70), (70, 1), (333, 257)])
def test_pectoral_kernel_tile_edge_cases(dev, hw):
    """`synthetic.pectoral_tile_edge_inputs` (objects across tile edges and
    corners, noise costs, a third marker in a corner): the CCLs, bands and
    the tile-local watershed on ragged shapes."""
    arrays = pectoral_tile_edge_inputs(*hw)
    _pectoral_agrees_twice(*(torch.from_numpy(a).to(dev) for a in arrays))


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
from cadx_tpu_torch.ops import geodesic_scan as TGS  # noqa: E402


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
    """Both forms run JAX's sweeps to the same cap as the plain version:
    256 (the pair form's float32 sweeps may never settle at larger
    sizes)."""
    img, mk = _ws_inputs(rng, 2, *hw, dev)
    kw = dict(max_scan=max_scan, marker_label_values=values)
    cap = 256
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
    # the cleaner's front is one cleaner_front launch, no largest_obj, at
    # sides <= 512 (the fused pectoral tail)
    x = torch.from_numpy(synthetic_mammograms(2, 128, seed=4)).to(dev)
    counts = (KF.cleaner_front.launches, KL.largest_obj.launches, KP.pectoral_tail.launches)
    _eq(cleaner.clean_boundary_gray(x), cleaner.clean_boundary_gray(x.cpu()))
    assert (KF.cleaner_front.launches, KL.largest_obj.launches,
            KP.pectoral_tail.launches) == (counts[0] + 1, counts[1], counts[2] + 1)


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


@pytest.mark.parametrize("shape", [(2, 5, 9, 11, 7, 3), (1, 64, 34, 34, 128, 3),
                                   (3, 3, 20, 17, 33, 5), (2, 24, 19, 21, 70, 3),
                                   (2, 9, 16, 16, 16, 1)])
@pytest.mark.parametrize("pad", ["VALID", "SAME"])
@pytest.mark.parametrize("nhwc", [False, True])
def test_conv_leaky_bf16_kernel(dev, rng, shape, pad, nhwc):
    """The bf16 form against its plain version (cuDNN's bf16 conv, the same
    epilogue): float32 sums in other orders rounded to bf16 twice, so an
    output may land a bf16 step or two away: max |d| <= 2^-6 * max
    |plain|; most outputs equal. One launch a call, NCHW or the NHWC view."""
    b, c, h, w, f, k = shape
    x = torch.from_numpy(rng.standard_normal((b, h, w, c) if nhwc else (b, c, h, w))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    x = x.permute(0, 3, 1, 2) if nhwc else x
    wt = torch.from_numpy((rng.standard_normal((f, c, k, k)) * 0.2).astype(np.float32)).to(
        dev, torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(f).astype(np.float32)).to(dev)
    p = 0 if pad == "VALID" else k // 2
    before = KCL.conv_leaky_bf16.launches
    got = KCL.conv_leaky_bf16(x, wt, bias, 0.01, p)
    assert KCL.conv_leaky_bf16.launches == before + 1
    ref = KCL.conv_leaky_bf16_reference(x, wt, bias, 0.01, p)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 2 ** -6 * float(ref.float().abs().max()), err
    assert float((got != ref).float().mean()) < 0.01


def test_conv_stack_bf16_launches_the_bf16_form(dev, rng):
    """A bf16 conv stack launches conv_leaky_bf16 a block (never the
    float32 form); a float32 input to the bf16 wrapper raises."""
    cfg = TCNN.CNNConfig(input_shape=(16, 16, 8), num_classes=2,
                         conv_layers=((16, 3), (8, 3)), hidden_units=(8,),
                         dropout_rate=0.0, conv_padding="SAME")
    model = TCNN.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    x = torch.from_numpy(rng.standard_normal((4, 16, 16, 8)).astype(np.float32)).to(dev)
    before = (KCL.conv_leaky_bf16.launches, KCL.conv_leaky.launches)
    feats = TCNN.conv_stack(model, x, compute_dtype=torch.bfloat16)
    assert feats.dtype == torch.bfloat16
    assert (KCL.conv_leaky_bf16.launches, KCL.conv_leaky.launches) == (before[0] + 2,
                                                                        before[1])
    cpu = TCNN.conv_stack(model.cpu(), x.cpu(), compute_dtype=torch.bfloat16)
    err = float((feats.float().cpu() - cpu.float()).abs().max())
    assert err <= 2 ** -5 * float(cpu.float().abs().max()), err
    with pytest.raises(ValueError):
        KCL.conv_leaky_bf16(x.permute(0, 3, 1, 2), model.conv_w[0].detach().to(dev),
                            model.conv_b[0].detach().to(dev))


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


# ---- the explainability slice's kernels: batchnorm, jet_blend, gradcam_tail ----

from cadx_tpu_torch.kernels import batchnorm as KBN       # noqa: E402
from cadx_tpu_torch.kernels import gradcam_tail as KGT    # noqa: E402
from cadx_tpu_torch.kernels import overlay as KOv         # noqa: E402
from cadx_tpu_torch.models import resnet as TR            # noqa: E402


def _bn_vectors(rng, c, dev):
    vec = [rng.standard_normal(c) * 0.3 + 1, rng.standard_normal(c) * 0.2,
           rng.standard_normal(c) * 0.3, rng.uniform(0.5, 1.5, c)]
    return [torch.from_numpy(v.astype(np.float32)).to(dev) for v in vec]


@pytest.mark.parametrize("shape", [(1, 64, 256, 256), (2, 2048, 16, 16), (3, 5, 7, 9),
                                   (1, 3, 1, 1)])
def test_batchnorm_kernel(dev, rng, shape):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    vec = _bn_vectors(rng, shape[1], dev)
    before = KBN.batchnorm.launches
    _eq(KBN.batchnorm(x, *vec), KBN.batchnorm_reference(x, *vec))
    assert KBN.batchnorm.launches == before + 1
    # a contiguous view that starts off a 16-byte boundary takes the scalar path
    big = torch.from_numpy(rng.standard_normal((shape[0] + 1,) + shape[1:]).astype(np.float32))
    big = big.to(dev)
    view = big.flatten()[1:1 + x.numel()].view(shape)
    _eq(KBN.batchnorm(view, *vec), KBN.batchnorm_reference(view, *vec))


@pytest.mark.parametrize("shape", [(2, c, h, w) for c in (3, 64, 2048)
                                   for h, w in ((1, 1), (1, 3), (2, 2), (16, 16))]
                         + [(2, 3, 256, 256), (2, 64, 256, 256)])
def test_batchnorm_kernel_plane_sizes(dev, rng, shape):
    """Planes of 1, 3, 4, 256 and 65,536 elements (a block spans up to
    1,024 planes or a chunk of one), on a contiguous tensor and on a view
    4 bytes off a 16-byte boundary (the scalar path)."""
    vec = _bn_vectors(rng, shape[1], dev)
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32)).to(dev)
    with torch.no_grad():
        for x in (flat[:n].view(shape), flat[1:].view(shape)):
            _eq(KBN.batchnorm(x, *vec), KBN.batchnorm_reference(x, *vec))


def test_batchnorm_kernel_rejects_wrong_inputs(dev, rng):
    x = torch.zeros((1, 4, 8, 8), device=dev)
    vec = _bn_vectors(rng, 4, dev)
    before = KBN.batchnorm.launches
    for bad in (x.to(memory_format=torch.channels_last), x.double(), x[0]):
        with pytest.raises(ValueError):
            KBN.batchnorm(bad, *vec)
    with pytest.raises(ValueError):
        KBN.batchnorm(x, vec[0][:3], *vec[1:])
    with pytest.raises(ValueError):
        KBN.batchnorm(x.requires_grad_(True), *vec)        # no backward
    assert KBN.batchnorm.launches == before


@pytest.mark.parametrize("shape", [(64, 256, 256), (1, 512, 512), (3, 37, 53)])
@pytest.mark.parametrize("rgb", [False, True])
def test_jet_blend_kernel(dev, rng, shape, rgb):
    heat = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)).to(dev)
    img = rng.integers(0, 256, shape + ((3,) if rgb else ())).astype(np.float32)
    img01 = torch.from_numpy(img).to(dev) / 255.0
    before = KOv.jet_blend.launches
    _eq(KOv.jet_blend(heat, img01), KOv.jet_blend_reference(heat, img01))
    assert KOv.jet_blend.launches == before + 1
    dark = torch.zeros_like(img01)                         # peak from the table alone
    _eq(KOv.jet_blend(heat, dark), KOv.jet_blend_reference(heat, dark))


def test_jet_blend_kernel_rejects_wrong_inputs(dev):
    heat = torch.zeros((2, 8, 8), dtype=torch.uint8, device=dev)
    img = torch.zeros((2, 8, 8), device=dev)
    before = KOv.jet_blend.launches
    for h, i in ((heat.int(), img), (heat, img.double()), (heat, img.transpose(1, 2)),
                 (heat, torch.zeros((2, 8, 8, 3), device=dev).transpose(1, 2)),
                 (heat, torch.zeros((2, 8, 9), device=dev))):
        with pytest.raises(ValueError):
            KOv.jet_blend(h, i)
    assert KOv.jet_blend.launches == before


@pytest.mark.parametrize("acts_shape,out_hw", [((64, 6, 6, 64), (256, 256)),
                                               ((2, 6, 6, 64), (256, 256)),
                                               ((2, 16, 16, 32), (512, 512)),
                                               ((3, 5, 7, 8), (37, 53))])
def test_gradcam_tail_kernel(dev, rng, acts_shape, out_hw):
    """The pipeline's layout (channel-first activations, channel-last
    gradients): the kernel adds in torch's reduction order, heat +-1 and
    overlay +-2 where the heat agrees (the Pallas kernel's own
    tolerances), bit for bit at the pipeline's (B, 6, 6, 64) -> 256²;
    contiguous activations add in another order, within the same
    tolerances."""
    b, h, w, f = acts_shape
    acts = torch.from_numpy(np.abs(rng.standard_normal((b, f, h, w))).astype(np.float32))
    acts = acts.to(dev).permute(0, 2, 3, 1)                 # the pipeline's strides
    grads = torch.from_numpy(rng.standard_normal(acts_shape).astype(np.float32)).to(dev)
    img01 = torch.from_numpy(rng.integers(0, 256, (b,) + out_hw).astype(np.float32)).to(dev) / 255
    before = KGT.gradcam_tail.launches
    ov, hm = KGT.gradcam_tail(acts, grads, img01, out_hw)
    assert KGT.gradcam_tail.launches == before + 1
    ov_p, hm_p = KGT.gradcam_tail_reference(acts, grads, img01, out_hw)
    if (h, w, f) == (6, 6, 64):
        _eq(ov, ov_p)
        _eq(hm, hm_p)
    for a in (acts, acts.contiguous()):
        ov, hm = KGT.gradcam_tail(a, grads, img01, out_hw)
        torch.cuda.synchronize()
        dh = (hm.int() - hm_p.int()).abs().cpu()
        assert int(dh.max()) <= 1
        same = (dh == 0)[..., None].expand(ov.shape)
        assert int((ov.int() - ov_p.int()).abs().cpu()[same].max()) <= 2


@pytest.mark.parametrize("b,rows", [(1, None), (2, None), (64, None), (3, 5), (2, 7)])
def test_gradcam_tail_kernel_bands(dev, rng, monkeypatch, b, rows):
    """Row bands of the pipeline's (B, 6, 6, 64) -> 256²: band_rows' own
    choice at B=1, 2 and 64, and 5 and 7 rows a band, which leave a last
    band of 1 and 4 rows; bit for bit on the pipeline's layout, and heat
    +-1, overlay +-2 where the heat agrees on contiguous activations, as
    test_gradcam_tail_kernel holds them."""
    if rows is not None:
        monkeypatch.setattr(KGT, "band_rows", lambda *_: rows)
    acts = torch.from_numpy(np.abs(rng.standard_normal((b, 64, 6, 6))).astype(np.float32))
    acts = acts.to(dev).permute(0, 2, 3, 1)
    grads = torch.from_numpy(rng.standard_normal((b, 6, 6, 64)).astype(np.float32)).to(dev)
    img01 = torch.from_numpy(rng.integers(0, 256, (b, 256, 256)).astype(np.float32)).to(dev) / 255
    before = KGT.gradcam_tail.launches
    ov, hm = KGT.gradcam_tail(acts, grads, img01, (256, 256))
    assert KGT.gradcam_tail.launches == before + 1
    ov_p, hm_p = KGT.gradcam_tail_reference(acts, grads, img01, (256, 256))
    _eq(ov, ov_p)
    _eq(hm, hm_p)
    ov, hm = KGT.gradcam_tail(acts.contiguous(), grads, img01, (256, 256))
    torch.cuda.synchronize()
    dh = (hm.int() - hm_p.int()).abs().cpu()
    assert int(dh.max()) <= 1
    same = (dh == 0)[..., None].expand(ov.shape)
    assert int((ov.int() - ov_p.int()).abs().cpu()[same].max()) <= 2


def test_gradcam_tail_kernel_rejects_wrong_inputs(dev):
    acts = torch.zeros((2, 6, 6, 4), device=dev)
    img = torch.zeros((2, 32, 32), device=dev)
    before = KGT.gradcam_tail.launches
    for a, g, i in ((acts.double(), acts, img), (acts, acts.half(), img),
                    (acts, acts, img.transpose(1, 2)), (acts, acts[:1], img),
                    (acts, acts, torch.zeros((2, 32, 31), device=dev))):
        with pytest.raises(ValueError):
            KGT.gradcam_tail(a, g, i, (32, 32))
    assert KGT.gradcam_tail.launches == before


def test_resnet_card_vs_cpu(dev, rng):
    cfg = TR.ResNetConfig("bottleneck", (1, 2, 1, 1), (8, 16, 16, 32), 3, 5)
    model = TR.init_resnet(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    before = KBN.batchnorm.launches
    got = TR.stage_features(model.to(dev), x.to(dev))
    assert KBN.batchnorm.launches == before + 1 + 3 * 5 + 4
    ref = TR.stage_features(model.cpu(), x)
    for a, c in zip(got, ref):
        assert float((a.cpu() - c).abs().max()) <= 1e-4 * max(float(c.abs().max()), 1.0)


# ---- the last two TPU kernels: cleaner_front and the seeded component ---------

from cadx_tpu_torch.synthetic import synthetic_native_mammogram, tile_edge_cases  # noqa: E402


def _front_batch(rng, h, w, dev):
    """Mammograms at (h, w), uniform noise and an all-dark image."""
    mammos = [synthetic_native_mammogram(h, w, seed=s, dtype=np.uint8, top=250)
              for s in (1, 2)]
    noise = rng.integers(0, 256, (h, w)).astype(np.uint8)
    return torch.from_numpy(np.stack(mammos + [noise, np.zeros((h, w), np.uint8)])).to(dev)


@pytest.mark.parametrize("hw", [(128, 128), (200, 136)])
@pytest.mark.parametrize("smooth_k", [15, 4])
def test_cleaner_front_kernel(dev, rng, hw, smooth_k):
    x = _front_batch(rng, *hw, dev)
    before = KF.cleaner_front.launches
    got = KF.cleaner_front(x, smooth_k)
    assert KF.cleaner_front.launches == before + 1
    want = KF.cleaner_front_reference(x, smooth_k, max_iters=hw[0] * hw[1])
    assert KF.cleaner_front.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        _eq(a, b)
    # an absolute threshold (the constant table)
    for a, b in zip(KF.cleaner_front(x, smooth_k, 30.0),
                    KF.cleaner_front_reference(x, smooth_k, 30.0, max_iters=hw[0] * hw[1])):
        _eq(a, b)


@pytest.mark.parametrize("smooth_k", [0, 3, 15])
@pytest.mark.parametrize("hw", [(64, 64), (256, 256), (45, 70), (1, 70), (70, 1)])
def test_cleaner_front_kernel_tile_edge_cases(dev, hw, smooth_k):
    """The tiled kernel on the inputs that break a tiled CCL, a batch of
    twelve different images, against the plain version uncapped; a second
    run gives the same bytes."""
    x = torch.from_numpy(tile_edge_cases(*hw)).to(dev)
    got = KF.cleaner_front(x, smooth_k)
    again = KF.cleaner_front(x, smooth_k)
    want = KF.cleaner_front_reference(x, smooth_k, max_iters=hw[0] * hw[1])
    for a, b, c in zip(got, want, again):
        _eq(a, b)
        _eq(a, c)


def test_cleaner_front_kernel_rejects_wrong_inputs(dev):
    before = KF.cleaner_front.launches
    for bad in (torch.zeros((1, 8, 8), dtype=torch.int32, device=dev),
                torch.zeros((8, 8), dtype=torch.uint8, device=dev),
                torch.zeros((1, 8, 9), dtype=torch.uint8, device=dev).transpose(1, 2)):
        with pytest.raises(ValueError):
            KF.cleaner_front(bad)
    with pytest.raises(ValueError):
        KF.cleaner_front(torch.zeros((1, 8, 8), dtype=torch.uint8, device=dev), -1)
    assert KF.cleaner_front.launches == before


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("shape", [(4, 64, 64), (3, 200, 136)])
def test_seeded_component_kernel(dev, rng, conn, shape):
    b, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((yy - h // 2) ** 2 + (xx - 3 * w // 4) ** 2) < (min(h, w) // 2 - 4) ** 2
    blob[2:5, 2:5] = True
    tie = np.zeros((h, w), bool)
    tie[5:10, 5:10] = tie[40:45, 40:45] = True
    masks = np.stack([blob, tie, rng.random((h, w)) > 0.55, np.zeros((h, w), bool)][:b])
    m = torch.from_numpy(masks).to(dev)
    before = KL.largest_component_seeded.launches
    got = KL.largest_component_seeded(m, conn)
    assert KL.largest_component_seeded.launches == before + 1
    _eq(got, KL.largest_component_seeded_reference(m, conn, max_iters=h * w))
    _eq(got, TC.largest_component_plain(m, conn, max_iters=h * w))
    assert KL.largest_component_seeded.launches == before + 1


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 1, 70), (2, 70, 1), (3, 33, 31),
                                   (2, 45, 70), (2, 333, 257)])
def test_seeded_component_kernel_ties_and_edges(dev, rng, conn, shape):
    """Exact ties (two equal squares; two equal diagonal pairs, which join
    8-connected only; equal parts in different 32x32 tiles), an empty mask,
    one pixel, odd shapes: the smallest label wins, empty selects nothing,
    and the bytes are largest_obj's without fill or opening."""
    b, h, w = shape
    masks = np.zeros(shape, bool)
    masks[0, h // 2, w // 2] = True
    if b > 1:
        masks[1] = rng.random((h, w)) < 0.5
    if h >= 33 and w >= 31:
        tie = np.zeros((h, w), bool)
        tie[2:6, 2:6] = tie[h - 6:h - 2, w - 6:w - 2] = True
        tie[10, 10] = tie[11, 11] = tie[10, 20] = tie[11, 21] = True
        masks = np.concatenate([masks, tie[None], np.zeros((1, h, w), bool)])
    m = torch.from_numpy(masks).to(dev)
    got = KL.largest_component_seeded(m, conn)
    _eq(got, KL.largest_component_seeded_reference(m, conn, max_iters=h * w))
    _eq(got, TC.largest_component_plain(m, conn, max_iters=h * w))
    _eq(got, KL.largest_obj(m, conn))
    _eq(KL.largest_component_seeded(m, conn), got)


def test_seeded_component_kernel_rejects_wrong_inputs(dev):
    before = KL.largest_component_seeded.launches
    for bad in (torch.zeros((1, 8, 8), dtype=torch.uint8, device=dev),
                torch.zeros((8, 8), dtype=torch.bool, device=dev)):
        with pytest.raises(ValueError):
            KL.largest_component_seeded(bad)
    with pytest.raises(ValueError):
        KL.largest_component_seeded(torch.zeros((1, 8, 8), dtype=torch.bool, device=dev), 6)
    assert KL.largest_component_seeded.launches == before


# ---- the flood kernel; conv_leaky's layouts and ragged shapes; upsample ------

from cadx_tpu_torch.kernels import flood as KFl       # noqa: E402


def _serpentine(h, w, step):
    m = np.zeros((h, w), bool)
    for r in range(0, h, step):
        m[r, :] = True
        m[r + 1:r + step, w - 1 if (r // step) % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 256, 256), (2, 600, 520)])
def test_flood_kernel(dev, rng, conn, shape):
    """Bit-exact to the fixpoint and after a capped run, from a short image
    to one of more bands than the others' (600x520: 19 row bands, 17
    column bands of 32)."""
    b, h, w = shape
    masks = rng.random(shape) < 0.6
    masks[0] = _serpentine(h, w, 3)
    seed = np.zeros(shape, bool)
    seed[:, 0, :] = True
    m, s = torch.from_numpy(masks).to(dev), torch.from_numpy(seed).to(dev)
    for cap in (0, 1, 2, 9, h * w):
        before = KFl.flood_from.launches
        got = KFl.flood_from(m, s, cap, conn)
        assert KFl.flood_from.launches == before + 1
        _eq(got, KFl.flood_from_reference(m, s, cap, conn))


def _flood_edge_cases(rng):
    """(name, mask, seed) at the cooperative flood's edges: runs across word
    borders at W = 31, 32, 33 (B*H*W not a multiple of 32), rows and columns
    of more than a warp's 32 words, a batch of more bands than the card holds
    blocks at once, a single pixel, an empty mask."""
    cases = []
    for w in (31, 32, 33):
        m = rng.random((3, 37, w)) < 0.7
        m[0, 5], m[1, :, 7] = True, True
        s = np.zeros_like(m)
        s[:, :, 0] = True
        cases.append((f"3x37x{w}", m, s))
    m = rng.random((2, 5, 1100)) < 0.97
    m[0, 2] = True
    s = np.zeros_like(m)
    s[:, 2, 1099] = True
    cases.append(("rows of 35 words, 2x5x1100", m, s))
    m = rng.random((1, 1090, 5)) < 0.97
    s = np.zeros_like(m)
    s[0, 0, :] = True
    cases.append(("columns of 35 words, 1x1090x5", m, s))
    m = rng.random((700, 64, 40)) < 0.6
    s = np.zeros_like(m)
    s[:, 0, :] = True
    cases.append(("more bands than one wave, 700x64x40", m, s))
    one = np.zeros((2, 1, 1), bool)
    one[0] = True
    cases.append(("one pixel", one, one.copy()))
    cases.append(("empty", np.zeros((2, 9, 70), bool), np.ones((2, 9, 70), bool)))
    return cases


@pytest.mark.parametrize("conn", [4, 8])
def test_flood_kernel_layout_edges(dev, rng, conn):
    sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
    for name, masks, seeds in _flood_edge_cases(rng):
        m, s = torch.from_numpy(masks).to(dev), torch.from_numpy(seeds).to(dev)
        cap = masks.shape[1] * masks.shape[2]
        got = KFl.flood_from(m, s, cap, conn, sweeps=sweeps)
        _eq(got, KFl.flood_from_reference(m, s, cap, conn))
        _eq(KFl.flood_from(m, s, cap, conn), got)


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("cap", [1, 2, 17])
def test_flood_kernel_capped_serpentine(dev, conn, cap):
    """The state and the sweep count after a capped run, which no union-find
    gives: the serpentines need a sweep a turn."""
    masks = np.stack([_serpentine(90, 70, st) for st in (2, 3, 5)])
    seeds = np.zeros_like(masks)
    seeds[:, 0, 0] = True
    m, s = torch.from_numpy(masks).to(dev), torch.from_numpy(seeds).to(dev)
    sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
    got = KFl.flood_from(m, s, cap, conn, sweeps=sweeps)
    _eq(got, KFl.flood_from_reference(m, s, cap, conn))
    assert int(sweeps) == cap
    assert int(got.sum()) < int(m.sum())


def test_flood_kernel_sweep_count(dev, rng):
    """The sweeps a call ran: those of the plain loop (to the first sweep that
    changes nothing)."""
    from cadx_tpu_torch.ops import components as TCo

    m = torch.from_numpy(rng.random((4, 48, 40)) < 0.65).to(dev)
    s = torch.zeros_like(m)
    s[:, 0] = True
    s &= m
    for conn in (4, 8):
        count = [0]
        run = TCo._run_to_fixpoint

        def counting(sweep, state, cap):
            def counted(x):
                count[0] += 1
                return sweep(x)
            return run(counted, state, cap)

        TCo._run_to_fixpoint = counting
        try:
            KFl.flood_from_reference(m, s, 48 * 40, conn)
        finally:
            TCo._run_to_fixpoint = run
        sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
        KFl.flood_from(m, s, 48 * 40, conn, sweeps=sweeps)
        assert int(sweeps) == count[0]


def test_flood_dispatch_and_plain_versions(dev, rng):
    m = torch.from_numpy(rng.random((2, 40, 36)) > 0.3).to(dev)
    before = KFl.flood_from.launches
    _eq(TC.fill_holes(m), TC.fill_holes_plain(m, 40 * 36))
    s = m & torch.from_numpy(rng.random((2, 40, 36)) < 0.01).to(dev)
    _eq(TC.flood_from(m, s), TC.flood_from_plain(m, s, 40 * 36))
    assert KFl.flood_from.launches == before + 2
    KL.largest_obj_reference(m, fill=True)
    KL.largest_obj_reference(m, fill_first=True)
    KL.largest_component_seeded_reference(m)
    assert KFl.flood_from.launches == before + 2


def test_flood_kernel_rejects_wrong_inputs(dev):
    m = torch.zeros((1, 8, 8), dtype=torch.bool, device=dev)
    before = KFl.flood_from.launches
    for mask, seed in ((m.to(torch.uint8), m), (m[0], m[0]), (m, m[:, :4]),
                       (m, m.to(torch.uint8))):
        with pytest.raises(ValueError):
            KFl.flood_from(mask, seed)
    with pytest.raises(ValueError):
        KFl.flood_from(m, m, connectivity=6)
    assert KFl.flood_from.launches == before


@pytest.mark.parametrize("shape", [(2, 64, 32, 32, 128, 3, 0), (1, 64, 40, 36, 32, 3, 1),
                                   (1, 3, 37, 53, 40, 5, 2), (2, 7, 30, 33, 5, 7, 3),
                                   (1, 5, 19, 70, 5, 1, 0)])
def test_conv_leaky_kernel_nhwc_view(dev, rng, shape):
    """The channels-last view of NHWC features, as conv_stack hands layer 1
    over, read in place: the same tolerance as the contiguous input, and no
    allocation but the output."""
    b, c, h, w, f, k, pad = shape
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(dev)
    xv = x.permute(0, 3, 1, 2)
    wt = torch.from_numpy((rng.standard_normal((f, c, k, k)) * 0.2).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(f).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = KCL.conv_leaky(xv, wt, bias, 0.01, pad)
    torch.cuda.synchronize()
    # the caching allocator rounds a block up to 512 bytes
    assert torch.cuda.max_memory_allocated() - base <= -(-got.numel() * 4 // 512) * 512
    ref = KCL.conv_leaky_reference(xv.contiguous(), wt, bias, 0.01, pad)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()) + 1e-6
    _eq(got, KCL.conv_leaky(xv.contiguous(), wt, bias, 0.01, pad))


def test_conv_leaky_kernel_rejects_other_strides(dev):
    x = torch.zeros((1, 4, 9, 10), device=dev)
    w, b = torch.zeros((3, 4, 3, 3), device=dev), torch.zeros(3, device=dev)
    before = KCL.conv_leaky.launches
    for bad in (x[:, :, ::2], x.transpose(2, 3), torch.zeros((1, 9, 4, 10), device=dev)
                .permute(0, 2, 1, 3)):
        with pytest.raises(ValueError):
            KCL.conv_leaky(bad, w, b)
    assert KCL.conv_leaky.launches == before


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32, torch.float64])
@pytest.mark.parametrize("w", [13, 16, 32])
def test_upsample_kernel_element_sizes(dev, rng, dtype, w):
    """Every element size at factors 2 (16-byte path where a row is a
    multiple of 16 bytes) and 3 (scalar path), raw bits."""
    x = torch.from_numpy(rng.integers(0, 120, (2, 3, 9, w))).to(dev, dtype)
    for f in (2, 3):
        _eq(KUp.upsample_nearest(x, f), KUp.upsample_nearest_reference(x, f))
    with pytest.raises(ValueError):
        KUp.upsample_nearest(x, 0)
    with pytest.raises(ValueError):
        KUp.upsample_nearest(x.transpose(2, 3), 2)


# ---- largest_obj on the tiled union-find; the pair-form watershed's tiled sweep ----

_LARGEST_ORDERINGS = [dict(), dict(smooth_k=15), dict(fill=True), dict(fill=True, smooth_k=4),
                      dict(fill=True, smooth_k=15), dict(fill_first=True),
                      dict(fill_first=True, smooth_k=4)]


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("kw", _LARGEST_ORDERINGS)
@pytest.mark.parametrize("hw", [(64, 64), (45, 70), (1, 70), (70, 1), (333, 257)])
def test_largest_obj_kernel_tile_edge_cases(dev, hw, kw, conn):
    """The tiled kernel in every ordering on the inputs that break a tiled
    CCL (ties across tiles, diagonal joins at tile corners, holes across
    corners, 1 x n), against its plain version uncapped, one launch a
    call, the same bytes on a second run."""
    h, w = hw
    m = torch.from_numpy(tile_edge_cases(h, w) > 0).to(dev)
    before = KL.largest_obj.launches
    got = KL.largest_obj(m, conn, **kw)
    again = KL.largest_obj(m, conn, **kw)
    assert KL.largest_obj.launches == before + 2
    _eq(got, KL.largest_obj_reference(m, conn, **kw, max_iters=h * w))
    _eq(got, again)


@pytest.mark.parametrize("kw", [dict(fill=True, smooth_k=15), dict(fill_first=True),
                                dict(fill=True)])
def test_largest_obj_kernel_batch_64(dev, rng, kw):
    """B=64 at 256²: the cleaner's suppress-site masks, random masks, an
    empty and a full image; two runs give the same bytes."""
    raw8 = torch.from_numpy(synthetic_mammograms(48, 256, seed=5)).to(dev)
    masks = binary_threshold(raw8, relative_threshold_value(raw8, 0.05), 255) > 0
    noise = torch.from_numpy(rng.random((14, 256, 256)) > 0.55).to(dev)
    m = torch.cat([masks, noise, torch.zeros_like(noise[:1]), torch.ones_like(noise[:1])])
    assert m.shape == (64, 256, 256)
    got = KL.largest_obj(m, 8, **kw)
    _eq(got, KL.largest_obj_reference(m, 8, **kw, max_iters=256 * 256))
    _eq(got, KL.largest_obj(m, 8, **kw))


def test_cleaner_front_unchanged_by_the_shared_header(dev):
    """cleaner_front launches the header's select, fill and window kernels
    that largest_obj now shares: still one call a batch, bit-exact to its
    plain version at B=64."""
    raw8 = torch.from_numpy(synthetic_mammograms(64, 256, seed=6)).to(dev)
    before = KF.cleaner_front.launches
    got = KF.cleaner_front(raw8)
    assert KF.cleaner_front.launches == before + 1
    for a, b in zip(got, KF.cleaner_front_reference(raw8, max_iters=256 * 256)):
        _eq(a, b)


@pytest.mark.parametrize("max_iters", [1, 2, 17, 256])
@pytest.mark.parametrize("max_scan", [8, 256])
@pytest.mark.parametrize("hw", [(45, 70), (1, 70), (70, 1), (5, 9), (130, 200), (333, 257)])
def test_pair_watershed_kernel_capped(dev, rng, hw, max_scan, max_iters):
    """The pair form at ragged shapes and sides below the halo, max_scan 8
    (the tiled sweep) and 256 (a launch a pass), stopped after exactly
    max_iters sweeps as the plain version is (odd counts end in the other
    plane pair), and the same bytes on a second run."""
    img, mk = _ws_inputs(rng, 2, *hw, dev)
    kw = dict(max_iters=max_iters, max_scan=max_scan)
    got = KW.marker_watershed(img, mk, **kw)
    for a, b, c in zip(got, KW.marker_watershed_reference(img, mk, **kw),
                       KW.marker_watershed(img, mk, **kw)):
        _eq(a, b)
        _eq(a, c)


@pytest.mark.parametrize("max_scan", [8, 256])
@pytest.mark.parametrize("hw", [(24, 20), (45, 70), (64, 48), (130, 200)])
def test_pair_watershed_kernel_early_stop(dev, rng, hw, max_scan):
    """Small images whose float32 sweeps settle: the kernel stops as the
    plain version does, reading the flags every CHECK_EVERY sweeps, so with
    at most ceil(n / CHECK_EVERY) + 1 host synchronisations for n sweeps
    (a 256-sweep call makes ceil(256 / CHECK_EVERY) - 1)."""
    img, mk = _ws_inputs(rng, 2, *hw, dev)
    n = TGS.sweeps_to_fixpoint(img, mk, 256, max_scan)
    assert n < 256
    got = KW.marker_watershed(img, mk, max_scan=max_scan)
    syncs = KW.marker_watershed.host_syncs
    for a, b in zip(got, KW.marker_watershed_reference(img, mk, max_scan=max_scan)):
        _eq(a, b)
    assert syncs <= -(-n // KW.CHECK_EVERY) + 1


@pytest.mark.parametrize("values", [(), (255, 128, 64)])
@pytest.mark.parametrize("hw,max_scan", [((3, 5), 8), ((3, 20), 256)])
def test_watershed_kernel_beyond_65535_images(dev, rng, values, hw, max_scan):
    """More images than a grid's images axis holds (65535): both forms take
    them in groups, bit-exact against the plain version on the whole batch.
    The pair form sweeps the 3 x 5 images in halo tiles and the 3 x 20 ones
    (a row window of 16) a launch a pass."""
    img, mk = _ws_inputs(rng, 65537, *hw, dev)
    kw = dict(max_scan=max_scan, marker_label_values=values)
    for a, b in zip(KW.marker_watershed(img, mk, **kw),
                    KW.marker_watershed_reference(img, mk, **kw)):
        _eq(a, b)


# ---- equalize over chunks x images; ccl's cluster and tiled forms -----------

from cadx_tpu_torch.synthetic import equalize_edge_cases  # noqa: E402

# equalize's path shapes: (B, H, W) of run_pipeline, the uploads (the
# 3328x2560 one at its 1536x1280 bucket), classify_batch and the training CLI
_EQ_PATH_SHAPES = [(64, 256, 256), (1, 512, 512), (8, 512, 512), (1, 1024, 832),
                   (1, 1536, 1280), (1, 3328, 2560), (1, 4608, 2656)]


def _equalize_twice(x):
    """One launch a call, bit-exact to the plain version, the same bytes on
    a second run."""
    before = KE.equalize.launches
    got = KE.equalize(x)
    again = KE.equalize(x)
    assert KE.equalize.launches == before + 2
    _eq(got, KE.equalize_reference(x))
    _eq(got, again)


@pytest.mark.parametrize("shape", _EQ_PATH_SHAPES)
def test_equalize_kernel_path_shapes(dev, shape):
    """The breast image remove_pectoral hands equalize (cleaner_front's
    output) at every shape a path gives it."""
    b, h, w = shape
    raw = np.stack([synthetic_native_mammogram(h, w, seed=s, dtype=np.uint8, top=250)
                    for s in range(b)])
    _equalize_twice(KF.cleaner_front(torch.from_numpy(raw).to(dev))[0].contiguous())


@pytest.mark.parametrize("case", sorted(equalize_edge_cases()))
def test_equalize_kernel_edge_cases(dev, case):
    """Zero background, all zero, one level, one pixel, a ramp, LUT entries
    on .5 and an odd-n batch whose images start off 16-byte boundaries."""
    _equalize_twice(torch.from_numpy(equalize_edge_cases()[case]).to(dev))


def test_equalize_kernel_unaligned_view(dev, rng):
    """A view that starts 1 byte past a 16-byte boundary: the output is
    placed at the same offset, so the kernel's 16-byte loads and stores
    pair up."""
    x = torch.from_numpy(rng.integers(0, 256, (4, 37, 53)).astype(np.uint8)).to(dev)
    view = x.view(-1)[1:1 + 3 * 37 * 53].view(3, 37, 53)
    assert view.data_ptr() % 16 != 0
    out = KE.equalize(view)
    assert (out.data_ptr() - view.data_ptr()) % 16 == 0
    _eq(out, KE.equalize_reference(view))


_CCL_EDGE_SHAPES = [(64, 64), (256, 256), (45, 70), (1, 70), (70, 1), (333, 257)]


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("hw", _CCL_EDGE_SHAPES)
def test_ccl_kernel_tile_edge_cases(dev, hw, conn):
    """The inputs that break a tiled CCL (ties across tiles, diagonal joins
    at tile corners, 1 x n; the cluster form up to 64 x 64, the tiled form
    beyond), against the plain version uncapped, the same bytes twice."""
    h, w = hw
    m = torch.from_numpy(tile_edge_cases(h, w) > 0).to(dev)
    want = KC.label_components_reference(m, conn, max_iters=h * w)
    got = KC.label_components(m, conn)
    _eq(got, want)
    _eq(got, KC.label_components(m, conn))


@pytest.mark.parametrize("form", ["cluster", "tiled"])
@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("shape", [(3, 62, 62), (1, 6, 6), (8, 6, 6), (2, 45, 60),
                                   (2, 64, 64), (1, 1, 64), (2, 64, 1)])
def test_ccl_kernel_forms(dev, rng, monkeypatch, shape, conn, form):
    """The serving path's CAM masks (CAM >= 0.6 of its peak) in the
    cluster form and in the tiled form, one launch a call, bit-exact against the
    plain version uncapped, the same bytes twice."""
    b, h, w = shape
    monkeypatch.setattr(KC, "form_for", lambda h, w: form)
    cams = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
    m = cams >= 0.6 * cams.amax(dim=(1, 2), keepdim=True)
    before = KC.label_components.launches
    got = KC.label_components(m, conn)
    assert KC.label_components.launches == before + 1
    _eq(got, KC.label_components_reference(m, conn, max_iters=h * w))
    _eq(got, KC.label_components(m, conn))


@pytest.mark.parametrize("hw", [(64, 64), (333, 257)])
@pytest.mark.parametrize("kernel", ["cleaner_front", "largest_obj", "pectoral_tail"])
def test_tiled_header_kernels_unchanged(dev, kernel, hw):
    """ccl moved onto tiled_components.cuh beside cleaner_front, largest_obj
    and pectoral_tail: each still bit-exact to its plain version uncapped
    on the tile edge cases."""
    h, w = hw
    x = torch.from_numpy(tile_edge_cases(h, w)).to(dev)
    if kernel == "cleaner_front":
        for a, b in zip(KF.cleaner_front(x), KF.cleaner_front_reference(x, max_iters=h * w)):
            _eq(a, b)
    elif kernel == "largest_obj":
        m = x > 0
        _eq(KL.largest_obj(m, 8, fill=True, smooth_k=15),
            KL.largest_obj_reference(m, 8, fill=True, smooth_k=15, max_iters=h * w))
    else:
        _pectoral_agrees_twice(*(torch.from_numpy(a).to(dev)
                                 for a in pectoral_tile_edge_inputs(h, w)))


# ---- mode as one cluster launch; jet_blend reading its inputs once ----------

# mode: (shape, form); the block form up to 64 x 64 (the wrapper takes it
# up to 1,024 pixels), the cluster form up to 64 x 64, the wide form at
# every shape: both sides of 32 x 32 and of 64 x 64
_MODE_SHAPES = [(3, 62, 62), (1, 6, 6), (8, 6, 6), (2, 32, 32), (2, 32, 33), (2, 64, 64),
                (1, 1, 64), (2, 64, 1), (3, 37, 53), (1, 1, 1), (2, 65, 64), (1, 64, 65),
                (16, 256, 256)]
_MODE_CASES = [(s, f) for s in _MODE_SHAPES if KM.form_for(*s[1:]) != "wide"
               for f in ("block", "cluster")] + [(s, "wide") for s in _MODE_SHAPES]


def _mode_inputs(rng, shape, dev):
    """CAM-like masks (CAM >= 0.6 of its peak) and their 8-connected labels;
    random masks at density 0.45 at 256²."""
    if shape[1] == 256:
        m = torch.from_numpy(rng.random(shape) < 0.45).to(dev)
    else:
        cams = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        m = cams >= 0.6 * cams.amax(dim=(1, 2), keepdim=True)
    return KC.label_components(m, 8), m


def _mode_twice(labels, m):
    """One launch a call, bit-exact to the plain version, the same bytes on
    a second run."""
    before = KM.largest_component_mask.launches
    got = KM.largest_component_mask(labels, m)
    assert KM.largest_component_mask.launches == before + 1
    _eq(got, KM.largest_component_mask_reference(labels, m))
    _eq(got, KM.largest_component_mask(labels, m))


@pytest.mark.parametrize("shape,form", _MODE_CASES)
def test_mode_kernel_forms(dev, rng, monkeypatch, shape, form):
    monkeypatch.setattr(KM, "form_for", lambda h, w: form)
    _mode_twice(*_mode_inputs(rng, shape, dev))


@pytest.mark.parametrize("form", ["block", "cluster", "wide"])
def test_mode_kernel_edge_inputs(dev, monkeypatch, form):
    """Labels out of range (negative, H*W, beyond), an exact tie, an empty
    mask and a mask whose every label is out of range."""
    monkeypatch.setattr(KM, "form_for", lambda h, w: form)
    m = torch.zeros((4, 12, 12), dtype=torch.bool, device=dev)
    m[0, 1:3, 1:3] = True          # two components of area 4: the first wins
    m[0, 8:10, 8:10] = True
    m[2, :, :6] = True
    m[3, 5, 5] = True
    labels = KC.label_components(m, 8)
    labels[2, :, :3] = -5          # 36 pixels not counted
    labels[2, :2, 3:6] = 144       # H*W: not counted
    labels[3, 5, 5] = 1000
    _mode_twice(labels, m)
    out = KM.largest_component_mask(labels, m)
    assert int(out[0].sum()) == 4 and bool(out[0, 1, 1]) and not bool(out[1].any())
    assert int(out[2].sum()) == 30 and not bool(out[3].any())


def test_mode_kernel_batch_zero_and_refusal(dev, monkeypatch):
    """B=0 launches nothing; the block and cluster forms refuse a plane
    beyond 64 x 64 (the C rule that form_for states) and count no launch."""
    for form in ("block", "cluster", "wide"):
        monkeypatch.setattr(KM, "form_for", lambda h, w, f=form: f)
        e = torch.zeros((0, 8, 8), dtype=torch.int32, device=dev)
        before = KM.largest_component_mask.launches
        assert KM.largest_component_mask(e, e.bool()).shape == (0, 8, 8)
        assert KM.largest_component_mask.launches == before
    m = torch.ones((1, 65, 64), dtype=torch.bool, device=dev)
    for form in ("block", "cluster"):
        monkeypatch.setattr(KM, "form_for", lambda h, w, f=form: f)
        before = KM.largest_component_mask.launches
        with pytest.raises(RuntimeError):
            KM.largest_component_mask(KC.label_components(m, 8), m)
        assert KM.largest_component_mask.launches == before


# jet_blend: (shape, form); the one-launch form where the images fit 132
# blocks of 512 threads (an H100 SXM's SMs), the wide form at every shape;
# both sides of that edge at 132 images and at one image of 132 blocks;
# (3, 37, 53), (2, 1, 5) and (5, 17, 19) start their images off 16-byte
# boundaries
_JET_SHAPES = [(1, 512, 512), (64, 256, 256), (3, 37, 53), (2, 1, 5), (1, 4, 4), (5, 17, 19),
               (1, 512, 513), (1, 1536, 1280), (132, 64, 64), (133, 64, 64), (1, 1024, 1056),
               (1, 1024, 1057)]
_JET_CASES = [(s, f) for s in _JET_SHAPES for f in ("once", "wide")
              if f == "wide" or KOv.form_for(*s) == "once"]


def _jet_twice(heat, img01):
    before = KOv.jet_blend.launches
    got = KOv.jet_blend(heat, img01)
    assert KOv.jet_blend.launches == before + 1
    _eq(got, KOv.jet_blend_reference(heat, img01))
    _eq(got, KOv.jet_blend(heat, img01))


@pytest.mark.parametrize("case", ["random", "dark", "hot"])
@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("shape,form", _JET_CASES)
def test_jet_blend_kernel_forms(dev, rng, monkeypatch, shape, form, rgb, case):
    """Random heat and images, a dark image (the peak from the table alone)
    and all-255 heat, in both forms on both sides of the boundary."""
    monkeypatch.setattr(KOv, "form_for", lambda *shape: form)
    heat = rng.integers(0, 256, shape).astype(np.uint8)
    img = rng.integers(0, 256, shape + ((3,) if rgb else ())).astype(np.float32) / 255.0
    if case == "dark":
        img[:] = 0.0
    elif case == "hot":
        heat[:] = 255
    _jet_twice(torch.from_numpy(heat).to(dev), torch.from_numpy(img).to(dev))


@pytest.mark.parametrize("form", ["once", "wide"])
@pytest.mark.parametrize("offset", [1, 4])
@pytest.mark.parametrize("rgb", [False, True])
def test_jet_blend_kernel_unaligned_views(dev, rng, monkeypatch, form, offset, rgb):
    """Views that start `offset` elements past a 16-byte boundary take the
    same groups a scalar at a time."""
    monkeypatch.setattr(KOv, "form_for", lambda *shape: form)
    shape = (3, 37, 53) + ((3,) if rgb else ())
    n = int(np.prod(shape))
    heat = torch.from_numpy(rng.integers(0, 256, 3 * 37 * 53 + 16).astype(np.uint8)).to(dev)
    img = torch.rand(n + 16, device=dev)
    _jet_twice(heat[offset:offset + 3 * 37 * 53].view(3, 37, 53),
               img[offset:offset + n].view(shape))


def test_jet_blend_kernel_odd_values_and_refusal(dev, monkeypatch):
    """Image values off the exact quotient path (negative, tiny, above 2^40)
    take the general division, bit-exact; B=0 launches nothing; the
    one-launch form refuses a batch beyond one block of 512 threads an SM
    and counts no launch."""
    heat = torch.arange(4 * 16 * 16, device=dev).remainder(256).to(torch.uint8).view(4, 16, 16)
    img = torch.rand((4, 16, 16), device=dev)
    img[0, 3, 3] = -0.25
    img[1, 5, 5] = 2.0 ** -60
    img[2, 7, 7] = 2.0 ** 50
    img[3] = 2.0 ** -45
    for form in ("once", "wide"):
        monkeypatch.setattr(KOv, "form_for", lambda *shape, f=form: f)
        _jet_twice(heat, img)
        before = KOv.jet_blend.launches
        out = KOv.jet_blend(heat[:0], img[:0])
        assert out.shape == (0, 16, 16, 3) and KOv.jet_blend.launches == before
    monkeypatch.setattr(KOv, "form_for", lambda *shape: "once")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    big = torch.zeros((sms + 1, 16, 16), dtype=torch.uint8, device=dev)
    before = KOv.jet_blend.launches
    with pytest.raises(RuntimeError):
        KOv.jet_blend(big, torch.zeros((sms + 1, 16, 16), device=dev))
    assert KOv.jet_blend.launches == before


# ---- the packed marker watershed over tiles x images -------------------------

_PACKED_SIDES = [(1, 1), (31, 33), (32, 32), (33, 31), (63, 65), (200, 136), (511, 512),
                 (512, 512)]


def _packed_inputs(rng, b, h, w, n_values, case, dev):
    """Float images (a smooth field with noise up to 1000, half of the
    pixels at x.5) and markers of the first n_values of (255, 128, 64):
    discs and a band ("some"), every pixel a marker ("all") or none
    ("none")."""
    yy, xx = np.mgrid[0:h, 0:w]
    field = 500 + 500 * np.sin(xx / (3 + w / 9)) * np.cos(yy / (4 + h / 11))
    img = np.clip(field + rng.normal(0, 50, (b, h, w)), 0, 1000)
    img = (np.floor(img) + np.where(rng.random((b, h, w)) < 0.5, 0.5, 0.0)).astype(np.float32)
    values = (255, 128, 64)[:n_values]
    mk = np.zeros((b, h, w), np.int32)
    if case == "all":
        mk[:] = values[-1]
        mk[:, : h // 2] = values[0]
    elif case == "some":
        for i in range(b):
            for v in values:
                cy, cx = rng.integers(0, h), rng.integers(0, w)
                mk[i][(yy - cy) ** 2 + (xx - cx) ** 2 < (min(h, w) // 8 + 1) ** 2] = v
        mk[:, -1, : w // 3] = values[-1]
    return torch.from_numpy(img).to(dev), torch.from_numpy(mk).to(dev), values


def _packed_twice(img, mk, values, max_iters=256, max_scan=8):
    """One packed launch a call, bit-exact to the plain version at the
    same cap and scan window, the same bytes on a second run; returns the
    sweeps run."""
    before = KW.packed_form.launches
    got = KW.marker_watershed(img, mk, max_iters=max_iters, max_scan=max_scan,
                              marker_label_values=values)
    sweeps = torch.zeros(1, dtype=torch.int32, device=img.device)
    labels = torch.empty_like(mk)
    boundary = torch.empty(img.shape, dtype=torch.bool, device=img.device)
    KW.packed_form(img, mk, values, labels, boundary, max_iters, max_scan, sweeps=sweeps)
    assert KW.packed_form.launches == before + 2
    assert (max_iters == 0) <= (int(sweeps.item()) == 0) and int(sweeps.item()) <= max_iters
    plain = KW.marker_watershed_reference(img, mk, max_iters=max_iters, max_scan=max_scan,
                                          marker_label_values=values)
    for a, b, c in zip(got, plain, (labels, boundary)):
        _eq(a, b)
        _eq(a, c)
    return int(sweeps.item())


@pytest.mark.parametrize("n_values", [1, 2, 3])
@pytest.mark.parametrize("hw", _PACKED_SIDES)
@pytest.mark.parametrize("b", [1, 8, 16])
def test_packed_watershed_kernel(dev, rng, b, hw, n_values):
    _packed_twice(*_packed_inputs(rng, b, *hw, n_values, "some", dev))


@pytest.mark.parametrize("max_scan", [1, 2, 4, 8, 9, 256])
@pytest.mark.parametrize("max_iters", [0, 1, 2, 5, 256])
def test_packed_watershed_kernel_capped(dev, rng, max_iters, max_scan):
    """The cap and the scan window honoured: tiled sweeps up to max_scan 8,
    the line form beyond, at B=2 200x136 and B=1 512x512."""
    for b, h, w in ((2, 200, 136), (1, 512, 512)):
        n = _packed_twice(*_packed_inputs(rng, b, h, w, 3, "some", dev), max_iters, max_scan)
        assert n <= max_iters


@pytest.mark.parametrize("side", [128, 512])
def test_packed_watershed_kernel_serpentine(dev, side):
    """A serpentine corridor where JAX's 256-sweep cap binds: the kernel
    runs all 256 sweeps and stops with the plain version's labels."""
    img = np.full((side, side), 200, np.float32)
    img[::2] = 0
    for r in range(1, side, 2):
        img[r, side - 1 if (r // 2) % 2 == 0 else 0] = 0
    mk = np.zeros((side, side), np.int32)
    mk[0, 0], mk[1, 0] = 255, 128
    n = _packed_twice(torch.from_numpy(img)[None].to(dev), torch.from_numpy(mk)[None].to(dev),
                      (255, 128, 64))
    assert n == 256


@pytest.mark.parametrize("case", ["all", "none"])
@pytest.mark.parametrize("hw", _PACKED_SIDES)
@pytest.mark.parametrize("b", [1, 8, 16])
def test_packed_watershed_kernel_edge_markers(dev, rng, b, hw, case):
    """Markers that leave nothing unreached (one sweep), and no markers at
    all (the shift fill lowers unreached pixels, as in JAX)."""
    img, mk, values = _packed_inputs(rng, b, *hw, 3, case, dev)
    n = _packed_twice(img, mk, values)
    assert n == 1 or case == "none"


def test_packed_watershed_kernel_trace(dev, rng):
    """At B=1 512² the call launches no grid of one block an image and makes
    no synchronising runtime call: a prologue and an epilogue of 256 blocks
    and one cooperative launch."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    img, mk, values = _packed_inputs(rng, 1, 512, 512, 3, "some", dev)
    KW.marker_watershed(img, mk, max_scan=8, marker_label_values=values)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        KW.marker_watershed(img, mk, max_scan=8, marker_label_values=values)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    grids = [e["args"]["grid"] for e in events
             if e.get("cat") == "kernel" and "grid" in e.get("args", {})]
    syncs = [e["name"] for e in events if e.get("cat") == "cuda_runtime" and e.get("name") in (
        "cudaEventSynchronize", "cudaStreamSynchronize", "cudaMemcpy")]
    assert len(grids) == 3, grids
    assert all(g[0] * g[1] * g[2] > 1 for g in grids), grids
    assert not syncs, syncs


def test_packed_watershed_kernel_rejects_wrong_inputs(dev):
    img = torch.zeros((1, 8, 8), dtype=torch.float32, device=dev)
    mk = torch.zeros((1, 8, 8), dtype=torch.int32, device=dev)
    out = torch.empty_like(mk), torch.empty((1, 8, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        KW.packed_form(img, mk, (255,), *out, sweeps=torch.zeros(1, device=dev))
    with pytest.raises(RuntimeError):   # sides beyond 512: the C entry refuses
        big = torch.zeros((1, 513, 8), dtype=torch.float32, device=dev)
        KW.packed_form(big, big.to(torch.int32), (255,),
                       torch.empty((1, 513, 8), dtype=torch.int32, device=dev),
                       torch.empty((1, 513, 8), dtype=torch.bool, device=dev))
