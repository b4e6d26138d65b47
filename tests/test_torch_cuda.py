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

from cadx_tpu_torch.synthetic import synthetic_native_mammogram  # noqa: E402


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


def test_seeded_component_kernel_rejects_wrong_inputs(dev):
    before = KL.largest_component_seeded.launches
    for bad in (torch.zeros((1, 8, 8), dtype=torch.uint8, device=dev),
                torch.zeros((8, 8), dtype=torch.bool, device=dev)):
        with pytest.raises(ValueError):
            KL.largest_component_seeded(bad)
    with pytest.raises(ValueError):
        KL.largest_component_seeded(torch.zeros((1, 8, 8), dtype=torch.bool, device=dev), 6)
    assert KL.largest_component_seeded.launches == before
