"""Adam's fused update (`kernels/adam.py`, `csrc/adam.cu`) against its plain
version.

The CPU tests hold the plain version to a numpy float32 model of the
kernel's arithmetic, operation for operation, and check that CPU tensors
never reach the kernel. The card tests (marker `cuda`) skip without a
CUDA device; on the GPU machine:

    CADX_TEST_TPU=1 python -m pytest tests/test_torch_adam.py -q

They hold the kernel bit-exact to the plain version on the card, at the
advanced classifier's parameter shapes and at sizes and offsets that take
the kernel's head, tail and scalar paths, and run every trainer that
steps Adam on the card through it.
"""

import copy

import numpy as np
import pytest
import torch

from cadx_tpu_torch.kernels import _build
from cadx_tpu_torch.kernels import adam as KA
from cadx_tpu_torch.models import cnn as TCNN
from cadx_tpu_torch.train import optim as TOpt
from cadx_tpu_torch.train import step as TS
from cadx_tpu_torch.utils import profiling as TProf

ADVANCED = TCNN.CNNConfig(
    input_shape=(256, 256, 64), num_classes=2, conv_layers=((32, 3), (64, 3)),
    hidden_units=(256, 128), dropout_rate=0.1, conv_padding="SAME")
SMALL = TCNN.CNNConfig(input_shape=(16, 16, 8), num_classes=2, conv_layers=((12, 3),),
                       hidden_units=(16,), dropout_rate=0.1)
HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def cpu_sqrt(a):
    """torch's float32 square root on the CPU: its vectorised form is not
    always correctly rounded (the card's, and the kernel's `__fsqrt_rn`,
    are), so the model takes the plain version's own."""
    return torch.sqrt(torch.from_numpy(a)).numpy()


def kernel_arithmetic(p, g, mu, nu, step, lr, b1, b2, eps):
    """`csrc/adam.cu::update` in numpy float32, one rounding an operation."""
    f = np.float32
    mu = mu * f(b1) + f(1 - b1) * g
    nu = nu * f(b2) + f(1 - b2) * (g * g)
    mu_hat = mu / f(KA.bias_correction(b1, step))
    nu_hat = nu / f(KA.bias_correction(b2, step))
    return p + f(-lr) * (mu_hat / (cpu_sqrt(nu_hat) + f(eps))), mu, nu


def _moments(rng, shape, start):
    if start == 0:
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    return ((rng.standard_normal(shape) * 1e-3).astype(np.float32),
            (rng.standard_normal(shape) ** 2 * 1e-5).astype(np.float32))


@pytest.mark.parametrize("start", [0, 999])
def test_plain_update_is_the_kernels_arithmetic(rng, start):
    """Five steps from step `start`: the plain version on CPU tensors
    equals the kernel's arithmetic in numpy float32, bit for bit, over
    gradients from 1e-30 to 1e3 and exact zeros."""
    shapes = [(7, 5), (1,), (1021,)]
    p = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in shapes]
    mu, nu = zip(*(_moments(rng, s, start) for s in shapes))
    mu, nu = list(mu), list(nu)
    tp, tm, tn = ([torch.from_numpy(a.copy()) for a in arrs] for arrs in (p, mu, nu))
    for k in range(5):
        grads = []
        for s in shapes:
            g = rng.standard_normal(s) * 10.0 ** rng.integers(-30, 4, s)
            g[rng.random(s) < 0.1] = 0.0
            grads.append(g.astype(np.float32))
        KA.adam_update_reference(tp, [torch.from_numpy(g) for g in grads], tm, tn,
                                 start + k + 1, **HYPER)
        for i, g in enumerate(grads):
            p[i], mu[i], nu[i] = kernel_arithmetic(p[i], g, mu[i], nu[i], start + k + 1,
                                                   **HYPER)
            for a, t in ((p[i], tp[i]), (mu[i], tm[i]), (nu[i], tn[i])):
                np.testing.assert_array_equal(t.numpy(), a)


def test_bias_correction_in_float32():
    assert KA.bias_correction(0.9, 1) == float(np.float32(1) - np.float32(0.9))
    assert KA.bias_correction(0.999, 1000) == float(
        np.float32(1) - np.float32(0.999) ** np.float32(1000))
    assert np.float32(KA.bias_correction(0.999, 1000)) == KA.bias_correction(0.999, 1000)


def test_cpu_step_stays_plain(rng, monkeypatch):
    """Adam.step on CPU tensors takes the plain version: no library is
    loaded, nothing launches and nothing is counted as fused."""
    def no_library():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", no_library)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in
              [(4, 3), (9,)]]
    want = [p.clone() for p in params]
    grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
             for p in params]
    tx = TOpt.adam(1e-3)
    launches, fused = KA.adam_update.launches, TProf.counts().get("adam_fused_leaves", 0)
    state = tx.step(params, grads, tx.init(params))
    ref = tx.init(want)
    KA.adam_update_reference(want, grads, ref.mu, ref.nu, 1, **HYPER)
    assert state.count == 1
    for a, b in zip(params + state.mu + state.nu, want + ref.mu + ref.nu):
        assert torch.equal(a, b)
    assert KA.adam_update.launches == launches
    assert TProf.counts().get("adam_fused_leaves", 0) == fused


def test_the_kernel_is_built_with_the_library():
    assert "adam.cu" in {p.name for p in _build._sources()}
    assert len(_build._SIGNATURES["cadx_adam_step"]) == 16


# --------------------------------------------------------------- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _build.load()
    return torch.device("cuda", 0)


def _card_leaves(dev, gen, shapes, start):
    """Parameters and moments on the card for each shape, then two leaves
    of 10,007 elements at offsets off 16-byte alignment: one whose four
    tensors share their offset (the vector body after a 3-element head),
    one whose gradient alone is off (the scalar path). Returns (params,
    mu, nu, grad_fn); grad_fn() gives a step's gradients, the odd leaves'
    as views at their offsets, a 4-D one channels_last and a 2-D one
    transposed, as autograd hands them on the card."""
    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def moments(shape):
        if start == 0:
            return torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)
        return randn(shape, 1e-3), randn(shape, 1.0) ** 2 * 1e-5

    n = 10_007
    shapes = list(shapes)
    params = [randn(s, 0.05) for s in shapes]
    mu, nu = map(list, zip(*(moments(s) for s in shapes)))
    # shared offset: every tensor a view one element into its buffer
    params.append(randn(n + 1, 0.05)[1:])
    m, v = moments(n + 1)
    mu.append(m[1:])
    nu.append(v[1:])
    # aligned parameter and moments, the gradient three elements in
    params.append(randn(n, 0.05))
    m, v = moments(n)
    mu.append(m)
    nu.append(v)

    def grad_fn():
        grads = [randn(s, 1e-2) for s in shapes]
        for i, s in enumerate(shapes):
            if len(s) == 4:
                grads[i] = grads[i].contiguous(memory_format=torch.channels_last)
            elif len(s) == 2:
                grads[i] = randn(s[::-1], 1e-2).t()
        grads.append(randn(n + 1, 1e-2)[1:])
        grads.append(randn(n + 3, 1e-2)[3:])
        return grads

    return params, mu, nu, grad_fn


def _fused_against_plain(dev, shapes, start, launches_a_step):
    gen = torch.Generator(device=dev).manual_seed(3 + start)
    params, mu, nu, grad_fn = _card_leaves(dev, gen, shapes, start)
    assert params[-2].data_ptr() % 16 == 4 and params[-1].data_ptr() % 16 == 0
    plain = [[t.clone() for t in ts] for ts in (params, mu, nu)]
    tx = TOpt.Adam(**HYPER)
    state = TOpt.AdamState(start, mu, nu)
    for k in range(5):
        grads = grad_fn()
        launches = KA.adam_update.launches
        fused = TProf.counts().get("adam_fused_leaves", 0)
        versions = [t._version for t in params + state.mu + state.nu]
        state = tx.step(params, grads, state)
        KA.adam_update_reference(plain[0], grads, plain[1], plain[2], start + k + 1, **HYPER)
        torch.cuda.synchronize()
        assert state.count == start + k + 1
        # written in place as PyTorch's own in-place ops write: every
        # parameter's and moment's version counter moved
        assert all(t._version > v for t, v in zip(params + state.mu + state.nu, versions))
        assert KA.adam_update.launches == launches + launches_a_step
        assert TProf.counts()["adam_fused_leaves"] == fused + len(params)
        for got, want in zip(params + state.mu + state.nu, plain[0] + plain[1] + plain[2]):
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 999])
def test_fused_step_bit_exact_at_the_advanced_leaves(dev, start):
    """Five steps from count `start` (the first step's count 1 or 1000) at
    the advanced classifier's ten leaves (67,179,234 parameters) and leaves
    of 1, 3, 5 and 1021 elements: one launch a step, p, mu and nu equal to
    the plain version's bit for bit."""
    shapes = [tuple(p.shape) for p in
              TCNN.init_params(torch.Generator().manual_seed(0), ADVANCED).parameters()]
    assert sum(int(np.prod(s)) for s in shapes) == 67_179_234
    _fused_against_plain(dev, shapes + [(1,), (3,), (5,), (1021,)], start, 1)


@pytest.mark.cuda
def test_fused_step_chunks_many_leaves(dev):
    """142 leaves of 0-300 elements: three launches a step (64 leaves a
    launch, the four empty ones skipped), bit-exact."""
    shapes = [(i * 7 % 301,) for i in range(140)]
    assert shapes.count((0,)) == 4
    _fused_against_plain(dev, shapes, 999, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64 parameter", "float64 gradient",
                                 "transposed parameter", "gradient of another shape"])
def test_fused_step_raises_on_what_it_does_not_take(dev, bad):
    """A float64 leaf, a parameter (and so its moments) not contiguous, a
    gradient of another shape: a ValueError and no launch."""
    p, g = torch.zeros((6, 4), device=dev), torch.ones((6, 4), device=dev)
    if bad == "float64 parameter":
        p = p.double()
    elif bad == "float64 gradient":
        g = g.double()
    elif bad == "transposed parameter":
        p = torch.zeros((4, 6), device=dev).t()
    else:
        g = g.reshape(24)
    tx = TOpt.adam(1e-3)
    launches = KA.adam_update.launches
    with pytest.raises(ValueError, match="adam_update"):
        tx.step([p], [g], tx.init([p]))
    assert KA.adam_update.launches == launches


@pytest.mark.cuda
def test_fused_step_is_seen_by_autograd(dev):
    """A graph that saved a parameter before the fused step refuses to run
    backward after it, as after PyTorch's own in-place update."""
    p = torch.randn((4, 5), device=dev).requires_grad_()
    loss = (p * p).sum()
    tx = TOpt.adam(1e-3)
    launches = KA.adam_update.launches
    tx.step([p], [torch.ones_like(p)], tx.init([p]))
    assert KA.adam_update.launches == launches + 1
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        loss.backward()


@pytest.mark.cuda
def test_dp_eval_serves_the_weights_after_a_fused_step(dev, rng):
    """make_dp_eval on a mesh of the card and the CPU keeps a copy of the
    model on the CPU, made again when the parameters' version counters
    move. After a fused Adam step on the card, the CPU's rows are
    predicted by the weights after the step, not by the stale copy."""
    from cadx_tpu_torch.parallel import data_parallel as DP
    from cadx_tpu_torch.parallel import mesh as M

    model = TCNN.init_params(torch.Generator().manual_seed(0), SMALL, device=dev)
    mesh = M.make_mesh(devices=[dev, torch.device("cpu")])
    predict = DP.make_dp_eval(SMALL, mesh)
    x = torch.from_numpy(rng.standard_normal((64, 16, 16, 8)).astype(np.float32)).to(dev)
    rows = M.row_slices(64, mesh.axis(M.DATA_AXIS))[1]

    def on_cpu():
        return TS.eval_step(copy.deepcopy(model).to("cpu"), x[rows].cpu())

    before = predict(model, x)[rows].cpu()
    assert torch.equal(before, on_cpu())
    params = list(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = [torch.randn(p.shape, generator=gen, device=dev) for p in params]
    tx = TOpt.adam(0.05)
    launches = KA.adam_update.launches
    tx.step(params, grads, tx.init(params))
    assert KA.adam_update.launches == launches + 1
    want = on_cpu()
    assert not torch.equal(want, before), "the step should move the CPU's predictions"
    assert torch.equal(predict(model, x)[rows].cpu(), want)


@pytest.mark.cuda
def test_adam_train_step_launches_once_a_step(dev, rng):
    """make_adam_train_step on the card: one Adam launch a step, its
    leaves counted inside `train.step`, and no host sync."""
    model = TCNN.init_params(torch.Generator().manual_seed(0), SMALL, device=dev)
    tx = TOpt.adam(1e-3)
    step = TS.make_adam_train_step(tx)
    state = tx.init(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.from_numpy(rng.standard_normal((8, 16, 16, 8)).astype(np.float32)).to(dev)
    y = torch.eye(2, device=dev)[torch.from_numpy(rng.integers(0, 2, 8)).to(dev)]
    mask = torch.ones(8, device=dev)
    leaves = len(list(model.parameters()))
    launches, syncs = KA.adam_update.launches, TProf.counts().get("host_syncs", 0)
    for _ in range(3):
        state, _ = step(model, state, x, y, mask, gen)
    torch.cuda.synchronize()
    assert KA.adam_update.launches == launches + 3
    assert TProf.counts().get("host_syncs", 0) == syncs
    TProf.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        state, _ = step(model, state, x, y, mask, gen)
    assert TProf.span_stats()["train.step"]["counts"]["adam_fused_leaves"] == leaves


def _blobs(rng, n=8, hw=32):
    X = rng.random((n, hw, hw, 1)).astype(np.float32) * 0.3
    Y = (X > 0.25).astype(np.float32)
    return X + 0.5 * Y, Y


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fit", "fit bf16", "segmentation", "compat",
                                  "data_parallel"])
def test_every_adam_trainer_takes_the_kernel_on_the_card(dev, rng, path):
    """Each trainer that steps Adam hands the kernel contiguous float32
    leaves on the card: it runs, launches, and ends finite."""
    launches = KA.adam_update.launches
    if path.startswith("fit"):
        model = TCNN.init_params(torch.Generator().manual_seed(0), SMALL)
        X = rng.standard_normal((20, 16, 16, 8)).astype(np.float32)
        labels = rng.integers(0, 2, 20)
        res = TS.fit(model, X, np.eye(2)[labels], X[:6], labels[:6], epochs=1, batch_size=8,
                     optimizer="adam", lr=1e-3, device=dev,
                     compute_dtype=torch.bfloat16 if path == "fit bf16" else None)
        assert KA.adam_update.launches == launches + 3
        params = list(res.model.parameters())
    elif path == "segmentation":
        from cadx_tpu_torch.models import unet as TU
        from cadx_tpu_torch.train import segmentation as TSeg

        X, Y = _blobs(rng)
        res = TSeg.fit_segmentation(TU.init_unet(torch.Generator().manual_seed(0),
                                                 TU.UNetConfig(features=(8, 16))),
                                    X, Y, X[:4], Y[:4], epochs=1, batch_size=4, device=dev)
        assert KA.adam_update.launches == launches + 2
        params = list(res.model.parameters())
    elif path == "compat":
        from cadx_tpu_torch.compat.classes import TinyUNetModel

        X, _ = _blobs(rng)
        model = TinyUNetModel((32, 32, 1), device=dev)
        model.fit(X, epochs=1, batch_size=4)
        assert KA.adam_update.launches == launches + 2
        params = list(model.params.parameters())
    else:
        from cadx_tpu_torch.parallel import data_parallel as DP
        from cadx_tpu_torch.parallel import mesh as M

        model = TCNN.init_params(torch.Generator().manual_seed(0), SMALL, device=dev)
        update, init = DP.make_dp_adam_update(SMALL, M.make_mesh(devices=[dev, dev]), 1e-3)
        state = init(model.parameters())
        X = torch.from_numpy(rng.standard_normal((8, 16, 16, 8)).astype(np.float32)).to(dev)
        Y = torch.eye(2, device=dev)[torch.from_numpy(rng.integers(0, 2, 8)).to(dev)]
        single = copy.deepcopy(model)
        for _ in range(2):
            state, _ = update(model, state, X, Y, torch.ones(8, device=dev), 1e-3,
                              torch.Generator(device=dev).manual_seed(0))
        # two replicas a step, each one launch
        assert KA.adam_update.launches == launches + 4
        params = list(model.parameters())
        assert any(not torch.equal(a, b) for a, b in zip(params, single.parameters()))
    torch.cuda.synchronize()
    assert all(p.device.type == "cuda" and bool(torch.isfinite(p).all()) for p in params)
