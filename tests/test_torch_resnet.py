"""Port parity: the resnets (`models/resnet.py`, the resnet34 encoder of
`models/unet.py`), their state-dict import and conversion, and the
batchnorm kernel's plain version, against the JAX package on the CPU.

Weights come from the torchvision-layout oracles of `test_resnet.py`
(seeded, batch-norm statistics randomised) through `torch.save`, or from
JAX's own init through `convert`. Inputs are seeded numpy arrays.
Tolerances: stage features and logits 1e-4 (float32 convolutions on two
backends, JAX's own oracle tolerance); the batch norm 1e-5 against JAX's
rsqrt form (tests/test_kernels.py); the stem max pool, key detection and
loaded weights exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.kernels import nn_kernels as nk
from cadx_tpu.models import resnet as JR
from cadx_tpu.models import unet as JU
from cadx_tpu_torch import convert
from cadx_tpu_torch.kernels import batchnorm as KBN
from cadx_tpu_torch.models import resnet as TR
from cadx_tpu_torch.models import unet as TU
from test_resnet import _torch_resnet

_ATOL = 1e-4

# (block, layers, widths, in_channels, num_classes, input side)
_NETS = [("bottleneck", (2, 2, 2, 2), (16, 32, 64, 128), 3, 10, 64),
         ("bottleneck", (1, 1, 1, 1), (8, 8, 8, 8), 3, 5, 96),
         ("basic", (2, 2, 2, 2), (64, 96, 128, 128), 1, None, 64),
         ("basic", (1, 1, 1, 1), (8, 16, 8, 16), 1, 4, 64)]


def _net(block, layers, widths, in_channels, num_classes, seed=0):
    return _torch_resnet(torch, block, layers=layers, widths=widths,
                         in_channels=in_channels, num_classes=num_classes, seed=seed)


def _close(a, b, atol=_ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("block,layers,widths,cin,ncls,side", _NETS)
def test_stage_features_and_forward_match_jax(block, layers, widths, cin, ncls, side):
    sd = _net(block, layers, widths, cin, ncls).state_dict()
    jcfg, jparams = JR.params_from_state_dict(sd)
    tcfg, model = TR.params_from_state_dict(sd)
    assert dataclasses.astuple(tcfg) == dataclasses.astuple(jcfg)
    x = np.random.default_rng(0).standard_normal((2, side, side, cin)).astype(np.float32)
    ours = TR.stage_features(model, torch.from_numpy(x))
    ref = JR.stage_features(jparams, jnp.asarray(x), jcfg)
    assert len(ours) == len(ref) == 8
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == r.shape
        _close(o.numpy(), r)
    if ncls is not None:
        _close(TR.forward(model, torch.from_numpy(x)).numpy(),
               JR.forward(jparams, jnp.asarray(x), jcfg))


def test_detect_config_and_strip_prefix_match_jax():
    sds = [_net(*n[:5]).state_dict() for n in _NETS]
    smp = {f"encoder.{k}": v for k, v in sds[2].items()}
    smp["decoder.blocks.0.conv1.0.weight"] = torch.zeros(1)
    for sd in sds + [smp]:
        stripped = TR.strip_prefix(sd)
        assert list(stripped) == list(JR.strip_prefix(sd))
        assert (dataclasses.astuple(TR.detect_config(stripped))
                == dataclasses.astuple(JR.detect_config(stripped)))
    assert TR.strip_prefix(smp, "decoder.") == {"blocks.0.conv1.0.weight": smp[
        "decoder.blocks.0.conv1.0.weight"]}
    cfg = TR.detect_config(TR.strip_prefix(smp))
    assert cfg.block == "basic" and cfg.in_channels == 1 and cfg.num_classes is None


def test_pth_round_trip(tmp_path):
    """torch.save -> the port's loader gives the saved weights bit for bit;
    the port's state dict saved again loads into JAX as the same network."""
    net = _net("bottleneck", (1, 2, 1, 1), (8, 16, 8, 16), 3, 7, seed=2)
    path = str(tmp_path / "r.pth")
    torch.save({"state_dict": net.state_dict()}, path)
    cfg, model = TR.encoder_params_from_state_dict(path)
    assert cfg.layers == (1, 2, 1, 1) and cfg.num_classes == 7
    ours = model.state_dict()
    for k, v in net.state_dict().items():
        assert torch.equal(ours[k], v), k
    back = str(tmp_path / "back.pth")
    torch.save(ours, back)
    jcfg, jparams = JR.encoder_params_from_state_dict(back)
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 3)).astype(np.float32)
    _close(TR.forward(model, torch.from_numpy(x)).numpy(),
           JR.forward(jparams, jnp.asarray(x), jcfg))
    # an encoder-only import keeps no head; a missing layer is an error
    sd = {k: v for k, v in net.state_dict().items() if not k.startswith("fc.")}
    assert TR.params_from_state_dict(sd)[1].fc is None
    del sd["layer2.1.conv2.weight"]
    with pytest.raises(KeyError):
        TR.params_from_state_dict(sd, cfg)


def test_init_resnet50_shapes():
    model = TR.init_resnet(torch.Generator().manual_seed(0), TR.RESNET50_CLASSIFIER)
    assert tuple(model.layer1[0].conv3.weight.shape) == (256, 64, 1, 1)
    assert tuple(model.fc.weight.shape) == (1000, 2048)
    bns = [m for m in model.modules() if isinstance(m, TU.BatchNorm)]
    assert len(bns) == 53
    assert set(model.state_dict()) == set(_net("bottleneck", (3, 4, 6, 3), (64, 128, 256, 512),
                                               3, 1000).state_dict())
    before = KBN.batchnorm.launches
    logits = TR.forward(model, torch.zeros((1, 64, 64, 3)))
    assert logits.shape == (1, 1000) and bool(torch.isfinite(logits).all())
    assert KBN.batchnorm.launches == before          # CPU tensors: the plain version
    # the same seed gives the same weights
    again = TR.init_resnet(torch.Generator().manual_seed(0), TR.RESNET50_CLASSIFIER)
    assert torch.equal(again.layer4[2].conv2.weight, model.layer4[2].conv2.weight)


def test_convert_resnet_params_and_encoder_match_jax():
    cfg = dataclasses.replace(JR.RESNET50, layers=(1, 1, 1, 1), widths=(8, 8, 16, 16),
                              num_classes=3)
    params = JR.init_resnet(jax.random.key(0), cfg)
    model = convert.convert_resnet_params(jax.tree_util.tree_map(np.asarray, params), cfg)
    assert model.config == TR.ResNetConfig("bottleneck", (1, 1, 1, 1), (8, 8, 16, 16), 3, 3)
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    _close(TR.forward(model, torch.from_numpy(x)).numpy(),
           JR.forward(params, jnp.asarray(x), cfg))

    enc = JU.init_resnet_encoder(jax.random.key(1), layers=(2, 1, 1, 1), widths=(8, 16, 16, 8))
    ours = convert.convert_resnet_encoder(jax.tree_util.tree_map(np.asarray, enc))
    assert ours.config.block == "basic" and ours.config.in_channels == 1
    xe = np.random.default_rng(3).standard_normal((1, 64, 64, 1)).astype(np.float32)
    for o, r in zip(TU.resnet_encoder_features(ours, torch.from_numpy(xe)),
                    JU.resnet_encoder_features(enc, jnp.asarray(xe))):
        _close(o.numpy(), r)
    # the port's own encoder init has the JAX encoder's structure
    mine = TU.init_resnet_encoder(torch.Generator().manual_seed(0), layers=(2, 1, 1, 1),
                                  widths=(8, 16, 16, 8))
    assert set(mine.state_dict()) == set(convert._resnet_state_dict(enc)) | {
        k for k in mine.state_dict() if k.endswith("num_batches_tracked")}


def _bn_case(rng, c):
    p = {k: (rng.standard_normal(c) * 0.3 + (1 if k in ("scale", "var") else 0)).astype(np.float32)
         for k in ("scale", "bias", "mean", "var")}
    p["var"] = np.abs(p["var"]) + 0.5
    return p


@pytest.mark.parametrize("shape", [(2, 12, 12, 8), (1, 7, 5, 3), (3, 16, 16, 64)])
def test_batchnorm_plain_matches_pallas_and_bn_apply(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    p = _bn_case(rng, shape[-1])
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    pallas = np.asarray(nk.batchnorm_pallas(jnp.asarray(x), jp["scale"], jp["bias"],
                                            jp["mean"], jp["var"], interpret=True))
    ref = np.asarray(JU._bn_apply(jp, jnp.asarray(x)))
    bn = TU.BatchNorm(shape[-1])
    with torch.no_grad():
        for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, ours).copy_(torch.from_numpy(p[theirs]))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    before = KBN.batchnorm.launches
    ours = TU.bn_apply(bn, xt).detach().permute(0, 2, 3, 1).numpy()
    plain = KBN.batchnorm_reference(xt, *(torch.from_numpy(p[k]) for k in
                                          ("scale", "bias", "mean", "var")))
    assert KBN.batchnorm.launches == before
    assert np.array_equal(ours, plain.permute(0, 2, 3, 1).numpy())
    _close(ours, pallas, 1e-5)
    _close(ours, ref, 1e-5)


def test_max_pool_plain_matches_jax(rng):
    x = rng.standard_normal((2, 13, 10, 4)).astype(np.float32)
    ours = TU.max_pool_plain(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                             3, 2, pad=1)
    ref = np.asarray(JU._max_pool_plain(jnp.asarray(x), 3, 2, pad=1))
    assert np.array_equal(ours.permute(0, 2, 3, 1).numpy(), ref)
