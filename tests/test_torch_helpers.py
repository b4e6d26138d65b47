"""Port parity: the JAX package's last public helpers without a
counterpart of the same name until the parallel slice —
`ops/morphology.py::closing`, `ops/resize.py::resize_nearest`,
`ops/histogram.py::apply_lut256`, `ops/components.py::component_areas`
and `utils/tree.py::tree_size` / `tree_cast` — against JAX on the same
numpy inputs, bit-exact (integer and selection ops; the casts are the
same rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadx_tpu.models import cnn as JCNN
from cadx_tpu.ops import components as JC
from cadx_tpu.ops import histogram as JH
from cadx_tpu.ops import morphology as JM
from cadx_tpu.ops import resize as JR
from cadx_tpu.utils import tree as JTree
from cadx_tpu_torch import convert
from cadx_tpu_torch.ops import components as TC
from cadx_tpu_torch.ops import histogram as TH
from cadx_tpu_torch.ops import morphology as TM
from cadx_tpu_torch.ops import resize as TR
from cadx_tpu_torch.utils import tree as TTree


@pytest.mark.parametrize("ksize,iterations", [(3, 1), (5, 1), (4, 2), (1, 3)])
def test_closing_matches_jax(rng, ksize, iterations):
    imgs = (rng.random((3, 40, 29)) * 255).astype(np.uint8)
    ours = TM.closing(torch.from_numpy(imgs), ksize, iterations).numpy()
    for img, got in zip(imgs, ours):
        np.testing.assert_array_equal(
            got, np.asarray(JM.closing(jnp.asarray(img), ksize, iterations)))
    # tests/test_fuzz_ops.py's algebra, for its centred (odd) elements:
    # idempotent, img <= close
    if ksize % 2:
        again = TM.closing(torch.from_numpy(ours), ksize, iterations).numpy()
        np.testing.assert_array_equal(again, ours)
        assert (ours >= imgs).all()


@pytest.mark.parametrize("in_hw,out_hw", [((37, 29), (16, 16)), ((16, 16), (37, 29)),
                                          ((512, 512), (33, 7)), ((6, 9), (6, 4))])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_nearest_matches_jax(rng, in_hw, out_hw, channels):
    shape = (2,) + in_hw + ((channels,) if channels else ())
    imgs = rng.integers(0, 65535, shape).astype(np.uint16)
    ours = TR.resize_nearest(torch.from_numpy(imgs), out_hw)
    assert ours.dtype == torch.uint16
    for img, got in zip(imgs, ours.numpy()):
        np.testing.assert_array_equal(got, np.asarray(JR.resize_nearest(jnp.asarray(img),
                                                                        out_hw)))


@pytest.mark.parametrize("lut_dtype", [np.uint8, np.float32])
def test_apply_lut256_matches_jax(rng, lut_dtype):
    imgs = rng.integers(0, 256, (3, 33, 20)).astype(np.uint8)
    if lut_dtype == np.uint8:
        luts = rng.integers(0, 256, (3, 256)).astype(np.uint8)
    else:                                       # halves: JAX's round to even
        luts = (rng.integers(0, 512, (3, 256)) / 2.0).astype(np.float32)
    ours = TH.apply_lut256(torch.from_numpy(imgs), torch.from_numpy(luts)).numpy()
    shared = TH.apply_lut256(torch.from_numpy(imgs), torch.from_numpy(luts[0])).numpy()
    for i, img in enumerate(imgs):
        ref = np.asarray(JH.apply_lut256(jnp.asarray(img), jnp.asarray(luts[i])))
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours[i], ref)
        np.testing.assert_array_equal(
            shared[i], np.asarray(JH.apply_lut256(jnp.asarray(img), jnp.asarray(luts[0]))))


def test_component_areas_matches_jax(rng):
    masks = rng.random((3, 24, 31)) > 0.55
    masks[2] = False                            # an empty mask
    for m in masks:
        labels = JC.label_components(jnp.asarray(m), 8)
        ref = np.asarray(JC.component_areas(labels, jnp.asarray(m)))
        ours = TC.component_areas(torch.from_numpy(np.array(labels))[None],
                                  torch.from_numpy(m)[None])[0].numpy()
        assert ours.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(ours, ref)
        assert ours.sum() == m.sum()


def test_tree_size_and_cast_match_jax():
    cfg = dict(input_shape=(10, 10, 3), num_classes=3, conv_layers=[(6, 3), (5, 3)],
               hidden_units=[12, 8], dropout_rate=0.0, leaky_alpha=0.01)
    jcfg = JCNN.CNNConfig.from_json_dict(cfg)
    jp = jax.tree_util.tree_map(np.asarray, JCNN.init_params(jax.random.key(0), jcfg))
    model = convert.convert_classifier(jp, convert.convert_cnn_config(jcfg))
    assert TTree.tree_size(model) == JTree.tree_size(jp)
    tree = {"a": [np.ones((2, 3), np.float32), (np.zeros(4, np.float32),)],
            "b": np.arange(5, dtype=np.float32) / 3}
    assert TTree.tree_size(tree) == JTree.tree_size(tree) == 15
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)):
        ref = jax.tree_util.tree_leaves(JTree.tree_cast(tree, jdtype))
        ours = TTree.tree_cast(tree, dtype)
        flat = [ours["a"][0], ours["a"][1][0], ours["b"]]
        assert isinstance(ours["a"][1], tuple)
        for a, b in zip(flat, ref, strict=True):
            assert a.dtype == dtype
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
        cast = TTree.tree_cast(model, dtype)
        assert [c.dtype for c in cast] == [dtype] * len(list(model.parameters()))
