"""Parity of the port's ResNet pyramid backbone with the JAX package (f32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx
import torch

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu_torch import Backbone
from sihl_tpu_torch.layers.convblocks import BatchNorm2d

from torch_parity import load_from_jax, randomize_norms, to_numpy, to_torch


def _assert_pyramid_matches_jax(name: str) -> None:
    rng = np.random.RandomState(0)
    jax_bb = JaxBackbone(name, rngs=nnx.Rngs(0))
    randomize_norms(jax_bb, rng)
    jax_bb.eval()
    bb = load_from_jax(Backbone(name), jax_bb)
    assert bb.out_channels == jax_bb.out_channels
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    want = jax_bb(jnp.asarray(x))
    with torch.no_grad():
        got = bb(to_torch(x))
    assert len(got) == len(want) == 6
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.shape[2:] == (64 >> level, 64 >> level)
        np.testing.assert_allclose(to_numpy(g, nhwc=True), np.asarray(w), rtol=1e-3, atol=1e-4)


def test_resnet26_pyramid_matches_jax():
    """resnet26 runs resnet50's Bottleneck code at half the depth."""
    _assert_pyramid_matches_jax("resnet26")


def test_resnet18_pyramid_matches_jax():
    """resnet18, the examples' default backbone, runs the BasicBlock code."""
    _assert_pyramid_matches_jax("resnet18")


def test_backbone_refusals():
    with pytest.raises(ValueError, match="not supported"):
        Backbone("resnet0")
    with pytest.raises(NotImplementedError, match="pretrained"):
        Backbone("resnet18", pretrained=True)
    with pytest.raises(ValueError, match="top_level"):
        Backbone("resnet18", top_level=0)
    with pytest.raises(ValueError, match="divisible"):
        Backbone("resnet18").eval()(torch.zeros(1, 3, 48, 40))


@pytest.mark.parametrize("frozen_levels", [0, 1, 3, -1])
def test_frozen_levels_match_jax(frozen_levels):
    """Frozen attribute names, the parameter test and the stop-gradient cut
    agree with the JAX package; with ``freeze_batchnorms`` the frozen
    levels' BatchNorms use their running statistics."""
    jax_bb = JaxBackbone("resnet18", freeze_batchnorms=True, rngs=nnx.Rngs(0))
    jax_bb.set_frozen_levels(frozen_levels)
    bb = Backbone("resnet18", freeze_batchnorms=True)
    bb.set_frozen_levels(frozen_levels)
    assert bb.frozen_attr_names() == jax_bb.frozen_attr_names()
    assert bb.features._sg_levels == jax_bb.features._sg_levels
    for name, _ in bb.features.named_parameters():
        path = name.split(".")
        assert bb.is_frozen_param(path) == jax_bb.is_frozen_param(path), name
    bb.train()
    bb._set_frozen_bn_eval()
    frozen = set(bb.frozen_attr_names())
    for name, module in bb.features.named_modules():
        if isinstance(module, BatchNorm2d):
            assert module.training == (name.split(".")[0] not in frozen), name
    levels = bb(torch.rand(1, 3, 64, 64))[1:]
    cut = bb.features._sg_levels
    assert [f.requires_grad for f in levels] == [level > cut for level in range(1, 6)]
