"""Parity of the port's ResNet pyramid backbone with the JAX package (f32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx
import torch

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu_torch import Backbone

from torch_parity import load_from_jax, randomize_norms, to_numpy, to_torch


def test_resnet26_pyramid_matches_jax():
    """resnet26 runs resnet50's Bottleneck code at half the depth."""
    rng = np.random.RandomState(0)
    jax_bb = JaxBackbone("resnet26", rngs=nnx.Rngs(0))
    randomize_norms(jax_bb, rng)
    jax_bb.eval()
    bb = load_from_jax(Backbone("resnet26"), jax_bb)
    assert bb.out_channels == jax_bb.out_channels
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    want = jax_bb(jnp.asarray(x))
    with torch.no_grad():
        got = bb(to_torch(x))
    assert len(got) == len(want) == 6
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.shape[2:] == (64 >> level, 64 >> level)
        np.testing.assert_allclose(to_numpy(g, nhwc=True), np.asarray(w), rtol=1e-3, atol=1e-4)


def test_backbone_refusals():
    with pytest.raises(ValueError, match="not supported"):
        Backbone("resnet0")
    with pytest.raises(NotImplementedError, match="pretrained"):
        Backbone("resnet18", pretrained=True)
    with pytest.raises(NotImplementedError, match="AntialiasedDownscaler"):
        Backbone("resnet18", top_level=6)
    with pytest.raises(ValueError, match="divisible"):
        Backbone("resnet18").eval()(torch.zeros(1, 3, 48, 40))
