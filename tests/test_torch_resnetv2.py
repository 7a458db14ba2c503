"""The port's pre-activation ResNetV2 trunks against the JAX package's (CPU).

``resnetv2_50`` and ``resnetv2_101`` build with the JAX package's
parameters, name for name and shape for shape (``state_dict_from_flat``
carries the V2 keys: ``norm1..3``, the plain ``conv1..3``, the bare-conv
``downsample``, ``final_norm``), and ``resnetv2_50``'s pyramid in eval mode
agrees with JAX's f32 forward to relative L2 1e-5 at every level.
``tests/test_torch_resnetv2_step.py`` holds a training step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu_torch import Backbone, TimmBackbone
from sihl_tpu_torch.backbones.resnet import PreactBottleneck, ResNetV2Features
from sihl_tpu_torch.convert import state_dict_from_flat

from torch_parity import load_from_jax, randomize_norms, to_numpy, to_torch

SIZE = 64


def damp_preact_branches(model, rng: np.random.RandomState) -> None:
    """Scale the last conv of every pre-activation branch (``conv3``) by
    U(0.01, 0.03), so that each block starts near the identity, as timm's
    ``zero_init_last`` starts it at the identity: at full scale the f32
    gradients of the first blocks' norms lose most of their digits in the
    residual stream (the port's f32 step read 2.8e-2 from JAX's f64 step on
    ``layer1.blocks.0.norm1``)."""
    for path, sub in nnx.iter_graph(model):
        if isinstance(sub, nnx.Conv) and path[-1] == "conv3":
            sub.kernel[...] = sub.kernel[...] * jnp.asarray(rng.uniform(0.01, 0.03, sub.kernel[...].shape[-1]),
                                                            jnp.float32)


@pytest.mark.parametrize("name", ["resnetv2_50", "resnetv2_101"])
def test_resnetv2_builds_as_jax(name):
    """The timm name builds the pre-activation net with the JAX package's
    parameters and buffers, and the stem of ResNet v1 (so a frozen level 1
    runs K4)."""
    jax_bb = nnx.eval_shape(lambda: JaxBackbone(name, rngs=nnx.Rngs(0)))
    bb = TimmBackbone(name, device="cpu")
    assert isinstance(bb.features, ResNetV2Features) and bb.out_channels == jax_bb.out_channels
    assert all(isinstance(b, PreactBottleneck) for b in bb.features.layer3.blocks)
    assert len(bb.features.layer3.blocks) == (6 if name == "resnetv2_50" else 23)
    flat = {".".join(map(str, p)): np.zeros(v.shape, np.float32)
            for p, v in nnx.to_flat_state(nnx.state(jax_bb, nnx.Any(nnx.Param, nnx.BatchStat)))}
    want = {k: tuple(v.shape) for k, v in state_dict_from_flat(flat).items()}
    assert {k: tuple(v.shape) for k, v in bb.state_dict().items()} == want
    assert "features.final_norm.running_var" in want and "features.layer1.blocks.0.downsample.weight" in want


def test_resnetv2_pyramid_matches_jax():
    jax_bb = nnx.jit(lambda: JaxBackbone("resnetv2_50", rngs=nnx.Rngs(0)))()
    rng = np.random.RandomState(0)
    randomize_norms(jax_bb, rng)
    damp_preact_branches(jax_bb, rng)
    jax_bb.eval()
    bb = load_from_jax(Backbone("resnetv2_50", device="cpu"), jax_bb)
    x = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
    want = nnx.jit(lambda m, xx: m(xx))(jax_bb, jnp.asarray(x))
    with torch.no_grad():
        got = bb(to_torch(x))
    for level, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(to_numpy(g, nhwc=True) - w) / np.linalg.norm(w)
        assert err <= 1e-5, (level, err)
