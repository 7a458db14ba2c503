"""The port's PAN neck against the JAX package's (CPU): an FPN pass (its
top-down merges through K3's plain version) and the bottom-up path of
stride-2 ``ConvNormAct``\\ s, 32 channels over levels 3-5, in eval and
training mode; weights carried by ``state_dict_from_flat`` (strict).

Outputs within 1e-5, and the gradients of sum(outputs * cotangents) for
every parameter and input level within relative L2 1e-4 (summation order),
as ``tests/test_torch_bifpn.py`` holds the BiFPN; in training mode the
running statistics within 1e-6.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.layers import PAN as JaxPAN
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.layers import PAN, ConvNormAct

from test_torch_bifpn import _relative_error
from torch_parity import flat_state, load_from_jax, randomize_norms, to_numpy, to_torch

WIDTH = 32


@pytest.fixture(scope="module")
def pan_pair():
    rng = np.random.RandomState(0)
    pyramid = make_pyramid(batch_size=2, height=64, width=64, rng=rng)
    in_channels = [p.shape[-1] for p in pyramid]
    jax_neck = JaxPAN(in_channels, WIDTH, bottom_level=3, top_level=5, rngs=nnx.Rngs(0))
    randomize_norms(jax_neck, rng)
    cotangents = [rng.randn(*p.shape[:3], WIDTH).astype(np.float32) for p in pyramid[3:]]
    return jax_neck, PAN(in_channels, WIDTH, bottom_level=3, top_level=5), pyramid, cotangents


def test_pan_structure(pan_pair):
    """Two stride-2 aggregators (levels 4 and 5), conv → SiLU → BatchNorm,
    and the FPN base with the same SiLU; the levels outside 3-5 pass."""
    jax_neck, neck, _, _ = pan_pair
    assert neck.out_channels == jax_neck.out_channels == [3, 8, 16, WIDTH, WIDTH, WIDTH]
    assert len(neck.aggregate) == len(jax_neck.aggregate) == 2
    for down in neck.aggregate:
        assert isinstance(down, ConvNormAct) and down.conv.stride == 2 and down.conv.bias is None
        assert down.act is torch.nn.functional.silu
    assert neck.smooth[0].act is torch.nn.functional.silu


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pan_outputs_and_gradients_match_jax(pan_pair, train):
    jax_neck, neck, pyramid, cotangents = pan_pair
    jax_neck = nnx.clone(jax_neck)
    neck = load_from_jax(copy.deepcopy(neck), jax_neck).train(train)
    jax_neck.train() if train else jax_neck.eval()
    jax_in = [jnp.asarray(p) for p in pyramid]

    def loss(module, levels):
        outs = module(list(jax_in[:3]) + list(levels))
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(outs[3:], cotangents)), outs

    (_, want), (want_params, want_levels) = nnx.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax_neck, jax_in[3:]
    )
    levels = [to_torch(p).contiguous(memory_format=torch.channels_last).requires_grad_(True) for p in pyramid]
    outs = neck(levels)
    assert len(outs) == len(want) == 6
    sum((o * to_torch(c)).sum() for o, c in zip(outs[3:], cotangents)).backward()
    for got_level, want_level in zip(outs, want):
        np.testing.assert_allclose(to_numpy(got_level, nhwc=True), np.asarray(want_level), rtol=1e-5, atol=1e-5)
    want_grads = state_dict_from_flat({".".join(map(str, p)): np.asarray(v[...])
                                       for p, v in nnx.to_flat_state(want_params)})
    assert {n for n, _ in neck.named_parameters()} == set(want_grads)
    for name, p in neck.named_parameters():
        err = _relative_error(p.grad.numpy(), want_grads[name].numpy())
        assert err <= 1e-4, (name, err)
    for got_level, want_level in zip(levels[3:], want_levels):
        assert _relative_error(to_numpy(got_level.grad, nhwc=True), want_level) <= 1e-4
    if train:
        stats = state_dict_from_flat(flat_state(jax_neck))
        for name, buf in neck.named_buffers():
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), rtol=1e-6, atol=1e-6)
