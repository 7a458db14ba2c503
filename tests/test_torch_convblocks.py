"""Parity of the port's conv blocks with the JAX package's
(``sihl_tpu/layers/convblocks.py``), f32 on the CPU: the activations,
``SeparableConv2d`` and the separable ``ConvNormAct``, group norm in both
blocks, ``Identity`` and ``SequentialConvBlocks``.

Weights cross through ``state_dict_from_flat``; every norm gets random
affine parameters (and a BatchNorm random running statistics), so that no
norm is the identity.  Tolerances: forwards within 1e-5 relative (of each
element, with an absolute floor of 1e-5 of the largest magnitude);
gradients, of the input and of every parameter, within relative L2 1e-4,
ten times under the heads' limit of the slices (1e-3), since a single block
in f32 keeps that many digits; running statistics within 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from sihl_tpu.layers import ConvNormAct as JaxConvNormAct
from sihl_tpu.layers import Identity as JaxIdentity
from sihl_tpu.layers import SeparableConv2d as JaxSeparableConv2d
from sihl_tpu.layers import SequentialConvBlocks as JaxSequentialConvBlocks
from sihl_tpu.layers import StandardConvNormAct as JaxStandardConvNormAct
from sihl_tpu.layers.convblocks import _ACTS as JAX_ACTS
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.layers import (ConvNormAct, Identity, SeparableConv2d, SequentialConvBlocks,
                                   StandardConvNormAct)
from sihl_tpu_torch.layers.convblocks import _ACTS, GroupNorm

from torch_parity import flat_state, to_numpy, to_torch

FWD_REL = 1e-5
GRAD_REL = 1e-4


def assert_forward_close(got, want, rel=FWD_REL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


def relative_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def randomize_all_norms(module, rng: np.random.RandomState) -> None:
    """Random scale and bias of every BatchNorm and GroupNorm, and random
    running statistics of every BatchNorm."""
    for _, sub in nnx.iter_graph(module):
        if isinstance(sub, (nnx.BatchNorm, nnx.GroupNorm)):
            c = sub.scale[...].shape
            sub.scale[...] = jnp.asarray(rng.uniform(0.8, 1.2, c), jnp.float32)
            sub.bias[...] = jnp.asarray(rng.uniform(-0.1, 0.1, c), jnp.float32)
        if isinstance(sub, nnx.BatchNorm):
            sub.mean[...] = jnp.asarray(rng.uniform(-0.2, 0.2, c), jnp.float32)
            sub.var[...] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)


def load(port_module, jax_module):
    port_module.load_state_dict(state_dict_from_flat(flat_state(jax_module), port_module), strict=True)
    return port_module


def assert_block_matches(jax_block, block, x: np.ndarray, train: bool, seed: int = 0) -> None:
    """Forward of ``x`` (NHWC) in eval or training mode; in training mode also
    the gradients of ``sum(out * w)`` for a random ``w``, of the input and of
    every parameter, and the running statistics after the step."""
    rng = np.random.RandomState(seed)
    if not train:
        jax_block.eval()
        with torch.no_grad():
            got = block.eval()(to_torch(x))
        assert got.is_contiguous(memory_format=torch.channels_last) or got.shape[2:] == (1, 1)
        assert_forward_close(to_numpy(got, nhwc=True), jax_block(jnp.asarray(x)))
        return

    with torch.no_grad():
        b, c, h, w_ = block.eval()(to_torch(x)).shape
    w = rng.randn(b, h, w_, c).astype(np.float32)
    jax_block.train()

    def jax_loss(m, xx):
        out = m(xx)
        return jnp.sum(out * jnp.asarray(w)), out

    grad_fn = nnx.jit(nnx.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))
    (_, want), (grads, want_dx) = grad_fn(jax_block, jnp.asarray(x))
    x_t = to_torch(x).requires_grad_(True)
    got = block.train()(x_t)
    (got * to_torch(w)).sum().backward()
    assert_forward_close(to_numpy(got, nhwc=True), want)
    assert relative_l2(to_numpy(x_t.grad, nhwc=True), want_dx) <= GRAD_REL
    want_grads = state_dict_from_flat(
        {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads)}, block
    )
    params = dict(block.named_parameters())
    assert sorted(params) == sorted(want_grads)
    for name, p in params.items():
        err = relative_l2(p.grad.numpy(), want_grads[name].numpy())
        assert err <= GRAD_REL, (name, err)
    jax_stats = state_dict_from_flat(flat_state(jax_block), block)
    for name, b in block.named_buffers():
        np.testing.assert_allclose(b.numpy(), jax_stats[name].numpy(), rtol=1e-5, atol=1e-7)


# -- activations ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["relu", "silu", "gelu", "sigmoid", "softplus", "softmax"])
def test_activations_match_jax(name):
    assert set(_ACTS) == set(JAX_ACTS)
    x = (np.random.RandomState(0).randn(2, 5, 6, 8) * 4).astype(np.float32)
    want = np.asarray(JAX_ACTS[name](jnp.asarray(x)))
    got = to_numpy(_ACTS[name](to_torch(x)), nhwc=True)
    assert_forward_close(got, want)


def test_gelu_and_softmax_traps():
    """The mappings the port avoids miss JAX: ``F.gelu``'s default (the erf
    form) against ``jax.nn.gelu``'s tanh approximation, and a softmax over the
    last axis of NCHW (the width) against JAX's over the channels."""
    x = (np.random.RandomState(1).randn(2, 5, 6, 8) * 2).astype(np.float32)
    xt = to_torch(x)
    want = np.asarray(JAX_ACTS["gelu"](jnp.asarray(x)))
    assert np.abs(to_numpy(F.gelu(xt), nhwc=True) - want).max() > 1e-4
    want = np.asarray(JAX_ACTS["softmax"](jnp.asarray(x)))
    assert np.abs(to_numpy(torch.softmax(xt, dim=-1), nhwc=True) - want).max() > 1e-2


# -- separable convs -------------------------------------------------------------


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_separable_conv2d(stride, dilation):
    rng = np.random.RandomState(stride * 10 + dilation)
    jax_conv = JaxSeparableConv2d(8, 12, 3, stride=stride, padding=dilation, dilation=dilation,
                                  bias=True, rngs=nnx.Rngs(0))
    conv = load(SeparableConv2d(8, 12, 3, stride=stride, padding=dilation, dilation=dilation, bias=True),
                jax_conv)
    assert conv.depthwise.groups == 8 and tuple(conv.depthwise.weight.shape) == (8, 1, 3, 3)
    x = rng.randn(2, 12, 12, 8).astype(np.float32)
    assert_block_matches(jax_conv, conv, x, train=False)
    assert_block_matches(jax_conv, conv, x, train=True)


@pytest.mark.parametrize("norm,act,train", [
    ("batch", "relu", False), ("batch", "relu", True), ("group", "gelu", True), (None, "silu", True),
])
def test_separable_conv_norm_act(norm, act, train):
    rng = np.random.RandomState(3)
    jax_block = JaxConvNormAct(16, 24, 3, stride=2, norm=norm, act=act, separable=True, rngs=nnx.Rngs(1))
    randomize_all_norms(jax_block, rng)
    block = load(ConvNormAct(16, 24, 3, stride=2, norm=norm, act=act, separable=True), jax_block)
    assert isinstance(block.conv, SeparableConv2d)
    assert (block.conv.depthwise.bias is None) == (norm is not None)
    x = rng.randn(2, 10, 10, 16).astype(np.float32)
    assert_block_matches(jax_block, block, x, train=train)


def test_separable_1x1_is_a_plain_conv():
    """``separable`` applies only to kernels wider than 1x1, as in the JAX package."""
    assert not isinstance(ConvNormAct(8, 16, 1, separable=True).conv, SeparableConv2d)
    assert not isinstance(JaxConvNormAct(8, 16, 1, separable=True, rngs=nnx.Rngs(0)).conv, JaxSeparableConv2d)


# -- group norm --------------------------------------------------------------------


@pytest.mark.parametrize("block_cls,jax_cls,cin,cout", [
    (ConvNormAct, JaxConvNormAct, 16, 24),
    (ConvNormAct, JaxConvNormAct, 4, 6),
    (StandardConvNormAct, JaxStandardConvNormAct, 16, 24),
    (StandardConvNormAct, JaxStandardConvNormAct, 12, 4),
])
def test_group_counts_match_jax(block_cls, jax_cls, cin, cout):
    """ConvNormAct groups by its input channels (``max(in // 8, 1)``),
    StandardConvNormAct by its output channels (``max(out // 8, 1)``)."""
    block = block_cls(cin, cout, norm="group")
    jax_block = jax_cls(cin, cout, norm="group", rngs=nnx.Rngs(0))
    assert isinstance(block.norm, GroupNorm)
    assert block.norm.num_groups == jax_block.norm.num_groups
    expected = max(cin // 8, 1) if block_cls is ConvNormAct else max(cout // 8, 1)
    assert block.norm.num_groups == expected


@pytest.mark.parametrize("block_cls,jax_cls", [(ConvNormAct, JaxConvNormAct),
                                               (StandardConvNormAct, JaxStandardConvNormAct)])
@pytest.mark.parametrize("train", [False, True])
def test_group_norm_blocks(block_cls, jax_cls, train):
    rng = np.random.RandomState(4)
    jax_block = jax_cls(16, 24, 3, norm="group", act="silu", rngs=nnx.Rngs(2))
    randomize_all_norms(jax_block, rng)
    block = load(block_cls(16, 24, 3, norm="group", act="silu"), jax_block)
    # an offset input, so that E[x^2] - E[x]^2 cancels digits as it does in use
    x = (rng.randn(2, 8, 8, 16) + 3.0).astype(np.float32)
    assert_block_matches(jax_block, block, x, train=train)


def test_group_norm_rejects_an_uneven_split():
    with pytest.raises(ValueError, match="groups"):
        GroupNorm(10, 4)


# -- Identity and SequentialConvBlocks ------------------------------------------------


def test_identity():
    x = to_torch(np.random.RandomState(5).randn(1, 4, 4, 3).astype(np.float32))
    assert Identity()(x) is x and JaxIdentity()(x) is x


@pytest.mark.parametrize("num_layers", [0, -1])
def test_sequential_conv_blocks_without_layers(num_layers):
    blocks = SequentialConvBlocks(8, 16, num_layers)
    assert len(blocks.blocks) == 0 and not list(blocks.parameters())
    assert len(JaxSequentialConvBlocks(8, 16, num_layers, rngs=nnx.Rngs(0)).blocks) == 0
    x = to_torch(np.random.RandomState(6).randn(1, 4, 4, 8).astype(np.float32))
    assert blocks(x) is x


@pytest.mark.parametrize("conv_block,jax_conv_block,kwargs,train", [
    (ConvNormAct, JaxConvNormAct, {}, True),
    (ConvNormAct, JaxConvNormAct, {"norm": "group", "act": "gelu", "separable": True}, True),
    (StandardConvNormAct, JaxStandardConvNormAct, {"act": "silu", "stride": 1}, False),
])
def test_sequential_conv_blocks(conv_block, jax_conv_block, kwargs, train):
    rng = np.random.RandomState(7)
    jax_blocks = JaxSequentialConvBlocks(8, 16, 2, conv_block=jax_conv_block, rngs=nnx.Rngs(3), **kwargs)
    randomize_all_norms(jax_blocks, rng)
    blocks = load(SequentialConvBlocks(8, 16, 2, conv_block=conv_block, **kwargs), jax_blocks)
    assert [type(b) for b in blocks.blocks] == [conv_block] * 2
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    assert_block_matches(jax_blocks, blocks, x, train=train)
