"""Parity of the port's layers and image ops with the JAX package (f32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.layers import FPN as JaxFPN
from sihl_tpu.layers import MLP as JaxMLP
from sihl_tpu.layers import StandardConvNormAct as JaxConvNormAct
from sihl_tpu.ops import image as jax_image
from sihl_tpu_torch.layers import FPN, MLP, StandardConvNormAct
from sihl_tpu_torch.ops import image

from torch_parity import load_from_jax, randomize_norms, to_numpy, to_torch

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "kernel_size,stride,act", [(1, 1, None), (3, 1, "relu"), (3, 2, "relu"), (7, 2, "relu")]
)
def test_standard_conv_norm_act(kernel_size, stride, act):
    rng = np.random.RandomState(kernel_size * 10 + stride)
    jax_block = JaxConvNormAct(8, 16, kernel_size, stride=stride, act=act, rngs=nnx.Rngs(0))
    randomize_norms(jax_block, rng)
    jax_block.eval()
    block = load_from_jax(StandardConvNormAct(8, 16, kernel_size, stride=stride, act=act), jax_block)
    x = rng.randn(2, 12, 12, 8).astype(np.float32)
    want = np.asarray(jax_block(jnp.asarray(x)))
    with torch.no_grad():
        got = block(to_torch(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_numpy(got, nhwc=True), want, **TOL)


def test_mlp():
    rng = np.random.RandomState(1)
    jax_mlp = JaxMLP(32, [32] * 4 + [5], final_bias_init=-5.0, rngs=nnx.Rngs(1))
    randomize_norms(jax_mlp, rng)
    mlp = load_from_jax(MLP(32, [32] * 4 + [5]), jax_mlp)
    x = rng.randn(7, 32).astype(np.float32)
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(jax_mlp(jnp.asarray(x))), **TOL)


def test_fpn_levels_3_to_7():
    rng = np.random.RandomState(2)
    pyramid = make_pyramid(batch_size=2, height=128, width=128, rng=rng)
    in_channels = [p.shape[-1] for p in pyramid]
    jax_fpn = JaxFPN(in_channels, 32, bottom_level=3, top_level=7, rngs=nnx.Rngs(2))
    randomize_norms(jax_fpn, rng)
    jax_fpn.eval()
    fpn = load_from_jax(FPN(in_channels, 32, bottom_level=3, top_level=7), jax_fpn)
    want = jax_fpn([jnp.asarray(p) for p in pyramid])
    with torch.no_grad():
        got = fpn([to_torch(p) for p in pyramid])
    assert fpn.out_channels == jax_fpn.out_channels
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g, nhwc=True), np.asarray(w), **TOL)


def test_image_ops():
    x = np.random.RandomState(3).randn(2, 6, 10, 4).astype(np.float32)
    xt = to_torch(x)
    np.testing.assert_array_equal(
        to_numpy(image.max_pool2d(xt, 3, stride=2, padding=1), nhwc=True),
        np.asarray(jax_image.max_pool2d(jnp.asarray(x), 3, stride=2, padding=1)),
    )
    np.testing.assert_array_equal(
        to_numpy(image.upsample2x_nearest(xt), nhwc=True),
        np.asarray(jax_image.upsample2x_nearest(jnp.asarray(x))),
    )
    assert image.interpolate(xt, size=(6, 10)) is xt
    for size in ((5, 5), (12, 20)):
        np.testing.assert_array_equal(
            to_numpy(image.interpolate(xt, size=size), nhwc=True),
            np.asarray(jax_image.interpolate(jnp.asarray(x), size=size)),
        )


@pytest.mark.parametrize("act", [None, "relu"])
def test_standard_conv_norm_act_training(act):
    """Training-mode BatchNorm (batch statistics, differentiated through)
    behind a conv: output, every gradient and the running statistics after
    the step, f32."""
    rng = np.random.RandomState(4)
    jax_block = JaxConvNormAct(8, 16, 3, act=act, rngs=nnx.Rngs(4))
    randomize_norms(jax_block, rng)
    block = load_from_jax(StandardConvNormAct(8, 16, 3, act=act), jax_block).train()
    x = rng.randn(2, 12, 12, 8).astype(np.float32)
    w = rng.randn(2, 12, 12, 16).astype(np.float32)

    jax_block.train()

    def jax_loss(m, xx):
        out = m(xx)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), (grads, want_dx) = nnx.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jax_block, jnp.asarray(x)
    )
    x_t = to_torch(x).requires_grad_(True)
    got = block(x_t)
    (got * to_torch(w)).sum().backward()

    np.testing.assert_allclose(to_numpy(got, nhwc=True), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_numpy(x_t.grad, nhwc=True), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(
        block.conv.weight.grad.permute(2, 3, 1, 0).numpy(), np.asarray(grads["conv"]["kernel"][...]), **TOL
    )
    np.testing.assert_allclose(block.norm.weight.grad.numpy(), np.asarray(grads["norm"]["scale"][...]), **TOL)
    np.testing.assert_allclose(block.norm.bias.grad.numpy(), np.asarray(grads["norm"]["bias"][...]), **TOL)
    np.testing.assert_allclose(block.norm.running_mean.numpy(), np.asarray(jax_block.norm.mean[...]), **TOL)
    np.testing.assert_allclose(block.norm.running_var.numpy(), np.asarray(jax_block.norm.var[...]), **TOL)
