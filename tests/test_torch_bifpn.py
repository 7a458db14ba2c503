"""The port's BiFPN path against the JAX package's (CPU): the weighted-sum
fusion (K6's plain version) with its gradients, the binomial blur-pool,
``ConvNormAct``, ``AntialiasedDownscaler`` and the ``BiFPN`` neck, with
weights carried over by ``state_dict_from_flat`` (strict).

Tolerances: the fusion follows the JAX Pallas kernel's arithmetic (f32
products and sums, one rounding), so f32 agrees to 1e-6 relative (XLA may
contract a product and a sum into one rounding) and bf16 to one bf16 step
(``torch_parity.assert_within_one_bf16_step``), where the two f32 sums sit
on either side of a rounding boundary.  Modules made of convs and BatchNorms agree to 1e-5 in f32
(summation order), their gradients to relative L2 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.layers.bifpn import BiFPN as JaxBiFPN
from sihl_tpu.layers.convblocks import ConvNormAct as JaxConvNormAct
from sihl_tpu.layers.scalers import AntialiasedDownscaler as JaxAntialiasedDownscaler
from sihl_tpu.ops.image import blur_pool_2d as jax_blur_pool_2d
from sihl_tpu.ops.pallas.fusion import fused_weighted_sum as jax_weighted_sum
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.layers import AntialiasedDownscaler, BiFPN, BlurPool2d, ConvNormAct
from sihl_tpu_torch.ops.fusion import fused_weighted_sum, fused_weighted_sum_reference
from sihl_tpu_torch.ops.image import blur_pool_2d

from torch_parity import assert_within_one_bf16_step, flat_state, load_from_jax, randomize_norms, to_numpy, to_torch

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _fusion_inputs(rng, n, shape=(1, 4, 8, 16)):
    xs = [rng.randn(*shape).astype(np.float32) for _ in range(n)]
    w = rng.rand(n).astype(np.float32)
    return xs, w / w.sum()


def _assert_close_in(dtype_name, got, want):
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert_within_one_bf16_step(got, want)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_weighted_sum_matches_jax_kernel(dtype_name, n):
    """Against the Pallas kernel in interpret mode (f32 weights, f32 sums,
    one rounding) and, in f32, against the JAX plain path too."""
    jdt, tdt = DTYPES[dtype_name]
    xs, w = _fusion_inputs(np.random.RandomState(n), n)
    jx = [jnp.asarray(x, jdt) for x in xs]
    want = np.asarray(jax_weighted_sum(jnp.asarray(w), jx, use_pallas=True, interpret=True), np.float32)
    got = fused_weighted_sum(torch.from_numpy(w), [to_torch(x).to(tdt) for x in xs])
    assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
    _assert_close_in(dtype_name, to_numpy(got, nhwc=True), want)
    if dtype_name == "float32":
        plain = np.asarray(jax_weighted_sum(jnp.asarray(w), jx, use_pallas=False))
        np.testing.assert_allclose(to_numpy(got, nhwc=True), plain, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_weighted_sum_gradients_match_jax(dtype_name):
    """The JAX custom VJP: dw_i = sum(g * x_i) in f32 (relative 1e-5: two
    orders of one f32 sum), dx_i = w_i * g rounded to x_i's dtype (exact)."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.RandomState(7)
    xs, w = _fusion_inputs(rng, 3)
    g = rng.randn(1, 4, 8, 16).astype(np.float32)
    _, vjp = jax.vjp(
        lambda ww, *x: jax_weighted_sum(ww, x, use_pallas=True, interpret=True),
        jnp.asarray(w), *[jnp.asarray(x, jdt) for x in xs],
    )
    want_w, *want_x = vjp(jnp.asarray(g, jdt))
    wt = torch.from_numpy(w).requires_grad_(True)
    xt = [to_torch(x).to(tdt).requires_grad_(True) for x in xs]
    fused_weighted_sum(wt, xt).backward(to_torch(g).to(tdt))
    assert wt.grad.dtype == torch.float32
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-6)
    for got, want in zip(xt, want_x):
        assert got.grad.dtype == tdt
        np.testing.assert_array_equal(to_numpy(got.grad, nhwc=True), np.asarray(want, np.float32))


def test_fused_weighted_sum_keeps_f64():
    """Under the f64 compute dtype the plain version sums in f64."""
    xs = [torch.randn(1, 2, 3, 4, dtype=torch.float64) for _ in range(3)]
    w = torch.tensor([0.2, 0.3, 0.5], dtype=torch.float64)
    got = fused_weighted_sum(w, xs)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, 0.2 * xs[0] + 0.3 * xs[1] + 0.5 * xs[2], rtol=1e-15, atol=1e-15)
    assert torch.equal(got, fused_weighted_sum_reference(w, xs))


def test_fused_weighted_sum_rejects_mismatches():
    x = torch.zeros(1, 4, 2, 3)
    with pytest.raises(ValueError, match="weights of shape"):
        fused_weighted_sum(torch.ones(3), [x, x])
    with pytest.raises(ValueError, match="share shape"):
        fused_weighted_sum(torch.ones(2), [x, torch.zeros(1, 4, 2, 4)])
    with pytest.raises(ValueError, match="share shape"):
        fused_weighted_sum(torch.ones(2), [x, x.bfloat16()])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_weighted_sum(torch.ones(2, device="meta"), [x.to("meta"), x.to("meta")])


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel_size", [3, 5])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_blur_pool_2d_matches_jax(dtype_name, kernel_size, stride):
    """Reflect pad, binomial depthwise conv in f32, cast back: 1e-6 in f32,
    one bf16 step in bf16 (the conv's f32 sums in two orders)."""
    jdt, tdt = DTYPES[dtype_name]
    x = np.random.RandomState(kernel_size + stride).randn(2, 12, 10, 5).astype(np.float32)
    want = np.asarray(jax_blur_pool_2d(jnp.asarray(x, jdt), kernel_size, stride), np.float32)
    got = BlurPool2d(5, kernel_size, stride)(to_torch(x).to(tdt).contiguous(memory_format=torch.channels_last))
    assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
    assert got.shape[2:] == want.shape[1:3]
    _assert_close_in(dtype_name, to_numpy(got, nhwc=True), want)
    assert torch.equal(got, blur_pool_2d(to_torch(x).to(tdt), kernel_size, stride))


def _pair_outputs(jax_module, module, x, train: bool):
    """Outputs of the JAX module and the port's (weights carried over) on x."""
    jax_module = nnx.clone(jax_module)
    module = load_from_jax(module, jax_module)
    jax_module.train() if train else jax_module.eval()
    module.train(train)
    want = np.asarray(jax_module(jnp.asarray(x)))
    got = to_numpy(module(to_torch(x).contiguous(memory_format=torch.channels_last)), nhwc=True)
    return got, want


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conv_norm_act_and_downscaler_match_jax(train):
    """ConvNormAct (conv → act → norm, bias only without a norm) and
    AntialiasedDownscaler, within 1e-5."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    cases = [
        (JaxConvNormAct(8, 16, rngs=nnx.Rngs(0)), ConvNormAct(8, 16)),
        (JaxConvNormAct(8, 16, 1, act="silu", rngs=nnx.Rngs(1)), ConvNormAct(8, 16, 1, act="silu")),
        (JaxConvNormAct(8, 16, norm=None, rngs=nnx.Rngs(2)), ConvNormAct(8, 16, norm=None)),
        (JaxAntialiasedDownscaler(8, 16, rngs=nnx.Rngs(3)), AntialiasedDownscaler(8, 16)),
    ]
    assert ConvNormAct(8, 16, norm=None).conv.bias is not None and ConvNormAct(8, 16).conv.bias is None
    for jax_module, module in cases:
        randomize_norms(jax_module, rng)
        got, want = _pair_outputs(jax_module, module, x, train)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv_norm_act_refuses_separable():
    """The separable ConvNormAct is ported now, and refused no longer: it
    builds a depthwise and a pointwise conv, as the JAX package's does
    (its parity is in ``tests/test_torch_convblocks.py``)."""
    block = ConvNormAct(8, 16, separable=True)
    jax_block = JaxConvNormAct(8, 16, separable=True, rngs=nnx.Rngs(0))
    assert block.conv.depthwise.groups == 8 and jax_block.conv.depthwise.feature_group_count == 8
    assert tuple(block.conv.pointwise.weight.shape) == (16, 8, 1, 1)


def _relative_error(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.fixture(scope="module")
def bifpn_pair():
    rng = np.random.RandomState(0)
    pyramid = make_pyramid(batch_size=2, height=64, width=64, rng=rng)
    in_channels = [p.shape[-1] for p in pyramid]
    jax_neck = JaxBiFPN(in_channels, 16, bottom_level=3, top_level=5, num_layers=2, rngs=nnx.Rngs(0))
    randomize_norms(jax_neck, rng)
    for _, sub in nnx.iter_graph(jax_neck):  # non-uniform fusion weights
        if type(sub).__name__ == "FastNormalizedFusion":
            sub.weights[...] = jnp.asarray(rng.randn(*sub.weights[...].shape), jnp.float32)
    cotangents = [rng.randn(*p.shape[:3], 16).astype(np.float32) for p in pyramid[3:]]
    return jax_neck, BiFPN(in_channels, 16, bottom_level=3, top_level=5, num_layers=2), pyramid, cotangents


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bifpn_outputs_and_gradients_match_jax(bifpn_pair, train):
    """Outputs within 1e-5; the gradients of sum(outputs * cotangents) for
    every parameter (the fusion weights included) and for the input levels
    within relative L2 1e-4; in training mode the running statistics within
    1e-6 too."""
    jax_neck, neck, pyramid, cotangents = bifpn_pair
    jax_neck = nnx.clone(jax_neck)
    neck = load_from_jax(copy.deepcopy(neck), jax_neck).train(train)  # before JAX's step moves its statistics
    jax_neck.train() if train else jax_neck.eval()
    assert neck.out_channels == jax_neck.out_channels
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
    want_grads = state_dict_from_flat({".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(want_params)})
    for name, p in neck.named_parameters():
        err = _relative_error(p.grad.numpy(), want_grads[name].numpy())
        assert err <= 1e-4, (name, err)
    for got_level, want_level in zip(levels[3:], want_levels):
        assert _relative_error(to_numpy(got_level.grad, nhwc=True), want_level) <= 1e-4
    if train:
        stats = state_dict_from_flat(flat_state(jax_neck))
        for name, buf in neck.named_buffers():
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), rtol=1e-6, atol=1e-6)
