"""Parity of the port's resizing, pooling and scaling with the JAX package's
(f32, CPU): ``ops/image.interpolate`` and ``avg_pool2d``, the five scalers
of ``layers/scalers.py`` beside ``AntialiasedDownscaler``, the
transposed-conv rule of ``convert.state_dict_from_flat``, and backbone
levels above the feature net's top.

Tolerances: resizes and pools within 1e-6 (f32 rounding of a few terms);
blocks within 1e-5 relative, gradients within relative L2 1e-4, as in
``tests/test_torch_convblocks.py``; a backbone's levels within 1e-3
relative and 1e-4 absolute, as ``tests/test_torch_backbone.py`` holds them.
The tests of the mappings the port avoids show each of them missing JAX by
far more than that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu.layers import AntialiasedDownscaler as JaxAntialiasedDownscaler
from sihl_tpu.layers import BilinearAdditiveUpscaler as JaxBilinearAdditiveUpscaler
from sihl_tpu.layers import Interpolate as JaxInterpolate
from sihl_tpu.layers import SimpleDownscaler as JaxSimpleDownscaler
from sihl_tpu.layers import SimpleUpscaler as JaxSimpleUpscaler
from sihl_tpu.layers import StridedDownscaler as JaxStridedDownscaler
from sihl_tpu.ops import image as jax_image
from sihl_tpu_torch import Backbone
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.layers import (AntialiasedDownscaler, BilinearAdditiveUpscaler, Interpolate,
                                   SimpleDownscaler, SimpleUpscaler, StridedDownscaler)
from sihl_tpu_torch.ops import image

from test_torch_convblocks import assert_block_matches, load, randomize_all_norms
from torch_parity import flat_state, to_numpy, to_torch

RESIZE_ATOL = 1e-6


def _resize_pair(x, **kwargs):
    got = image.interpolate(to_torch(x), **kwargs)
    size = kwargs.get("size")
    want = jax_image.interpolate(jnp.asarray(x), size=None if size is None else tuple(size),
                                 scale=kwargs.get("scale"), mode=kwargs.get("mode", "nearest"))
    return to_numpy(got, nhwc=True), np.asarray(want)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("size", [(3, 3), (4, 5), (9, 9), (12, 12), (13, 7)])
def test_interpolate_by_size(mode, size):
    x = np.random.RandomState(0).randn(2, 6, 6, 3).astype(np.float32)
    got, want = _resize_pair(x, size=size, mode=mode)
    assert got.shape == want.shape == (2, *size, 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("scale", [0.5, 2, 1.5, 0.75, 3])
def test_interpolate_by_scale(mode, scale):
    x = np.random.RandomState(1).randn(2, 8, 12, 3).astype(np.float32)
    got, want = _resize_pair(x, scale=scale, mode=mode)
    assert got.shape == want.shape == (2, int(8 * scale), int(12 * scale), 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


def test_interpolate_identity_and_refusals():
    x = to_torch(np.random.RandomState(2).randn(1, 4, 4, 2).astype(np.float32))
    assert image.interpolate(x, size=(4, 4)) is x and image.interpolate(x, scale=1) is x
    with pytest.raises(ValueError, match="size or a scale"):
        image.interpolate(x)
    with pytest.raises(ValueError, match="mode"):
        image.interpolate(x, size=(2, 2), mode="bicubic")


def test_interpolate_traps():
    """The mappings the port avoids miss JAX: ``F.interpolate``'s "nearest"
    (it floors the source index) and bilinear without antialiasing when
    shrinking."""
    x = np.random.RandomState(3).randn(2, 6, 6, 3).astype(np.float32)
    xt = to_torch(x)
    for size in ((4, 4), (9, 9)):
        want = np.asarray(jax_image.interpolate(jnp.asarray(x), size=size, mode="nearest"))
        assert np.abs(to_numpy(F.interpolate(xt, size=size, mode="nearest"), nhwc=True) - want).max() > 0.1
    want = np.asarray(jax_image.interpolate(jnp.asarray(x), size=(3, 3), mode="bilinear"))
    plain = F.interpolate(xt, size=(3, 3), mode="bilinear", align_corners=False)
    assert np.abs(to_numpy(plain, nhwc=True) - want).max() > 0.1


@pytest.mark.parametrize("kernel_size,stride,padding", [(2, 2, 0), (3, 2, 1), (3, 1, 1), (5, 1, 2), ((3, 2), (1, 2), (1, 0))])
def test_avg_pool2d(kernel_size, stride, padding):
    """Zero padding counts in the mean, as in the JAX package."""
    x = np.random.RandomState(4).randn(2, 9, 10, 3).astype(np.float32)
    got = image.avg_pool2d(to_torch(x), kernel_size, stride=stride, padding=padding)
    want = jax_image.avg_pool2d(jnp.asarray(x), kernel_size, stride=stride, padding=padding)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got, nhwc=True), np.asarray(want), atol=RESIZE_ATOL, rtol=0)


def test_avg_pool2d_keeps_the_input_dtype():
    x = torch.randn(1, 2, 4, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    got = image.avg_pool2d(x, 2)
    assert got.dtype == torch.bfloat16
    want = F.avg_pool2d(x.float(), 2).to(torch.bfloat16)
    assert torch.equal(got, want)


# -- the scalers ---------------------------------------------------------------


SCALERS = {
    "strided": lambda jax: (JaxStridedDownscaler if jax else StridedDownscaler),
    "antialiased": lambda jax: (JaxAntialiasedDownscaler if jax else AntialiasedDownscaler),
    "simple_down": lambda jax: (JaxSimpleDownscaler if jax else SimpleDownscaler),
    "simple_up": lambda jax: (JaxSimpleUpscaler if jax else SimpleUpscaler),
    "bilinear_additive": lambda jax: (JaxBilinearAdditiveUpscaler if jax else BilinearAdditiveUpscaler),
}


@pytest.mark.parametrize("name", sorted(SCALERS))
@pytest.mark.parametrize("train", [False, True])
def test_scalers(name, train):
    rng = np.random.RandomState(5)
    jax_block = SCALERS[name](True)(8, 12, rngs=nnx.Rngs(0))
    randomize_all_norms(jax_block, rng)
    block = load(SCALERS[name](False)(8, 12), jax_block)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    assert_block_matches(jax_block, block, x, train=train)


def test_scaler_kwargs_reach_the_conv():
    block = SimpleDownscaler(8, 16, 3, norm="group", act="gelu")
    jax_block = JaxSimpleDownscaler(8, 16, 3, norm="group", act="gelu", rngs=nnx.Rngs(0))
    assert type(block.conv.norm).__name__ == "GroupNorm" and block.conv.norm.num_groups == 1
    assert jax_block.conv.norm.num_groups == 1
    assert StridedDownscaler(8, 16).conv.stride == 2


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_interpolate_module(mode):
    x = np.random.RandomState(6).randn(2, 6, 6, 4).astype(np.float32)
    for kwargs in ({"size": 4}, {"size": (9, 5)}, {"scale": 2}):
        got = Interpolate(mode=mode, **kwargs)(to_torch(x))
        want = JaxInterpolate(mode=mode, **kwargs)(jnp.asarray(x))
        np.testing.assert_allclose(to_numpy(got, nhwc=True), np.asarray(want), atol=RESIZE_ATOL, rtol=0)


def test_transposed_conv_carry_over():
    """A BilinearAdditiveUpscaler's ``residual`` (flax ``ConvTranspose``, 2x2,
    stride 2) loads flipped in space; the same kernel laid out (I, O, H, W)
    without the flip misses JAX, and without the port's module the conv rule
    gives a weight that ``load_state_dict`` refuses."""
    rng = np.random.RandomState(7)
    jax_block = JaxBilinearAdditiveUpscaler(8, 4, rngs=nnx.Rngs(1))
    x = rng.randn(2, 5, 5, 8).astype(np.float32)
    want = np.asarray(jax_block.residual(jnp.asarray(x)))
    block = load(BilinearAdditiveUpscaler(8, 4), jax_block)
    with torch.no_grad():
        got = to_numpy(block.residual(to_torch(x)), nhwc=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    kernel = np.asarray(jax_block.residual.kernel[...])
    with torch.no_grad():
        block.residual.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
        unflipped = to_numpy(block.residual(to_torch(x)), nhwc=True)
    assert np.abs(unflipped - want).max() > 0.1

    with pytest.raises(RuntimeError, match="size mismatch"):
        BilinearAdditiveUpscaler(8, 4).load_state_dict(state_dict_from_flat(flat_state(jax_block)), strict=True)


def test_bilinear_additive_upscaler_refuses_uneven_channels():
    with pytest.raises(ValueError, match="multiple of 4"):
        BilinearAdditiveUpscaler(6, 4)


# -- backbone levels above the top ----------------------------------------------


@pytest.mark.parametrize("top_level", [6, 7])
def test_backbone_levels_above_the_top(top_level):
    rng = np.random.RandomState(8)
    jax_bb = JaxBackbone("resnet18", top_level=top_level, rngs=nnx.Rngs(0))
    randomize_all_norms(jax_bb, rng)
    jax_bb.eval()
    bb = load(Backbone("resnet18", top_level=top_level), jax_bb).eval()
    assert bb.out_channels == jax_bb.out_channels == [3, 64, 64, 128, 256, 512] + [512] * (top_level - 5)
    assert len(bb.downscalers) == top_level - 5
    size = 2**top_level
    x = rng.rand(2, size, size, 3).astype(np.float32)
    want = jax_bb(jnp.asarray(x))
    with torch.no_grad():
        got = bb(to_torch(x))
    assert len(got) == len(want) == top_level + 1
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.shape[2:] == (size >> level, size >> level)
        np.testing.assert_allclose(to_numpy(g, nhwc=True), np.asarray(w), rtol=1e-3, atol=1e-4)
