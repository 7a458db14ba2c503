"""The port's dynamic decode, mask boxes and mask resize against the JAX
package (f32, CPU).

The decode's plain version (the path every CPU tensor takes) is held to
``sihl_tpu``'s einsum chain and to its Pallas kernel in interpret mode
(``dynconv._decode(..., True)``, as ``tests/ops/test_dynconv.py`` runs it):
logits within 1e-5, and the gradients of the features and the dynamic
weights within 1e-4 of ``jax.grad``.  The kernels themselves run only on a
card (``tests/test_torch_kernels_cuda.py``); here K5f's tensor-core
arithmetic (bf16 operands, the f32 grid and activations split exactly into
three bf16 parts by bit masks, f32 sums) is emulated in plain PyTorch and
held to the JAX chain, and its block plan is checked to cover every pixel
and instance once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sihl_tpu.ops.boxes import masks_to_boxes as jax_masks_to_boxes
from sihl_tpu.ops.pallas import dynconv as jax_dynconv
from sihl_tpu_torch.ops import dynconv
from sihl_tpu_torch.ops.boxes import masks_to_boxes
from sihl_tpu_torch.ops.image import resize_linear

import torch_parity  # noqa: F401  (the CPU default device)

SHAPES = [(8, 1, 5), (32, 17, 3)]
JAX_DECODES = {
    "einsum": jax_dynconv.reference_decode,
    "pallas": lambda *args: jax_dynconv._decode(*args, True),
}


def _inputs(c, k, i, b=2, h=8, w=8, seed=0):
    rng = np.random.RandomState(seed)
    mf = (rng.randn(b, h, w, c) * 0.5).astype(np.float32)
    grid = rng.rand(h, w, 2).astype(np.float32)
    centers = rng.rand(b, i, 2).astype(np.float32)
    dyn = (rng.randn(b, i, dynconv.param_count(c, k)) * 0.3).astype(np.float32)
    cotangent = rng.randn(b, i, h, w, k).astype(np.float32)
    return mf, grid, centers, dyn, cotangent


def _port_args(mf, grid, centers, dyn):
    """NHWC features as (B, c, H, W) in channels_last memory, as the head gives them."""
    return torch.from_numpy(mf).permute(0, 3, 1, 2), torch.from_numpy(grid), torch.from_numpy(centers), torch.from_numpy(dyn)


@pytest.mark.parametrize("jax_decode", sorted(JAX_DECODES))
@pytest.mark.parametrize("c,k,i", SHAPES)
def test_decode_forward_matches_jax(c, k, i, jax_decode):
    mf, grid, centers, dyn, _ = _inputs(c, k, i)
    want = np.asarray(JAX_DECODES[jax_decode](*map(jnp.asarray, (mf, grid, centers, dyn)), c, k))
    args = _port_args(mf, grid, centers, dyn)
    for got in (dynconv.reference_decode(*args, c, k), dynconv.dynamic_pointwise_decode(*args, c, k)):
        assert got.shape == want.shape == (2, i, 8, 8, k) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("jax_decode", sorted(JAX_DECODES))
@pytest.mark.parametrize("c,k,i", SHAPES)
def test_decode_gradients_match_jax(c, k, i, jax_decode):
    """d(features) and d(weights) of sum(tanh(decode) * cotangent)."""
    mf, grid, centers, dyn, cot = _inputs(c, k, i, seed=3)
    decode = JAX_DECODES[jax_decode]

    def loss(mf_, dyn_):
        return jnp.sum(jnp.tanh(decode(mf_, jnp.asarray(grid), jnp.asarray(centers), dyn_, c, k)) * cot)

    want_mf, want_dyn = jax.grad(loss, argnums=(0, 1))(jnp.asarray(mf), jnp.asarray(dyn))
    t_mf, t_grid, t_centers, t_dyn = _port_args(mf, grid, centers, dyn)
    t_mf.requires_grad_(True)
    t_dyn.requires_grad_(True)
    out = dynconv.dynamic_pointwise_decode(t_mf, t_grid, t_centers, t_dyn, c, k)
    (torch.tanh(out) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t_mf.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_mf), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_dyn.grad.numpy(), np.asarray(want_dyn), atol=1e-4, rtol=1e-4)


def _bf16_parts(x: torch.Tensor):
    """f32 x as three bf16 values (f32 whose low 16 bits are zero) that sum
    to it exactly, as K5f's tensor-core body splits h1 and h2: the top 16
    bits of x, of what is left, and of what is left then."""
    parts = []
    for _ in range(3):
        top = (x.view(torch.int32) & -65536).view(torch.float32)
        parts.append(top)
        x = x - top
    return parts


def _emulated_mma_decode(mf, grid, centers, dyn, c, k):
    """K5f's bf16 body in plain f32 arithmetic: NHWC features and weights
    that are bf16 values; layer 1 from b1 - center . W1c, with the grid term
    as products of the grid's three bf16 parts and W1c, and the products of
    layers 2 and 3 as sums over h's three bf16 parts (each part times a bf16
    weight is exact in f32); layer 3 at k = 1 in f32."""
    w1f, w1c, b1, w2, b2, w3, b3 = dynconv._split(dyn, c, k)
    b1_eff = b1 - (centers[..., 0:1] * w1c[:, :, 0] + centers[..., 1:2] * w1c[:, :, 1])
    parts = _bf16_parts(grid)
    assert torch.equal(parts[0] + parts[1] + parts[2], grid)
    x = torch.einsum("bhwc,bicd->bihwd", mf, w1f) + b1_eff[:, :, None, None]
    x = x + sum(torch.einsum("hwe,bied->bihwd", p, w1c) for p in parts)
    h1 = torch.nn.functional.silu(x)
    parts = _bf16_parts(h1)
    assert torch.equal(parts[0] + parts[1] + parts[2], h1)
    h2 = torch.nn.functional.silu(sum(torch.einsum("bihwc,bicd->bihwd", p, w2) for p in parts) + b2[:, :, None, None])
    if k == 1:
        return torch.einsum("bihwc,bick->bihwk", h2, w3) + b3[:, :, None, None]
    parts = _bf16_parts(h2)
    assert torch.equal(parts[0] + parts[1] + parts[2], h2)
    return sum(torch.einsum("bihwc,bick->bihwk", p, w3) for p in parts) + b3[:, :, None, None]


@pytest.mark.parametrize("c,k,i", SHAPES)
def test_tensor_core_decode_arithmetic_matches_jax(c, k, i):
    """The bf16 body's arithmetic on bf16-valued inputs within atol = rtol =
    1e-4 of the JAX chain on the same values (the card test's bound)."""
    mf, grid, centers, dyn, _ = _inputs(c, k, i, seed=5)
    mf, dyn = (torch.from_numpy(a).bfloat16().float().numpy() for a in (mf, dyn))
    want = np.asarray(jax_dynconv.reference_decode(*map(jnp.asarray, (mf, grid, centers, dyn)), c, k))
    got = _emulated_mma_decode(*map(torch.from_numpy, (mf, grid, centers, dyn)), c, k)
    assert got.shape == want.shape == (2, i, 8, 8, k)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("is_bf16", [True, False], ids=["tensor_core", "fma"])
@pytest.mark.parametrize("c,k", [(8, 1), (32, 17)])
def test_decode_plan_covers_every_pixel_and_instance_once(c, k, is_bf16):
    for s, i in ((1, 1), (15, 1), (16, 3), (143, 5), (256, 16), (257, 17), (6400, 100), (6400, 256), (323, 70)):
        strip, strips, group, groups = dynconv.decode_plan(s, i, c, k, is_bf16)
        pixels = [range(x * strip, min(s, (x + 1) * strip)) for x in range(strips)]
        instances = [range(y * group, min(i, (y + 1) * group)) for y in range(groups)]
        for blocks, n in ((pixels, s), (instances, i)):
            assert all(len(r) for r in blocks)
            assert sorted(j for r in blocks for j in r) == list(range(n))
        if is_bf16:  # groups as even as they come: sizes differ by at most one group's remainder
            assert group <= dynconv._MMA_MAX_GROUP[c] and groups == -(-i // dynconv._MMA_MAX_GROUP[c])


def test_decode_checks_its_inputs():
    mf, grid, centers, dyn, _ = _inputs(8, 1, 4)
    args = _port_args(mf, grid, centers, dyn)
    with pytest.raises(ValueError, match="channels_last"):
        dynconv.dynamic_pointwise_decode(args[0].contiguous(), *args[1:], 8, 1)
    with pytest.raises(ValueError, match="do not fit"):
        dynconv.dynamic_pointwise_decode(*args, 8, 2)
    with pytest.raises(ValueError, match="do not fit"):
        dynconv.dynamic_pointwise_decode(args[0], args[1][:4], *args[2:], 8, 1)
    # f64 inputs decode in f64 on the CPU (the reference runs of a f64 model)
    out = dynconv.dynamic_pointwise_decode(*(a.double() for a in args), 8, 1)
    assert out.dtype == torch.float64


def test_masks_to_boxes_matches_jax():
    rng = np.random.RandomState(0)
    masks = (rng.rand(3, 4, 20, 30) > 0.97).astype(np.float32)
    masks[0, 1] = 0.0  # an empty mask: a zero box
    masks[1, 2] = 0.0
    masks[1, 2, 7, 29] = 1.0  # one pixel in the last column
    got = masks_to_boxes(torch.from_numpy(masks))
    want = np.stack([np.asarray(jax_masks_to_boxes(jnp.asarray(m))) for m in masks])
    assert got.shape == (3, 4, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 1].numpy(), [0, 0, 0, 0])
    np.testing.assert_array_equal(got[1, 2].numpy(), [29, 7, 29, 7])


@pytest.mark.parametrize("src,dst", [(64, 8), (32, 8), (10, 8), (8, 16)], ids=["8x_down", "4x_down", "1.25x_down", "2x_up"])
def test_resize_linear_matches_jax_image_resize(src, dst):
    rng = np.random.RandomState(src)
    x = (rng.rand(2, 3, src, 2 * src) > 0.5).astype(np.float32)
    size = (dst, 2 * dst)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, *size), method="linear"))
    got = resize_linear(torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
