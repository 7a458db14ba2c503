"""Parity of the port's fused upsample-add with the JAX Pallas kernel
(interpret mode) and its custom VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sihl_tpu.ops.pallas.fusion import fused_upsample_add as jax_upsample_add
from sihl_tpu_torch.ops.fusion import fused_upsample_add

from torch_parity import to_numpy, to_torch

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_upsample_add_matches_jax_exactly(dtype_name):
    """One add in one dtype: the results are bitwise equal."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.RandomState(0)
    top = rng.randn(2, 4, 8, 128).astype(np.float32)
    lateral = rng.randn(2, 8, 16, 128).astype(np.float32)
    want = jax_upsample_add(
        jnp.asarray(top, jdt), jnp.asarray(lateral, jdt), use_pallas=True, interpret=True
    )
    got = fused_upsample_add(to_torch(top).to(tdt), to_torch(lateral).to(tdt))
    assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(to_numpy(got, nhwc=True), np.asarray(want, np.float32))


def test_fused_upsample_add_rejects_mismatches():
    top = torch.zeros(1, 4, 2, 3)
    with pytest.raises(ValueError, match="lateral must be"):
        fused_upsample_add(top, torch.zeros(1, 4, 4, 5))
    with pytest.raises(ValueError, match="share dtype"):
        fused_upsample_add(top, torch.zeros(1, 4, 4, 6, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_upsample_add(top.to("meta"), torch.zeros(1, 4, 4, 6, device="meta"))


def test_fused_upsample_add_backward_matches_jax():
    """The cotangent of top is the 2x2 block sum of g, that of lateral g
    itself (the JAX custom VJP); f32 sums of four terms, to 1e-6."""
    rng = np.random.RandomState(1)
    top = rng.randn(2, 4, 8, 128).astype(np.float32)
    lateral = rng.randn(2, 8, 16, 128).astype(np.float32)
    g = rng.randn(2, 8, 16, 128).astype(np.float32)
    _, vjp = jax.vjp(
        lambda t, l: jax_upsample_add(t, l, use_pallas=True, interpret=True),
        jnp.asarray(top), jnp.asarray(lateral),
    )
    want_top, want_lateral = vjp(jnp.asarray(g))
    top_t = to_torch(top).requires_grad_(True)
    lateral_t = to_torch(lateral).requires_grad_(True)
    fused_upsample_add(top_t, lateral_t).backward(to_torch(g))
    assert top_t.grad.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(to_numpy(top_t.grad, nhwc=True), np.asarray(want_top), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(to_numpy(lateral_t.grad, nhwc=True), np.asarray(want_lateral))
