"""Parity of the port's fused upsample-add with the JAX Pallas kernel (interpret mode)."""

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
