"""Parity of the port's fused per-anchor MLPs with the JAX package: the
Pallas kernel in interpret mode and the JAX module chain against the port's
``fused_mlps`` on the CPU (its plain version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu.layers.mlp import MLP as JaxMLP
from sihl_tpu.ops.pallas import mlp as jax_fused
from sihl_tpu.policy import compute_dtype_scope
from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops import fused_mlp
from sihl_tpu_torch.policy import compute_dtype_scope as torch_compute_dtype_scope

from torch_parity import load_from_jax, randomize_norms, to_numpy

D = 128
# (atol, rtol): f32 differs by summation order only; bf16 by where each
# side rounds (the kernel keeps y in f32 before LayerNorm, the chain does not)
TOL = {"float32": (1e-4, 0.0), "bfloat16": (5e-2, 5e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _mlp_pair(out_dims, dtype_name, seed):
    jdt, tdt = DTYPES[dtype_name]
    with compute_dtype_scope(jdt), torch_compute_dtype_scope(tdt):
        rngs = nnx.Rngs(seed)
        jax_mlps = [
            JaxMLP(D, [D] * 4 + [n], final_bias_init=-5.0 if i == 0 else None, rngs=rngs)
            for i, n in enumerate(out_dims)
        ]
        rng = np.random.RandomState(seed)
        for j in jax_mlps:
            randomize_norms(j, rng)
            for lin in list(j.linears)[:-1]:
                lin.bias[...] = jnp.asarray(rng.uniform(-0.1, 0.1, D), jnp.float32)
        port_mlps = [load_from_jax(MLP(D, [D] * 4 + [n]), j) for n, j in zip(out_dims, jax_mlps)]
    return jax_mlps, port_mlps


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dims", [(1,), (80, 4)], ids=["loc", "cls_box"])
@pytest.mark.parametrize("m", [333, 512])
def test_fused_mlps_match_jax(m, out_dims, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    atol, rtol = TOL[dtype_name]
    jax_mlps, port_mlps = _mlp_pair(out_dims, dtype_name, seed=m)
    x = np.random.RandomState(m).randn(m, D).astype(np.float32)
    x_j = jnp.asarray(x, jdt)
    kernel = jax_fused.fused_mlps(x_j, jax_mlps, interpret=True)
    chain = [mlp(x_j) for mlp in jax_mlps]
    with torch.no_grad():
        got = fused_mlp.fused_mlps(torch.from_numpy(x).to(tdt), port_mlps)
    for g, k, c, n in zip(got, kernel, chain, out_dims):
        assert g.shape == (m, n) and g.dtype == tdt
        g = to_numpy(g)
        np.testing.assert_allclose(g, np.asarray(k, np.float32), atol=atol, rtol=rtol)
        np.testing.assert_allclose(g, np.asarray(c, np.float32), atol=atol, rtol=rtol)


def test_kernel_shape_checks():
    """What the CUDA kernel refuses is refused before any launch."""
    _, (loc,) = _mlp_pair((1,), "float32", seed=0)
    with pytest.raises(ValueError, match=r"\(M, 256\)"):
        fused_mlp._check_supported(torch.zeros(4, D), [loc], width=256)
    with pytest.raises(NotImplementedError, match="no backward"):
        fused_mlp._check_supported(torch.zeros(4, D), [loc], width=D)
    with torch.no_grad():
        assert fused_mlp._check_supported(torch.zeros(4, D), [loc], width=D) == torch.float32
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_mlp.fused_mlps(torch.zeros(4, D, device="meta"), [loc])
