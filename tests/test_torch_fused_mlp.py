"""Parity of the port's fused per-anchor MLPs with the JAX package: the
Pallas kernels in interpret mode and the JAX module chain against the port's
``fused_mlps`` on the CPU (its plain version), forward and backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu.layers.mlp import MLP as JaxMLP
from sihl_tpu.ops.pallas import mlp as jax_fused
from sihl_tpu.policy import compute_dtype_scope
from sihl_tpu_torch.convert import state_dict_from_flat
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
    """What the CUDA kernels refuse is refused before any launch; inputs and
    parameters that need a gradient are taken."""
    _, (loc,) = _mlp_pair((1,), "float32", seed=0)
    with pytest.raises(ValueError, match=r"\(M, 256\)"):
        fused_mlp._check_supported(torch.zeros(4, D), [loc], width=256)
    assert fused_mlp._check_supported(torch.zeros(4, D, requires_grad=True), [loc], width=D) == torch.float32
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_mlp.fused_mlps(torch.zeros(4, D, device="meta"), [loc])


@pytest.mark.parametrize("out_dims", [(1, 1), (80, 4)], ids=["loc_iou", "cls_box"])
def test_fused_mlps_gradients_match_jax(out_dims):
    """Gradients of sum_i sum(out_i * w_i) with respect to the input and
    every parameter, f32.  Against JAX autodiff of the module chain: 1e-4 of
    each gradient's largest magnitude (summation order).  Against the Pallas
    backward kernel (interpret mode): 1e-2 of it, because that kernel keeps
    the normalised activations in bf16 even in f32 (mlp.py:_NS_BF16)."""
    m = 256
    jax_mlps, port_mlps = _mlp_pair(out_dims, "float32", seed=7)
    rng = np.random.RandomState(7)
    x = rng.randn(m, D).astype(np.float32)
    weights = [rng.randn(m, n).astype(np.float32) for n in out_dims]
    graphdef, state = nnx.split(jax_mlps)

    def jax_loss(st, xx, fused):
        mlps = nnx.merge(graphdef, st)
        outs = jax_fused.fused_mlps(xx, mlps, interpret=True) if fused else [f(xx) for f in mlps]
        return sum(jnp.sum(o * jnp.asarray(w)) for o, w in zip(outs, weights))

    x_t = torch.from_numpy(x).requires_grad_(True)
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(fused_mlp.fused_mlps(x_t, port_mlps), weights))
    loss.backward()
    got = {"x": x_t.grad.numpy()}
    for i, mlp in enumerate(port_mlps):
        for name, p in mlp.named_parameters():
            got[f"{i}.{name}"] = p.grad.numpy()

    for fused, tol in ((False, 1e-4), (True, 1e-2)):
        grad_state, grad_x = jax.grad(jax_loss, argnums=(0, 1))(state, jnp.asarray(x), fused)
        flat = {".".join(map(str, path)): np.asarray(v[...]) for path, v in nnx.to_flat_state(grad_state)}
        want = {k: v.numpy() for k, v in state_dict_from_flat(flat).items()}  # kernels as weights
        want["x"] = np.asarray(grad_x)
        assert sorted(want) == sorted(got)
        for key, g in got.items():
            w = want[key]
            assert g.shape == w.shape, key
            err = np.abs(g - w).max()
            assert err <= tol * max(np.abs(w).max(), 1e-6), (key, fused, err)
