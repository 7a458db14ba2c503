"""The port's fused-MLP pipeline modes (``sihl_tpu_torch/ops/mlp_pipeline.py``)
against the JAX fused-MLP pipeline probe's Pallas kernels in interpret mode,
and the port's probe script run end to end on the CPU.

The JAX probe (``tools/probe_mlp_pipeline.py``) is loaded by path with its
module-level shapes shrunk (M = 256 rows, TILE = 64: four grid steps, and
even halves for its pingpong split), and its ``build(mode, heads)`` runs
each of the five modes with ``jax.experimental.pallas.pallas_call`` patched
to interpret mode and ``jnp.dot`` patched to take bf16 operands, as a bf16
matrix unit takes them (only the mxured modes' products with the ones
column have f32 operands; XLA on the CPU would sum those in f32).  Its
parameters and x come from its own ``make_params`` and ``main``'s draw;
``mlps_from_probe_params`` carries the same numpy arrays into the port's
MLPs.  No file in ``tools/`` changes.

Tolerance (``probe_timing.within_rounding_flips``): equal outputs but in
at most a tenth of them, and there by at most one bf16 step at the largest
output.  Both sides follow the probe kernel's roundings with f32 sums in
another order, so an output moves only where a bf16 rounding on its way
falls the other way.  Observed here: 2 of 512 outputs differ in base and
pingpong (by up to 0.001953125, one bf16 step of an output near 0.5), 3 in
nops (0.00061), 12 in the mxured modes (0.0029); a different function
(two-pass against one-pass variance) moves more than half of them.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from sihl_tpu_torch.ops import fused_mlp, mlp_pipeline
from sihl_tpu_torch.ops.mlp_pipeline import (MODES, mlp_pipeline_reference, mlps_from_probe_params,
                                             probe_params)
from sihl_tpu_torch.tools import probe_mlp_pipeline
from sihl_tpu_torch.tools.probe_timing import differing_share, within_rounding_flips

PROBE = Path(__file__).resolve().parents[1] / "tools" / "probe_mlp_pipeline.py"
ROWS, TILE = 256, 64  # the JAX probe's M and TILE, shrunk
TOL = 2e-2  # the JAX probe's check between its modes


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe's parameters and x at the shrunk shape (drawn as its
    ``main`` draws them), and each mode's outputs from its Pallas kernel in
    interpret mode, its products taking bf16 operands."""
    spec = importlib.util.spec_from_file_location("jax_probe_mlp_pipeline", PROBE)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    probe.M, probe.TILE = ROWS, TILE
    rng = np.random.RandomState(0)
    heads = probe.make_params(rng)
    x = jnp.asarray(rng.randn(probe.M, probe.D) * 0.5, jnp.bfloat16)
    outs = {}
    dot = jnp.dot

    def bf16_operand_dot(a, b, **kwargs):
        return dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), **kwargs)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(pallas, "pallas_call", functools.partial(pallas.pallas_call, interpret=True))
        patch.setattr(jnp, "dot", bf16_operand_dot)
        for mode in MODES:
            call = probe.build(mode, heads)
            outs[mode] = [np.asarray(o, np.float32) for o in call(x, *[p for h in heads for p in h])]
    return heads, x, outs


def _port_inputs(heads, x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16(), mlps_from_probe_params(heads, "cpu")


@pytest.mark.parametrize("mode", MODES)
def test_plain_modes_match_the_jax_probe_kernels(jax_probe, mode):
    heads, x, outs = jax_probe
    x_cpu, mlps = _port_inputs(heads, x)
    got = mlp_pipeline.mlp_pipeline(x_cpu, mlps, mode)  # a CPU tensor: the plain version
    assert len(got) == len(outs[mode]) == 2
    for g, want in zip(got, outs[mode]):
        assert g.shape == want.shape == (ROWS, 1) and g.dtype == torch.bfloat16
    got, want = torch.cat(got).float(), torch.from_numpy(np.concatenate(outs[mode]))
    print(f"{mode}: {differing_share(got, want):.2%} of the outputs differ from the JAX probe's kernel, "
          f"by up to {float((got - want).abs().max())}")
    assert within_rounding_flips(got, want)


def test_probe_params_draw_the_jax_probes_arrays(jax_probe):
    heads, x, _ = jax_probe
    ours, x_ours = probe_params(0, ROWS)
    assert np.array_equal(x_ours, np.asarray(x, np.float32))
    for theirs, mine in zip(heads, ours):
        for a, b in zip(theirs, mine):
            a = np.asarray(a, np.float32)
            assert a.shape == b.shape and b.dtype == np.float32 and np.array_equal(a, b)


def test_mlps_hold_the_probe_params_exactly():
    heads, _ = probe_params(3, 8)
    mlps = mlps_from_probe_params(heads, "cpu")
    for (wh, bh, sc, bi, wo, bo), mlp in zip(heads, mlps):
        assert mlp.dtype == torch.bfloat16 and len(mlp.norms) == 4
        for l in range(4):
            assert torch.equal(mlp.linears[l].weight, torch.from_numpy(wh[l].T.copy()))
            assert torch.equal(mlp.linears[l].weight.bfloat16().float(), mlp.linears[l].weight)
            assert torch.equal(mlp.linears[l].bias, torch.from_numpy(bh[l]))
            assert torch.equal(mlp.norms[l].weight, torch.from_numpy(sc[l]))
            assert torch.equal(mlp.norms[l].bias, torch.from_numpy(bi[l]))
        assert torch.equal(mlp.linears[-1].weight, torch.from_numpy(wo.T.copy()))
        assert torch.equal(mlp.linears[-1].bias, torch.from_numpy(bo[0]))


def _formula(x: np.ndarray, head, mode: str) -> np.ndarray:
    """The probe kernel's function for one MLP in numpy, row by row in f64
    between its bf16 roundings."""
    wh, bh, sc, bi, wo, bo = (np.asarray(a, np.float64) for a in head)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).double().numpy()

    h = x.astype(np.float64)
    for l in range(wh.shape[0]):
        y = h @ wh[l] + bh[l]
        if mode == "nops":
            h = bf16(y)
            continue
        if "mxured" in mode:  # the sums of the operands a bf16 matrix unit takes
            mu = bf16(y).mean(-1, keepdims=True)
            var = bf16(y * y).mean(-1, keepdims=True) - mu * mu
        else:
            mu = y.mean(-1, keepdims=True)
            var = ((y - mu) ** 2).mean(-1, keepdims=True)
        z = bf16((y - mu) / np.sqrt(var + 1e-5) * sc[l] + bi[l])
        h = bf16(z / (1 + np.exp(-z)))
    return h @ wo + bo[0]


@pytest.mark.parametrize("mode", MODES)
def test_plain_modes_at_ragged_rows(mode):
    """200 rows: one whole 128-row block and a last one that its two
    64-row warpgroups split 64 + 8; the plain version against the formula,
    and the modes that compute one function bit for bit."""
    heads, x = probe_params(5, 200)
    x_cpu, mlps = _port_inputs(heads, x)
    got = mlp_pipeline.mlp_pipeline(x_cpu, mlps, mode)
    for g, head in zip(got, heads):
        assert g.shape == (200, 1) and torch.isfinite(g.float()).all()
        assert within_rounding_flips(g, _bf16_formula(x, head, mode))
    same = {"pingpong": "base", "pp+mxured": "mxured"}.get(mode)
    if same:
        assert all(torch.equal(a, b) for a, b in zip(got, mlp_pipeline_reference(x_cpu, mlps, same)))


def _bf16_formula(x: np.ndarray, head, mode: str) -> torch.Tensor:
    return torch.from_numpy(_formula(x, head, mode)).bfloat16()


def test_plain_two_pass_variance_at_a_large_row_mean():
    """LayerNorm and SiLU of the plain base (and pingpong) version on f32
    rows whose mean is 256, 640 of their standard deviations, against the
    f64 formula: 2.3% of the outputs differ here, where E[y^2] - mean^2 in
    f32 (a one-pass variance) moves 85% of them, by up to 0.19."""
    rng = np.random.RandomState(9)
    y = (256.0 + 0.4 * rng.randn(64, 256)).astype(np.float32)
    sc, bi = (1.0 + 0.05 * rng.randn(256)).astype(np.float32), (0.05 * rng.randn(256)).astype(np.float32)
    got = mlp_pipeline._ln_silu(torch.from_numpy(y), torch.from_numpy(sc), torch.from_numpy(bi), one_pass=False)
    y = y.astype(np.float64)
    z = torch.from_numpy((y - y.mean(-1, keepdims=True)) / np.sqrt(y.var(-1, keepdims=True) + 1e-5) * sc + bi)
    z = z.bfloat16().double()
    assert within_rounding_flips(got, (z / (1 + torch.exp(-z))).bfloat16())


def test_pingpong_modes_equal_their_functions_on_cpu():
    heads, x = probe_params(6, 64)
    x_cpu, mlps = _port_inputs(heads, x)
    out = {mode: mlp_pipeline.mlp_pipeline(x_cpu, mlps, mode) for mode in MODES}
    for mode, same in (("pingpong", "base"), ("pp+mxured", "mxured")):
        assert all(torch.equal(a, b) for a, b in zip(out[mode], out[same]))
    assert not all(torch.equal(a, b) for a, b in zip(out["mxured"], out["base"]))  # one pass against two


def test_mlp_pipeline_refuses_an_unknown_mode():
    heads, x = probe_params(7, 8)
    x_cpu, mlps = _port_inputs(heads, x)
    with pytest.raises(ValueError, match="mode"):
        mlp_pipeline.mlp_pipeline(x_cpu, mlps, "halves")
    with pytest.raises(ValueError, match="mode"):
        mlp_pipeline_reference(x_cpu, mlps, "halves")


def test_probe_mlp_pipeline_runs_on_cpu():
    before = (mlp_pipeline.mlp_pipeline.launches, fused_mlp.fused_mlps.launches)
    result = probe_mlp_pipeline.run(device="cpu", m=256)
    assert (mlp_pipeline.mlp_pipeline.launches, fused_mlp.fused_mlps.launches) == before  # plain versions only
    assert set(result["legs"]) == {*MODES, "plain", "plain_nops", "plain_mxured", "library"}
    assert all(leg["ms"] is None and leg["launches"] == 0 for leg in result["legs"].values())
    assert all(result["errors"][mode] == 0.0 for mode in MODES)
    assert result["errors"]["pingpong_vs_base"] == 0.0 and result["errors"]["mxured_vs_base"] < TOL
    assert all(result["shares"][mode] == 0.0 for mode in MODES)
    assert result["shares"]["mxured_vs_base"] > 0.5  # these data tell the two variances apart
    assert result["flops"] == 2 * 2 * 256 * 256 * (4 * 256 + 1)
