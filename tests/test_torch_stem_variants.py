"""The port's stem-variant legs (``sihl_tpu_torch/ops/stem_variants.py``)
against the JAX stem-variant probe's Pallas kernels in interpret mode and
against each leg's defining formula, and the port's probe script run end to
end on the CPU.

The JAX probe (``tools/probe_stem_variants.py``) builds its kernels inside
``main``, so they are reached by running ``main`` once on a loaded copy of
the file: its module-level shapes shrunk, its timing loop replaced by one
call, and ``jax.experimental.pallas.pallas_call`` patched to build each call
in interpret mode and record it.  Its two full-function calls (``resident``
and ``full28``) then run again on this file's own seeded inputs, laid out in
the probe's row-parity and lane-phase form (``prep``, :222-227) with the
weights in its (ky, u, v) order (``sihl_tpu/ops/pallas/stem.py:_remap_kernel``,
kx = 7 zero).  No file in ``tools/`` changes.

Tolerances: ``load`` and ``stage`` copy bf16 values and are held bit for
bit.  ``product`` and ``full`` are bf16 outputs rounded from f32 sums of 147
products: held within one bf16 step, plus the most two f32 sums of the same
products can differ by in two orders (2 * 147 * 2^-24 times the sum of
their magnitudes, which matters only where the products cancel).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from sihl_tpu.ops.pallas.stem import _remap_kernel
from sihl_tpu_torch.ops import stem_variants
from sihl_tpu_torch.ops.stem_variants import MODES, TAPS, stem_variant, stem_variant_reference
from sihl_tpu_torch.tools import probe_stem_variants
from sihl_tpu_torch.tools.probe_timing import order_slack, within_one_bf16_step

PROBE = Path(__file__).resolve().parents[1] / "tools" / "probe_stem_variants.py"
# the JAX probe's shapes, shrunk: one 32 x 32 image, row tiles of 8
BATCH, SIZE, ROWS = 1, 32, 8


def _inputs(seed: int, b: int, h: int, w: int):
    """A seeded image on [0, 1) and N(0, 0.1^2) weights (the JAX probe's
    distributions), as f32 numpy arrays rounded to bf16 values."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32)).bfloat16()
    wt = torch.from_numpy((rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)).bfloat16()
    return x, wt


def _slack(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return order_slack(TAPS, stem_variant_reference(x.float().abs(), w.float().abs(), "full"))


@pytest.fixture(scope="module")
def jax_probe_calls():
    """The JAX probe's pallas_calls by mode, built in interpret mode by its
    own ``main`` at the shrunk shape."""
    spec = importlib.util.spec_from_file_location("jax_probe_stem_variants", PROBE)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    probe.BATCH, probe.SIZE, probe.R, probe.W2 = BATCH, SIZE, ROWS, SIZE // 2
    probe.amortized = lambda fn, x, est_iter_s: float(fn(x))
    recorded = {}
    original = pallas.pallas_call

    def recording(kernel, **kwargs):
        call = original(kernel, interpret=True, **kwargs)
        # the resident call takes the whole image and the weights; full28 four row blocks and the weights
        recorded["resident" if len(kwargs["in_specs"]) == 2 else "full28"] = call
        return call

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(pallas, "pallas_call", recording)
        probe.main()
    return recorded


def _probe_layout(x: torch.Tensor) -> jnp.ndarray:
    """The JAX probe's ``prep`` (tools/probe_stem_variants.py:222-227): the
    padded image split by row parity and lane phase, (B, 2, 6, h2 + R, W2 + 3)."""
    h2, lanes = SIZE // 2, SIZE // 2 + 3
    flat = jnp.asarray(x.float().numpy(), jnp.bfloat16).reshape(BATCH, SIZE, SIZE * 3)
    hp = 2 * h2 + 2 * ROWS
    xp = jnp.pad(flat, ((0, 0), (4, hp - 4 - SIZE), (9, 9)))
    return xp.reshape(BATCH, hp // 2, 2, lanes, 6).transpose(0, 2, 4, 1, 3)


@pytest.mark.parametrize("mode", ["resident", "full28"])
def test_jax_probe_full_kernels_match_plain_full(jax_probe_calls, mode):
    assert set(jax_probe_calls) == {"resident", "full28"}  # main swallows a mode's failure
    x, w = _inputs(0, BATCH, SIZE, SIZE)
    xt = _probe_layout(x)
    wk = _remap_kernel(jnp.asarray(w.float().numpy(), jnp.bfloat16))  # (168, 64), kx = 7 zero
    call = jax_probe_calls[mode]
    want = call(xt, wk) if mode == "resident" else call(xt, xt, xt, xt, wk)
    want = torch.from_numpy(np.asarray(want, np.float32))
    got = stem_variant(x, w, "full")
    assert got.shape == want.shape == (BATCH, SIZE // 2, SIZE // 2, 64) and got.dtype == torch.bfloat16
    assert within_one_bf16_step(got, want, _slack(x, w))


@pytest.mark.parametrize("mode", MODES)
def test_plain_legs_match_their_formulas(mode):
    """Each plain leg against its definition, written out in numpy loops
    over a ragged (2, 10, 14) image (output 5 x 7)."""
    x, w = _inputs(1, 2, 10, 14)
    got = stem_variant(x, w, mode)  # a CPU tensor: the plain version
    b, h, wd, _ = x.shape
    xn, wn = x.double().numpy(), w.double().numpy()
    x_pad = np.pad(xn, ((0, 0), (3, 3), (3, 3), (0, 0)))
    want = np.zeros((b, h // 2, wd // 2, 64))
    for bi in range(b):
        for i in range(h // 2):
            for j in range(wd // 2):
                if mode == "load":
                    want[bi, i, j] = [xn[bi, 2 * i, 2 * j, co % 3] for co in range(64)]
                elif mode == "stage":
                    want[bi, i, j] = [x_pad[bi, 2 * i + co // 21, 2 * j + co % 21 // 3, co % 3] for co in range(64)]
                else:
                    r, c = (0, 0) if mode == "product" else (i, j)
                    want[bi, i, j] = np.einsum("yxc,yxco->o", x_pad[bi, 2 * r : 2 * r + 7, 2 * c : 2 * c + 7], wn)
    want = torch.from_numpy(want)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    if mode in ("load", "stage"):
        assert torch.equal(got.double(), want)
    else:
        slack = _slack(x, w)
        assert within_one_bf16_step(got, want, slack[:, :1, :1] if mode == "product" else slack)


def test_stem_variant_refuses_an_unknown_mode():
    x, w = _inputs(2, 1, 8, 8)
    with pytest.raises(ValueError, match="mode"):
        stem_variant(x, w, "dma")


def test_probe_stem_variants_legs_agree_on_cpu():
    before = stem_variants.stem_variant.launches
    result = probe_stem_variants.run(device="cpu", batch=1, size=32)
    assert stem_variants.stem_variant.launches == before  # the CPU takes the plain versions
    assert set(result["legs"]) == {*MODES, "k4", "library", "plain", "plain_load", "plain_stage", "plain_product"}
    assert all(leg["ms"] is None and leg["launches"] == 0 for leg in result["legs"].values())
    assert all(result["errors"][mode] == 0.0 for mode in (*MODES, "k4"))
    assert result["flops"] == 2 * 16 * 16 * 64 * 147
    assert set(result["leg_bounds"]) == set(MODES)
