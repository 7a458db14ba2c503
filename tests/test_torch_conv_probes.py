"""The port's conv-probe functions (``sihl_tpu_torch/ops/conv_probes.py``)
against the JAX probes' Pallas kernels in interpret mode, and the port's
probe scripts run end to end on the CPU.

Each JAX probe is loaded from ``tools/`` by path, its module-level shapes
shrunk on the loaded module, and its ``pallas_call`` run in interpret mode
through a copy of ``jax.experimental.pallas`` given to that module; no file
in ``tools/`` changes.  The same seeded numpy inputs go to the port's
wrapper on CPU tensors, which takes the plain version.

Tolerances: bf16 outputs within one bf16 step of each other, plus the most
two f32 sums of the same products can differ by in two orders (2 * terms *
2^-24 times the sum of their magnitudes; this matters only where the
products cancel); f32 sums and dW within 1e-5 times the sum of the
magnitudes of their terms (f32 sums in another order).
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sihl_tpu_torch.ops import conv_probes
from sihl_tpu_torch.tools import probe_conv1x1, probe_conv3x3, probe_wrt_filter
from sihl_tpu_torch.tools.probe_timing import order_slack, within_one_bf16_step, within_sum_order

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _load_probe(filename: str, **shapes) -> types.ModuleType:
    """The JAX probe ``tools/<filename>`` as a fresh module, with ``shapes``
    set on it and its ``pallas_call`` in interpret mode."""
    spec = importlib.util.spec_from_file_location(f"jax_{Path(filename).stem}", TOOLS / filename)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    interpret = types.ModuleType("pallas_interpret")
    interpret.__dict__.update(vars(pl))
    interpret.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    module.pl = interpret
    for name, value in shapes.items():
        setattr(module, name, value)
    return module


def _bf16_pair(array: np.ndarray):
    """One f32 numpy array as a JAX and a torch bf16 array (both round to
    nearest even, so they hold the same values)."""
    return jnp.asarray(array, jnp.bfloat16), torch.from_numpy(array).to(torch.bfloat16)


def _torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("stats", [False, True], ids=["y", "y_and_stats"])
def test_matmul_stats_matches_jax_probe_kernel(stats):
    probe = _load_probe("probe_conv1x1_pallas.py", M=512, TILE=128)
    rng = np.random.RandomState(0)
    x_j, x_t = _bf16_pair((rng.randn(512, 64) * 0.5).astype(np.float32))
    w_j, w_t = _bf16_pair((rng.randn(64, 256) * 0.05).astype(np.float32))
    outs = probe.build_pallas(stats)(x_j, w_j)
    got = conv_probes.matmul_stats(x_t, w_t, stats=stats)
    y_port = got[0] if stats else got
    y_jax = _torch(outs[0])
    assert y_port.shape == (512, 256) and y_port.dtype == torch.bfloat16
    slack = order_slack(64, x_t.float().abs() @ w_t.float().abs())
    assert within_one_bf16_step(y_port, y_jax, slack)
    if stats:
        yf = x_t.float() @ w_t.float()
        assert within_sum_order(got[1], _torch(outs[1])[0], yf.abs().sum(dim=0))
        assert within_sum_order(got[2], _torch(outs[2])[0], (yf * yf).sum(dim=0))


@pytest.mark.parametrize("ci,co", [(64, 256), (128, 512), (256, 256)])
def test_weight_grad_1x1_matches_jax_probe_kernel(ci, co):
    probe = _load_probe("probe_wrt_filter.py")
    m = 512
    rng = np.random.RandomState(1)
    x_j, x_t = _bf16_pair((rng.randn(m, ci) * 0.1).astype(np.float32))
    dy_j, dy_t = _bf16_pair((rng.randn(m, co) * 0.1).astype(np.float32))
    want = _torch(probe.build_pallas(m, ci, co, 128)(x_j, dy_j))
    got = conv_probes.weight_grad_1x1(x_t, dy_t)
    assert got.shape == (ci, co) and got.dtype == torch.float32
    assert within_sum_order(got, want, x_t.float().abs().T @ dy_t.float().abs())


def test_conv3x3_matches_jax_probe_kernel():
    b, s, rows, c = 2, 16, 8, 64
    probe = _load_probe("probe_conv3x3_pallas.py", B=b, S=s, ROWS=rows)
    rng = np.random.RandomState(2)
    x_j, x_t = _bf16_pair((rng.randn(b, s, s, c) * 0.5).astype(np.float32))
    w_j, w_t = _bf16_pair((rng.randn(3, 3, c, c) * 0.05).astype(np.float32))
    # the JAX probe's pre-haloed row tiles (tools/probe_conv3x3_pallas.py:117-125)
    n_tiles = b * (s // rows)
    xp = jnp.pad(x_j, ((0, 0), (1, 1), (1, 1), (0, 0)))
    tiles = [xp[:, r * rows : r * rows + rows + 2] for r in range(s // rows)]
    x_halo = jnp.stack(tiles, axis=1).reshape(n_tiles, rows + 2, s + 2, c)
    want = _torch(probe.build_pallas(n_tiles)(x_halo, w_j)[0]).reshape(b, s, s, c)
    got = conv_probes.conv3x3(x_t, w_t)
    assert got.shape == (b, s, s, c) and got.dtype == torch.bfloat16
    slack = order_slack(9 * c, conv_probes.conv3x3_reference(x_t.float().abs(), w_t.float().abs()))
    assert within_one_bf16_step(got, want, slack)


def test_probe_conv1x1_legs_agree_on_cpu():
    result = probe_conv1x1.run(device="cpu", batch=2, size=8)
    assert set(result["legs"]) == {"library_conv", "library_conv_stats", "kernel", "kernel_stats", "plain",
                                   "plain_stats"}
    assert all(leg["ms"] is None and leg["launches"] == 0 for leg in result["legs"].values())
    assert result["errors"]["kernel_y"] == 0.0  # on the CPU the wrapper is the plain version


def test_probe_wrt_filter_legs_agree_on_cpu():
    shapes = (("4sq_64_256", 2, 4, 64, 256), ("3sq_128_512", 1, 3, 128, 512), ("5sq_256_256", 1, 5, 256, 256))
    result = probe_wrt_filter.run(device="cpu", shapes=shapes)
    assert list(result) == [name for name, *_ in shapes]
    for shape in result.values():
        assert set(shape["legs"]) == {"library", "kernel", "plain"}
        assert shape["errors"]["kernel"] == 0.0


def test_probe_conv3x3_legs_agree_on_cpu():
    result = probe_conv3x3.run(device="cpu", batch=1, size=13)
    assert set(result["legs"]) == {"library", "kernel", "plain"}
    assert result["errors"]["kernel"] == 0.0
    assert result["flops"] == 2 * 13 * 13 * 64 * 64 * 9


# The work plans of the P4 and P5 kernels (what the wrappers hand each
# block), at the probes' shapes and at ragged row counts, for the H100's 132
# blocks (one an SM) and for fewer.
P5_CASES = [(409_600, 64, 256), (102_400, 128, 512), (102_400, 256, 256), (1, 64, 256), (63, 192, 768),
            (65, 128, 512), (64 * 132 * 6 + 37, 192, 768), (100_003, 256, 256)]


@pytest.mark.parametrize("clusters", [33, 2])
@pytest.mark.parametrize("m,ci,co", P5_CASES)
def test_weight_grad_plan_covers_every_tile_and_chunk_once(m, ci, co, clusters):
    """Every (dW tile, 64-row chunk) pair is some block's exactly once; each
    tile's splits take the chunks in order, back to back; a cluster's four
    blocks share one tile and take four consecutive splits, which add into
    one partial; the tiles cover dW; no more clusters than fit at once
    unless dW has more tiles."""
    ti, splits = conv_probes.weight_grad_plan(m, ci, co, clusters)
    assert ti == (128 if ci % 128 == 0 else 64)
    plan = conv_probes.weight_grad_blocks(m, ci, co, ti, splits)
    tiles = (ci // ti) * (co // 256)
    chunks = -(-m // 64)
    assert splits % 4 == 0 and 4 <= splits <= max(4, chunks + 3)
    assert len(plan) == tiles * splits and len(plan) // 4 <= max(clusters, tiles)
    for k in range(len(plan) // 4):
        members = plan[4 * k : 4 * k + 4]
        assert len({(ci0, co0) for ci0, co0, *_ in members}) == 1
        assert [split for _, _, split, _, _ in members] == list(range(members[0][2], members[0][2] + 4))
        assert members[0][2] % 4 == 0  # one partial a cluster
    covered = {}
    for ci0, co0, split, first, end in plan:
        assert ci0 % ti == 0 and co0 % 256 == 0 and ci0 < ci and co0 < co
        covered.setdefault((ci0, co0), []).append((split, first, end))
    assert len(covered) == tiles
    for runs in covered.values():
        assert [split for split, _, _ in runs] == list(range(splits))  # in block order
        assert runs[0][1] == 0 and runs[-1][2] == chunks
        assert all(a[2] == b[1] for a, b in zip(runs, runs[1:]))  # back to back
        assert all(first <= end for _, first, end in runs)
    # the clusters of one group of splits sit next to each other, ci fastest
    assert [b[2] // 4 for b in plan] == sorted(b[2] // 4 for b in plan)


@pytest.mark.parametrize("m", [1, 63, 65, 409_600, 64 * 132 * 3 + 5])
def test_matmul_stats_blocks_take_every_tile_once(m):
    """P4's persistent blocks: block b takes tiles b, b + blocks, ...; every
    64-row tile is taken once and no block is idle."""
    tiles = -(-m // 64)
    for resident in (132, 5):
        blocks = conv_probes.matmul_stats_blocks(m, resident)
        assert 1 <= blocks <= min(tiles, resident)
        taken = sorted(t for b in range(blocks) for t in range(b, tiles, blocks))
        assert taken == list(range(tiles))


@pytest.mark.parametrize("b,h,w", [(1, 1, 1), (1, 2, 64), (2, 13, 13), (1, 7, 45), (3, 32, 130), (16, 160, 160)])
def test_conv3x3_plan_takes_every_output_pixel_once(b, h, w):
    """P2's persistent blocks: every output pixel lies in exactly one tile
    of one block, no tile lies wholly outside its image, the blocks' tile
    counts differ by at most one, and each block's consumer warpgroups take
    its tiles in turn."""
    tiles, rows, cols = conv_probes.conv3x3_tiles(b, h, w)
    assert (rows, cols) == (-(-h // 2), -(-w // 64))
    for resident in (132, 5):
        blocks = conv_probes.conv3x3_blocks(b, h, w, resident)
        assert blocks == min(tiles, resident)
        plan = conv_probes.conv3x3_plan(b, h, w, blocks)
        assert len(plan) == blocks
        counts = [len(mine) for mine in plan]
        assert max(counts) - min(counts) <= 1 and sum(counts) == tiles
        covered = np.zeros((b, h, w), np.int64)
        for mine in plan:
            assert [wg for *_, wg in mine] == [n % 2 for n in range(len(mine))]
            for image, r0, c0, _ in mine:
                assert 0 <= image < b and 0 <= r0 < h and 0 <= c0 < w
                covered[image, r0 : r0 + 2, c0 : c0 + 64] += 1
        assert (covered == 1).all()


def test_conv3x3_tile_constants_match_the_source():
    """The tile and warpgroup counts the plan uses are the kernel's."""
    source = (Path(conv_probes.__file__).parent / "csrc" / "conv_probes.cu").read_text()
    p2 = source[source.index("namespace p2 {"):]
    assert f"constexpr int TR = {conv_probes.P2_TILE[0]}, TC = {conv_probes.P2_TILE[1]};" in p2
    assert f"constexpr int WGS = {conv_probes.P2_WARPGROUPS};" in p2


def test_probe_conv_variants_edits_match_the_source():
    """Every edit the variant probe makes to csrc/conv_probes.cu finds its
    text there once, so the probe builds what it says it builds."""
    from sihl_tpu_torch.tools import probe_conv_variants

    source = (Path(conv_probes.__file__).parent / "csrc" / "conv_probes.cu").read_text()
    edits = [e for v in (probe_conv_variants.P4_VARIANTS, probe_conv_variants.P5_VARIANTS,
                         probe_conv_variants.P2_VARIANTS) for es in v.values() for e in es]
    assert edits
    for old, new in edits:
        assert source.count(old) == 1 and old != new
