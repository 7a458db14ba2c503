"""The hand-written kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). The file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest
"""

import copy
import itertools
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops import conv_probes, dynconv, fused_mlp, mlp_pipeline, stem, stem_variants, topk
from sihl_tpu_torch.ops.fusion import (
    fused_upsample_add,
    fused_upsample_add_reference,
    fused_weighted_sum,
    fused_weighted_sum_reference,
)
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.tools.probe_timing import order_slack, within_rounding_flips, within_sum_order


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.fixture
def full_f32_convs():
    """cuDNN's f32 convs in full f32, not TF32, for the plain versions."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


def _random_mlp(out: int, gen: torch.Generator) -> MLP:
    """An MLP whose every bias and LayerNorm affine parameter is random, so
    that the kernel's reads of each (per layer) are checked."""
    mlp = MLP(256, [256] * 4 + [out], generator=gen, device="cpu")
    with torch.no_grad():
        for lin in mlp.linears:
            lin.bias.uniform_(-0.1, 0.1, generator=gen)
        for norm in mlp.norms:
            norm.weight.uniform_(0.8, 1.2, generator=gen)
            norm.bias.uniform_(-0.1, 0.1, generator=gen)
    return mlp.cuda()


def _within_one_bf16_step(got: torch.Tensor, want: torch.Tensor, slack=0.0) -> bool:
    """Every element within one bf16 step (the spacing of bf16 values at the
    larger of the two magnitudes) of the other, plus ``slack``."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs())
    step = torch.exp2(torch.floor(torch.log2(torch.where(mag > 0, mag, 1.0))) - 7)
    return bool(((got - want).abs() <= step + slack).all())


@pytest.mark.cuda
def test_fused_mlp_kernel_matches_plain_version_on_card():
    _need_card()
    gen = torch.Generator().manual_seed(0)
    for tdt, atol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        with compute_dtype_scope(tdt):
            mlps = [_random_mlp(n, gen) for n in (1, 80, 4)]
        for m in (1, 64, 65, 333, 1600):
            x = torch.randn(m, 256, generator=gen).to("cuda", tdt)
            with torch.no_grad():
                got = fused_mlp.fused_mlps(x, mlps)
                ref = fused_mlp.fused_mlps_reference(x, mlps)
            for g, r in zip(got, ref):
                torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=atol)


@pytest.mark.cuda
def test_fused_mlp_kernel_matches_plain_version_at_quad_outputs_on_card():
    """K1f with the quadrilateral head's gathered MLPs (8 and 5 outputs) at
    its serving and training row counts."""
    _need_card()
    gen = torch.Generator().manual_seed(6)
    for tdt, atol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        with compute_dtype_scope(tdt):
            mlps = [_random_mlp(n, gen) for n in (8, 5)]
        for m in (1600, 2880):
            x = torch.randn(m, 256, generator=gen).to("cuda", tdt)
            with torch.no_grad():
                got = fused_mlp.fused_mlps(x, mlps)
                ref = fused_mlp.fused_mlps_reference(x, mlps)
            for g, r in zip(got, ref):
                torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=atol)


def mlp_gradients(fn, x, mlps, weights):
    """dx and every parameter's gradient of sum_i sum(fn(x, mlps)[i] * w_i)."""
    x = x.detach().requires_grad_(True)
    for p in (p for m in mlps for p in m.parameters()):
        p.grad = None
    loss = sum((o.float() * w).sum() for o, w in zip(fn(x, mlps), weights))
    loss.backward()
    return [x.grad] + [p.grad for m in mlps for p in m.parameters()]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "outs", [(1, 1), (80, 4), (80, 169), (8, 5)], ids=["loc_iou", "cls_box", "cls_kernel", "quad_class"]
)
def test_fused_mlp_backward_kernel_matches_plain_autograd_on_card(outs):
    """K1b against autograd of the plain chain.  dx within atol = rtol =
    ``tol``; every parameter gradient's largest error within ``tol`` times its
    largest magnitude (tests/ops/test_fused_mlp.py bounds bf16 so)."""
    _need_card()
    gen = torch.Generator().manual_seed(1)
    for tdt, tol in ((torch.bfloat16, 1e-1), (torch.float32, 1e-3)):
        with compute_dtype_scope(tdt):
            mlps = [_random_mlp(n, gen) for n in outs]
        for m in (1, 65, 333, 2000):
            x = torch.randn(m, 256, generator=gen).to("cuda", tdt)
            weights = [torch.randn(m, n, generator=gen).cuda() for n in outs]
            before = fused_mlp.fused_mlps_backward.launches
            got = mlp_gradients(fused_mlp.fused_mlps, x, mlps, weights)
            assert fused_mlp.fused_mlps_backward.launches == before + 1  # one launch for all MLPs
            want = mlp_gradients(fused_mlp.fused_mlps_reference, x, mlps, weights)
            torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
            for g, w in zip(got[1:], want[1:]):
                assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
                err = float((g - w).abs().max())
                assert err <= tol * max(float(w.abs().max()), 1e-6), (tuple(g.shape), m, tdt, err)


RAGGED_ROWS = (1, 63, 64, 65, 127, 129, 1600)
OUTPUTS = [(1,), (1, 1), (80, 4), (8, 5), (80, 169)]
OUTPUT_IDS = ["loc", "loc_iou", "cls_box", "quad_class", "cls_kernel"]


@pytest.mark.cuda
@pytest.mark.parametrize("outs", OUTPUTS, ids=OUTPUT_IDS)
def test_fused_mlp_kernel_at_ragged_rows_on_card(outs):
    """K1f at row counts around the 64- and 128-row tiles, one launch per
    call, against the plain chain at the tolerances above.  The largest,
    ragged at 128, fills the card with 128-row tiles (two consumer
    warpgroups a block)."""
    _need_card()
    gen = torch.Generator().manual_seed(7)
    for tdt, atol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        with compute_dtype_scope(tdt):
            mlps = [_random_mlp(n, gen) for n in outs]
        for m in RAGGED_ROWS + (16961,):
            x = torch.randn(m, 256, generator=gen).to("cuda", tdt)
            with torch.no_grad():
                before = fused_mlp.fused_mlps.launches
                got = fused_mlp.fused_mlps(x, mlps)
                assert fused_mlp.fused_mlps.launches == before + 1
                ref = fused_mlp.fused_mlps_reference(x, mlps)
            for g, r in zip(got, ref):
                torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("outs", OUTPUTS, ids=OUTPUT_IDS)
def test_fused_mlp_backward_kernel_at_ragged_rows_on_card(outs):
    """K1b at row counts around the 64-row tile, against autograd of the
    plain chain at the tolerances of the test above; two calls give bitwise
    equal gradients (fixed-order sums, no atomics)."""
    _need_card()
    gen = torch.Generator().manual_seed(8)
    for tdt, tol in ((torch.bfloat16, 1e-1), (torch.float32, 1e-3)):
        with compute_dtype_scope(tdt):
            mlps = [_random_mlp(n, gen) for n in outs]
        for m in RAGGED_ROWS:
            x = torch.randn(m, 256, generator=gen).to("cuda", tdt)
            weights = [torch.randn(m, n, generator=gen).cuda() for n in outs]
            before = fused_mlp.fused_mlps_backward.launches
            got = mlp_gradients(fused_mlp.fused_mlps, x, mlps, weights)
            again = mlp_gradients(fused_mlp.fused_mlps, x, mlps, weights)
            assert fused_mlp.fused_mlps_backward.launches == before + 2
            want = mlp_gradients(fused_mlp.fused_mlps_reference, x, mlps, weights)
            for g, a in zip(got, again):
                assert torch.equal(g, a), "two K1b calls differ"
            torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
            for g, w in zip(got[1:], want[1:]):
                assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
                err = float((g - w).abs().max())
                assert err <= tol * max(float(w.abs().max()), 1e-6), (tuple(g.shape), m, tdt, err)


# output layers wider than 256 (the tensor-core output path): one block and
# one output past it, the keypoint head's kernel MLP (2,737) beside its
# presence MLP (17) in one call, and c = 32 with 68 keypoints (4,420)
WIDE_OUTPUTS = [(257,), (17, 2737), (4420, 1)]
WIDE_IDS = ["one_past", "keypoint", "face_landmarks"]


@pytest.mark.cuda
@pytest.mark.parametrize("outs", WIDE_OUTPUTS, ids=WIDE_IDS)
def test_fused_mlp_wide_output_kernels_match_plain_versions_on_card(outs):
    """K1f and K1b with an output layer wider than 256, at ragged row counts
    and the keypoint path's gathered rows (1,600 serving, 2,048 training),
    against the plain chain and its autograd at the tolerances of the tests
    above, dx held as the parameter gradients are (its largest error within
    ``tol`` of its largest magnitude: dh sums n_out products, so dx grows
    with the output width and a fixed atol tightens with it); one launch a
    call, and two K1b calls bitwise equal."""
    _need_card()
    gen = torch.Generator().manual_seed(9)
    for tdt, atol, tol in ((torch.bfloat16, 5e-2, 1e-1), (torch.float32, 1e-3, 1e-3)):
        with compute_dtype_scope(tdt):
            mlps = [_random_mlp(n, gen) for n in outs]
        for m in (1, 65, 1600, 2048):
            x = torch.randn(m, 256, generator=gen).to("cuda", tdt)
            with torch.no_grad():
                before = fused_mlp.fused_mlps.launches
                got = fused_mlp.fused_mlps(x, mlps)
                assert fused_mlp.fused_mlps.launches == before + 1
                ref = fused_mlp.fused_mlps_reference(x, mlps)
            for g, r in zip(got, ref):
                assert g.shape == r.shape == (m, g.shape[1])
                torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=atol)
            weights = [torch.randn(m, n, generator=gen).cuda() for n in outs]
            before = fused_mlp.fused_mlps_backward.launches
            grads = mlp_gradients(fused_mlp.fused_mlps, x, mlps, weights)
            again = mlp_gradients(fused_mlp.fused_mlps, x, mlps, weights)
            assert fused_mlp.fused_mlps_backward.launches == before + 2
            want = mlp_gradients(fused_mlp.fused_mlps_reference, x, mlps, weights)
            for g, a in zip(grads, again):
                assert torch.equal(g, a), "two K1b calls differ"
            assert grads[0].shape == want[0].shape and grads[0].dtype == want[0].dtype == tdt
            for g, w in zip(grads, want):
                err = float((g.float() - w.float()).abs().max())
                assert err <= tol * max(float(w.float().abs().max()), 1e-6), (tuple(g.shape), m, tdt, err)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 64, 65, 1600, 14400])
def test_fused_mlp_weight_gradient_gemm_on_card(m):
    """The bf16 backward's dW GEMM alone (tile images, split-M wgmma,
    fixed-order reduction) against dy^T h in f32: the same bf16 products,
    summed in another order."""
    _need_card()
    gen = torch.Generator().manual_seed(m)
    h = torch.randn(m, 256, generator=gen).to("cuda", torch.bfloat16)
    dy = torch.randn(m, 256, generator=gen).to("cuda", torch.bfloat16)
    got = fused_mlp.dw_gemm_alone(h, dy)
    want = dy.float().T @ h.float()
    torch.testing.assert_close(got, want, atol=1e-3 * max(1.0, m ** 0.5), rtol=1e-4)


def _assert_same(got: torch.Tensor, want: torch.Tensor) -> None:
    """Bit for bit, NaN where the other is NaN."""
    torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)


@pytest.mark.cuda
def test_row_kth_kernel_matches_plain_version_on_card():
    """K2 is bitwise equal to its plain version, with ties, zeros and zero
    rows, at each template instance's edges (ROW_PLANS) and the widest row,
    at k = 1, with a NaN in a row, and with fewer distinct values than k."""
    _need_card()
    lib = topk._library()
    widest = topk.ROW_PLANS[-1][0] * topk.ROW_PLANS[-1][1]
    assert lib.sihl_row_kth_max_cols() == widest
    edges = [(3, t * v + d, 9) for t, v in topk.ROW_PLANS[:-1] for d in (0, 1)]
    gen = torch.Generator().manual_seed(2)
    for g, a, k in [(1600, 8525, 9), (7, 33, 9), (5, 1000, 1), (3, 4, 9), (4, 8400, 1), (3, widest, 9)] + edges:
        x = torch.rand(g, a, generator=gen)
        x = torch.where(x < 0.3, 0.0, torch.round(x * 50) / 50)  # zeros and many ties
        x[0] = 0.0
        x = x.cuda()
        before = topk.row_best_and_kth.launches
        best, kth = topk.row_best_and_kth(x, k)
        assert topk.row_best_and_kth.launches == before + 1
        want_best, want_kth = topk._row_reference(x, k)
        assert torch.equal(best, want_best) and torch.equal(kth, want_kth)
        assert float(kth[0]) == -1.0 or k == 1
    x = torch.rand(4, 8525, generator=gen)
    x[1, 4000] = float("nan")  # a NaN: the row's maximum and k-th value are NaN
    x[2] = 0.0
    x[2, :3] = torch.tensor([0.5, 0.5, 0.25])  # two distinct values above zero, fewer than k
    x[3, :2] = float("inf")
    x = x.cuda()
    for k in (1, 2, 9):
        best, kth = topk.row_best_and_kth(x, k)
        want_best, want_kth = topk._row_reference(x, k)
        _assert_same(best, want_best)
        _assert_same(kth, want_kth)
        assert bool(torch.isnan(kth[1])) and (k < 4 or float(kth[2]) == -1.0)
    with pytest.raises(ValueError, match="columns"):
        topk.row_best_and_kth(torch.zeros(2, widest + 1, device="cuda"), 9)


@pytest.mark.cuda
def test_upsample_add_kernel_matches_plain_version_on_card():
    _need_card()
    gen = torch.Generator().manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        for h in (40, 20, 10, 3):
            top = torch.randn(2, 256, h, h + 1, generator=gen)
            lat = torch.randn(2, 256, 2 * h, 2 * h + 2, generator=gen)
            top, lat = (
                t.to("cuda", dt).contiguous(memory_format=torch.channels_last) for t in (top, lat)
            )
            got = fused_upsample_add(top, lat)
            assert torch.equal(got, fused_upsample_add_reference(top, lat))


def _check_weighted_sum(n, shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    for dt in (torch.bfloat16, torch.float32):
        for shape in shapes:
            xs = [torch.randn(shape, generator=gen).to("cuda", dt).contiguous(memory_format=torch.channels_last)
                  for _ in range(n)]
            w = torch.softmax(torch.randn(n, generator=gen), dim=0).cuda()
            g = torch.randn(shape, generator=gen).to("cuda", dt).contiguous(memory_format=torch.channels_last)
            grads = []
            for fn in (fused_weighted_sum, fused_weighted_sum_reference):
                leaves = [w.clone().requires_grad_(True)] + [x.clone().requires_grad_(True) for x in xs]
                before = fused_weighted_sum.launches
                out = fn(leaves[0], leaves[1:])
                assert fused_weighted_sum.launches == before + (fn is fused_weighted_sum)
                out.backward(g)
                grads.append([out.detach()] + [t.grad for t in leaves])
            (got, *got_grads), (want, *want_grads) = grads
            assert got.dtype == dt and got.is_contiguous(memory_format=torch.channels_last)
            if dt == torch.bfloat16:
                assert _within_one_bf16_step(got, want)
            else:
                assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
            for a, b in zip(got_grads, want_grads):
                assert a.dtype == b.dtype
                err = float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(b.double()))
                assert err <= 1e-6, err


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3])
def test_weighted_sum_kernel_matches_plain_version_on_card(n):
    """K6 against its plain version (the same f32 order, no fused
    multiply-add): bf16 within one bf16 step, f32 within 1e-6 of the largest
    magnitude; its backward (plain PyTorch) against autograd of the plain
    version within 1e-6 relative."""
    _need_card()
    _check_weighted_sum(n, ((2, 128, 20, 20), (3, 16, 7, 9)), 7)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3])
def test_weighted_sum_kernel_at_64_channels_on_card(n):
    """K6 as the EfficientDet-D0 BiFPN runs it: 64 channels at batch 16 on
    4 x 4, 8 x 8 and 64 x 64 maps, held as above."""
    _need_card()
    _check_weighted_sum(n, ((16, 64, 4, 4), (16, 64, 8, 8), (16, 64, 64, 64)), 11)


@pytest.mark.cuda
def test_weighted_sum_kernel_refuses_what_it_does_not_take():
    _need_card()
    x = torch.zeros(1, 8, 4, 4, device="cuda").contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels_last"):
        fused_weighted_sum(torch.ones(2, device="cuda"), [x.contiguous(), x.contiguous()])
    with pytest.raises(ValueError, match="float32 weights"):
        fused_weighted_sum(torch.ones(2, device="cuda", dtype=torch.float64), [x, x])
    with pytest.raises(ValueError, match="2 or 3 inputs"):
        fused_weighted_sum(torch.ones(4, device="cuda"), [x, x, x, x])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_stem_kernel_matches_plain_version_on_card(dtype, full_f32_convs):
    """K4 against its plain version (an f32 conv of the rounded operands,
    rounded once, then the sums; cuDNN in full f32): y within 1e-4 of the
    largest magnitude in f32; in bf16 within one bf16 step plus the most two
    f32 sums of the same 49 * C products can differ by (2 * 49 * C * 2^-24
    times the sum of their magnitudes: near zero, cancellation leaves fewer
    digits than a bf16 step); the sums
    within 1e-5 of the sums of |y| and y^2, against the plain version's and
    against K4's own y summed by PyTorch; two calls bitwise equal.  Shapes:
    the ragged H/2 = 18 and W/2 = 19 edges, one channel, eight channels,
    the even channel counts 2 and 4 at ragged edges (the bf16 body's halo
    rows have no lead element there), seven channels (staged as eight, with
    a lead element), and (4, 3, 640, 646): more 8 x 16 tiles than the bf16
    body's resident blocks, so its persistent loop and per-tile partials
    run."""
    _need_card()
    gen = torch.Generator().manual_seed(8)
    for b, c, h, w in ((2, 3, 36, 38), (1, 1, 64, 64), (2, 8, 20, 22), (2, 2, 36, 38), (1, 4, 50, 70),
                       (1, 7, 26, 34), (4, 3, 640, 646)):
        x = torch.rand(b, h, w, c, generator=gen).to("cuda", dtype).permute(0, 3, 1, 2)
        weight = (torch.randn(64, c, 7, 7, generator=gen) * (1 / (49 * c)) ** 0.5).cuda()
        before = stem.stem_conv_stats.launches
        got = stem.stem_conv_stats(x, weight)
        assert stem.stem_conv_stats.launches == before + 1
        again = stem.stem_conv_stats(x, weight)
        assert all(torch.equal(p, q) for p, q in zip(got, again))
        y, s, q = got
        want_y, want_s, want_q = stem.stem_conv_stats_reference(x, weight)
        assert y.shape == (b, 64, h // 2, w // 2) and y.dtype == dtype
        assert y.is_contiguous(memory_format=torch.channels_last)
        if dtype == torch.bfloat16:
            magnitudes = F.conv2d(x.float().abs(), weight.to(dtype).float().abs(), stride=2, padding=3)
            assert _within_one_bf16_step(y, want_y, 2 * 49 * c * 2.0**-24 * magnitudes)
        else:
            assert float((y - want_y).abs().max()) <= 1e-4 * float(want_y.abs().max())
        yf = y.float()
        norms = (yf.abs().sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3)))
        for got_sum, want_sum, own, norm in zip(
            (s, q), (want_s, want_q), (yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))), norms
        ):
            assert float(((got_sum - want_sum).abs() / norm).max()) <= 1e-5
            assert float(((got_sum - own).abs() / norm).max()) <= 1e-5


@pytest.mark.cuda
def test_stem_kernel_refuses_what_it_does_not_take():
    _need_card()
    x = torch.zeros(1, 3, 16, 16, device="cuda")
    weight = torch.zeros(64, 3, 7, 7, device="cuda")
    with pytest.raises(ValueError, match="channels_last"):
        stem.stem_conv_stats(x, weight)
    with pytest.raises(ValueError, match="takes"):
        stem.stem_conv_stats(x.half().contiguous(memory_format=torch.channels_last), weight)
    # a channels_last view that starts 2 bytes past a 4-byte boundary
    shifted = torch.zeros(16 * 16 * 3 + 1, device="cuda", dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="aligned"):
        stem.stem_conv_stats(shifted.view(1, 16, 16, 3).permute(0, 3, 1, 2), weight)


def _decode_inputs(gen, b, i, h, w, c, k, dtype):
    """Decode inputs on the card: (B, c, H, W) channels_last features, grid,
    centres and dynamic weights."""
    feats = torch.randn(b, h, w, c, generator=gen) * 0.5
    grid = torch.rand(h, w, 2, generator=gen)
    centers = torch.rand(b, i, 2, generator=gen)
    dyn = torch.randn(b, i, dynconv.param_count(c, k), generator=gen) * 0.3
    return feats.to("cuda", dtype).permute(0, 3, 1, 2), grid.cuda(), centers.cuda(), dyn.to("cuda", dtype)


# (b, i, h, w, c, k): instance masks, a ragged spatial tile and instance
# group, more than one instance group with a ragged last tile and a ragged
# tile of output columns, keypoint heatmaps, and c = 32 at one output; one
# instance and 63 or 25 pixels (a ragged 16-pixel tile, most of a strip's
# warps idle); 323 pixels (not a multiple of 16 or of a strip) and 67
# instances (the tensor-core body's groups 14, last 11); the serving decode
DECODE_SHAPES = [(2, 37, 80, 80, 8, 1), (3, 5, 13, 11, 8, 1), (3, 33, 24, 24, 8, 5), (2, 11, 40, 40, 32, 17),
                 (2, 3, 13, 11, 32, 1), (1, 1, 9, 7, 8, 1), (1, 1, 5, 5, 32, 17), (2, 67, 17, 19, 8, 1),
                 (16, 100, 80, 80, 8, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,i,h,w,c,k", DECODE_SHAPES)
def test_dynconv_decode_kernel_matches_plain_version_on_card(b, i, h, w, c, k):
    """K5f within atol = rtol = 1e-4 of the plain einsum chain (f32 logits),
    for f32 inputs (the FMA body) and bf16 inputs (the tensor-core body);
    two calls bitwise equal."""
    _need_card()
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        args = _decode_inputs(gen, b, i, h, w, c, k, dtype)
        before = dynconv.dynamic_pointwise_decode.launches
        with torch.no_grad():
            got = dynconv.dynamic_pointwise_decode(*args, c, k)
            again = dynconv.dynamic_pointwise_decode(*args, c, k)
        assert dynconv.dynamic_pointwise_decode.launches == before + 2
        assert torch.equal(got, again)
        want = dynconv.reference_decode(*args, c, k)
        assert got.shape == (b, i, h, w, k) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,i,h,w,c,k", DECODE_SHAPES)
def test_dynconv_decode_backward_kernel_matches_plain_autograd_on_card(b, i, h, w, c, k):
    """K5b's d(features) and d(weights) through autograd, within atol = rtol
    = 2e-3 of autograd of the plain chain for f32 inputs, and for bf16 inputs
    within atol 2e-3 and rtol 2e-3 + 2^-7 (both sides round their f32 sums to
    bf16, and a sum near a rounding boundary may round either way), bitwise
    equal over two calls, and no gradient for the grid and the centres."""
    _need_card()
    gen = torch.Generator().manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        mf, grid, centers, dyn = _decode_inputs(gen, b, i, h, w, c, k, dtype)
        weights = torch.randn(b, i, h, w, k, generator=gen).cuda()
        grads = []
        for fn in (dynconv.dynamic_pointwise_decode, dynconv.dynamic_pointwise_decode, dynconv.reference_decode):
            leaves = [t.detach().requires_grad_(True) for t in (mf, grid, centers, dyn)]
            before = dynconv.dynamic_pointwise_decode_backward.launches
            (torch.tanh(fn(*leaves, c, k)) * weights).sum().backward()
            if fn is dynconv.dynamic_pointwise_decode:
                assert dynconv.dynamic_pointwise_decode_backward.launches == before + 1
                assert leaves[1].grad is None and leaves[2].grad is None
                assert leaves[0].grad.is_contiguous(memory_format=torch.channels_last)
            grads.append((leaves[0].grad, leaves[3].grad))
        (k_mf, k_dyn), (k2_mf, k2_dyn), (want_mf, want_dyn) = grads
        assert torch.equal(k_mf, k2_mf) and torch.equal(k_dyn, k2_dyn)
        assert k_mf.dtype == k_dyn.dtype == dtype
        rtol = 2e-3 + (2**-7 if dtype == torch.bfloat16 else 0.0)
        torch.testing.assert_close(k_mf.float(), want_mf.float(), atol=2e-3, rtol=rtol)
        torch.testing.assert_close(k_dyn.float(), want_dyn.float(), atol=2e-3, rtol=rtol)


@pytest.mark.cuda
def test_dynconv_decode_backward_kernel_at_the_keypoint_training_shape_on_card():
    """K5b in bf16 at the keypoint head's training decode (16 images x 128
    positives at 80 x 80, c = 32, k = 17) against autograd of the plain
    chain, at the tolerances of the test above; two calls bitwise equal."""
    _need_card()
    gen = torch.Generator().manual_seed(5)
    c, k = 32, 17
    mf, grid, centers, dyn = _decode_inputs(gen, 16, 128, 80, 80, c, k, torch.bfloat16)
    gout = torch.randn(16, 128, 80, 80, k, generator=gen).cuda()
    got = dynconv.dynamic_pointwise_decode_backward(mf, grid, centers, dyn, gout, c, k)
    again = dynconv.dynamic_pointwise_decode_backward(mf, grid, centers, dyn, gout, c, k)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    leaves = [mf.detach().requires_grad_(True), dyn.detach().requires_grad_(True)]
    want = torch.autograd.grad(dynconv.reference_decode(leaves[0], grid, centers, leaves[1], c, k), leaves, gout)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), atol=2e-3, rtol=2e-3 + 2**-7)


@pytest.mark.cuda
def test_dynconv_decode_kernel_refuses_what_it_does_not_take():
    _need_card()
    gen = torch.Generator().manual_seed(5)
    mf, grid, centers, dyn = _decode_inputs(gen, 1, 2, 8, 8, 16, 1, torch.float32)
    with pytest.raises(ValueError, match="c in"):
        dynconv.dynamic_pointwise_decode(mf, grid, centers, dyn, 16, 1)
    mf, grid, centers, dyn = _decode_inputs(gen, 1, 2, 8, 8, 8, 1, torch.float32)
    with pytest.raises(ValueError, match="one dtype"):
        dynconv.dynamic_pointwise_decode(mf, grid, centers, dyn.bfloat16(), 8, 1)
    with pytest.raises(ValueError, match="channels_last"):
        dynconv.dynamic_pointwise_decode(mf.contiguous(), grid, centers, dyn, 8, 1)
    mf, grid, centers, dyn = _decode_inputs(gen, 1, 2, 8, 8, 8, 1, torch.bfloat16)
    shifted = torch.empty(mf.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:]
    shifted = shifted.view(1, 8, 8, 8).permute(0, 3, 1, 2).copy_(mf)  # channels_last, 2 bytes off a word
    with pytest.raises(ValueError, match="aligned"):
        dynconv.dynamic_pointwise_decode(shifted, grid, centers, dyn, 8, 1)
    shifted = torch.empty(dyn.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:].view_as(dyn).copy_(dyn)
    with pytest.raises(ValueError, match="aligned"):
        dynconv.dynamic_pointwise_decode(mf, grid, centers, shifted, 8, 1)


def _bf16(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda", torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 63, 65, 1000, 4097, 64 * 132 * 3 + 5])
def test_matmul_stats_kernel_matches_plain_version_on_card(m):
    """P4 at ragged row counts and with more 64-row tiles than blocks fit on
    the card at once (the last, 3 tiles a block and a ragged one): y within
    one bf16 step of the plain f32 product (plus what f32 order moves a sum
    of 64 products that cancel), the same with and without the statistics;
    the sums within 1e-5 of the sums of |y| and y^2 (f32 sums in another
    order); two calls bitwise equal."""
    _need_card()
    gen = torch.Generator().manual_seed(6)
    x, w = _bf16(gen, m, 64, scale=0.5), _bf16(gen, 64, 256, scale=0.05)
    yf = x.float() @ w.float()
    slack = order_slack(64, x.float().abs() @ w.float().abs())
    before = conv_probes.matmul_stats.launches
    y = conv_probes.matmul_stats(x, w)
    y1, s1, s2 = conv_probes.matmul_stats(x, w, stats=True)
    y2, s1b, s2b = conv_probes.matmul_stats(x, w, stats=True)
    assert conv_probes.matmul_stats.launches == before + 3
    assert y.shape == (m, 256) and y.dtype == torch.bfloat16
    assert _within_one_bf16_step(y, yf, slack)
    assert torch.equal(y, y1) and torch.equal(y1, y2)
    assert torch.equal(y, conv_probes.matmul_stats(x, w))
    assert within_sum_order(s1, yf.sum(dim=0), yf.abs().sum(dim=0))
    assert within_sum_order(s2, (yf * yf).sum(dim=0), (yf * yf).sum(dim=0))
    assert torch.equal(s1, s1b) and torch.equal(s2, s2b)


@pytest.mark.cuda
@pytest.mark.parametrize("ci,co", [(64, 256), (128, 512), (256, 256), (192, 768)])
@pytest.mark.parametrize("m", [1, 63, 65, 64 * 132 * 6 + 37])
def test_weight_grad_kernel_matches_plain_version_on_card(m, ci, co):
    """P5 at the probes' three channel counts and one whose dW tiles (3 x 3
    of 64 x 256) are no power of two, with one row, less than a 64-row TMA
    box, one row past a box, and enough rows that every block takes many
    chunks: dW within 1e-5 of |x|^T |dy| of x^T dy in f32 (f32 sums in
    another order); two calls bitwise equal."""
    _need_card()
    gen = torch.Generator().manual_seed(7)
    x, dy = _bf16(gen, m, ci, scale=0.1), _bf16(gen, m, co, scale=0.1)
    before = conv_probes.weight_grad_1x1.launches
    dw = conv_probes.weight_grad_1x1(x, dy)
    assert conv_probes.weight_grad_1x1.launches == before + 1
    assert dw.shape == (ci, co) and dw.dtype == torch.float32
    assert within_sum_order(dw, x.float().T @ dy.float(), x.float().abs().T @ dy.float().abs())
    assert torch.equal(dw, conv_probes.weight_grad_1x1(x, dy))


@pytest.mark.cuda
def test_weight_grad_phases_add_up_to_the_call_on_card():
    """P5's two launches apart (what the smoke times one by one) give the
    call's dW bitwise, and do not count as launches of the wrapper."""
    _need_card()
    gen = torch.Generator().manual_seed(11)
    x, dy = _bf16(gen, 5000, 128, scale=0.1), _bf16(gen, 5000, 512, scale=0.1)
    before = conv_probes.weight_grad_1x1.launches
    products, reduction = conv_probes.weight_grad_phases(x, dy)
    partials = products()
    dw = reduction()
    assert conv_probes.weight_grad_1x1.launches == before
    assert partials.shape[1:] == (128, 512)
    assert within_sum_order(dw, partials.sum(dim=0), partials.abs().sum(dim=0))
    assert torch.equal(dw, conv_probes.weight_grad_1x1(x, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(1, 13, 13), (2, 13, 13), (1, 7, 45), (3, 32, 64), (1, 1, 1), (2, 1, 100),
                                   (1, 9, 1), (16, 160, 160)])
def test_conv3x3_kernel_matches_plain_version_on_card(b, h, w):
    """P2 on ragged images and a batch of one; an image narrower and
    shorter than one 2 x 64 tile, one row, one column; and the probe's
    shape, with more tiles than blocks fit on the card at once: y within one
    bf16 step of the plain 9-tap f32 sum (plus what f32 order moves a sum
    of 576 products that cancel); two calls bitwise equal."""
    _need_card()
    gen = torch.Generator().manual_seed(8)
    x, wt = _bf16(gen, b, h, w, 64, scale=0.5), _bf16(gen, 3, 3, 64, 64, scale=0.05)
    before = conv_probes.conv3x3.launches
    y = conv_probes.conv3x3(x, wt)
    assert conv_probes.conv3x3.launches == before + 1
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    want = conv_probes.conv3x3_reference(x.float(), wt.float())
    slack = order_slack(576, conv_probes.conv3x3_reference(x.float().abs(), wt.float().abs()))
    assert _within_one_bf16_step(y, want, slack)
    assert torch.equal(y, conv_probes.conv3x3(x, wt))


@pytest.mark.cuda
@pytest.mark.parametrize("tap", range(9))
def test_conv3x3_kernel_reads_each_tap_of_one_tile_on_card(tap):
    """One tile (2 rows by 64 columns) with the weights of one tap alone:
    y is the halo shifted by that tap times its matrix, so each tap's A
    descriptor, which starts inside a swizzle pattern, is checked on its
    own, the edges' zero padding with it."""
    _need_card()
    gen = torch.Generator().manual_seed(12)
    x = _bf16(gen, 1, 2, 64, 64, scale=0.5)
    wt = torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16, device="cuda")
    wt[tap // 3, tap % 3] = _bf16(gen, 64, 64, scale=0.05)
    y = conv_probes.conv3x3(x, wt)
    want = conv_probes.conv3x3_reference(x.float(), wt.float())
    slack = order_slack(64, conv_probes.conv3x3_reference(x.float().abs(), wt.float().abs()))
    assert _within_one_bf16_step(y, want, slack)


@pytest.mark.cuda
def test_conv_probe_kernels_refuse_what_they_do_not_take():
    _need_card()
    gen = torch.Generator().manual_seed(9)
    x, w = _bf16(gen, 128, 64), _bf16(gen, 64, 256)
    with pytest.raises(ValueError, match="bf16"):
        conv_probes.matmul_stats(x.float(), w)
    with pytest.raises(ValueError, match="contiguous"):
        conv_probes.matmul_stats(_bf16(gen, 64, 128).t(), w)
    with pytest.raises(ValueError, match="shape"):
        conv_probes.matmul_stats(_bf16(gen, 128, 32), w)
    dy = _bf16(gen, 128, 256)
    with pytest.raises(ValueError, match="bf16"):
        conv_probes.weight_grad_1x1(x, dy.half())
    with pytest.raises(ValueError, match="contiguous"):
        conv_probes.weight_grad_1x1(x, _bf16(gen, 256, 128).t())
    with pytest.raises(ValueError, match="multiple"):
        conv_probes.weight_grad_1x1(x, _bf16(gen, 128, 128))
    # TMA takes 16-byte-aligned addresses: a contiguous view one element in is refused
    odd = _bf16(gen, 128 * 256 + 1)[1:]
    with pytest.raises(ValueError, match="aligned"):
        conv_probes.matmul_stats(odd[: 128 * 64].view(128, 64), w)
    with pytest.raises(ValueError, match="aligned"):
        conv_probes.matmul_stats(x, odd[: 64 * 256].view(64, 256))
    with pytest.raises(ValueError, match="aligned"):
        conv_probes.weight_grad_1x1(odd[: 128 * 64].view(128, 64), dy)
    with pytest.raises(ValueError, match="aligned"):
        conv_probes.weight_grad_1x1(x, odd.view(128, 256))
    img, wt = _bf16(gen, 1, 8, 8, 64), _bf16(gen, 3, 3, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        conv_probes.conv3x3(img.permute(0, 2, 1, 3), wt)
    with pytest.raises(ValueError, match="bf16"):
        conv_probes.conv3x3(img, wt.float())
    with pytest.raises(ValueError, match="shape"):
        conv_probes.conv3x3(_bf16(gen, 1, 8, 8, 32), wt)
    # TMA takes 16-byte-aligned addresses: x or w one element in is refused
    odd = _bf16(gen, 8 * 8 * 64 + 1)[1:]
    with pytest.raises(ValueError, match="aligned"):
        conv_probes.conv3x3(odd.view(1, 8, 8, 64), wt)
    with pytest.raises(ValueError, match="aligned"):
        conv_probes.conv3x3(img, _bf16(gen, 9 * 64 * 64 + 1)[1:].view(3, 3, 64, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", list(itertools.product((1, 3), (32, 70, 640), (32, 70, 640))))
def test_stem_variant_kernels_match_plain_versions_on_card(b, h, w, full_f32_convs):
    """P3's four legs on square and ragged images (70 / 2 = 35 outputs is
    no multiple of the 8 x 16 tile): load and stage bit for bit against
    their plain versions; product and full within one bf16 step plus what
    f32 order moves a sum of 147 products that cancel; two full calls
    bitwise equal."""
    _need_card()
    gen = torch.Generator().manual_seed(10)
    x = torch.randn(b, h, w, 3, generator=gen).to("cuda", torch.bfloat16)
    wt = _bf16(gen, 7, 7, 3, 64, scale=0.1)
    slack = order_slack(147, stem_variants.stem_variant_reference(x.float().abs(), wt.float().abs(), "full"))
    outs = {}
    for mode in stem_variants.MODES:
        before = stem_variants.stem_variant.launches
        y = outs[mode] = stem_variants.stem_variant(x, wt, mode)
        assert stem_variants.stem_variant.launches == before + 1
        assert y.shape == (b, h // 2, w // 2, 64) and y.dtype == torch.bfloat16
        want = stem_variants.stem_variant_reference(x, wt, mode)
        if mode in ("load", "stage"):
            assert torch.equal(y, want), mode
        else:
            assert _within_one_bf16_step(y, want, slack[:, :1, :1] if mode == "product" else slack), mode
    assert torch.equal(outs["full"], stem_variants.stem_variant(x, wt, "full"))


@pytest.mark.cuda
def test_stem_variant_kernel_refuses_what_it_does_not_take():
    _need_card()
    gen = torch.Generator().manual_seed(11)
    x, wt = _bf16(gen, 1, 16, 16, 3), _bf16(gen, 7, 7, 3, 64)
    with pytest.raises(ValueError, match="bf16"):
        stem_variants.stem_variant(x.float(), wt, "full")
    with pytest.raises(ValueError, match="contiguous"):
        stem_variants.stem_variant(_bf16(gen, 1, 3, 16, 16).permute(0, 2, 3, 1), wt, "full")  # NCHW memory
    with pytest.raises(ValueError, match="shape"):
        stem_variants.stem_variant(_bf16(gen, 1, 16, 16, 4), wt, "full")
    with pytest.raises(ValueError, match="shape"):
        stem_variants.stem_variant(_bf16(gen, 1, 15, 16, 3), wt, "load")
    with pytest.raises(ValueError, match="mode"):
        stem_variants.stem_variant(x, wt, "dma")


def _pipeline_inputs(seed: int, m: int):
    heads, x = mlp_pipeline.probe_params(seed, m)
    return torch.from_numpy(x).to("cuda", torch.bfloat16), mlp_pipeline.mlps_from_probe_params(heads, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1000, 1280])
def test_mlp_pipeline_kernels_match_plain_versions_on_card(m):
    """P1's variant kernels at a ragged row count (1,000 = 7 blocks of 128
    and one that its warpgroups split 64 + 40) and at 10 whole blocks, with
    the JAX probe's distributions: each equal to its plain version but in
    at most a tenth of the outputs, and there within one bf16 step at the
    largest output (1-3% of them differ; a different function such as
    two-pass against one-pass variance moves more than half); pingpong bit
    for bit K1f's (base) and pp+mxured mxured's, mxured not base's; each
    mode's two calls bitwise equal; one launch per call."""
    _need_card()
    x, mlps = _pipeline_inputs(12, m)
    outs = {}
    for mode in mlp_pipeline.MODES:
        counter = fused_mlp.fused_mlps if mode == "base" else mlp_pipeline.mlp_pipeline
        before = counter.launches
        got = outs[mode] = mlp_pipeline.mlp_pipeline(x, mlps, mode)
        assert counter.launches == before + 1, mode
        want = mlp_pipeline.mlp_pipeline_reference(x, mlps, mode)
        assert all(g.shape == (m, 1) and g.dtype == torch.bfloat16 for g in got)
        assert within_rounding_flips(torch.cat(got), torch.cat(want)), mode
        assert all(torch.equal(a, b) for a, b in zip(got, mlp_pipeline.mlp_pipeline(x, mlps, mode))), mode
    for mode, same in (("pingpong", "base"), ("pp+mxured", "mxured")):
        assert all(torch.equal(a, b) for a, b in zip(outs[mode], outs[same])), mode
    assert not all(torch.equal(a, b) for a, b in zip(outs["mxured"], outs["base"]))


@pytest.mark.cuda
def test_mlp_pipeline_kernels_refuse_what_they_do_not_take():
    _need_card()
    x, mlps = _pipeline_inputs(13, 256)
    for mode in mlp_pipeline.MODES:
        with pytest.raises(ValueError, match="bf16"):
            mlp_pipeline.mlp_pipeline(x.float(), mlps, mode)
        with pytest.raises(ValueError, match="contiguous"):
            mlp_pipeline.mlp_pipeline(x.t().contiguous().t(), mlps, mode)
        with pytest.raises(ValueError, match="256"):
            mlp_pipeline.mlp_pipeline(x[:, :128].contiguous(), mlps, mode)
    with pytest.raises(ValueError, match="mode"):
        mlp_pipeline.mlp_pipeline(x, mlps, "halves")


def _small_detector(seed: int):
    """resnet18 with level 1 frozen, FPN 256 wide over levels 3-5 and an
    ObjectDetection head whose MLPs K1 takes (256 wide), bf16, on the card."""
    from sihl_tpu_torch import Backbone, SihlModel
    from sihl_tpu_torch.heads import ObjectDetection
    from sihl_tpu_torch.layers import FPN

    gen = torch.Generator().manual_seed(seed)
    with compute_dtype_scope(torch.bfloat16):
        bb = Backbone("resnet18", top_level=5, generator=gen, device="cuda")
        bb.set_frozen_levels(1)
        neck = FPN(bb.out_channels, 256, bottom_level=3, top_level=5, generator=gen, device="cuda")
        head = ObjectDetection(neck.out_channels, 5, num_channels=256, num_layers=2, max_instances=16,
                               max_targets=4, generator=gen, device="cuda")
        return SihlModel(bb, neck, [head])


@pytest.mark.cuda
def test_trainer_paths_serve_the_current_weights_on_card():
    """K1's pack cache across the trainer's paths: validate, a training step
    and predict, then use_ema_params and predict; each prediction bit for
    bit that of a freshly built model holding the same weights (whose packs
    are built anew), and the step's loss bit for bit a fresh trainer's."""
    _need_card()
    from sihl_tpu_torch.training import Trainer

    def fresh_prediction(state, x):
        model = _small_detector(1)
        model.load_state_dict(state, strict=True)
        with torch.no_grad():
            return model.eval()(x)[0]

    def same(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want))

    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.rand(2, 3, 128, 128, device="cuda", generator=gen)
    targets = {"classes": torch.tensor([[0, 3, -1, -1], [1, -1, -1, -1]], device="cuda"),
               "boxes": torch.tensor([[[8.0, 8.0, 41.0, 37.0], [60.0, 20.0, 91.0, 85.0], [0.0] * 4, [0.0] * 4],
                                      [[30.0, 40.0, 77.0, 93.0], [0.0] * 4, [0.0] * 4, [0.0] * 4]], device="cuda")}
    kw = dict(optimizer="adamw", optimizer_kwargs={"lr": 1e-3, "weight_decay": 1e-4}, grad_clip=0.1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        initial = {k: v.clone() for k, v in _small_detector(0).state_dict().items()}
        model = _small_detector(1)
        model.load_state_dict(initial)
        trainer = Trainer(model, ema_decay=0.5, **kw)
        fused_mlp.fused_mlps.launches = 0
        metrics = trainer.validate([(x, targets)])
        assert fused_mlp.fused_mlps.launches > 0 and "head0/valid/map" in metrics
        loss = trainer.training_step(x, targets)["trainer/loss"]
        other = _small_detector(1)
        other.load_state_dict(initial)
        assert torch.equal(loss, Trainer(other, **kw).training_step(x, targets)["trainer/loss"])
        assert same(trainer.predict(x)[0], fresh_prediction(model.state_dict(), x))
        trainer.use_ema_params()
        ema_state = {**model.state_dict(), **trainer.ema_params}
        assert not same(fresh_prediction(ema_state, x), fresh_prediction(initial, x))
        assert same(trainer.predict(x)[0], fresh_prediction(ema_state, x))
    finally:
        torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
def test_classification_model_with_a_frozen_stem_runs_k4_in_eval_on_card():
    """The three-head classification model (resnet18 with level 1 frozen, no
    neck; multiclass, multilabel and regression heads) served in eval mode
    on the card: its frozen stem launches K4, and in full f32 (TF32 off) its
    outputs equal the CPU's, where the stem runs K4's plain version: classes
    and multilabel orders exactly, scores and values within 1e-4."""
    _need_card()
    from sihl_tpu_torch import Backbone, SihlModel
    from sihl_tpu_torch.heads import MulticlassClassification, MultilabelClassification, Regression

    gen = torch.Generator().manual_seed(0)
    bb = Backbone("resnet18", generator=gen, device="cpu")
    bb.set_frozen_levels(1)
    c = bb.out_channels
    cpu_model = SihlModel(bb, None, [
        MulticlassClassification(c, 196, num_channels=64, label_smoothing=0.1, generator=gen, device="cpu"),
        MultilabelClassification(c, 80, num_channels=64, generator=gen, device="cpu"),
        Regression(c, 0.0, 100.0, num_channels=64, generator=gen, device="cpu"),
    ]).eval()
    model = copy.deepcopy(cpu_model).cuda()
    x = torch.rand(2, 3, 128, 128, generator=gen)
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            stem.stem_conv_stats.launches = 0
            got = model(x.cuda())
            assert stem.stem_conv_stats.launches == 1
            want = cpu_model(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
    (scores, classes), (ml_scores, ml_labels), values = got
    (w_scores, w_classes), (w_ml_scores, w_ml_labels), w_values = want
    assert torch.equal(classes.cpu(), w_classes) and torch.equal(ml_labels.cpu(), w_ml_labels)
    for g, w in ((scores, w_scores), (ml_scores, w_ml_scores), (values, w_values)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


def _small_dense_models(gen: torch.Generator, device: str):
    """resnet18 with level 1 frozen → FPN 32 over levels 3-5 → (semantic
    segmentation with 7 classes and depth estimation on one trunk, 32 wide)
    and (panoptic segmentation with 3 stuff and 4 thing classes, 256 wide:
    the fused-MLP kernel takes 256-wide rows)."""
    from sihl_tpu_torch import Backbone, SihlModel
    from sihl_tpu_torch.heads import DepthEstimation, PanopticSegmentation, SemanticSegmentation
    from sihl_tpu_torch.layers import FPN

    models = []
    for kind in ("dense", "panoptic"):
        bb = Backbone("resnet18", generator=gen, device=device)
        bb.set_frozen_levels(1)
        neck = FPN(bb.out_channels, 32, bottom_level=3, top_level=5, generator=gen, device=device)
        c = neck.out_channels
        if kind == "dense":
            heads = [SemanticSegmentation(c, 7, num_channels=32, ignore_index=255, generator=gen, device=device),
                     DepthEstimation(c, 0.1, 10.0, num_channels=32, num_bins=16, generator=gen, device=device)]
        else:
            heads = [PanopticSegmentation(c, 3, 4, max_instances=16, max_targets=4,
                                          soft_label_decay_steps=10, ignore_index=255, generator=gen, device=device)]
        models.append(SihlModel(bb, neck, heads))
    return models


def _dense_targets(kind: str, gen: torch.Generator, size: int = 128):
    """The dense model's semantic classes (void rows on top) and depths with
    validity masks; or the panoptic model's stuff classes under three
    rectangular things, with their padded classes and masks."""
    if kind == "dense":
        semantic = torch.randint(0, 7, (2, size, size), generator=gen)
        semantic[:, :8] = 255
        depth = torch.rand(2, size, size, generator=gen) * 9.9 + 0.1
        masks = torch.rand(2, size, size, generator=gen) > 0.1
        return [semantic, {"targets": torch.where(masks, depth, 0.0), "masks": masks}]
    semantic = torch.randint(0, 3, (2, size, size), generator=gen)
    semantic[:, :8] = 255
    classes = torch.tensor([[0, 3, -1, -1], [1, -1, -1, -1]])
    masks = torch.zeros(2, 4, size, size)
    masks[0, 0, 8:40, 10:36] = masks[0, 1, 60:90, 64:120] = masks[1, 0, 30:94, 40:78] = 1.0
    for b, t in ((0, 0), (0, 1), (1, 0)):
        semantic[b][masks[b, t] > 0] = 3 + classes[b, t]
    return {"semantic": semantic, "classes": classes, "masks": masks}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "panoptic"])
def test_dense_heads_serve_and_train_through_the_kernels_on_card(kind):
    """The dense heads' small models on the card: in full f32 the eval
    forward equals the CPU's (class and instance maps exactly but at ties of
    the CPU's top two semantic probabilities, under 1% of the pixels; scores
    and depths within 1e-4), launching K4 and K3 (and K1f and K5f for the
    panoptic head); one bf16 ``Trainer`` step launches every kernel of the
    path (K1b, K2 and K5b too for the panoptic head), gives a finite loss
    and moves the panoptic counter from 0 to 1."""
    _need_card()
    from sihl_tpu_torch.ops.fusion import fused_upsample_add as k3
    from sihl_tpu_torch.training import Trainer

    gen = torch.Generator().manual_seed(0)
    cpu_model = _small_dense_models(gen, "cpu")[0 if kind == "dense" else 1].eval()
    model = copy.deepcopy(cpu_model).cuda()
    x = torch.rand(2, 3, 128, 128, generator=gen) * torch.tensor([0.5, 1.0])[:, None, None, None]
    kernels = {"k3": k3, "k4": stem.stem_conv_stats, "k1f": fused_mlp.fused_mlps, "k5f": dynconv.dynamic_pointwise_decode}
    for k in kernels.values():
        k.launches = 0
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            got = model(x.cuda())
            want = cpu_model(x)
            feats = cpu_model.extract_features(x)
            head = cpu_model.heads[0].semantic if kind == "panoptic" else cpu_model.heads[0]
            probs = torch.softmax(head.get_logits(feats), dim=1).topk(2, dim=1).values
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
    launched = {name: k.launches for name, k in kernels.items()}
    assert launched["k3"] == 2 and launched["k4"] == 1, launched
    assert (launched["k1f"] > 0 and launched["k5f"] > 0) == (kind == "panoptic"), launched
    tie = (probs[:, 0] - probs[:, 1]) / probs[:, 0] <= 1e-5
    if kind == "dense":
        (scores, classes), depth = got
        (w_scores, w_classes), w_depth = want
        tie = F.interpolate(tie[:, None].float(), size=classes.shape[1:], mode="nearest")[:, 0] > 0
        differ = classes.cpu() != w_classes
        torch.testing.assert_close(depth.cpu(), w_depth, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(scores.cpu()[~differ], w_scores[~differ], atol=1e-4, rtol=1e-4)
    else:
        (got,), (want,) = got, want
        differ = (got[0].cpu() != want[0]) | (got[1].cpu() != want[1])
        torch.testing.assert_close(got[3].cpu(), want[3], atol=1e-4, rtol=1e-4)
    assert not (differ & ~tie).any() and differ.float().mean() < 1e-2

    with compute_dtype_scope(torch.bfloat16):
        model = _small_dense_models(torch.Generator().manual_seed(1), "cuda")[0 if kind == "dense" else 1]
    trainer = Trainer(model, optimizer="adamw", optimizer_kwargs={"lr": 1e-4}, grad_clip=0.1)
    targets = _dense_targets(kind, torch.Generator().manual_seed(2))
    targets = [targets[0].cuda(), {k: v.cuda() for k, v in targets[1].items()}] if kind == "dense" else {
        k: v.cuda() for k, v in targets.items()}
    step_kernels = dict(kernels, k1b=fused_mlp.fused_mlps_backward, k2=topk.row_best_and_kth,
                        k5b=dynconv.dynamic_pointwise_decode_backward)
    for k in step_kernels.values():
        k.launches = 0
    loss = trainer.training_step(x.cuda(), targets)["trainer/loss"]
    assert torch.isfinite(loss)
    launched = {name: k.launches for name, k in step_kernels.items()}
    expected = ("k3", "k4") + (("k1f", "k1b", "k2", "k5f", "k5b") if kind == "panoptic" else ())
    assert all(launched[k] > 0 for k in expected) and not any(
        launched[k] for k in step_kernels if k not in expected), launched
    if kind == "panoptic":
        assert model.heads[0].step_counter.dtype == torch.int32 and int(model.heads[0].step_counter) == 1


def test_card_tests_import_no_jax():
    """This file runs where JAX is absent: nothing it imports loads JAX."""
    code = "import sys, test_torch_kernels_cuda; print(sorted(m for m in ('jax', 'flax') if m in sys.modules))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parent, env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1])})
    assert out.stdout.strip() == "[]", out


@pytest.mark.cuda
def test_transformer_layers_hybrid_encoder_and_new_heads_on_card():
    """The attention layers, the HybridEncoder and the text-recognition and
    metric-learning heads in f32 eval mode on the card, in full f32 (TF32 off
    in cuDNN and in the matrix products), against the CPU with the same
    weights: each output within 1e-5 of its largest magnitude, the text
    tokens equal."""
    _need_card()
    from sihl_tpu_torch.heads import MetricLearning, TextRecognition
    from sihl_tpu_torch.layers import HybridEncoder, TransformerDecoderLayer, TransformerEncoderLayer

    gen = torch.Generator().manual_seed(0)
    channels = [3, 64, 256, 512, 1024, 2048]
    pyramid = [torch.rand(2, c, 256 >> i, 256 >> i, generator=gen) for i, c in enumerate(channels)]
    tokens, memory = torch.randn(2, 12, 256, generator=gen), torch.randn(2, 400, 256, generator=gen)
    cases = [
        (TransformerEncoderLayer(256, generator=gen, device="cpu"), (memory,)),
        (TransformerDecoderLayer(256, num_heads=4, ff_dim=1024, generator=gen, device="cpu"), (tokens, memory)),
        (HybridEncoder(channels, 256, bottom_level=3, top_level=5, generator=gen, device="cpu"), (pyramid,)),
        (TextRecognition(channels, 30, 12, level=3, generator=gen, device="cpu"), (pyramid,)),
        (MetricLearning(channels, 8, level=2, generator=gen, device="cpu"), (pyramid,)),
    ]
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for module, args in cases:
            module.eval()
            on_card = copy.deepcopy(module).cuda()
            card_args = [[t.cuda() for t in a] if isinstance(a, list) else a.cuda() for a in args]
            with torch.no_grad():
                want, got = module(*args), on_card(*card_args)
            want = want if isinstance(want, (list, tuple)) else [want]
            got = got if isinstance(got, (list, tuple)) else [got]
            for g, w in zip(got, want):
                if w.is_floating_point():
                    torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-5 * float(w.abs().max()))
                else:
                    assert torch.equal(g.cpu(), w), type(module).__name__
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


@pytest.mark.cuda
def test_pretrained_trunk_pan_and_resnetv2_on_card(tmp_path, monkeypatch):
    """A torchvision-format resnet18 file (the port's export of a seeded
    trunk) in a temporary ``TORCH_HOME``, loaded by ``Backbone(...,
    pretrained=True, frozen_levels=1)`` on the card: the trunk holds the
    file's tensors and normalises its input; in full f32 (TF32 off) the
    pyramid, a PAN 64 wide over levels 3-5 on it, and a ``resnetv2_50``
    pyramid with level 1 frozen each equal the CPU's within 1e-5 of their
    largest magnitude; the frozen stems launch K4, the PAN's merges K3."""
    _need_card()
    from sihl_tpu_torch import Backbone, TimmBackbone
    from sihl_tpu_torch.backbones.resnet import make_resnet_features
    from sihl_tpu_torch.backbones.torchvision_import import dump_state_dict
    from sihl_tpu_torch.layers import PAN
    from sihl_tpu_torch.ops.fusion import fused_upsample_add as k3

    gen = torch.Generator().manual_seed(0)
    features = make_resnet_features("resnet18", generator=gen, device="cpu")
    with torch.no_grad():
        for name, buf in features.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) * (0.4 if name.endswith("mean") else 1.0) + 0.5)
    sd = dump_state_dict(features, "resnet18")
    (tmp_path / "hub" / "checkpoints").mkdir(parents=True)
    torch.save(sd, tmp_path / "hub" / "checkpoints" / "resnet18-0123abcd.pth")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    bb = Backbone("resnet18", pretrained=True, frozen_levels=1, device="cuda").eval()
    cpu_bb = Backbone("resnet18", pretrained=True, frozen_levels=1, device="cpu").eval()
    assert bb.normalize is not None and bb.normalize.mean.is_cuda
    assert all(torch.equal(v, sd[k]) for k, v in dump_state_dict(bb.features, "resnet18").items())
    neck = PAN(bb.out_channels, 64, bottom_level=3, top_level=5, generator=gen, device="cpu").eval()
    v2 = TimmBackbone("resnetv2_50", generator=gen, device="cpu")
    v2.set_frozen_levels(1)
    cases = [(cpu_bb, bb, None), (neck, copy.deepcopy(neck).cuda(), cpu_bb), (v2.eval(), copy.deepcopy(v2).cuda(), None)]
    x = torch.rand(2, 3, 128, 128, generator=gen)
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for module, on_card, trunk in cases:
                stem.stem_conv_stats.launches = k3.launches = 0
                want = module(trunk(x)) if trunk is not None else module(x)
                got = on_card(bb(x.cuda())) if trunk is not None else on_card(x.cuda())
                assert (stem.stem_conv_stats.launches, k3.launches) == ((1, 2) if trunk is not None else (1, 0))
                for g, w in zip(got, want):
                    torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-5 * float(w.abs().max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


@pytest.mark.cuda
def test_m16_layers_ops_and_utils_on_card():
    """CBAM, CrossCBAM, PadToMultipleOf, the adaptive pools, ``edges``,
    ``gaussian_blur``, the four losses and ``polygon_iou`` on the card in
    full f32 against the CPU: within 1e-5 of the CPU's largest magnitude
    (PadToMultipleOf bitwise)."""
    _need_card()
    from sihl_tpu_torch.layers import CBAM, CrossCBAM, PadToMultipleOf
    from sihl_tpu_torch.ops import (adaptive_avg_pool, adaptive_max_pool, binary_cross_entropy, edges, focal_loss,
                                    gaussian_blur, ssim_loss, tversky_loss)
    from sihl_tpu_torch.utils import polygon_iou

    gen = torch.Generator().manual_seed(0)
    maps = [torch.randn(2, 64, 40, 40, generator=gen) for _ in range(2)]
    images = torch.rand(2, 3, 96, 96, generator=gen)
    probs, labels = torch.rand(2, 5, 16, 16, generator=gen), (torch.rand(2, 5, 16, 16, generator=gen) > 0.8).float()
    classes = torch.randint(0, 7, (2, 16, 16), generator=gen)
    classes[:, :3] = 255
    square = torch.tensor([[0.0, 0.0], [4.0, 0.0], [4.0, 4.0], [0.0, 4.0]])
    quads = (torch.stack([square, square, square]), torch.stack([square + 1.5, square, square + 9.0]))
    cases = [
        (CBAM(64, generator=gen, device="cpu"), maps[:1]),
        (CrossCBAM(64, generator=gen, device="cpu"), maps),
        (PadToMultipleOf(16), [maps[0][:, :, :35, :30]]),
        (lambda x: adaptive_avg_pool(x, 7), maps[:1]),
        (lambda x: adaptive_max_pool(x, 8), maps[:1]),
        (edges, [images]),
        (gaussian_blur, [images]),
        (binary_cross_entropy, [probs, labels]),
        (focal_loss, [probs, labels]),
        (lambda x, t: tversky_loss(x, t, ignore_index=255), [torch.randn(2, 7, 16, 16, generator=gen), classes]),
        (ssim_loss, [images, images.flip(-1)]),
        (polygon_iou, list(quads)),
    ]
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            for fn, inputs in cases:
                want = fn(*inputs)
                card_fn = copy.deepcopy(fn).cuda() if isinstance(fn, torch.nn.Module) else fn
                got = card_fn(*[t.cuda() for t in inputs]).cpu()
                tol = 0.0 if isinstance(fn, PadToMultipleOf) else 1e-5 * float(want.abs().max())
                torch.testing.assert_close(got, want, rtol=0, atol=tol)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn


def _host_batches(n: int, seed: int = 0, batch: int = 4, size: int = 64):
    """Host batches in the JAX package's layout: NHWC f32 images, int32
    classes padded with -1, f32 boxes."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        classes = np.full((batch, 5), -1, np.int32)
        classes[:, :3] = rng.randint(0, 3, (batch, 3))
        xy = rng.uniform(0, size - 24, (batch, 5, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(6, 20, (batch, 5, 2))], axis=2).astype(np.float32)
        out.append((rng.rand(batch, size, size, 3).astype(np.float32), {"classes": classes, "boxes": boxes}))
    return out


def _assert_on_card_as_host(got, host):
    images, targets = got
    assert images.is_cuda and images.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(images.permute(0, 2, 3, 1).cpu(), torch.from_numpy(host[0]))
    assert targets["classes"].is_cuda and targets["classes"].dtype == torch.int64
    assert torch.equal(targets["classes"].cpu(), torch.from_numpy(host[1]["classes"]).long())
    assert torch.equal(targets["boxes"].cpu(), torch.from_numpy(host[1]["boxes"]))


@pytest.mark.cuda
@pytest.mark.parametrize("buffer_size", [1, 2])
def test_to_device_and_prefetcher_hand_over_host_batches_on_card(buffer_size):
    _need_card()
    from sihl_tpu_torch.data import DevicePrefetcher, to_device

    hosts = _host_batches(5)
    _assert_on_card_as_host(to_device(hosts[0], "cuda"), hosts[0])

    def source():
        yield from hosts
        raise OSError("a file went missing")

    prefetcher = DevicePrefetcher(source(), buffer_size=buffer_size, device="cuda")
    for host in hosts:
        _assert_on_card_as_host(next(prefetcher), host)
    with pytest.raises(OSError, match="went missing"):
        next(prefetcher)
    assert prefetcher.staged == 5 and prefetcher.pinned_bytes > 0
    prefetcher.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", [1, 2])
def test_fit_over_the_prefetcher_is_bitwise_fit_over_staged_batches_on_card(dispatch):
    """A resnet18 detector (FPN 32 over levels 3-5, 3 classes) at 64 px: a
    2-step ``fit`` fed by the prefetcher, eager or as one dispatch of a
    captured graph, against the same ``fit`` on batches staged beforehand."""
    _need_card()
    from sihl_tpu_torch import Backbone, SihlModel
    from sihl_tpu_torch.data import DevicePrefetcher, to_device
    from sihl_tpu_torch.heads import ObjectDetection
    from sihl_tpu_torch.layers import FPN
    from sihl_tpu_torch.training import Trainer

    def fitted(data):
        gen = torch.Generator().manual_seed(0)
        backbone = Backbone("resnet18", top_level=5, generator=gen, device="cuda")
        backbone.set_frozen_levels(1)
        neck = FPN(backbone.out_channels, 32, bottom_level=3, top_level=5, generator=gen, device="cuda")
        # K1 takes 256-wide hidden layers
        head = ObjectDetection(neck.out_channels, 3, num_layers=1, max_instances=8, max_targets=5, generator=gen,
                               device="cuda")
        model = SihlModel(backbone, neck, [head])
        logged = []
        trainer = Trainer(model, optimizer="adamw", optimizer_kwargs={"lr": 1e-3}, grad_clip=0.1,
                          logger=lambda metrics, step: logged.append((step, metrics)))
        trainer.fit(data, num_steps=2, steps_per_dispatch=dispatch, log_every=dispatch)
        return logged, model.state_dict()

    hosts = _host_batches(2, seed=1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want_log, want_state = fitted([to_device(h, "cuda") for h in hosts])
        with DevicePrefetcher(iter(hosts), device="cuda") as prefetcher:
            got_log, got_state = fitted(prefetcher)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert got_log == want_log and len(got_log) == 2 // dispatch
    for k, v in want_state.items():
        assert torch.equal(got_state[k], v), k
