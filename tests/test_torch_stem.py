"""The port's frozen stem (K4's plain version) against the JAX package's
(CPU): ``stem_conv_stats`` against the Pallas kernel in interpret mode, and
a ResNet whose level 1 is frozen against JAX's ``_Stem._fused`` path
(``SIHL_TPU_STEM_FUSED=interpret``, set here for the test only).

Tolerances: in f32, y within 1e-4 and the sums within 1e-5 relative
(``tests/ops/test_stem_kernel.py`` holds the Pallas kernel so against XLA's
conv; the sums add 2 * 16 * 16 values in another order).  In bf16 both
sides round f32 sums of exact products, in two orders, so y agrees within
one bf16 step, and each side's sums are those of its own
rounded y (1e-5 relative).  Backbone levels within 1e-4, running
statistics within 1e-6.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu.ops.pallas.stem import stem_conv_stats as jax_stem_conv_stats
from sihl_tpu_torch import Backbone
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.ops import stem as stem_ops
from sihl_tpu_torch.ops.stem import stem_conv_stats, supported
from sihl_tpu_torch.policy import compute_dtype_scope

from torch_parity import assert_within_one_bf16_step, flat_state, load_from_jax, randomize_norms, to_numpy, to_torch

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _sums(y: np.ndarray):
    y = y.astype(np.float64)
    return y.sum(axis=(0, 1, 2)), (y * y).sum(axis=(0, 1, 2))


@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_stem_conv_stats_matches_jax_kernel(dtype_name, c):
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.RandomState(c)
    x = rng.randn(2, 32, 32, c).astype(np.float32)
    w = (rng.randn(7, 7, c, 64) * 0.1).astype(np.float32)
    want_y, want_s, want_q = (
        np.asarray(a, np.float32)
        for a in jax_stem_conv_stats(jnp.asarray(x, jdt), jnp.asarray(w, jdt), interpret=True)
    )
    xt = to_torch(x).to(tdt).contiguous(memory_format=torch.channels_last)
    y, s, q = stem_conv_stats(xt, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    assert y.dtype == tdt and s.dtype == q.dtype == torch.float32
    assert y.shape == (2, 64, 16, 16) and y.is_contiguous(memory_format=torch.channels_last)
    got_y = to_numpy(y, nhwc=True)
    if dtype_name == "float32":
        np.testing.assert_allclose(got_y, want_y, atol=1e-4, rtol=0)
        np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(q.numpy(), want_q, rtol=1e-5, atol=1e-2)
    else:
        assert_within_one_bf16_step(got_y, want_y)
        for got, want in zip((s.numpy(), q.numpy()), _sums(got_y)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
        for got, want in zip((want_s, want_q), _sums(want_y)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("c", [1, 3, 5, 8])
def test_weight_image_k_order_and_zero_rows(c):
    """The bf16 kernel's weight image against a loop over the taps: row
    (ky * 8 + kx) * CP + c, CP = 4 for C <= 4 and 8 above, holds the bf16
    weights of (c, ky, kx) for the 64 outputs; the rows of the eighth tap
    kx = 7 and of the channels past C are zero."""
    w = np.random.RandomState(20 + c).randn(64, c, 7, 7).astype(np.float32)
    cp = 4 if c <= 4 else 8
    want = np.zeros((7 * 8 * cp, 64), np.float32)
    for ky in range(7):
        for kx in range(7):
            for ch in range(c):
                want[(ky * 8 + kx) * cp + ch] = w[:, ch, ky, kx]
    got = stem_ops.weight_image(torch.from_numpy(w))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), torch.from_numpy(want).bfloat16().float().numpy())
    taps = got.reshape(7, 8, cp, 64)
    assert not taps[:, 7].any() and not taps[:, :, c:].any()


def test_supported_gates():
    w = (64, 3, 7, 7)
    assert supported((2, 3, 64, 64), w)
    assert supported((2, 3, 36, 36), w)  # H/2 = 18: no row-tile condition
    assert supported((2, 8, 64, 64), (64, 8, 7, 7))
    assert not supported((2, 3, 63, 64), w)  # odd H
    assert not supported((2, 4, 64, 64), w)  # channel mismatch
    assert not supported((2, 9, 64, 64), (64, 9, 7, 7))  # more than 8 channels
    assert not supported((2, 3, 64, 64), (64, 3, 5, 5))  # wrong kernel
    assert not supported((2, 3, 64, 64), (32, 3, 7, 7))  # not the stem's 64 outputs
    with pytest.raises(ValueError, match="stem_conv_stats takes"):
        stem_conv_stats(torch.zeros(1, 3, 63, 64), torch.zeros(64, 3, 7, 7))


def test_stem_conv_stats_ragged_rows_and_f64():
    """An H/2 that is not a multiple of 4, and the f64 sums of an f64 image."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 36, 38, generator=gen, dtype=torch.float64)
    w = torch.randn(64, 3, 7, 7, generator=gen) * 0.1
    y, s, q = stem_conv_stats(x.contiguous(memory_format=torch.channels_last), w)
    want = torch.nn.functional.conv2d(x, w.double(), stride=2, padding=3)
    assert y.shape == (2, 64, 18, 19) and s.dtype == q.dtype == torch.float64
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(s, want.sum(dim=(0, 2, 3)), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(q, (want * want).sum(dim=(0, 2, 3)), rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def backbone_pair():
    rng = np.random.RandomState(1)
    jax_bb = JaxBackbone("resnet18", rngs=nnx.Rngs(0))
    randomize_norms(jax_bb, rng)
    jax_bb.set_frozen_levels(1)
    bb = load_from_jax(Backbone("resnet18"), jax_bb)
    bb.set_frozen_levels(1)
    return jax_bb, bb, rng.rand(2, 64, 64, 3).astype(np.float32)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_frozen_stem_matches_jax_fused_stem(backbone_pair, monkeypatch, train):
    """A ResNet-18 with level 1 frozen: the port's stem goes through
    ``stem_conv_stats`` once; every level and the stem's running statistics
    (updated in training mode, untouched in eval mode) match JAX's fused
    stem path."""
    monkeypatch.setenv("SIHL_TPU_STEM_FUSED", "interpret")
    jax_bb, bb, x = backbone_pair
    jax_bb = nnx.clone(jax_bb)
    bb = copy.deepcopy(bb)
    jax_bb.train() if train else jax_bb.eval()
    bb.train(train)
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return stem_conv_stats(*args)

    monkeypatch.setattr(stem_ops, "stem_conv_stats", spy)
    want = jax_bb(jnp.asarray(x))
    before = {n: b.clone() for n, b in bb.named_buffers()}
    with torch.no_grad():
        got = bb(to_torch(x))
    assert calls == [(2, 3, 64, 64)]
    for level, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(to_numpy(g, nhwc=True), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=f"level {level}")
    stats = state_dict_from_flat(flat_state(jax_bb))
    for name in ("features.stem.bn.running_mean", "features.stem.bn.running_var"):
        np.testing.assert_allclose(bb.state_dict()[name].numpy(), stats[name].numpy(), rtol=1e-6, atol=1e-6)
        assert train != torch.equal(bb.state_dict()[name], before[name])


def test_unfrozen_and_f64_stems():
    """An unfrozen stem takes the conv and BatchNorm2d, not the kernel; a
    frozen stem built under the f64 compute dtype keeps f64 through it."""
    x = torch.rand(1, 3, 32, 32)
    bb = Backbone("resnet18").train()
    assert bb.features.stem(x, fwd_only=False).requires_grad
    with compute_dtype_scope(torch.float64):
        bb64 = Backbone("resnet18").train()
    bb64.set_frozen_levels(1)
    levels = bb64(x)
    assert levels[1].dtype == torch.float64 and not levels[1].requires_grad
    assert bb64.features.stem.bn.running_mean.dtype == torch.float32
