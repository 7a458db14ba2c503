"""Parity of the port's self-supervised heads and Welford helpers with the
JAX package's (f32, CPU): ``BatchedMeanVarianceAccumulator`` and
``welford_init`` / ``welford_update`` / ``welford_compute`` (the first
batch's spread dropped in both packages), ``Autoencoding`` and
``ViewInvarianceLearning``: each head's forward, ``training_step`` (the
loss, every gradient and the running statistics) and validation triple,
and the autoencoder's bottleneck, which must flatten in the JAX package's
(h, w, c) order.

Heads at the size of ``tests/heads``: a synthetic pyramid of 4 images at
64 px (level 5 is 2 x 2 with 64 channels, so the 4 x 4 pre-bottleneck map
has more than one pixel), 16 channels, weights carried by
``state_dict_from_flat``.  Tolerances: forwards within 1e-5 relative
(``assert_forward_close``), losses within 1e-5 relative, gradients within
relative L2 1e-3 (the heads' limit of the slice tests: the heads'
train-mode BatchNorms cancel digits) where they are not zero in exact
arithmetic (then below 1e-7 of the largest on both sides), running statistics within 1e-5,
validation metrics within 1e-5 relative; the Welford helpers within 1e-6
relative of JAX's f32 results.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.heads import Autoencoding as JaxAutoencoding
from sihl_tpu.heads import ViewInvarianceLearning as JaxViewInvarianceLearning
from sihl_tpu.utils import BatchedMeanVarianceAccumulator as JaxAccumulator
from sihl_tpu.utils import welford_compute as jax_welford_compute
from sihl_tpu.utils import welford_init as jax_welford_init
from sihl_tpu.utils import welford_update as jax_welford_update
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import Autoencoding, ViewInvarianceLearning
from sihl_tpu_torch.utils import BatchedMeanVarianceAccumulator, welford_compute, welford_init, welford_update

from test_torch_convblocks import assert_forward_close, load, randomize_all_norms, relative_l2
from torch_parity import flat_state, to_numpy, to_torch

BATCH = 4
HEAD_GRAD_REL = 1e-3
# a gradient below this share of the head's largest is rounding noise
ZERO_GRAD = 1e-7


def pyramids(seed: int = 0):
    levels = make_pyramid(batch_size=BATCH, rng=np.random.RandomState(seed))
    return [jnp.asarray(p) for p in levels], [to_torch(p) for p in levels]


def in_channels():
    return [p.shape[-1] for p in make_pyramid(batch_size=1)]


# -- Welford ------------------------------------------------------------------------


def _batches(seed: int = 0):
    """Three batches of rows with their own offsets and spreads."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, 5) * s + o).astype(np.float32) for n, s, o in ((6, 1.0, 0.0), (9, 3.0, 2.0), (4, 0.5, -1.0))]


def test_welford_functional_matches_jax_and_drops_the_first_batch_spread():
    """The functional form equals JAX's after each batch; both drop the first
    batch's spread within itself, so neither is ``numpy.var(ddof=1)`` over
    all rows (a fault of the reference that the port copies)."""
    batches = _batches()
    jax_state, state = jax_welford_init((5,)), welford_init((5,))
    for x in batches:
        jax_state = jax_welford_update(jax_state, jnp.asarray(x))
        state = welford_update(state, torch.from_numpy(x))
        for got, want in zip(state, jax_state):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert state[0].dtype == torch.float32 and float(state[0]) == sum(len(x) for x in batches)
    (mean, var), (w_mean, w_var) = welford_compute(state), jax_welford_compute(jax_state)
    np.testing.assert_allclose(mean.numpy(), np.asarray(w_mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(w_var), rtol=1e-6)
    rows = np.concatenate(batches).astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), rows.mean(0), rtol=1e-5, atol=1e-6)
    true_var = rows.var(0, ddof=1)
    assert (np.abs(var.numpy() - true_var) > 1e-2 * true_var).all()
    # the shortfall is the first batch's spread: m2 lacks its sum of squares
    dropped = batches[0].astype(np.float64).var(0) * len(batches[0]) / (len(rows) - 1)
    np.testing.assert_allclose(var.numpy() + dropped, true_var, rtol=1e-5)


def test_welford_below_two_rows_is_nan():
    state = welford_update(welford_init((3,)), torch.ones(1, 3))
    want = jax_welford_compute(jax_welford_update(jax_welford_init((3,)), jnp.ones((1, 3))))
    assert torch.isnan(welford_compute(state)[1]).all() and np.isnan(np.asarray(want[1])).all()


def test_batched_accumulator_matches_jax():
    got, want = BatchedMeanVarianceAccumulator(), JaxAccumulator()
    batches = _batches(1)
    got.update(batches[0][:1])
    want.update(batches[0][:1])
    assert torch.isnan(got.compute()[1]).all() and np.isnan(np.asarray(want.compute()[1])).all()
    for x in batches:
        got.update(torch.from_numpy(x))
        want.update(x)
    assert got.count == want.count
    for g, w in zip(got.compute(), want.compute()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Shape mismatch"):
        got.update(torch.zeros(2, 4))


# -- the heads ------------------------------------------------------------------------

AE_KWARGS = dict(num_channels=16, num_layers=2, representation_channels=32)
VI_KWARGS = dict(embedding_dim=24, num_channels=16, num_layers=2)


def head_pair(kind: str):
    """The JAX head (built under ``nnx.jit``: eagerly its construction takes
    seconds) with random norms, and the port's head carrying its weights."""
    rng = np.random.RandomState(1)
    if kind == "autoencoding":
        jax_head = nnx.jit(lambda: JaxAutoencoding(in_channels(), rngs=nnx.Rngs(0), **AE_KWARGS))()
        head = Autoencoding(in_channels(), **AE_KWARGS)
    else:
        jax_head = nnx.jit(lambda: JaxViewInvarianceLearning(in_channels(), rngs=nnx.Rngs(0), **VI_KWARGS))()
        head = ViewInvarianceLearning(in_channels(), **VI_KWARGS)
    randomize_all_norms(jax_head, rng)
    return jax_head, load(head, jax_head)


def targets(kind: str, seed: int):
    """The autoencoder's target is the input image; the view-invariance
    head's is a second pyramid."""
    jax_inputs, inputs = pyramids(seed)
    if kind == "autoencoding":
        return (jax_inputs[0],), (inputs[0],)
    jax_view, view = pyramids(seed + 100)
    return (jax_view,), (view,)


@pytest.mark.parametrize("kind", ["autoencoding", "view_invariance"])
def test_forward(kind):
    jax_head, head = head_pair(kind)
    jax_inputs, inputs = pyramids()
    jax_head.eval()
    want = jax_head(jax_inputs)
    with torch.no_grad():
        got = head.eval()(inputs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == len(head.output_shapes)
    for (name, shape), g, w in zip(head.output_shapes.items(), got, want):
        assert tuple(g.shape) == tuple(BATCH if d == "batch_size" else 64 if isinstance(d, str) else d
                                       for d in shape), name
        assert g.dtype == torch.float32
        assert_forward_close(to_numpy(g, nhwc=g.ndim == 4), w)
    if kind == "autoencoding":
        assert ((got[0] >= 0) & (got[0] <= 1)).all() and (got[1] >= 0).all()


def test_autoencoder_bottleneck_flattens_in_nhwc_order():
    """The representations equal JAX's, and the same weights applied to the
    map flattened in NCHW order give something else: the test would catch
    that order."""
    jax_head, head = head_pair("autoencoding")
    jax_inputs, inputs = pyramids(2)
    jax_head.eval()
    head.eval()
    want = np.asarray(jax_head(jax_inputs)[1])
    captured = []
    head.encode_linear.register_forward_pre_hook(lambda mod, args: captured.append(args[0]))
    with torch.no_grad():
        got = head(inputs)[1]
        nhwc = captured[0].reshape(BATCH, *head.size, head.num_channels)
        nchw_flat = nhwc.permute(0, 3, 1, 2).reshape(BATCH, -1)
        wrong = head.encode_act(head.encode_linear(nchw_flat))
    assert_forward_close(got.numpy(), want)
    assert relative_l2(wrong.numpy(), want) > 0.1


@pytest.mark.parametrize("kind", ["autoencoding", "view_invariance"])
def test_training_step(kind):
    """The loss and every parameter's gradient, train mode (batch statistics),
    and the running statistics after the step (the view-invariance head's
    projector runs on both views, first on the first)."""
    jax_head, head = head_pair(kind)
    jax_inputs, inputs = pyramids(3)
    jax_target, target = targets(kind, 3)
    jax_head.train()

    @nnx.jit
    def value_and_grad(m, xs, t):
        return nnx.value_and_grad(lambda mm: mm.training_step(xs, *t)[0])(m)

    want, grads = value_and_grad(jax_head, jax_inputs, jax_target)
    want_grads = state_dict_from_flat(
        {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads)}, head
    )
    loss, metrics = head.train().training_step(inputs, *target)
    loss.backward()
    assert metrics == {} and loss.dtype == torch.float32
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    largest = max(float(g.norm()) for g in want_grads.values())
    for name, p in head.named_parameters():
        if float(want_grads[name].norm()) <= ZERO_GRAD * largest:
            # zero in exact arithmetic: the view-invariance projector's last
            # biases shift every image's embedding alike, which the
            # standardisation over the batch removes
            assert float(p.grad.norm()) <= ZERO_GRAD * largest, name
            continue
        err = relative_l2(p.grad.numpy(), want_grads[name].numpy())
        assert err <= HEAD_GRAD_REL, (name, err)
    jax_stats = state_dict_from_flat(flat_state(jax_head), head)
    for name, b in head.named_buffers():
        np.testing.assert_allclose(b.numpy(), jax_stats[name].numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("kind", ["autoencoding", "view_invariance"])
def test_validation(kind):
    """``metrics_init``, two ``validation_step``s and ``validation_end`` in eval mode."""
    jax_head, head = head_pair(kind)
    jax_head.eval()
    head.eval()
    jax_state, state = jax_head.metrics_init(), head.metrics_init()
    for seed in (4, 5):
        jax_inputs, inputs = pyramids(seed)
        jax_target, target = targets(kind, seed)
        jax_state, want_loss, want_aux = jax_head.validation_step(jax_state, jax_inputs, *jax_target)
        with torch.no_grad():
            state, loss, aux = head.validation_step(state, inputs, *target)
        assert aux == {} == want_aux
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    want = jax_head.validation_end(jax_state)
    got = head.validation_end(state)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


def test_head_refusals():
    with pytest.raises(ValueError, match="level"):
        Autoencoding([3, 8], level=5)
    with pytest.raises(ValueError, match="> 0"):
        Autoencoding(in_channels(), num_layers=0)
    with pytest.raises(ValueError, match="level"):
        ViewInvarianceLearning([3, 8], level=5)
    assert ViewInvarianceLearning.target_is_second_view
