"""Parity of the port's classification and regression heads with the JAX
package's (f32, CPU): ``log_cosh_loss``, ``GlobalPoolReadout``,
``soft_ordinal_category``, ``MulticlassClassification`` (label smoothing,
ordinal), ``MultilabelClassification`` (its stable descending sort) and
``Regression``, each head's forward, ``training_step`` and validation
triple; and the port's copy of ``OptimalF1Threshold``.

Heads at the size of ``tests/heads``: a synthetic pyramid of 4 images at
64 px (level 5 is 2 x 2 with 64 channels), 16 channels, one layer, weights
carried by ``state_dict_from_flat``.  Tolerances: forwards and losses
within 1e-5 relative; gradients within relative L2 1e-3, the heads' limit
of the slice tests (the head's train-mode BatchNorm over 16 samples a
channel cancels digits); validation metrics within 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.heads import MulticlassClassification as JaxMulticlassClassification
from sihl_tpu.heads import MultilabelClassification as JaxMultilabelClassification
from sihl_tpu.heads import Regression as JaxRegression
from sihl_tpu.heads import soft_ordinal_category as jax_soft_ordinal_category
from sihl_tpu.heads.base import GlobalPoolReadout as JaxGlobalPoolReadout
from sihl_tpu.ops.losses import log_cosh_loss as jax_log_cosh_loss
from sihl_tpu.utils.f1 import OptimalF1Threshold as JaxOptimalF1Threshold
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import (MulticlassClassification, MultilabelClassification, Regression,
                                  soft_ordinal_category)
from sihl_tpu_torch.heads.base import GlobalPoolReadout
from sihl_tpu_torch.ops.losses import log_cosh_loss
from sihl_tpu_torch.utils import OptimalF1Threshold

from test_torch_convblocks import assert_forward_close, load, randomize_all_norms, relative_l2
from torch_parity import flat_state, to_torch

BATCH, NUM_CLASSES = 4, 7
HEAD_GRAD_REL = 1e-3


def pyramids(seed: int = 0):
    levels = make_pyramid(batch_size=BATCH, rng=np.random.RandomState(seed))
    return [jnp.asarray(p) for p in levels], [to_torch(p) for p in levels]


def in_channels():
    return [p.shape[-1] for p in make_pyramid(batch_size=1)]


def targets(kind: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    if kind == "multiclass":
        t = rng.randint(0, NUM_CLASSES, BATCH)
        return jnp.asarray(t), torch.from_numpy(t)
    if kind == "multilabel":
        t = (rng.rand(BATCH, NUM_CLASSES) > 0.5).astype(np.float32)
        return jnp.asarray(t), torch.from_numpy(t)
    t = (rng.rand(BATCH) * 13.0 - 3.0).astype(np.float32)
    return jnp.asarray(t), torch.from_numpy(t)


def head_pair(kind: str, **kwargs):
    rng = np.random.RandomState(1)
    if kind == "multiclass":
        jax_head = JaxMulticlassClassification(in_channels(), NUM_CLASSES, num_channels=16, rngs=nnx.Rngs(0), **kwargs)
        head = MulticlassClassification(in_channels(), NUM_CLASSES, num_channels=16, **kwargs)
    elif kind == "multilabel":
        jax_head = JaxMultilabelClassification(in_channels(), NUM_CLASSES, num_channels=16, rngs=nnx.Rngs(0), **kwargs)
        head = MultilabelClassification(in_channels(), NUM_CLASSES, num_channels=16, **kwargs)
    else:
        jax_head = JaxRegression(in_channels(), -3.0, 10.0, num_channels=16, rngs=nnx.Rngs(0), **kwargs)
        head = Regression(in_channels(), -3.0, 10.0, num_channels=16, **kwargs)
    randomize_all_norms(jax_head, rng)
    return jax_head, load(head, jax_head)


# -- ops and the readout ----------------------------------------------------------


def test_log_cosh_loss():
    """The stable form, also where cosh overflows f32 (|x| > 89)."""
    rng = np.random.RandomState(0)
    pred = np.concatenate([rng.randn(64) * 3, [100.0, -120.0, 0.0, 1e-4]]).astype(np.float32)
    target = np.concatenate([rng.randn(64), [-5.0, 3.0, 0.0, 0.0]]).astype(np.float32)
    got = log_cosh_loss(torch.from_numpy(pred), torch.from_numpy(target))
    want = np.asarray(jax_log_cosh_loss(jnp.asarray(pred), jnp.asarray(target)))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert log_cosh_loss(torch.ones(3, dtype=torch.bfloat16), torch.zeros(3)).dtype == torch.float32


def test_soft_ordinal_category():
    labels = np.array([0, 3, 6, 2])
    for peakiness in (1.0, 2.5):
        got = soft_ordinal_category(torch.from_numpy(labels), NUM_CLASSES, peakiness)
        want = jax_soft_ordinal_category(jnp.asarray(labels), NUM_CLASSES, peakiness)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_global_pool_readout(num_layers):
    rng = np.random.RandomState(2)
    jax_readout = JaxGlobalPoolReadout(32, 16, 5, num_layers, rngs=nnx.Rngs(0))
    randomize_all_norms(jax_readout, rng)
    jax_readout.eval()
    readout = load(GlobalPoolReadout(32, 16, 5, num_layers), jax_readout).eval()
    x = rng.randn(2, 4, 6, 32).astype(np.float32)
    with torch.no_grad():
        got = readout(to_torch(x))
    assert got.shape == (2, 5)
    assert_forward_close(got.numpy(), jax_readout(jnp.asarray(x)))


# -- the heads ---------------------------------------------------------------------


HEADS = [
    ("multiclass", {}),
    ("multiclass", {"label_smoothing": 0.1}),
    ("multiclass", {"is_ordinal": True}),
    ("multiclass", {"is_ordinal": True, "label_smoothing": 0.2, "num_layers": 2}),
    ("multilabel", {}),
    ("regression", {}),
    ("regression", {"num_layers": 2, "level": 4}),
]


@pytest.mark.parametrize("kind,kwargs", HEADS[:1] + HEADS[4:])
def test_forward(kind, kwargs):
    jax_head, head = head_pair(kind, **kwargs)
    jax_inputs, inputs = pyramids()
    jax_head.eval()
    want = jax_head(jax_inputs)
    with torch.no_grad():
        got = head.eval()(inputs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == len(head.output_shapes) and head.output_shapes == jax_head.output_shapes
    for (name, shape), g, w in zip(head.output_shapes.items(), got, want):
        assert tuple(g.shape) == tuple(BATCH if isinstance(d, str) else d for d in shape), name
        if g.is_floating_point():
            assert g.dtype == torch.float32
            assert_forward_close(g.numpy(), w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("kind,kwargs", HEADS)
def test_training_step(kind, kwargs):
    """The loss and every parameter's gradient, train mode (batch statistics)."""
    jax_head, head = head_pair(kind, **kwargs)
    jax_inputs, inputs = pyramids(3)
    jax_target, target = targets(kind, 3)
    jax_head.train()

    @nnx.jit
    def value_and_grad(m, xs, t):
        return nnx.value_and_grad(lambda mm: mm.training_step(xs, t)[0])(m)

    want, grads = value_and_grad(jax_head, jax_inputs, jax_target)
    want_grads = state_dict_from_flat(
        {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads)}, head
    )
    loss, metrics = head.train().training_step(inputs, target)
    loss.backward()
    assert metrics == {} and loss.dtype == torch.float32
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    for name, p in head.named_parameters():
        err = relative_l2(p.grad.numpy(), want_grads[name].numpy())
        assert err <= HEAD_GRAD_REL, (name, err)
    jax_stats = state_dict_from_flat(flat_state(jax_head), head)
    for name, b in head.named_buffers():
        np.testing.assert_allclose(b.numpy(), jax_stats[name].numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind,kwargs", [HEADS[1], HEADS[2], HEADS[4], HEADS[5]])
def test_validation(kind, kwargs):
    """``metrics_init``, two ``validation_step``s and ``validation_end`` in eval mode."""
    jax_head, head = head_pair(kind, **kwargs)
    jax_head.eval()
    head.eval()
    jax_state, state = jax_head.metrics_init(), head.metrics_init()
    for seed in (4, 5):
        jax_inputs, inputs = pyramids(seed)
        jax_target, target = targets(kind, seed)
        jax_state, want_loss, want_aux = jax_head.validation_step(jax_state, jax_inputs, jax_target)
        with torch.no_grad():
            state, loss, aux = head.validation_step(state, inputs, target)
        assert aux == {} == want_aux
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    want = jax_head.validation_end(jax_state)
    got = head.validation_end(state)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


def test_multilabel_sort_keeps_tied_labels_in_ascending_order():
    """Tied scores keep ascending label order, as ``jnp.argsort(-p)`` (stable)
    gives them; ``torch.sort`` without ``stable`` promises no order."""
    jax_head, head = head_pair("multilabel")
    bias = np.array([0.5, 1.0, 0.5, 1.0, -1.0, 0.5, 1.0], np.float32)
    jax_head.readout.out_conv.kernel[...] = jnp.zeros_like(jax_head.readout.out_conv.kernel[...])
    jax_head.readout.out_conv.bias[...] = jnp.asarray(bias)
    load(head, jax_head)
    jax_inputs, inputs = pyramids()
    jax_head.eval()
    want_scores, want_labels = jax_head(jax_inputs)
    with torch.no_grad():
        scores, labels = head.eval()(inputs)
    expected = np.tile(np.argsort(-bias, kind="stable"), (BATCH, 1))
    np.testing.assert_array_equal(np.asarray(want_labels), expected)
    np.testing.assert_array_equal(labels.numpy(), expected)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want_scores))


def test_head_refusals():
    with pytest.raises(ValueError, match="level"):
        MulticlassClassification([3, 8], NUM_CLASSES, level=5)
    with pytest.raises(ValueError, match="> 0"):
        MultilabelClassification(in_channels(), 0)
    with pytest.raises(ValueError, match="below"):
        Regression(in_channels(), 1.0, 1.0)


# -- OptimalF1Threshold --------------------------------------------------------------


def _f1_images(rng, n_images=6):
    images = []
    for _ in range(n_images):
        m, n = rng.randint(0, 5), rng.randint(0, 8)
        tb = np.sort(rng.rand(m, 2, 2) * 100, axis=1).reshape(m, 4)[:, [0, 2, 1, 3]]
        tc = rng.randint(0, 3, m)
        # predictions: jittered copies of some targets, and random boxes
        pick = rng.randint(0, max(m, 1), n) if m else np.zeros(0, int)
        pb = (tb[pick] + rng.randn(len(pick), 4) * 4) if m else np.zeros((0, 4))
        extra = np.sort(rng.rand(n - len(pb), 2, 2) * 100, axis=1).reshape(-1, 4)[:, [0, 2, 1, 3]]
        pb = np.concatenate([pb, extra]) if len(extra) else pb
        pc = np.where(rng.rand(len(pb)) < 0.8, tc[pick] if m else 0, rng.randint(0, 3, len(pb)))
        ps = np.round(rng.rand(len(pb)), 2)  # rounded, so that some scores tie
        images.append((pc, ps, pb, tc, tb))
    return images


@pytest.mark.parametrize("class_metrics,granularity", [(False, 10), (True, 4), (True, 100)])
def test_optimal_f1_threshold_matches_jax(class_metrics, granularity):
    rng = np.random.RandomState(9)
    got = OptimalF1Threshold(0.5, class_metrics=class_metrics, threshold_granularity=granularity)
    want = JaxOptimalF1Threshold(0.5, class_metrics=class_metrics, threshold_granularity=granularity)
    for image in _f1_images(rng):
        got.update(*image)
        want.update(*image)
    result = got.compute()
    assert result == want.compute()
    assert 0 < result["best_f1"] < 1
    assert OptimalF1Threshold().compute() == {"optimal_threshold": 0.5, "best_f1": 0.0}
