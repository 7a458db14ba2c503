"""The self-supervised and anomaly slice of the port against the JAX
package's (CPU): the three models that ``chip_smoke.py`` runs at full
size, at 64 px.  This file holds the tests and runs them on the
autoencoder; ``tests/test_torch_view_invariance_slice.py`` and
``tests/test_torch_anomaly_slice.py`` run them on the other two models
(one file a model, so that test workers can take them apart).

* the autoencoder: resnet18 with level 1 frozen, no neck → Autoencoding
  (16 channels, 2 refine layers, a 32-wide representation); the target is
  the input;
* the view-invariance model: resnet18 with level 1 frozen →
  ViewInvarianceLearning (a 24-wide embedding, 16 channels, 2 layers); the
  target is a second view, the image scaled in brightness with noise,
  clipped to [0, 1], as ``examples/view_invariance.py`` makes it; the trunk
  runs on both views, in that order, in each step;
* the anomaly model: resnet18 with every level frozen and its BatchNorms in
  eval mode (EfficientAD's teacher; its BatchNorm statistics taken from a
  batch, ``torch_parity.batch_stats_from_data``, so that no teacher channel
  is 0 everywhere) → AnomalyDetection (16 channels, an 8-wide autoencoder,
  a ring of 256 with 64 samples a step).

4 images at 64 px, each with its own brightness and contrast, weights
carried by ``state_dict_from_flat`` (strict), every basic block's last
BatchNorm damped to U(0.01, 0.03) as in
``tests/test_torch_classification_slice.py``.

Compared: the forward in eval mode against JAX's f32 forward (within 1e-5
relative); one training step through ``_losses`` with the port in f64 and
in f32 against JAX's jitted f64 step (``jax_f64``; losses within 1e-4
relative, every gradient of the port's f64 step within ``F64_LIMIT`` and
of its f32 step within the relative L2 limit of its part (the
autoencoder's heads at ``AUTOENCODER_HEAD_LIMIT``), a gradient that
is zero in exact arithmetic below 1e-6 of its part's largest, every buffer
within 1e-4 after the step: the running statistics after the
view-invariance model's two trunk passes, the anomaly head's reservoir,
position and fill); the port's f32 ``Trainer.training_step`` against the
JAX ``Trainer``'s f64 step (metrics within 1e-4, the update as
``assert_update_matches`` holds it, the autoencoder's backbone at
``UPDATE_FLIPS``); and ``Trainer.validate`` over two
batches against JAX's (metrics within 1e-4 relative), for the anomaly
model after ``Trainer.pretrain`` over two batches (the teacher's mean and
standard deviation within 1e-5 relative) and two training steps, on a
normal batch and one with a noise patch, as ``examples/anomaly_detection.py``
validates.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.heads import AnomalyDetection as JaxAnomalyDetection
from sihl_tpu.heads import Autoencoding as JaxAutoencoding
from sihl_tpu.heads import ViewInvarianceLearning as JaxViewInvarianceLearning
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import AnomalyDetection, Autoencoding, ViewInvarianceLearning
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

from test_torch_anomaly import topk_margin
from test_torch_classification_slice import _damp_basic_blocks, _relative_error
from test_torch_hybrid_slice import F64_LIMIT, GRADIENT_LIMITS, OPTIMIZER, _f64, assert_update_matches, jax_f64
from test_torch_hybrid_slice import UPDATE_FLIPS as HYBRID_UPDATE_FLIPS
from torch_parity import batch_stats_from_data, copy_batch_stats, flat_state, randomize_norms, to_torch

KIND = "autoencoding"
BATCH, SIZE = 4, 64
# The autoencoder's f32 gradients lose digits everywhere: the loss's
# cotangent 2 (reconstruction - image) / n is nearly constant over each
# image, and the decoder's train-mode BatchNorms remove each channel's mean
# from it.  The port's f32 step reads up to 1.3e-3 from its f64 step on the
# head (an upscaler's BatchNorm bias, the decoder's linear layer) and 9.9e-4
# on the backbone, ReLU decisions all equal; so its heads are held at 5e-3.
AUTOENCODER_HEAD_LIMIT = 5e-3
# The same digits move the first AdamW step of a weight whose gradient is
# near AdamW's epsilon (1e-8): 4.0% of the autoencoder's backbone weights
# land more than 1e-3 of their learning rate from JAX's f64 step; the other
# parts and models keep ``UPDATE_FLIPS``.
UPDATE_FLIPS = {"autoencoding": {**HYBRID_UPDATE_FLIPS, "backbone": 0.08}}


def _build(kind, backbone, autoencoding, view_invariance, anomaly, model, **init):
    frozen = -1 if kind == "anomaly" else 1
    bb = backbone("resnet18", top_level=5, freeze_batchnorms=kind == "anomaly", **init)
    bb.set_frozen_levels(frozen)
    c = bb.out_channels
    if kind == "autoencoding":
        head = autoencoding(c, num_channels=16, num_layers=2, representation_channels=32, **init)
    elif kind == "view_invariance":
        head = view_invariance(c, embedding_dim=24, num_channels=16, num_layers=2, **init)
    else:
        head = anomaly(c, num_channels=16, autoencoder_channels=8, reservoir_size=256, samples_per_step=64, **init)
    return model(bb, None, [head])


JAX_MODULES = (JaxBackbone, JaxAutoencoding, JaxViewInvarianceLearning, JaxAnomalyDetection, JaxSihlModel)
PORT_MODULES = (Backbone, Autoencoding, ViewInvarianceLearning, AnomalyDetection, SihlModel)


def _images(rng) -> np.ndarray:
    x = rng.rand(BATCH, SIZE, SIZE, 3) * rng.uniform(0.25, 1.0, (BATCH, 1, 1, 1))
    return np.clip(x + rng.uniform(0.0, 0.5, (BATCH, 1, 1, 1)), 0, 1).astype(np.float32)


def _batch(kind: str, seed: int, anomalous: bool = False):
    """(JAX batch, port batch): images and the head's target: the images
    themselves, a second view, or none (the anomaly model's validation takes
    the (B, H, W) anomaly mask: all 0, or all 1 for a batch with a noise
    patch, as ``examples/anomaly_detection.py`` labels its batches)."""
    rng = np.random.RandomState(seed)
    x = _images(rng)
    if kind == "autoencoding":
        return (jnp.asarray(x), jnp.asarray(x)), (to_torch(x), to_torch(x))
    if kind == "view_invariance":
        view = np.clip(x * (0.8 + 0.4 * rng.rand()) + rng.randn(*x.shape) * 0.05, 0, 1).astype(np.float32)
        return (jnp.asarray(x), jnp.asarray(view)), (to_torch(x), to_torch(view))
    if anomalous:
        x[:, 15:30, 15:30] = rng.rand(BATCH, 15, 15, 3)
    mask = np.full((BATCH, SIZE, SIZE), float(anomalous), np.float32)
    return (jnp.asarray(x), jnp.asarray(mask)), (to_torch(x), torch.from_numpy(mask))


def _pair(kind):
    jax_model = nnx.jit(lambda: _build(kind, *JAX_MODULES, rngs=nnx.Rngs(0)))()
    rng = np.random.RandomState(0)
    randomize_norms(jax_model, rng)
    _damp_basic_blocks(jax_model, rng)
    models = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            models[dtype] = _build(kind, *PORT_MODULES)
        models[dtype].load_state_dict(state_dict_from_flat(flat_state(jax_model), models[dtype]), strict=True)
    if kind == "anomaly":
        batch_stats_from_data(models[torch.float32].backbone, _batch(kind, 9)[1][0])
        copy_batch_stats(models[torch.float32], jax_model)
        models[torch.float64].load_state_dict(models[torch.float32].state_dict())
    return kind, jax_model, models


@pytest.fixture(scope="module")
def pair():
    return _pair(KIND)


def _targets(kind, t):
    """A batch's head targets as ``_losses`` takes them: one list entry; none
    in training for the anomaly model."""
    return [None if kind == "anomaly" else t]


def test_forward_matches_jax(pair):
    kind, jax_model, models = pair
    (jx, _), (x, _) = _batch(kind, 1)
    jax_model = nnx.clone(jax_model)
    jax_model.eval()
    want = nnx.jit(lambda m, xx: m(xx))(jax_model, jx)[0]
    with torch.no_grad():
        got = copy.deepcopy(models[torch.float32]).eval()(x)[0]
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == len(models[torch.float32].heads[0].output_shapes)
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1) if g.ndim == 4 else g
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


def _jax_model64(kind, jax_model):
    model = nnx.jit(lambda: _build(kind, *JAX_MODULES, rngs=nnx.Rngs(0)))()
    nnx.update(model, _f64(nnx.state(jax_model, nnx.Not(nnx.RngState))))
    return model


@pytest.fixture(scope="module")
def jax_step(pair):
    """JAX's f64 training step (the JAX ``Trainer``'s ``_train_step``: the
    losses' value and gradients, then the optimizer's update), jitted once,
    on batch 2.  Returns loss, metrics, gradients (a port state dict), the
    state after the update and the step's learning rate."""
    kind, jax_model, models = pair
    (jx, jt), _ = _batch(kind, 2)
    with jax_f64():
        model = _jax_model64(kind, jax_model)
        trainer = JaxTrainer(model, **OPTIMIZER)
        model.train()
        trainer._apply_frozen_bn()

        @nnx.jit
        def train_step(m, optimizer, xx, tt):
            (loss, metrics), grads = nnx.value_and_grad(lambda mm: jax_losses(mm, xx, tt), has_aux=True)(m)
            optimizer.update(m, grads)
            return loss, metrics, grads

        targets = [None] if kind == "anomaly" else [_f64(jt)]
        loss, metrics, grads = train_step(model, trainer.optimizer, _f64(jx), targets)
        grads = state_dict_from_flat(
            {".".join(map(str, p)): np.asarray(v[...], np.float64) for p, v in nnx.to_flat_state(grads)},
            models[torch.float32])
        return (float(loss), {k: float(v) for k, v in metrics.items()}, grads, flat_state(model),
                float(trainer.schedule(0)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_train_step_losses_gradients_and_stats_match_jax(pair, jax_step, dtype):
    kind, _, models = pair
    want_loss, want_metrics, want_grads, jax_state, _ = jax_step
    _, (x, t) = _batch(kind, 2)
    model = copy.deepcopy(models[dtype]).train()
    model.backbone._set_frozen_bn_eval() if kind == "anomaly" else None
    if kind == "anomaly" and dtype == torch.float64:
        probe = copy.deepcopy(model)
        with torch.no_grad():
            distance_st = probe.heads[0].compute_distances(probe.extract_features(x.double()))[0]
        assert topk_margin(distance_st, 16) > 1e-5
    loss, metrics = _losses(model, x.to(dtype), _targets(kind, t if kind == "autoencoding" else t.to(dtype)))
    loss.backward()

    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-4)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(want_metrics[k], rel=1e-4, abs=1e-6), k
    largest = {}
    for name, g in want_grads.items():
        largest[name.split(".")[0]] = max(largest.get(name.split(".")[0], 0.0), float(g.norm()))
    frozen = [n for n in want_grads if n.startswith("backbone.") and model.backbone.is_frozen_param(n.split(".")[2:])]
    assert frozen and all(n.startswith("backbone.features.stem.") or kind == "anomaly" for n in frozen)
    for name, p in model.named_parameters():
        if name in frozen:
            assert p.grad is None and not want_grads[name].any(), name
            continue
        part = name.split(".")[0]
        if float(want_grads[name].norm()) <= 1e-9 * largest[part]:
            assert float(p.grad.norm()) <= 1e-6 * largest[part], name
            continue
        limit = GRADIENT_LIMITS[part]
        if kind == "autoencoding" and part == "heads":
            limit = AUTOENCODER_HEAD_LIMIT
        err = _relative_error(p.grad, want_grads[name])
        assert err <= (F64_LIMIT if dtype == torch.float64 else limit), (name, err)

    want_state = state_dict_from_flat(jax_state, model)
    buffers = dict(model.named_buffers())
    for name, buf in buffers.items():
        np.testing.assert_allclose(buf.double().numpy(), want_state[name].numpy().astype(np.float64), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    if kind == "anomaly":
        assert int(buffers["heads.0.reservoir_pos"]) == int(buffers["heads.0.reservoir_filled"]) == 64


def test_trainer_step_metrics_and_update_match_jax(pair, jax_step):
    kind, _, models = pair
    want_loss, want_metrics, _, jax_state, want_lr = jax_step
    _, (x, t) = _batch(kind, 2)
    model = copy.deepcopy(models[torch.float32])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = Trainer(model, **OPTIMIZER).training_step(x, _targets(kind, t))
    want = {**want_metrics, "trainer/loss": want_loss, "trainer/learning_rate": want_lr}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert float(v) == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    assert_update_matches(model, before, jax_state, OPTIMIZER["optimizer_kwargs"]["lr"],
                          UPDATE_FLIPS.get(kind, HYBRID_UPDATE_FLIPS))


def test_validate_matches_jax(pair):
    """``Trainer.validate`` over two batches; the anomaly model's after
    ``Trainer.pretrain`` and two training steps, on a normal and an
    anomalous batch."""
    kind, jax_model, models = pair
    jax_trainer = JaxTrainer(nnx.clone(jax_model), **OPTIMIZER)
    trainer = Trainer(copy.deepcopy(models[torch.float32]), **OPTIMIZER)
    if kind == "anomaly":
        data = [_batch(kind, seed) for seed in (5, 6)]
        jax_trainer.pretrain([(b[0][0], None) for b in data])
        trainer.pretrain([(b[1][0], None) for b in data])
        jax_head, head = jax_trainer.model.heads[0], trainer.model.heads[0]
        for name in ("features_mean", "feature_std"):
            want = np.asarray(getattr(jax_head, name)[...]).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(getattr(head, name).numpy(), want, rtol=1e-5)
        assert float(head.feature_std.min()) > 0
        for b in data:
            jax_trainer.training_step(b[0][0], None)
            trainer.training_step(b[1][0], None)
        assert trainer.model.training and int(head.reservoir_filled) == 128
        batches = [_batch(kind, 7), _batch(kind, 8, anomalous=True)]
    else:
        batches = [_batch(kind, 3), _batch(kind, 4)]
    want = jax_trainer.validate([b[0] for b in batches])
    model = trainer.model
    buffers = {n: b.clone() for n, b in model.named_buffers() if not n.startswith("heads.0.q_")}
    got = trainer.validate([b[1] for b in batches])
    assert sorted(got) == sorted(want) and len(got) >= 3
    for k, v in got.items():
        assert v == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k
    assert all(torch.equal(b, buffers[n]) for n, b in model.named_buffers() if n in buffers)
    if kind == "anomaly":
        for name in ("q_st_start", "q_st_end", "q_ae_start", "q_ae_end"):
            assert float(getattr(head, name)) == pytest.approx(float(getattr(jax_head, name)[...]), rel=1e-4), name
