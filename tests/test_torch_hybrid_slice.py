"""The HybridEncoder slice of the port against the JAX package's (CPU): the
canonical detector that ``chip_smoke.py`` runs at full size, at 64 px;
this file holds it, ``tests/test_torch_multitask_slice.py`` runs the same
tests on the four-head multitask model.

* the detector: resnet18 with level 1 frozen (its stem through
  ``stem_conv_stats``'s plain version) → HybridEncoder 32 wide over levels
  3-5 → ObjectDetection (5 classes, 16 channels, one hidden layer, 8
  instances, 5 targets), with the examples' multistep schedule;
* the multitask model: the same trunk → FPN 32 wide over levels 3-5 →
  ObjectDetection (as above), TextRecognition (5 tokens, sequences of 6,
  level 3, 16 channels, 4 heads, a 32-wide feed-forward, dropout 0: the two
  packages' random streams cannot agree), DepthEstimation (0.1-10, 16
  channels, 16 bins) and MetricLearning (6 identities, level 2, 8-wide
  embeddings).

4 images at 64 px, each with its own brightness and contrast (the text
head's and SPPM's train-mode BatchNorms over pooled 1 x 1 maps, as in
``tests/test_torch_dense_slice.py``), weights carried by
``state_dict_from_flat`` (strict), every basic block's last BatchNorm
damped to U(0.01, 0.03) as in ``tests/test_torch_classification_slice.py``;
boxes with centres on half pixels (``box_targets``).

Compared: the forward in eval mode against JAX's f32 forward (integer
outputs exact, floats within 1e-5 relative); one training step through
``_losses`` with the port in f64 and in f32 against JAX's jitted f64 step
(``jax_f64``; losses and metrics within 1e-4 relative, every gradient of
the port's f64 step within ``F64_LIMIT`` and of its f32 step within the
relative L2 limit of its part as ``tests/test_torch_train_slice.py`` holds
them, a gradient that is zero in exact arithmetic below 1e-6 of its part's
largest, the running statistics within 1e-4, no gradient for the frozen
stem; on a batch whose box-loss decisions lie away from their kinks,
``STEP_SEEDS``); and the port's f32 ``Trainer.training_step`` on that
batch against the same JAX step (the JAX ``Trainer``'s ``_train_step``,
its optimizer update included): every metric within 1e-4, and the
parameters after the update (``assert_update_matches``).  JAX's f32 step
is no reference for gradients here (``jax_step``).
"""

import contextlib
import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.heads import DepthEstimation as JaxDepthEstimation
from sihl_tpu.heads import MetricLearning as JaxMetricLearning
from sihl_tpu.heads import ObjectDetection as JaxObjectDetection
from sihl_tpu.heads import TextRecognition as JaxTextRecognition
from sihl_tpu.layers import FPN as JaxFPN
from sihl_tpu.layers import HybridEncoder as JaxHybridEncoder
from sihl_tpu.layers import convblocks as jax_convblocks
from sihl_tpu.policy import compute_dtype_scope as jax_compute_dtype_scope
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import DepthEstimation, MetricLearning, ObjectDetection, TextRecognition, object_detection
from sihl_tpu_torch.layers import FPN, HybridEncoder
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

from test_torch_classification_slice import _damp_basic_blocks, _relative_error
from test_torch_validation import T, box_targets
from torch_parity import flat_state, randomize_norms, to_torch

KIND = "hybrid"
# the batch of the gradient comparison: a CIoU decision of the detector's box
# loss (a max or min of a predicted and a target edge, a clip of their
# overlap at 0) within f32 rounding of its kink flips in one f32 step and not
# in the other, and moves the box head's gradients by up to 92% (the
# multitask model's batch 2: an edge 5.5e-7 from its target's, where JAX's
# f32 step took the other side of the max); ``_ciou_kink_margin`` holds the
# batch away from every kink
STEP_SEEDS = {"hybrid": 2, "multitask": 3}
BATCH, SIZE, NUM_CLASSES, TOKENS, LENGTH, IDENTITIES = 4, 64, 5, 5, 6, 6
GRADIENT_LIMITS = {"heads": 1e-3, "neck": 1e-3, "backbone": 5e-3}
# the port's f64 step against JAX's: JAX's losses cast their inputs to f32
# in its f64 run too (sihl_tpu/ops/losses.py), so the heads' gradients agree
# to f32's digits (1.06e-6 on the multitask detector's class MLP)
F64_LIMIT = 1e-5
OPTIMIZER = dict(
    optimizer="adamw",
    optimizer_kwargs={"lr": 1e-4, "weight_decay": 1e-4, "backbone_lr_factor": 0.1},
    grad_clip=0.1,
)
# the share of a part's weights whose first AdamW step (the port's f32 step)
# may land away from JAX's f64 step: 0.24% and 0.26% of the backbone's, 0.06%
# and 0.13% of the neck's, 0.09% and 0 of the heads' on the multitask model
# and the detector (against JAX's f32 step the detector's backbone read
# 1.45%, as tests/test_torch_fit.py finds it)
UPDATE_FLIPS = {"heads": 0.01, "neck": 0.01, "backbone": 0.01}
# examples/object_detection.py's schedule
SCHEDULE = dict(scheduler="multistep", scheduler_kwargs={"milestones": [60_000, 80_000], "gamma": 0.1})


def _build(kind, backbone, fpn, hybrid, detection, text, depth, metric, model, **init):
    bb = backbone("resnet18", top_level=5, **init)
    bb.set_frozen_levels(1)
    neck = (hybrid if kind == "hybrid" else fpn)(bb.out_channels, 32, bottom_level=3, top_level=5, **init)
    c = neck.out_channels
    heads = [detection(c, NUM_CLASSES, num_channels=16, num_layers=1, max_instances=8, max_targets=T, **init)]
    if kind == "multitask":
        heads += [text(c, TOKENS, LENGTH, level=3, num_channels=16, num_heads=4, embedding_dim=32, dropout=0.0, **init),
                  depth(c, 0.1, 10.0, num_channels=16, num_bins=16, **init),
                  metric(c, IDENTITIES, embedding_dim=8, level=2, **init)]
    return model(bb, neck, heads)


JAX_MODULES = (JaxBackbone, JaxFPN, JaxHybridEncoder, JaxObjectDetection, JaxTextRecognition, JaxDepthEstimation,
               JaxMetricLearning, JaxSihlModel)
PORT_MODULES = (Backbone, FPN, HybridEncoder, ObjectDetection, TextRecognition, DepthEstimation, MetricLearning,
                SihlModel)


def _batch(kind: str, seed: int):
    """(JAX batch, port batch): images and the heads' targets, a list of one
    target a head for the multitask model."""
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, SIZE, SIZE, 3) * rng.uniform(0.25, 1.0, (BATCH, 1, 1, 1))
    x = (x + rng.uniform(0.0, 0.75, (BATCH, 1, 1, 1))).astype(np.float32)
    classes, boxes = box_targets(rng, SIZE, NUM_CLASSES, (2, 3, 1, 4))
    jax_det = {"classes": jnp.asarray(classes), "boxes": jnp.asarray(boxes)}
    det = {"classes": torch.from_numpy(classes).long(), "boxes": torch.from_numpy(boxes)}
    if kind == "hybrid":
        return (jnp.asarray(x), jax_det), (to_torch(x), det)
    texts = np.full((BATCH, LENGTH), TOKENS, np.int32)
    for b in range(BATCH):
        n = rng.randint(1, LENGTH + 1)
        texts[b, :n] = rng.randint(0, TOKENS, n)
    depth = (x.mean(-1) * 9.9 / 1.75 + 0.1).astype(np.float32)
    masks = rng.rand(BATCH, SIZE, SIZE) > 0.1
    depth[~masks] = 0.0
    ids = rng.randint(0, IDENTITIES, BATCH).astype(np.int32)
    jax_targets = [jax_det, jnp.asarray(texts), {"targets": jnp.asarray(depth), "masks": jnp.asarray(masks)},
                   jnp.asarray(ids)]
    targets = [det, torch.from_numpy(texts), {"targets": torch.from_numpy(depth), "masks": torch.from_numpy(masks)},
               torch.from_numpy(ids)]
    return (jnp.asarray(x), jax_targets), (to_torch(x), targets)


def _jax_model(kind):
    model = nnx.jit(lambda: _build(kind, *JAX_MODULES, rngs=nnx.Rngs(0)))()
    rng = np.random.RandomState(0)
    randomize_norms(model, rng)
    _damp_basic_blocks(model, rng)
    return model


def _pair(kind):
    jax_model = _jax_model(kind)
    models = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            models[dtype] = _build(kind, *PORT_MODULES)
        models[dtype].load_state_dict(state_dict_from_flat(flat_state(jax_model), models[dtype]), strict=True)
    return kind, jax_model, models


@pytest.fixture(scope="module")
def pair():
    return _pair(KIND)


def _ciou_kink_margin(model, x, t) -> float:
    """The least distance, in the port's f64 forward, of a CIoU decision of
    the detector's box loss from its kink: between a predicted and a target
    box edge, and of their overlaps from 0 (normalised coordinates)."""
    seen = []
    ciou = object_detection.complete_box_iou_loss

    def spy(b1, b2):
        seen.append((b1.detach().double(), b2.detach().double()))
        return ciou(b1, b2)

    with mock.patch.object(object_detection, "complete_box_iou_loss", spy), torch.no_grad():
        model.heads[0].training_step(model.extract_features(x.double()), **t)
    b1, b2 = seen[0]
    overlaps = [torch.minimum(b1[..., i + 2], b2[..., i + 2]) - torch.maximum(b1[..., i], b2[..., i]) for i in (0, 1)]
    return float(torch.cat([(b1 - b2).abs().flatten()] + [o.abs().flatten() for o in overlaps]).min())


def _flatten(outputs):
    return [t for out in outputs for t in (out if isinstance(out, tuple) else (out,))]


def test_forward_matches_jax(pair):
    kind, jax_model, models = pair
    (jx, _), (x, _) = _batch(kind, 1)
    jax_model = nnx.clone(jax_model)
    jax_model.eval()
    want = _flatten(nnx.jit(lambda m, xx: m(xx))(jax_model, jx))
    with torch.no_grad():
        got = _flatten(copy.deepcopy(models[torch.float32]).eval()(x))
    assert len(got) == len(want) == (4 if kind == "hybrid" else 8)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


@contextlib.contextmanager
def jax_f64():
    """JAX computing in f64, its BatchNorms the stock ``nnx.BatchNorm`` (the
    package's ``SIHL_TPU_FUSED_BN=0`` path: the fused BatchNorm keeps its
    statistics in f32), as ``tests/test_torch_fit.py`` runs it."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True), jax_compute_dtype_scope(jnp.float64):
        mp.setattr(jax_convblocks, "_FUSED_BN", False)
        yield


def _jax_model64(kind, jax_model):
    """An f64 copy of ``jax_model`` (inside ``jax_f64``)."""
    model = nnx.jit(lambda: _build(kind, *JAX_MODULES, rngs=nnx.Rngs(0)))()
    nnx.update(model, jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.float64) if v.dtype == jnp.float32 else v, nnx.state(jax_model, nnx.Not(nnx.RngState))))
    return model


def _f64(tree):
    return jax.tree_util.tree_map(lambda v: v.astype(jnp.float64) if v.dtype == jnp.float32 else v, tree)


@pytest.fixture(scope="module")
def jax_step(pair):
    """JAX's f64 training step on the ``STEP_SEEDS`` batch, jitted once: the
    JAX ``Trainer``'s ``_train_step`` (the losses' value and gradients, then
    the trainer's optimizer update), returning the gradients too.  Returns
    loss, metrics, gradients (a port state dict), the state after the update
    and the step's learning rate.  An f32 step is no reference here: the
    ReLUs on raw outputs (the depth head's, the text decoder's feed-forward)
    and the box loss's CIoU decisions flip on f32 rounding, and JAX's f32
    step reads up to 6.8% from f64 on the multitask neck where the port's
    f32 step reads 8e-5."""
    kind, jax_model, models = pair
    (jx, jt), _ = _batch(kind, STEP_SEEDS[kind])
    with jax_f64():
        model = _jax_model64(kind, jax_model)
        trainer = JaxTrainer(model, **OPTIMIZER, **(SCHEDULE if kind == "hybrid" else {}))
        model.train()

        @nnx.jit
        def train_step(m, optimizer, xx, tt):
            (loss, metrics), grads = nnx.value_and_grad(lambda mm: jax_losses(mm, xx, tt), has_aux=True)(m)
            optimizer.update(m, grads)
            return loss, metrics, grads

        loss, metrics, grads = train_step(model, trainer.optimizer, _f64(jx), jt if kind == "multitask" else [jt])
        grads = state_dict_from_flat(
            {".".join(map(str, p)): np.asarray(v[...], np.float64) for p, v in nnx.to_flat_state(grads)},
            models[torch.float32])
        return (float(loss), {k: float(v) for k, v in metrics.items()}, grads, flat_state(model),
                float(trainer.schedule(0)))


def _zero_in_exact_arithmetic(name: str, want_grads, largest) -> bool:
    """A gradient below 1e-9 of its part's largest on JAX's side: an
    attention key projection's bias (the softmax removes a shift common to
    a query's logits), or a map's bias that feeds only convs into
    train-mode BatchNorms (their mean removal cancels it)."""
    return float(want_grads[name].norm()) <= 1e-9 * largest[name.split(".")[0]]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_train_step_losses_gradients_and_stats_match_jax(pair, jax_step, dtype):
    kind, _, models = pair
    want_loss, want_metrics, want_grads, jax_state, _ = jax_step
    _, (x, t) = _batch(kind, STEP_SEEDS[kind])
    model = copy.deepcopy(models[dtype]).train()
    if dtype == torch.float64:
        assert _ciou_kink_margin(copy.deepcopy(model), x, t[0] if kind == "multitask" else t) > 1e-5
    loss, metrics = _losses(model, x.to(dtype), t if kind == "multitask" else [t])
    loss.backward()

    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-4)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(want_metrics[k], rel=1e-4, abs=1e-6), k
    largest = {}
    for name, g in want_grads.items():
        largest[name.split(".")[0]] = max(largest.get(name.split(".")[0], 0.0), float(g.norm()))
    for name, p in model.named_parameters():
        if name.startswith("backbone.features.stem."):
            assert p.grad is None and not want_grads[name].any(), name
            continue
        if _zero_in_exact_arithmetic(name, want_grads, largest):
            assert float(p.grad.norm()) <= 1e-6 * largest[name.split(".")[0]], name
            continue
        err = _relative_error(p.grad, want_grads[name])
        assert err <= (F64_LIMIT if dtype == torch.float64 else GRADIENT_LIMITS[name.split(".")[0]]), (name, err)

    want_state = state_dict_from_flat(jax_state, model)
    for name, buf in model.state_dict().items():
        if name in dict(model.named_buffers()):
            np.testing.assert_allclose(buf.double().numpy(), want_state[name].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)


def assert_update_matches(model, before, jax_state, lr: float, flips=None) -> None:
    """The parameters after one AdamW step against JAX's (``jax_state``, its
    flat state after the step).  AdamW's first step moves each weight by
    about its learning rate times the sign of its gradient, so a weight
    whose gradient lies within f32 rounding of zero may step either way;
    every other weight must land within 1e-3 of its learning rate of JAX's.
    Held: at most ``flips`` (by default ``UPDATE_FLIPS``) of a part's
    weights away from JAX's by more than that, and none by more than twice the learning rate (and the
    weight decay's share)."""
    want = state_dict_from_flat(jax_state, model)
    moved = {}
    for name, p in model.named_parameters():
        if name.startswith("backbone.features.stem."):
            assert torch.equal(p.detach(), before[name]), name
            continue
        scale = lr * (0.1 if name.startswith("backbone.") else 1.0)
        diff = (p.detach() - want[name]).abs()
        assert float(diff.max()) <= 2.01 * scale + 1e-6 * float(before[name].abs().max()), name
        part = name.split(".")[0]
        far, count = moved.get(part, (0, 0))
        moved[part] = (far + int((diff > 1e-3 * scale).sum()), count + diff.numel())
    flips = UPDATE_FLIPS if flips is None else flips
    for part, (far, count) in moved.items():
        assert far <= flips[part] * count, (part, far, count)


def test_trainer_step_metrics_and_update_match_jax(pair, jax_step):
    """The port's f32 ``Trainer.training_step`` on the ``STEP_SEEDS`` batch
    against ``jax_step``: every metric within 1e-4, the update."""
    kind, _, models = pair
    want_loss, want_metrics, _, jax_state, want_lr = jax_step
    _, (x, t) = _batch(kind, STEP_SEEDS[kind])
    model = copy.deepcopy(models[torch.float32])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = Trainer(model, **OPTIMIZER, **(SCHEDULE if kind == "hybrid" else {})).training_step(x, t)
    want = {**want_metrics, "trainer/loss": want_loss, "trainer/learning_rate": want_lr}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert float(v) == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    assert_update_matches(model, before, jax_state, OPTIMIZER["optimizer_kwargs"]["lr"])
