"""The port's training step against the JAX package's, on the same weights
and batch (CPU): resnet26 with level 1 frozen, FPN 32 wide over levels
3-7, ObjectDetection with 5 classes and targets padded to 10, 2 images at
256 px, bench.py's optimizer.

Compared: the loss and every head metric (relative 1e-4); every
parameter's gradient of the summed head losses, the JAX side through
``nnx.value_and_grad`` of ``_losses``, to the relative L2 limit of its part
(``GRADIENT_LIMITS``); the BatchNorm running statistics after the step,
the frozen stem's included (1e-4 relative and absolute); that the stem
gets no gradient; and the metrics of one ``Trainer.training_step`` on each
side.

The JAX step runs in f32 (the package casts its statistics and losses to
f32 whatever the input), the port's in f64 and in f32.  The weights are
chosen so that f32 keeps most of the gradients' digits: every bottleneck's
last BatchNorm starts small (``damp_residual_branches``), and the images
are 256 px, so that the level-7 map holds 2x2 values per image (at 128 px a
BatchNorm over its 2 values has a gradient of nearly 0, all rounding).  The
backbone's gradients still lose digits in f32, in train-mode BatchNorm's
backward: on these weights the JAX step and the port's f32 step are each
a few 1e-3 from the port's f64 step, hence their wider limit.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.heads import ObjectDetection as JaxObjectDetection
from sihl_tpu.layers import FPN as JaxFPN
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import ObjectDetection
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

from torch_parity import damp_residual_branches, flat_state, randomize_norms, to_torch

BATCH, SIZE, NUM_CLASSES, MAX_TARGETS = 2, 256, 5, 10
GRADIENT_LIMITS = {"heads": 1e-3, "neck": 1e-3, "backbone": 5e-3}
OPTIMIZER = dict(
    optimizer="adamw",
    optimizer_kwargs={"lr": 1e-4, "weight_decay": 1e-4, "backbone_lr_factor": 0.1},
    grad_clip=0.1,
)


def _build(backbone, fpn, head, model, **init):
    bb = backbone("resnet26", top_level=5, **init)
    bb.set_frozen_levels(1)
    neck = fpn(bb.out_channels, 32, bottom_level=3, top_level=7, **init)
    od = head(
        neck.out_channels, NUM_CLASSES, bottom_level=3, top_level=7, num_channels=32,
        max_targets=MAX_TARGETS, **init,
    )
    return model(bb, neck, [od])


def _batch(rng):
    """bench.py's recipe for images and padded targets, at 128 px."""
    x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    classes = np.full((BATCH, MAX_TARGETS), -1, np.int32)
    boxes = np.zeros((BATCH, MAX_TARGETS, 4), np.float32)
    for b in range(BATCH):
        n = rng.randint(1, 5)
        classes[b, :n] = rng.randint(0, NUM_CLASSES, n)
        xy = rng.rand(n, 2) * (SIZE - 24)
        wh = rng.rand(n, 2) * 32 + 4
        boxes[b, :n] = np.concatenate([xy, xy + wh], axis=1)
    return x, classes, boxes


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    jax_model = _build(JaxBackbone, JaxFPN, JaxObjectDetection, JaxSihlModel, rngs=nnx.Rngs(0))
    randomize_norms(jax_model, rng)
    damp_residual_branches(jax_model, rng)
    state = state_dict_from_flat(flat_state(jax_model))
    model = _build(Backbone, FPN, ObjectDetection, SihlModel)
    model.load_state_dict(state, strict=True)
    with compute_dtype_scope(torch.float64):
        model64 = _build(Backbone, FPN, ObjectDetection, SihlModel)
    model64.load_state_dict(state, strict=True)
    x, classes, boxes = _batch(rng)
    jax_targets = {"classes": jnp.asarray(classes), "boxes": jnp.asarray(boxes)}
    targets = {"classes": torch.from_numpy(classes).long(), "boxes": torch.from_numpy(boxes)}
    return jax_model, {torch.float32: model, torch.float64: model64}, (jnp.asarray(x), jax_targets), (to_torch(x), targets)


def _step(model, x, t):
    """Loss, metrics and every parameter's gradient of one training forward
    and backward of a copy of ``model``, and the copy."""
    model = copy.deepcopy(model).train()
    loss, metrics = _losses(model, x, [t])
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads, model


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_train_step_losses_gradients_and_stats_match_jax(pair, dtype):
    jax_model, models, (jx, jt), (x, t) = pair
    jax_model = nnx.clone(jax_model)

    @nnx.jit
    def value_and_grad(m, xx, tt):
        return nnx.value_and_grad(lambda mm: jax_losses(mm, xx, [tt]), has_aux=True)(m)

    jax_model.train()
    (want_loss, want_metrics), jax_grads = value_and_grad(jax_model, jx, jt)
    loss, metrics, grads, model = _step(models[dtype], x, t)

    assert loss == pytest.approx(float(want_loss), rel=1e-4)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in metrics.items():
        assert v == pytest.approx(float(want_metrics[k]), rel=1e-4, abs=1e-6), k
    assert float(want_metrics["head0/train/box_loss"]) > 0  # the targets matched

    flat_grads = {
        ".".join(map(str, path)): np.asarray(v[...]) for path, v in nnx.to_flat_state(jax_grads)
    }
    want_grads = state_dict_from_flat(flat_grads)
    for name, g in grads.items():
        if name.startswith("backbone.features.stem."):
            assert g is None, name
            assert not want_grads[name].any(), name
            continue
        err = _relative_error(g, want_grads[name])
        assert err <= GRADIENT_LIMITS[name.split(".")[0]], (name, err)

    want_state = state_dict_from_flat(flat_state(jax_model))
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(
            buf.double().numpy(), want_state[name].numpy(), rtol=1e-4, atol=1e-4, err_msg=name
        )


def _relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - want.double())) / max(
        float(torch.linalg.vector_norm(want.double())), 1e-12
    )


def test_trainer_step_metrics_match_jax(pair):
    jax_model, models, (jx, jt), (x, t) = pair
    want = JaxTrainer(nnx.clone(jax_model), **OPTIMIZER).training_step(jx, jt)
    got = Trainer(copy.deepcopy(models[torch.float32]), **OPTIMIZER).training_step(x, t)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert float(v) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k
