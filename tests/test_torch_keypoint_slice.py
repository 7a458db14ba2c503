"""The keypoint slice of the port against the JAX package's (CPU): the model
that ``chip_smoke.py`` runs at full size (``examples/keypoint_detection.py``),
at 64 px: resnet18 with level 1 frozen (its stem through
``stem_conv_stats``'s plain version) → FPN 32 wide over levels 3-5 →
KeypointDetection (5 keypoints, 16 channels, one hidden layer, anchors at
levels 4-5, heatmaps at level 3, 8 instances, 5 targets, 16 positives),
weights carried by ``state_dict_from_flat`` (strict), every basic block's
last BatchNorm damped to U(0.01, 0.03) as in
``tests/test_torch_classification_slice.py``; 4 images, each with its own
brightness and contrast, and integer keypoints whose targets' box centres
sit on half pixels (``tests/test_torch_keypoint.keypoint_targets``).

Compared against one jitted JAX step in f64 (``jax_f64``: the JAX
``Trainer``'s losses, their gradients and its AdamW update):

* one training step through ``_losses`` with the port in f64 and in f32:
  losses and metrics within 1e-4 relative, every gradient of the port's f64
  step within relative L2 ``F64_LIMIT`` and of its f32 step within its
  part's limit (``GRADIENT_LIMITS``), the running statistics within 1e-4,
  no gradient for the frozen stem;
* the port's f32 ``Trainer.training_step``: every metric within 1e-4, and
  the parameters after the update (``assert_update_matches``).
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
from sihl_tpu.heads import KeypointDetection as JaxKeypointDetection
from sihl_tpu.layers import FPN as JaxFPN
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import KeypointDetection
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

from test_torch_classification_slice import _damp_basic_blocks, _relative_error
from test_torch_hybrid_slice import GRADIENT_LIMITS, OPTIMIZER, _f64, assert_update_matches, jax_f64
from test_torch_keypoint import keypoint_targets
from torch_parity import flat_state, randomize_norms, to_torch

BATCH, SIZE, K, T = 4, 64, 5, 5
# the port's f64 step against JAX's: JAX's decode runs its einsum chain in
# f32 inside its f64 step (sihl_tpu/ops/pallas/dynconv.py:67), so the two
# agree to about f32's digits there
F64_LIMIT = 1e-4


def _build(backbone, fpn, head, model, **init):
    bb = backbone("resnet18", top_level=5, **init)
    bb.set_frozen_levels(1)
    neck = fpn(bb.out_channels, 32, bottom_level=3, top_level=5, **init)
    kp = head(neck.out_channels, K, num_channels=16, num_layers=1, max_instances=8, max_targets=T,
              max_mask_positives=16, bottom_level=4, top_level=5, **init)
    return model(bb, neck, [kp])


def _batch(seed: int):
    """(JAX batch, port batch): images with their own brightness and
    contrast, and padded keypoint targets."""
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, SIZE, SIZE, 3) * rng.uniform(0.25, 1.0, (BATCH, 1, 1, 1))
    x = (x + rng.uniform(0.0, 0.75, (BATCH, 1, 1, 1))).astype(np.float32)
    keypoints, presence = keypoint_targets(rng, SIZE, (2, 3, 1, 2))
    jax_targets = {"keypoints": jnp.asarray(keypoints), "presence": jnp.asarray(presence)}
    targets = {"keypoints": torch.from_numpy(keypoints), "presence": torch.from_numpy(presence)}
    return (jnp.asarray(x), jax_targets), (to_torch(x), targets)


@pytest.fixture(scope="module")
def pair():
    jax_model = nnx.jit(lambda: _build(JaxBackbone, JaxFPN, JaxKeypointDetection, JaxSihlModel, rngs=nnx.Rngs(0)))()
    rng = np.random.RandomState(0)
    randomize_norms(jax_model, rng)
    _damp_basic_blocks(jax_model, rng)
    models = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            models[dtype] = _build(Backbone, FPN, KeypointDetection, SihlModel)
        models[dtype].load_state_dict(state_dict_from_flat(flat_state(jax_model), models[dtype]), strict=True)
    return jax_model, models


@pytest.fixture(scope="module")
def jax_step(pair):
    """JAX's jitted f64 step on batch 1: the losses' value and gradients,
    then the JAX ``Trainer``'s AdamW update.  Returns loss, metrics,
    gradients (a port state dict), the flat state after the update and the
    step's learning rate."""
    jax_model, models = pair
    (jx, jt), _ = _batch(1)
    with jax_f64():
        model = nnx.jit(lambda: _build(JaxBackbone, JaxFPN, JaxKeypointDetection, JaxSihlModel,
                                       rngs=nnx.Rngs(0)))()
        nnx.update(model, _f64(nnx.state(jax_model, nnx.Not(nnx.RngState))))
        trainer = JaxTrainer(model, **OPTIMIZER)
        model.train()

        @nnx.jit
        def train_step(m, optimizer, xx, tt):
            (loss, metrics), grads = nnx.value_and_grad(lambda mm: jax_losses(mm, xx, tt), has_aux=True)(m)
            optimizer.update(m, grads)
            return loss, metrics, grads

        loss, metrics, grads = train_step(model, trainer.optimizer, _f64(jx), [jt])
        grads = state_dict_from_flat(
            {".".join(map(str, p)): np.asarray(v[...], np.float64) for p, v in nnx.to_flat_state(grads)},
            models[torch.float32])
        return (float(loss), {k: float(v) for k, v in metrics.items()}, grads, flat_state(model),
                float(trainer.schedule(0)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_train_step_losses_gradients_and_stats_match_jax(pair, jax_step, dtype):
    _, models = pair
    want_loss, want_metrics, want_grads, jax_state, _ = jax_step
    _, (x, t) = _batch(1)
    model = copy.deepcopy(models[dtype]).train()
    loss, metrics = _losses(model, x.to(dtype), [t])
    loss.backward()

    assert want_metrics["head0/train/keypoint_loss"] > 0 and want_metrics["head0/train/presence_loss"] > 0
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-4)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(want_metrics[k], rel=1e-4, abs=1e-6), k
    for name, p in model.named_parameters():
        if name.startswith("backbone.features.stem."):
            assert p.grad is None and not want_grads[name].any(), name
            continue
        err = _relative_error(p.grad, want_grads[name])
        assert err <= (F64_LIMIT if dtype == torch.float64 else GRADIENT_LIMITS[name.split(".")[0]]), (name, err)

    want_state = state_dict_from_flat(jax_state, model)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.double().numpy(), want_state[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_trainer_step_metrics_and_update_match_jax(pair, jax_step):
    """The port's f32 ``Trainer.training_step`` on batch 1 against
    ``jax_step``: every metric within 1e-4, the update."""
    _, models = pair
    want_loss, want_metrics, _, jax_state, want_lr = jax_step
    _, (x, t) = _batch(1)
    model = copy.deepcopy(models[torch.float32])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = Trainer(model, **OPTIMIZER).training_step(x, t)
    want = {**want_metrics, "trainer/loss": want_loss, "trainer/learning_rate": want_lr}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert float(v) == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    assert_update_matches(model, before, jax_state, OPTIMIZER["optimizer_kwargs"]["lr"])
