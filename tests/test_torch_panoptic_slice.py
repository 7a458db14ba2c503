"""The panoptic slice of the port against the JAX package's (CPU): the
tests of ``tests/test_torch_dense_slice.py`` on its panoptic model
(resnet18 with level 1 frozen → FPN 32 wide over levels 3-5 →
PanopticSegmentation with 3 stuff and 4 thing classes, 16 channels, two
layers, 8 instances, 5 targets, void 255, the smoothing decaying over 10
steps, its counter at 3; 4 images at 64 px), and the counter through a
checkpoint.
"""

import pytest
import torch

from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import DepthEstimation, PanopticSegmentation, SemanticSegmentation
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer, restore_checkpoint, save_checkpoint

from test_torch_dense_slice import (OPTIMIZER, _batch, _build, _jax_model, jax_step,  # noqa: F401
                                    test_forward_matches_jax, test_train_step_losses_gradients_and_stats_match_jax,
                                    test_trainer_step_metrics_match_jax, test_validate_matches_jax)
from torch_parity import flat_state

KIND = "panoptic"


@pytest.fixture(scope="module")
def pair():
    jax_model = _jax_model(KIND)
    models = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            models[dtype] = _build(KIND, Backbone, FPN, SemanticSegmentation, DepthEstimation, PanopticSegmentation,
                                   SihlModel)
        models[dtype].load_state_dict(state_dict_from_flat(flat_state(jax_model), models[dtype]), strict=True)
    return KIND, jax_model, models


def test_panoptic_counter_through_a_checkpoint(tmp_path):
    """A trainer's two steps move the counter from 3 to 5; the checkpoint
    carries it into a fresh trainer (whose counter was 0), and the next
    step's loss there equals the first trainer's."""
    jax_model = _jax_model(KIND)
    trainers = []
    for _ in range(2):
        model = _build(KIND, Backbone, FPN, SemanticSegmentation, DepthEstimation, PanopticSegmentation, SihlModel)
        model.load_state_dict(state_dict_from_flat(flat_state(jax_model), model), strict=True)
        trainers.append(Trainer(model, **OPTIMIZER))
    trainer, fresh = trainers
    fresh.model.heads[0].step_counter.zero_()
    _, (x, t) = _batch(KIND, 6)
    for _ in range(2):
        trainer.training_step(x, t)
    assert int(trainer.model.heads[0].step_counter) == 5
    save_checkpoint(trainer, str(tmp_path / "ckpt"))
    restore_checkpoint(fresh, str(tmp_path / "ckpt"))
    assert fresh.model.heads[0].step_counter.dtype == torch.int32
    assert int(fresh.model.heads[0].step_counter) == 5 and fresh.step == 2
    assert torch.equal(trainer.training_step(x, t)["trainer/loss"], fresh.training_step(x, t)["trainer/loss"])
