"""The port's multi-step dispatch against the JAX package's (CPU).

``Trainer.training_steps_scanned`` and ``Trainer.fit(steps_per_dispatch=2)``
on ``tests/test_torch_fit.py``'s detector (resnet18 with level 1 frozen,
FPN 16 wide over levels 3-5, ObjectDetection with 4 classes; 2 images at
64 px), the JAX side in f64 under ``jax.enable_x64`` with stock BatchNorm,
the port in f64 and in f32, for two optimizers: SGD with momentum, and
bench.py's AdamW with an EMA at decay 0.9, both with bench.py's clip.  From the same
weights each side runs one dispatch of 2 steps, then a fit of 4 steps in
dispatches of 2 with ``log_every=3``, ``val_every=4`` (AdamW only) and
``checkpoint_every=3``:

* every step's metrics of the dispatch under the same keys (no
  ``trainer/learning_rate``, as JAX's), losses within ``LOSS_RTOL`` (1e-5)
  relative;
* the logger called at the same steps as JAX's (4, 6; a validation at 4),
  each call's metrics within ``LOSS_RTOL``, the learning rate within 1e-6
  (both log the rate at the step count a dispatch ends on), mAP within
  1e-9;
* checkpoints saved at the same steps (4, 6 and the final save at 6).

The port's own checks of the dispatch (torch only) are in
``tests/test_torch_dispatch.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.heads import ObjectDetection as JaxObjectDetection
from sihl_tpu.layers import FPN as JaxFPN
from sihl_tpu.layers import convblocks as jax_convblocks
from sihl_tpu.policy import compute_dtype_scope as jax_compute_dtype_scope
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.training import Trainer
from test_torch_fit import (OPTIMIZER, Logger, _assert_metrics_match, _batches, _build, _jax_data, _port_model,
                            _torch_data)

from torch_parity import flat_state, randomize_norms

LOSS_RTOL = 1e-5
CASES = {
    "sgd": dict(optimizer="sgd", optimizer_kwargs={"lr": 1e-2, "momentum": 0.9, "backbone_lr_factor": 0.1},
                grad_clip=0.1),
    "adamw_ema": {k: v for k, v in OPTIMIZER.items() if k != "hyperparameters"},
}
FIT = dict(num_steps=4, steps_per_dispatch=2, log_every=3, checkpoint_every=3, checkpoint_dir="unused")


def _abstract_model():
    return nnx.eval_shape(lambda: _build(JaxBackbone, JaxFPN, JaxObjectDetection, JaxSihlModel, rngs=nnx.Rngs(0)))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    jax_model = nnx.jit(lambda: _build(JaxBackbone, JaxFPN, JaxObjectDetection, JaxSihlModel, rngs=nnx.Rngs(0)))()
    randomize_norms(jax_model, rng)
    return jax_model, state_dict_from_flat(flat_state(jax_model)), _batches(rng, 6), _batches(rng, 1)


def _saves(monkeypatch, trainer_class) -> list:
    """Record the steps at which ``trainer_class`` saves a checkpoint."""
    steps = []
    monkeypatch.setattr(trainer_class, "_save_checkpoint", lambda self, directory: steps.append(self.step))
    return steps


def _stack(data, stack):
    """(xs, targets) of one dispatch from a list of (x, targets)."""
    return stack([x for x, _ in data]), {k: stack([t[k] for _, t in data]) for k in data[0][1]}


def _fit_kwargs(case, val):
    return dict(FIT, val_data=val, val_every=4) if case == "adamw_ema" else FIT


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Per case: JAX's dispatch of 2 steps, then its fit, in f64, each case
    from the same weights in one f64 model."""
    jax_model, _, train, val = setup
    runs = {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_convblocks, "_FUSED_BN", False)
        saves = _saves(mp, JaxTrainer)
        with jax_compute_dtype_scope(jnp.float64):  # the f64 model's structure, filled with the setup's weights
            graphdef, _ = nnx.split(_abstract_model())
        initial = jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64) if v.dtype == jnp.float32 else v, nnx.state(jax_model))
        model = nnx.merge(graphdef, initial)
        data, val = _jax_data(train, jnp.float64), _jax_data(val, jnp.float64)
        for case, kwargs in CASES.items():
            nnx.update(model, initial)
            logger = Logger()
            trainer = JaxTrainer(model, logger=logger, **kwargs)
            scanned = trainer.training_steps_scanned(*_stack(data[:2], jnp.stack))
            scanned = {k: np.asarray(v) for k, v in scanned.items()}
            saves.clear()
            trainer.fit(data[2:], **_fit_kwargs(case, val))
            runs[case] = scanned, logger, list(saves)
    return runs


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scanned_dispatch_and_fit_match_jax(setup, jax_runs, monkeypatch, case, dtype):
    _, state, train, val = setup
    want_scanned, want_log, want_saves = jax_runs[case]
    saves = _saves(monkeypatch, Trainer)
    logger = Logger()
    trainer = Trainer(_port_model(state, dtype), logger=logger, **CASES[case])
    data = _torch_data(train)
    scanned = trainer.training_steps_scanned(*_stack(data[:2], torch.stack))
    assert trainer.step == 2 and not logger.calls
    assert sorted(scanned) == sorted(want_scanned)
    for k, v in scanned.items():
        assert v.shape == (2,)
        np.testing.assert_allclose(v.double().numpy(), want_scanned[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    trainer.fit(data[2:], **_fit_kwargs(case, _torch_data(val)))
    assert trainer.step == 6
    assert [s for s, _ in logger.calls] == [s for s, _ in want_log.calls]
    assert [s for s, m in logger.calls if "trainer/loss" in m] == [4, 6]
    for (_, got), (_, want) in zip(logger.calls, want_log.calls):
        _assert_metrics_match(got, want)
    assert saves == want_saves == [4, 6, 6]
