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

And one dispatch of K = 3 steps of the quadrilateral detector (resnet18 with
level 1 frozen → BiFPN 16 wide over levels 3-5 with 2 layers →
QuadrilateralDetection with 5 classes; 2 images at 64 px), the JAX model
from ``nnx.eval_shape`` filled by ``torch_parity.numpy_filled``, JAX in f64
against the port: under SGD with momentum in f64 and in f32, under AdamW
(with EMA) in f64, every step's metrics within ``LOSS_RTOL``.  It runs the
BiFPN's blur-pool downscalers and the quad head's training step, which
build their constant vectors on the device.  AdamW has no f32 case: there
the port's f32 run moves the third step's location loss 1.08e-5 relative
from JAX's f64 one, just outside ``LOSS_RTOL``.  Adam scales every gradient
to about the learning rate, the f32 rounding of the gradients that are zero
in exact arithmetic too (``tests/test_torch_quad_slice.py`` names the
BiFPN's last BatchNorm biases); the f64 case holds the same dispatch.

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
from sihl_tpu.heads import QuadrilateralDetection as JaxQuadrilateralDetection
from sihl_tpu.layers import FPN as JaxFPN
from sihl_tpu.layers import BiFPN as JaxBiFPN
from sihl_tpu.layers import convblocks as jax_convblocks
from sihl_tpu.policy import compute_dtype_scope as jax_compute_dtype_scope
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import QuadrilateralDetection
from sihl_tpu_torch.layers import BiFPN
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer
from test_torch_fit import (OPTIMIZER, Logger, _assert_metrics_match, _batches, _build, _jax_data, _port_model,
                            _torch_data)
from test_torch_quadrilateral_detection import BATCH as QUAD_BATCH
from test_torch_quadrilateral_detection import quad_targets
from test_torch_quad_slice import _build_model as _build_quad

from torch_parity import flat_state, numpy_filled, randomize_norms, to_torch

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



# (optimizer case, port dtype) of the quad dispatch
QUAD_CASES = [("sgd", torch.float64), ("sgd", torch.float32), ("adamw_ema", torch.float64)]


@pytest.fixture(scope="module")
def quad_run():
    """(the data, the port's state, JAX's dispatch of 3 steps in f64 under
    each optimizer case of ``QUAD_CASES``)."""
    rng = np.random.RandomState(2)
    xs = rng.rand(3, QUAD_BATCH, 64, 64, 3).astype(np.float32)
    targets = [quad_targets(rng, 64, 5, (2, 4)) for _ in range(3)]
    classes, quads = (np.stack(parts) for parts in zip(*targets))

    def abstract():
        return nnx.eval_shape(lambda: _build_quad(JaxBackbone, JaxBiFPN, JaxQuadrilateralDetection, JaxSihlModel,
                                                  rngs=nnx.Rngs(0)))

    jax_model = numpy_filled(abstract(), seed=3)
    want = {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_convblocks, "_FUSED_BN", False)
        with jax_compute_dtype_scope(jnp.float64):
            graphdef, _ = nnx.split(abstract())
        for case in sorted({case for case, _ in QUAD_CASES}):
            model = nnx.merge(graphdef, jax.tree_util.tree_map(
                lambda v: jnp.asarray(v, jnp.float64) if v.dtype == jnp.float32 else v, nnx.state(jax_model)))
            got = JaxTrainer(model, **CASES[case]).training_steps_scanned(
                jnp.asarray(xs, jnp.float64), {"classes": jnp.asarray(classes), "quads": jnp.asarray(quads)})
            want[case] = {k: np.asarray(v) for k, v in got.items()}
    return (xs, classes, quads), state_dict_from_flat(flat_state(jax_model)), want


@pytest.mark.parametrize("case,dtype", QUAD_CASES, ids=["sgd-f64", "sgd-f32", "adamw_ema-f64"])
def test_quad_scanned_dispatch_matches_jax(quad_run, case, dtype):
    (xs, classes, quads), state, want = quad_run
    want = want[case]
    with compute_dtype_scope(dtype):
        port = _build_quad(Backbone, BiFPN, QuadrilateralDetection, SihlModel)
    port.load_state_dict(state, strict=True)
    trainer = Trainer(port, **CASES[case])
    got = trainer.training_steps_scanned(
        torch.stack([to_torch(x) for x in xs]),
        {"classes": torch.from_numpy(classes).long(), "quads": torch.from_numpy(quads)})
    assert trainer.step == 3 and sorted(got) == sorted(want)
    assert float(want["head0/train/quad_loss"][0]) > 0
    for k, v in got.items():
        assert v.shape == (3,)
        np.testing.assert_allclose(v.double().numpy(), want[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
