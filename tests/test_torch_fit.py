"""The port's ``Trainer`` loop, validation, EMA and checkpoints against the
JAX package's (CPU).

One small detector on both sides (resnet18 with level 1 frozen, FPN 16
wide over levels 3-5, ObjectDetection with 4 classes, one hidden layer, 8
instances, targets padded to 5; 2 images at 64 px), bench.py's optimizer
(AdamW, backbone lr factor 0.1, clip 0.1) and an EMA at decay 0.9.  The
validation targets of image 1 are the initial model's own top three
detections, so that mAP50 lies strictly between 0 and 1.

* ``validate`` before training, and a 4-step ``fit(val_every=2,
  log_every=2)`` with a logger, the port in f64 and in f32 against JAX's
  in f64: the same keys at every logger call (steps 0-4) and in ``fit``'s
  result, mAP values within 1e-9, losses within ``LOSS_RTOL`` (1e-5)
  relative before and after the updates; ``log_hyperparams`` called as
  JAX's.  The JAX side runs under ``jax.enable_x64`` with its model
  computing in f64 and its BatchNorms as stock ``nnx.BatchNorm`` (the
  package's ``SIHL_TPU_FUSED_BN=0`` path: the fused BatchNorm keeps its
  statistics in f32 whatever the input).  Its f32 run is no reference for
  a trajectory: at step 0 its backbone gradients are up to 43% (of each
  leaf's largest) from its own f64 gradients, which agree with the port's
  f64 gradients within 1.4e-6 and with the port's f32 within 8.3e-5;
  AdamW's first step moves each weight by about ``lr * sign(g)``, so 0.5-2%
  of the backbone's weights step the other way and the JAX f32 losses
  drift up to 6e-4 from its f64 losses.  Against the f64 reference the
  port's f64 losses read at most 7.5e-7 and its f32 losses 3.3e-6; planted
  faults in the port read 7.9e-4 (no gradient clip), 1.9e-3 (the last
  optimizer step skipped), 1.3e-2 (lr 1.1e-4), 1.8e-2 (the first step
  skipped) and 3.7e-2 (backbone lr factor 1); a missing weight decay
  (1e-8 a step here) shows in no loss;
* the EMA shadow after 3 steps against the JAX trainer's ``_ema_update``
  run over the port's own parameters after each step, within 1e-6 of
  each tensor's largest magnitude;
* the EMA's increment factor ``1 - decay`` bitwise JAX's;
* ``fit``'s ``trainer/steps_per_sec`` counts the steps taken since the
  last log, also when the call starts off the logging cadence;
* validation leaves BatchNorm's running statistics where they were.

Checkpoints and the arguments that are not ported are in
``tests/test_torch_checkpoint.py``.
"""

from types import SimpleNamespace

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
from sihl_tpu.training.trainer import _ema_update
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import ObjectDetection
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training import trainer as trainer_module
from test_torch_validation import box_targets

from torch_parity import flat_state, randomize_norms, to_torch

BATCH, SIZE, NUM_CLASSES, T = 2, 64, 4, 5
LOSS_RTOL, MAP_ATOL, EMA_TOL = 1e-5, 1e-9, 1e-6
OPTIMIZER = dict(
    optimizer="adamw",
    optimizer_kwargs={"lr": 1e-4, "weight_decay": 1e-4, "backbone_lr_factor": 0.1},
    grad_clip=0.1,
    ema_decay=0.9,
    hyperparameters={"lr": 1e-4},
)


def _build(backbone, fpn, head, model, **init):
    bb = backbone("resnet18", top_level=5, **init)
    bb.set_frozen_levels(1)
    neck = fpn(bb.out_channels, 16, bottom_level=3, top_level=5, **init)
    od = head(neck.out_channels, NUM_CLASSES, num_channels=16, num_layers=1, max_instances=8, max_targets=T, **init)
    return model(bb, neck, [od])


class Logger:
    """Records every call, and the trainer's parameters and EMA shadow
    after each training step."""

    def __init__(self):
        self.calls, self.hyperparams, self.trainer, self.params, self.ema = [], [], None, [], []

    def __call__(self, metrics, step):
        self.calls.append((step, dict(metrics)))
        if self.trainer is not None and "trainer/loss" in metrics:
            self.params.append({k: v.detach().clone() for k, v in self.trainer.params.items()})
            self.ema.append({k: v.clone() for k, v in self.trainer.ema_params.items()})

    def log_hyperparams(self, hyperparameters, metrics, step):
        self.hyperparams.append((dict(hyperparameters), step))


def _batches(rng, n):
    """n batches of (NHWC images, classes, boxes)."""
    out = []
    for _ in range(n):
        x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
        out.append((x, *box_targets(rng, SIZE, NUM_CLASSES, (2, 3))))
    return out


def _jax_data(batches, dtype=jnp.float32):
    return [(jnp.asarray(x, dtype), {"classes": jnp.asarray(c), "boxes": jnp.asarray(b)}) for x, c, b in batches]


def _torch_data(batches):
    return [(to_torch(x), {"classes": torch.from_numpy(c).long(), "boxes": torch.from_numpy(b)})
            for x, c, b in batches]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    jax_model = nnx.jit(lambda: _build(JaxBackbone, JaxFPN, JaxObjectDetection, JaxSihlModel, rngs=nnx.Rngs(0)))()
    randomize_norms(jax_model, rng)
    state = state_dict_from_flat(flat_state(jax_model))
    train = _batches(rng, 4)
    val = _batches(rng, 2)
    model = _port_model(state).eval()
    for x, classes, boxes in val:
        with torch.no_grad():
            _, _, pred_classes, pred_boxes = model(to_torch(x))[0]
        classes[1, :3], boxes[1, :3] = pred_classes[1, :3].numpy(), pred_boxes[1, :3].numpy()
    return jax_model, state, train, val


def _port_model(state, dtype=torch.float32):
    with compute_dtype_scope(dtype):
        model = _build(Backbone, FPN, ObjectDetection, SihlModel)
    model.load_state_dict(state, strict=True)
    return model


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's ``validate`` and ``fit`` in f64 on the setup's weights (see the
    module docstring)."""
    jax_model, _, train, val = setup
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_convblocks, "_FUSED_BN", False)
        with jax_compute_dtype_scope(jnp.float64):
            model = nnx.jit(lambda: _build(JaxBackbone, JaxFPN, JaxObjectDetection, JaxSihlModel, rngs=nnx.Rngs(0)))()
        nnx.update(model, jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64) if v.dtype == jnp.float32 else v, nnx.state(jax_model)))
        logger = Logger()
        trainer = JaxTrainer(model, logger=logger, **OPTIMIZER)
        before = trainer.validate(_jax_data(val, jnp.float64))
        result = trainer.fit(_jax_data(train, jnp.float64), num_steps=4, val_data=_jax_data(val, jnp.float64),
                             val_every=2, log_every=2)
    return before, result, logger


def _port_run(setup, dtype):
    _, state, train, val = setup
    logger = Logger()
    trainer = Trainer(_port_model(state, dtype), logger=logger, **OPTIMIZER)
    logger.trainer = trainer
    before = trainer.validate(_torch_data(val))
    result = trainer.fit(_torch_data(train), num_steps=4, val_data=_torch_data(val), val_every=2, log_every=2)
    return before, result, logger


def _assert_metrics_match(got, want):
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if k == "trainer/steps_per_sec":
            assert v > 0
        elif k == "trainer/learning_rate":
            assert v == pytest.approx(float(want[k]), rel=1e-6)
        elif "/valid/map" in k or "/valid/mar" in k:
            assert v == pytest.approx(float(want[k]), abs=MAP_ATOL), k
        else:
            assert v == pytest.approx(float(want[k]), rel=LOSS_RTOL, abs=1e-7), k


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_validate_and_fit_match_jax(setup, jax_run, dtype):
    want_before, want_result, want_log = jax_run
    before, result, log = _port_run(setup, dtype)
    assert 0 < before["head0/valid/map_50"] < 1
    _assert_metrics_match(before, want_before)
    _assert_metrics_match(result, want_result)
    assert "trainer/steps_per_sec" in result and "head0/valid/map" in result
    # every logger call: the training steps' metrics and the validations'
    assert [s for s, _ in log.calls] == [s for s, _ in want_log.calls] == [0, 1, 2, 2, 3, 4, 4]
    for (_, got), (_, want) in zip(log.calls, want_log.calls):
        _assert_metrics_match(got, want)
    assert log.hyperparams == want_log.hyperparams == [({"lr": 1e-4}, s) for s in (0, 2, 4)]


def test_ema_matches_jax(setup):
    """The port's EMA shadow after 3 steps against JAX's ``_ema_update``
    run over the port's own parameters after each step."""
    _, state, train, _ = setup
    logger = Logger()
    trainer = Trainer(_port_model(state), logger=logger, **OPTIMIZER)
    logger.trainer = trainer
    initial = {k: v.detach().numpy().copy() for k, v in trainer.params.items()}
    trainer.fit(_torch_data(train), num_steps=3)
    want = initial
    for params in logger.params:
        want = _ema_update(want, {k: v.numpy() for k, v in params.items()}, OPTIMIZER["ema_decay"])
    got = logger.ema[2]
    assert sorted(got) == sorted(want) and all(torch.equal(a, b) for a, b in zip(got.values(), trainer.ema_params.values()))
    for name, e in got.items():
        w = np.asarray(want[name])
        err = float(np.abs(e.numpy() - w).max()) / max(float(np.abs(w).max()), 1e-12)
        assert err <= EMA_TOL, (name, err)
    # the shadow moved away from both the initial and the live parameters
    moved = [n for n in got if not torch.equal(got[n], torch.from_numpy(initial[n]))
             and not torch.equal(got[n], logger.params[2][n])]
    assert len(moved) > len(got) // 2


def test_validate_keeps_running_statistics(setup):
    _, state, _, val = setup
    trainer = Trainer(_port_model(state), **OPTIMIZER)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.validate(_torch_data(val))
    after = trainer.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert not trainer.model.training


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_ema_increment_factor_matches_jax(decay):
    """One update from a zero shadow toward parameters of 1 reads ``1 -
    decay``: bitwise the JAX trainer's jitted ``_ema_update``."""
    stub = SimpleNamespace(model=torch.nn.Linear(3, 2), ema_decay=decay)
    with torch.no_grad():
        for p in stub.model.parameters():
            p.fill_(1.0)
    stub.ema_params = {n: torch.zeros_like(p) for n, p in stub.model.named_parameters()}
    Trainer._ema_update(stub)
    want = _ema_update({"w": np.zeros(2, np.float32)}, {"w": np.ones(2, np.float32)}, decay)["w"]
    for e in stub.ema_params.values():
        assert np.array_equal(e.numpy().ravel()[:2], np.asarray(want))


class _ClockedSteps:
    """``Trainer.fit``'s loop over a stub step that takes one second of a
    fake clock."""

    def __init__(self, step):
        self.step, self.now = step, 0.0

    def training_step(self, x, targets):
        self.now += 1.0
        self.step += 1
        return {"trainer/loss": torch.tensor(0.0)}


@pytest.mark.parametrize("start", [0, 5], ids=["on-cadence", "off-cadence"])
def test_fit_steps_per_sec_counts_the_steps_taken(monkeypatch, start):
    """From step 5 with ``log_every=4`` the first log comes after 3 steps
    (at step 8); steps/s is 3 over their 3 s, not 4 over 3 s."""
    stub = _ClockedSteps(start)
    monkeypatch.setattr(trainer_module, "time", SimpleNamespace(perf_counter=lambda: stub.now))
    result = Trainer.fit(stub, [(None, None)] * 4, num_steps=4, log_every=4)
    assert stub.step == start + 4
    assert result["trainer/steps_per_sec"] == 1.0
