"""The port's checkpoints and the ``Trainer`` arguments it does not port
(CPU, no JAX).

A small detector (resnet18 with level 1 frozen, FPN 16 wide over levels
3-5, ObjectDetection with 4 classes, one hidden layer; 2 images at 64 px),
random weights from a seed, bench.py's optimizer and an EMA at decay 0.9:

* ``restore_checkpoint`` of a fit's final save into a fresh trainer gives
  a ``state_dict`` (parameters, BatchNorm buffers, optimizer state, step,
  EMA shadow) bitwise equal to the saved one;
* a fit of 2 steps resumed from ``step_2`` ends bitwise where an
  uninterrupted 4-step fit ends;
* loading a live ``state_dict`` shares no optimizer state between two
  trainers;
* ``use_ema_params`` then ``predict`` equals a model loaded from the shadow;
* a fit in dispatches of 2 steps saves at its cadence, and a trainer
  restored from its ``step_2`` and fitted in one more dispatch ends bitwise
  where it ends;
* ``mesh``, ``spatial_partition``, ``viz_logger``, ``viz_every`` and
  ``remat`` raise ``NotImplementedError``.
"""

import numpy as np
import pytest
import torch

from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.heads import ObjectDetection
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.policy import set_default_device
from sihl_tpu_torch.training import Trainer, restore_checkpoint, save_checkpoint

torch.set_num_threads(1)
set_default_device("cpu")

BATCH, SIZE, NUM_CLASSES, T = 2, 64, 4, 5
OPTIMIZER = dict(
    optimizer="adamw",
    optimizer_kwargs={"lr": 1e-4, "weight_decay": 1e-4, "backbone_lr_factor": 0.1},
    grad_clip=0.1,
    ema_decay=0.9,
)


def _port_model(state=None):
    gen = torch.Generator().manual_seed(0)
    bb = Backbone("resnet18", top_level=5, generator=gen)
    bb.set_frozen_levels(1)
    neck = FPN(bb.out_channels, 16, bottom_level=3, top_level=5, generator=gen)
    od = ObjectDetection(neck.out_channels, NUM_CLASSES, num_channels=16, num_layers=1, max_instances=8,
                         max_targets=T, generator=gen)
    model = SihlModel(bb, neck, [od])
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    data = []
    for _ in range(4):
        x = torch.from_numpy(rng.rand(BATCH, 3, SIZE, SIZE).astype(np.float32))
        classes = torch.full((BATCH, T), -1, dtype=torch.long)
        boxes = torch.zeros(BATCH, T, 4)
        for b in range(BATCH):
            n = rng.randint(1, T + 1)
            classes[b, :n] = torch.from_numpy(rng.randint(0, NUM_CLASSES, n))
            wh = 2 * rng.randint(2, 12, (n, 2)) + 1
            xy = rng.randint(0, SIZE - 25, (n, 2))
            boxes[b, :n] = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32))
        data.append((x, {"classes": classes, "boxes": boxes}))
    return _port_model().state_dict(), data


def _assert_state_equal(got, want):
    """Two train states (nested dicts of tensors and numbers) bit for bit."""
    if isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str)
        for k in want:
            _assert_state_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_state_equal(g, w)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert got == want


def test_checkpoint_round_trip_and_resumed_fit(setup, tmp_path):
    state, data = setup
    full = Trainer(_port_model(state), **OPTIMIZER)
    full.fit(data, num_steps=4, checkpoint_every=2, checkpoint_dir=str(tmp_path), log_every=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]

    # the final save, restored into a fresh trainer
    fresh = Trainer(_port_model(state), **OPTIMIZER)
    restore_checkpoint(fresh, str(tmp_path / "step_4"))
    _assert_state_equal(fresh.state_dict(), full.state_dict())
    assert fresh.step == 4

    # 2 + 2 steps, resumed from step_2, end where 4 uninterrupted steps end
    resumed = Trainer(_port_model(state), **OPTIMIZER)
    restore_checkpoint(resumed, str(tmp_path / "step_2"))
    assert resumed.step == 2
    resumed.fit(data[2:], num_steps=2, log_every=2)
    _assert_state_equal(resumed.state_dict(), full.state_dict())

    # a save of the resumed trainer holds what it holds; loading a live state
    # dict shares no optimizer state between two trainers
    save_checkpoint(resumed, str(tmp_path / "again"))
    restore_checkpoint(fresh, str(tmp_path / "again"))
    _assert_state_equal(fresh.state_dict(), resumed.state_dict())
    fresh.load_state_dict(full.state_dict())
    opt, full_opt = fresh.optimizer.state_dict()["state"], full.optimizer.state_dict()["state"]
    assert all(a["exp_avg"].data_ptr() != b["exp_avg"].data_ptr() for a, b in zip(opt.values(), full_opt.values()))

    # the EMA shadow served: use_ema_params then predict, against a model
    # loaded from the shadow
    x = data[0][0]
    model = _port_model(state)
    model.load_state_dict({**full.model.state_dict(), **full.ema_params}, strict=True)
    with torch.no_grad():
        want = model.eval()(x)[0]
    full.use_ema_params()
    got = full.predict(x)[0]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(p, full.ema_params[n]) for n, p in full.params.items())


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()}, {"spatial_partition": True}, {"viz_logger": print}, {"viz_every": 5}, {"remat": True},
], ids=["mesh", "spatial_partition", "viz_logger", "viz_every", "remat"])
def test_arguments_not_ported_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Trainer(None, **kwargs)


def test_scanned_fit_then_save_and_restore(setup, tmp_path):
    state, data = setup
    scanned = Trainer(_port_model(state), **OPTIMIZER)
    scanned.fit(data, num_steps=4, steps_per_dispatch=2, checkpoint_every=2, checkpoint_dir=str(tmp_path), log_every=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]
    scanned.sync_model()  # a no-op: the live parameters are current
    resumed = Trainer(_port_model(state), **OPTIMIZER)
    restore_checkpoint(resumed, str(tmp_path / "step_2"))
    assert resumed.step == 2
    resumed.fit(data[2:], num_steps=2, steps_per_dispatch=2, log_every=2)
    _assert_state_equal(resumed.state_dict(), scanned.state_dict())
