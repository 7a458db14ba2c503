"""The port's multi-step dispatch on the CPU, torch only (its parity with
the JAX package's is ``tests/test_torch_scanned.py``).

A small detector (resnet18 with level 1 frozen, FPN 16 wide over levels
3-5, ObjectDetection with 4 classes, one hidden layer; 2 images at 64 px)
and an instance segmenter on the same trunk, random weights from a seed:

* ``fit(steps_per_dispatch=3)`` ends bitwise where
  ``fit(steps_per_dispatch=1)`` ends (parameters, BatchNorm statistics,
  optimizer state, EMA, the last logged metrics but the learning rate,
  which a dispatch logs at the step count it ends on), for AdamW with an
  EMA, Nesterov SGD and LAMB under a one-cycle schedule, and for the
  multitask model (the detector's trunk and neck under ObjectDetection,
  TextRecognition with Dropout 0.1, DepthEstimation and MetricLearning),
  whose dropout stream ends at the same count;
* a K1 pack built before a dispatch is not served after it, even where a
  parameter changed without moving its ``_version`` (as a CUDA graph's
  replay writes); a call made while a stream is captured packs anew and
  caches nothing;
* the detector's and the instance segmenter's steps (forward and backward)
  run no operation that would make a CUDA graph's capture fail or tie it
  to host data: no read of a tensor on the host (``item``), no
  data-dependent shape (``nonzero``, a boolean index), no tensor made from
  host data (a host-to-device copy on the card);
* a trainer whose learning rates are floats (the CPU's) refuses a graph;
  an active Dropout does not.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.heads import (DepthEstimation, InstanceSegmentation, MetricLearning, ObjectDetection,
                                  TextRecognition)
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops import fused_mlp
from sihl_tpu_torch.policy import set_default_device
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

torch.set_num_threads(1)
set_default_device("cpu")

BATCH, SIZE, NUM_CLASSES, T = 2, 64, 4, 5
TOKENS, LENGTH, IDENTITIES = 6, 5, 3
ADAMW_EMA = dict(
    optimizer="adamw",
    optimizer_kwargs={"lr": 1e-4, "weight_decay": 1e-4, "backbone_lr_factor": 0.1},
    grad_clip=0.1,
    ema_decay=0.9,
)
SGD = dict(optimizer="sgd", optimizer_kwargs={"lr": 1e-2, "momentum": 0.9, "nesterov": True}, grad_clip=0.1)


def _trunk(gen):
    bb = Backbone("resnet18", top_level=5, generator=gen)
    bb.set_frozen_levels(1)
    return bb, FPN(bb.out_channels, 16, bottom_level=3, top_level=5, generator=gen)


def _detector():
    gen = torch.Generator().manual_seed(0)
    bb, neck = _trunk(gen)
    od = ObjectDetection(neck.out_channels, NUM_CLASSES, num_channels=16, num_layers=1, max_instances=8,
                         max_targets=T, generator=gen)
    return SihlModel(bb, neck, [od])


def _instance_model():
    gen = torch.Generator().manual_seed(0)
    bb, neck = _trunk(gen)
    head = InstanceSegmentation(neck.out_channels, NUM_CLASSES, num_channels=16, num_layers=1, max_instances=8,
                                max_targets=T, max_mask_positives=16, generator=gen)
    return SihlModel(bb, neck, [head])


def _multitask(dropout: float = 0.1):
    """``examples/multitask.py``'s four heads, narrow, on the detector's
    trunk and neck; the text head with ``dropout``."""
    gen = torch.Generator().manual_seed(0)
    bb, neck = _trunk(gen)
    c = neck.out_channels
    heads = [
        ObjectDetection(c, NUM_CLASSES, num_channels=16, num_layers=1, max_instances=8, max_targets=T, generator=gen),
        TextRecognition(c, TOKENS, LENGTH, level=3, num_channels=16, num_heads=4, embedding_dim=32, dropout=dropout,
                        generator=gen),
        DepthEstimation(c, 0.1, 10.0, num_channels=16, num_bins=16, generator=gen),
        MetricLearning(c, IDENTITIES, embedding_dim=16, level=2, generator=gen),
    ]
    return SihlModel(bb, neck, heads)


def _multitask_targets(rng, x, detection):
    """The four heads' targets of images ``x``: ``detection``, texts of 1 to
    ``LENGTH - 1`` tokens padded with ``TOKENS``, depths in (0.1, 10) with a
    tenth of the pixels invalid, identities."""
    texts = torch.full((x.shape[0], LENGTH), TOKENS, dtype=torch.long)
    for b in range(x.shape[0]):
        n = rng.randint(1, LENGTH)
        texts[b, :n] = torch.from_numpy(rng.randint(0, TOKENS, n))
    masks = torch.from_numpy(rng.rand(x.shape[0], SIZE, SIZE) > 0.1)
    depth = torch.where(masks, x.mean(dim=1) * 9.0 + 0.5, 0.0)
    ids = torch.from_numpy(rng.randint(0, IDENTITIES, x.shape[0]))
    return [detection, texts, {"targets": depth, "masks": masks}, ids]


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(6):
        x = torch.from_numpy(rng.rand(BATCH, 3, SIZE, SIZE).astype(np.float32))
        classes = torch.full((BATCH, T), -1, dtype=torch.long)
        boxes = torch.zeros(BATCH, T, 4)
        for b in range(BATCH):
            n = rng.randint(1, T + 1)
            classes[b, :n] = torch.from_numpy(rng.randint(0, NUM_CLASSES, n))
            wh = 2 * rng.randint(2, 12, (n, 2)) + 1
            xy = rng.randint(0, SIZE - 25, (n, 2))
            boxes[b, :n] = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32))
        out.append((x, {"classes": classes, "boxes": boxes}))
    return out


def _stack(batches):
    """(xs, targets) of one dispatch from a list of (x, targets)."""
    return torch.stack([x for x, _ in batches]), {k: torch.stack([t[k] for _, t in batches]) for k in batches[0][1]}


@pytest.mark.parametrize("case", ["adamw_ema", "sgd_nesterov", "lamb_onecycle", "multitask_dropout"])
def test_fit_dispatch_of_3_is_bitwise_one_step_at_a_time(data, case):
    kwargs = {
        "adamw_ema": ADAMW_EMA,
        "sgd_nesterov": SGD,
        "lamb_onecycle": dict(optimizer="lamb", optimizer_kwargs={"lr": 1e-3, "weight_decay": 1e-2},
                              scheduler="onecycle", scheduler_kwargs={"total_steps": 6}),
        "multitask_dropout": ADAMW_EMA,
    }[case]
    build = _detector
    if case == "multitask_dropout":
        build = _multitask
        rng = np.random.RandomState(1)
        data = [(x, _multitask_targets(rng, x, t)) for x, t in data]
    ends = []
    for k in (3, 1):
        trainer = Trainer(build(), **kwargs)
        result = trainer.fit(data, num_steps=6, steps_per_dispatch=k, log_every=3)
        ends.append((trainer.state_dict(), result))
    (scanned, scanned_result), (stepped, stepped_result) = ends
    assert scanned["step"] == stepped["step"] == 6
    assert scanned["model"].keys() == stepped["model"].keys()
    for part in ("model", "ema"):
        for name, value in stepped.get(part, {}).items():
            assert torch.equal(scanned[part][name], value), (part, name)
    for (a, b) in zip(scanned["opt"]["state"].values(), stepped["opt"]["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in b)
    own = ("trainer/steps_per_sec", "trainer/learning_rate")
    assert {k: v for k, v in scanned_result.items() if k not in own} == {
        k: v for k, v in stepped_result.items() if k not in own}
    # a step logs the rate it took; a dispatch, as the JAX trainer's, the
    # rate at the step count it ends on
    assert stepped_result["trainer/learning_rate"] == trainer.schedule(5)
    assert scanned_result["trainer/learning_rate"] == trainer.schedule(6)


def test_pack_built_before_a_dispatch_is_not_served_after_it(data, monkeypatch):
    mlp = MLP(16, [16, 16, 3])
    first = fused_mlp.pack_mlp_params(mlp, torch.float32)
    assert fused_mlp.pack_mlp_params(mlp, torch.float32) is first
    with torch.no_grad():
        mlp.linears[0].weight.data.mul_(2.0)  # as a replay writes: no version bump
    assert fused_mlp.pack_mlp_params(mlp, torch.float32) is first  # the stale pack, before a dispatch
    trainer = Trainer(_detector(), **SGD)
    trainer.training_steps_scanned(*_stack(data[:1]))
    fresh = fused_mlp.pack_mlp_params(mlp, torch.float32)
    assert fresh is not first
    assert torch.equal(fresh.wt[0], mlp.linears[0].weight.detach())

    # while a stream is captured: packed anew each call, nothing cached
    monkeypatch.setattr(fused_mlp, "_capturing", lambda t: True)
    captured = fused_mlp.pack_mlp_params(mlp, torch.float32)
    assert captured is not fresh and fused_mlp.pack_mlp_params(mlp, torch.float32) is not captured
    monkeypatch.undo()
    assert fused_mlp.pack_mlp_params(mlp, torch.float32) is fresh


class _HostRoundTrips(TorchDispatchMode):
    """Records the operations that a CUDA graph's capture refuses or that
    would tie it to host data."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bool_index = name in ("index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
            for i in (args[1] if len(args) > 1 and isinstance(args[1], (list, tuple)) else ()))
        if name in ("_local_scalar_dense", "nonzero", "masked_select", "lift_fresh", "_unique2", "unique_dim",
                    "equal", "is_nonzero", "repeat_interleave") or bool_index:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("model", ["flagship", "instance"])
def test_step_has_no_host_round_trip(data, model):
    x, targets = data[0]
    if model == "flagship":
        net = _detector()
    else:
        net = _instance_model()
        masks = torch.zeros(x.shape[0], 5, 64, 64)
        masks[:, :2, 8:30, 10:40] = 1.0
        targets = {"classes": targets["classes"], "masks": masks}
    net.train()
    mode = _HostRoundTrips()
    with mode:
        loss, _ = _losses(net, x, [targets])
        loss.backward()
    assert mode.seen == []


def test_float_learning_rates_refuse_a_graph():
    trainer = Trainer(_multitask(), **SGD)  # an active Dropout, which a graph holds
    with pytest.raises(RuntimeError, match="learning rate as a tensor"):
        trainer._check_capturable(torch.device("cpu"))
