"""The training steps of every model that ``chip_smoke.py`` trains, as a CUDA
graph would hold them, and the Dropout stream that such a graph replays
(CPU, torch only).

Each of the twenty configurations is the smoke's model cut to the smallest
name of its trunk family, 64 px, necks 16 wide, heads narrow (random
weights from a seed; the pretrained trunks get the ImageNet ``Normalize``
in front that their file's loader puts there, and level 1 frozen), with
targets of every kind its heads take.  Its step, forward and backward,
runs no operation that would make a CUDA graph's capture fail or tie it to
host data (``test_torch_dispatch._HostRoundTrips``: a host read, a
data-dependent shape, a tensor made from host data).

The Dropout stream (``layers/dropout.py``): the mask is a function of
(seed, count), the same from a fresh module with the same seed and after
a state-dict round trip into another module; the count is a 0-dim int64
tensor on the module's device that a call advances in place (the storage
stays, its version moves); two consecutive training steps of the
multitask model draw different masks; the kept share lies within five
standard deviations of ``1 - rate``.

A trunk that differentiates its frozen prefix (MobileNet) gives each step
that step's gradients there, so a trainer restored from a state steps on
bitwise as the one it was saved from.
"""

import copy

import numpy as np
import pytest
import torch

from sihl_tpu_torch import Backbone, SihlModel, TimmBackbone
from sihl_tpu_torch.backbones.base import IMAGENET_MEAN, IMAGENET_STD
from sihl_tpu_torch.heads import (AnomalyDetection, Autoencoding, DepthEstimation, KeypointDetection,
                                  MulticlassClassification, MultilabelClassification, ObjectDetection,
                                  PanopticSegmentation, QuadrilateralDetection, Regression, SemanticSegmentation,
                                  ViewInvarianceLearning)
from sihl_tpu_torch.layers import FPN, PAN, BiFPN, HybridEncoder
from sihl_tpu_torch.layers.dropout import Dropout, keep_mask
from sihl_tpu_torch.layers.preprocessing import Normalize
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

from test_torch_dispatch import (BATCH, NUM_CLASSES, SGD, SIZE, T, _HostRoundTrips, _instance_model, _multitask,
                                 _multitask_targets)

WIDTH, CLASSES, KEYPOINTS, VOID = 16, 7, 5, 255
HEAD = dict(num_channels=16, num_layers=1)


def _trunk(name: str, gen, pretrained: bool = False, frozen: int = 1, **kwargs):
    """The trunk ``name`` with ``frozen`` levels frozen (-1: every level);
    ``pretrained`` puts the ImageNet ``Normalize`` in front, as the
    pretrained loader does."""
    make = TimmBackbone if name.startswith("resnetv2") else Backbone
    bb = make(name, top_level=5, generator=gen, **kwargs)
    if pretrained:
        bb.normalize = Normalize(IMAGENET_MEAN, IMAGENET_STD)
    bb.set_frozen_levels(frozen)
    return bb


def _detector(name="resnet18", neck=FPN, top=7, pretrained=False, **neck_kwargs):
    """The flagship's shape (``name`` → ``neck`` over levels 3-``top`` →
    ObjectDetection), narrow."""
    gen = torch.Generator().manual_seed(0)
    bb = _trunk(name, gen, pretrained)
    n = neck(bb.out_channels, WIDTH, 3, top, generator=gen, **neck_kwargs)
    od = ObjectDetection(n.out_channels, NUM_CLASSES, bottom_level=3, top_level=top, max_instances=8, max_targets=T,
                         generator=gen, **HEAD)
    return SihlModel(bb, n, [od])


def _quad():
    gen = torch.Generator().manual_seed(0)
    bb = _trunk("resnet18", gen)
    neck = BiFPN(bb.out_channels, WIDTH, 3, 5, num_layers=2, generator=gen)
    head = QuadrilateralDetection(neck.out_channels, 3, max_instances=8, max_targets=T, generator=gen, **HEAD)
    return SihlModel(bb, neck, [head])


def _classifier(name="resnet18", pretrained=False, three_heads=True):
    gen = torch.Generator().manual_seed(0)
    bb = _trunk(name, gen, pretrained)
    c = bb.out_channels
    heads = [MulticlassClassification(c, CLASSES, label_smoothing=0.1, num_channels=16, generator=gen)]
    if three_heads:
        heads += [MultilabelClassification(c, CLASSES, num_channels=16, generator=gen),
                  Regression(c, 0.0, 100.0, num_channels=16, generator=gen)]
    return SihlModel(bb, None, heads)


def _dense():
    gen = torch.Generator().manual_seed(0)
    bb = _trunk("resnet18", gen)
    neck = FPN(bb.out_channels, WIDTH, 3, 5, generator=gen)
    c = neck.out_channels
    return SihlModel(bb, neck, [SemanticSegmentation(c, CLASSES, ignore_index=VOID, generator=gen, **HEAD),
                                DepthEstimation(c, 0.1, 10.0, num_bins=16, generator=gen, **HEAD)])


def _panoptic():
    gen = torch.Generator().manual_seed(0)
    bb = _trunk("resnet18", gen)
    neck = FPN(bb.out_channels, WIDTH, 3, 5, generator=gen)
    head = PanopticSegmentation(neck.out_channels, 3, NUM_CLASSES, max_instances=8, max_targets=T,
                                soft_label_decay_steps=100, ignore_index=VOID, generator=gen, **HEAD)
    return SihlModel(bb, neck, [head])


def _ssl(kind: str):
    gen = torch.Generator().manual_seed(0)
    bb = _trunk("resnet18", gen, frozen=-1 if kind == "anomaly" else 1, freeze_batchnorms=kind == "anomaly")
    c = bb.out_channels
    head = {
        "autoencoder": lambda: Autoencoding(c, num_channels=16, representation_channels=32, generator=gen),
        "view_invariance": lambda: ViewInvarianceLearning(c, embedding_dim=32, generator=gen, **HEAD),
        "anomaly": lambda: AnomalyDetection(c, num_channels=16, autoencoder_channels=8, reservoir_size=256,
                                            samples_per_step=16, generator=gen),
    }[kind]()
    return SihlModel(bb, None, [head])


def _keypoint():
    gen = torch.Generator().manual_seed(0)
    bb = _trunk("resnet18", gen)
    neck = FPN(bb.out_channels, WIDTH, 3, 5, generator=gen)
    head = KeypointDetection(neck.out_channels, KEYPOINTS, max_instances=8, max_targets=T, max_mask_positives=8,
                             generator=gen, **HEAD)
    return SihlModel(bb, neck, [head])


def _hrnet():
    gen = torch.Generator().manual_seed(0)
    bb = _trunk("hrnet_w18", gen)
    head = SemanticSegmentation(bb.out_channels, CLASSES, bottom_level=2, top_level=5, ignore_index=VOID,
                                generator=gen, **HEAD)
    return SihlModel(bb, None, [head])


# -- targets -------------------------------------------------------------------------


def _boxes(rng):
    classes = torch.full((BATCH, T), -1, dtype=torch.long)
    boxes = torch.zeros(BATCH, T, 4)
    for b in range(BATCH):
        n = rng.randint(1, T + 1)
        classes[b, :n] = torch.from_numpy(rng.randint(0, NUM_CLASSES, n))
        wh = 2 * rng.randint(2, 12, (n, 2)) + 1
        xy = rng.randint(0, SIZE - 25, (n, 2))
        boxes[b, :n] = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32))
    return {"classes": classes, "boxes": boxes}


def _masks(rng, classes):
    """(B, T, SIZE, SIZE) rectangles for the live rows of ``classes``."""
    masks = torch.zeros(BATCH, T, SIZE, SIZE)
    for b, t in zip(*np.nonzero(classes.numpy() >= 0)):
        h, w = rng.randint(4, 24, 2)
        y, x = rng.randint(0, SIZE - h), rng.randint(0, SIZE - w)
        masks[b, t, y : y + h, x : x + w] = 1.0
    return masks


def _semantic(rng):
    blocks = rng.randint(0, CLASSES, (BATCH, SIZE // 16, SIZE // 16))
    blocks[rng.rand(*blocks.shape) < 0.05] = VOID
    return torch.from_numpy(blocks.repeat(16, axis=1).repeat(16, axis=2))


def _depth(rng, x):
    masks = torch.from_numpy(rng.rand(BATCH, SIZE, SIZE) > 0.1)
    return {"targets": torch.where(masks, x.mean(dim=1) * 9.0 + 0.5, 0.0), "masks": masks}


def _quads(rng):
    classes = torch.full((BATCH, T), -1, dtype=torch.long)
    quads = torch.zeros(BATCH, T, 4, 2)
    for b in range(BATCH):
        n = rng.randint(1, T + 1)
        classes[b, :n] = torch.from_numpy(rng.randint(0, 3, n))
        for t in range(n):
            w, h = 2 * rng.randint(4, 12, 2) + 1
            x0, y0 = rng.randint(0, SIZE - w), rng.randint(0, SIZE - h)
            a, bb, c, d = rng.randint(1, min(w, h), 4)
            quads[b, t] = torch.tensor([[x0 + a, y0], [x0 + w, y0 + bb], [x0 + w - c, y0 + h], [x0, y0 + h - d]])
    return {"classes": classes, "quads": quads}


def _keypoints(rng):
    keypoints = torch.zeros(BATCH, T, KEYPOINTS, 2)
    presence = torch.zeros(BATCH, T, KEYPOINTS, dtype=torch.bool)
    for b in range(BATCH):
        for t in range(rng.randint(1, 3)):
            centre = rng.rand(1, 2) * 32 + 16
            keypoints[b, t] = torch.from_numpy(np.clip(np.round(centre + rng.randn(KEYPOINTS, 2) * 8), 0, SIZE - 1))
            presence[b, t] = torch.from_numpy(rng.rand(KEYPOINTS) > 0.3)
            presence[b, t, :2] = True
    return {"keypoints": keypoints, "presence": presence}


def _targets(kind: str, rng, x):
    if kind in ("flagship", "hybrid", "pan", "resnetv2", "effdet", "mnv3", "convnext", "dla"):
        return _boxes(rng)
    if kind == "instance":
        classes = _boxes(rng)["classes"]
        return {"classes": classes, "masks": _masks(rng, classes)}
    if kind == "panoptic":
        classes = _boxes(rng)["classes"]
        return {"semantic": _semantic(rng), "classes": classes, "masks": _masks(rng, classes)}
    if kind == "quad":
        return _quads(rng)
    if kind == "classifier":
        return [torch.from_numpy(rng.randint(0, CLASSES, BATCH)),
                torch.from_numpy((rng.rand(BATCH, CLASSES) < 0.3).astype(np.float32)),
                torch.from_numpy((rng.rand(BATCH) * 100).astype(np.float32))]
    if kind == "densenet":
        return torch.from_numpy(rng.randint(0, CLASSES, BATCH))
    if kind == "dense":
        return [_semantic(rng), _depth(rng, x)]
    if kind == "hrnet":
        return _semantic(rng)
    if kind == "multitask":
        return _multitask_targets(rng, x, _boxes(rng))
    if kind == "autoencoder":
        return x
    if kind == "view_invariance":
        return torch.clamp(x * 0.9 + torch.from_numpy(rng.randn(*x.shape).astype(np.float32)) * 0.05, 0, 1)
    if kind == "anomaly":
        return None
    if kind == "keypoint":
        return _keypoints(rng)
    raise ValueError(kind)


MODELS = {
    "flagship": _detector,
    "instance": _instance_model,
    "quad": _quad,
    "classifier": _classifier,
    "dense": _dense,
    "panoptic": _panoptic,
    "hybrid": lambda: _detector(neck=HybridEncoder, top=5),
    "multitask": _multitask,
    "autoencoder": lambda: _ssl("autoencoder"),
    "view_invariance": lambda: _ssl("view_invariance"),
    "anomaly": lambda: _ssl("anomaly"),
    "keypoint": _keypoint,
    "pan": lambda: _detector(neck=PAN, pretrained=True),
    "resnetv2": lambda: _detector("resnetv2_50"),
    "effdet": lambda: _detector("efficientnet_b0", neck=BiFPN, top=6, pretrained=True, num_layers=2),
    "mnv3": lambda: _detector("mobilenet_v3_small"),
    "convnext": lambda: _detector("convnext_atto", pretrained=True),
    "densenet": lambda: _classifier("densenet121", pretrained=True, three_heads=False),
    "dla": lambda: _detector("dla34"),
    "hrnet": _hrnet,
}


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_step_has_no_host_round_trip(kind):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(BATCH, 3, SIZE, SIZE).astype(np.float32))
    targets = _targets(kind, rng, x)
    net = MODELS[kind]()
    net.train()
    Trainer(net, **SGD)._apply_frozen_bn()
    mode = _HostRoundTrips()
    with mode:
        loss, _ = _losses(net, x, targets if isinstance(targets, list) else [targets])
        loss.backward()
    assert mode.seen == []
    assert torch.isfinite(loss)


# -- the Dropout stream ------------------------------------------------------------------


def test_dropout_mask_is_a_function_of_seed_and_count():
    x = torch.rand(4, 5, 16) + 0.5
    drop = Dropout(0.3, generator=torch.Generator().manual_seed(0)).train()
    masks = [drop(x) != 0 for _ in range(3)]
    for count, mask in enumerate(masks):
        assert torch.equal(mask, keep_mask(drop.seed, torch.tensor(count), x.shape, 0.3))
    twin = Dropout(0.3, generator=torch.Generator().manual_seed(0)).train()
    assert twin.seed == drop.seed and all(torch.equal(twin(x) != 0, m) for m in masks)
    other = Dropout(0.3, generator=torch.Generator().manual_seed(9)).train()
    assert not torch.equal(other(x) != 0, masks[0])
    other.load_state_dict(drop.state_dict(), strict=True)
    assert (other.seed, int(other.count)) == (drop.seed, 3)
    assert torch.equal(other(x) != 0, drop(x) != 0)


def test_dropout_count_is_a_device_tensor_advanced_in_place():
    drop = Dropout(0.5, device="cpu").train()
    count = drop.count
    assert count.shape == () and count.dtype == torch.int64 and count.device.type == "cpu"
    version = count._version
    drop(torch.ones(8))
    assert drop.count is count and int(count) == 1 and count._version > version
    drop.eval()(torch.ones(8))
    Dropout(0.0).train()(torch.ones(8))
    assert int(count) == 1
    moved = drop.to(torch.float64)
    assert moved.count.dtype == torch.int64 and int(moved.count) == 1


def test_dropout_kept_share_and_scale():
    rate, n = 0.1, 200_000
    x = torch.rand(n) + 0.5
    y = Dropout(rate, generator=torch.Generator().manual_seed(3)).train()(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5
    assert torch.equal(y[kept], x[kept] / (1 - rate))


def test_consecutive_steps_draw_different_masks():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(BATCH, 3, SIZE, SIZE).astype(np.float32))
    targets = _targets("multitask", rng, x)
    trainer = Trainer(_multitask(), **SGD)
    dropout = trainer.model.heads[1].dropout
    masks = []
    dropout.register_forward_hook(lambda module, inputs, output: masks.append(output != 0))
    for _ in range(2):
        trainer.training_step(x, targets)
    assert len(masks) == 2 and not torch.equal(*masks) and int(dropout.count) == 2


def test_frozen_prefix_gradients_start_anew_each_step():
    """A MobileNet trunk gives its frozen prefix gradients (outside every
    optimizer group; the clip's norm counts them): each step's are that
    step's alone, so a trainer restored from a state continues bitwise as
    the one it was saved from."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(BATCH, 3, SIZE, SIZE).astype(np.float32))
    targets = _targets("mnv3", rng, x)
    trainer = Trainer(MODELS["mnv3"](), **SGD)
    frozen = [p for n, p in trainer.model.named_parameters() if n.startswith("backbone.features.stem.")]
    for _ in range(2):
        trainer.training_step(x, targets)
    assert frozen and all(p.grad is not None for p in frozen)
    restored = Trainer(MODELS["mnv3"](), **SGD)
    restored.load_state_dict(copy.deepcopy(trainer.state_dict()))
    for t in (trainer, restored):
        t.training_step(x, targets)
    for (name, p), q in zip(trainer.model.named_parameters(), restored.model.parameters()):
        assert torch.equal(p, q), name
