"""The dense slice of the port against the JAX package's (CPU): the two
models that ``chip_smoke.py`` phases 28-37 run at full size, at 64 px;
this file holds the dense model, ``tests/test_torch_panoptic_slice.py``
runs the same tests on the panoptic model.

Each is resnet18 with level 1 frozen (its stem through
``stem_conv_stats``'s plain version) → FPN 32 wide over levels 3-5 →

* the dense model: SemanticSegmentation (5 classes, void 255) and
  DepthEstimation (bounds 0.1-10, 16 bins) on the one trunk, 16 channels;
* the panoptic model: PanopticSegmentation (3 stuff, 4 thing classes, 16
  channels, two layers, 8 instances, 5 targets, void 255, smoothing
  decaying over 10 steps, its counter at 3);

4 images at 64 px, weights carried by ``state_dict_from_flat`` (strict),
every basic block's last BatchNorm damped to U(0.01, 0.03) as in
``tests/test_torch_classification_slice.py``.

Each image has its own brightness and contrast, as photographs do.  Images
of i.i.d. noise pool to nearly the same value at SPPM's 1 x 1 size, and
the train-mode BatchNorm behind that pooling then sees four nearly equal
samples, whose f32 "fast variance" (E[x^2] - E[x]^2, both packages)
cancels: JAX's f32 step then read up to 1.2e-2 from the port's f64 step
on those norms' gradients (the port's f32 step 8e-5).  With the spread,
both f32 steps are within 6.5e-4 of f64.

Compared: the forward in eval mode (class and instance maps exact, scores
and depths within 1e-5 relative); one training step through ``_losses``
with the port in f64 and in f32 against JAX's f32 step (losses within 1e-4
relative, every gradient within the relative L2 limit of its part as
``tests/test_torch_train_slice.py`` holds them, the running statistics
within 1e-4, the counter); the metrics of one ``Trainer.training_step``
(bench.py's optimizer); one ``Trainer.validate`` over two batches (every
metric within 1e-4 relative, the running statistics and the counter
unchanged).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.heads import DepthEstimation as JaxDepthEstimation
from sihl_tpu.heads import PanopticSegmentation as JaxPanopticSegmentation
from sihl_tpu.heads import SemanticSegmentation as JaxSemanticSegmentation
from sihl_tpu.layers import FPN as JaxFPN
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import DepthEstimation, PanopticSegmentation, SemanticSegmentation, panoptic_targets_from_maps
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

from test_torch_classification_slice import _damp_basic_blocks, _relative_error
from test_torch_panoptic import STUFF, THINGS, T, panoptic_maps
from torch_parity import flat_state, randomize_norms, to_torch

KIND = "dense"
BATCH, SIZE, NUM_CLASSES, IGNORE = 4, 64, 5, 255
GRADIENT_LIMITS = {"heads": 1e-3, "neck": 1e-3, "backbone": 5e-3}
OPTIMIZER = dict(
    optimizer="adamw",
    optimizer_kwargs={"lr": 1e-4, "weight_decay": 1e-4, "backbone_lr_factor": 0.1},
    grad_clip=0.1,
)
PANOPTIC_KW = dict(num_channels=16, num_layers=2, max_instances=8, max_targets=T, soft_label_decay_steps=10,
                   ignore_index=IGNORE)


def _build(kind, backbone, fpn, semantic, depth, panoptic, model, **init):
    bb = backbone("resnet18", top_level=5, **init)
    bb.set_frozen_levels(1)
    neck = fpn(bb.out_channels, 32, bottom_level=3, top_level=5, **init)
    c = neck.out_channels
    if kind == "dense":
        heads = [semantic(c, NUM_CLASSES, num_channels=16, ignore_index=IGNORE, **init),
                 depth(c, 0.1, 10.0, num_channels=16, num_bins=16, **init)]
    else:
        heads = [panoptic(c, STUFF, THINGS, **PANOPTIC_KW, **init)]
    return model(bb, neck, heads)


def _batch(kind: str, seed: int):
    """(JAX batch, port batch): images and the heads' targets."""
    rng = np.random.RandomState(seed)
    # each image its own brightness and contrast (module docstring)
    x = rng.rand(BATCH, SIZE, SIZE, 3) * rng.uniform(0.25, 1.0, (BATCH, 1, 1, 1))
    x = (x + rng.uniform(0.0, 0.75, (BATCH, 1, 1, 1))).astype(np.float32)
    if kind == "dense":
        semantic = rng.randint(0, NUM_CLASSES, (BATCH, SIZE // 4, SIZE // 4))
        semantic[rng.rand(*semantic.shape) < 0.1] = IGNORE
        semantic = semantic.repeat(4, 1).repeat(4, 2)
        depth = (x.mean(-1) * 9.9 + 0.1).astype(np.float32)
        masks = rng.rand(BATCH, SIZE, SIZE) > 0.1
        depth[~masks] = 0.0
        return ((jnp.asarray(x), [jnp.asarray(semantic), {"targets": jnp.asarray(depth), "masks": jnp.asarray(masks)}]),
                (to_torch(x), [torch.from_numpy(semantic),
                               {"targets": torch.from_numpy(depth), "masks": torch.from_numpy(masks)}]))
    sems, classes, masks = [], [], []
    for b in range(BATCH):
        semantic, id_map = panoptic_maps(rng, things=0)
        for t in range(b):
            hh, ww = 2 * rng.choice(np.arange(4, 9), 2, replace=False)
            y, xx = (t // 2) * SIZE // 2 + rng.randint(0, 8), (t % 2) * SIZE // 2 + rng.randint(0, 8)
            semantic[y : y + hh, xx : xx + ww] = STUFF + rng.randint(0, THINGS)
            id_map[y : y + hh, xx : xx + ww] = t + 1
        c, m = panoptic_targets_from_maps(semantic, id_map, STUFF, T, ignore_index=IGNORE)
        sems.append(semantic)
        classes.append(c)
        masks.append(m)
    targets = (np.stack(sems), np.stack(classes), np.stack(masks))
    keys = ("semantic", "classes", "masks")
    return ((jnp.asarray(x), {k: jnp.asarray(t) for k, t in zip(keys, targets)}),
            (to_torch(x), {k: torch.from_numpy(t) for k, t in zip(keys, targets)}))


def _jax_model(kind):
    model = _build(kind, JaxBackbone, JaxFPN, JaxSemanticSegmentation, JaxDepthEstimation, JaxPanopticSegmentation,
                   JaxSihlModel, rngs=nnx.Rngs(0))
    rng = np.random.RandomState(0)
    randomize_norms(model, rng)
    _damp_basic_blocks(model, rng)
    if kind == "panoptic":
        model.heads[0].step_counter[...] = jnp.asarray(3, jnp.int32)
    return model


@pytest.fixture(scope="module")
def pair():
    kind = KIND
    jax_model = _jax_model(kind)
    models = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            models[dtype] = _build(kind, Backbone, FPN, SemanticSegmentation, DepthEstimation, PanopticSegmentation,
                                   SihlModel)
        models[dtype].load_state_dict(state_dict_from_flat(flat_state(jax_model), models[dtype]), strict=True)
    return kind, jax_model, models


def test_forward_matches_jax(pair):
    kind, jax_model, models = pair
    (jx, _), (x, _) = _batch(kind, 1)
    jax_model = nnx.clone(jax_model)
    jax_model.eval()
    want = nnx.jit(lambda m, xx: m(xx))(jax_model, jx)
    with torch.no_grad():
        got = copy.deepcopy(models[torch.float32]).eval()(x)
    flat_got = [t for out in got for t in (out if isinstance(out, tuple) else (out,))]
    flat_want = [np.asarray(t) for out in want for t in (out if isinstance(out, tuple) else (out,))]
    assert len(flat_got) == len(flat_want) == (3 if kind == "dense" else 5)
    for g, w in zip(flat_got, flat_want):
        assert tuple(g.shape) == w.shape
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def jax_step(pair):
    """JAX's f32 training step on batch 2 (jitted once for both of the
    port's steps): loss, metrics, gradients (a port state dict) and the
    state after it."""
    kind, jax_model, models = pair
    (jx, jt), _ = _batch(kind, 2)
    jax_model = nnx.clone(jax_model)
    jax_model.train()

    @nnx.jit
    def value_and_grad(m, xx, tt):
        return nnx.value_and_grad(lambda mm: jax_losses(mm, xx, tt), has_aux=True)(m)

    (loss, metrics), grads = value_and_grad(jax_model, jx, jt if kind == "dense" else [jt])
    grads = state_dict_from_flat(
        {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads)}, models[torch.float32]
    )
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads, flat_state(jax_model)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_train_step_losses_gradients_and_stats_match_jax(pair, jax_step, dtype):
    kind, _, models = pair
    want_loss, want_metrics, want_grads, jax_state = jax_step
    _, (x, t) = _batch(kind, 2)
    model = copy.deepcopy(models[dtype]).train()
    loss, metrics = _losses(model, x.to(dtype), t if kind == "dense" else [t])
    loss.backward()

    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-4)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(want_metrics[k], rel=1e-4, abs=1e-6), k
    for name, p in model.named_parameters():
        if name.startswith("backbone.features.stem."):
            assert p.grad is None and not want_grads[name].any(), name
            continue
        err = _relative_error(p.grad, want_grads[name])
        assert err <= GRADIENT_LIMITS[name.split(".")[0]], (name, err)

    want_state = state_dict_from_flat(jax_state, model)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.double().numpy(), want_state[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    if kind == "panoptic":
        assert int(model.heads[0].step_counter) == int(want_state["heads.0.step_counter"]) == 4


def test_trainer_step_metrics_match_jax(pair):
    kind, jax_model, models = pair
    (jx, jt), (x, t) = _batch(kind, 3)
    want = JaxTrainer(nnx.clone(jax_model), **OPTIMIZER).training_step(jx, jt)
    got = Trainer(copy.deepcopy(models[torch.float32]), **OPTIMIZER).training_step(x, t)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert float(v) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k


def test_validate_matches_jax(pair):
    kind, jax_model, models = pair
    batches = [_batch(kind, 4), _batch(kind, 5)]
    want = JaxTrainer(nnx.clone(jax_model), **OPTIMIZER).validate([b[0] for b in batches])
    model = copy.deepcopy(models[torch.float32])
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    got = Trainer(model, **OPTIMIZER).validate([b[1] for b in batches])
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k
    assert all(torch.equal(b, buffers[n]) for n, b in model.named_buffers())
