"""The pretrained PAN detector of the port against the JAX package's (CPU):
the model that ``chip_smoke.py`` runs at full size, at 64 px.

resnet18 with torchvision-format weights from a file (the JAX package's
``dump_state_dict`` of a seeded trunk, every basic block's last BatchNorm
damped to U(0.01, 0.03) as in ``tests/test_torch_classification_slice.py``,
saved under a temporary ``TORCH_HOME``), loaded by the port's
``Backbone("resnet18", pretrained=True, frozen_levels=1)`` (``Normalize``
in front, the stem through ``stem_conv_stats``'s plain version) and by
JAX's ``load_state_dict`` + ``PyramidBackbone(..., pretrained=True,
frozen_levels=1)`` → PAN 32 wide over levels 3-5 → ObjectDetection (5
classes, 16 channels, one hidden layer, 8 instances, 5 targets).  The
neck's and head's weights cross by ``state_dict_from_flat`` (strict, the
trunk's equal to the file's).  4 images at 64 px with their own
brightness and contrast, boxes with centres on half pixels.

Compared: the forward in eval mode against JAX's f32 forward (integer
outputs exact, floats within 1e-5 relative); one training step through
``_losses`` with the port in f64 and f32 against JAX's jitted f64 step
(the JAX ``Trainer``'s ``_train_step``; losses and metrics within 1e-4,
gradients within 1e-5 (f64) and the part limits (f32), running statistics
within 1e-4, no gradient for the frozen stem), on a batch whose CIoU
decisions lie away from their kinks; and the port's f32
``Trainer.training_step`` against the same JAX step: every metric within
1e-4 and the parameters after the update (``assert_update_matches``).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.backbones.base import PyramidBackbone as JaxPyramidBackbone
from sihl_tpu.backbones.resnet import make_resnet_features as jax_make_resnet_features
from sihl_tpu.backbones.torchvision_import import dump_state_dict as jax_dump_state_dict
from sihl_tpu.backbones.torchvision_import import load_state_dict as jax_load_state_dict
from sihl_tpu.heads import ObjectDetection as JaxObjectDetection
from sihl_tpu.layers import PAN as JaxPAN
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import ObjectDetection
from sihl_tpu_torch.layers import PAN
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

from test_torch_classification_slice import _damp_basic_blocks, _relative_error
from test_torch_hybrid_slice import (F64_LIMIT, GRADIENT_LIMITS, OPTIMIZER, _ciou_kink_margin, _f64,
                                     _zero_in_exact_arithmetic, assert_update_matches, jax_f64)
from test_torch_pretrained import write_weights
from test_torch_validation import T, box_targets
from torch_parity import flat_state, randomize_norms, to_torch

BATCH, SIZE, NUM_CLASSES, WIDTH = 4, 64, 5, 32
STEP_SEED = 2


def _jax_features(sd):
    features = nnx.jit(lambda: jax_make_resnet_features("resnet18", rngs=nnx.Rngs(1)))()
    jax_load_state_dict(features, "resnet18", sd)
    return features


def _build(bb, pan, detection, model, **init):
    neck = pan(bb.out_channels, WIDTH, bottom_level=3, top_level=5, **init)
    head = detection(neck.out_channels, NUM_CLASSES, num_channels=16, num_layers=1, max_instances=8, max_targets=T,
                     **init)
    return model(bb, neck, [head])


def _jax_model(sd):
    bb = JaxPyramidBackbone("resnet18", _jax_features(sd), frozen_levels=1, pretrained=True, rngs=nnx.Rngs(0))
    model = _build(bb, JaxPAN, JaxObjectDetection, JaxSihlModel, rngs=nnx.Rngs(0))
    rng = np.random.RandomState(3)
    for sub in (model.neck, model.heads):
        randomize_norms(sub, rng)
    return model


def _port_model(dtype):
    with compute_dtype_scope(dtype):
        bb = Backbone("resnet18", pretrained=True, frozen_levels=1, device="cpu")
        return _build(bb, PAN, ObjectDetection, SihlModel)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The weights file, the JAX model on its tensors, and the port's models
    in f32 and f64 that read it."""
    features = jax_make_resnet_features("resnet18", rngs=nnx.Rngs(0))
    rng = np.random.RandomState(0)
    randomize_norms(features, rng)
    _damp_basic_blocks(features, rng)
    sd = jax_dump_state_dict(features, "resnet18")
    home = tmp_path_factory.mktemp("torch_home")
    write_weights(home, "resnet18", sd)
    jax_model = _jax_model(sd)
    models = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TORCH_HOME", str(home))
        for dtype in (torch.float32, torch.float64):
            model = _port_model(dtype)
            want = state_dict_from_flat(flat_state(jax_model), model)
            for k, v in model.backbone.state_dict().items():  # the file's tensors
                assert torch.equal(v, want[f"backbone.{k}"]), k
            model.load_state_dict(want, strict=True)
            models[dtype] = model
    return jax_model, models, sd


def _batch(seed: int):
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, SIZE, SIZE, 3) * rng.uniform(0.25, 1.0, (BATCH, 1, 1, 1))
    x = (x + rng.uniform(0.0, 0.75, (BATCH, 1, 1, 1))).astype(np.float32)
    classes, boxes = box_targets(rng, SIZE, NUM_CLASSES, (2, 3, 1, 4))
    return ((jnp.asarray(x), {"classes": jnp.asarray(classes), "boxes": jnp.asarray(boxes)}),
            (to_torch(x), {"classes": torch.from_numpy(classes).long(), "boxes": torch.from_numpy(boxes)}))


def test_forward_matches_jax(pair):
    jax_model, models, _ = pair
    (jx, _), (x, _) = _batch(1)
    jax_model = nnx.clone(jax_model)
    jax_model.eval()
    want = nnx.jit(lambda m, xx: m(xx))(jax_model, jx)[0]
    with torch.no_grad():
        got = copy.deepcopy(models[torch.float32]).eval()(x)[0]
    assert models[torch.float32].backbone.normalize is not None
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def jax_step(pair):
    """JAX's f64 training step on the ``STEP_SEED`` batch, jitted once (the
    JAX ``Trainer``'s ``_train_step``, its update included).  Returns loss,
    metrics, gradients (a port state dict), the state after the update and
    the step's learning rate."""
    jax_model, models, sd = pair
    (jx, jt), _ = _batch(STEP_SEED)
    with jax_f64():
        model = _jax_model(sd)
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
    _, models, _ = pair
    want_loss, want_metrics, want_grads, jax_state, _ = jax_step
    _, (x, t) = _batch(STEP_SEED)
    model = copy.deepcopy(models[dtype]).train()
    if dtype == torch.float64:
        assert _ciou_kink_margin(copy.deepcopy(model), x, t) > 1e-5
    loss, metrics = _losses(model, x.to(dtype), [t])
    loss.backward()

    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-4)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(want_metrics[k], rel=1e-4, abs=1e-6), k
    largest = {}
    for name, g in want_grads.items():
        largest[name.split(".")[0]] = max(largest.get(name.split(".")[0], 0.0), float(g.norm()))
    for name, p in model.named_parameters():
        if name.startswith("backbone.features.stem."):
            assert p.grad is None and not want_grads[name].any(), name
            continue
        if _zero_in_exact_arithmetic(name, want_grads, largest):
            assert float(p.grad.norm()) <= 1e-6 * largest[name.split(".")[0]], name
            continue
        err = _relative_error(p.grad, want_grads[name])
        assert err <= (F64_LIMIT if dtype == torch.float64 else GRADIENT_LIMITS[name.split(".")[0]]), (name, err)

    want_state = state_dict_from_flat(jax_state, model)
    for name, buf in model.named_buffers():
        if name in want_state:
            np.testing.assert_allclose(buf.double().numpy(), want_state[name].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)


def test_trainer_step_metrics_and_update_match_jax(pair, jax_step):
    """The port's f32 ``Trainer.training_step`` on the ``STEP_SEED`` batch
    against ``jax_step``: every metric within 1e-4, the update."""
    _, models, _ = pair
    want_loss, want_metrics, _, jax_state, want_lr = jax_step
    _, (x, t) = _batch(STEP_SEED)
    model = copy.deepcopy(models[torch.float32])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = Trainer(model, **OPTIMIZER).training_step(x, t)
    want = {**want_metrics, "trainer/loss": want_loss, "trainer/learning_rate": want_lr}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert float(v) == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    assert_update_matches(model, before, jax_state, OPTIMIZER["optimizer_kwargs"]["lr"])
