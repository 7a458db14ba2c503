"""The classification slice of the port against the JAX package's (CPU): one
trunk, three heads, as ``chip_smoke.py`` phases 23-27 run it at full size.

resnet18 with level 1 frozen (so the stem runs ``stem_conv_stats``'s plain
version) and no neck → MulticlassClassification (10 classes, label
smoothing 0.1), MultilabelClassification (8 labels) and Regression on [0,
100], each 32 channels wide with one layer at level 5; 4 images at 64 px,
weights carried by ``state_dict_from_flat`` (strict).  Every basic block's
last BatchNorm (``conv2.bn``) starts at a scale of U(0.01, 0.03), as
``torch_parity.damp_residual_branches`` does for bottlenecks: at full
scales the JAX package's f32 step reads up to 19% from the port's f64 step
on its worst backbone gradients (16% on a head's first conv), while the
port's f32 step stays within 1.2e-2 of it, so no limit between the two
f32 steps would test anything.  Damped, both are within 3e-5 of f64.

Compared: the forward of all three heads in eval mode (classes and label
orders exact, scores and values within 1e-5 relative); one training step
through ``_losses`` with the port in f64 and in f32 against JAX's f32 step
(the three losses and their sum within 1e-4 relative, every gradient
within the relative L2 limit of its part as ``tests/test_torch_train_slice.py``
holds them, the running statistics within 1e-4, no gradient for the frozen
stem); the metrics of one ``Trainer.training_step`` (bench.py's optimizer);
and one ``Trainer.validate`` over two batches (every metric within 1e-4
relative).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.heads import MulticlassClassification as JaxMulticlassClassification
from sihl_tpu.heads import MultilabelClassification as JaxMultilabelClassification
from sihl_tpu.heads import Regression as JaxRegression
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import MulticlassClassification, MultilabelClassification, Regression
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

from torch_parity import flat_state, randomize_norms, to_torch

BATCH, SIZE, NUM_CLASSES, NUM_LABELS = 4, 64, 10, 8
GRADIENT_LIMITS = {"heads": 1e-3, "backbone": 5e-3}
OPTIMIZER = dict(
    optimizer="adamw",
    optimizer_kwargs={"lr": 1e-4, "weight_decay": 1e-4, "backbone_lr_factor": 0.1},
    grad_clip=0.1,
)


def _build(backbone, multiclass, multilabel, regression, model, **init):
    bb = backbone("resnet18", top_level=5, **init)
    bb.set_frozen_levels(1)
    c = bb.out_channels
    heads = [
        multiclass(c, NUM_CLASSES, num_channels=32, label_smoothing=0.1, **init),
        multilabel(c, NUM_LABELS, num_channels=32, **init),
        regression(c, 0.0, 100.0, num_channels=32, **init),
    ]
    return model(bb, None, heads)


def _batch(seed: int):
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    classes = rng.randint(0, NUM_CLASSES, BATCH)
    labels = (rng.rand(BATCH, NUM_LABELS) > 0.5).astype(np.float32)
    values = (rng.rand(BATCH) * 100).astype(np.float32)
    jax_batch = (jnp.asarray(x), [jnp.asarray(classes), jnp.asarray(labels), jnp.asarray(values)])
    batch = (to_torch(x), [torch.from_numpy(classes), torch.from_numpy(labels), torch.from_numpy(values)])
    return jax_batch, batch


def _damp_basic_blocks(model, rng: np.random.RandomState) -> None:
    for path, sub in nnx.iter_graph(model):
        if isinstance(sub, nnx.BatchNorm) and tuple(path[-2:]) == ("conv2", "bn"):
            sub.scale[...] = jnp.asarray(rng.uniform(0.01, 0.03, sub.scale[...].shape), jnp.float32)


@pytest.fixture(scope="module")
def pair():
    jax_model = _build(JaxBackbone, JaxMulticlassClassification, JaxMultilabelClassification, JaxRegression,
                       JaxSihlModel, rngs=nnx.Rngs(0))
    rng = np.random.RandomState(0)
    randomize_norms(jax_model, rng)
    _damp_basic_blocks(jax_model, rng)
    models = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            models[dtype] = _build(Backbone, MulticlassClassification, MultilabelClassification, Regression,
                                   SihlModel)
        models[dtype].load_state_dict(state_dict_from_flat(flat_state(jax_model), models[dtype]), strict=True)
    return jax_model, models


def test_forward_matches_jax(pair):
    jax_model, models = pair
    (jx, _), (x, _) = _batch(1)
    jax_model = nnx.clone(jax_model)
    jax_model.eval()
    want = jax_model(jx)
    with torch.no_grad():
        got = copy.deepcopy(models[torch.float32]).eval()(x)
    (scores, classes), (ml_scores, ml_labels), values = got
    (w_scores, w_classes), (w_ml_scores, w_ml_labels), w_values = want
    assert scores.shape == classes.shape == values.shape == (BATCH,)
    assert ml_scores.shape == ml_labels.shape == (BATCH, NUM_LABELS)
    np.testing.assert_array_equal(classes.numpy(), np.asarray(w_classes))
    np.testing.assert_array_equal(ml_labels.numpy(), np.asarray(w_ml_labels))
    for g, w in ((scores, w_scores), (ml_scores, w_ml_scores), (values, w_values)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert ((values >= 0) & (values <= 100)).all()


def _relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - want.double())) / max(
        float(torch.linalg.vector_norm(want.double())), 1e-12
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_train_step_losses_gradients_and_stats_match_jax(pair, dtype):
    jax_model, models = pair
    (jx, jt), (x, t) = _batch(2)
    jax_model = nnx.clone(jax_model)
    jax_model.train()

    @nnx.jit
    def value_and_grad(m, xx, tt):
        return nnx.value_and_grad(lambda mm: jax_losses(mm, xx, tt), has_aux=True)(m)

    (want_loss, want_metrics), jax_grads = value_and_grad(jax_model, jx, jt)
    model = copy.deepcopy(models[dtype]).train()
    loss, metrics = _losses(model, x, t)
    loss.backward()

    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-4)
    assert sorted(metrics) == sorted(want_metrics) == [f"head{i}/train/loss" for i in range(3)]
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(float(want_metrics[k]), rel=1e-4), k

    want_grads = state_dict_from_flat(
        {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(jax_grads)}, model
    )
    for name, p in model.named_parameters():
        if name.startswith("backbone.features.stem."):
            assert p.grad is None and not want_grads[name].any(), name
            continue
        err = _relative_error(p.grad, want_grads[name])
        assert err <= GRADIENT_LIMITS[name.split(".")[0]], (name, err)

    want_state = state_dict_from_flat(flat_state(jax_model), model)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.double().numpy(), want_state[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_trainer_step_metrics_match_jax(pair):
    jax_model, models = pair
    (jx, jt), (x, t) = _batch(3)
    want = JaxTrainer(nnx.clone(jax_model), **OPTIMIZER).training_step(jx, jt)
    got = Trainer(copy.deepcopy(models[torch.float32]), **OPTIMIZER).training_step(x, t)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert float(v) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k


def test_validate_matches_jax(pair):
    jax_model, models = pair
    batches = [_batch(4), _batch(5)]
    want = JaxTrainer(nnx.clone(jax_model), **OPTIMIZER).validate([b[0] for b in batches])
    model = copy.deepcopy(models[torch.float32])
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    got = Trainer(model, **OPTIMIZER).validate([b[1] for b in batches])
    assert sorted(got) == sorted(want)
    assert {k.split("/")[0] for k in got} == {"head0", "head1", "head2"}
    for k, v in got.items():
        assert v == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k
    assert all(torch.equal(b, buffers[n]) for n, b in model.named_buffers())
