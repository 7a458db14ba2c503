"""One training step of the port's ``resnetv2_50`` against the JAX
package's f64 step (CPU).

``resnetv2_50`` with level 1 frozen (its stem through ``stem_conv_stats``'s
plain version) under a MulticlassClassification head (5 classes, 32
channels, level 5), 4 images at 128 px, weights carried by
``state_dict_from_flat`` (strict), every branch's ``conv3`` damped
(``damp_preact_branches``).  Through ``_losses``: the port's f64 and f32
steps against JAX's jitted f64 step (``jax_f64``), the loss within 1e-4
relative, the port's f64 gradients within 1e-5 and its f32 gradients
within the relative L2 limit of their part (heads 1e-3, backbone 5e-3, as
``tests/test_torch_classification_slice.py`` holds them), the running
statistics within 1e-4 and no gradient for the stem.  At 64 px level 5
holds 16 samples a channel, and the port's f32 step read 7.5e-3 from f64
on one norm of layer 2 (summation order in train-mode BatchNorm); at
128 px the largest is 2.2e-3.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.heads import MulticlassClassification as JaxMulticlassClassification
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import MulticlassClassification
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training.trainer import _losses

from test_torch_classification_slice import _relative_error
from test_torch_hybrid_slice import jax_f64
from test_torch_resnetv2 import damp_preact_branches
from torch_parity import flat_state, randomize_norms, to_torch

BATCH, SIZE, NUM_CLASSES = 4, 128, 5
GRADIENT_LIMITS = {"heads": 1e-3, "backbone": 5e-3}
F64_LIMIT = 1e-5


def _build(backbone, multiclass, model, **init):
    bb = backbone("resnetv2_50", top_level=5, **init)
    bb.set_frozen_levels(1)
    return model(bb, None, [multiclass(bb.out_channels, NUM_CLASSES, num_channels=32, **init)])


def _jax_model():
    model = nnx.jit(lambda: _build(JaxBackbone, JaxMulticlassClassification, JaxSihlModel, rngs=nnx.Rngs(0)))()
    rng = np.random.RandomState(0)
    randomize_norms(model, rng)
    damp_preact_branches(model, rng)
    return model


@pytest.fixture(scope="module")
def pair():
    jax_model = _jax_model()
    models = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            models[dtype] = _build(Backbone, MulticlassClassification, SihlModel)
        models[dtype].load_state_dict(state_dict_from_flat(flat_state(jax_model), models[dtype]), strict=True)
    return jax_model, models


def _batch(seed: int):
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    classes = rng.randint(0, NUM_CLASSES, BATCH)
    return (jnp.asarray(x), [jnp.asarray(classes)]), (to_torch(x), [torch.from_numpy(classes)])


@pytest.fixture(scope="module")
def jax_step(pair):
    """JAX's f64 step (loss, gradients as a port state dict, the state after
    the forward), jitted once."""
    jax_model, models = pair
    (jx, jt), _ = _batch(2)
    with jax_f64():
        model = nnx.jit(lambda: _build(JaxBackbone, JaxMulticlassClassification, JaxSihlModel,
                                       rngs=nnx.Rngs(0)))()
        nnx.update(model, jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64) if v.dtype == jnp.float32 else v, nnx.state(jax_model)))
        model.train()

        @nnx.jit
        def value_and_grad(m, xx, tt):
            return nnx.value_and_grad(lambda mm: jax_losses(mm, xx, tt), has_aux=True)(m)

        (loss, _), grads = value_and_grad(model, jx.astype(jnp.float64), jt)
        grads = state_dict_from_flat(
            {".".join(map(str, p)): np.asarray(v[...], np.float64) for p, v in nnx.to_flat_state(grads)},
            models[torch.float32])
        return float(loss), grads, flat_state(model)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_resnetv2_train_step_matches_jax_f64(pair, jax_step, dtype):
    _, models = pair
    want_loss, want_grads, jax_state = jax_step
    _, (x, t) = _batch(2)
    model = copy.deepcopy(models[dtype]).train()
    loss, _ = _losses(model, x.to(dtype), t)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-4)
    for name, p in model.named_parameters():
        if name.startswith("backbone.features.stem."):
            assert p.grad is None and not want_grads[name].any(), name
            continue
        err = _relative_error(p.grad, want_grads[name])
        limit = F64_LIMIT if dtype == torch.float64 else GRADIENT_LIMITS[name.split(".")[0]]
        assert err <= limit, (name, err)
    want_state = state_dict_from_flat(jax_state, model)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.double().numpy(), want_state[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
