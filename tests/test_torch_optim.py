"""Parity of the port's optimizer with the JAX trainer's optax chain: the
same gradients, fed to both for 3 steps, give the same parameters (f32,
to 1e-6 absolute and 1e-5 relative: Adam's arithmetic in another order).
Updates are compared, not gradients, since AdamW's first step hides a
gradient's scale; the parameters start random so that weight decay shows
on every kind of parameter.  Every optimizer (AdamW, Adam, SGD plain, with
momentum and Nesterov, LAMB) and every schedule (multistep, cosine and
one-cycle after a warmup, a callable) has a case; the learning rate of each
step is held to optax's f32 value at 1e-5 relative.  Both models are built
once for the module and take the same random parameters in each case."""

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
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu.training.optim import _path_keys
from sihl_tpu.training.optim import make_schedule as jax_make_schedule
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import ObjectDetection
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.optim import make_schedule, param_labels

from torch_parity import flat_state, numpy_filled

CASES = {
    # bench.py's optimizer, with a clip that binds
    "adamw_clipped": dict(
        optimizer="adamw",
        optimizer_kwargs={"lr": 1e-2, "weight_decay": 0.1, "backbone_lr_factor": 0.1},
        grad_clip=0.1,
    ),
    # plain Adam, a clip that does not bind, warmup then multistep
    "adam_multistep": dict(
        optimizer="adam",
        optimizer_kwargs={"lr": 1e-2, "backbone_lr_factor": 0.5},
        grad_clip=1e6,
        scheduler="multistep",
        scheduler_kwargs={"milestones": [1], "gamma": 0.5, "warmup": 1},
    ),
    # SGD: the weight decay is given and, as in the JAX package, not applied
    "sgd": dict(optimizer="sgd", optimizer_kwargs={"lr": 1e-2, "weight_decay": 0.1, "backbone_lr_factor": 0.1}),
    "sgd_momentum_callable": dict(
        optimizer="sgd",
        optimizer_kwargs={"lr": 1e-2, "momentum": 0.9},
        scheduler=lambda step: 1e-2 * 0.5**step,
    ),
    "sgd_nesterov_cosine": dict(
        optimizer="sgd",
        optimizer_kwargs={"lr": 1e-2, "momentum": 0.9, "nesterov": True, "backbone_lr_factor": 0.5},
        scheduler="cosine",
        scheduler_kwargs={"T_max": 4, "eta_min": 1e-3, "warmup": 1},
    ),
    # LAMB with decay in the decay groups and a clip that binds, one-cycle
    "lamb_clipped_onecycle": dict(
        optimizer="lamb",
        optimizer_kwargs={"lr": 1e-2, "weight_decay": 0.1, "backbone_lr_factor": 0.1},
        grad_clip=0.1,
        scheduler="onecycle",
        scheduler_kwargs={"total_steps": 5, "max_lr": 2e-2, "warmup": 1},
    ),
}


def _build(backbone, fpn, head, model, **init):
    bb = backbone("resnet18", top_level=5, **init)
    bb.set_frozen_levels(1)
    neck = fpn(bb.out_channels, 16, bottom_level=3, top_level=5, **init)
    od = head(neck.out_channels, 3, bottom_level=3, top_level=5, num_channels=16, **init)
    return model(bb, neck, [od])


@pytest.fixture(scope="module")
def models():
    """The JAX and port models, built once, and random parameters for them
    (the JAX model from ``nnx.eval_shape``: every parameter is drawn here)."""
    rng = np.random.RandomState(0)
    jax_model = numpy_filled(nnx.eval_shape(
        lambda: _build(JaxBackbone, JaxFPN, JaxObjectDetection, JaxSihlModel, rngs=nnx.Rngs(0))), 0)
    params = jax.tree.map(lambda a: jnp.asarray(rng.uniform(-1, 1, a.shape), a.dtype), nnx.state(jax_model, nnx.Param))
    nnx.update(jax_model, params)
    model = _build(Backbone, FPN, ObjectDetection, SihlModel)
    state = state_dict_from_flat(flat_state(jax_model))
    return jax_model, params, model, state


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_steps_match_optax(models, case):
    kwargs = CASES[case]
    rng = np.random.RandomState(0)
    jax_model, params, model, state = models
    nnx.update(jax_model, params)
    model.load_state_dict(state, strict=True)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    jax_trainer = JaxTrainer(jax_model, **kwargs)
    jax_update = nnx.jit(lambda optimizer, module, grads: optimizer.update(module, grads))
    trainer = Trainer(model, **kwargs)
    names = [n for n, _ in model.named_parameters()]
    for step in range(3):
        grads = {n: rng.randn(*p.shape).astype(np.float32) for n, p in start.items()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        jax_grads = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(_to_jax(grads[_port_name(path, a)])), nnx.state(jax_model, nnx.Param)
        )
        jax_update(jax_trainer.optimizer, jax_model, jax_grads)
        lr = trainer.apply_gradients()
        assert lr == pytest.approx(float(jax_trainer.schedule(step)), rel=1e-5)  # optax in f32

    want = state_dict_from_flat(flat_state(jax_model))
    labels = param_labels(model)
    assert {labels[n] for n in names} == {
        "frozen", "backbone_decay", "backbone_no_decay", "rest_decay", "rest_no_decay"
    }
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, rtol=1e-5, err_msg=n)
        if labels[n] == "frozen":
            assert torch.equal(p.detach(), start[n]), n
        else:
            assert not torch.equal(p.detach(), start[n]), n


@pytest.mark.parametrize("scheduler, kwargs", [
    ("cosine", {"decay_steps": 7, "eta_min": 1e-4}),
    ("cosine", {"T_max": 5, "warmup": 3}),
    ("onecycle", {"total_steps": 12}),
    ("onecycle", {"total_steps": 10, "max_lr": 3e-2, "pct_start": 0.25, "div_factor": 10.0,
                  "final_div_factor": 100.0, "warmup": 2}),
], ids=["cosine", "cosine_warmup", "onecycle", "onecycle_custom_warmup"])
def test_schedules_match_optax_over_their_whole_run(scheduler, kwargs):
    """Every step of a schedule's run and past its end, against optax's
    f32 values."""
    want = jax_make_schedule(1e-2, scheduler, kwargs)
    got = make_schedule(1e-2, scheduler, kwargs)
    for step in range(16):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5, abs=1e-12), step


def _port_name(path, value) -> str:
    """The port's parameter name of the nnx parameter at ``path``."""
    (name,) = state_dict_from_flat({".".join(map(str, _path_keys(path))): np.asarray(value)})
    return name


def _to_jax(grad: np.ndarray) -> np.ndarray:
    """A port-layout gradient in the JAX parameter's layout."""
    if grad.ndim == 4:
        return grad.transpose(2, 3, 1, 0)
    return grad.T if grad.ndim == 2 else grad
