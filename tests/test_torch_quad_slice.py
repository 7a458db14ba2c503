"""One whole quadrilateral-detection step of the port against the JAX
package's (CPU): resnet18 (BasicBlock, level 1 frozen, so the stem runs
``stem_conv_stats``'s plain version) → BiFPN 16 wide over levels 3-5 with 2
layers → QuadrilateralDetection with 5 classes, on 2 images at 64 px, with
the weights carried over by ``state_dict_from_flat`` (strict):

* through ``_losses``: metrics within 1e-4 relative; gradients of the heads
  and the neck within relative L2 1e-3 and of the backbone within 5e-3, as
  ``tests/test_torch_train_slice.py`` holds them.  A gradient that is zero
  in exact arithmetic (below 1e-6 of the largest of its part on JAX's side)
  is held below that bound instead;
* through ``Trainer``: every metric of the step within 1e-4.

Targets as in ``tests/test_torch_quadrilateral_detection.py``: no two
anchors tie for a target.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.heads import QuadrilateralDetection as JaxQuadrilateralDetection
from sihl_tpu.layers import BiFPN as JaxBiFPN
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import QuadrilateralDetection
from sihl_tpu_torch.layers import BiFPN
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

from test_torch_quadrilateral_detection import BATCH, T, quad_targets
from torch_parity import flat_state, randomize_norms, to_torch

OPTIMIZER = dict(
    optimizer="adamw",
    optimizer_kwargs={"lr": 1e-4, "weight_decay": 1e-4, "backbone_lr_factor": 0.1},
    grad_clip=0.1,
)


def _relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - want.double())) / max(
        float(torch.linalg.vector_norm(want.double())), 1e-12
    )


def _build_model(backbone, bifpn, head, model, **init):
    bb = backbone("resnet18", top_level=5, **init)
    bb.set_frozen_levels(1)
    neck = bifpn(bb.out_channels, 16, bottom_level=3, top_level=5, num_layers=2, **init)
    quad = head(neck.out_channels, 5, num_channels=32, num_layers=1, max_targets=T, **init)
    return model(bb, neck, [quad])


@pytest.fixture(scope="module")
def model_pair():
    rng = np.random.RandomState(1)
    jax_model = _build_model(JaxBackbone, JaxBiFPN, JaxQuadrilateralDetection, JaxSihlModel, rngs=nnx.Rngs(0))
    randomize_norms(jax_model, rng)
    model = _build_model(Backbone, BiFPN, QuadrilateralDetection, SihlModel)
    model.load_state_dict(state_dict_from_flat(flat_state(jax_model)), strict=True)
    x = rng.rand(BATCH, 64, 64, 3).astype(np.float32)
    classes, quads = quad_targets(rng, 64, 5, (2, 4))
    jax_batch = (jnp.asarray(x), {"classes": jnp.asarray(classes), "quads": jnp.asarray(quads)})
    batch = (to_torch(x), {"classes": torch.from_numpy(classes).long(), "quads": torch.from_numpy(quads)})
    return jax_model, model, jax_batch, batch


def test_model_step_gradients_match_jax(model_pair):
    jax_model, model, (jx, jt), (x, t) = model_pair
    jax_model = nnx.clone(jax_model)
    jax_model.train()

    @nnx.jit
    def value_and_grad(m, xx, tt):
        return nnx.value_and_grad(lambda mm: jax_losses(mm, xx, [tt]), has_aux=True)(m)

    (_, want_metrics), jax_grads = value_and_grad(jax_model, jx, jt)
    want = state_dict_from_flat({".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(jax_grads)})
    model = copy.deepcopy(model).train()
    assert isinstance(model.heads[0], QuadrilateralDetection)
    loss, metrics = _losses(model, x, [t])
    loss.backward()
    assert float(want_metrics["head0/train/quad_loss"]) > 0
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(float(want_metrics[k]), rel=1e-4, abs=1e-7), k
    limits = {"heads": 1e-3, "neck": 1e-3, "backbone": 5e-3}
    largest = {}
    for name, g in want.items():
        part = name.split(".")[0]
        largest[part] = max(largest.get(part, 0.0), float(g.norm()))
    for name, p in model.named_parameters():
        if name.startswith("backbone.features.stem."):
            assert p.grad is None and not want[name].any(), name
            continue
        part = name.split(".")[0]
        if float(want[name].norm()) <= 1e-6 * largest[part]:
            # zero in exact arithmetic: the last BiFPN layer's BatchNorm
            # outputs feed only the head's train-mode BatchNorms, whose mean
            # removal sums their cotangent to zero, so its bias gradient is
            # rounding on both sides
            assert float(p.grad.norm()) <= 1e-6 * largest[part], name
            continue
        err = _relative_error(p.grad, want[name])
        assert err <= limits[part], (name, err)


def test_model_trainer_step_matches_jax(model_pair):
    jax_model, model, (jx, jt), (x, t) = model_pair
    want = JaxTrainer(nnx.clone(jax_model), **OPTIMIZER).training_step(jx, jt)
    got = Trainer(copy.deepcopy(model), **OPTIMIZER).training_step(x, t)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert float(v) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-7), k
