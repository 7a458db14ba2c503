"""The port's serving slice end to end against the JAX package: backbone,
FPN and ObjectDetection in one SihlModel, weights carried by the bridge."""

import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.heads import ObjectDetection as JaxObjectDetection
from sihl_tpu.layers import FPN as JaxFPN
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import ObjectDetection
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.policy import default_device, set_default_device

from torch_parity import assert_detections_match, flat_state, randomize_norms, to_torch


@contextmanager
def default_device_scope(device):
    prev = default_device()
    set_default_device(device)
    try:
        yield
    finally:
        set_default_device(prev)


def _build(backbone, fpn, head, model, **init):
    bb = backbone("resnet26", top_level=5, **init)
    neck = fpn(bb.out_channels, 32, bottom_level=3, top_level=7, **init)
    od = head(neck.out_channels, 5, bottom_level=3, top_level=7, num_channels=32, **init)
    return model(bb, neck, [od])


def test_slice_matches_jax():
    rng = np.random.RandomState(0)
    jax_model = _build(JaxBackbone, JaxFPN, JaxObjectDetection, JaxSihlModel, rngs=nnx.Rngs(0))
    randomize_norms(jax_model, rng)
    jax_model.heads[0].loc_head.linears[-1].bias[...] = jnp.zeros((1,), jnp.float32)
    jax_model.eval()
    model = _build(Backbone, FPN, ObjectDetection, SihlModel)
    missing, unexpected = model.load_state_dict(
        state_dict_from_flat(flat_state(jax_model)), strict=True
    )
    assert not missing and not unexpected
    model.eval()

    x = rng.rand(2, 128, 128, 3).astype(np.float32)
    graphdef, state = nnx.split(jax_model)
    (want,) = nnx.merge(graphdef, state)(jnp.asarray(x))
    with torch.no_grad():
        (got,) = model(to_torch(x))
    assert 0 < int(np.asarray(want[0]).sum()) < 200
    assert_detections_match(got, want, box_atol=1e-3)


def test_building_without_a_card_raises():
    """The port builds on the card unless asked for the CPU, and never moves
    to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with default_device_scope("cuda"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Backbone("resnet18")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ObjectDetection([3, 8, 8, 8, 8, 8], 5, num_channels=8)
    assert Backbone("resnet18", device="cpu").features.stem.conv.weight.device.type == "cpu"


def test_import_loads_no_jax_and_no_triton():
    code = (
        "import sys, sihl_tpu_torch, sihl_tpu_torch.heads, sihl_tpu_torch.layers, "
        "sihl_tpu_torch.convert, sihl_tpu_torch.training, sihl_tpu_torch.ops.topk, "
        "sihl_tpu_torch.ops.boxes, sihl_tpu_torch.ops.losses; "
        "print(sorted(m for m in ('jax', 'flax', 'triton') if m in sys.modules))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=120,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert out.stdout.strip() == "[]", out
