"""The instance slice's gradient split (``sihl_tpu_torch/tools/split_instance_grads.py``)
and the train slice's full-f32 guard (``chip_smoke.full_f32``), on the CPU.

On the CPU the "card" model is an f32 model on the CPU, so every piece of
the split runs through the plain versions: a small instance model (resnet18,
FPN 32 wide, 64 px images) must come out within ``GRADIENT_LIMITS`` with
the same matching choices on both sides.
"""

import numpy as np
import torch

import chip_smoke
import torch_parity  # noqa: F401  (the CPU as the default device, one thread per worker)
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.heads import InstanceSegmentation
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.tools import split_instance_grads


def _build(generator, device=None):
    backbone = Backbone("resnet18", top_level=5, generator=generator, device=device)
    neck = FPN(backbone.out_channels, 32, bottom_level=3, top_level=5, generator=generator, device=device)
    head = InstanceSegmentation(neck.out_channels, 5, num_channels=32, max_targets=4, max_mask_positives=16,
                                generator=generator, device=device)
    return SihlModel(backbone, neck, [head])


def test_split_instance_grads_runs_and_agrees_on_cpu(capsys):
    gen = torch.Generator().manual_seed(0)
    model = _build(gen, device="cpu")
    chip_smoke.randomize_norms_and_biases(model, gen)
    model.eval()
    model, cpu_models = chip_smoke.train_slice_models(model, gen, _build)
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.rand(2, 3, 64, 64).astype(np.float32))
    classes = torch.tensor([[1, 2, -1, -1], [0, -1, -1, -1]])
    masks = torch.zeros(2, 4, 32, 32)
    masks[0, 0, 2:15, 5:20] = 1
    masks[0, 1, 15:30, 10:25] = 1
    masks[1, 0, 5:25, 5:25] = 1
    assert split_instance_grads.split(model, cpu_models, images, {"classes": classes, "masks": masks})
    out = capsys.readouterr().out
    assert "the card's matching makes the same choices as the CPU's" in out
    assert "cuDNN off: the trunk's gradients" in out


def test_full_f32_turns_tf32_off_and_restores_the_callers_flags():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
        with chip_smoke.full_f32():
            assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
