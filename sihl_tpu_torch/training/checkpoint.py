"""Checkpoints of the full train state (counterpart of
``sihl_tpu/training/checkpoint.py``, which uses orbax).

``Trainer.state_dict()`` — the model's parameters and BatchNorm buffers,
the optimizer's state, the step and the EMA shadow — goes to one file
through ``torch.save`` and comes back through ``torch.load(...,
weights_only=True)`` to the host, from where ``load_state_dict`` copies it
into the live tensors in place: onto the model's device, and the
optimizer's state where the optimizer keeps it (Adam's step counts on the
host).
"""

import os

import torch


def save_checkpoint(trainer, path: str) -> None:
    torch.save(trainer.state_dict(), os.path.abspath(path))


def restore_checkpoint(trainer, path: str) -> None:
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    trainer.load_state_dict(state)
