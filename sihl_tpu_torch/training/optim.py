"""Optimizer and schedule factory (counterpart of ``sihl_tpu/training/optim.py``).

The JAX package builds one ``optax.multi_transform`` over five labels; here
the same labels become parameter groups of one torch optimizer:

* ``backbone_lr_factor``: backbone parameters get ``lr * factor``;
* no weight decay on biases, norm scales (the ``weight`` of a BatchNorm or
  LayerNorm, flax's ``scale``) and embeddings;
* frozen parameters (``PyramidBackbone.is_frozen_param``) are in no group:
  they get neither update nor decay;
* "adam" or "adamw" with a weight decay is decoupled AdamW (optax.adamw),
  without one plain Adam;
* :func:`clip_by_global_norm_` is optax's clip, ``g / norm * max`` where
  ``norm >= max`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
* schedules are functions of the step count, evaluated by the trainer
  before each step: constant, multistep and a linear warmup before either.
"""

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import BatchNorm2d
from sihl_tpu_torch.layers.mlp import LayerNorm

_NORMS = (BatchNorm2d, LayerNorm)
LABELS = ("rest_decay", "rest_no_decay", "backbone_decay", "backbone_no_decay")


def make_schedule(
    learning_rate: float,
    scheduler: Optional[str] = None,
    scheduler_kwargs: Optional[Dict[str, Any]] = None,
) -> Callable[[int], float]:
    """The learning rate at each step count, as optax's schedules give it."""
    kwargs = dict(scheduler_kwargs or {})
    warmup = kwargs.pop("warmup", None)

    if scheduler is None or scheduler == "constant":
        def main(step: int) -> float:
            return learning_rate
    elif scheduler == "multistep":
        milestones = sorted({int(m) for m in kwargs.pop("milestones")})
        gamma = kwargs.pop("gamma", 0.1)

        def main(step: int) -> float:
            return learning_rate * gamma ** sum(step >= m for m in milestones)
    else:
        raise NotImplementedError(f"scheduler {scheduler!r} is not ported yet (ROADMAP.md, M9b)")

    if not warmup:
        return main

    def schedule(step: int) -> float:
        if step < warmup:  # linear from lr / 100 to lr
            return learning_rate * (0.01 + 0.99 * step / warmup)
        return main(step - warmup)

    return schedule


def param_labels(model: nn.Module) -> Dict[str, str]:
    """Each parameter's label by name: one of :data:`LABELS`, or "frozen"."""
    backbone = getattr(model, "backbone", None)
    labels = {}
    for module_name, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            name = f"{module_name}.{leaf}" if module_name else leaf
            path = name.split(".")
            if (
                backbone is not None and path[0] == "backbone" and len(path) > 2
                and path[1] == "features" and backbone.is_frozen_param(path[2:])
            ):
                labels[name] = "frozen"
                continue
            part = "backbone" if path[0] == "backbone" else "rest"
            no_decay = leaf in ("bias", "embedding") or (leaf == "weight" and isinstance(module, _NORMS))
            labels[name] = f"{part}_{'no_decay' if no_decay else 'decay'}"
    return labels


def make_optimizer(
    model: nn.Module,
    optimizer: str = "adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    scheduler: Optional[str] = None,
    scheduler_kwargs: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """(optimizer, schedule).  Each parameter group carries ``lr_scale``:
    the trainer sets ``lr = schedule(step) * lr_scale`` before each step."""
    kwargs = dict(optimizer_kwargs or {})
    lr = kwargs.pop("lr", 1e-3)
    backbone_lr_factor = kwargs.pop("backbone_lr_factor", 1.0)
    weight_decay = kwargs.pop("weight_decay", None)
    schedule = make_schedule(lr, scheduler, scheduler_kwargs)

    labels = param_labels(model)
    named = dict(model.named_parameters())
    groups = []
    for label in LABELS:
        params = [named[n] for n, lab in labels.items() if lab == label]
        if params:
            groups.append(dict(
                params=params, label=label, lr=schedule(0),
                weight_decay=0.0 if label.endswith("no_decay") else (weight_decay or 0.0),
                lr_scale=backbone_lr_factor if label.startswith("backbone") else 1.0,
            ))
    if optimizer in ("adam", "adamw"):
        # decoupled decay, as optax.adamw; groups without decay are plain Adam
        return torch.optim.AdamW(groups, **kwargs), schedule
    raise NotImplementedError(f"optimizer {optimizer!r} is not ported yet (ROADMAP.md, M9b)")


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: when the global L2 norm of the
    gradients exceeds ``max_norm``, every gradient becomes ``g / norm *
    max_norm``.  Returns the norm; no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm))
    return norm
