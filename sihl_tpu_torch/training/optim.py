"""Optimizer and schedule factory (counterpart of ``sihl_tpu/training/optim.py``).

The JAX package builds one ``optax.multi_transform`` over five labels; here
the same labels become parameter groups of one torch optimizer:

* ``backbone_lr_factor``: backbone parameters get ``lr * factor``;
* no weight decay on biases, norm scales (the ``weight`` of a BatchNorm or
  LayerNorm, flax's ``scale``) and embeddings;
* frozen parameters (``PyramidBackbone.is_frozen_param``) are in no group:
  they get neither update nor decay;
* "adam" or "adamw" with a weight decay is decoupled AdamW (optax.adamw),
  without one plain Adam; "sgd" is optax.sgd (:class:`SGD`: ``momentum``,
  ``nesterov``, and no weight decay, since the JAX package passes none to
  it); "lamb" is optax.lamb (:class:`LAMB`);
* :func:`clip_by_global_norm_` is optax's clip, ``g / norm * max`` where
  ``norm >= max`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
* schedules are functions of the step count, evaluated by the trainer
  before each step: constant, multistep, cosine, one-cycle or a callable,
  and a linear warmup before any of them.  They compute in Python floats
  where optax computes in f32: a rate agrees with optax's within about
  2e-6 relative, except near the end of a long cosine, where optax's f32
  ``1 + cos`` cancels.

On a CUDA model every optimizer keeps its state and step count on the card
and reads each group's learning rate from a 0-dim f32 tensor there
(AdamW with ``capturable=True``), which the trainer writes before each step:
nothing in an update waits for the host, so a CUDA graph can hold it.  On
the CPU the learning rates are Python floats and AdamW is torch's default.
"""

import math
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
    elif scheduler == "cosine":  # optax.cosine_decay_schedule
        decay_steps = kwargs.pop("T_max", None) or kwargs.pop("decay_steps")
        alpha = kwargs.pop("eta_min", 0.0) / max(learning_rate, 1e-12)

        def main(step: int) -> float:
            cosine = 0.5 * (1 + math.cos(math.pi * min(step, decay_steps) / decay_steps))
            return learning_rate * ((1 - alpha) * cosine + alpha)
    elif scheduler == "onecycle":  # optax.cosine_onecycle_schedule
        total_steps = kwargs.pop("total_steps")
        max_lr = kwargs.pop("max_lr", learning_rate)
        pct_start = kwargs.pop("pct_start", 0.3)
        div_factor = kwargs.pop("div_factor", 25.0)
        final_div_factor = kwargs.pop("final_div_factor", 1e4)
        # optax's piecewise cosine interpolation between the running
        # products of (initial value, scales) at its boundaries
        bounds = (0, int(pct_start * total_steps), int(total_steps))
        values = [max_lr / div_factor]
        values.append(values[0] * div_factor)
        values.append(values[1] * (1.0 / (div_factor * final_div_factor)))

        def main(step: int) -> float:
            for i in range(2):
                if bounds[i] <= step < bounds[i + 1]:
                    pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                    return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (math.cos(math.pi * pct) + 1)
            return values[2]
    elif callable(scheduler):
        def main(step: int) -> float:
            return float(scheduler(step))
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")

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
    the trainer sets ``lr = schedule(step) * lr_scale`` before each step, a
    float on the CPU and a 0-dim tensor's value on the card."""
    kwargs = dict(optimizer_kwargs or {})
    lr = kwargs.pop("lr", 1e-3)
    backbone_lr_factor = kwargs.pop("backbone_lr_factor", 1.0)
    weight_decay = kwargs.pop("weight_decay", None)
    schedule = make_schedule(lr, scheduler, scheduler_kwargs)

    labels = param_labels(model)
    named = dict(model.named_parameters())
    on_card = next(iter(named.values())).is_cuda
    groups = []
    for label in LABELS:
        params = [named[n] for n, lab in labels.items() if lab == label]
        if params:
            lr_scale = backbone_lr_factor if label.startswith("backbone") else 1.0
            lr0 = schedule(0) * lr_scale
            groups.append(dict(
                params=params, label=label,
                lr=torch.full((), lr0, dtype=torch.float32, device=params[0].device) if on_card else lr0,
                weight_decay=0.0 if label.endswith("no_decay") else (weight_decay or 0.0),
                lr_scale=lr_scale,
            ))
    if optimizer in ("adam", "adamw"):
        # decoupled decay, as optax.adamw; groups without decay are plain Adam
        if on_card:
            kwargs = dict(kwargs, capturable=True, foreach=True)
        return torch.optim.AdamW(groups, **kwargs), schedule
    if optimizer == "sgd":
        return SGD(groups, **kwargs), schedule
    if optimizer == "lamb":
        return LAMB(groups, **kwargs), schedule
    raise ValueError(f"unknown optimizer {optimizer!r}")


class SGD(torch.optim.Optimizer):
    """optax.sgd: with ``momentum`` the trace ``m = g + momentum * m`` (from
    zeros) and the update ``-lr * m``, or ``-lr * (g + momentum * m)`` with
    ``nesterov``; without it ``-lr * g``.  No weight decay: the JAX package
    gives SGD none, so a group's ``weight_decay`` is not read.  (torch's SGD
    with ``dampening=0`` computes the same, but reads a tensor learning
    rate on the host.)"""

    def __init__(self, params, momentum: Optional[float] = None, nesterov: bool = False):
        super().__init__(params, dict(momentum=momentum, nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            updates, momentum = grads, group["momentum"]
            if momentum:
                traces = []
                for p in params:
                    if "momentum_buffer" not in self.state[p]:
                        self.state[p]["momentum_buffer"] = torch.zeros_like(p)
                    traces.append(self.state[p]["momentum_buffer"])
                torch._foreach_mul_(traces, momentum)
                torch._foreach_add_(traces, grads)
                updates = torch._foreach_add(grads, traces, alpha=momentum) if group["nesterov"] else traces
            torch._foreach_sub_(params, torch._foreach_mul(updates, group["lr"]))  # lr: a float or a tensor


class LAMB(torch.optim.Optimizer):
    """optax.lamb: Adam's bias-corrected moments ``u = m^ / (sqrt(v^ +
    eps_root) + eps)``, plus ``weight_decay * p`` in a group that decays,
    scaled by the trust ratio ``|p| / |u|`` of each parameter tensor (1
    where either norm is 0), then by ``-lr``.  The step count ``count`` is
    a 0-dim f32 tensor on the parameter's device, so the bias corrections
    ``1 - b ** count`` are computed there in f32, as optax computes them."""

    def __init__(self, params, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6, eps_root: float = 0.0):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=0.0))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["b1"], group["b2"]
            for p in params:
                if not self.state[p]:
                    self.state[p].update(count=torch.zeros((), dtype=torch.float32, device=p.device),
                                         exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
            states = [self.state[p] for p in params]
            grads = [p.grad for p in params]
            counts = [s["count"] for s in states]
            mu, nu = [s["exp_avg"] for s in states], [s["exp_avg_sq"] for s in states]
            torch._foreach_add_(counts, 1.0)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            corr1, corr2 = torch._foreach_pow(b1, counts), torch._foreach_pow(b2, counts)  # b ** count
            for corr in (corr1, corr2):  # 1 - b ** count
                torch._foreach_neg_(corr)
                torch._foreach_add_(corr, 1.0)
            denom = torch._foreach_div(nu, corr2)
            torch._foreach_add_(denom, group["eps_root"])
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mu, corr1)
            torch._foreach_div_(updates, denom)
            if group["weight_decay"]:
                torch._foreach_add_(updates, params, alpha=group["weight_decay"])
            param_norm = torch.stack(torch._foreach_norm(params))
            update_norm = torch.stack(torch._foreach_norm(updates))
            trust = torch.where((param_norm == 0) | (update_norm == 0), 1.0, param_norm / update_norm)
            torch._foreach_mul_(updates, list(trust.unbind()))
            torch._foreach_sub_(params, torch._foreach_mul(updates, group["lr"]))  # lr: a float or a tensor


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
