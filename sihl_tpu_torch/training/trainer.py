"""Training step (counterpart of ``sihl_tpu/training/trainer.py``).

:class:`Trainer` runs one optimisation step per :meth:`Trainer.training_step`
on the model's device: the features once, each head's ``training_step``
with its targets, the sum of the head losses, the backward, optax's global
norm clip and the optimizer's update.  It returns the metrics the JAX
trainer returns, under the same keys, as tensors on the device: nothing in
the step waits for the device.  The multi-step dispatch
(``training_steps_scanned``), validation, EMA and checkpoints come later
(ROADMAP.md, M7 and M9).
"""

from typing import Any, Dict, Optional

import torch

from sihl_tpu_torch.model import SihlModel
from sihl_tpu_torch.training.optim import clip_by_global_norm_, make_optimizer


def _call_step(head, feats, target):
    if isinstance(target, dict):
        return head.training_step(feats, **target)
    if isinstance(target, (tuple, list)):
        return head.training_step(feats, *target)
    return head.training_step(feats, *(() if target is None else (target,)))


def _losses(model: SihlModel, x: torch.Tensor, targets):
    """The sum of the heads' losses, and every head's metrics under
    ``head{i}/train/...``."""
    feats = model.extract_features(x)
    losses, metrics = [], {}
    for idx, (head, target) in enumerate(zip(model.heads, targets)):
        loss, head_metrics = _call_step(head, feats, target)
        losses.append(loss)
        metrics[f"head{idx}/train/loss"] = loss
        for k, v in head_metrics.items():
            metrics[f"head{idx}/train/{k}"] = v
    return torch.stack(losses).sum(), metrics


class Trainer:
    def __init__(
        self,
        model: SihlModel,
        optimizer: str = "adam",
        optimizer_kwargs: Optional[Dict[str, Any]] = None,
        scheduler: Optional[str] = None,
        scheduler_kwargs: Optional[Dict[str, Any]] = None,
        grad_clip: Optional[float] = None,
    ):
        self.model = model
        self.optimizer, self.schedule = make_optimizer(
            model, optimizer, optimizer_kwargs, scheduler, scheduler_kwargs
        )
        self.grad_clip = grad_clip
        self.step = 0

    def _apply_frozen_bn(self) -> None:
        backbone = self.model.backbone
        if getattr(backbone, "freeze_batchnorms", False) and getattr(backbone, "frozen_levels", 0):
            backbone._set_frozen_bn_eval()

    def training_step(self, x: torch.Tensor, targets=None) -> Dict[str, Any]:
        """One optimisation step on a batch of (B, C, H, W) images; ``targets``
        is one head's targets (a dict splats as keyword arguments) or a list
        of them, one per head.  Returns the step's metrics."""
        if not isinstance(targets, list):
            targets = [targets]
        self.model.train()
        self._apply_frozen_bn()
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = _losses(self.model, x, targets)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["trainer/loss"] = loss.detach()
        metrics["trainer/learning_rate"] = self.apply_gradients()
        return metrics

    def apply_gradients(self) -> float:
        """Clip the gradients the parameters hold and update the parameters
        at this step's learning rate, which it returns; counts the step."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
        if self.grad_clip:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip)
        self.optimizer.step()
        self.step += 1
        return lr
