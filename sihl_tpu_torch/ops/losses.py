"""Loss functions, computed in f32 (counterpart of ``sihl_tpu/ops/losses.py``):
every loss upcasts its inputs explicitly, as the reference computes its
losses with autocast off (f64 inputs stay f64)."""

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from sihl_tpu_torch.policy import upcast


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE on logits."""
    logits, targets = upcast(logits), upcast(targets)
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    label_smoothing: Union[float, torch.Tensor] = 0.0,
    ignore_index: Optional[int] = None,
    dim: int = -1,
) -> torch.Tensor:
    """Elementwise categorical cross-entropy over integer targets, with no
    reduction; entries equal to ``ignore_index`` give 0 (torch
    ``F.cross_entropy(reduction="none")`` with optional label smoothing).

    Whether to smooth is decided from the argument's type, as the JAX
    package decides it: a Python 0 skips the blend, and any tensor takes it
    (a schedule computed on the device, such as the panoptic head's decay),
    with no host sync and no branch on its value."""
    logits = upcast(logits)
    num_classes = logits.shape[dim]
    log_probs = F.log_softmax(logits, dim=dim)
    valid = torch.ones_like(targets, dtype=torch.bool) if ignore_index is None else targets != ignore_index
    safe_targets = torch.where(valid, targets, 0).long()
    one_hot = F.one_hot(safe_targets, num_classes).to(logits.dtype).movedim(-1, dim)
    static_zero = isinstance(label_smoothing, (int, float)) and label_smoothing == 0.0
    if not static_zero:
        one_hot = one_hot * (1.0 - label_smoothing) + label_smoothing / num_classes
    loss = -(one_hot * log_probs).sum(dim=dim)
    return torch.where(valid, loss, 0.0)


def sigmoid_focal_loss(
    logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0
) -> torch.Tensor:
    """Elementwise focal loss on logits (torchvision ``sigmoid_focal_loss``
    semantics, no reduction); ``alpha < 0`` turns the class weighting off."""
    logits, targets = upcast(logits), upcast(targets)
    p = torch.sigmoid(logits)
    ce = binary_cross_entropy_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def log_cosh_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise log-cosh regression loss in its stable form,
    ``|x| + log1p(exp(-2|x|)) - log(2)`` for ``x = pred - target``."""
    x = upcast(pred) - upcast(target)
    return x.abs() + torch.log1p(torch.exp(-2.0 * x.abs())) - math.log(2.0)
