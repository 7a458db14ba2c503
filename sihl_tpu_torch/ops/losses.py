"""Loss functions, computed in f32 (counterpart of ``sihl_tpu/ops/losses.py``):
every loss upcasts its inputs explicitly, as the reference computes its
losses with autocast off (f64 inputs stay f64)."""

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from sihl_tpu_torch.ops.image import avg_pool2d
from sihl_tpu_torch.policy import upcast

EPS = 1e-5


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE on probabilities clipped to [EPS, 1 - EPS]."""
    probs, targets = upcast(probs), upcast(targets)
    p = torch.clamp(probs, EPS, 1.0 - EPS)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))


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
    with no host sync and no branch on its value.  A target outside
    ``[0, num_classes)`` that is not ignored gives a zero row, as
    ``jax.nn.one_hot`` does."""
    logits = upcast(logits)
    num_classes = logits.shape[dim]
    log_probs = F.log_softmax(logits, dim=dim)
    valid = torch.ones_like(targets, dtype=torch.bool) if ignore_index is None else targets != ignore_index
    safe_targets = torch.where(valid, targets, 0).long()
    # jax.nn.one_hot's comparison with the class indices: no host read of
    # the targets (F.one_hot checks their range with one on the CPU), and an
    # out-of-range target gives a row of zeros, as in JAX
    classes = torch.arange(num_classes, device=targets.device)
    one_hot = (safe_targets[..., None] == classes).to(logits.dtype).movedim(-1, dim)
    static_zero = isinstance(label_smoothing, (int, float)) and label_smoothing == 0.0
    if not static_zero:
        one_hot = one_hot * (1.0 - label_smoothing) + label_smoothing / num_classes
    loss = -(one_hot * log_probs).sum(dim=dim)
    return torch.where(valid, loss, 0.0)


def focal_loss(probs: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss on probabilities (reference ``utils/__init__.py:203-213``)."""
    probs, targets = upcast(probs), upcast(targets)
    ce = binary_cross_entropy(probs, targets)
    p_t = probs * targets + (1.0 - probs) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return alpha_t * ce * (1.0 - p_t) ** gamma


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


def tversky_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.5, beta: float = 0.5,
                 ignore_index: int = -100) -> torch.Tensor:
    """Tversky loss of dense logits (B, C, H, W) against class maps (B, H, W):
    one minus the batch mean of each image's and class's (TP + EPS) /
    (TP + alpha FP + beta FN + EPS); pixels at ``ignore_index`` count nowhere,
    and a class outside [0, C) has an all-zero one-hot row, as
    ``jax.nn.one_hot`` gives it."""
    logits = upcast(logits)
    valid = (targets != ignore_index)[:, None].to(logits.dtype)
    classes = torch.arange(logits.shape[1], device=logits.device)[None, :, None, None]
    one_hot = (torch.where(targets == ignore_index, 0, targets)[:, None] == classes).to(logits.dtype) * valid
    probs = torch.softmax(logits, dim=1) * valid
    tp = (probs * one_hot).sum(dim=(2, 3))
    fn = ((1.0 - probs) * one_hot).sum(dim=(2, 3))
    fp = (probs * (1.0 - one_hot)).sum(dim=(2, 3))
    return 1.0 - ((tp + EPS) / (tp + alpha * fp + beta * fn + EPS)).mean()


def ssim_loss(pred: torch.Tensor, gt: torch.Tensor, window_size: int = 11, size_average: bool = True) -> torch.Tensor:
    """Structural-similarity loss of (B, C, H, W) images (reference
    ``utils:184-200``): |1 - SSIM| with means over a ``window_size`` box,
    zero padding counted."""
    pred, gt = upcast(pred), upcast(gt)
    pad = window_size // 2
    c1, c2 = 0.01**2, 0.03**2

    def pool(x):
        return avg_pool2d(x, window_size, stride=1, padding=pad)

    mu1, mu2 = pool(pred), pool(gt)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = pool(pred * pred) - mu1_sq
    sigma2_sq = pool(gt * gt) - mu2_sq
    sigma12 = pool(pred * gt) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    reduced = ssim_map.mean() if size_average else ssim_map.sum()
    return (1.0 - reduced).abs()
