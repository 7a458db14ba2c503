"""On-device metric accumulators (counterpart of ``sihl_tpu/training/metrics.py``).

Each metric is an (init, update, compute) triple over a dict of f32 tensors
of sums on the model's device, as in the JAX package: ``*_update`` adds a
batch's sums without a host sync, ``*_compute`` reduces a state to its
metrics (0-d tensors), and :func:`tree_add` merges two states.  The counts
are f32 sums, as the JAX package keeps them: exact up to 2^24.

Scatter indices follow ``jnp.ndarray.at[...].add``: a negative index counts
from the end, and an index out of range adds nothing.

The cross-device reduction (``tree_psum``) waits for the multi-GPU path
(ROADMAP.md, M19).
"""

from typing import Dict, Optional

import torch

from sihl_tpu_torch.policy import resolve_device

_F32 = torch.float32


def _zeros(shape=(), device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=_F32, device=resolve_device(device))


def _scatter_add(size: int, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A (size,) f32 vector with ``weight`` added at ``idx``, as
    ``jnp.zeros(size).at[idx].add(weight)``: negative indices wrap once,
    indices still out of range are dropped."""
    idx = idx.reshape(-1).long()
    idx = torch.where(idx < 0, idx + size, idx)
    keep = (idx >= 0) & (idx < size)
    weight = torch.broadcast_to(weight.to(_F32), idx.shape)
    flat = torch.zeros(size, dtype=_F32, device=idx.device)
    return flat.index_add_(0, torch.where(keep, idx, 0), torch.where(keep, weight, 0.0))


# --------------------------------------------------------------------------
# mean (torchmetrics MeanMetric with nan_strategy="ignore")


def mean_init(device=None) -> Dict[str, torch.Tensor]:
    return {"total": _zeros(device=device), "count": _zeros(device=device)}


def mean_update(state, value, weight=1.0):
    value = torch.as_tensor(value, device=state["total"].device).to(_F32)
    ok = torch.isfinite(value)
    return {
        "total": state["total"] + torch.where(ok, value * weight, 0.0),
        "count": state["count"] + torch.where(ok, weight, 0.0),
    }


def mean_compute(state) -> torch.Tensor:
    return state["total"] / torch.clamp(state["count"], min=1e-12)


# --------------------------------------------------------------------------
# multiclass confusion-based metrics


def confusion_init(num_classes: int, device=None):
    return {"confusion": _zeros((num_classes, num_classes), device)}


def confusion_update(state, preds, targets):
    """preds: (N,) int predicted class; targets: (N,) int true class."""
    num_classes = state["confusion"].shape[0]
    idx = targets.long() * num_classes + preds.long()
    flat = _scatter_add(num_classes * num_classes, idx, torch.ones((), device=idx.device))
    return {"confusion": state["confusion"] + flat.reshape(num_classes, num_classes)}


def confusion_compute(state) -> Dict[str, torch.Tensor]:
    cm = state["confusion"]  # rows: true, cols: pred
    total = torch.clamp(cm.sum(), min=1e-12)
    tp = torch.diagonal(cm)
    pred_pos = cm.sum(dim=0)
    true_pos = cm.sum(dim=1)
    # macro-averaged over the classes present in the targets
    precision_c = tp / torch.clamp(pred_pos, min=1e-12)
    recall_c = tp / torch.clamp(true_pos, min=1e-12)
    present = (true_pos > 0).to(_F32)
    denom = torch.clamp(present.sum(), min=1.0)
    return {
        "accuracy": tp.sum() / total,
        "precision": (precision_c * present).sum() / denom,
        "recall": (recall_c * present).sum() / denom,
    }


# --------------------------------------------------------------------------
# multilabel / binary micro metrics


def binary_stats_init(device=None):
    return {k: _zeros(device=device) for k in ("tp", "fp", "fn", "tn")}


def binary_stats_update(state, pred_pos, true_pos):
    """pred_pos / true_pos: same-shape boolean tensors of label decisions."""
    pred_pos = pred_pos.to(_F32)
    true_pos = true_pos.to(_F32)
    return {
        "tp": state["tp"] + (pred_pos * true_pos).sum(),
        "fp": state["fp"] + (pred_pos * (1 - true_pos)).sum(),
        "fn": state["fn"] + ((1 - pred_pos) * true_pos).sum(),
        "tn": state["tn"] + ((1 - pred_pos) * (1 - true_pos)).sum(),
    }


def binary_stats_compute(state) -> Dict[str, torch.Tensor]:
    tp, fp, fn, tn = state["tp"], state["fp"], state["fn"], state["tn"]
    return {
        "accuracy": (tp + tn) / torch.clamp(tp + tn + fp + fn, min=1e-12),
        "precision": tp / torch.clamp(tp + fp, min=1e-12),
        "recall": tp / torch.clamp(tp + fn, min=1e-12),
    }


# --------------------------------------------------------------------------
# regression metrics (MAE / MSE / R^2), accumulated from sums


def regression_init(device=None):
    return {k: _zeros(device=device) for k in ("abs_err", "sq_err", "sum_y", "sum_y2", "count")}


def regression_update(state, preds, targets, mask: Optional[torch.Tensor] = None):
    preds = preds.to(_F32).reshape(-1)
    targets = targets.to(_F32).reshape(-1)
    w = torch.ones_like(targets) if mask is None else mask.to(_F32).reshape(-1)
    return {
        "abs_err": state["abs_err"] + (w * (preds - targets).abs()).sum(),
        "sq_err": state["sq_err"] + (w * (preds - targets) ** 2).sum(),
        "sum_y": state["sum_y"] + (w * targets).sum(),
        "sum_y2": state["sum_y2"] + (w * targets**2).sum(),
        "count": state["count"] + w.sum(),
    }


def regression_compute(state) -> Dict[str, torch.Tensor]:
    n = torch.clamp(state["count"], min=1e-12)
    ss_tot = state["sum_y2"] - state["sum_y"] ** 2 / n
    return {
        "mean_absolute_error": state["abs_err"] / n,
        "mean_squared_error": state["sq_err"] / n,
        "r_squared": 1.0 - state["sq_err"] / torch.clamp(ss_tot, min=1e-12),
    }


# --------------------------------------------------------------------------
# dense segmentation metrics (jaccard / pixel accuracy) via confusion matrix


def segmentation_init(num_classes: int, device=None):
    return confusion_init(num_classes, device)


def segmentation_update(state, preds, targets, ignore_index: Optional[int] = None):
    """preds/targets: integer maps of any matching shape."""
    num_classes = state["confusion"].shape[0]
    preds = preds.reshape(-1).long()
    targets = targets.reshape(-1).long()
    if ignore_index is not None:
        valid = targets != ignore_index
        weight = valid.to(_F32)
        targets = torch.where(valid, targets, 0)
    else:
        weight = torch.ones(targets.shape, dtype=_F32, device=targets.device)
    flat = _scatter_add(num_classes * num_classes, targets * num_classes + preds, weight)
    return {"confusion": state["confusion"] + flat.reshape(num_classes, num_classes)}


def segmentation_compute(state) -> Dict[str, torch.Tensor]:
    cm = state["confusion"]
    tp = torch.diagonal(cm)
    union = cm.sum(dim=0) + cm.sum(dim=1) - tp
    present = (cm.sum(dim=1) > 0).to(_F32)
    iou_c = tp / torch.clamp(union, min=1e-12)
    return {
        "accuracy": tp.sum() / torch.clamp(cm.sum(), min=1e-12),
        "mean_iou": (iou_c * present).sum() / torch.clamp(present.sum(), min=1.0),
    }


# --------------------------------------------------------------------------
# helpers


def tree_add(a, b):
    """Merge of two metric states (nested dicts, lists or tuples of tensors), leaf by leaf."""
    if isinstance(a, dict):
        return {k: tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(tree_add(x, y) for x, y in zip(a, b))
    return a + b
