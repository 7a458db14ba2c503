"""Box geometry and anchor matching (counterpart of ``sihl_tpu/ops/boxes.py``).

IoU and complete-IoU (CIoU) of ``(x1, y1, x2, y2)`` boxes, the CIoU loss,
the boxes of binary masks, and ``bbox_matching``, the static top-k anchor
<-> ground-truth assignment of the detection heads over padded ground truth,
batched over images.
"""

import math
from typing import Tuple

import torch

from sihl_tpu_torch.ops.topk import row_best_and_kth
from sihl_tpu_torch.policy import upcast

_EPS = 1e-7


def _areas(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0
    )


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU matrix between (N, 4) and (M, 4) boxes -> (N, M)."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = _areas(boxes1)[:, None] + _areas(boxes2)[None, :] - inter
    return inter / (union + _EPS)


def _ciou_terms(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """CIoU of broadcast-compatible (..., 4) box tensors."""
    x1, y1, x2, y2 = b1.unbind(-1)
    x1g, y1g, x2g, y2g = b2.unbind(-1)

    inter_w = torch.clamp(torch.minimum(x2, x2g) - torch.maximum(x1, x1g), min=0)
    inter_h = torch.clamp(torch.minimum(y2, y2g) - torch.maximum(y1, y1g), min=0)
    inter = inter_w * inter_h
    union = (
        torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
        + torch.clamp(x2g - x1g, min=0) * torch.clamp(y2g - y1g, min=0)
        - inter
    )
    iou = inter / (union + _EPS)

    # normalised centre distance (the DIoU term)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    cxg, cyg = (x1g + x2g) / 2, (y1g + y2g) / 2
    ex1, ey1 = torch.minimum(x1, x1g), torch.minimum(y1, y1g)
    ex2, ey2 = torch.maximum(x2, x2g), torch.maximum(y2, y2g)
    diag_sq = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2 + _EPS
    center_sq = (cx - cxg) ** 2 + (cy - cyg) ** 2
    diou = iou - center_sq / diag_sq

    # aspect-ratio consistency (the CIoU term); alpha is a detached weight
    w, h = x2 - x1, y2 - y1
    wg, hg = x2g - x1g, y2g - y1g
    v = (4.0 / math.pi**2) * (torch.atan(wg / (hg + _EPS)) - torch.atan(w / (h + _EPS))) ** 2
    alpha = (v / (1.0 - iou + v + _EPS)).detach()
    return diou - alpha * v


def complete_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """CIoU matrix between (..., N, 4) and (..., M, 4) boxes -> (..., N, M)."""
    return _ciou_terms(boxes1[..., :, None, :], boxes2[..., None, :, :])


def complete_box_iou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise CIoU loss (1 - CIoU) for matched (..., 4) box pairs, in f32
    (f64 for f64 boxes)."""
    return 1.0 - _ciou_terms(upcast(boxes1), upcast(boxes2))


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """Pixel-index bounding boxes (..., 4) of binary masks (..., H, W): the
    first and last column and row holding a value > 0, in f32; zeros for an
    empty mask.  The extremes are taken over each mask's row and column
    "any", which gives the same values as over every pixel."""
    h, w = masks.shape[-2:]
    valid = masks > 0
    cols, rows = valid.any(dim=-2), valid.any(dim=-1)  # (..., W), (..., H)
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    big = 1e9
    boxes = torch.stack(
        [
            torch.where(cols, xs, big).amin(dim=-1),
            torch.where(rows, ys, big).amin(dim=-1),
            torch.where(cols, xs, -big).amax(dim=-1),
            torch.where(rows, ys, -big).amax(dim=-1),
        ],
        dim=-1,
    )
    return torch.where(rows.any(dim=-1, keepdim=True), boxes, 0.0)


def points_to_bbox(points: torch.Tensor) -> torch.Tensor:
    """(N, K, 2) point sets to their (N, 4) enclosing boxes (x0, y0, x1, y1)."""
    return torch.cat([points.amin(dim=-2), points.amax(dim=-2)], dim=-1)


def bbox_matching(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    topk: int = 9,
    relative: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static top-k anchor <-> gt assignment over padded ground truth, for a
    batch of images at once.

    CIoU between anchors and gt is clamped to >= 0; each gt claims every
    anchor at or above its ``topk``-th largest *distinct* IoU (ties at the
    threshold are all claimed) and never an anchor of IoU 0; each claimed
    anchor keeps its highest-IoU gt (the lowest index among equals).  With
    ``relative=True`` the second return is the anchor's IoU divided by the
    best IoU any anchor reaches for its gt (0/0 and other non-finite ratios
    become 0).

    Args:
        anchors: (A, 4) anchor boxes.
        gt_boxes: (B, G, 4) padded ground-truth boxes.
        gt_mask: (B, G) validity of each gt row.
        topk: anchors claimed per gt.
        relative: return relative IoU instead of the matched IoU.

    Returns:
        assignment: (B, A) int32 gt index, -1 where unmatched.
        iou_or_rel_iou: (B, A) float32.
    """
    b, g = gt_boxes.shape[:2]
    num_anchors = anchors.shape[0]
    gt_mask = gt_mask.bool()

    ious = torch.clamp(complete_box_iou(anchors, gt_boxes), min=0)  # (B, A, G)
    ious = torch.where(gt_mask[:, None, :], ious, 0.0)

    work = ious.transpose(1, 2).reshape(b * g, num_anchors)  # (B*G, A)
    best, kth = row_best_and_kth(work, min(topk, num_anchors))
    best, kth = best.view(b, g), kth.view(b, g)
    is_topk = (ious >= kth[:, None, :]) & (ious > 0.0)  # (B, A, G)

    masked = torch.where(is_topk, ious, 0.0)
    max_ious = masked.amax(dim=2)  # (B, A)
    max_gt_idxs = masked.argmax(dim=2)  # the first index among equal maxima, as jnp.argmax
    valid = max_ious > 0.0
    assignment = torch.where(valid, max_gt_idxs, -1).to(torch.int32)
    if not relative:
        return assignment, max_ious
    rel = max_ious / torch.gather(best, 1, max_gt_idxs)
    rel = torch.nan_to_num(rel, nan=0.0, posinf=0.0, neginf=0.0)
    return assignment, torch.where(valid, rel, 0.0)
