"""Shared detection-family machinery (counterpart of ``sihl_tpu/heads/anchors.py``).

The normalised cell-centre anchor grid, the per-level 1x1 laterals
flattened into one anchor list, and the per-anchor MLPs over it.  The port
runs the true anchor count: the TPU's anchor padding and flat-gather
switch are layout levers and are not ported.
"""

from typing import List, Tuple

import torch

from sihl_tpu_torch.ops.fused_mlp import fused_mlps
from sihl_tpu_torch.policy import device_vector


def gather_anchor_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-image rows of (B, A, C) features at (B, k) indices: (B, k, C).
    Its backward is autograd's scatter-add."""
    return feats[torch.arange(feats.shape[0], device=feats.device)[:, None], idx]


def sort_positives(pos_w: torch.Tensor, pos_idx: torch.Tensor):
    """Reorder per-image top-k positives ascending by anchor index.  The
    losses over positives are permutation-invariant sums, so this changes no
    value; it keeps the gather of their features in memory order."""
    order = torch.argsort(pos_idx, dim=1)
    return torch.take_along_dim(pos_w, order, dim=1), torch.take_along_dim(pos_idx, order, dim=1)


def _level_grid(feature: torch.Tensor):
    """Normalised pixel-centre coordinates of one (B, C, h, w) feature map."""
    h, w = feature.shape[2:]
    y_min, x_min = 1.0 / h / 2.0, 1.0 / w / 2.0
    kw = dict(dtype=torch.float32, device=feature.device)
    ys = torch.linspace(y_min, 1 - y_min, h, **kw)
    xs = torch.linspace(x_min, 1 - x_min, w, **kw)
    xg = xs[None, :].expand(h, w).reshape(-1)
    yg = ys[:, None].expand(h, w).reshape(-1)
    return xg, yg, x_min, y_min


def mask_grid(feature: torch.Tensor) -> torch.Tensor:
    """Normalised (x, y) pixel-centre coordinates (H, W, 2) of one (B, C, H,
    W) map: the grid of the dynamic mask and heatmap decodes."""
    xg, yg, _, _ = _level_grid(feature)
    return torch.stack([xg, yg], dim=1).reshape(*feature.shape[2:], 2)


def cell_anchors(inputs, levels) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalised cell-centre offsets (A, 4) and cell-box scales (A, 4) over
    all ``levels``, h-major then w within a level."""
    offsets, scales = [], []
    for level in levels:
        xg, yg, x_min, y_min = _level_grid(inputs[level])
        offsets.append(torch.stack([xg, yg, xg, yg], dim=1))
        cell = device_vector([-x_min, -y_min, x_min, y_min], xg.device)
        scales.append(cell[None, :].expand(xg.shape[0], 4))
    return torch.cat(offsets), torch.cat(scales)


def cell_centers_with_levels(inputs, levels) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quadrilateral head's variant: each anchor's normalised cell centre
    tiled to the 4 vertices, (A, 8) as x, y, x, y, ..., and its pyramid
    level, (A, 1) f32, over all ``levels``."""
    rel_offsets, level_ids = [], []
    for level in levels:
        xg, yg, _, _ = _level_grid(inputs[level])
        rel_offsets.append(torch.stack([xg, yg], dim=1).repeat(1, 4))
        level_ids.append(torch.full((xg.shape[0], 1), float(level), dtype=torch.float32, device=xg.device))
    return torch.cat(rel_offsets), torch.cat(level_ids)


def flatten_laterals(inputs, levels, laterals, num_channels: int, extra=None) -> torch.Tensor:
    """Apply per-level 1x1 laterals and flatten into one (B, A, C) anchor list;
    ``extra`` is an addend broadcast to every level's lateral (the
    quadrilateral head's (B, C, 1, 1) global context).

    On channels_last maps the per-level ``permute(0, 2, 3, 1).reshape`` is a
    view; the concatenation is the only copy.
    """
    flat = []
    for level, lateral in zip(levels, laterals):
        f = lateral(inputs[level])
        if extra is not None:
            f = f + extra
        flat.append(f.permute(0, 2, 3, 1).reshape(f.shape[0], -1, num_channels))
    return torch.cat(flat, dim=1)


def run_mlps(x: torch.Tensor, mlps, *, num_valid: int) -> List[torch.Tensor]:
    """Run several per-anchor MLPs over shared (B, A, C) features in one
    :func:`~sihl_tpu_torch.ops.fused_mlp.fused_mlps` call; every output is
    sliced to the first ``num_valid`` anchors."""
    b, a, c = x.shape
    if not (isinstance(num_valid, int) and 0 < num_valid <= a):
        raise ValueError(f"num_valid must be in (0, {a}], got {num_valid!r}")
    outs = [o.reshape(b, a, -1) for o in fused_mlps(x.reshape(b * a, c), mlps)]
    if num_valid != a:
        outs = [o[:, :num_valid] for o in outs]
    return outs
