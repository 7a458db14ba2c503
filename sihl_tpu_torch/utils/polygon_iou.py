"""IoU between convex polygons (counterpart of ``sihl_tpu/utils/polygon_iou.py``).

Sutherland–Hodgman clipping and the shoelace area on fixed-size vertex
buffers: clipping a convex n-gon against a convex m-gon leaves at most
n + m vertices, so each buffer is padded to that bound and carries a count
of valid vertices.  Every function takes any leading batch dimensions, so
one call covers a batch of polygon pairs on the device, where the JAX
package maps the single-pair function.
"""

from typing import Optional, Tuple

import torch


def polygon_area(vertices: torch.Tensor, num_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shoelace area of polygons (..., V, 2); with ``num_valid`` (...,) only
    each buffer's first ``num_valid`` vertices count, closing on vertex 0."""
    if num_valid is None:
        rolled = torch.roll(vertices, -1, dims=-2)
        cross = vertices[..., 0] * rolled[..., 1] - rolled[..., 0] * vertices[..., 1]
        return cross.sum(dim=-1).abs() / 2.0
    idx = torch.arange(vertices.shape[-2], device=vertices.device)
    num_valid = num_valid[..., None]
    nxt = torch.where(idx + 1 >= num_valid, 0, idx + 1)
    rolled = torch.gather(vertices, -2, nxt[..., None].expand(vertices.shape))
    cross = vertices[..., 0] * rolled[..., 1] - rolled[..., 0] * vertices[..., 1]
    cross = torch.where(idx < num_valid, cross, 0.0)
    return cross.sum(dim=-1).abs() / 2.0


def _clip_against_edge(poly, count, a, b):
    """Clip the padded polygons (M, N, 2) with counts (M,) against the
    half-plane left of each edge a -> b (M, 2); returns the clipped buffers
    (M, N, 2) and counts."""
    m, n, _ = poly.shape
    idx = torch.arange(n, device=poly.device)
    nxt = torch.where(idx + 1 >= count[:, None], 0, idx + 1)
    nxt_v = torch.gather(poly, 1, nxt[..., None].expand(m, n, 2))
    a, b = a[:, None], b[:, None]

    def side(p):
        return (b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0])

    cur_side = side(poly)
    cur_in, nxt_in = cur_side >= 0, side(nxt_v) >= 0
    d = nxt_v - poly
    denom = (b[..., 0] - a[..., 0]) * d[..., 1] - (b[..., 1] - a[..., 1]) * d[..., 0]
    t = torch.where(denom.abs() > 1e-12, -cur_side / torch.where(denom == 0, 1.0, denom), 0.0)
    inter = poly + t[..., None] * d

    # each input edge emits up to two points: its first vertex (if inside)
    # and the crossing (if the edge crosses the boundary); writes that emit
    # nothing land on a scratch slot past the buffer, which is dropped
    valid_edge = idx < count[:, None]
    emit_cur = cur_in & valid_edge
    emit_inter = (cur_in != nxt_in) & valid_edge
    emitted = emit_cur.long() + emit_inter.long()
    offsets = torch.cumsum(emitted, dim=1) - emitted
    cur_pos = torch.where(emit_cur, offsets, n)
    inter_pos = torch.where(emit_inter, offsets + emit_cur.long(), n)
    out = poly.new_zeros(m, n + 1, 2)
    out.scatter_(1, cur_pos[..., None].expand(m, n, 2), poly)
    out.scatter_(1, inter_pos[..., None].expand(m, n, 2), inter)
    new_count = emitted.sum(dim=1)
    out = torch.where((torch.arange(n, device=poly.device) < new_count[:, None])[..., None], out[:, :n], 0.0)
    return out, new_count


def polygon_intersection(poly1: torch.Tensor, poly2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sutherland–Hodgman intersection of convex polygons (..., n1, 2) and
    (..., n2, 2), the clip polygon counter-clockwise; returns the vertices
    (..., n1 + n2, 2), padded with zeros, and their counts (...,)."""
    batch = poly1.shape[:-2]
    n1, n2 = poly1.shape[-2], poly2.shape[-2]
    p1, p2 = poly1.reshape(-1, n1, 2), poly2.reshape(-1, n2, 2)
    out = torch.cat([p1, p1.new_zeros(p1.shape[0], n2, 2)], dim=1)
    count = torch.full((p1.shape[0],), n1, dtype=torch.long, device=poly1.device)
    for i in range(n2):
        out, count = _clip_against_edge(out, count, p2[:, i], p2[:, (i + 1) % n2])
    return out.reshape(*batch, n1 + n2, 2), count.reshape(batch)


def _ensure_ccw(poly: torch.Tensor) -> torch.Tensor:
    rolled = torch.roll(poly, -1, dims=-2)
    signed2 = (poly[..., 0] * rolled[..., 1] - rolled[..., 0] * poly[..., 1]).sum(dim=-1)
    return torch.where((signed2 < 0)[..., None, None], poly.flip(-2), poly)


def polygon_iou(poly1: torch.Tensor, poly2: torch.Tensor) -> torch.Tensor:
    """IoU of convex polygons (..., V, 2), clockwise or counter-clockwise,
    pair by pair over the leading dimensions."""
    dtype = torch.promote_types(poly1.dtype, poly2.dtype)
    poly1, poly2 = _ensure_ccw(poly1.to(dtype)), _ensure_ccw(poly2.to(dtype))
    inter_v, inter_n = polygon_intersection(poly1, poly2)
    inter = torch.where(inter_n >= 3, polygon_area(inter_v, inter_n), 0.0)
    union = polygon_area(poly1) + polygon_area(poly2) - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)
