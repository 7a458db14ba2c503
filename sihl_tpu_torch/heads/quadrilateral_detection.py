"""Quadrilateral detection head (counterpart of
``sihl_tpu/heads/quadrilateral_detection.py``).

Per-level SiLU laterals plus a global-context vector added to every level,
tanh vertex offsets from the cell centres, its own top-k matching (a
one-to-one best-anchor mask and relative CIoU, batched over images), an L1
quad loss and a sigmoid-focal class loss.

Inference: the loc MLP dense over every anchor, the top ``max_instances``
anchors by loc logit (no NMS), then the quad and class MLPs over those rows.
Training: the quad and class MLPs over the ``max_targets * topk`` anchors of
highest relative CIoU per image, the loc MLP dense.  Targets: ``classes``
(B, T) integer, -1 padded, and ``quads`` (B, T, 4, 2) absolute vertices.
Losses are f32 (f64 for a model built under the f64 compute dtype); the
geometry and the matching stay f32.  Validation scores the quads' bounding
boxes with COCO box mAP, as the JAX package does; polygon IoU, which no
ported head uses, is not ported.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.heads import anchors
from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.heads.object_detection import box_map_end
from sihl_tpu_torch.layers.convblocks import StandardConvNormAct, default_generator
from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops.boxes import complete_box_iou
from sihl_tpu_torch.ops.losses import binary_cross_entropy_with_logits, sigmoid_focal_loss
from sihl_tpu_torch.policy import device_vector, upcast
from sihl_tpu_torch.training import metrics as M


def _descending_top(x: torch.Tensor, k: int):
    """The k largest entries of each row of ``x`` and their indices, in
    ``lax.top_k``'s order: descending, the lower index first among equals
    (a stable sort; ``torch.topk`` promises no order among equals)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def quad_bbox_matching(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor, gt_mask: torch.Tensor, topk: int):
    """The reference's quad matching over padded ground truth, for a batch of
    images at once.

    Each valid gt claims its ``topk`` anchors of highest CIoU; an anchor is
    assigned the argmax over gts of its CIoU times its claim mask.  The CIoU
    is *not* clamped, as in the reference: where all of an anchor's claiming
    gts have a negative CIoU, the argmax lands on a column holding 0, a gt
    that did not claim it.  The relative CIoU divides by the best CIoU of the
    assigned gt; non-finite ratios become 0.

    Args:
        anchor_boxes: (A, 4) anchor boxes.
        gt_boxes: (B, G, 4) padded ground-truth boxes.
        gt_mask: (B, G) validity of each gt row.
        topk: anchors claimed per gt.

    Returns:
        assignment (B, A) int32, -1 where no gt claimed the anchor;
        o2o_mask (B, A) bool, the anchors that are some gt's best;
        rel_iou (B, A), 0 where unclaimed.
    """
    b, g = gt_boxes.shape[:2]
    num_anchors = anchor_boxes.shape[0]
    gt_mask = gt_mask.bool()
    ious = complete_box_iou(anchor_boxes, gt_boxes)  # (B, A, G), can be negative
    ious = torch.where(gt_mask[:, None, :], ious, -torch.inf)

    topk_ious, topk_idxs = _descending_top(ious.transpose(1, 2), min(topk, num_anchors))  # (B, G, k)
    claims = torch.zeros((b, g, num_anchors), dtype=torch.bool, device=ious.device)
    is_topk = (claims.scatter(2, topk_idxs, True) & gt_mask[..., None]).transpose(1, 2)  # (B, A, G)
    is_best = (claims.scatter(2, topk_idxs[..., :1], True) & gt_mask[..., None]).transpose(1, 2)

    safe_ious = torch.where(gt_mask[:, None, :], ious, 0.0)
    prod = safe_ious * is_topk.to(safe_ious.dtype)
    max_gt_idxs = prod.argmax(dim=2)  # the first index among equal maxima, as jnp.argmax
    max_ious = prod.gather(2, max_gt_idxs[..., None])[..., 0]
    valid = is_topk.any(dim=2)

    assignment = torch.where(valid, max_gt_idxs, -1).to(torch.int32)
    o2o_mask = is_best.any(dim=2)
    rel = max_ious / topk_ious[..., 0].gather(1, max_gt_idxs)
    rel = torch.nan_to_num(rel, nan=0.0, posinf=0.0, neginf=0.0)
    return assignment, o2o_mask, torch.where(valid, rel, 0.0)


class QuadrilateralDetection(Head):
    def __init__(
        self,
        in_channels: List[int],
        num_classes: int,
        bottom_level: int = 3,
        top_level: int = 5,
        num_channels: int = 256,
        num_layers: int = 4,
        max_instances: int = 100,
        max_targets: int = 100,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ) -> None:
        super().__init__()
        if num_classes <= 0 or max_instances <= 0 or num_channels % 4:
            raise ValueError((num_classes, max_instances, num_channels))
        if len(in_channels) <= top_level or not 0 < bottom_level <= top_level:
            raise ValueError((len(in_channels), bottom_level, top_level))
        generator = default_generator(generator)

        self.in_channels = in_channels
        self.num_classes = num_classes
        self.bottom_level, self.top_level = bottom_level, top_level
        self.levels = range(bottom_level, top_level + 1)
        self.num_channels = num_channels
        self.max_instances = max_instances
        self.max_targets = max_targets
        self.topk = 9

        def lateral(cin):
            return StandardConvNormAct(cin, num_channels, 1, act="silu", generator=generator, device=device)

        self.laterals = nn.ModuleList(lateral(in_channels[level]) for level in self.levels)
        self.global_context = lateral(in_channels[top_level])
        hidden = [num_channels] * num_layers

        def mlp(out):
            return MLP(num_channels, hidden + [out], generator=generator, device=device)

        self.loc_head = mlp(1)
        self.class_head = mlp(num_classes)
        self.quad_head = mlp(8)

        self.output_shapes = {
            "num_instances": ("batch_size",),
            "scores": ("batch_size", max_instances),
            "classes": ("batch_size", max_instances),
            "quads": ("batch_size", max_instances, 4, 2),
        }

    def get_offsets_and_levels(self, inputs):
        return anchors.cell_centers_with_levels(inputs, self.levels)

    def get_features(self, inputs) -> torch.Tensor:
        """(B, A, C) lateral features, each with the top level's mean context added."""
        ctx = torch.mean(self.global_context(inputs[self.top_level]), dim=(2, 3), keepdim=True)
        return anchors.flatten_laterals(inputs, self.levels, self.laterals, self.num_channels, extra=ctx)

    @staticmethod
    def quads_to_boxes(quads: torch.Tensor) -> torch.Tensor:
        x, y = quads[..., 0], quads[..., 1]
        return torch.stack([x.amin(-1), y.amin(-1), x.amax(-1), y.amax(-1)], dim=-1)

    @staticmethod
    def canonicalize_and_convexify(quads: torch.Tensor) -> torch.Tensor:
        """Sort each quad's vertices by angle around its centroid, then
        replace every concave vertex with its neighbours' midpoint."""
        rel = quads - quads.mean(dim=-2, keepdim=True)
        order = torch.argsort(torch.atan2(rel[..., 1], rel[..., 0]), dim=-1, stable=True)
        v = torch.take_along_dim(quads, order[..., None], dim=-2)
        # the neighbours by rolls: an index list would be copied from the host
        v_next = torch.roll(v, -1, dims=-2)
        v_prev = torch.roll(v, 1, dims=-2)
        cross = (v_next[..., 0] - v[..., 0]) * (v_prev[..., 1] - v[..., 1]) - (
            (v_next[..., 1] - v[..., 1]) * (v_prev[..., 0] - v[..., 0])
        )
        return torch.where((cross < 0)[..., None], (v_prev + v_next) * 0.5, v)

    def forward(self, inputs):
        """Returns (num_instances (B,), scores (B, I), classes (B, I), quads
        (B, I, 4, 2) in input pixels)."""
        batch, (full_h, full_w) = inputs[0].shape[0], inputs[0].shape[2:]
        feats = self.get_features(inputs)
        rel_offsets, _ = self.get_offsets_and_levels(inputs)

        (loc_out,) = anchors.run_mlps(feats, [self.loc_head], num_valid=rel_offsets.shape[0])
        num_slots = min(self.max_instances, loc_out.shape[1])
        loc_logits, loc_idxs = _descending_top(upcast(loc_out[..., 0]), num_slots)
        scores = torch.sigmoid(loc_logits)
        num_instances = torch.sum(scores > 0.5, dim=1)
        feats = anchors.gather_anchor_rows(feats, loc_idxs)

        quad_out, class_logits = anchors.run_mlps(
            feats, [self.quad_head, self.class_head], num_valid=num_slots
        )
        full = device_vector([full_w, full_h] * 4, feats.device)
        quad_preds = (torch.tanh(upcast(quad_out)) + rel_offsets[loc_idxs]) * full
        classes = torch.argmax(class_logits, dim=2)
        return num_instances, scores, classes, quad_preds.reshape(batch, num_slots, 4, 2)

    def training_step(self, inputs, classes: torch.Tensor, quads: torch.Tensor):
        """classes: (B, T) integer with -1 padding; quads: (B, T, 4, 2) vertices
        in input pixels.  Returns (loss, metrics)."""
        if len(inputs) <= self.top_level:
            raise ValueError(f"need levels up to {self.top_level}, got {len(inputs)} inputs")
        batch, (full_h, full_w) = inputs[0].shape[0], inputs[0].shape[2:]
        feats = self.get_features(inputs)
        rel_offsets, levels = self.get_offsets_and_levels(inputs)
        device = rel_offsets.device

        # anchors: a box around each cell centre, half-side sigmoid(level - top)
        directions = device_vector([-1.0, -1.0, 1.0, 1.0], device)
        full4 = device_vector([full_w, full_h, full_w, full_h], device)
        anchor_boxes = (rel_offsets[:, :4] + directions * torch.sigmoid(levels - self.top_level)) * full4

        quads = quads.float()
        assignment, o2o_mask, rel_iou = quad_bbox_matching(
            anchor_boxes, self.quads_to_boxes(quads), classes >= 0, self.topk
        )
        loc_target = torch.where(o2o_mask, 1.0, rel_iou / self.topk)
        any_match = rel_iou.max() > 0.0

        # the positives of each image (a static count), in anchor order
        k = min(self.max_targets * self.topk, rel_iou.shape[1])
        pos_w, pos_idx = anchors.sort_positives(*torch.topk(rel_iou, k, dim=1))
        pos_feats = anchors.gather_anchor_rows(feats, pos_idx)
        pos_assign = torch.clamp(torch.take_along_dim(assignment, pos_idx, dim=1), min=0).long()
        w_sum = torch.clamp(pos_w.sum(), min=1e-6)
        quad_out, class_logits = anchors.run_mlps(
            pos_feats, [self.quad_head, self.class_head], num_valid=k
        )

        # quad L1 loss against the canonical, convex target
        quad_preds = torch.clamp(torch.tanh(upcast(quad_out)) + rel_offsets[pos_idx], 0.0, 1.0)
        quad_target = torch.take_along_dim(quads, pos_assign[..., None, None], dim=1)
        quad_target = self.canonicalize_and_convexify(quad_target) / device_vector([full_w, full_h], device)
        l1 = torch.abs(quad_preds.reshape(batch, k, 4, 2) - quad_target).sum(dim=(2, 3))
        quad_loss = 10.0 * (pos_w * l1).sum() / w_sum

        # focal classification loss over the positives
        class_target = torch.take_along_dim(torch.clamp(classes, min=0), pos_assign, dim=1)
        one_hot = (class_target.long()[..., None] == torch.arange(self.num_classes, device=classes.device)).float()
        focal = sigmoid_focal_loss(class_logits, one_hot).sum(dim=2)
        class_loss = 10.0 * (pos_w * focal).sum() / w_sum

        # location loss, dense over every anchor
        (loc_out,) = anchors.run_mlps(feats, [self.loc_head], num_valid=rel_iou.shape[1])
        loc_bce = binary_cross_entropy_with_logits(loc_out[..., 0], loc_target)
        loc_loss = loc_bce.sum() / torch.clamp(loc_target.sum(), min=1e-6)

        # where no gt matched anywhere, only the location loss applies
        zero = torch.zeros((), device=loc_loss.device)
        quad_loss = torch.where(any_match, quad_loss, zero)
        class_loss = torch.where(any_match, class_loss, zero)
        loss = loc_loss + quad_loss + class_loss
        return loss, {"location_loss": loc_loss, "quad_loss": quad_loss, "class_loss": class_loss}

    # -- validation --------------------------------------------------------
    def metrics_init(self):
        return {"loss": M.mean_init(self._device())}

    def validation_step(self, state, inputs, classes, quads):
        num_instances, scores, pred_classes, quad_preds = self(inputs)
        loss, _ = self.training_step(inputs, classes, quads)
        state = {"loss": M.mean_update(state["loss"], loss)}
        aux = {
            "scores": scores,
            "pred_classes": pred_classes,
            "pred_boxes": self.quads_to_boxes(quad_preds),
            "gt_classes": classes,
            "gt_boxes": self.quads_to_boxes(quads.float()),
        }
        return state, loss, aux

    def validation_end(self, state, collected=()):
        return box_map_end(state, collected)
