"""Anchor-free object detection head (counterpart of
``sihl_tpu/heads/object_detection.py``).

Inference: per-level 1x1 laterals, one flattened anchor list, the loc MLP
dense over every anchor, the top ``max_instances`` anchors by loc logit (no
NMS), then the cls and box MLPs over those rows only.

Training: every image's padded ground truth is matched to the anchors at
once (``bbox_matching``, batched over images); the loc and iou MLPs run dense
over every anchor in one fused call; the ``max_targets * topk`` anchors of
highest relative IoU per image are gathered, and the cls and box MLPs run
over them in a second fused call.  Losses are f32 (f64 for a model built
under the f64 compute dtype).

Validation: the loss's mean on the device; each batch's detections and
padded ground truth go to the host in ``aux``, and ``validation_end`` runs
COCO mAP (:mod:`sihl_tpu_torch.utils.coco_map`) over them.
"""

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from sihl_tpu_torch.heads import anchors
from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.layers.convblocks import StandardConvNormAct, default_generator
from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops.boxes import bbox_matching, complete_box_iou_loss
from sihl_tpu_torch.ops.losses import binary_cross_entropy_with_logits, cross_entropy
from sihl_tpu_torch.policy import device_vector, upcast
from sihl_tpu_torch.training import metrics as M
from sihl_tpu_torch.utils.coco_map import MeanAveragePrecisionAccumulator


def box_map_end(state, collected) -> Dict[str, float]:
    """The mean validation loss and COCO box mAP over the collected batches'
    ``pred_boxes``, ``pred_classes``, ``scores``, ``gt_boxes`` and
    ``gt_classes``."""
    out = {"loss": float(M.mean_compute(state["loss"]))}
    acc = MeanAveragePrecisionAccumulator()
    for aux in collected:
        acc.update(aux["pred_boxes"], aux["pred_classes"], aux["scores"], aux["gt_boxes"], aux["gt_classes"])
    out.update(acc.compute())
    return out


class ObjectDetection(Head):
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
        """
        Args:
            in_channels: channels of input feature maps by level.
            num_classes: number of object categories.
            bottom_level/top_level: pyramid levels this head reads.
            num_channels: conv/MLP width.
            num_layers: MLP depth.
            max_instances: fixed-size inference output slots.
            max_targets: ground-truth padding size (targets per image).
        """
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

        self.laterals = nn.ModuleList(
            StandardConvNormAct(
                in_channels[level], num_channels, 1, act=None, generator=generator, device=device
            )
            for level in self.levels
        )
        hidden = [num_channels] * num_layers

        def mlp(out, bias=None):
            return MLP(num_channels, hidden + [out], bias, generator=generator, device=device)

        # loc head biased low so initial predictions are "no object"
        self.loc_head = mlp(1, -5.0)
        self.cls_head = mlp(num_classes)
        self.box_head = mlp(4)
        self.iou_head = mlp(1)  # read by training only

        self.output_shapes = {
            "num_instances": ("batch_size",),
            "scores": ("batch_size", max_instances),
            "classes": ("batch_size", max_instances),
            "boxes": ("batch_size", max_instances, 4),
        }

    def get_offsets_and_scales(self, inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        return anchors.cell_anchors(inputs, self.levels)

    def flat_features(self, inputs) -> torch.Tensor:
        return anchors.flatten_laterals(inputs, self.levels, self.laterals, self.num_channels)

    def forward(self, inputs):
        """Returns (num_instances (B,), scores (B, I), classes (B, I),
        boxes (B, I, 4) in input pixels as x0, y0, x1, y1)."""
        height, width = inputs[0].shape[2:]
        flat_feats = self.flat_features(inputs)
        offsets, scales = self.get_offsets_and_scales(inputs)
        full_size = device_vector([width, height, width, height], offsets.device)

        (loc_out,) = anchors.run_mlps(flat_feats, [self.loc_head], num_valid=offsets.shape[0])
        loc_logits = loc_out[..., 0].float()
        num_slots = min(self.max_instances, loc_logits.shape[1])
        # a stable descending sort puts the lower index first among equal
        # logits, as lax.top_k does; torch.topk promises no order on CUDA
        loc_logits, loc_idxs = torch.sort(loc_logits, dim=1, descending=True, stable=True)
        loc_logits, loc_idxs = loc_logits[:, :num_slots], loc_idxs[:, :num_slots]
        flat_feats = anchors.gather_anchor_rows(flat_feats, loc_idxs)
        scores = torch.sigmoid(loc_logits)
        num_instances = torch.sum(scores > 0.5, dim=1)

        class_logits, box_out = anchors.run_mlps(
            flat_feats, [self.cls_head, self.box_head], num_valid=num_slots
        )
        classes = torch.argmax(class_logits, dim=2)
        box_preds = (offsets[loc_idxs] + scales[loc_idxs] * torch.exp(box_out.float())) * full_size
        return num_instances, scores, classes, box_preds

    def training_step(self, inputs, classes: torch.Tensor, boxes: torch.Tensor):
        """classes: (B, T) integer with -1 padding; boxes: (B, T, 4) in input
        pixels as x0, y0, x1, y1.  Returns (loss, metrics)."""
        if len(inputs) <= self.top_level:
            raise ValueError(f"need levels up to {self.top_level}, got {len(inputs)} inputs")
        height, width = inputs[0].shape[2:]
        offsets, scales = self.get_offsets_and_scales(inputs)
        full_size = device_vector([width, height, width, height], offsets.device)
        boxes = boxes.float()
        assignment, rel_iou = bbox_matching(
            (offsets + scales) * full_size, boxes, classes >= 0, self.topk, relative=True
        )

        # loc and iou heads, dense over every anchor, in one fused call
        flat_feats = self.flat_features(inputs)
        num_anchors = offsets.shape[0]
        loc_out, iou_out = anchors.run_mlps(
            flat_feats, [self.loc_head, self.iou_head], num_valid=num_anchors
        )
        loc_logits = upcast(loc_out[..., 0])
        loc_target = (rel_iou == 1.0).float()
        loc_loss = binary_cross_entropy_with_logits(loc_logits, loc_target).sum() / torch.clamp(
            loc_target.sum(), min=1.0
        )
        any_match = rel_iou.max() > 0.0
        rel_sum = torch.clamp(rel_iou.sum(), min=1e-6)
        iou_loss = ((upcast(iou_out[..., 0]) - rel_iou) ** 2).sum() / rel_sum

        # the positives of each image (a static count), in anchor order
        k = min(self.max_targets * self.topk, num_anchors)
        pos_w, pos_idx = anchors.sort_positives(*torch.topk(rel_iou, k, dim=1))
        pos_feats = anchors.gather_anchor_rows(flat_feats, pos_idx)
        pos_assign = torch.clamp(torch.take_along_dim(assignment, pos_idx, dim=1), min=0).long()
        class_logits, box_out = anchors.run_mlps(
            pos_feats, [self.cls_head, self.box_head], num_valid=k
        )

        # box loss: CIoU between the decoded positives and their gt
        box_preds = offsets[pos_idx] + scales[pos_idx] * torch.exp(upcast(box_out))
        box_target = torch.take_along_dim(boxes, pos_assign[..., None], dim=1) / full_size
        box_loss = (pos_w * complete_box_iou_loss(box_preds, box_target)).sum() / rel_sum

        # classification over the positives, weighted by relative IoU
        class_target = torch.take_along_dim(classes, pos_assign, dim=1)
        class_ce = cross_entropy(class_logits, torch.clamp(class_target, min=0))
        class_loss = (pos_w * class_ce).sum() / rel_sum

        # where no gt matched anywhere, only the location loss applies
        zero = torch.zeros((), device=loc_loss.device)
        box_loss = torch.where(any_match, box_loss, zero)
        class_loss = torch.where(any_match, class_loss, zero)
        iou_loss = torch.where(any_match, iou_loss, zero)

        loss = loc_loss + 10.0 * box_loss + class_loss + iou_loss
        metrics = {
            "location_loss": loc_loss,
            "box_loss": box_loss,
            "class_loss": class_loss,
            "iou_loss": iou_loss,
        }
        return loss, metrics

    # -- validation --------------------------------------------------------
    def metrics_init(self):
        return {"loss": M.mean_init(self._device())}

    def validation_step(self, state, inputs, classes, boxes):
        num_instances, scores, pred_classes, pred_boxes = self(inputs)
        loss, _ = self.training_step(inputs, classes, boxes)
        state = {"loss": M.mean_update(state["loss"], loss)}
        aux = {
            "scores": scores,
            "pred_classes": pred_classes,
            "pred_boxes": pred_boxes,
            "gt_classes": classes,
            "gt_boxes": boxes,
        }
        return state, loss, aux

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        return box_map_end(state, collected)
