"""CondInst instance segmentation head (counterpart of
``sihl_tpu/heads/instance_segmentation.py``).

It shares the anchor-free localization machinery of ObjectDetection; a
``kernel_head`` MLP emits, per instance, the weights of a 3-layer pointwise
net that decodes the instance's mask from shared mask features and
coordinates relative to the instance's anchor
(:func:`~sihl_tpu_torch.ops.dynconv.dynamic_pointwise_decode`, kernels K5f
and K5b on the card).

Inference: the loc MLP dense over every anchor, the top ``max_instances``
anchors by loc logit, then the cls and kernel MLPs over those rows only and
the decode of their masks at ``mask_level`` resolution.

Training: ground-truth boxes come from the masks (``masks_to_boxes``), every
image's padded ground truth is matched to the anchors at once, and the
``max_mask_positives`` anchors of highest relative IoU per image are decoded
and scored with a dice loss against the ground-truth masks resized to the
decode's resolution.

Validation: the loss's mean on the device; each batch's scores, classes,
predicted masks (> 0.5) and ground-truth masks (> 0) go to the host, the
masks bit-packed on the device (``packbits_last``), and ``validation_end``
runs COCO mask mAP (:mod:`sihl_tpu_torch.utils.coco_map`) over them.
``full_res_masks=True`` resizes the masks to the input's size (linear).
"""

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from sihl_tpu_torch.heads import anchors
from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.layers.convblocks import StandardConvNormAct, default_generator
from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops.boxes import bbox_matching, masks_to_boxes
from sihl_tpu_torch.ops.dynconv import dynamic_pointwise_decode, param_count
from sihl_tpu_torch.ops.image import packbits_last, resize_linear
from sihl_tpu_torch.ops.losses import binary_cross_entropy_with_logits, cross_entropy
from sihl_tpu_torch.policy import device_vector, upcast
from sihl_tpu_torch.training import metrics as M
from sihl_tpu_torch.utils.coco_map import MeanAveragePrecisionAccumulator


class InstanceSegmentation(Head):
    """https://arxiv.org/abs/2003.05664 (Conditional Convolutions)."""

    def __init__(
        self,
        in_channels: List[int],
        num_classes: int,
        mask_level: int = 3,
        bottom_level: int = 3,
        top_level: int = 5,
        num_channels: int = 256,
        num_layers: int = 4,
        max_instances: int = 100,
        max_targets: int = 100,
        max_mask_positives: int = 256,
        full_res_masks: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ) -> None:
        """
        Args:
            in_channels: channels of input feature maps by level.
            num_classes: number of object categories.
            mask_level: pyramid level of the mask features and of the masks.
            bottom_level/top_level: pyramid levels of the anchors.
            num_channels: conv/MLP width.
            num_layers: MLP depth.
            max_instances: fixed-size inference output slots.
            max_targets: ground-truth padding size (targets per image).
            max_mask_positives: anchors per image decoded in training.
            full_res_masks: masks resized (linear) to the input's resolution.
        """
        super().__init__()
        if num_classes <= 0 or max_instances <= 0 or num_channels % 4:
            raise ValueError((num_classes, max_instances, num_channels))
        if len(in_channels) <= top_level or not 0 < bottom_level <= top_level:
            raise ValueError((len(in_channels), bottom_level, top_level))
        generator = default_generator(generator)

        self.in_channels = in_channels
        self.num_classes = num_classes
        self.mask_level = mask_level
        self.bottom_level, self.top_level = bottom_level, top_level
        self.levels = range(bottom_level, top_level + 1)
        self.num_channels = num_channels
        self.max_instances = max_instances
        self.max_targets = max_targets
        self.max_mask_positives = max_mask_positives
        self.full_res_masks = full_res_masks
        self.topk = 9

        def conv(cin, cout, kernel_size, act=None):
            return StandardConvNormAct(cin, cout, kernel_size, act=act, generator=generator, device=device)

        self.laterals = nn.ModuleList(conv(in_channels[level], num_channels, 1) for level in self.levels)
        hidden = [num_channels] * num_layers

        def mlp(out, bias=None):
            return MLP(num_channels, hidden + [out], bias, generator=generator, device=device)

        self.loc_head = mlp(1, -5.0)
        self.cls_head = mlp(num_classes)
        c = self.mask_num_channels = 8
        self.kernel_head = mlp(param_count(c, 1))
        self.mask_lateral = conv(in_channels[mask_level], num_channels, 1)
        self.mask_head = conv(num_channels, c, 3, act="silu")

        scale = 2**mask_level
        self.output_shapes = {
            "num_instances": ("batch_size",),
            "scores": ("batch_size", max_instances),
            "classes": ("batch_size", max_instances),
            "masks": ("batch_size", max_instances, f"height/{scale}", f"width/{scale}"),
        }

    def get_offsets_and_scales(self, inputs):
        return anchors.cell_anchors(inputs, self.levels)

    def flat_features(self, inputs) -> torch.Tensor:
        return anchors.flatten_laterals(inputs, self.levels, self.laterals, self.num_channels)

    def _decode_masks(self, mask_feats, grid, centers, dyn_weights) -> torch.Tensor:
        """Mask logits (B, I, H, W) of (B, c, H, W) features, the (H, W, 2)
        grid, (B, I, 2) centres and (B, I, P) dynamic weights, in f32."""
        return dynamic_pointwise_decode(mask_feats, grid, centers, dyn_weights, self.mask_num_channels, 1)[..., 0]

    def _mask_grid(self, inputs) -> torch.Tensor:
        """Normalised (x, y) pixel-centre coordinates (H, W, 2) of the mask level."""
        return anchors.mask_grid(inputs[self.mask_level])

    def _mask_features(self, inputs) -> torch.Tensor:
        return self.mask_head(self.mask_lateral(inputs[self.mask_level]))

    def forward(self, inputs):
        """Returns (num_instances (B,), scores (B, I), classes (B, I), masks
        (B, I, H / 2^mask_level, W / 2^mask_level) as probabilities; (B, I,
        H, W) with ``full_res_masks``)."""
        flat_feats = self.flat_features(inputs)
        offsets, _ = self.get_offsets_and_scales(inputs)
        (loc_out,) = anchors.run_mlps(flat_feats, [self.loc_head], num_valid=offsets.shape[0])
        loc_logits = loc_out[..., 0].float()
        num_slots = min(self.max_instances, loc_logits.shape[1])
        # a stable descending sort puts the lower index first among equal
        # logits, as lax.top_k does; torch.topk promises no order on CUDA
        loc_logits, loc_idxs = torch.sort(loc_logits, dim=1, descending=True, stable=True)
        loc_logits, loc_idxs = loc_logits[:, :num_slots], loc_idxs[:, :num_slots]
        scores = torch.sigmoid(loc_logits)
        num_instances = torch.sum(scores > 0.5, dim=1)
        flat_feats = anchors.gather_anchor_rows(flat_feats, loc_idxs)
        centers = offsets[:, :2][loc_idxs]  # (B, I, 2)

        class_logits, dyn = anchors.run_mlps(
            flat_feats, [self.cls_head, self.kernel_head], num_valid=num_slots
        )
        mask_logits = self._decode_masks(self._mask_features(inputs), self._mask_grid(inputs), centers, dyn)
        classes = torch.argmax(class_logits, dim=2)
        masks = torch.sigmoid(mask_logits)
        if self.full_res_masks:
            masks = resize_linear(masks, inputs[0].shape[2:])
        return num_instances, scores, classes, masks

    def training_step(self, inputs, classes: torch.Tensor, masks: torch.Tensor):
        """classes: (B, T) integer with -1 padding; masks: (B, T, Hm, Wm)
        binary, at any resolution (boxes are scaled to input pixels).
        Returns (loss, metrics)."""
        if len(inputs) <= self.top_level:
            raise ValueError(f"need levels up to {self.top_level}, got {len(inputs)} inputs")
        height, width = inputs[0].shape[2:]
        offsets, scales = self.get_offsets_and_scales(inputs)
        device = offsets.device
        full_size = device_vector([width, height, width, height], device)

        # empty masks are invalid targets, as in the reference
        valid = (classes >= 0) & (masks > 0).flatten(2).any(dim=2)
        mh, mw = masks.shape[2:]
        scale = device_vector([width / mw, height / mh, width / mw, height / mh], device)
        boxes = masks_to_boxes(masks) * scale
        assignment, rel_iou = bbox_matching((offsets + scales) * full_size, boxes, valid, self.topk, relative=True)

        flat_feats = self.flat_features(inputs)
        (loc_out,) = anchors.run_mlps(flat_feats, [self.loc_head], num_valid=offsets.shape[0])
        loc_logits = upcast(loc_out[..., 0])
        loc_target = (rel_iou == 1.0).float()
        loc_loss = binary_cross_entropy_with_logits(loc_logits, loc_target).sum() / torch.clamp(
            loc_target.sum(), min=1.0
        )
        any_match = rel_iou.max() > 0.0

        # the positives of each image (a static count), in anchor order
        k = min(self.max_mask_positives, rel_iou.shape[1])
        pos_w, pos_idx = anchors.sort_positives(*torch.topk(rel_iou, k, dim=1))
        pos_feats = anchors.gather_anchor_rows(flat_feats, pos_idx)
        pos_assign = torch.clamp(torch.take_along_dim(assignment, pos_idx, dim=1), min=0).long()
        w_sum = torch.clamp(pos_w.sum(), min=1e-6)

        # mask dice loss over the positives' decoded masks
        centers = offsets[:, :2][pos_idx]  # (B, k, 2)
        class_logits, dyn = anchors.run_mlps(pos_feats, [self.cls_head, self.kernel_head], num_valid=k)
        mask_logits = self._decode_masks(self._mask_features(inputs), self._mask_grid(inputs), centers, dyn)
        mask_preds = torch.sigmoid(mask_logits)  # (B, k, h, w)
        # The reference gathers each positive's full-resolution mask, then
        # resizes them; the resize acts on each mask alone, so resizing the
        # (B, T) ground-truth masks first and then gathering gives the same
        # values without a (B, k, Hm, Wm) copy.
        target_masks = torch.take_along_dim(
            resize_linear(upcast(masks), mask_preds.shape[2:]), pos_assign[..., None, None], dim=1
        )
        numerator = (mask_preds * target_masks).sum(dim=(2, 3))
        denominator = (mask_preds**2 + target_masks**2).sum(dim=(2, 3))
        dice = 1.0 - 2.0 * numerator / torch.clamp(denominator, min=1e-6)
        mask_loss = (pos_w * dice).sum() / w_sum

        class_target = torch.take_along_dim(torch.clamp(classes, min=0), pos_assign, dim=1)
        class_loss = (pos_w * cross_entropy(class_logits, class_target)).sum() / w_sum

        # where no gt matched anywhere, only the location loss applies
        zero = torch.zeros((), device=device)
        mask_loss = torch.where(any_match, mask_loss, zero)
        class_loss = torch.where(any_match, class_loss, zero)
        loss = loc_loss + 10.0 * mask_loss + class_loss
        metrics = {"location_loss": loc_loss, "mask_loss": mask_loss, "class_loss": class_loss}
        return loss, metrics

    # -- validation --------------------------------------------------------
    def metrics_init(self):
        return {"loss": M.mean_init(self._device())}

    def validation_step(self, state, inputs, classes, masks):
        num_instances, scores, pred_classes, pred_masks = self(inputs)
        loss, _ = self.training_step(inputs, classes, masks)
        state = {"loss": M.mean_update(state["loss"], loss)}
        # binary masks cross to the host bit-packed, an eighth of the bytes
        aux = {
            "scores": scores,
            "pred_classes": pred_classes,
            "pred_masks_bits": packbits_last(pred_masks > 0.5),
            "pred_masks_width": pred_masks.shape[-1],
            "gt_classes": classes,
            "gt_masks_bits": packbits_last(masks > 0),
            "gt_masks_width": masks.shape[-1],
        }
        return state, loss, aux

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        out = {"loss": float(M.mean_compute(state["loss"]))}
        acc = MeanAveragePrecisionAccumulator(iou_type="segm")
        for aux in collected:
            pred = np.unpackbits(aux["pred_masks_bits"], axis=-1, bitorder="little")[..., : int(aux["pred_masks_width"])]
            gt = np.unpackbits(aux["gt_masks_bits"], axis=-1, bitorder="little")[..., : int(aux["gt_masks_width"])]
            acc.update(pred, aux["pred_classes"], aux["scores"], gt, aux["gt_classes"])
        out.update(acc.compute())
        return out
