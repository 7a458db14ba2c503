"""FCPose keypoint detection head (counterpart of
``sihl_tpu/heads/keypoint_detection.py``).

The dynamic-kernel trick of instance segmentation with c = 32 channels and
K heatmap outputs: a ``kernel_head`` MLP emits, per instance, the 2,737
weights (at K = 17) of a 3-layer pointwise net that decodes the instance's
K heatmaps from shared mask features and coordinates relative to the
instance's anchor (:func:`~sihl_tpu_torch.ops.dynconv.dynamic_pointwise_decode`,
kernels K5f and K5b on the card); a ``presence_head`` predicts each
keypoint's visibility.  Both MLPs run in one fused call (K1f and K1b on
the card, the kernel MLP's output on the tensor cores).

Inference: the loc MLP dense over every anchor, the top ``max_instances``
anchors by loc logit, then the presence and kernel MLPs over those rows and
the decode of their heatmaps at ``mask_level`` resolution; each keypoint is
its heatmap's first maximum, at the pixel's centre in input pixels.  The
decode fixes the reference's row/col mix-up as the JAX package does
(``//`` and ``%`` by the map's width).

Training: each instance's box is the box of its visible keypoints
(``keypoints_to_boxes``), every image's padded ground truth is matched to
the anchors at once, and the ``max_mask_positives`` anchors of highest
relative IoU per image are decoded; a spatial softmax cross-entropy per
keypoint against one-hot target heatmaps, and a BCE on presence.

Validation: the loss's mean on the device; keypoints and presence cross to
the host, and ``validation_end`` runs PCK at 0.05 of the image size
(:mod:`sihl_tpu_torch.utils.pck`).

Targets: ``keypoints (B, T, K, 2)`` absolute xy, ``presence (B, T, K)``
bool; padded instances have all-false presence.
"""

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sihl_tpu_torch.heads import anchors
from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.layers.convblocks import StandardConvNormAct, default_generator
from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops.boxes import bbox_matching
from sihl_tpu_torch.ops.dynconv import dynamic_pointwise_decode, param_count
from sihl_tpu_torch.ops.losses import binary_cross_entropy_with_logits
from sihl_tpu_torch.policy import device_vector, upcast
from sihl_tpu_torch.training import metrics as M
from sihl_tpu_torch.utils.pck import PercentageOfCorrectKeypoints


class KeypointDetection(Head):
    """https://arxiv.org/abs/2105.14185 (FCPose)."""

    def __init__(
        self,
        in_channels: List[int],
        num_keypoints: int,
        mask_level: int = 3,
        bottom_level: int = 5,
        top_level: int = 5,
        num_channels: int = 256,
        num_layers: int = 4,
        max_instances: int = 100,
        max_targets: int = 100,
        max_mask_positives: int = 128,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ) -> None:
        """
        Args:
            in_channels: channels of input feature maps by level.
            num_keypoints: keypoints per instance (K).
            mask_level: pyramid level of the mask features and the heatmaps.
            bottom_level/top_level: pyramid levels of the anchors.
            num_channels: conv/MLP width.
            num_layers: MLP depth.
            max_instances: fixed-size inference output slots.
            max_targets: ground-truth padding size (targets per image).
            max_mask_positives: anchors per image decoded in training.
        """
        super().__init__()
        if num_keypoints <= 0 or num_channels % 4:
            raise ValueError((num_keypoints, num_channels))
        if len(in_channels) <= top_level or not 0 < bottom_level <= top_level:
            raise ValueError((len(in_channels), bottom_level, top_level))
        generator = default_generator(generator)

        self.in_channels = in_channels
        self.num_keypoints = num_keypoints
        self.mask_level = mask_level
        self.bottom_level, self.top_level = bottom_level, top_level
        self.levels = range(bottom_level, top_level + 1)
        self.num_channels = num_channels
        self.max_instances = max_instances
        self.max_targets = max_targets
        self.max_mask_positives = max_mask_positives
        self.topk = 9

        def conv(cin, cout, kernel_size, act=None):
            return StandardConvNormAct(cin, cout, kernel_size, act=act, generator=generator, device=device)

        self.laterals = nn.ModuleList(conv(in_channels[level], num_channels, 1) for level in self.levels)
        hidden = [num_channels] * num_layers

        def mlp(out, bias=None):
            return MLP(num_channels, hidden + [out], bias, generator=generator, device=device)

        self.loc_head = mlp(1, -5.0)
        self.presence_head = mlp(num_keypoints)
        c = self.mask_num_channels = 32
        self.kernel_head = mlp(param_count(c, num_keypoints))
        self.mask_lateral = conv(in_channels[mask_level], num_channels, 1)
        self.mask_head = conv(num_channels, c, 3, act="silu")

        self.output_shapes = {
            "num_instances": ("batch_size",),
            "scores": ("batch_size", max_instances),
            "presence": ("batch_size", max_instances, num_keypoints),
            "keypoints": ("batch_size", max_instances, num_keypoints, 2),
        }

    def get_offsets_and_scales(self, inputs):
        return anchors.cell_anchors(inputs, self.levels)

    def flat_features(self, inputs) -> torch.Tensor:
        return anchors.flatten_laterals(inputs, self.levels, self.laterals, self.num_channels)

    def _mask_grid(self, inputs) -> torch.Tensor:
        """Normalised (x, y) pixel-centre coordinates (H, W, 2) of the mask level."""
        return anchors.mask_grid(inputs[self.mask_level])

    def _split_dynamic_weights(self, dyn: torch.Tensor):
        """(..., P) -> w1 (..., c + 2, c), b1, w2 (..., c, c), b2, w3 (..., c, K), b3."""
        c, k = self.mask_num_channels, self.num_keypoints
        lead = dyn.shape[:-1]
        s0 = (c + 2) * c
        w1 = dyn[..., :s0].reshape(*lead, c + 2, c)
        b1 = dyn[..., s0 : s0 + c]
        s1 = s0 + c
        w2 = dyn[..., s1 : s1 + c * c].reshape(*lead, c, c)
        s2 = s1 + c * c
        b2 = dyn[..., s2 : s2 + c]
        s3 = s2 + c
        w3 = dyn[..., s3 : s3 + c * k].reshape(*lead, c, k)
        b3 = dyn[..., s3 + c * k :]
        return w1, b1, w2, b2, w3, b3

    def _decode_heatmaps(self, inputs, centers, dyn) -> torch.Tensor:
        """(B, I, H, W, K) heatmap logits in f32 of the (B, I, 2) centres and
        (B, I, P) dynamic weights over the mask level."""
        mask_feats = self.mask_head(self.mask_lateral(inputs[self.mask_level]))
        return dynamic_pointwise_decode(
            mask_feats, self._mask_grid(inputs), centers, dyn, self.mask_num_channels, self.num_keypoints
        )

    def forward(self, inputs, output_heatmaps: bool = False):
        """Returns (num_instances (B,), scores (B, I), presence (B, I, K),
        keypoints (B, I, K, 2) as xy in input pixels); with
        ``output_heatmaps``, the heatmaps (B, I, H, W, K) as probabilities
        over each map's pixels."""
        full_h, full_w = inputs[0].shape[2:]
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

        presence_out, dyn = anchors.run_mlps(flat_feats, [self.presence_head, self.kernel_head], num_valid=num_slots)
        heatmaps = self._decode_heatmaps(inputs, centers, dyn)
        b, i, mh, mw, k = heatmaps.shape
        flat = heatmaps.reshape(b, i, mh * mw, k)
        if output_heatmaps:
            return torch.softmax(flat, dim=2).reshape(b, i, mh, mw, k)

        flat_idxs = torch.argmax(flat, dim=2)  # (B, I, K), the first maximum
        kpts_y = torch.div(flat_idxs, mw, rounding_mode="floor").float()
        kpts_x = (flat_idxs % mw).float()
        kpts_y = (kpts_y + 0.5) / mh * full_h
        kpts_x = (kpts_x + 0.5) / mw * full_w
        keypoints = torch.stack([kpts_x, kpts_y], dim=3)
        presence = torch.sigmoid(presence_out.float())
        return num_instances, scores, presence, keypoints

    def get_saliency(self, inputs) -> torch.Tensor:
        """(B, H, W): the largest heatmap probability over instances and keypoints."""
        return torch.amax(self(inputs, output_heatmaps=True), dim=(1, 4))

    # -- training ----------------------------------------------------------
    @staticmethod
    def keypoints_to_boxes(keypoints: torch.Tensor, presence: torch.Tensor) -> torch.Tensor:
        """Enclosing box (..., 4) of each instance's visible keypoints; 0 where
        none is visible."""
        vis = presence[..., None]
        low = torch.where(vis, keypoints, float("inf")).amin(dim=-2)
        high = torch.where(vis, keypoints, float("-inf")).amax(dim=-2)
        boxes = torch.cat([low, high], dim=-1)
        return torch.where(presence.any(dim=-1)[..., None], boxes, 0.0)

    def keypoints_to_heatmaps(self, keypoints, presence, height: int, width: int, img_h: int, img_w: int):
        """One-hot target heatmaps (..., K, height, width) in f32 of
        keypoints in an img_h x img_w image, zero where absent."""
        xs = torch.clamp(torch.round(keypoints[..., 0] * (width - 1) / (img_w - 1)), 0, width - 1).long()
        ys = torch.clamp(torch.round(keypoints[..., 1] * (height - 1) / (img_h - 1)), 0, height - 1).long()
        # one-hot rows by comparison, as ops/losses.py builds them: off the card
        # ``F.one_hot`` reads its indices' range on the host
        one_x = (xs[..., None] == torch.arange(width, device=xs.device)).float()
        one_y = (ys[..., None] == torch.arange(height, device=ys.device)).float()
        heat = one_y[..., :, None] * one_x[..., None, :]
        return heat * presence[..., None, None]

    def training_step(self, inputs, keypoints: torch.Tensor, presence: torch.Tensor):
        """keypoints: (B, T, K, 2) xy in input pixels; presence: (B, T, K)
        bool, all false on padded rows.  Returns (loss, metrics)."""
        if len(inputs) <= self.top_level:
            raise ValueError(f"need levels up to {self.top_level}, got {len(inputs)} inputs")
        full_h, full_w = inputs[0].shape[2:]
        presence = presence.bool()
        keypoints = keypoints.float()
        valid = presence.any(dim=2)  # (B, T)
        boxes = self.keypoints_to_boxes(keypoints, presence)
        offsets, scales = self.get_offsets_and_scales(inputs)
        device = offsets.device
        full_size = device_vector([full_w, full_h, full_w, full_h], device)
        assignment, rel_iou = bbox_matching((offsets + scales) * full_size, boxes, valid, self.topk, relative=True)

        flat_feats = self.flat_features(inputs)
        (loc_out,) = anchors.run_mlps(flat_feats, [self.loc_head], num_valid=offsets.shape[0])
        loc_logits = upcast(loc_out[..., 0])
        loc_target = (rel_iou == 1.0).float()
        loc_loss = binary_cross_entropy_with_logits(loc_logits, loc_target).sum() / torch.clamp(
            loc_target.sum(), min=1.0
        )
        any_match = rel_iou.max() > 0.0

        # the positives of each image (a static count), in anchor order; the
        # stable sort takes the lowest index first among equal IoUs, as
        # lax.top_k does
        k = min(self.max_mask_positives, rel_iou.shape[1])
        pos_w, pos_idx = torch.sort(rel_iou, dim=1, descending=True, stable=True)
        pos_w, pos_idx = anchors.sort_positives(pos_w[:, :k], pos_idx[:, :k])
        pos_feats = anchors.gather_anchor_rows(flat_feats, pos_idx)
        pos_assign = torch.clamp(torch.take_along_dim(assignment, pos_idx, dim=1), min=0).long()
        w_sum = torch.clamp(pos_w.sum(), min=1e-6)

        # presence loss
        presence_out, dyn = anchors.run_mlps(pos_feats, [self.presence_head, self.kernel_head], num_valid=k)
        target_presence = torch.take_along_dim(presence.float(), pos_assign[..., None], dim=1)  # (B, k, K)
        p_bce = binary_cross_entropy_with_logits(presence_out, target_presence)
        presence_loss = (pos_w[..., None] * p_bce).sum() / w_sum

        # keypoint heatmap loss: a spatial softmax cross-entropy per keypoint
        centers = offsets[:, :2][pos_idx]  # (B, k, 2)
        heat_logits = self._decode_heatmaps(inputs, centers, dyn)
        b, i, mh, mw, nk = heat_logits.shape
        target_kpts = torch.take_along_dim(keypoints, pos_assign[..., None, None], dim=1)  # (B, k, K, 2)
        target_heat = self.keypoints_to_heatmaps(target_kpts, target_presence, mh, mw, full_h, full_w)
        log_probs = F.log_softmax(heat_logits.reshape(b, i, mh * mw, nk), dim=2)
        target_flat = target_heat.permute(0, 1, 3, 4, 2).reshape(b, i, mh * mw, nk)
        kp_ce = -(target_flat * log_probs).sum(dim=2)  # (B, k, K)
        keypoint_loss = (pos_w[..., None] * kp_ce).sum() / w_sum

        # where no gt matched anywhere, only the location loss applies
        zero = torch.zeros((), dtype=loc_loss.dtype, device=device)
        presence_loss = torch.where(any_match, presence_loss, zero)
        keypoint_loss = torch.where(any_match, keypoint_loss, zero)
        loss = loc_loss + keypoint_loss + presence_loss
        metrics = {"location_loss": loc_loss, "keypoint_loss": keypoint_loss, "presence_loss": presence_loss}
        return loss, metrics

    # -- validation --------------------------------------------------------
    def metrics_init(self):
        return {"loss": M.mean_init(self._device())}

    def validation_step(self, state, inputs, keypoints, presence):
        num_instances, _, pred_presence, pred_keypoints = self(inputs)
        loss, _ = self.training_step(inputs, keypoints, presence)
        state = {"loss": M.mean_update(state["loss"], loss)}
        full_h, full_w = inputs[0].shape[2:]
        full = device_vector([full_w, full_h], pred_keypoints.device)
        aux = {
            "num_instances": num_instances,
            "pred_presence": pred_presence,
            "pred_keypoints": pred_keypoints / full,
            "gt_keypoints": keypoints.float() / full,
            "gt_presence": presence,
        }
        return state, loss, aux

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        pck = PercentageOfCorrectKeypoints(threshold=0.05)
        for aux in collected:
            n = np.asarray(aux["num_instances"])
            for b in range(len(n)):
                gt_valid = np.asarray(aux["gt_presence"][b]).any(axis=1)
                pck.update(
                    np.asarray(aux["pred_keypoints"][b])[: n[b]],
                    np.asarray(aux["pred_presence"][b])[: n[b]],
                    np.asarray(aux["gt_keypoints"][b])[gt_valid],
                    np.asarray(aux["gt_presence"][b])[gt_valid],
                )
        metrics = pck.compute()
        metrics["loss"] = float(M.mean_compute(state["loss"]))
        return metrics
