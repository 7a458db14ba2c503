"""Panoptic segmentation head (counterpart of
``sihl_tpu/heads/panoptic_segmentation.py``): a PP-LiteSeg semantic
decoder over the stuff and thing classes (:class:`SemanticSegmentation`)
and a CondInst instance branch over the thing classes
(:class:`InstanceSegmentation`), fused on the device at inference.

Fusion: every live instance (score > 0.5) claims the pixels where its
mask is > 0.5, and a pixel takes the claiming instance of lowest index
(the highest score, as the instances come sorted), else the semantic
argmax.  The JAX package pastes the instances in a loop from the lowest
priority to the highest; here one pass finds each pixel's first claiming
index, which gives the same integer maps.

``soft_label_decay_steps`` decays the semantic loss's label smoothing
linearly from 0.1 to 0 over that many steps, counted by ``step_counter``,
an int32 buffer on the device: each training step adds one, a validation
step takes its own back, and the smoothing is computed from it on the
device without a host sync.

Targets (padded): ``semantic`` (B, H, W) integer (stuff then thing
classes, ``ignore_index`` for void), ``classes`` (B, T) thing classes
(-1 padded), ``masks`` (B, T, Hm, Wm) binary; the host-side
:func:`panoptic_targets_from_maps` builds the last two from a semantic map
and an instance-id map.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.heads.instance_segmentation import InstanceSegmentation
from sihl_tpu_torch.heads.semantic_segmentation import SemanticSegmentation
from sihl_tpu_torch.layers.convblocks import default_generator
from sihl_tpu_torch.ops.image import interpolate, packbits_last
from sihl_tpu_torch.ops.losses import cross_entropy
from sihl_tpu_torch.policy import resolve_device, upcast
from sihl_tpu_torch.training import metrics as M
from sihl_tpu_torch.utils.panoptic_quality import PanopticQuality


def panoptic_targets_from_maps(
    semantic_map: np.ndarray,
    id_map: np.ndarray,
    num_stuff_classes: int,
    max_targets: int,
    ignore_index: int = -100,
):
    """Host-side conversion of a semantic map and an instance-id map (H, W)
    into padded head targets (numpy; for the input pipeline): a copy of
    ``sihl_tpu/heads/panoptic_segmentation.py:47-65``."""
    thing_region = (semantic_map >= num_stuff_classes) & (semantic_map != ignore_index)
    classes = np.full((max_targets,), -1, np.int64)
    masks = np.zeros((max_targets,) + id_map.shape, np.float32)
    ids = np.unique(id_map[thing_region])
    for t, seg_id in enumerate(ids[:max_targets]):
        sel = (id_map == seg_id) & thing_region
        cls_vals, counts = np.unique(semantic_map[sel], return_counts=True)
        classes[t] = int(cls_vals[np.argmax(counts)]) - num_stuff_classes
        masks[t] = sel
    return classes, masks


def panoptic_fusion(sem_classes: torch.Tensor, scores: torch.Tensor, inst_classes: torch.Tensor,
                    inst_masks: torch.Tensor, num_stuff_classes: int):
    """(class_map, id_map) int32 (B, H, W) of the semantic classes (B, H, W)
    and the instances' scores (B, I), thing classes (B, I) and mask
    probabilities (B, I, H, W): each pixel takes the first live instance
    (score > 0.5) whose mask there is > 0.5, its thing class (after the
    stuff classes) and id ``index + 1``, else its semantic class and id 0.
    The JAX package's loop pastes the instances from the last to the first,
    so the first claim is the one that stays."""
    b, i, h, w = inst_masks.shape
    claim = (inst_masks > 0.5) & (scores > 0.5)[:, :, None, None]
    order = torch.arange(i, dtype=torch.int32, device=claim.device)[None, :, None, None]
    first = torch.where(claim, order, i).amin(dim=1)  # (B, H, W); i where no instance claims
    claimed = first < i
    first = torch.clamp(first, max=i - 1).long()
    thing = torch.take_along_dim(inst_classes, first.reshape(b, -1), dim=1).reshape(b, h, w)
    class_map = torch.where(claimed, thing + num_stuff_classes, sem_classes).to(torch.int32)
    id_map = torch.where(claimed, first + 1, 0).to(torch.int32)
    return class_map, id_map


class PanopticSegmentation(Head):
    def __init__(
        self,
        in_channels: List[int],
        num_stuff_classes: int,
        num_thing_classes: int,
        bottom_level: int = 3,
        top_level: int = 5,
        mask_top_level: int = 5,
        mask_level: int = 3,
        num_channels: int = 256,
        num_layers: int = 4,
        max_instances: int = 100,
        max_targets: int = 100,
        soft_label_decay_steps: int = 0,
        ignore_index: int = -100,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if num_stuff_classes < 0 or num_thing_classes <= 0:
            raise ValueError(f"need num_stuff_classes >= 0 and num_thing_classes > 0, got "
                             f"{num_stuff_classes}, {num_thing_classes}")
        generator = default_generator(generator)
        self.num_stuff_classes = num_stuff_classes
        self.num_thing_classes = num_thing_classes
        self.ignore_index = ignore_index
        self.soft_label_decay_steps = soft_label_decay_steps
        self.max_instances = max_instances
        self.semantic = SemanticSegmentation(
            in_channels,
            num_stuff_classes + num_thing_classes,
            bottom_level=bottom_level,
            top_level=mask_top_level,
            num_channels=num_channels,
            num_layers=max(num_layers - 2, 1),
            ignore_index=ignore_index,
            generator=generator,
            device=device,
        )
        self.instance = InstanceSegmentation(
            in_channels,
            num_thing_classes,
            mask_level=mask_level,
            bottom_level=bottom_level,
            top_level=top_level,
            num_channels=num_channels,
            num_layers=num_layers,
            max_instances=max_instances,
            max_targets=max_targets,
            generator=generator,
            device=device,
        )
        self.register_buffer("step_counter", torch.zeros((), dtype=torch.int32, device=resolve_device(device)))

        scale = 2**mask_level
        self.output_shapes = {
            "class_maps": ("batch_size", f"height/{scale}", f"width/{scale}"),
            "instance_maps": ("batch_size", f"height/{scale}", f"width/{scale}"),
            "num_instances": ("batch_size",),
            "scores": ("batch_size", max_instances),
            "classes": ("batch_size", max_instances),
        }

    # -- inference: panoptic fusion ---------------------------------------
    def forward(self, inputs):
        """(class_maps, instance_maps) (B, H / 2^mask_level, W /
        2^mask_level) int32, then the instance branch's num_instances,
        scores and classes; instance ids count from 1, 0 is no instance."""
        sem_logits = self.semantic.get_logits(inputs)
        num_instances, scores, inst_classes, inst_masks = self.instance(inputs)
        sem_logits = interpolate(sem_logits, size=inst_masks.shape[2:], mode="bilinear")
        sem_classes = upcast(sem_logits).argmax(dim=1)
        class_map, id_map = panoptic_fusion(sem_classes, scores, inst_classes, inst_masks, self.num_stuff_classes)
        return class_map, id_map, num_instances, scores, inst_classes

    # -- training ----------------------------------------------------------
    def _label_smoothing(self):
        """0.1 decayed linearly to 0 over ``soft_label_decay_steps`` steps of
        ``step_counter``: an f32 tensor on the device, or a Python 0 when
        there is no decay (the loss then skips the blend)."""
        if self.soft_label_decay_steps <= 0:
            return 0.0
        frac = torch.clamp(1.0 - self.step_counter / self.soft_label_decay_steps, 0.0, 1.0)
        return 0.1 * frac

    def training_step(self, inputs, semantic: torch.Tensor, classes: torch.Tensor, masks: torch.Tensor):
        smoothing = self._label_smoothing()
        self.step_counter.add_(1)

        sem_logits = interpolate(self.semantic.get_logits(inputs), size=semantic.shape[1:3])
        ce = cross_entropy(sem_logits, semantic, label_smoothing=smoothing, ignore_index=self.ignore_index, dim=1)
        valid = (semantic != self.ignore_index).to(ce.dtype)
        semantic_loss = ce.sum() / torch.clamp(valid.sum(), min=1.0)

        instance_loss, inst_metrics = self.instance.training_step(inputs, classes, masks)
        loss = semantic_loss + instance_loss
        metrics = {"semantic_loss": semantic_loss}
        metrics.update(inst_metrics)
        return loss, metrics

    # -- validation --------------------------------------------------------
    def metrics_init(self):
        device = self._device()
        return {
            "loss": M.mean_init(device),
            "seg": M.segmentation_init(self.num_stuff_classes + self.num_thing_classes, device),
        }

    def validation_step(self, state, inputs, semantic, classes, masks):
        loss, _ = self.training_step(inputs, semantic, classes, masks)
        self.step_counter.sub_(1)  # a validation step does not count
        class_map, id_map, num_instances, scores, inst_classes = self(inputs)
        sem_small = interpolate(
            semantic[:, None].to(torch.float32), size=class_map.shape[1:3], mode="nearest"
        )[:, 0].to(torch.int32)
        state = {
            "loss": M.mean_update(state["loss"], loss),
            "seg": M.segmentation_update(state["seg"], class_map, sem_small, ignore_index=self.ignore_index),
        }
        aux = {
            "class_map": class_map,
            "id_map": id_map,
            "gt_semantic": sem_small,
            "gt_classes": classes,
            # binary masks cross to the host bit-packed, an eighth of the bytes
            "gt_masks_bits": packbits_last(masks > 0),
            "gt_masks_width": masks.shape[-1],
        }
        return state, loss, aux

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        seg = M.segmentation_compute(state["seg"])
        out = {
            "loss": float(M.mean_compute(state["loss"])),
            "semantic_mean_iou": float(seg["mean_iou"]),
        }
        pq = PanopticQuality(self.num_stuff_classes, self.ignore_index)
        for aux in collected:
            class_map = np.asarray(aux["class_map"])
            id_map = np.asarray(aux["id_map"])
            gt_sem = np.asarray(aux["gt_semantic"])
            gt_classes = np.asarray(aux["gt_classes"])
            gt_masks = np.unpackbits(
                np.asarray(aux["gt_masks_bits"]), axis=-1, bitorder="little"
            )[..., : int(aux["gt_masks_width"])]
            for b in range(class_map.shape[0]):
                gt_ids = np.zeros_like(id_map[b])
                h, w = gt_ids.shape
                for t in range(gt_classes.shape[1]):
                    if gt_classes[b, t] < 0:
                        continue
                    m = gt_masks[b, t]
                    ys = (np.arange(h) * (m.shape[0] / h)).astype(np.int64)
                    xs = (np.arange(w) * (m.shape[1] / w)).astype(np.int64)
                    gt_ids[m[ys][:, xs]] = t + 1
                pq.update(class_map[b], id_map[b], gt_sem[b], gt_ids)
        out.update(pq.compute())
        return out
