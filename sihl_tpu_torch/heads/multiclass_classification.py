"""Multiclass classification head (counterpart of
``sihl_tpu/heads/multiclass_classification.py``).

The forward returns each image's largest class probability and its class
(``output_shapes`` of ``(B,)`` each), the JAX package's documented
deviation from upstream, which declares the scores (B, num_classes)
(PARITY.md).  The loss is cross-entropy with label smoothing, or, for
ordinal classes, the cross-entropy against soft ordinal labels; it and
the softmax are f32 (f64 for a model built under the f64 compute dtype).
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from sihl_tpu_torch.heads.base import GlobalPoolReadout, Head
from sihl_tpu_torch.ops.losses import cross_entropy
from sihl_tpu_torch.policy import upcast
from sihl_tpu_torch.training import metrics as M


def soft_ordinal_category(labels: torch.Tensor, num_labels: int, peakiness: float = 1.0) -> torch.Tensor:
    """Soft labels for ordinal regression (Diaz & Marathe, CVPR 2019): the f32
    softmax over the classes of ``-|class - label| * peakiness``, (N, num_labels)."""
    grid = torch.arange(num_labels, dtype=torch.float32, device=labels.device)
    return torch.softmax(-(grid[None, :] - labels[:, None].float()).abs() * peakiness, dim=1)


class MulticlassClassification(Head):
    """Prediction of the most probable category for an input image."""

    def __init__(
        self,
        in_channels: List[int],
        num_classes: int,
        num_channels: int = 256,
        num_layers: int = 1,
        level: int = 5,
        label_smoothing: float = 0.0,
        is_ordinal: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if num_classes <= 0 or num_channels <= 0 or num_layers <= 0:
            raise ValueError(f"num_classes, num_channels, num_layers must be > 0, got "
                             f"{num_classes}, {num_channels}, {num_layers}")
        if len(in_channels) <= level:
            raise ValueError(f"level {level} is not among {len(in_channels)} inputs")
        self.num_classes = num_classes
        self.level = level
        self.label_smoothing = label_smoothing
        self.is_ordinal = is_ordinal
        self.readout = GlobalPoolReadout(
            in_channels[level], num_channels, num_classes, num_layers, generator=generator, device=device
        )
        self.output_shapes = {"scores": ("batch_size",), "classes": ("batch_size",)}

    def logits(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        return self.readout(inputs[self.level])

    def forward(self, inputs: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = torch.softmax(upcast(self.logits(inputs)), dim=1)
        scores, classes = probs.max(dim=1)
        return scores, classes

    def _loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.is_ordinal:
            log_probs = F.log_softmax(upcast(logits), dim=1)
            soft = soft_ordinal_category(target, self.num_classes).to(log_probs.dtype)
            if self.label_smoothing > 0:
                soft = soft * (1 - self.label_smoothing) + self.label_smoothing / self.num_classes
            return (-(soft * log_probs).sum(dim=1)).mean()
        return cross_entropy(logits, target, label_smoothing=self.label_smoothing).mean()

    def training_step(self, inputs, target) -> Tuple[torch.Tensor, Dict]:
        return self._loss(self.logits(inputs), target), {}

    def metrics_init(self):
        device = self._device()
        return {"loss": M.mean_init(device), "cls": M.confusion_init(self.num_classes, device)}

    def validation_step(self, state, inputs, target):
        logits = self.logits(inputs)
        loss = self._loss(logits, target)
        state = {
            "loss": M.mean_update(state["loss"], loss),
            "cls": M.confusion_update(state["cls"], logits.argmax(dim=1), target),
        }
        return state, loss, {}

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        out = {"loss": float(M.mean_compute(state["loss"]))}
        out.update({k: float(v) for k, v in M.confusion_compute(state["cls"]).items()})
        return out
