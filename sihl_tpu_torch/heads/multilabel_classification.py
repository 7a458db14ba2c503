"""Multilabel classification head (counterpart of
``sihl_tpu/heads/multilabel_classification.py``).

The forward returns every label's f32 sigmoid score sorted in descending
order, with the label indices in that order; among equal scores the lower
label comes first, as ``jnp.argsort(-p)`` (a stable sort) orders them.
The loss is binary cross-entropy on the logits; validation counts the
decisions ``logit > 0`` against ``target > 0.5``.
"""

from typing import Dict, List, Optional, Tuple

import torch

from sihl_tpu_torch.heads.base import GlobalPoolReadout, Head
from sihl_tpu_torch.ops.losses import binary_cross_entropy_with_logits
from sihl_tpu_torch.policy import upcast
from sihl_tpu_torch.training import metrics as M


class MultilabelClassification(Head):
    """Prediction of the subset of labels relevant to an input image."""

    def __init__(
        self,
        in_channels: List[int],
        num_labels: int,
        num_channels: int = 256,
        num_layers: int = 1,
        level: int = 5,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if num_labels <= 0 or num_channels <= 0 or num_layers <= 0:
            raise ValueError(f"num_labels, num_channels, num_layers must be > 0, got "
                             f"{num_labels}, {num_channels}, {num_layers}")
        if len(in_channels) <= level:
            raise ValueError(f"level {level} is not among {len(in_channels)} inputs")
        self.num_labels = num_labels
        self.level = level
        self.readout = GlobalPoolReadout(
            in_channels[level], num_channels, num_labels, num_layers, generator=generator, device=device
        )
        self.output_shapes = {"scores": ("batch_size", num_labels), "labels": ("batch_size", num_labels)}

    def logits(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        return self.readout(inputs[self.level])

    def forward(self, inputs: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = torch.sigmoid(upcast(self.logits(inputs)))
        scores, labels = torch.sort(probs, dim=1, descending=True, stable=True)
        return scores, labels

    def training_step(self, inputs, target) -> Tuple[torch.Tensor, Dict]:
        return binary_cross_entropy_with_logits(self.logits(inputs), target).mean(), {}

    def metrics_init(self):
        device = self._device()
        return {"loss": M.mean_init(device), "stats": M.binary_stats_init(device)}

    def validation_step(self, state, inputs, target):
        logits = self.logits(inputs)
        loss = binary_cross_entropy_with_logits(logits, target).mean()
        state = {
            "loss": M.mean_update(state["loss"], loss),
            "stats": M.binary_stats_update(state["stats"], logits > 0, target > 0.5),
        }
        return state, loss, {}

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        out = {"loss": float(M.mean_compute(state["loss"]))}
        out.update({k: float(v) for k, v in M.binary_stats_compute(state["stats"]).items()})
        return out
