"""Barlow-Twins view-invariance head (counterpart of
``sihl_tpu/heads/view_invariance_learning.py``).

The trainer re-encodes the second view through the shared trunk and passes
its pyramid as the target (``target_is_second_view``), as the JAX
package's trainer does.
"""

from typing import Dict, List, Optional, Tuple

import torch

from sihl_tpu_torch.heads.base import GlobalPoolReadout, Head
from sihl_tpu_torch.policy import upcast
from sihl_tpu_torch.training import metrics as M


class ViewInvarianceLearning(Head):
    """https://arxiv.org/abs/2103.03230 (Barlow Twins)."""

    target_is_second_view = True

    def __init__(
        self,
        in_channels: List[int],
        embedding_dim: int = 1024,
        level: int = 5,
        num_channels: int = 256,
        num_layers: int = 4,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if level >= len(in_channels):
            raise ValueError(f"level {level} is not among {len(in_channels)} inputs")
        if num_channels <= 0 or num_layers <= 0:
            raise ValueError(f"num_channels, num_layers must be > 0, got {num_channels}, {num_layers}")
        self.level = level
        self.embedding_dim = embedding_dim
        self.num_channels = num_channels
        self.projector = GlobalPoolReadout(
            in_channels[level], num_channels, embedding_dim, num_layers, generator=generator, device=device
        )
        self.output_shapes = {"representations": ("batch_size", embedding_dim)}

    def forward(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        return self.projector(inputs[self.level])

    def get_correlation(self, inputs1, inputs2) -> torch.Tensor:
        """The (D, D) cross-correlation of the two views' embeddings, each
        standardised over the batch (standard deviation with Bessel's
        correction) where the batch has more than one image."""
        e1 = upcast(self.projector(inputs1[self.level]))
        e2 = upcast(self.projector(inputs2[self.level]))
        if e1.shape[0] > 1:
            e1 = (e1 - e1.mean(dim=0)) / e1.std(dim=0, correction=1)
            e2 = (e2 - e2.mean(dim=0)) / e2.std(dim=0, correction=1)
        return e1.T @ e2 / e1.shape[0]

    def _loss(self, cc: torch.Tensor) -> torch.Tensor:
        eye = torch.eye(cc.shape[0], dtype=cc.dtype, device=cc.device)
        invariance = ((cc * eye - eye) ** 2).sum()
        # the reference divides the redundancy by num_channels, not by embedding_dim
        redundancy = ((cc * (1 - eye)) ** 2).sum()
        return invariance + redundancy / self.num_channels

    def training_step(self, inputs1, inputs2) -> Tuple[torch.Tensor, Dict]:
        return self._loss(self.get_correlation(inputs1, inputs2)), {}

    def metrics_init(self):
        device = self._device()
        return {k: M.mean_init(device) for k in ("loss", "norm", "on_diag", "off_diag")}

    def validation_step(self, state, inputs1, inputs2):
        cc = self.get_correlation(inputs1, inputs2)
        loss = self._loss(cc)
        cc = cc.abs()
        dim = cc.shape[0]
        eye = torch.eye(dim, dtype=cc.dtype, device=cc.device)
        norm = torch.linalg.norm(cc - eye)
        max_diff_norm = torch.sqrt(torch.linalg.norm(cc) ** 2 + torch.linalg.norm(eye) ** 2)
        on_diag = (cc * eye).sum() / dim
        off_diag = (cc * (1 - eye)).sum() / (dim * dim - dim)
        state = {
            "loss": M.mean_update(state["loss"], loss),
            "norm": M.mean_update(state["norm"], norm / max_diff_norm),
            "on_diag": M.mean_update(state["on_diag"], on_diag),
            "off_diag": M.mean_update(state["off_diag"], off_diag),
        }
        return state, loss, {}

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        return {
            "loss": float(M.mean_compute(state["loss"])),
            "normalized_frobenius_norm": float(M.mean_compute(state["norm"])),
            "on_diagonal_mean": float(M.mean_compute(state["on_diag"])),
            "off_diagonal_mean": float(M.mean_compute(state["off_diag"])),
        }
