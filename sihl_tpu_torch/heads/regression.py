"""Scalar regression head (counterpart of ``sihl_tpu/heads/regression.py``).

A conv tower and a 1x1 conv to one channel, the sigmoid of every pixel
*before* the mean over H and W (the order of upstream's ``nn.Sequential``),
then the normalised value mapped onto ``[lower_bound, upper_bound]`` and
clipped there.  The loss is log-cosh on normalised targets; validation
scores the denormalised predictions.
"""

from typing import Dict, List, Optional, Tuple

import torch

from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.layers.convblocks import SequentialConvBlocks, default_generator, make_conv
from sihl_tpu_torch.ops.losses import log_cosh_loss
from sihl_tpu_torch.training import metrics as M


class Regression(Head):
    """Prediction of a scalar within a given finite interval."""

    def __init__(
        self,
        in_channels: List[int],
        lower_bound: float,
        upper_bound: float,
        level: int = 5,
        num_channels: int = 256,
        num_layers: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if not lower_bound < upper_bound:
            raise ValueError(f"lower_bound {lower_bound} must be below upper_bound {upper_bound}")
        if num_channels <= 0 or num_layers <= 0:
            raise ValueError(f"num_channels, num_layers must be > 0, got {num_channels}, {num_layers}")
        if len(in_channels) <= level:
            raise ValueError(f"level {level} is not among {len(in_channels)} inputs")
        generator = default_generator(generator)
        self.level = level
        self.lower_bound = float(lower_bound)
        self.upper_bound = float(upper_bound)
        self.convs = SequentialConvBlocks(
            in_channels[level], num_channels, num_layers, generator=generator, device=device
        )
        self.out_conv = make_conv(num_channels, 1, 1, generator=generator, device=device)
        self.output_shapes = {"values": ("batch_size",)}

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.lower_bound) / (self.upper_bound - self.lower_bound)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        x = x * (self.upper_bound - self.lower_bound) + self.lower_bound
        return torch.clamp(x, self.lower_bound, self.upper_bound)

    def predict_normalized(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        x = torch.sigmoid(self.out_conv(self.convs(inputs[self.level])))
        return x.mean(dim=(1, 2, 3))

    def forward(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        return self.denormalize(self.predict_normalized(inputs))

    def training_step(self, inputs, targets) -> Tuple[torch.Tensor, Dict]:
        preds = self.predict_normalized(inputs)
        return log_cosh_loss(preds, self.normalize(targets)).mean(), {}

    def metrics_init(self):
        device = self._device()
        return {"loss": M.mean_init(device), "reg": M.regression_init(device)}

    def validation_step(self, state, inputs, targets):
        preds = self.predict_normalized(inputs)
        loss = log_cosh_loss(preds, self.normalize(targets)).mean()
        state = {
            "loss": M.mean_update(state["loss"], loss),
            "reg": M.regression_update(state["reg"], self.denormalize(preds), targets),
        }
        return state, loss, {}

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        out = {"loss": float(M.mean_compute(state["loss"]))}
        out.update({k: float(v) for k, v in M.regression_compute(state["reg"]).items()})
        return out
