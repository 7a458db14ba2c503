"""Autoencoding head (counterpart of ``sihl_tpu/heads/autoencoding.py``):
encode the top level into a compact vector, decode back to image space.
Self-supervised; the target is the input image, (B, C, H, W) in [0, 1].

The bottleneck's ``Linear`` layers take and give the (h, w, c) order of the
JAX package's NHWC maps, so that carried weights compute the same thing:
the NCHW maps are permuted to NHWC before they are flattened, and back
after the decode is reshaped.
"""

from typing import Dict, List, Optional, Tuple

import torch

from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.layers.convblocks import ConvNormAct, SequentialConvBlocks, default_generator
from sihl_tpu_torch.layers.mlp import Linear
from sihl_tpu_torch.layers.scalers import SimpleUpscaler
from sihl_tpu_torch.ops.image import interpolate
from sihl_tpu_torch.ops.relu import relu
from sihl_tpu_torch.policy import upcast
from sihl_tpu_torch.training import metrics as M


class Autoencoding(Head):
    def __init__(
        self,
        in_channels: List[int],
        level: int = 5,
        num_channels: int = 256,
        num_layers: int = 3,
        representation_channels: int = 1024,
        prebottleneck_size: Tuple[int, int] = (4, 4),
        activation: Optional[str] = "sigmoid",
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if num_channels <= 0 or num_layers <= 0:
            raise ValueError(f"num_channels, num_layers must be > 0, got {num_channels}, {num_layers}")
        if not len(in_channels) > level > 0:
            raise ValueError(f"level {level} is not among the {len(in_channels) - 1} levels")
        generator = default_generator(generator)
        init = dict(generator=generator, device=device)
        self.level = level
        self.size = tuple(prebottleneck_size)
        self.num_channels = num_channels
        flat = num_channels * self.size[0] * self.size[1]

        self.encode_conv = ConvNormAct(in_channels[level], num_channels, 1, **init)
        self.encode_linear = Linear(flat, representation_channels, **init)
        self.decode_linear = Linear(representation_channels, flat, **init)
        self.upscalers = torch.nn.ModuleList(SimpleUpscaler(num_channels, num_channels, **init) for _ in range(level))
        self.refine = SequentialConvBlocks(num_channels, num_channels, num_layers, **init)
        self.out_conv = ConvNormAct(num_channels, in_channels[0], 1, norm=None, act=activation, **init)
        # the ReLUs on the bottleneck's raw outputs, held as attributes that a
        # caller may wrap (as the depth head's)
        self.encode_act = relu
        self.decode_act = relu
        self.output_shapes = {
            "reconstructions": ("batch_size", in_channels[0], "height", "width"),
            "representations": ("batch_size", representation_channels),
        }

    def forward(self, inputs: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        x = inputs[self.level]
        b, _, h, w = x.shape
        enc = interpolate(self.encode_conv(x), size=self.size, mode="bilinear")
        representations = self.encode_act(self.encode_linear(enc.permute(0, 2, 3, 1).reshape(b, -1)))

        dec = self.decode_act(self.decode_linear(representations))
        dec = dec.reshape(b, self.size[0], self.size[1], self.num_channels).permute(0, 3, 1, 2)
        dec = interpolate(dec, size=(h, w), mode="bilinear")
        for up in self.upscalers:
            dec = up(dec)
        reconstructions = self.out_conv(self.refine(dec))
        return reconstructions, representations

    def _loss(self, reconstructions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return ((upcast(reconstructions) - upcast(targets)) ** 2).mean()

    def training_step(self, inputs, targets) -> Tuple[torch.Tensor, Dict]:
        reconstructions, _ = self(inputs)
        return self._loss(reconstructions, targets), {}

    def metrics_init(self):
        device = self._device()
        return {"loss": M.mean_init(device), "reg": M.regression_init(device)}

    def validation_step(self, state, inputs, targets):
        reconstructions, _ = self(inputs)
        loss = self._loss(reconstructions, targets)
        state = {
            "loss": M.mean_update(state["loss"], loss),
            "reg": M.regression_update(state["reg"], reconstructions, targets),
        }
        return state, loss, {}

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        reg = M.regression_compute(state["reg"])
        return {
            "loss": float(M.mean_compute(state["loss"])),
            "mean_absolute_error": float(reg["mean_absolute_error"]),
            "mean_squared_error": float(reg["mean_squared_error"]),
        }
