"""BiFPN neck (counterpart of ``sihl_tpu/layers/bifpn.py``).

``FastNormalizedFusion`` keeps the reference's softmax weighting (not the
paper's ReLU / (sum + eps)), with the softmax in f32 (f64 for the f64
compute dtype), and fuses through
:func:`~sihl_tpu_torch.ops.fusion.fused_weighted_sum` (K6).  The top-down
pass upsamples with :func:`~sihl_tpu_torch.ops.image.upsample2x_nearest`,
the bottom-up pass downsamples with ``AntialiasedDownscaler``.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import ConvNormAct, default_generator
from sihl_tpu_torch.layers.scalers import AntialiasedDownscaler
from sihl_tpu_torch.ops.fusion import fused_weighted_sum
from sihl_tpu_torch.ops.image import upsample2x_nearest
from sihl_tpu_torch.policy import resolve_device


class FastNormalizedFusion(nn.Module):
    def __init__(self, num_inputs: int = 2, *, device=None):
        super().__init__()
        self.weights = nn.Parameter(torch.ones(num_inputs, device=resolve_device(device)))

    def forward(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        dtype = torch.promote_types(inputs[0].dtype, torch.float32)
        return fused_weighted_sum(torch.softmax(self.weights.to(dtype), dim=0), inputs)


class BiFPNLayer(nn.Module):
    def __init__(self, out_channels: int, num_levels: int, *, generator=None, device=None, **kwargs):
        super().__init__()
        if num_levels < 2:
            raise ValueError(f"a BiFPN layer needs at least 2 levels, got {num_levels}")
        self.num_levels = num_levels
        n = num_levels - 1
        init = dict(generator=default_generator(generator), device=device)
        self.up_fusions = nn.ModuleList(FastNormalizedFusion(2, device=device) for _ in range(n))
        self.up_convs = nn.ModuleList(ConvNormAct(out_channels, out_channels, **init, **kwargs) for _ in range(n))
        self.downscalers = nn.ModuleList(
            AntialiasedDownscaler(out_channels, out_channels, **init, **kwargs) for _ in range(n)
        )
        self.down_fusions = nn.ModuleList(FastNormalizedFusion(3, device=device) for _ in range(n))
        self.down_convs = nn.ModuleList(
            ConvNormAct(out_channels, out_channels, **init, **kwargs) for _ in range(n)
        )

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        if len(inputs) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels, got {len(inputs)}")
        top_down = [inputs[-1]]
        for idx, (conv, fuse) in enumerate(zip(self.up_convs, self.up_fusions)):
            top_down.append(conv(fuse([upsample2x_nearest(top_down[-1]), inputs[-2 - idx]])))
        top_down = top_down[::-1]  # lowest level first
        bottom_up = [top_down[0]]
        for idx, (conv, fuse, downscale) in enumerate(
            zip(self.down_convs, self.down_fusions, self.downscalers)
        ):
            args = [downscale(bottom_up[-1]), inputs[idx + 1], top_down[idx + 1]]
            bottom_up.append(conv(fuse(args)))
        return bottom_up


class BiFPN(nn.Module):
    """https://arxiv.org/abs/1911.09070"""

    def __init__(
        self,
        in_channels: List[int],
        out_channels: int,
        bottom_level: int,
        top_level: int,
        num_layers: int = 3,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
        **kwargs,
    ):
        super().__init__()
        if num_layers <= 0 or not 0 < bottom_level < top_level:
            raise ValueError(f"need num_layers > 0 and 0 < bottom_level < top_level, got "
                             f"{num_layers}, {bottom_level}, {top_level}")
        init = dict(generator=default_generator(generator), device=device)
        # the backbone's levels below bottom_level pass through, as in the JAX package
        self.out_channels = list(in_channels[:bottom_level]) + [out_channels] * (top_level - bottom_level + 1)
        self.bottom_level = bottom_level
        self.top_level = top_level
        self.lateral_connections = nn.ModuleList(
            ConvNormAct(in_c, out_channels, kernel_size=1, **init, **kwargs)
            for in_c in in_channels[bottom_level : top_level + 1]
        )
        self.downscalers = nn.ModuleList(
            AntialiasedDownscaler(out_channels, out_channels, **init, **kwargs)
            for _ in range(top_level + 1 - len(in_channels))
        )
        num_levels = top_level - bottom_level + 1
        self.layers = nn.ModuleList(
            BiFPNLayer(out_channels, num_levels, **init, **kwargs) for _ in range(num_layers)
        )

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        features = [
            lateral(inputs[self.bottom_level + idx])
            for idx, lateral in enumerate(self.lateral_connections)
        ]
        for downscaler in self.downscalers:
            features.append(downscaler(features[-1]))
        for layer in self.layers:
            features = layer(features)
        return list(inputs[: self.bottom_level]) + features + list(inputs[self.top_level + 1 :])
