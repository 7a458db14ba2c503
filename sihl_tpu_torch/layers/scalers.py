"""Down-scaling blocks (counterpart of ``sihl_tpu/layers/scalers.py``).

Only ``AntialiasedDownscaler`` is ported, for BiFPN; the other scalers
wait for their callers (ROADMAP.md, M16).
"""

from typing import Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import ConvNormAct
from sihl_tpu_torch.layers.pooling import BlurPool2d


class AntialiasedDownscaler(nn.Module):
    """ConvNormAct followed by a stride-2 BlurPool."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
        **kwargs,
    ):
        super().__init__()
        self.conv = ConvNormAct(
            in_channels, out_channels, kernel_size, generator=generator, device=device, **kwargs
        )
        self.pool = BlurPool2d(out_channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pool(self.conv(x))
