"""CBAM-style attention blocks (counterpart of ``sihl_tpu/layers/attention.py``);
public API, used by no head in either package."""

from typing import Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator, make_conv
from sihl_tpu_torch.ops.relu import relu


class SpatialAttention(nn.Module):
    """https://arxiv.org/abs/1807.06521"""

    def __init__(self, kernel_size: int = 7, *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.conv = make_conv(2, 1, kernel_size, padding=kernel_size // 2, generator=default_generator(generator),
                              device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg_out = x.mean(dim=1, keepdim=True)
        max_out = x.amax(dim=1, keepdim=True)
        return torch.sigmoid(self.conv(torch.cat([avg_out, max_out], dim=1)))


class ChannelAttention(nn.Module):
    """https://arxiv.org/abs/1807.06521"""

    def __init__(self, in_channels: int, ratio: int = 16, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        generator = default_generator(generator)
        hidden = max(in_channels // ratio, 1)
        self.conv1 = make_conv(in_channels, hidden, 1, generator=generator, device=device)
        self.conv2 = make_conv(hidden, in_channels, 1, generator=generator, device=device)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(relu(self.conv1(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg_out = self._mlp(x.mean(dim=(2, 3), keepdim=True))
        max_out = self._mlp(x.amax(dim=(2, 3), keepdim=True))
        return torch.sigmoid(avg_out + max_out)


class CBAM(nn.Module):
    """https://arxiv.org/abs/1807.06521

    ``kernel_size`` is also ChannelAttention's ratio, and ``ratio`` is
    unused: the reference passes it so (``attention.py:49``), and the JAX
    package keeps that for parity."""

    def __init__(self, in_channels: int, kernel_size: int = 7, ratio: int = 16, applied: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator = default_generator(generator)
        self.applied = applied
        self.channel_attention = ChannelAttention(in_channels, kernel_size, generator=generator, device=device)
        self.spatial_attention = SpatialAttention(kernel_size, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.channel_attention(x) * x
        attention = self.spatial_attention(x) * x
        return attention * x if self.applied else attention


class CrossCBAM(nn.Module):
    """https://arxiv.org/abs/2306.02306"""

    def __init__(self, in_channels: int, kernel_size: int = 7, ratio: int = 16, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        init = dict(generator=default_generator(generator), device=device)
        self.channel_attention_high = ChannelAttention(in_channels, ratio, **init)
        self.spatial_attention_high = SpatialAttention(kernel_size, **init)
        self.channel_attention_low = ChannelAttention(in_channels, ratio, **init)
        self.spatial_attention_low = SpatialAttention(kernel_size, **init)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        mid_low = self.channel_attention_low(low) * high
        mid_high = self.channel_attention_high(high) * low
        out_low = self.spatial_attention_low(mid_low) * mid_high
        out_high = self.spatial_attention_high(mid_high) * mid_low
        return out_low + out_high
