"""Pyramid backbone wrapper (counterpart of ``sihl_tpu/backbones/base.py``).

Contract: the output is ``[input] + [level1..top_level]`` where
``outputs[l]`` has spatial size exactly ``(H/2^l, W/2^l)``, and
``out_channels[0] == input_channels``; input H and W must be divisible by
``2**top_level``.  The input is moved to channels_last memory here, once,
and every layer after keeps that layout.
"""

from typing import List

import torch
from torch import nn

from sihl_tpu_torch.ops.image import interpolate


class PyramidBackbone(nn.Module):
    """Wraps a feature net into the sihl pyramid contract."""

    def __init__(self, name: str, features: nn.Module, input_channels: int = 3, top_level: int = 5):
        super().__init__()
        if top_level < 1:
            raise ValueError(f"top_level must be >= 1, got {top_level}")
        if top_level > len(features.feature_channels):
            raise NotImplementedError(
                "levels above the feature net's top need AntialiasedDownscaler, "
                "which is not ported yet (ROADMAP.md, M16)"
            )
        self.name = name
        self.input_channels = input_channels
        self.top_level = top_level
        self.features = features
        self.out_channels = [input_channels] + list(features.feature_channels[:top_level])

    def forward(self, input: torch.Tensor) -> List[torch.Tensor]:
        h, w = input.shape[2:]
        if h % 2**self.top_level or w % 2**self.top_level:
            raise ValueError(
                f"input spatial dims {(h, w)} must be divisible by 2^{self.top_level}"
            )
        input = input.contiguous(memory_format=torch.channels_last)
        feats = self.features(input)[: self.top_level]
        return [input] + [
            interpolate(f, size=(h // 2**level, w // 2**level))
            for f, level in zip(feats, range(1, self.top_level + 1))
        ]
