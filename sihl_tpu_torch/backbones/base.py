"""Pyramid backbone wrapper (counterpart of ``sihl_tpu/backbones/base.py``).

Contract: the output is ``[input] + [level1..top_level]`` where
``outputs[l]`` has spatial size exactly ``(H/2^l, W/2^l)``, and
``out_channels[0] == input_channels``; levels above the feature net's top
are made by :class:`AntialiasedDownscaler`\\ s (``downscalers``), each from
the level below; input H and W must be divisible by ``2**top_level``.  The
input is moved to channels_last memory here, once, and every layer after
keeps that layout.

A feature net plugged into this wrapper exposes ``feature_channels`` (the
channels of levels 1..n), ``level_modules`` (attribute names per level, for
freezing) and honours ``_sg_levels``: the levels up to it run without a
gradient, so a frozen prefix has no backward pass.
"""

from typing import List, Optional, Sequence

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import BatchNorm2d, default_generator
from sihl_tpu_torch.layers.scalers import AntialiasedDownscaler
from sihl_tpu_torch.ops.image import interpolate


class PyramidBackbone(nn.Module):
    """Wraps a feature net into the sihl pyramid contract."""

    def __init__(
        self,
        name: str,
        features: nn.Module,
        input_channels: int = 3,
        top_level: int = 5,
        freeze_batchnorms: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if top_level < 1:
            raise ValueError(f"top_level must be >= 1, got {top_level}")
        self.name = name
        self.input_channels = input_channels
        self.top_level = top_level
        self.features = features
        self.native_levels = min(top_level, len(features.feature_channels))
        channels = [input_channels] + list(features.feature_channels[: self.native_levels])
        top_c = channels[-1]
        generator = default_generator(generator)
        self.downscalers = nn.ModuleList(
            AntialiasedDownscaler(top_c, top_c, generator=generator, device=device)
            for _ in range(top_level - self.native_levels)
        )
        self.out_channels = channels + [top_c] * (top_level - self.native_levels)
        self.freeze_batchnorms = freeze_batchnorms
        self.set_frozen_levels(0)

    def set_frozen_levels(self, frozen_levels: int) -> None:
        """Freeze the first ``frozen_levels`` levels (all of them if < 0):
        their parameters leave the optimizer and, since the feature net cuts
        the gradient after the deepest frozen level, they have no backward."""
        self.frozen_levels = frozen_levels
        n = len(self.features.feature_channels)
        self.features._sg_levels = n if frozen_levels < 0 else min(max(frozen_levels, 0), n)

    # -- freezing ---------------------------------------------------------
    def frozen_attr_names(self) -> List[str]:
        """Feature-net attribute names whose parameters must not be updated."""
        mods = self.features.level_modules
        k = len(mods) if self.frozen_levels < 0 else min(self.frozen_levels, len(mods))
        return [name for level in mods[:k] for name in level]

    def is_frozen_param(self, feature_path: Sequence[str]) -> bool:
        """Whether a parameter path relative to ``features`` (its dotted name
        split, ``("stem", "conv", "weight")``) is frozen."""
        return len(feature_path) > 0 and str(feature_path[0]) in self.frozen_attr_names()

    def _set_frozen_bn_eval(self) -> None:
        """Frozen levels' BatchNorms normalise with their running statistics."""
        for name in self.frozen_attr_names():
            for sub in getattr(self.features, name).modules():
                if isinstance(sub, BatchNorm2d):
                    sub.eval()

    def forward(self, input: torch.Tensor) -> List[torch.Tensor]:
        h, w = input.shape[2:]
        if h % 2**self.top_level or w % 2**self.top_level:
            raise ValueError(
                f"input spatial dims {(h, w)} must be divisible by 2^{self.top_level}"
            )
        input = input.contiguous(memory_format=torch.channels_last)
        feats = self.features(input)[: self.native_levels]
        outputs = [input] + [
            interpolate(f, size=(h // 2**level, w // 2**level))
            for f, level in zip(feats, range(1, self.native_levels + 1))
        ]
        for downscaler in self.downscalers:
            outputs.append(downscaler(outputs[-1]))
        return outputs
