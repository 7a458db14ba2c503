"""Pyramid backbone wrapper (counterpart of ``sihl_tpu/backbones/base.py``).

Contract: the output is ``[input] + [level1..top_level]`` where
``outputs[l]`` has spatial size exactly ``(H/2^l, W/2^l)``, and
``out_channels[0] == input_channels``; levels above the feature net's top
are made by :class:`AntialiasedDownscaler`\\ s (``downscalers``), each from
the level below; input H and W must be divisible by ``2**top_level``.  The
input is moved to channels_last memory here, once, and every layer after
keeps that layout.  ImageNet normalisation (:class:`Normalize`) runs in
front of the feature net only when ``pretrained and input_channels == 3``;
``outputs[0]`` is the raw input all the same.

A feature net plugged into this wrapper exposes ``feature_channels`` (the
channels of levels 1..n), ``level_modules`` (attribute names per level, for
freezing) and honours ``_sg_levels``: the levels up to it run without a
gradient, so a frozen prefix has no backward pass.
"""

from typing import List, Optional, Sequence

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import BatchNorm2d, default_generator
from sihl_tpu_torch.layers.preprocessing import Normalize
from sihl_tpu_torch.layers.scalers import AntialiasedDownscaler
from sihl_tpu_torch.ops.image import interpolate

IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]


class PyramidBackbone(nn.Module):
    """Wraps a feature net into the sihl pyramid contract."""

    def __init__(
        self,
        name: str,
        features: nn.Module,
        input_channels: int = 3,
        top_level: int = 5,
        frozen_levels: int = 0,
        pretrained: bool = False,
        freeze_batchnorms: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        """``frozen_levels`` takes effect only with ``pretrained``, as in the
        JAX package; a random-weight trunk is frozen with
        :meth:`set_frozen_levels`."""
        super().__init__()
        if top_level < 1:
            raise ValueError(f"top_level must be >= 1, got {top_level}")
        self.name = name
        self.input_channels = input_channels
        self.top_level = top_level
        self.features = features
        self.normalize = (
            Normalize(IMAGENET_MEAN, IMAGENET_STD, device=device) if pretrained and input_channels == 3 else None
        )
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
        self.set_frozen_levels(frozen_levels if pretrained else 0)
        if self.frozen_levels != 0 and freeze_batchnorms:
            self._set_frozen_bn_eval()

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

    @property
    def dummy_input(self) -> torch.Tensor:
        """The smallest valid input: zeros of (1, input_channels,
        2^(top_level+1), 2^(top_level+1)) on the backbone's device."""
        size = 2 ** (self.top_level + 1)
        device = next(self.features.parameters()).device
        return torch.zeros(1, self.input_channels, size, size, device=device)

    def forward(self, input: torch.Tensor) -> List[torch.Tensor]:
        h, w = input.shape[2:]
        if h % 2**self.top_level or w % 2**self.top_level:
            raise ValueError(
                f"input spatial dims {(h, w)} must be divisible by 2^{self.top_level}"
            )
        input = input.contiguous(memory_format=torch.channels_last)
        x = self.normalize(input) if self.normalize is not None else input
        feats = self.features(x)[: self.native_levels]
        outputs = [input] + [
            interpolate(f, size=(h // 2**level, w // 2**level))
            for f, level in zip(feats, range(1, self.native_levels + 1))
        ]
        for downscaler in self.downscalers:
            outputs.append(downscaler(outputs[-1]))
        return outputs
