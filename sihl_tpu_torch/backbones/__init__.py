"""Backbone factory (counterpart of ``sihl_tpu/backbones/__init__.py``) over
the ResNet family.  Other families follow in ROADMAP.md, M10 and M17."""

from typing import Optional

import torch

from sihl_tpu_torch.backbones.base import PyramidBackbone
from sihl_tpu_torch.backbones.resnet import RESNET_CONFIGS, make_resnet_features
from sihl_tpu_torch.layers.convblocks import default_generator


def backbone_names():
    return tuple(sorted(RESNET_CONFIGS))


def Backbone(
    name: str,
    pretrained: bool = False,
    input_channels: int = 3,
    top_level: int = 5,
    freeze_batchnorms: bool = False,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> PyramidBackbone:
    """Build a pyramid backbone by architecture name, with random weights.
    Freeze levels with ``set_frozen_levels``; ``freeze_batchnorms`` makes the
    frozen levels' BatchNorms use their running statistics in training."""
    if name not in RESNET_CONFIGS:
        raise ValueError(f"Architecture {name} is not supported. Select from {backbone_names()}")
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not available to the port (no weight files on disk); "
            "ROADMAP.md, M10"
        )
    generator = default_generator(generator)
    features = make_resnet_features(
        name, input_channels=input_channels, generator=generator, device=device
    )
    return PyramidBackbone(
        name, features, input_channels=input_channels, top_level=top_level,
        freeze_batchnorms=freeze_batchnorms, generator=generator, device=device,
    )


__all__ = ["Backbone", "PyramidBackbone", "backbone_names"]
