"""Backbone factories (counterpart of ``sihl_tpu/backbones/__init__.py``)
over the ResNet family, ResNetV2 included.  The other families follow in
ROADMAP.md, M17.

``pretrained=True`` loads torchvision's weights from its cache directory
(:func:`~sihl_tpu_torch.backbones.torchvision_import.weights_file`), puts
ImageNet normalisation in front of a 3-channel trunk and freezes
``frozen_levels``; nothing is downloaded.
"""

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
    frozen_levels: int = 0,
    freeze_batchnorms: bool = False,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> PyramidBackbone:
    """Build a pyramid backbone by architecture name: the feature net from
    ``generator``, then torchvision's weights where ``pretrained``, then the
    pyramid wrapper.  ``frozen_levels`` takes effect only with
    ``pretrained``; freeze a random-weight trunk with ``set_frozen_levels``.
    ``freeze_batchnorms`` makes the frozen levels' BatchNorms use their
    running statistics in training."""
    if name not in RESNET_CONFIGS:
        raise ValueError(f"Architecture {name} is not supported. Select from {backbone_names()}")
    generator = default_generator(generator)
    features = make_resnet_features(name, input_channels=input_channels, generator=generator, device=device)
    if pretrained:
        from sihl_tpu_torch.backbones.torchvision_import import load_torchvision_weights

        load_torchvision_weights(features, name, input_channels)
    return PyramidBackbone(
        name, features, input_channels=input_channels, top_level=top_level, frozen_levels=frozen_levels,
        pretrained=pretrained, freeze_batchnorms=freeze_batchnorms, generator=generator, device=device,
    )


TorchvisionBackbone = Backbone

# timm architecture names and the native feature nets they map onto (the
# JAX package's whole table); a name whose family the port lacks raises
_TIMM_ALIASES = {
    "resnet18": "resnet18",
    "resnet34": "resnet34",
    "resnet50": "resnet50",
    "resnet101": "resnet101",
    "resnet152": "resnet152",
    "resnext50_32x4d": "resnext50_32x4d",
    "resnext101_32x8d": "resnext101_32x8d",
    "resnext101_64x4d": "resnext101_64x4d",
    "wide_resnet50_2": "wide_resnet50_2",
    "wide_resnet101_2": "wide_resnet101_2",
    "efficientnet_b0": "efficientnet_b0",
    "efficientnet_b1": "efficientnet_b1",
    "efficientnet_b2": "efficientnet_b2",
    "efficientnet_b3": "efficientnet_b3",
    "efficientnet_b4": "efficientnet_b4",
    "efficientnet_b5": "efficientnet_b5",
    "mobilenetv2_100": "mobilenet_v2",
    "mobilenetv2_050": "mobilenet_v2_050",
    "mobilenetv2_140": "mobilenet_v2_140",
    "mobilenetv3_large_100": "mobilenet_v3_large",
    "mobilenetv3_small_100": "mobilenet_v3_small",
    "mobilenetv3_small_050": "mobilenet_v3_small_050",
    "mobilenetv3_small_075": "mobilenet_v3_small_075",
    "convnext_tiny": "convnext_tiny",
    "convnext_small": "convnext_small",
    "convnext_base": "convnext_base",
    "convnext_large": "convnext_large",
    "densenet121": "densenet121",
    "densenet161": "densenet161",
    "densenet169": "densenet169",
    "mnasnet_100": "mnasnet1_0",
    "mnasnet_050": "mnasnet0_5",
    "efficientnetv2_s": "efficientnet_v2_s",
    "efficientnetv2_m": "efficientnet_v2_m",
    "efficientnetv2_l": "efficientnet_v2_l",
    "resnet26": "resnet26",
    "resnetv2_50": "resnetv2_50",
    "resnetv2_101": "resnetv2_101",
    "efficientnet_lite0": "efficientnet_lite0",
    "convnext_atto": "convnext_atto",
    "convnext_femto": "convnext_femto",
    "convnext_pico": "convnext_pico",
    "convnext_nano": "convnext_nano",
    "convnext_xlarge": "convnext_xlarge",
    "convnext_xxlarge": "convnext_xxlarge",
    "convnextv2_atto": "convnextv2_atto",
    "convnextv2_femto": "convnextv2_femto",
    "convnextv2_pico": "convnextv2_pico",
    "convnextv2_nano": "convnextv2_nano",
    "convnextv2_tiny": "convnextv2_tiny",
    "convnextv2_base": "convnextv2_base",
    "convnextv2_large": "convnextv2_large",
    "dla34": "dla34",
    "dla60": "dla60",
    "dla102": "dla102",
    "dla169": "dla169",
    "hrnet_w18": "hrnet_w18",
    "hrnet_w30": "hrnet_w30",
    "hrnet_w32": "hrnet_w32",
    "hrnet_w40": "hrnet_w40",
    "hrnet_w44": "hrnet_w44",
    "hrnet_w48": "hrnet_w48",
    "hrnet_w64": "hrnet_w64",
    "mobilenetv4_conv_small": "mobilenetv4_conv_small",
    "mobilenetv4_conv_medium": "mobilenetv4_conv_medium",
    "mobilenetv4_conv_large": "mobilenetv4_conv_large",
    "mobilenetv4_hybrid_medium": "mobilenetv4_hybrid_medium",
    "mobilenetv4_hybrid_large": "mobilenetv4_hybrid_large",
}


def TimmBackbone(
    name: str,
    pretrained: bool = False,
    input_channels: int = 3,
    top_level: int = 5,
    frozen_levels: int = 0,
    freeze_batchnorms: bool = False,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> PyramidBackbone:
    """timm-style naming front-end over :func:`Backbone`."""
    if name not in _TIMM_ALIASES:
        raise ValueError(f"Architecture {name} is not supported. Select from {tuple(sorted(_TIMM_ALIASES))}")
    native = _TIMM_ALIASES[name]
    if native not in RESNET_CONFIGS:
        raise NotImplementedError(
            f"{name} maps onto {native}, whose feature net the port does not build yet (ROADMAP.md, M17)"
        )
    return Backbone(
        native, pretrained=pretrained, input_channels=input_channels, top_level=top_level,
        frozen_levels=frozen_levels, freeze_batchnorms=freeze_batchnorms, generator=generator, device=device,
    )


__all__ = ["Backbone", "PyramidBackbone", "TimmBackbone", "TorchvisionBackbone", "backbone_names"]
