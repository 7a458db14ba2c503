"""Backbone factories (counterpart of ``sihl_tpu/backbones/__init__.py``)
over every family of the JAX package: the ResNet family (ResNetV2
included), MobileNet v2 / v3, EfficientNet (B0-B7, V2 S/M/L, lite0),
MNASNet, ConvNeXt v1 / v2, MobileNetV4, DenseNet, ShuffleNetV2, DLA and
HRNet.

``pretrained=True`` loads torchvision's weights from its cache directory
(:func:`~sihl_tpu_torch.backbones.torchvision_import.weights_file`), puts
ImageNet normalisation in front of a 3-channel trunk and freezes
``frozen_levels``; nothing is downloaded.
"""

from typing import Optional

import torch

from sihl_tpu_torch.backbones.base import PyramidBackbone
from sihl_tpu_torch.backbones.convnext import CONVNEXT_CONFIGS, make_convnext_features
from sihl_tpu_torch.backbones.densenet import DENSENET_CONFIGS, make_densenet_features
from sihl_tpu_torch.backbones.dla import DLA_CONFIGS, make_dla_features
from sihl_tpu_torch.backbones.efficientnet import EFFICIENTNET_CONFIGS, make_efficientnet_features
from sihl_tpu_torch.backbones.hrnet import HRNET_CONFIGS, make_hrnet_features
from sihl_tpu_torch.backbones.mnasnet import MNASNET_CONFIGS, make_mnasnet_features
from sihl_tpu_torch.backbones.mobilenet import MOBILENET_CONFIGS, make_mobilenet_features
from sihl_tpu_torch.backbones.mobilenetv4 import MOBILENETV4_CONFIGS, make_mobilenetv4_features
from sihl_tpu_torch.backbones.resnet import RESNET_CONFIGS, make_resnet_features
from sihl_tpu_torch.backbones.shufflenet import SHUFFLENET_CONFIGS, make_shufflenet_features
from sihl_tpu_torch.layers.convblocks import default_generator

_FEATURE_FACTORIES = {
    name: factory
    for configs, factory in (
        (RESNET_CONFIGS, make_resnet_features),
        (EFFICIENTNET_CONFIGS, make_efficientnet_features),
        (MOBILENET_CONFIGS, make_mobilenet_features),
        (MNASNET_CONFIGS, make_mnasnet_features),
        (CONVNEXT_CONFIGS, make_convnext_features),
        (MOBILENETV4_CONFIGS, make_mobilenetv4_features),
        (DENSENET_CONFIGS, make_densenet_features),
        (SHUFFLENET_CONFIGS, make_shufflenet_features),
        (DLA_CONFIGS, make_dla_features),
        (HRNET_CONFIGS, make_hrnet_features),
    )
    for name in configs
}


def backbone_names():
    return tuple(sorted(_FEATURE_FACTORIES))


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
    if name not in _FEATURE_FACTORIES:
        raise ValueError(f"Architecture {name} is not supported. Select from {backbone_names()}")
    generator = default_generator(generator)
    features = _FEATURE_FACTORIES[name](name, input_channels=input_channels, generator=generator, device=device)
    if pretrained:
        from sihl_tpu_torch.backbones.torchvision_import import load_torchvision_weights

        load_torchvision_weights(features, name, input_channels)
    return PyramidBackbone(
        name, features, input_channels=input_channels, top_level=top_level, frozen_levels=frozen_levels,
        pretrained=pretrained, freeze_batchnorms=freeze_batchnorms, generator=generator, device=device,
    )


TorchvisionBackbone = Backbone

# timm architecture names and the native feature nets they map onto (the
# JAX package's whole table)
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
    return Backbone(
        _TIMM_ALIASES[name], pretrained=pretrained, input_channels=input_channels, top_level=top_level,
        frozen_levels=frozen_levels, freeze_batchnorms=freeze_batchnorms, generator=generator, device=device,
    )


__all__ = ["Backbone", "PyramidBackbone", "TimmBackbone", "TorchvisionBackbone", "backbone_names"]
