"""Layers of the port."""

from sihl_tpu_torch.layers.bifpn import BiFPN
from sihl_tpu_torch.layers.convblocks import ConvNormAct, StandardConvNormAct
from sihl_tpu_torch.layers.fpn import FPN
from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.layers.pooling import BlurPool2d
from sihl_tpu_torch.layers.scalers import AntialiasedDownscaler

__all__ = ["AntialiasedDownscaler", "BiFPN", "BlurPool2d", "ConvNormAct", "FPN", "MLP", "StandardConvNormAct"]
