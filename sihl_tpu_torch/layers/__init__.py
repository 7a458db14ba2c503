"""Layers of the port."""

from sihl_tpu_torch.layers.bifpn import BiFPN
from sihl_tpu_torch.layers.convblocks import (
    ConvNormAct,
    Identity,
    SeparableConv2d,
    SequentialConvBlocks,
    StandardConvNormAct,
)
from sihl_tpu_torch.layers.fpn import FPN
from sihl_tpu_torch.layers.hybrid_encoder import CSPRepLayer, HybridEncoder, RepVGGBlock
from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.layers.pooling import BlurPool2d
from sihl_tpu_torch.layers.scalers import (
    AntialiasedDownscaler,
    BilinearAdditiveUpscaler,
    Interpolate,
    SimpleDownscaler,
    SimpleUpscaler,
    StridedDownscaler,
)
from sihl_tpu_torch.layers.transformer import TransformerDecoderLayer, TransformerEncoderLayer

__all__ = [
    "AntialiasedDownscaler",
    "BiFPN",
    "BilinearAdditiveUpscaler",
    "BlurPool2d",
    "CSPRepLayer",
    "ConvNormAct",
    "FPN",
    "HybridEncoder",
    "Identity",
    "Interpolate",
    "MLP",
    "RepVGGBlock",
    "SeparableConv2d",
    "SequentialConvBlocks",
    "SimpleDownscaler",
    "SimpleUpscaler",
    "StandardConvNormAct",
    "StridedDownscaler",
    "TransformerDecoderLayer",
    "TransformerEncoderLayer",
]
