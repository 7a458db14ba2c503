"""Layers of the port."""

from sihl_tpu_torch.layers.attention import CBAM, ChannelAttention, CrossCBAM, SpatialAttention
from sihl_tpu_torch.layers.bifpn import BiFPN, FastNormalizedFusion
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
from sihl_tpu_torch.layers.pan import PAN
from sihl_tpu_torch.layers.pooling import BlurPool2d
from sihl_tpu_torch.layers.preprocessing import Normalize, PadToMultipleOf
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
    "CBAM",
    "CSPRepLayer",
    "ChannelAttention",
    "ConvNormAct",
    "CrossCBAM",
    "FPN",
    "FastNormalizedFusion",
    "HybridEncoder",
    "Identity",
    "Interpolate",
    "MLP",
    "Normalize",
    "PAN",
    "PadToMultipleOf",
    "RepVGGBlock",
    "SeparableConv2d",
    "SequentialConvBlocks",
    "SimpleDownscaler",
    "SimpleUpscaler",
    "SpatialAttention",
    "StandardConvNormAct",
    "StridedDownscaler",
    "TransformerDecoderLayer",
    "TransformerEncoderLayer",
]
