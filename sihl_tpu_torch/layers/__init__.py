"""Layers of the port."""

from sihl_tpu_torch.layers.convblocks import StandardConvNormAct
from sihl_tpu_torch.layers.fpn import FPN
from sihl_tpu_torch.layers.mlp import MLP

__all__ = ["FPN", "MLP", "StandardConvNormAct"]
