"""Antialiased blur-pool module (counterpart of ``sihl_tpu/layers/pooling.py``)."""

import torch
from torch import nn

from sihl_tpu_torch.ops.image import blur_pool_2d


class BlurPool2d(nn.Module):
    """Binomial-kernel antialiased downsampling (https://arxiv.org/abs/1904.11486)."""

    def __init__(self, in_channels: int, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.in_channels = in_channels
        self.kernel_size = kernel_size
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return blur_pool_2d(x, self.kernel_size, self.stride)
