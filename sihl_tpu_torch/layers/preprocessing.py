"""Input preprocessing (counterpart of ``sihl_tpu/layers/preprocessing.py``)."""

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from sihl_tpu_torch.policy import resolve_device


class Normalize(nn.Module):
    """Per-channel ``(x - mean) / std`` of (B, C, H, W), computed in the
    input's dtype, as the JAX package casts its f32 constants to it.  The
    constants are non-persistent buffers: the JAX module keeps them as plain
    arrays, neither a Param nor a BatchStat, so they are in no checkpoint of
    either package and come from the constructor alone."""

    def __init__(self, mean: List[float], std: List[float], *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32, device=device).reshape(1, -1, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32, device=device).reshape(1, -1, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)


class PadToMultipleOf(nn.Module):
    """Zero-pad the height and width of (B, C, H, W) up to multiples of
    ``n``; of an odd padding the extra pixel goes to the bottom and right."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad_y = (self.n - x.shape[2] % self.n) % self.n
        pad_x = (self.n - x.shape[3] % self.n) % self.n
        return F.pad(x, (pad_x // 2, pad_x - pad_x // 2, pad_y // 2, pad_y - pad_y // 2))
