"""Up- and down-scaling blocks (counterpart of ``sihl_tpu/layers/scalers.py``)."""

from typing import Optional, Tuple, Union

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import ConvNormAct, ConvTranspose2d, default_generator
from sihl_tpu_torch.layers.pooling import BlurPool2d
from sihl_tpu_torch.ops.image import avg_pool2d, interpolate as _interpolate


class StridedDownscaler(ConvNormAct):
    """A ConvNormAct of stride 2."""

    def __init__(self, in_channels: int, out_channels: int, *, generator=None, device=None, **kwargs):
        super().__init__(in_channels, out_channels, stride=2, generator=generator, device=device, **kwargs)


class AntialiasedDownscaler(nn.Module):
    """ConvNormAct followed by a stride-2 BlurPool."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
        **kwargs,
    ):
        super().__init__()
        self.conv = ConvNormAct(
            in_channels, out_channels, kernel_size, generator=generator, device=device, **kwargs
        )
        self.pool = BlurPool2d(out_channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pool(self.conv(x))


class SimpleDownscaler(nn.Module):
    """ConvNormAct followed by a 2x2 average pool of stride 2."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
        **kwargs,
    ):
        super().__init__()
        self.conv = ConvNormAct(
            in_channels, out_channels, kernel_size, generator=generator, device=device, **kwargs
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool2d(self.conv(x), 2, stride=2)


class Interpolate(nn.Module):
    """:func:`~sihl_tpu_torch.ops.image.interpolate` as a module."""

    def __init__(
        self,
        scale: Optional[Union[float, int]] = None,
        size: Optional[Union[int, Tuple[int, int]]] = None,
        mode: str = "bilinear",
    ):
        super().__init__()
        self.scale, self.size, self.mode = scale, size, mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = (self.size, self.size) if isinstance(self.size, int) else self.size
        return _interpolate(x, size=size, scale=self.scale, mode=self.mode)


class SimpleUpscaler(nn.Module):
    """2x bilinear upscale, then a ConvNormAct."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.conv = ConvNormAct(in_channels, out_channels, kernel_size, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_interpolate(x, scale=2, mode="bilinear"))


class BilinearAdditiveUpscaler(nn.Module):
    """https://arxiv.org/abs/1707.05847: the 2x bilinear upscale averaged
    over four channel groups, plus a learned 2x2 transposed conv of stride
    2, then a ConvNormAct."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if in_channels % 4:
            raise ValueError(f"in_channels must be a multiple of 4, got {in_channels}")
        generator = default_generator(generator)
        self.in_channels = in_channels
        self.residual = ConvTranspose2d(
            in_channels, in_channels // 4, 2, 2, generator=generator, device=device
        )
        self.out_conv = ConvNormAct(
            in_channels // 4, out_channels, kernel_size=kernel_size, generator=generator, device=device
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        up = _interpolate(x, scale=2, mode="bilinear")
        # the mean over the 4 groups of c // 4 channels (NHWC's (4, c // 4) split)
        a = up.reshape(b, 4, c // 4, 2 * h, 2 * w).mean(dim=1)
        return self.out_conv(a + self.residual(x))
