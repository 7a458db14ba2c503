"""ResNet / ResNeXt / Wide ResNet feature nets (counterpart of
``sihl_tpu/backbones/resnet.py``), torchvision v1.5 structure, and the
pre-activation ResNetV2 (timm's ``resnetv2_50`` / ``resnetv2_101``) on the
same stem.

Level 1 is the stem's ReLU output (stride 2); levels 2..5 are layer1..layer4
(strides 4..32).  A frozen stem (``_sg_levels >= 1``) runs its conv and its
BatchNorm's batch statistics in one pass through
:func:`~sihl_tpu_torch.ops.stem.stem_conv_stats` (K4), as the JAX package's
``_Stem._fused`` does; any other stem is the conv and ``BatchNorm2d``.  The
space-to-depth and batch-fold stems and the stage-1 space-to-depth are TPU
layout levers that leave the values unchanged, and are not ported.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator, make_conv, make_norm
from sihl_tpu_torch.ops import stem as stem_ops
from sihl_tpu_torch.ops.image import max_pool2d
from sihl_tpu_torch.ops.relu import relu


class _ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, groups=1, *, generator, device=None):
        super().__init__()
        self.conv = make_conv(
            cin, cout, k, stride=stride, groups=groups, bias=False, generator=generator, device=device
        )
        self.bn = make_norm("batch", cout, device=device)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes, planes, stride=1, groups=1, base_width=64, *, generator, device=None):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1 and base_width=64")
        self.conv1 = _ConvBN(in_planes, planes, 3, stride=stride, generator=generator, device=device)
        self.conv2 = _ConvBN(planes, planes, 3, generator=generator, device=device)
        self.downsample = (
            _ConvBN(in_planes, planes, 1, stride=stride, generator=generator, device=device)
            if (stride != 1 or in_planes != planes)
            else None
        )

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        out = relu(self.conv1(x))
        out = self.conv2(out)
        return relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes, planes, stride=1, groups=1, base_width=64, *, generator, device=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_planes = planes * self.expansion
        self.conv1 = _ConvBN(in_planes, width, 1, generator=generator, device=device)
        self.conv2 = _ConvBN(
            width, width, 3, stride=stride, groups=groups, generator=generator, device=device
        )
        self.conv3 = _ConvBN(width, out_planes, 1, generator=generator, device=device)
        self.downsample = (
            _ConvBN(in_planes, out_planes, 1, stride=stride, generator=generator, device=device)
            if (stride != 1 or in_planes != out_planes)
            else None
        )

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        out = relu(self.conv1(x))
        out = relu(self.conv2(out))
        out = self.conv3(out)
        return relu(out + identity)


class _Stage(nn.Module):
    def __init__(self, block, in_planes, planes, num_blocks, stride, groups, base_width, *, generator, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            block(
                in_planes if i == 0 else planes * block.expansion,
                planes,
                stride=stride if i == 0 else 1,
                groups=groups,
                base_width=base_width,
                generator=generator,
                device=device,
            )
            for i in range(num_blocks)
        )

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


class _Stem(nn.Module):
    def __init__(self, input_channels, *, generator, device=None):
        super().__init__()
        self.conv = make_conv(
            input_channels, 64, 7, stride=2, padding=3, bias=False, generator=generator, device=device
        )
        self.bn = make_norm("batch", 64, device=device)

    @torch.no_grad()
    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """The forward-only stem of a frozen level 1, through K4: the conv and
        its output's sums in one pass, then BatchNorm as ``_Stem._fused`` in
        the JAX package computes it.  In training mode: mean = s / n,
        var = max(0, q / n - mean^2), and the running statistics updated at
        momentum 0.9 with that biased variance; in eval mode the running
        statistics, rounded to the compute dtype.  Scale and bias are rounded
        to the compute dtype; the transform runs in f32 (f64 for f64)."""
        dtype = self.conv.dtype
        y, s, q = stem_ops.stem_conv_stats(x.to(dtype), self.conv.weight)
        bn = self.bn
        stat = s.dtype
        if bn.training:
            n = y.numel() // y.shape[1]
            mean = s / n
            var = torch.clamp(q / n - mean * mean, min=0.0)
            m = bn.momentum
            bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
            bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
        else:
            mean = bn.running_mean.to(dtype).to(stat)
            var = bn.running_var.to(dtype).to(stat)
        scale = bn.weight.to(dtype).to(stat)
        bias = bn.bias.to(dtype).to(stat)
        mul = torch.rsqrt(var + bn.eps) * scale
        out = (y.to(stat) - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
        return relu(out.to(dtype))

    def forward(self, x, fwd_only: bool = False):
        """``fwd_only``: the stem is frozen and nothing differentiates it, so
        the K4 path may run (where its geometry allows)."""
        if fwd_only and stem_ops.supported(tuple(x.shape), tuple(self.conv.weight.shape)):
            return self._fused(x)
        return relu(self.bn(self.conv(x)))


class ResNetFeatures(nn.Module):
    """Feature-pyramid ResNet; returns levels 1..5 (strides 2..32).

    Levels up to ``_sg_levels`` (set by ``PyramidBackbone.set_frozen_levels``)
    run without a gradient, as ``stop_gradient`` cuts them in the JAX
    package: a frozen stem has no backward pass, and its BatchNorm still
    updates its running statistics in training mode.
    """

    level_modules = [["stem"], ["layer1"], ["layer2"], ["layer3"], ["layer4"]]
    _sg_levels = 0

    def __init__(
        self,
        block,
        layers: List[int],
        input_channels: int = 3,
        groups: int = 1,
        base_width: int = 64,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        generator = default_generator(generator)
        self.stem = _Stem(input_channels, generator=generator, device=device)
        planes = [64, 128, 256, 512]
        strides = [1, 2, 2, 2]
        in_planes = 64
        stages = []
        for p, n, s in zip(planes, layers, strides):
            stages.append(
                _Stage(block, in_planes, p, n, s, groups, base_width, generator=generator, device=device)
            )
            in_planes = p * block.expansion
        self.layer1, self.layer2, self.layer3, self.layer4 = stages
        self.feature_channels = [64] + [p * block.expansion for p in planes]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        sg = self._sg_levels
        with torch.set_grad_enabled(torch.is_grad_enabled() and sg < 1):
            c1 = self.stem(x, fwd_only=sg >= 1)
        with torch.set_grad_enabled(torch.is_grad_enabled() and sg < 2):
            c2 = self.layer1(max_pool2d(c1, 3, stride=2, padding=1))
        with torch.set_grad_enabled(torch.is_grad_enabled() and sg < 3):
            c3 = self.layer2(c2)
        with torch.set_grad_enabled(torch.is_grad_enabled() and sg < 4):
            c4 = self.layer3(c3)
        with torch.set_grad_enabled(torch.is_grad_enabled() and sg < 5):
            c5 = self.layer4(c4)
        return [c1, c2, c3, c4, c5]


class PreactBottleneck(nn.Module):
    """Pre-activation bottleneck (He et al. 2016; timm ``resnetv2_*``):
    BatchNorm → ReLU before each conv, a bare 1x1 conv as the shortcut's
    downsample (fed the pre-activated input), no activation after the sum."""

    expansion = 4

    def __init__(self, in_planes, planes, stride=1, groups=1, base_width=64, *, generator, device=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_planes = planes * self.expansion
        self.norm1 = make_norm("batch", in_planes, device=device)
        self.conv1 = make_conv(in_planes, width, 1, bias=False, generator=generator, device=device)
        self.norm2 = make_norm("batch", width, device=device)
        self.conv2 = make_conv(
            width, width, 3, stride=stride, groups=groups, bias=False, generator=generator, device=device
        )
        self.norm3 = make_norm("batch", width, device=device)
        self.conv3 = make_conv(width, out_planes, 1, bias=False, generator=generator, device=device)
        self.downsample = (
            make_conv(in_planes, out_planes, 1, stride=stride, bias=False, generator=generator, device=device)
            if (stride != 1 or in_planes != out_planes)
            else None
        )

    def forward(self, x):
        pre = relu(self.norm1(x))
        identity = self.downsample(pre) if self.downsample is not None else x
        out = self.conv1(pre)
        out = self.conv2(relu(self.norm2(out)))
        out = self.conv3(relu(self.norm3(out)))
        return out + identity


class ResNetV2Features(ResNetFeatures):
    """Pre-activation ResNet: level 5 is layer4's output through
    ``final_norm`` and a ReLU.  ``final_norm`` belongs to no level, so no
    ``frozen_levels`` freezes it; with all five levels frozen it runs
    without a gradient, as the JAX package's ``stop_gradient`` cuts it."""

    def __init__(self, block, layers, input_channels=3, groups=1, base_width=64, *, generator=None, device=None):
        generator = default_generator(generator)
        super().__init__(block, layers, input_channels=input_channels, groups=groups, base_width=base_width,
                         generator=generator, device=device)
        self.final_norm = make_norm("batch", self.feature_channels[-1], device=device)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        sg = self._sg_levels
        with torch.set_grad_enabled(torch.is_grad_enabled() and sg < 1):
            c1 = self.stem(x, fwd_only=sg >= 1)
        with torch.set_grad_enabled(torch.is_grad_enabled() and sg < 2):
            c2 = self.layer1(max_pool2d(c1, 3, stride=2, padding=1))
        with torch.set_grad_enabled(torch.is_grad_enabled() and sg < 3):
            c3 = self.layer2(c2)
        with torch.set_grad_enabled(torch.is_grad_enabled() and sg < 4):
            c4 = self.layer3(c3)
        with torch.set_grad_enabled(torch.is_grad_enabled() and sg < 5):
            c5 = relu(self.final_norm(self.layer4(c4)))
        return [c1, c2, c3, c4, c5]


RESNET_CONFIGS = {
    "resnet18": dict(block=BasicBlock, layers=[2, 2, 2, 2]),
    "resnet26": dict(block=Bottleneck, layers=[2, 2, 2, 2]),
    "resnet34": dict(block=BasicBlock, layers=[3, 4, 6, 3]),
    "resnet50": dict(block=Bottleneck, layers=[3, 4, 6, 3]),
    "resnet101": dict(block=Bottleneck, layers=[3, 4, 23, 3]),
    "resnet152": dict(block=Bottleneck, layers=[3, 8, 36, 3]),
    "resnext50_32x4d": dict(block=Bottleneck, layers=[3, 4, 6, 3], groups=32, base_width=4),
    "resnext101_32x8d": dict(block=Bottleneck, layers=[3, 4, 23, 3], groups=32, base_width=8),
    "resnext101_64x4d": dict(block=Bottleneck, layers=[3, 4, 23, 3], groups=64, base_width=4),
    "wide_resnet50_2": dict(block=Bottleneck, layers=[3, 4, 6, 3], base_width=128),
    "wide_resnet101_2": dict(block=Bottleneck, layers=[3, 4, 23, 3], base_width=128),
    "resnetv2_50": dict(block=PreactBottleneck, layers=[3, 4, 6, 3], v2=True),
    "resnetv2_101": dict(block=PreactBottleneck, layers=[3, 4, 23, 3], v2=True),
}


def make_resnet_features(
    name: str, input_channels: int = 3, *, generator=None, device=None
) -> ResNetFeatures:
    cfg = dict(RESNET_CONFIGS[name])
    cls = ResNetV2Features if cfg.pop("v2", False) else ResNetFeatures
    return cls(
        cfg.pop("block"), cfg.pop("layers"), input_channels=input_channels,
        generator=generator, device=device, **cfg,
    )
