"""ConvNeXt v1 / v2 feature nets (counterpart of
``sihl_tpu/backbones/convnext.py``).

Levels are torchvision's nodes ``features.{0,1,3,5,7}``: level 1 is the
stride-4 stem output (the pyramid wrapper resizes it to stride 2), level 2
stage 1 (stride 4), levels 3-5 stages 2-4 (strides 8, 16, 32).  The
``convnextv2_*`` names use GRN blocks in place of the layer scale.

The LayerNorms (eps 1e-6) and the pointwise Linears act over the channels
of the NHWC view ``x.permute(0, 2, 3, 1)``, which costs no copy in
channels_last memory; the Linears' weights are (out, in), as
``nnx.Linear``'s kernels transposed.  The JAX package's choices are kept
where torchvision's and timm's differ: GELU is the tanh approximation, no
block has stochastic depth, and the layer scale starts at 1e-6 (ROADMAP.md,
queue C).  The 7x7 depthwise convs are grouped ``F.conv2d`` calls.  The net
does not honour ``_sg_levels`` (``backbones/base.py``): a frozen prefix
runs its backward.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import _ACTS, default_generator, make_conv
from sihl_tpu_torch.layers.mlp import LayerNorm, Linear
from sihl_tpu_torch.policy import resolve_device, upcast

_gelu = _ACTS["gelu"]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    """depthwise 7x7 → LayerNorm → Linear 4x → GELU → Linear, scaled by
    ``gamma`` per channel, plus the input."""

    def __init__(self, dim, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.depthwise = make_conv(dim, dim, 7, padding=3, groups=dim, **kw)
        self.norm = LayerNorm(dim, eps=1e-6, device=device)
        self.pw1 = Linear(dim, 4 * dim, **kw)
        self.pw2 = Linear(4 * dim, dim, **kw)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6, device=resolve_device(device)))

    def forward(self, x):
        h = _nhwc(self.depthwise(x))
        h = self.pw2(_gelu(self.pw1(self.norm(h))))
        return x + _nchw(self.gamma.to(h.dtype) * h)


class GRN(nn.Module):
    """Global response normalisation (ConvNeXt-V2, arXiv:2301.00808) of an
    NHWC tensor: each channel's L2 norm over the pixels, in f32 (f64 for an
    f64 input), divided by its mean over the channels; ``gamma`` and
    ``beta`` start at zero, so the block starts as the identity.  The JAX
    package casts to f32 explicitly, which an f64 run reads as f64 here."""

    def __init__(self, dim, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.gamma = nn.Parameter(torch.zeros(dim, device=device))
        self.beta = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        xf = upcast(x)
        gx = torch.sqrt((xf * xf).sum(dim=(1, 2), keepdim=True))
        nx = (gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
        return self.gamma.to(x.dtype) * (x * nx) + self.beta.to(x.dtype) + x


class ConvNeXtV2Block(nn.Module):
    """depthwise 7x7 → LayerNorm → Linear 4x → GELU → GRN → Linear, plus the
    input."""

    def __init__(self, dim, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.depthwise = make_conv(dim, dim, 7, padding=3, groups=dim, **kw)
        self.norm = LayerNorm(dim, eps=1e-6, device=device)
        self.pw1 = Linear(dim, 4 * dim, **kw)
        self.grn = GRN(4 * dim, device=device)
        self.pw2 = Linear(4 * dim, dim, **kw)

    def forward(self, x):
        h = _nhwc(self.depthwise(x))
        h = self.pw2(self.grn(_gelu(self.pw1(self.norm(h)))))
        return x + _nchw(h)


class _Downsample(nn.Module):
    """LayerNorm, then a 2x2 stride-2 conv."""

    def __init__(self, cin, cout, *, generator, device=None):
        super().__init__()
        self.norm = LayerNorm(cin, eps=1e-6, device=device)
        self.conv = make_conv(cin, cout, 2, stride=2, padding=0, generator=generator, device=device)

    def forward(self, x):
        return self.conv(_nchw(self.norm(_nhwc(x))))


CONVNEXT_CONFIGS = {
    # timm's size ladder (atto..xxlarge) and torchvision's sizes; the "v2"
    # names use GRN blocks (ConvNeXt-V2) in place of the layer scale
    "convnext_atto": ([2, 2, 6, 2], [40, 80, 160, 320]),
    "convnext_femto": ([2, 2, 6, 2], [48, 96, 192, 384]),
    "convnext_pico": ([2, 2, 6, 2], [64, 128, 256, 512]),
    "convnext_nano": ([2, 2, 8, 2], [80, 160, 320, 640]),
    "convnext_tiny": ([3, 3, 9, 3], [96, 192, 384, 768]),
    "convnext_small": ([3, 3, 27, 3], [96, 192, 384, 768]),
    "convnext_base": ([3, 3, 27, 3], [128, 256, 512, 1024]),
    "convnext_large": ([3, 3, 27, 3], [192, 384, 768, 1536]),
    "convnext_xlarge": ([3, 3, 27, 3], [256, 512, 1024, 2048]),
    "convnext_xxlarge": ([3, 4, 30, 3], [384, 768, 1536, 3072]),
    "convnextv2_atto": ([2, 2, 6, 2], [40, 80, 160, 320]),
    "convnextv2_femto": ([2, 2, 6, 2], [48, 96, 192, 384]),
    "convnextv2_pico": ([2, 2, 6, 2], [64, 128, 256, 512]),
    "convnextv2_nano": ([2, 2, 8, 2], [80, 160, 320, 640]),
    "convnextv2_tiny": ([3, 3, 9, 3], [96, 192, 384, 768]),
    "convnextv2_base": ([3, 3, 27, 3], [128, 256, 512, 1024]),
    "convnextv2_large": ([3, 3, 27, 3], [192, 384, 768, 1536]),
}


class ConvNeXtFeatures(nn.Module):
    """Levels 1..5: a 4x4 stride-4 ``stem_conv`` and ``stem_norm``, four
    ``stages`` of blocks and the three ``downsamples`` between them.
    ``level_modules`` freezes the stem with level 1, stage 1 with level 2,
    and each later stage with its downsample."""

    _sg_levels = 0

    def __init__(self, name: str, input_channels: int = 3, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=device)
        depths, widths = CONVNEXT_CONFIGS[name]
        block_cls = ConvNeXtV2Block if name.startswith("convnextv2") else ConvNeXtBlock
        self.stem_conv = make_conv(input_channels, widths[0], 4, stride=4, padding=0, **kw)
        self.stem_norm = LayerNorm(widths[0], eps=1e-6, device=device)
        self.stages = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        for i, (d, w) in enumerate(zip(depths, widths)):
            if i > 0:
                self.downsamples.append(_Downsample(widths[i - 1], w, **kw))
            self.stages.append(nn.ModuleList(block_cls(w, **kw) for _ in range(d)))
        self.feature_channels = [widths[0]] + list(widths)
        self.level_modules = [
            ["stem_conv", "stem_norm"],
            [("stages", 0)],
            [("stages", 1), ("downsamples", 0)],
            [("stages", 2), ("downsamples", 1)],
            [("stages", 3), ("downsamples", 2)],
        ]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = _nchw(self.stem_norm(_nhwc(self.stem_conv(x))))
        outs = [x]
        for i, stage in enumerate(self.stages):
            if i > 0:
                x = self.downsamples[i - 1](x)
            for block in stage:
                x = block(x)
            outs.append(x)
        return outs


def make_convnext_features(name, input_channels=3, *, generator=None, device=None) -> ConvNeXtFeatures:
    return ConvNeXtFeatures(name, input_channels=input_channels, generator=generator, device=device)
