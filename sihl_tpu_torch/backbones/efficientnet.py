"""EfficientNet B0-B7, V2 S/M/L and lite0 feature nets (counterpart of
``sihl_tpu/backbones/efficientnet.py``).

Levels are torchvision's feature nodes ``features.{1,2,3,5,8}``: a level
is emitted after the last stage at each cumulative stride, and level 5 is
the 1x1 head conv's output.  MBConv blocks carry squeeze-excitation (but
lite0's), FusedMBConv runs V2's early stages.  As in the JAX package there
is no stochastic depth, and every BatchNorm has eps 1e-5 and momentum 0.9
(torchvision's V2: eps 1e-3).  lite0 is B0's stages with ReLU6 and no SE,
a 32-wide stem and a 1280-wide head.

The activations are module attributes (``act``, and an SE block's
``gate``).  Depthwise convs are grouped ``F.conv2d`` calls.  The net does
not honour ``_sg_levels`` (``backbones/base.py``): a frozen prefix runs
its backward.
"""

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sihl_tpu_torch.backbones.mobilenet import relu6 as _relu6
from sihl_tpu_torch.layers.convblocks import default_generator, make_conv, make_norm


def _round_channels(channels: float, divisor: int = 8) -> int:
    new = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new < 0.9 * channels:
        new += divisor
    return new


class _ConvBNAct(nn.Module):
    """conv (no bias) → BatchNorm → SiLU, ReLU6 (``relu6``) or nothing
    (``act=False``)."""

    def __init__(self, cin, cout, k, stride=1, groups=1, act=True, relu6=False, *, generator, device=None):
        super().__init__()
        self.conv = make_conv(cin, cout, k, stride=stride, groups=groups, bias=False, generator=generator,
                              device=device)
        self.bn = make_norm("batch", cout, device=device)
        self.act = None if not act else _relu6 if relu6 else F.silu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class SqueezeExcite(nn.Module):
    """The spatial mean → 1x1 conv → SiLU → 1x1 conv → sigmoid, scaling the
    input."""

    def __init__(self, channels, squeeze_channels, *, generator, device=None):
        super().__init__()
        self.fc1 = make_conv(channels, squeeze_channels, 1, generator=generator, device=device)
        self.fc2 = make_conv(squeeze_channels, channels, 1, generator=generator, device=device)
        self.act, self.gate = F.silu, torch.sigmoid

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * self.gate(self.fc2(self.act(self.fc1(s))))


class MBConv(nn.Module):
    """[1x1 expand] → depthwise → [SE, squeezed to a quarter of the block's
    input] → 1x1 project, with the residual where the shape allows."""

    def __init__(self, cin, cout, kernel, stride, expand_ratio, use_se=True, relu6=False, *, generator,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        expanded = cin * expand_ratio
        self.use_residual = stride == 1 and cin == cout
        self.expand = _ConvBNAct(cin, expanded, 1, relu6=relu6, **kw) if expand_ratio != 1 else None
        self.depthwise = _ConvBNAct(expanded, expanded, kernel, stride=stride, groups=expanded, relu6=relu6, **kw)
        self.se = SqueezeExcite(expanded, max(1, cin // 4), **kw) if use_se else None
        self.project = _ConvBNAct(expanded, cout, 1, act=False, **kw)

    def forward(self, x):
        h = x if self.expand is None else self.expand(x)
        h = self.depthwise(h)
        if self.se is not None:
            h = self.se(h)
        h = self.project(h)
        return x + h if self.use_residual else h


class FusedMBConv(nn.Module):
    """A full kxk conv in place of expand + depthwise, then a 1x1 project
    (none at expansion 1)."""

    def __init__(self, cin, cout, kernel, stride, expand_ratio, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        expanded = cin * expand_ratio
        self.use_residual = stride == 1 and cin == cout
        if expand_ratio != 1:
            self.fused = _ConvBNAct(cin, expanded, kernel, stride=stride, **kw)
            self.project = _ConvBNAct(expanded, cout, 1, act=False, **kw)
        else:
            self.fused = _ConvBNAct(cin, cout, kernel, stride=stride, **kw)
            self.project = None

    def forward(self, x):
        h = self.fused(x)
        if self.project is not None:
            h = self.project(h)
        return x + h if self.use_residual else h


class _Stage(nn.Module):
    def __init__(self, block, cin, cout, kernel, stride, expand, num, *, generator, device=None, **kw):
        super().__init__()
        self.blocks = nn.ModuleList(
            block(cin if i == 0 else cout, cout, kernel, stride if i == 0 else 1, expand, generator=generator,
                  device=device, **kw)
            for i in range(num)
        )

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


# (block, expand, kernel, stride, out_channels, num_layers) for B0; B1-B7
# scale width and depth
_B0_STAGES = [
    (MBConv, 1, 3, 1, 16, 1),
    (MBConv, 6, 3, 2, 24, 2),
    (MBConv, 6, 5, 2, 40, 2),
    (MBConv, 6, 3, 2, 80, 3),
    (MBConv, 6, 5, 1, 112, 3),
    (MBConv, 6, 5, 2, 192, 4),
    (MBConv, 6, 3, 1, 320, 1),
]
_B_MULTS = {  # (width, depth)
    "efficientnet_b0": (1.0, 1.0),
    "efficientnet_b1": (1.0, 1.1),
    "efficientnet_b2": (1.1, 1.2),
    "efficientnet_b3": (1.2, 1.4),
    "efficientnet_b4": (1.4, 1.8),
    "efficientnet_b5": (1.6, 2.2),
    "efficientnet_b6": (1.8, 2.6),
    "efficientnet_b7": (2.0, 3.1),
}
_V2_STAGES = {
    "efficientnet_v2_s": [
        (FusedMBConv, 1, 3, 1, 24, 2),
        (FusedMBConv, 4, 3, 2, 48, 4),
        (FusedMBConv, 4, 3, 2, 64, 4),
        (MBConv, 4, 3, 2, 128, 6),
        (MBConv, 6, 3, 1, 160, 9),
        (MBConv, 6, 3, 2, 256, 15),
    ],
    "efficientnet_v2_m": [
        (FusedMBConv, 1, 3, 1, 24, 3),
        (FusedMBConv, 4, 3, 2, 48, 5),
        (FusedMBConv, 4, 3, 2, 80, 5),
        (MBConv, 4, 3, 2, 160, 7),
        (MBConv, 6, 3, 1, 176, 14),
        (MBConv, 6, 3, 2, 304, 18),
        (MBConv, 6, 3, 1, 512, 5),
    ],
    "efficientnet_v2_l": [
        (FusedMBConv, 1, 3, 1, 32, 4),
        (FusedMBConv, 4, 3, 2, 64, 7),
        (FusedMBConv, 4, 3, 2, 96, 7),
        (MBConv, 4, 3, 2, 192, 10),
        (MBConv, 6, 3, 1, 224, 19),
        (MBConv, 6, 3, 2, 384, 25),
        (MBConv, 6, 3, 1, 640, 7),
    ],
}
EFFICIENTNET_CONFIGS = {**_B_MULTS, **_V2_STAGES, "efficientnet_lite0": None}


class EfficientNetFeatures(nn.Module):
    """Pyramid feature net; returns levels 1..5 at strides 2..32.
    ``level_modules`` lists ``("stages", j)`` pairs: level 1 freezes the
    stem and the stages up to the first level's, level 5 the head too."""

    _sg_levels = 0

    def __init__(self, name: str, input_channels: int = 3, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=device)
        lite = name.startswith("efficientnet_lite")
        if lite:
            stages_cfg = list(_B0_STAGES)
            stem_c, head_c = 32, 1280
        elif name in _B_MULTS:
            width, depth = _B_MULTS[name]
            stages_cfg = [
                (blk, exp, k, s, _round_channels(c * width), int(math.ceil(n * depth)))
                for (blk, exp, k, s, c, n) in _B0_STAGES
            ]
            stem_c = _round_channels(32 * width)
            head_c = 4 * stages_cfg[-1][4]
        else:
            stages_cfg = _V2_STAGES[name]
            stem_c = stages_cfg[0][4]
            head_c = 1280

        self.stem = _ConvBNAct(input_channels, stem_c, 3, stride=2, relu6=lite, **kw)
        stages, cin = [], stem_c
        extra = {"use_se": False, "relu6": True} if lite else {}
        for blk, exp, k, s, c, n in stages_cfg:
            stages.append(_Stage(blk, cin, c, k, s, exp, n, **kw, **extra))
            cin = c
        self.stages = nn.ModuleList(stages)
        self.head = _ConvBNAct(cin, head_c, 1, relu6=lite, **kw)

        # a level after the last stage at each cumulative stride
        # (torchvision's features.{1,2,3,5,8}); level 5 is the head conv's output
        cum, last_stage_at_stride = 2, {}
        for i, (_, _, _, s, _, _) in enumerate(stages_cfg):
            cum *= s
            last_stage_at_stride[cum] = i
        self.level_stage_idx = [last_stage_at_stride[k] for k in sorted(last_stage_at_stride)]
        chans = [stages_cfg[i][4] for i in self.level_stage_idx]
        chans[-1] = head_c
        self.feature_channels = chans
        mods, prev = [], -1
        for li, idx in enumerate(self.level_stage_idx):
            entry = [("stages", j) for j in range(prev + 1, idx + 1)]
            if li == 0:
                entry = ["stem"] + entry
            if li == len(self.level_stage_idx) - 1:
                entry = entry + ["head"]
            mods.append(entry)
            prev = idx
        self.level_modules = mods

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = []
        emit = set(self.level_stage_idx)
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i in emit:
                outs.append(x)
        outs[-1] = self.head(x)
        return outs


def make_efficientnet_features(name, input_channels=3, *, generator=None, device=None) -> EfficientNetFeatures:
    return EfficientNetFeatures(name, input_channels=input_channels, generator=generator, device=device)
