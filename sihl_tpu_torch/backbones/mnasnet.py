"""MNASNet feature nets (counterpart of ``sihl_tpu/backbones/mnasnet.py``).

Levels are torchvision's ``layers.{7,8,9,11,16}``: the stride-2 16-wide
projection (level 1), stack 0 (stride 4), stack 1 (8), stack 3 (16) and
the 1280-wide head conv (32).  The stacks are a ``ModuleList`` of
``ModuleList``\\ s, so ``level_modules`` freezes them by ``("stacks", i)``
pairs.  The ReLUs are module attributes (``act``).  Depthwise convs are
grouped ``F.conv2d`` calls.  The net does not honour ``_sg_levels``
(``backbones/base.py``): a frozen prefix runs its backward.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator, make_conv, make_norm
from sihl_tpu_torch.ops.relu import relu as _relu


def _scale(c, alpha):
    c = c * alpha
    new = max(8, int(c + 4) // 8 * 8)
    if new < 0.9 * c:
        new += 8
    return new


class _ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k, stride=1, groups=1, relu=True, *, generator, device=None):
        super().__init__()
        self.conv = make_conv(cin, cout, k, stride=stride, groups=groups, bias=False, generator=generator,
                              device=device)
        self.bn = make_norm("batch", cout, device=device)
        self.act = _relu if relu else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)



class _InvertedResidual(nn.Module):
    def __init__(self, cin, cout, kernel, stride, expand, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        mid = cin * expand
        self.use_residual = stride == 1 and cin == cout
        self.expand = _ConvBNReLU(cin, mid, 1, **kw)
        self.depthwise = _ConvBNReLU(mid, mid, kernel, stride=stride, groups=mid, **kw)
        self.project = _ConvBNReLU(mid, cout, 1, relu=False, **kw)

    def forward(self, x):
        h = self.project(self.depthwise(self.expand(x)))
        return x + h if self.use_residual else h


# (kernel, stride, expand, out, repeats) per stack, at alpha = 1.0
_STACKS = [
    (3, 2, 3, 24, 3),
    (5, 2, 3, 40, 3),
    (5, 2, 6, 80, 3),
    (3, 1, 6, 96, 2),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
]
MNASNET_CONFIGS = {
    "mnasnet0_5": 0.5,
    "mnasnet0_75": 0.75,
    "mnasnet1_0": 1.0,
    "mnasnet1_3": 1.3,
}


class MnasNetFeatures(nn.Module):
    _sg_levels = 0

    def __init__(self, name: str, input_channels: int = 3, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=device)
        alpha = MNASNET_CONFIGS[name]
        c32, c16 = _scale(32, alpha), _scale(16, alpha)
        self.stem = _ConvBNReLU(input_channels, c32, 3, stride=2, **kw)
        self.sep_dw = _ConvBNReLU(c32, c32, 3, groups=c32, **kw)
        self.sep_pw = _ConvBNReLU(c32, c16, 1, relu=False, **kw)
        stacks, stack_out, cin = [], [], c16
        for k, s, e, c, n in _STACKS:
            cout = _scale(c, alpha)
            stacks.append(nn.ModuleList(
                _InvertedResidual(cin if i == 0 else cout, cout, k, s if i == 0 else 1, e, **kw) for i in range(n)))
            stack_out.append(cout)
            cin = cout
        self.stacks = nn.ModuleList(stacks)
        self.head = _ConvBNReLU(cin, 1280, 1, **kw)
        self.feature_channels = [c16, stack_out[0], stack_out[1], stack_out[3], 1280]
        self.level_modules = [
            ["stem", "sep_dw", "sep_pw"],
            [("stacks", 0)],
            [("stacks", 1)],
            [("stacks", 2), ("stacks", 3)],
            [("stacks", 4), ("stacks", 5), "head"],
        ]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.sep_pw(self.sep_dw(self.stem(x)))
        outs = [x]
        for i, stack in enumerate(self.stacks):
            for unit in stack:
                x = unit(x)
            if i in (0, 1, 3):
                outs.append(x)
        outs.append(self.head(x))
        return outs


def make_mnasnet_features(name, input_channels=3, *, generator=None, device=None) -> MnasNetFeatures:
    return MnasNetFeatures(name, input_channels=input_channels, generator=generator, device=device)
