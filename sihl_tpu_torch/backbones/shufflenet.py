"""ShuffleNetV2 feature nets (counterpart of
``sihl_tpu/backbones/shufflenet.py``).

Levels are torchvision's nodes ``conv1`` (stride 2), ``maxpool`` (4, no
module of its own), ``stage2`` (8), ``stage3`` (16) and ``conv5`` (32).  A
stride-2 unit runs both branches on its input; a stride-1 unit passes its
first half of the channels through and runs branch 2 on the second; both
concatenate the branches and shuffle the channels in two groups.  The
ReLUs are module attributes (``act``).  The net does not honour
``_sg_levels`` (``backbones/base.py``): a frozen prefix runs its backward.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator, make_conv, make_norm
from sihl_tpu_torch.ops.image import max_pool2d
from sihl_tpu_torch.ops.relu import relu as _relu


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Channel ``g * (C / groups) + j`` to ``j * groups + g``: the JAX
    package's NHWC shuffle, taken on the NHWC view so that the result stays
    in channels_last memory."""
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1).reshape(b, h, w, groups, c // groups).transpose(3, 4).reshape(b, h, w, c)
    return nhwc.permute(0, 3, 1, 2)


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


class _ShuffleUnit(nn.Module):
    def __init__(self, cin, cout, stride, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.stride = stride
        branch_c = cout // 2
        if stride == 2:
            self.branch1_dw = _ConvBNReLU(cin, cin, 3, stride=2, groups=cin, relu=False, **kw)
            self.branch1_pw = _ConvBNReLU(cin, branch_c, 1, **kw)
            b2_in = cin
        else:
            self.branch1_dw = None
            b2_in = cin // 2
        self.branch2_pw1 = _ConvBNReLU(b2_in, branch_c, 1, **kw)
        self.branch2_dw = _ConvBNReLU(branch_c, branch_c, 3, stride=stride, groups=branch_c, relu=False, **kw)
        self.branch2_pw2 = _ConvBNReLU(branch_c, branch_c, 1, **kw)

    def forward(self, x):
        if self.stride == 2:
            b1, rest = self.branch1_pw(self.branch1_dw(x)), x
        else:
            half = x.shape[1] // 2
            b1, rest = x[:, :half], x[:, half:]
        b2 = self.branch2_pw2(self.branch2_dw(self.branch2_pw1(rest)))
        return channel_shuffle(torch.cat([b1, b2], dim=1))


SHUFFLENET_CONFIGS = {  # (stage widths, conv5 width)
    "shufflenet_v2_x0_5": ((48, 96, 192), 1024),
    "shufflenet_v2_x1_0": ((116, 232, 464), 1024),
    "shufflenet_v2_x1_5": ((176, 352, 704), 1024),
    "shufflenet_v2_x2_0": ((244, 488, 976), 2048),
}
_REPEATS = (4, 8, 4)


class ShuffleNetFeatures(nn.Module):
    """Levels 1..5: ``conv1``, its 3x3 stride-2 max pool, ``stages`` 0 and 1,
    and ``conv5`` after stage 2; ``level_modules`` freezes ``conv1`` with
    level 1, nothing with level 2, stage 0 with level 3, stage 1 with level
    4, and stage 2 and ``conv5`` with level 5."""

    _sg_levels = 0

    def __init__(self, name: str, input_channels: int = 3, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=device)
        stage_channels, conv5_c = SHUFFLENET_CONFIGS[name]
        self.conv1 = _ConvBNReLU(input_channels, 24, 3, stride=2, **kw)
        self.stages = nn.ModuleList()
        cin = 24
        for cout, n in zip(stage_channels, _REPEATS):
            self.stages.append(nn.ModuleList(
                [_ShuffleUnit(cin, cout, 2, **kw)] + [_ShuffleUnit(cout, cout, 1, **kw) for _ in range(n - 1)]))
            cin = cout
        self.conv5 = _ConvBNReLU(cin, conv5_c, 1, **kw)
        self.feature_channels = [24, 24, stage_channels[0], stage_channels[1], conv5_c]
        self.level_modules = [
            ["conv1"], [], [("stages", 0)], [("stages", 1)],
            [("stages", 2), "conv5"],
        ]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        c1 = self.conv1(x)
        p = max_pool2d(c1, 3, stride=2, padding=1)
        outs = [c1, p]
        x = p
        for i, stage in enumerate(self.stages):
            for unit in stage:
                x = unit(x)
            if i < 2:
                outs.append(x)
        outs.append(self.conv5(x))
        return outs


def make_shufflenet_features(name, input_channels=3, *, generator=None, device=None) -> ShuffleNetFeatures:
    return ShuffleNetFeatures(name, input_channels=input_channels, generator=generator, device=device)
