"""HRNet feature nets (counterpart of ``sihl_tpu/backbones/hrnet.py``).

Two stride-2 3x3 stem convs (``conv1``, ``conv2``), a stage-1 layer of four
bottlenecks (``layer1``), then three stages of parallel branches at strides
4, 8, 16 and 32 (widths C, 2C, 4C, 8C), each ``transition`` adding one
lower-resolution branch.  Every module of a stage runs four basic blocks
on each branch, then fuses: branch i's output is ``relu(y_i + sum_j
link_ij(y_j))``, summed in order of j, where a link from a finer branch is
a chain of stride-2 3x3 convs (all but the last keep ``c_from`` channels
and a ReLU) and a link from a coarser one a 1x1 conv followed by nearest 2x
upsamples.  ``links.i.j`` keeps the JAX package's indices: the diagonal
``links.i.i`` is an ``nn.Identity`` placeholder, skipped.

Level 1 is ``conv1``'s output (64 channels, stride 2); levels 2-5 are the
four final branch outputs, as they are (no timm ``incre`` blocks).  Every
BatchNorm has ``make_norm``'s eps 1e-5 and momentum 0.9.  The ReLUs are
module attributes (``act``).  The net does not honour ``_sg_levels``
(``backbones/base.py``): a frozen prefix runs its backward.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator, make_conv, make_norm
from sihl_tpu_torch.ops.image import upsample2x_nearest
from sihl_tpu_torch.ops.relu import relu as _relu


class _ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, relu=True, *, generator, device=None):
        super().__init__()
        self.conv = make_conv(cin, cout, k, stride=stride, bias=False, generator=generator, device=device)
        self.bn = make_norm("batch", cout, device=device)
        self.act = _relu if relu else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class _BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = _ConvBN(cin, cout, 3, stride=stride, **kw)
        self.conv2 = _ConvBN(cout, cout, 3, relu=False, **kw)
        self.down = _ConvBN(cin, cout, 1, stride=stride, relu=False, **kw) if stride != 1 or cin != cout else None
        self.act = _relu

    def forward(self, x):
        res = x if self.down is None else self.down(x)
        return self.act(self.conv2(self.conv1(x)) + res)


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        cout = planes * self.expansion
        self.conv1 = _ConvBN(cin, planes, 1, **kw)
        self.conv2 = _ConvBN(planes, planes, 3, stride=stride, **kw)
        self.conv3 = _ConvBN(planes, cout, 1, relu=False, **kw)
        self.down = _ConvBN(cin, cout, 1, stride=stride, relu=False, **kw) if stride != 1 or cin != cout else None
        self.act = _relu

    def forward(self, x):
        res = x if self.down is None else self.down(x)
        return self.act(self.conv3(self.conv2(self.conv1(x))) + res)


class _FuseLink(nn.Module):
    """Resolution adapter from branch j to branch i inside a fusion:
    ``steps_down > 0`` stride-2 convs, or a 1x1 conv and ``-steps_down``
    nearest upsamples."""

    def __init__(self, c_from, c_to, steps_down: int, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.steps_down = steps_down
        if steps_down > 0:
            self.convs = nn.ModuleList(
                _ConvBN(c_from, c_to if s == steps_down - 1 else c_from, 3, stride=2, relu=s < steps_down - 1, **kw)
                for s in range(steps_down)
            )
        else:
            self.convs = nn.ModuleList([_ConvBN(c_from, c_to, 1, relu=False, **kw)])

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        for _ in range(-self.steps_down):
            x = upsample2x_nearest(x)
        return x


class _Module(nn.Module):
    """One HRNet module: per-branch block stacks, then full cross fusion."""

    def __init__(self, widths: List[int], blocks_per_branch: int, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.branches = nn.ModuleList(
            nn.ModuleList(_BasicBlock(w, w, **kw) for _ in range(blocks_per_branch)) for w in widths
        )
        n = len(widths)
        self.links = nn.ModuleList(
            nn.ModuleList(nn.Identity() if i == j else _FuseLink(widths[j], widths[i], j_to_i(j, i), **kw)
                          for j in range(n))
            for i in range(n)
        )
        self.act = _relu

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = []
        for branch, x in zip(self.branches, xs):
            for block in branch:
                x = block(x)
            ys.append(x)
        fused = []
        for i, row in enumerate(self.links):
            acc = ys[i]
            for j, link in enumerate(row):
                if j != i:
                    acc = acc + link(ys[j])
            fused.append(self.act(acc))
        return fused


def j_to_i(j: int, i: int) -> int:
    """Stride steps from branch j (stride 4 * 2^j) to branch i: positive, a
    downsampling chain; negative, the number of upsamples."""
    return i - j


HRNET_CONFIGS = {
    "hrnet_w18": 18,
    "hrnet_w30": 30,
    "hrnet_w32": 32,
    "hrnet_w40": 40,
    "hrnet_w44": 44,
    "hrnet_w48": 48,
    "hrnet_w64": 64,
}
# (modules, blocks a branch) of stages 2, 3 and 4: the HRNetV2 recipe
_STAGES = ((1, 4), (4, 4), (3, 4))


class HrnetFeatures(nn.Module):
    _sg_levels = 0

    def __init__(self, name: str, input_channels: int = 3, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=device)
        c = HRNET_CONFIGS[name]
        widths = [c, 2 * c, 4 * c, 8 * c]
        self.conv1 = _ConvBN(input_channels, 64, 3, stride=2, **kw)
        self.conv2 = _ConvBN(64, 64, 3, stride=2, **kw)
        self.layer1 = nn.ModuleList([_Bottleneck(64, 64, **kw)] + [_Bottleneck(256, 64, **kw) for _ in range(3)])
        # the transitions add one lower-resolution branch at a time
        self.transition1 = nn.ModuleList(
            [_ConvBN(256, widths[0], 3, **kw), _ConvBN(256, widths[1], 3, stride=2, **kw)]
        )
        self.transition2 = _ConvBN(widths[1], widths[2], 3, stride=2, **kw)
        self.transition3 = _ConvBN(widths[2], widths[3], 3, stride=2, **kw)
        self.stage2 = nn.ModuleList(_Module(widths[:2], _STAGES[0][1], **kw) for _ in range(_STAGES[0][0]))
        self.stage3 = nn.ModuleList(_Module(widths[:3], _STAGES[1][1], **kw) for _ in range(_STAGES[1][0]))
        self.stage4 = nn.ModuleList(_Module(widths, _STAGES[2][1], **kw) for _ in range(_STAGES[2][0]))
        self.feature_channels = [64] + widths
        self.level_modules = [
            ["conv1"],
            ["conv2", "layer1", "transition1"],
            ["stage2", "transition2"],
            ["stage3", "transition3"],
            ["stage4"],
        ]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        s2 = self.conv1(x)
        x = self.conv2(s2)
        for block in self.layer1:
            x = block(x)
        xs = [self.transition1[0](x), self.transition1[1](x)]
        for module in self.stage2:
            xs = module(xs)
        xs = xs + [self.transition2(xs[-1])]
        for module in self.stage3:
            xs = module(xs)
        xs = xs + [self.transition3(xs[-1])]
        for module in self.stage4:
            xs = module(xs)
        return [s2] + xs


def make_hrnet_features(name, input_channels=3, *, generator=None, device=None) -> HrnetFeatures:
    return HrnetFeatures(name, input_channels=input_channels, generator=generator, device=device)
