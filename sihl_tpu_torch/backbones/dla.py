"""Deep Layer Aggregation feature nets (counterpart of
``sihl_tpu/backbones/dla.py``).

A 7x7 stride-1 ``base`` conv, two plain conv levels (``level0``, and
``level1`` at stride 2), then four hierarchical-aggregation trees
(``stages``, strides 4-32).  A tree of depth 1 runs two blocks and joins
their outputs in a root node (concatenation → 1x1 conv → BatchNorm, with
the first child added back where roots are residual, → ReLU); a deeper
tree passes its first subtree's output down to the second subtree's root.
A stage's pooled input joins the root too (``level_root``, every stage but
the first).  The root's concatenation order is the JAX package's:
``[x2, x1]`` and then the children handed down, the pooled input first.
Level 1 is ``level1``'s output (32 channels), levels 2-5 the four stages.

Every BatchNorm has ``make_norm``'s eps 1e-5 and momentum 0.9.  The ReLUs
are module attributes (``act``).  The net does not honour ``_sg_levels``
(``backbones/base.py``): a frozen prefix runs its backward.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator, make_conv, make_norm
from sihl_tpu_torch.ops.image import max_pool2d
from sihl_tpu_torch.ops.relu import relu as _relu


class _ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k, stride=1, relu=True, *, generator, device=None):
        super().__init__()
        self.conv = make_conv(cin, cout, k, stride=stride, bias=False, generator=generator, device=device)
        self.bn = make_norm("batch", cout, device=device)
        self.act = _relu if relu else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class DlaBasic(nn.Module):
    """Two 3x3 convs with a residual provided by the caller."""

    def __init__(self, cin, cout, stride=1, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv1 = _ConvBNReLU(cin, cout, 3, stride=stride, **kw)
        self.conv2 = _ConvBNReLU(cout, cout, 3, relu=False, **kw)
        self.act = _relu

    def forward(self, x, shortcut):
        return self.act(self.conv2(self.conv1(x)) + shortcut)


class DlaBottleneck(nn.Module):
    """1x1 → 3x3 → 1x1 with DLA's expansion of 2 (mid = cout // 2)."""

    def __init__(self, cin, cout, stride=1, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        mid = cout // 2
        self.conv1 = _ConvBNReLU(cin, mid, 1, **kw)
        self.conv2 = _ConvBNReLU(mid, mid, 3, stride=stride, **kw)
        self.conv3 = _ConvBNReLU(mid, cout, 1, relu=False, **kw)
        self.act = _relu

    def forward(self, x, shortcut):
        return self.act(self.conv3(self.conv2(self.conv1(x))) + shortcut)


class _Root(nn.Module):
    """Aggregation node: concatenate the children → 1x1 conv (+ the first
    child where ``residual``) → ReLU."""

    def __init__(self, cin, cout, residual, *, generator, device=None):
        super().__init__()
        self.conv = _ConvBNReLU(cin, cout, 1, relu=False, generator=generator, device=device)
        self.residual = residual
        self.act = _relu

    def forward(self, children: List[torch.Tensor]) -> torch.Tensor:
        out = self.conv(torch.cat(children, dim=1))
        if self.residual:
            out = out + children[0]
        return self.act(out)


class _Tree(nn.Module):
    """Recursive hierarchical aggregation (one DLA stage at depth
    ``levels``); ``root_dim`` grows as in the JAX package: ``2 * cout``,
    plus ``cin`` at a level root, plus ``cout`` for each deeper ``tree2``."""

    def __init__(self, levels: int, block, cin: int, cout: int, stride: int = 1, root_dim: int = 0,
                 root_residual: bool = False, level_root: bool = False, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        self.levels, self.stride, self.level_root = levels, stride, level_root
        if levels == 1:
            self.tree1 = block(cin, cout, stride=stride, **kw)
            self.tree2 = block(cout, cout, stride=1, **kw)
            self.root = _Root(root_dim, cout, root_residual, **kw)
            self.project = _ConvBNReLU(cin, cout, 1, relu=False, **kw) if cin != cout else None
        else:
            self.tree1 = _Tree(levels - 1, block, cin, cout, stride=stride, root_dim=0,
                               root_residual=root_residual, **kw)
            self.tree2 = _Tree(levels - 1, block, cout, cout, stride=1, root_dim=root_dim + cout,
                               root_residual=root_residual, **kw)
            self.root = None
            self.project = None

    def forward(self, x, children: Optional[List[torch.Tensor]] = None):
        children = [] if children is None else children
        bottom = max_pool2d(x, self.stride, stride=self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            shortcut = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, shortcut)
            x2 = self.tree2(x1, x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


# name -> (levels of stages 2..5, channels, bottleneck blocks, residual roots)
DLA_CONFIGS = {
    "dla34": ((1, 2, 2, 1), (64, 128, 256, 512), False, False),
    "dla60": ((1, 2, 3, 1), (128, 256, 512, 1024), True, False),
    "dla102": ((1, 3, 4, 1), (128, 256, 512, 1024), True, True),
    "dla169": ((2, 3, 5, 1), (128, 256, 512, 1024), True, True),
}


class DlaFeatures(nn.Module):
    _sg_levels = 0

    def __init__(self, name: str, input_channels: int = 3, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=device)
        levels, channels, bottleneck, root_residual = DLA_CONFIGS[name]
        block = DlaBottleneck if bottleneck else DlaBasic
        self.base = _ConvBNReLU(input_channels, 16, 7, **kw)
        self.level0 = _ConvBNReLU(16, 16, 3, **kw)
        self.level1 = _ConvBNReLU(16, 32, 3, stride=2, **kw)
        self.stages = nn.ModuleList()
        cin = 32
        for i, (depth, c) in enumerate(zip(levels, channels)):
            self.stages.append(_Tree(depth, block, cin, c, stride=2, root_residual=root_residual, level_root=i > 0,
                                     **kw))
            cin = c
        self.feature_channels = [32] + list(channels)
        self.level_modules = [["base", "level0", "level1"]] + [[("stages", i)] for i in range(4)]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.level1(self.level0(self.base(x)))
        outs = [x]
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return outs


def make_dla_features(name, input_channels=3, *, generator=None, device=None) -> DlaFeatures:
    return DlaFeatures(name, input_channels=input_channels, generator=generator, device=device)
