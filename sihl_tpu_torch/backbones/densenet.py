"""DenseNet feature nets (counterpart of ``sihl_tpu/backbones/densenet.py``).

Level 1 is the stem's ReLU output (stride 2), before the 3x3 stride-2 max
pool; levels 2-5 are the dense blocks' outputs before each transition
(strides 4-32).  Level 5 is ``denseblock4`` without torchvision's
``norm5``, as in the JAX package (ROADMAP.md, queue C).  Each dense layer
is BatchNorm → ReLU → 1x1 conv → BatchNorm → ReLU → 3x3 conv, its output
concatenated after its input along the channels; a transition is
BatchNorm → ReLU → 1x1 conv → 2x2 average pool.  The 7x7 stride-2 stem conv
is a plain conv.  The ReLUs are module attributes (``act``, one a module,
called once a forward by the stem and a transition, twice by a dense
layer).  The net does not honour ``_sg_levels`` (``backbones/base.py``): a
frozen prefix runs its backward.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator, make_conv, make_norm
from sihl_tpu_torch.ops.image import avg_pool2d, max_pool2d
from sihl_tpu_torch.ops.relu import relu


class _DenseLayer(nn.Module):
    def __init__(self, cin, growth, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = make_norm("batch", cin, device=device)
        self.conv1 = make_conv(cin, 4 * growth, 1, bias=False, **kw)
        self.norm2 = make_norm("batch", 4 * growth, device=device)
        self.conv2 = make_conv(4 * growth, growth, 3, bias=False, **kw)
        self.act = relu

    def forward(self, x):
        h = self.conv1(self.act(self.norm1(x)))
        h = self.conv2(self.act(self.norm2(h)))
        return torch.cat([x, h], dim=1)


class _DenseBlock(nn.Module):
    def __init__(self, cin, growth, num_layers, *, generator, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            _DenseLayer(cin + i * growth, growth, generator=generator, device=device) for i in range(num_layers)
        )

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _Transition(nn.Module):
    def __init__(self, cin, cout, *, generator, device=None):
        super().__init__()
        self.norm = make_norm("batch", cin, device=device)
        self.conv = make_conv(cin, cout, 1, bias=False, generator=generator, device=device)
        self.act = relu

    def forward(self, x):
        return avg_pool2d(self.conv(self.act(self.norm(x))), 2, stride=2)


DENSENET_CONFIGS = {  # (growth, stem width, layers a block)
    "densenet121": (32, 64, (6, 12, 24, 16)),
    "densenet161": (48, 96, (6, 12, 36, 24)),
    "densenet169": (32, 64, (6, 12, 32, 32)),
    "densenet201": (32, 64, (6, 12, 48, 32)),
}


class DenseNetFeatures(nn.Module):
    """Levels 1..5: ``conv0`` and ``norm0`` (level 1), four dense ``blocks``
    and the three ``transitions`` between them; ``level_modules`` freezes
    the stem with level 1, block 1 with level 2, and each later block with
    the transition before it."""

    _sg_levels = 0

    def __init__(self, name: str, input_channels: int = 3, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=device)
        growth, init_c, block_cfg = DENSENET_CONFIGS[name]
        self.conv0 = make_conv(input_channels, init_c, 7, stride=2, padding=3, bias=False, **kw)
        self.norm0 = make_norm("batch", init_c, device=device)
        self.act = relu
        self.blocks = nn.ModuleList()
        self.transitions = nn.ModuleList()
        channels, c = [init_c], init_c
        for i, n in enumerate(block_cfg):
            self.blocks.append(_DenseBlock(c, growth, n, **kw))
            c = c + n * growth
            channels.append(c)
            if i < len(block_cfg) - 1:
                self.transitions.append(_Transition(c, c // 2, **kw))
                c = c // 2
        self.feature_channels = channels
        self.level_modules = [
            ["conv0", "norm0"],
            [("blocks", 0)],
            [("blocks", 1), ("transitions", 0)],
            [("blocks", 2), ("transitions", 1)],
            [("blocks", 3), ("transitions", 2)],
        ]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.act(self.norm0(self.conv0(x)))
        outs = [x]
        x = max_pool2d(x, 3, stride=2, padding=1)
        for i, block in enumerate(self.blocks):
            x = block(x)
            outs.append(x)
            if i < len(self.transitions):
                x = self.transitions[i](x)
        return outs


def make_densenet_features(name, input_channels=3, *, generator=None, device=None) -> DenseNetFeatures:
    return DenseNetFeatures(name, input_channels=input_channels, generator=generator, device=device)
