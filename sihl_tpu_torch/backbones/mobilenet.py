"""MobileNetV2 / V3 feature nets (counterpart of
``sihl_tpu/backbones/mobilenet.py``).

Levels are torchvision's feature nodes ``features.{1,3,6,13,18}`` (v2),
``{1,3,6,12,16}`` (v3-large) and ``{0,1,3,8,12}`` (v3-small: level 1 is the
stem's output).  The JAX package's choices are kept where torchvision's
differ: MobileNetV3's ``"RE"`` activation is ReLU6 (torchvision: ReLU),
every BatchNorm has eps 1e-5 and momentum 0.9 (torchvision's V3: eps
1e-3), and hardswish and hardsigmoid are ``x * clip(x + 3, 0, 6) / 6`` and
``clip(x + 3, 0, 6) / 6``.  Each clip is ``minimum(maximum(.))``, which
splits the gradient at a bound as ``jnp.clip`` does.

The activations are held as module attributes (``act``, and an SE block's
``gate``), so that a caller may wrap them.  Depthwise convs are grouped
``F.conv2d`` calls.  The net does not honour ``_sg_levels``
(``backbones/base.py``): a frozen prefix runs its backward.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator, make_conv, make_norm
from sihl_tpu_torch.ops.relu import relu


# 0-dim CPU scalars: a binary op takes them beside a tensor on any device
_ZERO, _SIX = torch.tensor(0.0), torch.tensor(6.0)


def _clip06(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 6)``: ``minimum(maximum(x, 0), 6)``, half the
    gradient to each side at a bound."""
    return torch.minimum(torch.maximum(x, _ZERO), _SIX)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(jnp.maximum(x, 0), 0, 6)``."""
    return _clip06(torch.maximum(x, _ZERO))


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * _clip06(x + 3.0) / 6.0


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return _clip06(x + 3.0) / 6.0


_ACTS = {"RE": relu6, "HS": hardswish, "relu6": relu6, None: None}


class _ConvBNAct(nn.Module):
    """conv (no bias) → BatchNorm → ``act`` ("relu6", "RE", "HS" or None)."""

    def __init__(self, cin, cout, k, stride=1, groups=1, act="relu6", *, generator, device=None):
        super().__init__()
        self.conv = make_conv(cin, cout, k, stride=stride, groups=groups, bias=False, generator=generator,
                              device=device)
        self.bn = make_norm("batch", cout, device=device)
        self.act = _ACTS[act]

    def forward(self, x):
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class _SEv3(nn.Module):
    """Squeeze-excitation: the spatial mean → 1x1 conv → ReLU → 1x1 conv →
    hardsigmoid, scaling the input."""

    def __init__(self, channels, squeeze, *, generator, device=None):
        super().__init__()
        self.fc1 = make_conv(channels, squeeze, 1, generator=generator, device=device)
        self.fc2 = make_conv(squeeze, channels, 1, generator=generator, device=device)
        self.act, self.gate = relu, hardsigmoid

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * self.gate(self.fc2(self.act(self.fc1(s))))


class InvertedResidualV2(nn.Module):
    def __init__(self, cin, cout, stride, expand_ratio, *, generator, device=None):
        super().__init__()
        hidden = cin * expand_ratio
        self.use_residual = stride == 1 and cin == cout
        kw = dict(generator=generator, device=device)
        self.expand = _ConvBNAct(cin, hidden, 1, **kw) if expand_ratio != 1 else None
        self.depthwise = _ConvBNAct(hidden, hidden, 3, stride=stride, groups=hidden, **kw)
        self.project = _ConvBNAct(hidden, cout, 1, act=None, **kw)

    def forward(self, x):
        h = x if self.expand is None else self.expand(x)
        h = self.project(self.depthwise(h))
        return x + h if self.use_residual else h


class InvertedResidualV3(nn.Module):
    def __init__(self, cin, cout, kernel, exp, use_se, act, stride, *, generator, device=None):
        super().__init__()
        self.use_residual = stride == 1 and cin == cout
        kw = dict(generator=generator, device=device)
        self.expand = _ConvBNAct(cin, exp, 1, act=act, **kw) if exp != cin else None
        self.depthwise = _ConvBNAct(exp, exp, kernel, stride=stride, groups=exp, act=act, **kw)
        self.se = _SEv3(exp, _round8(exp // 4), **kw) if use_se else None
        self.project = _ConvBNAct(exp, cout, 1, act=None, **kw)

    def forward(self, x):
        h = x if self.expand is None else self.expand(x)
        h = self.depthwise(h)
        if self.se is not None:
            h = self.se(h)
        h = self.project(h)
        return x + h if self.use_residual else h


def _round8(v):
    new = max(8, int(v + 4) // 8 * 8)
    if new < 0.9 * v:
        new += 8
    return new


_V2_CFG = [  # (expand, out, num, stride)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]
# v3: (kernel, exp, out, se, act, stride)
_V3_LARGE = [
    (3, 16, 16, False, "RE", 1), (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1), (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1), (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2), (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1), (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1), (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2), (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
]
_V3_SMALL = [
    (3, 16, 16, True, "RE", 2), (3, 72, 24, False, "RE", 2),
    (3, 88, 24, False, "RE", 1), (5, 96, 40, True, "HS", 2),
    (5, 240, 40, True, "HS", 1), (5, 240, 40, True, "HS", 1),
    (5, 120, 48, True, "HS", 1), (5, 144, 48, True, "HS", 1),
    (5, 288, 96, True, "HS", 2), (5, 576, 96, True, "HS", 1),
    (5, 576, 96, True, "HS", 1),
]
MOBILENET_CONFIGS = {
    "mobilenet_v2": _V2_CFG,
    "mobilenet_v3_large": _V3_LARGE,
    "mobilenet_v3_small": _V3_SMALL,
    # timm's width variants: channels scaled by the multiplier through _round8
    "mobilenet_v2_050": _V2_CFG,
    "mobilenet_v2_140": _V2_CFG,
    "mobilenet_v3_small_050": _V3_SMALL,
    "mobilenet_v3_small_075": _V3_SMALL,
}

_WIDTH_MULT = {
    "mobilenet_v2_050": 0.5,
    "mobilenet_v2_140": 1.4,
    "mobilenet_v3_small_050": 0.5,
    "mobilenet_v3_small_075": 0.75,
}


class MobileNetFeatures(nn.Module):
    """Levels 1..5 (strides 2..32): a stem, inverted residual ``blocks`` and
    a 1x1 ``head`` conv, which is level 5.  ``level_modules`` freezes the
    stem (and v2's and v3-large's first block) with level 1 and the head
    with level 5; levels 2-4 name no module, as in the JAX package."""

    _sg_levels = 0

    def __init__(self, name: str, input_channels: int = 3, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=device)
        self.name = name
        width = _WIDTH_MULT.get(name, 1.0)
        adjust = (lambda c: _round8(c * width)) if width != 1.0 else (lambda c: c)
        blocks = []
        if name.startswith("mobilenet_v2"):
            stem_c = adjust(32)
            self.stem = _ConvBNAct(input_channels, stem_c, 3, stride=2, **kw)
            cin = stem_c
            for t, c, n, s in _V2_CFG:
                c = adjust(c)
                for i in range(n):
                    blocks.append(InvertedResidualV2(cin, c, s if i == 0 else 1, t, **kw))
                    cin = c
            self.blocks = nn.ModuleList(blocks)
            # torchvision: last_channel = make_divisible(1280 * max(1, w))
            head_c = _round8(1280 * max(1.0, width))
            self.head = _ConvBNAct(cin, head_c, 1, **kw)
            self._emit_blocks, self._emit_stem = [0, 2, 5, 12], False  # features 1..17 are the blocks
            self.feature_channels = [adjust(16), adjust(24), adjust(32), adjust(96), head_c]
        else:
            cfg = MOBILENET_CONFIGS[name]
            stem_c = adjust(16)
            self.stem = _ConvBNAct(input_channels, stem_c, 3, stride=2, act="HS", **kw)
            cin = stem_c
            for k, exp, c, se, act, s in cfg:
                exp, c = adjust(exp), adjust(c)
                blocks.append(InvertedResidualV3(cin, c, k, exp, se, act, s, **kw))
                cin = c
            self.blocks = nn.ModuleList(blocks)
            # torchvision: lastconv_output = 6 * lastconv_input (960 / 576 at width 1)
            head_c = 6 * cin
            self.head = _ConvBNAct(cin, head_c, 1, act="HS", **kw)
            if "large" in name:
                self._emit_blocks, self._emit_stem = [0, 2, 5, 11], False
                self.feature_channels = [adjust(16), adjust(24), adjust(40), adjust(112), head_c]
            else:  # level 1 is the stem's output; features.8 is block 7 (48 channels, stride 16)
                self._emit_blocks, self._emit_stem = [0, 2, 7], True
                self.feature_channels = [stem_c, adjust(16), adjust(24), adjust(48), head_c]
        first = ["stem"] if self._emit_stem else ["stem", ("blocks", 0)]
        self.level_modules = [first, [], [], [], ["head"]]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = [x] if self._emit_stem else []
        emit = set(self._emit_blocks)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in emit:
                outs.append(x)
        outs.append(self.head(x))
        return outs


def make_mobilenet_features(name, input_channels=3, *, generator=None, device=None) -> MobileNetFeatures:
    return MobileNetFeatures(name, input_channels=input_channels, generator=generator, device=device)
