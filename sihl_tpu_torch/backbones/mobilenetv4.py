"""MobileNetV4 feature nets (counterpart of
``sihl_tpu/backbones/mobilenetv4.py``; Qin et al., arXiv:2404.10518, the
timm ``mobilenetv4_*`` models).

The building block is the Universal Inverted Bottleneck (UIB): an optional
depthwise conv before the expansion, a 1x1 expansion, an optional
depthwise conv in the middle and a 1x1 projection.  The ``hybrid`` variants
add a Mobile-MQA block (multi-query attention: one K/V head shared by the
query heads) after every third deep UIB, the JAX package's reconstruction
of timm's interleave, kept as it is (ROADMAP.md, queue C).  Every ReLU is a
module attribute (``act``), so that a caller may wrap it.  The net does
not honour ``_sg_levels`` (``backbones/base.py``): a frozen prefix runs its
backward.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator, make_conv, make_norm
from sihl_tpu_torch.layers.mlp import LayerNorm, Linear
from sihl_tpu_torch.ops.relu import relu
from sihl_tpu_torch.policy import upcast


class _ConvBN(nn.Module):
    """conv (no bias) → BatchNorm → ReLU where ``act``."""

    def __init__(self, cin, cout, k, stride=1, groups=1, act=True, *, generator, device=None):
        super().__init__()
        self.conv = make_conv(cin, cout, k, stride=stride, groups=groups, bias=False, generator=generator,
                              device=device)
        self.bn = make_norm("batch", cout, device=device)
        self.act = relu if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class UIB(nn.Module):
    """Universal Inverted Bottleneck: [dw_start] → expand 1x1 → [dw_mid] →
    project 1x1; residual when the shapes allow."""

    def __init__(self, cin, cout, k_start, k_mid, stride, expand, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        mid = int(cin * expand)
        self.use_residual = stride == 1 and cin == cout
        self.dw_start = _ConvBN(cin, cin, k_start, groups=cin, act=False, **kw) if k_start else None
        self.expand = _ConvBN(cin, mid, 1, **kw)
        self.dw_mid = _ConvBN(mid, mid, k_mid, stride=stride, groups=mid, **kw) if k_mid else None
        self.project = _ConvBN(mid, cout, 1, act=False, **kw)

    def forward(self, x):
        h = x if self.dw_start is None else self.dw_start(x)
        h = self.expand(h)
        if self.dw_mid is not None:
            h = self.dw_mid(h)
        h = self.project(h)
        return x + h if self.use_residual else h


class FusedIB(nn.Module):
    """Fused inverted bottleneck: a full 3x3 expansion conv → 1x1 project."""

    def __init__(self, cin, cout, stride, expand, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        mid = int(cin * expand)
        self.use_residual = stride == 1 and cin == cout
        self.fused = _ConvBN(cin, mid, 3, stride=stride, **kw)
        self.project = _ConvBN(mid, cout, 1, act=False, **kw)

    def forward(self, x):
        h = self.project(self.fused(x))
        return x + h if self.use_residual else h


class MobileMQA(nn.Module):
    """Mobile multi-query attention (arXiv:2404.10518, section 4.2): the
    pixels as tokens, pre-LayerNorm (eps 1e-6), ``num_heads`` query heads
    over one shared key and value head, bias-free projections, plus the
    input.  The logits are taken in f32 (f64 for f64 compute) times
    ``head_dim ** -0.5``, the softmax there too, and the weights cast to the
    values' dtype, as the JAX package computes them."""

    def __init__(self, channels, num_heads=4, head_dim=64, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.num_heads, self.head_dim = num_heads, head_dim
        self.norm = LayerNorm(channels, eps=1e-6, device=device)
        self.q = Linear(channels, num_heads * head_dim, bias=False, **kw)
        self.kv = Linear(channels, 2 * head_dim, bias=False, **kw)
        self.out = Linear(num_heads * head_dim, channels, bias=False, **kw)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.norm(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        q = self.q(tokens).reshape(b, h * w, self.num_heads, self.head_dim)
        kv = self.kv(tokens)
        k, v = kv[..., : self.head_dim], kv[..., self.head_dim:]
        logits = upcast(torch.einsum("bqhd,bkd->bhqk", q, k)) * self.head_dim**-0.5
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkd->bqhd", attn, v)
        out = self.out(out.reshape(b, h * w, self.num_heads * self.head_dim))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


# spec entries:
#   ("conv", cout, k, stride)
#   ("fused", cout, stride, expand)
#   ("uib", cout, k_start, k_mid, stride, expand)
#   ("mqa",)
# a pyramid level is emitted after the last block at each stride
MOBILENETV4_CONFIGS = {
    "mobilenetv4_conv_small": [
        ("conv", 32, 3, 2), ("conv", 32, 1, 1),
        ("conv", 96, 3, 2), ("conv", 64, 1, 1),
        ("uib", 96, 5, 5, 2, 3.0), ("uib", 96, 0, 3, 1, 2.0),
        ("uib", 96, 0, 3, 1, 2.0), ("uib", 96, 0, 3, 1, 2.0),
        ("uib", 96, 0, 3, 1, 2.0), ("uib", 96, 3, 0, 1, 4.0),
        ("uib", 128, 3, 3, 2, 6.0), ("uib", 128, 5, 5, 1, 4.0),
        ("uib", 128, 0, 5, 1, 4.0), ("uib", 128, 0, 5, 1, 3.0),
        ("uib", 128, 0, 3, 1, 4.0), ("uib", 128, 0, 3, 1, 4.0),
        ("conv", 960, 1, 1),  # timm's blocks end with cn_r1_k1_s1_c960
    ],
    "mobilenetv4_conv_medium": [
        ("fused", 48, 2, 4.0),
        ("uib", 80, 3, 5, 2, 4.0), ("uib", 80, 3, 3, 1, 2.0),
        ("uib", 160, 3, 5, 2, 6.0), ("uib", 160, 3, 3, 1, 4.0),
        ("uib", 160, 3, 3, 1, 4.0), ("uib", 160, 3, 5, 1, 4.0),
        ("uib", 160, 3, 3, 1, 4.0), ("uib", 160, 3, 0, 1, 4.0),
        ("uib", 160, 0, 0, 1, 2.0), ("uib", 160, 3, 0, 1, 4.0),
        ("uib", 256, 5, 5, 2, 6.0), ("uib", 256, 5, 5, 1, 4.0),
        ("uib", 256, 3, 5, 1, 4.0), ("uib", 256, 3, 5, 1, 4.0),
        ("uib", 256, 0, 0, 1, 4.0), ("uib", 256, 3, 0, 1, 4.0),
        ("uib", 256, 3, 5, 1, 2.0), ("uib", 256, 5, 5, 1, 4.0),
        ("uib", 256, 0, 0, 1, 4.0), ("uib", 256, 0, 0, 1, 4.0),
        ("uib", 256, 5, 0, 1, 2.0),
        ("conv", 960, 1, 1),
    ],
    "mobilenetv4_conv_large": [
        ("fused", 48, 2, 4.0),
        ("uib", 96, 3, 5, 2, 4.0), ("uib", 96, 3, 3, 1, 4.0),
        ("uib", 192, 3, 5, 2, 4.0), ("uib", 192, 3, 3, 1, 4.0),
        ("uib", 192, 3, 3, 1, 4.0), ("uib", 192, 3, 3, 1, 4.0),
        ("uib", 192, 3, 5, 1, 4.0), ("uib", 192, 5, 3, 1, 4.0),
        ("uib", 192, 5, 3, 1, 4.0), ("uib", 192, 5, 3, 1, 4.0),
        ("uib", 192, 5, 3, 1, 4.0), ("uib", 192, 5, 3, 1, 4.0),
        ("uib", 192, 3, 0, 1, 4.0),
        ("uib", 512, 5, 5, 2, 4.0), ("uib", 512, 5, 5, 1, 4.0),
        ("uib", 512, 5, 5, 1, 4.0), ("uib", 512, 5, 5, 1, 4.0),
        ("uib", 512, 5, 0, 1, 4.0), ("uib", 512, 5, 3, 1, 4.0),
        ("uib", 512, 5, 0, 1, 4.0), ("uib", 512, 5, 0, 1, 4.0),
        ("uib", 512, 5, 3, 1, 4.0), ("uib", 512, 5, 5, 1, 4.0),
        ("uib", 512, 5, 0, 1, 4.0), ("uib", 512, 5, 0, 1, 4.0),
        ("uib", 512, 5, 0, 1, 4.0),
        ("conv", 960, 1, 1),
    ],
}
# the hybrids: the conv specs with an MQA block after every third stride-1
# UIB of the deep widths
_DEEP_CHANNELS = {160, 192, 256, 512}
for _src, _dst in (("mobilenetv4_conv_medium", "mobilenetv4_hybrid_medium"),
                   ("mobilenetv4_conv_large", "mobilenetv4_hybrid_large")):
    _spec, _count = [], 0
    for _e in MOBILENETV4_CONFIGS[_src]:
        _spec.append(_e)
        if _e[0] == "uib" and _e[1] in _DEEP_CHANNELS and _e[4] == 1:
            _count += 1
            if _count % 3 == 0:
                _spec.append(("mqa",))
    MOBILENETV4_CONFIGS[_dst] = _spec


class MobileNetV4Features(nn.Module):
    """Levels 1..5: the ``stem`` (stride 2; 32 wide for small and medium, 24
    for large), then the ``blocks``; each of levels 2-5 is the last block at
    its stride (4, 8, 16, 32).  ``level_modules`` freezes the stem with level
    1 and each level's blocks with it, as ``("blocks", i)`` pairs."""

    _sg_levels = 0

    def __init__(self, name: str, input_channels: int = 3, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=default_generator(generator), device=device)
        spec = MOBILENETV4_CONFIGS[name]
        stem_c = 32 if "small" in name or "medium" in name else 24
        self.stem = _ConvBN(input_channels, stem_c, 3, stride=2, **kw)
        self.blocks = nn.ModuleList()
        cin, stride = stem_c, 2
        last_at_stride = {}  # cumulative stride -> (block index, channels)
        for entry in spec:
            kind = entry[0]
            if kind == "conv":
                _, cout, k, s = entry
                self.blocks.append(_ConvBN(cin, cout, k, stride=s, **kw))
            elif kind == "fused":
                _, cout, s, exp = entry
                self.blocks.append(FusedIB(cin, cout, s, exp, **kw))
            elif kind == "uib":
                _, cout, ks, km, s, exp = entry
                self.blocks.append(UIB(cin, cout, ks, km, s, exp, **kw))
            else:  # mqa
                cout, s = cin, 1
                self.blocks.append(MobileMQA(cin, **kw))
            stride *= s
            last_at_stride[stride] = (len(self.blocks) - 1, cout)
            cin = cout
        self._emit = [last_at_stride[s][0] for s in (4, 8, 16, 32)]
        self.feature_channels = [stem_c] + [last_at_stride[s][1] for s in (4, 8, 16, 32)]
        bounds = [-1] + self._emit
        self.level_modules = [["stem"]] + [
            [("blocks", i) for i in range(bounds[lv] + 1, bounds[lv + 1] + 1)] for lv in range(4)
        ]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = [x]
        emit = set(self._emit)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in emit:
                outs.append(x)
        return outs


def make_mobilenetv4_features(name, input_channels=3, *, generator=None, device=None) -> MobileNetV4Features:
    return MobileNetV4Features(name, input_channels=input_channels, generator=generator, device=device)
