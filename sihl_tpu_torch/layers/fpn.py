"""Feature Pyramid Network neck (counterpart of ``sihl_tpu/layers/fpn.py``).

Replaces pyramid levels [bottom_level, top_level] with ``out_channels``-wide
fused maps and passes every other level through.  Per level: a 1x1
projection; top-down merging by nearest 2x upsample + add, where each upper
map is refined by a 1x1 conv *before* it is upsampled (and that refined map
is what the level emits); levels above the backbone's top come from
stride-2 convs on the highest merged map; every emitted level passes a
final 3x3 smoothing conv.  The merges go through
:func:`~sihl_tpu_torch.ops.fusion.fused_upsample_add`.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import StandardConvNormAct, default_generator
from sihl_tpu_torch.ops.fusion import fused_upsample_add


class FPN(nn.Module):
    """https://arxiv.org/abs/1612.03144"""

    def __init__(
        self,
        in_channels: List[int],
        out_channels: int,
        bottom_level: int,
        top_level: int,
        norm: str = "batch",
        act: str = "relu",
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if not 0 < bottom_level < top_level:
            raise ValueError(f"need 0 < bottom_level < top_level, got {bottom_level}, {top_level}")
        generator = default_generator(generator)
        self.bottom_level = bottom_level
        self.top_level = top_level
        # highest level the backbone provides; anything above is synthesized
        self.highest_in = min(top_level, len(in_channels) - 1)
        self.out_channels = (
            list(in_channels[:bottom_level])
            + [out_channels] * (top_level - bottom_level + 1)
            + list(in_channels[top_level + 1 :])
        )

        def conv(cin, cout, k=3, stride=1):
            return StandardConvNormAct(
                cin, cout, k, stride=stride, norm=norm, act=act, generator=generator, device=device
            )

        num_in = self.highest_in - bottom_level + 1
        self.project = nn.ModuleList(
            conv(in_channels[bottom_level + i], out_channels, 1) for i in range(num_in)
        )
        self.refine = nn.ModuleList(conv(out_channels, out_channels, 1) for _ in range(num_in - 1))
        self.synthesize = nn.ModuleList(
            conv(out_channels, out_channels, 3, stride=2)
            for _ in range(top_level - self.highest_in)
        )
        self.smooth = nn.ModuleList(
            conv(out_channels, out_channels) for _ in range(top_level - bottom_level + 1)
        )

    def _index(self, level: int) -> int:
        return level - self.bottom_level

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        bot, top_in = self.bottom_level, self.highest_in
        merged = {
            lvl: self.project[self._index(lvl)](features[lvl]) for lvl in range(bot, top_in + 1)
        }
        for lvl in range(top_in, bot, -1):
            refined = self.refine[self._index(lvl) - 1](merged[lvl])
            merged[lvl] = refined
            merged[lvl - 1] = fused_upsample_add(refined, merged[lvl - 1])
        for lvl in range(top_in + 1, self.top_level + 1):
            merged[lvl] = self.synthesize[lvl - top_in - 1](merged[lvl - 1])
        fused = [
            self.smooth[self._index(lvl)](merged[lvl]) for lvl in range(bot, self.top_level + 1)
        ]
        return list(features[:bot]) + fused + list(features[self.top_level + 1 :])
