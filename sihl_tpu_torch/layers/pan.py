"""Path Aggregation Network neck (counterpart of ``sihl_tpu/layers/pan.py``).

An FPN pass, its top-down merges on K3 (:func:`~sihl_tpu_torch.ops.fusion.fused_upsample_add`),
then a bottom-up path: each level above the bottom adds a stride-2
downscale of the already aggregated level below.  The FPN base takes the
requested ``norm`` and ``act`` (default SiLU), as in the JAX package.
"""

from typing import List, Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import ConvNormAct, default_generator
from sihl_tpu_torch.layers.fpn import FPN


class PAN(FPN):
    """https://arxiv.org/abs/1803.01534 — FPN plus a bottom-up path."""

    def __init__(
        self,
        in_channels: List[int],
        out_channels: int,
        bottom_level: int,
        top_level: int,
        norm: str = "batch",
        act: str = "silu",
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        generator = default_generator(generator)
        super().__init__(in_channels, out_channels, bottom_level, top_level, norm, act, generator=generator,
                         device=device)
        # one stride-2 aggregator a level above the bottom, in sihl's conv → act → norm order
        self.aggregate = nn.ModuleList(
            ConvNormAct(out_channels, out_channels, stride=2, norm=norm, act=act, generator=generator, device=device)
            for _ in range(bottom_level, top_level)
        )

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        pyramid = super().forward(features)
        bot = self.bottom_level
        out = [pyramid[bot]]
        for down, lvl in zip(self.aggregate, range(bot + 1, self.top_level + 1)):
            out.append(down(out[-1]) + pyramid[lvl])
        return list(pyramid[:bot]) + out + list(pyramid[self.top_level + 1:])
