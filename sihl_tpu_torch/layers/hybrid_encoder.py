"""RT-DETR-style HybridEncoder neck (counterpart of
``sihl_tpu/layers/hybrid_encoder.py``): a 1-layer transformer encoder with
a 2D sine position embedding on the top level, then FPN + PAN conv fusion
paths built from :class:`CSPRepLayer` / :class:`RepVGGBlock`.

The encoder reads the top map's pixels as tokens in row-major (H, W) order,
as the JAX package flattens its NHWC map: the NCHW map is permuted to
(B, H, W, C) before the (H, W, C) embedding is added and the tokens are
flattened, and reshaped back in the same order.  The top-down path
upsamples with the plain nearest 2x and concatenates (K3's fused
upsample-add does not apply).
"""

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sihl_tpu_torch.layers.convblocks import StandardConvNormAct, default_generator, make_norm
from sihl_tpu_torch.layers.transformer import TransformerEncoderLayer
from sihl_tpu_torch.ops.embeddings import sine_embedding_2d_grid
from sihl_tpu_torch.ops.image import upsample2x_nearest


class RepVGGBlock(nn.Module):
    """3x3 + 1x1 + identity-BatchNorm branches, summed, then SiLU."""

    def __init__(self, num_channels: int, *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator = default_generator(generator)
        self.conv1 = StandardConvNormAct(num_channels, num_channels, 3, act=None, generator=generator, device=device)
        self.conv2 = StandardConvNormAct(num_channels, num_channels, 1, act=None, generator=generator, device=device)
        self.identity = make_norm("batch", num_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv1(x) + self.conv2(x) + self.identity(x))


class CSPRepLayer(nn.Module):
    """Cross-stage partial fusion of two feature maps, concatenated in the
    order given on the channel axis."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 3, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator = default_generator(generator)
        self.conv1 = StandardConvNormAct(in_channels, out_channels, 1, act="silu", generator=generator, device=device)
        self.conv2 = StandardConvNormAct(in_channels, out_channels, 1, act="silu", generator=generator, device=device)
        self.bottlenecks = nn.ModuleList(
            RepVGGBlock(out_channels, generator=generator, device=device) for _ in range(num_layers))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x1, x2], dim=1)
        h = self.conv1(x)
        for block in self.bottlenecks:
            h = block(h)
        return h + self.conv2(x)


class HybridEncoder(nn.Module):
    """https://github.com/lyuwenyu/RT-DETR (rtdetr hybrid_encoder)."""

    def __init__(
        self,
        in_channels: List[int],
        out_channels: int,
        bottom_level: int,
        top_level: int,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if out_channels % 2:
            raise ValueError(f"out_channels must be even, got {out_channels}")
        generator = default_generator(generator)
        self.in_channels = in_channels
        self.top_in_level = min(top_level, len(in_channels) - 1)
        self.bottom_level, self.top_level = bottom_level, top_level
        levels = range(bottom_level, top_level + 1)
        self.num_channels = out_channels
        self.out_channels = list(in_channels)
        self.out_channels[levels.start : levels.stop] = [out_channels for _ in levels]

        def conv(cin, cout, k=3, stride=1, act="silu"):
            return StandardConvNormAct(cin, cout, k, stride=stride, act=act, generator=generator, device=device)

        self.input_projections = nn.ModuleList(
            conv(in_channels[level], out_channels, 1, act=None) for level in range(bottom_level, self.top_in_level + 1)
        )
        self.encoder = TransformerEncoderLayer(
            out_channels, num_heads=8, ff_dim=4 * out_channels, activation="gelu", norm_first=True,
            generator=generator, device=device,
        )

        def fusion():
            return CSPRepLayer(out_channels * 2, out_channels, generator=generator, device=device)

        # top-down (fpn)
        self.up_convs = nn.ModuleList()
        self.up_fusions = nn.ModuleList()
        for _ in range(self.top_in_level, bottom_level, -1):
            self.up_convs.append(conv(out_channels, out_channels, 1))
            self.up_fusions.append(fusion())

        self.extra_downscalers = nn.ModuleList(
            conv(out_channels, out_channels, 3, stride=2) for _ in range(top_level - len(in_channels) + 1)
        )

        # bottom-up (pan)
        self.down_convs = nn.ModuleList()
        self.down_fusions = nn.ModuleList()
        for _ in range(bottom_level, top_level):
            self.down_convs.append(conv(out_channels, out_channels, 3, stride=2))
            self.down_fusions.append(fusion())

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = inputs[self.bottom_level : self.top_in_level + 1]
        xs = [project(x) for project, x in zip(self.input_projections, xs)]

        top = xs[-1]
        batch_size, _, height, width = top.shape
        pos_emb = sine_embedding_2d_grid(height, width, self.num_channels, device=top.device)
        tokens = (top.permute(0, 2, 3, 1) + pos_emb[None].to(top.dtype)).reshape(
            batch_size, height * width, self.num_channels
        )
        # an extra residual around the (already residual) encoder, as the JAX
        # package keeps it from the reference
        x = tokens + self.encoder(tokens)
        x = x.reshape(batch_size, height, width, self.num_channels).permute(0, 3, 1, 2)
        xs = xs[:-1] + [x]

        inner_outs = [x]
        for idx, (conv, fuse) in enumerate(zip(self.up_convs, self.up_fusions)):
            feat_low = xs[len(xs) - 2 - idx]
            feat_high = conv(inner_outs[0])
            inner_outs[0] = feat_high
            inner_out = fuse(upsample2x_nearest(feat_high), feat_low)
            inner_outs.insert(0, inner_out)

        for downscaler in self.extra_downscalers:
            inner_outs.append(downscaler(inner_outs[-1]))

        outs = [inner_outs[0]]
        for idx, (conv, fuse) in enumerate(zip(self.down_convs, self.down_fusions)):
            outs.append(fuse(conv(outs[-1]), inner_outs[idx + 1]))

        return list(inputs[: self.bottom_level]) + outs + list(inputs[self.top_level + 1 :])
