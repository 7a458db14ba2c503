"""Semantic segmentation head, PP-LiteSeg style (counterpart of
``sihl_tpu/heads/semantic_segmentation.py``): SPPM context aggregation on
the top level, top-down lateral + upscale + UAFM fusion, a conv tower
readout.

The logits come at the bottom level and are resized (nearest) to the
input's size for the forward and to the targets' size for the loss: the
f32 softmax, max and argmax of the forward, and the loss's f32
log-softmax and one-hot, run over (B, num_classes, H, W) at full
resolution, as in the JAX package.
"""

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.layers.convblocks import ConvNormAct, SequentialConvBlocks, default_generator, make_conv
from sihl_tpu_torch.layers.scalers import SimpleUpscaler
from sihl_tpu_torch.ops.image import interpolate
from sihl_tpu_torch.ops.losses import cross_entropy
from sihl_tpu_torch.policy import upcast
from sihl_tpu_torch.training import metrics as M


class SPPM(nn.Module):
    """Simple Pyramid Pooling Module (https://arxiv.org/abs/2204.02681).

    The pooling is a bilinear resize to each pool size (antialiased, since
    it shrinks), a 1x1 ConvNormAct, and a bilinear resize back to the
    level's size; a size equal to the level's is the identity."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        pool_sizes: Tuple[int, ...] = (1, 2, 4),
        with_shortcut: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        generator = default_generator(generator)
        self.pool_sizes = tuple(pool_sizes)
        self.with_shortcut = with_shortcut
        self.pool_convs = nn.ModuleList(
            ConvNormAct(in_channels, out_channels, 1, generator=generator, device=device) for _ in self.pool_sizes
        )
        if with_shortcut:
            self.shortcut = ConvNormAct(in_channels, out_channels, 1, generator=generator, device=device)
        self.out_conv = ConvNormAct(out_channels, out_channels, 1, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = tuple(x.shape[2:])
        fused = None
        for pool_size, conv in zip(self.pool_sizes, self.pool_convs):
            p = interpolate(x, size=(pool_size, pool_size), mode="bilinear")
            p = interpolate(conv(p), size=size, mode="bilinear")
            fused = p if fused is None else fused + p
        if self.with_shortcut:
            fused = fused + self.shortcut(x)
        return self.out_conv(fused)


def channel_max(x: torch.Tensor) -> torch.Tensor:
    """Each pixel's largest channel, (B, 1, H, W): ``torch.amax``, which
    splits its gradient among tied channels as ``jnp.max`` does."""
    return x.amax(dim=1, keepdim=True)


class UAFM(nn.Module):
    """Unified Attention Fusion Module (https://arxiv.org/abs/2204.02681):
    a sigmoid weight from each pixel's channel mean and max of both inputs,
    stacked [mean x1, max x1, mean x2, max x2].  The max picks one channel's
    gradient path, so it is held as the attribute ``channel_max`` that a
    caller may wrap, as the depth head's ReLUs."""

    def __init__(self, in_channels: int, out_channels: int, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.conv = ConvNormAct(4, 1, norm=None, act="sigmoid", generator=default_generator(generator),
                                device=device)
        self.channel_max = channel_max

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        stats = torch.cat(
            [x1.mean(dim=1, keepdim=True), self.channel_max(x1),
             x2.mean(dim=1, keepdim=True), self.channel_max(x2)],
            dim=1,
        )
        alpha = self.conv(stats)
        return x1 * alpha + x2 * (1 - alpha)


class SemanticSegmentation(Head):
    """Pixelwise multiclass classification (PP-LiteSeg decoder)."""

    def __init__(
        self,
        in_channels: List[int],
        num_classes: int,
        bottom_level: int = 3,
        top_level: int = 5,
        num_channels: int = 256,
        num_layers: int = 3,
        pool_sizes: Tuple[int, ...] = (1, 2, 4),
        ignore_index: Optional[int] = None,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if num_classes <= 0:
            raise ValueError(f"num_classes must be > 0, got {num_classes}")
        if not len(in_channels) > top_level >= bottom_level > 0:
            raise ValueError(f"levels {bottom_level}-{top_level} do not fit {len(in_channels)} inputs")
        if num_channels <= 0 or num_layers < 0:
            raise ValueError(f"num_channels must be > 0 and num_layers >= 0, got {num_channels}, {num_layers}")
        generator = default_generator(generator)
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.num_channels = num_channels
        self.bottom_level = bottom_level
        self.top_level = top_level
        self.ignore_index = -100 if ignore_index is None else ignore_index
        self.rev_levels = list(reversed(range(bottom_level, top_level)))
        kw = dict(generator=generator, device=device)
        self.context_aggregation = SPPM(in_channels[top_level], num_channels, tuple(pool_sizes), **kw)
        self.lateral_convs = nn.ModuleList(
            ConvNormAct(in_channels[level], num_channels, **kw) for level in self.rev_levels
        )
        self.upscalers = nn.ModuleList(SimpleUpscaler(num_channels, num_channels, **kw) for _ in self.rev_levels)
        self.fusions = nn.ModuleList(UAFM(num_channels, num_channels, **kw) for _ in self.rev_levels)
        self.out_convs = SequentialConvBlocks(num_channels, num_channels, num_layers, **kw)
        self.logit_conv = make_conv(num_channels, num_classes, 1, **kw)
        self.output_shapes = {
            "score_maps": ("batch_size", "height", "width"),
            "class_maps": ("batch_size", "height", "width"),
        }

    def get_logits(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        """Logits (B, num_classes, H / 2^bottom_level, W / 2^bottom_level) in
        the compute dtype."""
        x = self.context_aggregation(inputs[self.top_level])
        for level, lateral, upscale, fuse in zip(self.rev_levels, self.lateral_convs, self.upscalers, self.fusions):
            x = fuse(lateral(inputs[level]), upscale(x))
        return self.logit_conv(self.out_convs(x))

    def forward(self, inputs: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(score_maps, class_maps), each (B, H, W): the largest f32 softmax
        probability of each pixel and its class."""
        logits = interpolate(self.get_logits(inputs), size=inputs[0].shape[2:])
        probs = torch.softmax(upcast(logits), dim=1)
        return probs.amax(dim=1), probs.argmax(dim=1)

    def _loss(self, inputs, targets: torch.Tensor):
        logits = interpolate(self.get_logits(inputs), size=targets.shape[1:3])
        ce = cross_entropy(logits, targets, ignore_index=self.ignore_index, dim=1)
        valid = (targets != self.ignore_index).to(ce.dtype)
        return ce.sum() / torch.clamp(valid.sum(), min=1.0), logits

    def training_step(self, inputs, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """targets: (B, H, W) integer classes, ``ignore_index`` for void."""
        loss, _ = self._loss(inputs, targets)
        return loss, {}

    def metrics_init(self):
        device = self._device()
        return {"loss": M.mean_init(device), "seg": M.segmentation_init(self.num_classes, device)}

    def validation_step(self, state, inputs, targets):
        loss, logits = self._loss(inputs, targets)
        state = {
            "loss": M.mean_update(state["loss"], loss),
            "seg": M.segmentation_update(state["seg"], logits.argmax(dim=1), targets, ignore_index=self.ignore_index),
        }
        return state, loss, {}

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        seg = M.segmentation_compute(state["seg"])
        return {
            "loss": float(M.mean_compute(state["loss"])),
            "pixel_accuracy": float(seg["accuracy"]),
            "mean_iou": float(seg["mean_iou"]),
        }
