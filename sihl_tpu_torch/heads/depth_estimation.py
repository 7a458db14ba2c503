"""Monocular depth estimation head, AdaBins style (counterpart of
``sihl_tpu/heads/depth_estimation.py``), built on the PP-LiteSeg decoder
by subclassing :class:`SemanticSegmentation` with one logit a bin.

Bin widths come from the top level's mean over the pixels, the depth of a
pixel is the bin centres weighted by its ReLU'd logits, and the loss is a
scale-invariant log loss at the targets' resolution plus a masked,
bidirectional chamfer loss between the targets (at the logits'
resolution) and the bin centres, over a (B, pixels, bins) distance matrix.

The two ReLUs act on raw conv outputs (the bins' mean and the logits), so
they are held as attributes (``width_act``, ``weight_act``) that a caller
may wrap, as a ConvNormAct's ``act``.  The depth's clip to [0, 1] is
``minimum(maximum(x, 0), 1)``: at a bound it sends half the gradient on,
as ``jnp.clip`` does (``torch.clamp`` would send all of it), and a depth
map reaches 1 by rounding where the bins near 1 are narrow.
"""

from typing import Dict, List, Optional, Tuple

import torch

from sihl_tpu_torch.heads.semantic_segmentation import SemanticSegmentation
from sihl_tpu_torch.layers.convblocks import SequentialConvBlocks, default_generator, make_conv
from sihl_tpu_torch.ops.image import interpolate
from sihl_tpu_torch.ops.relu import relu
from sihl_tpu_torch.policy import upcast
from sihl_tpu_torch.training import metrics as M
from sihl_tpu_torch.utils import EPS


class DepthEstimation(SemanticSegmentation):
    """https://arxiv.org/abs/2011.14141 (AdaBins)."""

    def __init__(
        self,
        in_channels: List[int],
        lower_bound: float,
        upper_bound: float,
        bottom_level: int = 3,
        top_level: int = 5,
        num_channels: int = 256,
        num_layers: int = 1,
        num_bins: int = 256,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        if not lower_bound < upper_bound:
            raise ValueError(f"lower_bound {lower_bound} must be below upper_bound {upper_bound}")
        if num_bins <= 1:
            raise ValueError(f"num_bins must be > 1, got {num_bins}")
        generator = default_generator(generator)
        super().__init__(
            in_channels=in_channels,
            num_classes=num_bins,
            num_channels=num_channels,
            bottom_level=bottom_level,
            top_level=top_level,
            num_layers=num_layers,
            generator=generator,
            device=device,
        )
        self.num_bins = num_bins
        self.lower_bound, self.upper_bound = float(lower_bound), float(upper_bound)
        self.bin_convs = SequentialConvBlocks(
            in_channels[top_level], num_channels, num_layers, generator=generator, device=device
        )
        self.bin_conv_out = make_conv(num_channels, num_bins, 1, generator=generator, device=device)
        self.width_act = relu
        self.weight_act = relu
        self.output_shapes = {"depth_maps": ("batch_size", "height", "width")}

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.lower_bound) / (self.upper_bound - self.lower_bound)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * (self.upper_bound - self.lower_bound) + self.lower_bound

    def get_bin_centers(self, inputs) -> torch.Tensor:
        """(B, num_bins) bin centres in (0, 1), in f32."""
        x = self.bin_conv_out(self.bin_convs(inputs[self.top_level]))
        widths = self.width_act(upcast(x.mean(dim=(2, 3)))) + EPS
        widths = widths / widths.sum(dim=1, keepdim=True)
        return torch.cumsum(widths, dim=1) - widths / 2

    def get_depth_map(self, inputs, bin_centers: torch.Tensor) -> torch.Tensor:
        """(B, h, w) normalised depths at the logits' resolution, in f32."""
        weights = self.weight_act(upcast(self.get_logits(inputs))) + EPS
        weights = weights / weights.sum(dim=1, keepdim=True)
        depth = (weights * bin_centers[:, :, None, None]).sum(dim=1)
        zero = torch.zeros((), dtype=depth.dtype, device=depth.device)
        return torch.minimum(torch.maximum(depth, zero), zero + 1.0)

    def forward(self, inputs) -> torch.Tensor:
        """Depth maps (B, H, W) in [lower_bound, upper_bound], f32."""
        depth = self.denormalize(self.get_depth_map(inputs, self.get_bin_centers(inputs)))
        return interpolate(depth[:, None], size=inputs[0].shape[2:])[:, 0]

    def training_step(self, inputs, targets: torch.Tensor, masks: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """targets: (B, H, W) absolute depths; masks: (B, H, W) validity."""
        targets = self.normalize(upcast(targets))
        masks_f = masks.to(targets.dtype)
        # valid targets outside the bounds are clamped to them (their log
        # would be NaN), and invalid pixels, which may hold any value (0
        # depth), take a safe constant, as in the JAX package
        targets = torch.clamp(targets, EPS, 1.0)
        targets = torch.where(masks_f > 0, targets, 1.0)

        bin_centers = self.get_bin_centers(inputs)
        depth = self.get_depth_map(inputs, bin_centers)  # (B, h, w)
        pred_shape = tuple(depth.shape[1:])
        depth_full = interpolate(depth[:, None], size=targets.shape[1:3])[:, 0]

        # scale-invariant log loss over valid pixels, the unbiased variance
        g = torch.log(depth_full + EPS) - torch.log(targets + EPS)
        n = torch.clamp(masks_f.sum(), min=1.0)
        g_mean = (g * masks_f).sum() / n
        g_var = (((g - g_mean) ** 2) * masks_f).sum() / torch.clamp(n - 1.0, min=1.0)
        pix_loss = torch.sqrt(g_var + 0.15 * g_mean**2) * 10.0

        # bidirectional chamfer between the targets and the bin centres
        small_masks = interpolate(masks_f[:, None], size=pred_shape, mode="nearest")[:, 0] > 0
        small_targets = interpolate(targets[:, None], size=pred_shape)[:, 0]
        b = targets.shape[0]
        t_flat = small_targets.reshape(b, -1)  # (B, K)
        m_flat = small_masks.reshape(b, -1)
        dist = (t_flat[:, :, None] - bin_centers[:, None, :]) ** 2  # (B, K, L)
        fwd = dist.amin(dim=2)  # (B, K): the nearest bin of each pixel
        fwd = (fwd * m_flat).sum(dim=1) / torch.clamp(m_flat.sum(dim=1), min=1.0)
        bwd = torch.where(m_flat[:, :, None], dist, 1e9).amin(dim=1)  # (B, L): the nearest valid pixel of each bin
        any_valid = m_flat.any(dim=1, keepdim=True)
        bwd = torch.where(any_valid, bwd, 0.0).mean(dim=1)
        hist_loss = (fwd + bwd).mean()

        loss = pix_loss + hist_loss
        return loss, {"pixel_loss": pix_loss, "hist_loss": hist_loss}

    def metrics_init(self):
        device = self._device()
        return {"loss": M.mean_init(device), "reg": M.regression_init(device)}

    def validation_step(self, state, inputs, targets, masks):
        loss, _ = self.training_step(inputs, targets, masks)
        depth = self(inputs)
        state = {
            "loss": M.mean_update(state["loss"], loss),
            "reg": M.regression_update(state["reg"], depth, targets, mask=masks),
        }
        return state, loss, {}

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        reg = M.regression_compute(state["reg"])
        return {
            "loss": float(M.mean_compute(state["loss"])),
            "rmse": float(torch.sqrt(reg["mean_squared_error"])),
            "mae": float(reg["mean_absolute_error"]),
        }
