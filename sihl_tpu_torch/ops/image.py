"""Image-space ops on NCHW tensors (counterpart of ``sihl_tpu/ops/image.py``).

Ported so far: nearest 2x upsampling, the identity case of ``interpolate``,
max pooling, and the linear resize of mask targets.
"""

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def interpolate(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize (B, C, H, W) to ``size``; only the identity case is ported."""
    h, w = x.shape[2:]
    if tuple(size) == (h, w):
        return x
    raise NotImplementedError(
        f"interpolate from {(h, w)} to {tuple(size)} is not ported yet (ROADMAP.md, M16)"
    )


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two axes of (B, C, H, W) to ``size`` as
    ``jax.image.resize(method="linear")`` does: half-pixel centres and, when
    shrinking, a triangle filter widened by the scale (antialiasing), which
    ``F.interpolate``'s antialiased bilinear mode computes."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)


def max_pool2d(
    x: torch.Tensor,
    kernel_size: Union[int, Sequence[int]],
    stride: Optional[Union[int, Sequence[int]]] = None,
    padding: Union[int, Sequence[int]] = 0,
) -> torch.Tensor:
    """Max pool whose padding counts as -inf (as ``reduce_window`` with a
    -inf init does in the JAX package)."""
    return F.max_pool2d(
        x, kernel_size, stride=stride if stride is not None else kernel_size, padding=padding
    )
