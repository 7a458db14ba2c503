"""Image-space ops on NCHW tensors (counterpart of ``sihl_tpu/ops/image.py``).

Only what the serving slice runs is ported: nearest 2x upsampling, the
identity case of ``interpolate``, and max pooling.
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
