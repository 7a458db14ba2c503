"""Image-space ops on NCHW tensors (counterpart of ``sihl_tpu/ops/image.py``).

Nearest 2x upsampling, ``interpolate`` (nearest and bilinear, by size or
scale), average and max pooling and their adaptive forms, the linear
resize of mask targets, the binomial blur-pool, Sobel ``edges``,
``gaussian_blur``, and the bit packing of binary masks for validation.
"""

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from sihl_tpu_torch.policy import upcast


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def interpolate(
    x: torch.Tensor,
    size: Optional[Tuple[int, int]] = None,
    scale: Optional[Union[int, float]] = None,
    mode: str = "nearest",
) -> torch.Tensor:
    """Resize (B, C, H, W) to ``size`` or by ``scale`` ("nearest" or
    "bilinear") as ``jax.image.resize`` does: "nearest" takes the pixel whose
    centre is nearest the output pixel's (``F.interpolate``'s
    "nearest-exact"; its "nearest" floors and misses), "bilinear" is
    :func:`resize_linear` (antialiased when shrinking).  The result is in
    channels_last memory."""
    h, w = x.shape[2:]
    if size is None:
        if scale is None:
            raise ValueError("interpolate needs a size or a scale")
        size = (int(h * scale), int(w * scale))
    size = tuple(size)
    if size == (h, w):
        return x
    if mode == "nearest" and size == (2 * h, 2 * w):
        out = upsample2x_nearest(x)
    elif mode == "nearest":
        out = F.interpolate(x, size=size, mode="nearest-exact")
    elif mode == "bilinear":
        out = resize_linear(x, size)
    else:
        raise ValueError(f"unknown interpolation mode {mode!r}")
    return out.contiguous(memory_format=torch.channels_last)


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two axes of (B, C, H, W) to ``size`` as
    ``jax.image.resize(method="linear")`` does: half-pixel centres and, when
    shrinking, a triangle filter widened by the scale (antialiasing), which
    ``F.interpolate``'s antialiased bilinear mode computes.  An upscaling by
    whole factors widens nothing, and there the plain bilinear mode computes
    the same weights (equal within f64 rounding) far faster: on the card the
    antialiased mode's backward took 55% of a dense-model training step (the
    decoders' 2x upscalers and SPPM's growths back to the level's size)."""
    size = tuple(size)
    (h, w), (oh, ow) = x.shape[2:], size
    whole_upscale = oh >= h and ow >= w and oh % h == 0 and ow % w == 0
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=not whole_upscale)


def avg_pool2d(
    x: torch.Tensor,
    kernel_size: Union[int, Sequence[int]],
    stride: Optional[Union[int, Sequence[int]]] = None,
    padding: Union[int, Sequence[int]] = 0,
) -> torch.Tensor:
    """Average pool whose zero padding counts in the mean (the JAX package's
    and torch's default), summed in f32 (f64 for f64 inputs) and returned in
    ``x``'s dtype."""
    out = F.avg_pool2d(
        upcast(x), kernel_size, stride=stride if stride is not None else kernel_size, padding=padding,
        count_include_pad=True,
    )
    return out.to(x.dtype)


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


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def adaptive_avg_pool(x: torch.Tensor, output_size: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """Adaptive average pool of (B, C, H, W) to (B, C, oh, ow): exact block
    means where the sizes divide, else the JAX package's fallback, a linear
    resize (:func:`resize_linear`)."""
    oh, ow = _pair(output_size)
    b, c, h, w = x.shape
    if oh == 1 and ow == 1:
        return x.mean(dim=(2, 3), keepdim=True)
    if h % oh == 0 and w % ow == 0:
        return x.reshape(b, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return resize_linear(x, (oh, ow))


def adaptive_max_pool(x: torch.Tensor, output_size: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """Adaptive max pool of (B, C, H, W) to (B, C, oh, ow); the sizes must divide."""
    oh, ow = _pair(output_size)
    b, c, h, w = x.shape
    if oh == 1 and ow == 1:
        return x.amax(dim=(2, 3), keepdim=True)
    if h % oh or w % ow:
        raise ValueError(f"adaptive_max_pool needs sizes that divide, got {(h, w)} to {(oh, ow)}")
    return x.reshape(b, c, oh, h // oh, ow, w // ow).amax(dim=(3, 5))


def _depthwise_conv(x: torch.Tensor, kernel_hw: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Depthwise conv of (B, C, H, W) ``x`` with one (kh, kw) kernel shared by
    every channel, unpadded, in the kernel's dtype."""
    c = x.shape[1]
    kernel = kernel_hw[None, None].expand(c, 1, *kernel_hw.shape)
    return F.conv2d(x.to(kernel.dtype), kernel, stride=stride, groups=c)


def blur_pool_2d(x: torch.Tensor, kernel_size: int = 3, stride: int = 1) -> torch.Tensor:
    """Antialiased (binomial-kernel) blur-pool with reflect padding, as the
    JAX package's: kernel ``poly1d((0.5, 0.5)) ** (k - 1)`` in its outer
    product, reflect pad of ``((s - 1) + (k - 1)) // 2``, a strided depthwise
    conv in f32 (f64 for f64 inputs), and the result in ``x``'s dtype, in
    channels_last memory."""
    coeffs = (np.poly1d((0.5, 0.5)) ** (kernel_size - 1)).coeffs
    xp = upcast(x)
    k1 = torch.tensor(coeffs, dtype=xp.dtype, device=x.device)
    pad = ((stride - 1) + (kernel_size - 1)) // 2
    xp = F.pad(xp, (pad, pad, pad, pad), mode="reflect")
    out = _depthwise_conv(xp, k1[:, None] * k1[None, :], stride=stride)
    return out.to(dtype=x.dtype, memory_format=torch.channels_last)


def edges(x: torch.Tensor) -> torch.Tensor:
    """Sobel edge magnitude of each channel of (B, C, H, W), zero-padded,
    divided by its largest value over the whole tensor (plus 1e-12); in f32
    (f64 for f64 inputs), returned in ``x``'s dtype."""
    xp = F.pad(upcast(x), (1, 1, 1, 1))
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=xp.dtype, device=x.device)
    mag = torch.sqrt(_depthwise_conv(xp, kx) ** 2 + _depthwise_conv(xp, kx.T.contiguous()) ** 2)
    return (mag / (mag.max() + 1e-12)).to(x.dtype)


def gaussian_blur(x: torch.Tensor, kernel_size: int = 5, sigma: Optional[float] = None) -> torch.Tensor:
    """Depthwise Gaussian blur of (B, C, H, W) with zero padding; ``sigma``
    defaults to OpenCV's ``0.3 * ((k - 1) / 2 - 1) + 0.8``.  In f32 (f64 for
    f64 inputs), returned in ``x``'s dtype."""
    sigma = sigma or (0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8)
    half = kernel_size // 2
    xp = F.pad(upcast(x), (half, half, half, half))
    coords = torch.arange(-half, half + 1, dtype=xp.dtype, device=x.device)
    k1 = torch.exp(-(coords**2) / (2.0 * sigma**2))
    k1 = k1 / k1.sum()
    return _depthwise_conv(xp, k1[:, None] * k1[None, :]).to(x.dtype)


def packbits_last(x: torch.Tensor) -> torch.Tensor:
    """Pack a boolean tensor's last axis into uint8 bits (little-endian bit
    order) on its device, so that binary masks cross to the host at an
    eighth of the bytes during validation; the last axis is zero-padded to
    a multiple of 8.  Host-side inverse:
    ``np.unpackbits(arr, axis=-1, bitorder="little")[..., :w]``."""
    w = x.shape[-1]
    x = x.to(torch.uint8)
    pad = (-w) % 8
    if pad:
        x = F.pad(x, (0, pad))
    x = x.reshape(*x.shape[:-1], (w + pad) // 8, 8)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8, device=x.device)
    return (x * weights).sum(dim=-1, dtype=torch.uint8)
