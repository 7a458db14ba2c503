"""The ResNet stem's conv with BatchNorm's batch statistics in one pass
(counterpart of ``sihl_tpu/ops/pallas/stem.py``).

:func:`stem_conv_stats` computes the 7x7 / stride 2 / pad 3 conv of an image
with up to 8 channels to 64 channels, and the per-channel sum and sum of
squares of its output after the output is rounded to its dtype: the batch
statistics of the BatchNorm that follows.  It is forward only: the frozen
stem (``ResNetFeatures._sg_levels >= 1``) takes it, and nothing
differentiates through it.  A CUDA tensor goes to the hand-written kernel of
``csrc/stem.cu``: a bf16 image to its tensor-core body, which reads the
weights as :func:`weight_image`, an f32 image to its f32 FMA body (the file
says how each is laid out and what bounds it).  A CPU tensor goes to
:func:`stem_conv_stats_reference`.
"""

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from sihl_tpu_torch.ops.build import cuda_library
from sihl_tpu_torch.policy import upcast

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SIZE, STRIDE, PADDING, OUT_CHANNELS, MAX_CHANNELS = 7, 2, 3, 64, 8


def supported(x_shape, w_shape) -> bool:
    """Whether ``stem_conv_stats`` takes an image of (B, C, H, W) ``x_shape``
    and conv weights of (O, C, kh, kw) ``w_shape``: the ResNet stem's 7x7
    geometry, 1 to 8 input channels, even H and W, 64 outputs.  (The JAX
    package's row-tile condition is not needed: the kernel masks its own
    edges.)"""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    _, c, h, w = x_shape
    o, wc, kh, kw = w_shape
    return (
        (kh, kw) == (KERNEL_SIZE, KERNEL_SIZE)
        and wc == c
        and 1 <= c <= MAX_CHANNELS
        and h % 2 == 0
        and w % 2 == 0
        and h > 0
        and w > 0
        and o == OUT_CHANNELS
    )


def weight_image(weight: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's weights: (64, C, 7, 7) to (7 * 8 * CP, 64) bf16,
    where CP, the channels of a pixel as the kernel stages it, is 4 for
    C <= 4 and 8 above (a pair of taps or one tap is then 16 bytes, one row
    of the tensor cores' operand).  Row k = (ky * 8 + kx) * CP + c holds
    ``weight[:, c, ky, kx]``; the rows of an eighth tap kx = 7 and of the
    channels past C are zero.  That is the HWIO image (7, 7, C, 64) padded to
    (7, 8, CP, 64) and flattened.  The weights round to bf16 first, as the
    conv reads them.  Runs on any device."""
    o, c, _, _ = weight.shape
    staged = 4 if c <= 4 else 8
    hwio = weight.to(torch.bfloat16).permute(2, 3, 1, 0)
    return F.pad(hwio, (0, 0, 0, staged - c, 0, 1)).reshape(-1, o).contiguous()


def stem_conv_stats_reference(x: torch.Tensor, weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the conv of the image and the weights rounded
    to ``x``'s dtype, summed in f32 (f64 for f64 inputs) and rounded once to
    ``x``'s dtype, as the kernel and the TPU kernel compute it (a bf16 conv
    of cuDNN's may round partial sums); then the sums of the rounded output.
    On the card, a reference needs ``torch.backends.cudnn.allow_tf32 = False``."""
    acc = upcast(x)
    y = F.conv2d(acc, weight.to(x.dtype).to(acc.dtype), stride=STRIDE, padding=PADDING).to(x.dtype)
    yf = upcast(y)
    return y, yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_library("stem")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sihl_stem_conv_stats.argtypes = [i, p, i, i, i, i, p, p, p, p, p, p]
    lib.sihl_stem_conv_stats.restype = i
    lib.sihl_stem_workspace_floats.argtypes = [i, i, i, i]
    lib.sihl_stem_workspace_floats.restype = ctypes.c_longlong
    lib.sihl_cuda_error_string.argtypes = [i]
    lib.sihl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _is_nhwc(x: torch.Tensor) -> bool:
    """(B, C, H, W) stored as dense NHWC (channels_last; any layout when C = 1)."""
    return x.permute(0, 2, 3, 1).is_contiguous()


def _stem_conv_stats_cuda(x: torch.Tensor, weight: torch.Tensor):
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the stem kernel takes {list(_KERNEL_DTYPES)}, got {x.dtype}")
    if not _is_nhwc(x):
        raise ValueError("the stem kernel takes a channels_last-contiguous image")
    if x.numel() >= 2**31 or x.shape[0] * OUT_CHANNELS * (x.shape[2] // 2) * (x.shape[3] // 2) >= 2**31:
        raise ValueError("the stem kernel indexes a batch's rows with 32-bit offsets")
    if weight.device != x.device:
        raise ValueError(f"weights on {weight.device}, image on {x.device}")
    if x.data_ptr() % 4:
        raise ValueError("the stem kernel reads x in 4-byte words: x must start 4-byte aligned")
    lib = _library()
    b, c, h, w = x.shape
    is_bf16 = _KERNEL_DTYPES[x.dtype]
    # bf16: the tensor-core body's weight image; f32: (7, 7, C, 64) f32
    wk = weight_image(weight) if is_bf16 else weight.float().permute(2, 3, 1, 0).contiguous()
    y = torch.empty((b, OUT_CHANNELS, h // 2, w // 2), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    sums = torch.empty((2, OUT_CHANNELS), dtype=torch.float32, device=x.device)
    partials = torch.empty(lib.sihl_stem_workspace_floats(is_bf16, b, h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sihl_stem_conv_stats(
            is_bf16, x.data_ptr(), b, h, w, c, wk.data_ptr(), y.data_ptr(),
            partials.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"stem kernel launch failed: {lib.sihl_cuda_error_string(err).decode()}")
    stem_conv_stats.launches += 1
    return y, sums[0], sums[1]


@torch.no_grad()
def stem_conv_stats(x: torch.Tensor, weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stem conv of ``x`` (B, C, H, W) by ``weight`` (64, C, 7, 7), and
    BatchNorm's batch-statistic sums of its output.

    Returns ``(y, sum, sumsq)``: y is (B, 64, H/2, W/2) in ``x``'s dtype and
    channels_last memory; the sums are (64,) f32 (f64 for f64 inputs) over
    every position of the rounded y.  No gradient flows through it.
    """
    if not supported(tuple(x.shape), tuple(weight.shape)):
        raise ValueError(
            f"stem_conv_stats takes a (B, C<=8, even H, even W) image and (64, C, 7, 7) weights, got "
            f"{tuple(x.shape)} and {tuple(weight.shape)}"
        )
    if x.device.type == "cuda":
        return _stem_conv_stats_cuda(x, weight)
    if x.device.type == "cpu":
        return stem_conv_stats_reference(x, weight)
    raise ValueError(f"stem_conv_stats runs on CUDA or CPU tensors, got {x.device}")


stem_conv_stats.launches = 0  # kernel launches since the last reset
