"""The ResNet stem's conv split into legs, each doing one part of the work:
the port of the JAX package's stem-variant probe
(``tools/probe_stem_variants.py``), which times stripped variants of the
stem kernel to say which part of it is slow.

:func:`stem_variant` takes x (B, H, W, 3) NHWC with H and W even and w
(7, 7, 3, 64) HWIO, and returns y (B, H/2, W/2, 64) NHWC.  Each ``mode``
computes a defined function:

- ``"load"``: y[b, i, j, co] = x[b, 2i, 2j, co % 3] (the kernel stages every
  input byte of each tile's halo and reads these back);
- ``"stage"``: y[b, i, j, co] = A[b, i, j, co] for co < 64, where A is the
  patch operand of the conv, A[b, i, j, k] = x_pad[b, 2i + ky - 3,
  2j + kx - 3, c] with k = (ky * 7 + kx) * 3 + c and x_pad x with zeros
  outside the image (see :func:`patches`);
- ``"product"``: y[b, i, j, :] = the conv's output at (b, 0, 0), from A's
  window of that pixel alone (the kernel runs every tile's products on it);
- ``"full"``: y = the stem conv (stride 2, padding 3), rounded once to bf16
  from f32 sums.

A CUDA tensor goes to the hand-written kernel of ``csrc/stem_variants.cu``
(one template with the mode at compile time; the file says how it is laid
out and what bounds it); a CPU tensor to :func:`stem_variant_reference`.  No
model path calls it: ``sihl_tpu_torch.tools.probe_stem_variants`` and
``chip_smoke.py`` do.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from sihl_tpu_torch.ops.build import cuda_library
from sihl_tpu_torch.ops.stem import KERNEL_SIZE, OUT_CHANNELS, PADDING, STRIDE, stem_conv_stats_reference

MODES = ("load", "stage", "product", "full")
CHANNELS = 3
TAPS = KERNEL_SIZE * KERNEL_SIZE * CHANNELS  # 147, the conv's contraction


def patches(x: torch.Tensor) -> torch.Tensor:
    """The conv's patch operand: (B, H/2, W/2, 147) with entry k = (ky * 7 +
    kx) * 3 + c of pixel (i, j) equal to x[b, 2i + ky - 3, 2j + kx - 3, c],
    zero outside the image."""
    _, h, w, _ = x.shape
    ho, wo = h // STRIDE, w // STRIDE
    xp = F.pad(x, (0, 0, PADDING, PADDING, PADDING, PADDING))
    taps = [xp[:, ky : ky + STRIDE * ho : STRIDE, kx : kx + STRIDE * wo : STRIDE, :]
            for ky in range(KERNEL_SIZE) for kx in range(KERNEL_SIZE)]
    return torch.stack(taps, dim=3).reshape(*taps[0].shape[:3], TAPS)


def stem_variant_reference(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version of each leg's function (see the module's doc).
    ``"full"`` is the y of :func:`ops.stem.stem_conv_stats_reference` (the
    conv summed in f32, rounded once) in NHWC, its BatchNorm sums dropped;
    ``"product"`` sums its 147 products in f32 and rounds once to x's
    dtype."""
    if mode == "load":
        channel = torch.arange(OUT_CHANNELS, device=x.device) % CHANNELS
        return x[:, ::STRIDE, ::STRIDE, :][..., channel].contiguous()
    if mode == "stage":
        return patches(x)[..., :OUT_CHANNELS].contiguous()
    b, h, wd, _ = x.shape
    if mode == "product":
        corner = KERNEL_SIZE - PADDING  # the rows and columns pixel (0, 0)'s window reads
        window = patches(x[:, :corner, :corner])[:, 0, 0]
        out = (window.float() @ w.reshape(TAPS, OUT_CHANNELS).float()).to(x.dtype)
        return out[:, None, None, :].expand(b, h // STRIDE, wd // STRIDE, OUT_CHANNELS).contiguous()
    if mode == "full":
        y, _, _ = stem_conv_stats_reference(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
        return y.permute(0, 2, 3, 1).contiguous()
    raise ValueError(f"stem_variant's mode is one of {MODES}, got {mode!r}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_library("stem_variants")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sihl_stem_variant.argtypes = [i, p, p, i, i, i, p, p]
    lib.sihl_stem_variant.restype = i
    lib.sihl_cuda_error_string.argtypes = [i]
    lib.sihl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _stem_variant_cuda(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    for t, name in ((x, "x"), (w, "w")):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the stem_variant kernel takes bf16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the stem_variant kernel takes a contiguous {name} (x NHWC, w HWIO)")
    if x.dim() != 4 or x.shape[3] != CHANNELS or x.shape[1] % 2 or x.shape[2] % 2 or min(x.shape) < 1:
        raise ValueError(f"the stem_variant kernel takes x of shape (B, even H, even W, 3), got {tuple(x.shape)}")
    if tuple(w.shape) != (KERNEL_SIZE, KERNEL_SIZE, CHANNELS, OUT_CHANNELS):
        raise ValueError(f"the stem_variant kernel takes w of shape (7, 7, 3, 64), got {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if x.data_ptr() % 4:
        raise ValueError("the stem_variant kernel reads x in 4-byte words: x must start 4-byte aligned")
    b, h, wd, _ = x.shape
    lib = _library()
    y = torch.empty((b, h // 2, wd // 2, OUT_CHANNELS), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sihl_stem_variant(MODES.index(mode), x.data_ptr(), w.data_ptr(), b, h, wd, y.data_ptr(), stream)
    if err:
        raise RuntimeError(f"stem_variant kernel launch failed: {lib.sihl_cuda_error_string(err).decode()}")
    stem_variant.launches += 1
    return y


@torch.no_grad()
def stem_variant(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Leg ``mode`` of the stem conv of x (B, H, W, 3) NHWC by w (7, 7, 3, 64)
    HWIO: y (B, H/2, W/2, 64) NHWC, bf16 on the card.  No gradient flows
    through it."""
    if mode not in MODES:
        raise ValueError(f"stem_variant's mode is one of {MODES}, got {mode!r}")
    if x.device.type == "cuda":
        return _stem_variant_cuda(x, w, mode)
    if x.device.type == "cpu":
        return stem_variant_reference(x, w, mode)
    raise ValueError(f"stem_variant runs on CUDA or CPU tensors, got {x.device}")


stem_variant.launches = 0  # kernel launches since the last reset
