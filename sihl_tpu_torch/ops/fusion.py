"""Fused multiscale fusion (counterpart of ``sihl_tpu/ops/pallas/fusion.py``).

Only ``fused_upsample_add`` (forward) is ported; ``fused_weighted_sum``
(BiFPN) waits for its caller (ROADMAP.md, K6).
"""

import torch

from sihl_tpu_torch.ops.build import use_triton_cache
from sihl_tpu_torch.ops.image import upsample2x_nearest


def fused_upsample_add_reference(top: torch.Tensor, lateral: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: nearest 2x upsample, then add."""
    return upsample2x_nearest(top) + lateral


def _fused_upsample_add_cuda(top: torch.Tensor, lateral: torch.Tensor) -> torch.Tensor:
    cl = torch.channels_last
    if not (top.is_contiguous(memory_format=cl) and lateral.is_contiguous(memory_format=cl)):
        raise ValueError("the upsample-add kernel takes channels_last-contiguous inputs")
    if lateral.numel() >= 2**31:
        raise ValueError("the upsample-add kernel indexes with 32-bit offsets")
    if torch.is_grad_enabled() and (top.requires_grad or lateral.requires_grad):
        raise NotImplementedError(
            "the upsample-add kernel has no backward yet; run inference under torch.no_grad()"
        )
    use_triton_cache()
    from sihl_tpu_torch.ops import fusion_triton

    out = torch.empty_like(lateral, memory_format=cl)
    if out.numel():
        with torch.cuda.device(out.device):
            fusion_triton.launch(top, lateral, out)
        fused_upsample_add.launches += 1
    return out


def fused_upsample_add(top: torch.Tensor, lateral: torch.Tensor) -> torch.Tensor:
    """``upsample2x_nearest(top) + lateral`` in one pass.

    top: (B, C, h, w); lateral: (B, C, 2h, 2w), of one dtype.  A CUDA tensor
    goes to the Triton kernel (``fusion_triton.py``), a CPU tensor to
    :func:`fused_upsample_add_reference`.
    """
    b, c, h, w = top.shape
    if tuple(lateral.shape) != (b, c, 2 * h, 2 * w):
        raise ValueError(f"lateral must be {(b, c, 2 * h, 2 * w)}, got {tuple(lateral.shape)}")
    if top.dtype != lateral.dtype or top.device != lateral.device:
        raise ValueError(
            f"top and lateral must share dtype and device, got {top.dtype}/{lateral.dtype} "
            f"on {top.device}/{lateral.device}"
        )
    if top.device.type == "cuda":
        return _fused_upsample_add_cuda(top, lateral)
    if top.device.type == "cpu":
        return fused_upsample_add_reference(top, lateral)
    raise ValueError(f"fused_upsample_add runs on CUDA or CPU tensors, got {top.device}")


fused_upsample_add.launches = 0  # kernel launches since the last reset
