"""Fused multiscale fusion (counterpart of ``sihl_tpu/ops/pallas/fusion.py``).

Only ``fused_upsample_add`` is ported; ``fused_weighted_sum`` (BiFPN) waits
for its caller (ROADMAP.md, K6).
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
    use_triton_cache()
    from sihl_tpu_torch.ops import fusion_triton

    out = torch.empty_like(lateral, memory_format=cl)
    if out.numel():
        with torch.cuda.device(out.device):
            fusion_triton.launch(top, lateral, out)
        fused_upsample_add.launches += 1
    return out


class _UpsampleAdd(torch.autograd.Function):
    """Forward: the Triton kernel on the card, the plain version on the CPU.
    Backward, plain PyTorch as in the JAX custom VJP (``fusion.py:97-100``):
    ``top`` gets the 2x2 block sums of the cotangent, ``lateral`` the
    cotangent itself."""

    @staticmethod
    def forward(ctx, top, lateral):
        if top.device.type == "cuda":
            return _fused_upsample_add_cuda(top, lateral)
        return fused_upsample_add_reference(top, lateral)

    @staticmethod
    def backward(ctx, g):
        b, c, h2, w2 = g.shape
        d_top = g.unflatten(3, (w2 // 2, 2)).unflatten(2, (h2 // 2, 2)).sum(dim=(3, 5))
        return d_top.to(g.dtype).contiguous(memory_format=torch.channels_last), g


def fused_upsample_add(top: torch.Tensor, lateral: torch.Tensor) -> torch.Tensor:
    """``upsample2x_nearest(top) + lateral`` in one pass, differentiable.

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
    if top.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_upsample_add runs on CUDA or CPU tensors, got {top.device}")
    return _UpsampleAdd.apply(top, lateral)


fused_upsample_add.launches = 0  # kernel launches since the last reset
