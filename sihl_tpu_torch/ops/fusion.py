"""Fused multiscale fusion (counterpart of ``sihl_tpu/ops/pallas/fusion.py``).

``fused_upsample_add`` (K3, the FPN merge) and ``fused_weighted_sum`` (K6,
BiFPN's softmax-weighted fusion).  A CUDA tensor goes to the Triton kernels
of ``fusion_triton.py``, a CPU tensor to the plain version beside each.
"""

from typing import Sequence

import torch

from sihl_tpu_torch.ops.build import use_triton_cache
from sihl_tpu_torch.ops.image import upsample2x_nearest
from sihl_tpu_torch.policy import upcast

_CL = torch.channels_last


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


# -- softmax-weighted feature fusion ---------------------------------------


def fused_weighted_sum_reference(weights: torch.Tensor, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version, in the kernel's order: ``w0 * x0``, then
    ``+ w_i * x_i`` for each later input, each product and sum rounded to f32
    (f64 for f64 inputs), and the result rounded once to the inputs' dtype.
    (The JAX package's own plain path rounds the weights to the inputs'
    dtype first; its TPU kernel, which this follows, does not.)"""
    acc_dtype = torch.promote_types(inputs[0].dtype, torch.float32)
    w = weights.to(acc_dtype)
    acc = inputs[0].to(acc_dtype) * w[0]
    for i, x in enumerate(inputs[1:], start=1):
        acc = acc + x.to(acc_dtype) * w[i]
    return acc.to(inputs[0].dtype)


_WEIGHTED_SUM_DTYPES = (torch.float32, torch.bfloat16)


def _fused_weighted_sum_cuda(weights: torch.Tensor, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    if len(inputs) not in (2, 3):
        raise ValueError(f"the weighted-sum kernel takes 2 or 3 inputs, got {len(inputs)}")
    if inputs[0].dtype not in _WEIGHTED_SUM_DTYPES:
        raise ValueError(f"the weighted-sum kernel takes {_WEIGHTED_SUM_DTYPES}, got {inputs[0].dtype}")
    if weights.dtype != torch.float32 or not weights.is_contiguous():
        raise ValueError(f"the weighted-sum kernel takes contiguous float32 weights, got {weights.dtype}")
    if not all(x.dim() == 4 and x.is_contiguous(memory_format=_CL) for x in inputs):
        raise ValueError("the weighted-sum kernel takes channels_last-contiguous (B, C, H, W) inputs")
    if inputs[0].numel() >= 2**31:
        raise ValueError("the weighted-sum kernel indexes with 32-bit offsets")
    use_triton_cache()
    from sihl_tpu_torch.ops import fusion_triton

    out = torch.empty_like(inputs[0], memory_format=_CL)
    if out.numel():
        with torch.cuda.device(out.device):
            fusion_triton.launch_weighted_sum(weights, inputs, out)
        fused_weighted_sum.launches += 1
    return out


class _WeightedSum(torch.autograd.Function):
    """Forward: the Triton kernel on the card, the plain version on the CPU.
    Backward, plain PyTorch as in the JAX custom VJP (``fusion.py:172-179``):
    ``dw_i = sum(g * x_i)`` in f32 (f64 for f64), in the weights' dtype, and
    ``dx_i = w_i * g`` in f32, cast to ``x_i``'s dtype."""

    @staticmethod
    def forward(ctx, weights, *inputs):
        ctx.save_for_backward(weights, *inputs)
        if weights.device.type == "cuda":
            return _fused_weighted_sum_cuda(weights, inputs)
        return fused_weighted_sum_reference(weights, inputs)

    @staticmethod
    def backward(ctx, g):
        weights, *inputs = ctx.saved_tensors
        g_up = upcast(g)
        d_weights = None
        if ctx.needs_input_grad[0]:
            d_weights = torch.stack([(g_up * upcast(x)).sum() for x in inputs]).to(weights.dtype)
        w = weights.to(g_up.dtype)
        d_inputs = [
            (g_up * w[i]).to(x.dtype) if ctx.needs_input_grad[i + 1] else None
            for i, x in enumerate(inputs)
        ]
        return (d_weights, *d_inputs)


def fused_weighted_sum(weights: torch.Tensor, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sum_i weights[i] * inputs[i]`` over same-shape (B, C, H, W) maps of
    one dtype, accumulated in f32 and rounded once; differentiable in the
    weights and the inputs.  ``weights``: (N,) f32 (f64 for f64 inputs),
    read on the device.  A CUDA tensor goes to the Triton kernel (2 or 3
    channels_last inputs), a CPU tensor to :func:`fused_weighted_sum_reference`.
    """
    inputs = tuple(inputs)
    if not inputs or tuple(weights.shape) != (len(inputs),):
        raise ValueError(f"need weights of shape ({len(inputs)},), got {tuple(weights.shape)}")
    x0 = inputs[0]
    for x in inputs[1:]:
        if x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError(
                f"inputs must share shape, dtype and device, got {tuple(x.shape)} {x.dtype} {x.device} "
                f"against {tuple(x0.shape)} {x0.dtype} {x0.device}"
            )
    if weights.device != x0.device:
        raise ValueError(f"weights on {weights.device}, inputs on {x0.device}")
    if x0.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_weighted_sum runs on CUDA or CPU tensors, got {x0.device}")
    return _WeightedSum.apply(weights, *inputs)


fused_weighted_sum.launches = 0  # kernel launches since the last reset
