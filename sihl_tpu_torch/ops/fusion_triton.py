"""Triton kernels of :mod:`sihl_tpu_torch.ops.fusion`.  This module imports
Triton, so only the CUDA paths of ``fusion.py`` import it, at their first
launch.

``upsample_add_kernel`` (K3, :func:`~sihl_tpu_torch.ops.fusion.fused_upsample_add`)
replaces the TPU kernel ``sihl_tpu/ops/pallas/fusion.py:_upsample_add_kernel``
(launched by ``_upsample_add_pallas``).  The op is one broadcast read of
``top``, one read of ``lateral`` and one write, with no reduction and no
matmul: it is bound by device-memory bandwidth.  Each program takes
``BLOCK_P`` output pixels by all channels of the channels_last (NHWC)
memory, so every load and store runs along contiguous channels, and the
upsampled map never exists in memory.

``weighted_sum_kernel`` (K6, :func:`~sihl_tpu_torch.ops.fusion.fused_weighted_sum`)
replaces ``fusion.py:_weighted_sum_kernel`` (launched by
``_weighted_sum_pallas``): the sum of 2 or 3 maps times f32 weights.  It
reads each input once and writes the output once, 2 flops an element: bound
by device-memory bandwidth.  The TPU kernel walks (B, H) rows of its (8, 128)
tiles; here every input shares one memory order, so the maps are flat
arrays and each program takes a contiguous block of elements, with 16-byte
loads along it.  The weights stay on the device: the kernel loads the N
scalars from the softmax's output, so the host never waits for them.
The sum keeps the plain version's order and rounding (each product and
each add rounded to f32, no fused multiply-add), so the two agree bitwise.
"""

import triton
import triton.language as tl


@triton.jit
def upsample_add_kernel(
    top_ptr, lateral_ptr, out_ptr, num_pixels, h, w, C,
    BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr,
):
    pix = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
    ch = tl.arange(0, BLOCK_C)
    x2 = pix % (2 * w)
    rest = pix // (2 * w)
    y2 = rest % (2 * h)
    b = rest // (2 * h)
    top_pix = (b * h + y2 // 2) * w + x2 // 2
    mask = (pix < num_pixels)[:, None] & (ch < C)[None, :]
    lateral = tl.load(lateral_ptr + pix[:, None] * C + ch[None, :], mask=mask)
    top = tl.load(top_ptr + top_pix[:, None] * C + ch[None, :], mask=mask)
    # the sum is rounded once, from f32, as PyTorch's own add rounds it
    out = (lateral.to(tl.float32) + top.to(tl.float32)).to(out_ptr.dtype.element_ty)
    tl.store(out_ptr + pix[:, None] * C + ch[None, :], out, mask=mask)


def launch(top, lateral, out) -> None:
    """``out = nearest2x(top) + lateral`` on channels_last-contiguous
    (B, C, h, w), (B, C, 2h, 2w) and (B, C, 2h, 2w) tensors."""
    b, c, h, w = top.shape
    num_pixels = b * 4 * h * w
    block_c = triton.next_power_of_2(c)
    block_p = max(1, 2048 // block_c)
    grid = (triton.cdiv(num_pixels, block_p),)
    upsample_add_kernel[grid](
        top, lateral, out, num_pixels, h, w, c, BLOCK_P=block_p, BLOCK_C=block_c, num_warps=4
    )


@triton.jit
def weighted_sum_kernel(
    x0_ptr, x1_ptr, x2_ptr, w_ptr, out_ptr, numel,
    N: tl.constexpr, BLOCK: tl.constexpr,
):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < numel
    acc = tl.load(x0_ptr + offs, mask=mask).to(tl.float32) * tl.load(w_ptr)
    acc = acc + tl.load(x1_ptr + offs, mask=mask).to(tl.float32) * tl.load(w_ptr + 1)
    if N == 3:
        acc = acc + tl.load(x2_ptr + offs, mask=mask).to(tl.float32) * tl.load(w_ptr + 2)
    tl.store(out_ptr + offs, acc.to(out_ptr.dtype.element_ty), mask=mask)


def launch_weighted_sum(weights, inputs, out) -> None:
    """``out = sum_i weights[i] * inputs[i]`` over 2 or 3 tensors that share
    one shape, dtype and memory order with ``out``; ``weights``: (N,) f32 on
    the same card."""
    n = len(inputs)
    numel = out.numel()
    block = 2048
    grid = (triton.cdiv(numel, block),)
    x2 = inputs[2] if n == 3 else inputs[1]  # not read when N == 2
    weighted_sum_kernel[grid](
        inputs[0], inputs[1], x2, weights, out, numel, N=n, BLOCK=block, num_warps=4,
        enable_fp_fusion=False,
    )
