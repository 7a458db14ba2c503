"""Triton kernel of :func:`sihl_tpu_torch.ops.fusion.fused_upsample_add`.

Replaces the TPU kernel ``sihl_tpu/ops/pallas/fusion.py:_upsample_add_kernel``
(launched by ``_upsample_add_pallas``).  This module imports Triton, so only
the CUDA path of ``fusion.py`` imports it, at its first launch.

The op is one broadcast read of ``top``, one read of ``lateral`` and one
write, with no reduction and no matmul: it is bound by device-memory
bandwidth.  Each program takes ``BLOCK_P`` output pixels by all channels of
the channels_last (NHWC) memory, so every load and store runs along
contiguous channels, and the upsampled map never exists in memory.
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
