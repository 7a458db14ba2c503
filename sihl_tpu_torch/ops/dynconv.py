"""Dynamic per-instance pointwise decode, forward and backward (counterpart of
``sihl_tpu/ops/pallas/dynconv.py``).

The instance-segmentation head (CondInst) and the keypoint head (FCPose)
decode dense maps with a tiny 3-layer pointwise net whose weights are
predicted per instance:

    x1 = mf . W1f + (grid - center_i) . W1c + b1   -> silu
    x2 = x1 . W2 + b2                              -> silu
    out = x2 . W3 + b3

:func:`dynamic_pointwise_decode` sends a CUDA tensor to the autograd Function
:class:`_DynamicDecode`: K5f in the forward and K5b
(:func:`dynamic_pointwise_decode_backward`) in the backward, the
hand-written kernels of ``csrc/dynconv.cu`` (the file says how they are laid
out and what bounds them; K5f runs bf16 inputs on the tensor cores and f32
ones on FMAs, over the blocks of :func:`decode_plan`).  A CPU tensor goes to
:func:`reference_decode`, the plain einsum chain, whose backward is
autograd's.  The grid and the
centres get no gradient on either path (they come from constant anchors).
"""

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from sihl_tpu_torch.ops.build import cuda_library
from sihl_tpu_torch.policy import upcast

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_CHANNELS = (8, 32)
# K5f's blocks (csrc/dynconv.cu): pixels a block (its strip) and the most
# instances it stages, by channel count, for the bf16 tensor-core body
# (MmaPlan<C>); the f32 FMA body takes 256 pixels and as many instances as
# 48 KB of shared memory holds, at most 32.
_MMA_STRIP = {8: 256, 32: 640}
_MMA_MAX_GROUP = {8: 16, 32: 6}
_FMA_STRIP, _FMA_MAX_GROUP, _FMA_SMEM_FLOATS = 256, 32, 12288


def param_count(c: int, k: int) -> int:
    return (c + 2) * c + c + c * c + c + c * k + k


def decode_plan(s: int, i: int, c: int, k: int, is_bf16: bool) -> Tuple[int, int, int, int]:
    """K5f's grid over s pixels and i instances of an image: (strip, strips,
    group, groups), block (x, y) taking pixels [x * strip, (x + 1) * strip)
    and instances [y * group, (y + 1) * group), both cut at the end.  The
    tensor-core body evens out its groups (100 instances as 7 groups of at
    most 15, not 6 of 16 and one of 4)."""
    if is_bf16:
        strip, most = _MMA_STRIP[c], _MMA_MAX_GROUP[c]
        group = -(-i // -(-i // most))
    else:
        strip, group = _FMA_STRIP, min(_FMA_MAX_GROUP, _FMA_SMEM_FLOATS // (param_count(c, k) + 2))
    return strip, -(-s // strip), group, -(-i // group)


def _split(dyn: torch.Tensor, c: int, k: int):
    """dyn (..., P) -> w1f (..., c, c), w1c (..., 2, c), b1, w2, b2, w3, b3."""
    lead = dyn.shape[:-1]
    s0 = (c + 2) * c
    w1 = dyn[..., :s0].reshape(*lead, c + 2, c)
    w1f, w1c = w1[..., :c, :], w1[..., c:, :]
    b1 = dyn[..., s0 : s0 + c]
    s1 = s0 + c
    w2 = dyn[..., s1 : s1 + c * c].reshape(*lead, c, c)
    s2 = s1 + c * c
    b2 = dyn[..., s2 : s2 + c]
    s3 = s2 + c
    w3 = dyn[..., s3 : s3 + c * k].reshape(*lead, c, k)
    b3 = dyn[..., s3 + c * k :]
    return w1f, w1c, b1, w2, b2, w3, b3


def reference_decode(mask_feats, grid, centers, dyn, c: int, num_out: int) -> torch.Tensor:
    """Plain PyTorch version, the JAX package's einsum chain: (B, c, H, W)
    features, (H, W, 2) grid, (B, I, 2) centres and (B, I, P) weights ->
    (B, I, H, W, num_out) logits, in f32 (f64 for f64 inputs)."""
    dt = torch.promote_types(upcast(mask_feats).dtype, upcast(dyn).dtype)
    mf = mask_feats.to(dt).permute(0, 2, 3, 1)
    w1f, w1c, b1, w2, b2, w3, b3 = _split(dyn.to(dt), c, num_out)
    x = (
        torch.einsum("bhwc,bicd->bihwd", mf, w1f)
        + torch.einsum("hwe,bied->bihwd", grid.to(dt), w1c)
        - torch.einsum("bie,bied->bid", centers.to(dt), w1c)[:, :, None, None, :]
        + b1[:, :, None, None, :]
    )
    x = F.silu(x)
    x = torch.einsum("bihwc,bicd->bihwd", x, w2) + b2[:, :, None, None, :]
    x = F.silu(x)
    return torch.einsum("bihwc,bick->bihwk", x, w3) + b3[:, :, None, None, :]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_library("dynconv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sihl_dynconv_fwd.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i, i, p, p]
    lib.sihl_dynconv_fwd.restype = i
    lib.sihl_dynconv_bwd_workspace.argtypes = [i, i, i, i, i]
    lib.sihl_dynconv_bwd_workspace.restype = ctypes.c_size_t
    lib.sihl_dynconv_bwd.argtypes = [i, i, p, p, p, p, p, i, i, i, i, p, p, p, p]
    lib.sihl_dynconv_bwd.restype = i
    lib.sihl_dynconv_max_out.argtypes = []
    lib.sihl_dynconv_max_out.restype = i
    lib.sihl_cuda_error_string.argtypes = [i]
    lib.sihl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"dynamic decode {what} kernel launch failed: {lib.sihl_cuda_error_string(err).decode()}")


def _kernel_args(mask_feats, grid, centers, dyn, c: int, num_out: int):
    """Check what the kernels take; the small inputs as contiguous f32."""
    lib = _library()
    if c not in _KERNEL_CHANNELS or not 1 <= num_out <= lib.sihl_dynconv_max_out():
        raise ValueError(
            f"the dynamic decode kernels take c in {_KERNEL_CHANNELS} and 1 to "
            f"{lib.sihl_dynconv_max_out()} outputs, got c={c}, num_out={num_out}"
        )
    if mask_feats.dtype not in _KERNEL_DTYPES or dyn.dtype != mask_feats.dtype:
        raise ValueError(
            f"the dynamic decode kernels take features and weights of one dtype in "
            f"{list(_KERNEL_DTYPES)}, got {mask_feats.dtype} and {dyn.dtype}"
        )
    return lib, grid.float().contiguous(), centers.float().contiguous(), dyn.contiguous()


def _forward_cuda(mask_feats, grid, centers, dyn, c: int, num_out: int) -> torch.Tensor:
    """K5f: (B, I, H, W, num_out) f32 logits."""
    lib, grid, centers, dyn = _kernel_args(mask_feats, grid, centers, dyn, c, num_out)
    is_bf16 = mask_feats.dtype == torch.bfloat16
    if is_bf16 and (mask_feats.data_ptr() % 4 or dyn.data_ptr() % 4):
        raise ValueError("the decode's bf16 kernel reads features and weights in pairs: pass them 4-byte aligned")
    b, _, h, w = mask_feats.shape
    i = dyn.shape[1]
    out = torch.empty((b, i, h, w, num_out), dtype=torch.float32, device=mask_feats.device)
    if out.numel():
        _, strips, group, groups = decode_plan(h * w, i, c, num_out, is_bf16)
        with torch.cuda.device(mask_feats.device):
            stream = torch.cuda.current_stream(mask_feats.device).cuda_stream
            err = lib.sihl_dynconv_fwd(
                int(is_bf16), c, mask_feats.data_ptr(), grid.data_ptr(), centers.data_ptr(), dyn.data_ptr(),
                b, h * w, i, num_out, strips, groups, group, out.data_ptr(), stream,
            )
        _check_launch(lib, err, "forward")
        dynamic_pointwise_decode.launches += 1
    return out


def dynamic_pointwise_decode_backward(
    mask_feats, grid, centers, dyn, gout, c: int, num_out: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5b: the gradients of the CUDA decode's inputs given the cotangent
    ``gout`` (B, I, H, W, num_out) of its logits.  Returns d(mask_feats)
    (B, c, H, W) in channels_last memory and d(dyn) (B, I, P), each in its
    input's dtype; deterministic (fixed-order sums, no atomics)."""
    lib, grid, centers, dyn = _kernel_args(mask_feats, grid, centers, dyn, c, num_out)
    b, _, h, w = mask_feats.shape
    i = dyn.shape[1]
    dmf = torch.empty((b, h, w, c), dtype=mask_feats.dtype, device=mask_feats.device)
    ddyn = torch.empty_like(dyn)
    if not (b and h * w and i):
        return dmf.zero_().permute(0, 3, 1, 2), ddyn.zero_()
    gout = gout.float().contiguous()
    workspace = torch.empty(
        lib.sihl_dynconv_bwd_workspace(c, b, h * w, i, num_out), dtype=torch.uint8, device=mask_feats.device
    )
    with torch.cuda.device(mask_feats.device):
        stream = torch.cuda.current_stream(mask_feats.device).cuda_stream
        err = lib.sihl_dynconv_bwd(
            _KERNEL_DTYPES[mask_feats.dtype], c, mask_feats.data_ptr(), grid.data_ptr(), centers.data_ptr(),
            dyn.data_ptr(), gout.data_ptr(), b, h * w, i, num_out, workspace.data_ptr(), dmf.data_ptr(),
            ddyn.data_ptr(), stream,
        )
    _check_launch(lib, err, "backward")
    dynamic_pointwise_decode_backward.launches += 1
    return dmf.permute(0, 3, 1, 2), ddyn


dynamic_pointwise_decode_backward.launches = 0  # kernel launches since the last reset


class _DynamicDecode(torch.autograd.Function):
    """K5f forward, K5b backward; no gradient for the grid and the centres."""

    @staticmethod
    def forward(ctx, mask_feats, grid, centers, dyn, c, num_out):
        ctx.save_for_backward(mask_feats, grid, centers, dyn)
        ctx.c, ctx.num_out = c, num_out
        return _forward_cuda(mask_feats, grid, centers, dyn, c, num_out)

    @staticmethod
    def backward(ctx, gout):
        mask_feats, grid, centers, dyn = ctx.saved_tensors
        dmf, ddyn = dynamic_pointwise_decode_backward(mask_feats, grid, centers, dyn, gout, ctx.c, ctx.num_out)
        return dmf, None, None, ddyn, None, None


def dynamic_pointwise_decode(mask_feats, grid, centers, dyn, c: int, num_out: int) -> torch.Tensor:
    """CondInst/FCPose decode: (B, c, H, W) features in channels_last memory,
    (H, W, 2) normalised grid, (B, I, 2) instance centres and (B, I, P)
    per-instance weights -> (B, I, H, W, num_out) f32 logits (f64 for f64
    inputs on the CPU), differentiable in the features and the weights."""
    b, ch, h, w = mask_feats.shape
    if ch != c or dyn.dim() != 3 or dyn.shape[0] != b or dyn.shape[2] != param_count(c, num_out):
        raise ValueError(
            f"features {tuple(mask_feats.shape)} and weights {tuple(dyn.shape)} do not fit c={c}, "
            f"num_out={num_out} (P = {param_count(c, num_out)})"
        )
    if tuple(grid.shape) != (h, w, 2) or tuple(centers.shape) != (b, dyn.shape[1], 2):
        raise ValueError(f"grid {tuple(grid.shape)} or centres {tuple(centers.shape)} do not fit")
    if not mask_feats.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the decode reads the features as (B, H, W, c): pass them in channels_last memory")
    devices = {t.device for t in (mask_feats, grid, centers, dyn)}
    if len(devices) != 1:
        raise ValueError(f"the decode's inputs must be on one device, got {devices}")
    if mask_feats.device.type == "cuda":
        return _DynamicDecode.apply(mask_feats, grid, centers, dyn, c, num_out)
    if mask_feats.device.type == "cpu":
        return reference_decode(mask_feats, grid, centers, dyn, c, num_out)
    raise ValueError(f"dynamic_pointwise_decode runs on CUDA or CPU tensors, got {mask_feats.device}")


dynamic_pointwise_decode.launches = 0  # kernel launches since the last reset
