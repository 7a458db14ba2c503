"""Fused per-anchor MLPs, forward and backward (counterpart of
``sihl_tpu/ops/pallas/mlp.py``).

:func:`fused_mlps` runs several :class:`~sihl_tpu_torch.layers.mlp.MLP`\\ s
over one shared (M, D) input.  A CUDA tensor goes to the hand-written
kernels of ``csrc/fused_mlp.cu`` (the file says how they are laid out and
what bounds them) through :class:`_FusedMLPs`: K1f in the forward, one launch
per MLP, and K1b (:func:`fused_mlps_backward`) in the backward.  The
parameters are packed inside the autograd graph, so the gradients reach each
Linear and LayerNorm through the stack, transpose and cast.  A CPU tensor
goes to :func:`fused_mlps_reference`, the plain module chain, whose backward
is autograd's.
"""

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from sihl_tpu_torch.ops.build import cuda_library

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PARAMS_PER_MLP = 6


def fused_mlps_reference(x_2d: torch.Tensor, mlps: Sequence[torch.nn.Module]) -> List[torch.Tensor]:
    """Plain PyTorch version: the module chain of each MLP."""
    return [m(x_2d) for m in mlps]


def pack_mlp_params(mlp, dtype: torch.dtype):
    """(wh, bh, sc, bi, wo, bo) as the kernels read them: hidden weights
    (L, D, D) and the output weight (D, n_out) as [in][out] in ``dtype``;
    biases and LayerNorm parameters in f32."""
    linears = list(mlp.linears)
    wh = torch.stack([lin.weight.t() for lin in linears[:-1]]).to(dtype).contiguous()
    bh = torch.stack([lin.bias for lin in linears[:-1]]).float().contiguous()
    sc = torch.stack([n.weight for n in mlp.norms]).float().contiguous()
    bi = torch.stack([n.bias for n in mlp.norms]).float().contiguous()
    wo = linears[-1].weight.t().to(dtype).contiguous()
    bo = linears[-1].bias.float().contiguous()
    return wh, bh, sc, bi, wo, bo


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_library("fused_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sihl_fused_mlp_fwd.argtypes = [i, p, i, p, p, p, p, i, p, p, i, p, p]
    lib.sihl_fused_mlp_fwd.restype = i
    lib.sihl_fused_mlp_bwd_workspace.argtypes = [i, i, i, i]
    lib.sihl_fused_mlp_bwd_workspace.restype = ctypes.c_size_t
    lib.sihl_fused_mlp_bwd.argtypes = [i, p, i, p, p, p, p, p, i, p, i, p, p, p, p, p, p, p, p, p, p]
    lib.sihl_fused_mlp_bwd.restype = i
    lib.sihl_fused_mlp_width.argtypes = []
    lib.sihl_fused_mlp_width.restype = i
    lib.sihl_cuda_error_string.argtypes = [i]
    lib.sihl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_supported(x_2d: torch.Tensor, mlps, width: int) -> torch.dtype:
    if x_2d.dim() != 2 or x_2d.shape[1] != width:
        raise ValueError(f"the fused-MLP kernel takes (M, {width}) inputs, got {tuple(x_2d.shape)}")
    dtypes = {m.dtype for m in mlps}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _KERNEL_DTYPES:
        raise ValueError(f"the fused-MLP kernel takes MLPs of one dtype in {list(_KERNEL_DTYPES)}, got {dtypes}")
    for m in mlps:
        linears = list(m.linears)
        if len(linears) < 2 or len(m.norms) != len(linears) - 1:
            raise ValueError("the fused-MLP kernel needs >= 1 hidden Linear-LayerNorm-SiLU layer")
        for lin in linears[:-1]:
            if tuple(lin.weight.shape) != (width, width):
                raise ValueError(f"hidden layers must be {width} wide, got {tuple(lin.weight.shape)}")
        if any(p.device != x_2d.device for p in m.parameters()):
            raise ValueError("MLP parameters and input must be on one device")
    return next(iter(dtypes))


def _check_launch(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"fused-MLP {what} kernel launch failed: {lib.sihl_cuda_error_string(err).decode()}")


def _forward_cuda(x: torch.Tensor, heads) -> List[torch.Tensor]:
    """K1f: one launch per MLP of packed parameters ``heads``."""
    lib = _library()
    m = x.shape[0]
    outs = []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for wh, bh, sc, bi, wo, bo in heads:
            out = torch.empty((m, wo.shape[1]), dtype=x.dtype, device=x.device)
            if m:
                err = lib.sihl_fused_mlp_fwd(
                    _KERNEL_DTYPES[x.dtype], x.data_ptr(), m, wh.data_ptr(), bh.data_ptr(),
                    sc.data_ptr(), bi.data_ptr(), wh.shape[0], wo.data_ptr(), bo.data_ptr(),
                    wo.shape[1], out.data_ptr(), stream,
                )
                _check_launch(lib, err, "forward")
                fused_mlps.launches += 1
            outs.append(out)
    return outs


def fused_mlps_backward(x: torch.Tensor, heads, gs) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K1b: the backward of the MLPs of packed parameters ``heads`` over the
    CUDA input ``x`` (M, D), given each output's cotangent ``gs`` in the
    compute dtype.  Returns dx (M, D) in the compute dtype, summed over the
    MLPs, and the gradient of every packed parameter, cast to its dtype (as
    ``_fused_bwd`` casts them)."""
    lib = _library()
    m, d = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    is_bf16 = _KERNEL_DTYPES[x.dtype]
    dx = torch.empty_like(x)
    grads = []
    if m == 0:
        for head in heads:
            grads += [torch.zeros_like(p) for p in head]
        return dx, grads
    workspace = torch.empty(
        max(lib.sihl_fused_mlp_bwd_workspace(is_bf16, m, wh.shape[0], wo.shape[1])
            for wh, _, _, _, wo, _ in heads),
        dtype=torch.uint8, device=x.device,
    )
    dx_acc = torch.empty((m, d), **f32) if len(heads) > 1 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for idx, ((wh, bh, sc, bi, wo, bo), g) in enumerate(zip(heads, gs)):
            num_layers, n_out = wh.shape[0], wo.shape[1]
            wht = wh.transpose(1, 2).contiguous()
            dwh = torch.empty((num_layers, d, d), **f32)
            dcols = torch.empty((num_layers, 3, d), **f32)  # LN scale, LN shift, hidden bias
            dwo = torch.empty((d, n_out), **f32)
            dbo = torch.empty((n_out,), **f32)
            first, last = idx == 0, idx == len(heads) - 1
            err = lib.sihl_fused_mlp_bwd(
                is_bf16, x.data_ptr(), m, wh.data_ptr(), wht.data_ptr(), bh.data_ptr(),
                sc.data_ptr(), bi.data_ptr(), num_layers, wo.data_ptr(), n_out, g.data_ptr(),
                workspace.data_ptr(), dwh.data_ptr(), dcols.data_ptr(), dwo.data_ptr(),
                dbo.data_ptr(), None if first else dx_acc.data_ptr(),
                None if last else dx_acc.data_ptr(), dx.data_ptr() if last else None, stream,
            )
            _check_launch(lib, err, "backward")
            fused_mlps_backward.launches += 1
            grads += [dwh.to(wh.dtype), dcols[:, 2], dcols[:, 0], dcols[:, 1], dwo.to(wo.dtype), dbo]
    return dx, grads


fused_mlps_backward.launches = 0  # kernel launches since the last reset


class _FusedMLPs(torch.autograd.Function):
    """K1f forward, K1b backward, over the packed parameters of every MLP."""

    @staticmethod
    def forward(ctx, x, *flat):
        heads = [flat[i : i + _PARAMS_PER_MLP] for i in range(0, len(flat), _PARAMS_PER_MLP)]
        ctx.save_for_backward(x, *flat)
        return tuple(_forward_cuda(x, heads))

    @staticmethod
    def backward(ctx, *gs):
        x, *flat = ctx.saved_tensors
        heads = [flat[i : i + _PARAMS_PER_MLP] for i in range(0, len(flat), _PARAMS_PER_MLP)]
        gs = [
            torch.zeros((x.shape[0], head[4].shape[1]), dtype=x.dtype, device=x.device)
            if g is None else g.to(x.dtype).contiguous()
            for g, head in zip(gs, heads)
        ]
        dx, grads = fused_mlps_backward(x, heads, gs)
        return (dx, *grads)


def _fused_mlps_cuda(x_2d: torch.Tensor, mlps) -> List[torch.Tensor]:
    dtype = _check_supported(x_2d, mlps, _library().sihl_fused_mlp_width())
    x = x_2d.to(dtype).contiguous()
    if x.data_ptr() % 16:  # the kernels read x in 16-byte vectors
        x = x.clone()
    flat = [t for mlp in mlps for t in pack_mlp_params(mlp, dtype)]
    return list(_FusedMLPs.apply(x, *flat))


def fused_mlps(x_2d: torch.Tensor, mlps: Sequence[torch.nn.Module]) -> List[torch.Tensor]:
    """Run several MLPs over one shared (M, D) input; one (M, out_i) tensor
    per MLP, in the MLPs' compute dtype, differentiable in the input and in
    every parameter."""
    if x_2d.device.type == "cuda":
        return _fused_mlps_cuda(x_2d, mlps)
    if x_2d.device.type == "cpu":
        return fused_mlps_reference(x_2d, mlps)
    raise ValueError(f"fused_mlps runs on CUDA or CPU tensors, got {x_2d.device}")


fused_mlps.launches = 0  # kernel launches since the last reset
