"""Fused per-anchor MLPs, forward (counterpart of ``sihl_tpu/ops/pallas/mlp.py``).

:func:`fused_mlps` runs several :class:`~sihl_tpu_torch.layers.mlp.MLP`\\ s
over one shared (M, D) input.  A CUDA tensor goes to the hand-written
kernel ``csrc/fused_mlp.cu`` (one launch per MLP; the file says how it is
laid out and what bounds it); a CPU tensor goes to
:func:`fused_mlps_reference`, the plain module chain.  The backward kernel
is not ported yet, so the CUDA path refuses inputs that need a gradient.
"""

import ctypes
import functools
from typing import List, Sequence

import torch

from sihl_tpu_torch.ops.build import cuda_library

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_mlps_reference(x_2d: torch.Tensor, mlps: Sequence[torch.nn.Module]) -> List[torch.Tensor]:
    """Plain PyTorch version: the module chain of each MLP."""
    return [m(x_2d) for m in mlps]


def pack_mlp_params(mlp, dtype: torch.dtype):
    """(wh, bh, sc, bi, wo, bo) as the kernel reads them: hidden weights
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
    if torch.is_grad_enabled() and (
        x_2d.requires_grad or any(p.requires_grad for m in mlps for p in m.parameters())
    ):
        raise NotImplementedError(
            "the fused-MLP kernel has no backward yet (ROADMAP.md, K1b); "
            "run inference under torch.no_grad()"
        )
    return next(iter(dtypes))


def _fused_mlps_cuda(x_2d: torch.Tensor, mlps) -> List[torch.Tensor]:
    lib = _library()
    dtype = _check_supported(x_2d, mlps, lib.sihl_fused_mlp_width())
    x = x_2d.to(dtype).contiguous()
    if x.data_ptr() % 16:  # the kernel reads x in 16-byte vectors
        x = x.clone()
    m = x.shape[0]
    outs = []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for mlp in mlps:
            wh, bh, sc, bi, wo, bo = pack_mlp_params(mlp, dtype)
            out = torch.empty((m, wo.shape[1]), dtype=dtype, device=x.device)
            if m:
                err = lib.sihl_fused_mlp_fwd(
                    _KERNEL_DTYPES[dtype], x.data_ptr(), m, wh.data_ptr(), bh.data_ptr(),
                    sc.data_ptr(), bi.data_ptr(), wh.shape[0], wo.data_ptr(), bo.data_ptr(),
                    wo.shape[1], out.data_ptr(), stream,
                )
                if err:
                    raise RuntimeError(
                        f"fused-MLP kernel launch failed: {lib.sihl_cuda_error_string(err).decode()}"
                    )
                fused_mlps.launches += 1
            outs.append(out)
    return outs


def fused_mlps(x_2d: torch.Tensor, mlps: Sequence[torch.nn.Module]) -> List[torch.Tensor]:
    """Run several MLPs over one shared (M, D) input; one (M, out_i) tensor
    per MLP, in the MLPs' compute dtype."""
    if x_2d.device.type == "cuda":
        return _fused_mlps_cuda(x_2d, mlps)
    if x_2d.device.type == "cpu":
        return fused_mlps_reference(x_2d, mlps)
    raise ValueError(f"fused_mlps runs on CUDA or CPU tensors, got {x_2d.device}")


fused_mlps.launches = 0  # kernel launches since the last reset
