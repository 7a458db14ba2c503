"""The fused-MLP forward in five modes, each a restructuring of K1f: the
port of the JAX package's fused-MLP pipeline probe
(``tools/probe_mlp_pipeline.py``), which times stripped and reordered
variants of the forward kernel to say where its time goes.

:func:`mlp_pipeline` runs MLPs of L x [Linear 256 -> 256 -> LayerNorm ->
SiLU] and an output Linear over one shared x (M, 256) bf16, with no stash
for a backward, and returns one (M, n_out) bf16 output per MLP.  The modes:

- ``"base"``: K1f itself (``ops/fused_mlp.py``, ``csrc/fused_mlp.cu``);
- ``"nops"``: h = bf16(y), the bias alone, no LayerNorm or SiLU (the
  products' floor; a different function, so it is checked only against its
  own plain version);
- ``"mxured"``: LayerNorm's row sum and sum of squares as products with a
  ones column, whose operands bf16(y) and bf16(y * y) a bf16 matrix unit
  takes, then the one-pass variance E[y^2] - mean^2;
- ``"pingpong"``: the same function as ``"base"``, with a block's two
  warpgroups taking the tensor cores in turn;
- ``"pp+mxured"``: both, the same function as ``"mxured"``.

A CUDA tensor goes to K1f for ``"base"`` (counted by
``fused_mlp.fused_mlps.launches``) and to the kernels of
``csrc/mlp_pipeline.cu`` for the other modes (counted by
``mlp_pipeline.launches``; the file says how they are laid out); a CPU
tensor goes to :func:`mlp_pipeline_reference`.  No model path calls it:
``sihl_tpu_torch.tools.probe_mlp_pipeline`` and ``chip_smoke.py`` do.
"""

import ctypes
import functools
from typing import List, Sequence

import numpy as np
import torch

from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops import fused_mlp
from sihl_tpu_torch.ops.build import cuda_library
from sihl_tpu_torch.policy import compute_dtype_scope

MODES = ("base", "nops", "mxured", "pingpong", "pp+mxured")
# the JAX probe's shapes: the flagship's dense loc and iou MLPs over 16
# images x 8,525 anchors at 640 px
ROWS, WIDTH, LAYERS, HEADS = 136_400, 256, 4, 2
LN_EPS = 1e-5


def probe_params(seed: int = 0, m: int = ROWS):
    """The JAX probe's parameters and input, drawn in its order from
    ``np.random.RandomState(seed)`` (``make_params``, then ``main``'s x):
    per MLP (wh (L, D, D) as [in][out], bh, sc, bi (L, D), wo (D, 1), bo
    (1, 1)), and x (m, D).  f32 arrays; wh, wo and x hold bf16 values, as
    the probe rounds them (f64 to bf16, the same bits by either route)."""
    rng = np.random.RandomState(seed)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    heads = []
    for _ in range(HEADS):
        wh = bf16(rng.randn(LAYERS, WIDTH, WIDTH) * 0.05)
        bh = (rng.randn(LAYERS, WIDTH) * 0.05).astype(np.float32)
        sc = (1.0 + rng.randn(LAYERS, WIDTH) * 0.05).astype(np.float32)
        bi = (rng.randn(LAYERS, WIDTH) * 0.05).astype(np.float32)
        wo = bf16(rng.randn(WIDTH, 1) * 0.05)
        bo = (rng.randn(1, 1) * 0.05).astype(np.float32)
        heads.append((wh, bh, sc, bi, wo, bo))
    return heads, bf16(rng.randn(m, WIDTH) * 0.5)


def mlps_from_probe_params(heads, device=None) -> List[MLP]:
    """The probe's per-MLP arrays (numpy, f32 or bf16) as bf16 port MLPs:
    hidden Linear l's weight wh[l]^T and bias bh[l], LayerNorm l's scale
    sc[l] and shift bi[l], the output Linear's weight wo^T and bias bo[0].
    Every value is held exactly in the f32 parameter."""
    mlps = []
    for wh, bh, sc, bi, wo, bo in heads:
        wh, bh, sc, bi, wo, bo = (torch.from_numpy(np.array(a, np.float32)) for a in (wh, bh, sc, bi, wo, bo))
        num_layers, d, _ = wh.shape
        with compute_dtype_scope(torch.bfloat16):
            mlp = MLP(d, [d] * num_layers + [wo.shape[1]], device=device)
        with torch.no_grad():
            for l in range(num_layers):
                mlp.linears[l].weight.copy_(wh[l].T)
                mlp.linears[l].bias.copy_(bh[l])
                mlp.norms[l].weight.copy_(sc[l])
                mlp.norms[l].bias.copy_(bi[l])
            mlp.linears[-1].weight.copy_(wo.T)
            mlp.linears[-1].bias.copy_(bo[0])
        mlps.append(mlp)
    return mlps


def _ln_silu(y: torch.Tensor, sc: torch.Tensor, bi: torch.Tensor, one_pass: bool) -> torch.Tensor:
    """LayerNorm (eps 1e-5) and SiLU of f32 y, as the probe's ``_ln_silu``
    (two-pass variance) or ``_ln_silu_mxu`` (one pass, E[y^2] - mean^2,
    unclipped): z = n sc + bi rounded to bf16, SiLU in f32 on that z,
    rounded to bf16.  The one-pass sums are f32 sums of bf16(y) and
    bf16(y * y), the operands a bf16 matrix unit takes for the products
    with the ones column (the mxured kernels' row sums)."""
    if one_pass:
        mu = y.bfloat16().float().sum(-1, keepdim=True) * (1.0 / y.shape[-1])
        var = (y * y).bfloat16().float().sum(-1, keepdim=True) * (1.0 / y.shape[-1]) - mu * mu
    else:
        mu = y.mean(-1, keepdim=True)
        var = ((y - mu) ** 2).mean(-1, keepdim=True)
    z = ((y - mu) * torch.rsqrt(var + LN_EPS) * sc + bi).bfloat16().float()
    return (z * torch.sigmoid(z)).bfloat16()


@torch.no_grad()
def mlp_pipeline_reference(x: torch.Tensor, mlps: Sequence[MLP], mode: str) -> List[torch.Tensor]:
    """Plain PyTorch version of each mode's function, with the probe
    kernel's roundings (not the module chain's, which rounds y and the
    biases to bf16): h is bf16 between layers; y = h W^T in f32 plus the
    f32 bias; the output h wo^T + bo in f32, rounded once to bf16.
    ``"base"`` and ``"pingpong"`` are one function, as are ``"mxured"``
    and ``"pp+mxured"``."""
    if mode not in MODES:
        raise ValueError(f"mlp_pipeline's mode is one of {MODES}, got {mode!r}")
    outs = []
    for mlp in mlps:
        linears = list(mlp.linears)
        h = x.bfloat16()
        for l, norm in enumerate(mlp.norms):
            y = h.float() @ linears[l].weight.bfloat16().float().T + linears[l].bias.float()
            if mode == "nops":
                h = y.bfloat16()
            else:
                h = _ln_silu(y, norm.weight.float(), norm.bias.float(), one_pass="mxured" in mode)
        out = h.float() @ linears[-1].weight.bfloat16().float().T + linears[-1].bias.float()
        outs.append(out.bfloat16())
    return outs


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_library("mlp_pipeline")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sihl_mlp_pipeline_fwd.argtypes = [i, p, i, i, i, p, p, p]
    lib.sihl_mlp_pipeline_fwd.restype = i
    lib.sihl_cuda_error_string.argtypes = [i]
    lib.sihl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _mlp_pipeline_cuda(x: torch.Tensor, mlps: Sequence[MLP], mode: str) -> List[torch.Tensor]:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the mlp_pipeline kernels take a bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the mlp_pipeline kernels take a contiguous x")
    if x.data_ptr() % 16:
        raise ValueError("the mlp_pipeline kernels read x in 16-byte vectors: x must start 16-byte aligned")
    if fused_mlp._check_supported(x, mlps, WIDTH) != torch.bfloat16:
        raise ValueError("the mlp_pipeline kernels take bf16 MLPs")
    packs = [fused_mlp.pack_mlp_params(mlp, torch.bfloat16) for mlp in mlps]
    if mode == "base":
        return fused_mlp._forward_cuda(x, packs)
    lib = _library()
    m = x.shape[0]
    outs = [torch.empty((m, pk.n_out), dtype=x.dtype, device=x.device) for pk in packs]
    if m:
        ptrs, n_outs = fused_mlp._pointer_table(packs, outs, None)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.sihl_mlp_pipeline_fwd(MODES.index(mode), x.data_ptr(), m, packs[0].num_layers, len(packs),
                                            ptrs, n_outs, stream)
        if err:
            raise RuntimeError(f"mlp_pipeline {mode} kernel launch failed: {lib.sihl_cuda_error_string(err).decode()}")
        mlp_pipeline.launches += 1
    return outs


@torch.no_grad()
def mlp_pipeline(x: torch.Tensor, mlps: Sequence[MLP], mode: str) -> List[torch.Tensor]:
    """Mode ``mode`` of the fused-MLP forward of bf16 ``mlps`` over x (M,
    256): one (M, n_out) bf16 output per MLP.  No gradient flows through
    it."""
    if mode not in MODES:
        raise ValueError(f"mlp_pipeline's mode is one of {MODES}, got {mode!r}")
    if x.device.type == "cuda":
        return _mlp_pipeline_cuda(x, mlps, mode)
    if x.device.type == "cpu":
        return mlp_pipeline_reference(x, mlps, mode)
    raise ValueError(f"mlp_pipeline runs on CUDA or CPU tensors, got {x.device}")


mlp_pipeline.launches = 0  # launches of the csrc/mlp_pipeline.cu kernels since the last reset
