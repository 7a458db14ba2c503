"""Fused per-anchor MLPs, forward and backward (counterpart of
``sihl_tpu/ops/pallas/mlp.py``).

:func:`fused_mlps` runs several :class:`~sihl_tpu_torch.layers.mlp.MLP`\\ s
over one shared (M, D) input.  A CUDA tensor goes to the hand-written
kernels of ``csrc/fused_mlp.cu`` (the file says how they are laid out and
what bounds them) through :class:`_FusedMLPs`: K1f in the forward and K1b
(:func:`fused_mlps_backward`) in the backward.  A CPU tensor goes to
:func:`fused_mlps_reference`, the plain module chain, whose backward is
autograd's.

One launch covers every MLP of a call: ``fused_mlps.launches`` counts K1f
launches, one per forward call, and ``fused_mlps_backward.launches`` counts
K1b launches, one per backward call (its tile kernel over every MLP, then
the dW GEMM and the fixed-order reductions that finish it).

The kernels read each MLP's parameters as :func:`pack_mlp_params` lays them
out: in bf16, the hidden weights as one swizzled image that the kernels'
bulk copies move as it is (:func:`pack_hidden_image`), followed, for an
output layer wider than 256 (the keypoint head's 2,737 dynamic weights),
by the output weight in blocks of 256 outputs laid out as further layers
(:func:`pack_output_image`), which the kernels multiply on the tensor cores;
an output layer of at most 256 runs from registers.  A pack is cached per
MLP and rebuilt only when a parameter changes (its ``_version`` or
``data_ptr``), so a warm request packs nothing and a training step packs
once.  A CUDA graph's replay updates parameters without moving their
``_version``: a call made while a stream is being captured packs inside
the graph and caches nothing, and the trainer empties the cache after each
scanned dispatch (:func:`invalidate_packs`).  The autograd Function takes the MLPs' own parameters as inputs, packs
them outside the graph, and returns each parameter's gradient in its own
layout and dtype, the weights' gradients rounded to the compute dtype first
(``_fused_bwd`` of ``sihl_tpu/ops/pallas/mlp.py`` returns its compute-dtype
weights' gradients so).  A bf16 forward that a backward will follow also
writes the :class:`Stash` (x and every hidden output as tile images) that
K1b reads in place of recomputing the forward.
"""

import ctypes
import functools
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from sihl_tpu_torch.ops.build import cuda_library

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 64  # columns of one K-chunk of the packed image: 128 bytes of bf16
# as csrc/fused_mlp.cu is compiled: MLPs of one call, the widest output layer
# of the register path, the outputs of a wide output layer's block
_MAX_MLPS, _NARROW_OUT, _OUT_BLOCK = 4, 256, 256


def fused_mlps_reference(x_2d: torch.Tensor, mlps: Sequence[torch.nn.Module]) -> List[torch.Tensor]:
    """Plain PyTorch version: the module chain of each MLP."""
    return [m(x_2d) for m in mlps]


def pack_hidden_image(weights: torch.Tensor) -> torch.Tensor:
    """The hidden weights (L, D, D) in the Linear layout (out, in), as the
    flat image the bf16 kernels copy into shared memory: for each layer l and
    K-chunk kc (columns 64 kc .. 64 kc + 63), 256 rows n of 128 bytes, whose
    16-byte unit u (columns 64 kc + 8 u .. + 7) sits at unit u ^ (n % 8) (the
    128-byte swizzle that wgmma's descriptors read)."""
    num_layers, d, _ = weights.shape
    w = weights.reshape(num_layers, d, d // _CHUNK, 8, 8).permute(0, 2, 1, 3, 4)  # l, kc, n, u, e
    n = torch.arange(d, device=weights.device)
    unit = torch.arange(8, device=weights.device)[None, :] ^ (n[:, None] % 8)  # (n, position) -> unit
    index = unit[None, None, :, :, None].expand(num_layers, d // _CHUNK, d, 8, 8)
    return torch.gather(w, 3, index).contiguous().reshape(-1)


def pack_output_image(weight: torch.Tensor) -> torch.Tensor:
    """A wide output Linear's weight (n_out, D), n_out > 256, as the image
    its kernels stream after the hidden layers': zero rows up to whole blocks
    of 256 outputs, each block laid out as a hidden layer
    (:func:`pack_hidden_image`)."""
    n_out, d = weight.shape
    blocks = -(-n_out // _OUT_BLOCK)
    padded = torch.zeros((blocks * _OUT_BLOCK, d), dtype=weight.dtype, device=weight.device)
    padded[:n_out] = weight
    return pack_hidden_image(padded.reshape(blocks, _OUT_BLOCK, d))


class MLPPack(NamedTuple):
    """One MLP's parameters as the kernels read them.  bf16: ``w`` is the
    weight image (the hidden layers', then a wide output layer's blocks) and
    ``wt`` None; f32: ``w`` is (L, D, D) as [in][out] and ``wt`` as
    [out][in].  ``bh``, ``sc``, ``bi`` (L, D) and ``bo`` (n_out)
    are f32; ``wo`` is (n_out, D) in the compute dtype."""

    w: torch.Tensor
    wt: Optional[torch.Tensor]
    bh: torch.Tensor
    sc: torch.Tensor
    bi: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor

    @property
    def num_layers(self) -> int:
        return self.bh.shape[0]

    @property
    def n_out(self) -> int:
        return self.wo.shape[0]


def mlp_parameters(mlp) -> List[torch.Tensor]:
    """The MLP's parameters in the order the Function takes them: the hidden
    Linears' weights, their biases, the LayerNorms' scales and shifts, then
    the output Linear's weight and bias."""
    linears = list(mlp.linears)
    return ([lin.weight for lin in linears[:-1]] + [lin.bias for lin in linears[:-1]]
            + [n.weight for n in mlp.norms] + [n.bias for n in mlp.norms]
            + [linears[-1].weight, linears[-1].bias])


_PACKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def invalidate_packs() -> None:
    """Forget every cached pack: the next call of each MLP packs anew.  For
    writes into the parameters that leave ``_version`` where it was (a CUDA
    graph's replay)."""
    _PACKS.clear()


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def pack_mlp_params(mlp, dtype: torch.dtype) -> MLPPack:
    """The MLP's :class:`MLPPack` in ``dtype``, cached until a parameter
    changes: the cache key is every parameter's ``data_ptr`` and
    ``_version``, which an in-place update (an optimizer step) bumps.  While
    the stream is being captured into a CUDA graph the pack is built in the
    graph, from the parameters as each replay finds them, and not cached."""
    params = mlp_parameters(mlp)
    capturing = _capturing(params[0])
    key = (dtype, tuple((p.data_ptr(), p._version) for p in params))
    cached = _PACKS.get(mlp)
    if cached is not None and cached[0] == key and not capturing:
        return cached[1]
    linears = list(mlp.linears)
    with torch.no_grad():
        wt = torch.stack([lin.weight for lin in linears[:-1]]).to(dtype)
        if dtype == torch.bfloat16:
            w, wt = pack_hidden_image(wt), None
            if linears[-1].weight.shape[0] > _NARROW_OUT:
                w = torch.cat([w, pack_output_image(linears[-1].weight.to(dtype))])
        else:
            w, wt = wt.transpose(1, 2).contiguous(), wt.contiguous()
        pack = MLPPack(
            w=w,
            wt=wt,
            bh=torch.stack([lin.bias for lin in linears[:-1]]).float().contiguous(),
            sc=torch.stack([n.weight for n in mlp.norms]).float().contiguous(),
            bi=torch.stack([n.bias for n in mlp.norms]).float().contiguous(),
            wo=linears[-1].weight.to(dtype).contiguous(),
            bo=linears[-1].bias.float().contiguous(),
        )
    if not capturing:
        _PACKS[mlp] = (key, pack)
    return pack


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_library("fused_mlp")
    p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    for name in ("sihl_fused_mlp_width", "sihl_fused_mlp_max_mlps", "sihl_fused_mlp_narrow_out",
                 "sihl_fused_mlp_out_block"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.sihl_fused_mlp_fwd.argtypes = [i, p, p, i, i, i, p, p, p]
    lib.sihl_fused_mlp_fwd.restype = i
    lib.sihl_fused_mlp_tile_bytes.argtypes = [i]
    lib.sihl_fused_mlp_tile_bytes.restype = size
    lib.sihl_fused_mlp_bwd_workspace.argtypes = [i, i, i, i, p]
    lib.sihl_fused_mlp_bwd_workspace.restype = size
    lib.sihl_fused_mlp_bwd.argtypes = [i, p, p, i, i, i, p, p, p, p, p, p, p, p]
    lib.sihl_fused_mlp_bwd.restype = i
    lib.sihl_fused_mlp_dw_alone_workspace.argtypes = [i]
    lib.sihl_fused_mlp_dw_alone_workspace.restype = size
    lib.sihl_fused_mlp_dw_alone.argtypes = [p, p, i, p, p, p]
    lib.sihl_fused_mlp_dw_alone.restype = i
    lib.sihl_cuda_error_string.argtypes = [i]
    lib.sihl_cuda_error_string.restype = ctypes.c_char_p
    compiled = (lib.sihl_fused_mlp_max_mlps(), lib.sihl_fused_mlp_narrow_out(), lib.sihl_fused_mlp_out_block())
    if compiled != (_MAX_MLPS, _NARROW_OUT, _OUT_BLOCK):
        raise RuntimeError("csrc/fused_mlp.cu and ops/fused_mlp.py disagree on the call limits")
    return lib


def _check_supported(x_2d: torch.Tensor, mlps, width: int) -> torch.dtype:
    if x_2d.dim() != 2 or x_2d.shape[1] != width:
        raise ValueError(f"the fused-MLP kernel takes (M, {width}) inputs, got {tuple(x_2d.shape)}")
    if not 1 <= len(mlps) <= _MAX_MLPS:
        raise ValueError(f"the fused-MLP kernel takes 1 to {_MAX_MLPS} MLPs, got {len(mlps)}")
    dtypes = {m.dtype for m in mlps}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _KERNEL_DTYPES:
        raise ValueError(f"the fused-MLP kernel takes MLPs of one dtype in {list(_KERNEL_DTYPES)}, got {dtypes}")
    if len({len(m.linears) for m in mlps}) != 1:
        raise ValueError("the fused-MLP kernel takes MLPs of one depth")
    for m in mlps:
        linears = list(m.linears)
        if len(linears) < 2 or len(m.norms) != len(linears) - 1:
            raise ValueError("the fused-MLP kernel needs >= 1 hidden Linear-LayerNorm-SiLU layer")
        for lin in linears[:-1]:
            if tuple(lin.weight.shape) != (width, width):
                raise ValueError(f"hidden layers must be {width} wide, got {tuple(lin.weight.shape)}")
        if linears[-1].weight.shape[0] < 1:
            raise ValueError("the output layer must have at least 1 output")
        if any(p.device != x_2d.device for p in m.parameters()):
            raise ValueError("MLP parameters and input must be on one device")
    return next(iter(dtypes))


def _check_launch(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"fused-MLP {what} kernel launch failed: {lib.sihl_cuda_error_string(err).decode()}")


class Stash(NamedTuple):
    """What the bf16 training forward keeps for the backward, as 64-row tile
    images: x, and each MLP's hidden outputs h_0 .. h_{L-1}."""

    x: torch.Tensor
    h: List[torch.Tensor]


def stash_for(x: torch.Tensor, packs: Sequence[MLPPack]) -> Optional[Stash]:
    """Room for the stash of a bf16 forward over ``x`` (None in f32, whose
    backward recomputes its own)."""
    if x.dtype != torch.bfloat16:
        return None
    per_layer = _library().sihl_fused_mlp_tile_bytes(x.shape[0])
    room = dict(dtype=torch.uint8, device=x.device)
    return Stash(torch.empty(per_layer, **room), [torch.empty(pk.num_layers * per_layer, **room) for pk in packs])


def _pointer_table(packs: Sequence[MLPPack], ios: Sequence[torch.Tensor], stash: Optional[Stash]):
    """Per MLP the addresses (w, wt, bh, sc, bi, wo, bo, io, h), and the output widths."""
    values = []
    for i, (pk, io) in enumerate(zip(packs, ios)):
        values += [pk.w.data_ptr(), pk.wt.data_ptr() if pk.wt is not None else 0, pk.bh.data_ptr(),
                   pk.sc.data_ptr(), pk.bi.data_ptr(), pk.wo.data_ptr(), pk.bo.data_ptr(), io.data_ptr(),
                   stash.h[i].data_ptr() if stash is not None else 0]
    ptrs = (ctypes.c_longlong * len(values))(*values)
    n_outs = (ctypes.c_int * len(packs))(*[pk.n_out for pk in packs])
    return ptrs, n_outs


def _forward_cuda(x: torch.Tensor, packs: Sequence[MLPPack], stash: Optional[Stash] = None) -> List[torch.Tensor]:
    """K1f: one launch over every MLP of packed parameters ``packs``; in a
    bf16 training forward it also fills ``stash`` for the backward."""
    lib = _library()
    m = x.shape[0]
    outs = [torch.empty((m, pk.n_out), dtype=x.dtype, device=x.device) for pk in packs]
    if m:
        ptrs, n_outs = _pointer_table(packs, outs, stash)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.sihl_fused_mlp_fwd(_KERNEL_DTYPES[x.dtype], x.data_ptr(),
                                         stash.x.data_ptr() if stash is not None else None, m,
                                         packs[0].num_layers, len(packs), ptrs, n_outs, stream)
        _check_launch(lib, err, "forward")
        fused_mlps.launches += 1
    return outs


def fused_mlps_backward(x: torch.Tensor, packs: Sequence[MLPPack], gs,
                        stash: Optional[Stash] = None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K1b: the backward of the MLPs of packed parameters ``packs`` over the
    CUDA input ``x`` (M, D), given each output's cotangent ``gs`` (M, n_out)
    in the compute dtype and, in bf16, the ``stash`` their forward filled.
    Returns dx (M, D) in the compute dtype, summed over the MLPs, and per MLP
    the f32 gradients (dwh (L, D, D) in the Linear layout, dbh, dsc, dbi
    (L, D), dwo (n_out, D), dbo (n_out)), any n_out."""
    lib = _library()
    m, d = x.shape
    num_layers, num = packs[0].num_layers, len(packs)
    if x.dtype == torch.bfloat16 and m and stash is None:
        raise ValueError("the bf16 fused-MLP backward needs the stash of its forward")
    f32 = dict(dtype=torch.float32, device=x.device)
    if m == 0:
        grads = []
        for pk in packs:
            grads += [torch.zeros((num_layers, d, d), **f32), torch.zeros((num_layers, d), **f32),
                      torch.zeros((num_layers, d), **f32), torch.zeros((num_layers, d), **f32),
                      torch.zeros((pk.n_out, d), **f32), torch.zeros((pk.n_out,), **f32)]
        return torch.empty_like(x), grads
    is_bf16 = _KERNEL_DTYPES[x.dtype]
    gs = [g.to(x.dtype).contiguous() for g in gs]
    ptrs, n_outs = _pointer_table(packs, gs, stash)
    workspace = torch.empty(lib.sihl_fused_mlp_bwd_workspace(is_bf16, m, num_layers, num, n_outs),
                            dtype=torch.uint8, device=x.device)
    # per MLP in order: L x D hidden weights' rows, then n_out output rows
    dw = torch.empty((sum(num_layers * d + pk.n_out for pk in packs), d), **f32)
    dcols = torch.empty((num, num_layers, 3, d), **f32)  # LN scale, LN shift, hidden bias
    dbo = torch.empty((num, max(pk.n_out for pk in packs)), **f32)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sihl_fused_mlp_bwd(is_bf16, x.data_ptr(), stash.x.data_ptr() if stash is not None else None,
                                     m, num_layers, num, ptrs, n_outs,
                                     workspace.data_ptr(), dw.data_ptr(), dcols.data_ptr(), dbo.data_ptr(),
                                     dx.data_ptr(), stream)
    _check_launch(lib, err, "backward")
    fused_mlps_backward.launches += 1
    grads, row0 = [], 0
    for i, pk in enumerate(packs):
        hidden = row0 + num_layers * d
        grads += [dw[row0:hidden].view(num_layers, d, d), dcols[i, :, 2], dcols[i, :, 0], dcols[i, :, 1],
                  dw[hidden : hidden + pk.n_out], dbo[i, : pk.n_out]]
        row0 = hidden + pk.n_out
    return dx, grads


fused_mlps_backward.launches = 0  # kernel launches since the last reset


def dw_gemm_alone(h: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The bf16 backward's dW GEMM on its own, for tests: dy^T h (D, D) in
    f32 for CUDA bf16 (M, D) inputs, through the same tile images, kernel
    and fixed-order reduction as :func:`fused_mlps_backward`."""
    lib = _library()
    m, d = h.shape
    h, dy = h.contiguous(), dy.contiguous()
    out = torch.empty((d, d), dtype=torch.float32, device=h.device)
    workspace = torch.empty(lib.sihl_fused_mlp_dw_alone_workspace(m), dtype=torch.uint8, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.sihl_fused_mlp_dw_alone(h.data_ptr(), dy.data_ptr(), m, workspace.data_ptr(), out.data_ptr(), stream)
    _check_launch(lib, err, "dW")
    return out


class _FusedMLPs(torch.autograd.Function):
    """K1f forward, K1b backward.  Inputs: x, the MLPs, the compute dtype,
    whether a backward will follow, then every MLP's :func:`mlp_parameters`."""

    @staticmethod
    def forward(ctx, x, mlps, dtype, training, *params):
        packs = [pack_mlp_params(mlp, dtype) for mlp in mlps]
        ctx.packs = packs
        ctx.stash = stash_for(x, packs) if training else None
        ctx.save_for_backward(x, *params)
        return tuple(_forward_cuda(x, packs, ctx.stash))

    @staticmethod
    def backward(ctx, *gs):
        x, *params = ctx.saved_tensors
        packs = ctx.packs
        gs = [torch.zeros((x.shape[0], pk.n_out), dtype=x.dtype, device=x.device) if g is None else g
              for g, pk in zip(gs, packs)]
        dx, grads = fused_mlps_backward(x, packs, gs, ctx.stash)
        out = []
        for i, pk in enumerate(packs):
            dwh, dbh, dsc, dbi, dwo, dbo = grads[6 * i : 6 * i + 6]
            num_layers = pk.num_layers
            out += [dwh[l].to(x.dtype) for l in range(num_layers)]  # rounded as the compute-dtype weight
            out += [dbh[l] for l in range(num_layers)] + [dsc[l] for l in range(num_layers)]
            out += [dbi[l] for l in range(num_layers)] + [dwo.to(x.dtype), dbo]
        out = [g.to(p.dtype) for g, p in zip(out, params)]
        return (dx, None, None, None, *out)


def _fused_mlps_cuda(x_2d: torch.Tensor, mlps) -> List[torch.Tensor]:
    dtype = _check_supported(x_2d, mlps, _library().sihl_fused_mlp_width())
    x = x_2d.to(dtype).contiguous()
    if x.data_ptr() % 16:  # the kernels read x in 16-byte vectors
        x = x.clone()
    params = [p for mlp in mlps for p in mlp_parameters(mlp)]
    training = torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params))
    return list(_FusedMLPs.apply(x, tuple(mlps), dtype, training, *params))


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
