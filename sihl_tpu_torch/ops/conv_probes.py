"""The flagship backbone's stage-1/2 convolutions as hand-written GEMMs: the
port of the JAX package's conv probes (``tools/probe_conv1x1_pallas.py``,
``tools/probe_wrt_filter.py``, ``tools/probe_conv3x3_pallas.py``).

- :func:`matmul_stats` (P4): the 1x1 conv 64 -> 256 as y = x w over rows,
  optionally with BatchNorm's per-channel sum and sum of squares of y taken
  from the f32 sums before y is rounded;
- :func:`weight_grad_1x1` (P5): the 1x1 conv's weight gradient x^T dy in f32;
- :func:`conv3x3` (P2): the stride-1 SAME 3x3 conv 64 -> 64 in NHWC.

bf16 operands, f32 sums, each bf16 output rounded once.  A CUDA tensor goes
to the hand-written kernels of ``csrc/conv_probes.cu`` (the file says how
each is laid out and what bounds it); a CPU tensor goes to the plain
PyTorch version beside each wrapper, which repeats the kernel's arithmetic
in f32.  No model path calls these yet: the probe scripts of
``sihl_tpu_torch.tools`` and ``chip_smoke.py`` do.
"""

import ctypes
import functools
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from sihl_tpu_torch.ops.build import cuda_library

P4_IN, P4_OUT = 64, 256          # matmul_stats: x (M, 64) by w (64, 256)
P5_CI_STEP, P5_CO_STEP = 64, 256  # weight_grad_1x1: ci and co multiples
P2_CHANNELS = 64                  # conv3x3: 64 -> 64


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_library("conv_probes")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sihl_probe_matmul_blocks.argtypes = [ll, i]
    lib.sihl_probe_matmul_blocks.restype = ll
    lib.sihl_probe_matmul_stats.argtypes = [i, p, p, ll, p, p, p, ll, p]
    lib.sihl_probe_matmul_stats.restype = i
    lib.sihl_probe_weight_grad_splits.argtypes = [ll, i, i]
    lib.sihl_probe_weight_grad_splits.restype = ll
    lib.sihl_probe_weight_grad.argtypes = [p, p, ll, i, i, p, p, ll, p]
    lib.sihl_probe_weight_grad.restype = i
    lib.sihl_probe_conv3x3.argtypes = [p, p, i, i, i, p, p]
    lib.sihl_probe_conv3x3.restype = i
    lib.sihl_cuda_error_string.argtypes = [i]
    lib.sihl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: {_library().sihl_cuda_error_string(err).decode()}")


def _count(n: int, what: str) -> int:
    """A block or split count from the library; 0 or less is minus a CUDA error."""
    if n <= 0:
        _check(-n, what)
    return n


def _require(t: torch.Tensor, name: str, shape, what: str) -> None:
    """What every kernel takes: a contiguous bf16 tensor of ``shape`` (None
    for any size) on the first tensor's device."""
    if t.dtype != torch.bfloat16:
        raise ValueError(f"the {what} kernel takes bf16 {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"the {what} kernel takes a contiguous {name}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"the {what} kernel takes {name} of shape {shape}, got {tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _same_device(*ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"inputs on {[str(t.device) for t in ts]}")


# ----------------------------------------------------------------------- P4

MatmulOut = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def matmul_stats_reference(x: torch.Tensor, w: torch.Tensor, stats: bool = False) -> MatmulOut:
    """Plain PyTorch version: y = x w in f32, rounded once to x's dtype; with
    ``stats``, also the f32 sum and sum of squares of each column of the f32
    y.  On the card, a reference needs ``torch.backends.cuda.matmul.allow_tf32
    = False``."""
    yf = x.float() @ w.float()
    y = yf.to(x.dtype)
    if not stats:
        return y
    return y, yf.sum(dim=0), (yf * yf).sum(dim=0)


def _matmul_stats_cuda(x: torch.Tensor, w: torch.Tensor, stats: bool) -> MatmulOut:
    _require(x, "x", (None, P4_IN), "matmul_stats")
    _require(w, "w", (P4_IN, P4_OUT), "matmul_stats")
    _same_device(x, w)
    m = x.shape[0]
    if m < 1:
        raise ValueError("the matmul_stats kernel takes at least one row")
    lib = _library()
    with torch.cuda.device(x.device):
        blocks = _count(lib.sihl_probe_matmul_blocks(m, int(stats)), "matmul_stats")
        y = torch.empty((m, P4_OUT), dtype=torch.bfloat16, device=x.device)
        partials = torch.empty((blocks, 2, P4_OUT) if stats else (0,), dtype=torch.float32, device=x.device)
        sums = torch.empty((2, P4_OUT) if stats else (0,), dtype=torch.float32, device=x.device)
        err = lib.sihl_probe_matmul_stats(int(stats), x.data_ptr(), w.data_ptr(), m, y.data_ptr(),
                                          partials.data_ptr(), sums.data_ptr(), blocks, _stream(x))
    _check(err, "matmul_stats")
    matmul_stats.launches += 1
    return (y, sums[0], sums[1]) if stats else y


@torch.no_grad()
def matmul_stats(x: torch.Tensor, w: torch.Tensor, stats: bool = False) -> MatmulOut:
    """The 1x1 conv 64 -> 256 over rows: y = x w for x (M, 64) and w
    (64, 256), bf16 on the card, y (M, 256) rounded once from f32 sums.
    With ``stats``, returns ``(y, sum, sumsq)``: the (256,) f32 sum and sum
    of squares over the rows of y before rounding (BatchNorm's batch
    statistics); else y alone.  No gradient flows through it."""
    if x.device.type == "cuda":
        return _matmul_stats_cuda(x, w, stats)
    if x.device.type == "cpu":
        return matmul_stats_reference(x, w, stats)
    raise ValueError(f"matmul_stats runs on CUDA or CPU tensors, got {x.device}")


matmul_stats.launches = 0  # kernel launches since the last reset


# ----------------------------------------------------------------------- P5


def weight_grad_1x1_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x^T dy in f32."""
    return x.float().T @ dy.float()


def _weight_grad_1x1_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    _require(x, "x", (None, None), "weight_grad_1x1")
    m, ci = x.shape
    _require(dy, "dy", (m, None), "weight_grad_1x1")
    _same_device(x, dy)
    co = dy.shape[1]
    if m < 1 or ci < 1 or co < 1 or ci % P5_CI_STEP or co % P5_CO_STEP:
        raise ValueError(f"the weight_grad_1x1 kernel takes rows >= 1, ci a multiple of {P5_CI_STEP} and co "
                         f"of {P5_CO_STEP}, got ({m}, {ci}) and ({m}, {co})")
    lib = _library()
    with torch.cuda.device(x.device):
        splits = _count(lib.sihl_probe_weight_grad_splits(m, ci, co), "weight_grad_1x1")
        partials = torch.empty((splits, ci, co), dtype=torch.float32, device=x.device)
        dw = torch.empty((ci, co), dtype=torch.float32, device=x.device)
        err = lib.sihl_probe_weight_grad(x.data_ptr(), dy.data_ptr(), m, ci, co, partials.data_ptr(),
                                         dw.data_ptr(), splits, _stream(x))
    _check(err, "weight_grad_1x1")
    weight_grad_1x1.launches += 1
    return dw


@torch.no_grad()
def weight_grad_1x1(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The 1x1 conv's weight gradient over rows: dW = x^T dy, (ci, co) f32,
    for x (M, ci) and dy (M, co), bf16 on the card with ci a multiple of 64
    and co of 256."""
    if x.device.type == "cuda":
        return _weight_grad_1x1_cuda(x, dy)
    if x.device.type == "cpu":
        return weight_grad_1x1_reference(x, dy)
    raise ValueError(f"weight_grad_1x1 runs on CUDA or CPU tensors, got {x.device}")


weight_grad_1x1.launches = 0  # kernel launches since the last reset


# ----------------------------------------------------------------------- P2


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the sum over the 9 taps of the zero-padded
    input's shifted rows times each tap's (C, C) matrix, in f32, rounded
    once to x's dtype.  x (B, H, W, C) NHWC, w (3, 3, C, C) HWIO."""
    _, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = sum(xp[:, ky : ky + h, kx : kx + wd, :] @ w[ky, kx].float() for ky in range(3) for kx in range(3))
    return acc.to(x.dtype)


def _conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _require(x, "x", (None, None, None, P2_CHANNELS), "conv3x3")
    _require(w, "w", (3, 3, P2_CHANNELS, P2_CHANNELS), "conv3x3")
    _same_device(x, w)
    b, h, wd, _ = x.shape
    if min(b, h, wd) < 1:
        raise ValueError(f"the conv3x3 kernel takes a non-empty image, got {tuple(x.shape)}")
    lib = _library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.sihl_probe_conv3x3(x.data_ptr(), w.data_ptr(), b, h, wd, y.data_ptr(), _stream(x))
    _check(err, "conv3x3")
    conv3x3.launches += 1
    return y


@torch.no_grad()
def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stride-1 SAME 3x3 conv 64 -> 64 of x (B, H, W, 64) NHWC by w
    (3, 3, 64, 64) HWIO: y (B, H, W, 64) NHWC, bf16 on the card, rounded
    once from the f32 sum over the taps and channels."""
    if x.device.type == "cuda":
        return _conv3x3_cuda(x, w)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    raise ValueError(f"conv3x3 runs on CUDA or CPU tensors, got {x.device}")


conv3x3.launches = 0  # kernel launches since the last reset
