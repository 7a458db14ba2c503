"""Per-row k-th-largest threshold for anchor matching (counterpart of
``sihl_tpu/ops/pallas/topk.py``).

:func:`row_best_and_kth` returns, for a (G, A) matrix of non-negative
scores, each row's maximum and its k-th largest *distinct* value: k-1
passes each set every entry at or above the current maximum to -1.  A CUDA
tensor goes to the hand-written kernel ``csrc/topk.cu`` (one block per row,
the row in registers, in the template instance :func:`row_plan` picks); a
CPU tensor to :func:`_row_reference`.  Matching carries no gradient, so
there is no backward.
"""

import ctypes
import functools
from typing import Tuple

import torch

from sihl_tpu_torch.ops.build import cuda_library

# The kernel's template instances (threads, entries a thread), narrowest
# first: a row of A columns goes to the first with threads * entries >= A.
ROW_PLANS = ((256, 8), (128, 67), (512, 40), (1024, 57))


def row_plan(a: int) -> Tuple[int, int]:
    """(threads, entries a thread) of the instance that holds a row of ``a``
    columns, thread t taking entries j * threads + t."""
    for threads, values in ROW_PLANS:
        if a <= threads * values:
            return threads, values
    raise ValueError(f"the row k-th kernel takes 1 to {threads * values} columns, got {a}")


def _row_reference(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (G, A) -> (best (G,), kth (G,))."""
    best = x.max(dim=-1).values
    cur = x
    for _ in range(k - 1):
        m = cur.max(dim=-1, keepdim=True).values
        cur = torch.where(cur >= m, -1.0, cur)
    return best, cur.max(dim=-1).values


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_library("topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sihl_row_best_kth.argtypes = [p, i, i, i, i, i, p, p, p]
    lib.sihl_row_best_kth.restype = i
    lib.sihl_row_kth_max_cols.argtypes = []
    lib.sihl_row_kth_max_cols.restype = i
    lib.sihl_cuda_error_string.argtypes = [i]
    lib.sihl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _row_best_and_kth_cuda(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    lib = _library()
    g, a = x.shape
    if x.dtype != torch.float32:
        raise ValueError(f"the row k-th kernel takes float32, got {x.dtype}")
    if a < 1:
        raise ValueError(f"the row k-th kernel takes 1 to {lib.sihl_row_kth_max_cols()} columns, got {a}")
    threads, values = row_plan(a)
    x = x.contiguous()
    best = torch.empty(g, dtype=x.dtype, device=x.device)
    kth = torch.empty(g, dtype=x.dtype, device=x.device)
    if g:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.sihl_row_best_kth(x.data_ptr(), g, a, k, threads, values, best.data_ptr(), kth.data_ptr(), stream)
        if err:
            raise RuntimeError(f"row k-th kernel launch failed: {lib.sihl_cuda_error_string(err).decode()}")
        row_best_and_kth.launches += 1
    return best, kth


def row_best_and_kth(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, A) non-negative scores -> per-row (max (G,), k-th largest distinct (G,))."""
    if x.dim() != 2 or k < 1:
        raise ValueError(f"row_best_and_kth takes a (G, A) matrix and k >= 1, got {tuple(x.shape)}, k={k}")
    if x.device.type == "cuda":
        return _row_best_and_kth_cuda(x, k)
    if x.device.type == "cpu":
        return _row_reference(x, k)
    raise ValueError(f"row_best_and_kth runs on CUDA or CPU tensors, got {x.device}")


row_best_and_kth.launches = 0  # kernel launches since the last reset
