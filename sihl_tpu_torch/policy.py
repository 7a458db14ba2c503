"""Mixed-precision policy (counterpart of ``sihl_tpu/policy.py``).

Parameters are float32.  Modules read the compute dtype when they are
constructed and cast their inputs and weights to it explicitly in
``forward``; there is no ``torch.autocast``, so every kernel sees a definite
dtype.
"""

from contextlib import contextmanager

import torch

_COMPUTE_DTYPE = torch.float32


def set_compute_dtype(dtype: torch.dtype) -> None:
    """Set the computation dtype used by modules constructed afterwards."""
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


@contextmanager
def compute_dtype_scope(dtype: torch.dtype):
    global _COMPUTE_DTYPE
    prev = _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        _COMPUTE_DTYPE = prev
