"""Mixed-precision and device policy (counterpart of ``sihl_tpu/policy.py``).

Parameters are float32.  Modules read the compute dtype when they are
constructed and cast their inputs and weights to it explicitly in
``forward``; there is no ``torch.autocast``, so every kernel sees a definite
dtype.

Modules are built on the default device, a CUDA card, unless the caller
passes ``device=`` or changes the default with :func:`set_default_device`.
Building on the card where there is none raises: the port never moves to the
CPU on its own.
"""

from contextlib import contextmanager

import torch

_COMPUTE_DTYPE = torch.float32
_DEFAULT_DEVICE = "cuda"


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


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in f64 where it is f64: the dtype of statistics and
    losses (f32 for the bf16 and f32 compute dtypes, as in the JAX package;
    a model built under ``compute_dtype_scope(torch.float64)`` computes
    them in f64, for reference runs)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def device_vector(values, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A short vector of Python numbers made on ``device`` by fill kernels,
    not copied from the host: a CUDA graph can capture a fill, and cannot
    capture ``torch.tensor(values, device=...)``'s host-to-device copy.  The
    values round to ``dtype`` as ``torch.tensor`` rounds them."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])


def set_default_device(device) -> None:
    """Set the device that constructors use when they are given ``device=None``."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = device


def default_device():
    return _DEFAULT_DEVICE


def resolve_device(device=None) -> torch.device:
    """``device``, or the default device when it is None; raises when that is
    a CUDA device and no card is present."""
    device = torch.device(_DEFAULT_DEVICE if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is present; build on the CPU with device='cpu' or "
            "sihl_tpu_torch.policy.set_default_device('cpu')"
        )
    return device
