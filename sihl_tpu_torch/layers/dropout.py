"""Dropout with an explicit random stream (counterpart of ``nnx.Dropout``).

In training mode with ``rate > 0`` each call keeps an element with
probability ``1 - rate`` and scales it by ``1 / (1 - rate)``, as
``nnx.Dropout`` does; in eval mode, or at rate 0, it is the identity and
draws nothing.

The stream is a seed, drawn at construction from the model's init
generator, and a count of the calls that drew, as nnx keeps an ``RngKey``
and an ``RngCount``.  The count is a 0-dim int64 tensor on the module's
device, advanced in place by every call that draws, so a CUDA graph that
holds the call draws a new mask at each replay.  The mask is a pure
function of (seed, count, element index) (:func:`keep_mask`): element
``j`` is kept iff the ``j``-th output of splitmix64, seeded with a mix of
(seed, count), falls below ``(1 - rate) * 2**53`` in its top 53 bits.  It
is computed in int64 tensor ops, so the CPU and the card, an eager step
and a graph's replay draw the same mask at the same count, and the masks
depend on no other use of PyTorch's generators.  The state dict carries
(seed, count) as an int64 tensor under ``<prefix>rng``, so a checkpoint
restores the stream; a state dict without it (a model carried over from
JAX, whose ``RngCount`` the bridge leaves out) keeps the module's own.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator
from sihl_tpu_torch.policy import resolve_device

# splitmix64's constants as signed int64 (int64 products wrap mod 2**64)
_GOLDEN = 0x9E3779B97F4A7C15 - 2**64
_MUL1 = 0xBF58476D1CE4E5B9 - 2**64
_MUL2 = 0x94D049BB133111EB - 2**64


def _shift_right(z: torch.Tensor, bits: int) -> torch.Tensor:
    """Logical right shift of int64 ``z`` (``>>`` is arithmetic on signed
    integers: mask off the copied sign bits)."""
    return (z >> bits) & ((1 << (64 - bits)) - 1)


def _finalise(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's output function of the int64 state ``z``."""
    z = (z ^ _shift_right(z, 30)) * _MUL1
    z = (z ^ _shift_right(z, 27)) * _MUL2
    return z ^ _shift_right(z, 31)


def keep_mask(seed: int, count: torch.Tensor, shape: Sequence[int], rate: float) -> torch.Tensor:
    """The boolean mask of the call at ``count`` (a 0-dim int64 tensor, whose
    device the mask takes): element ``j`` (row-major) is kept iff the top 53
    bits of ``finalise(key + (j + 1) * golden)`` lie below ``(1 - rate) *
    2**53``, with ``key = finalise(seed + (count + 1) * golden)``."""
    key = _finalise(count * _GOLDEN + (seed + _GOLDEN))
    index = torch.arange(1, 1 + int(torch.Size(shape).numel()), dtype=torch.int64, device=count.device)
    bits = _shift_right(_finalise(index * _GOLDEN + key), 11)
    return (bits < int((1.0 - rate) * 2**53)).reshape(shape)


class Dropout(nn.Module):
    def __init__(self, rate: float, *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
        self.rate = float(rate)
        self.seed = int(torch.randint(2**62, (1,), generator=default_generator(generator)))
        # not a buffer: (seed, count) cross the state dict as one ``rng`` entry, and
        # JAX's BatchStats hold no counterpart; ``_apply`` moves it with the module
        self.count = torch.zeros((), dtype=torch.int64, device=resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = keep_mask(self.seed, self.count, x.shape, self.rate)
        self.count.add_(1)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype, device=x.device))

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self.count = fn(self.count)  # a move; ``to(dtype)`` casts floating tensors only
        return self

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        destination[prefix + "rng"] = torch.stack((torch.full_like(self.count, self.seed), self.count))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                              error_msgs):
        if prefix + "rng" in state_dict:
            seed, count = state_dict[prefix + "rng"]
            self.seed = int(seed)
            self.count.copy_(count)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
