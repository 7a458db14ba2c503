"""Dropout with an explicit random stream (counterpart of ``nnx.Dropout``).

In training mode with ``rate > 0`` each call keeps an element with
probability ``1 - rate`` and scales it by ``1 / (1 - rate)``, as
``nnx.Dropout`` does; in eval mode, or at rate 0, it is the identity and
draws nothing.

The stream is a seed, drawn at construction from the model's init
generator, and a count of the calls that drew, as nnx keeps an ``RngKey``
and an ``RngCount``: call ``n`` draws its mask from a ``torch.Generator`` on
the input's device seeded with a 32-bit mix of (seed, n) (the CPU
generator keeps 32 bits of its seed), so the masks do not depend on any
other use of PyTorch's global generators, and a model moved between
devices keeps its stream.  The count is host state, so a call waits for
nothing.  The state dict carries (seed, count) as an int64 tensor under
``<prefix>rng``, so a checkpoint restores the stream; a state dict without
it (a model carried over from JAX, whose ``RngCount`` the bridge leaves
out) keeps the module's own.
"""

from typing import Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator

_MASK64 = 2**64 - 1


def _mix(seed: int, count: int) -> int:
    """splitmix64's finaliser of (seed, count), cut to 32 bits."""
    z = (seed + (count + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


class Dropout(nn.Module):
    def __init__(self, rate: float, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
        self.rate = float(rate)
        self.seed = int(torch.randint(2**62, (1,), generator=default_generator(generator)))
        self.count = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        gen = torch.Generator(device=x.device)
        gen.manual_seed(_mix(self.seed, self.count))
        self.count += 1
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype, device=x.device))

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        destination[prefix + "rng"] = torch.tensor([self.seed, self.count], dtype=torch.int64)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                              error_msgs):
        if prefix + "rng" in state_dict:
            self.seed, self.count = (int(v) for v in state_dict[prefix + "rng"])

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
