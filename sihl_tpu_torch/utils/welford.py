"""Welford's online mean and variance over batches (counterpart of
``sihl_tpu/utils/__init__.py:34-100``): the stateful
:class:`BatchedMeanVarianceAccumulator` and the functional ``(state,
update, compute)`` form that the anomaly head's pretraining protocol keeps
on the device.

Both copy the JAX package's first update: it takes the batch's mean and
sets ``m2`` to 0, so the first batch's spread within itself never enters
the variance (ROADMAP.md, queue C, records this as a fault of the reference
that both packages are to lose together).
"""

from typing import Optional, Tuple

import torch

WelfordState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class BatchedMeanVarianceAccumulator:
    """Welford online mean and variance over the first axis of batches."""

    def __init__(self):
        self.count = 0
        self.mean: Optional[torch.Tensor] = None
        self.m2: Optional[torch.Tensor] = None

    def update(self, x) -> None:
        x = torch.as_tensor(x)
        if self.mean is None:
            self.mean = x.mean(dim=0)
            self.m2 = torch.zeros_like(self.mean)
        else:
            if x.shape[1:] != self.mean.shape:
                raise ValueError(f"Shape mismatch: got {tuple(x.shape[1:])}, expected {tuple(self.mean.shape)}")
            batch_count = x.shape[0]
            total = self.count + batch_count
            batch_mean = x.mean(dim=0)
            delta = batch_mean - self.mean
            self.mean = self.mean + delta * batch_count / total
            self.m2 = self.m2 + (
                x.var(dim=0, correction=0) * batch_count + delta**2 * self.count * batch_count / total
            )
        self.count += x.shape[0]

    def compute(self):
        if self.count < 2:
            return self.mean, torch.full_like(self.mean, float("nan"))
        return self.mean, self.m2 / (self.count - 1)


def welford_init(shape, dtype: torch.dtype = torch.float32, device=None) -> WelfordState:
    """The functional state ``(count, mean, m2)``, the count an f32 scalar as
    in the JAX package."""
    return (
        torch.zeros((), dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    """Fold the rows of ``x`` (N, ...) into ``state``; on the first update
    ``mean`` becomes the batch's mean and ``m2`` 0."""
    count, mean, m2 = state
    batch_count = x.shape[0]
    total = count + batch_count
    batch_mean = x.mean(dim=0)
    delta = batch_mean - mean
    new_mean = mean + delta * batch_count / total
    new_m2 = m2 + x.var(dim=0, correction=0) * batch_count + delta**2 * count * batch_count / total
    new_m2 = torch.where(count == 0, torch.zeros_like(new_m2), new_m2)
    return total, new_mean, new_m2


def welford_compute(state: WelfordState):
    """``(mean, variance)``, the variance with Bessel's correction and NaN
    below two rows."""
    count, mean, m2 = state
    var = torch.where(count < 2, torch.full_like(m2, float("nan")), m2 / torch.clamp(count - 1, min=1))
    return mean, var
