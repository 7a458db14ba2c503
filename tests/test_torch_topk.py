"""Parity of the port's row k-th threshold (K2's plain version, on the CPU)
with the JAX package's Pallas kernel in interpret mode and its plain
reference.  Every comparison is exact: the op takes maxima and compares only.

The Pallas kernel pads rows to multiples of 8 and columns of 128 with zeros;
a row that holds no zero can then read 0 where the unpadded op reads -1, a
difference the matching never sees (it claims no anchor of IoU 0).  The
inputs here either hold a zero in every row or need no column padding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sihl_tpu.ops.pallas.topk import _row_reference as jax_row_reference
from sihl_tpu.ops.pallas.topk import _rows_pallas
from sihl_tpu_torch.ops.topk import ROW_PLANS, row_best_and_kth, row_plan

import torch_parity  # noqa: F401  (one thread per worker)


def _cases():
    rng = np.random.RandomState(0)
    ties = rng.choice([0.0, 0.25, 0.5, 0.5, 1.0], (16, 257)).astype(np.float32)
    ties[3] = 0.0  # an all-zero row: kth is -1
    dense = np.abs(rng.randn(8, 256)).astype(np.float32)  # no padding, no zeros
    sparse = np.where(rng.rand(12, 1000) < 0.7, 0.0, rng.rand(12, 1000)).astype(np.float32)
    few = np.zeros((3, 130), np.float32)
    few[:, :2] = [[0.5, 0.5], [0.9, 0.1], [0.3, 0.0]]  # fewer distinct values than k
    return {"ties_zeros": ties, "dense": dense, "sparse": sparse, "few_distinct": few}


@pytest.mark.parametrize("k", [9, 1, 2])
@pytest.mark.parametrize("case", ["ties_zeros", "dense", "sparse", "few_distinct"])
def test_row_best_and_kth_matches_jax(case, k):
    x = _cases()[case]
    best, kth = row_best_and_kth(torch.from_numpy(x), k)
    for want_best, want_kth in (
        _rows_pallas(jnp.asarray(x), k, interpret=True),
        jax_row_reference(jnp.asarray(x), k),
    ):
        np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))
        np.testing.assert_array_equal(kth.numpy(), np.asarray(want_kth))


def test_row_best_and_kth_refusals():
    with pytest.raises(ValueError, match=r"\(G, A\)"):
        row_best_and_kth(torch.zeros(3), 9)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        row_best_and_kth(torch.zeros(2, 3, device="meta"), 9)


# each instance's edges, the matchings' rows (8,400 and 8,525) and the
# widest row the shared-memory kernel took (57,856 columns)
@pytest.mark.parametrize("a", [1, 255, 2048, 2049, 8400, 8525, 9216, 9217, 20480, 20481, 57856, 58368])
def test_row_plan_covers_every_column_once(a):
    """The kernel's thread t holds entries j * threads + t for j < values:
    every column of the row once, in the narrowest instance that holds it."""
    threads, values = row_plan(a)
    columns = sorted(j * threads + t for j in range(values) for t in range(threads) if j * threads + t < a)
    assert columns == list(range(a))
    assert all(a > t * v for t, v in ROW_PLANS[: ROW_PLANS.index((threads, values))])
    with pytest.raises(ValueError, match="columns"):
        row_plan(ROW_PLANS[-1][0] * ROW_PLANS[-1][1] + 1)
