"""Host-side utilities of the port (counterpart of ``sihl_tpu/utils``).

Ported so far: ``EPS``, Welford's batched mean and variance
(:mod:`~sihl_tpu_torch.utils.welford`), and
:mod:`~sihl_tpu_torch.utils.coco_map`, :mod:`~sihl_tpu_torch.utils.f1`,
:mod:`~sihl_tpu_torch.utils.panoptic_quality` and
:mod:`~sihl_tpu_torch.utils.pck`, copies of the JAX package's numpy COCO
mAP, optimal-F1 threshold, panoptic quality and percentage of correct
keypoints.
"""

from sihl_tpu_torch.utils.f1 import OptimalF1Threshold
from sihl_tpu_torch.utils.panoptic_quality import PanopticQuality
from sihl_tpu_torch.utils.pck import PercentageOfCorrectKeypoints
from sihl_tpu_torch.utils.welford import (BatchedMeanVarianceAccumulator, welford_compute, welford_init,
                                          welford_update)

# a copy of sihl_tpu/utils/__init__.py:31
EPS = 1e-5

__all__ = ["BatchedMeanVarianceAccumulator", "EPS", "OptimalF1Threshold", "PanopticQuality",
           "PercentageOfCorrectKeypoints", "welford_compute", "welford_init", "welford_update"]
