"""Host-side utilities of the port (counterpart of ``sihl_tpu/utils``).

Ported so far: ``EPS``, and :mod:`~sihl_tpu_torch.utils.coco_map`,
:mod:`~sihl_tpu_torch.utils.f1` and
:mod:`~sihl_tpu_torch.utils.panoptic_quality`, copies of the JAX package's
numpy COCO mAP, optimal-F1 threshold and panoptic quality.
"""

from sihl_tpu_torch.utils.f1 import OptimalF1Threshold
from sihl_tpu_torch.utils.panoptic_quality import PanopticQuality

# a copy of sihl_tpu/utils/__init__.py:31
EPS = 1e-5

__all__ = ["EPS", "OptimalF1Threshold", "PanopticQuality"]
