"""Host-side utilities of the port (counterpart of ``sihl_tpu/utils``).

Ported so far: :mod:`~sihl_tpu_torch.utils.coco_map` and
:mod:`~sihl_tpu_torch.utils.f1`, copies of the JAX package's numpy COCO
mAP and optimal-F1 threshold.
"""

from sihl_tpu_torch.utils.f1 import OptimalF1Threshold

__all__ = ["OptimalF1Threshold"]
