"""Host-side utilities of the port (counterpart of ``sihl_tpu/utils``).

``EPS``, Welford's batched mean and variance
(:mod:`~sihl_tpu_torch.utils.welford`), convex-polygon IoU
(:mod:`~sihl_tpu_torch.utils.polygon_iou`), ``f_score``, ``random_pad``
and the dotted-attribute helpers, and
:mod:`~sihl_tpu_torch.utils.coco_map`, :mod:`~sihl_tpu_torch.utils.f1`,
:mod:`~sihl_tpu_torch.utils.panoptic_quality` and
:mod:`~sihl_tpu_torch.utils.pck`, copies of the JAX package's numpy COCO
mAP, optimal-F1 threshold, panoptic quality and percentage of correct
keypoints.  The geometry, embedding and loss helpers that the JAX module
re-exports from its ops are re-exported here from the port's.
"""

import functools
import random
from typing import Any, Callable, Tuple, Union

import numpy as np

from sihl_tpu_torch.ops import (  # noqa: F401  (the JAX module's re-exports)
    coordinate_grid,
    edges,
    focal_loss,
    gaussian_blur,
    points_to_bbox,
    sine_embedding_1d,
    sine_embedding_2d,
    sine_embedding_2d_grid,
    ssim_loss,
    tversky_loss,
)
from sihl_tpu_torch.utils.f1 import OptimalF1Threshold
from sihl_tpu_torch.utils.panoptic_quality import PanopticQuality
from sihl_tpu_torch.utils.pck import PercentageOfCorrectKeypoints
from sihl_tpu_torch.utils.polygon_iou import polygon_area, polygon_iou
from sihl_tpu_torch.utils.welford import (BatchedMeanVarianceAccumulator, welford_compute, welford_init,
                                          welford_update)

# a copy of sihl_tpu/utils/__init__.py:31
EPS = 1e-5


def f_score(beta: float) -> Callable:
    """https://en.wikipedia.org/wiki/F-score#Definition (reference ``utils:141-143``)."""
    return lambda p, r: (1 + beta**2) * p * r / (beta**2 * p + r)


def random_pad(
    image: np.ndarray,
    target_size: Union[int, Tuple[int, int]],
    fill: Union[float, int] = 0,
) -> np.ndarray:
    """Host-side random pad of an HWC numpy image to ``target_size``, first
    shrunk by nearest-pixel sampling to fit where it is larger (reference
    ``utils:61-88``).  The offsets come from Python's ``random``, as in the
    JAX package, so ``random.seed`` fixes them."""
    if isinstance(target_size, int):
        target_size = (target_size, target_size)
    h, w = image.shape[:2]
    if h > target_size[0] or w > target_size[1]:
        scale = min(target_size[0] / h, target_size[1] / w)
        new_h, new_w = int(h * scale), int(w * scale)
        ys = (np.arange(new_h) * (h / new_h)).astype(np.int64)
        xs = (np.arange(new_w) * (w / new_w)).astype(np.int64)
        image = image[ys][:, xs]
        h, w = new_h, new_w
    pad_h, pad_w = target_size[0] - h, target_size[1] - w
    top = random.randint(0, pad_h)
    left = random.randint(0, pad_w)
    pad_spec = [(top, pad_h - top), (left, pad_w - left)] + [(0, 0)] * (image.ndim - 2)
    return np.pad(image, pad_spec, constant_values=fill)


def recursive_getattr(obj: Any, attr: str, *args):
    """``getattr`` along a dotted path; ``args`` is ``getattr``'s default."""

    def _getattr(obj: Any, attr: str):
        return getattr(obj, attr, *args)

    return functools.reduce(_getattr, [obj] + attr.split("."))


def recursive_setattr(obj: Any, attr: str, val: Any):
    """``setattr`` at the end of a dotted path."""
    pre, _, post = attr.rpartition(".")
    return setattr(recursive_getattr(obj, pre) if pre else obj, post, val)


__all__ = ["BatchedMeanVarianceAccumulator", "EPS", "OptimalF1Threshold", "PanopticQuality",
           "PercentageOfCorrectKeypoints", "f_score", "polygon_area", "polygon_iou", "random_pad",
           "recursive_getattr", "recursive_setattr", "welford_compute", "welford_init", "welford_update"]
