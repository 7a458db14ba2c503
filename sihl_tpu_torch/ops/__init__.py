"""Ops of the port: plain tensor functions and the hand-written kernels
(counterpart of ``sihl_tpu/ops``, whose public names it exports)."""

from sihl_tpu_torch.ops.boxes import (bbox_matching, box_iou, complete_box_iou, complete_box_iou_loss,
                                      masks_to_boxes, points_to_bbox)
from sihl_tpu_torch.ops.embeddings import coordinate_grid, sine_embedding_1d, sine_embedding_2d, sine_embedding_2d_grid
from sihl_tpu_torch.ops.image import (adaptive_avg_pool, adaptive_max_pool, avg_pool2d, blur_pool_2d, edges,
                                      gaussian_blur, interpolate, max_pool2d, upsample2x_nearest)
from sihl_tpu_torch.ops.losses import (binary_cross_entropy, binary_cross_entropy_with_logits, cross_entropy,
                                       focal_loss, log_cosh_loss, sigmoid_focal_loss, ssim_loss, tversky_loss)

__all__ = [
    "coordinate_grid",
    "sine_embedding_1d",
    "sine_embedding_2d",
    "sine_embedding_2d_grid",
    "box_iou",
    "complete_box_iou",
    "complete_box_iou_loss",
    "masks_to_boxes",
    "points_to_bbox",
    "bbox_matching",
    "binary_cross_entropy",
    "binary_cross_entropy_with_logits",
    "cross_entropy",
    "focal_loss",
    "sigmoid_focal_loss",
    "tversky_loss",
    "ssim_loss",
    "log_cosh_loss",
    "upsample2x_nearest",
    "interpolate",
    "avg_pool2d",
    "max_pool2d",
    "adaptive_avg_pool",
    "adaptive_max_pool",
    "edges",
    "gaussian_blur",
    "blur_pool_2d",
]
