"""Task heads of the port."""

from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.heads.instance_segmentation import InstanceSegmentation
from sihl_tpu_torch.heads.object_detection import ObjectDetection
from sihl_tpu_torch.heads.quadrilateral_detection import QuadrilateralDetection

__all__ = ["Head", "InstanceSegmentation", "ObjectDetection", "QuadrilateralDetection"]
