"""Task heads of the port."""

from sihl_tpu_torch.heads.base import Head, TensorShape
from sihl_tpu_torch.heads.instance_segmentation import InstanceSegmentation
from sihl_tpu_torch.heads.multiclass_classification import MulticlassClassification, soft_ordinal_category
from sihl_tpu_torch.heads.multilabel_classification import MultilabelClassification
from sihl_tpu_torch.heads.object_detection import ObjectDetection
from sihl_tpu_torch.heads.quadrilateral_detection import QuadrilateralDetection
from sihl_tpu_torch.heads.regression import Regression

__all__ = [
    "Head",
    "InstanceSegmentation",
    "MulticlassClassification",
    "MultilabelClassification",
    "ObjectDetection",
    "QuadrilateralDetection",
    "Regression",
    "TensorShape",
    "soft_ordinal_category",
]
