"""Task heads of the port."""

from sihl_tpu_torch.heads.anomaly_detection import AnomalyDetection
from sihl_tpu_torch.heads.autoencoding import Autoencoding
from sihl_tpu_torch.heads.base import Head, TensorShape
from sihl_tpu_torch.heads.depth_estimation import DepthEstimation
from sihl_tpu_torch.heads.instance_segmentation import InstanceSegmentation
from sihl_tpu_torch.heads.keypoint_detection import KeypointDetection
from sihl_tpu_torch.heads.metric_learning import MetricLearning
from sihl_tpu_torch.heads.multiclass_classification import MulticlassClassification, soft_ordinal_category
from sihl_tpu_torch.heads.multilabel_classification import MultilabelClassification
from sihl_tpu_torch.heads.object_detection import ObjectDetection
from sihl_tpu_torch.heads.panoptic_segmentation import PanopticSegmentation, panoptic_targets_from_maps
from sihl_tpu_torch.heads.quadrilateral_detection import QuadrilateralDetection
from sihl_tpu_torch.heads.regression import Regression
from sihl_tpu_torch.heads.semantic_segmentation import SPPM, UAFM, SemanticSegmentation
from sihl_tpu_torch.heads.text_recognition import TextRecognition
from sihl_tpu_torch.heads.view_invariance_learning import ViewInvarianceLearning

__all__ = [
    "AnomalyDetection",
    "Autoencoding",
    "DepthEstimation",
    "Head",
    "InstanceSegmentation",
    "KeypointDetection",
    "MetricLearning",
    "MulticlassClassification",
    "MultilabelClassification",
    "ObjectDetection",
    "PanopticSegmentation",
    "QuadrilateralDetection",
    "Regression",
    "SPPM",
    "SemanticSegmentation",
    "TensorShape",
    "TextRecognition",
    "UAFM",
    "ViewInvarianceLearning",
    "panoptic_targets_from_maps",
    "soft_ordinal_category",
]
