"""Drive the PyTorch port's serving, training and validation paths on one CUDA card and check them.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Twenty models run through the port's hand-written kernels, with weights
from a seed: the flagship (ResNet-50, FPN 256 channels over levels
3-7, ObjectDetection with 80 classes), the instance-segmentation model of
``examples/instance_segmentation.py`` at the flagship's width (ResNet-50,
FPN 256 channels over levels 3-5, InstanceSegmentation with 80 classes),
the quadrilateral detector of ``examples/quadrilateral_detection.py``
(ResNet-18, BiFPN 128 channels over levels 3-5 with 3 layers,
QuadrilateralDetection with 5 classes, 20 targets, 256 channels) and the
classifier, the three heads of the classification and regression examples
on one trunk (ResNet-50 with level 1 frozen and no neck;
MulticlassClassification with 196 classes and label smoothing 0.1,
MultilabelClassification with 80 labels, Regression on [0, 100]; 256
channels, one layer, level 5), the dense model (ResNet-50 with level 1
frozen, FPN 128 channels over levels 3-5, SemanticSegmentation with COCO
2017 panoptic's 133 classes and void 255, and DepthEstimation on 0.1-10 m
with 256 bins, on one trunk) and the panoptic model (the same trunk and
neck, PanopticSegmentation with 53 stuff and 80 thing classes, 100 targets,
label smoothing decaying over 90,000 steps), the canonical detector of
``examples/object_detection.py`` (ResNet-50, HybridEncoder 256 channels over
levels 3-5, ObjectDetection with 80 classes, the example's multistep
schedule) and the multitask model of ``examples/multitask.py`` (ResNet-50,
FPN 128 channels over levels 3-5, ObjectDetection with 10 classes and 20
targets, TextRecognition with 30 tokens up to 12 long, DepthEstimation on
0.1-10 m and MetricLearning with 8 identities at level 2), and the
self-supervised and anomaly models of ``examples/autoencoding.py``,
``view_invariance.py`` and ``anomaly_detection.py`` (ResNet-18, no neck;
Autoencoding, ViewInvarianceLearning and AnomalyDetection at their
defaults; the anomaly model's teacher wholly frozen with its BatchNorms in
eval mode), and the keypoint model of ``examples/keypoint_detection.py``
(ResNet-18, FPN 128 channels over levels 3-5, KeypointDetection with
COCO's 17 keypoints and 10 targets at its defaults: its kernel MLP
predicts 2,737 dynamic weights an instance), and the flagship twice more:
with its neck swapped for PAN 256 wide (levels 3-7, SiLU) and its ResNet-50
pretrained, read from a torchvision-format file that the script writes from
a seed into a temporary ``TORCH_HOME`` (ImageNet normalisation in front,
level 1 frozen), and on timm's pre-activation ``resnetv2_50`` under the
flagship's FPN and head, and two detectors on inverted-residual trunks:
EfficientDet-D0's shape (a pretrained EfficientNet-B0, BiFPN 64 wide over
levels 3-7 with 3 layers, ObjectDetection with 80 classes, at 512 px) and
torchvision's MobileNetV3-large + FPN trunk under the flagship's FPN and
head, and ConvNeXt-T pretrained (read from a seeded torchvision-format file
as the PAN detector's trunk is) under the flagship's FPN and head, and a
pretrained DenseNet-121 under a 1,000-class MulticlassClassification at 224
px, and DLA-34 under the flagship's FPN and head at 512 px (CenterNet's
trunk and size) and HRNetV2-W48 under a 150-class SemanticSegmentation at
512 px (ADE20K's classes), both with random weights.  Every training step
freezes level 1 at least, so a ResNet stem runs K4.  Phases, each of which
raises on failure:

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel from the checkout's sources, all at once;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   paths give it, with CUDA-event timings of both and the least time the
   card could take for the same work (the bound); K4's and K5f's SASS must
   show tensor-core instructions in their bf16 bodies, and K5f's no
   f32 <-> bf16 conversion; K5f and K5b also at the keypoint head's decodes
   (c = 32, k = 17; 16 x 100 serving, 16 x 128 training, bf16);
4. slice: one batch of two 640 px images, f32, served on the card and on the
   CPU (where the plain versions run) with the same weights;
5. serving: three requests of 16 images at 640 px in bf16;
6. train slice: one f32 training step of two 640 px images on the card
   against an f64 step on the CPU, with the same weights: losses,
   gradients, BatchNorm statistics;
7. training: ten bf16 steps of bench.py's training step (level 1 frozen,
   targets padded to 100, AdamW, clip 0.1) on 16 images at 640 px through
   ``Trainer.training_step``;
8-11. the same four for instance segmentation: the f32 serving slice
   (scores, classes and masks against the CPU), three bf16 requests, the
   f32 training slice against f64 on the CPU, and ten bf16 steps on 16
   images at 640 px with masks (16, 100, 640, 640);
12-15. the same four for the quadrilateral detector: the f32 serving slice
   (indices, scores and quads against the CPU), three bf16 requests, the f32
   training slice against f64 on the CPU, and ten bf16 steps on 16 images at
   640 px with 5-20 quads each;
16. probes: the backbone-conv probes of ``sihl_tpu_torch.tools`` at their
   full shapes (the flagship's stage-1/2 convs at batch 16, 160 x 160): the
   1x1 conv 64 -> 256 with and without BatchNorm's sums (P4), the 1x1 weight
   gradient at three shapes (P5) and the 3x3 conv 64 -> 64 (P2); each
   probe's run holds its kernel against the plain version and the library
   call (cuDNN) and times all three; P4's, P5's and P2's kernels must show
   wgmma (HGMMA) and TMA instructions in their SASS (read with the CUDA
   toolkit's cuobjdump, which must be there); P4, P5 and P2 are timed alone
   (CUDA graphs) beside cuDNN alone and the host time of a call, and P5's
   products and its partial sums apart;
17. stem variants: the stem-variant probe P3 at the flagship's stem shape
   (16 images of 640 x 640 x 3 to (16, 320, 320, 64), bf16): the stem conv
   split into its load, stage, product and full legs, each held against its
   plain version, then timed beside K4, cuDNN's conv and the plain conv;
18. MLP pipeline: the fused-MLP pipeline probe P1 at the flagship's dense
   training shape (x (136,400, 256) bf16 through the loc and iou MLPs, 4 x
   256 -> 1, no stash) in its five modes: base (K1f itself), nops,
   mxured, pingpong and pp+mxured, each held against its plain version,
   pingpong bit for bit against base and pp+mxured against mxured, every
   mode but nops within 2e-2 of base; then timed beside the plain versions
   and the same products alone on cuBLAS;
19. validate slice: ``Trainer.validate`` of the flagship in f32 on two
   640 px images (image 1's first three targets its own top detections), on
   the card in full f32 against the CPU: the loss within relative 1e-4, the
   same metric keys, the largest mAP difference printed;
20-22. fit: for the flagship, the instance model and the quadrilateral
   detector in bf16 at batch 16, 640 px, ``Trainer.fit`` of four steps (EMA
   0.999) validating on two batches (the instance model on one) every two
   steps and saving a checkpoint every two steps; one ``validate`` that must launch the path's kernels (K1f, K2, K3;
   K1f, K2, K3, K5f; K1f, K6; and K4 on each, since level 1 is frozen) and
   no backward kernel and must leave the
   running statistics alone; the final save restored into a fresh trainer
   bitwise, the next step's loss bitwise equal there; ``use_ema_params``
   then ``predict`` bitwise a model loaded from the shadow; validate
   images/s, fit steps/s and the checkpoint's save and restore seconds
   printed beside the card's name and power limit;
23. classifier slice: the classifier in f32 on two 640 px images, on the
   card (its frozen stem through K4) and on the CPU with the same weights:
   classes and scores, the sorted multilabel scores and their labels, the
   regression values;
24. classifier serving: three bf16 requests of 16 images at 640 px, every
   head's outputs checked; K4 must launch;
25. classifier train slice: one f32 training step of two images on the card
   against an f64 step on the CPU: the three losses and their sum, the
   gradients (heads and backbone under ``GRADIENT_LIMITS``), the BatchNorm
   statistics;
26. classifier training: ten bf16 steps of 16 images through
   ``Trainer.training_step`` (class indices, multi-hot labels and values as
   targets; AdamW as above); K4 must launch;
27. classifier fit: as phases 20-22, validating with the heads' accuracy,
   multilabel counts and regression errors; the validate must launch K4
   and no backward kernel;
28. dense slice: first K3 at the dense models' FPN (128 channels, 20 -> 40
   and 40 -> 80) against its plain version; then the dense model in f32
   on two 640 px images, on the card and on the CPU: the semantic class
   maps equal but at ties of the top two probabilities, score and depth
   maps within 1e-5 relative; K4 and K3 must launch;
29. dense serving: three bf16 requests of 16 images at 640 px, every head's
   outputs checked; K4 and K3 must launch;
30. dense train slice: one f32 training step of four 256 px images
   (``SHORT_SLICE_SIZE``) on the card against an f64 step on the CPU, as
   phase 25 (the depth head's ReLUs on
   the bins' mean and on the logits among the decisions taken from the
   card);
31. dense training: five bf16 steps of 16 images (semantic classes with
   void pixels, depths with about 10% invalid) through
   ``Trainer.training_step``; K4 and K3 must launch;
32. dense fit: as phases 20-22, validating with the mean IoU, pixel
   accuracy and depth errors; the validate must launch K4 and K3 and no
   backward kernel;
33-37. the same five for the panoptic model: the f32 slice (class and
   instance-id maps equal but at explained ties), three bf16 requests
   (K1f, K5f, K3 and K4 must launch), the f32 train slice on four 256 px
   images against f64 (the step counter equal on both sides after it),
   five bf16 steps on masks (16, 100, 640, 640) (K1f, K1b, K2, K5f, K5b,
   K3 and K4 must launch), and the fit, validating with PQ on the host;
   its checkpoint carries the step counter;
38-42. the same five for the canonical detector, after K1f, K1b and K2 at
   the shapes the two new models add (``new_path_kernels``): the f32
   serving slice as phase 4 (K4 and K1f must launch), three bf16 requests,
   the f32 train slice against f64 on the CPU, ten bf16 steps (K1f, K1b,
   K2 and K4 must launch) and the fit, validating with COCO box mAP, all
   on the example's multistep schedule;
43-47. the same five for the multitask model: the f32 slice with the text
   head's dropout at 0 (detections as phase 4, text tokens equal but at
   ties of the top two logits, depths and embeddings within 1e-5; K1f, K3
   and K4 must launch), three bf16 requests, the f32 train slice against
   f64 on four 256 px images (dropout 0; the text decoder's feed-forward
   ReLUs among the decisions taken from the card), ten bf16 steps with the example's
   dropout 0.1 (K1f, K1b, K2, K3 and K4 must launch), and the fit, whose
   validations retrieve against the metric head's index of a third batch;
   its checkpoint carries the text head's dropout stream;
48-52. the same five for the autoencoder, its f32 slices at smaller sizes
   (``SSL_SERVE_SIZE``, ``SSL_TRAIN_SIZE``): the serving slice
   (reconstructions and representations within 1e-4 of the CPU's largest;
   K4 must launch), three bf16 requests, the train slice against f64 (the
   bottleneck's ReLUs among the card's decisions, the head held as the
   dense decoders), ten bf16 steps and the fit (K4 in each);
53-57. the same five for the view-invariance model at 640 px (its train
   slice on four images), each step running the trunk on both views (K4
   twice a step and a validate batch);
58-62. the same five for the anomaly model, after its teacher's
   BatchNorm statistics from a batch and ``Trainer.pretrain`` over 4
   batches (K4 once a batch): the serving slice on images with the
   example's noise patch, the train slice taking the card's top-k picks
   into the f64 step, and the fit validating on a normal and an anomalous
   batch, its restored checkpoint carrying the reservoirs, their position
   and the calibration;
63-67. the same five for the keypoint model, after K1f and K1b at its
   calls (the presence and kernel MLPs' outputs 17 and 2,737 wide, over
   1,600 and 2,048 rows, bf16 and f32; the loc MLP over 6,400 rows) and K2
   at its matching (160 x 400): the f32 serving slice (scores and presence
   against the CPU, keypoints equal wherever a heatmap is clear of a near
   tie; K4, K3, K1f and K5f must launch), three bf16 requests (K1f twice
   a request), the f32 train slice against f64, ten bf16 steps (K1f, K1b,
   K2, K3, K4, K5f and K5b must launch) and the fit, validating with PCK on
   the host;
68-72. the same five for the pretrained PAN detector, after its trunk is
   held equal to the file's tensors with ``Normalize`` in front and level 1
   frozen: the f32 serving slice as phase 4, three bf16 requests, the f32
   train slice against f64, ten bf16 steps and the fit (K1f, K3 and K4 in
   serving; K1f, K1b, K2, K3 and K4 in training; K1f, K2, K3 and K4 in the
   validate), at the flagship's kernel shapes;
73-76. the first four for the ResNetV2 detector (every pre-activation
   branch's last conv damped in the train slice), with the same kernels;
77. M16: CBAM, CrossCBAM, PadToMultipleOf, the adaptive pools, ``edges``,
   ``gaussian_blur``, the four losses and ``polygon_iou`` on CUDA tensors
   against the CPU in f32 (``m16_phase``), no kernel involved;
78-82. the same five for the EfficientDet-D0-shaped detector at 512 px,
   after K1f and K1b at its dense calls (16 x 5,456 anchors), K2 at its
   matching (1,600 x 5,456) and K6 at its fusions (64 channels on 64^2 to
   4^2 maps; ``effdet_kernels``), its trunk held equal to the file's: the
   f32 serving slice (scores within 1e-5 of the CPU's), three bf16 requests
   (K1f and K6), the f32 train slice against f64 (level 1,
   the stem and stage 0, frozen but differentiated: the net does not cut
   the gradient there), ten bf16 steps (K1f, K1b, K2, K6) and the fit;
83-86. the first four for the MobileNetV3-large detector (FPN 256 over
   levels 3-7, the flagship's kernel shapes; the train slice takes the
   card's decisions at the trunk's ReLU6, hardswish and hardsigmoid kinks
   into the f64 step);
87. M17: every MobileNet, EfficientNet and MNASNet name on the card at 64
   px in eval mode, f32, each level within 1e-5 of the same net on the CPU
   (``m17_phase``);
88-92. the same five for the ConvNeXt-T + FPN detector, its trunk held
   equal to the file's (the layer scales U(0.1, 0.5)): the f32 serving
   slice (scores within 1e-5 of the CPU's), three bf16 requests (K1f and
   K3), the f32 train slice on two 256 px images against f64 (the frozen
   patchify stem differentiated), ten bf16 steps (K1f, K1b, K2, K3) and the fit, at the
   flagship's kernel shapes;
93-96. the first four for the DenseNet-121 classifier at 224 px, its trunk
   held equal to the file's (whose ``norm5`` and classifier are skipped):
   the f32 serving slice against the CPU, three bf16 requests, the f32 train
   slice against f64 (the trunk's ReLU decisions taken from the card) and
   ten bf16 steps; no TPU kernel runs there;
97. M17, second part: every ConvNeXt v1 / v2, MobileNetV4, DenseNet and
   ShuffleNetV2 name as phase 87, and convnext_atto, convnextv2_atto,
   mobilenetv4_hybrid_medium, densenet121 and shufflenet_v2_x1_0 in train
   mode too (batch statistics; the card's f32 levels within 3e-4 of an f64
   copy's on the CPU);
98. DLA kernels: K3 at the DLA-34 detector's FPN merges at 512 px (256
   channels, 16 -> 32 and 32 -> 64) against its plain version (its K1f,
   K1b and K2 calls are EfficientDet's and the flagship's, phases 78 and 3);
99-103. the same five as phases 88-92 for the DLA-34 + FPN detector at 512
   px, random weights (the train slice takes the trunk's ReLU decisions
   from the card; K1f and K3 in serving, K1f, K1b, K2 and K3 in training);
104-107. the first four for the HRNetV2-W48 segmenter, its trunk's
   BatchNorm statistics from a batch: the f32 serving slice on two 256 px
   images (class maps equal but at ties, scores within twice the CPU's own
   f32 error against an f64 copy), three bf16 requests at 512 px, the f32
   train slice on two 256 px images against f64 (the trunk's ReLU and the
   decoder's channel-maximum decisions taken from the card, a ReLU flip as
   far from 0 as twice the CPU's own f32 step's farthest) and ten bf16
   steps at 512 px on 150-class maps; no TPU kernel runs there;
108. M17, the rest: every DLA and HRNet name as phase 87, and dla34,
   dla102 and hrnet_w18 in train mode too (dla102 within twice the CPU's
   own f32 drift where that passes 3e-4);
109. the optimizer family: every optimizer and schedule case of
   ``tests/test_torch_optim.py`` on the card (state, step counts and
   learning rates there, the update replayed from a CUDA graph) against
   the port's f64 CPU updates;
110-112. the flagship's scanned dispatch in f32 (``full_f32``, 2 images at
   640 px, K = 3): ``Trainer.training_steps_scanned`` (one CUDA graph of a
   step, replayed) against eager steps from the same state, within twice
   the distance between two eager runs of the same steps; ``predict`` and
   ``validate`` after a dispatch against a fresh model loaded from the
   trainer's state; a save after a dispatch restored into a new trainer, one
   more dispatch on both;
113. bench.py's dispatch: ``Trainer.fit(steps_per_dispatch=40)`` of the
   flagship in bf16 at batch 16, then a warm dispatch of 40 under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside it),
   timed beside eager steps of the same trainer;
114-117. the instance segmenter as 110-113, with K = 4 in bf16;
118-153. the other eighteen models (``SCANNED_MODELS``: the quad model, the
   classifier, the dense, panoptic, canonical and multitask models, the
   autoencoder, the view-invariance, anomaly and keypoint models, the PAN,
   ResNetV2, EfficientDet, MobileNetV3, ConvNeXt-T, DenseNet-121, DLA-34
   and HRNetV2-W48 models), two phases each: 110-112's f32 check at its
   model's full train-slice size (640 px for the dense, panoptic,
   multitask and ConvNeXt models too; the multitask model with its
   dropout 0.1, two replays' masks different and equal to the eager
   steps' at the same count and to the CPU's; where a backward adds
   atomically and two eager runs differ, each replay is held to
   ``ATOMIC_TWINS`` eager steps from its own state, ``forced_step``), and
   113's bf16 dispatch with K = 4 at
   batch 16, each step one CUDA graph of its kernels;
154-160. the data feed (``sihl_tpu_torch.data``), files to the card: a
   synthetic COCO set written to a temporary directory (48 PNGs at COCO's
   shapes, 1-20 objects an image over COCO's 80 category ids, polygons, an
   uncompressed RLE, a crowd annotation, a missing file); the loader alone
   and its stages' host ms; the flagship's ``fit`` through
   ``CocoDataset`` -> ``train_pipeline(640)`` -> ``batched_loader`` ->
   ``collate_detection(100)`` -> ``DevicePrefetcher``, eager and
   dispatched (the capture made while the prefetcher's worker stages a
   batch), each bitwise the same ``fit`` on batches staged beforehand;
   ``validate`` over an epoch of ``eval_pipeline(640)`` (K1f, K2, K3, K4);
   the instance segmenter's steps on masks (16, 100, 640, 640) from the
   same files (K5f, K5b); ``batch_resize_normalize`` against its numpy
   version (``data_phases()``).

The line before the last is a JSON object of per-kernel results; the last
line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sihl_tpu_torch import Backbone, SihlModel, TimmBackbone
from sihl_tpu_torch.backbones import _FEATURE_FACTORIES, hrnet
from sihl_tpu_torch.backbones.convnext import CONVNEXT_CONFIGS, GRN, ConvNeXtBlock
from sihl_tpu_torch.backbones.densenet import DENSENET_CONFIGS
from sihl_tpu_torch.backbones.dla import DLA_CONFIGS, DlaBasic, DlaBottleneck
from sihl_tpu_torch.backbones.efficientnet import EFFICIENTNET_CONFIGS
from sihl_tpu_torch.backbones.hrnet import HRNET_CONFIGS
from sihl_tpu_torch.backbones.mnasnet import MNASNET_CONFIGS
from sihl_tpu_torch.backbones.mobilenet import MOBILENET_CONFIGS, hardsigmoid, hardswish, relu6
from sihl_tpu_torch.backbones.mobilenetv4 import MOBILENETV4_CONFIGS
from sihl_tpu_torch.backbones.shufflenet import SHUFFLENET_CONFIGS
from sihl_tpu_torch.backbones.resnet import BasicBlock, Bottleneck, PreactBottleneck, ResNetFeatures
from sihl_tpu_torch.backbones.torchvision_import import dump_state_dict
from sihl_tpu_torch.data import DevicePrefetcher, batch_resize_normalize, to_device
from sihl_tpu_torch.data import augment
from sihl_tpu_torch.data.augment import eval_pipeline, train_pipeline
from sihl_tpu_torch.data.datasets import (CocoDataset, batched_loader, collate_detection,
                                          collate_instance_segmentation)
from sihl_tpu_torch.heads import (AnomalyDetection, Autoencoding, DepthEstimation, InstanceSegmentation,
                                  KeypointDetection, MetricLearning, MulticlassClassification,
                                  MultilabelClassification, ObjectDetection, PanopticSegmentation,
                                  QuadrilateralDetection, Regression, SemanticSegmentation, TextRecognition, UAFM,
                                  ViewInvarianceLearning, anchors)
from sihl_tpu_torch.heads.anomaly_detection import hard_mined
from sihl_tpu_torch.heads.semantic_segmentation import channel_max
from sihl_tpu_torch.layers import CBAM, FPN, PAN, BiFPN, CrossCBAM, HybridEncoder, PadToMultipleOf
from sihl_tpu_torch.layers.convblocks import BatchNorm2d, Conv2d, ConvNormAct, StandardConvNormAct
from sihl_tpu_torch.layers.dropout import keep_mask
from sihl_tpu_torch.layers.mlp import MLP, LayerNorm, Linear
from sihl_tpu_torch.layers.transformer import _FeedForward
from sihl_tpu_torch.ops.image import interpolate
from sihl_tpu_torch.ops import (adaptive_avg_pool, adaptive_max_pool, binary_cross_entropy, boxes, conv_probes, dynconv,
                                edges, focal_loss, fused_mlp, fusion, gaussian_blur, mlp_pipeline, ssim_loss, stem,
                                stem_variants, topk, tversky_loss)
from sihl_tpu_torch.ops.relu import relu
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.tools import (probe_conv1x1, probe_conv3x3, probe_mlp_pipeline, probe_stem_variants,
                                  probe_wrt_filter)
from sihl_tpu_torch.tools.probe_timing import card_name, cublas_products_ms, graph_ms, median_ms, within_one_bf16_step
from sihl_tpu_torch.training import Trainer, restore_checkpoint, save_checkpoint
from sihl_tpu_torch.training.trainer import _losses, _map_tree
from sihl_tpu_torch.utils import polygon_iou

# the caching allocator's segments grow in place, as a user sets them for a
# step whose eager peak nears the card's memory (``Trainer``'s docstring): a
# capture cannot hand split pieces back to the card, and the autoencoder's
# (63.5 GiB live at batch 16, 640 px) ran out of the 80 GB without it; read
# when CUDA first allocates
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

BATCH, SIZE, NUM_CLASSES, WIDTH = 16, 640, 80, 256
# anchors of levels 3-7 at 640 px: 80^2 + 40^2 + 20^2 + 10^2 + 5^2
NUM_ANCHORS = 8525
MAX_INSTANCES = 100
MAX_TARGETS, TOPK = 100, 9
LOC_BIAS_INIT = -5.0  # ObjectDetection's loc head starts at "no object"
# instance segmentation: anchors of levels 3-5 at 640 px, 80^2 + 40^2 + 20^2;
# the head's defaults (256 mask positives per image, 8 mask channels, one
# mask logit, masks at level 3)
INSTANCE_ANCHORS = 8400
MASK_POSITIVES, MASK_CHANNELS, MASK_SIZE = 256, 8, SIZE // 8
KERNEL_PARAMS = dynconv.param_count(MASK_CHANNELS, 1)
# the quadrilateral detector: 5 classes, 20 targets, BiFPN 128 wide with 3
# layers over levels 3-5 (anchors as the instance model's); its gathered
# calls run the quad (8 outputs) and class (5) MLPs over the top 100 rows
# (serving) or 20 * 9 positives (training) of each image
QUAD_CLASSES, QUAD_TARGETS, BIFPN_WIDTH, BIFPN_LAYERS = 5, 20, 128, 3
NUM_LAYERS = 4
# the classifier: the examples' three heads on one ResNet-50 trunk, no neck;
# Stanford Cars' 196 classes with label smoothing 0.1, COCO's 80 labels, and
# a value in [0, 100]
CARS_CLASSES, COCO_LABELS, VALUE_RANGE = 196, 80, (0.0, 100.0)
# the dense models: FPN 128 wide over levels 3-5 (examples/semantic_segmentation.py,
# depth_estimation.py, panoptic_segmentation.py); COCO 2017 panoptic's 53 stuff
# and 80 thing classes (133 for the semantic head), void 255; NYU-V2's depth
# bounds; panoptic smoothing decaying over 90,000 steps
DENSE_WIDTH, STUFF_CLASSES, THING_CLASSES, VOID = 128, 53, 80, 255
DEPTH_RANGE, DECAY_STEPS = (0.1, 10.0), 90_000
# the canonical detector (examples/object_detection.py:21-33): HybridEncoder 256
# wide over levels 3-5 (anchors as the instance model's), the example's
# multistep schedule
HYBRID_SCHEDULE = dict(scheduler="multistep", scheduler_kwargs={"milestones": [60_000, 80_000], "gamma": 0.1})
# the multitask model (examples/multitask.py:17-36): FPN 128 wide over levels
# 3-5; detection of 10 classes, 20 targets; text of 30 tokens, up to 12 long,
# at level 3; depth as the dense model's; 8 identities at level 2
MT_CLASSES, MT_TARGETS, MT_TOKENS, MT_LENGTH, MT_IDENTITIES = 10, 20, 30, 12, 8
# the self-supervised and anomaly models run their f32 slices against the
# CPU on smaller images: the autoencoder's decoder and the anomaly head's
# student run 256-wide 3x3 convs at the full input size, which the CPU's f64
# step takes minutes over at 640 px.  320 px for the serving slices and 160
# px for the training slices keep both resizes of each bottleneck off whole
# factors (the autoencoder's 4 x 4 and the anomaly head's 8 x 8 map against
# level 5's 10 x 10 and 5 x 5)
SSL_SERVE_SIZE, SSL_TRAIN_SIZE = 320, 160
# the dense, panoptic and multitask train slices (four images each) and the
# ConvNeXt detector's (two) run at 256 px, where the CPU's f64 step took
# about 34, 33, 28 and 23 s of their phases at 640 px: SPPM's pools
# of 1, 2 and 4 still divide level 5's 8 x 8
SHORT_SLICE_SIZE = 256
# the anomaly example's noise patch (rows and columns 30-60 at 128 px),
# scaled to 640 px; its pretraining pass takes 4 batches
ANOMALY_PATCH, PRETRAIN_BATCHES = (150, 300), 4
# the keypoint model (examples/keypoint_detection.py:12-20): FPN 128 wide over
# levels 3-5; KeypointDetection with COCO's 17 keypoints and 10 targets at its
# defaults (256 channels, 4 layers, anchors at level 5: 20 x 20 an image,
# heatmaps at level 3, 100 instances, 128 positives); its dynamic net has
# c = 32 channels, 2,737 weights an instance
KEYPOINTS, KP_TARGETS, KP_POSITIVES, KP_CHANNELS = 17, 10, 128, 32
KP_ANCHORS = (SIZE // 32) ** 2
KP_PARAMS = dynconv.param_count(KP_CHANNELS, KEYPOINTS)
# EfficientDet-D0 (Tan, Pang, Le, CVPR 2020, Table 1): an EfficientNet-B0
# trunk, BiFPN 64 wide with 3 layers over levels 3-7, 512 px input; anchors
# of levels 3-7 at 512 px, 64^2 + 32^2 + 16^2 + 8^2 + 4^2; the BiFPN's fusions
# per layer: (inputs, side of the map), each shape once a layer
EFFDET_SIZE, EFFDET_WIDTH, EFFDET_LAYERS = 512, 64, 3
EFFDET_ANCHORS = 5456
EFFDET_FUSION_SHAPES = tuple((2, EFFDET_SIZE >> lvl) for lvl in (3, 4, 5, 6)) + tuple(
    (3, EFFDET_SIZE >> lvl) for lvl in (4, 5, 6, 7))
# the DenseNet-121 classifier (Huang et al., CVPR 2017, Table 1; torchvision's
# densenet121 recipe): ImageNet's 1,000 classes at 224 px
IMAGENET_CLASSES, DENSENET_SIZE = 1000, 224
# the DLA-34 detector (Zhou, Wang, Krahenbuhl, "Objects as Points", §5: DLA-34
# on COCO at 512 x 512) under the flagship's FPN and head: anchors and K1's and
# K2's shapes as EfficientDet's, K3's merges at 16^2 -> 32^2 and 32^2 -> 64^2
DLA_SIZE = EFFDET_SIZE
# the HRNetV2-W48 segmenter (Wang et al., TPAMI 2020, §5: ADE20K's 150 classes
# at 520 x 520 crops, cut to 512 px, a multiple of 32); its f32 slices run on
# two 256 px images, which the CPU's f64 step takes minutes over at 512 px
ADE_CLASSES, HRNET_SIZE, HRNET_SLICE_SIZE = 150, 512, 256
OPTIMIZER = dict(
    optimizer="adamw",
    optimizer_kwargs={"lr": 1e-4, "weight_decay": 1e-4, "backbone_lr_factor": 0.1},
    grad_clip=0.1,
)
# the scanned dispatch: bench.py's 40 steps a dispatch (bench.py:44-46) for
# the flagship, 4 for the instance segmenter (its masks (16, 100, 640, 640)
# take 2.6 GB a batch); the f32 checks take 3 steps of 2 images, and hold
# the scanned run to twice the largest distance between eager runs, or to
# these floors where that distance is 0 (a relative loss; a parameter, a hundredth
# of the learning rate)
FLAGSHIP_DISPATCH, INSTANCE_DISPATCH, CHECK_DISPATCH, CHECK_BATCH = 40, 4, 3, 2
LOSS_FLOOR, PARAM_FLOOR = 1e-6, 1e-6
# where a backward adds atomically (a bilinear resize's, a max pool's), two
# eager runs of the check differ, and a third step's parameters can lie a
# learning rate apart now and then (an outlier among eager runs as among
# scanned ones: no bound of a few runs holds them); there the check holds
# each replay to eager steps from the replay's own state (``forced_step``),
# ``ATOMIC_TWINS`` of them, whose forward is the replay's bit for bit
ATOMIC_TWINS = 4
# every optimizer and schedule case of tests/test_torch_optim.py
OPTIMIZER_FAMILY = {
    "adamw_clipped": dict(optimizer="adamw", grad_clip=0.1,
                          optimizer_kwargs={"lr": 1e-2, "weight_decay": 0.1, "backbone_lr_factor": 0.1}),
    "adam_multistep": dict(optimizer="adam", optimizer_kwargs={"lr": 1e-2, "backbone_lr_factor": 0.5}, grad_clip=1e6,
                           scheduler="multistep", scheduler_kwargs={"milestones": [1], "gamma": 0.5, "warmup": 1}),
    "sgd": dict(optimizer="sgd", optimizer_kwargs={"lr": 1e-2, "weight_decay": 0.1, "backbone_lr_factor": 0.1}),
    "sgd_momentum_callable": dict(optimizer="sgd", optimizer_kwargs={"lr": 1e-2, "momentum": 0.9},
                                  scheduler=lambda step: 1e-2 * 0.5**step),
    "sgd_nesterov_cosine": dict(
        optimizer="sgd", optimizer_kwargs={"lr": 1e-2, "momentum": 0.9, "nesterov": True, "backbone_lr_factor": 0.5},
        scheduler="cosine", scheduler_kwargs={"T_max": 4, "eta_min": 1e-3, "warmup": 1}),
    "lamb_clipped_onecycle": dict(
        optimizer="lamb", grad_clip=0.1, optimizer_kwargs={"lr": 1e-2, "weight_decay": 0.1, "backbone_lr_factor": 0.1},
        scheduler="onecycle", scheduler_kwargs={"total_steps": 5, "max_lr": 2e-2, "warmup": 1}),
}
# H100 SXM data-sheet peaks: device memory, and dense operations by type
# (bf16 on tensor cores, f32 outside them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
SFU_OPS_PER_CLOCK = 16  # special-function unit results (ex2, rcp) a clock per SM


def build_flagship(generator: torch.Generator, device=None) -> SihlModel:
    backbone = Backbone("resnet50", top_level=5, generator=generator, device=device)
    neck = FPN(backbone.out_channels, WIDTH, bottom_level=3, top_level=7, generator=generator, device=device)
    head = ObjectDetection(
        neck.out_channels, NUM_CLASSES, bottom_level=3, top_level=7,
        max_targets=MAX_TARGETS, generator=generator, device=device,
    )
    return SihlModel(backbone, neck, [head])


def build_instance(generator: torch.Generator, device=None) -> SihlModel:
    """``examples/instance_segmentation.py``'s model at the flagship's width."""
    backbone = Backbone("resnet50", top_level=5, generator=generator, device=device)
    neck = FPN(backbone.out_channels, WIDTH, bottom_level=3, top_level=5, generator=generator, device=device)
    head = InstanceSegmentation(
        neck.out_channels, NUM_CLASSES, max_targets=MAX_TARGETS, generator=generator, device=device
    )
    return SihlModel(backbone, neck, [head])


def build_small_detector(generator: torch.Generator, device=None) -> SihlModel:
    """``tests/test_torch_optim.py``'s detector: resnet18 with level 1
    frozen, FPN 16 wide over levels 3-5, ObjectDetection with 3 classes."""
    backbone = Backbone("resnet18", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    neck = FPN(backbone.out_channels, 16, bottom_level=3, top_level=5, generator=generator, device=device)
    head = ObjectDetection(neck.out_channels, 3, bottom_level=3, top_level=5, num_channels=16, generator=generator,
                           device=device)
    return SihlModel(backbone, neck, [head])


def build_quad(generator: torch.Generator, device=None) -> SihlModel:
    """``examples/quadrilateral_detection.py``'s model: resnet18, the examples'
    default backbone (``examples/common.py:30``)."""
    backbone = Backbone("resnet18", top_level=5, generator=generator, device=device)
    neck = BiFPN(backbone.out_channels, BIFPN_WIDTH, bottom_level=3, top_level=5, num_layers=BIFPN_LAYERS,
                 generator=generator, device=device)
    head = QuadrilateralDetection(
        neck.out_channels, QUAD_CLASSES, max_targets=QUAD_TARGETS, generator=generator, device=device
    )
    return SihlModel(backbone, neck, [head])


def build_classifier(generator: torch.Generator, device=None) -> SihlModel:
    """The examples' classification heads (``examples/multiclass_classification.py``,
    ``multilabel_classification.py``, ``regression.py``) at their defaults (256
    channels, one layer, level 5) on one trunk: ResNet-50 with level 1 frozen,
    as the examples' ``--pretrained`` run freezes it (``examples/common.py``),
    and no neck."""
    backbone = Backbone("resnet50", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    c = backbone.out_channels
    heads = [
        MulticlassClassification(c, CARS_CLASSES, label_smoothing=0.1, generator=generator, device=device),
        MultilabelClassification(c, COCO_LABELS, generator=generator, device=device),
        Regression(c, *VALUE_RANGE, generator=generator, device=device),
    ]
    return SihlModel(backbone, None, heads)


def build_dense(generator: torch.Generator, device=None) -> SihlModel:
    """The dense model: semantic segmentation (COCO 2017 panoptic's 133
    classes, void 255; ``examples/semantic_segmentation.py:14-19``) and depth
    estimation (NYU-V2's 0.1-10 m; ``examples/depth_estimation.py:64-69``) on
    one trunk, as ``examples/multitask.py:22-34`` puts depth on a shared FPN:
    ResNet-50 with level 1 frozen → FPN 128 wide over levels 3-5; the heads
    at their defaults (256 channels; 3 layers and 1, 256 bins)."""
    backbone = Backbone("resnet50", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    neck = FPN(backbone.out_channels, DENSE_WIDTH, bottom_level=3, top_level=5, generator=generator, device=device)
    c = neck.out_channels
    heads = [
        SemanticSegmentation(c, STUFF_CLASSES + THING_CLASSES, ignore_index=VOID, generator=generator, device=device),
        DepthEstimation(c, *DEPTH_RANGE, generator=generator, device=device),
    ]
    return SihlModel(backbone, neck, heads)


def build_panoptic(generator: torch.Generator, device=None) -> SihlModel:
    """``examples/panoptic_segmentation.py:147-153``'s model with COCO 2017
    panoptic's 53 stuff and 80 thing classes and 100 targets: ResNet-50
    with level 1 frozen → FPN 128 wide over levels 3-5 →
    PanopticSegmentation (smoothing decaying over 90,000 steps, void 255;
    256 channels, 4 layers, masks at level 3, 100 instances)."""
    backbone = Backbone("resnet50", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    neck = FPN(backbone.out_channels, DENSE_WIDTH, bottom_level=3, top_level=5, generator=generator, device=device)
    head = PanopticSegmentation(
        neck.out_channels, STUFF_CLASSES, THING_CLASSES, max_targets=MAX_TARGETS, soft_label_decay_steps=DECAY_STEPS,
        ignore_index=VOID, generator=generator, device=device,
    )
    return SihlModel(backbone, neck, [head])


def build_hybrid(generator: torch.Generator, device=None) -> SihlModel:
    """The canonical detector (``examples/object_detection.py:21-33``, upstream's
    COCO configuration): ResNet-50 with level 1 frozen, as the example's
    ``--pretrained`` run freezes it → HybridEncoder 256 wide over levels 3-5 →
    ObjectDetection (80 classes, levels 3-5, 100 targets)."""
    backbone = Backbone("resnet50", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    neck = HybridEncoder(backbone.out_channels, WIDTH, bottom_level=3, top_level=5, generator=generator, device=device)
    head = ObjectDetection(neck.out_channels, NUM_CLASSES, bottom_level=3, top_level=5, max_targets=MAX_TARGETS,
                           generator=generator, device=device)
    return SihlModel(backbone, neck, [head])


def build_multitask(generator: torch.Generator, device=None, dropout: float = 0.1) -> SihlModel:
    """``examples/multitask.py:22-36``'s model at the 640 px ResNet-50
    protocol of the dense model: ResNet-50 with level 1 frozen → FPN 128 wide
    over levels 3-5 → ObjectDetection (10 classes, 20 targets),
    TextRecognition (30 tokens, up to 12, level 3, dropout ``dropout``, the
    example's 0.1 by default), DepthEstimation (0.1-10 m) and MetricLearning
    (8 identities, level 2), each at its defaults otherwise."""
    backbone = Backbone("resnet50", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    neck = FPN(backbone.out_channels, DENSE_WIDTH, bottom_level=3, top_level=5, generator=generator, device=device)
    c = neck.out_channels
    heads = [
        ObjectDetection(c, MT_CLASSES, max_targets=MT_TARGETS, generator=generator, device=device),
        TextRecognition(c, MT_TOKENS, MT_LENGTH, level=3, dropout=dropout, generator=generator, device=device),
        DepthEstimation(c, *DEPTH_RANGE, generator=generator, device=device),
        MetricLearning(c, MT_IDENTITIES, level=2, generator=generator, device=device),
    ]
    return SihlModel(backbone, neck, heads)


def build_multitask_still(generator: torch.Generator, device=None) -> SihlModel:
    """``build_multitask`` with the text head's dropout at 0, for the f32
    slices against the CPU: the card's and the CPU's random streams cannot
    agree."""
    return build_multitask(generator, device, dropout=0.0)


def build_autoencoder(generator: torch.Generator, device=None) -> SihlModel:
    """``examples/autoencoding.py:9-11``'s model: ResNet-18 with level 1 frozen,
    no neck, Autoencoding at its defaults (level 5, 256 channels, 3 refine
    layers, a 1,024-wide representation, a 4 x 4 pre-bottleneck, a
    sigmoid); the target is the input."""
    backbone = Backbone("resnet18", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    return SihlModel(backbone, None, [Autoencoding(backbone.out_channels, generator=generator, device=device)])


def build_view_invariance(generator: torch.Generator, device=None) -> SihlModel:
    """``examples/view_invariance.py:11-13``'s model: ResNet-18 with level 1
    frozen, no neck, ViewInvarianceLearning (Barlow Twins) at its defaults
    (a 1,024-wide embedding, level 5, 256 channels, 4 layers)."""
    backbone = Backbone("resnet18", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    head = ViewInvarianceLearning(backbone.out_channels, generator=generator, device=device)
    return SihlModel(backbone, None, [head])


def build_anomaly(generator: torch.Generator, device=None) -> SihlModel:
    """``examples/anomaly_detection.py:14-19``'s model with its ``--pretrained``
    structure: ResNet-18 with every level frozen and its BatchNorms in eval
    mode (EfficientAD's teacher, from a seed here), AnomalyDetection at its
    defaults (level 2, 256 channels, 1 layer, a 64-wide autoencoder up to
    level 5, a ring of 65,536, 1,024 samples a step)."""
    backbone = Backbone("resnet18", top_level=5, freeze_batchnorms=True, generator=generator, device=device)
    backbone.set_frozen_levels(-1)
    return SihlModel(backbone, None, [AnomalyDetection(backbone.out_channels, generator=generator, device=device)])


def build_keypoint(generator: torch.Generator, device=None) -> SihlModel:
    """``examples/keypoint_detection.py:16-21``'s model: ResNet-18 (the
    examples' default) with level 1 frozen, FPN 128 wide over levels 3-5,
    KeypointDetection with 17 keypoints and 10 targets at its defaults."""
    backbone = Backbone("resnet18", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    neck = FPN(backbone.out_channels, DENSE_WIDTH, bottom_level=3, top_level=5, generator=generator, device=device)
    head = KeypointDetection(neck.out_channels, KEYPOINTS, max_targets=KP_TARGETS, generator=generator, device=device)
    return SihlModel(backbone, neck, [head])


def build_pan(generator: torch.Generator, device=None) -> SihlModel:
    """The flagship with its neck swapped and its trunk pretrained, as the
    examples' ``--pretrained`` runs load it (``examples/common.py:60-63``):
    ResNet-50 from torchvision's cached file (``pretrained_home``), ImageNet
    normalisation in front and level 1 frozen → PAN 256 wide over levels 3-7
    (``sihl_tpu/layers/pan.py``, SiLU) → ObjectDetection (80 classes, levels
    3-7, 100 targets)."""
    backbone = Backbone("resnet50", pretrained=True, frozen_levels=1, generator=generator, device=device)
    neck = PAN(backbone.out_channels, WIDTH, bottom_level=3, top_level=7, generator=generator, device=device)
    head = ObjectDetection(neck.out_channels, NUM_CLASSES, bottom_level=3, top_level=7, max_targets=MAX_TARGETS,
                           generator=generator, device=device)
    return SihlModel(backbone, neck, [head])


def build_resnetv2(generator: torch.Generator, device=None) -> SihlModel:
    """The flagship on timm's pre-activation trunk (``TimmBackbone("resnetv2_50")``,
    ``sihl_tpu/backbones/__init__.py:150-219``), random weights, level 1
    frozen as bench.py's step freezes it → FPN 256 wide over levels 3-7 →
    ObjectDetection (80 classes, levels 3-7, 100 targets)."""
    backbone = TimmBackbone("resnetv2_50", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    neck = FPN(backbone.out_channels, WIDTH, bottom_level=3, top_level=7, generator=generator, device=device)
    head = ObjectDetection(neck.out_channels, NUM_CLASSES, bottom_level=3, top_level=7, max_targets=MAX_TARGETS,
                           generator=generator, device=device)
    return SihlModel(backbone, neck, [head])


def build_effdet(generator: torch.Generator, device=None) -> SihlModel:
    """EfficientDet-D0's shape (Tan, Pang, Le, "EfficientDet", CVPR 2020,
    Table 1): EfficientNet-B0 from torchvision's cached file
    (``pretrained_home``), ImageNet normalisation in front and level 1
    frozen → BiFPN 64 wide over levels 3-7 with 3 layers (levels 6 and 7 made
    by its downscalers) → ObjectDetection (80 classes, levels 3-7, 100
    targets), at 512 px.  The head keeps its defaults (256 channels, 4
    layers), not D0's 64-wide box net: K1's hidden width is compiled at 256
    (``ops/fused_mlp.py``, ``sihl_fused_mlp_width``), and the kernel refuses
    another."""
    backbone = Backbone("efficientnet_b0", pretrained=True, frozen_levels=1, generator=generator, device=device)
    neck = BiFPN(backbone.out_channels, EFFDET_WIDTH, bottom_level=3, top_level=7, num_layers=EFFDET_LAYERS,
                 generator=generator, device=device)
    head = ObjectDetection(neck.out_channels, NUM_CLASSES, bottom_level=3, top_level=7, max_targets=MAX_TARGETS,
                           generator=generator, device=device)
    return SihlModel(backbone, neck, [head])


def build_mnv3(generator: torch.Generator, device=None) -> SihlModel:
    """torchvision's ``fasterrcnn_mobilenet_v3_large_fpn`` trunk choice under
    the flagship's neck and head: MobileNetV3-large, random weights, level 1
    frozen → FPN 256 wide over levels 3-7 → ObjectDetection (80 classes,
    levels 3-7, 100 targets), at 640 px."""
    backbone = Backbone("mobilenet_v3_large", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    neck = FPN(backbone.out_channels, WIDTH, bottom_level=3, top_level=7, generator=generator, device=device)
    head = ObjectDetection(neck.out_channels, NUM_CLASSES, bottom_level=3, top_level=7, max_targets=MAX_TARGETS,
                           generator=generator, device=device)
    return SihlModel(backbone, neck, [head])


def build_convnext(generator: torch.Generator, device=None) -> SihlModel:
    """Liu et al., "A ConvNet for the 2020s", CVPR 2022, section 4 (COCO
    detection on an ImageNet-pretrained ConvNeXt-T with FPN), under the
    port's flagship neck and head: ConvNeXt-T from torchvision's cached file
    (``pretrained_home("convnext_tiny")``), ImageNet normalisation in front
    and level 1 frozen (the 4x4 patchify stem and its LayerNorm: no K4) →
    FPN 256 wide over levels 3-7 → ObjectDetection (80 classes, levels 3-7,
    100 targets), at 640 px."""
    backbone = Backbone("convnext_tiny", pretrained=True, frozen_levels=1, generator=generator, device=device)
    neck = FPN(backbone.out_channels, WIDTH, bottom_level=3, top_level=7, generator=generator, device=device)
    head = ObjectDetection(neck.out_channels, NUM_CLASSES, bottom_level=3, top_level=7, max_targets=MAX_TARGETS,
                           generator=generator, device=device)
    return SihlModel(backbone, neck, [head])


def build_densenet(generator: torch.Generator, device=None) -> SihlModel:
    """Huang et al., "Densely Connected Convolutional Networks", CVPR 2017,
    Table 1 (DenseNet-121 on ImageNet at 224 px), torchvision's
    ``densenet121`` recipe: DenseNet-121 from torchvision's cached file
    (``pretrained_home("densenet121")``), ImageNet normalisation in front
    and level 1 frozen → MulticlassClassification over its 1,000 classes at
    its defaults (level 5, 1,024 channels there), no neck."""
    backbone = Backbone("densenet121", pretrained=True, frozen_levels=1, generator=generator, device=device)
    head = MulticlassClassification(backbone.out_channels, IMAGENET_CLASSES, generator=generator, device=device)
    return SihlModel(backbone, None, [head])


def build_dla(generator: torch.Generator, device=None) -> SihlModel:
    """Zhou, Wang, Krahenbuhl, "Objects as Points", arXiv:1904.07850, §5
    (DLA-34 on COCO at 512 x 512, 16 images a GPU), under the port's
    flagship neck and head: DLA-34, random weights (no pretrained file
    exists for the family), level 1 frozen (``base``, ``level0``,
    ``level1``) → FPN 256 wide over levels 3-7 → ObjectDetection (80
    classes, levels 3-7, 100 targets), at 512 px."""
    backbone = Backbone("dla34", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    neck = FPN(backbone.out_channels, WIDTH, bottom_level=3, top_level=7, generator=generator, device=device)
    head = ObjectDetection(neck.out_channels, NUM_CLASSES, bottom_level=3, top_level=7, max_targets=MAX_TARGETS,
                           generator=generator, device=device)
    return SihlModel(backbone, neck, [head])


def build_hrnet(generator: torch.Generator, device=None) -> SihlModel:
    """Wang et al., "Deep High-Resolution Representation Learning for Visual
    Recognition", TPAMI 2020, §5 (HRNetV2-W48 on ADE20K: 150 classes, 520 x
    520 crops, 16 images a batch), at 512 px: HRNetV2-W48, random weights,
    level 1 frozen (``conv1``) → no neck → SemanticSegmentation over its 150
    classes (void 255) at its defaults (256 channels, 3 layers), reading
    levels 2-5 from the stride-4 branch up, as HRNetV2 does."""
    backbone = Backbone("hrnet_w48", top_level=5, generator=generator, device=device)
    backbone.set_frozen_levels(1)
    head = SemanticSegmentation(backbone.out_channels, ADE_CLASSES, bottom_level=2, top_level=5, ignore_index=VOID,
                                generator=generator, device=device)
    return SihlModel(backbone, None, [head])


def freeze_trunk(model: SihlModel) -> None:
    """Freeze the trunk as every training path here does: level 1, or every
    level of a teacher whose BatchNorms are frozen (the anomaly model)."""
    model.backbone.set_frozen_levels(-1 if model.backbone.freeze_batchnorms else 1)


def randomize_norms_and_biases(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Random BatchNorm running statistics, random affine parameters of every
    BatchNorm and LayerNorm, and random biases of every MLP Linear, so that
    no norm is the identity and every array the fused-MLP kernels read
    (hidden biases, LayerNorm scale and shift per layer) is non-trivial;
    ConvNeXt's layer scales U(0.1, 0.5) and GRN's scale and shift U(-0.5,
    0.5), where the package starts them at 1e-6 and 0 and every block would
    be the identity to six digits."""

    def fill(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm2d, LayerNorm)):
                fill(m.weight, 0.8, 1.2)
                fill(m.bias, -0.1, 0.1)
            if isinstance(m, BatchNorm2d):
                fill(m.running_mean, -0.2, 0.2)
                fill(m.running_var, 0.5, 1.5)
            if isinstance(m, Linear) and m.bias is not None:
                fill(m.bias, -0.1, 0.1)
            if isinstance(m, ConvNeXtBlock):
                fill(m.gamma, 0.1, 0.5)
            if isinstance(m, GRN):
                fill(m.gamma, -0.5, 0.5)
                fill(m.beta, -0.5, 0.5)


def damp_residual_branches(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Scale the last BatchNorm of every residual branch (``conv3.bn`` of a
    bottleneck, ``conv2.bn`` of a basic block: ResNet's, DLA's and HRNet's)
    to U(0.01, 0.03), and the
    last conv of a pre-activation branch (``conv3``) by U(0.01, 0.03), so
    that each residual block starts near the identity, as zero-init-residual
    ResNets (timm's ``zero_init_last``) do; at full scales the f32 gradients
    of these random-weight models lose most of their digits."""
    with torch.no_grad():
        for m in model.modules():
            last = {Bottleneck: "conv3", BasicBlock: "conv2", DlaBottleneck: "conv3", DlaBasic: "conv2",
                    hrnet._Bottleneck: "conv3", hrnet._BasicBlock: "conv2"}.get(type(m))
            if last is not None:
                bn = getattr(m, last).bn
                bn.weight.copy_(torch.rand(bn.weight.shape, generator=generator) * 0.02 + 0.01)
            if isinstance(m, PreactBottleneck):  # no norm ends its branch: its last conv, per output channel
                w = m.conv3.weight
                w.mul_((torch.rand(w.shape[0], generator=generator) * 0.02 + 0.01).to(w.device)[:, None, None, None])


def training_batch(batch: int, seed: int = 0, device="cuda", size: int = SIZE):
    """bench.py's images and targets (padded to 100 boxes), from a seeded
    numpy generator; images as (B, 3, size, size)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, size, size, 3).astype(np.float32)
    classes = np.full((batch, MAX_TARGETS), -1, np.int64)
    gt = np.zeros((batch, MAX_TARGETS, 4), np.float32)
    for b in range(batch):
        n = rng.randint(1, 20)
        classes[b, :n] = rng.randint(0, NUM_CLASSES, n)
        xy = rng.rand(n, 2) * (size - 64)
        wh = rng.rand(n, 2) * 128 + 8
        gt[b, :n] = np.concatenate([xy, xy + wh], axis=1)
    images = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(device)
    return images, {"classes": torch.from_numpy(classes).to(device), "boxes": torch.from_numpy(gt).to(device)}


def instance_batch(batch: int, seed: int = 0, mask_size: int = SIZE, device="cuda"):
    """Images and padded instance targets from a seeded numpy generator: per
    image 1-20 rectangles or ellipses, classes 0-79, as binary f32 masks
    (B, 100, mask_size, mask_size) drawn on ``device``."""
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.rand(batch, SIZE, SIZE, 3).astype(np.float32)).permute(0, 3, 1, 2)
    classes = np.full((batch, MAX_TARGETS), -1, np.int64)
    masks = torch.zeros(batch, MAX_TARGETS, mask_size, mask_size, device=device)
    scale = mask_size / SIZE
    for b in range(batch):
        n = rng.randint(1, 21)
        classes[b, :n] = rng.randint(0, NUM_CLASSES, n)
        for t in range(n):
            h, w = (rng.randint(SIZE // 40, SIZE // 4, 2) * scale).astype(int) + 1
            y, x = rng.randint(0, mask_size - h), rng.randint(0, mask_size - w)
            if rng.rand() < 0.5:
                masks[b, t, y : y + h, x : x + w] = 1.0
            else:
                yy = torch.arange(h, device=device)[:, None] - (h - 1) / 2
                xx = torch.arange(w, device=device)[None, :] - (w - 1) / 2
                inside = (2 * yy / h) ** 2 + (2 * xx / w) ** 2 <= 1.0
                masks[b, t, y : y + h, x : x + w] = inside.float()
    return images.contiguous().to(device), {"classes": torch.from_numpy(classes).to(device), "masks": masks}


def quad_batch(batch: int, seed: int = 0, device="cuda"):
    """Images and padded quad targets from a seeded numpy generator: per image
    5-20 convex quads, one vertex on each side of an axis-aligned box with
    integer corners and odd sides of 17-127 px (so no box centre lies midway
    between two anchor centres, and no two anchors tie for a target),
    classes 0-4, padded to 20 with -1; quads (B, 20, 4, 2) f32 in pixels."""
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.rand(batch, SIZE, SIZE, 3).astype(np.float32)).permute(0, 3, 1, 2)
    classes = np.full((batch, QUAD_TARGETS), -1, np.int64)
    quads = np.zeros((batch, QUAD_TARGETS, 4, 2), np.float32)
    for b in range(batch):
        n = rng.randint(5, QUAD_TARGETS + 1)
        classes[b, :n] = rng.randint(0, QUAD_CLASSES, n)
        for t in range(n):
            w, h = 2 * rng.randint(8, 64, 2) + 1
            x0, y0 = rng.randint(0, SIZE - w), rng.randint(0, SIZE - h)
            a, bb, c, d = rng.randint(1, min(w, h), 4)
            quads[b, t] = [[x0 + a, y0], [x0 + w, y0 + bb], [x0 + w - c, y0 + h], [x0, y0 + h - d]]
    return images.contiguous().to(device), {
        "classes": torch.from_numpy(classes).to(device), "quads": torch.from_numpy(quads).to(device),
    }


def classifier_batch(batch: int, seed: int = 0, device="cuda", size: int = SIZE, num_classes: int = CARS_CLASSES):
    """Images of ``size`` px and the classifier's three targets from a seeded
    numpy generator: class indices (B,) in [0, ``num_classes``), multi-hot
    labels (B, 80) f32 (each label on with probability 0.1) and values (B,)
    f32 in [0, 100]; a model with fewer heads reads the first targets."""
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.rand(batch, size, size, 3).astype(np.float32)).permute(0, 3, 1, 2)
    classes = torch.from_numpy(rng.randint(0, num_classes, batch))
    labels = torch.from_numpy((rng.rand(batch, COCO_LABELS) < 0.1).astype(np.float32))
    values = torch.from_numpy((rng.rand(batch) * VALUE_RANGE[1]).astype(np.float32))
    return images.contiguous().to(device), [t.to(device) for t in (classes, labels, values)]


def varied_images(rng, batch: int, size: int = SIZE) -> torch.Tensor:
    """(B, 3, size, size) f32 noise images, each with its own brightness and
    contrast, as photographs have: images of i.i.d. noise pool to nearly the
    same value at SPPM's 1 x 1 size, and the train-mode BatchNorm behind that
    pooling would see nearly equal samples, whose f32 "fast variance"
    (E[x^2] - E[x]^2) cancels (``tests/test_torch_dense_slice.py``)."""
    x = rng.rand(batch, size, size, 3) * rng.uniform(0.25, 1.0, (batch, 1, 1, 1))
    x = (x + rng.uniform(0.0, 0.75, (batch, 1, 1, 1))).astype(np.float32)
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def dense_batch(batch: int, seed: int = 0, device="cuda", size: int = SIZE,
                num_classes: int = STUFF_CLASSES + THING_CLASSES):
    """Images (``varied_images``) and the dense model's two targets from a
    seeded numpy generator: semantic classes (B, size, size) in [0,
    ``num_classes``) (COCO panoptic's 133 by default) in blocks of 32 x 32
    px, about 5% of the blocks void (255); and, as
    ``examples/depth_estimation.py:115-121`` draws them, depths (B, size,
    size) f32 of 0.1 + 9.9 x the image's mean over its channels (over 1.75,
    the largest value of ``varied_images``), with validity masks, about 10%
    of the pixels invalid (their depth 0).  A model with one head (the HRNet
    segmenter) reads the semantic classes."""
    rng = np.random.RandomState(seed)
    images = varied_images(rng, batch, size)
    blocks = rng.randint(0, num_classes, (batch, size // 32, size // 32))
    blocks[rng.rand(*blocks.shape) < 0.05] = VOID
    semantic = torch.from_numpy(blocks.repeat(32, axis=1).repeat(32, axis=2))
    depth = images.mean(dim=1) / 1.75 * 9.9 + DEPTH_RANGE[0]
    masks = torch.from_numpy(rng.rand(batch, size, size) > 0.1)
    depth = torch.where(masks, depth, 0.0)
    return images.to(device), [semantic.to(device), {"targets": depth.to(device), "masks": masks.to(device)}]


def panoptic_batch(batch: int, seed: int = 0, mask_size: int = 0, device="cuda", size: int = SIZE):
    """Images (``varied_images``) and panoptic targets from a seeded numpy
    generator: a semantic map (B, size, size) of stuff classes in [0, 53) in
    blocks of 32 x 32 px (about 5% void, 255) under 1-20 things per image
    (rectangles or ellipses, later ones on top, thing classes 53-132), and
    the things' padded targets as ``panoptic_targets_from_maps`` makes them
    from an instance-id map: classes (B, 100) in [0, 80), -1 padded, and
    binary f32 masks (B, 100, mask_size, mask_size) of the visible part of
    each (every ``size // mask_size``-th pixel; at the image's size by
    default), drawn on ``device``."""
    rng = np.random.RandomState(seed)
    images = varied_images(rng, batch, size)
    blocks = rng.randint(0, STUFF_CLASSES, (batch, size // 32, size // 32))
    blocks[rng.rand(*blocks.shape) < 0.05] = VOID
    semantic = torch.from_numpy(blocks.repeat(32, axis=1).repeat(32, axis=2)).to(device)
    ids = torch.zeros(batch, size, size, dtype=torch.int64, device=device)
    classes = np.full((batch, MAX_TARGETS), -1, np.int64)
    for b in range(batch):
        n = rng.randint(1, 21)
        classes[b, :n] = rng.randint(0, THING_CLASSES, n)
        for t in range(n):
            h, w = rng.randint(size // 40, size // 4, 2) + 1
            y, x = rng.randint(0, size - h), rng.randint(0, size - w)
            inside = torch.ones(h, w, dtype=torch.bool, device=device)
            if rng.rand() >= 0.5:
                yy = torch.arange(h, device=device)[:, None] - (h - 1) / 2
                xx = torch.arange(w, device=device)[None, :] - (w - 1) / 2
                inside = (2 * yy / h) ** 2 + (2 * xx / w) ** 2 <= 1.0
            ids[b, y : y + h, x : x + w] = torch.where(inside, t + 1, ids[b, y : y + h, x : x + w])
            semantic[b, y : y + h, x : x + w] = torch.where(
                inside, STUFF_CLASSES + int(classes[b, t]), semantic[b, y : y + h, x : x + w])
    step = size // (mask_size or size)
    slots = torch.arange(1, MAX_TARGETS + 1, device=device)[None, :, None, None]
    masks = (ids[:, None, ::step, ::step] == slots).float()
    classes = torch.from_numpy(classes).to(device)
    classes = torch.where((ids[:, None] == slots).flatten(2).any(dim=2), classes, -1)
    return images.to(device), {"semantic": semantic, "classes": classes, "masks": masks}


def multitask_batch(batch: int, seed: int = 0, device="cuda", size: int = SIZE):
    """Images (``varied_images``: the text head's train-mode BatchNorm runs on
    each image's mean over the pixels) and the multitask model's four
    targets from a seeded numpy generator, as ``examples/multitask.py:39-61``
    draws them: 1-20 boxes an image (bench.py's sizes, classes 0-9, padded
    to 20), texts of 1-11 tokens in [0, 30) padded with 30 to 12, depths of
    0.1 + 9.9 x the image's mean over its channels (over 1.75) with about 10%
    of the pixels invalid, and identities in [0, 8)."""
    rng = np.random.RandomState(seed)
    images = varied_images(rng, batch, size)
    classes = np.full((batch, MT_TARGETS), -1, np.int64)
    gt = np.zeros((batch, MT_TARGETS, 4), np.float32)
    texts = np.full((batch, MT_LENGTH), MT_TOKENS, np.int64)
    for b in range(batch):
        n = rng.randint(1, MT_TARGETS + 1)
        classes[b, :n] = rng.randint(0, MT_CLASSES, n)
        xy = rng.rand(n, 2) * (size - 64)
        wh = rng.rand(n, 2) * 128 + 8
        gt[b, :n] = np.concatenate([xy, xy + wh], axis=1)
        length = rng.randint(1, MT_LENGTH)
        texts[b, :length] = rng.randint(0, MT_TOKENS, length)
    depth = images.mean(dim=1) / 1.75 * 9.9 + DEPTH_RANGE[0]
    masks = torch.from_numpy(rng.rand(batch, size, size) > 0.1)
    depth = torch.where(masks, depth, 0.0)
    ids = torch.from_numpy(rng.randint(0, MT_IDENTITIES, batch))
    det = {"classes": torch.from_numpy(classes).to(device), "boxes": torch.from_numpy(gt).to(device)}
    return images.to(device), [det, torch.from_numpy(texts).to(device),
                               {"targets": depth.to(device), "masks": masks.to(device)}, ids.to(device)]


def autoencoder_batch(batch: int, seed: int = 0, size: int = SIZE, device="cuda"):
    """Images (``varied_images``) from a seeded numpy generator, and the same
    images as the target."""
    images = varied_images(np.random.RandomState(seed), batch, size).to(device)
    return images, images


def view_batch(batch: int, seed: int = 0, size: int = SIZE, device="cuda"):
    """Images (``varied_images``) and their second view as
    ``examples/view_invariance.py:35-40`` makes it: the batch scaled in
    brightness by U(0.8, 1.2), plus noise of standard deviation 0.05,
    clipped to [0, 1]."""
    rng = np.random.RandomState(seed)
    images = varied_images(rng, batch, size)
    view = torch.clamp(images * (0.8 + 0.4 * rng.rand()) + torch.from_numpy(
        rng.randn(batch, size, size, 3).astype(np.float32)).permute(0, 3, 1, 2) * 0.05, 0, 1)
    return images.to(device), view.contiguous().to(device)


def anomaly_batch(batch: int, seed: int = 0, anomalous: bool = False, size: int = SIZE, device="cuda"):
    """Images (``varied_images``) and the (B, H, W) anomaly mask the example
    validates with (``examples/anomaly_detection.py:38-43``): all 0 for a
    normal batch; all 1 for an anomalous one, whose images get the example's
    patch of uniform noise (rows and columns ``ANOMALY_PATCH``, scaled with
    ``size``)."""
    rng = np.random.RandomState(seed)
    images = varied_images(rng, batch, size)
    if anomalous:
        lo, hi = (v * size // SIZE for v in ANOMALY_PATCH)
        images[:, :, lo:hi, lo:hi] = torch.from_numpy(rng.rand(batch, 3, hi - lo, hi - lo).astype(np.float32))
    mask = torch.full((batch, size, size), float(anomalous))
    return images.to(device), mask.to(device)


def keypoint_batch(batch: int, seed: int = 0, device="cuda"):
    """Images and padded keypoint targets from a seeded numpy generator,
    after the example's synthetic data (``examples/keypoint_detection.py:58-70``)
    scaled from 128 to 640 px: per image 1-3 people, each 17 keypoints about
    a centre (spread 50 px), each visible with probability 0.7.  Keypoints
    are whole pixels, at least two visible, the visible box of positive
    width and height with odd sums of opposite edges (its centre on a half
    pixel, never midway between two anchor centres, so no two anchors tie
    for a target's best IoU); keypoints (B, 10, 17, 2) f32 in pixels,
    presence (B, 10, 17) bool."""
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.rand(batch, SIZE, SIZE, 3).astype(np.float32)).permute(0, 3, 1, 2)
    keypoints = np.zeros((batch, KP_TARGETS, KEYPOINTS, 2), np.float32)
    presence = np.zeros((batch, KP_TARGETS, KEYPOINTS), bool)
    for b in range(batch):
        for t in range(rng.randint(1, 4)):
            while True:
                center = rng.rand(1, 2) * (SIZE - 320) + 160
                kp = np.clip(np.round(center + rng.randn(KEYPOINTS, 2) * 50), 0, SIZE - 1)
                vis = rng.rand(KEYPOINTS) > 0.3
                if vis.sum() < 2:
                    continue
                low, high = kp[vis].min(axis=0), kp[vis].max(axis=0)
                if (high > low).all() and ((low + high) % 2 == 1).all():
                    break
            keypoints[b, t], presence[b, t] = kp, vis
    return images.contiguous().to(device), {
        "keypoints": torch.from_numpy(keypoints).to(device), "presence": torch.from_numpy(presence).to(device),
    }


def bound(num_bytes: float, ops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate for their type, whichever is longer."""
    t_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def mlp_work(m: int, outs, dtype: torch.dtype, passes: int) -> tuple:
    """(bytes, operations) of the MLPs of one fused call over m rows: x read
    and, in the backward (passes = 3), dx written and the output cotangents
    read; outputs or cotangents of width n_out; every weight read once (and
    its f32 gradient written in the backward)."""
    es = torch.finfo(dtype).bits // 8
    weights = sum(NUM_LAYERS * WIDTH * WIDTH + WIDTH * n for n in outs)
    num_bytes = m * WIDTH * es * (2 if passes == 3 else 1) + sum(m * n * es for n in outs)
    num_bytes += weights * es + (weights * 4 if passes == 3 else 0)
    ops = sum(2 * passes * m * WIDTH * (NUM_LAYERS * WIDTH + n) for n in outs)
    return num_bytes, ops


def random_mlps(outs, dtype, gen):
    with compute_dtype_scope(dtype):
        mlps = [MLP(WIDTH, [WIDTH] * NUM_LAYERS + [n], generator=gen) for n in outs]
    for m in mlps:
        randomize_norms_and_biases(m, gen)
    return mlps


def mlp_grads(fn, x, mlps, weights):
    """The outputs of fn(x, mlps), and dx and every parameter's gradient of
    sum_i sum(fn(x, mlps)[i] * w_i)."""
    x = x.detach().requires_grad_(True)
    for p in (p for m in mlps for p in m.parameters()):
        p.grad = None
    outputs = fn(x, mlps)
    loss = sum((o.float() * w).sum() for o, w in zip(outputs, weights))
    loss.backward()
    return [o.detach() for o in outputs], [x.grad] + [p.grad for m in mlps for p in m.parameters()]


def k1f_case(gen, cuda_gen, label, m, outs, dtype, atol, rtol) -> dict:
    """K1f over m rows against the plain chain, eval MLPs, no gradient.
    ``ms`` is the kernel alone (a CUDA graph of 20 calls over packed
    weights); ``call_ms`` the call as a request makes it (the pack cache is
    warm, so it packs nothing)."""
    mlps = [mlp.eval() for mlp in random_mlps(outs, dtype, gen)]
    x = torch.randn(m, WIDTH, device="cuda", generator=cuda_gen).to(dtype)
    with torch.no_grad():
        got = fused_mlp.fused_mlps(x, mlps)
        want = fused_mlp.fused_mlps_reference(x, mlps)
        torch.cuda.synchronize()
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)
        packs = [fused_mlp.pack_mlp_params(mlp, dtype) for mlp in mlps]
        ms = graph_ms(lambda: fused_mlp._forward_cuda(x, packs))
        call_ms = median_ms(lambda: fused_mlp.fused_mlps(x, mlps))
        plain_ms = median_ms(lambda: fused_mlp.fused_mlps_reference(x, mlps))
    cublas_ms = cublas_products_ms(m, outs, dtype, backward=False)
    case = dict(path=dtype == torch.bfloat16, label=label, err=err, ms=ms, call_ms=call_ms, cublas_ms=cublas_ms,
                plain_ms=plain_ms, **bound(*mlp_work(m, outs, dtype, 1), dtype))
    print(f"  K1f fused_mlp {label} {tuple(x.shape)} {dtype}, outputs {outs}: max_abs_err {err:.3g} "
          f"(atol {atol}, rtol {rtol}); kernel alone {ms:.4f} ms, call {call_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {case['bound_ms']:.4f} ms; yardstick: the same products alone on cuBLAS {cublas_ms:.4f} ms")
    return case


def k1_train_case(gen, cuda_gen, label, m, outs, dtype, tol, f_atol, f_rtol):
    """K1f's forward and K1b over m rows against the plain chain and its
    autograd, with gradients; returns the forward's and the backward's case.
    Each is timed as the kernel alone (a CUDA graph of 20 calls over packed
    weights; the forward writing the stash its backward reads) and as the
    call a training step makes: the forward packing the weights (as after an
    optimizer step), the backward through autograd."""
    mlps = random_mlps(outs, dtype, gen)
    x = torch.randn(m, WIDTH, device="cuda", generator=cuda_gen).to(dtype)
    weights = [torch.randn(m, n, device="cuda", generator=cuda_gen) for n in outs]
    got_out, got = mlp_grads(fused_mlp.fused_mlps, x, mlps, weights)
    want_out, want = mlp_grads(fused_mlp.fused_mlps_reference, x, mlps, weights)
    torch.cuda.synchronize()
    out_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got_out, want_out))
    for g, w in zip(got_out, want_out):
        torch.testing.assert_close(g.float(), w.float(), atol=f_atol, rtol=f_rtol)
    packs = [fused_mlp.pack_mlp_params(mlp, dtype) for mlp in mlps]
    stash = fused_mlp.stash_for(x, packs)

    def packed_call():
        fused_mlp._PACKS.clear()
        return fused_mlp.fused_mlps(x, mlps)

    with torch.no_grad():
        ms = graph_ms(lambda: fused_mlp._forward_cuda(x, packs, stash))
        plain_ms = median_ms(lambda: fused_mlp.fused_mlps_reference(x, mlps))
    call_ms = median_ms(packed_call)
    cublas_ms = cublas_products_ms(m, outs, dtype, backward=False)
    fwd = dict(path=dtype == torch.bfloat16, label=label, err=out_err, ms=ms, call_ms=call_ms, cublas_ms=cublas_ms,
               plain_ms=plain_ms, **bound(*mlp_work(m, outs, dtype, 1), dtype))
    print(f"  K1f fused_mlp {label} {tuple(x.shape)} {dtype}, outputs {outs}: max_abs_err "
          f"{out_err:.3g} (atol {f_atol}, rtol {f_rtol}); kernel alone {ms:.4f} ms, call (packing included) "
          f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {fwd['bound_ms']:.4f} ms; yardstick: the same "
          f"products alone on cuBLAS {cublas_ms:.4f} ms")

    err = float((got[0].float() - want[0].float()).abs().max())
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
    param_err = max(float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got[1:], want[1:]))
    if param_err > tol:
        raise AssertionError(f"K1b {label} {dtype}: parameter gradient error {param_err} of the largest")
    gs = [w.to(dtype) for w in weights]
    xr = x.detach().requires_grad_(True)
    inputs = [xr] + [p for mlp in mlps for p in mlp.parameters()]
    outputs = fused_mlp.fused_mlps(xr, mlps)
    ms = graph_ms(lambda: fused_mlp.fused_mlps_backward(x, packs, gs, stash))
    call_ms = median_ms(lambda: torch.autograd.grad(outputs, inputs, gs, retain_graph=True))
    outputs = fused_mlp.fused_mlps_reference(xr, mlps)
    plain_ms = median_ms(lambda: torch.autograd.grad(outputs, inputs, gs, retain_graph=True))
    del outputs
    cublas_ms = cublas_products_ms(m, outs, dtype, backward=True)
    bwd = dict(path=dtype == torch.bfloat16, label=label, err=err, ms=ms, call_ms=call_ms, cublas_ms=cublas_ms,
               plain_ms=plain_ms, **bound(*mlp_work(m, outs, dtype, 3), dtype))
    print(f"  K1b fused_mlp_backward {label} {tuple(x.shape)} {dtype}, outputs {outs}: dx "
          f"max_abs_err {err:.3g} (atol = rtol = {tol}); parameter gradients' largest error "
          f"{param_err:.3g} of their largest magnitude (bound {tol}); kernel alone {ms:.4f} ms, call "
          f"(autograd through the kernel) {call_ms:.4f} ms, plain (autograd of the chain) {plain_ms:.4f} ms, "
          f"bound {bwd['bound_ms']:.4f} ms; yardstick: the chain's products alone on cuBLAS {cublas_ms:.4f} ms")
    return fwd, bwd


def k2_case(label, work) -> dict:
    """K2 on a (G, A) matrix of anchor-gt IoUs, bitwise against its plain
    version; timed a call and alone (a CUDA graph of 20 calls)."""
    best, kth = topk.row_best_and_kth(work, TOPK)
    want_best, want_kth = topk._row_reference(work, TOPK)
    if not (torch.equal(best, want_best) and torch.equal(kth, want_kth)):
        raise AssertionError(f"row_best_and_kth {label} is not bitwise equal to its plain version")
    ms = median_ms(lambda: topk.row_best_and_kth(work, TOPK))
    alone_ms = graph_ms(lambda: topk.row_best_and_kth(work, TOPK))
    plain_ms = median_ms(lambda: topk._row_reference(work, TOPK))
    g, a = work.shape
    case = dict(path=True, err=0.0, ms=ms, alone_ms=alone_ms, plain_ms=plain_ms,
                **bound(g * a * 4 + 2 * g * 4, 2 * TOPK * g * a, torch.float32))
    print(f"  K2 row_best_and_kth {label} {tuple(work.shape)} k={TOPK}: bitwise equal; kernel {ms:.4f} ms a call "
          f"({alone_ms:.4f} alone, device time from a CUDA graph of 20 calls), plain {plain_ms:.4f} ms, bound "
          f"{case['bound_ms']:.4f} ms")
    return case


def anchor_ious(levels, gt_boxes, classes, size: int = SIZE) -> torch.Tensor:
    """The (B * G, A) matrix of clamped anchor-gt CIoUs that matching hands K2."""
    head_levels = [torch.empty(1, 1, size >> lvl, size >> lvl, device="cuda") for lvl in range(max(levels) + 1)]
    offsets, scales = anchors.cell_anchors(head_levels, levels)
    full = torch.tensor([size] * 4, dtype=torch.float32, device="cuda")
    ious = torch.clamp(boxes.complete_box_iou((offsets + scales) * full, gt_boxes), min=0)
    ious = torch.where((classes >= 0)[:, None, :], ious, 0.0)
    return ious.transpose(1, 2).reshape(-1, offsets.shape[0]).contiguous()


def check_kernels(gen: torch.Generator, cuda_gen: torch.Generator, train_targets) -> dict:
    """Phase 3, flagship shapes: each kernel against its plain version,
    timed; ``path`` marks the cases the bf16 serving or training path runs."""
    results = {"fused_mlp": [], "fused_mlp@train": [], "fused_mlp_backward": [], "row_kth": [], "upsample_add": []}

    # K1f at the serving shapes: loc dense over every anchor, cls + box over the top 100
    for dtype, atol, rtol in ((torch.bfloat16, 5e-2, 5e-2), (torch.float32, 1e-3, 0.0)):
        for label, m, outs in (("dense", BATCH * NUM_ANCHORS, (1,)), ("gathered", BATCH * MAX_INSTANCES, (NUM_CLASSES, 4))):
            results["fused_mlp"].append(k1f_case(gen, cuda_gen, label, m, outs, dtype, atol, rtol))

    # K1b at the training shapes, and K1f's forward there: loc + iou dense
    # over every anchor, cls + box over the 900 positives of each image
    for dtype, tol, (f_atol, f_rtol) in ((torch.bfloat16, 1e-1, (5e-2, 5e-2)), (torch.float32, 1e-3, (1e-3, 0.0))):
        for label, m, outs in (
            ("dense", BATCH * NUM_ANCHORS, (1, 1)),
            ("gathered", BATCH * MAX_TARGETS * TOPK, (NUM_CLASSES, 4)),
        ):
            fwd, bwd = k1_train_case(gen, cuda_gen, label, m, outs, dtype, tol, f_atol, f_rtol)
            results["fused_mlp@train"].append(fwd)
            results["fused_mlp_backward"].append(bwd)

    # K2 on the training batch's anchor-gt IoUs: (16 * 100, 8525), k = 9
    work = anchor_ious(range(3, 8), train_targets["boxes"], train_targets["classes"])
    results["row_kth"].append(k2_case("levels 3-7", work))

    # K3: the two top-down merges of the FPN at 640 px: level 5 into 4, level 4 into 3
    results["upsample_add"] = k3_cases(cuda_gen, WIDTH)
    return results


def k3_cases(cuda_gen, width: int, size: int = SIZE) -> list:
    """K3 at the two top-down merges of an FPN ``width`` channels wide at
    ``size`` px (level 5 into 4, level 4 into 3), bf16, bitwise against its
    plain version; device times from CUDA graphs."""
    cases = []
    for h in (size // 32, size // 16):
        cl = torch.channels_last
        top = torch.randn(BATCH, width, h, h, device="cuda", generator=cuda_gen)
        lateral = torch.randn(BATCH, width, 2 * h, 2 * h, device="cuda", generator=cuda_gen)
        top, lateral = (t.to(torch.bfloat16).contiguous(memory_format=cl) for t in (top, lateral))
        with torch.no_grad():
            got = fusion.fused_upsample_add(top, lateral)
            want = fusion.fused_upsample_add_reference(top, lateral)
            if not torch.equal(got, want):
                raise AssertionError(f"upsample_add at {width} channels, h={h} is not bitwise equal to its plain version")
            ms = graph_ms(lambda: fusion.fused_upsample_add(top, lateral))
            plain_ms = graph_ms(lambda: fusion.fused_upsample_add_reference(top, lateral))
        cases.append(dict(
            path=True, err=0.0, ms=ms, plain_ms=plain_ms,
            **bound((top.numel() + 2 * lateral.numel()) * 2, lateral.numel(), torch.bfloat16),
        ))
        print(f"  K3 upsample_add top {tuple(top.shape)} bf16: bitwise equal; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (device times, CUDA graphs), bound {cases[-1]['bound_ms']:.4f} ms")
    return cases


def decode_inputs(cuda_gen, batch, instances, c, k, dtype):
    """Random decode inputs on the card: (B, c, 80, 80) channels_last
    features, the mask grid, centres and dynamic weights in ``dtype``."""
    feats = torch.randn(batch, MASK_SIZE, MASK_SIZE, c, device="cuda", generator=cuda_gen)
    grid = torch.rand(MASK_SIZE, MASK_SIZE, 2, device="cuda", generator=cuda_gen)
    centers = torch.rand(batch, instances, 2, device="cuda", generator=cuda_gen)
    dyn = torch.randn(batch, instances, dynconv.param_count(c, k), device="cuda", generator=cuda_gen) * 0.3
    return (feats * 0.5).to(dtype).permute(0, 3, 1, 2), grid, centers, dyn.to(dtype)


def decode_work(batch, instances, c, k, dtype, backward: bool):
    """(bytes, f32 operations, exponentials) of one decode call: features,
    weights, grid and centres read once; logits written (forward) or their
    cotangent read and the two gradients written (backward).  Per
    pixel-instance the forward does (c + 2) c + c c + c k multiply-adds and
    2 c exponentials; the backward recomputes it, backpropagates (c k + 2 c c),
    and forms the weight gradients (as many products as the forward, and
    2 c + k bias sums)."""
    es = torch.finfo(dtype).bits // 8
    s, p = MASK_SIZE * MASK_SIZE, dynconv.param_count(c, k)
    num_bytes = batch * s * c * es + batch * instances * p * es + s * 2 * 4 + batch * instances * 2 * 4
    num_bytes += batch * instances * s * k * 4
    fwd_macs = (c + 2) * c + c * c + c * k
    macs = fwd_macs + (c * k + 2 * c * c + fwd_macs + 2 * c + k if backward else 0)
    if backward:
        num_bytes += batch * s * c * es + batch * instances * p * es
    pixels = batch * instances * s
    return num_bytes, 2 * macs * pixels, 2 * c * pixels


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def k5f_bound(batch, instances, c, k, dtype) -> dict:
    """K5f's least time.  f32 inputs run the FMA body: bytes or f32 FMAs
    (``decode_work``).  bf16 inputs run the tensor-core body: the largest of
    its bytes at 3.35 TB/s; its SiLUs' special-function operations (an
    exponential and a reciprocal each, 4c per pixel-instance) at SMs x 16 a
    clock x the maximum SM clock; and its tensor-core products at 989
    TFLOP/s, layer 1 once, layer 2 (and layer 3 at k > 1) three times for the
    three bf16 parts of its f32 input.  ``old_bound_ms`` is the f32-FMA
    figure, the yardstick before the tensor-core body."""
    num_bytes, ops, exps = decode_work(batch, instances, c, k, dtype, backward=False)
    old = bound(num_bytes, ops, torch.float32)
    if dtype != torch.bfloat16:
        return dict(old, old_bound_ms=old["bound_ms"], terms="")
    pixels = batch * instances * MASK_SIZE * MASK_SIZE
    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    t_sfu = 2 * exps / (sms * SFU_OPS_PER_CLOCK * clock) * 1e3
    products = 2 * pixels * (c * c + 3 * c * c + (3 * c * k if k > 1 else 0))
    t_mma = products / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    terms = (f"max of bytes {t_bytes:.4f} ({num_bytes / 1e6:.1f} MB at 3.35 TB/s), SFU {t_sfu:.4f} "
             f"({2 * exps / 1e6:.0f} M ex2 + rcp at {sms} SMs x {SFU_OPS_PER_CLOCK} x {clock / 1e9:.3f} GHz), "
             f"tensor cores {t_mma:.4f} ({products / 1e9:.2f} GFLOP at 989 TFLOP/s)")
    return dict(bound_ms=max(t_bytes, t_sfu, t_mma), bound_by="bytes" if t_bytes >= max(t_sfu, t_mma) else "operations",
                old_bound_ms=old["bound_ms"], terms=terms)


def check_decode_sass() -> None:
    """K5f's tensor-core body (decode_fwd_mma_kernel<C, ONE_OUT>, its four
    instances) must show mma.sync (HMMA) and no f32 <-> bf16 conversion
    (F2F, F2FP) anywhere in its SASS, its loops included; without
    cuobjdump (the CUDA toolkit's), the check fails."""
    counts = sass_counts(dynconv._library()._name)
    if not counts:
        raise AssertionError("dynconv SASS: cuobjdump not found, so K5f's SASS cannot be read")
    kernels = {k: n for k, n in counts.items() if "decode_fwd_mma_kernel" in k}
    if len(kernels) != 4:
        raise AssertionError(f"dynconv SASS: expected four instances of decode_fwd_mma_kernel, found {sorted(kernels)}")
    for k, n in sorted(kernels.items()):
        print(f"  K5f SASS (cuobjdump) {k}: HMMA {n['HMMA']}, MUFU {n['MUFU']}, F2F {n['F2F']}, F2FP {n['F2FP']}")
        if n["HMMA"] == 0 or n["F2F"] or n["F2FP"]:
            raise AssertionError(f"dynconv: {k} shows no HMMA, or a conversion instruction, in its SASS")


def k5f_case(cuda_gen, label, batch, instances, c, k, dtype, path: bool = True) -> dict:
    """K5f against the plain einsum chain on the same inputs, f32 logits
    within atol = rtol = 1e-4 (tests/ops/test_dynconv.py holds the Pallas
    kernel so); timed a call and alone (a CUDA graph of 20 calls)."""
    args = decode_inputs(cuda_gen, batch, instances, c, k, dtype)
    with torch.no_grad():
        got = dynconv.dynamic_pointwise_decode(*args, c, k)
        want = dynconv.reference_decode(*args, c, k)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        ms = median_ms(lambda: dynconv.dynamic_pointwise_decode(*args, c, k))
        alone_ms = graph_ms(lambda: dynconv.dynamic_pointwise_decode(*args, c, k))
        plain_ms = median_ms(lambda: dynconv.reference_decode(*args, c, k))
    lower = k5f_bound(batch, instances, c, k, dtype)
    terms = lower.pop("terms")
    old_bound_ms = lower.pop("old_bound_ms")
    case = dict(path=path, err=err, ms=ms, alone_ms=alone_ms, plain_ms=plain_ms, **lower)
    print(f"  K5f dynconv_decode {label} {batch}x{instances} instances at {MASK_SIZE}x{MASK_SIZE}, c={c}, "
          f"k={k}, {dtype} inputs: max_abs_err {err:.3g} (atol = rtol = 1e-4); kernel {ms:.4f} ms a call "
          f"({alone_ms:.4f} alone, device time from a CUDA graph of 20 calls), plain {plain_ms:.4f} ms, bound "
          f"{case['bound_ms']:.4f} ms ({case['bound_by']}{'; ' + terms if terms else ''}); old f32-FMA "
          f"yardstick {old_bound_ms:.4f} ms")
    return case


def k5b_case(cuda_gen, label, batch, instances, c, k, dtype, path: bool = True) -> dict:
    """K5b's d(features) and d(weights) against autograd of the plain chain,
    within atol = rtol = 2e-3 (tests/ops/test_dynconv.py's gradient bound);
    bf16 gradients also within one bf16 step (at most 2^-7 relative), since
    both sides round their f32 sums to bf16 and a sum near a rounding
    boundary may round either way.  Two calls are bitwise equal."""
    mf, grid, centers, dyn = decode_inputs(cuda_gen, batch, instances, c, k, dtype)
    gout = torch.randn(batch, instances, MASK_SIZE, MASK_SIZE, k, device="cuda", generator=cuda_gen)
    got = dynconv.dynamic_pointwise_decode_backward(mf, grid, centers, dyn, gout, c, k)
    again = dynconv.dynamic_pointwise_decode_backward(mf, grid, centers, dyn, gout, c, k)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K5b {label}: two calls differ")
    inputs = [mf.detach().requires_grad_(True), dyn.detach().requires_grad_(True)]
    outputs = dynconv.reference_decode(inputs[0], grid, centers, inputs[1], c, k)
    want = torch.autograd.grad(outputs, inputs, gout, retain_graph=True)
    torch.cuda.synchronize()
    rtol = 2e-3 + (2**-7 if dtype == torch.bfloat16 else 0.0)
    err = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == dtype
        err = max(err, float((g.float() - w.float()).abs().max()))
        torch.testing.assert_close(g.float(), w.float(), atol=2e-3, rtol=rtol)

    def call():
        return dynconv.dynamic_pointwise_decode_backward(mf, grid, centers, dyn, gout, c, k)

    ms = median_ms(call)
    alone_ms = graph_ms(call)
    plain_ms = median_ms(lambda: torch.autograd.grad(outputs, inputs, gout, retain_graph=True))
    del outputs
    num_bytes, ops, exps = decode_work(batch, instances, c, k, dtype, backward=True)
    case = dict(path=path, err=err, ms=ms, alone_ms=alone_ms, plain_ms=plain_ms, **bound(num_bytes, ops, torch.float32))
    print(f"  K5b dynconv_decode_backward {label} {batch}x{instances} instances at {MASK_SIZE}x{MASK_SIZE}, "
          f"c={c}, k={k}, {dtype} inputs: d(features) and d(weights) max_abs_err {err:.3g} (atol 2e-3, "
          f"rtol {rtol:.3g}); two calls bitwise equal; kernel {ms:.4f} ms a call ({alone_ms:.4f} alone, device "
          f"time from a CUDA graph of 20 calls), plain (autograd of the chain) {plain_ms:.4f} ms, bound "
          f"{case['bound_ms']:.4f} ms ({case['bound_by']}: {num_bytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP f32, "
          f"{exps / 1e6:.0f} M exponentials beside them)")
    return case


def k5b_cases(cuda_gen) -> dict:
    """K5b at the instance training path's decode (bf16 and f32 inputs) and
    at the keypoint head's (c = 32, k = 17): its training path's bf16
    decode of 16 x 128 positives, and f32 inputs at 16 x 100 (off the
    paths, kept as the yardstick of the f32 body)."""
    results = {"dynconv_decode_backward": [
        k5b_case(cuda_gen, "training", BATCH, MASK_POSITIVES, MASK_CHANNELS, 1, dtype, path=dtype == torch.bfloat16)
        for dtype in (torch.bfloat16, torch.float32)
    ]}
    results["dynconv_decode_backward@keypoint"] = [
        k5b_case(cuda_gen, "keypoint training", BATCH, KP_POSITIVES, KP_CHANNELS, KEYPOINTS, torch.bfloat16),
        k5b_case(cuda_gen, "keypoint", BATCH, MAX_INSTANCES, KP_CHANNELS, KEYPOINTS, torch.float32, path=False)]
    return results


def k5f_k2_cases(cuda_gen) -> None:
    """K2 at the detector's and the instance model's matchings (1,600 x
    8,525 and 1,600 x 8,400) and K5f at the instance path's decodes (serving
    16 x 100, training 16 x 256) and the keypoint path's (c = 32, k = 17,
    16 x 100 and 16 x 128), bf16, each held against its plain version and timed a call and alone.
    With another tree's package first on the path (run from that tree,
    loading this file by path), times that tree's kernels the same way."""
    _, targets = training_batch(BATCH)
    for levels in (range(3, 8), range(3, 6)):
        work = anchor_ious(levels, targets["boxes"], targets["classes"])
        k2_case(f"levels {levels.start}-{levels.stop - 1}", work)
    for label, instances, c, k in (("serving", MAX_INSTANCES, MASK_CHANNELS, 1),
                                   ("training", MASK_POSITIVES, MASK_CHANNELS, 1),
                                   ("keypoint serving", MAX_INSTANCES, KP_CHANNELS, KEYPOINTS),
                                   ("keypoint training", KP_POSITIVES, KP_CHANNELS, KEYPOINTS)):
        k5f_case(cuda_gen, label, BATCH, instances, c, k, torch.bfloat16)


def check_instance_kernels(gen: torch.Generator, cuda_gen: torch.Generator, train_targets) -> dict:
    """Phase 3, instance-segmentation shapes: K1f and K1b at the head's calls,
    K2 at its matching, K5f and K5b at its decodes and at the keypoint
    head's (c = 32, k = 17: serving 16 x 100, training 16 x 128)."""
    results = {key: [] for key in (
        "fused_mlp@instance_serve", "fused_mlp@instance_train", "fused_mlp_backward@instance_train",
        "row_kth@instance_train", "dynconv_decode", "dynconv_decode@train", "dynconv_decode_backward",
        "dynconv_decode@keypoint_serve", "dynconv_decode@keypoint_train", "dynconv_decode_backward@keypoint",
    )}
    dense = BATCH * INSTANCE_ANCHORS
    # serving: loc dense over every anchor, cls + kernel over the top 100
    for label, m, outs in (("dense", dense, (1,)), ("gathered", BATCH * MAX_INSTANCES, (NUM_CLASSES, KERNEL_PARAMS))):
        results["fused_mlp@instance_serve"].append(k1f_case(gen, cuda_gen, label, m, outs, torch.bfloat16, 5e-2, 5e-2))
    # training: loc dense over every anchor, cls + kernel over the 256 mask positives
    for dtype, tol, (f_atol, f_rtol) in ((torch.bfloat16, 1e-1, (5e-2, 5e-2)), (torch.float32, 1e-3, (1e-3, 0.0))):
        cases = [("gathered", BATCH * MASK_POSITIVES, (NUM_CLASSES, KERNEL_PARAMS))]
        if dtype == torch.bfloat16:
            cases.insert(0, ("dense", dense, (1,)))
        for label, m, outs in cases:
            fwd, bwd = k1_train_case(gen, cuda_gen, label, m, outs, dtype, tol, f_atol, f_rtol)
            results["fused_mlp@instance_train"].append(fwd)
            results["fused_mlp_backward@instance_train"].append(bwd)
    work = anchor_ious(range(3, 6), train_targets["boxes"], train_targets["classes"])
    results["row_kth@instance_train"].append(k2_case("levels 3-5", work))
    c, bf16 = MASK_CHANNELS, torch.bfloat16
    check_decode_sass()
    results["dynconv_decode"].append(k5f_case(cuda_gen, "serving", BATCH, MAX_INSTANCES, c, 1, bf16))
    results["dynconv_decode@train"].append(k5f_case(cuda_gen, "training", BATCH, MASK_POSITIVES, c, 1, bf16))
    results["dynconv_decode@keypoint_serve"].append(
        k5f_case(cuda_gen, "keypoint serving", BATCH, MAX_INSTANCES, KP_CHANNELS, KEYPOINTS, bf16))
    results["dynconv_decode@keypoint_train"].append(
        k5f_case(cuda_gen, "keypoint training", BATCH, KP_POSITIVES, KP_CHANNELS, KEYPOINTS, bf16))
    results.update(k5b_cases(cuda_gen))
    return results


# BiFPN's fusions at 640 px, per layer: (inputs, side of the map)
FUSION_SHAPES = ((2, SIZE // 16), (2, SIZE // 8), (3, SIZE // 16), (3, SIZE // 32))


def k6_cases(cuda_gen, width: int = BIFPN_WIDTH, shapes=FUSION_SHAPES) -> dict:
    """K6 against its plain version at a BiFPN's fusion shapes (batch 16,
    ``width`` channels; by default the quad detector's four at 128), bf16 and
    f32: the forward bitwise or within one bf16 step (f32 within 1e-6 of the
    largest magnitude), the backward (plain PyTorch on both sides: the
    Function's and autograd's of the plain version) within 1e-6 relative;
    each layer of the request runs each shape once."""
    results = {"weighted_sum@serve": [], "weighted_sum@train": []}
    cl = torch.channels_last
    for dtype in (torch.bfloat16, torch.float32):
        for n, side in shapes:
            xs = [torch.randn(BATCH, width, side, side, device="cuda", generator=cuda_gen)
                  .to(dtype).contiguous(memory_format=cl) for _ in range(n)]
            w = torch.softmax(torch.randn(n, device="cuda", generator=cuda_gen), dim=0)
            with torch.no_grad():
                got = fusion.fused_weighted_sum(w, xs)
                want = fusion.fused_weighted_sum_reference(w, xs)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                bitwise = torch.equal(got, want)
                ok = within_one_bf16_step(got, want) if dtype == torch.bfloat16 else err <= 1e-6 * float(want.abs().max())
                if not ok:
                    raise AssertionError(f"weighted_sum N={n} at {side}x{side} {dtype}: error {err}")
                ms = graph_ms(lambda: fusion.fused_weighted_sum(w, xs))
                plain_ms = graph_ms(lambda: fusion.fused_weighted_sum_reference(w, xs))
                host_ms = median_ms(lambda: fusion.fused_weighted_sum(w, xs))
            # backward: the Function's plain backward against autograd of the plain version
            g = torch.randn(xs[0].shape, device="cuda", generator=cuda_gen).to(dtype).contiguous(memory_format=cl)
            grads = []
            for fn in (fusion.fused_weighted_sum, fusion.fused_weighted_sum_reference):
                leaves = [w.detach().requires_grad_(True)] + [x.detach().requires_grad_(True) for x in xs]
                fn(leaves[0], leaves[1:]).backward(g)
                grads.append([t.grad for t in leaves])
            for a, b in zip(*grads):
                if relative_error(a, b) > 1e-6:
                    raise AssertionError(f"weighted_sum backward N={n} {dtype}: relative error {relative_error(a, b)}")
            es = torch.finfo(dtype).bits // 8
            numel = xs[0].numel()
            case = dict(path=dtype == torch.bfloat16, err=err, ms=ms, plain_ms=plain_ms,
                        **bound((n + 1) * numel * es + n * 4, 2 * n * numel, dtype))
            results["weighted_sum@serve"].append(case)
            results["weighted_sum@train"].append(case)
            print(f"  K6 weighted_sum N={n} {tuple(xs[0].shape)} {dtype}: {'bitwise equal' if bitwise else 'max_abs_err'} "
                  f"{'' if bitwise else f'{err:.3g}'}; backward within 1e-6 of autograd of the plain version; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (device times, CUDA graphs), bound "
                  f"{case['bound_ms']:.4f} ms ({case['bound_by']}); one call timed alone {host_ms:.4f} ms (its launch)")
    return results


# mma.sync, wgmma, TMA load / store, bulk copy, special-function unit, f32 <-> bf16 conversions
SASS_OPCODES = ("HMMA", "HGMMA", "UTMALDG", "UTMASTG", "UBLKCP", "MUFU", "F2F", "F2FP")


def sass_counts(library: str) -> dict:
    """Tensor-core (HMMA, HGMMA), TMA (UTMALDG, UTMASTG, UBLKCP),
    special-function (MUFU) and conversion (F2F, F2FP) instructions in each
    kernel of a built library, by its mangled name:
    ``{kernel: {opcode: count}}`` from ``cuobjdump -sass``; empty without
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not shutil.which(tool):
        return {}
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True, check=True, timeout=300).stdout
    opcode = re.compile(r"\b(" + "|".join(SASS_OPCODES) + r")\b")
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            counts[kernel] = dict.fromkeys(SASS_OPCODES, 0)
        elif kernel and (found := opcode.search(line)):
            counts[kernel][found.group(1)] += 1
    return counts


def k4_cases(cuda_gen) -> dict:
    """K4 against its plain version (an f32 conv of the rounded operands,
    rounded once, then the sums) on every training path's stem call,
    (16, 3, 640, 640) -> (16, 64, 320, 320): y within 1e-4 of the largest
    magnitude in f32, and in bf16 within one bf16 step plus the most two f32
    sums of the same 147 products can differ by (2 * 147 * 2^-24 times the
    sum of their magnitudes); both sums within 1e-5 of the sums of |y| and y^2 (the plain
    version's on its own y, and K4's own y summed by PyTorch); two calls
    bitwise equal.  The bf16 call runs K4's tensor-core body, the f32 call
    its f32 FMA body; the built library's SASS must show HMMA in the
    former.  cuDNN's conv alone is timed for information: no single call
    computes the statistics too."""
    results = {"stem_conv_stats": []}
    counts = sass_counts(stem._library()._name)
    if counts:
        mma = sum(n["HMMA"] for k, n in counts.items() if "stem_conv_stats_mma_kernelILi3E" in k)
        fma = sum(n["HMMA"] for k, n in counts.items() if "stem_conv_stats_kernelIfE" in k)
        print(f"  K4 SASS (cuobjdump): {mma} HMMA in the bf16 body at 3 channels "
              f"(stem_conv_stats_mma_kernel<3>), {fma} in the f32 body (stem_conv_stats_kernel<float>)")
        if mma == 0:
            raise AssertionError("stem_conv_stats: the bf16 body's SASS has no tensor-core instruction")
    else:
        print("  K4 SASS: cuobjdump not found, not read")
    x32 = torch.rand(BATCH, SIZE, SIZE, 3, device="cuda", generator=cuda_gen).permute(0, 3, 1, 2)
    weight = torch.randn(64, 3, 7, 7, device="cuda", generator=cuda_gen) * (1 / 147) ** 0.5
    for dtype in (torch.bfloat16, torch.float32):
        x = x32.to(dtype)
        assert x.is_contiguous(memory_format=torch.channels_last)
        got = stem.stem_conv_stats(x, weight)
        again = stem.stem_conv_stats(x, weight)
        want = stem.stem_conv_stats_reference(x, weight)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"stem_conv_stats {dtype}: two calls differ")
        y, s, q = got
        err = float((y.float() - want[0].float()).abs().max())
        scale = float(want[0].float().abs().max())
        if dtype == torch.bfloat16:
            n = 49 * x.shape[1]
            magnitudes = torch.nn.functional.conv2d(x.float().abs(), weight.to(dtype).float().abs(), stride=2, padding=3)
            if not within_one_bf16_step(y, want[0], 2 * n * 2.0**-24 * magnitudes):
                raise AssertionError(f"stem_conv_stats bf16: y beyond one bf16 step and the f32 sums' spread "
                                     f"(max error {err})")
        if dtype == torch.float32 and err > 1e-4 * scale:
            raise AssertionError(f"stem_conv_stats f32: y error {err} of the largest {scale}")
        yf = y.float()
        own = (yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3)))
        norms = (yf.abs().sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3)))
        sum_err = max(float(((a - b).abs() / n).max()) for a, b, n in zip((s, q), want[1:], norms))
        own_err = max(float(((a - b).abs() / n).max()) for a, b, n in zip((s, q), own, norms))
        if max(sum_err, own_err) > 1e-5:
            raise AssertionError(f"stem_conv_stats {dtype}: sums off by {sum_err} (plain) / {own_err} (own y)")
        ms = median_ms(lambda: stem.stem_conv_stats(x, weight))
        alone_ms = graph_ms(lambda: stem.stem_conv_stats(x, weight))
        plain_ms = median_ms(lambda: stem.stem_conv_stats_reference(x, weight))
        w_dt = weight.to(dtype)
        conv_ms = median_ms(lambda: torch.nn.functional.conv2d(x, w_dt, stride=2, padding=3))
        es = torch.finfo(dtype).bits // 8
        macs = y.numel() * 49 * 3
        case = dict(path=dtype == torch.bfloat16, err=err, ms=ms, alone_ms=alone_ms, plain_ms=plain_ms,
                    **bound((x.numel() + y.numel()) * es + 2 * 64 * 4, 2 * macs, dtype))
        results["stem_conv_stats"].append(case)
        body = "tensor-core body (bf16 mma.sync)" if dtype == torch.bfloat16 else "f32 FMA body"
        print(f"  K4 stem_conv_stats {tuple(x.shape)} -> {tuple(y.shape)} {dtype}, {body}: y max_abs_err {err:.3g} "
              f"(largest {scale:.3g}); sums within {sum_err:.3g} of the plain version's and {own_err:.3g} of its "
              f"own y's; two calls bitwise equal; kernel {ms:.4f} ms a call ({alone_ms:.4f} alone, device time from a "
              f"CUDA graph of 20 calls), plain (f32 conv, rounding, sums) {plain_ms:.4f} "
              f"ms, cuDNN's {dtype} conv alone {conv_ms:.4f} ms; bound {case['bound_ms']:.4f} ms ({case['bound_by']}; "
              f"{2 * macs / PEAK_OPS_PER_S[dtype] * 1e3:.4f} ms of operations at the {body}'s peak rate)")
    return results


def check_quad_kernels(gen: torch.Generator, cuda_gen: torch.Generator, instance_kernels: dict) -> dict:
    """Phase 3, the quadrilateral detector's shapes: K6 and K4, and K1f/K1b
    at the head's gathered calls, quad + class MLPs (8, 5) over 1,600 rows
    (serving) and 2,880 (training).  Its dense loc call (134,400 rows, one
    output) is the instance model's, checked there; its cases are shared."""
    results = k6_cases(cuda_gen)
    results.update(k4_cases(cuda_gen))
    dense_serve = [c for c in instance_kernels["fused_mlp@instance_serve"] if c["label"] == "dense"]
    dense_train = [i for i, c in enumerate(instance_kernels["fused_mlp@instance_train"]) if c["label"] == "dense"]
    results["fused_mlp@quad_serve"] = dense_serve + [
        k1f_case(gen, cuda_gen, "gathered", BATCH * MAX_INSTANCES, (8, QUAD_CLASSES), torch.bfloat16, 5e-2, 5e-2)]
    results["fused_mlp@quad_train"] = [instance_kernels["fused_mlp@instance_train"][i] for i in dense_train]
    results["fused_mlp_backward@quad_train"] = [instance_kernels["fused_mlp_backward@instance_train"][i] for i in dense_train]
    for dtype, tol, (f_atol, f_rtol) in ((torch.bfloat16, 1e-1, (5e-2, 5e-2)), (torch.float32, 1e-3, (1e-3, 0.0))):
        fwd, bwd = k1_train_case(gen, cuda_gen, "gathered", BATCH * QUAD_TARGETS * TOPK, (8, QUAD_CLASSES),
                                 dtype, tol, f_atol, f_rtol)
        results["fused_mlp@quad_train"].append(fwd)
        results["fused_mlp_backward@quad_train"].append(bwd)
    return results


def anchor_features(head, feats) -> torch.Tensor:
    """A detection-family head's (B, A, C) per-anchor features."""
    return head.get_features(feats) if isinstance(head, QuadrilateralDetection) else head.flat_features(feats)


def detect_with_indices(model: SihlModel, images: torch.Tensor):
    """The head's outputs and its top-k anchor indices, from one backbone and
    neck pass (the indices come from the loc branch run a second time)."""
    head = model.heads[0]
    feats = model.extract_features(images)
    flat = anchor_features(head, feats)
    (loc,) = anchors.run_mlps(flat, [head.loc_head], num_valid=flat.shape[1])
    order = torch.sort(loc[..., 0].float(), dim=1, descending=True, stable=True)[1]
    return [t.cpu() for t in head(feats)], order[:, :MAX_INSTANCES].cpu()


def set_loc_bias(model: SihlModel, images: torch.Tensor, head=None, live: int = 50) -> float:
    """Set the loc head's final bias (of ``head``, by default the model's
    first) midway between the ``live``-th and the next largest loc logits of
    the first image, so that ``live`` of its top-100 slots (about half, by
    default) score above 0.5 and no logit sits on that line; returns the
    bias."""
    head = model.heads[0] if head is None else head
    bias = head.loc_head.linears[-1].bias
    with torch.no_grad():
        bias.zero_()
        flat = anchor_features(head, model.extract_features(images[:1]))
        (loc,) = anchors.run_mlps(flat, [head.loc_head], num_valid=flat.shape[1])
        top = torch.sort(loc[0, :, 0].float(), descending=True)[0]
        bias.fill_(-float(top[live - 1] + top[live]) / 2)
    return float(bias)


def check_slice(model: SihlModel, gen: torch.Generator, label: str = "slice", kernels=(), size: int = SIZE,
                score_tol: float = 1e-3) -> None:
    """Phases 4 and 38: the f32 serving slice of a detector on two images of
    ``size`` px on the card against the CPU (plain versions), scores within
    ``score_tol``; every kernel in ``kernels`` must launch on the card."""
    images = torch.rand(2, 3, size, size, generator=gen)
    with torch.no_grad():
        loc_bias = set_loc_bias(model, images.cuda())
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        (c_num, c_scores, c_classes, c_boxes), c_idx = detect_with_indices(cpu_model, images)
        t_cpu = time.perf_counter() - t0
        reset_counts()
        (num, scores, classes, boxes_), idx = detect_with_indices(model, images.cuda())
        launches = read_counts(kernels)
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"the {label} forward launched {launches}")
    agree = idx == c_idx
    share = float(agree.float().mean())
    box_err = float((boxes_ - c_boxes).abs().amax(dim=2)[agree].max())
    score_err = float((scores - c_scores).abs().max())
    score_rel_err = float(((scores - c_scores).abs() / c_scores.abs()).max())
    print(f"  {label} f32, 2 images at {size} px, loc bias {loc_bias:.4f}: num_instances card "
          f"{num.tolist()} cpu {c_num.tolist()}; top-k indices agree in {share:.4f} of slots; "
          f"max box err {box_err:.3g} px; max score err {score_err:.3g} (relative "
          f"{score_rel_err:.3g}); CPU forward {t_cpu:.1f} s" + (f"; kernel launches {launches}" if launches else ""))
    if not 0 < int(c_num.sum()) < 2 * MAX_INSTANCES:
        raise AssertionError(f"num_instances {c_num.tolist()} leave nothing to compare")
    if not torch.equal(num, c_num):
        raise AssertionError("num_instances differ between card and CPU")
    if share < 0.98:
        raise AssertionError(f"top-k indices agree in only {share:.4f} of slots")
    if not torch.equal(classes[agree], c_classes[agree]):
        raise AssertionError("classes differ in slots whose indices agree")
    if box_err > 0.5 or score_err > score_tol or score_rel_err > 1e-3:
        raise AssertionError(
            f"box err {box_err} px, score err {score_err} or relative score err "
            f"{score_rel_err} out of bounds"
        )


def expected_shape(shape, size: int = SIZE) -> tuple:
    """A head's ``output_shapes`` entry at batch 16 and ``size`` px."""
    sizes = {"batch_size": BATCH, "height": size, "width": size}
    return tuple(sizes[d.split("/")[0]] // int(d.split("/")[1]) if isinstance(d, str) and "/" in d
                 else sizes.get(d, d) for d in shape)


def check_instance_slice(model: SihlModel, gen: torch.Generator) -> None:
    """Phase 8: the f32 instance-segmentation serving slice on the card
    against the CPU (plain versions): num_instances equal, top-100 indices
    agreeing in >= 98% of slots, and in those slots classes equal, scores
    and mask probabilities within 1e-3."""
    images = torch.rand(2, 3, SIZE, SIZE, generator=gen)
    with torch.no_grad():
        loc_bias = set_loc_bias(model, images.cuda())
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        (c_num, c_scores, c_classes, c_masks), c_idx = detect_with_indices(cpu_model, images)
        t_cpu = time.perf_counter() - t0
        (num, scores, classes, masks), idx = detect_with_indices(model, images.cuda())
    agree = idx == c_idx
    share = float(agree.float().mean())
    score_err = float((scores - c_scores).abs()[agree].max())
    mask_err = float((masks - c_masks).abs().amax(dim=(2, 3))[agree].max())
    print(f"  instance slice f32, 2 images at {SIZE} px, loc bias {loc_bias:.4f}: num_instances card "
          f"{num.tolist()} cpu {c_num.tolist()}; top-k indices agree in {share:.4f} of slots; max score "
          f"err {score_err:.3g}; max mask err {mask_err:.3g} over masks {tuple(masks.shape)}; CPU forward "
          f"{t_cpu:.1f} s")
    if not 0 < int(c_num.sum()) < 2 * MAX_INSTANCES:
        raise AssertionError(f"num_instances {c_num.tolist()} leave nothing to compare")
    if not torch.equal(num, c_num):
        raise AssertionError("num_instances differ between card and CPU")
    if share < 0.98:
        raise AssertionError(f"top-k indices agree in only {share:.4f} of slots")
    if not torch.equal(classes[agree], c_classes[agree]):
        raise AssertionError("classes differ in slots whose indices agree")
    if score_err > 1e-3 or mask_err > 1e-3:
        raise AssertionError(f"score err {score_err} or mask err {mask_err} out of bounds")


def check_quad_slice(model: SihlModel, gen: torch.Generator) -> None:
    """Phase 12: the f32 quadrilateral serving slice on the card against the
    CPU (plain versions): num_instances and classes equal, the same top-100
    indices in every slot, scores within 1e-5, quads within 1e-2 px."""
    images = torch.rand(2, 3, SIZE, SIZE, generator=gen)
    with torch.no_grad():
        loc_bias = set_loc_bias(model, images.cuda())
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        (c_num, c_scores, c_classes, c_quads), c_idx = detect_with_indices(cpu_model, images)
        t_cpu = time.perf_counter() - t0
        (num, scores, classes, quads), idx = detect_with_indices(model, images.cuda())
    score_err = float((scores - c_scores).abs().max())
    quad_err = float((quads - c_quads).abs().max())
    print(f"  quad slice f32, 2 images at {SIZE} px, loc bias {loc_bias:.4f}: num_instances card "
          f"{num.tolist()} cpu {c_num.tolist()}; top-k indices agree in "
          f"{float((idx == c_idx).float().mean()):.4f} of slots; max score err {score_err:.3g}; max quad err "
          f"{quad_err:.3g} px; CPU forward {t_cpu:.1f} s")
    if not 0 < int(c_num.sum()) < 2 * MAX_INSTANCES:
        raise AssertionError(f"num_instances {c_num.tolist()} leave nothing to compare")
    if not (torch.equal(num, c_num) and torch.equal(idx, c_idx) and torch.equal(classes, c_classes)):
        raise AssertionError("num_instances, top-k indices or classes differ between card and CPU")
    if score_err > 1e-5 or quad_err > 1e-2:
        raise AssertionError(f"score err {score_err} or quad err {quad_err} px out of bounds")


def check_outputs(head, outputs, size: int = SIZE) -> None:
    """One head's outputs at batch 16 and ``size`` px: the shapes ``output_shapes``
    gives, finite, class, label, instance and token ids in range,
    probabilities in [0, 1] (a text head's scores are logits), keypoints
    inside the image, multilabel
    scores in descending order, values and depths within the head's bounds,
    embeddings of unit length."""
    named = dict(zip(head.output_shapes, outputs if isinstance(outputs, (tuple, list)) else (outputs,)))
    for name, shape in head.output_shapes.items():
        if tuple(named[name].shape) != expected_shape(shape, size):
            raise AssertionError(f"{name}: shape {tuple(named[name].shape)}, expected {expected_shape(shape, size)}")
        if named[name].is_floating_point() and not torch.isfinite(named[name]).all():
            raise AssertionError(f"non-finite {name}")
    panoptic = isinstance(head, PanopticSegmentation)
    counts = {
        "classes": head.num_thing_classes if panoptic else getattr(head, "num_classes", None),
        "labels": getattr(head, "num_labels", None),
        "class_maps": head.num_stuff_classes + head.num_thing_classes if panoptic else getattr(head, "num_classes", None),
        "instance_maps": getattr(head, "max_instances", 0) + 1,
    }
    if isinstance(head, TextRecognition):  # its scores are each position's largest logit
        counts["tokens"] = head.num_tokens + 1
        named.pop("scores")
    for name, count in counts.items():
        if name in named and not ((0 <= named[name]).all() and (named[name] < count).all()):
            raise AssertionError(f"{name} out of [0, {count})")
    for name in ("masks", "scores", "score_maps", "reconstructions", "anomaly_maps", "presence"):
        if name in named and not ((0 <= named[name]).all() and (named[name] <= 1).all()):
            raise AssertionError(f"{name} out of [0, 1]")
    if "keypoints" in named and not ((0 <= named["keypoints"]).all() and (named["keypoints"] <= size).all()):
        raise AssertionError(f"keypoints out of [0, {size}]")
    if "embeddings" in named and ((named["embeddings"].norm(dim=1) - 1).abs() > 1e-5).any():
        raise AssertionError("embeddings not of unit length")
    if "labels" in named and (named["scores"][:, 1:] > named["scores"][:, :-1]).any():
        raise AssertionError("multilabel scores out of descending order")
    for name in ("values", "depth_maps"):
        if name in named and not ((head.lower_bound <= named[name]).all()
                                  and (named[name] <= head.upper_bound).all()):
            raise AssertionError(f"{name} out of the head's bounds")


def check_classifier_slice(model: SihlModel, gen: torch.Generator, size: int = SIZE, label: str = "classifier slice",
                           stem_launches: int = 1) -> None:
    """Phases 23 and 93: the f32 classifier on two ``size`` px images, on the
    card (a frozen ResNet stem through K4's f32 body, ``stem_launches`` times)
    and on the CPU (the plain versions) with the same weights, head by head:
    the multiclass classes equal and scores within 1e-4 relative; the
    multilabel scores, sorted, within 1e-4 relative and their label orders
    agreeing in at least 98% of slots (two labels whose scores lie within
    rounding of each other may swap); the regression values within 1e-4
    relative."""
    images = torch.rand(2, 3, size, size, generator=gen)
    with torch.no_grad():
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        want = cpu_model(images)
        t_cpu = time.perf_counter() - t0
        reset_counts()
        got = [[t.cpu() for t in out] if isinstance(out, tuple) else out.cpu() for out in model(images.cuda())]
        k4 = read_counts(("stem_conv_stats",))["stem_conv_stats"]

    def rel(got, want):
        return float(((got - want).abs() / want.abs()).max())

    errors, outputs, rows, share, same_classes = {}, {}, [], 1.0, True
    for head, g, w in zip(model.heads, got, want):
        if isinstance(head, MulticlassClassification):
            (scores, classes), (c_scores, c_classes) = g, w
            errors["scores"], outputs["scores"] = rel(scores, c_scores), scores
            same_classes = torch.equal(classes, c_classes)
            rows.append(f"classes card {classes.tolist()} cpu {c_classes.tolist()}")
        elif isinstance(head, MultilabelClassification):
            (ml_scores, labels), (c_ml_scores, c_labels) = g, w
            errors["multilabel scores"], outputs["multilabel scores"] = rel(ml_scores, c_ml_scores), ml_scores
            share = float((labels == c_labels).float().mean())
            rows.append(f"multilabel orders agree in {share:.4f} of slots")
        else:
            errors["values"], outputs["values"] = rel(g, w), g
            rows.append(f"values card {g.tolist()} cpu {w.tolist()}")
    print(f"  {label} f32, 2 images at {size} px: " + "; ".join(rows) + f"; largest relative errors "
          f"{({k: f'{v:.3g}' for k, v in errors.items()})}; K4 launches {k4}; CPU forward {t_cpu:.1f} s")
    for name, out in outputs.items():
        if not torch.isfinite(out).all():
            raise AssertionError(f"non-finite {name}")
    if k4 != stem_launches:
        raise AssertionError(f"the frozen stem launched K4 {k4} times, expected {stem_launches}")
    if not same_classes or share < 0.98:
        raise AssertionError(f"classes differ, or multilabel orders agree in only {share:.4f} of slots")
    if max(errors.values()) > 1e-4:
        raise AssertionError(f"relative errors {errors} out of bounds")


def top_two_gap(logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W) gap between each pixel's two largest f32 class probabilities
    (over dim 1 of ``logits``), relative to the largest."""
    top = torch.softmax(logits.float(), dim=1).topk(2, dim=1).values
    return (top[:, 0] - top[:, 1]) / top[:, 0]


DENSE_SLICE_LAUNCHES = {"stem_conv_stats": 1, "upsample_add": 2}


def check_dense_slice(model: SihlModel, gen: torch.Generator, size: int = SIZE, label: str = "dense slice",
                      launches_expected=DENSE_SLICE_LAUNCHES, build=None) -> None:
    """Phases 28 and 104: the f32 dense model (or the HRNet segmenter, its
    one head semantic) on two ``size`` px images, on the card (the dense
    model's frozen stem through K4, the FPN's merges through K3: the
    launches ``launches_expected``) and on the CPU (the plain versions) with
    the same weights: the semantic class maps equal, but where the CPU's two
    largest probabilities of a pixel lie within 1e-5 of each other
    (relative; a tie in f32), which must be under 1e-3 of the pixels; the
    score maps (where the classes agree) and any depth maps within 1e-5
    relative.  With ``build``, an f64 copy on the CPU (``build``'s model in
    f64) measures the CPU's own f32 error on the score maps, and where
    twice that passes 1e-5 it takes 1e-5's place, as the bound of the score
    maps and of a tie: HRNetV2-W48's 300 f32 convs keep fewer digits than
    the dense model's trunk."""
    images = varied_images(np.random.RandomState(int(torch.randint(2**31, (1,), generator=gen))), 2, size)
    with torch.no_grad():
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        c_feats = cpu_model.extract_features(images)
        (c_scores, c_classes), *c_depth = (head(c_feats) for head in cpu_model.heads)
        gap = top_two_gap(cpu_model.heads[0].get_logits(c_feats))
        t_cpu = time.perf_counter() - t0
        score_tol, drift = 1e-5, None
        if build is not None:
            with compute_dtype_scope(torch.float64):
                ref = build(torch.Generator().manual_seed(0), device="cpu")
            ref.load_state_dict(cpu_model.state_dict())
            r_scores, r_classes = ref.eval()(images.double())[0]
            same = r_classes == c_classes
            drift = float(((c_scores.double() - r_scores).abs() / r_scores)[same].max())
            score_tol = max(score_tol, 2 * drift)
            del ref
        reset_counts()
        (scores, classes), *depth = model(images.cuda())
        launches = read_counts(DENSE_SLICE_LAUNCHES)
    scores, classes, depth = scores.cpu(), classes.cpu(), [d.cpu() for d in depth]
    tie = F.interpolate(gap[:, None], size=(size, size), mode="nearest")[:, 0] <= score_tol
    differ = classes != c_classes
    agree = ~differ
    score_err = float(((scores - c_scores).abs() / c_scores)[agree].max())
    depth_err = max((float(((d - c).abs() / c).max()) for d, c in zip(depth, c_depth)), default=0.0)
    print(f"  {label} f32, 2 images at {size} px: semantic classes differ at {int(differ.sum())} of "
          f"{differ.numel()} pixels, {int((differ & ~tie).sum())} of them outside a tie of the top two "
          f"probabilities (relative {score_tol:.3g}; ties at {int(tie.sum())} pixels); score maps' largest "
          f"relative error "
          f"{score_err:.3g}" + (f" (the CPU's own f32 against f64 {drift:.3g}; bound {score_tol:.3g})"
                                if drift is not None else "")
          + "".join(f"; depth maps' {depth_err:.3g} (depths {float(c.min()):.3f}-{float(c.max()):.3f} m)"
                    for c in c_depth)
          + f"; kernel launches {launches}; CPU forward {t_cpu:.1f} s")
    if not (torch.isfinite(scores).all() and all(torch.isfinite(d).all() for d in depth)):
        raise AssertionError("non-finite score or depth maps")
    if launches != {name: launches_expected.get(name, 0) for name in DENSE_SLICE_LAUNCHES}:
        raise AssertionError(f"the {label} forward launched {launches}")
    if (differ & ~tie).any() or int(differ.sum()) > 1e-3 * differ.numel():
        raise AssertionError(f"semantic classes differ at {int(differ.sum())} pixels, "
                             f"{int((differ & ~tie).sum())} of them outside a tie")
    if score_err > score_tol or depth_err > 1e-5:
        raise AssertionError(f"score maps' relative error {score_err}, depth maps' {depth_err}")


def panoptic_parts(model: SihlModel, images: torch.Tensor):
    """The panoptic head's outputs, and from the same trunk pass its parts:
    the semantic logits at the masks' size, the instance branch's outputs
    and its top-100 anchor indices (on the CPU)."""
    head = model.heads[0]
    feats = model.extract_features(images)
    outputs = head(feats)
    num, scores, classes, masks = head.instance(feats)
    logits = interpolate(head.semantic.get_logits(feats), size=masks.shape[2:], mode="bilinear").float()
    flat = anchor_features(head.instance, feats)
    (loc,) = anchors.run_mlps(flat, [head.instance.loc_head], num_valid=flat.shape[1])
    order = torch.sort(loc[..., 0].float(), dim=1, descending=True, stable=True)[1][:, :MAX_INSTANCES]
    return [t.cpu() for t in outputs], [t.cpu() for t in (logits, scores, masks, order)]


def check_panoptic_slice(model: SihlModel, gen: torch.Generator) -> None:
    """Phase 33: the f32 panoptic model on two 640 px images, on the card and
    on the CPU with the same weights, the instance branch's loc bias set as
    phase 8 sets it but for 3 live slots in the first image (random mask
    weights claim most pixels): num_instances equal, the
    class and instance-id maps equal but at ties, each of which must be
    explained: a pixel no instance claims where the CPU's two largest
    semantic probabilities lie within 1e-5 (relative), a pixel where a
    candidate instance's mask probability lies within 1e-4 of 0.5 (an
    instance whose score does so makes its image's every pixel one), or one
    claimed on either side by a slot whose anchor differs between the two
    sides' top 100; the ties under 1e-3 of the pixels; the scores of slots
    whose anchors agree within 1e-3."""
    images = varied_images(np.random.RandomState(int(torch.randint(2**31, (1,), generator=gen))), 2)
    with torch.no_grad():
        loc_bias = set_loc_bias(model, images.cuda(), head=model.heads[0].instance, live=3)
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        (c_map, c_ids, c_num, c_scores, _), (c_logits, _, c_masks, c_idx) = panoptic_parts(cpu_model, images)
        t_cpu = time.perf_counter() - t0
        reset_counts()
        (p_map, p_ids, num, scores, _), (_, _, _, idx) = panoptic_parts(model, images.cuda())
        launches = read_counts(("stem_conv_stats", "upsample_add", "fused_mlp", "dynconv_decode"))
    differ = (p_map != c_map) | (p_ids != c_ids)
    sem_tie = (top_two_gap(c_logits) <= 1e-5) & (c_ids == 0) & (p_ids == 0)
    live = c_scores > 0.5 - 1e-4
    mask_tie = ((c_masks - 0.5).abs() <= 1e-4) & live[:, :, None, None]
    score_tie = ((c_scores - 0.5).abs() <= 1e-4).any(dim=1)[:, None, None]
    moved = idx != c_idx  # (B, 100) slots whose anchors differ
    slot_moved = torch.zeros_like(differ)
    for ids in (p_ids, c_ids):
        slot = torch.clamp(ids.long() - 1, min=0)
        slot_moved |= (ids > 0) & torch.take_along_dim(moved, slot.flatten(1), dim=1).view_as(ids)
    explained = sem_tie | mask_tie.any(dim=1) | score_tie | slot_moved
    share = float((~moved).float().mean())
    score_err = float((scores - c_scores).abs()[~moved].max())
    print(f"  panoptic slice f32, 2 images at {SIZE} px, loc bias {loc_bias:.4f}: num_instances card {num.tolist()} "
          f"cpu {c_num.tolist()}; top-k anchors agree in {share:.4f} of slots; class or id maps differ at "
          f"{int(differ.sum())} of {differ.numel()} pixels, {int((differ & ~explained).sum())} of them unexplained "
          f"(semantic ties {int(sem_tie.sum())}, mask-probability ties {int(mask_tie.any(dim=1).sum())}, pixels of "
          f"moved slots {int(slot_moved.sum())}); {int((c_ids > 0).sum())} pixels claimed by an instance on the "
          f"CPU, {int(c_ids.max())} the largest id; max score err {score_err:.3g}; kernel launches {launches}; "
          f"CPU forward {t_cpu:.1f} s")
    if not 0 < int(c_num.sum()) < 2 * MAX_INSTANCES or not (c_ids > 0).any():
        raise AssertionError(f"num_instances {c_num.tolist()}, or the id maps, leave nothing to compare")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"the panoptic forward launched {launches}")
    if not torch.equal(num, c_num) or share < 0.98:
        raise AssertionError(f"num_instances differ, or top-k anchors agree in only {share:.4f} of slots")
    if (differ & ~explained).any() or int(differ.sum()) > 1e-3 * differ.numel():
        raise AssertionError(f"class or id maps differ at {int(differ.sum())} pixels, "
                             f"{int((differ & ~explained).sum())} of them unexplained")
    if score_err > 1e-3:
        raise AssertionError(f"score err {score_err} out of bounds")


def multitask_parts(model: SihlModel, images: torch.Tensor):
    """From one trunk pass: the detector's outputs and top-100 anchor indices,
    the text head's scores, tokens and the relative gap between each
    position's two largest f32 logits, the depth maps and the embeddings (on
    the CPU)."""
    det, text, depth, metric = model.heads
    feats = model.extract_features(images)
    flat = anchor_features(det, feats)
    (loc,) = anchors.run_mlps(flat, [det.loc_head], num_valid=flat.shape[1])
    order = torch.sort(loc[..., 0].float(), dim=1, descending=True, stable=True)[1][:, :MAX_INSTANCES]
    top = text.logits(feats).float().topk(2, dim=2).values
    gap = (top[..., 0] - top[..., 1]) / top[..., 0].abs().clamp_min(1e-12)
    outputs = [*det(feats), *text(feats), depth(feats), metric(feats), order, gap]
    return [t.cpu() for t in outputs]


def check_multitask_slice(model: SihlModel, gen: torch.Generator) -> None:
    """Phase 43: the f32 multitask model (its text head's dropout at 0) on two
    640 px images, on the card (the frozen stem through K4, the FPN's merges
    through K3, the detector's MLPs through K1f) and on the CPU with the same
    weights, the detector's loc bias set as phase 4 sets it: the detector as
    phase 4 holds it; the text tokens equal but where the CPU's two largest
    logits of a position lie within 1e-5 of each other (relative), the
    scores (each position's largest logit) within 1e-4 of the largest
    score; the depth maps within 1e-5 relative; the embeddings within 1e-5."""
    images = varied_images(np.random.RandomState(int(torch.randint(2**31, (1,), generator=gen))), 2)
    with torch.no_grad():
        loc_bias = set_loc_bias(model, images.cuda())
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        c_num, c_scores, c_classes, c_boxes, c_tscores, c_tokens, c_depth, c_emb, c_idx, gap = multitask_parts(
            cpu_model, images)
        t_cpu = time.perf_counter() - t0
        reset_counts()
        num, scores, classes, boxes_, tscores, tokens, depth, emb, idx, _ = multitask_parts(model, images.cuda())
        launches = read_counts(("stem_conv_stats", "upsample_add", "fused_mlp"))
    agree = idx == c_idx
    share = float(agree.float().mean())
    box_err = float((boxes_ - c_boxes).abs().amax(dim=2)[agree].max())
    score_err = float((scores - c_scores).abs().max())
    differ = tokens != c_tokens
    tie = gap <= 1e-5
    errors = {"text scores": float((tscores - c_tscores).abs().max() / c_tscores.abs().max()),
              "depth": float(((depth - c_depth).abs() / c_depth).max()), "embeddings": float((emb - c_emb).abs().max())}
    print(f"  multitask slice f32, 2 images at {SIZE} px, loc bias {loc_bias:.4f}: num_instances card {num.tolist()} "
          f"cpu {c_num.tolist()}; top-k indices agree in {share:.4f} of slots; max box err {box_err:.3g} px; max "
          f"score err {score_err:.3g}; text tokens differ at {int(differ.sum())} of {differ.numel()} positions "
          f"({int((differ & ~tie).sum())} outside a tie of the top two logits; ties at {int(tie.sum())}); errors "
          f"{({k: f'{v:.3g}' for k, v in errors.items()})} (text scores of the largest, depth relative); kernel "
          f"launches {launches}; CPU forward {t_cpu:.1f} s")
    if not all(torch.isfinite(t).all() for t in (scores, boxes_, tscores, depth, emb)):
        raise AssertionError("non-finite multitask outputs")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"the multitask forward launched {launches}")
    if not 0 < int(c_num.sum()) < 2 * MAX_INSTANCES or not torch.equal(num, c_num) or share < 0.98:
        raise AssertionError(f"num_instances {num.tolist()} / {c_num.tolist()}, or top-k indices agree in only "
                             f"{share:.4f} of slots")
    if not torch.equal(classes[agree], c_classes[agree]) or box_err > 0.5 or score_err > 1e-3:
        raise AssertionError(f"detections differ: classes, box err {box_err} px or score err {score_err}")
    if (differ & ~tie).any():
        raise AssertionError(f"text tokens differ at {int((differ & ~tie).sum())} positions outside a tie")
    if errors["text scores"] > 1e-4 or errors["depth"] > 1e-5 or errors["embeddings"] > 1e-5:
        raise AssertionError(f"errors {errors} out of bounds")


def serve(model: SihlModel, cuda_gen: torch.Generator, requests: int = 3, size: int = SIZE):
    """Phases 5, 9, 13 and 24: answer ``requests`` batches of 16 images at
    ``size`` px; every head's outputs pass ``check_outputs``."""
    latencies = []
    for _ in range(requests):
        images = torch.rand(BATCH, 3, size, size, device="cuda", generator=cuda_gen)
        t0 = time.perf_counter()
        with torch.no_grad():
            outputs = model(images)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        for head, out in zip(model.heads, outputs):
            check_outputs(head, out, size)
    return latencies


def to_cpu(tree):
    """A target tree (a tensor, or dicts and lists of them, or None) on the CPU."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.cpu()


def step_gradients(model: SihlModel, images, targets):
    """Loss, metrics, every gradient and every buffer after one training
    forward and backward of ``model``; ``targets`` is one head's, or a list
    of them, one a head."""
    model.train()
    if model.backbone.freeze_batchnorms:  # the frozen levels' BatchNorms in eval mode, as the Trainer sets them
        model.backbone._set_frozen_bn_eval()
    loss, metrics = _losses(model, images, targets if isinstance(targets, list) else [targets])
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads, dict(model.named_buffers())


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - want.double()) / max(
        float(torch.linalg.vector_norm(want.double())), 1e-30))


# Relative L2 limits of the card's f32 gradients against the CPU's f64 ones,
# by part of the model.  The heads' gradients keep their digits in f32.  The
# neck's and backbone's are what train-mode BatchNorm's backward leaves after
# it removes each channel's mean and its projection on the normalised input,
# and f32 loses digits there: the CPU's own f32 step, plain PyTorch, misses
# 1e-3 on some of them, as phase 6 prints (PERF.md, section 6).
GRADIENT_LIMITS = {"heads": 1e-3, "neck": 1e-2, "backbone": 2e-2}
# The instance head's mask branch ends in train-mode BatchNorms of its own
# (mask_lateral, mask_head).  Where the CPU's own f32 step misses the heads'
# limit on one of their parameters, f32 itself loses those digits, and the
# parameter is held at the neck's fixed limit instead.
MASK_BRANCH = ("heads.0.mask_lateral.", "heads.0.mask_head.")
# The PP-LiteSeg decoders of the dense heads (SemanticSegmentation, and the
# DepthEstimation and PanopticSegmentation heads built on it) are chains of
# conv → ReLU → train-mode BatchNorm at 1 x 1 to 80 x 80, whose UAFM
# attention convs have one-element biases: a bias's gradient is a sum over
# every pixel that cancels, and f32 loses its digits there too (the CPU's
# own f32 step read up to 15% from f64 on one at 320 px).  Their parameters
# take the mask branch's rule: where the CPU's own f32 step misses the
# heads' limit, they are held at the neck's.


# The autoencoder's decoder is a chain of the same kind up to 640 x 640,
# whose cotangent, 2 (reconstruction - image) / n, is nearly constant over
# each image: its train-mode BatchNorms remove each channel's mean from it,
# and f32 loses digits there too (the port's CPU f32 step read 1.3e-3 from
# f64 on it at 64 px, tests/test_torch_ssl_slice.py).  It takes the same
# rule.


def decoder_prefixes(model: SihlModel) -> tuple:
    """The parameter-name prefixes of ``model``'s PP-LiteSeg decoders and
    autoencoding heads."""
    return tuple(f"{n}." for n, m in model.named_modules() if isinstance(m, (SemanticSegmentation, Autoencoding)))
# BiFPN's fusion weights reach the loss through a softmax: each gradient is
# a difference of dot products over whole feature maps, d(w_j) = s_j (dw_j -
# sum_k s_k dw_k), and f32 cancels most of its digits (the CPU's own f32 step
# misses the neck's limit by up to 18x).  Where the CPU's f32 step misses the
# part's limit on one of them, f32 itself cannot hold it there, and the card
# is held to twice the CPU's f32 error instead: no further from f64 than a
# second f32 summation order may land.
FUSION_WEIGHTS = "_fusions."


@contextlib.contextmanager
def full_f32():
    """f32 matrix products and cuDNN convolutions in full f32 inside the
    block, whatever the caller set: PyTorch's default runs cuDNN's f32
    convolutions in TF32, which keeps about three decimal digits (ROADMAP.md,
    queue C)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def train_slice_models(model: SihlModel, gen: torch.Generator, build=build_flagship):
    """The train slice's weights: a copy of ``model`` with its trunk frozen
    (``freeze_trunk``),
    the residual branches damped (``damp_residual_branches``, drawn from
    ``gen``) and a detector's loc head's final bias at -5; and CPU models built by
    ``build`` in f64 and f32 with the same weights and buffers.  Returns
    ``(model, {torch.float64: ..., torch.float32: ...})``."""
    model = copy.deepcopy(model)
    freeze_trunk(model)
    damp_residual_branches(model, gen)
    detector = getattr(model.heads[0], "instance", model.heads[0])
    if hasattr(detector, "loc_head"):
        with torch.no_grad():
            detector.loc_head.linears[-1].bias.fill_(LOC_BIAS_INIT)
    cpu_models = {}
    for dtype in (torch.float64, torch.float32):
        with compute_dtype_scope(dtype):
            ref = build(torch.Generator().manual_seed(0), device="cpu")
        freeze_trunk(ref)
        ref.load_state_dict(model.state_dict())
        cpu_models[dtype] = ref
    return model, cpu_models


def head_relu_sites(model: SihlModel) -> dict:
    """The heads' ReLUs on raw conv outputs, by name: (module, attribute that
    holds the activation).  The ConvNormAct blocks whose ReLU acts on the
    conv's output (conv → ReLU → norm), a transformer feed-forward's ReLU on
    its first linear layer's output (the text head's decoder), a depth
    head's two ReLUs: on the bins' mean of a conv's output (``width_act``)
    and on its logits (``weight_act``), and an autoencoding head's two on its
    bottleneck's linear layers (``encode_act``, ``decode_act``)."""
    sites = {}
    for name, mod in model.named_modules():
        if name.startswith("heads.") and isinstance(mod, (ConvNormAct, _FeedForward)) and mod.act is relu:
            sites[name] = (mod, "act")
        for cls, attrs in ((DepthEstimation, ("width_act", "weight_act")),
                           (Autoencoding, ("encode_act", "decode_act"))):
            if isinstance(mod, cls):
                sites.update({f"{name}.{attr}": (mod, attr) for attr in attrs})
    return sites


# The piecewise-linear activations that decide a gradient's path: each one's
# kinks, and its linear pieces between them, in order (as the port writes
# them, ``backbones/mobilenet.py``)
PIECEWISE = {
    relu: ((0.0,), (torch.zeros_like, lambda z: z)),
    relu6: ((0.0, 6.0), (torch.zeros_like, lambda z: z, lambda z: torch.full_like(z, 6.0))),
    hardswish: ((-3.0, 3.0), (torch.zeros_like, lambda z: z * (z + 3.0) / 6.0, lambda z: z)),
    hardsigmoid: ((-3.0, 3.0), (torch.zeros_like, lambda z: (z + 3.0) / 6.0, torch.ones_like)),
}


def kink_sites(model: SihlModel) -> dict:
    """``head_relu_sites``; the neck's ReLUs on raw conv or BatchNorm outputs
    (an FPN's conv → norm → ReLU blocks, a BiFPN's conv → ReLU → norm blocks
    and those of its downscalers); and the trunk's piecewise-linear
    activations on raw BatchNorm outputs that a MobileNet, EfficientNet-lite
    or MNASNet holds as module attributes (``act``, an SE block's ``gate``),
    by name: (module, attribute)."""
    sites = head_relu_sites(model)
    for name, mod in model.named_modules():
        if name.startswith("neck.") and isinstance(mod, (ConvNormAct, StandardConvNormAct)) and mod.act is relu:
            sites[name] = (mod, "act")
        if name.startswith("backbone."):
            sites.update({f"{name}.{attr}": (mod, attr) for attr in ("act", "gate")
                          if any(getattr(mod, attr, None) is fn for fn in PIECEWISE)})
    return sites


def piece(z: torch.Tensor, kinks) -> torch.Tensor:
    """The index of the linear piece each element of ``z`` lies on."""
    return sum((z > k).to(torch.int8) for k in kinks)


@contextlib.contextmanager
def recorded_preactivations(model: SihlModel):
    """Inside the block, every forward of ``model`` records the inputs of its
    ``kink_sites``, call by call (on the CPU, in f64), into the dict of
    lists it yields: the view-invariance head's projector runs on both views."""
    out, sites = {}, kink_sites(model)
    originals = {name: getattr(mod, attr) for name, (mod, attr) in sites.items()}

    def recorder(name, act):
        def recording(z):
            out.setdefault(name, []).append(z.detach().cpu().double())
            return act(z)
        return recording

    for name, (mod, attr) in sites.items():
        setattr(mod, attr, recorder(name, originals[name]))
    try:
        yield out
    finally:
        for name, (mod, attr) in sites.items():
            setattr(mod, attr, originals[name])


def head_max_sites(model: SihlModel) -> dict:
    """The heads' channel maxima that pick one channel's gradient path (each
    UAFM's ``channel_max``, two calls a forward), by the UAFM's name."""
    return {name: mod for name, mod in model.named_modules() if name.startswith("heads.") and isinstance(mod, UAFM)}


@contextlib.contextmanager
def recorded_channel_maxima(model: SihlModel):
    """Inside the block, every forward of ``model`` records the inputs of its
    ``head_max_sites``, call by call (on the CPU, in f64), into the dict of
    lists it yields."""
    out, sites = {}, head_max_sites(model)

    def recorder(name):
        def recording(x):
            out.setdefault(name, []).append(x.detach().cpu().double())
            return channel_max(x)
        return recording

    for name, mod in sites.items():
        mod.channel_max = recorder(name)
    try:
        yield out
    finally:
        for mod in sites.values():
            mod.channel_max = channel_max


def with_max_decisions(model: SihlModel, inputs: dict, seen: dict) -> SihlModel:
    """``model`` with its ``head_max_sites`` taking, call by call, the channel
    that ``inputs`` (another forward's) maximise at each pixel: the same
    branch of every maximum as that forward, for one forward.  Each call's
    own input goes into ``seen`` (on the CPU, in f64)."""
    for name, mod in head_max_sites(model).items():
        picks = iter([x.argmax(dim=1, keepdim=True) for x in inputs[name]])

        def decided(x, picks=picks, name=name):
            seen.setdefault(name, []).append(x.detach().cpu().double())
            return torch.gather(x, 1, next(picks).to(x.device))

        mod.channel_max = decided
    return model


def with_relu_decisions(model: SihlModel, preactivations: dict, seen: dict) -> SihlModel:
    """A copy of ``model`` whose ``kink_sites`` take, call by call, the
    linear piece that ``preactivations`` (another forward's) lie on: the
    same branch of every ReLU, ReLU6, hardswish and hardsigmoid as that
    forward.  Each call's own input goes into ``seen`` (on the CPU, in f64)."""
    model = copy.deepcopy(model)
    for name, (mod, attr) in kink_sites(model).items():
        kinks, pieces = PIECEWISE[getattr(mod, attr)]
        picks = iter([piece(z, kinks) for z in preactivations[name]])

        def decided(z, picks=picks, pieces=pieces, name=name):
            seen.setdefault(name, []).append(z.detach().cpu().double())
            pick = next(picks).to(z.device)
            out = pieces[0](z)
            for i, fn in enumerate(pieces[1:], start=1):
                out = torch.where(pick == i, fn(z), out)
            return out

        setattr(mod, attr, decided)
    return model


def head_topk_sites(model: SihlModel) -> dict:
    """The anomaly heads' hard mining by name (``hard_mined``, one call a
    training step): the top-k of each image's student-teacher distances,
    which alone send the loss's gradient back."""
    return {name: mod for name, mod in model.named_modules() if isinstance(mod, AnomalyDetection)}


@contextlib.contextmanager
def recorded_topk(model: SihlModel):
    """Inside the block, every training step of ``model`` records its
    ``head_topk_sites``' inputs (on the CPU, in f64) and picks, call by call,
    into the dict of lists it yields; the values are those of the picks."""
    out, sites = {}, head_topk_sites(model)

    def recorder(name):
        def recording(flat, k):
            idx = torch.topk(flat, k, dim=1, sorted=False).indices
            out.setdefault(name, []).append((flat.detach().cpu().double(), idx.cpu()))
            return torch.gather(flat, 1, idx)
        return recording

    for name, mod in sites.items():
        mod.hard_mined = recorder(name)
    try:
        yield out
    finally:
        for mod in sites.values():
            mod.hard_mined = hard_mined


def with_topk_decisions(model: SihlModel, recorded: dict, seen: dict) -> SihlModel:
    """``model`` with its ``head_topk_sites`` taking, call by call, the picks
    that ``recorded`` (another step's) made.  Each call's own input and own
    top-k go into ``seen`` (on the CPU, the input in f64)."""
    for name, mod in head_topk_sites(model).items():
        picks = iter([idx for _, idx in recorded[name]])

        def decided(flat, k, picks=picks, name=name):
            own = torch.topk(flat, k, dim=1, sorted=False).indices
            seen.setdefault(name, []).append((flat.detach().cpu().double(), own.cpu()))
            return torch.gather(flat, 1, next(picks).to(flat.device))

        mod.hard_mined = decided
    return model


def check_train_slice(model: SihlModel, gen: torch.Generator, build=build_flagship, batch=None,
                      label: str = "train slice", kink_drift: bool = False) -> None:
    """Phases 6, 10, 14 and 25: one f32 training step's loss, metrics, gradients and
    BatchNorm statistics on the card against an f64 step on the CPU (plain
    versions), on the same weights and batch, each gradient to relative L2
    ``GRADIENT_LIMITS`` of its part; an f32 step on the CPU shows how many
    digits f32 keeps.  The card's step runs in full f32 (``full_f32``), also
    when this is called without ``main``, which turns TF32 off.  The weights
    are those of the serving slice with the residual branches damped
    (``damp_residual_branches``) and a detector's loc head's final bias at
    -5 (the detector's initial value), so that the dense location loss does
    not send every anchor nearly the same gradient.  ``build`` makes the CPU
    models; ``batch`` is the images and targets (the flagship's two images
    by default; a list of targets, one a head, for several heads).  The parts
    of ``GRADIENT_LIMITS`` that the model has are held.

    A ReLU on a head conv's raw output (``head_relu_sites``) passes or
    stops its whole gradient on the sign of a value that f32 rounds: where
    the card's f32 pre-activation and the CPU's f64 one fall on two sides
    of 0, the conv's weight gradient loses that pixel's whole term, and a
    single flip can move it past the heads' limit.  So every flip must lie
    within 1e-4 of its block's largest pre-activation from 0 (the f32
    rounding of a conv output, not an error in it); the f64 step takes the
    card's decisions in those blocks (its own pre-activations recorded to
    measure each flip), and the gradients are held against that.  The neck's ReLUs on raw conv or norm
    outputs, and the trunk's ReLU6, hardswish and hardsigmoid on raw
    BatchNorm outputs (a MobileNet's; ``kink_sites``), switch their linear
    piece the same way at their kinks (0 and 6, -3 and 3), and are held and
    taken over alike.  A UAFM's channel maximum
    (``head_max_sites``) sends a pixel's gradient to one channel, and two
    channels within rounding of each other swap it (one swap among 64,000
    moved a depth decoder's lateral-conv gradient 1.1e-3 from f64): a channel the
    card picks must lie within 1e-4 of its map's largest magnitude below
    the f64 maximum, and the f64 step takes the card's picks too.  With
    ``kink_drift``, a flipped ReLU or kink decision may lie as far from its
    kink as twice the farthest that the CPU's own f32 step flips, where
    that passes 1e-4: HRNetV2-W48's 300 f32 convs round its pre-activations
    by more than a ResNet's."""
    model, cpu_models = train_slice_models(model, gen, build)
    kinks = {name: PIECEWISE[getattr(mod, attr)][0] for name, (mod, attr) in kink_sites(model).items()}
    images, targets = batch if batch is not None else training_batch(2, seed=1)
    cpu_images, cpu_targets = images.cpu(), to_cpu(targets)
    with (full_f32(), recorded_preactivations(model) as z_card, recorded_channel_maxima(model) as m_card,
          recorded_topk(model) as k_card):
        loss, metrics, grads, bufs = step_gradients(model, images, targets)
    # the f64 step takes the card's decisions, and records its own inputs at
    # each site to show how far from its kink each flipped decision lay
    z_cpu, m_cpu, k_cpu = {}, {}, {}
    ref64 = with_topk_decisions(with_max_decisions(with_relu_decisions(
        cpu_models[torch.float64], z_card, z_cpu), m_card, m_cpu), k_card, k_cpu)
    references, z_f32 = {}, {}
    for dtype, ref in ((torch.float64, ref64), (torch.float32, cpu_models[torch.float32])):
        t0 = time.perf_counter()
        recording = kink_drift and dtype == torch.float32
        with recorded_preactivations(ref) if recording else contextlib.nullcontext(z_f32) as z_f32:
            references[dtype] = step_gradients(ref, cpu_images, cpu_targets) + (time.perf_counter() - t0,)
    flips, kink = 0, 0.0
    for name, zs in z_cpu.items():
        for z, z_c in zip(zs, z_card[name]):
            flipped = piece(z_c, kinks[name]) != piece(z, kinks[name])
            flips += int(flipped.sum())
            if flipped.any():
                gap = torch.stack([(z[flipped] - k).abs() for k in kinks[name]]).amin(dim=0)
                kink = max(kink, float(gap.max() / z.abs().max()))
    cpu_kink = 0.0  # the CPU's own f32 flips, against the same f64 pre-activations
    for name, zs in z_f32.items():
        for z32, z in zip(zs, z_cpu.get(name, [])):
            flipped = piece(z32, kinks[name]) != piece(z, kinks[name])
            if flipped.any():
                gap = torch.stack([(z[flipped] - k).abs() for k in kinks[name]]).amin(dim=0)
                cpu_kink = max(cpu_kink, float(gap.max() / z.abs().max()))
    kink_tol = max(1e-4, 2 * cpu_kink)
    topk_flips, topk_gap = 0, 0.0
    for name, calls in k_cpu.items():
        for (flat, idx), (_, idx_card) in zip(calls, k_card[name]):
            picked = torch.zeros(flat.shape, dtype=torch.bool).scatter_(1, idx, True)
            extra = torch.zeros(flat.shape, dtype=torch.bool).scatter_(1, idx_card, True) & ~picked
            topk_flips += int(extra.sum())
            if extra.any():
                kth = flat.gather(1, idx).amin(dim=1, keepdim=True)
                gap = (kth - flat) / flat.abs().amax(dim=1, keepdim=True)
                topk_gap = max(topk_gap, float(gap[extra].max()))
    max_flips, max_gap = 0, 0.0
    for name, xs in m_cpu.items():
        for x, x_card in zip(xs, m_card[name]):
            pick = x_card.argmax(dim=1, keepdim=True)
            flipped = pick != x.argmax(dim=1, keepdim=True)
            max_flips += int(flipped.sum())
            if flipped.any():
                gap = (x.amax(dim=1, keepdim=True) - x.gather(1, pick)) / x.abs().max()
                max_gap = max(max_gap, float(gap[flipped].max()))
    c_loss, c_metrics, c_grads, c_bufs, t_cpu = references[torch.float64]
    f32_grads = references[torch.float32][2]
    if z_cpu:
        print(f"  {label}: {flips} of {sum(z.numel() for zs in z_cpu.values() for z in zs)} decisions of the "
              f"heads' and the neck's ReLUs on raw conv or norm outputs and the trunk's piecewise activations "
              f"differ between the card's f32 and the CPU's f64 forward, the farthest "
              f"{kink:.3g} of its block's largest pre-activation from its kink (bound {kink_tol:.3g}"
              + (f": twice the CPU's own f32 step's farthest, {cpu_kink:.3g}" if kink_tol > 1e-4 else "") + ")"
              + (f"; {max_flips} of {sum(x[:, :1].numel() for xs in m_cpu.values() for x in xs)} UAFM channel "
                 f"maxima pick another channel, the farthest {max_gap:.3g} of its map's largest magnitude below "
                 f"the maximum (bound 1e-4)" if m_cpu else "")
              + (f"; the hard mining's top-k picks {topk_flips} of "
                 f"{sum(i.numel() for calls in k_cpu.values() for _, i in calls)} distances outside the CPU's top-k, "
                 f"the farthest {topk_gap:.3g} of its image's largest below the CPU's k-th (bound 1e-4)"
                 if k_cpu else "")
              + "; the f64 step takes the card's decisions")
    if kink > kink_tol or max_gap > 1e-4 or topk_gap > 1e-4:
        raise AssertionError(f"a ReLU decision flipped {kink} of its block's scale away from 0, a channel "
                             f"maximum picked a channel {max_gap} of its map's scale below the maximum, or a "
                             f"top-k pick lay {topk_gap} of its image's scale below the k-th")

    if not math.isclose(loss, c_loss, rel_tol=1e-4):
        raise AssertionError(f"loss {loss} on the card, {c_loss} on the CPU")
    for k, v in metrics.items():
        if not math.isclose(v, c_metrics[k], rel_tol=1e-4, abs_tol=1e-6):
            raise AssertionError(f"{k}: {v} on the card, {c_metrics[k]} on the CPU")
    frozen = [n for n in grads
              if n.startswith("backbone.features.") and model.backbone.is_frozen_param(n.split(".")[2:])]
    # the ResNet family cuts the gradient after its frozen levels; MobileNet,
    # EfficientNet and MNASNet run their frozen prefix's backward, as in the
    # JAX package, and its gradients count in the clip's norm
    cuts = isinstance(model.backbone.features, ResNetFeatures)
    # the stem: level 1's modules by name ("stem"; ConvNeXt's stem_conv and
    # stem_norm; DenseNet's conv0 and norm0)
    stem = tuple(f"backbone.features.{e}." for e in model.backbone.features.level_modules[0] if isinstance(e, str))
    if not any(n.startswith(stem) for n in frozen):
        raise AssertionError("the stem is not frozen")
    if any((grads[n] is not None or c_grads[n] is not None) if cuts else (grads[n] is None or c_grads[n] is None)
           for n in frozen):
        raise AssertionError("a frozen parameter got a gradient" if cuts else
                             "a frozen parameter of a net that differentiates its frozen prefix got no gradient")
    # parameters that no head reaches get no gradient on either side (the
    # FPN's level-4 output conv under the keypoint head, which reads levels
    # 3 and 5 only)
    unused = [n for n in grads if n not in frozen and grads[n] is None]
    if any((grads[n] is None) != (c_grads[n] is None) for n in grads):
        raise AssertionError("a parameter got a gradient on one side only")
    # integer buffers (the panoptic head's step counter) must be equal
    counters = {n: (int(bufs[n]), int(b)) for n, b in c_bufs.items() if not b.is_floating_point()}
    if any(card != cpu for card, cpu in counters.values()):
        raise AssertionError(f"counters after the step differ (card, CPU): {counters}")
    stats_err = max(
        float((bufs[n].cpu().double() - b).abs().max() / b.abs().max().clamp_min(1e-12))
        for n, b in c_bufs.items() if b.is_floating_point()
    )
    stem_stats_err = max((
        float((bufs[n].cpu().double() - c_bufs[n]).abs().max() / c_bufs[n].abs().max().clamp_min(1e-12))
        for n in c_bufs if n.startswith(stem) and n.endswith(("running_mean", "running_var"))
    ), default=0.0)  # ConvNeXt's stem has a LayerNorm, no statistics
    print(f"  {label}, {images.shape[0]} images at {images.shape[-1]} px, card f32 against CPU f64: loss {loss:.6f} / "
          f"{c_loss:.6f}; " + "; ".join(
              f"{k.replace('/train', '')} {v:.6f}/{c_metrics[k]:.6f}" for k, v in metrics.items())
          + (f"; counters after the step {counters}" if counters else "")
          + f"; running statistics' largest relative error {stats_err:.3g} (the stem's"
          + (", through K4, " if cuts else " ") + f"{stem_stats_err:.3g}); the {len(frozen)} frozen parameters got "
          + ("no gradient" if cuts else "their gradients, held below with their part's")
          + (f", nor the {len(unused)} that no head reaches ({unused})" if unused else "")
          + f"; CPU f64 step {t_cpu:.1f} s, "
          f"f32 step "
          f"{references[torch.float32][4]:.1f} s")
    parts = {part: limit for part, limit in GRADIENT_LIMITS.items()
             if any(n.split(".")[0] == part and n not in frozen for n in grads)}
    failed = grade_gradients(grads, c_grads, f32_grads, parts, skip=(frozen if cuts else []) + unused,
                             held_f32=MASK_BRANCH + decoder_prefixes(model))
    if failed:
        raise AssertionError(f"{len(failed)} gradients out of bounds, the worst {failed[0]}")
    if stats_err > 1e-3 or stem_stats_err > 1e-5:
        raise AssertionError(f"running statistics differ by {stats_err}, the stem's by {stem_stats_err} (relative)")


def grade_gradients(grads: dict, c_grads: dict, f32_grads: dict, parts: dict, skip=(), held_f32=MASK_BRANCH) -> list:
    """Holds the card's gradients of each part in ``parts`` (its limit)
    against the CPU's f64 ones, as ``check_train_slice`` does, and prints a
    line a part; ``f32_grads`` are the CPU's own f32 step's, which set the
    limits of the parameters under ``held_f32`` (the mask branch, and the
    dense heads' decoders) and of the fusion weights.  Returns the gradients
    out of bounds as (card error, CPU f32 error, name), worst first within a
    part."""
    failed = []
    for part, limit in parts.items():
        names = [n for n in grads if n.split(".")[0] == part and n not in skip]
        largest = max(float(torch.linalg.vector_norm(c_grads[n])) for n in names)
        # zero in exact arithmetic (f64 rounding, below 1e-9 of the part's
        # largest): a BatchNorm output that feeds only train-mode BatchNorms,
        # whose mean removal sums its cotangent to zero (the last BiFPN
        # layer's biases); held in absolute terms instead
        zeros = [n for n in names if float(torch.linalg.vector_norm(c_grads[n])) <= 1e-9 * largest]
        zero_err = max((float(torch.linalg.vector_norm(grads[n])) / largest for n in zeros), default=0.0)
        rows = sorted(
            ((relative_error(grads[n].cpu(), c_grads[n]), relative_error(f32_grads[n], c_grads[n]), n)
             for n in names if n not in zeros),
            reverse=True,
        )
        held = [r[2] for r in rows if r[2].startswith(held_f32) and r[1] > limit]
        witnessed = [r[2] for r in rows if FUSION_WEIGHTS in r[2] and r[2].endswith(".weights") and r[1] > limit]
        limits = [GRADIENT_LIMITS["neck"] if r[2] in held else 2 * r[1] if r[2] in witnessed else limit for r in rows]
        within = sum(r[0] <= lim for r, lim in zip(rows, limits))
        print(f"    {part}: {len(rows)} gradients, {within} within relative L2 {limit} (card f32 "
              f"against CPU f64){f', {held} at the neck limit: the CPU f32 step misses {limit} there' if held else ''}"
              f"{f', {witnessed} at twice the CPU f32 error, which misses {limit} there' if witnessed else ''}; "
              f"worst three (card error, CPU f32 error, name): "
              f"{[(f'{r[0]:.3g}', f'{r[1]:.3g}', r[2]) for r in rows[:3]]}"
              + (f"; {len(zeros)} zero in exact arithmetic, the card's largest {zero_err:.3g} of the part's "
                 f"largest gradient (bound 1e-5): {zeros}" if zeros else ""))
        failed += [r for r, lim in zip(rows, limits) if r[0] > lim]
        if zero_err > 1e-5:
            failed.append((zero_err, None, f"{part}: a gradient that is zero in exact arithmetic"))
    return failed


COUNTERS = {
    "fused_mlp": fused_mlp.fused_mlps,
    "fused_mlp_backward": fused_mlp.fused_mlps_backward,
    "row_kth": topk.row_best_and_kth,
    "upsample_add": fusion.fused_upsample_add,
    "dynconv_decode": dynconv.dynamic_pointwise_decode,
    "dynconv_decode_backward": dynconv.dynamic_pointwise_decode_backward,
    "weighted_sum": fusion.fused_weighted_sum,
    "stem_conv_stats": stem.stem_conv_stats,
    "matmul_stats": conv_probes.matmul_stats,
    "weight_grad_1x1": conv_probes.weight_grad_1x1,
    "conv3x3": conv_probes.conv3x3,
    "stem_variant": stem_variants.stem_variant,
    "mlp_pipeline": mlp_pipeline.mlp_pipeline,
}


def reset_counts() -> None:
    for wrapper in COUNTERS.values():
        wrapper.launches = 0


def read_counts(names) -> dict:
    return {name: COUNTERS[name].launches for name in names}


TRAIN_KERNELS = ("fused_mlp", "fused_mlp_backward", "row_kth", "upsample_add", "stem_conv_stats")
INSTANCE_TRAIN_KERNELS = ("fused_mlp", "fused_mlp_backward", "row_kth", "upsample_add", "dynconv_decode",
                          "dynconv_decode_backward", "stem_conv_stats")


def train(build=build_flagship, batch=None, kernels=TRAIN_KERNELS,
          steps: int = 10, label: str = "training", schedule=None, prepare=None):
    """Phases 7, 11 and 15: bf16 training steps through Trainer (the trunk
    frozen by ``freeze_trunk``, bench.py's optimizer, and ``schedule``'s
    scheduler arguments) on ``batch`` (the flagship's 16 images by
    default); every kernel in ``kernels`` must launch.  ``prepare(trainer)``
    runs first (the anomaly model's teacher statistics and pretraining)."""
    with compute_dtype_scope(torch.bfloat16):
        model = build(torch.Generator().manual_seed(2))
    freeze_trunk(model)
    trainer = Trainer(model, **OPTIMIZER, **(schedule or {}))
    if prepare is not None:
        prepare(trainer)
    images, targets = batch if batch is not None else training_batch(BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics.append(trainer.training_step(images, targets))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts(kernels)
    losses = [float(m["trainer/loss"]) for m in metrics]
    steady = statistics.median(times[2:])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {label} bf16, batch {BATCH} at {images.shape[-1]} px, {steps} steps: losses "
          f"{[round(v, 4) for v in losses]}; step times {[round(t * 1000, 3) for t in times]} ms; "
          f"median of steps 3-{steps} {steady * 1000:.3f} ms, {BATCH / steady:.2f} images/s; "
          f"peak memory {peak_gib:.2f} GiB [{card_name()}]; kernel launches {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite training loss")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the {label} path never launched the {name} kernel")
    return launches


def serve_phase(model: SihlModel, build, cuda_gen, kernels, label: str, size: int = SIZE) -> dict:
    """Phases 5, 9 and 13: the f32 slice's weights in a bf16 model, three
    requests of ``size`` px; every kernel in ``kernels`` must launch.
    Returns the counts."""
    with compute_dtype_scope(torch.bfloat16):
        served = build(torch.Generator().manual_seed(1))
    served.load_state_dict(model.state_dict())
    served.eval()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    latencies = serve(served, cuda_gen, size=size)
    launches = read_counts(kernels)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steady = statistics.median(latencies[1:])
    print(f"  {label} bf16, batch {BATCH} at {size} px: request latencies "
          f"{[round(t * 1000, 3) for t in latencies]} ms; {BATCH / steady:.2f} images/s from "
          f"the median of requests 2-{len(latencies)}; peak memory {peak_gib:.2f} GiB [{card_name()}]; "
          f"kernel launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the {label} path never launched the {name} kernel")
    return launches


def check_tma_kernels_sass() -> None:
    """P4's, P5's and P2's kernels (matmul_stats_kernel<STATS>,
    weight_grad_kernel<TI>, conv3x3_kernel) must show wgmma (HGMMA) and a
    TMA instruction in their SASS; without cuobjdump (the CUDA toolkit's),
    the phase fails."""
    counts = sass_counts(conv_probes._library()._name)
    if not counts:
        raise AssertionError("conv_probes SASS: cuobjdump not found, so the kernels' SASS cannot be read")
    tma = ("UTMALDG", "UTMASTG", "UBLKCP")
    kernels = {k: n for k, n in counts.items()
               if any(name in k for name in ("matmul_stats_kernel", "weight_grad_kernel", "conv3x3_kernel"))}
    if len(kernels) != 5:
        raise AssertionError(f"conv_probes SASS: expected P4's two, P5's two and P2's kernels, found {sorted(kernels)}")
    for k, n in sorted(kernels.items()):
        print(f"  SASS (cuobjdump) {k}: " + ", ".join(f"{op} {n[op]}" for op in SASS_OPCODES))
        if n["HGMMA"] == 0 or not any(n[op] for op in tma):
            raise AssertionError(f"conv_probes: {k} shows no HGMMA or no TMA instruction in its SASS")


def host_ms(fn, reps: int = 20) -> float:
    """Median host time of one call of ``fn`` (its checks, allocations and
    launches), the card idle before each: what a call adds to the device
    time when nothing else is queued."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def probe_alone_times(cuda_gen) -> None:
    """P4, P5 and P2 at the probes' shapes, apart from the probe scripts' event
    timing of a call (which adds the host time before the first launch):
    device time alone (a CUDA graph of 20 calls) beside cuDNN's call for the
    same function timed the same way, and the host time of a call.  With
    another tree's package first on the path (run from that tree, loading
    this file by path), times that tree's kernels the same way."""
    m = 16 * 160 * 160  # probe_conv1x1.run's rows: 16 images at 160 x 160
    x = (torch.randn(m, 64, device="cuda", generator=cuda_gen) * 0.5).to(torch.bfloat16)
    w = (torch.randn(64, 256, device="cuda", generator=cuda_gen) * 0.05).to(torch.bfloat16)
    x_nchw, w4 = x.view(16, 160, 160, 64).permute(0, 3, 1, 2), w.t().reshape(256, 64, 1, 1).contiguous()
    print(f"  P4 ({m}, 64) @ (64, 256): cuDNN's 1x1 conv alone {graph_ms(lambda: F.conv2d(x_nchw, w4)):.4f} ms")
    for stats in (False, True):
        fn = lambda: conv_probes.matmul_stats(x, w, stats=stats)  # noqa: E731
        print(f"  P4 ({m}, 64) @ (64, 256){' with the sums' if stats else ''}: alone {graph_ms(fn):.4f} ms "
              f"(device time, a CUDA graph of 20 calls); host time of a call {host_ms(fn):.4f} ms")
    for name, batch, side, ci, co in probe_wrt_filter.SHAPES:
        m = batch * side * side
        x = (torch.randn(m, ci, device="cuda", generator=cuda_gen) * 0.1).to(torch.bfloat16)
        dy = (torch.randn(m, co, device="cuda", generator=cuda_gen) * 0.1).to(torch.bfloat16)
        x_img = x.view(batch, side, side, ci).permute(0, 3, 1, 2)
        dy_img = dy.view(batch, side, side, co).permute(0, 3, 1, 2)
        library_ms = graph_ms(lambda: torch.nn.grad.conv2d_weight(x_img, (co, ci, 1, 1), dy_img))
        call = lambda: conv_probes.weight_grad_1x1(x, dy)  # noqa: E731
        print(f"  P5 {name}: alone {graph_ms(call):.4f} ms, cuDNN's weight gradient alone {library_ms:.4f} ms "
              f"(device times, CUDA graphs of 20 calls); host time of a call {host_ms(call):.4f} ms")
    x = (torch.randn(16, 160, 160, 64, device="cuda", generator=cuda_gen) * 0.5).to(torch.bfloat16)
    w = (torch.randn(3, 3, 64, 64, device="cuda", generator=cuda_gen) * 0.05).to(torch.bfloat16)
    x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
    library_ms = graph_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1))
    call = lambda: conv_probes.conv3x3(x, w)  # noqa: E731
    print(f"  P2 (16, 160, 160, 64) 3x3: alone {graph_ms(call):.4f} ms, cuDNN's bf16 channels_last conv alone "
          f"{library_ms:.4f} ms (device times, CUDA graphs of 20 calls); host time of a call {host_ms(call):.4f} ms")


def p5_split(cuda_gen) -> None:
    """P5 at the probe's three shapes split into its products and its
    partial sums, each device time from a CUDA graph of 20 launches."""
    for name, batch, side, ci, co in probe_wrt_filter.SHAPES:
        m = batch * side * side
        x = (torch.randn(m, ci, device="cuda", generator=cuda_gen) * 0.1).to(torch.bfloat16)
        dy = (torch.randn(m, co, device="cuda", generator=cuda_gen) * 0.1).to(torch.bfloat16)
        products, reduction = conv_probes.weight_grad_phases(x, dy)
        partials = products()
        print(f"  P5 split {name}: products {graph_ms(products):.4f} ms ({partials.shape[0]} partials, "
              f"{partials.numel() * 4 / 1e6:.1f} MB of f32 written), partial sums {graph_ms(reduction):.4f} ms "
              f"(reading them; device times, CUDA graphs of 20 launches)")


def probes_phase() -> list:
    """Phase 16: the three probe scripts' runs at their full shapes, with
    every count set to 0 just before and read just after; each kernel must
    launch.  Then P4's and P5's SASS and P5's split.  Returns the kernels'
    summary entries (path "probe")."""
    reset_counts()
    p4 = probe_conv1x1.run()
    p5 = probe_wrt_filter.run()
    p2 = probe_conv3x3.run()
    launches = read_counts(("matmul_stats", "weight_grad_1x1", "conv3x3"))
    print(f"  probes: kernel launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the probe path never launched the {name} kernel")
    check_tma_kernels_sass()
    probe_alone_times(torch.Generator("cuda").manual_seed(16))
    p5_split(torch.Generator("cuda").manual_seed(16))

    def entry(name, replaces, n, cases, kernel="kernel", plain="plain", library="library"):
        """``cases``: (legs, bound, max_abs_err) of each shape the probe ran;
        times and bounds are summed over them."""
        if n == 0:
            raise AssertionError(f"the probe path never launched {name}")
        bounds = [b for _, b, _ in cases]
        return dict(
            name=name, path="probe", route="cuda", source="sihl_tpu_torch/ops/csrc/conv_probes.cu",
            replaces=replaces, launches=n, max_abs_err=max(err for _, _, err in cases),
            ms=sum(legs[kernel]["ms"] for legs, _, _ in cases),
            plain_ms=sum(legs[plain]["ms"] for legs, _, _ in cases),
            bound_ms=sum(b["bound_ms"] for b in bounds),
            bound_by=max(bounds, key=lambda b: b["bound_ms"])["bound_by"],
            library_ms=sum(legs[library]["ms"] for legs, _, _ in cases),
        )

    legs4, err4 = p4["legs"], p4["errors"]
    if legs4["kernel"]["launches"] + legs4["kernel_stats"]["launches"] > launches["matmul_stats"]:
        raise AssertionError("matmul_stats: the legs counted more launches than the wrapper")
    return [
        entry("matmul_stats", "tools/probe_conv1x1_pallas.py:79", legs4["kernel"]["launches"],
              [(legs4, p4["bound"]["plain"], err4["kernel_y"])], library="library_conv"),
        entry("matmul_stats@stats", "tools/probe_conv1x1_pallas.py:79", legs4["kernel_stats"]["launches"],
              [(legs4, p4["bound"]["stats"], max(err4["kernel_y"], err4["kernel_sum"], err4["kernel_sumsq"]))],
              kernel="kernel_stats", plain="plain_stats", library="library_conv_stats"),
        entry("weight_grad_1x1", "tools/probe_wrt_filter.py:78", launches["weight_grad_1x1"],
              [(r["legs"], r["bound"], r["errors"]["kernel"]) for r in p5.values()]),
        entry("conv3x3", "tools/probe_conv3x3_pallas.py:89", launches["conv3x3"],
              [(p2["legs"], p2["bound"], p2["errors"]["kernel"])]),
    ]


def stem_variants_phase() -> list:
    """Phase 17: the stem-variant probe's run at its full shape, with every
    count set to 0 just before and read just after; each leg's kernel must
    launch.  Returns one summary entry per leg (path "probe"): its timed
    launches, its own function's bound, and cuDNN's bf16 conv of the whole
    stem as the yardstick of every leg."""
    reset_counts()
    p3 = probe_stem_variants.run()
    total = read_counts(("stem_variant",))["stem_variant"]
    legs = p3["legs"]
    k4 = legs["k4"]
    print(f"  stem variants: kernel launches {total}; K4 / full {k4['ms'] / legs['full']['ms']:.4f} per call, "
          f"{k4['alone_ms'] / legs['full']['ms']:.4f} alone (K4 {k4['ms']:.4f} ms per call, {k4['alone_ms']:.4f} "
          f"alone: the full leg's conv with BatchNorm's sums)")
    if sum(legs[mode]["launches"] for mode in stem_variants.MODES) > total:
        raise AssertionError("stem_variant: the legs counted more launches than the wrapper")
    entries = []
    for mode in stem_variants.MODES:
        if legs[mode]["launches"] == 0:
            raise AssertionError(f"the probe path never launched the stem_variant kernel's {mode} leg")
        plain = "plain" if mode == "full" else f"plain_{mode}"
        entries.append(dict(
            name=f"stem_variants@{mode}", path="probe", route="cuda", source="sihl_tpu_torch/ops/csrc/stem_variants.cu",
            replaces="tools/probe_stem_variants.py:180", launches=legs[mode]["launches"],
            max_abs_err=p3["errors"][mode], ms=legs[mode]["ms"], plain_ms=legs[plain]["ms"],
            **p3["leg_bounds"][mode], library_ms=legs["library"]["ms"], k4_ms=k4["ms"], k4_alone_ms=k4["alone_ms"],
        ))
    return entries


def mlp_pipeline_phase() -> list:
    """Phase 18: the fused-MLP pipeline probe's run at its full shape, with
    every count set to 0 just before and read just after: K1f must launch
    for base and the variant kernels for the other modes.  Returns one
    summary entry per mode (path "probe"): its timed launches, its plain
    version's time, the bound of the MLPs' work, and the same products
    alone on cuBLAS as the yardstick of every mode."""
    reset_counts()
    p1 = probe_mlp_pipeline.run()
    total = read_counts(("fused_mlp", "mlp_pipeline"))
    legs = p1["legs"]
    print(f"  mlp pipeline: kernel launches {total}")
    if legs["base"]["launches"] > total["fused_mlp"] or \
            sum(legs[mode]["launches"] for mode in mlp_pipeline.MODES[1:]) > total["mlp_pipeline"]:
        raise AssertionError("mlp_pipeline: the legs counted more launches than the wrappers")
    # pingpong's gain rests on the order of its barrier arrivals, which a
    # compiler change can undo without changing the output
    print(f"  mlp pipeline: pingpong / base {legs['pingpong']['ms'] / legs['base']['ms']:.4f}, "
          f"pp+mxured / mxured {legs['pp+mxured']['ms'] / legs['mxured']['ms']:.4f} (below 1: the turns pay)")
    entries = []
    for mode in mlp_pipeline.MODES:
        if legs[mode]["launches"] == 0:
            raise AssertionError(f"the probe path never launched the kernel of the mlp_pipeline mode {mode}")
        entries.append(dict(
            name=f"mlp_pipeline@{mode}", path="probe", route="cuda",
            source=f"sihl_tpu_torch/ops/csrc/{'fused_mlp' if mode == 'base' else 'mlp_pipeline'}.cu",
            replaces="tools/probe_mlp_pipeline.py:114", launches=legs[mode]["launches"],
            max_abs_err=p1["errors"][mode], ms=legs[mode]["ms"],
            plain_ms=legs[probe_mlp_pipeline.PLAIN[mode]]["ms"], **p1["bound"],
            library_ms=legs["library"]["ms"],
        ))
    return entries


def own_detections_as_targets(model: SihlModel, images: torch.Tensor, targets: dict, n: int = 3) -> dict:
    """``targets`` with image 1's first ``n`` rows replaced by the model's own
    top ``n`` detections (classes and boxes), so that mAP50 lies strictly
    between 0 and 1 on random weights."""
    with torch.no_grad():
        _, _, classes, boxes_ = model.eval()(images)[0]
    targets = {k: v.clone() for k, v in targets.items()}
    targets["classes"][1, :n] = classes[1, :n]
    targets["boxes"][1, :n] = boxes_[1, :n]
    return targets


def check_validate_slice(gen: torch.Generator) -> None:
    """Phase 19: ``Trainer.validate`` of the flagship in f32 on one batch of
    two 640 px images, on the card (full f32) against the CPU (plain
    versions) with the same weights and batch: the loss within the train
    slice's relative 1e-4, the same metric keys on both sides, every value
    finite; prints the largest mAP difference."""
    model = build_flagship(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    images, targets = training_batch(2, seed=3)
    with full_f32():
        loc_bias = set_loc_bias(model, images)
        targets = own_detections_as_targets(model, images, targets)
    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    want = Trainer(cpu_model, **OPTIMIZER).validate([(images.cpu(), {k: v.cpu() for k, v in targets.items()})])
    t_cpu = time.perf_counter() - t0
    with full_f32():
        t0 = time.perf_counter()
        got = Trainer(model, **OPTIMIZER).validate([(images, targets)])
        t_card = time.perf_counter() - t0
    maps = [k for k in want if "/valid/ma" in k]
    worst = max(maps, key=lambda k: abs(got.get(k, math.inf) - want[k]))
    print(f"  validate slice f32, 2 images at {SIZE} px, loc bias {loc_bias:.4f}: loss card {got['head0/valid/loss']:.6f} "
          f"cpu {want['head0/valid/loss']:.6f}; {len(maps)} mAP keys on both sides, map_50 card "
          f"{got['head0/valid/map_50']:.6f} cpu {want['head0/valid/map_50']:.6f}; the largest mAP difference "
          f"{abs(got[worst] - want[worst]):.3g} ({worst}); validate {t_card:.2f} s on the card, {t_cpu:.1f} s on "
          f"the CPU")
    if sorted(got) != sorted(want) or not maps:
        raise AssertionError(f"validate keys differ: card {sorted(got)}, cpu {sorted(want)}")
    if not all(math.isfinite(v) for v in got.values()):
        raise AssertionError(f"non-finite validation metrics {got}")
    if not math.isclose(got["head0/valid/loss"], want["head0/valid/loss"], rel_tol=1e-4):
        raise AssertionError(f"validation loss {got['head0/valid/loss']} on the card, {want['head0/valid/loss']} on the CPU")


def states_equal(a, b) -> bool:
    """Two train states (nested dicts and lists of tensors and numbers) bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(states_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(states_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    return a == b


@contextlib.contextmanager
def cudnn_deterministic():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def fit_phase(build, batches, kernels, label: str, metric: str = "head0/valid/map_50",
              param_tol: float = 1e-5, schedule=None, prepare=None) -> dict:
    """Phases 20-22, 27, 32, 37, 42, 47, 52, 57 and 62: ``Trainer.fit`` of four bf16 steps on ``batches[0]``
    (16 images at 640 px, the trunk frozen by ``freeze_trunk``, bench.py's optimizer, EMA 0.999),
    validating on both batches every 2 steps and saving a checkpoint every
    2; then one ``validate`` between launch-count reads, which must launch
    every kernel in ``kernels`` and no backward kernel, and leave the
    running statistics as they were; the final save restored into a freshly
    built trainer, its ``state_dict`` bitwise the saved one; one more step
    on ``batches[0]`` in both (cuDNN deterministic): the loss bitwise equal,
    every parameter within ``param_tol`` (1e-5, a tenth of the learning
    rate: the weight gradients may sum in another order; see
    ``DENSE_PARAM_TOL`` for the dense models); ``use_ema_params`` then
    ``predict`` bitwise a model loaded from the EMA shadow.  Prints validate
    images/s (with the time of the heads' ``validation_end`` on the host,
    the COCO mAP of a detector, apart), fit steps/s, fit's ``metric`` and
    the checkpoint's save and restore seconds beside the card's name and
    power limit.  ``schedule`` adds scheduler arguments to the trainers;
    ``prepare(trainer)`` runs before the fit (the multitask model populates
    its metric head's index there, the anomaly model pretrains).  An anomaly
    head's restored reservoirs and calibration are printed and must be
    there.  Returns the validate's launch counts."""

    def fresh_trainer(seed):
        with compute_dtype_scope(torch.bfloat16):
            model = build(torch.Generator().manual_seed(seed))
        freeze_trunk(model)
        return Trainer(model, ema_decay=0.999, **OPTIMIZER, **(schedule or {}))

    trainer = fresh_trainer(3)
    if prepare is not None:
        prepare(trainer)
    model, train_batch = trainer.model, batches[0]
    card = card_name()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        result = trainer.fit([train_batch] * 4, num_steps=4, val_data=batches, val_every=2, log_every=2,
                             checkpoint_every=2, checkpoint_dir=ckpt_dir)
        t_fit = time.perf_counter() - t0
        saved = sorted(os.listdir(ckpt_dir))
        if saved != ["step_2", "step_4"] or not all(math.isfinite(v) for v in result.values()):
            raise AssertionError(f"{label}: checkpoints {saved}, fit's metrics {result}")

        # one validate between launch-count reads, the heads' host time apart
        host_s = []

        def timed(end):
            def timed_end(state, collected=()):
                t = time.perf_counter()
                out = end(state, collected)
                host_s.append(time.perf_counter() - t)
                return out
            return timed_end

        for head in model.heads:
            head.validation_end = timed(head.validation_end)
        buffers = {n: b.clone() for n, b in model.named_buffers()}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        metrics = trainer.validate(batches)
        t_val = time.perf_counter() - t0
        launches = read_counts(kernels)
        backward = read_counts(("fused_mlp_backward", "dynconv_decode_backward"))
        for head in model.heads:
            del head.validation_end
        if any(not torch.equal(b, buffers[n]) for n, b in model.named_buffers()):
            raise AssertionError(f"{label}: validate moved the running statistics")
        if any(n == 0 for n in launches.values()) or any(backward.values()):
            raise AssertionError(f"{label}: validate launched {launches}, backward kernels {backward}")

        # the checkpoint: save, restore into a fresh trainer
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(trainer, os.path.join(ckpt_dir, "timed"))
        t_save = time.perf_counter() - t0
        size_mib = os.path.getsize(os.path.join(ckpt_dir, "timed")) / 2**20
        other = fresh_trainer(4)
        t0 = time.perf_counter()
        restore_checkpoint(other, os.path.join(ckpt_dir, "step_4"))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    if not states_equal(other.state_dict(), trainer.state_dict()):
        raise AssertionError(f"{label}: the restored state differs from the saved one")
    for head in other.model.heads:
        if isinstance(head, AnomalyDetection):
            calibration = {n: float(getattr(head, n)) for n in ("q_st_start", "q_st_end", "q_ae_start", "q_ae_end")}
            print(f"  {label}: the restored reservoirs hold {int(head.reservoir_filled)} of {head.reservoir_size} "
                  f"entries, the ring at {int(head.reservoir_pos)}; calibration {calibration}; teacher std "
                  f"{float(head.feature_std.min()):.4g}-{float(head.feature_std.max()):.4g}")
            if int(head.reservoir_filled) == 0 or calibration["q_st_end"] == 0.1 or not torch.isfinite(
                    head.feature_std).all():
                raise AssertionError(f"{label}: the restored head carries no calibration")
    with cudnn_deterministic():
        loss = trainer.training_step(*train_batch)["trainer/loss"]
        other_loss = other.training_step(*train_batch)["trainer/loss"]
        param_err = max(float((p.detach() - q.detach()).abs().max())
                        for p, q in zip(trainer.params.values(), other.params.values()))
        trainer.use_ema_params()
        served = trainer.predict(train_batch[0])[0]
        with compute_dtype_scope(torch.bfloat16):
            ema_model = build(torch.Generator().manual_seed(5))
        freeze_trunk(ema_model)  # its stem through K4, as the trainer's
        ema_model.load_state_dict({**model.state_dict(), **trainer.ema_params})
        with torch.no_grad():
            want = ema_model.eval()(train_batch[0])[0]
    if not torch.equal(loss, other_loss) or param_err > param_tol:
        raise AssertionError(f"{label}: the step after the restore gives loss {float(other_loss)} against "
                             f"{float(loss)}, parameters apart by {param_err}")
    if not all(torch.equal(g, w) for g, w in zip(served, want)):
        raise AssertionError(f"{label}: use_ema_params then predict differs from a model loaded from the shadow")
    del other, ema_model

    # fit's steps/s: four steps with nothing else, timed between syncs (fit's
    # own trainer/steps_per_sec counts log_every steps since the call began,
    # and the trainer's step is not a multiple of 4 here)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit([train_batch] * 4, num_steps=4, log_every=4)
    torch.cuda.synchronize()
    steps_per_sec = 4 / (time.perf_counter() - t0)
    images = sum(b[0].shape[0] for b in batches)
    print(f"  {label} bf16, batch {BATCH} at {train_batch[0].shape[-1]} px: fit of 4 steps with 2 validations of "
          f"{len(batches)} batches "
          f"and 3 saves {t_fit:.2f} s, loss {result['trainer/loss']:.4f}, {metric} {result[metric]:.4f}; "
          f"validate {images / t_val:.2f} images/s ({t_val:.3f} s for {images} images, of which the heads' "
          f"validation_end on the host {sum(host_s):.3f} s) [{card}]; fit {steps_per_sec:.3f} steps/s [{card}]; "
          f"checkpoint ({size_mib:.0f} MiB) "
          f"save {t_save:.3f} s, restore {t_restore:.3f} s [{card}]; restored state bitwise equal, the next "
          f"step's loss bitwise equal ({float(loss):.6f}), parameters within {param_err:.3g}; EMA predict bitwise "
          f"equal; validate's kernel launches {launches}, backward {backward}")
    return launches


def classifier_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 23-27, the classifier (``build_classifier``): the f32 serving
    slice against the CPU, three bf16 requests, the f32 training slice
    against f64 on the CPU, ten bf16 steps and the fit; the frozen stem runs
    K4 in each.  Returns the launch counts of serving, training and
    validation."""
    model = build_classifier(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_classifier_slice(model, gen)
    launches = {"classifier_serve": serve_phase(model, build_classifier, cuda_gen, ("stem_conv_stats",),
                                                "classifier serving")}
    check_train_slice(model, gen, build_classifier, classifier_batch(2, seed=1), "classifier train slice")
    del model
    launches["classifier_train"] = train(build_classifier, classifier_batch(BATCH), ("stem_conv_stats",),
                                         label="classifier training")
    launches["classifier_validate"] = fit_phase(
        build_classifier, [classifier_batch(BATCH), classifier_batch(BATCH, seed=4)], ("stem_conv_stats",),
        "classifier fit", metric="head0/valid/accuracy")
    return launches


DENSE_KERNELS = ("upsample_add", "stem_conv_stats")
# The dense heads' decoders upscale by bilinear resizes, whose backward on
# the card adds into its gradient with atomics, in another order each run:
# two equal steps give gradients that differ in their last bits, and AdamW
# turns a gradient that is rounding noise into a step of up to the learning
# rate either way.  So after the restore their parameters are held within
# twice the learning rate (2e-4), the loss still bitwise.
DENSE_PARAM_TOL = 2 * OPTIMIZER["optimizer_kwargs"]["lr"]
PANOPTIC_SERVE = ("fused_mlp", "upsample_add", "dynconv_decode", "stem_conv_stats")
PANOPTIC_TRAIN = ("fused_mlp", "fused_mlp_backward", "row_kth", "upsample_add", "dynconv_decode",
                  "dynconv_decode_backward", "stem_conv_stats")
PANOPTIC_VALIDATE = ("fused_mlp", "row_kth", "upsample_add", "dynconv_decode", "stem_conv_stats")
# the dense and panoptic models' bf16 steps, five to keep the whole smoke
# inside its time (the median of steps 3-5 is their step time)
DENSE_STEPS = 5


def dense_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 28-32, the dense model (``build_dense``): the f32 serving slice
    against the CPU, three bf16 requests, the f32 training slice against f64
    on the CPU, ``DENSE_STEPS`` bf16 steps and the fit; K4 and K3 launch in
    each.  Returns the launch counts of serving, training and validation."""
    model = build_dense(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_dense_slice(model, gen)
    launches = {"dense_serve": serve_phase(model, build_dense, cuda_gen, DENSE_KERNELS, "dense serving")}
    check_train_slice(model, gen, build_dense, dense_batch(4, seed=1, size=SHORT_SLICE_SIZE), "dense train slice")
    del model
    launches["dense_train"] = train(build_dense, dense_batch(BATCH), DENSE_KERNELS, steps=DENSE_STEPS,
                                    label="dense training")
    launches["dense_validate"] = fit_phase(
        build_dense, [dense_batch(BATCH), dense_batch(BATCH, seed=4)], DENSE_KERNELS, "dense fit",
        metric="head0/valid/mean_iou", param_tol=DENSE_PARAM_TOL)
    return launches


def panoptic_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 33-37, the panoptic model (``build_panoptic``), as phases 28-32;
    its instance branch runs K1f, K1b, K2, K5f and K5b, its step counter
    rides in the checkpoint.  Returns the launch counts of serving, training
    and validation."""
    model = build_panoptic(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_panoptic_slice(model, gen)
    launches = {"panoptic_serve": serve_phase(model, build_panoptic, cuda_gen, PANOPTIC_SERVE, "panoptic serving")}
    check_train_slice(model, gen, build_panoptic,
                      panoptic_batch(4, seed=1, mask_size=SHORT_SLICE_SIZE // 2, size=SHORT_SLICE_SIZE),
                      "panoptic train slice")
    del model
    launches["panoptic_train"] = train(build_panoptic, panoptic_batch(BATCH), PANOPTIC_TRAIN, steps=DENSE_STEPS,
                                       label="panoptic training")
    launches["panoptic_validate"] = fit_phase(
        build_panoptic, [panoptic_batch(BATCH), panoptic_batch(BATCH, seed=4)], PANOPTIC_VALIDATE, "panoptic fit",
        metric="head0/valid/pq", param_tol=DENSE_PARAM_TOL)
    return launches


def new_path_kernels(gen: torch.Generator, cuda_gen: torch.Generator, kernels: dict) -> dict:
    """Phase 38: K1f, K1b and K2 at the shapes the canonical detector and the
    multitask model give them, bf16.  Both run the detector's loc MLP dense
    over levels 3-5's 134,400 anchors (the instance model's serving case)
    and, in training, the loc and iou MLPs there (a new case); the canonical
    detector's gathered calls and its matching are the flagship's (cls + box
    over 1,600 rows serving and 14,400 training) and the instance model's
    (1,600 x 8,400); the multitask detector's are new: cls (10) + box over
    1,600 and 2,880 rows, and its matching 320 x 8,400."""
    bf16 = torch.bfloat16
    dense_serve = [c for c in kernels["fused_mlp@instance_serve"] if c["label"] == "dense"]
    flagship_serve = [c for c in kernels["fused_mlp"] if c["label"] == "gathered" and c["path"]]
    flagship_train = [i for i, c in enumerate(kernels["fused_mlp@train"]) if c["label"] == "gathered" and c["path"]]
    fwd, bwd = k1_train_case(gen, cuda_gen, "dense", BATCH * INSTANCE_ANCHORS, (1, 1), bf16, 1e-1, 5e-2, 5e-2)
    mt_fwd, mt_bwd = k1_train_case(gen, cuda_gen, "gathered", BATCH * MT_TARGETS * TOPK, (MT_CLASSES, 4), bf16,
                                   1e-1, 5e-2, 5e-2)
    _, targets = multitask_batch(BATCH)
    results = {
        "fused_mlp@hybrid_serve": dense_serve + flagship_serve,
        "fused_mlp@hybrid_train": [fwd] + [kernels["fused_mlp@train"][i] for i in flagship_train],
        "fused_mlp_backward@hybrid_train": [bwd] + [kernels["fused_mlp_backward"][i] for i in flagship_train],
        "row_kth@hybrid_train": kernels["row_kth@instance_train"],
        "fused_mlp@multitask_serve": dense_serve + [k1f_case(
            gen, cuda_gen, "gathered", BATCH * MAX_INSTANCES, (MT_CLASSES, 4), bf16, 5e-2, 5e-2)],
        "fused_mlp@multitask_train": [fwd, mt_fwd],
        "fused_mlp_backward@multitask_train": [bwd, mt_bwd],
        "row_kth@multitask_train": [k2_case("levels 3-5, 20 targets", anchor_ious(
            range(3, 6), targets[0]["boxes"], targets[0]["classes"]))],
    }
    # each validate batch runs the serving forward and the training step's forward
    for path in ("hybrid", "multitask"):
        results[f"fused_mlp@{path}_validate"] = results[f"fused_mlp@{path}_serve"] + results[f"fused_mlp@{path}_train"]
    return results


HYBRID_SERVE = ("fused_mlp", "stem_conv_stats")
HYBRID_TRAIN = ("fused_mlp", "fused_mlp_backward", "row_kth", "stem_conv_stats")
HYBRID_VALIDATE = ("fused_mlp", "row_kth", "stem_conv_stats")
MT_SERVE = ("fused_mlp", "upsample_add", "stem_conv_stats")
MT_TRAIN = ("fused_mlp", "fused_mlp_backward", "row_kth", "upsample_add", "stem_conv_stats")
MT_VALIDATE = ("fused_mlp", "row_kth", "upsample_add", "stem_conv_stats")


def hybrid_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 38-42, the canonical detector (``build_hybrid``): the f32 serving
    slice against the CPU, three bf16 requests, the f32 training slice
    against f64 on the CPU, ten bf16 steps and the fit, the trainers on the
    example's multistep schedule.  Returns the launch counts of serving,
    training and validation."""
    model = build_hybrid(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_slice(model, gen, "hybrid slice", kernels=HYBRID_SERVE)
    launches = {"hybrid_serve": serve_phase(model, build_hybrid, cuda_gen, HYBRID_SERVE, "hybrid serving")}
    check_train_slice(model, gen, build_hybrid, training_batch(2, seed=1), "hybrid train slice")
    del model
    launches["hybrid_train"] = train(build_hybrid, training_batch(BATCH), HYBRID_TRAIN, label="hybrid training",
                                     schedule=HYBRID_SCHEDULE)
    launches["hybrid_validate"] = fit_phase(
        build_hybrid, [training_batch(BATCH), training_batch(BATCH, seed=4)], HYBRID_VALIDATE, "hybrid fit",
        schedule=HYBRID_SCHEDULE)
    return launches


def index_from(batch):
    """A ``fit_phase`` ``prepare``: the metric head's retrieval index from
    ``batch``'s images and identities, the model in eval mode."""

    def prepare(trainer):
        images, targets = batch
        model = trainer.model.eval()
        with torch.no_grad():
            model.heads[3].extend_validation_index_set(model.extract_features(images), targets[3])

    return prepare


def multitask_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 43-47, the multitask model (``build_multitask``), as phases
    38-42; the f32 slices take the text head's dropout at 0
    (``build_multitask_still``), the rest the example's 0.1; the fit's
    validations retrieve against an index of a third batch.  Returns the
    launch counts of serving, training and validation."""
    model = build_multitask_still(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_multitask_slice(model, gen)
    launches = {"multitask_serve": serve_phase(model, build_multitask, cuda_gen, MT_SERVE, "multitask serving")}
    check_train_slice(model, gen, build_multitask_still, multitask_batch(4, seed=1, size=SHORT_SLICE_SIZE),
                      "multitask train slice")
    del model
    launches["multitask_train"] = train(build_multitask, multitask_batch(BATCH), MT_TRAIN, label="multitask training")
    launches["multitask_validate"] = fit_phase(
        build_multitask, [multitask_batch(BATCH), multitask_batch(BATCH, seed=4)], MT_VALIDATE, "multitask fit",
        metric="head3/valid/r_precision", param_tol=DENSE_PARAM_TOL, prepare=index_from(multitask_batch(BATCH, seed=5)))
    return launches


K4_ONLY = ("stem_conv_stats",)


@torch.no_grad()
def teacher_statistics(model: SihlModel, images: torch.Tensor) -> None:
    """The trunk's BatchNorms take the statistics of one training-mode
    forward of ``images`` as their running statistics: a random frozen
    teacher's (or a random HRNet's) stand-in for pretrained ones.  With random running statistics
    a stem filter that is negative on every pixel of images in [0, 1] can
    leave a channel 0 everywhere, down to the anomaly head's level, whose
    standard deviation is then 0 and its distances infinite."""
    norms = [m for m in model.backbone.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.momentum = 0.0
    model.backbone.train()
    model.backbone(images)
    for m in norms:
        del m.momentum


def pretrained_teacher(batches):
    """A ``train`` / ``fit_phase`` ``prepare`` for the anomaly model: the
    teacher's BatchNorm statistics from the first batch
    (``teacher_statistics``), then ``Trainer.pretrain`` over ``batches``
    (``examples/anomaly_detection.py:32``), whose frozen stem must launch
    K4 once a batch; the teacher's mean and standard deviation must come
    out finite, the deviations positive."""

    def prepare(trainer):
        teacher_statistics(trainer.model, batches[0][0])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        trainer.pretrain([(x, None) for x, _ in batches])
        torch.cuda.synchronize()
        t_pretrain = time.perf_counter() - t0
        k4 = read_counts(K4_ONLY)["stem_conv_stats"]
        head = trainer.model.heads[0]
        std = head.feature_std
        print(f"  pretrain over {len(batches)} batches of {batches[0][0].shape[0]} at {batches[0][0].shape[-1]} px: "
              f"{t_pretrain:.3f} s; teacher mean {float(head.features_mean.min()):.4g}-"
              f"{float(head.features_mean.max()):.4g}, std {float(std.min()):.4g}-{float(std.max()):.4g}; K4 "
              f"launches {k4}")
        if k4 != len(batches) or not torch.isfinite(head.features_mean).all() or not (std > 0).all():
            raise AssertionError(f"pretrain launched K4 {k4} times, or left no usable teacher statistics")

    return prepare


@torch.no_grad()
def calibrate_anomaly(model: SihlModel, batches) -> None:
    """The anomaly model as training leaves it: the teacher's statistics
    (``pretrained_teacher``), one reservoir write a batch in training mode,
    then the quantiles (``on_validation_start``), so that its maps are not
    all 0 or all 1."""
    pretrained_teacher(batches)(Trainer(model, **OPTIMIZER))
    model.train()
    model.backbone._set_frozen_bn_eval()
    for x, _ in batches:
        model.heads[0].training_step(model.extract_features(x))
    model.heads[0].on_validation_start()
    model.eval()


def check_ssl_slice(model: SihlModel, images: torch.Tensor, label: str) -> None:
    """Phases 48, 53 and 58: one of the self-supervised or anomaly models in
    f32 on two images, on the card (its frozen stem through K4's f32 body,
    in full f32) and on the CPU (the plain versions) with the same weights:
    each output (reconstructions and representations, embeddings, anomaly
    maps) within 1e-4 of its largest magnitude; K4 must launch once."""
    with torch.no_grad():
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        want = cpu_model(images)[0]
        t_cpu = time.perf_counter() - t0
        reset_counts()
        with full_f32():
            got = model(images.cuda())[0]
        k4 = read_counts(K4_ONLY)["stem_conv_stats"]
    head = model.heads[0]
    want = want if isinstance(want, tuple) else (want,)
    got = [t.cpu() for t in (got if isinstance(got, tuple) else (got,))]
    errors = {name: float((g - w).abs().max() / w.abs().max().clamp_min(1e-12))
              for name, g, w in zip(head.output_shapes, got, want)}
    extra = ""
    if isinstance(head, AnomalyDetection):
        maps = want[0]
        extra = (f"; CPU maps at 0 {float((maps == 0).float().mean()):.4f}, at 1 {float((maps == 1).float().mean()):.4f}"
                 f", between {float(((maps > 0) & (maps < 1)).float().mean()):.4f} of pixels")
    print(f"  {label} f32, {images.shape[0]} images at {images.shape[-1]} px: largest errors relative to each "
          f"output's largest magnitude {({k: f'{v:.3g}' for k, v in errors.items()})}{extra}; K4 launches {k4}; CPU "
          f"forward {t_cpu:.1f} s")
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"{label}: non-finite outputs")
    if k4 != 1:
        raise AssertionError(f"{label}: the frozen stem launched K4 {k4} times")
    if max(errors.values()) > 1e-4:
        raise AssertionError(f"{label}: errors {errors} out of bounds")


def autoencoder_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 48-52, the autoencoder (``build_autoencoder``): the f32 serving
    slice against the CPU at ``SSL_SERVE_SIZE``, three bf16 requests, the f32
    training slice against f64 on the CPU at ``SSL_TRAIN_SIZE``, ten bf16
    steps and the fit; K4 launches in each.  Returns the launch counts of
    serving, training and validation."""
    model = build_autoencoder(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_ssl_slice(model, autoencoder_batch(2, seed=1, size=SSL_SERVE_SIZE, device="cpu")[0], "autoencoder slice")
    launches = {"autoencoder_serve": serve_phase(model, build_autoencoder, cuda_gen, K4_ONLY, "autoencoder serving")}
    check_train_slice(model, gen, build_autoencoder, autoencoder_batch(2, seed=1, size=SSL_TRAIN_SIZE),
                      "autoencoder train slice")
    del model
    launches["autoencoder_train"] = train(build_autoencoder, autoencoder_batch(BATCH), K4_ONLY,
                                          label="autoencoder training")
    launches["autoencoder_validate"] = fit_phase(
        build_autoencoder, [autoencoder_batch(BATCH), autoencoder_batch(BATCH, seed=4)], K4_ONLY, "autoencoder fit",
        metric="head0/valid/mean_squared_error", param_tol=DENSE_PARAM_TOL)
    return launches


def view_invariance_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 53-57, the view-invariance model (``build_view_invariance``) as
    phases 48-52, at 640 px throughout (its train slice takes four images:
    standardised over two, every embedding is +-1/sqrt(2) and the loss has
    no gradient); each step runs the trunk on both views."""
    model = build_view_invariance(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_ssl_slice(model, view_batch(2, seed=1, device="cpu")[0], "view-invariance slice")
    launches = {"view_serve": serve_phase(model, build_view_invariance, cuda_gen, K4_ONLY, "view-invariance serving")}
    check_train_slice(model, gen, build_view_invariance, view_batch(4, seed=1), "view-invariance train slice")
    del model
    launches["view_train"] = train(build_view_invariance, view_batch(BATCH), K4_ONLY, label="view-invariance training")
    launches["view_validate"] = fit_phase(
        build_view_invariance, [view_batch(BATCH), view_batch(BATCH, seed=4)], K4_ONLY, "view-invariance fit",
        metric="head0/valid/normalized_frobenius_norm")
    return launches


def anomaly_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 58-62, the anomaly model (``build_anomaly``) as phases 48-52:
    its slices' weights calibrated first (``calibrate_anomaly``), its train
    slice taking the card's top-k picks into the f64 step, its training and
    fit after ``Trainer.pretrain`` over ``PRETRAIN_BATCHES`` batches of 16
    (``pretrained_teacher``); the fit validates on a normal and an anomalous
    batch and its restored checkpoint must carry the reservoirs, their
    position and the calibration."""
    model = build_anomaly(gen)
    randomize_norms_and_biases(model, gen)
    calibrate_anomaly(model, [anomaly_batch(4, seed=10 + i, size=SSL_SERVE_SIZE) for i in range(PRETRAIN_BATCHES)])
    check_ssl_slice(model, anomaly_batch(2, seed=1, anomalous=True, size=SSL_SERVE_SIZE, device="cpu")[0],
                    "anomaly slice")
    launches = {"anomaly_serve": serve_phase(model, build_anomaly, cuda_gen, K4_ONLY, "anomaly serving")}
    check_train_slice(model, gen, build_anomaly, (anomaly_batch(2, seed=1, size=SSL_TRAIN_SIZE)[0], None),
                      "anomaly train slice")
    del model
    pretrain = pretrained_teacher([anomaly_batch(BATCH, seed=10 + i) for i in range(PRETRAIN_BATCHES)])
    launches["anomaly_train"] = train(build_anomaly, (anomaly_batch(BATCH)[0], None), K4_ONLY,
                                      label="anomaly training", prepare=pretrain)
    launches["anomaly_validate"] = fit_phase(
        build_anomaly, [anomaly_batch(BATCH, seed=4), anomaly_batch(BATCH, seed=5, anomalous=True)], K4_ONLY,
        "anomaly fit", metric="head0/valid/mean_iou", param_tol=DENSE_PARAM_TOL, prepare=pretrain)
    return launches


KP_SERVE = ("fused_mlp", "upsample_add", "dynconv_decode", "stem_conv_stats")
KP_TRAIN = ("fused_mlp", "fused_mlp_backward", "row_kth", "upsample_add", "dynconv_decode", "dynconv_decode_backward",
            "stem_conv_stats")
KP_VALIDATE = ("fused_mlp", "row_kth", "upsample_add", "dynconv_decode", "stem_conv_stats")


def keypoint_kernels(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phase 63: K1f, K1b and K2 at the keypoint head's calls.  Its loc MLP
    runs dense over level 5's 6,400 anchors (one output, serving and
    training); its presence and kernel MLPs (17 and 2,737 outputs, the
    kernel MLP's output layer on the tensor cores) over the top 1,600 rows
    serving and the 2,048 positives training, bf16 and f32; its matching
    hands K2 160 x 400 IoUs.  K5f and K5b at its decodes are phase 3's."""
    bf16, f32 = torch.bfloat16, torch.float32
    dense, gathered = BATCH * KP_ANCHORS, (KEYPOINTS, KP_PARAMS)
    results = {"fused_mlp@keypoint_serve": [k1f_case(gen, cuda_gen, "dense", dense, (1,), bf16, 5e-2, 5e-2)],
               "fused_mlp@keypoint_train": [], "fused_mlp_backward@keypoint_train": []}
    for dtype, atol, rtol in ((bf16, 5e-2, 5e-2), (f32, 1e-3, 0.0)):
        results["fused_mlp@keypoint_serve"].append(
            k1f_case(gen, cuda_gen, "gathered", BATCH * MAX_INSTANCES, gathered, dtype, atol, rtol))
    for label, m, outs, dtype in (("dense", dense, (1,), bf16), ("gathered", BATCH * KP_POSITIVES, gathered, bf16),
                                  ("gathered", BATCH * KP_POSITIVES, gathered, f32)):
        tol, f_atol, f_rtol = (1e-1, 5e-2, 5e-2) if dtype == bf16 else (1e-3, 1e-3, 0.0)
        fwd, bwd = k1_train_case(gen, cuda_gen, label, m, outs, dtype, tol, f_atol, f_rtol)
        results["fused_mlp@keypoint_train"].append(fwd)
        results["fused_mlp_backward@keypoint_train"].append(bwd)
    _, targets = keypoint_batch(BATCH)
    boxes_ = KeypointDetection.keypoints_to_boxes(targets["keypoints"], targets["presence"])
    classes = torch.where(targets["presence"].any(dim=2), 0, -1)
    results["row_kth@keypoint_train"] = [k2_case("level 5, 10 targets", anchor_ious(range(5, 6), boxes_, classes))]
    results["fused_mlp@keypoint_validate"] = results["fused_mlp@keypoint_serve"] + results["fused_mlp@keypoint_train"]
    return results


def check_keypoint_slice(model: SihlModel, gen: torch.Generator) -> None:
    """Phase 63: the f32 keypoint serving slice on the card against the CPU
    (plain versions): num_instances equal, top-100 indices agreeing in >=
    98% of slots, and in those slots scores and presence within 1e-3 and
    keypoints at the same pixel (within 1e-3 px: the pixel centre's scaling
    rounds on each side; another pixel is 8 px away) wherever the CPU's
    heatmap's two largest probabilities lie more than 1e-4 of the largest
    apart (the first maximum of two values within f32 rounding of each
    other may differ), which must hold for at least 95% of them; K4, K3,
    K1f and K5f must launch."""
    images = torch.rand(2, 3, SIZE, SIZE, generator=gen)
    with torch.no_grad():
        loc_bias = set_loc_bias(model, images.cuda())
        cpu_model = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        (c_num, c_scores, c_presence, c_kpts), c_idx = detect_with_indices(cpu_model, images)
        heat = cpu_model.heads[0](cpu_model.extract_features(images), output_heatmaps=True)
        t_cpu = time.perf_counter() - t0
        reset_counts()
        (num, scores, presence, kpts), idx = detect_with_indices(model, images.cuda())
        launches = read_counts(KP_SERVE)
    b, i, h, w, k = heat.shape
    top = heat.reshape(b, i, h * w, k).topk(2, dim=2).values
    clear = (idx == c_idx)[..., None] & ((top[:, :, 0] - top[:, :, 1]) > 1e-4 * top[:, :, 0])
    agree = idx == c_idx
    share, clear_share = float(agree.float().mean()), float(clear.float().sum() / (agree.sum() * k))
    score_err = float((scores - c_scores).abs()[agree].max())
    presence_err = float((presence - c_presence).abs()[agree].max())
    kpt_err = float((kpts - c_kpts).abs()[clear].max()) if clear.any() else 0.0
    print(f"  keypoint slice f32, 2 images at {SIZE} px, loc bias {loc_bias:.4f}: num_instances card "
          f"{num.tolist()} cpu {c_num.tolist()}; top-k indices agree in {share:.4f} of slots; max score err "
          f"{score_err:.3g}, max presence err {presence_err:.3g}; keypoints of {clear_share:.4f} of those slots' "
          f"heatmaps clear of a near tie, their largest difference {kpt_err:.3g} px; CPU forward {t_cpu:.1f} s; "
          f"kernel launches {launches}")
    if not 0 < int(c_num.sum()) < 2 * MAX_INSTANCES:
        raise AssertionError(f"num_instances {c_num.tolist()} leave nothing to compare")
    if not torch.equal(num, c_num):
        raise AssertionError("num_instances differ between card and CPU")
    if share < 0.98 or clear_share < 0.95:
        raise AssertionError(f"top-k indices agree in only {share:.4f} of slots, or {clear_share:.4f} of their "
                             f"heatmaps are clear of a near tie")
    if score_err > 1e-3 or presence_err > 1e-3 or kpt_err > 1e-3:
        raise AssertionError(f"score err {score_err}, presence err {presence_err} or keypoint err {kpt_err} px")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"the keypoint slice's forward launched {launches}")


def keypoint_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 63-67, the keypoint model (``build_keypoint``), as phases
    38-42: the f32 serving slice against the CPU, three bf16 requests
    (K1f twice a request), the f32 training slice against f64 on the CPU,
    ten bf16 steps and the fit, validating with PCK on the host.  Returns
    the launch counts of serving, training and validation."""
    model = build_keypoint(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_keypoint_slice(model, gen)
    launches = {"keypoint_serve": serve_phase(model, build_keypoint, cuda_gen, KP_SERVE, "keypoint serving")}
    if launches["keypoint_serve"]["fused_mlp"] != 2 * 3:
        raise AssertionError(f"three keypoint requests launched K1f {launches['keypoint_serve']['fused_mlp']} times")
    check_train_slice(model, gen, build_keypoint, keypoint_batch(2, seed=1), "keypoint train slice")
    del model
    launches["keypoint_train"] = train(build_keypoint, keypoint_batch(BATCH), KP_TRAIN, label="keypoint training")
    launches["keypoint_validate"] = fit_phase(
        build_keypoint, [keypoint_batch(BATCH), keypoint_batch(BATCH, seed=4)], KP_VALIDATE, "keypoint fit",
        metric="head0/valid/PCK")
    return launches


PAN_SERVE = ("fused_mlp", "upsample_add", "stem_conv_stats")
PAN_TRAIN = ("fused_mlp", "fused_mlp_backward", "row_kth", "upsample_add", "stem_conv_stats")
PAN_VALIDATE = ("fused_mlp", "row_kth", "upsample_add", "stem_conv_stats")
PRETRAINED_SEED = 23


def write_pretrained_weights(torch_home: str, seed: int = PRETRAINED_SEED, arch: str = "resnet50") -> str:
    """torchvision's cached file of ``arch``, made from a seed, in
    ``torch_home/hub/checkpoints``: the port's torchvision-format export
    (``dump_state_dict``) of the net drawn from ``seed`` with random
    BatchNorm statistics and affine parameters and random conv biases (the
    squeeze-excitation convs', ConvNeXt's), ConvNeXt's layer scales U(0.1,
    0.5) (``randomize_norms_and_biases``), and a classifier under the
    family's key (``fc.`` for a ResNet or a ShuffleNetV2, ``classifier.0.``
    (a LayerNorm) and ``classifier.2.`` for a ConvNeXt, ``classifier.`` for
    a DenseNet, with its ``features.norm5.`` beside it, ``classifier.1.``
    for the others) and BatchNorm counters beside it, as torchvision's files
    hold them; named ``{arch}-<the first 8 hex digits of its SHA-256>.pth``,
    as torchvision names its files.  Returns its path."""
    generator = torch.Generator().manual_seed(seed)
    features = _FEATURE_FACTORIES[arch](arch, generator=generator, device="cpu")
    randomize_norms_and_biases(features, generator)
    with torch.no_grad():
        for m in features.modules():
            if isinstance(m, Conv2d) and m.bias is not None:
                m.bias.copy_(torch.rand(m.bias.shape, generator=generator) * 0.2 - 0.1)
    sd = dump_state_dict(features, arch)
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(0)
               for k in list(sd) if k.endswith("running_mean")})
    width = features.feature_channels[-1]
    classifier = ("fc" if arch.startswith(("resnet", "shufflenet")) else "classifier.2" if arch.startswith("convnext")
                  else "classifier" if arch.startswith("densenet") else "classifier.1")
    sd.update({f"{classifier}.weight": torch.randn(1000, width, generator=generator) * 0.01,
               f"{classifier}.bias": torch.zeros(1000)})
    if arch.startswith("convnext"):
        sd.update({"classifier.0.weight": torch.ones(width), "classifier.0.bias": torch.zeros(width)})
    if arch.startswith("densenet"):
        sd.update({"features.norm5.weight": torch.ones(width), "features.norm5.bias": torch.zeros(width),
                   "features.norm5.running_mean": torch.zeros(width), "features.norm5.running_var": torch.ones(width),
                   "features.norm5.num_batches_tracked": torch.tensor(0)})
    directory = os.path.join(torch_home, "hub", "checkpoints")
    os.makedirs(directory, exist_ok=True)
    partial = os.path.join(directory, f"{arch}.partial")
    torch.save(sd, partial)
    with open(partial, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    path = os.path.join(directory, f"{arch}-{digest}.pth")
    os.replace(partial, path)
    return path


@contextlib.contextmanager
def pretrained_home(arch: str = "resnet50"):
    """A temporary ``TORCH_HOME`` holding ``write_pretrained_weights``'s file
    of ``arch``, set for the block; yields the file's path."""
    before = os.environ.get("TORCH_HOME")
    with tempfile.TemporaryDirectory(prefix="torch_home_") as home:
        os.environ["TORCH_HOME"] = home
        try:
            yield write_pretrained_weights(home, arch=arch)
        finally:
            if before is None:
                del os.environ["TORCH_HOME"]
            else:
                os.environ["TORCH_HOME"] = before


def check_pretrained(model: SihlModel, path: str, t_build: float, arch: str = "resnet50", label: str = "pan") -> None:
    """The trunk holds the file's tensors, runs ImageNet normalisation in
    front and has level 1 frozen (its parameters out of the optimizer; a
    ResNet's without a backward)."""
    want = torch.load(path, weights_only=True, map_location="cpu")
    got = dump_state_dict(model.backbone.features, arch)
    unequal = [k for k, v in got.items() if not torch.equal(v, want[k])]
    bb = model.backbone
    print(f"  {label}: {os.path.basename(path)} ({os.path.getsize(path) / 2**20:.1f} MiB) read from "
          f"torch.hub.get_dir()/checkpoints; {len(got) - len(unequal)} of {len(got)} trunk tensors equal to the "
          f"file's; Normalize in front: {bb.normalize is not None}; frozen levels {bb.frozen_levels} "
          f"({bb.frozen_attr_names()}); model built in {t_build:.2f} s")
    if unequal or bb.normalize is None or bb.frozen_levels != 1 or bb.features._sg_levels != 1:
        raise AssertionError(f"the pretrained trunk: {len(unequal)} tensors differ from the file's (e.g. "
                             f"{unequal[:3]}), normalize {bb.normalize}, frozen levels {bb.frozen_levels}")


def pan_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 68-72, the pretrained PAN detector (``build_pan``), its trunk
    read from ``write_pretrained_weights``'s file: the f32 serving slice
    against the CPU, three bf16 requests, the f32 training slice against
    f64 on the CPU, ten bf16 steps and the fit.  The neck's and head's norms
    and biases are randomised, the trunk keeps the file's.  Returns the
    launch counts of serving, training and validation."""
    with pretrained_home() as path:
        t0 = time.perf_counter()
        model = build_pan(gen)
        check_pretrained(model, path, time.perf_counter() - t0)
        randomize_norms_and_biases(model.neck, gen)
        randomize_norms_and_biases(model.heads, gen)
        model.eval()
        check_slice(model, gen, "pan slice", kernels=PAN_SERVE)
        launches = {"pan_serve": serve_phase(model, build_pan, cuda_gen, PAN_SERVE, "pan serving")}
        check_train_slice(model, gen, build_pan, training_batch(2, seed=1), "pan train slice")
        del model
        launches["pan_train"] = train(build_pan, training_batch(BATCH), PAN_TRAIN, label="pan training")
        launches["pan_validate"] = fit_phase(
            build_pan, [training_batch(BATCH), training_batch(BATCH, seed=4)], PAN_VALIDATE, "pan fit")
    return launches


def resnetv2_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 73-76, the ResNetV2 detector (``build_resnetv2``): the f32
    serving slice against the CPU, three bf16 requests, the f32 training
    slice against f64 on the CPU (every pre-activation branch's last conv
    damped, ``damp_residual_branches``) and ten bf16 steps.  Returns the
    launch counts of serving and training."""
    model = build_resnetv2(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_slice(model, gen, "resnetv2 slice", kernels=PAN_SERVE)
    launches = {"v2_serve": serve_phase(model, build_resnetv2, cuda_gen, PAN_SERVE, "resnetv2 serving")}
    check_train_slice(model, gen, build_resnetv2, training_batch(2, seed=1), "resnetv2 train slice")
    del model
    launches["v2_train"] = train(build_resnetv2, training_batch(BATCH), PAN_TRAIN, label="resnetv2 training")
    return launches


def random_quads(gen: torch.Generator, n: int) -> torch.Tensor:
    """``n`` rotated rectangles (n, 4, 2), counter-clockwise, in a 64-pixel field."""
    centre = torch.rand(n, 1, 2, generator=gen) * 64
    half = torch.rand(n, 1, 2, generator=gen) * 12 + 2
    angle = torch.rand(n, 1, generator=gen) * math.pi
    corners = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]]) * half
    cos, sin = torch.cos(angle), torch.sin(angle)
    rotated = torch.stack([corners[..., 0] * cos - corners[..., 1] * sin,
                           corners[..., 0] * sin + corners[..., 1] * cos], dim=-1)
    return centre + rotated


M16_TOL = 1e-5


def m16_phase(gen: torch.Generator) -> None:
    """Phase 77: the rest of the public layers, ops and utils on CUDA tensors
    against the CPU, f32 (TF32 off): CBAM, CrossCBAM and PadToMultipleOf on
    (16, 256, 80, 80) maps; the adaptive pools (a size that divides and one
    that does not, the linear resize), ``edges`` and ``gaussian_blur`` on 16
    images at 640 px; the BCE and focal losses on (16, 80, 80, 80)
    probabilities, the Tversky loss on (16, 133, 80, 80) logits with void
    pixels, the SSIM loss on 16 images at 320 px; ``polygon_iou`` on 16,000
    pairs of rotated rectangles.  Each within ``M16_TOL`` of its largest
    CPU magnitude (PadToMultipleOf bitwise)."""
    t0 = time.perf_counter()
    cl = torch.channels_last
    maps = [torch.randn(BATCH, WIDTH, 80, 80, generator=gen).contiguous(memory_format=cl) for _ in range(2)]
    images = torch.rand(BATCH, 3, SIZE, SIZE, generator=gen)
    probs = torch.rand(BATCH, NUM_CLASSES, 80, 80, generator=gen)
    labels = (torch.rand(BATCH, NUM_CLASSES, 80, 80, generator=gen) > 0.9).float()
    logits = torch.randn(BATCH, STUFF_CLASSES + THING_CLASSES, 80, 80, generator=gen)
    classes = torch.randint(0, STUFF_CLASSES + THING_CLASSES, (BATCH, 80, 80), generator=gen)
    classes[:, :10] = VOID
    quads = [random_quads(gen, BATCH * 1000) for _ in range(2)]
    cbam, cross = CBAM(WIDTH, generator=gen, device="cpu"), CrossCBAM(WIDTH, generator=gen, device="cpu")
    cases = (
        ("CBAM", cbam, maps[:1]),
        ("CrossCBAM", cross, maps),
        ("PadToMultipleOf(32) of (16, 256, 75, 70)", PadToMultipleOf(32), [maps[0][:, :, :75, :70]]),
        ("adaptive_avg_pool 80 -> 20", lambda x: adaptive_avg_pool(x, 20), maps[:1]),
        ("adaptive_avg_pool 80 -> 7 (linear resize)", lambda x: adaptive_avg_pool(x, 7), maps[:1]),
        ("adaptive_max_pool 80 -> 10", lambda x: adaptive_max_pool(x, 10), maps[:1]),
        ("edges", edges, [images]),
        ("gaussian_blur", gaussian_blur, [images]),
        ("binary_cross_entropy", binary_cross_entropy, [probs, labels]),
        ("focal_loss", focal_loss, [probs, labels]),
        ("tversky_loss", lambda x, t: tversky_loss(x, t, ignore_index=VOID), [logits, classes]),
        ("ssim_loss", ssim_loss, [images[:, :, :320, :320], images[:, :, 320:, 320:]]),
        ("polygon_iou", polygon_iou, quads),
    )
    rows = []
    with full_f32(), torch.no_grad():
        for label, fn, inputs in cases:
            want = fn(*inputs)
            card_fn = copy.deepcopy(fn).cuda() if isinstance(fn, torch.nn.Module) else fn
            got = card_fn(*[x.cuda() for x in inputs]).cpu()
            err = float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30))
            exact = isinstance(fn, PadToMultipleOf)
            rows.append(f"{label} {tuple(got.shape)} {err:.3g}")
            if got.shape != want.shape or not torch.isfinite(got).all() or (err > 0 if exact else err > M16_TOL):
                raise AssertionError(f"{label}: card against CPU {err} (shape {tuple(got.shape)})")
    print(f"  M16 on the card against the CPU, f32, largest error relative to the CPU's largest magnitude "
          f"(bound {M16_TOL:g}, PadToMultipleOf 0): " + "; ".join(rows) + f"; {time.perf_counter() - t0:.1f} s")


EFFDET_SERVE = ("fused_mlp", "weighted_sum")
EFFDET_TRAIN = ("fused_mlp", "fused_mlp_backward", "row_kth", "weighted_sum")
EFFDET_VALIDATE = ("fused_mlp", "row_kth", "weighted_sum")
MNV3_SERVE = ("fused_mlp", "upsample_add")
MNV3_TRAIN = ("fused_mlp", "fused_mlp_backward", "row_kth", "upsample_add")


def effdet_kernels(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phase 78: K1f and K1b at the EfficientDet-D0-shaped detector's dense
    calls (its loc MLP over 16 x 5,456 = 87,296 rows serving; loc and iou
    training; bf16, as the path runs them: phase 3 holds the f32 bodies), K2 at its matching (a 512 px batch's 1,600 x
    5,456 IoUs) and K6 at its BiFPN's fusions (64 channels: N = 2 on 64^2 to
    8^2 maps, N = 3 on 32^2 to 4^2; three layers run each shape once).  Its
    gathered calls (1,600 and 14,400 rows, 80 classes and 4 box outputs) are
    the flagship's, held in phase 3."""
    bf16, dense = torch.bfloat16, BATCH * EFFDET_ANCHORS
    fwd, bwd = k1_train_case(gen, cuda_gen, "dense", dense, (1, 1), bf16, 1e-1, 5e-2, 5e-2)
    results = {"fused_mlp@effdet_serve": [k1f_case(gen, cuda_gen, "dense", dense, (1,), bf16, 5e-2, 5e-2)],
               "fused_mlp@effdet_train": [fwd], "fused_mlp_backward@effdet_train": [bwd]}
    _, targets = training_batch(BATCH, size=EFFDET_SIZE)
    work = anchor_ious(range(3, 8), targets["boxes"], targets["classes"], EFFDET_SIZE)
    results["row_kth@effdet"] = [k2_case(f"levels 3-7 at {EFFDET_SIZE} px", work)]
    results["weighted_sum@effdet"] = k6_cases(cuda_gen, EFFDET_WIDTH, EFFDET_FUSION_SHAPES)["weighted_sum@serve"]
    return results


def effdet_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 78-82, the EfficientDet-D0-shaped detector (``build_effdet``) at
    512 px, its trunk read from ``write_pretrained_weights``'s
    efficientnet_b0 file: the f32 serving slice against the CPU (scores
    within 1e-5), three bf16 requests, the f32 training slice against f64
    on the CPU, ten bf16 steps and the fit.  The neck's and head's
    norms and biases are randomised, the trunk keeps the file's.  Returns
    the launch counts of serving, training and validation."""
    size = EFFDET_SIZE
    with pretrained_home("efficientnet_b0") as path:
        t0 = time.perf_counter()
        model = build_effdet(gen)
        check_pretrained(model, path, time.perf_counter() - t0, "efficientnet_b0", "effdet")
        randomize_norms_and_biases(model.neck, gen)
        randomize_norms_and_biases(model.heads, gen)
        model.eval()
        check_slice(model, gen, "effdet slice", kernels=EFFDET_SERVE, size=size, score_tol=1e-5)
        launches = {"effdet_serve": serve_phase(model, build_effdet, cuda_gen, EFFDET_SERVE, "effdet serving",
                                                size=size)}
        check_train_slice(model, gen, build_effdet, training_batch(2, seed=1, size=size), "effdet train slice")
        del model
        launches["effdet_train"] = train(build_effdet, training_batch(BATCH, size=size), EFFDET_TRAIN,
                                         label="effdet training")
        launches["effdet_validate"] = fit_phase(
            build_effdet, [training_batch(BATCH, size=size), training_batch(BATCH, seed=4, size=size)],
            EFFDET_VALIDATE, "effdet fit")
    if launches["effdet_serve"]["weighted_sum"] != 3 * 2 * EFFDET_LAYERS * 4:
        raise AssertionError(f"three effdet requests launched K6 {launches['effdet_serve']['weighted_sum']} times")
    return launches


def mnv3_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 83-86, the MobileNetV3-large detector (``build_mnv3``): the f32
    serving slice against the CPU (scores within 1e-5), three bf16 requests,
    the f32 training slice against f64 on the CPU (the trunk's kink
    decisions taken from the card) and ten bf16 steps, at the flagship's
    kernel shapes.  Returns the launch counts of serving and training."""
    model = build_mnv3(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_slice(model, gen, "mnv3 slice", kernels=MNV3_SERVE, score_tol=1e-5)
    launches = {"mnv3_serve": serve_phase(model, build_mnv3, cuda_gen, MNV3_SERVE, "mnv3 serving")}
    check_train_slice(model, gen, build_mnv3, training_batch(2, seed=1), "mnv3 train slice")
    del model
    launches["mnv3_train"] = train(build_mnv3, training_batch(BATCH), MNV3_TRAIN, label="mnv3 training")
    return launches


M17_TOL = 1e-5
# a train-mode forward through a trunk's BatchNorms on two 64 px images, card
# f32 against CPU f64: an f32 forward through 16-60 train-mode BatchNorms
# drifts from f64 by up to 1.3e-4 of a level's largest on the CPU itself
# (tests/test_torch_mobilenet.py, F32_TRAIN_LIMIT)
M17_TRAIN_TOL = 3e-4
M17_FIRST = (MOBILENET_CONFIGS, EFFICIENTNET_CONFIGS, MNASNET_CONFIGS)
M17_SECOND = (CONVNEXT_CONFIGS, MOBILENETV4_CONFIGS, DENSENET_CONFIGS, SHUFFLENET_CONFIGS)
M17_SECOND_TRAIN = ("convnext_atto", "convnextv2_atto", "mobilenetv4_hybrid_medium", "densenet121",
                    "shufflenet_v2_x1_0")
M17_LAST = (DLA_CONFIGS, HRNET_CONFIGS)
M17_LAST_TRAIN = ("dla34", "dla102", "hrnet_w18")
# dla102's deepest trees normalise 8 values a channel at level 5 (two images
# at 2 x 2): the CPU's own f32 forward reads 7e-4 to 1.1e-3 from f64 there
# (tests/test_torch_dla_hrnet.py), past M17_TRAIN_TOL, so the card is held
# within twice that drift, measured in the same phase
M17_LAST_DRIFT = ("dla102",)


def level_error(got, want) -> float:
    """The largest error of any level, relative to that level's largest magnitude."""
    return max(float((g.double() - w.double()).abs().max() / w.double().abs().max()) for g, w in zip(got, want))


def m17_phase(gen: torch.Generator, configs=M17_FIRST, train_names=(), label: str = "M17", drift_names=()) -> None:
    """Phases 87 and 97: every name of ``configs`` (by default
    ``MOBILENET_CONFIGS``, ``EFFICIENTNET_CONFIGS`` and ``MNASNET_CONFIGS``),
    built on the CPU with f32 weights from ``gen`` (random BatchNorm
    statistics and affine parameters; ConvNeXt's layer scales and GRN's
    scale and shift), copied to the card, in eval mode (TF32 off) on two 64
    px images: each of the five levels within ``M17_TOL`` of its largest CPU
    magnitude.  Each of ``train_names`` also runs a train-mode forward (the
    batch's statistics) on both: the card's f32 levels within
    ``M17_TRAIN_TOL`` of an f64 copy's on the CPU, or, for each of
    ``drift_names``, within twice the CPU's own f32 forward's error from
    that copy where that is larger.  Prints each name's card forward time
    (CUDA-event median) and build seconds."""
    t0 = time.perf_counter()
    x = torch.rand(2, 3, 64, 64, generator=gen)
    rows, worst, train_rows, train_worst = [], (0.0, None), [], (0.0, None)
    with full_f32(), torch.no_grad():
        for name in (n for table in configs for n in table):
            t_build = time.perf_counter()
            net = Backbone(name, generator=torch.Generator().manual_seed(len(name)), device="cpu")
            randomize_norms_and_biases(net, gen)
            net.eval()
            t_build = time.perf_counter() - t_build
            want = net(x)[1:]
            card, xc = copy.deepcopy(net).cuda(), x.cuda()
            got = [g.cpu() for g in card(xc)[1:]]
            ms = median_ms(lambda: card(xc), reps=5, warmup=1)
            if len(got) != 5 or any(g.shape != w.shape or not torch.isfinite(g).all() for g, w in zip(got, want)):
                raise AssertionError(f"{name}: levels {[tuple(g.shape) for g in got]} against the CPU's")
            err = level_error(got, want)
            worst = max(worst, (err, name), key=lambda e: e[0])
            rows.append(f"{name} {err:.2g} {ms:.2f} ms ({t_build:.1f} s)")
            if name in train_names:
                with compute_dtype_scope(torch.float64):
                    ref = Backbone(name, generator=torch.Generator().manual_seed(0), device="cpu")
                ref.load_state_dict(net.state_dict())
                want64 = ref.train()(x.double())[1:]
                cpu32 = net.train()(x)[1:]
                got = [g.cpu() for g in card.train()(xc)[1:]]
                err, cpu_err = level_error(got, want64), level_error(cpu32, want64)
                tol = max(M17_TRAIN_TOL, 2 * cpu_err) if name in drift_names else M17_TRAIN_TOL
                train_worst = max(train_worst, (err / tol * M17_TRAIN_TOL, name), key=lambda e: e[0])
                train_rows.append(f"{name} {err:.2g} (the CPU's f32 {cpu_err:.2g}; bound {tol:.2g})")
                del ref
            del card
    print(f"  {label} on the card against the CPU, f32 at 64 px, each name's largest level error relative to the "
          f"CPU's largest magnitude (bound {M17_TOL:g}), its forward of 2 images on the card and its build: "
          + "; ".join(rows) + (f"; train mode (batch statistics), card f32 against CPU f64 (bound "
                               f"{M17_TRAIN_TOL:g}): " + "; ".join(train_rows) if train_rows else "")
          + f" [{card_name()}]; {time.perf_counter() - t0:.1f} s")
    if worst[0] > M17_TOL or train_worst[0] > M17_TRAIN_TOL:
        raise AssertionError(f"{worst[1]}: card against CPU {worst[0]}; train mode {train_worst[1]}: "
                             f"{train_worst[0] / M17_TRAIN_TOL:.3g} of its bound")


# the ConvNeXt detector launches the MobileNetV3 detector's kernels (the
# flagship's without K4) in serving and training
CONVNEXT_VALIDATE = ("fused_mlp", "row_kth", "upsample_add")


def convnext_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 88-92, the ConvNeXt-T + FPN detector (``build_convnext``), its
    trunk read from ``write_pretrained_weights``'s convnext_tiny file: the
    f32 serving slice against the CPU (scores within 1e-5), three bf16
    requests, the f32 training slice against f64 on the CPU (the frozen
    stem differentiated: the net does not cut the gradient there), ten bf16
    steps and the fit, at the flagship's kernel shapes (phase 3).  The
    neck's and head's norms and biases are randomised, the trunk keeps the
    file's.  Returns the launch counts of serving, training and
    validation."""
    with pretrained_home("convnext_tiny") as path:
        t0 = time.perf_counter()
        model = build_convnext(gen)
        check_pretrained(model, path, time.perf_counter() - t0, "convnext_tiny", "convnext")
        randomize_norms_and_biases(model.neck, gen)
        randomize_norms_and_biases(model.heads, gen)
        model.eval()
        check_slice(model, gen, "convnext slice", kernels=MNV3_SERVE, score_tol=1e-5)
        launches = {"convnext_serve": serve_phase(model, build_convnext, cuda_gen, MNV3_SERVE, "convnext serving")}
        check_train_slice(model, gen, build_convnext, training_batch(2, seed=1, size=SHORT_SLICE_SIZE),
                          "convnext train slice")
        del model
        launches["convnext_train"] = train(build_convnext, training_batch(BATCH), MNV3_TRAIN,
                                           label="convnext training")
        launches["convnext_validate"] = fit_phase(
            build_convnext, [training_batch(BATCH), training_batch(BATCH, seed=4)], CONVNEXT_VALIDATE, "convnext fit")
    return launches


def densenet_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> None:
    """Phases 93-96, the DenseNet-121 classifier (``build_densenet``) at 224
    px, its trunk read from ``write_pretrained_weights``'s densenet121 file
    (``features.norm5`` and the classifier beside it, skipped): the f32
    serving slice against the CPU (``check_classifier_slice``, no K4),
    three bf16 requests, the f32 training slice against f64 on the CPU (the
    trunk's ReLU decisions taken from the card) and ten bf16 steps.  No TPU
    kernel runs on this path."""
    size = DENSENET_SIZE
    with pretrained_home("densenet121") as path:
        t0 = time.perf_counter()
        model = build_densenet(gen)
        check_pretrained(model, path, time.perf_counter() - t0, "densenet121", "densenet")
        randomize_norms_and_biases(model.heads, gen)
        model.eval()
        check_classifier_slice(model, gen, size=size, label="densenet slice", stem_launches=0)
        serve_phase(model, build_densenet, cuda_gen, (), "densenet serving", size=size)
        check_train_slice(model, gen, build_densenet,
                          classifier_batch(2, seed=1, size=size, num_classes=IMAGENET_CLASSES), "densenet train slice")
        del model
        train(build_densenet, classifier_batch(BATCH, size=size, num_classes=IMAGENET_CLASSES), (),
              label="densenet training")


def dla_kernels(cuda_gen: torch.Generator) -> dict:
    """Phase 98: K3 at the DLA-34 detector's two FPN merges at 512 px (16 x
    256 channels, 16^2 -> 32^2 and 32^2 -> 64^2, bf16), bitwise against its
    plain version, timed.  Its K1f, K1b and K2 calls are EfficientDet's
    (phase 78) and the flagship's (phase 3)."""
    return {"upsample_add@dla": k3_cases(cuda_gen, WIDTH, DLA_SIZE)}


def dla_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 99-103, the DLA-34 + FPN detector (``build_dla``) at 512 px,
    random weights: the f32 serving slice against the CPU (scores within
    1e-5), three bf16 requests (K1f and K3), the f32 training slice against
    f64 on the CPU (the frozen level 1 differentiated: the net does not cut
    the gradient there; the trunk's ReLU decisions taken from the card), ten
    bf16 steps (K1f, K1b, K2, K3) and the fit.  Returns the launch counts of
    serving, training and validation."""
    size = DLA_SIZE
    model = build_dla(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_slice(model, gen, "dla slice", kernels=MNV3_SERVE, size=size, score_tol=1e-5)
    launches = {"dla_serve": serve_phase(model, build_dla, cuda_gen, MNV3_SERVE, "dla serving", size=size)}
    check_train_slice(model, gen, build_dla, training_batch(2, seed=1, size=size), "dla train slice")
    del model
    launches["dla_train"] = train(build_dla, training_batch(BATCH, size=size), MNV3_TRAIN, label="dla training")
    launches["dla_validate"] = fit_phase(
        build_dla, [training_batch(BATCH, size=size), training_batch(BATCH, seed=4, size=size)], CONVNEXT_VALIDATE,
        "dla fit")
    return launches


def hrnet_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> None:
    """Phases 104-107, the HRNetV2-W48 segmenter (``build_hrnet``), random
    weights, the trunk's BatchNorm statistics from a batch
    (``teacher_statistics``: with random ones its levels reach 2e4 and the
    logits 2e3): the f32 serving slice on two ``HRNET_SLICE_SIZE`` images
    against the CPU (class maps equal but at ties, scores within twice the
    CPU's own f32 error against f64; ``check_dense_slice``), three bf16
    requests at 512 px, the f32 training
    slice on two ``HRNET_SLICE_SIZE`` images against f64 on the CPU (the
    trunk's ReLU and the decoder's channel-maximum decisions taken from the
    card, a flip as far from 0 as twice the CPU's own f32 step's farthest;
    ``kink_drift``) and ten bf16 steps at 512 px on ADE20K-shaped targets (150
    classes, void 255).  No TPU kernel runs on this path."""
    model = build_hrnet(gen)
    randomize_norms_and_biases(model, gen)
    teacher_statistics(model, varied_images(np.random.RandomState(5), 2, HRNET_SLICE_SIZE).cuda())
    model.eval()
    check_dense_slice(model, gen, HRNET_SLICE_SIZE, "hrnet slice", launches_expected={}, build=build_hrnet)
    serve_phase(model, build_hrnet, cuda_gen, (), "hrnet serving", size=HRNET_SIZE)
    check_train_slice(model, gen, build_hrnet,
                      dense_batch(2, seed=1, size=HRNET_SLICE_SIZE, num_classes=ADE_CLASSES), "hrnet train slice",
                      kink_drift=True)
    del model
    train(build_hrnet, dense_batch(BATCH, size=HRNET_SIZE, num_classes=ADE_CLASSES), (), label="hrnet training")


def optimizer_family_phase(gen: torch.Generator) -> None:
    """Phase 109: each case of ``OPTIMIZER_FAMILY``, with an EMA at 0.9, on
    ``build_small_detector``'s parameters drawn from U(-1, 1): three steps
    on the same normal gradients on the card (f32) and on the CPU (f64).
    The card's first step runs eagerly (it builds the state); the next two
    are replays of one CUDA graph of the update (the clip, the optimizer,
    the EMA), the step's learning rate filled into the groups' device
    tensors before each.  Every parameter and EMA entry must lie within
    1e-6 + 1e-5 |p| of the CPU's, the learning rates agree to 1e-6."""
    t0 = time.perf_counter()
    worst = {}
    for name, kwargs in OPTIMIZER_FAMILY.items():
        models = {device: build_small_detector(torch.Generator().manual_seed(0), device=device)
                  for device in ("cuda", "cpu")}
        models["cpu"].double()
        with torch.no_grad():
            for p, q in zip(models["cuda"].parameters(), models["cpu"].parameters()):
                p.copy_(torch.rand(p.shape, generator=gen) * 2 - 1)
                q.copy_(p)
        card, cpu = (Trainer(models[device], ema_decay=0.9, **kwargs) for device in ("cuda", "cpu"))
        graph = None
        for step in range(3):
            grads = [torch.randn(q.shape, generator=gen) for q in cpu.model.parameters()]
            for q, g in zip(cpu.model.parameters(), grads):
                q.grad = g.double()
            want_lr = cpu.apply_gradients()
            if graph is None:
                for p, g in zip(card.model.parameters(), grads):
                    p.grad = g.cuda()
                lr = card.apply_gradients()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    card._update()
            else:
                for p, g in zip(card.model.parameters(), grads):
                    p.grad.copy_(g)
                lr = card._set_learning_rate(card.step)
                graph.replay()
                card.step += 1
            if not math.isclose(lr, want_lr, rel_tol=1e-6):
                raise AssertionError(f"optimizer {name}: step {step} learning rate {lr} on the card, {want_lr} on the CPU")
        torch.cuda.synchronize()
        excess = 0.0
        pairs = list(zip(card.model.parameters(), cpu.model.parameters()))
        pairs += list(zip(card.ema_params.values(), cpu.ema_params.values()))
        for p, q in pairs:
            err = (p.detach().double().cpu() - q.detach()).abs() / (1e-6 + 1e-5 * q.detach().abs())
            excess = max(excess, float(err.max()))
        worst[name] = excess
        if excess > 1.0:
            raise AssertionError(f"optimizer {name}: the card's updates lie {excess:.3g} times the tolerance from the "
                                 f"CPU's f64 updates")
    print(f"  optimizer family on the card (f32, state on the card, steps 2-3 replayed from a CUDA graph) against "
          f"f64 on the CPU, error over (1e-6 + 1e-5 |p|): {json.dumps({k: round(v, 4) for k, v in worst.items()})}; "
          f"{time.perf_counter() - t0:.1f} s")


def stack_batches(batches):
    """(xs, targets) of one dispatch: the batches' images and targets (a
    tensor, a dict or list of them, or None) stacked on a new leading
    axis, as ``Trainer.fit`` stacks them."""
    targets = [t if isinstance(t, list) else [t] for _, t in batches]
    return torch.stack([x for x, _ in batches]), _map_tree(lambda *ts: torch.stack(ts), *targets)


def run_state(trainer: Trainer) -> dict:
    """A copy of a trainer's parameters and EMA shadow, on its device."""
    out = {f"param.{n}": p.detach().clone() for n, p in trainer.model.named_parameters()}
    out.update({f"ema.{n}": e.clone() for n, e in (trainer.ema_params or {}).items()})
    return out


def run_distance(a, b) -> tuple:
    """(the largest relative distance between two runs' per-step metrics,
    the largest absolute distance between their parameters and EMA), in
    f64 on the device, read with one wait."""
    (metrics_a, state_a), (metrics_b, state_b) = a, b
    loss = torch.stack([((metrics_a[k].double() - metrics_b[k].double()).abs()
                         / metrics_b[k].double().abs().clamp(min=1e-12)).max() for k in metrics_b]).max()
    param = torch.stack([(state_a[k].double() - state_b[k].double()).abs().max() for k in state_b]).max()
    return tuple(torch.stack([loss, param]).tolist())


def same_metrics(a: dict, b: dict) -> bool:
    """Two metric dicts equal, a NaN equal to a NaN."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (isinstance(a[k], float) and math.isnan(a[k]) and math.isnan(b[k])) for k in a)


class MaskTap:
    """Records the masks that a ``Dropout`` applies: each eager call's in
    :attr:`eager`, and the last two calls' in :attr:`ring` on the card, by
    copies that a CUDA graph holding the call replays."""

    def __init__(self, dropout):
        self.eager, self.ring = [], None
        dropout.register_forward_hook(self)

    def __call__(self, module, inputs, output):
        keep = output != 0
        if self.ring is None:
            self.ring = torch.zeros((2, *keep.shape), dtype=torch.bool, device=keep.device)
        self.ring[0].copy_(self.ring[1])
        self.ring[1].copy_(keep)
        if not torch.cuda.is_current_stream_capturing():
            self.eager.append(keep.clone())


def check_replayed_masks(eager_tap: MaskTap, scanned_tap: MaskTap, dropout, label: str) -> str:
    """The scanned dispatch's last two replays (counts K - 2 and K - 1) drew
    different masks, each the mask an eager step drew at that count, and
    the card's mask at K - 1 is the CPU's (``keep_mask``) bit for bit."""
    count = int(dropout.count)
    last = scanned_tap.ring
    want_cpu = keep_mask(dropout.seed, torch.tensor(count - 1), last.shape[1:], dropout.rate)
    checks = {
        "replays differ": not torch.equal(last[0], last[1]),
        "equal to the eager steps'": torch.equal(last[0], eager_tap.eager[count - 2])
        and torch.equal(last[1], eager_tap.eager[count - 1]),
        "equal to the CPU's": torch.equal(last[1].cpu(), want_cpu),
    }
    if not all(checks.values()):
        raise AssertionError(f"{label}: the dropout masks of the replays at counts {count - 2}, {count - 1}: {checks}")
    kept = float(last.float().mean())
    return (f"dropout {dropout.rate}: the replays at counts {count - 2} and {count - 1} drew different masks, each "
            f"the eager step's at its count and the CPU's, {kept:.4f} kept")


def check_models(build, prepare=None) -> Callable:
    """A function that makes fresh f32 models of one seeded build of
    ``build`` (``prepare(model)`` run on it first: the anomaly model's
    teacher statistics and pretraining), each with ``freeze_trunk``."""
    with compute_dtype_scope(torch.float32):
        base = build(torch.Generator().manual_seed(6))
    if prepare is not None:
        prepare(base)

    def fresh_model():
        model = copy.deepcopy(base)  # the same state as a build loaded from ``base``'s, without the build
        freeze_trunk(model)
        return model

    return fresh_model


def eager_run(trainer: Trainer, batches) -> tuple:
    """(per-step metrics stacked, ``run_state``) of ``training_step`` on
    each of ``batches``, as ``training_steps_scanned`` returns them."""
    rows = [trainer.training_step(x, t) for x, t in batches]
    return ({k: torch.stack([r[k] for r in rows]) for k in rows[0] if k != "trainer/learning_rate"},
            run_state(trainer))


def forced_step(trainers, batch, twins: int, fresh_trainer) -> tuple:
    """One step on ``batch`` of each of ``trainers``, which hold one state
    (a dispatch of one step: a replay where the trainer holds a graph),
    against ``twins`` eager steps of fresh trainers loaded from that state
    (``Trainer.load_state_dict``).  Returns each trainer's distance from the
    first twin (``run_distance``) and the bounds: twice the widest distance
    between two twins, or ``LOSS_FLOOR`` and ``PARAM_FLOOR`` where it is 0."""
    state = trainers[0].state_dict()
    runs = []
    for _ in range(twins):
        twin = fresh_trainer()
        twin.load_state_dict(state)
        runs.append(eager_run(twin, [batch]))
        del twin
    pairs = [run_distance(a, b) for i, a in enumerate(runs) for b in runs[i + 1:]]
    bounds = tuple(max(2 * max(d), floor) for d, floor in zip(zip(*pairs), (LOSS_FLOOR, PARAM_FLOOR)))
    xs, ts = stack_batches([batch])
    return [run_distance((t.training_steps_scanned(xs, ts), run_state(t)), runs[0]) for t in trainers], bounds


def scanned_check(build, batches, label: str, kernels, prepare=None, prepare_validate=None, dropout_path=None,
                  twins: int = 0) -> None:
    """Phases 110-112, 114-116 and one of each model's two in 118-153: K =
    ``len(batches)`` steps of a freshly built f32 model (``check_models``,
    bench.py's optimizer, EMA 0.999) under ``full_f32`` with cuDNN
    deterministic, from the same weights: two eager runs
    (``training_step``) and one ``training_steps_scanned``; the scanned
    run's per-step metrics and final parameters and EMA must lie within
    twice the distance between the eager runs (``LOSS_FLOOR`` and
    ``PARAM_FLOOR`` where that is 0) of the first eager run.  With
    ``twins`` (a backward that adds atomically) one eager run, whose
    distance is printed, and instead each of K more replays, one a
    dispatch, lies within ``forced_step``'s bounds of ``twins`` eager steps
    from its own state.  Then a ``predict`` (which caches the K1 packs), a
    second dispatch (replays only: no parameter's ``_version`` moves), and
    ``predict`` and ``validate`` against a fresh model loaded from the
    trainer's state (bitwise; ``prepare_validate(trainer)`` runs before
    each validate: the multitask model's retrieval index); then a save, a
    restore into a new trainer and one more dispatch on both, within the
    same bounds (with ``twins``, one step on both, each within
    ``forced_step``'s bounds).  Every kernel in ``kernels`` must launch in
    the first dispatch.  With ``dropout_path``, the dotted path of a
    model's ``Dropout``, the first dispatch's replays are held to the masks
    of the first eager run (``check_replayed_masks``)."""
    t0 = time.perf_counter()
    fresh_model = check_models(build, prepare)

    def fresh_trainer():
        return Trainer(fresh_model(), ema_decay=0.999, **OPTIMIZER)

    def tap(trainer):
        return MaskTap(trainer.model.get_submodule(dropout_path)) if dropout_path else None

    def refuse(what, errs, bounds):
        if any(e[0] > bounds[0] or e[1] > bounds[1] for e in errs):
            raise AssertionError(f"{label}: {what} lie {[tuple(f'{v:.3g}' for v in e) for e in errs]} (metrics, "
                                 f"relative; parameters) from the eager steps; bounds {bounds[0]:.3g}, {bounds[1]:.3g}")

    xs, ts = stack_batches(batches)
    with full_f32(), cudnn_deterministic():
        eager = []
        for run in range(1 if twins else 2):
            trainer = fresh_trainer()
            if run == 0:
                eager_tap = tap(trainer)
            eager.append(eager_run(trainer, batches))
        del trainer
        scanned = fresh_trainer()
        scanned_tap = tap(scanned)
        reset_counts()
        metrics = scanned.training_steps_scanned(xs, ts)
        launches = read_counts(kernels)
        if sorted(metrics) != sorted(eager[0][0]) or any(n == 0 for n in launches.values()):
            raise AssertionError(f"{label}: the dispatch's metrics {sorted(metrics)}, its kernel launches {launches}")
        scanned_err = run_distance((metrics, run_state(scanned)), eager[0])
        masks = (check_replayed_masks(eager_tap, scanned_tap, scanned.model.get_submodule(dropout_path), label) + "; "
                 if dropout_path else "")
        if twins:
            forced = [forced_step([scanned], batch, twins, fresh_trainer) for batch in batches]
            for errs, bounds in forced:
                refuse("the replays from their own states", errs, bounds)
            errs = [errs[0] for errs, _ in forced]
            bounds = tuple(max(b[i] for _, b in forced) for i in range(2))
            checked = (f"{len(forced)} replays, each a dispatch, against {twins} eager steps from its state "
                       f"{max(e[0] for e in errs):.3g} (metrics, relative), {max(e[1] for e in errs):.3g} "
                       f"(parameters and EMA), bounds at most {bounds[0]:.3g}, {bounds[1]:.3g}; the first dispatch "
                       f"{scanned_err[0]:.3g}, {scanned_err[1]:.3g} from the eager run (not bounded)")
        else:
            eager_dist = run_distance(*eager)
            bounds = tuple(max(2 * d, floor) for d, floor in zip(eager_dist, (LOSS_FLOOR, PARAM_FLOOR)))
            refuse("the scanned steps", [scanned_err], bounds)
            checked = (f"scanned against the first eager run {scanned_err[0]:.3g} (metrics, relative), "
                       f"{scanned_err[1]:.3g} (parameters and EMA); the eager runs {eager_dist[0]:.3g}, "
                       f"{eager_dist[1]:.3g} apart; bounds {bounds[0]:.3g}, {bounds[1]:.3g}")

        # predict and validate after a dispatch of replays only
        images = batches[0][0]
        scanned.predict(images)
        scanned.training_steps_scanned(xs, ts)
        got = scanned.predict(images)
        reference = fresh_model()
        reference.load_state_dict(scanned.model.state_dict())
        with torch.no_grad():
            want = reference.eval()(images)
        if not states_equal(to_cpu(list(got)), to_cpu(list(want))):
            raise AssertionError(f"{label}: predict after a dispatch differs from a fresh model's")
        validators = [scanned, Trainer(reference, **OPTIMIZER)]
        for trainer in validators if prepare_validate else ():
            prepare_validate(trainer)
        got_valid, want_valid = (trainer.validate(batches[:1]) for trainer in validators)
        if not same_metrics(got_valid, want_valid):
            raise AssertionError(f"{label}: validate after a dispatch gives {got_valid}, a fresh model {want_valid}")
        del reference, validators

        # a save after a dispatch, restored; one more dispatch on both
        with tempfile.TemporaryDirectory() as ckpt_dir:
            save_checkpoint(scanned, os.path.join(ckpt_dir, "ckpt"))
            restored = fresh_trainer()
            restore_checkpoint(restored, os.path.join(ckpt_dir, "ckpt"))
        if twins:
            errs, restore_bounds = forced_step([scanned, restored], batches[0], twins, fresh_trainer)
            refuse("after a restore, a replay and the restored trainer's step", errs, restore_bounds)
            restore_err = tuple(max(e[i] for e in errs) for i in range(2))
        else:
            after = scanned.training_steps_scanned(xs, ts)
            restored_after = restored.training_steps_scanned(xs, ts)
            restore_err = run_distance((restored_after, run_state(restored)), (after, run_state(scanned)))
            refuse("after a restore, the dispatch's steps", [restore_err], bounds)
        if restored.step != scanned.step:
            raise AssertionError(f"{label}: after a restore the steps are {restored.step}, {scanned.step}")
    stats = scanned.graph_stats
    print(f"  {label} f32, {images.shape[0]} images at {images.shape[-1]} px, K = {len(batches)}: {checked}; "
          f"{masks}predict and validate after a dispatch of replays equal a fresh model's; after a save and restore "
          f"one more {'step' if twins else 'dispatch'} {restore_err[0]:.3g}, {restore_err[1]:.3g} from "
          f"{'the eager steps' if twins else 'the original'}; losses "
          f"{[round(float(v), 5) for v in metrics['trainer/loss']]}; capture {stats['capture_s']:.2f} s; first "
          f"dispatch's kernel launches {launches} (its eager step's and the capture's); "
          f"{time.perf_counter() - t0:.1f} s [{card_name()}]")


def scanned_fit_phase(build, batch, dispatch: int, kernels, label: str, eager_steps: int = 6, prepare=None) -> dict:
    """Phases 113, 117 and one of each model's two in 118-153:
    ``Trainer.fit(steps_per_dispatch=dispatch)`` of bf16 steps on ``batch``
    (16 images at the model's size, ``freeze_trunk``, bench.py's optimizer;
    ``prepare(trainer)`` first: the anomaly model's pretraining) after
    ``eager_steps`` timed eager steps of the same trainer, then one warm
    dispatch of ``dispatch`` steps under
    ``torch.cuda.set_sync_debug_mode("error")`` (any host sync inside it
    raises), timed on the host clock to its end.  Prints step ms and
    images/s (eager: the median of steps 3-``eager_steps``; scanned: the
    warm dispatch over its steps), the capture's seconds, peak memory and
    the kernels launched per step.  The wrappers count a kernel where its
    launch is recorded: the first dispatch's eager step and its capture
    count one step each, and replays count nothing; so the launches per
    step are the first dispatch's counts over 2, and the path's launches
    are those times the steps run (eager and replayed).  Every kernel in
    ``kernels`` must launch.  Returns the path's launches."""
    t0 = time.perf_counter()
    with compute_dtype_scope(torch.bfloat16):
        model = build(torch.Generator().manual_seed(2))
    freeze_trunk(model)
    trainer = Trainer(model, **OPTIMIZER)
    if prepare is not None:
        prepare(trainer)
    images, targets = batch
    times = []
    for _ in range(eager_steps):
        t1 = time.perf_counter()
        trainer.training_step(images, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    eager_ms = statistics.median(times[2:]) * 1000
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the eager steps' cache out of the reserved peak
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.perf_counter()
    result = trainer.fit([batch] * dispatch, num_steps=dispatch, steps_per_dispatch=dispatch, log_every=dispatch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    counts = read_counts(kernels)
    if any(n == 0 or n % 2 for n in counts.values()) or not math.isfinite(result["trainer/loss"]):
        raise AssertionError(f"{label}: the first dispatch's kernel launches {counts}, its metrics {result}")
    per_step = {name: n // 2 for name, n in counts.items()}
    xs, ts = stack_batches([batch] * dispatch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t1 = time.perf_counter()
        metrics = trainer.training_steps_scanned(xs, ts)
        launched_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    losses = metrics["trainer/loss"].tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite scanned losses {losses}")
    stats = trainer.graph_stats
    steps_run = stats["eager_steps"] + stats["replays"]
    launches = {name: n * steps_run for name, n in per_step.items()}
    step_ms = warm_s / dispatch * 1000
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    reserved_gib = torch.cuda.max_memory_reserved() / 2**30
    print(f"  {label} bf16, batch {BATCH} at {images.shape[-1]} px: fit(steps_per_dispatch={dispatch}) "
          f"{first_s:.2f} s for its first dispatch (an eager step, the capture {stats['capture_s']:.2f} s, "
          f"{dispatch - 1} replays), loss {result['trainer/loss']:.4f}; a warm dispatch of {dispatch} with no host "
          f"sync (sync debug mode \"error\") {warm_s:.3f} s, its host returning after {launched_s:.3f} s: "
          f"scanned step {step_ms:.3f} ms, {BATCH * 1000 / step_ms:.2f} images/s; eager step of the same trainer "
          f"{eager_ms:.3f} ms, {BATCH * 1000 / eager_ms:.2f} images/s (median of steps 3-{eager_steps}); peak "
          f"memory {peak_gib:.2f} GiB ({reserved_gib:.2f} GiB reserved) [{card_name()}]; kernels launched a step "
          f"{per_step} (counted at the capture), "
          f"times {steps_run} steps run: {launches}; losses of the warm dispatch "
          f"{[round(v, 4) for v in losses[:2]]} ... {[round(v, 4) for v in losses[-2:]]}; "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def scanned_phases(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phases 109-117: the optimizer family, then the flagship's and the
    instance segmenter's scanned dispatches.  Returns the launch counts of
    the two bf16 paths, ``train_scanned`` and ``instance_train_scanned``."""
    optimizer_family_phase(gen)
    scanned_check(build_flagship, [training_batch(CHECK_BATCH, seed=20 + i) for i in range(CHECK_DISPATCH)],
                  "flagship scanned check", TRAIN_KERNELS)
    launches = {"train_scanned": scanned_fit_phase(build_flagship, training_batch(BATCH), FLAGSHIP_DISPATCH,
                                                   TRAIN_KERNELS, "flagship scanned dispatch")}
    scanned_check(build_instance,
                  [instance_batch(CHECK_BATCH, seed=20 + i, mask_size=SIZE // 2) for i in range(CHECK_DISPATCH)],
                  "instance scanned check", INSTANCE_TRAIN_KERNELS)
    launches["instance_train_scanned"] = scanned_fit_phase(build_instance, instance_batch(BATCH), INSTANCE_DISPATCH,
                                                           INSTANCE_TRAIN_KERNELS, "instance scanned dispatch")
    return launches


def anomaly_prepare(model: SihlModel) -> None:
    """A ``scanned_check`` ``prepare`` for the anomaly model: its teacher's
    statistics and pretraining over ``PRETRAIN_BATCHES`` batches of 2 at
    ``SSL_TRAIN_SIZE`` px, as ``pretrained_teacher`` runs them."""
    batches = [anomaly_batch(CHECK_BATCH, seed=10 + i, size=SSL_TRAIN_SIZE) for i in range(PRETRAIN_BATCHES)]
    pretrained_teacher(batches)(Trainer(model, **OPTIMIZER))


class ScannedModel(NamedTuple):
    """One model of phases 118-153: its key in the kernel summary's paths
    (``<key>_train_scanned``), the label its lines print, its builder, its
    f32 check's batch and its bf16 batch of 16 from a seed, the kernels its
    step launches, the pretrained file its builder reads (an arch, or None),
    whether two eager runs of its f32 check differ (a backward that adds
    atomically: the check then holds each replay to ``ATOMIC_TWINS`` eager
    steps from its own state) and
    functions that make the extra arguments of ``scanned_check`` and
    ``scanned_fit_phase``."""

    key: str
    label: str
    build: Callable
    check_batch: Callable
    fit_batch: Callable
    kernels: tuple
    arch: Optional[str] = None
    atomic: bool = False
    check_extras: Callable = dict
    fit_extras: Callable = dict


SCANNED_MODELS = (
    ScannedModel("quad", "quad", build_quad, lambda s: quad_batch(CHECK_BATCH, seed=s), lambda: quad_batch(BATCH),
                 ("fused_mlp", "fused_mlp_backward", "weighted_sum", "stem_conv_stats"), atomic=True),
    ScannedModel("classifier", "classifier", build_classifier, lambda s: classifier_batch(CHECK_BATCH, seed=s),
                 lambda: classifier_batch(BATCH), K4_ONLY),
    ScannedModel("dense", "dense", build_dense, lambda s: dense_batch(CHECK_BATCH, seed=s),
                 lambda: dense_batch(BATCH), DENSE_KERNELS, atomic=True),
    ScannedModel("panoptic", "panoptic", build_panoptic,
                 lambda s: panoptic_batch(CHECK_BATCH, seed=s, mask_size=SIZE // 2), lambda: panoptic_batch(BATCH),
                 PANOPTIC_TRAIN, atomic=True),
    ScannedModel("hybrid", "canonical detector", build_hybrid, lambda s: training_batch(CHECK_BATCH, seed=s),
                 lambda: training_batch(BATCH), HYBRID_TRAIN),
    ScannedModel("multitask", "multitask (dropout 0.1)", build_multitask,
                 lambda s: multitask_batch(CHECK_BATCH, seed=s), lambda: multitask_batch(BATCH),
                 MT_TRAIN, atomic=True, check_extras=lambda: dict(
                     prepare_validate=index_from(multitask_batch(CHECK_BATCH, seed=5)),
                     dropout_path="heads.1.dropout")),
    ScannedModel("autoencoder", "autoencoder", build_autoencoder,
                 lambda s: autoencoder_batch(CHECK_BATCH, seed=s, size=SSL_TRAIN_SIZE),
                 lambda: autoencoder_batch(BATCH), K4_ONLY, atomic=True),
    # four images, as the view-invariance train slice takes them: standardised
    # over two, every embedding is +-1/sqrt(2) and the loss has no gradient
    ScannedModel("view", "view invariance", build_view_invariance, lambda s: view_batch(4, seed=s),
                 lambda: view_batch(BATCH), K4_ONLY),
    ScannedModel("anomaly", "anomaly", build_anomaly, lambda s: anomaly_batch(CHECK_BATCH, seed=s, size=SSL_TRAIN_SIZE),
                 lambda: anomaly_batch(BATCH), K4_ONLY, atomic=True,
                 check_extras=lambda: dict(prepare=anomaly_prepare),
                 fit_extras=lambda: dict(prepare=pretrained_teacher(
                     [anomaly_batch(BATCH, seed=10 + i) for i in range(PRETRAIN_BATCHES)]))),
    ScannedModel("keypoint", "keypoint", build_keypoint, lambda s: keypoint_batch(CHECK_BATCH, seed=s),
                 lambda: keypoint_batch(BATCH), KP_TRAIN),
    ScannedModel("pan", "pretrained PAN detector", build_pan, lambda s: training_batch(CHECK_BATCH, seed=s),
                 lambda: training_batch(BATCH), PAN_TRAIN, arch="resnet50"),
    ScannedModel("v2", "ResNetV2 detector", build_resnetv2, lambda s: training_batch(CHECK_BATCH, seed=s),
                 lambda: training_batch(BATCH), PAN_TRAIN),
    ScannedModel("effdet", "EfficientDet-D0-shaped detector", build_effdet,
                 lambda s: training_batch(CHECK_BATCH, seed=s, size=EFFDET_SIZE),
                 lambda: training_batch(BATCH, size=EFFDET_SIZE), EFFDET_TRAIN, arch="efficientnet_b0", atomic=True),
    ScannedModel("mnv3", "MobileNetV3-large detector", build_mnv3, lambda s: training_batch(CHECK_BATCH, seed=s),
                 lambda: training_batch(BATCH), MNV3_TRAIN),
    ScannedModel("convnext", "ConvNeXt-T detector", build_convnext, lambda s: training_batch(CHECK_BATCH, seed=s),
                 lambda: training_batch(BATCH), MNV3_TRAIN, arch="convnext_tiny"),
    ScannedModel("densenet", "DenseNet-121 classifier", build_densenet,
                 lambda s: classifier_batch(CHECK_BATCH, seed=s, size=DENSENET_SIZE, num_classes=IMAGENET_CLASSES),
                 lambda: classifier_batch(BATCH, size=DENSENET_SIZE, num_classes=IMAGENET_CLASSES), (),
                 arch="densenet121"),
    ScannedModel("dla", "DLA-34 detector", build_dla, lambda s: training_batch(CHECK_BATCH, seed=s, size=DLA_SIZE),
                 lambda: training_batch(BATCH, size=DLA_SIZE), MNV3_TRAIN),
    ScannedModel("hrnet", "HRNetV2-W48 segmenter", build_hrnet,
                 lambda s: dense_batch(CHECK_BATCH, seed=s, size=HRNET_SLICE_SIZE, num_classes=ADE_CLASSES),
                 lambda: dense_batch(BATCH, size=HRNET_SIZE, num_classes=ADE_CLASSES), (), atomic=True),
)
# the bf16 dispatch of phases 118-153, and the eager steps timed beside it
# (the median of steps 3-4)
MODELS_DISPATCH, MODELS_EAGER_STEPS = 4, 4


# each scanned path's kernels: the phase-3 (or model-phase) cases at its
# training step's shapes, as its eager training path's rows take them
_DETECTOR_CASES = {"fused_mlp": "fused_mlp@train", "fused_mlp_backward": "fused_mlp_backward", "row_kth": "row_kth",
                   "upsample_add": "upsample_add"}
_EFFDET_CASES = {"fused_mlp": "fused_mlp@effdet_train", "fused_mlp_backward": "fused_mlp_backward@effdet_train",
                 "row_kth": "row_kth@effdet"}
SCANNED_KERNEL_CASES = {
    "quad_train_scanned": {"fused_mlp": "fused_mlp@quad_train", "fused_mlp_backward": "fused_mlp_backward@quad_train",
                           "weighted_sum": "weighted_sum@train", "stem_conv_stats": "stem_conv_stats"},
    "classifier_train_scanned": {"stem_conv_stats": "stem_conv_stats"},
    "dense_train_scanned": {"upsample_add": "upsample_add@fpn128", "stem_conv_stats": "stem_conv_stats"},
    "panoptic_train_scanned": {
        "fused_mlp": "fused_mlp@instance_train", "fused_mlp_backward": "fused_mlp_backward@instance_train",
        "row_kth": "row_kth@instance_train", "upsample_add": "upsample_add@fpn128",
        "dynconv_decode": "dynconv_decode@train", "dynconv_decode_backward": "dynconv_decode_backward",
        "stem_conv_stats": "stem_conv_stats"},
    "hybrid_train_scanned": {
        "fused_mlp": "fused_mlp@hybrid_train", "fused_mlp_backward": "fused_mlp_backward@hybrid_train",
        "row_kth": "row_kth@hybrid_train", "stem_conv_stats": "stem_conv_stats"},
    "multitask_train_scanned": {
        "fused_mlp": "fused_mlp@multitask_train", "fused_mlp_backward": "fused_mlp_backward@multitask_train",
        "row_kth": "row_kth@multitask_train", "upsample_add": "upsample_add@fpn128",
        "stem_conv_stats": "stem_conv_stats"},
    **{f"{model}_train_scanned": {"stem_conv_stats": "stem_conv_stats"}
       for model in ("autoencoder", "view", "anomaly")},
    "keypoint_train_scanned": {
        "fused_mlp": "fused_mlp@keypoint_train", "fused_mlp_backward": "fused_mlp_backward@keypoint_train",
        "row_kth": "row_kth@keypoint_train", "upsample_add": "upsample_add@fpn128",
        "dynconv_decode": "dynconv_decode@keypoint_train",
        "dynconv_decode_backward": "dynconv_decode_backward@keypoint",
        "stem_conv_stats": "stem_conv_stats"},
    "pan_train_scanned": {**_DETECTOR_CASES, "stem_conv_stats": "stem_conv_stats"},
    "v2_train_scanned": {**_DETECTOR_CASES, "stem_conv_stats": "stem_conv_stats"},
    "effdet_train_scanned": {**_EFFDET_CASES, "weighted_sum": "weighted_sum@effdet"},
    "mnv3_train_scanned": _DETECTOR_CASES,
    "convnext_train_scanned": _DETECTOR_CASES,
    "dla_train_scanned": {**_EFFDET_CASES, "upsample_add": "upsample_add@dla"},
}


def models_scanned_phases(models=SCANNED_MODELS) -> dict:
    """Phases 118-153, two for each model of ``models``: its f32
    ``scanned_check`` (K = 3, its kernels launched in the first dispatch;
    the multitask model's with the example's dropout 0.1, its replays'
    masks held to the eager steps' and the CPU's) and its bf16
    ``scanned_fit_phase`` (``fit(steps_per_dispatch=4)`` at batch 16, a warm
    dispatch with no host sync).  Returns each bf16 path's launch counts
    under ``<key>_train_scanned``."""
    launches = {}
    for phase, m in enumerate(models, start=118):
        t0 = time.perf_counter()
        with pretrained_home(m.arch) if m.arch else contextlib.nullcontext():
            scanned_check(m.build, [m.check_batch(20 + i) for i in range(CHECK_DISPATCH)],
                          f"{m.label} scanned check", m.kernels, twins=ATOMIC_TWINS if m.atomic else 0,
                          **m.check_extras())
            launches[f"{m.key}_train_scanned"] = scanned_fit_phase(
                m.build, m.fit_batch(), MODELS_DISPATCH, m.kernels, f"{m.label} scanned dispatch",
                eager_steps=MODELS_EAGER_STEPS, **m.fit_extras())
        torch.cuda.empty_cache()
        print(f"phases {2 * phase - 118}-{2 * phase - 117} ({m.label}) in {time.perf_counter() - t0:.1f} s")
    return launches


# -- phases 154-160: the data feed ---------------------------------------------------

# COCO 2017's image shapes (w, h) and its 80 category ids (1-90 with ten unused)
COCO_SHAPES = ((640, 480), (480, 640), (640, 427), (500, 375), (612, 612))
COCO_CATEGORY_IDS = tuple(i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
COCO_IMAGES, DATA_WORKERS, DATA_SEED = 48, 4, 29
DATA_STEPS, DATA_DISPATCH = 4, 4
VALIDATE_KERNELS = ("fused_mlp", "row_kth", "upsample_add", "stem_conv_stats")
# the paths of phases 155-159 and, for each kernel they launch, phase 3's case at its shapes
DATA_KERNEL_CASES = {
    "data_train": {"fused_mlp": "fused_mlp@train", "fused_mlp_backward": "fused_mlp_backward", "row_kth": "row_kth",
                   "upsample_add": "upsample_add", "stem_conv_stats": "stem_conv_stats"},
    "data_train_scanned": {"fused_mlp": "fused_mlp@train", "fused_mlp_backward": "fused_mlp_backward",
                           "row_kth": "row_kth", "upsample_add": "upsample_add", "stem_conv_stats": "stem_conv_stats"},
    "data_validate": {"fused_mlp": "fused_mlp@validate", "row_kth": "row_kth", "upsample_add": "upsample_add",
                      "stem_conv_stats": "stem_conv_stats"},
    "data_instance_train": {
        "fused_mlp": "fused_mlp@instance_train", "fused_mlp_backward": "fused_mlp_backward@instance_train",
        "row_kth": "row_kth@instance_train", "upsample_add": "upsample_add", "dynconv_decode": "dynconv_decode@train",
        "dynconv_decode_backward": "dynconv_decode_backward", "stem_conv_stats": "stem_conv_stats"},
}


def polygon(rng, cx: float, cy: float, rx: float, ry: float) -> list:
    """3-12 vertices around (cx, cy) at sorted angles, every other one pulled
    in on half the polygons (concave), as COCO's flat [x0, y0, x1, ...]."""
    n = rng.randint(3, 13)
    angles = np.sort(rng.rand(n) * 2 * np.pi)
    scale = rng.uniform(0.6, 1.0, n)
    if rng.rand() < 0.5:
        scale[::2] *= 0.4
    return np.stack([cx + rx * scale * np.cos(angles), cy + ry * scale * np.sin(angles)], 1).reshape(-1).round(2).tolist()


def write_coco_set(root: Path, seed: int = DATA_SEED):
    """Phase 154: a synthetic COCO set of ``COCO_IMAGES`` PNGs at COCO's
    shapes (``COCO_SHAPES``, written with Pillow) and ``instances_train.json``:
    1-20 objects an image over COCO's 80 category ids, each a box and a
    polygon segmentation (two polygons on every fifth), image 1's first
    object an uncompressed RLE (an ellipse), image 2's first object a crowd
    annotation, and the last image's file missing.  Returns (image_dir,
    ann_file, bytes written)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    image_dir = root / "images"
    image_dir.mkdir()
    images, annotations, written = [], [], 0
    for i in range(COCO_IMAGES):
        w, h = COCO_SHAPES[i % len(COCO_SHAPES)]
        name = f"{i:012d}.png"
        images.append({"id": i + 1, "file_name": name, "width": w, "height": h})
        if i != COCO_IMAGES - 1:
            coarse = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3))
            pixels = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w] + rng.randint(-12, 13, (h, w, 3))
            Image.fromarray(np.clip(pixels, 0, 255).astype(np.uint8)).save(image_dir / name, compress_level=1)
            written += (image_dir / name).stat().st_size
        for k in range(max(rng.randint(1, 21), 2 if i == 2 else 1)):
            bw, bh = rng.uniform(8, w / 3), rng.uniform(8, h / 3)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            cx, cy = x0 + bw / 2, y0 + bh / 2
            segmentation = [polygon(rng, cx, cy, bw / 2, bh / 2)]
            if k % 5 == 4:
                segmentation.append(polygon(rng, x0 + bw / 4, y0 + bh / 4, bw / 5, bh / 5))
            if i == 1 and k == 0:
                yy, xx = np.mgrid[:h, :w]
                inside = ((xx - cx) / (bw / 2)) ** 2 + ((yy - cy) / (bh / 2)) ** 2 <= 1
                flat = inside.T.reshape(-1)  # column-major
                edges = np.flatnonzero(np.diff(np.concatenate([[0], flat.astype(np.int8), [0]])))
                runs = np.diff(np.concatenate([[0], edges, [flat.size]]))
                segmentation = {"size": [h, w], "counts": runs.tolist()}
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1, "iscrowd": int(i == 2 and k == 0),
                                "category_id": COCO_CATEGORY_IDS[rng.randint(len(COCO_CATEGORY_IDS))],
                                "bbox": [round(x0, 2), round(y0, 2), round(bw, 2), round(bh, 2)],
                                "segmentation": segmentation})
    categories = [{"id": c, "name": f"category {c}"} for c in COCO_CATEGORY_IDS]
    ann_file = root / "instances_train.json"
    ann_file.write_text(json.dumps({"images": images, "annotations": annotations, "categories": categories}))
    return image_dir, ann_file, written


def coco_loader(image_dir, ann_file, task: str, collate, augment, epochs=None, shuffle: bool = True):
    """``CocoDataset`` -> ``augment`` -> ``batched_loader`` (``DATA_WORKERS``
    threads) -> ``collate``: host batches of ``BATCH``."""
    dataset = CocoDataset(image_dir, ann_file, task=task)
    return batched_loader(dataset, BATCH, collate, augment=augment, shuffle=shuffle, seed=DATA_SEED,
                          workers=DATA_WORKERS, epochs=epochs)


class Tap:
    """Iterates ``batches`` (a prefetcher), keeping the first ``keep``
    batches it hands over and the seconds each ``next()`` waited."""

    def __init__(self, batches, keep: int = 2):
        self.batches, self.keep, self.kept, self.waits = batches, keep, [], []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.batches)
        self.waits.append(time.perf_counter() - t0)
        if len(self.kept) < self.keep:
            self.kept.append(batch)
        return batch


def check_delivered(kept, hosts, label: str) -> None:
    """Each delivered batch bitwise its host batch: images a channels_last
    CUDA view of the NHWC array, classes int64, boxes or masks float32."""
    for (x, targets), (hx, ht) in zip(kept, hosts):
        layout_ok = x.is_contiguous(memory_format=torch.channels_last) and x.dtype == torch.float32
        if not layout_ok or not torch.equal(x.permute(0, 2, 3, 1).cpu(), torch.from_numpy(hx)):
            raise AssertionError(f"{label}: a delivered image batch differs from its host batch "
                                 f"({x.dtype}, strides {x.stride()})")
        for key, host in ht.items():
            want = torch.from_numpy(host)
            want = want.long() if key == "classes" else want
            if targets[key].dtype != want.dtype or not torch.equal(targets[key].cpu(), want):
                raise AssertionError(f"{label}: delivered {key} ({targets[key].dtype}) differ from the host's")


def logged_fit(trainer: Trainer, data, steps: int, dispatch: int = 1) -> list:
    """``trainer.fit`` of ``steps`` steps, ``dispatch`` a dispatch, logging
    every dispatch; returns the logger's (step, host time, metrics)."""
    log = []
    trainer.logger = lambda metrics, step: log.append((step, time.perf_counter(), metrics))
    try:
        trainer.fit(data, num_steps=steps, steps_per_dispatch=dispatch, log_every=dispatch)
    finally:
        trainer.logger = None
    return log


def data_trainer(build=build_flagship, seed: int = 3) -> Trainer:
    with compute_dtype_scope(torch.bfloat16):
        model = build(torch.Generator().manual_seed(seed))
    freeze_trunk(model)
    return Trainer(model, **OPTIMIZER)


def images_per_s(log: list, batches_per_entry: int = 1) -> float:
    """Images/s between the first and the last logger call."""
    return BATCH * batches_per_entry * (len(log) - 1) / (log[-1][1] - log[0][1])


def augment_stages_ms(image_dir, ann_file, samples: int = 8) -> dict:
    """Host ms a sample of each stage of ``train_pipeline(640)``, one thread,
    over the first ``samples`` images: the decode (``CocoDataset[i]``) and
    each transform with a draw that takes it."""
    dataset = CocoDataset(image_dir, ann_file, task="boxes")
    samples = min(samples, len(dataset))
    stages = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1000 / samples
        return out

    for i in range(samples):
        rng = np.random.RandomState(i)
        sample = timed("decode", dataset.__getitem__, i)
        sample = timed("flip", augment.horizontal_flip, sample)
        sample = timed("photometric", augment.photometric_distort, sample, rng)
        sample = timed("zoom_out", augment.zoom_out, sample, rng, (1.5, 2.0))
        sample = timed("resize", augment.resize, sample, SIZE - 1, SIZE)
        sample = timed("crop", augment.random_crop, sample, SIZE, rng)
        timed("sanitize", augment.sanitize, sample)
    return stages


def flagship_data_phases(image_dir, ann_file, card: str) -> dict:
    """Phases 155-158: the flagship fed from the files (``CocoDataset(task=
    "boxes")`` -> ``train_pipeline(640)`` -> ``batched_loader`` ->
    ``collate_detection(100)`` -> ``DevicePrefetcher``), bf16 at batch 16,
    cuDNN deterministic.  155: the loader alone, 8 host batches, images/s,
    and one thread's host ms a sample of each stage;
    156: ``fit(num_steps=4)`` through the prefetcher against a ``fit`` of a
    trainer from the same state on those host batches staged on the card
    beforehand (``to_device``): the first two delivered batches bitwise
    their host batches (layout and dtypes), every logged metric bitwise,
    the parameters bitwise; images/s of both (steps 2-4) and the seconds
    each step waited in ``next()``; 157: the same with
    ``fit(steps_per_dispatch=4, num_steps=8)``, the capture of the step made
    while the prefetcher's worker stages a batch (its source held until the
    capture has begun, the capture held until the batch is on the card:
    allocations, a pinned copy and a copy on the worker's stream from
    another thread); 158: ``validate`` over one epoch of
    ``eval_pipeline(640)`` through a prefetcher, which must launch K1f, K2,
    K3 and K4.  Returns the three paths' launches."""
    collate = collate_detection(MAX_TARGETS)
    launches = {}

    t0 = time.perf_counter()
    loader = coco_loader(image_dir, ann_file, "boxes", collate, train_pipeline(SIZE))
    hosts = [next(loader) for _ in range(2 * DATA_DISPATCH)]
    loader_s = time.perf_counter() - t0
    loader.close()
    x, t = hosts[0]
    if (x.shape, x.dtype, t["classes"].dtype, t["boxes"].shape) != (
            (BATCH, SIZE, SIZE, 3), np.float32, np.int32, (BATCH, MAX_TARGETS, 4)) or not all(
            (h[1]["classes"] >= 0).any(axis=1).all() for h in hosts):
        raise AssertionError(f"the loader's batches: {x.shape} {x.dtype}, classes {t['classes'].dtype}")
    loader_rate = len(hosts) * BATCH / loader_s
    stages = augment_stages_ms(image_dir, ann_file)
    print(f"  phase 155, the loader alone ({DATA_WORKERS} threads): {len(hosts)} batches of {BATCH} at {SIZE} px in "
          f"{loader_s:.2f} s, {loader_rate:.2f} images/s (decode, augment, collate; {len(os.sched_getaffinity(0))} "
          f"cores) [{card}]; one thread's host ms a sample, by stage (zoom-out at 1.5-2x): "
          f"{ {k: round(v, 1) for k, v in stages.items()} }; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with cudnn_deterministic():
        staged = [to_device(h) for h in hosts]
        torch.cuda.synchronize()
        reference = data_trainer()
        want = logged_fit(reference, staged[:DATA_STEPS], DATA_STEPS)
        trainer = data_trainer()
        prefetcher = DevicePrefetcher(coco_loader(image_dir, ann_file, "boxes", collate, train_pipeline(SIZE)))
        tap = Tap(prefetcher)
        reset_counts()
        got = logged_fit(trainer, tap, DATA_STEPS)
        launches["data_train"] = read_counts(TRAIN_KERNELS)
        pinned = prefetcher.pinned_bytes
        prefetcher.close()
    check_delivered(tap.kept, hosts, "phase 156")
    if [(s, m) for s, _, m in got] != [(s, m) for s, _, m in want]:
        raise AssertionError(f"phase 156: fit through the prefetcher logged {[m['trainer/loss'] for _, _, m in got]},"
                             f" on staged batches {[m['trainer/loss'] for _, _, m in want]}")
    if not states_equal(trainer.model.state_dict(), reference.model.state_dict()) or any(
            n == 0 for n in launches["data_train"].values()):
        raise AssertionError(f"phase 156: the parameters differ, or the kernels launched {launches['data_train']}")
    print(f"  phase 156, fit of {DATA_STEPS} bf16 steps fed by the prefetcher: losses "
          f"{[round(m['trainer/loss'], 6) for _, _, m in got]} bitwise those on staged batches, parameters bitwise; "
          f"the first two batches bitwise their host batches (channels_last f32, int64 classes); "
          f"{images_per_s(got):.2f} images/s through the prefetcher, {images_per_s(want):.2f} on staged batches "
          f"(steps 2-{DATA_STEPS}); next() waited {[round(w * 1000, 1) for w in tap.waits]} ms; pinned staging "
          f"{pinned / 2**20:.1f} MiB [{card}]; kernel launches {launches['data_train']}; "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with cudnn_deterministic():
        reference = data_trainer()
        want = logged_fit(reference, staged, 2 * DATA_DISPATCH, DATA_DISPATCH)
        trainer = data_trainer()
        held = threading.Event()
        source = coco_loader(image_dir, ann_file, "boxes", collate, train_pipeline(SIZE))

        def gated():
            # the worker stages batches 4 and 5 while the consumer takes 0-3,
            # then waits here for batch 6 until the capture has begun
            for i, batch in enumerate(source):
                if i == DATA_DISPATCH + 2 and not held.wait(timeout=600):
                    raise TimeoutError("the capture never began")
                yield batch

        prefetcher = DevicePrefetcher(gated())
        tap = Tap(prefetcher)
        step_body, seen = trainer._step_body, []

        def step_in_capture(x, targets):
            if torch.cuda.is_current_stream_capturing() and not seen:
                before = prefetcher.staged
                held.set()
                deadline = time.perf_counter() + 600
                while prefetcher.staged == before and prefetcher.thread.is_alive():
                    if time.perf_counter() > deadline:
                        raise TimeoutError("the prefetcher staged nothing during the capture")
                    time.sleep(0.01)
                seen.append(prefetcher.staged - before)
            return step_body(x, targets)

        trainer._step_body = step_in_capture
        reset_counts()
        got = logged_fit(trainer, tap, 2 * DATA_DISPATCH, DATA_DISPATCH)
        launches["data_train_scanned"] = read_counts(TRAIN_KERNELS)
        prefetcher.close()
        del trainer._step_body
    check_delivered(tap.kept, hosts, "phase 157")
    if [(s, m) for s, _, m in got] != [(s, m) for s, _, m in want] or not states_equal(
            trainer.model.state_dict(), reference.model.state_dict()):
        raise AssertionError(f"phase 157: dispatched fit through the prefetcher logged "
                             f"{[m['trainer/loss'] for _, _, m in got]}, on staged batches "
                             f"{[m['trainer/loss'] for _, _, m in want]}, or the parameters differ")
    if len(seen) != 1 or trainer.graph_stats["captures"] != 1 or any(
            n == 0 for n in launches["data_train_scanned"].values()):
        raise AssertionError(f"phase 157: staged during the capture {seen}, {trainer.graph_stats}, "
                             f"launches {launches['data_train_scanned']}")
    print(f"  phase 157, fit(steps_per_dispatch={DATA_DISPATCH}) of {2 * DATA_DISPATCH} bf16 steps fed by the "
          f"prefetcher, which staged a batch on its own stream during the capture: the logged losses "
          f"{[round(m['trainer/loss'], 6) for _, _, m in got]} and the parameters bitwise those on staged batches; "
          f"the second dispatch (replays) {images_per_s(got, DATA_DISPATCH):.2f} images/s through the prefetcher, "
          f"{images_per_s(want, DATA_DISPATCH):.2f} on staged batches; next() waited "
          f"{[round(w * 1000, 1) for w in tap.waits]} ms; capture {trainer.graph_stats['capture_s']:.2f} s [{card}]; "
          f"kernel launches {launches['data_train_scanned']} (the first dispatch's eager step and capture); "
          f"{time.perf_counter() - t0:.1f} s")
    del staged, reference

    t0 = time.perf_counter()
    with DevicePrefetcher(coco_loader(image_dir, ann_file, "boxes", collate, eval_pipeline(SIZE), epochs=1,
                                      shuffle=False)) as prefetcher:
        tap = Tap(prefetcher, keep=0)
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        metrics = trainer.validate(tap)
        t_val = time.perf_counter() - t1
        launches["data_validate"] = read_counts(VALIDATE_KERNELS)
    backward = read_counts(("fused_mlp_backward",))
    if (len(tap.waits) != len(CocoDataset(image_dir, ann_file).items) // BATCH or any(
            n == 0 for n in launches["data_validate"].values()) or any(backward.values())
            or not all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"phase 158: validate over {len(tap.waits)} batches launched "
                             f"{launches['data_validate']}, backward {backward}; metrics {metrics}")
    print(f"  phase 158, validate over one epoch of eval_pipeline({SIZE}) through the prefetcher: "
          f"{len(tap.waits)} batches, {len(tap.waits) * BATCH / t_val:.2f} images/s (the host's mAP "
          f"included), map_50 {metrics['head0/valid/map_50']:.4f}; kernel launches {launches['data_validate']} "
          f"[{card}]; {time.perf_counter() - t0:.1f} s")
    return launches


def instance_data_phase(image_dir, ann_file, card: str) -> dict:
    """Phase 159: the instance segmenter fed from the files
    (``CocoDataset(task="masks")`` -> ``train_pipeline(640)`` ->
    ``batched_loader`` -> ``collate_instance_segmentation(100)``, masks
    (16, 100, 640, 640) f32 -> ``DevicePrefetcher``), ``fit`` of 4 bf16
    eager steps, which must launch K5f and K5b (and K1f, K1b, K2, K3, K4);
    the collate's host ms a batch, the seconds each step waited in
    ``next()`` and the pinned staging bytes printed.  Returns its launches."""
    t0 = time.perf_counter()
    collate_ms = []
    collate = collate_instance_segmentation(MAX_TARGETS)

    def timed_collate(samples):
        t1 = time.perf_counter()
        out = collate(samples)
        collate_ms.append((time.perf_counter() - t1) * 1000)
        return out

    trainer = data_trainer(build_instance)
    with DevicePrefetcher(coco_loader(image_dir, ann_file, "masks", timed_collate, train_pipeline(SIZE))) as prefetcher:
        tap = Tap(prefetcher, keep=1)
        reset_counts()
        log = logged_fit(trainer, tap, DATA_STEPS)
        launches = read_counts(INSTANCE_TRAIN_KERNELS)
        pinned = prefetcher.pinned_bytes
    x, targets = tap.kept[0]
    if targets["masks"].shape != (BATCH, MAX_TARGETS, SIZE, SIZE) or any(n == 0 for n in launches.values()) or not all(
            math.isfinite(m["trainer/loss"]) for _, _, m in log):
        raise AssertionError(f"phase 159: masks {tuple(targets['masks'].shape)}, launches {launches}, "
                             f"losses {[m['trainer/loss'] for _, _, m in log]}")
    print(f"  phase 159, instance segmenter fed by the prefetcher, {DATA_STEPS} bf16 steps on masks "
          f"{tuple(targets['masks'].shape)}: losses {[round(m['trainer/loss'], 4) for _, _, m in log]}; "
          f"{images_per_s(log):.2f} images/s (steps 2-{DATA_STEPS}); the collate's host ms a batch "
          f"{[round(v) for v in collate_ms]}; next() waited {[round(w * 1000, 1) for w in tap.waits]} ms; pinned "
          f"staging {pinned / 2**30:.2f} GiB [{card}]; kernel launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


def native_batch_phase(card: str) -> None:
    """Phase 160: ``batch_resize_normalize`` (the native C++ library, built
    with g++ here) on 16 uint8 images of 480 x 640 to 640 x 640 with
    ImageNet's mean and std, against its numpy version within 2e-5."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(DATA_SEED)
    images = [rng.randint(0, 256, (480, 640, 3), np.uint8) for _ in range(BATCH)]
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    batch_resize_normalize(images[:1], SIZE, mean, std)  # the build
    t1 = time.perf_counter()
    native = batch_resize_normalize(images, SIZE, mean, std)
    native_ms = (time.perf_counter() - t1) * 1000
    t1 = time.perf_counter()
    plain = batch_resize_normalize(images, SIZE, mean, std, force_numpy=True)
    plain_ms = (time.perf_counter() - t1) * 1000
    err = float(np.abs(native - plain).max())
    if native.shape != (BATCH, SIZE, SIZE, 3) or err > 2e-5:
        raise AssertionError(f"phase 160: the native batch {native.shape} lies {err} from its numpy version")
    print(f"  phase 160, batch_resize_normalize 16 x 480x640 -> {SIZE}: native {native_ms:.1f} ms "
          f"({len(os.sched_getaffinity(0))} cores), numpy {plain_ms:.1f} ms, max difference {err:.3g} [{card}]; "
          f"{time.perf_counter() - t0:.1f} s")


def data_phases() -> dict:
    """Phases 154-160: a synthetic COCO set written to a temporary directory,
    then the flagship and the instance segmenter fed from it and the native
    batch path.  Returns the data paths' launches."""
    card = card_name()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        image_dir, ann_file, written = write_coco_set(Path(root))
        dataset = CocoDataset(image_dir, ann_file, task="masks")
        data = json.loads(ann_file.read_text())
        rle = next(a for a in data["annotations"] if isinstance(a["segmentation"], dict))
        counts = rle["segmentation"]["counts"]
        h, w = rle["segmentation"]["size"]
        want = np.repeat(np.arange(len(counts)) % 2, counts).reshape(w, h).T
        kept = {a["id"] for _, anns in dataset.items for a in anns}
        crowd = [a["id"] for a in data["annotations"] if a["iscrowd"]]
        if (len(dataset) != COCO_IMAGES - 1 or not np.array_equal(dataset[1]["masks"][0], want)
                or any(c in kept for c in crowd)):
            raise AssertionError(f"phase 154: {len(dataset)} images kept, the RLE mask or the crowd annotation wrong")
        print(f"  phase 154, a COCO set of {COCO_IMAGES} PNGs ({written / 2**20:.1f} MiB) at {COCO_SHAPES}, "
              f"{len(data['annotations'])} annotations: {len(dataset)} images kept (a missing file dropped, a crowd "
              f"annotation skipped), the RLE mask decoded; {time.perf_counter() - t0:.1f} s")
        launches = flagship_data_phases(image_dir, ann_file, card)
        launches["data_instance_train"] = instance_data_phase(image_dir, ann_file, card)
    native_batch_phase(card)
    return launches


def main() -> None:
    # phase 1: device
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    print(f"card: {card_name()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
          f"{torch.get_num_threads()} CPU threads, {len(os.sched_getaffinity(0))} cores available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # phase 2: build, every kernel at once
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def upsample_add_once():
        cl = torch.channels_last
        small = torch.zeros(1, 8, 2, 2, device="cuda").contiguous(memory_format=cl)
        fusion.fused_upsample_add(small, torch.zeros(1, 8, 4, 4, device="cuda").contiguous(memory_format=cl))
        torch.cuda.synchronize()

    def weighted_sum_once():
        cl = torch.channels_last
        small = [torch.zeros(1, 8, 2, 2, device="cuda").contiguous(memory_format=cl) for _ in range(2)]
        fusion.fused_weighted_sum(torch.full((2,), 0.5, device="cuda"), small)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(9) as pool:
        builds = [pool.submit(timed, fn) for fn in (
            fused_mlp._library, topk._library, dynconv._library, stem._library, conv_probes._library,
            stem_variants._library, mlp_pipeline._library, upsample_add_once, weighted_sum_once,
        )]
        t_mlp, t_topk, t_dynconv, t_stem, t_probes, t_variants, t_pipeline, t_triton, t_triton6 = (
            b.result() for b in builds)
    print(f"build (in parallel, {time.perf_counter() - t0:.1f} s): fused_mlp K1f + K1b (CUDA C++, "
          f"sm_90a) {t_mlp:.1f} s; row_kth K2 (CUDA C++, sm_90a) {t_topk:.1f} s; dynconv K5f + K5b "
          f"(CUDA C++, sm_90a) {t_dynconv:.1f} s; stem_conv_stats K4 (CUDA C++, sm_90a) {t_stem:.1f} s; "
          f"conv_probes P4 + P5 + P2 (CUDA C++, sm_90a) {t_probes:.1f} s; "
          f"stem_variants P3 (CUDA C++, sm_90a) {t_variants:.1f} s; "
          f"mlp_pipeline P1 (CUDA C++, sm_90a, with K1f's device code) {t_pipeline:.1f} s; "
          f"upsample_add K3 (Triton) {t_triton:.1f} s; weighted_sum K6 (Triton) {t_triton6:.1f} s")

    # phase 3: kernels against their plain versions
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    cuda_gen = torch.Generator("cuda").manual_seed(0)
    _, train_targets = training_batch(BATCH)
    kernels = check_kernels(gen, cuda_gen, train_targets)
    kernels.update(check_instance_kernels(gen, cuda_gen, train_targets))
    kernels.update(check_quad_kernels(gen, cuda_gen, kernels))

    print(f"phase 3 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # phase 4: serving slice parity, f32, card against CPU
    model = build_flagship(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_slice(model, gen)

    # phase 5: serving in bf16 through the kernels
    launches = {"serve": serve_phase(model, build_flagship, cuda_gen, ("fused_mlp", "upsample_add"), "serving")}

    # phase 6: training-slice parity, card f32 against CPU f64
    check_train_slice(model, gen)
    del model

    # phase 7: the bf16 training step through the kernels
    launches["train"] = train()

    print(f"phases 4-7 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # phases 8-11: instance segmentation, the same four
    model = build_instance(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_instance_slice(model, gen)
    launches["instance_serve"] = serve_phase(
        model, build_instance, cuda_gen, ("fused_mlp", "upsample_add", "dynconv_decode"), "instance serving")
    check_train_slice(model, gen, build_instance, instance_batch(2, seed=1, mask_size=SIZE // 2),
                      "instance train slice")
    del model
    launches["instance_train"] = train(build_instance, instance_batch(BATCH), INSTANCE_TRAIN_KERNELS,
                                       label="instance training")

    print(f"phases 8-11 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # phases 12-15: the quadrilateral detector, the same four
    model = build_quad(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_quad_slice(model, gen)
    launches["quad_serve"] = serve_phase(model, build_quad, cuda_gen, ("fused_mlp", "weighted_sum"), "quad serving")
    check_train_slice(model, gen, build_quad, quad_batch(2, seed=1), "quad train slice")
    del model
    launches["quad_train"] = train(
        build_quad, quad_batch(BATCH), ("fused_mlp", "fused_mlp_backward", "weighted_sum", "stem_conv_stats"),
        label="quad training")

    print(f"phases 12-15 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # phase 16: the backbone-conv probes
    probes = probes_phase()

    # phase 17: the stem-variant probe
    probes += stem_variants_phase()

    # phase 18: the fused-MLP pipeline probe
    probes += mlp_pipeline_phase()

    print(f"phases 16-18 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    # phase 19: validation parity, f32, card against CPU
    check_validate_slice(gen)

    # phases 20-22: fit, validate and checkpoints of each model, bf16
    # (level 1 is frozen, so the stem runs K4 in eval mode too)
    launches["validate"] = fit_phase(
        build_flagship, [training_batch(BATCH), training_batch(BATCH, seed=4)],
        ("fused_mlp", "row_kth", "upsample_add", "stem_conv_stats"), "flagship fit")
    # one batch: the host's mask mAP over two took 14-39 s a validate, by
    # host, 23 s of the phase's 33 s
    launches["instance_validate"] = fit_phase(
        build_instance, [instance_batch(BATCH)],
        ("fused_mlp", "row_kth", "upsample_add", "dynconv_decode", "stem_conv_stats"), "instance fit")
    launches["quad_validate"] = fit_phase(
        build_quad, [quad_batch(BATCH), quad_batch(BATCH, seed=4)], ("fused_mlp", "weighted_sum", "stem_conv_stats"),
        "quad fit")

    print(f"phases 19-22 in {time.perf_counter() - t0:.1f} s")

    # phases 23-27: the classifier
    t0 = time.perf_counter()
    launches.update(classifier_phases(gen, cuda_gen))
    print(f"phases 23-27 in {time.perf_counter() - t0:.1f} s")

    # phases 28-37: the dense model, then the panoptic model; K3 merges 128
    # channels on both, the panoptic head's instance branch runs K1 and K5 at
    # the instance model's shapes (80 classes, 100 instances, 256 positives)
    t0 = time.perf_counter()
    kernels["upsample_add@fpn128"] = k3_cases(cuda_gen, DENSE_WIDTH)
    launches.update(dense_phases(gen, cuda_gen))
    print(f"phases 28-32 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(panoptic_phases(gen, cuda_gen))
    print(f"phases 33-37 in {time.perf_counter() - t0:.1f} s")

    # phases 38-47: the canonical detector (HybridEncoder), then the multitask
    # model; first K1 and K2 at the shapes they add
    t0 = time.perf_counter()
    kernels.update(new_path_kernels(gen, cuda_gen, kernels))
    launches.update(hybrid_phases(gen, cuda_gen))
    print(f"phases 38-42 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(multitask_phases(gen, cuda_gen))
    print(f"phases 43-47 in {time.perf_counter() - t0:.1f} s")

    # phases 48-62: the autoencoder, the view-invariance model and the
    # anomaly model; each runs K4 alone, at the shape phase 3 held
    for first, phases in ((48, autoencoder_phases), (53, view_invariance_phases), (58, anomaly_phases)):
        t0 = time.perf_counter()
        launches.update(phases(gen, cuda_gen))
        print(f"phases {first}-{first + 4} in {time.perf_counter() - t0:.1f} s")

    # phases 63-67: the keypoint model; first K1 and K2 at its calls (K1f and
    # K1b with the 2,737-wide kernel MLP), its K5f and K5b held in phase 3
    t0 = time.perf_counter()
    kernels.update(keypoint_kernels(gen, cuda_gen))
    launches.update(keypoint_phases(gen, cuda_gen))
    print(f"phases 63-67 in {time.perf_counter() - t0:.1f} s")

    # phases 68-76: the pretrained PAN detector and the ResNetV2 detector, at
    # the flagship's kernel shapes (phase 3); phase 77: the rest of M16
    t0 = time.perf_counter()
    launches.update(pan_phases(gen, cuda_gen))
    print(f"phases 68-72 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(resnetv2_phases(gen, cuda_gen))
    print(f"phases 73-76 in {time.perf_counter() - t0:.1f} s")
    m16_phase(gen)

    # phases 78-87: the EfficientDet-D0-shaped detector (first K1, K2 and K6
    # at the shapes it adds), the MobileNetV3-large detector (the flagship's
    # kernel shapes) and every inverted-residual name
    t0 = time.perf_counter()
    kernels.update(effdet_kernels(gen, cuda_gen))
    launches.update(effdet_phases(gen, cuda_gen))
    print(f"phases 78-82 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(mnv3_phases(gen, cuda_gen))
    print(f"phases 83-86 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m17_phase(gen)
    print(f"phase 87 in {time.perf_counter() - t0:.1f} s")

    # phases 88-97: the pretrained ConvNeXt-T + FPN detector (the flagship's
    # kernel shapes), the pretrained DenseNet-121 classifier (no TPU kernel)
    # and every ConvNeXt, MobileNetV4, DenseNet and ShuffleNetV2 name
    t0 = time.perf_counter()
    launches.update(convnext_phases(gen, cuda_gen))
    print(f"phases 88-92 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    densenet_phases(gen, cuda_gen)
    print(f"phases 93-96 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m17_phase(gen, M17_SECOND, M17_SECOND_TRAIN, "M17 (second part)")
    print(f"phase 97 in {time.perf_counter() - t0:.1f} s")

    # phases 98-108: the DLA-34 + FPN detector (first K3 at its 512 px
    # merges; K1 and K2 at EfficientDet's shapes), the HRNetV2-W48 segmenter
    # (no TPU kernel) and every DLA and HRNet name
    t0 = time.perf_counter()
    kernels.update(dla_kernels(cuda_gen))
    launches.update(dla_phases(gen, cuda_gen))
    print(f"phases 98-103 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hrnet_phases(gen, cuda_gen)
    print(f"phases 104-107 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m17_phase(gen, M17_LAST, M17_LAST_TRAIN, "M17 (DLA and HRNet)", drift_names=M17_LAST_DRIFT)
    print(f"phase 108 in {time.perf_counter() - t0:.1f} s")

    # phases 109-117: the optimizer family on the card, and the scanned
    # dispatch (one CUDA graph of a step, replayed) of the flagship and the
    # instance segmenter: K1f, K1b, K2, K3, K4, and K5f and K5b
    t0 = time.perf_counter()
    launches.update(scanned_phases(gen, cuda_gen))
    print(f"phases 109-117 in {time.perf_counter() - t0:.1f} s")

    # phases 118-153: the other eighteen models' scanned dispatches, each
    # step one CUDA graph of its kernels (K6 on the quad model and
    # EfficientDet, K5f and K5b at c = 32 and the wide K1 on the keypoint
    # model), the multitask model's with its dropout
    t0 = time.perf_counter()
    launches.update(models_scanned_phases())
    print(f"phases 118-153 in {time.perf_counter() - t0:.1f} s")

    # phases 154-160: the data feed, files to the card: a synthetic COCO set,
    # the flagship's fit and validate and the instance segmenter's steps
    # through the loader and the prefetcher, the native batch path
    t0 = time.perf_counter()
    launches.update(data_phases())
    print(f"phases 154-160 in {time.perf_counter() - t0:.1f} s")

    # each validate batch runs the serving forward and the training step's
    # forward once: K1f at both shapes of each, K5f at both decodes
    kernels["fused_mlp@validate"] = kernels["fused_mlp"] + kernels["fused_mlp@train"]
    kernels["fused_mlp@instance_validate"] = kernels["fused_mlp@instance_serve"] + kernels["fused_mlp@instance_train"]
    kernels["fused_mlp@quad_validate"] = kernels["fused_mlp@quad_serve"] + kernels["fused_mlp@quad_train"]
    kernels["dynconv_decode@validate"] = kernels["dynconv_decode"] + kernels["dynconv_decode@train"]
    kernels["dynconv_decode@keypoint_validate"] = (kernels["dynconv_decode@keypoint_serve"]
                                                   + kernels["dynconv_decode@keypoint_train"])
    # the EfficientDet-D0-shaped detector's gathered calls are the flagship's
    for key, flagship in (("fused_mlp@effdet_serve", "fused_mlp"), ("fused_mlp@effdet_train", "fused_mlp@train"),
                          ("fused_mlp_backward@effdet_train", "fused_mlp_backward")):
        kernels[key] += [c for c in kernels[flagship] if c["label"] == "gathered"]
    kernels["fused_mlp@effdet_validate"] = kernels["fused_mlp@effdet_serve"] + kernels["fused_mlp@effdet_train"]

    # one entry for each kernel on each path, with its launches there and one
    # call of each shape that path gives it (bf16)
    mlp_cu, mlp_py = "sihl_tpu_torch/ops/csrc/fused_mlp.cu", "sihl_tpu/ops/pallas/mlp.py"
    fusion_tr, fusion_py = "sihl_tpu_torch/ops/fusion_triton.py", "sihl_tpu/ops/pallas/fusion.py:59"
    topk_cu, topk_py = "sihl_tpu_torch/ops/csrc/topk.cu", "sihl_tpu/ops/pallas/topk.py:51"
    dyn_cu, dyn_py = "sihl_tpu_torch/ops/csrc/dynconv.cu", "sihl_tpu/ops/pallas/dynconv.py"
    stem_cu, stem_py = "sihl_tpu_torch/ops/csrc/stem.cu", "sihl_tpu/ops/pallas/stem.py:179"
    fusion6_py = "sihl_tpu/ops/pallas/fusion.py:138"
    KERNEL_SOURCES = {
        "fused_mlp": ("cuda", mlp_cu, f"{mlp_py}:204"), "fused_mlp_backward": ("cuda", mlp_cu, f"{mlp_py}:365"),
        "row_kth": ("cuda", topk_cu, topk_py), "upsample_add": ("triton", fusion_tr, fusion_py),
        "weighted_sum": ("triton", fusion_tr, fusion6_py), "dynconv_decode": ("cuda", dyn_cu, f"{dyn_py}:257"),
        "dynconv_decode_backward": ("cuda", dyn_cu, f"{dyn_py}:290"), "stem_conv_stats": ("cuda", stem_cu, stem_py),
    }
    summary = []
    for name, path, key, route, source, replaces, counter in (
        ("fused_mlp", "serve", "fused_mlp", "cuda", mlp_cu, f"{mlp_py}:204", "fused_mlp"),
        ("upsample_add", "serve", "upsample_add", "triton", fusion_tr, fusion_py, "upsample_add"),
        ("fused_mlp@train", "train", "fused_mlp@train", "cuda", mlp_cu, f"{mlp_py}:204", "fused_mlp"),
        ("fused_mlp_backward", "train", "fused_mlp_backward", "cuda", mlp_cu, f"{mlp_py}:365", "fused_mlp_backward"),
        ("row_kth", "train", "row_kth", "cuda", topk_cu, topk_py, "row_kth"),
        ("upsample_add@train", "train", "upsample_add", "triton", fusion_tr, fusion_py, "upsample_add"),
        ("fused_mlp@instance_serve", "instance_serve", "fused_mlp@instance_serve", "cuda", mlp_cu,
         f"{mlp_py}:204", "fused_mlp"),
        ("upsample_add@instance_serve", "instance_serve", "upsample_add", "triton", fusion_tr, fusion_py,
         "upsample_add"),
        ("dynconv_decode", "instance_serve", "dynconv_decode", "cuda", dyn_cu, f"{dyn_py}:257", "dynconv_decode"),
        ("fused_mlp@instance_train", "instance_train", "fused_mlp@instance_train", "cuda", mlp_cu,
         f"{mlp_py}:204", "fused_mlp"),
        ("fused_mlp_backward@instance_train", "instance_train", "fused_mlp_backward@instance_train", "cuda",
         mlp_cu, f"{mlp_py}:365", "fused_mlp_backward"),
        ("row_kth@instance_train", "instance_train", "row_kth@instance_train", "cuda", topk_cu, topk_py, "row_kth"),
        ("upsample_add@instance_train", "instance_train", "upsample_add", "triton", fusion_tr, fusion_py,
         "upsample_add"),
        ("dynconv_decode@train", "instance_train", "dynconv_decode@train", "cuda", dyn_cu, f"{dyn_py}:257",
         "dynconv_decode"),
        ("dynconv_decode_backward", "instance_train", "dynconv_decode_backward", "cuda", dyn_cu, f"{dyn_py}:290",
         "dynconv_decode_backward"),
        ("stem_conv_stats", "train", "stem_conv_stats", "cuda", stem_cu, stem_py, "stem_conv_stats"),
        ("stem_conv_stats@instance_train", "instance_train", "stem_conv_stats", "cuda", stem_cu, stem_py,
         "stem_conv_stats"),
        ("fused_mlp@quad_serve", "quad_serve", "fused_mlp@quad_serve", "cuda", mlp_cu, f"{mlp_py}:204", "fused_mlp"),
        ("weighted_sum@quad_serve", "quad_serve", "weighted_sum@serve", "triton", fusion_tr, fusion6_py,
         "weighted_sum"),
        ("fused_mlp@quad_train", "quad_train", "fused_mlp@quad_train", "cuda", mlp_cu, f"{mlp_py}:204", "fused_mlp"),
        ("fused_mlp_backward@quad_train", "quad_train", "fused_mlp_backward@quad_train", "cuda", mlp_cu,
         f"{mlp_py}:365", "fused_mlp_backward"),
        ("weighted_sum@quad_train", "quad_train", "weighted_sum@train", "triton", fusion_tr, fusion6_py,
         "weighted_sum"),
        ("stem_conv_stats@quad_train", "quad_train", "stem_conv_stats", "cuda", stem_cu, stem_py, "stem_conv_stats"),
        ("fused_mlp@validate", "validate", "fused_mlp@validate", "cuda", mlp_cu, f"{mlp_py}:204", "fused_mlp"),
        ("row_kth@validate", "validate", "row_kth", "cuda", topk_cu, topk_py, "row_kth"),
        ("upsample_add@validate", "validate", "upsample_add", "triton", fusion_tr, fusion_py, "upsample_add"),
        ("fused_mlp@instance_validate", "instance_validate", "fused_mlp@instance_validate", "cuda", mlp_cu,
         f"{mlp_py}:204", "fused_mlp"),
        ("row_kth@instance_validate", "instance_validate", "row_kth@instance_train", "cuda", topk_cu, topk_py,
         "row_kth"),
        ("upsample_add@instance_validate", "instance_validate", "upsample_add", "triton", fusion_tr, fusion_py,
         "upsample_add"),
        ("dynconv_decode@instance_validate", "instance_validate", "dynconv_decode@validate", "cuda", dyn_cu,
         f"{dyn_py}:257", "dynconv_decode"),
        ("fused_mlp@quad_validate", "quad_validate", "fused_mlp@quad_validate", "cuda", mlp_cu, f"{mlp_py}:204",
         "fused_mlp"),
        ("weighted_sum@quad_validate", "quad_validate", "weighted_sum@serve", "triton", fusion_tr, fusion6_py,
         "weighted_sum"),
        ("stem_conv_stats@validate", "validate", "stem_conv_stats", "cuda", stem_cu, stem_py, "stem_conv_stats"),
        ("stem_conv_stats@instance_validate", "instance_validate", "stem_conv_stats", "cuda", stem_cu, stem_py,
         "stem_conv_stats"),
        ("stem_conv_stats@quad_validate", "quad_validate", "stem_conv_stats", "cuda", stem_cu, stem_py,
         "stem_conv_stats"),
        ("stem_conv_stats@classifier_serve", "classifier_serve", "stem_conv_stats", "cuda", stem_cu, stem_py,
         "stem_conv_stats"),
        ("stem_conv_stats@classifier_train", "classifier_train", "stem_conv_stats", "cuda", stem_cu, stem_py,
         "stem_conv_stats"),
        ("stem_conv_stats@classifier_validate", "classifier_validate", "stem_conv_stats", "cuda", stem_cu,
         stem_py, "stem_conv_stats"),
        *((f"upsample_add@{path}", path, "upsample_add@fpn128", "triton", fusion_tr, fusion_py, "upsample_add")
          for path in ("dense_serve", "dense_train", "dense_validate", "panoptic_serve", "panoptic_train",
                       "panoptic_validate")),
        *((f"stem_conv_stats@{path}", path, "stem_conv_stats", "cuda", stem_cu, stem_py, "stem_conv_stats")
          for path in ("dense_serve", "dense_train", "dense_validate", "panoptic_serve", "panoptic_train",
                       "panoptic_validate")),
        ("fused_mlp@panoptic_serve", "panoptic_serve", "fused_mlp@instance_serve", "cuda", mlp_cu,
         f"{mlp_py}:204", "fused_mlp"),
        ("dynconv_decode@panoptic_serve", "panoptic_serve", "dynconv_decode", "cuda", dyn_cu, f"{dyn_py}:257",
         "dynconv_decode"),
        ("fused_mlp@panoptic_train", "panoptic_train", "fused_mlp@instance_train", "cuda", mlp_cu,
         f"{mlp_py}:204", "fused_mlp"),
        ("fused_mlp_backward@panoptic_train", "panoptic_train", "fused_mlp_backward@instance_train", "cuda",
         mlp_cu, f"{mlp_py}:365", "fused_mlp_backward"),
        ("row_kth@panoptic_train", "panoptic_train", "row_kth@instance_train", "cuda", topk_cu, topk_py, "row_kth"),
        ("dynconv_decode@panoptic_train", "panoptic_train", "dynconv_decode@train", "cuda", dyn_cu,
         f"{dyn_py}:257", "dynconv_decode"),
        ("dynconv_decode_backward@panoptic_train", "panoptic_train", "dynconv_decode_backward", "cuda", dyn_cu,
         f"{dyn_py}:290", "dynconv_decode_backward"),
        ("fused_mlp@panoptic_validate", "panoptic_validate", "fused_mlp@instance_validate", "cuda", mlp_cu,
         f"{mlp_py}:204", "fused_mlp"),
        ("row_kth@panoptic_validate", "panoptic_validate", "row_kth@instance_train", "cuda", topk_cu, topk_py,
         "row_kth"),
        ("dynconv_decode@panoptic_validate", "panoptic_validate", "dynconv_decode@validate", "cuda", dyn_cu,
         f"{dyn_py}:257", "dynconv_decode"),
        *((f"fused_mlp@{path}", path, f"fused_mlp@{path}", "cuda", mlp_cu, f"{mlp_py}:204", "fused_mlp")
          for path in ("hybrid_serve", "hybrid_train", "hybrid_validate", "multitask_serve", "multitask_train",
                       "multitask_validate")),
        *((f"fused_mlp_backward@{path}", path, f"fused_mlp_backward@{path}", "cuda", mlp_cu, f"{mlp_py}:365",
           "fused_mlp_backward") for path in ("hybrid_train", "multitask_train")),
        *((f"row_kth@{model}_{path}", f"{model}_{path}", f"row_kth@{model}_train", "cuda", topk_cu, topk_py, "row_kth")
          for model in ("hybrid", "multitask") for path in ("train", "validate")),
        *((f"upsample_add@{path}", path, "upsample_add@fpn128", "triton", fusion_tr, fusion_py, "upsample_add")
          for path in ("multitask_serve", "multitask_train", "multitask_validate")),
        *((f"stem_conv_stats@{path}", path, "stem_conv_stats", "cuda", stem_cu, stem_py, "stem_conv_stats")
          for path in ("hybrid_serve", "hybrid_train", "hybrid_validate", "multitask_serve", "multitask_train",
                       "multitask_validate")),
        *((f"stem_conv_stats@{model}_{path}", f"{model}_{path}", "stem_conv_stats", "cuda", stem_cu, stem_py,
           "stem_conv_stats")
          for model in ("autoencoder", "view", "anomaly", "keypoint") for path in ("serve", "train", "validate")),
        *((f"fused_mlp@keypoint_{path}", f"keypoint_{path}", f"fused_mlp@keypoint_{path}", "cuda", mlp_cu,
           f"{mlp_py}:204", "fused_mlp") for path in ("serve", "train", "validate")),
        ("fused_mlp_backward@keypoint_train", "keypoint_train", "fused_mlp_backward@keypoint_train", "cuda", mlp_cu,
         f"{mlp_py}:365", "fused_mlp_backward"),
        *((f"row_kth@keypoint_{path}", f"keypoint_{path}", "row_kth@keypoint_train", "cuda", topk_cu, topk_py,
           "row_kth") for path in ("train", "validate")),
        *((f"upsample_add@keypoint_{path}", f"keypoint_{path}", "upsample_add@fpn128", "triton", fusion_tr, fusion_py,
           "upsample_add") for path in ("serve", "train", "validate")),
        *((f"dynconv_decode@keypoint_{path}", f"keypoint_{path}", f"dynconv_decode@keypoint_{path}", "cuda", dyn_cu,
           f"{dyn_py}:257", "dynconv_decode") for path in ("serve", "train", "validate")),
        ("dynconv_decode_backward@keypoint_train", "keypoint_train", "dynconv_decode_backward@keypoint", "cuda",
         dyn_cu, f"{dyn_py}:290", "dynconv_decode_backward"),
        # the PAN and ResNetV2 detectors run the flagship's kernel shapes
        *((f"fused_mlp@{model}_{path}", f"{model}_{path}", key, "cuda", mlp_cu, f"{mlp_py}:204", "fused_mlp")
          for model in ("pan", "v2")
          for path, key in (("serve", "fused_mlp"), ("train", "fused_mlp@train"), ("validate", "fused_mlp@validate"))
          if (model, path) != ("v2", "validate")),
        *((f"fused_mlp_backward@{model}_train", f"{model}_train", "fused_mlp_backward", "cuda", mlp_cu,
           f"{mlp_py}:365", "fused_mlp_backward") for model in ("pan", "v2")),
        *((f"row_kth@{path}", path, "row_kth", "cuda", topk_cu, topk_py, "row_kth")
          for path in ("pan_train", "pan_validate", "v2_train")),
        *((f"upsample_add@{path}", path, "upsample_add", "triton", fusion_tr, fusion_py, "upsample_add")
          for path in ("pan_serve", "pan_train", "pan_validate", "v2_serve", "v2_train")),
        *((f"stem_conv_stats@{path}", path, "stem_conv_stats", "cuda", stem_cu, stem_py, "stem_conv_stats")
          for path in ("pan_serve", "pan_train", "pan_validate", "v2_serve", "v2_train")),
        # the EfficientDet-D0-shaped detector: its dense K1 calls, K2 and K6 at its shapes
        *((f"fused_mlp@effdet_{path}", f"effdet_{path}", f"fused_mlp@effdet_{path}", "cuda", mlp_cu, f"{mlp_py}:204",
           "fused_mlp") for path in ("serve", "train", "validate")),
        ("fused_mlp_backward@effdet_train", "effdet_train", "fused_mlp_backward@effdet_train", "cuda", mlp_cu,
         f"{mlp_py}:365", "fused_mlp_backward"),
        *((f"row_kth@effdet_{path}", f"effdet_{path}", "row_kth@effdet", "cuda", topk_cu, topk_py, "row_kth")
          for path in ("train", "validate")),
        *((f"weighted_sum@effdet_{path}", f"effdet_{path}", "weighted_sum@effdet", "triton", fusion_tr, fusion6_py,
           "weighted_sum") for path in ("serve", "train", "validate")),
        # the MobileNetV3-large detector runs the flagship's kernel shapes
        *((f"fused_mlp@mnv3_{path}", f"mnv3_{path}", key, "cuda", mlp_cu, f"{mlp_py}:204", "fused_mlp")
          for path, key in (("serve", "fused_mlp"), ("train", "fused_mlp@train"))),
        ("fused_mlp_backward@mnv3_train", "mnv3_train", "fused_mlp_backward", "cuda", mlp_cu, f"{mlp_py}:365",
         "fused_mlp_backward"),
        ("row_kth@mnv3_train", "mnv3_train", "row_kth", "cuda", topk_cu, topk_py, "row_kth"),
        *((f"upsample_add@mnv3_{path}", f"mnv3_{path}", "upsample_add", "triton", fusion_tr, fusion_py, "upsample_add")
          for path in ("serve", "train")),
        # the ConvNeXt-T detector runs the flagship's kernel shapes
        *((f"fused_mlp@convnext_{path}", f"convnext_{path}", key, "cuda", mlp_cu, f"{mlp_py}:204", "fused_mlp")
          for path, key in (("serve", "fused_mlp"), ("train", "fused_mlp@train"), ("validate", "fused_mlp@validate"))),
        ("fused_mlp_backward@convnext_train", "convnext_train", "fused_mlp_backward", "cuda", mlp_cu, f"{mlp_py}:365",
         "fused_mlp_backward"),
        *((f"row_kth@convnext_{path}", f"convnext_{path}", "row_kth", "cuda", topk_cu, topk_py, "row_kth")
          for path in ("train", "validate")),
        *((f"upsample_add@convnext_{path}", f"convnext_{path}", "upsample_add", "triton", fusion_tr, fusion_py,
           "upsample_add") for path in ("serve", "train", "validate")),
        # the DLA-34 detector: K1 and K2 at EfficientDet's shapes, K3 at its 512 px merges
        *((f"fused_mlp@dla_{path}", f"dla_{path}", f"fused_mlp@effdet_{path}", "cuda", mlp_cu, f"{mlp_py}:204",
           "fused_mlp") for path in ("serve", "train", "validate")),
        ("fused_mlp_backward@dla_train", "dla_train", "fused_mlp_backward@effdet_train", "cuda", mlp_cu,
         f"{mlp_py}:365", "fused_mlp_backward"),
        *((f"row_kth@dla_{path}", f"dla_{path}", "row_kth@effdet", "cuda", topk_cu, topk_py, "row_kth")
          for path in ("train", "validate")),
        *((f"upsample_add@dla_{path}", f"dla_{path}", "upsample_add@dla", "triton", fusion_tr, fusion_py,
           "upsample_add") for path in ("serve", "train", "validate")),
        # the scanned dispatches replay the training steps' kernels at their shapes
        ("fused_mlp@train_scanned", "train_scanned", "fused_mlp@train", "cuda", mlp_cu, f"{mlp_py}:204", "fused_mlp"),
        ("fused_mlp_backward@train_scanned", "train_scanned", "fused_mlp_backward", "cuda", mlp_cu, f"{mlp_py}:365",
         "fused_mlp_backward"),
        ("row_kth@train_scanned", "train_scanned", "row_kth", "cuda", topk_cu, topk_py, "row_kth"),
        ("upsample_add@train_scanned", "train_scanned", "upsample_add", "triton", fusion_tr, fusion_py, "upsample_add"),
        ("stem_conv_stats@train_scanned", "train_scanned", "stem_conv_stats", "cuda", stem_cu, stem_py,
         "stem_conv_stats"),
        ("fused_mlp@instance_train_scanned", "instance_train_scanned", "fused_mlp@instance_train", "cuda", mlp_cu,
         f"{mlp_py}:204", "fused_mlp"),
        ("fused_mlp_backward@instance_train_scanned", "instance_train_scanned", "fused_mlp_backward@instance_train",
         "cuda", mlp_cu, f"{mlp_py}:365", "fused_mlp_backward"),
        ("row_kth@instance_train_scanned", "instance_train_scanned", "row_kth@instance_train", "cuda", topk_cu, topk_py,
         "row_kth"),
        ("upsample_add@instance_train_scanned", "instance_train_scanned", "upsample_add", "triton", fusion_tr,
         fusion_py, "upsample_add"),
        ("dynconv_decode@instance_train_scanned", "instance_train_scanned", "dynconv_decode@train", "cuda", dyn_cu,
         f"{dyn_py}:257", "dynconv_decode"),
        ("dynconv_decode_backward@instance_train_scanned", "instance_train_scanned", "dynconv_decode_backward", "cuda",
         dyn_cu, f"{dyn_py}:290", "dynconv_decode_backward"),
        ("stem_conv_stats@instance_train_scanned", "instance_train_scanned", "stem_conv_stats", "cuda", stem_cu,
         stem_py, "stem_conv_stats"),
        # the other models' scanned dispatches replay their training steps' kernels at their shapes
        *((f"{counter}@{path}", path, key, *KERNEL_SOURCES[counter], counter)
          for path, keys in SCANNED_KERNEL_CASES.items() for counter, key in keys.items()),
        # the data feed's paths run the flagship's and the instance segmenter's kernels at their shapes
        *((f"{counter}@{path}", path, key, *KERNEL_SOURCES[counter], counter)
          for path, keys in DATA_KERNEL_CASES.items() for counter, key in keys.items()),
    ):
        cases = [c for c in kernels[key] if c["path"]]
        summary.append(dict(
            name=name, path=path, route=route, source=source, replaces=replaces, launches=launches[path][counter],
            max_abs_err=max(c["err"] for c in cases),
            ms=sum(c["ms"] for c in cases), plain_ms=sum(c["plain_ms"] for c in cases),
            bound_ms=sum(c["bound_ms"] for c in cases),
            bound_by=max(cases, key=lambda c: c["bound_ms"])["bound_by"],
            library_ms=None,
            # K1f / K1b: the call as the path makes it, and the cuBLAS yardstick; K4, K5b: device time alone
            **({k: sum(c[k] for c in cases) for k in ("call_ms", "cublas_ms")} if "call_ms" in cases[0] else {}),
            **({"alone_ms": sum(c["alone_ms"] for c in cases)} if "alone_ms" in cases[0] else {}),
        ))
    summary += probes
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s after the device check")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
