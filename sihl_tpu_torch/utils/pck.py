"""Percentage of Correct Keypoints, host-side numpy.

A copy of ``sihl_tpu/utils/pck.py``, kept in the port so that it imports
nothing of the JAX package; the code after this docstring is the same byte
for byte.  It follows the reference ``src/sihl/utils/pck.py``: greedy
pred↔gt instance assignment by mean mutual-visible keypoint distance, then
per-keypoint correctness at a distance threshold (coordinates
pre-normalized by image size)."""

from typing import Dict

import numpy as np


class PercentageOfCorrectKeypoints:
    def __init__(self, threshold: float = 0.05) -> None:
        self.threshold = threshold
        self.correct = 0
        self.total = 0

    def update(self, pred_keypoints, pred_presence, gt_keypoints, gt_presence) -> None:
        pred_keypoints = np.asarray(pred_keypoints, np.float32)
        pred_presence = np.asarray(pred_presence)
        gt_keypoints = np.asarray(gt_keypoints, np.float32)
        gt_presence = np.asarray(gt_presence)

        n_pred, n_gt = pred_keypoints.shape[0], gt_keypoints.shape[0]
        if n_pred == 0 or n_gt == 0:
            if n_gt > 0:
                self.total += int((gt_presence > 0).sum())
            return

        cost = np.full((n_pred, n_gt), np.inf, np.float32)
        for i in range(n_pred):
            for j in range(n_gt):
                mutual = (pred_presence[i] > 0) & (gt_presence[j] > 0)
                if mutual.any():
                    d = np.linalg.norm(
                        pred_keypoints[i][mutual] - gt_keypoints[j][mutual], axis=-1
                    )
                    cost[i, j] = d.mean()

        used_pred = np.zeros(n_pred, bool)
        used_gt = np.zeros(n_gt, bool)
        matched_gts = set()
        while True:
            avail = cost.copy()
            avail[used_pred, :] = np.inf
            avail[:, used_gt] = np.inf
            if not np.isfinite(avail).any():
                break
            i, j = np.unravel_index(np.argmin(avail), avail.shape)
            used_pred[i] = used_gt[j] = True
            matched_gts.add(int(j))
            visible = gt_presence[j] > 0
            if visible.any():
                d = np.linalg.norm(
                    pred_keypoints[i][visible] - gt_keypoints[j][visible], axis=-1
                )
                self.correct += int((d <= self.threshold).sum())
                self.total += int(visible.sum())

        for j in range(n_gt):
            if j not in matched_gts:
                self.total += int((gt_presence[j] > 0).sum())

    def compute(self) -> Dict[str, float]:
        if self.total == 0:
            return {"PCK": 0.0}
        return {"PCK": self.correct / self.total}
