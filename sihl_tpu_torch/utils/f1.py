"""Optimal-F1-threshold metric for detection.

A copy of ``sihl_tpu/utils/f1.py``, kept in the port so that it imports
nothing of the JAX package; the arithmetic is the same line for line, and
``_box_iou`` comes from the port's copy of ``coco_map``.  It finds the
confidence threshold that maximises detection F1 at an IoU cutoff
(reference ``src/sihl/utils/f1.py``, dead code there, public API in both
packages); no head calls it.

Host-side numpy; accumulates per-image predictions, greedily matches in
score order, and sweeps candidate thresholds.
"""

from typing import Dict, List, Union

import numpy as np

from sihl_tpu_torch.utils.coco_map import _box_iou


class OptimalF1Threshold:
    def __init__(
        self,
        iou_threshold: float = 0.5,
        class_metrics: bool = False,
        threshold_granularity: int = 10,
    ):
        self.iou_threshold = iou_threshold
        self.class_metrics = class_metrics
        self.threshold_granularity = threshold_granularity
        self._images: List[dict] = []

    def update(
        self,
        preds_classes,
        preds_scores,
        preds_boxes,
        target_classes,
        target_boxes,
    ) -> None:
        """One image's predictions (n,) / (n, 4) and targets (m,) / (m, 4)."""
        self._images.append(
            {
                "pc": np.asarray(preds_classes),
                "ps": np.asarray(preds_scores, np.float32),
                "pb": np.asarray(preds_boxes, np.float32),
                "tc": np.asarray(target_classes),
                "tb": np.asarray(target_boxes, np.float32),
            }
        )

    def _match(self) -> tuple:
        """Greedy per-image matching; returns (scores, is_tp, num_gt, classes)."""
        scores, is_tp, classes = [], [], []
        num_gt = 0
        for img in self._images:
            num_gt += len(img["tc"])
            order = np.argsort(-img["ps"])
            matched = np.zeros(len(img["tc"]), bool)
            ious = (
                _box_iou(img["pb"], img["tb"])
                if len(img["pb"]) and len(img["tb"])
                else np.zeros((len(img["pb"]), len(img["tb"])))
            )
            for i in order:
                cand = np.where(
                    (~matched)
                    & (img["tc"] == img["pc"][i])
                    & (ious[i] >= self.iou_threshold)
                )[0]
                tp = False
                if len(cand):
                    best = cand[np.argmax(ious[i][cand])]
                    matched[best] = True
                    tp = True
                scores.append(img["ps"][i])
                is_tp.append(tp)
                classes.append(img["pc"][i])
        return (
            np.asarray(scores, np.float32),
            np.asarray(is_tp, bool),
            num_gt,
            np.asarray(classes),
        )

    def compute(self) -> Dict[str, Union[float, Dict]]:
        scores, is_tp, num_gt, classes = self._match()
        if len(scores) == 0 or num_gt == 0:
            return {"optimal_threshold": 0.5, "best_f1": 0.0}

        uniq = np.unique(scores)
        if len(uniq) > self.threshold_granularity:
            idx = np.linspace(0, len(uniq) - 1, self.threshold_granularity).astype(int)
            thresholds = uniq[idx]
        else:
            thresholds = uniq

        def f1_at(thr, tp_mask, score_arr, n_gt):
            keep = score_arr >= thr
            tp = int((tp_mask & keep).sum())
            fp = int((~tp_mask & keep).sum())
            fn = n_gt - tp
            denom = 2 * tp + fp + fn
            return 2 * tp / denom if denom else 0.0

        f1s = [f1_at(t, is_tp, scores, num_gt) for t in thresholds]
        best = int(np.argmax(f1s))
        out = {"optimal_threshold": float(thresholds[best]), "best_f1": float(f1s[best])}
        if self.class_metrics:
            per_class = {}
            for c in np.unique(classes):
                sel = classes == c
                n_gt_c = sum(int((img["tc"] == c).sum()) for img in self._images)
                f1s_c = [f1_at(t, is_tp[sel], scores[sel], n_gt_c) for t in thresholds]
                b = int(np.argmax(f1s_c))
                per_class[int(c)] = {
                    "optimal_threshold": float(thresholds[b]),
                    "best_f1": float(f1s_c[b]),
                }
            out["per_class"] = per_class
        return out
