"""Panoptic Quality (Kirillov et al., https://arxiv.org/abs/1801.00868),
host-side numpy.

A copy of ``sihl_tpu/utils/panoptic_quality.py``, kept in the port so that
it imports nothing of the JAX package; the code after this docstring is the
JAX file's, byte for byte.

PQ = sum(IoU of matched segment pairs) / (|TP| + |FP|/2 + |FN|/2), with
segments matched when IoU > 0.5 (the matching is then unique).  Reported
overall and split into "things"/"stuff".
"""

from typing import Dict

import numpy as np


class PanopticQuality:
    def __init__(self, num_stuff_classes: int, ignore_index: int = -100):
        self.num_stuff = num_stuff_classes
        self.ignore_index = ignore_index
        # per-kind accumulators: iou sum, tp, fp, fn
        self.stats = {
            "things": np.zeros(4),
            "stuff": np.zeros(4),
        }

    def _kind(self, cls: int) -> str:
        return "stuff" if cls < self.num_stuff else "things"

    def update(self, pred_classes, pred_ids, gt_classes, gt_ids) -> None:
        """Per-image update. All maps (H, W): class map + segment-id map.
        Segments are (class, id) pairs; gt pixels with class == ignore_index
        are excluded."""
        pred_classes = np.asarray(pred_classes)
        pred_ids = np.asarray(pred_ids)
        gt_classes = np.asarray(gt_classes)
        gt_ids = np.asarray(gt_ids)

        valid = gt_classes != self.ignore_index

        def segments(classes, ids, mask):
            segs = {}
            combined = (ids.astype(np.int64) << 8) + 0  # id-keyed; class stored
            for key in np.unique(combined[mask]):
                sel = (combined == key) & mask
                cls_vals, counts = np.unique(classes[sel], return_counts=True)
                cls = int(cls_vals[np.argmax(counts)])
                segs[(int(key), cls)] = sel
            return segs

        gt_segs = segments(gt_classes, gt_ids, valid)
        pred_segs = segments(pred_classes, pred_ids, valid)

        matched_gt, matched_pred = set(), set()
        for gk, gmask in gt_segs.items():
            for pk, pmask in pred_segs.items():
                if pk in matched_pred or gk[1] != pk[1]:
                    continue
                inter = np.logical_and(gmask, pmask).sum()
                union = np.logical_or(gmask, pmask).sum()
                iou = inter / max(union, 1)
                if iou > 0.5:
                    kind = self._kind(gk[1])
                    self.stats[kind] += [iou, 1, 0, 0]
                    matched_gt.add(gk)
                    matched_pred.add(pk)
                    break
        for gk in gt_segs:
            if gk not in matched_gt:
                self.stats[self._kind(gk[1])][3] += 1  # FN
        for pk in pred_segs:
            if pk not in matched_pred:
                self.stats[self._kind(pk[1])][2] += 1  # FP

    def compute(self) -> Dict[str, float]:
        out = {}
        total = np.zeros(4)
        for kind, s in self.stats.items():
            total += s
            iou_sum, tp, fp, fn = s
            denom = tp + fp / 2 + fn / 2
            out[f"pq_{kind}"] = float(iou_sum / denom) if denom > 0 else 0.0
        iou_sum, tp, fp, fn = total
        denom = tp + fp / 2 + fn / 2
        out["pq"] = float(iou_sum / denom) if denom > 0 else 0.0
        return out
