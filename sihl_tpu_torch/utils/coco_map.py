"""Host-side COCO-style mean-average-precision evaluation in numpy.

A copy of ``sihl_tpu/utils/coco_map.py``, kept in the port so that it
imports nothing of the JAX package; the arithmetic is the same line for
line.  It replaces the reference's ``torchmetrics.MeanAveragePrecision``
with the ``faster_coco_eval`` backend (reference ``object_detection.py:219-250``):
101-point interpolated AP averaged over IoU thresholds 0.50:0.95:0.05,
plus AP50/AP75, per-area APs and max-detection recalls — the standard
COCO protocol.

Runs on the host at validation end; the device side only produces
fixed-shape (padded) detection and ground-truth arrays, which reach it as
numpy arrays.
"""

from typing import Dict, List

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _mask_iou(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """Pairwise IoU between binary mask sets (N, H, W) x (M, H, W)."""
    if m1.shape[0] == 0 or m2.shape[0] == 0:
        return np.zeros((m1.shape[0], m2.shape[0]), np.float32)
    a = m1.reshape(m1.shape[0], -1).astype(np.float32)
    b = m2.reshape(m2.shape[0], -1).astype(np.float32)
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _nearest_resize_masks(masks: np.ndarray, size) -> np.ndarray:
    h, w = masks.shape[2:]
    ys = (np.arange(size[0]) * (h / size[0])).astype(np.int64)
    xs = (np.arange(size[1]) * (w / size[1])).astype(np.int64)
    return masks[:, :, ys][:, :, :, xs]


def _box_iou(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    area1 = np.clip(b1[:, 2] - b1[:, 0], 0, None) * np.clip(b1[:, 3] - b1[:, 1], 0, None)
    area2 = np.clip(b2[:, 2] - b2[:, 0], 0, None) * np.clip(b2[:, 3] - b2[:, 1], 0, None)
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area1[:, None] + area2[None, :] - inter, 1e-9)


class MeanAveragePrecisionAccumulator:
    """Accumulate padded per-batch detections and compute COCO mAP.

    ``update`` takes device arrays: pred boxes (B, I, 4), classes (B, I),
    scores (B, I); gt boxes (B, T, 4), gt classes (B, T) with -1 padding.
    All detections are kept (COCO maxDets=100 == the head's fixed
    ``max_instances``).
    """

    def __init__(self, max_dets=(1, 10, 100), iou_type: str = "bbox"):
        assert iou_type in ("bbox", "segm")
        self.max_dets = max_dets
        self.iou_type = iou_type
        self._images: List[dict] = []

    def update(self, pred_geoms, pred_classes, scores, gt_geoms, gt_classes) -> None:
        """``pred_geoms``/``gt_geoms``: boxes (B, N, 4) for iou_type="bbox",
        binary masks (B, N, H, W) for iou_type="segm"."""
        pred_geoms = np.asarray(pred_geoms)
        pred_classes = np.asarray(pred_classes)
        scores = np.asarray(scores, np.float32)
        gt_geoms = np.asarray(gt_geoms)
        gt_classes = np.asarray(gt_classes)
        if self.iou_type == "segm" and pred_geoms.shape[2:] != gt_geoms.shape[2:]:
            pred_geoms = _nearest_resize_masks(pred_geoms, gt_geoms.shape[2:])
        for b in range(pred_geoms.shape[0]):
            valid_gt = gt_classes[b] >= 0
            self._images.append(
                {
                    "pred_geoms": pred_geoms[b],
                    "pred_classes": pred_classes[b],
                    "scores": scores[b],
                    "gt_geoms": gt_geoms[b][valid_gt],
                    "gt_classes": gt_classes[b][valid_gt],
                }
            )

    def _iou(self, d, g) -> np.ndarray:
        if self.iou_type == "bbox":
            return _box_iou(d.astype(np.float32), g.astype(np.float32))
        return _mask_iou(d, g)

    def _areas(self, geoms) -> np.ndarray:
        if self.iou_type == "bbox":
            return (geoms[:, 2] - geoms[:, 0]) * (geoms[:, 3] - geoms[:, 1])
        if geoms.shape[0] == 0:
            return np.zeros((0,), np.float32)
        return geoms.reshape(geoms.shape[0], -1).astype(np.float32).sum(axis=1)

    # -- evaluation --------------------------------------------------------
    def compute(self) -> Dict[str, float]:
        if not self._images:
            return {}
        classes = sorted(
            {int(c) for img in self._images for c in img["gt_classes"]}
        )
        if not classes:
            return {"map": 0.0, "map_50": 0.0, "map_75": 0.0}

        # ap[class][area] -> (num_thresholds,) AP; recall similar
        aps = {a: [] for a in AREA_RANGES}
        recalls = {m: [] for m in self.max_dets}
        for c in classes:
            per_area, rec = self._evaluate_class(c)
            for a in AREA_RANGES:
                if per_area[a] is not None:
                    aps[a].append(per_area[a])
            for m in self.max_dets:
                if rec[m] is not None:
                    recalls[m].append(rec[m])

        def agg(values):
            return float(np.mean(np.stack(values))) if values else -1.0

        all_ap = np.stack(aps["all"]) if aps["all"] else np.zeros((1, len(IOU_THRESHOLDS)))
        out = {
            "map": float(np.mean(all_ap)),
            "map_50": float(np.mean(all_ap[:, 0])),
            "map_75": float(np.mean(all_ap[:, 5])),
            "map_small": agg(aps["small"]),
            "map_medium": agg(aps["medium"]),
            "map_large": agg(aps["large"]),
        }
        for m in self.max_dets:
            out[f"mar_{m}"] = agg(recalls[m])
        return out

    def _evaluate_class(self, cls: int):
        """Greedy COCO matching for one class over all images/areas."""
        dets = []  # (score, image_idx, det_idx)
        gts_per_img = []
        for i, img in enumerate(self._images):
            sel = img["pred_classes"] == cls
            for j in np.nonzero(sel)[0]:
                dets.append((img["scores"][j], i, j))
            gts_per_img.append(np.nonzero(img["gt_classes"] == cls)[0])

        dets.sort(key=lambda t: -t[0])
        num_dets = len(dets)
        num_thr = len(IOU_THRESHOLDS)

        # precompute IoUs and areas per image
        ious, gt_areas, det_areas = {}, {}, {}
        for i, img in enumerate(self._images):
            g = gts_per_img[i]
            d = [j for (_, ii, j) in dets if ii == i]
            gb = img["gt_geoms"][g]
            db = img["pred_geoms"][list(d)]
            ious[i] = (self._iou(db, gb), {j: k for k, j in enumerate(d)})
            gt_areas[i] = self._areas(gb)
            da = self._areas(db)
            det_areas[i] = {j: da[k] for k, j in enumerate(d)}

        per_area_ap = {}
        recalls = {m: None for m in self.max_dets}
        for area_name, (lo, hi) in AREA_RANGES.items():
            # gt validity per area; out-of-area gts are "ignored"
            n_gt = 0
            gt_ignore = {}
            for i in range(len(self._images)):
                a = gt_areas[i]
                ignore = ~((a >= lo) & (a < hi))
                gt_ignore[i] = ignore
                n_gt += int((~ignore).sum())
            if n_gt == 0:
                per_area_ap[area_name] = None
                continue

            tp = np.zeros((num_thr, num_dets), bool)
            ignored_det = np.zeros((num_thr, num_dets), bool)
            # per-image per-threshold matched-gt sets
            matched = {
                (t, i): np.zeros(len(gts_per_img[i]), bool)
                for t in range(num_thr)
                for i in range(len(self._images))
            }
            # track per-image detection rank for maxDets recalls (area "all")
            det_rank_in_img = np.zeros(num_dets, np.int64)
            img_counts = {}
            for k, (_, i, j) in enumerate(dets):
                det_rank_in_img[k] = img_counts.get(i, 0)
                img_counts[i] = det_rank_in_img[k] + 1

            for k, (_, i, j) in enumerate(dets):
                iou_mat, dmap = ious[i]
                row = iou_mat[dmap[j]] if iou_mat.size else np.zeros(0)
                ignore = gt_ignore[i]
                for t, thr in enumerate(IOU_THRESHOLDS):
                    m = matched[(t, i)]
                    best, best_g = thr, -1
                    # prefer non-ignored gts; fall back to ignored
                    for g_idx in np.argsort(-row) if row.size else []:
                        if m[g_idx] or row[g_idx] < thr:
                            continue
                        if best_g >= 0 and not ignore[best_g] and ignore[g_idx]:
                            break  # already have a real match
                        best_g = g_idx
                        if not ignore[g_idx]:
                            break
                    if best_g >= 0:
                        m[best_g] = True
                        if ignore[best_g]:
                            ignored_det[t, k] = True
                        else:
                            tp[t, k] = True
                    else:
                        # unmatched dets outside the area range are ignored
                        da = det_areas[i][j]
                        if not (lo <= da < hi):
                            ignored_det[t, k] = True

            # precision-recall with 101-point interpolation
            ap = np.zeros(num_thr)
            for t in range(num_thr):
                keep = ~ignored_det[t]
                tps = np.cumsum(tp[t][keep])
                fps = np.cumsum(~tp[t][keep])
                recall = tps / n_gt
                precision = tps / np.maximum(tps + fps, 1e-9)
                # monotone precision envelope
                for z in range(len(precision) - 2, -1, -1):
                    precision[z] = max(precision[z], precision[z + 1])
                recall_points = np.linspace(0, 1, 101)
                if len(precision):
                    idx = np.searchsorted(recall, recall_points, side="left")
                    prec_at = np.where(
                        idx < len(precision),
                        precision[np.minimum(idx, len(precision) - 1)],
                        0.0,
                    )
                else:
                    prec_at = np.zeros(101)
                ap[t] = prec_at.mean()
                if area_name == "all":
                    for m_det in self.max_dets:
                        if recalls[m_det] is None:
                            recalls[m_det] = np.zeros(num_thr)
                        sel = keep & (det_rank_in_img < m_det)
                        recalls[m_det][t] = tp[t][sel].sum() / n_gt
            per_area_ap[area_name] = ap
        return per_area_ap, recalls
