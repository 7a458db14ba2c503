"""Host-side augmentation (counterpart of ``sihl_tpu/data/augment.py``).

The JAX file's transforms and pipelines after its docstring, with OpenCV's
resize and colour conversions replaced by :mod:`sihl_tpu_torch.data.imgproc`,
which follows their arithmetic: every transform makes the same
``RandomState`` draws in the same order, so its geometry, masks and maps
equal the JAX package's exactly and its float32 images agree within a few
ulps (cv2's vector code fuses some multiply-adds).

A sample is a dict with an ``image`` (H, W, 3) float32 [0, 1] or uint8
array and any of: ``boxes`` (N, 4) xyxy absolute, ``classes`` (N,),
``masks`` (N, H, W), ``keypoints`` (N, K, 2) absolute xy with
``keypoint_visible`` (N, K) bools, ``quads`` (N, 4, 2), ``dense_map``
(H, W[, C]) per-pixel targets (semantic/panoptic/depth; nearest-resampled,
padded with ``dense_pad``).  The train pipeline ends with a crop to a
static size, so every batch has one shape.
"""

from typing import Callable, Dict, Optional

import numpy as np

from sihl_tpu_torch.data import imgproc

Sample = Dict[str, np.ndarray]


def _img_float(image: np.ndarray) -> np.ndarray:
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    return image.astype(np.float32)


# -- individual transforms ---------------------------------------------------


def horizontal_flip(sample: Sample) -> Sample:
    """Mirror along W; boxes map x -> W - x (xyxy stays sorted), keypoints
    map x -> W - x, masks/dense maps mirror."""
    out = dict(sample)
    w = sample["image"].shape[1]
    out["image"] = sample["image"][:, ::-1].copy()
    if "boxes" in sample and len(sample["boxes"]):
        b = np.asarray(sample["boxes"], np.float32)
        out["boxes"] = np.stack([w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], axis=1)
    if "masks" in sample and len(sample["masks"]):
        out["masks"] = np.asarray(sample["masks"])[:, :, ::-1].copy()
    if "keypoints" in sample and len(sample["keypoints"]):
        k = np.asarray(sample["keypoints"], np.float32).copy()
        k[..., 0] = w - k[..., 0]
        out["keypoints"] = k
    if "dense_map" in sample:
        out["dense_map"] = sample["dense_map"][:, ::-1].copy()
    if "quads" in sample and len(sample["quads"]):
        q = np.asarray(sample["quads"], np.float32).copy()
        q[..., 0] = w - q[..., 0]
        out["quads"] = q
    return out


def photometric_distort(sample: Sample, rng: np.random.RandomState) -> Sample:
    """Random brightness / contrast / saturation / hue jitter (the
    torchvision ``RandomPhotometricDistort`` ranges)."""
    img = _img_float(sample["image"])
    if rng.rand() < 0.5:  # brightness +- 32/255
        img = img + rng.uniform(-32.0 / 255.0, 32.0 / 255.0)
    if rng.rand() < 0.5:  # contrast 0.5..1.5
        img = (img - img.mean()) * rng.uniform(0.5, 1.5) + img.mean()
    if rng.rand() < 0.5:  # saturation 0.5..1.5
        gray = img.mean(axis=2, keepdims=True)
        img = gray + (img - gray) * rng.uniform(0.5, 1.5)
    if rng.rand() < 0.5:  # hue +- 18 degrees
        hsv = imgproc.rgb_to_hsv(np.clip(img, 0, 1))
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-18.0, 18.0)) % 360.0
        img = imgproc.hsv_to_rgb(hsv)
    out = dict(sample)
    out["image"] = np.clip(img, 0.0, 1.0)
    return out


def zoom_out(sample: Sample, rng: np.random.RandomState, side_range=(1.0, 2.0)) -> Sample:
    """Paste the image at a random offset on a larger mean-filled canvas
    (torchvision ``RandomZoomOut`` semantics)."""
    img = _img_float(sample["image"])
    h, w = img.shape[:2]
    ratio = rng.uniform(*side_range)
    if ratio <= 1.0:
        out = dict(sample)
        out["image"] = img
        return out
    nh, nw = int(round(h * ratio)), int(round(w * ratio))
    top = rng.randint(0, nh - h + 1)
    left = rng.randint(0, nw - w + 1)
    canvas = np.full((nh, nw, img.shape[2]), img.mean(axis=(0, 1)), np.float32)
    canvas[top : top + h, left : left + w] = img
    out = dict(sample)
    out["image"] = canvas
    if "boxes" in sample and len(sample["boxes"]):
        b = np.asarray(sample["boxes"], np.float32).copy()
        b[:, [0, 2]] += left
        b[:, [1, 3]] += top
        out["boxes"] = b
    if "masks" in sample and len(sample["masks"]):
        m = np.asarray(sample["masks"])
        mc = np.zeros((m.shape[0], nh, nw), m.dtype)
        mc[:, top : top + h, left : left + w] = m
        out["masks"] = mc
    if "keypoints" in sample and len(sample["keypoints"]):
        k = np.asarray(sample["keypoints"], np.float32).copy()
        k[..., 0] += left
        k[..., 1] += top
        out["keypoints"] = k
    if "quads" in sample and len(sample["quads"]):
        q = np.asarray(sample["quads"], np.float32).copy()
        q[..., 0] += left
        q[..., 1] += top
        out["quads"] = q
    if "dense_map" in sample:
        d = sample["dense_map"]
        pad = sample.get("dense_pad", 0)
        dc = np.full((nh, nw) + d.shape[2:], pad, d.dtype)
        dc[top : top + h, left : left + w] = d
        out["dense_map"] = dc
    return out


def resize(sample: Sample, size: int, max_size: Optional[int] = None) -> Sample:
    """torchvision ``Resize(size, max_size)``: shorter side -> ``size``,
    capped so the longer side stays <= ``max_size``."""
    img = _img_float(sample["image"])
    h, w = img.shape[:2]
    scale = size / min(h, w)
    if max_size is not None and scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = dict(sample)
    out["image"] = imgproc.resize(img, nh, nw, nearest=False)
    sy, sx = nh / h, nw / w
    if "boxes" in sample and len(sample["boxes"]):
        b = np.asarray(sample["boxes"], np.float32).copy()
        b[:, [0, 2]] *= sx
        b[:, [1, 3]] *= sy
        out["boxes"] = b
    if "masks" in sample and len(sample["masks"]):
        m = np.asarray(sample["masks"])
        out["masks"] = np.stack(
            [imgproc.resize(mm.astype(np.float32), nh, nw, nearest=True) for mm in m]
        )
    if "keypoints" in sample and len(sample["keypoints"]):
        k = np.asarray(sample["keypoints"], np.float32).copy()
        k[..., 0] *= sx
        k[..., 1] *= sy
        out["keypoints"] = k
    if "quads" in sample and len(sample["quads"]):
        q = np.asarray(sample["quads"], np.float32).copy()
        q[..., 0] *= sx
        q[..., 1] *= sy
        out["quads"] = q
    if "dense_map" in sample:
        out["dense_map"] = imgproc.resize(sample["dense_map"], nh, nw, nearest=True).reshape(
            (nh, nw) + sample["dense_map"].shape[2:]
        )
    return out


def random_crop(sample: Sample, size: int, rng: np.random.RandomState) -> Sample:
    """Random ``size`` x ``size`` crop, zero-padding first if the image is
    smaller (``RandomCrop(pad_if_needed=True)``); coordinates shift by the
    crop offset, boxes clip to the window, keypoints outside it are marked
    invisible."""
    img = _img_float(sample["image"])
    h, w = img.shape[:2]
    pad_h, pad_w = max(size - h, 0), max(size - w, 0)
    out = dict(sample)
    if pad_h or pad_w:
        img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)))
        if "masks" in sample and len(sample["masks"]):
            out["masks"] = np.pad(np.asarray(sample["masks"]), ((0, 0), (0, pad_h), (0, pad_w)))
        if "dense_map" in sample:
            d = sample["dense_map"]
            pad_cfg = ((0, pad_h), (0, pad_w)) + ((0, 0),) * (d.ndim - 2)
            out["dense_map"] = np.pad(
                d, pad_cfg, constant_values=sample.get("dense_pad", 0)
            )
        h, w = img.shape[:2]
    top = rng.randint(0, h - size + 1)
    left = rng.randint(0, w - size + 1)
    out["image"] = img[top : top + size, left : left + size]
    if "boxes" in sample and len(sample["boxes"]):
        b = np.asarray(sample["boxes"], np.float32).copy()
        b[:, [0, 2]] = np.clip(b[:, [0, 2]] - left, 0, size)
        b[:, [1, 3]] = np.clip(b[:, [1, 3]] - top, 0, size)
        out["boxes"] = b
    if "masks" in sample and len(sample["masks"]):
        m = out.get("masks", np.asarray(sample["masks"]))
        out["masks"] = m[:, top : top + size, left : left + size]
    if "keypoints" in sample and len(sample["keypoints"]):
        k = np.asarray(sample["keypoints"], np.float32).copy()
        k[..., 0] -= left
        k[..., 1] -= top
        inside = (
            (k[..., 0] >= 0) & (k[..., 0] < size) & (k[..., 1] >= 0) & (k[..., 1] < size)
        )
        vis = np.asarray(
            sample.get("keypoint_visible", np.ones(k.shape[:2], bool))
        ) & inside
        out["keypoints"] = k
        out["keypoint_visible"] = vis
    if "quads" in sample and len(sample["quads"]):
        q = np.asarray(sample["quads"], np.float32).copy()
        q[..., 0] -= left
        q[..., 1] -= top
        out["quads"] = q
    if "dense_map" in sample:
        d = out.get("dense_map", sample["dense_map"])
        out["dense_map"] = d[top : top + size, left : left + size]
    return out


def sanitize(sample: Sample, min_size: float = 1.0) -> Sample:
    """Drop degenerate instances (boxes thinner than ``min_size`` after
    clipping, empty masks, all-invisible keypoint sets) — the
    ``SanitizeBoundingBoxes`` step."""
    out = dict(sample)
    keep = None
    if "boxes" in sample and len(sample["boxes"]):
        b = np.asarray(sample["boxes"], np.float32)
        keep = ((b[:, 2] - b[:, 0]) >= min_size) & ((b[:, 3] - b[:, 1]) >= min_size)
    elif "masks" in sample and len(sample["masks"]):
        keep = np.asarray(sample["masks"]).sum(axis=(1, 2)) > 0
    elif "keypoint_visible" in sample and len(sample["keypoint_visible"]):
        keep = np.asarray(sample["keypoint_visible"]).any(axis=1)
    if keep is None:
        return out
    for key in ("boxes", "classes", "masks", "keypoints", "keypoint_visible", "quads"):
        if key in sample and len(sample[key]):
            out[key] = np.asarray(sample[key])[keep]
    return out


# -- pipelines ---------------------------------------------------------------


def train_pipeline(
    image_size: int,
    *,
    flip: bool = True,
    distort: bool = True,
    zoom: Optional[tuple] = (1.0, 2.0),
    seed: int = 0,
) -> Callable[[Sample], Sample]:
    """The reference train-time chain: flip -> photometric -> zoom-out ->
    resize(size-1, max=size) -> crop-to-size -> sanitize.

    Each call draws from its OWN RandomState derived from
    ``(seed, index)`` — legacy RandomState is not thread-safe, so a single
    shared stream mutated by loader worker threads would interleave
    nondeterministically.  ``batched_loader`` passes ``index = epoch*n + i``
    so the augmentation of every sample is reproducible regardless of
    thread scheduling; callers that omit ``index`` get a process-local
    counter (isolated draws, ordering-dependent seeds)."""
    import itertools

    counter = itertools.count()

    def apply(sample: Sample, index: Optional[int] = None) -> Sample:
        if index is None:
            index = next(counter)
        rng = np.random.RandomState(
            np.random.SeedSequence([seed, int(index)]).generate_state(1)[0]
        )
        if flip and rng.rand() < 0.5:
            sample = horizontal_flip(sample)
        if distort:
            sample = photometric_distort(sample, rng)
        if zoom is not None:
            sample = zoom_out(sample, rng, zoom)
        sample = resize(sample, image_size - 1, max_size=image_size)
        sample = random_crop(sample, image_size, rng)
        return sanitize(sample)

    apply.accepts_index = True
    return apply


def eval_pipeline(image_size: int, *, seed: int = 0) -> Callable[[Sample], Sample]:
    def apply(sample: Sample, index: Optional[int] = None) -> Sample:
        rng = np.random.RandomState(
            np.random.SeedSequence([seed, int(index or 0)]).generate_state(1)[0]
        )
        sample = resize(sample, image_size - 1, max_size=image_size)
        return random_crop(sample, image_size, rng)

    apply.accepts_index = True
    return apply
