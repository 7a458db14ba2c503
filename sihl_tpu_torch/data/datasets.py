"""Real-dataset loaders (counterpart of ``sihl_tpu/data/datasets.py``),
read from a local directory.

* :class:`ImageFolderDataset` -- class-per-subdirectory layout, for
  classification / metric-learning / autoencoding / view-invariance.
* :class:`CocoDataset` -- COCO-json annotations for detection, instance
  segmentation (polygons filled by :func:`~sihl_tpu_torch.data.imgproc.fill_poly`,
  ``cv2.fillPoly``'s rule; uncompressed RLE) and keypoints; crowd
  annotations and annotations of missing files are skipped.
* :class:`SegmentationFolderDataset` -- paired ``images/`` + ``masks/``
  directories of per-pixel label maps.
* :func:`batched_loader` -- shuffling, multi-threaded decode+augment, and
  padding to the heads' fixed-shape target contracts (the collates).

Samples are the augment-module dicts; images decode to RGB uint8 through
Pillow, imported when a file is opened.  The batches are numpy, in the JAX
package's layout; :func:`sihl_tpu_torch.data.to_device` and
:class:`~sihl_tpu_torch.data.DevicePrefetcher` move them to the card.
"""

import json
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from sihl_tpu_torch.data import pad_detection_targets, pad_instance_targets
from sihl_tpu_torch.data.augment import Sample
from sihl_tpu_torch.data.imgproc import fill_poly

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _pillow():
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError("decoding image files needs Pillow (the PIL package)") from err
    return Image


def load_image(path) -> np.ndarray:
    with _pillow().open(path) as im:
        return np.asarray(im.convert("RGB"))


class ImageFolderDataset:
    """``root/<class_name>/<image>`` layout; yields image + class index."""

    def __init__(self, root):
        self.root = Path(root)
        self.class_names = sorted(
            d.name for d in self.root.iterdir() if d.is_dir()
        )
        self.items: List[Tuple[Path, int]] = []
        for idx, name in enumerate(self.class_names):
            for p in sorted((self.root / name).rglob("*")):
                if p.suffix.lower() in _IMG_EXTS:
                    self.items.append((p, idx))
        if not self.items:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Sample:
        path, label = self.items[idx]
        return {"image": load_image(path), "label": np.int32(label)}


class CocoDataset:
    """COCO-format annotations (detection / instance-seg / keypoints).

    ``ann_file`` is an ``instances_*.json`` / ``person_keypoints_*.json``;
    ``image_dir`` the matching image directory.  Crowd annotations are
    skipped like the reference (:158-160); category ids are remapped to a
    contiguous [0, num_classes) index.
    """

    def __init__(self, image_dir, ann_file, task: str = "boxes"):
        assert task in ("boxes", "masks", "keypoints")
        self.image_dir = Path(image_dir)
        self.task = task
        with open(ann_file) as f:
            data = json.load(f)
        self.cat_ids = sorted(c["id"] for c in data.get("categories", []))
        self.cat_index = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.class_names = [
            c["name"] for c in sorted(data.get("categories", []), key=lambda c: c["id"])
        ]
        images = {im["id"]: im for im in data["images"]}
        by_image: Dict[int, List[dict]] = {}
        for ann in data["annotations"]:
            if ann.get("iscrowd"):
                continue
            if not (self.image_dir / images[ann["image_id"]]["file_name"]).exists():
                continue
            by_image.setdefault(ann["image_id"], []).append(ann)
        self.items = [(images[i], anns) for i, anns in sorted(by_image.items())]
        if not self.items:
            raise FileNotFoundError(f"no annotated images under {image_dir}")

    def __len__(self):
        return len(self.items)

    def _polygons_to_mask(self, segm, h: int, w: int) -> np.ndarray:
        mask = np.zeros((h, w), np.uint8)
        if isinstance(segm, list):  # polygon(s), each filled on its own
            for poly in segm:
                pts = np.asarray(poly, np.float32).reshape(-1, 2)
                fill_poly(mask, np.round(pts).astype(np.int32), 1)
        elif isinstance(segm, dict):  # uncompressed RLE
            counts, val, pos = segm["counts"], 0, 0
            flat = np.zeros(h * w, np.uint8)
            for c in counts:
                if val:
                    flat[pos : pos + c] = 1
                pos += c
                val ^= 1
            mask = flat.reshape(w, h).T  # RLE is column-major
        return mask

    def __getitem__(self, idx: int) -> Sample:
        info, anns = self.items[idx]
        image = load_image(self.image_dir / info["file_name"])
        h, w = image.shape[:2]
        sample: Sample = {"image": image}
        classes = np.asarray(
            [self.cat_index[a["category_id"]] for a in anns], np.int32
        )
        boxes = np.asarray(
            [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
              a["bbox"][1] + a["bbox"][3]] for a in anns],
            np.float32,
        )
        sample["classes"] = classes
        sample["boxes"] = boxes
        if self.task == "masks":
            sample["masks"] = np.stack(
                [self._polygons_to_mask(a.get("segmentation", []), h, w) for a in anns]
            )
        elif self.task == "keypoints":
            kps = np.asarray(
                [np.asarray(a["keypoints"], np.float32).reshape(-1, 3) for a in anns]
            )
            sample["keypoints"] = kps[..., :2]
            sample["keypoint_visible"] = kps[..., 2] > 0
        return sample


class SegmentationFolderDataset:
    """``root/images/*`` + ``root/masks/*`` (same stem, label-map pngs)."""

    def __init__(self, root):
        root = Path(root)
        self.pairs = []
        masks = {p.stem: p for p in (root / "masks").iterdir()} if (root / "masks").is_dir() else {}
        for p in sorted((root / "images").iterdir()):
            if p.suffix.lower() in _IMG_EXTS and p.stem in masks:
                self.pairs.append((p, masks[p.stem]))
        if not self.pairs:
            raise FileNotFoundError(f"no image/mask pairs under {root}")

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Sample:
        img_path, mask_path = self.pairs[idx]
        with _pillow().open(mask_path) as m:
            dense = np.asarray(m).astype(np.int32)
        return {"image": load_image(img_path), "dense_map": dense, "dense_pad": -1}


# -- batching ----------------------------------------------------------------


def batched_loader(
    dataset,
    batch_size: int,
    collate: Callable[[List[Sample]], Tuple],
    augment: Optional[Callable[[Sample], Sample]] = None,
    shuffle: bool = True,
    seed: int = 0,
    workers: int = 4,
    epochs: Optional[int] = None,
) -> Iterator[Tuple]:
    """Yield collated batches; decode+augment run on a thread pool (Pillow's
    decode and numpy's array passes release the GIL in part), the
    replacement for torch DataLoader workers."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.RandomState(seed)
    n = len(dataset)
    if n < batch_size:
        # the epoch loop below yields nothing per epoch and would spin
        # forever with epochs=None — fail loudly instead
        raise ValueError(
            f"dataset has {n} samples but batch_size={batch_size}; "
            "reduce batch_size or repeat the dataset"
        )

    # index-aware pipelines (augment.py) derive a per-sample RNG from
    # (seed, epoch*n + i) so worker threads never share a RandomState
    indexed = getattr(augment, "accepts_index", False)

    def fetch(i, epoch):
        s = dataset[int(i)]
        if augment is None:
            return s
        if indexed:
            return augment(s, index=epoch * n + int(i))
        return augment(s)

    epoch = 0
    with ThreadPoolExecutor(max_workers=workers) as pool:
        while epochs is None or epoch < epochs:
            order = rng.permutation(n) if shuffle else np.arange(n)
            for start in range(0, n - batch_size + 1, batch_size):
                idxs = order[start : start + batch_size]
                yield collate(list(pool.map(fetch, idxs, [epoch] * len(idxs))))
            epoch += 1


# -- collate functions (pad to the heads' target contracts) ------------------


def collate_classification(samples: List[Sample]) -> Tuple[np.ndarray, np.ndarray]:
    images = np.stack([s["image"] for s in samples]).astype(np.float32)
    labels = np.asarray([s["label"] for s in samples], np.int32)
    return images, labels


def collate_detection(max_targets: int):
    def collate(samples: List[Sample]):
        images = np.stack([s["image"] for s in samples]).astype(np.float32)
        targets = pad_detection_targets(
            [s.get("classes", np.zeros(0, np.int32)) for s in samples],
            [s.get("boxes", np.zeros((0, 4), np.float32)) for s in samples],
            max_targets,
        )
        return images, targets

    return collate


def collate_instance_segmentation(max_targets: int):
    def collate(samples: List[Sample]):
        images = np.stack([s["image"] for s in samples]).astype(np.float32)
        h, w = images.shape[1:3]
        targets = pad_instance_targets(
            [s.get("classes", np.zeros(0, np.int32)) for s in samples],
            [s.get("masks", np.zeros((0, h, w), np.float32)) for s in samples],
            max_targets,
            mask_size=(h, w),
        )
        return images, targets

    return collate


def collate_semantic_segmentation(samples: List[Sample]):
    images = np.stack([s["image"] for s in samples]).astype(np.float32)
    maps = np.stack([s["dense_map"] for s in samples]).astype(np.int32)
    return images, maps
