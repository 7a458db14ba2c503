"""The port's data feed (``sihl_tpu_torch/data``) against the JAX package's
(``sihl_tpu/data``) and OpenCV, on the CPU.

The same numpy inputs go through both packages.  Geometry (boxes,
keypoints, quads, crop offsets), masks and integer maps must be equal
exactly; float32 images within ``IMAGE_ATOL`` (1e-6): the port follows
OpenCV's arithmetic in numpy, and cv2's vector code fuses some
multiply-adds.

* the padding helpers, ``ArrayDataset`` and ``batched`` (with shuffle);
* ``imgproc``: cv2's nearest index map for every length pair from 1 to
  199, linear resizing and RGB <-> HSV against cv2, and ``fill_poly``
  against ``cv2.fillPoly`` on every pixel for random convex and concave
  polygons of 3-12 integer vertices, a third of them crossing the border;
* every transform on samples carrying boxes, masks, keypoints, quads and
  dense maps, the train and eval pipelines at fixed ``(seed, index)``;
* the three datasets and ``batched_loader`` with each collate on PNG trees
  written to ``tmp_path`` (:func:`write_coco_tree`): crowd annotations and a
  missing file skipped, polygons and an uncompressed RLE;
* the native library against JAX's and against the port's numpy version,
  and a failed build raising with the compiler's output;
* ``to_device`` and ``DevicePrefetcher`` on the CPU: layout, dtypes, a
  source that raises, ``buffer_size`` 1, ``close``;
* importing the port's data modules loads neither JAX, the JAX package,
  OpenCV nor Pillow (Pillow is imported when a file is opened).

The card is not needed (``tests/test_torch_kernels_cuda.py`` holds the
prefetcher's CUDA path).  The Pillow package writes the PNGs, as it reads
them in both packages.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import sihl_tpu.data as jdata
import sihl_tpu.data.augment as jaug
import sihl_tpu.data.datasets as jds
import sihl_tpu.data.native as jnative
import sihl_tpu_torch.data as tdata
import sihl_tpu_torch.data.augment as taug
import sihl_tpu_torch.data.datasets as tds
import sihl_tpu_torch.data.native as tnative
from sihl_tpu_torch.data import imgproc

import torch_parity  # noqa: F401  (the CPU as the default device)

IMAGE_ATOL = 1e-6
COCO_SIZES = ((40, 30), (30, 40), (40, 27), (25, 19), (31, 31))  # (w, h): COCO's shapes, scaled down


# -- shared helpers ------------------------------------------------------------


def assert_tree_equal(got, want, image_keys=("image",), path="") -> None:
    """Dicts, lists and arrays equal: exactly, but float32 arrays under
    ``image_keys`` within ``IMAGE_ATOL``; dtypes and shapes equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], image_keys, f"{path}.{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, image_keys, f"{path}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype, got.shape, want.shape)
    # images: under an image key, or the first element of a batch (images, targets)
    if path.split(".")[-1] in image_keys or (image_keys and path.endswith("[0]") and got.dtype == np.float32):
        np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL, err_msg=path)
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


def random_polygon(rng, cx, cy, radius, n, concave: bool):
    """n vertices around (cx, cy): sorted angles (convex-ish), or every other
    vertex pulled in (concave)."""
    angles = np.sort(rng.rand(n) * 2 * np.pi)
    r = radius * rng.uniform(0.6, 1.0, n)
    if concave:
        r[::2] *= 0.35
    return np.stack([cx + r * np.cos(angles), cy + r * np.sin(angles)], axis=1)


def write_coco_tree(root, rng, num_images: int, sizes=COCO_SIZES, max_objects: int = 6):
    """A synthetic COCO set under ``root``: ``images/*.png`` of the given
    (w, h) sizes and ``instances_train.json`` with 1-``max_objects`` objects
    an image (categories 3, 7 and 11), each with a box, a polygon
    segmentation (two polygons on some) and 17 keypoints; the first object
    of image 1 as an uncompressed RLE, one crowd annotation, and one image
    whose file is missing.  Returns (image_dir, ann_file)."""
    image_dir = root / "images"
    image_dir.mkdir(parents=True)
    images, anns = [], []
    for i in range(num_images):
        w, h = sizes[i % len(sizes)]
        name = f"{i:06d}.png"
        images.append({"id": i + 1, "file_name": name, "width": w, "height": h})
        if i != num_images - 1:  # the last file is missing
            Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(image_dir / name)
        for k in range(rng.randint(1, max_objects + 1)):
            bw, bh = rng.uniform(4, w / 2), rng.uniform(4, h / 2)
            x0, y0 = rng.uniform(-2, w - bw + 2), rng.uniform(-2, h - bh + 2)
            polys = [random_polygon(rng, x0 + bw / 2, y0 + bh / 2, min(bw, bh) / 2, rng.randint(3, 13), k % 2 == 1)]
            if k == 2:
                polys.append(random_polygon(rng, x0 + bw / 3, y0 + bh / 3, 3, 4, False))
            segm = [p.reshape(-1).round(2).tolist() for p in polys]
            if i == 1 and k == 0:
                flat = (rng.rand(w * h) < 0.3).astype(np.uint8)  # column-major
                counts, run, val = [], 0, 0
                for v in flat:
                    if v != val:
                        counts.append(run)
                        run, val = 0, v
                    run += 1
                counts.append(run)
                segm = {"size": [h, w], "counts": counts}
            kps = np.concatenate([rng.uniform(0, [w, h], (17, 2)), rng.randint(0, 3, (17, 1))], axis=1)
            anns.append({
                "id": len(anns) + 1, "image_id": i + 1, "category_id": (3, 7, 11)[rng.randint(3)],
                "bbox": [round(x0, 2), round(y0, 2), round(bw, 2), round(bh, 2)], "segmentation": segm,
                "iscrowd": int(i == 2 and k == 0), "keypoints": kps.reshape(-1).round(2).tolist(),
                "num_keypoints": 17,
            })
    cats = [{"id": c, "name": f"cat{c}"} for c in (11, 3, 7)]
    ann_file = root / "instances_train.json"
    ann_file.write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    return image_dir, ann_file


def rich_sample(rng, h=37, w=53, n=5):
    """An image with boxes, classes, masks, keypoints, visibilities, quads
    and an int32 dense map."""
    xy = rng.uniform(0, [w - 8, h - 8], (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 12, (n, 2))], axis=1).astype(np.float32)
    return {
        "image": rng.randint(0, 256, (h, w, 3), np.uint8),
        "boxes": boxes,
        "classes": rng.randint(0, 5, n).astype(np.int32),
        "masks": (rng.rand(n, h, w) < 0.4).astype(np.uint8),
        "keypoints": rng.uniform(0, [w, h], (n, 4, 2)).astype(np.float32),
        "keypoint_visible": rng.rand(n, 4) < 0.7,
        "quads": rng.uniform(0, [w, h], (n, 4, 2)).astype(np.float32),
        "dense_map": rng.randint(0, 9, (h, w)).astype(np.int32),
        "dense_pad": -1,
    }


# -- padding, ArrayDataset, batched ----------------------------------------------


def test_padding_helpers_match_jax():
    rng = np.random.RandomState(0)
    classes = [rng.randint(0, 9, n) for n in (3, 0, 7)]
    boxes = [rng.rand(len(c), 4) * 50 for c in classes]
    masks = [rng.rand(len(c), 12, 10) > 0.5 for c in classes]
    for fn, args in (
        ("pad_detection_targets", (classes, boxes, 5)),
        ("pad_instance_targets", (classes, masks, 5, (8, 9))),
        ("pad_instance_targets", (classes, [m[:, :8, :9] for m in masks], 4)),
        ("pad_keypoint_targets", ([rng.rand(len(c), 3, 2) for c in classes],
                                  [rng.rand(len(c), 3) > 0.5 for c in classes], 4, 3)),
        ("pad_text_targets", ([[1, 2, 3], [], list(range(9))], 6, 0)),
    ):
        assert_tree_equal(getattr(tdata, fn)(*args), getattr(jdata, fn)(*args))


@pytest.mark.parametrize("shuffle, drop_last", [(False, True), (True, True), (True, False)])
def test_batched_matches_jax(shuffle, drop_last):
    rng = np.random.RandomState(1)
    images = rng.rand(10, 4, 5, 3).astype(np.float32)
    targets = {"classes": rng.randint(0, 3, (10, 2)).astype(np.int32), "extra": [np.arange(10), rng.rand(10, 2)]}
    got = list(tdata.batched(tdata.ArrayDataset(images, targets), 4, shuffle=shuffle, seed=3, drop_last=drop_last,
                             epochs=2))
    want = list(jdata.batched(jdata.ArrayDataset(images, targets), 4, shuffle=shuffle, seed=3, drop_last=drop_last,
                              epochs=2))
    assert len(got) == len(want) == (4 if drop_last else 6)
    assert_tree_equal(got, want, image_keys=())
    assert tdata.ArrayDataset(images)[3][1] is None


# -- imgproc against OpenCV ---------------------------------------------------


def test_nearest_index_maps_equal_cv2_for_every_length_pair():
    bad = []
    for src in range(1, 200):
        ramp = np.arange(src, dtype=np.float32)[None, :]
        for dst in range(1, 200):
            got = imgproc.nearest_indices(src, dst)
            want = cv2.resize(ramp, (dst, 1), interpolation=cv2.INTER_NEAREST)[0].astype(np.int64)
            if not np.array_equal(got, want):
                bad.append((src, dst))
    assert not bad, bad[:10]


@pytest.mark.parametrize("shape, out", [((480, 640, 3), (639, 852)), ((37, 53, 3), (100, 17)), ((64, 64, 3), (32, 32)),
                                        ((1, 9, 3), (3, 4)), ((640, 427, 3), (958, 639)), ((20, 30), (20, 30))])
def test_resize_matches_cv2(shape, out):
    rng = np.random.RandomState(2)
    oh, ow = out
    image = rng.rand(*shape).astype(np.float32)
    np.testing.assert_allclose(imgproc.resize(image, oh, ow, nearest=False),
                               cv2.resize(image, (ow, oh), interpolation=cv2.INTER_LINEAR), rtol=0, atol=IMAGE_ATOL)
    for dtype in (np.float32, np.int32, np.uint8):
        maps = rng.randint(0, 200, shape[:2]).astype(dtype)
        np.testing.assert_array_equal(imgproc.resize(maps, oh, ow, nearest=True),
                                      cv2.resize(maps, (ow, oh), interpolation=cv2.INTER_NEAREST))
    channels = rng.randint(0, 200, shape[:2] + (2,)).astype(np.int32)
    np.testing.assert_array_equal(imgproc.resize(channels, oh, ow, nearest=True),
                                  cv2.resize(channels, (ow, oh), interpolation=cv2.INTER_NEAREST))


def test_hsv_conversions_match_cv2():
    rng = np.random.RandomState(3)
    image = rng.rand(48, 40, 3).astype(np.float32)
    image[0, :8] = 0.5  # grays: saturation 0
    image[1, :8] = [0.25, 0.25, 0.75]  # ties between channels
    image[2, :8] = 0.0
    hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV)
    got = imgproc.rgb_to_hsv(image)
    np.testing.assert_array_equal(got[..., 1:], hsv[..., 1:])
    np.testing.assert_allclose(got[..., 0], hsv[..., 0], rtol=0, atol=3.1e-5)  # one float32 step at 360
    hsv[..., 0] = (hsv[..., 0] + 17.25) % 360.0
    np.testing.assert_allclose(imgproc.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), rtol=0, atol=IMAGE_ATOL)


def test_fill_poly_equals_cv2_on_every_pixel():
    rng = np.random.RandomState(4)
    crossing = 0
    for trial in range(600):
        h, w = rng.randint(6, 64, 2)
        n = rng.randint(3, 13)
        if trial % 3 == 2:  # anywhere, crossing the border
            points = rng.uniform(-12, [w + 12, h + 12], (n, 2))
        else:
            points = random_polygon(rng, w / 2, h / 2, min(h, w) / 2, n, concave=trial % 3 == 1)
        points = np.round(points).astype(np.int32)
        crossing += bool(((points < 0) | (points >= [w, h])).any())
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [points], 1)
        got = imgproc.fill_poly(np.zeros((h, w), np.uint8), points, 1)
        np.testing.assert_array_equal(got, want, err_msg=str(points.tolist()))
    assert crossing >= 150


# -- transforms and pipelines --------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_transforms_match_jax(seed):
    rng = np.random.RandomState(seed)
    sample = rich_sample(rng)
    assert_tree_equal(taug.horizontal_flip(sample), jaug.horizontal_flip(sample), image_keys=())
    float_sample = dict(sample, image=taug._img_float(sample["image"]))
    for name in ("photometric_distort", "zoom_out"):
        got = getattr(taug, name)(float_sample, np.random.RandomState(seed))
        want = getattr(jaug, name)(float_sample, np.random.RandomState(seed))
        assert_tree_equal(got, want)
    for size, max_size in ((24, None), (31, 32), (61, 64)):
        assert_tree_equal(taug.resize(float_sample, size, max_size), jaug.resize(float_sample, size, max_size))
    for size in (20, 64):
        got = taug.random_crop(float_sample, size, np.random.RandomState(seed))
        want = jaug.random_crop(float_sample, size, np.random.RandomState(seed))
        assert_tree_equal(got, want)
        assert_tree_equal(taug.sanitize(got), jaug.sanitize(want))
    masks_only = {k: sample[k] for k in ("image", "classes", "masks")}
    assert_tree_equal(taug.sanitize(masks_only), jaug.sanitize(masks_only), image_keys=())


def test_photometric_distort_seeds_take_every_branch():
    """The seeds of ``test_transforms_match_jax`` draw each of the four
    jitters at least once (the hue's HSV round trip included): the draws
    of ``photometric_distort``, a ``rand()`` for each jitter and a
    ``uniform()`` for each one taken."""
    drawn = np.zeros(4, bool)
    for seed in range(6):
        rng = np.random.RandomState(seed)
        for j in range(4):
            if rng.rand() < 0.5:
                drawn[j] = True
                rng.uniform()
    assert drawn.all()


@pytest.mark.parametrize("index", [0, 1, 7])
def test_pipelines_match_jax(index):
    rng = np.random.RandomState(10 + index)
    sample = rich_sample(rng, h=45, w=31)
    for size in (32, 64):
        got = taug.train_pipeline(size, seed=5)(sample, index=index)
        want = jaug.train_pipeline(size, seed=5)(sample, index=index)
        assert got["image"].shape == (size, size, 3)
        assert_tree_equal(got, want)
        assert_tree_equal(taug.eval_pipeline(size, seed=5)(sample, index=index),
                          jaug.eval_pipeline(size, seed=5)(sample, index=index))
    no_zoom = dict(flip=False, distort=False, zoom=None, seed=1)
    assert_tree_equal(taug.train_pipeline(32, **no_zoom)(sample, index=index),
                      jaug.train_pipeline(32, **no_zoom)(sample, index=index))


# -- datasets and the loader -----------------------------------------------------


def _loader_batches(ds_module, dataset, collate, augment, n: int):
    it = ds_module.batched_loader(dataset, 4, collate, augment=augment, shuffle=True, seed=2, workers=3, epochs=None)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("task", ["boxes", "masks", "keypoints"])
def test_coco_dataset_and_loader_match_jax(tmp_path, task):
    image_dir, ann_file = write_coco_tree(tmp_path, np.random.RandomState(5), num_images=11)
    got_ds = tds.CocoDataset(image_dir, ann_file, task=task)
    want_ds = jds.CocoDataset(image_dir, ann_file, task=task)
    assert len(got_ds) == len(want_ds) and f"{10:06d}.png" not in {info["file_name"] for info, _ in got_ds.items}
    assert got_ds.class_names == want_ds.class_names == ["cat3", "cat7", "cat11"]
    for i in range(len(got_ds)):
        assert_tree_equal(got_ds[i], want_ds[i], image_keys=())
    if task == "keypoints":
        return
    collate = {"boxes": tds.collate_detection, "masks": tds.collate_instance_segmentation}[task]
    got = _loader_batches(tds, got_ds, collate(5), taug.train_pipeline(32, seed=1), 3)
    want = _loader_batches(jds, want_ds, getattr(jds, collate.__name__)(5), jaug.train_pipeline(32, seed=1), 3)
    assert_tree_equal(got, want)
    assert got[0][0].shape == (4, 32, 32, 3) and got[0][0].dtype == np.float32
    assert got[0][1]["classes"].dtype == np.int32


def test_coco_rle_and_crowd(tmp_path):
    image_dir, ann_file = write_coco_tree(tmp_path, np.random.RandomState(5), num_images=4)
    ds = tds.CocoDataset(image_dir, ann_file, task="masks")
    data = json.loads(ann_file.read_text())
    rle = next(a for a in data["annotations"] if isinstance(a["segmentation"], dict))
    h, w = rle["segmentation"]["size"]
    flat = np.repeat(np.arange(len(rle["segmentation"]["counts"])) % 2, rle["segmentation"]["counts"])
    image_index = [info["id"] for info, _ in ds.items].index(rle["image_id"])
    np.testing.assert_array_equal(ds[image_index]["masks"][0], flat.reshape(w, h).T)
    crowd_ids = {a["id"] for a in data["annotations"] if a["iscrowd"]}
    assert crowd_ids and not crowd_ids & {a["id"] for _, anns in ds.items for a in anns}


def test_folder_datasets_and_loader_match_jax(tmp_path):
    rng = np.random.RandomState(6)
    for c in ("cats", "dogs"):
        (tmp_path / "folder" / c).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.randint(0, 256, (20 + i, 24, 3), np.uint8)).save(tmp_path / "folder" / c / f"{i}.png")
    seg = tmp_path / "seg"
    (seg / "images").mkdir(parents=True)
    (seg / "masks").mkdir()
    for i in range(5):
        w, h = COCO_SIZES[i]
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(seg / "images" / f"{i}.png")
        label = Image.fromarray(rng.randint(0, 6, (h, w)).astype(np.uint8))
        if i % 2:
            label = label.convert("P")
        label.save(seg / "masks" / f"{i}.png")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(seg / "images" / "unpaired.png")

    got, want = tds.ImageFolderDataset(tmp_path / "folder"), jds.ImageFolderDataset(tmp_path / "folder")
    assert got.class_names == want.class_names and len(got) == len(want) == 6
    for i in range(len(got)):
        assert_tree_equal(got[i], want[i], image_keys=())
    assert_tree_equal(_loader_batches(tds, got, tds.collate_classification, taug.eval_pipeline(16), 2),
                      _loader_batches(jds, want, jds.collate_classification, jaug.eval_pipeline(16), 2))

    got, want = tds.SegmentationFolderDataset(seg), jds.SegmentationFolderDataset(seg)
    assert len(got) == len(want) == 5
    for i in range(len(got)):
        assert_tree_equal(got[i], want[i], image_keys=())
    assert_tree_equal(_loader_batches(tds, got, tds.collate_semantic_segmentation, taug.train_pipeline(24), 2),
                      _loader_batches(jds, want, jds.collate_semantic_segmentation, jaug.train_pipeline(24), 2))


def test_loader_refuses_a_dataset_smaller_than_a_batch():
    with pytest.raises(ValueError, match="batch_size"):
        next(tds.batched_loader([{"image": np.zeros((2, 2, 3))}] * 3, 4, tds.collate_classification))


# -- the native library --------------------------------------------------------


def test_native_library_matches_jax_and_numpy():
    rng = np.random.RandomState(7)
    images = [rng.randint(0, 256, s, np.uint8) for s in ((37, 53, 3), (64, 64, 3), (480, 640, 3), (9, 5, 3))]
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    for size in (32, (24, 40), 640):
        got = tnative.batch_resize_normalize(images, size, mean, std, num_threads=2)
        np.testing.assert_array_equal(got, jnative.batch_resize_normalize(images, size, mean, std, num_threads=2))
        np.testing.assert_allclose(got, tnative.batch_resize_normalize(images, size, mean, std, force_numpy=True),
                                   rtol=0, atol=2e-5)
        np.testing.assert_array_equal(
            tnative.batch_resize_normalize(images, size, mean, std, force_numpy=True),
            jnative.batch_resize_normalize(images, size, mean, std, force_numpy=True))
    rows = [np.array([1, 2, 3], np.int32), np.array([], np.int32), np.arange(10, dtype=np.int32)]
    for force in (False, True):
        np.testing.assert_array_equal(tnative.native_pad_labels(rows, 5, force_numpy=force),
                                      jnative.native_pad_labels(rows, 5, force_numpy=True))
    assert tnative.native_available()


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++;\n")
    monkeypatch.setattr(tnative, "_SRC", str(broken))
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tnative.batch_resize_normalize([np.zeros((4, 4, 3), np.uint8)], 2)
    assert "error" in str(err.value)


# -- to_device and the prefetcher on the CPU -----------------------------------


def _host_batch(rng, b=3, h=8, w=6):
    images = rng.rand(b, h, w, 3).astype(np.float32)
    return images, {"classes": rng.randint(-1, 4, (b, 5)).astype(np.int32), "boxes": rng.rand(b, 5, 4).astype(np.float32),
                    "presence": rng.rand(b, 5) > 0.5, "view": rng.rand(b, h, w, 3).astype(np.float32)}


def _assert_delivered(got, host):
    images, targets = got
    assert images.shape == (3, 3, 8, 6) and images.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(images.permute(0, 2, 3, 1), torch.from_numpy(host[0]))
    assert targets["classes"].dtype == torch.int64 and torch.equal(targets["classes"],
                                                                   torch.from_numpy(host[1]["classes"]).long())
    assert targets["presence"].dtype == torch.bool and targets["boxes"].dtype == torch.float32
    assert torch.equal(targets["boxes"], torch.from_numpy(host[1]["boxes"]))
    # a target of the images' own shape is image data too
    assert targets["view"].shape == (3, 3, 8, 6) and torch.equal(targets["view"].permute(0, 2, 3, 1),
                                                                 torch.from_numpy(host[1]["view"]))


def test_to_device_layout_and_dtypes():
    rng = np.random.RandomState(8)
    host = _host_batch(rng)
    _assert_delivered(tdata.to_device(host, "cpu"), host)
    x = torch.zeros(2, 3, 4, 4)
    targets = [torch.ones(2, dtype=torch.int32), None]
    got = tdata.to_device((x, targets), "cpu")
    assert got[0] is x and got[1][0] is targets[0] and got[1][1] is None
    with pytest.raises(ValueError, match="NHWC"):
        tdata.to_device((np.zeros((4, 4, 3), np.float32), None), "cpu")


@pytest.mark.parametrize("buffer_size", [1, 2])
def test_prefetcher_hands_over_every_batch(buffer_size):
    rng = np.random.RandomState(9)
    hosts = [_host_batch(rng) for _ in range(5)]
    with tdata.DevicePrefetcher(iter(hosts), buffer_size=buffer_size, device="cpu") as prefetcher:
        got = list(prefetcher)
        assert prefetcher.staged == 5 and prefetcher.pinned_bytes == 0
        with pytest.raises(StopIteration):
            next(prefetcher)
    assert len(got) == 5
    for g, h in zip(got, hosts):
        _assert_delivered(g, h)
    with pytest.raises(ValueError):
        tdata.DevicePrefetcher(iter(hosts), buffer_size=0, device="cpu")


def test_prefetcher_raises_its_sources_error():
    rng = np.random.RandomState(10)
    hosts = [_host_batch(rng) for _ in range(2)]

    def source():
        yield from hosts
        raise OSError("a file went missing")

    prefetcher = tdata.DevicePrefetcher(source(), buffer_size=1, device="cpu")
    assert len([next(prefetcher), next(prefetcher)]) == 2
    with pytest.raises(OSError, match="went missing"):
        next(prefetcher)
    with pytest.raises(StopIteration):
        next(prefetcher)
    prefetcher.thread.join(timeout=10)
    assert not prefetcher.thread.is_alive()


def test_prefetcher_close_stops_the_worker_and_the_source():
    rng = np.random.RandomState(11)
    host = _host_batch(rng)
    closed = threading.Event()

    def endless():
        try:
            while True:
                yield host
        finally:
            closed.set()

    prefetcher = tdata.DevicePrefetcher(endless(), buffer_size=2, device="cpu")
    _assert_delivered(next(prefetcher), host)
    prefetcher.close()
    assert not prefetcher.thread.is_alive() and closed.is_set()
    with pytest.raises(StopIteration):
        next(prefetcher)


def test_data_modules_load_no_jax_cv2_or_pillow():
    code = ("import sys, sihl_tpu_torch.data, sihl_tpu_torch.data.augment, sihl_tpu_torch.data.datasets, "
            "sihl_tpu_torch.data.imgproc, sihl_tpu_torch.data.native; "
            "print(sorted(m for m in ('jax', 'flax', 'sihl_tpu', 'cv2', 'PIL') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "[]", out
