"""The input pipeline of the port (counterpart of ``sihl_tpu/data``).

Datasets decode image files on the host (:mod:`.datasets`), augmentations
run there in numpy (:mod:`.augment`, on :mod:`.imgproc`'s copies of
OpenCV's arithmetic), and collates pad ragged annotations into the heads'
fixed-size target contracts, as numpy batches in the JAX package's layout:
NHWC float32 images, int32 classes.  :func:`to_device` makes such a batch
the tensors the port's models and ``Trainer`` take, and
:class:`DevicePrefetcher` does that from a thread, ahead of the consumer,
through pinned staging buffers and a copy stream of its own.
"""

import queue as _queue
import random as _random
import threading
from typing import Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from sihl_tpu_torch.data.native import batch_resize_normalize, native_available, native_pad_labels  # noqa: F401
from sihl_tpu_torch.policy import resolve_device
from sihl_tpu_torch.utils import random_pad  # noqa: F401  (re-export)


# -- target padding (copies of sihl_tpu/data/__init__.py:27-100) -------------


def pad_detection_targets(
    classes: Sequence[np.ndarray],
    boxes: Sequence[np.ndarray],
    max_targets: int,
) -> Dict[str, np.ndarray]:
    """Ragged per-image (classes, boxes) lists -> padded batch dict
    (classes: (B, T) int32 with -1 padding; boxes: (B, T, 4))."""
    batch = len(classes)
    out_classes = np.full((batch, max_targets), -1, np.int32)
    out_boxes = np.zeros((batch, max_targets, 4), np.float32)
    for b, (c, bx) in enumerate(zip(classes, boxes)):
        n = min(len(c), max_targets)
        out_classes[b, :n] = np.asarray(c[:n], np.int32)
        out_boxes[b, :n] = np.asarray(bx[:n], np.float32)
    return {"classes": out_classes, "boxes": out_boxes}


def pad_instance_targets(
    classes: Sequence[np.ndarray],
    masks: Sequence[np.ndarray],
    max_targets: int,
    mask_size: Optional[tuple] = None,
) -> Dict[str, np.ndarray]:
    """Ragged (classes, masks) -> padded {classes (B,T), masks (B,T,H,W)}."""
    batch = len(classes)
    if mask_size is None:
        mask_size = masks[0].shape[-2:] if len(masks[0]) else (1, 1)
    out_classes = np.full((batch, max_targets), -1, np.int32)
    out_masks = np.zeros((batch, max_targets) + tuple(mask_size), np.float32)
    for b, (c, m) in enumerate(zip(classes, masks)):
        n = min(len(c), max_targets)
        out_classes[b, :n] = np.asarray(c[:n], np.int32)
        for t in range(n):
            mm = np.asarray(m[t], np.float32)
            if mm.shape != tuple(mask_size):
                ys = (np.arange(mask_size[0]) * mm.shape[0] / mask_size[0]).astype(int)
                xs = (np.arange(mask_size[1]) * mm.shape[1] / mask_size[1]).astype(int)
                mm = mm[ys][:, xs]
            out_masks[b, t] = mm
    return {"classes": out_classes, "masks": out_masks}


def pad_keypoint_targets(
    keypoints: Sequence[np.ndarray],
    presence: Sequence[np.ndarray],
    max_targets: int,
    num_keypoints: int,
) -> Dict[str, np.ndarray]:
    batch = len(keypoints)
    out_k = np.zeros((batch, max_targets, num_keypoints, 2), np.float32)
    out_p = np.zeros((batch, max_targets, num_keypoints), bool)
    for b, (k, p) in enumerate(zip(keypoints, presence)):
        n = min(len(k), max_targets)
        if n:
            out_k[b, :n] = np.asarray(k[:n], np.float32)
            out_p[b, :n] = np.asarray(p[:n], bool)
    return {"keypoints": out_k, "presence": out_p}


def pad_text_targets(texts: Sequence[Sequence[int]], max_length: int, pad_id: int) -> np.ndarray:
    out = np.full((len(texts), max_length), pad_id, np.int32)
    for b, t in enumerate(texts):
        n = min(len(t), max_length)
        out[b, :n] = np.asarray(list(t)[:n], np.int32)
    return out


# -- batching ------------------------------------------------------------------


def tree_map(fn, *trees):
    """``fn`` over the leaves at the same places of ``trees`` (nested dicts,
    lists and tuples; anything else is a leaf, None too), as
    ``jax.tree_util.tree_map`` maps a tree of arrays."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


class ArrayDataset:
    """In-memory dataset of (image, target) pairs with map-style access."""

    def __init__(self, images, targets=None):
        self.images = images
        self.targets = targets

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        t = None if self.targets is None else tree_map(lambda x: x[i], self.targets)
        return self.images[i], t


def batched(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    epochs: Optional[int] = None,
) -> Iterator:
    """Yield (stacked images, stacked targets) batches; loops ``epochs``
    times (forever if None)."""
    rng = _random.Random(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = list(range(len(dataset)))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idx = order[start : start + batch_size]
            if drop_last and len(idx) < batch_size:
                continue
            items = [dataset[i] for i in idx]
            images = np.stack([np.asarray(im) for im, _ in items])
            targets = items[0][1]
            if targets is not None:
                targets = tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *[t for _, t in items])
            yield images, targets
        epoch += 1


# -- to the device ---------------------------------------------------------------


def _leaves(batch):
    """The numpy arrays of a host batch ``(images, targets)``, in order, and
    whether each is NHWC image data: the images, and any target of their
    shape (a second view, a reconstruction target)."""
    if not (isinstance(batch, (tuple, list)) and len(batch) == 2):
        raise TypeError(f"a batch is a pair (images, targets), got {type(batch).__name__}")
    images, targets = batch
    shape = images.shape if isinstance(images, np.ndarray) else None
    found = []

    def visit(x, image):
        if isinstance(x, np.ndarray):
            found.append((x, image or (x.ndim == 4 and x.shape == shape)))
        return x

    if isinstance(images, np.ndarray):
        if images.ndim != 4:
            raise ValueError(f"host images are NHWC (B, H, W, C), got shape {images.shape}")
        visit(images, True)
    tree_map(lambda x: visit(x, False), targets)
    return found


def _replace_leaves(batch, tensors):
    it = iter(tensors)
    return tree_map(lambda x: next(it) if isinstance(x, np.ndarray) else x, tuple(batch))


def _host_tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _finish(t: torch.Tensor, image: bool) -> torch.Tensor:
    """A copied leaf as the port takes it: NHWC image data as the (B, C, H,
    W) view of its memory (channels_last), integers as int64 (the index
    dtype of torch's gathers and one-hots; JAX's collates give int32)."""
    if image:
        t = t.permute(0, 3, 1, 2)
    if not t.is_floating_point() and t.dtype != torch.bool and t.dtype != torch.int64:
        t = t.to(torch.int64)
    return t


def to_device(batch, device=None):
    """A host batch ``(images, targets)`` in the JAX package's layout as
    tensors on ``device`` (the default device unless given): NHWC images as
    the (B, C, H, W) view of their memory (channels_last), targets with the
    dtypes the heads take (integers as int64, floats and bools as they are).
    On a CUDA device each array is copied from pinned memory with
    ``non_blocking=True`` on the current stream.  Tensors, and anything that
    is not a numpy array, pass unchanged."""
    device = resolve_device(device)
    out = []
    for x, image in _leaves(batch):
        t = _host_tensor(x)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(_finish(t, image))
    return _replace_leaves(batch, out)


class DevicePrefetcher:
    """Moves host batches ``(images, targets)`` to the device from a worker
    thread, ``buffer_size`` batches ahead of the consumer (the counterpart of
    torch DataLoader's pinned memory and of the JAX package's prefetcher).

    On a CUDA device the worker copies each batch's arrays into one of two
    pinned staging buffers (reused batch after batch, once the copy that
    last read them has finished), then to the card with ``non_blocking=True``
    on a copy stream of its own, and records an event there.  ``next()``
    makes the consumer's current stream wait for that event and marks every
    tensor it hands over as used on that stream (``record_stream``), so the
    allocator keeps its memory until the consumer's work on it is done.
    The layout and dtypes are :func:`to_device`'s.  The worker allocates on
    the card while the consumer may be capturing a CUDA graph:
    ``Trainer``'s capture confines CUDA's capture checks to the capturing
    thread for that reason (``training/trainer.py``).

    An exception raised by the source is raised again by ``next()`` in the
    consumer; iteration then ends.  :meth:`close` (or leaving a ``with``
    block) stops the worker and closes the source where it can be closed.
    ``staged`` counts the batches the worker has put on the device;
    ``pinned_bytes`` is the size of the staging buffers."""

    _SLOTS = 2

    def __init__(self, iterator: Iterable, buffer_size: int = 2, device=None):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be at least 1, got {buffer_size}")
        self.device = resolve_device(device)
        self.source = iter(iterator)
        self.q: _queue.Queue = _queue.Queue(maxsize=buffer_size)
        self.staged = 0
        self.pinned_bytes = 0
        self._closed = threading.Event()
        self._finished = False
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._pinned = [[] for _ in range(self._SLOTS)]
        self._copied = [None] * self._SLOTS
        self.thread = threading.Thread(target=self._worker, name="DevicePrefetcher", daemon=True)
        self.thread.start()

    def _stage_cuda(self, batch, slot: int):
        leaves = _leaves(batch)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            if self._copied[slot] is not None:
                self._copied[slot].synchronize()
            buffers = self._pinned[slot]
            wanted = [(tuple(x.shape), _torch_dtype(x.dtype)) for x, _ in leaves]
            if [(tuple(b.shape), b.dtype) for b in buffers] != wanted:
                self.pinned_bytes -= sum(b.nbytes for b in buffers)
                buffers = [torch.empty(shape, dtype=dtype, pin_memory=True) for shape, dtype in wanted]
                self._pinned[slot] = buffers
                self.pinned_bytes += sum(b.nbytes for b in buffers)
            out = []
            for buf, (x, image) in zip(buffers, leaves):
                buf.copy_(_host_tensor(x))
                out.append(_finish(buf.to(self.device, non_blocking=True), image))
            copied = torch.cuda.Event()
            copied.record(self._stream)
        self._copied[slot] = copied
        return _replace_leaves(batch, out), copied, out

    def _worker(self):
        try:
            slot = 0
            for batch in self.source:
                if self._stream is not None:
                    item = self._stage_cuda(batch, slot)
                    slot = (slot + 1) % self._SLOTS
                else:
                    item = (to_device(batch, self.device), None, [])
                self.staged += 1
                if not self._put(("batch", item)):
                    return
        except BaseException as err:  # handed to the consumer, which raises it
            self._put(("error", err))
        else:
            self._put(("done", None))

    def _put(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self.q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        kind, item = self.q.get()
        if kind == "done":
            self._finished = True
            raise StopIteration
        if kind == "error":
            self._finished = True
            raise item
        batch, copied, tensors = item
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            for t in tensors:
                t.record_stream(stream)
        return batch

    def close(self) -> None:
        """Stop the worker, drop the batches it staged and close the source."""
        self._closed.set()
        self._finished = True
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.05)
            except _queue.Empty:
                pass
        close = getattr(self.source, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
