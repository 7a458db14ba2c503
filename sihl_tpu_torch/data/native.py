"""ctypes bindings for the native (C++) batch-assembly path (counterpart of
``sihl_tpu/data/native.py``).

``csrc/batch_ops.cpp`` is compiled with g++ at first use into
``sihl_tpu_torch/_build/batch_ops/``, under a name keyed on the source, the
flags and the host's CPU (``-march=native`` code runs only where it was
built).  A build that fails raises with the compiler's output: there is no
silent fallback.  ``force_numpy=True`` runs the plain numpy version of the
same arithmetic instead, by the caller's choice.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "batch_ops.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "batch_ops")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return os.uname().machine


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_FLAGS).encode() + _cpu_model().encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libbatch_ops-{key}.so")


def _build(path: str) -> None:
    """Compile the library to ``path`` (through a temporary file in the same
    directory, renamed into place, so that processes building at once never
    load a half-written file); raise with g++'s output if it fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC, "-lpthread"], capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"building {_SRC} with g++ failed ({done.returncode}):\n{done.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    """The library, built first where this host has none."""
    global _lib
    with _lock:
        if _lib is None:
            path = _library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.batch_resize_normalize.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ]
            lib.batch_resize_normalize.restype = None
            lib.pad_labels.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.pad_labels.restype = None
            _lib = lib
        return _lib


def native_available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def batch_resize_normalize(
    images: Sequence[np.ndarray],
    size,
    mean=(0.0, 0.0, 0.0),
    std=(1.0, 1.0, 1.0),
    num_threads: int = 0,
    force_numpy: bool = False,
) -> np.ndarray:
    """uint8 HWC images (mixed sizes) -> normalized float32 NHWC batch:
    half-pixel-centre bilinear resizing (the source coordinate clamped to
    the image), ``(x / 255 - mean) / std``, one image a thread."""
    dh, dw = (size, size) if isinstance(size, int) else size
    c = images[0].shape[2]
    batch = len(images)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if any(im.ndim != 3 or im.shape[2] != c for im in images):
        raise ValueError(f"every image must be HWC with {c} channels")
    if len(mean) != c or len(std) != c:
        raise ValueError(f"mean and std need {c} values")
    if force_numpy:
        out = np.empty((batch, dh, dw, c), np.float32)
        for i, im in enumerate(images):
            out[i] = _np_resize_bilinear(im.astype(np.float32) / 255.0, dh, dw)
        return (out - mean) / std
    lib = _load()
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    out = np.empty((batch, dh, dw, c), np.float32)
    ptrs = (ctypes.c_void_p * batch)(*[im.ctypes.data_as(ctypes.c_void_p) for im in images])
    heights = (ctypes.c_int * batch)(*[im.shape[0] for im in images])
    widths = (ctypes.c_int * batch)(*[im.shape[1] for im in images])
    lib.batch_resize_normalize(
        ptrs, heights, widths, batch, c,
        out.ctypes.data_as(ctypes.c_void_p), dh, dw,
        mean.ctypes.data_as(ctypes.c_void_p),
        std.ctypes.data_as(ctypes.c_void_p),
        num_threads or (os.cpu_count() or 1),
    )
    return out


def _np_resize_bilinear(im: np.ndarray, dh: int, dw: int) -> np.ndarray:
    sh, sw = im.shape[:2]
    sy = np.clip((np.arange(dh) + 0.5) * sh / dh - 0.5, 0, sh - 1)
    sx = np.clip((np.arange(dw) + 0.5) * sw / dw - 0.5, 0, sw - 1)
    y0 = sy.astype(int)
    x0 = sx.astype(int)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = (sy - y0)[:, None, None]
    fx = (sx - x0)[None, :, None]
    top = im[y0][:, x0] * (1 - fx) + im[y0][:, x1] * fx
    bot = im[y1][:, x0] * (1 - fx) + im[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def native_pad_labels(rows: Sequence[np.ndarray], max_targets: int, force_numpy: bool = False) -> np.ndarray:
    """Ragged int32 label rows -> a (batch, max_targets) grid padded with -1."""
    batch = len(rows)
    if force_numpy:
        out = np.full((batch, max_targets), -1, np.int32)
        for b, r in enumerate(rows):
            n = min(len(r), max_targets)
            out[b, :n] = np.asarray(r[:n], np.int32)
        return out
    lib = _load()
    rows = [np.ascontiguousarray(r, np.int32) for r in rows]
    out = np.empty((batch, max_targets), np.int32)
    ptrs = (ctypes.c_void_p * batch)(*[r.ctypes.data_as(ctypes.c_void_p) for r in rows])
    lengths = (ctypes.c_int * batch)(*[len(r) for r in rows])
    lib.pad_labels(ptrs, lengths, batch, max_targets, out.ctypes.data_as(ctypes.c_void_p))
    return out
