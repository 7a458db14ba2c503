"""Builds the port's hand-written kernels from the sources in the checkout.

Nothing is built when a module is imported: the first CUDA call of a kernel
builds it into ``sihl_tpu_torch/_build/`` (CUDA C++ through
``torch.utils.cpp_extension.load``, Triton through its own JIT with its
cache in the same directory).
"""

import ctypes
import functools
import os
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
CUDA_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3"]


@functools.cache
def cuda_library(name: str, source: Path = None) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu``, or ``source`` (plain C interface, no
    PyTorch headers), for sm_90a and load it; later calls reuse the loaded
    library.  Each library has its own build directory, so several can
    build at once."""
    from torch.utils.cpp_extension import load

    build_dir = BUILD_DIR / name
    build_dir.mkdir(parents=True, exist_ok=True)
    path = load(
        name=f"sihl_{name}",
        sources=[str(source or CSRC_DIR / f"{name}.cu")],
        build_directory=str(build_dir),
        extra_cuda_cflags=CUDA_FLAGS,
        is_python_module=False,
        verbose=False,
    )
    return ctypes.CDLL(path)


def use_triton_cache() -> None:
    """Keep Triton's compiled kernels inside the checkout's build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
