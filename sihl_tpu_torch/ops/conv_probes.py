"""The flagship backbone's stage-1/2 convolutions as hand-written GEMMs: the
port of the JAX package's conv probes (``tools/probe_conv1x1_pallas.py``,
``tools/probe_wrt_filter.py``, ``tools/probe_conv3x3_pallas.py``).

- :func:`matmul_stats` (P4): the 1x1 conv 64 -> 256 as y = x w over rows,
  optionally with BatchNorm's per-channel sum and sum of squares of y taken
  from the f32 sums before y is rounded;
- :func:`weight_grad_1x1` (P5): the 1x1 conv's weight gradient x^T dy in f32;
- :func:`conv3x3` (P2): the stride-1 SAME 3x3 conv 64 -> 64 in NHWC.

bf16 operands, f32 sums, each bf16 output rounded once.  A CUDA tensor goes
to the hand-written kernels of ``csrc/conv_probes.cu`` (the file says how
each is laid out and what bounds it); a CPU tensor goes to the plain
PyTorch version beside each wrapper, which repeats the kernel's arithmetic
in f32.  The kernels read and write their arrays by TMA, which takes
16-byte-aligned addresses; the wrappers refuse others.  How the kernels
deal their work to blocks is planned here (:func:`matmul_stats_blocks`,
:func:`weight_grad_plan`, :func:`weight_grad_blocks`,
:func:`conv3x3_blocks`, :func:`conv3x3_plan`), so that the CPU tests can
check it.  No model path calls these yet: the probe scripts of
``sihl_tpu_torch.tools`` and ``chip_smoke.py`` do.
"""

import contextlib
import ctypes
import functools
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from sihl_tpu_torch.ops.build import cuda_library

P4_IN, P4_OUT = 64, 256          # matmul_stats: x (M, 64) by w (64, 256)
P5_CI_STEP, P5_CO_STEP = 64, 256  # weight_grad_1x1: ci and co multiples, and the co of a dW tile
P5_CLUSTER = 4                    # weight_grad_1x1: blocks of a cluster (csrc/conv_probes.cu, p5::CL)
P2_CHANNELS = 64                  # conv3x3: 64 -> 64
P2_TILE = (2, 64)                 # conv3x3: output rows and columns of a tile (csrc/conv_probes.cu, p2::TR, p2::TC)
P2_WARPGROUPS = 2                 # conv3x3: consumer warpgroups, taking a block's tiles in turn (p2::WGS)
ROWS = 64                         # P4's row tiles and P5's row chunks: one TMA box's rows
MAX_ROWS = 2**31 - 1              # TMA's coordinates are 32-bit


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_library("conv_probes"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a built ``csrc/conv_probes.cu`` (or of an
    edited copy of it, as ``tools.probe_conv_variants`` builds)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sihl_probe_matmul_resident.argtypes = [i]
    lib.sihl_probe_matmul_resident.restype = ll
    lib.sihl_probe_matmul_stats.argtypes = [i, p, p, ll, p, p, p, ll, p]
    lib.sihl_probe_matmul_stats.restype = i
    lib.sihl_probe_weight_grad_resident.argtypes = [i]
    lib.sihl_probe_weight_grad_resident.restype = ll
    lib.sihl_probe_weight_grad.argtypes = [p, p, ll, i, i, i, ll, p, p, i, p]
    lib.sihl_probe_weight_grad.restype = i
    lib.sihl_probe_conv3x3_resident.argtypes = []
    lib.sihl_probe_conv3x3_resident.restype = ll
    lib.sihl_probe_conv3x3.argtypes = [p, p, i, i, i, p, ll, p]
    lib.sihl_probe_conv3x3.restype = i
    lib.sihl_cuda_error_string.argtypes = [i]
    lib.sihl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: {_library().sihl_cuda_error_string(err).decode()}")


@functools.cache
def _resident(kernel: str, variant: int, device_index: int) -> int:
    """Blocks of P4's kernel (``variant`` = stats) or of P2's, or clusters
    of P5's (``variant`` = the tile's ci rows), that fit on card
    ``device_index`` at once, asked of the library once per device and
    kernel: the query (occupancy and a function attribute) would otherwise
    cost each call host time."""
    lib = _library()
    with torch.cuda.device(device_index):
        if kernel == "matmul_stats":
            n = lib.sihl_probe_matmul_resident(variant)
        elif kernel == "conv3x3":
            n = lib.sihl_probe_conv3x3_resident()
        else:
            n = lib.sihl_probe_weight_grad_resident(variant)
    if n <= 0:
        _check(-n, kernel)
    return n


def _require(t: torch.Tensor, name: str, shape, what: str) -> None:
    """What every kernel takes: a contiguous bf16 tensor of ``shape`` (None
    for any size) on the first tensor's device."""
    if t.dtype != torch.bfloat16:
        raise ValueError(f"the {what} kernel takes bf16 {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"the {what} kernel takes a contiguous {name}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"the {what} kernel takes {name} of shape {shape}, got {tuple(t.shape)}")


def _require_tma(t: torch.Tensor, name: str, what: str) -> None:
    """What TMA takes besides: a 16-byte-aligned address and fewer than
    2^31 rows (its row strides here are multiples of 128 bytes)."""
    if t.data_ptr() % 16:
        raise ValueError(f"the {what} kernel takes a 16-byte-aligned {name} (TMA), got address {t.data_ptr():#x}")
    if t.shape[0] > MAX_ROWS:
        raise ValueError(f"the {what} kernel takes at most {MAX_ROWS} rows, got {t.shape[0]}")


def _stream(t: torch.Tensor) -> int:
    """The current stream of t's card, as a raw pointer (without building a
    Stream object: several microseconds of host time a call)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _on(t: torch.Tensor):
    """The device guard of a launch on t's card: none when that card is
    already the current one (entering one costs microseconds a call)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _same_device(*ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"inputs on {[str(t.device) for t in ts]}")


# ----------------------------------------------------------------------- P4

MatmulOut = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def matmul_stats_reference(x: torch.Tensor, w: torch.Tensor, stats: bool = False) -> MatmulOut:
    """Plain PyTorch version: y = x w in f32, rounded once to x's dtype; with
    ``stats``, also the f32 sum and sum of squares of each column of the f32
    y.  On the card, a reference needs ``torch.backends.cuda.matmul.allow_tf32
    = False``."""
    yf = x.float() @ w.float()
    y = yf.to(x.dtype)
    if not stats:
        return y
    return y, yf.sum(dim=0), (yf * yf).sum(dim=0)


def matmul_stats_blocks(m: int, resident: int) -> int:
    """P4's persistent blocks for m rows when ``resident`` fit on the card
    at once: one per 64-row tile, at most ``resident``.  Block b takes tiles
    b, b + blocks, b + 2 blocks, ... in that order (the kernel walks them so)
    and writes the statistics' partial b."""
    return min(-(-m // ROWS), resident)


def _matmul_stats_cuda(x: torch.Tensor, w: torch.Tensor, stats: bool) -> MatmulOut:
    _require(x, "x", (None, P4_IN), "matmul_stats")
    _require(w, "w", (P4_IN, P4_OUT), "matmul_stats")
    _same_device(x, w)
    m = x.shape[0]
    if m < 1:
        raise ValueError("the matmul_stats kernel takes at least one row")
    _require_tma(x, "x", "matmul_stats")
    _require_tma(w, "w", "matmul_stats")
    blocks = matmul_stats_blocks(m, _resident("matmul_stats", int(stats), x.device.index))
    y = torch.empty((m, P4_OUT), dtype=torch.bfloat16, device=x.device)
    partials = sums = None
    if stats:  # one scratch: the blocks' (2, 256) partials, then the two sums
        scratch = torch.empty(((blocks + 1) * 2 * P4_OUT,), dtype=torch.float32, device=x.device)
        partials, sums = scratch[: blocks * 2 * P4_OUT], scratch[blocks * 2 * P4_OUT :].view(2, P4_OUT)
    with _on(x):
        err = _library().sihl_probe_matmul_stats(
            int(stats), x.data_ptr(), w.data_ptr(), m, y.data_ptr(), partials.data_ptr() if stats else None,
            sums.data_ptr() if stats else None, blocks, _stream(x))
    _check(err, "matmul_stats")
    matmul_stats.launches += 1
    return (y, sums[0], sums[1]) if stats else y


def matmul_stats(x: torch.Tensor, w: torch.Tensor, stats: bool = False) -> MatmulOut:
    """The 1x1 conv 64 -> 256 over rows: y = x w for x (M, 64) and w
    (64, 256), bf16 on the card, y (M, 256) rounded once from f32 sums.
    With ``stats``, returns ``(y, sum, sumsq)``: the (256,) f32 sum and sum
    of squares over the rows of y before rounding (BatchNorm's batch
    statistics); else y alone.  No gradient flows through it."""
    if x.device.type == "cuda":
        return _matmul_stats_cuda(x, w, stats)
    if x.device.type == "cpu":
        with torch.no_grad():
            return matmul_stats_reference(x, w, stats)
    raise ValueError(f"matmul_stats runs on CUDA or CPU tensors, got {x.device}")


matmul_stats.launches = 0  # kernel launches since the last reset


# ----------------------------------------------------------------------- P5


def weight_grad_1x1_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x^T dy in f32."""
    return x.float().T @ dy.float()


def _tile_rows(ci: int) -> int:
    """The ci rows of P5's dW tiles: 128 where ci allows (each byte of dy is
    then read for ci / 128 tiles, not ci / 64), else 64."""
    return 128 if ci % 128 == 0 else P5_CI_STEP


def weight_grad_plan(m: int, ci: int, co: int, clusters: int) -> Tuple[int, int]:
    """P5's plan for x (m, ci) and dy (m, co) when ``clusters`` clusters of
    four blocks fit on the card at once: ``(ti, splits)``.  dW is cut into
    ti x 256 tiles and the rows into ``splits`` runs of 64-row chunks, four
    to a cluster (which adds them into one partial), as many clusters as
    fill the card with one per tile and group of four splits, at least one
    and at most one for every four chunks."""
    ti = _tile_rows(ci)
    tiles = (ci // ti) * (co // P5_CO_STEP)
    groups = max(1, min(-(-m // (ROWS * P5_CLUSTER)), clusters // tiles))
    return ti, P5_CLUSTER * groups


def weight_grad_blocks(m: int, ci: int, co: int, ti: int, splits: int) -> list:
    """What each block of P5's kernel takes, in block order, as the kernel
    computes it: ``(ci0, co0, split, first_chunk, end_chunk)``, the dW tile
    at rows ci0 .. ci0 + ti - 1 and columns co0 .. co0 + 255 over the 64-row
    chunks [first_chunk, end_chunk).  Block b is rank b % 4 of cluster
    b // 4; cluster k takes tile k % tiles (ci fastest, so the clusters of
    one group of splits sit next to each other) and splits 4 (k // tiles)
    .. 4 (k // tiles) + 3, rank r the r-th; the splits of a tile follow each
    other through the rows, and split s adds into partial s // 4."""
    i_tiles, chunks = ci // ti, -(-m // ROWS)
    tiles = i_tiles * (co // P5_CO_STEP)
    plan = []
    for b in range(tiles * splits):
        cluster, rank = divmod(b, P5_CLUSTER)
        tile, split = cluster % tiles, P5_CLUSTER * (cluster // tiles) + rank
        plan.append(((tile % i_tiles) * ti, (tile // i_tiles) * P5_CO_STEP, split,
                     chunks * split // splits, chunks * (split + 1) // splits))
    return plan


def _weight_grad_args(x: torch.Tensor, dy: torch.Tensor):
    """Checks P5's inputs; returns (m, ci, co, ti, splits)."""
    _require(x, "x", (None, None), "weight_grad_1x1")
    m, ci = x.shape
    _require(dy, "dy", (m, None), "weight_grad_1x1")
    _same_device(x, dy)
    co = dy.shape[1]
    if m < 1 or ci < 1 or co < 1 or ci % P5_CI_STEP or co % P5_CO_STEP:
        raise ValueError(f"the weight_grad_1x1 kernel takes rows >= 1, ci a multiple of {P5_CI_STEP} and co "
                         f"of {P5_CO_STEP}, got ({m}, {ci}) and ({m}, {co})")
    _require_tma(x, "x", "weight_grad_1x1")
    _require_tma(dy, "dy", "weight_grad_1x1")
    clusters = _resident("weight_grad_1x1", _tile_rows(ci), x.device.index)
    return (m, ci, co) + weight_grad_plan(m, ci, co, clusters)


def _weight_grad_outputs(x: torch.Tensor, args):
    """P5's partials (one a cluster of four splits) and its dW."""
    _, ci, co, _, splits = args
    return (torch.empty((splits // P5_CLUSTER, ci, co), dtype=torch.float32, device=x.device),
            torch.empty((ci, co), dtype=torch.float32, device=x.device))


def _weight_grad_launch(x, dy, args, partials, dw, phases: int) -> None:
    m, ci, co, ti, splits = args
    with _on(x):
        err = _library().sihl_probe_weight_grad(x.data_ptr(), dy.data_ptr(), m, ci, co, ti, splits,
                                                partials.data_ptr(), dw.data_ptr(), phases, _stream(x))
    _check(err, "weight_grad_1x1")


def _weight_grad_1x1_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    args = _weight_grad_args(x, dy)
    partials, dw = _weight_grad_outputs(x, args)
    _weight_grad_launch(x, dy, args, partials, dw, 3)
    weight_grad_1x1.launches += 1
    return dw


def weight_grad_phases(x: torch.Tensor, dy: torch.Tensor):
    """P5's two launches apart, for timing them one by one on the card:
    ``(products, reduction)``, two callables over one scratch, the first
    writing the partials and the second summing them into the dW it
    returns.  They do not count as launches of :func:`weight_grad_1x1`."""
    if x.device.type != "cuda":
        raise ValueError(f"weight_grad_phases times the card's kernels, got {x.device}")
    args = _weight_grad_args(x, dy)
    partials, dw = _weight_grad_outputs(x, args)

    def products() -> torch.Tensor:
        _weight_grad_launch(x, dy, args, partials, dw, 1)
        return partials

    def reduction() -> torch.Tensor:
        _weight_grad_launch(x, dy, args, partials, dw, 2)
        return dw

    return products, reduction


def weight_grad_1x1(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The 1x1 conv's weight gradient over rows: dW = x^T dy, (ci, co) f32,
    for x (M, ci) and dy (M, co), bf16 on the card with ci a multiple of 64
    and co of 256.  No gradient flows through it."""
    if x.device.type == "cuda":
        return _weight_grad_1x1_cuda(x, dy)
    if x.device.type == "cpu":
        with torch.no_grad():
            return weight_grad_1x1_reference(x, dy)
    raise ValueError(f"weight_grad_1x1 runs on CUDA or CPU tensors, got {x.device}")


weight_grad_1x1.launches = 0  # kernel launches since the last reset


# ----------------------------------------------------------------------- P2


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the sum over the 9 taps of the zero-padded
    input's shifted rows times each tap's (C, C) matrix, in f32, rounded
    once to x's dtype.  x (B, H, W, C) NHWC, w (3, 3, C, C) HWIO."""
    _, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = sum(xp[:, ky : ky + h, kx : kx + wd, :] @ w[ky, kx].float() for ky in range(3) for kx in range(3))
    return acc.to(x.dtype)


def conv3x3_tiles(b: int, h: int, w: int) -> Tuple[int, int, int]:
    """P2's output tiles of a (b, h, w) image batch: ``(tiles, tile rows,
    tile columns)``, tiles of ``P2_TILE`` pixels over each image, the last
    row and column of tiles ragged."""
    rows, cols = -(-h // P2_TILE[0]), -(-w // P2_TILE[1])
    return b * rows * cols, rows, cols


def conv3x3_blocks(b: int, h: int, w: int, resident: int) -> int:
    """P2's persistent blocks when ``resident`` fit on the card at once: one
    per tile, at most ``resident``."""
    return min(conv3x3_tiles(b, h, w)[0], resident)


def conv3x3_plan(b: int, h: int, w: int, blocks: int) -> list:
    """What each block of P2's kernel takes, in block order, as the kernel
    walks it: a list of ``(image, row0, col0, warpgroup)`` per block.  Block
    k takes tiles k, k + blocks, k + 2 blocks, ... of the walk (columns
    fastest, then rows, then images); its n-th tile goes to consumer
    warpgroup n % 2, and covers output rows row0 .. row0 + 1 and columns
    col0 .. col0 + 63, clipped at the image."""
    tiles, rows, cols = conv3x3_tiles(b, h, w)
    plan = []
    for k in range(blocks):
        mine = []
        for n, t in enumerate(range(k, tiles, blocks)):
            image, rem = divmod(t, rows * cols)
            mine.append((image, (rem // cols) * P2_TILE[0], (rem % cols) * P2_TILE[1], n % P2_WARPGROUPS))
        plan.append(mine)
    return plan


def _conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _require(x, "x", (None, None, None, P2_CHANNELS), "conv3x3")
    _require(w, "w", (3, 3, P2_CHANNELS, P2_CHANNELS), "conv3x3")
    _same_device(x, w)
    b, h, wd, _ = x.shape
    if min(b, h, wd) < 1:
        raise ValueError(f"the conv3x3 kernel takes a non-empty image, got {tuple(x.shape)}")
    _require_tma(x, "x", "conv3x3")
    _require_tma(w, "w", "conv3x3")
    blocks = conv3x3_blocks(b, h, wd, _resident("conv3x3", 0, x.device.index))
    y = torch.empty_like(x)
    with _on(x):
        err = _library().sihl_probe_conv3x3(x.data_ptr(), w.data_ptr(), b, h, wd, y.data_ptr(), blocks, _stream(x))
    _check(err, "conv3x3")
    conv3x3.launches += 1
    return y


@torch.no_grad()
def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stride-1 SAME 3x3 conv 64 -> 64 of x (B, H, W, 64) NHWC by w
    (3, 3, 64, 64) HWIO: y (B, H, W, 64) NHWC, bf16 on the card, rounded
    once from the f32 sum over the taps and channels."""
    if x.device.type == "cuda":
        return _conv3x3_cuda(x, w)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    raise ValueError(f"conv3x3 runs on CUDA or CPU tensors, got {x.device}")


conv3x3.launches = 0  # kernel launches since the last reset
