"""What the probe scripts and ``chip_smoke.py`` share: the card's name,
CUDA-event timing, the cuBLAS yardstick of the fused-MLP products, the
card's bound for a piece of work, the tolerances of bf16 outputs and f32
sums, and the line each probe leg prints."""

import math
import statistics
import subprocess

import torch

# H100 SXM data-sheet peaks: device memory, dense bf16 on the tensor cores,
# f32 outside them
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_F32_OPS_PER_S = 67e12
GRAPH_BELOW_MS = 0.05  # calls shorter than this are timed in a CUDA graph
# a long call needs fewer repeats: a timed run of median_ms lasts at least
# TIMED_MS in all (and 5 calls), a replay of graph_ms at least REPLAY_MS
TIMED_MS, REPLAY_MS = 100.0, 5.0
FLIP_SHARE = 0.1  # the most elements within_rounding_flips lets differ


def card_name() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _one_call_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` runs of ``fn``'s device time, from CUDA events;
    a call longer than ``TIMED_MS / reps`` is run fewer times, as many as
    fill ``TIMED_MS`` and at least 5 (a 30 ms call 5 times, not 20)."""
    for _ in range(warmup):
        fn()
    times = [_one_call_ms(fn)]
    if times[0] * reps > TIMED_MS:
        reps = min(reps, max(5, math.ceil(TIMED_MS / times[0])))
    while len(times) < reps:
        times.append(_one_call_ms(fn))
    return statistics.median(times)


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, replayed between CUDA events (median of 5 replays).  For calls
    shorter than their host-side launch, which a per-call event pair would
    time instead.  A call longer than ``REPLAY_MS / reps`` takes fewer calls
    a graph, as many as fill ``REPLAY_MS`` (at least one): one call of 30
    ms a replay, where the launches between calls are noise."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    reps = min(reps, max(1, math.ceil(REPLAY_MS / max(_one_call_ms(fn), 1e-6))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return median_ms(graph.replay, reps=5, warmup=1) / reps


def cublas_products_ms(m: int, outs, dtype: torch.dtype, backward: bool) -> float:
    """A yardstick of tensor-core speed for the fused-MLP kernels, never
    called by the port: the same layer products alone on cuBLAS
    (torch.matmul at the call's shapes, from a CUDA graph).  Forward: per
    MLP, four hidden (m, 256) x (256, 256) products and the output (m, 256)
    x (256, n_out).  Backward: per MLP, the chain's dX and dW products of
    every layer (what autograd of the plain chain multiplies), without
    K1b's recompute of the forward."""
    gen = torch.Generator("cuda").manual_seed(m)
    a = torch.randn(m, 256, device="cuda", generator=gen).to(dtype)
    w = torch.randn(256, 256, device="cuda", generator=gen).to(dtype)
    heads = [(torch.randn(256, n, device="cuda", generator=gen).to(dtype),
              torch.randn(m, n, device="cuda", generator=gen).to(dtype)) for n in outs]

    def products():
        for wo, g in heads:
            if backward:
                torch.matmul(g, wo.t())
                torch.matmul(a.t(), g)
                for _ in range(4):
                    torch.matmul(a, w.t())
                    torch.matmul(a.t(), a)
            else:
                for _ in range(4):
                    torch.matmul(a, w)
                torch.matmul(a, wo)

    return graph_ms(products)


def device_ms(fn) -> float:
    """``fn``'s device time: CUDA events around each call, or a CUDA graph
    where one call takes under ``GRAPH_BELOW_MS``."""
    ms = median_ms(fn)
    return graph_ms(fn) if ms < GRAPH_BELOW_MS else ms


def bound(num_bytes: float, bf16_ops: float, f32_ops: float = 0.0) -> dict:
    """The least time the card could take: the bytes over the memory rate,
    or the bf16 tensor-core operations and the f32 ones over their peaks,
    whichever is longer."""
    t_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (bf16_ops / PEAK_BF16_OPS_PER_S + f32_ops / PEAK_F32_OPS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def within_one_bf16_step(got: torch.Tensor, want: torch.Tensor, slack=0.0) -> bool:
    """Every element of got within one bf16 step of want (the spacing of
    bf16 values at the larger of the two magnitudes), plus ``slack``."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs())
    step = torch.exp2(torch.floor(torch.log2(torch.where(mag > 0, mag, 1.0))) - 7)
    return bool(((got - want).abs() <= step + slack).all())


def within_rounding_flips(got: torch.Tensor, want: torch.Tensor) -> bool:
    """got equal to want but in at most ``FLIP_SHARE`` of the elements, and
    nowhere more than one bf16 step at the largest magnitude of either.  For
    bf16 outputs of a chain that both sides compute with f32 sums in another
    order: an output moves only where a bf16 rounding on its way (its own,
    or that of an input to a later sum) falls the other way."""
    got, want = got.float(), want.float()
    largest = max(float(got.abs().max()), float(want.abs().max()))
    step = 2.0 ** (math.floor(math.log2(largest)) - 7) if largest > 0 else 0.0
    return differing_share(got, want) <= FLIP_SHARE and float((got - want).abs().max()) <= step


def differing_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of the elements in which got and want differ."""
    return float((got.float() != want.float()).float().mean())


def order_slack(terms: int, magnitude: torch.Tensor) -> torch.Tensor:
    """The most two f32 sums of the same ``terms`` products can differ by,
    taken in two orders: 2 * terms * 2^-24 times the sum of the products'
    magnitudes.  Where the products cancel, this is more than a bf16 step
    of the small result, so a bf16 output rounded from either sum is held
    within one step plus this."""
    return 2 * terms * 2.0**-24 * magnitude.float()


def within_sum_order(got: torch.Tensor, want: torch.Tensor, magnitude: torch.Tensor, rel: float = 1e-5) -> bool:
    """Every element of got within ``rel`` times the sum of the magnitudes
    of its terms (``magnitude``) of want: f32 sums taken in another order."""
    return bool(((got.double() - want.double()).abs() <= rel * magnitude.double()).all())


def leg_line(name: str, ms: float, flops: float, num_bytes: float, work_bound: dict, launches=None) -> str:
    """One leg: device ms, TF/s and effective GB/s of the work it computes,
    and the card's bound for that work."""
    text = (f"  {name:20s} {ms:8.4f} ms  {flops / ms / 1e9:7.1f} TF/s  {num_bytes / ms / 1e6:7.0f} GB/s-effective  "
            f"bound {work_bound['bound_ms']:.4f} ms ({work_bound['bound_by']})")
    return text + (f"  launches {launches}" if launches is not None else "")
