"""The 1x1 conv 64 -> 256 of the flagship backbone's stage 1 (16 images at
160 x 160), with and without BatchNorm's statistics: the port of
``tools/probe_conv1x1_pallas.py``.  Does computing the per-channel sum and
sum of squares in the conv's epilogue cost anything?

Legs (the JAX probe's, in the port's terms):

  library_conv        PyTorch's bf16 1x1 conv on a channels_last tensor
                      (cuDNN; what ``backbones/resnet.py`` runs), the yardstick
  library_conv_stats  the same conv, then the f32 sum and sum of squares
                      over (N, H, W)
  kernel              ``ops.conv_probes.matmul_stats``, the hand-written kernel
  kernel_stats        the same with the statistics in its epilogue
  plain, plain_stats  the kernel's plain PyTorch version (f32 products)

Each leg prints its device time, TF/s and effective GB/s of the probe's work,
and the card's bound for that work.  The legs are checked against each other
first: the kernel's y within one bf16 step of the plain version's (plus
what f32 order can move a sum of 64 products whose terms cancel), its sums
within 1e-5 of the sum of the magnitudes of their terms (f32 sums in another
order), the library's y within 1e-2 (the JAX probe's check) and its sums,
taken over the rounded y, within 2^-7 of those magnitudes (rounding y to bf16
moves a term by at most 2^-9 of itself and a square by about 2^-8; f32 order
adds less).

Run on a CUDA card:  python -m sihl_tpu_torch.tools.probe_conv1x1
"""

import numpy as np
import torch
import torch.nn.functional as F

from sihl_tpu_torch.ops import conv_probes
from sihl_tpu_torch.tools.probe_timing import (
    bound, card_name, device_ms, leg_line, order_slack, within_one_bf16_step, within_sum_order,
)

SEED = 0  # the JAX probe's numpy seed


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"probe_conv1x1: {what}")


def run(device="cuda", batch: int = 16, size: int = 160, ci: int = 64, co: int = 256) -> dict:
    """Check the legs against each other and, on a CUDA device, time them.

    Returns ``{"legs": {name: {"ms", "tflops", "gbps", "launches"}},
    "bound": {...}, "flops", "bytes", "errors": {...}}``; ``ms`` and the
    rates are None on the CPU, where nothing is timed."""
    device = torch.device(device)
    rng = np.random.RandomState(SEED)  # the JAX probe's draws, in its order
    w = torch.from_numpy((rng.randn(ci, co) * 0.05).astype(np.float32)).to(device, torch.bfloat16)
    x_img = torch.from_numpy((rng.randn(batch, size, size, ci) * 0.5).astype(np.float32)).to(device, torch.bfloat16)
    m = batch * size * size
    x = x_img.reshape(m, ci)
    x_nchw = x_img.permute(0, 3, 1, 2)  # channels_last memory
    w4 = w.t().reshape(co, ci, 1, 1).contiguous()

    def library_conv():
        return F.conv2d(x_nchw, w4)

    def library_conv_stats():
        y = F.conv2d(x_nchw, w4)
        yf = y.float()
        return y, yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))

    legs = {
        "library_conv": library_conv,
        "library_conv_stats": library_conv_stats,
        "kernel": lambda: conv_probes.matmul_stats(x, w),
        "kernel_stats": lambda: conv_probes.matmul_stats(x, w, stats=True),
        "plain": lambda: conv_probes.matmul_stats_reference(x, w),
        "plain_stats": lambda: conv_probes.matmul_stats_reference(x, w, stats=True),
    }

    with torch.no_grad():
        y_ref, s1_ref, s2_ref = legs["plain_stats"]()
        yf_ref = x.float() @ w.float()
        abs_sum, sq_sum = yf_ref.abs().sum(dim=0), (yf_ref * yf_ref).sum(dim=0)
        slack = order_slack(ci, x.float().abs() @ w.float().abs())
        y_k = legs["kernel"]()
        y_ks, s1_k, s2_k = legs["kernel_stats"]()
        y_lib = library_conv().permute(0, 2, 3, 1).reshape(m, co)
        _, s1_lib, s2_lib = library_conv_stats()
    _check(within_one_bf16_step(y_k, y_ref, slack), "kernel y is not within one bf16 step of the plain version's "
           f"(max abs error {float((y_k.float() - y_ref.float()).abs().max())})")
    _check(torch.equal(y_k, y_ks), "kernel y differs with and without the statistics")
    _check(within_sum_order(s1_k, s1_ref, abs_sum), "kernel sum is not within 1e-5 of sum |y|")
    _check(within_sum_order(s2_k, s2_ref, sq_sum), "kernel sum of squares is not within 1e-5 of sum y^2")
    lib_err = float((y_lib.float() - y_ref.float()).abs().max())
    _check(lib_err < 1e-2, f"library conv differs from the plain version by {lib_err}")
    _check(within_sum_order(s1_lib, s1_ref, abs_sum, 2**-7), "library sum is not within 2^-7 of sum |y|")
    _check(within_sum_order(s2_lib, s2_ref, sq_sum, 2**-7), "library sum of squares is not within 2^-7 of sum y^2")
    errors = {
        "kernel_y": float((y_k.float() - y_ref.float()).abs().max()),
        "kernel_sum": float((s1_k - s1_ref).abs().max()),
        "kernel_sumsq": float((s2_k - s2_ref).abs().max()),
        "library_y": lib_err,
    }

    flops = 2 * m * ci * co
    num_bytes = (m * ci + ci * co + m * co) * 2
    stats_ops = 3 * m * co  # the sum, the square and its sum, per output
    bounds = {"plain": bound(num_bytes, flops), "stats": bound(num_bytes + 2 * co * 4, flops, stats_ops)}
    timed = device.type == "cuda"
    where = card_name() if timed else "cpu: legs checked, nothing timed"
    print(f"probe_conv1x1: ({m}, {ci}) @ ({ci}, {co}) bf16, {flops / 1e9:.1f} GFLOP, {num_bytes / 1e6:.1f} MB; "
              f"{where}; errors {errors}", flush=True)
    results = {}
    for name, fn in legs.items():
        before = conv_probes.matmul_stats.launches
        ms = device_ms(fn) if timed else None
        results[name] = dict(
            ms=ms, tflops=flops / ms / 1e9 if ms else None, gbps=num_bytes / ms / 1e6 if ms else None,
            launches=conv_probes.matmul_stats.launches - before,
        )
        work_bound = bounds["stats" if name.endswith("stats") else "plain"]
        if timed:
            launches = results[name]["launches"] if name.startswith("kernel") else None
            print(leg_line(name, ms, flops, num_bytes, work_bound, launches), flush=True)
    return dict(legs=results, bound=bounds, flops=flops, bytes=num_bytes, errors=errors)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_conv1x1: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run()


if __name__ == "__main__":
    main()
