"""The 1x1 conv's weight gradient dW = x^T dy of the flagship backbone's
bottlenecks, a streaming reduction over the rows: the port of
``tools/probe_wrt_filter.py``, at its three shapes.

Legs per shape:

  library  ``torch.nn.grad.conv2d_weight`` in bf16 (cuDNN's weight gradient,
           what autograd runs in the training step), the yardstick
  kernel   ``ops.conv_probes.weight_grad_1x1``, the hand-written kernel
  plain    its plain PyTorch version (the f32 product)

Each leg prints its device time, TF/s and effective GB/s of the work, and
the card's bound for it (bytes: x and dy read once, dW written once).  The
legs are checked first: the kernel's dW within 1e-5 of |x|^T |dy| (the sum
of the magnitudes of each element's terms: f32 sums in another order) of the
plain version's, and the library's bf16 dW within 5e-2 of the largest |dW|
(the library is a yardstick whose rounding and order of summation are its
own: on an H100 its dW at 80 x 80, 256 -> 256 reads 0.77% of the largest
|dW| off, more than its final rounding explains; this check only shows that
it computes the same function).

Run on a CUDA card:  python -m sihl_tpu_torch.tools.probe_wrt_filter
"""

import numpy as np
import torch

from sihl_tpu_torch.ops import conv_probes
from sihl_tpu_torch.tools.probe_timing import bound, card_name, device_ms, leg_line, within_sum_order

SEED = 0  # the JAX probe's numpy seed
SHAPES = (
    # (name, batch, side, ci, co): rows are batch * side^2
    ("160sq_64_256", 16, 160, 64, 256),
    ("80sq_128_512", 16, 80, 128, 512),
    ("80sq_256_256", 16, 80, 256, 256),
)


def run(device="cuda", shapes=SHAPES) -> dict:
    """Check the legs of each shape against each other and, on a CUDA
    device, time them.  Returns ``{name: {"legs": {leg: {"ms", "tflops",
    "gbps", "launches"}}, "bound", "flops", "bytes", "errors"}}``; ``ms`` and
    the rates are None on the CPU, where nothing is timed."""
    device = torch.device(device)
    timed = device.type == "cuda"
    rng = np.random.RandomState(SEED)  # the JAX probe's draws, in its order
    print(f"probe_wrt_filter: {card_name() if timed else 'cpu: legs checked, nothing timed'}", flush=True)
    out = {}
    for name, batch, side, ci, co in shapes:
        m = batch * side * side
        x = torch.from_numpy((rng.randn(m, ci) * 0.1).astype(np.float32)).to(device, torch.bfloat16)
        dy = torch.from_numpy((rng.randn(m, co) * 0.1).astype(np.float32)).to(device, torch.bfloat16)
        x_img = x.view(batch, side, side, ci).permute(0, 3, 1, 2)  # channels_last memory
        dy_img = dy.view(batch, side, side, co).permute(0, 3, 1, 2)
        legs = {
            "library": lambda: torch.nn.grad.conv2d_weight(x_img, (co, ci, 1, 1), dy_img),
            "kernel": lambda: conv_probes.weight_grad_1x1(x, dy),
            "plain": lambda: conv_probes.weight_grad_1x1_reference(x, dy),
        }
        with torch.no_grad():
            ref = legs["plain"]()
            magnitude = x.float().abs().T @ dy.float().abs()
            got = legs["kernel"]()
            lib = legs["library"]().reshape(co, ci).T.float()
        scale = float(ref.abs().max())
        errors = {"kernel": float((got - ref).abs().max()), "library": float((lib - ref).abs().max())}
        if not within_sum_order(got, ref, magnitude):
            raise AssertionError(f"probe_wrt_filter {name}: kernel dW is not within 1e-5 of |x|^T |dy|")
        if errors["library"] > 5e-2 * scale:
            raise AssertionError(f"probe_wrt_filter {name}: library dW differs by {errors['library']}, "
                                 f"largest |dW| {scale}")
        flops = 2 * m * ci * co
        num_bytes = m * (ci + co) * 2 + ci * co * 4
        work_bound = bound(num_bytes, flops)
        print(f"-- {name}: ({m}, {ci})^T @ ({m}, {co}), {num_bytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP; "
              f"max abs errors {errors} (largest |dW| {scale:.4g})", flush=True)
        results = {}
        for leg, fn in legs.items():
            before = conv_probes.weight_grad_1x1.launches
            ms = device_ms(fn) if timed else None
            results[leg] = dict(
                ms=ms, tflops=flops / ms / 1e9 if ms else None, gbps=num_bytes / ms / 1e6 if ms else None,
                launches=conv_probes.weight_grad_1x1.launches - before,
            )
            if timed:
                print(leg_line(leg, ms, flops, num_bytes, work_bound,
                               results[leg]["launches"] if leg == "kernel" else None), flush=True)
        out[name] = dict(legs=results, bound=work_bound, flops=flops, bytes=num_bytes, errors=errors)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_wrt_filter: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run()


if __name__ == "__main__":
    main()
