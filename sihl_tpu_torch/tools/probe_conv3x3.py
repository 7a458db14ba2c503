"""The 3x3 conv 64 -> 64 of the flagship backbone's stage 1 (16 images at
160 x 160, SAME padding): the port of ``tools/probe_conv3x3_pallas.py``.

Legs:

  library  PyTorch's bf16 3x3 conv on a channels_last tensor (cuDNN; what
           ``backbones/resnet.py`` runs), the yardstick
  kernel   ``ops.conv_probes.conv3x3``, the hand-written kernel, on the
           unpadded NHWC input (the JAX probe's pre-haloed tiles existed only
           because BlockSpec blocks cannot overlap)
  plain    its plain PyTorch version (9 f32 tap products, rounded once)

Each leg prints its device time, TF/s and effective GB/s of the work, and
the card's bound for it.  The legs are checked first: the kernel's y within
one bf16 step of the plain version's (plus what f32 order can move a sum of
576 products whose terms cancel), the library's within 1e-1 (the JAX probe's
check).

Run on a CUDA card:  python -m sihl_tpu_torch.tools.probe_conv3x3
"""

import numpy as np
import torch
import torch.nn.functional as F

from sihl_tpu_torch.ops import conv_probes
from sihl_tpu_torch.tools.probe_timing import bound, card_name, device_ms, leg_line, order_slack, within_one_bf16_step

SEED = 0  # the JAX probe's numpy seed


def run(device="cuda", batch: int = 16, size: int = 160, channels: int = 64) -> dict:
    """Check the legs against each other and, on a CUDA device, time them.

    Returns ``{"legs": {name: {"ms", "tflops", "gbps", "launches"}},
    "bound", "flops", "bytes", "errors"}``; ``ms`` and the rates are None on
    the CPU, where nothing is timed."""
    device = torch.device(device)
    c = channels
    rng = np.random.RandomState(SEED)  # the JAX probe's draws, in its order
    x = torch.from_numpy((rng.randn(batch, size, size, c) * 0.5).astype(np.float32)).to(device, torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, c, c) * 0.05).astype(np.float32)).to(device, torch.bfloat16)
    x_nchw = x.permute(0, 3, 1, 2)  # channels_last memory
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    legs = {
        "library": lambda: F.conv2d(x_nchw, w_oihw, padding=1),
        "kernel": lambda: conv_probes.conv3x3(x, w),
        "plain": lambda: conv_probes.conv3x3_reference(x, w),
    }
    with torch.no_grad():
        ref = legs["plain"]()
        slack = order_slack(9 * c, conv_probes.conv3x3_reference(x.float().abs(), w.float().abs()))
        got = legs["kernel"]()
        lib = legs["library"]().permute(0, 2, 3, 1)
    errors = {"kernel": float((got.float() - ref.float()).abs().max()),
              "library": float((lib.float() - ref.float()).abs().max())}
    if not within_one_bf16_step(got, ref, slack):
        raise AssertionError(f"probe_conv3x3: kernel y is not within one bf16 step of the plain version's "
                             f"(max abs errors {errors})")
    if errors["library"] >= 1e-1:
        raise AssertionError(f"probe_conv3x3: library conv differs from the plain version by {errors['library']}")

    flops = 2 * batch * size * size * c * c * 9
    num_bytes = (2 * batch * size * size * c + 9 * c * c) * 2
    work_bound = bound(num_bytes, flops)
    timed = device.type == "cuda"
    where = card_name() if timed else "cpu: legs checked, nothing timed"
    print(f"probe_conv3x3: ({batch}, {size}, {size}, {c}) NHWC by (3, 3, {c}, {c}) bf16, {flops / 1e9:.1f} "
          f"GFLOP, {num_bytes / 1e6:.1f} MB; {where}; max abs errors {errors}", flush=True)
    results = {}
    for name, fn in legs.items():
        before = conv_probes.conv3x3.launches
        ms = device_ms(fn) if timed else None
        results[name] = dict(
            ms=ms, tflops=flops / ms / 1e9 if ms else None, gbps=num_bytes / ms / 1e6 if ms else None,
            launches=conv_probes.conv3x3.launches - before,
        )
        if timed:
            print(leg_line(name, ms, flops, num_bytes, work_bound,
                           results[name]["launches"] if name == "kernel" else None), flush=True)
    return dict(legs=results, bound=work_bound, flops=flops, bytes=num_bytes, errors=errors)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_conv3x3: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run()


if __name__ == "__main__":
    main()
