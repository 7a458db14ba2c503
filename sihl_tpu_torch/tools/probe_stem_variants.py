"""Which part of the stem conv is slow on the card: the port of
``tools/probe_stem_variants.py``.  The ResNet stem's 7x7 / stride 2 conv of
16 images of 640 x 640 x 3 to (16, 320, 320, 64), bf16 NHWC, split into the
legs of ``ops.stem_variants.stem_variant``:

  load      stage each tile's input halo, write x[2i, 2j, co % 3] (no products)
  stage     load, and build each tile's 147-deep patch operand
  product   the products and the epilogue on one fixed patch per image
  full      the whole conv on the tensor cores, rounded once from f32 sums
  k4        ``ops.stem.stem_conv_stats``, the shipped kernel: the full conv
            and BatchNorm's sums, its bf16 body on the tensor cores; timed
            per call like the legs, and alone (``k4 alone``: device time
            from a CUDA graph of 20 calls, without the host work of its
            wrapper, which builds the weight image each call)
  library   PyTorch's bf16 conv on a channels_last tensor (cuDNN), the yardstick
  plain     the plain PyTorch version of ``full``: K4's plain version, whose
            BatchNorm sums it drops but still computes (and plain_load,
            plain_stage, plain_product, those of the other legs)

Every leg is checked before anything is timed: load and stage bit for bit
against their plain versions; product, full and k4 within one bf16 step of
theirs, plus the most two f32 sums of the same 147 products can differ by
(where the products cancel, that is more than a step of the small result);
the library within 1e-1 (a yardstick of the same function, not a port).
Each leg prints its device time, TF/s and effective GB/s of the full conv's
work, and the card's bound for that work.

Run on a CUDA card:  python -m sihl_tpu_torch.tools.probe_stem_variants
"""

import numpy as np
import torch
import torch.nn.functional as F

from sihl_tpu_torch.ops import stem
from sihl_tpu_torch.ops.stem_variants import MODES, TAPS, stem_variant, stem_variant_reference
from sihl_tpu_torch.tools.probe_timing import (bound, card_name, device_ms, graph_ms, leg_line, order_slack,
                                               within_one_bf16_step)

SEED = 0  # the JAX probe's numpy seed
CO, C = 64, 3


def run(device="cuda", batch: int = 16, size: int = 640) -> dict:
    """Check the legs against their plain versions and, on a CUDA device,
    time them.

    Returns ``{"legs": {name: {"ms", "tflops", "gbps", "launches"}},
    "bound", "leg_bounds": {mode: ...}, "flops", "bytes", "errors"}``, k4's
    leg with ``"alone_ms"`` too;
    ``bound`` is the full conv's, ``leg_bounds`` each kernel leg's own
    function's; ``ms`` and the rates are None on the CPU, where nothing is
    timed."""
    device = torch.device(device)
    rng = np.random.RandomState(SEED)  # the JAX probe's distributions: image on [0, 1), weights N(0, 0.1^2)
    x = torch.from_numpy(rng.rand(batch, size, size, C).astype(np.float32)).to(device, torch.bfloat16)
    w = torch.from_numpy((rng.randn(7, 7, C, CO) * 0.1).astype(np.float32)).to(device, torch.bfloat16)
    x_nchw = x.permute(0, 3, 1, 2)  # channels_last memory
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    legs = {mode: (lambda mode=mode: stem_variant(x, w, mode)) for mode in MODES}
    legs.update({
        "k4": lambda: stem.stem_conv_stats(x_nchw, w_oihw),
        "library": lambda: F.conv2d(x_nchw, w_oihw, stride=2, padding=3),
        "plain": lambda: stem_variant_reference(x, w, "full"),
    })
    legs.update({f"plain_{mode}": (lambda mode=mode: stem_variant_reference(x, w, mode)) for mode in MODES[:3]})

    errors, wants = {}, {}
    with torch.no_grad():
        magnitude = stem_variant_reference(x.float().abs(), w.float().abs(), "full")
        slack = {"full": order_slack(TAPS, magnitude), "product": order_slack(TAPS, magnitude[:, :1, :1])}
        for mode in MODES:
            got = legs[mode]()
            want = wants[mode] = stem_variant_reference(x, w, mode)
            errors[mode] = float((got.float() - want.float()).abs().max())
            exact = mode in ("load", "stage")
            if got.shape != want.shape or not (torch.equal(got, want) if exact
                                               else within_one_bf16_step(got, want, slack[mode])):
                raise AssertionError(f"probe_stem_variants: the {mode} kernel differs from its plain version "
                                     f"(max abs error {errors[mode]}, {'exact' if exact else 'one bf16 step'} asked)")
        want = wants["full"]
        k4 = legs["k4"]()[0].permute(0, 2, 3, 1)
        errors["k4"] = float((k4.float() - want.float()).abs().max())
        if not within_one_bf16_step(k4, want, slack["full"]):
            raise AssertionError(f"probe_stem_variants: K4's y is not within one bf16 step of the plain conv's "
                                 f"(max abs error {errors['k4']})")
        errors["library"] = float((legs["library"]().permute(0, 2, 3, 1).float() - want.float()).abs().max())
        if errors["library"] >= 1e-1:
            raise AssertionError(f"probe_stem_variants: the library conv differs from the plain version by "
                                 f"{errors['library']}")

    pixels = batch * (size // 2) ** 2
    flops = 2 * pixels * CO * TAPS
    x_bytes, y_bytes, w_bytes = batch * size * size * C * 2, pixels * CO * 2, TAPS * CO * 2
    num_bytes = x_bytes + w_bytes + y_bytes
    work_bound = bound(num_bytes, flops)
    leg_bounds = {
        "load": bound(pixels * C * 2 + y_bytes, 0),  # the even pixels of x
        "stage": bound(x_bytes + y_bytes, 0),
        "product": bound(batch * 4 * 4 * C * 2 + w_bytes + y_bytes, flops),  # pixel (0, 0)'s window
        "full": work_bound,
    }
    timed = device.type == "cuda"
    where = card_name() if timed else "cpu: legs checked, nothing timed"
    print(f"probe_stem_variants: ({batch}, {size}, {size}, {C}) NHWC by (7, 7, {C}, {CO}) bf16, stride 2, "
          f"{flops / 1e9:.1f} GFLOP, {num_bytes / 1e6:.1f} MB; {where}; max abs errors {errors}", flush=True)
    results = {}
    for name, fn in legs.items():
        before = stem_variant.launches
        ms = device_ms(fn) if timed else None
        results[name] = dict(
            ms=ms, tflops=flops / ms / 1e9 if ms else None, gbps=num_bytes / ms / 1e6 if ms else None,
            launches=stem_variant.launches - before,
        )
        if timed:
            launches = results[name]["launches"] if name in MODES else None
            print(leg_line(name, ms, flops, num_bytes, work_bound, launches), flush=True)
    if timed:
        alone = results["k4"]["alone_ms"] = graph_ms(legs["k4"])
        print(leg_line("k4 alone", alone, flops, num_bytes, work_bound), flush=True)
    return dict(legs=results, bound=work_bound, leg_bounds=leg_bounds, flops=flops, bytes=num_bytes, errors=errors)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_stem_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run()


if __name__ == "__main__":
    main()
