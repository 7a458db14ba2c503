"""Where the fused-MLP forward's time goes on the card: the port of
``tools/probe_mlp_pipeline.py``.  The flagship's dense loc and iou MLPs
(4 x [Linear 256 -> 256, LayerNorm, SiLU], then 256 -> 1) over 136,400
rows (16 images x 8,525 anchors at 640 px), bf16, no stash, in the modes of
``ops.mlp_pipeline.mlp_pipeline``:

  base       K1f, the shipped kernel
  nops       LayerNorm and SiLU replaced by the bias alone (the products' floor)
  mxured     LayerNorm's row sums as products with a ones column, one-pass variance
  pingpong   the block's two warpgroups take the tensor cores in turn
  pp+mxured  both
  plain      the plain PyTorch version of base (and plain_nops, plain_mxured,
             those of the other two functions)
  library    the same layer products alone on cuBLAS, the yardstick

Every mode is checked before anything is timed: each kernel equal to its
plain version but in at most a tenth of the outputs, and there by at most
one bf16 step at the largest output (a rounding that fell the other way;
on the card 1-3% of the outputs differ, a different function such as
two-pass against one-pass variance moves more than half); pingpong bit for
bit equal to base and pp+mxured to mxured (each row's arithmetic is the
same), mxured not bit for bit equal to base; every mode but nops within
2e-2 of base, the JAX probe's own check.  Each leg prints its device time
(a mode's from a CUDA graph of 20 calls, as ``chip_smoke.py`` times K1f
alone), TF/s and effective GB/s of the MLPs' work, and the card's bound
for it.

Run on a CUDA card:  python -m sihl_tpu_torch.tools.probe_mlp_pipeline
"""

import torch

from sihl_tpu_torch.ops import fused_mlp, mlp_pipeline
from sihl_tpu_torch.ops.mlp_pipeline import (HEADS, LAYERS, MODES, ROWS, WIDTH, mlp_pipeline_reference,
                                             mlps_from_probe_params, probe_params)
from sihl_tpu_torch.tools.probe_timing import (FLIP_SHARE, bound, card_name, cublas_products_ms, device_ms,
                                               differing_share, graph_ms, leg_line, within_rounding_flips)

SEED = 0  # the JAX probe's numpy seed
TOL = 2e-2  # the JAX probe's check between its modes, absolute on the bf16 outputs
PLAIN = {"base": "plain", "pingpong": "plain", "nops": "plain_nops", "mxured": "plain_mxured",
         "pp+mxured": "plain_mxured"}  # each mode's plain version


def _launches() -> int:
    return fused_mlp.fused_mlps.launches + mlp_pipeline.mlp_pipeline.launches


def _max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def run(device="cuda", m: int = ROWS) -> dict:
    """Check every mode and, on a CUDA device, time the legs.

    Returns ``{"legs": {name: {"ms", "tflops", "gbps", "launches"}},
    "bound", "flops", "bytes", "errors", "shares"}``; ``errors[mode]`` is
    the kernel's max abs error against its plain version,
    ``errors[mode + "_vs_base"]`` against base, ``shares`` the share of
    the outputs in which they differ.  ``ms`` and the rates are None on the
    CPU, where nothing is timed."""
    device = torch.device(device)
    heads, x = probe_params(SEED, m)
    mlps = mlps_from_probe_params(heads, device)
    x = torch.from_numpy(x).to(device, torch.bfloat16)
    legs = {mode: (lambda mode=mode: mlp_pipeline.mlp_pipeline(x, mlps, mode)) for mode in MODES}
    legs.update({name: (lambda mode=mode: mlp_pipeline_reference(x, mlps, mode))
                 for mode, name in (("base", "plain"), ("nops", "plain_nops"), ("mxured", "plain_mxured"))})

    errors, shares, outs = {}, {}, {}
    for mode in MODES:
        got = outs[mode] = legs[mode]()
        want = legs[PLAIN[mode]]()
        errors[mode] = _max_err(got, want)
        shares[mode] = differing_share(torch.cat(got), torch.cat(want))
        if any(g.shape != (m, 1) or g.dtype != torch.bfloat16 for g in got) or \
                not within_rounding_flips(torch.cat(got), torch.cat(want)):
            raise AssertionError(f"probe_mlp_pipeline: the {mode} kernel differs from its plain version in "
                                 f"{shares[mode]:.2%} of the outputs ({FLIP_SHARE:.0%} allowed), by up to "
                                 f"{errors[mode]} (one bf16 step at the largest output allowed)")
    for mode, same in (("pingpong", "base"), ("pp+mxured", "mxured")):
        if not all(torch.equal(g, w) for g, w in zip(outs[mode], outs[same])):
            raise AssertionError(f"probe_mlp_pipeline: {mode} is not bitwise equal to {same}")
    if all(torch.equal(g, w) for g, w in zip(outs["mxured"], outs["base"])):
        raise AssertionError("probe_mlp_pipeline: mxured is bitwise equal to base: its row sums are not its own")
    for mode in MODES[1:]:
        errors[f"{mode}_vs_base"] = _max_err(outs[mode], outs["base"])
        shares[f"{mode}_vs_base"] = differing_share(torch.cat(outs[mode]), torch.cat(outs["base"]))
        if mode != "nops" and errors[f"{mode}_vs_base"] >= TOL:
            raise AssertionError(f"probe_mlp_pipeline: {mode} differs from base by {errors[f'{mode}_vs_base']}")

    flops = HEADS * 2 * m * WIDTH * (LAYERS * WIDTH + 1)
    weights = HEADS * ((LAYERS * WIDTH * WIDTH + WIDTH) * 2 + (3 * LAYERS * WIDTH + 1) * 4)
    num_bytes = m * WIDTH * 2 + weights + HEADS * m * 2  # x, every parameter, the outputs
    work_bound = bound(num_bytes, flops)
    timed = device.type == "cuda"
    where = card_name() if timed else "cpu: modes checked, nothing timed"
    print(f"probe_mlp_pipeline: x ({m}, {WIDTH}) bf16 through {HEADS} MLPs of {LAYERS} x {WIDTH} -> 1, "
          f"{flops / 1e9:.1f} GFLOP, {num_bytes / 1e6:.1f} MB; {where}; max abs errors {errors}; "
          f"shares of the outputs that differ {shares}", flush=True)
    legs["library"] = lambda: cublas_products_ms(m, (1,) * HEADS, torch.bfloat16, backward=False)
    results = {}
    for name, fn in legs.items():
        before = _launches()
        if not timed:
            ms = None
        elif name in MODES:  # the kernel alone: a CUDA graph of 20 calls, no host time between them
            ms = graph_ms(fn)
        else:
            ms = fn() if name == "library" else device_ms(fn)
        results[name] = dict(
            ms=ms, tflops=flops / ms / 1e9 if ms else None, gbps=num_bytes / ms / 1e6 if ms else None,
            launches=_launches() - before,
        )
        if timed:
            launches = results[name]["launches"] if name in MODES else None
            print(leg_line(name, ms, flops, num_bytes, work_bound, launches), flush=True)
    return dict(legs=results, bound=work_bound, flops=flops, bytes=num_bytes, errors=errors, shares=shares)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_mlp_pipeline: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    run()


if __name__ == "__main__":
    main()
