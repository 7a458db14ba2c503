"""Drive the PyTorch port's serving path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The flagship serving model (ResNet-50, FPN 256 channels over levels 3-7,
ObjectDetection with 80 classes; random weights from a seed) runs through
the port's hand-written kernels.  Phases, each of which raises on failure:

1. device: require CUDA; print the card's name and power limit;
2. build: compile both kernels from the checkout's sources;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   flagship path gives it, with CUDA-event timings of both;
4. slice: one batch of two 640 px images, f32, on the card and on the CPU
   (where the plain versions run) with the same weights;
5. serving: three requests of 16 images at 640 px in bf16.

The line before the last is a JSON object of per-kernel results; the last
line is ``{"ok": true, "device": {...}}``.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import torch

from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.heads import ObjectDetection, anchors
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.layers.convblocks import BatchNorm2d
from sihl_tpu_torch.layers.mlp import MLP, LayerNorm, Linear
from sihl_tpu_torch.ops import fused_mlp, fusion
from sihl_tpu_torch.policy import compute_dtype_scope

BATCH, SIZE, NUM_CLASSES, WIDTH = 16, 640, 80, 256
# anchors of levels 3-7 at 640 px: 80^2 + 40^2 + 20^2 + 10^2 + 5^2
NUM_ANCHORS = 8525
MAX_INSTANCES = 100


def card_name() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_flagship(generator: torch.Generator) -> SihlModel:
    backbone = Backbone("resnet50", top_level=5, generator=generator)
    neck = FPN(backbone.out_channels, WIDTH, bottom_level=3, top_level=7, generator=generator)
    head = ObjectDetection(
        neck.out_channels, NUM_CLASSES, bottom_level=3, top_level=7, generator=generator
    )
    return SihlModel(backbone, neck, [head])


def randomize_norms_and_biases(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Random BatchNorm running statistics, random affine parameters of every
    BatchNorm and LayerNorm, and random biases of every MLP Linear, so that
    no norm is the identity and every array the fused-MLP kernel reads
    (hidden biases, LayerNorm scale and shift per layer) is non-trivial."""

    def fill(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm2d, LayerNorm)):
                fill(m.weight, 0.8, 1.2)
                fill(m.bias, -0.1, 0.1)
            if isinstance(m, BatchNorm2d):
                fill(m.running_mean, -0.2, 0.2)
                fill(m.running_var, 0.5, 1.5)
            if isinstance(m, Linear):
                fill(m.bias, -0.1, 0.1)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` runs of ``fn``'s device time, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(gen: torch.Generator, cuda_gen: torch.Generator) -> dict:
    """Phase 3: each kernel against its plain version, timed at flagship
    shapes; ``serving`` marks the cases of the bf16 serving path."""
    results = {"fused_mlp": [], "upsample_add": []}
    rows = {"dense": BATCH * NUM_ANCHORS, "gathered": BATCH * MAX_INSTANCES}
    for dtype, atol, rtol in ((torch.bfloat16, 5e-2, 5e-2), (torch.float32, 1e-3, 0.0)):
        with compute_dtype_scope(dtype):
            heads = {
                "dense": [MLP(WIDTH, [WIDTH] * 4 + [1], generator=gen)],
                "gathered": [MLP(WIDTH, [WIDTH] * 4 + [n], generator=gen) for n in (NUM_CLASSES, 4)],
            }
        for case, mlps in heads.items():
            for m in mlps:
                randomize_norms_and_biases(m, gen)
            mlps = [m.cuda().eval() for m in mlps]
            x = torch.randn(rows[case], WIDTH, device="cuda", generator=cuda_gen).to(dtype)
            got = fused_mlp.fused_mlps(x, mlps)
            want = fused_mlp.fused_mlps_reference(x, mlps)
            torch.cuda.synchronize()
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            for g, w in zip(got, want):
                torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)
            ms = median_ms(lambda: fused_mlp.fused_mlps(x, mlps))
            plain_ms = median_ms(lambda: fused_mlp.fused_mlps_reference(x, mlps))
            results["fused_mlp"].append(
                dict(serving=dtype == torch.bfloat16, err=err, ms=ms, plain_ms=plain_ms)
            )
            print(f"  fused_mlp {case} {tuple(x.shape)} {dtype}: max_abs_err {err:.3g} "
                  f"(atol {atol}, rtol {rtol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    # the two top-down merges of the FPN at 640 px: level 5 into 4, level 4 into 3
    for h in (SIZE // 32, SIZE // 16):
        cl = torch.channels_last
        top = torch.randn(BATCH, WIDTH, h, h, device="cuda", generator=cuda_gen)
        lateral = torch.randn(BATCH, WIDTH, 2 * h, 2 * h, device="cuda", generator=cuda_gen)
        top, lateral = (t.to(torch.bfloat16).contiguous(memory_format=cl) for t in (top, lateral))
        got = fusion.fused_upsample_add(top, lateral)
        want = fusion.fused_upsample_add_reference(top, lateral)
        if not torch.equal(got, want):
            raise AssertionError(f"upsample_add at h={h} is not bitwise equal to its plain version")
        err = float((got.float() - want.float()).abs().max())
        ms = median_ms(lambda: fusion.fused_upsample_add(top, lateral))
        plain_ms = median_ms(lambda: fusion.fused_upsample_add_reference(top, lateral))
        results["upsample_add"].append(dict(serving=True, err=err, ms=ms, plain_ms=plain_ms))
        print(f"  upsample_add top {tuple(top.shape)} bf16: bitwise equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return results


def detect_with_indices(model: SihlModel, images: torch.Tensor):
    """The head's outputs and its top-k anchor indices, from one backbone and
    neck pass (the indices come from the loc branch run a second time)."""
    head = model.heads[0]
    feats = model.extract_features(images)
    flat = head.flat_features(feats)
    (loc,) = anchors.run_mlps(flat, [head.loc_head], num_valid=flat.shape[1])
    order = torch.sort(loc[..., 0].float(), dim=1, descending=True, stable=True)[1]
    return [t.cpu() for t in head(feats)], order[:, :MAX_INSTANCES].cpu()


def set_loc_bias(model: SihlModel, images: torch.Tensor) -> float:
    """Set the loc head's final bias midway between the 50th and 51st largest
    loc logits of the first image, so that about half of the top-100 slots
    score above 0.5 and no logit sits on that line; returns the bias."""
    head = model.heads[0]
    bias = head.loc_head.linears[-1].bias
    with torch.no_grad():
        bias.zero_()
        flat = head.flat_features(model.extract_features(images[:1]))
        (loc,) = anchors.run_mlps(flat, [head.loc_head], num_valid=flat.shape[1])
        top = torch.sort(loc[0, :, 0].float(), descending=True)[0]
        bias.fill_(-float(top[49] + top[50]) / 2)
    return float(bias)


def check_slice(model: SihlModel, gen: torch.Generator) -> None:
    """Phase 4: the f32 slice on the card against the CPU (plain versions)."""
    images = torch.rand(2, 3, SIZE, SIZE, generator=gen)
    loc_bias = set_loc_bias(model, images)
    t0 = time.perf_counter()
    (c_num, c_scores, c_classes, c_boxes), c_idx = detect_with_indices(model, images)
    t_cpu = time.perf_counter() - t0
    (num, scores, classes, boxes), idx = detect_with_indices(copy.deepcopy(model).cuda(), images.cuda())
    agree = idx == c_idx
    share = float(agree.float().mean())
    box_err = float((boxes - c_boxes).abs().amax(dim=2)[agree].max())
    score_err = float((scores - c_scores).abs().max())
    score_rel_err = float(((scores - c_scores).abs() / c_scores.abs()).max())
    print(f"  slice f32, 2 images at {SIZE} px, loc bias {loc_bias:.4f}: num_instances card "
          f"{num.tolist()} cpu {c_num.tolist()}; top-k indices agree in {share:.4f} of slots; "
          f"max box err {box_err:.3g} px; max score err {score_err:.3g} (relative "
          f"{score_rel_err:.3g}); CPU forward {t_cpu:.1f} s")
    if not 0 < int(c_num.sum()) < 2 * MAX_INSTANCES:
        raise AssertionError(f"num_instances {c_num.tolist()} leave nothing to compare")
    if not torch.equal(num, c_num):
        raise AssertionError("num_instances differ between card and CPU")
    if share < 0.98:
        raise AssertionError(f"top-k indices agree in only {share:.4f} of slots")
    if not torch.equal(classes[agree], c_classes[agree]):
        raise AssertionError("classes differ in slots whose indices agree")
    if box_err > 0.5 or score_err > 1e-3 or score_rel_err > 1e-3:
        raise AssertionError(
            f"box err {box_err} px, score err {score_err} or relative score err "
            f"{score_rel_err} out of bounds"
        )


def serve(model: SihlModel, cuda_gen: torch.Generator, requests: int = 3):
    """Phase 5: answer ``requests`` batches of 16 images at 640 px."""
    head = model.heads[0]
    latencies = []
    for _ in range(requests):
        images = torch.rand(BATCH, 3, SIZE, SIZE, device="cuda", generator=cuda_gen)
        t0 = time.perf_counter()
        outputs = model(images)[0]
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        for (name, shape), out in zip(head.output_shapes.items(), outputs):
            want = tuple(BATCH if s == "batch_size" else s for s in shape)
            if tuple(out.shape) != want:
                raise AssertionError(f"{name}: shape {tuple(out.shape)}, expected {want}")
        num, scores, classes, boxes = outputs
        if not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()):
            raise AssertionError("non-finite scores or boxes")
        if not ((0 <= classes).all() and (classes < NUM_CLASSES).all()):
            raise AssertionError("class ids out of range")
    return latencies


def main() -> None:
    # phase 1: device
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    print(f"card: {card_name()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    # phase 2: build
    t0 = time.perf_counter()
    fused_mlp._library()
    t1 = time.perf_counter()
    small = torch.zeros(1, 8, 2, 2, device="cuda").contiguous(memory_format=torch.channels_last)
    fusion.fused_upsample_add(small, torch.zeros(1, 8, 4, 4, device="cuda").contiguous(memory_format=torch.channels_last))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"build: fused_mlp (CUDA C++, sm_90a) {t1 - t0:.1f} s; upsample_add (Triton) {t2 - t1:.1f} s")

    # phase 3: kernels against their plain versions
    gen = torch.Generator().manual_seed(0)
    cuda_gen = torch.Generator("cuda").manual_seed(0)
    kernels = check_kernels(gen, cuda_gen)

    # phase 4: slice parity, f32, card against CPU
    model = build_flagship(gen)
    randomize_norms_and_biases(model, gen)
    model.eval()
    check_slice(model, gen)

    # phase 5: serving in bf16 through the kernels
    with compute_dtype_scope(torch.bfloat16):
        served = build_flagship(torch.Generator().manual_seed(1))
    served.load_state_dict(model.state_dict())
    served = served.cuda().eval()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.fused_mlps.launches = 0
    fusion.fused_upsample_add.launches = 0
    latencies = serve(served, cuda_gen)
    launches = {
        "fused_mlp": fused_mlp.fused_mlps.launches,
        "upsample_add": fusion.fused_upsample_add.launches,
    }
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steady = statistics.median(latencies[1:])
    print(f"  serving bf16, batch {BATCH} at {SIZE} px: request latencies "
          f"{[round(t * 1000, 3) for t in latencies]} ms; {BATCH / steady:.2f} images/s from "
          f"the median of requests 2-{len(latencies)}; peak memory {peak_gib:.2f} GiB; "
          f"kernel launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the serving path never launched the {name} kernel")

    summary = []
    for name, route, source, replaces in (
        ("fused_mlp", "cuda", "sihl_tpu_torch/ops/csrc/fused_mlp.cu", "sihl_tpu/ops/pallas/mlp.py:204"),
        ("upsample_add", "triton", "sihl_tpu_torch/ops/fusion_triton.py", "sihl_tpu/ops/pallas/fusion.py:59"),
    ):
        # ms and plain_ms: one request's worth, every call shape of the serving path
        cases = [c for c in kernels[name] if c["serving"]]
        summary.append(dict(
            name=name, route=route, source=source, replaces=replaces, launches=launches[name],
            max_abs_err=max(c["err"] for c in cases),
            ms=sum(c["ms"] for c in cases), plain_ms=sum(c["plain_ms"] for c in cases),
        ))
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
