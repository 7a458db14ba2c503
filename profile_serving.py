"""Profile the PyTorch port on a CUDA card: one bf16 serving request, or with
``--train`` one bf16 training step.

Run from the repository root on a machine with an NVIDIA card:

    python3 profile_serving.py                      # a request of 16 images at 640 px
    python3 profile_serving.py --train              # bench.py's training step, 16 images at 640 px
    python3 profile_serving.py --instance [--train] # the instance-segmentation model instead
    python3 profile_serving.py --quad [--train]     # the quadrilateral detector instead
    python3 profile_serving.py --dense [--train]    # the dense model (semantic segmentation + depth)
    python3 profile_serving.py --panoptic [--train] # the panoptic model
    python3 profile_serving.py --hybrid [--train]   # the canonical detector (HybridEncoder neck)
    python3 profile_serving.py --multitask [--train] # the four-head multitask model
    python3 profile_serving.py --autoencoder [--train]     # the autoencoder
    python3 profile_serving.py --view-invariance [--train] # the view-invariance (Barlow Twins) model
    python3 profile_serving.py --anomaly [--train]         # the anomaly (EfficientAD) model
    python3 profile_serving.py --keypoint [--train]        # the keypoint (FCPose) model
    python3 profile_serving.py --pan [--train]             # the pretrained PAN detector
    python3 profile_serving.py --resnetv2 [--train]        # the ResNetV2 detector

It builds the flagship model of ``chip_smoke.py`` (or, with ``--instance``,
its instance-segmentation model, trained on masks (16, 100, 640, 640), or,
with ``--quad``, its quadrilateral detector, trained on 5-20 quads per image;
with ``--dense`` and ``--panoptic`` its dense models, trained on the
targets of ``chip_smoke.dense_batch`` and ``panoptic_batch``; with
``--hybrid`` its canonical detector, trained on bench.py's targets on the
example's multistep schedule, with ``--multitask`` its multitask model,
trained on ``chip_smoke.multitask_batch``, and with ``--autoencoder``,
``--view-invariance`` and ``--anomaly`` its self-supervised and anomaly
models, trained on ``chip_smoke.autoencoder_batch``, ``view_batch`` and
``anomaly_batch``, the anomaly model after its teacher's statistics and
``Trainer.pretrain`` (``chip_smoke.pretrained_teacher``; served after
``chip_smoke.calibrate_anomaly``), and with ``--keypoint`` its keypoint
model, trained on ``chip_smoke.keypoint_batch``; with ``--pan`` its
pretrained PAN detector, its trunk read from the file that
``chip_smoke.pretrained_home`` writes from a seed, and with ``--resnetv2``
its ResNetV2 detector, both trained on bench.py's targets;
random weights from a seed), warms it up, times ``TIMED`` requests or steps on the host clock (each
ended by ``torch.cuda.synchronize()``), then runs ``torch.profiler`` over
``PROFILED`` more.  It prints:

- the median unprofiled request or step time;
- the device's busy time per request or step: the union of the intervals of
  every device event, over ``PROFILED``;
- the busy share: busy time over the unprofiled time (the profiler's own
  host cost stretches profiled runs, so their span is not used);
- device time per request or step by class.  A class is a set of aten ops,
  each counted by the device time of the kernels it launched itself (not
  those of ops it called), or one of the port's own kernels, matched by
  name; "other" is busy time outside every class;
- the profiler's table of the top rows by device time.
"""

import argparse
import contextlib
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (
    BATCH, HYBRID_SCHEDULE, OPTIMIZER, PRETRAIN_BATCHES, SIZE, anomaly_batch, autoencoder_batch, build_anomaly,
    build_autoencoder, build_dense, build_flagship, build_hybrid, build_instance, build_keypoint, build_multitask,
    build_pan, build_panoptic, build_quad, build_resnetv2, build_view_invariance, calibrate_anomaly, card_name,
    dense_batch, freeze_trunk, instance_batch, keypoint_batch, multitask_batch, panoptic_batch, pretrained_home,
    pretrained_teacher, quad_batch, randomize_norms_and_biases, training_batch, view_batch,
)
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer

TIMED, PROFILED = 10, 3
# (label, aten op names, a trailing * for a prefix): the device time of the
# kernels each op launched itself
OP_CLASSES = (
    ("cuDNN convolutions", ("aten::cudnn_convolution",)),
    ("convolution backward", ("aten::convolution_backward",)),
    ("BatchNorm transform", ("aten::native_batch_norm",)),
    ("ReLU", ("aten::clamp_min", "aten::threshold_backward")),
    ("adds and subtractions", ("aten::add", "aten::add_", "aten::sub")),
    ("multiplications", ("aten::mul", "aten::mul_")),
    ("sums and means", ("aten::sum", "aten::mean")),
    ("max pool", ("aten::max_pool2d_with_indices", "aten::max_pool2d_with_indices_backward")),
    ("dtype casts and copies", ("aten::copy_",)),
    ("AdamW (foreach)", ("aten::_foreach_*",)),
    ("antialiased bilinear resize", ("aten::_upsample_bilinear2d_aa", "aten::_upsample_bilinear2d_aa_backward")),
    ("nearest-exact resize", ("aten::_upsample_nearest_exact2d", "aten::_upsample_nearest_exact2d_backward")),
    ("softmax and log-softmax", ("aten::_softmax", "aten::_log_softmax", "aten::_softmax_backward_data",
                                 "aten::_log_softmax_backward_data")),
    ("max, min and argmax", ("aten::amax", "aten::amin", "aten::argmax", "aten::max", "aten::min")),
    ("one-hot (scatter, fill)", ("aten::scatter_", "aten::fill_", "aten::zero_")),
    ("mask comparisons and any", ("aten::gt", "aten::any")),
    ("reflect pad (blur-pool)", ("aten::reflection_pad2d",)),
    ("nearest upsample", ("aten::upsample_nearest2d", "aten::upsample_nearest2d_backward")),
    ("matrix products", ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")),
    ("concatenation", ("aten::cat",)),
    ("GELU and SiLU", ("aten::gelu", "aten::gelu_backward", "aten::silu", "aten::silu_backward")),
    ("bilinear resize", ("aten::upsample_bilinear2d", "aten::upsample_bilinear2d_backward")),
    ("average pool", ("aten::avg_pool2d", "aten::avg_pool2d_backward")),
    ("sigmoid", ("aten::sigmoid", "aten::sigmoid_backward")),
    ("top-k and gather", ("aten::topk", "aten::gather", "aten::scatter")),
    ("squares and powers", ("aten::pow",)),
    ("sort", ("aten::sort",)),
)
# (label, substrings of the kernel's name): the port's hand-written kernels
KERNEL_CLASSES = (
    ("K1f fused MLP", ("fused_mlp_fwd",)),
    ("K1b fused MLP backward", ("fused_mlp_bwd_", "dw_bf16_kernel", "dw_f32_kernel", "reduce_partials_kernel")),
    ("K2 row k-th threshold", ("row_best_kth_kernel",)),
    ("K3 upsample-add", ("upsample_add_kernel",)),
    ("K5f dynamic decode", ("decode_fwd_kernel", "decode_fwd_mma_kernel")),
    ("K5b dynamic decode backward", ("decode_bwd_tile_kernel", "reduce_parts_kernel")),
    ("K4 stem conv + statistics", ("stem_conv_stats_kernel", "stem_conv_stats_mma_kernel", "stem_stats_reduce_kernel")),
    ("K6 weighted sum", ("weighted_sum_kernel",)),
)


def busy_us(events) -> float:
    """Length of the union of the events' [start, end) intervals, in us."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total + (cur_end - cur_start if cur_end is not None else 0.0)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train", action="store_true", help="profile a training step")
    models = parser.add_mutually_exclusive_group()
    models.add_argument("--instance", action="store_true", help="the instance-segmentation model")
    models.add_argument("--quad", action="store_true", help="the quadrilateral detector")
    models.add_argument("--dense", action="store_true", help="the dense model (semantic segmentation + depth)")
    models.add_argument("--panoptic", action="store_true", help="the panoptic model")
    models.add_argument("--hybrid", action="store_true", help="the canonical detector (HybridEncoder neck)")
    models.add_argument("--multitask", action="store_true", help="the four-head multitask model")
    models.add_argument("--autoencoder", action="store_true", help="the autoencoder")
    models.add_argument("--view-invariance", action="store_true", help="the view-invariance (Barlow Twins) model")
    models.add_argument("--anomaly", action="store_true", help="the anomaly (EfficientAD) model")
    models.add_argument("--keypoint", action="store_true", help="the keypoint (FCPose) model")
    models.add_argument("--pan", action="store_true", help="the pretrained PAN detector")
    models.add_argument("--resnetv2", action="store_true", help="the ResNetV2 detector")
    args = parser.parse_args()
    name, build, batch = (
        ("instance segmentation", build_instance, instance_batch) if args.instance
        else ("quadrilateral detection", build_quad, quad_batch) if args.quad
        else ("dense", build_dense, dense_batch) if args.dense
        else ("panoptic", build_panoptic, panoptic_batch) if args.panoptic
        else ("canonical detector", build_hybrid, training_batch) if args.hybrid
        else ("multitask", build_multitask, multitask_batch) if args.multitask
        else ("autoencoder", build_autoencoder, autoencoder_batch) if args.autoencoder
        else ("view invariance", build_view_invariance, view_batch) if args.view_invariance
        else ("anomaly", build_anomaly, lambda b: (anomaly_batch(b)[0], None)) if args.anomaly
        else ("keypoint", build_keypoint, keypoint_batch) if args.keypoint
        else ("pretrained PAN detector", build_pan, training_batch) if args.pan
        else ("ResNetV2 detector", build_resnetv2, training_batch) if args.resnetv2
        else ("flagship", build_flagship, training_batch)
    )
    train = args.train
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA card")
    print(f"card: {card_name()}")
    with pretrained_home() if args.pan else contextlib.nullcontext(), compute_dtype_scope(torch.bfloat16):
        model = build(torch.Generator().manual_seed(0))
    pretraining = [anomaly_batch(BATCH, seed=10 + i) for i in range(PRETRAIN_BATCHES)] if args.anomaly else None
    if train:
        freeze_trunk(model)
        trainer = Trainer(model, **OPTIMIZER, **(HYBRID_SCHEDULE if args.hybrid else {}))
        if pretraining:
            pretrained_teacher(pretraining)(trainer)
        images, targets = batch(BATCH)

        def work():
            trainer.training_step(images, targets)
    else:
        randomize_norms_and_biases(model, torch.Generator().manual_seed(1))
        if pretraining:
            calibrate_anomaly(model, pretraining)
        model.eval()
        images = torch.rand(
            BATCH, 3, SIZE, SIZE, device="cuda", generator=torch.Generator("cuda").manual_seed(0)
        )

        def work():
            with torch.no_grad():
                model(images)

    def timed() -> float:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000

    what = "step" if train else "request"
    for _ in range(3):
        timed()
    latency = statistics.median(timed() for _ in range(TIMED))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            timed()
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device_events:
        raise SystemExit("profile_serving: the profiler recorded no device time")
    busy = busy_us(device_events) / PROFILED / 1000
    print(f"{name}, batch {BATCH} at {SIZE} px, bf16: unprofiled {what} {latency:.3f} ms (median of "
          f"{TIMED}); device busy {busy:.3f} ms per {what} over {PROFILED} profiled; busy "
          f"share {busy / latency:.4f}; peak memory {peak_gib:.2f} GiB")

    averages = prof.key_averages()
    rows = []
    for label, ops in OP_CLASSES:
        hits = [e for e in averages if any(e.key == op or (op.endswith("*") and e.key.startswith(op[:-1]))
                                           for op in ops)]
        rows.append((label, sum(e.self_device_time_total for e in hits), sum(e.count for e in hits)))
    for label, names in KERNEL_CLASSES:
        hits = [e for e in averages if any(name in e.key for name in names)]
        rows.append((label, sum(e.device_time_total for e in hits), sum(e.count for e in hits)))
    rows.append(("other", busy * PROFILED * 1000 - sum(us for _, us, _ in rows), 0))
    print(f"{'class':24s} {'ms/' + what:>10s} {'share':>7s} {'calls/' + what:>13s}")
    for label, us, count in rows:
        ms = us / PROFILED / 1000
        print(f"{label:24s} {ms:10.3f} {ms / busy:7.3f} {count / PROFILED:13.1f}")
    print(averages.table(sort_by="device_time_total", row_limit=25, max_name_column_width=60))


if __name__ == "__main__":
    main()
