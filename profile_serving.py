"""Profile one bf16 serving request of the PyTorch port on a CUDA card.

Run from the repository root on a machine with an NVIDIA card:

    python3 profile_serving.py

It builds the flagship serving model of ``chip_smoke.py`` (random weights
from a seed), warms it up, times ``TIMED`` requests of 16 images at 640 px on
the host clock (each ended by ``torch.cuda.synchronize()``), then runs
``torch.profiler`` over ``PROFILED`` more.  It prints:

- the median unprofiled request latency;
- the device's busy time per request: the union of the intervals of every
  device event, over ``PROFILED``;
- the busy share: busy time over the unprofiled latency (the profiler's own
  host cost stretches profiled requests, so their span is not used);
- device time per request by class.  A class is either an aten op, whose
  device time includes every kernel it launched, or one of the port's own
  kernels, matched by name; "other" is busy time outside every class;
- the profiler's table of the top rows by device time.
"""

import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import BATCH, SIZE, build_flagship, card_name, randomize_norms_and_biases
from sihl_tpu_torch.policy import compute_dtype_scope

TIMED, PROFILED = 10, 3
# (label, aten op): the op's device time, kernels it launched included
OP_CLASSES = (
    ("cuDNN convolutions", "aten::cudnn_convolution"),
    ("BatchNorm transform", "aten::native_batch_norm"),
    ("ReLU", "aten::clamp_min"),
    ("adds", "aten::add"),
    ("max pool", "aten::max_pool2d_with_indices"),
    ("dtype casts and copies", "aten::copy_"),
)
# (label, substring of the kernel's name): the port's hand-written kernels
KERNEL_CLASSES = (
    ("K1f fused MLP", "fused_mlp_fwd"),
    ("K3 upsample-add", "upsample_add_kernel"),
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
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA card")
    print(f"card: {card_name()}")
    torch.set_grad_enabled(False)
    with compute_dtype_scope(torch.bfloat16):
        model = build_flagship(torch.Generator().manual_seed(0))
    randomize_norms_and_biases(model, torch.Generator().manual_seed(1))
    model = model.cuda().eval()
    images = torch.rand(
        BATCH, 3, SIZE, SIZE, device="cuda", generator=torch.Generator("cuda").manual_seed(0)
    )

    def request() -> float:
        t0 = time.perf_counter()
        model(images)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000

    for _ in range(3):
        request()
    latency = statistics.median(request() for _ in range(TIMED))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            request()
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device_events:
        raise SystemExit("profile_serving: the profiler recorded no device time")
    busy = busy_us(device_events) / PROFILED / 1000
    print(f"batch {BATCH} at {SIZE} px, bf16: unprofiled request {latency:.3f} ms (median of "
          f"{TIMED}); device busy {busy:.3f} ms per request over {PROFILED} profiled; busy "
          f"share {busy / latency:.4f}")

    averages = prof.key_averages()
    by_key = {e.key: e for e in averages}
    rows = [(label, by_key[op].device_time_total if op in by_key else 0.0, by_key[op].count
             if op in by_key else 0) for label, op in OP_CLASSES]
    for label, name in KERNEL_CLASSES:
        hits = [e for e in averages if name in e.key]
        rows.append((label, sum(e.device_time_total for e in hits), sum(e.count for e in hits)))
    rows.append(("other", busy * PROFILED * 1000 - sum(us for _, us, _ in rows), 0))
    print(f"{'class':24s} {'ms/request':>10s} {'share':>7s} {'calls/request':>13s}")
    for label, us, count in rows:
        ms = us / PROFILED / 1000
        print(f"{label:24s} {ms:10.3f} {ms / busy:7.3f} {count / PROFILED:13.1f}")
    print(averages.table(sort_by="device_time_total", row_limit=25, max_name_column_width=60))


if __name__ == "__main__":
    main()
