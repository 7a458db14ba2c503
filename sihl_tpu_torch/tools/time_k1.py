"""Device times of the fused-MLP kernels K1f and K1b alone at every call the
models' bf16 paths make, to compare two trees' kernels on one card:

    python -m sihl_tpu_torch.tools.time_k1 [substring of a call's label ...]
    cd <other tree> && PYTHONPATH=. python <this tree>/sihl_tpu_torch/tools/time_k1.py [...]

The second form times the other tree's package (first on the path) with
this script's shapes; a call that tree's wrapper refuses (an output layer
wider than it takes) prints as refused.  Run the trees in turns (A, B, B,
A) in one command.  Each line: the call, K1f alone (a CUDA graph of 20
calls over packed weights; a training call's forward writes the stash its
backward reads) and, for a training call, K1b alone, with the card's name
and power limit.  Substrings given as arguments time only the calls whose
label holds one of them.
"""

import sys

import torch

from sihl_tpu_torch.layers.mlp import MLP
from sihl_tpu_torch.ops import fused_mlp
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.tools.probe_timing import card_name, graph_ms

WIDTH, LAYERS = 256, 4
# (call, rows, output widths, training) of the models at batch 16, 640 px:
# anchors of levels 3-7 (8,525 an image), 3-5 (8,400) and 5 (400); the
# heads' top 100 and their training rows (100 or 20 targets x 9 positives,
# 256 mask positives, 128 keypoint positives)
CALLS = (
    ("flagship dense", 16 * 8525, (1,), False),
    ("flagship gathered", 1600, (80, 4), False),
    ("flagship dense train", 16 * 8525, (1, 1), True),
    ("flagship gathered train", 16 * 900, (80, 4), True),
    ("levels 3-5 dense", 16 * 8400, (1,), False),
    ("levels 3-5 dense train", 16 * 8400, (1,), True),
    ("levels 3-5 loc + iou train", 16 * 8400, (1, 1), True),
    ("instance gathered", 1600, (80, 169), False),
    ("instance gathered train", 16 * 256, (80, 169), True),
    ("quad gathered", 1600, (8, 5), False),
    ("quad gathered train", 16 * 180, (8, 5), True),
    ("multitask gathered", 1600, (10, 4), False),
    ("multitask gathered train", 16 * 180, (10, 4), True),
    ("keypoint dense", 16 * 400, (1,), False),
    ("keypoint dense train", 16 * 400, (1,), True),
    ("keypoint gathered", 1600, (17, 2737), False),
    ("keypoint gathered train", 16 * 128, (17, 2737), True),
)


def call_times(rows: int, outs, training: bool, gen: torch.Generator):
    """(K1f ms, K1b ms or None) alone, bf16, random MLPs and inputs."""
    with compute_dtype_scope(torch.bfloat16):
        mlps = [MLP(WIDTH, [WIDTH] * LAYERS + [n], generator=gen, device="cpu").cuda() for n in outs]
    x = torch.randn(rows, WIDTH, device="cuda").to(torch.bfloat16)
    fused_mlp._check_supported(x, mlps, WIDTH)
    packs = [fused_mlp.pack_mlp_params(mlp, torch.bfloat16) for mlp in mlps]
    stash = fused_mlp.stash_for(x, packs) if training else None
    with torch.no_grad():
        fwd = graph_ms(lambda: fused_mlp._forward_cuda(x, packs, stash))
        if not training:
            return fwd, None
        gs = [torch.randn(rows, n, device="cuda").to(torch.bfloat16) for n in outs]
        return fwd, graph_ms(lambda: fused_mlp.fused_mlps_backward(x, packs, gs, stash))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_k1: needs a CUDA card")
    card = card_name()
    print(f"K1 alone, bf16, package {fused_mlp.__file__} [{card}]")
    gen = torch.Generator().manual_seed(0)
    for label, rows, outs, training in CALLS:
        if len(sys.argv) > 1 and not any(part in label for part in sys.argv[1:]):
            continue
        try:
            fwd, bwd = call_times(rows, outs, training, gen)
        except ValueError as refused:
            print(f"  {label} ({rows}, outputs {outs}): refused ({refused})")
            continue
        print(f"  {label} ({rows}, outputs {outs}): K1f {fwd:.4f} ms" + (f", K1b {bwd:.4f} ms" if bwd else ""))


if __name__ == "__main__":
    main()
