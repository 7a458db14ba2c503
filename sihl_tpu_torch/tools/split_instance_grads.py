"""Split the instance slice's card-only gradient misses into head and trunk.

The draw: ``chip_smoke.build_instance`` and ``randomize_norms_and_biases``
from ``torch.Generator().manual_seed(0)`` with nothing drawn in between, the
train slice's weights from the same generator (``train_slice_models``,
which damps the residual branches), and phase 10's batch
``instance_batch(2, seed=1, mask_size=SIZE // 2)``.  One f32 step on the
card is held against the f64 step on the CPU (the plain versions) as
``chip_smoke.check_train_slice`` holds it, in pieces:

1. the matching: ``bbox_matching``'s assignment and relative IoU on the card
   against the CPU's, and the anchors where they differ;
2. head against trunk: the gradient the head sends into the neck's outputs
   on the card against the CPU's; the trunk's gradients from the card's
   own upstream gradient and from the CPU's f64 one, fed to the card's
   trunk backward, each against ``GRADIENT_LIMITS``;
3. the head's kernels: the head's step again with K5b's backward replaced
   by autograd of the plain decode, and K1f / K1b by the plain MLP chain;
4. the CPU's matches fed to the card's step: the whole step's gradients
   against ``GRADIENT_LIMITS``;
5. the trunk's forward and backward again with cuDNN off (PyTorch's own
   f32 convolutions on the card), from the CPU's f64 upstream gradient.

The smoke turns TF32 off for matrix products and cuDNN's convolutions;
so does this script, unless ``--pytorch-tf32-defaults`` leaves PyTorch's
defaults (TF32 in cuDNN's f32 convolutions), as a script that calls
``check_train_slice`` without the smoke's ``main`` does.

Nothing is changed in the package: the swaps are made on this process's
modules alone.  Prints its readings; fails only if a step does not run.

Run on a CUDA card from the repository root:
    python -m sihl_tpu_torch.tools.split_instance_grads [--pytorch-tf32-defaults]
"""

import argparse
import contextlib
import math

import torch

import chip_smoke as smoke
from sihl_tpu_torch.heads import anchors, instance_segmentation
from sihl_tpu_torch.layers import fpn
from sihl_tpu_torch.ops import dynconv, fused_mlp, fusion
from sihl_tpu_torch.tools.probe_timing import card_name
from sihl_tpu_torch.training.trainer import _call_step

TRUNK = {part: smoke.GRADIENT_LIMITS[part] for part in ("neck", "backbone")}
HEADS = {"heads": smoke.GRADIENT_LIMITS["heads"]}


@contextlib.contextmanager
def patched(module, name: str, value):
    """``module.name`` is ``value`` inside the block."""
    before = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, before)


def recording_matcher(store: list):
    """``bbox_matching`` that also keeps its outputs in ``store``, on the
    CPU, followed by the same matching in f64 on the CPU."""
    match = instance_segmentation.bbox_matching

    def matcher(*args, **kwargs):
        out = match(*args, **kwargs)
        exact = match(*(a.cpu().double() if torch.is_floating_point(a) else a.cpu() for a in args[:3]), *args[3:],
                      **kwargs)
        store.append(tuple(t.detach().cpu() for t in out))
        store.append((exact[0], exact[1].float()))
        return out

    return matcher


def fed_matcher(result):
    """``bbox_matching`` that returns ``result`` (assignment, relative IoU),
    moved to the anchors' device."""

    def matcher(anchors_, *args, **kwargs):
        return tuple(t.to(anchors_.device) for t in result)

    return matcher


class _PlainBackwardDecode(torch.autograd.Function):
    """K5f's forward, and autograd of the plain decode as its backward."""

    @staticmethod
    def forward(ctx, mask_feats, grid, centers, dyn, c, num_out):
        ctx.save_for_backward(mask_feats, grid, centers, dyn)
        ctx.c, ctx.num_out = c, num_out
        return dynconv._forward_cuda(mask_feats, grid, centers, dyn, c, num_out)

    @staticmethod
    def backward(ctx, gout):
        mask_feats, grid, centers, dyn = ctx.saved_tensors
        with torch.enable_grad():
            mf, d = mask_feats.detach().requires_grad_(), dyn.detach().requires_grad_()
            out = dynconv.reference_decode(mf, grid, centers, d, ctx.c, ctx.num_out)
            dmf, ddyn = torch.autograd.grad(out, (mf, d), gout)
        return dmf, None, None, ddyn, None, None


def plain_backward_decode(mask_feats, grid, centers, dyn, c, num_out):
    if mask_feats.device.type != "cuda":
        return dynconv.reference_decode(mask_feats, grid, centers, dyn, c, num_out)
    return _PlainBackwardDecode.apply(mask_feats, grid, centers, dyn, c, num_out)


def head_step(model, feats, levels, targets):
    """The head's loss and gradients on detached copies of ``feats``:
    ``(loss, metrics, {level: gradient into that feature}, {name: head
    parameter gradient})``; the head's gradients are set anew."""
    for p in model.heads.parameters():
        p.grad = None
    leaves = [f.detach().requires_grad_(i in levels) for i, f in enumerate(feats)]
    loss, metrics = _call_step(model.heads[0], "training_step", leaves, targets)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if n.startswith("heads.")}
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            {i: leaves[i].grad for i in levels}, grads)


def trunk_grads(model, feats, levels, upstream, retain: bool = False) -> dict:
    """The trunk's parameter gradients from ``upstream`` gradients of the
    neck's outputs at ``levels``."""
    for n, p in model.named_parameters():
        if not n.startswith("heads."):
            p.grad = None
    outs = [feats[i] for i in levels]
    torch.autograd.backward(outs, [upstream[i].to(o.device, o.dtype) for i, o in zip(levels, outs)],
                            retain_graph=retain)
    return {n: p.grad for n, p in model.named_parameters() if not n.startswith("heads.")}


def split_model(model, images, targets, levels):
    """One train-mode forward of the trunk, then the head's step on it:
    ``(feats, loss, metrics, upstream, head gradients)``."""
    model.train()
    feats = model.extract_features(images)
    return (feats,) + head_step(model, feats, levels, targets)


def compare_matches(card, cpu, names=("the card", "the CPU")) -> bool:
    """Prints how one matching (``card``) differs from another (``cpu``),
    each ``(assignment, relative IoU)`` and named by ``names``; True if they
    make the same choices: the same assignments and loc targets."""
    (a_card, r_card), (a_cpu, r_cpu) = card, cpu
    one, other = names
    differ = (a_card != a_cpu).nonzero().tolist()
    rel_diff = (r_card.double() - r_cpu.double()).abs()
    ones_card, ones_cpu = r_card == 1.0, r_cpu == 1.0
    flips = (ones_card != ones_cpu).nonzero().tolist()
    same = not differ and not flips
    print(f"  matching, {one} against {other}: {int((a_card >= 0).sum())} and {int((a_cpu >= 0).sum())} matched "
          f"anchors; {len(differ)} assignments differ {differ[:10]}; relative IoU largest difference "
          f"{float(rel_diff.max()):.3g} at {int((rel_diff > 0).sum())} anchors; loc targets (relative IoU == 1) "
          f"{int(ones_card.sum())} and {int(ones_cpu.sum())}, differing at {flips[:10]}; "
          f"{'the same choices' if same else 'OTHER choices'}")
    for b, a in (differ + [f for f in flips if f not in differ])[:10]:
        print(f"    image {b} anchor {a}: {one} gt {int(a_card[b, a])} relative IoU {float(r_card[b, a])!r}, "
              f"{other} gt {int(a_cpu[b, a])} relative IoU {float(r_cpu[b, a])!r}")
    return same


def upstream_errors(got: dict, want: dict, label: str) -> None:
    print(f"  {label}: " + "; ".join(
        f"level {i} {tuple(want[i].shape)} relative L2 {smoke.relative_error(got[i].cpu(), want[i]):.3g}"
        for i in sorted(want)))


def report(label: str, loss: float, c_loss: float, grads: dict, c_grads: dict, f32_grads: dict, parts: dict) -> bool:
    print(f"  {label}: loss {loss:.6f} / {c_loss:.6f} (relative {abs(loss - c_loss) / abs(c_loss):.3g})")
    frozen = [n for n, g in grads.items() if g is None and c_grads[n] is None]  # the frozen stem
    failed = smoke.grade_gradients(grads, c_grads, f32_grads, parts, skip=frozen)
    print(f"    {len(failed)} out of bounds" + (f", the worst {failed[0]}" if failed else ""))
    return not failed


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pytorch-tf32-defaults", action="store_true",
                        help="leave PyTorch's TF32 defaults instead of turning TF32 off as the smoke does")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split_instance_grads: needs a CUDA card")
    if not args.pytorch_tf32_defaults:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(f"split_instance_grads: {card_name()}; TF32 in matrix products "
          f"{torch.backends.cuda.matmul.allow_tf32}, in cuDNN's convolutions {torch.backends.cudnn.allow_tf32}",
          flush=True)
    gen = torch.Generator().manual_seed(0)
    model = smoke.build_instance(gen)
    smoke.randomize_norms_and_biases(model, gen)
    model.eval()
    model, cpu_models = smoke.train_slice_models(model, gen, smoke.build_instance)
    split(model, cpu_models, *smoke.instance_batch(2, seed=1, mask_size=smoke.SIZE // 2))


def split(model, cpu_models: dict, images, targets) -> bool:
    """The four pieces, for ``model`` (the card's, f32) and its CPU copies
    in f64 and f32 (``train_slice_models``) on one batch.  Returns whether
    the card's step with the CPU's matches is within ``GRADIENT_LIMITS``."""
    cpu_images, cpu_targets = images.cpu(), {k: v.cpu() for k, v in targets.items()}
    head = model.heads[0]
    levels = sorted(set(head.levels) | {head.mask_level})

    # the CPU: f64 and f32 steps, split the same way, the f64 matching kept
    cpu = {}
    for dtype, ref in cpu_models.items():
        matches = []
        with patched(instance_segmentation, "bbox_matching", recording_matcher(matches)):
            feats, loss, metrics, up, head_g = split_model(ref, cpu_images, cpu_targets, levels)
        cpu[dtype] = dict(loss=loss, metrics=metrics, up=up, grads={**head_g, **trunk_grads(ref, feats, levels, up)},
                          matches=matches[0], exact=matches[1])
    c64, c32 = cpu[torch.float64], cpu[torch.float32]
    print(f"  CPU f64 loss {c64['loss']:.6f} {c64['metrics']}; CPU f32 loss {c32['loss']:.6f}", flush=True)
    upstream_errors(c32["up"], c64["up"], "the CPU f32 step's upstream gradient against f64")
    compare_matches(c32["matches"], c64["matches"], ("the CPU f32 step", "the CPU f64 step"))
    compare_matches(c64["matches"], c64["exact"], ("the CPU f64 step (f32 anchors and boxes)", "f64 throughout"))

    # the card's step as the smoke takes it, in pieces
    matches = []
    with patched(instance_segmentation, "bbox_matching", recording_matcher(matches)):
        feats, loss, metrics, up, head_g = split_model(model, images, targets, levels)
    print(f"  card f32 loss {loss:.6f} {metrics}", flush=True)
    same = compare_matches(matches[0], c64["matches"], ("the card", "the CPU f64 step"))
    compare_matches(matches[0], matches[1], ("the card", "f64 throughout on the CPU"))
    upstream_errors(up, c64["up"], "the card's upstream gradient against the CPU's f64")
    report("the head's gradients, card step", loss, c64["loss"], head_g, c64["grads"], c32["grads"], HEADS)
    own = trunk_grads(model, feats, levels, up, retain=True)
    report("the trunk's gradients from the card's own upstream gradient", loss, c64["loss"], own, c64["grads"],
           c32["grads"], TRUNK)
    fed = trunk_grads(model, feats, levels, c64["up"])
    report("the trunk's gradients from the CPU's f64 upstream gradient", loss, c64["loss"], fed, c64["grads"],
           c32["grads"], TRUNK)

    # the head's kernels swapped for autograd of their plain versions
    with patched(instance_segmentation, "dynamic_pointwise_decode", plain_backward_decode), \
            patched(anchors, "fused_mlps", fused_mlp.fused_mlps_reference):
        loss_p, _, up_p, head_p = head_step(model, feats, levels, targets)
    upstream_errors(up_p, c64["up"], "with K5b's backward and K1f / K1b plain: upstream gradient against f64")
    report("with K5b's backward and K1f / K1b plain: the head's gradients", loss_p, c64["loss"], head_p,
           c64["grads"], c32["grads"], HEADS)

    # the CPU's matches fed to the card's whole step
    with patched(instance_segmentation, "bbox_matching", fed_matcher(c64["matches"])):
        feats, loss_f, _, up_f, head_f = split_model(model, images, targets, levels)
    upstream_errors(up_f, c64["up"], "the CPU's matches fed to the card: upstream gradient against f64")
    whole = {**head_f, **trunk_grads(model, feats, levels, up_f)}
    ok = report("the CPU's matches fed to the card: the whole step's gradients", loss_f, c64["loss"], whole,
                c64["grads"], c32["grads"], smoke.GRADIENT_LIMITS)

    # the trunk with PyTorch's own convolutions in place of cuDNN's (their
    # outputs are not channels_last, which K3 refuses: its plain version)
    with torch.backends.cudnn.flags(enabled=False), \
            patched(fpn, "fused_upsample_add", fusion.fused_upsample_add_reference):
        model.train()
        feats = model.extract_features(images)
        plain = trunk_grads(model, feats, levels, c64["up"])
    report("cuDNN off: the trunk's gradients from the CPU's f64 upstream gradient", loss, c64["loss"], plain,
           c64["grads"], c32["grads"], TRUNK)
    print(f"split_instance_grads: the card's matching makes {'the same' if same else 'other'} choices as the "
          f"CPU's (assignments and loc targets); with the CPU's matches the card's step is {'within' if ok else 'NOT within'} GRADIENT_LIMITS; "
          f"loss with them {loss_f:.6f} against {c64['loss']:.6f} "
          f"({'agrees to 1e-6' if math.isclose(loss_f, c64['loss'], rel_tol=1e-6) else 'differs beyond 1e-6'})")
    return ok


if __name__ == "__main__":
    main()
