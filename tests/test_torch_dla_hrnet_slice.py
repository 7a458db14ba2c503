"""The DLA and HRNet models of the port against the JAX package's (CPU): the
two that ``chip_smoke.py`` runs at full size (phases 98-107), here narrow
and at 64 px.

* the DLA detector: dla34, level 1 frozen on both sides → FPN 16 wide over
  levels 3-5 → ObjectDetection (5 classes, 16 channels, one hidden layer,
  8 instances, 5 targets); boxes with centres on half pixels;
* the HRNet segmenter: hrnet_w18 cut to one module a stage and one block a
  branch (``HRNET_STAGES``), level 1 frozen → no neck →
  SemanticSegmentation (5 classes, void 255, 16 channels) over levels 2-5,
  reading the stride-4 branch as HRNetV2 does; classes in 4 x 4 blocks,
  about 10% void.

The trunks are ``test_torch_dla_hrnet.quick_jax_net``'s (leaves from
``torch_parity.numpy_filled``), each residual branch's last BatchNorm
damped (``_damp_residual_branches``), the neck's and head's norms
randomised; every weight crosses by ``state_dict_from_flat`` (strict).  4 images at
64 px, each with its own brightness and contrast.  Neither net cuts the
gradient after its frozen level, as in the JAX package: the frozen level-1
parameters get gradients, held like the others.

Compared: the eval forward against JAX's f32 forward (integer outputs
exact, floats within 1e-5 relative); one training step through
``_losses``, the port in f64 and f32 against JAX's f64 step: losses and
metrics within 1e-4, gradients within ``F64_LIMIT`` (f64) and the part
limits of
``GRADIENT_LIMITS`` (f32; ROADMAP.md queue C) against the port's f64 step
taking the f32 step's ReLU and channel-maximum decisions (each within
1e-4 of its kink), a gradient that is zero in exact arithmetic below 1e-6
of its part's largest, and the running statistics within 1e-4.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.backbones import dla as jax_dla
from sihl_tpu.backbones import hrnet as jax_hrnet
from sihl_tpu.backbones.base import PyramidBackbone as JaxPyramidBackbone
from sihl_tpu.heads import ObjectDetection as JaxObjectDetection
from sihl_tpu.heads import SemanticSegmentation as JaxSemanticSegmentation
from sihl_tpu.layers import FPN as JaxFPN
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import UAFM, ObjectDetection, SemanticSegmentation
from sihl_tpu_torch.heads.semantic_segmentation import channel_max
from sihl_tpu_torch.backbones import hrnet
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.ops.relu import relu
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training.trainer import _losses

from test_torch_classification_slice import _relative_error
from test_torch_dla_hrnet import quick_jax_net
from test_torch_hybrid_slice import F64_LIMIT, GRADIENT_LIMITS, _f64, _zero_in_exact_arithmetic, jax_f64
from test_torch_validation import T, box_targets
from torch_parity import flat_state, randomize_norms, to_torch

BATCH, SIZE, NUM_CLASSES, IGNORE = 4, 64, 5, 255
TRUNKS = {"dla": "dla34", "hrnet": "hrnet_w18"}
STEP_SEED = 2
# one module a stage and one basic block a branch: every block, transition
# and fusion link of hrnet_w18 at its widths, where a compile of JAX's f64
# step through the full depth takes over three minutes
HRNET_STAGES = ((1, 1), (1, 1), (1, 1))


@contextlib.contextmanager
def _shallow_hrnet():
    """Both packages build HRNet with ``HRNET_STAGES``."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_hrnet, hrnet):
            mp.setattr(module, "_STAGES", HRNET_STAGES)
        yield


def _build(kind, bb, fpn, detection, semantic, model, **init):
    bb.set_frozen_levels(1)
    if kind == "dla":
        neck = fpn(bb.out_channels, 16, bottom_level=3, top_level=5, **init)
        head = detection(neck.out_channels, NUM_CLASSES, num_channels=16, num_layers=1, max_instances=8,
                         max_targets=T, **init)
        return model(bb, neck, [head])
    head = semantic(bb.out_channels, NUM_CLASSES, bottom_level=2, top_level=5, num_channels=16,
                    ignore_index=IGNORE, **init)
    return model(bb, None, [head])


def _jax_model(kind):
    name = TRUNKS[kind]
    with _shallow_hrnet():
        bb = JaxPyramidBackbone(name, quick_jax_net(name), rngs=nnx.Rngs(0))
    model = _build(kind, bb, JaxFPN, JaxObjectDetection, JaxSemanticSegmentation, JaxSihlModel, rngs=nnx.Rngs(0))
    rng = np.random.RandomState(3)
    for sub in (model.neck, model.heads):
        if sub is not None:
            randomize_norms(sub, rng)
    _damp_residual_branches(model, rng)
    return model


# each residual block's last conv, by the block's class
LAST_CONV = {jax_dla.DlaBasic: "conv2", jax_dla.DlaBottleneck: "conv3", jax_hrnet._BasicBlock: "conv2",
             jax_hrnet._Bottleneck: "conv3"}


def _damp_residual_branches(model, rng: np.random.RandomState) -> None:
    """The last BatchNorm scale of every residual branch at U(0.01, 0.03), as
    the other slice tests damp ResNet blocks: at full scales the f32
    gradients of a random-weight residual net lose their digits (the
    undamped DLA detector's f32 step read 6.4e-3 from f64 on its first conv,
    past the backbone's 5e-3)."""
    for _, sub in nnx.iter_graph(model):
        if type(sub) in LAST_CONV:
            bn = getattr(sub, LAST_CONV[type(sub)]).bn
            bn.scale[...] = jnp.asarray(rng.uniform(0.01, 0.03, bn.scale[...].shape), jnp.float32)


def _batch(kind: str, seed: int):
    """(JAX batch, port batch): images and the head's targets."""
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, SIZE, SIZE, 3) * rng.uniform(0.25, 1.0, (BATCH, 1, 1, 1))
    x = (x + rng.uniform(0.0, 0.75, (BATCH, 1, 1, 1))).astype(np.float32)
    if kind == "dla":
        classes, boxes = box_targets(rng, SIZE, NUM_CLASSES, (2, 3, 1, 4))
        return ((jnp.asarray(x), {"classes": jnp.asarray(classes), "boxes": jnp.asarray(boxes)}),
                (to_torch(x), {"classes": torch.from_numpy(classes).long(), "boxes": torch.from_numpy(boxes)}))
    semantic = rng.randint(0, NUM_CLASSES, (BATCH, SIZE // 4, SIZE // 4))
    semantic[rng.rand(*semantic.shape) < 0.1] = IGNORE
    semantic = semantic.repeat(4, 1).repeat(4, 2)
    return (jnp.asarray(x), jnp.asarray(semantic)), (to_torch(x), torch.from_numpy(semantic))


@pytest.fixture(scope="module", params=list(TRUNKS))
def pair(request):
    """The JAX model, and the port's models in f32 and f64 on its weights."""
    kind = request.param
    jax_model = _jax_model(kind)
    models = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype), _shallow_hrnet():
            model = _build(kind, Backbone(TRUNKS[kind], device="cpu"), FPN, ObjectDetection, SemanticSegmentation,
                           SihlModel)
        model.load_state_dict(state_dict_from_flat(flat_state(jax_model), model), strict=True)
        models[dtype] = model
    return kind, jax_model, models


def test_forward_matches_jax(pair):
    """The detector's loc bias at 3 on both sides, so that every image
    detects."""
    kind, jax_model, models = pair
    (jx, _), (x, _) = _batch(kind, 1)
    jax_model = nnx.clone(jax_model)
    if kind == "dla":
        bias = jax_model.heads[0].loc_head.linears[-1].bias
        bias[...] = jnp.full(bias[...].shape, 3.0, bias[...].dtype)
    model = copy.deepcopy(models[torch.float32])
    model.load_state_dict(state_dict_from_flat(flat_state(jax_model), model), strict=True)
    jax_model.eval()
    graphdef, state = nnx.split(jax_model)
    want = jax.jit(lambda s, xx: nnx.merge(graphdef, s)(xx)[0])(state, jx)
    with torch.no_grad():
        got = model.eval()(x)[0]
    assert len(got) == len(want) == (4 if kind == "dla" else 2)
    if kind == "dla":
        assert int(np.asarray(want[0]).sum()) > 0
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.fixture(scope="module")
def jax_step(pair):
    """JAX's f64 loss, metrics, gradients (a port state dict) and state after
    one training forward and backward on the ``STEP_SEED`` batch."""
    kind, jax_model, models = pair
    (jx, jt), _ = _batch(kind, STEP_SEED)
    with jax_f64():
        model = _jax_model(kind)
        nnx.update(model, _f64(nnx.state(jax_model, nnx.Not(nnx.RngState))))
        model.train()
        graphdef, state = nnx.split(model)

        def value_and_grad(s, xx, tt):
            m = nnx.merge(graphdef, s)
            (loss, metrics), grads = nnx.value_and_grad(lambda mm: jax_losses(mm, xx, tt), has_aux=True)(m)
            return loss, metrics, grads, nnx.state(m)

        loss, metrics, grads, state = jax.jit(value_and_grad)(state, _f64(jx), [jt])
        nnx.update(model, state)
        grads = state_dict_from_flat(
            {".".join(map(str, p)): np.asarray(v[...], np.float64) for p, v in nnx.to_flat_state(grads)},
            models[torch.float32])
        return float(loss), {k: float(v) for k, v in metrics.items()}, grads, flat_state(model)


@contextlib.contextmanager
def decision_sites(model, recorded: dict, taken=None):
    """Inside the block, every ReLU that a module of ``model`` holds as its
    ``act``, and every UAFM's ``channel_max``, records its inputs, call by
    call, into ``recorded``; with ``taken`` (another forward's
    ``recorded``) each takes that forward's decisions: the same branch of
    each ReLU, the same channel of each maximum.  Yields the names of the
    maxima."""
    sites = {}
    for name, mod in model.named_modules():
        if getattr(mod, "act", None) is relu:
            sites[name] = (mod, "act", relu)
        if isinstance(mod, UAFM):
            sites[name] = (mod, "channel_max", channel_max)

    def site(name, fn):
        inputs = iter(taken[name]) if taken is not None else None

        def decided(z):
            recorded.setdefault(name, []).append(z.detach().double())
            if inputs is None:
                return fn(z)
            if fn is relu:
                return torch.where(next(inputs) > 0, z, torch.zeros_like(z))
            return torch.gather(z, 1, next(inputs).argmax(dim=1, keepdim=True))
        return decided

    for name, (mod, attr, fn) in sites.items():
        setattr(mod, attr, site(name, fn))
    try:
        yield {name for name, (_, attr, _) in sites.items() if attr == "channel_max"}
    finally:
        for mod, attr, fn in sites.values():
            setattr(mod, attr, fn)


def _flip_gap(z64: dict, z32: dict, maxima) -> float:
    """The farthest that a decision which the f32 forward took another way
    lies from its kink in the f64 forward, relative to the site's largest
    input: a ReLU input from 0, a maximum's pick (the sites ``maxima``)
    below the maximum."""
    gap = 0.0
    for name in z64:
        for z, z_f32 in zip(z64[name], z32[name]):
            if name in maxima:
                pick = z_f32.argmax(dim=1, keepdim=True)
                below = (z.amax(dim=1, keepdim=True) - z.gather(1, pick))[pick != z.argmax(dim=1, keepdim=True)]
            else:
                below = z.abs()[(z > 0) != (z_f32 > 0)]
            if below.numel():
                gap = max(gap, float(below.max() / z.abs().max()))
    return gap


def _step(model, x, t):
    model = copy.deepcopy(model).train()
    loss, metrics = _losses(model, x, [t])
    loss.backward()
    return model, loss, metrics


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_train_step_losses_gradients_and_stats_match_jax(pair, jax_step, dtype):
    """The f64 step against JAX's within ``F64_LIMIT``.  The f32 step
    against the port's f64 step taking the f32 step's decisions
    (``decision_sites``: every module's ReLU ``act`` in trunk, neck and
    head, and the UAFM channel maxima), each one taken another way within
    1e-4 of its site's largest input from its kink (``_flip_gap``), as
    ``chip_smoke.py`` holds the card: a ReLU input that f32 rounds across 0
    sends or stops its whole gradient (one such flip moved a dla34 block's
    conv gradient 2e-2 from f64, where JAX's own f32 step read 1.8e-4).
    Each f32 gradient lies within its part's relative limit, or, like a
    gradient that is zero in exact arithmetic, within 1e-6 of the part's
    largest: a UAFM attention conv's one-element bias sums a cancelling
    term over every pixel, and f32's error there scales with the terms, not
    with the sum (hrnet's ``fusions.2.conv.conv.bias``, 1.4e-4 of the
    head's largest gradient, read 1.02e-3 from f64, 1.4e-7 of the largest)."""
    kind, _, models = pair
    want_loss, want_metrics, want_grads, jax_state = jax_step
    _, (x, t) = _batch(kind, STEP_SEED)
    z32, z64 = {}, {}
    with decision_sites(models[dtype], z32):
        model, loss, metrics = _step(models[dtype], x.to(dtype), t)
    if dtype == torch.float32:
        with decision_sites(models[torch.float64], z64, taken=z32) as maxima:
            reference, _, _ = _step(models[torch.float64], x.double(), t)
        want_grads = {n: p.grad.detach() for n, p in reference.named_parameters()}
        assert _flip_gap(z64, z32, maxima) <= 1e-4

    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-4)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(want_metrics[k], rel=1e-4, abs=1e-6), k
    largest = {}
    for name, g in want_grads.items():
        part = name.split(".")[0]
        largest[part] = max(largest.get(part, 0.0), float(g.norm()))
    frozen = {n for n, _ in model.named_parameters()
              if n.startswith("backbone.features.") and model.backbone.is_frozen_param(n.split(".")[2:])}
    level1 = model.backbone.features.level_modules[0]
    assert frozen == {n for n, _ in model.named_parameters()
                      if n.startswith(tuple(f"backbone.features.{m}." for m in level1))}
    for name, p in model.named_parameters():
        assert p.grad is not None, name  # the frozen level too: the net runs its backward
        if _zero_in_exact_arithmetic(name, want_grads, largest):
            assert float(p.grad.norm()) <= 1e-6 * largest[name.split(".")[0]], name
            continue
        err = _relative_error(p.grad, want_grads[name])
        if dtype == torch.float64:
            assert err <= F64_LIMIT, (name, err)
        else:  # or, a small gradient, within the zero rule's absolute bound
            off = float((p.grad.double() - want_grads[name]).norm()) / largest[name.split(".")[0]]
            assert err <= GRADIENT_LIMITS[name.split(".")[0]] or off <= 1e-6, (name, err, off)

    want_state = state_dict_from_flat(jax_state, model)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.double().numpy(), want_state[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
