"""Parity of the port's panoptic head with the JAX package's (CPU):
``panoptic_targets_from_maps``, the copy of ``PanopticQuality``, the
fusion of instances over the semantic classes, the label smoothing's decay
on the step counter, and the head's forward, ``training_step`` and
validation triple; the counter's way through ``state_dict_from_flat``.

The head at the size of ``tests/heads/test_panoptic.py``: a synthetic
pyramid of 2 images at 64 px, 3 stuff and 4 thing classes, 16 channels,
two layers (the semantic decoder one), 8 instances, 5 targets, void 255,
the smoothing decaying over 10 steps; weights carried by
``state_dict_from_flat`` (strict), every norm random.  Tolerances: class
and instance maps exact; scores and losses within 1e-5 relative; gradients
within relative L2 1e-3 of JAX's f32 step from the port in f64 and f32;
running statistics within 1e-5 relative or 1e-6 absolute (a tenth of a
percent of their scale: the f64 port's batch means of the semantic
decoder's SPPM differ from JAX's f32 ones by up to 7.5e-7); validation
metrics within 1e-5.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.heads import PanopticSegmentation as JaxPanopticSegmentation
from sihl_tpu.heads.panoptic_segmentation import panoptic_targets_from_maps as jax_targets_from_maps
from sihl_tpu.utils import panoptic_quality as jax_panoptic_quality
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import PanopticSegmentation, panoptic_targets_from_maps
from sihl_tpu_torch.heads.panoptic_segmentation import panoptic_fusion
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.utils import panoptic_quality

from test_torch_convblocks import randomize_all_norms, relative_l2
from torch_parity import flat_state, to_torch

BATCH, SIZE, STUFF, THINGS, T, IGNORE = 2, 64, 3, 4, 5, 255
HEAD_KW = dict(num_channels=16, num_layers=2, max_instances=8, max_targets=T, soft_label_decay_steps=10,
               ignore_index=IGNORE)
HEAD_GRAD_REL = 1e-3


def panoptic_maps(rng, size: int = SIZE, things: int = 4):
    """A semantic map (stuff in 8 x 8 blocks, some void) and an instance-id
    map (overlapping rectangles with ids 10, 20, ..., later ones on top)."""
    semantic = rng.randint(0, STUFF, (size // 8, size // 8)).repeat(8, 0).repeat(8, 1)
    semantic[rng.rand(*semantic.shape) < 0.05] = IGNORE
    id_map = np.zeros((size, size), np.int64)
    for t in range(things):
        y, x = rng.randint(0, size * 3 // 4, 2)
        h, w = rng.randint(size // 8, size // 3, 2)
        semantic[y : y + h, x : x + w] = STUFF + rng.randint(0, THINGS)
        id_map[y : y + h, x : x + w] = 10 * (t + 1)
    return semantic, id_map


def batch(seed: int):
    """(semantic (B, H, W), classes (B, T), masks (B, T, H, W)), the first
    image with no thing at all, the second with three in three quadrants:
    rectangles of even, unequal sides, whose boxes' centres sit on half
    pixels, so that no two anchors tie for a target's best IoU (the
    location targets are ``rel_iou == 1``; ``tests/test_torch_instance_segmentation.py``)."""
    rng = np.random.RandomState(seed)
    sems, classes, masks = [], [], []
    for b in range(BATCH):
        semantic, id_map = panoptic_maps(rng, things=0)
        for t in range(3 * b):
            hh, ww = 2 * rng.choice(np.arange(4, 9), 2, replace=False)
            y, x = (t // 2) * SIZE // 2 + rng.randint(0, 8), (t % 2) * SIZE // 2 + rng.randint(0, 8)
            semantic[y : y + hh, x : x + ww] = STUFF + rng.randint(0, THINGS)
            id_map[y : y + hh, x : x + ww] = t + 1
        c, m = panoptic_targets_from_maps(semantic, id_map, STUFF, T, ignore_index=IGNORE)
        sems.append(semantic)
        classes.append(c)
        masks.append(m)
    return np.stack(sems), np.stack(classes), np.stack(masks)


def pyramids(seed: int):
    levels = make_pyramid(batch_size=BATCH, height=SIZE, width=SIZE, rng=np.random.RandomState(seed))
    return [jnp.asarray(p) for p in levels], [to_torch(p) for p in levels]


def in_channels():
    return [p.shape[-1] for p in make_pyramid(batch_size=1)]


@pytest.fixture(scope="module")
def pair():
    """The JAX head (counter at 3, the loc bias midway between image 0's 3rd
    and 4th loc logits, so that some instances are live) and the port's in
    f32 and f64 with its weights and counter."""
    jax_head = JaxPanopticSegmentation(in_channels(), STUFF, THINGS, rngs=nnx.Rngs(0), **HEAD_KW)
    randomize_all_norms(jax_head, np.random.RandomState(1))
    jax_head.step_counter[...] = jnp.asarray(3, jnp.int32)
    jax_head.eval()
    jax_inputs, _ = pyramids(0)
    bias = jax_head.instance.loc_head.linears[-1].bias
    bias[...] = jnp.zeros((1,), jnp.float32)
    top = np.log(np.asarray(jax_head(jax_inputs)[3][0], np.float64))
    top -= np.log1p(-np.exp(top))
    bias[...] = jnp.full((1,), -(top[2] + top[3]) / 2, jnp.float32)
    heads = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            heads[dtype] = PanopticSegmentation(in_channels(), STUFF, THINGS, **HEAD_KW)
        heads[dtype].load_state_dict(state_dict_from_flat(flat_state(jax_head), heads[dtype]), strict=True)
    return jax_head, heads


# -- host-side helpers ---------------------------------------------------------


def test_targets_from_maps_match_jax():
    """Overlapping instances, void pixels, and more instances than targets."""
    rng = np.random.RandomState(2)
    for things, max_targets in ((4, T), (7, T), (0, T), (3, 8)):
        semantic, id_map = panoptic_maps(rng, things=things)
        got = panoptic_targets_from_maps(semantic, id_map, STUFF, max_targets, ignore_index=IGNORE)
        want = jax_targets_from_maps(semantic, id_map, STUFF, max_targets, ignore_index=IGNORE)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert (got[0] >= 0).sum() == 3


def test_panoptic_quality_is_a_copy():
    """The port's file holds the JAX file's code after its docstring, loads
    nothing of the JAX package, and gives the same numbers."""
    def body(module):
        text = open(module.__file__).read()
        return text[text.index("from typing"):]

    assert body(panoptic_quality) == body(jax_panoptic_quality)
    assert "sihl_tpu." not in body(panoptic_quality)
    rng = np.random.RandomState(3)
    got, want = panoptic_quality.PanopticQuality(STUFF, IGNORE), jax_panoptic_quality.PanopticQuality(STUFF, IGNORE)
    for _ in range(3):
        gt_sem, gt_ids = panoptic_maps(rng)
        pred_sem, pred_ids = gt_sem.copy(), gt_ids.copy()
        pred_sem[rng.rand(*pred_sem.shape) < 0.2] = rng.randint(0, STUFF + THINGS)
        pred_ids[:8] = 0
        for acc in (got, want):
            acc.update(pred_sem, pred_ids, gt_sem, gt_ids)
    result = got.compute()
    assert result == want.compute() and 0 < result["pq"] < 1


# -- the fusion and the smoothing ------------------------------------------------


def test_fusion_of_overlapping_instances_matches_jax_loop():
    """Hand-made instances through the JAX head's ``fori_loop`` (its
    sub-heads replaced by fixed outputs) and through ``panoptic_fusion``:
    overlapping masks of live instances (the first claim stays), a dead
    instance (score 0.3) over them, a score and mask probabilities of
    exactly 0.5 (not live, not claimed), and an image with no live instance."""
    rng = np.random.RandomState(4)
    i, h = 6, 8
    logits = rng.randn(BATCH, h, h, STUFF + THINGS).astype(np.float32)
    scores = np.array([[0.9, 0.8, 0.3, 0.7, 0.5, 0.6], [0.4, 0.3, 0.2, 0.1, 0.5, 0.0]], np.float32)
    inst_classes = rng.randint(0, THINGS, (BATCH, i))
    masks = np.zeros((BATCH, i, h, h), np.float32)
    for b in range(BATCH):
        for k in range(i):
            y, x = rng.randint(0, 5, 2)
            masks[b, k, y : y + 4, x : x + 4] = rng.choice([0.6, 0.9, 1.0])
    masks[0, 3, :, :2] = 0.5
    masks[0, 2] = 1.0
    masks[:, 4] = 1.0
    num = (scores > 0.5).sum(1)

    class FixedSemantic(nnx.Module):
        def get_logits(self, inputs):
            return jnp.asarray(logits)

    class FixedInstance(nnx.Module):
        def __call__(self, inputs):
            return jnp.asarray(num), jnp.asarray(scores), jnp.asarray(inst_classes), jnp.asarray(masks)

    jax_head = JaxPanopticSegmentation(in_channels(), STUFF, THINGS, rngs=nnx.Rngs(0), **HEAD_KW)
    jax_head.semantic, jax_head.instance = FixedSemantic(), FixedInstance()
    want_classes, want_ids = (np.asarray(w) for w in jax_head([])[:2])
    sem_classes = torch.from_numpy(logits).permute(0, 3, 1, 2).argmax(dim=1)
    class_map, id_map = panoptic_fusion(sem_classes, torch.from_numpy(scores), torch.from_numpy(inst_classes),
                                        torch.from_numpy(masks), STUFF)
    assert class_map.dtype == id_map.dtype == torch.int32
    np.testing.assert_array_equal(class_map.numpy(), want_classes)
    np.testing.assert_array_equal(id_map.numpy(), want_ids)
    assert {0, 1, 2} <= set(np.unique(want_ids[0])) and not want_ids[1].any()
    assert not (want_ids == 3).any() and not (want_ids == 5).any()


def test_label_smoothing_decays_on_the_counter():
    jax_head = JaxPanopticSegmentation(in_channels(), STUFF, THINGS, rngs=nnx.Rngs(0), **HEAD_KW)
    head = PanopticSegmentation(in_channels(), STUFF, THINGS, **HEAD_KW)
    for count in (0, 3, 10, 25):
        jax_head.step_counter[...] = jnp.asarray(count, jnp.int32)
        head.step_counter.fill_(count)
        got = head._label_smoothing()
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert float(got) == float(jax_head._label_smoothing())
    still = PanopticSegmentation(in_channels(), STUFF, THINGS, **{**HEAD_KW, "soft_label_decay_steps": 0})
    assert still._label_smoothing() == 0.0 and not isinstance(still._label_smoothing(), torch.Tensor)


def test_counter_crosses_from_jax():
    jax_head = JaxPanopticSegmentation(in_channels(), STUFF, THINGS, rngs=nnx.Rngs(0), **HEAD_KW)
    jax_head.step_counter[...] = jnp.asarray(7, jnp.int32)
    state = state_dict_from_flat(flat_state(jax_head))
    assert state["step_counter"].dtype == torch.int32
    head = PanopticSegmentation(in_channels(), STUFF, THINGS, **HEAD_KW)
    head.load_state_dict(state, strict=True)
    assert head.step_counter.dtype == torch.int32 and int(head.step_counter) == 7
    del state["step_counter"]
    with pytest.raises(RuntimeError, match="step_counter"):
        head.load_state_dict(state, strict=True)


# -- the head --------------------------------------------------------------------


def test_forward_matches_jax(pair):
    jax_head, heads = pair
    jax_inputs, inputs = pyramids(0)
    want = [np.asarray(w) for w in jax_head(jax_inputs)]
    with torch.no_grad():
        got = heads[torch.float32].eval()(inputs)
    head = heads[torch.float32]
    assert head.output_shapes == jax_head.output_shapes
    sizes = {"batch_size": BATCH, "height/8": SIZE // 8, "width/8": SIZE // 8}
    for (name, shape), g, w in zip(head.output_shapes.items(), got, want):
        assert tuple(g.shape) == tuple(sizes.get(d, d) for d in shape), name
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert 0 < int(want[2].sum()) and (want[1] > 0).any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_training_step_matches_jax(pair, dtype):
    """Loss and metrics, every gradient, the running statistics and the
    counter after one step from 3 (smoothing 0.07, the tensor path)."""
    jax_head, heads = pair
    jax_head = nnx.clone(jax_head)
    jax_head.train()
    jax_inputs, inputs = pyramids(5)
    targets = batch(5)

    @nnx.jit
    def value_and_grad(h, xs, ts):
        return nnx.value_and_grad(lambda hh: hh.training_step(xs, *ts), has_aux=True)(h)

    (want_loss, want_metrics), grads = value_and_grad(jax_head, jax_inputs, tuple(jnp.asarray(t) for t in targets))
    head = copy.deepcopy(heads[dtype]).train()
    loss, metrics = head.training_step([x.to(dtype) for x in inputs], *(torch.from_numpy(t) for t in targets))
    loss.backward()
    assert int(jax_head.step_counter[...]) == int(head.step_counter) == 4
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    assert sorted(metrics) == sorted(want_metrics)
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(float(want_metrics[k]), rel=1e-5, abs=1e-7), k
    want_grads = state_dict_from_flat({".".join(map(str, p)): np.asarray(v[...])
                                       for p, v in nnx.to_flat_state(grads)}, head)
    for name, p in head.named_parameters():
        err = relative_l2(p.grad.numpy(), want_grads[name].numpy())
        assert err <= HEAD_GRAD_REL, (name, err)
    want_state = state_dict_from_flat(flat_state(jax_head), head)
    for name, b in head.named_buffers():
        np.testing.assert_allclose(b.double().numpy(), want_state[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_validation_matches_jax(pair):
    """Two ``validation_step``s (the counter back where it was after each),
    their aux, and ``validation_end``'s PQ and mean IoU."""
    jax_head, heads = pair
    jax_head = nnx.clone(jax_head)
    head = heads[torch.float32].eval()
    jax_state, state = jax_head.metrics_init(), head.metrics_init()
    collected, jax_collected = [], []
    for seed in (6, 7):
        jax_inputs, inputs = pyramids(seed)
        targets = batch(seed)
        jax_state, want_loss, want_aux = jax_head.validation_step(jax_state, jax_inputs,
                                                                  *(jnp.asarray(t) for t in targets))
        with torch.no_grad():
            state, loss, aux = head.validation_step(state, inputs, *(torch.from_numpy(t) for t in targets))
        assert int(head.step_counter) == int(jax_head.step_counter[...]) == 3
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
        assert sorted(aux) == sorted(want_aux)
        for k, v in aux.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(want_aux[k]), err_msg=k)
        collected.append({k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in aux.items()})
        jax_collected.append({k: np.asarray(v) if hasattr(v, "shape") else v for k, v in want_aux.items()})
    want = jax_head.validation_end(jax_state, jax_collected)
    got = head.validation_end(state, collected)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
