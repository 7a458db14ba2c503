"""Parity of the port's dense heads with the JAX package's (CPU):
``cross_entropy`` with a tensor label smoothing, ``SPPM``, ``UAFM``,
``SemanticSegmentation`` and ``DepthEstimation``, each head's forward,
``training_step`` and validation triple.

Heads at the size of ``tests/heads``: a synthetic pyramid of 4 images at
64 px (level 5 is 2 x 2), 16 channels, weights carried by
``state_dict_from_flat``, every norm with random affine parameters and
running statistics (4 images: a train-mode BatchNorm over
the 2 samples of SPPM's 1 x 1 pooling of 2 images loses digits in JAX's f32
step, 6.9e-4 from f64 on one conv).  Tolerances: forwards and losses within 1e-5 relative
(class maps exact); gradients within relative L2 1e-3 of JAX's f32 step
(the heads' limit of the slice tests), from the port in f64 and in f32,
and the port's f32 within 1e-3 of its f64; SPPM's and UAFM's gradients
within 1e-4, a single block's limit; validation metrics within 1e-5
relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.heads import DepthEstimation as JaxDepthEstimation
from sihl_tpu.heads import SemanticSegmentation as JaxSemanticSegmentation
from sihl_tpu.heads.semantic_segmentation import SPPM as JaxSPPM
from sihl_tpu.heads.semantic_segmentation import UAFM as JaxUAFM
from sihl_tpu.ops.losses import cross_entropy as jax_cross_entropy
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import SPPM, UAFM, DepthEstimation, SemanticSegmentation
from sihl_tpu_torch.ops.losses import cross_entropy
from sihl_tpu_torch.policy import compute_dtype_scope

from test_torch_convblocks import assert_block_matches, assert_forward_close, load, randomize_all_norms, relative_l2
from torch_parity import flat_state, to_numpy, to_torch

BATCH, NUM_CLASSES, IGNORE = 4, 5, 255
HEAD_GRAD_REL = 1e-3
BLOCK_GRAD_REL = 1e-4


def pyramids(seed: int = 0, height: int = 64, width: int = 64):
    levels = make_pyramid(batch_size=BATCH, height=height, width=width, rng=np.random.RandomState(seed))
    return [jnp.asarray(p) for p in levels], [to_torch(p) for p in levels]


def in_channels():
    return [p.shape[-1] for p in make_pyramid(batch_size=1)]


def head_pair(kind: str, **kwargs):
    """The JAX head with random norms, and the port's in f32 and f64 with its weights."""
    if kind == "semantic":
        jax_head = JaxSemanticSegmentation(in_channels(), NUM_CLASSES, num_channels=16, ignore_index=IGNORE,
                                           rngs=nnx.Rngs(0), **kwargs)
        build = lambda: SemanticSegmentation(in_channels(), NUM_CLASSES, num_channels=16,  # noqa: E731
                                             ignore_index=IGNORE, **kwargs)
    else:
        jax_head = JaxDepthEstimation(in_channels(), 0.1, 10.0, num_channels=16, num_bins=8, rngs=nnx.Rngs(0),
                                      **kwargs)
        build = lambda: DepthEstimation(in_channels(), 0.1, 10.0, num_channels=16, num_bins=8, **kwargs)  # noqa: E731
    randomize_all_norms(jax_head, np.random.RandomState(1))
    heads = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            heads[dtype] = load(build(), jax_head)
    return jax_head, heads


def semantic_targets(seed: int, height: int = 64, width: int = 64):
    """(B, H, W) classes in blocks of 4 x 4 pixels, a tenth of them void."""
    rng = np.random.RandomState(seed)
    blocks = rng.randint(0, NUM_CLASSES, (BATCH, height // 4, width // 4))
    blocks[rng.rand(*blocks.shape) < 0.1] = IGNORE
    return blocks.repeat(4, axis=1).repeat(4, axis=2)


def depth_targets(seed: int, height: int = 64, width: int = 64, out_of_bounds: bool = False):
    """Depths in [0.1, 10] and a validity mask with about 10% invalid
    pixels, which hold 0 (NYU style); ``out_of_bounds`` puts some valid
    depths below 0.1 and above 10."""
    rng = np.random.RandomState(seed)
    depth = (rng.rand(BATCH, height, width) * 9.9 + 0.1).astype(np.float32)
    masks = rng.rand(BATCH, height, width) > 0.1
    if out_of_bounds:
        depth[rng.rand(*depth.shape) < 0.05] = 0.02
        depth[rng.rand(*depth.shape) < 0.05] = 14.0
    depth[~masks] = 0.0
    return depth, masks


def jax_step(jax_head, inputs, *targets):
    """JAX's f32 loss, metrics, gradients and state after the step, jitted."""
    jax_head = nnx.clone(jax_head)
    jax_head.train()

    @nnx.jit
    def value_and_grad(h, xs, ts):
        return nnx.value_and_grad(lambda hh: hh.training_step(xs, *ts), has_aux=True)(h)

    (loss, metrics), grads = value_and_grad(jax_head, inputs, tuple(jnp.asarray(t) for t in targets))
    flat = {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads)}
    return float(loss), {k: float(v) for k, v in metrics.items()}, flat, flat_state(jax_head)


def port_step(head, inputs, *targets):
    head = copy.deepcopy(head).train()
    loss, metrics = head.training_step(inputs, *(torch.from_numpy(np.asarray(t)) for t in targets))
    loss.backward()
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, head


def assert_steps_match(jax_head, heads, jax_inputs, inputs, *targets):
    want_loss, want_metrics, flat, jax_state = jax_step(jax_head, jax_inputs, *targets)
    grads = {}
    for dtype, head in heads.items():
        loss, metrics, stepped = port_step(head, [x.to(dtype) for x in inputs], *targets)
        want_grads = state_dict_from_flat(flat, stepped)
        assert np.isfinite(loss) and loss == pytest.approx(want_loss, rel=1e-5), dtype
        assert sorted(metrics) == sorted(want_metrics)
        for k, v in metrics.items():
            assert v == pytest.approx(want_metrics[k], rel=1e-5, abs=1e-7), (dtype, k)
        grads[dtype] = {n: p.grad for n, p in stepped.named_parameters()}
        assert sorted(grads[dtype]) == sorted(want_grads)
        for name, g in grads[dtype].items():
            err = relative_l2(g.numpy(), want_grads[name].numpy())
            assert err <= HEAD_GRAD_REL, (dtype, name, err)
        jax_stats = state_dict_from_flat(jax_state, stepped)
        for name, b in stepped.named_buffers():
            np.testing.assert_allclose(b.double().numpy(), jax_stats[name].numpy(), rtol=1e-5, atol=1e-7)
    if len(grads) == 2:
        for name, g in grads[torch.float32].items():
            assert relative_l2(g.numpy(), grads[torch.float64][name].numpy()) <= HEAD_GRAD_REL, name


# -- cross-entropy's smoothing -------------------------------------------------


def test_cross_entropy_tensor_smoothing_takes_the_blend():
    """A tensor smoothing, also a zero one, takes the blend as JAX's traced
    smoothing does; a float keeps the old path, bit for bit."""
    rng = np.random.RandomState(0)
    logits = rng.randn(3, NUM_CLASSES, 4, 5).astype(np.float32)
    targets = rng.randint(0, NUM_CLASSES, (3, 4, 5))
    targets[0, 0, :2] = IGNORE
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    jl, jt = jnp.asarray(logits), jnp.asarray(targets)
    for smoothing in (0.0, 0.1, 0.0375):
        want = jax.jit(lambda x, t, s: jax_cross_entropy(x, t, label_smoothing=s, ignore_index=IGNORE, axis=1))(
            jl, jt, jnp.float32(smoothing))
        got = cross_entropy(lt, tt, label_smoothing=torch.tensor(smoothing), ignore_index=IGNORE, dim=1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        # a 0-d tensor always blends: at 0 the blend is exact, so the value equals the float path's
        float_path = cross_entropy(lt, tt, label_smoothing=smoothing, ignore_index=IGNORE, dim=1)
        np.testing.assert_allclose(got.numpy(), float_path.numpy(), rtol=1e-6, atol=1e-7)


def test_cross_entropy_float_path_unchanged():
    """The float path, bit for bit the formula it had: the blend skipped at a
    Python 0 and taken otherwise."""
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(6, NUM_CLASSES).astype(np.float32))
    targets = torch.from_numpy(rng.randint(0, NUM_CLASSES, 6))
    log_probs = torch.log_softmax(logits, dim=-1)
    one_hot = torch.nn.functional.one_hot(targets, NUM_CLASSES).float()
    assert torch.equal(cross_entropy(logits, targets), -(one_hot * log_probs).sum(dim=-1))
    smoothed = one_hot * (1.0 - 0.1) + 0.1 / NUM_CLASSES
    assert torch.equal(cross_entropy(logits, targets, label_smoothing=0.1), -(smoothed * log_probs).sum(dim=-1))
    assert torch.equal(cross_entropy(logits, targets, label_smoothing=0), cross_entropy(logits, targets))


# -- SPPM and UAFM -------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("hw", [(20, 20), (3, 5), (2, 2)], ids=["20x20", "3x5", "2x2"])
def test_sppm(hw, train):
    """Shrinks to 1, 2 and 4 (antialiased), growths back, and the identity
    branch at 2 x 2; the forward, and in training the gradients of the input
    and of every parameter."""
    jax_block = JaxSPPM(8, 12, (1, 2, 4), rngs=nnx.Rngs(0))
    randomize_all_norms(jax_block, np.random.RandomState(2))
    block = load(SPPM(8, 12, (1, 2, 4)), jax_block)
    x = np.random.RandomState(3).randn(4, *hw, 8).astype(np.float32)
    assert_block_matches(jax_block, block, x, train=train)


def test_sppm_with_shortcut():
    jax_block = JaxSPPM(8, 12, (1, 3), with_shortcut=True, rngs=nnx.Rngs(0))
    randomize_all_norms(jax_block, np.random.RandomState(4))
    block = load(SPPM(8, 12, (1, 3), with_shortcut=True), jax_block)
    assert_block_matches(jax_block, block, np.random.RandomState(5).randn(4, 6, 7, 8).astype(np.float32), train=True)


def test_uafm_with_tied_channel_maxima():
    """The fused output and the gradients of both inputs and of the attention
    conv; x1 ties its channel maximum between two channels at every pixel
    of one row, and x2 between three channels at one pixel, where ``amax``
    must split the gradient as ``jnp.max`` does."""
    rng = np.random.RandomState(6)
    jax_block = JaxUAFM(8, 8, rngs=nnx.Rngs(0))
    block = load(UAFM(8, 8), jax_block)
    x1 = rng.randn(2, 5, 6, 8).astype(np.float32)
    x2 = rng.randn(2, 5, 6, 8).astype(np.float32)
    x1[:, 2, :, 3] = x1[:, 2, :, 5] = np.abs(x1).max() + 1.0
    x2[1, 0, 0, [0, 4, 7]] = np.abs(x2).max() + 1.0
    w = rng.randn(2, 5, 6, 8).astype(np.float32)

    def jax_loss(m, a, b):
        return jnp.sum(m(a, b) * jnp.asarray(w))

    grad_fn = nnx.jit(nnx.value_and_grad(jax_loss, argnums=(0, 1, 2)))
    want, (grads, want_dx1, want_dx2) = grad_fn(jax_block, jnp.asarray(x1), jnp.asarray(x2))
    t1, t2 = to_torch(x1).requires_grad_(True), to_torch(x2).requires_grad_(True)
    out = block(t1, t2)
    loss = (out * to_torch(w)).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert_forward_close(to_numpy(out, nhwc=True), jax_block(jnp.asarray(x1), jnp.asarray(x2)))
    assert relative_l2(to_numpy(t1.grad, nhwc=True), want_dx1) <= BLOCK_GRAD_REL
    assert relative_l2(to_numpy(t2.grad, nhwc=True), want_dx2) <= BLOCK_GRAD_REL
    want_grads = state_dict_from_flat({".".join(map(str, p)): np.asarray(v[...])
                                       for p, v in nnx.to_flat_state(grads)}, block)
    for name, p in block.named_parameters():
        assert relative_l2(p.grad.numpy(), want_grads[name].numpy()) <= BLOCK_GRAD_REL, name


# -- the heads -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["semantic", "depth"])
def test_forward(kind):
    jax_head, heads = head_pair(kind)
    jax_inputs, inputs = pyramids()
    jax_head.eval()
    want = jax_head(jax_inputs)
    with torch.no_grad():
        got = heads[torch.float32].eval()(inputs)
    assert heads[torch.float32].output_shapes == jax_head.output_shapes
    if kind == "semantic":
        scores, classes = got
        assert scores.shape == classes.shape == (BATCH, 64, 64) and scores.dtype == torch.float32
        assert_forward_close(scores.numpy(), want[0])
        np.testing.assert_array_equal(classes.numpy(), np.asarray(want[1]))
    else:
        assert got.shape == (BATCH, 64, 64) and got.dtype == torch.float32
        assert_forward_close(got.numpy(), want)
        assert ((got >= 0.1) & (got <= 10.0)).all()


def test_semantic_training_step():
    jax_head, heads = head_pair("semantic")
    jax_inputs, inputs = pyramids(3)
    assert_steps_match(jax_head, heads, jax_inputs, inputs, semantic_targets(3))


def test_depth_training_step():
    jax_head, heads = head_pair("depth", num_layers=2)
    jax_inputs, inputs = pyramids(4)
    assert_steps_match(jax_head, heads, jax_inputs, inputs, *depth_targets(4))


def test_depth_masked_invalid_pixels_no_nan():
    """JAX's ``test_depth_masked_invalid_pixels_no_nan`` case on a non-square
    48 x 64 batch (levels 2-4): invalid pixels holding 0 and valid depths
    out of [0.1, 10] give a finite loss, equal to JAX's, and the same
    gradients."""
    kw = dict(bottom_level=2, top_level=4)
    jax_head, heads = head_pair("depth", **kw)
    jax_inputs, inputs = pyramids(5, height=48, width=64)
    depth, masks = depth_targets(5, 48, 64, out_of_bounds=True)
    assert (depth == 0).any() and ((depth > 10) & masks).any() and ((depth < 0.1) & masks).any()
    assert_steps_match(jax_head, heads, jax_inputs, inputs, depth, masks)


def test_depth_clip_at_one_splits_the_gradient():
    """A depth map that rounds to 1 exactly: the first bin wide, the others
    narrow (their centres round to 1), every pixel's weight on the last bin
    but for a sliver on the first (a logit of 1e-5, which the ReLU passes),
    whose gradient is the one the clip scales.  ``jnp.clip`` sends half the
    gradient through at the bound, and so must the port (``torch.clamp``
    would send all of it and miss the first bin's logit gradient by 2x)."""
    jax_head, heads = head_pair("depth")
    bias = np.full((8,), 0.0, np.float32)
    bias[0] = 1e4
    jax_head.bin_conv_out.kernel[...] = jnp.zeros_like(jax_head.bin_conv_out.kernel[...])
    jax_head.bin_conv_out.bias[...] = jnp.asarray(bias)
    logit_bias = np.full((8,), -50.0, np.float32)
    logit_bias[0], logit_bias[-1] = 1e-5, 1e4
    jax_head.logit_conv.kernel[...] = jnp.zeros_like(jax_head.logit_conv.kernel[...])
    jax_head.logit_conv.bias[...] = jnp.asarray(logit_bias)
    for dtype in heads:
        load(heads[dtype], jax_head)
    jax_inputs, inputs = pyramids(6)
    jax_head.eval()
    centers = jax_head.get_bin_centers(jax_inputs)
    assert float(jax_head.get_depth_map(jax_inputs, centers).min()) == 1.0
    head = heads[torch.float32]
    with torch.no_grad():
        assert float(head.eval().get_depth_map(inputs, head.get_bin_centers(inputs)).min()) == 1.0
    # the widths' and most logits' gradients are rounding noise here (saturated
    # normalisations); the logit conv's carry the clip's factor
    want_loss, _, flat, _ = jax_step(jax_head, jax_inputs, *depth_targets(6))
    loss, _, stepped = port_step(head, inputs, *depth_targets(6))
    assert loss == pytest.approx(want_loss, rel=1e-5)
    want_grads = state_dict_from_flat(flat, stepped)
    for name in ("logit_conv.weight", "logit_conv.bias"):
        got = dict(stepped.named_parameters())[name].grad
        assert float(got.abs().max()) > 1e-6, name
        assert relative_l2(got.numpy(), want_grads[name].numpy()) <= HEAD_GRAD_REL, name


@pytest.mark.parametrize("kind", ["semantic", "depth"])
def test_validation(kind):
    """``metrics_init``, two ``validation_step``s and ``validation_end`` in eval mode."""
    jax_head, heads = head_pair(kind)
    head = heads[torch.float32].eval()
    jax_head.eval()
    jax_state, state = jax_head.metrics_init(), head.metrics_init()
    for seed in (7, 8):
        jax_inputs, inputs = pyramids(seed)
        targets = (semantic_targets(seed),) if kind == "semantic" else depth_targets(seed)
        jax_state, want_loss, want_aux = jax_head.validation_step(jax_state, jax_inputs,
                                                                  *(jnp.asarray(t) for t in targets))
        with torch.no_grad():
            state, loss, aux = head.validation_step(state, inputs, *(torch.from_numpy(t) for t in targets))
        assert aux == {} == want_aux
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    want = jax_head.validation_end(jax_state)
    got = head.validation_end(state)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


def test_head_refusals():
    with pytest.raises(ValueError, match="levels"):
        SemanticSegmentation([3, 8, 16], NUM_CLASSES)
    with pytest.raises(ValueError, match="> 0"):
        SemanticSegmentation(in_channels(), 0)
    with pytest.raises(ValueError, match="below"):
        DepthEstimation(in_channels(), 1.0, 1.0)
    with pytest.raises(ValueError, match="num_bins"):
        DepthEstimation(in_channels(), 0.1, 1.0, num_bins=1)
