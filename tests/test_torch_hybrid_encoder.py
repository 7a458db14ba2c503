"""Parity of the port's HybridEncoder neck (``layers/hybrid_encoder.py``:
``RepVGGBlock``, ``CSPRepLayer``, ``HybridEncoder``) with the JAX
package's, on the CPU.

Weights cross through ``state_dict_from_flat``; every BatchNorm and
LayerNorm gets random affine parameters and running statistics.  Compared:
in eval mode the f32 forward within 1e-5 relative (``assert_forward_close``);
in training mode each output map of the port's f32 forward and of JAX's
within 1e-4 of the map's largest magnitude from the port's f64 forward (a
train-mode BatchNorm over four 1 x 1 samples keeps fewer f32 digits: JAX's
f32 map reads 3.8e-5 from f64 there, the port's 1.1e-5), the running
statistics after the forward within 1e-4, and the gradients of ``sum(out * w)`` for a random
``w``, of the inputs and of every parameter, from the port's f64 step and
from its f32 step, each against JAX's jitted f32 step within relative L2
1e-3, the neck's limit of the slice tests (train-mode BatchNorm at 1 x 1 to
4 x 4 maps costs f32 digits; a single block keeps 1e-4).

The pyramids are ``make_pyramid``'s, each image with its own contrast and
brightness: levels 0-5 of a 64 px image (levels 3-5 are 8, 4 and 2 pixels
wide), and of a 128 px image for ``top_level`` 7, past the backbone's top,
where two extra downscalers make levels 6 and 7 (2 x 2 and 1 x 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.layers.hybrid_encoder import CSPRepLayer as JaxCSPRepLayer
from sihl_tpu.layers.hybrid_encoder import HybridEncoder as JaxHybridEncoder
from sihl_tpu.layers.hybrid_encoder import RepVGGBlock as JaxRepVGGBlock
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.layers import CSPRepLayer, HybridEncoder, RepVGGBlock
from sihl_tpu_torch.policy import compute_dtype_scope

from test_torch_convblocks import assert_forward_close, relative_l2
from torch_parity import flat_state, randomize_norms, to_numpy, to_torch

GRAD_LIMIT = 1e-3
CHANNELS = (3, 8, 16, 24, 32, 40)


def _flat(outputs):
    return list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]


def assert_module_matches(jax_module, build, arrays, train: bool, seed: int = 0, skip_outputs: int = 0):
    """``build()`` makes the port's module in the current compute dtype; its
    weights come from ``jax_module``.  ``arrays`` are NHWC inputs, passed as
    one list (``as_list``) or as positional arguments.  ``skip_outputs``
    leading outputs are the pyramid's passed-through levels, left out of the
    loss."""
    as_list = isinstance(arrays, list) and len(arrays) > 2
    jax_in = [jnp.asarray(a) for a in arrays]

    def call(m, xs):
        return _flat(m(xs) if as_list else m(*xs))[skip_outputs:]

    if not train:
        jax_module.eval()
        module = build()
        module.load_state_dict(state_dict_from_flat(flat_state(jax_module), module), strict=True)
        want = nnx.jit(call)(jax_module, jax_in)
        with torch.no_grad():
            got = call(module.eval(), [to_torch(a) for a in arrays])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.is_contiguous(memory_format=torch.channels_last) or g.shape[2:] == (1, 1)
            assert_forward_close(to_numpy(g, nhwc=True), w)
        return

    state = flat_state(jax_module)
    jax_module.train()
    rng = np.random.RandomState(seed)
    shapes = [o.shape for o in jax.eval_shape(lambda xs: call(nnx.clone(jax_module), xs), jax_in)]
    weights = [jnp.asarray(rng.randn(*shape).astype(np.float32)) for shape in shapes]

    def jax_loss(m, xs):
        outs = call(m, xs)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)), outs

    grad_fn = nnx.jit(nnx.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))
    (_, want), (grads, want_dx) = grad_fn(jax_module, jax_in)
    jax_stats = flat_state(jax_module)
    for dtype in (torch.float64, torch.float32):
        with compute_dtype_scope(dtype):
            module = build()
        module.load_state_dict(state_dict_from_flat(state, module), strict=True)
        want_grads = state_dict_from_flat(
            {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads)}, module)
        xs = [to_torch(a).to(dtype).requires_grad_(True) for a in arrays]
        got = call(module.train(), xs)
        sum((g * to_torch(np.asarray(w)).to(dtype)).sum() for g, w in zip(got, weights)).backward()
        if dtype == torch.float64:
            ref = [g.detach().permute(0, 2, 3, 1).numpy() for g in got]
        else:  # both f32 forwards against the f64 one, each map within 1e-4 of its largest
            for g, w, r in zip(got, want, ref):
                scale = np.abs(r).max()
                for side in (to_numpy(g, nhwc=True), np.asarray(w)):
                    np.testing.assert_allclose(side, r, rtol=0, atol=1e-4 * scale)
        for x, dx in zip(xs, want_dx):
            if x.grad is None:  # a passed-through level
                assert not np.asarray(dx).any()
                continue
            assert relative_l2(to_numpy(x.grad, nhwc=True), dx) <= GRAD_LIMIT, dtype
        params = dict(module.named_parameters())
        assert sorted(params) == sorted(want_grads)
        largest = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
        if dtype == torch.float64:
            # zero in exact arithmetic (f64 rounding): a map that feeds only
            # convs into train-mode BatchNorms, whose mean removal cancels a
            # constant shift (the lower input projections' biases); both
            # f32 sides hold noise there, held against the largest gradient
            zeros = {n for n, p in params.items() if float(p.grad.norm()) <= 1e-9 * largest}
        for name, p in params.items():
            if name in zeros:
                assert max(float(p.grad.norm()), float(want_grads[name].norm())) <= 1e-5 * largest, name
                continue
            err = relative_l2(p.grad.numpy(), want_grads[name].numpy())
            assert err <= GRAD_LIMIT, (dtype, name, err)
        want_stats = state_dict_from_flat(jax_stats, module)
        for name, b in module.named_buffers():
            np.testing.assert_allclose(b.double().numpy(), want_stats[name].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)


def _randomized(module, seed: int):
    randomize_norms(module, np.random.RandomState(seed))
    return module


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_repvgg_block(train):
    x = np.random.RandomState(1).randn(4, 6, 6, 16).astype(np.float32)
    jax_block = _randomized(JaxRepVGGBlock(16, rngs=nnx.Rngs(1)), 1)
    assert_module_matches(jax_block, lambda: RepVGGBlock(16), [x], train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_csp_rep_layer(train):
    """Two maps of different contents: their concatenation's order shows."""
    rng = np.random.RandomState(2)
    x1 = rng.randn(4, 6, 6, 12).astype(np.float32)
    x2 = (rng.rand(4, 6, 6, 12) * 3).astype(np.float32)
    jax_layer = _randomized(JaxCSPRepLayer(24, 16, rngs=nnx.Rngs(2)), 2)
    assert_module_matches(jax_layer, lambda: CSPRepLayer(24, 16), [x1, x2], train)
    if not train:  # the swapped order runs, and gives another result
        jax_layer.eval()
        layer = CSPRepLayer(24, 16)
        layer.load_state_dict(state_dict_from_flat(flat_state(jax_layer), layer), strict=True)
        with torch.no_grad():
            swapped = to_numpy(layer.eval()(to_torch(x2), to_torch(x1)), nhwc=True)
        assert np.abs(swapped - np.asarray(jax_layer(jnp.asarray(x1), jnp.asarray(x2)))).max() > 1e-2


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("size,top_level,width", [(64, 5, 32), (128, 7, 16)], ids=["levels3-5", "levels3-7"])
def test_hybrid_encoder(size, top_level, width, train):
    rng = np.random.RandomState(size + top_level)
    # each image its own contrast and brightness on every level: i.i.d. noise
    # averages to nearly equal samples at 1 x 1, where a train-mode
    # BatchNorm's f32 fast variance would cancel (tests/test_torch_dense_slice.py)
    gain, shift = rng.uniform(0.25, 1.0, (4, 1, 1, 1)), rng.uniform(0.0, 0.75, (4, 1, 1, 1))
    pyramid = [(p * gain + shift).astype(np.float32)
               for p in make_pyramid(batch_size=4, height=size, width=size, channels=CHANNELS, rng=rng)]
    jax_neck = _randomized(JaxHybridEncoder(list(CHANNELS), width, bottom_level=3, top_level=top_level,
                                            rngs=nnx.Rngs(3)), 3)
    neck = HybridEncoder(list(CHANNELS), width, bottom_level=3, top_level=top_level)
    assert neck.out_channels == jax_neck.out_channels
    assert len(neck.extra_downscalers) == len(jax_neck.extra_downscalers) == top_level - len(CHANNELS) + 1 if \
        top_level >= len(CHANNELS) else len(neck.extra_downscalers) == 0
    assert_module_matches(jax_neck, lambda: HybridEncoder(list(CHANNELS), width, bottom_level=3, top_level=top_level),
                          pyramid, train, skip_outputs=3)
    if not train:  # the passed-through levels are the inputs themselves
        pyramid_t = [to_torch(p) for p in pyramid]
        with torch.no_grad():
            outs = neck.eval()(pyramid_t)
        assert len(outs) == top_level + 1 and all(outs[i] is pyramid_t[i] for i in range(3))
