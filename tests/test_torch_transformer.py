"""Parity of the port's position embeddings (``ops/embeddings.py``) and
transformer layers (``layers/transformer.py``) with the JAX package's, f32
on the CPU.

Weights cross through ``state_dict_from_flat`` with the port's module (the
attention kernels are rank 3); every LayerNorm gets random affine
parameters.  Tolerances: the embeddings within 1e-6; forwards within 1e-5
relative (``assert_forward_close``); gradients of the inputs and of every
parameter within relative L2 1e-4 of JAX's jitted f32 gradients (a single
layer in f32 keeps that many digits, as ``tests/test_torch_convblocks.py``
holds its blocks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from sihl_tpu.layers.transformer import TransformerDecoderLayer as JaxDecoderLayer
from sihl_tpu.layers.transformer import TransformerEncoderLayer as JaxEncoderLayer
from sihl_tpu.layers.transformer import _mha as jax_mha
from sihl_tpu.ops import embeddings as jax_embeddings
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.layers import TransformerDecoderLayer, TransformerEncoderLayer
from sihl_tpu_torch.layers.convblocks import _ACTS
from sihl_tpu_torch.layers.transformer import MultiHeadAttention
from sihl_tpu_torch.ops import embeddings

from test_torch_convblocks import GRAD_REL, assert_forward_close, load, relative_l2
from torch_parity import randomize_norms

DIM, HEADS = 32, 4


# -- embeddings ------------------------------------------------------------------


@pytest.mark.parametrize("height,width", [(1, 1), (5, 7), (20, 20)])
def test_coordinate_grid(height, width):
    got = embeddings.coordinate_grid(height, width)
    want = np.asarray(jax_embeddings.coordinate_grid(height, width))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (height, width, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_sine_embeddings():
    pos = np.random.RandomState(0).rand(3, 5).astype(np.float32) * 40
    got = embeddings.sine_embedding_1d(torch.from_numpy(pos), 16, temperature=100.0)
    want = np.asarray(jax_embeddings.sine_embedding_1d(jnp.asarray(pos), 16, temperature=100.0))
    assert tuple(got.shape) == want.shape == (3, 5, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # a scalar position becomes a (1, dim) row, as jnp.atleast_1d makes it
    np.testing.assert_allclose(embeddings.sine_embedding_1d(3.0, 8).numpy(),
                               np.asarray(jax_embeddings.sine_embedding_1d(3.0, 8)), rtol=0, atol=1e-6)
    ys, xs = pos[0], pos[1]
    got = embeddings.sine_embedding_2d(torch.from_numpy(ys), torch.from_numpy(xs), 24)
    want = np.asarray(jax_embeddings.sine_embedding_2d(jnp.asarray(ys), jnp.asarray(xs), 24))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for h, w, dim in ((4, 6, 32), (20, 20, 256)):
        got = embeddings.sine_embedding_2d_grid(h, w, dim)
        want = np.asarray(jax_embeddings.sine_embedding_2d_grid(h, w, dim))
        assert tuple(got.shape) == want.shape == (h, w, dim)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_embedding_dims_are_checked():
    with pytest.raises(ValueError, match="even"):
        embeddings.sine_embedding_1d(torch.zeros(3), 7)
    with pytest.raises(ValueError, match="divisible by 4"):
        embeddings.sine_embedding_2d(torch.zeros(3), torch.zeros(3), 10)


# -- attention and layers ---------------------------------------------------------


def _inputs(seed: int, *lengths):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, n, DIM).astype(np.float32) for n in lengths]


def assert_layer_matches(jax_layer, layer, arrays, seed: int = 0) -> None:
    """Forward of the (B, L, DIM) ``arrays`` and the gradients of
    ``sum(out * w)`` for a random ``w``, of every input and every parameter,
    against JAX's jitted f32 step."""
    jax_layer.eval()
    layer.eval()
    jax_arrays = [jnp.asarray(a) for a in arrays]
    w = np.random.RandomState(seed).randn(*arrays[0].shape).astype(np.float32)

    def jax_loss(m, *xs):
        out = m(*xs)
        return jnp.sum(out * jnp.asarray(w)), out

    argnums = tuple(range(len(arrays) + 1))
    (_, want), grads = nnx.jit(nnx.value_and_grad(jax_loss, argnums=argnums, has_aux=True))(jax_layer, *jax_arrays)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = layer(*xs)
    (got * torch.from_numpy(w)).sum().backward()
    assert_forward_close(got.detach().numpy(), want)
    for x, want_dx in zip(xs, grads[1:]):
        assert relative_l2(x.grad.numpy(), want_dx) <= GRAD_REL
    want_grads = state_dict_from_flat(
        {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads[0])}, layer)
    params = dict(layer.named_parameters())
    assert sorted(params) == sorted(want_grads)
    # the key projection's bias adds the same q.b to every logit of a query,
    # which the softmax removes: its gradient is zero in exact arithmetic and
    # both sides hold rounding noise there, held against the largest gradient
    largest = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
    for name, p in params.items():
        if name.endswith("key.bias"):
            assert float(np.linalg.norm(want_grads[name].numpy())) <= 1e-6 * largest
            assert float(np.linalg.norm(p.grad.numpy())) <= 1e-6 * largest, name
            continue
        err = relative_l2(p.grad.numpy(), want_grads[name].numpy())
        assert err <= GRAD_REL, (name, err)


@pytest.mark.parametrize("lengths", [(6,), (5, 9)], ids=["self", "cross"])
def test_multi_head_attention(lengths):
    jax_attn = jax_mha(DIM, HEADS, nnx.Rngs(0))
    attn = load(MultiHeadAttention(DIM, HEADS, generator=torch.Generator().manual_seed(0)), jax_attn)
    arrays = _inputs(1, *lengths)
    if len(arrays) == 1:  # self-attention: the same tensor as queries and keys
        jax_attn.eval()
        x = arrays[0]
        want = np.asarray(jax_attn(jnp.asarray(x), jnp.asarray(x)))
        with torch.no_grad():
            got = attn(torch.from_numpy(x), torch.from_numpy(x))
        assert_forward_close(got.numpy(), want)
        arrays = arrays * 2
    assert_layer_matches(jax_attn, attn, arrays)


def test_attention_weights_cross_as_the_module_says():
    """The query projection's kernel is (in, heads, head_dim) and the output
    projection's (heads, head_dim, out): square at DIM, so only the port's
    module tells them apart, and without it a rank-3 kernel raises."""
    jax_attn = jax_mha(DIM, HEADS, nnx.Rngs(3))
    flat = {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(nnx.state(jax_attn, nnx.Param))}
    assert flat["query.kernel"].shape == (DIM, HEADS, DIM // HEADS)
    assert flat["out.kernel"].shape == (HEADS, DIM // HEADS, DIM)
    attn = MultiHeadAttention(DIM, HEADS)
    sd = state_dict_from_flat(flat, attn)
    np.testing.assert_array_equal(sd["query.weight"].numpy(), flat["query.kernel"].reshape(DIM, DIM).T)
    np.testing.assert_array_equal(sd["out.weight"].numpy(), flat["out.kernel"].reshape(DIM, DIM).T)
    np.testing.assert_array_equal(sd["query.bias"].numpy(), flat["query.bias"].reshape(-1))
    with pytest.raises(ValueError, match="rank-3 kernel"):
        state_dict_from_flat(flat)


@pytest.mark.parametrize("norm_first", [True, False], ids=["norm_first", "norm_after"])
def test_encoder_layer(norm_first):
    rng = np.random.RandomState(4)
    jax_layer = JaxEncoderLayer(DIM, num_heads=HEADS, ff_dim=2 * DIM, norm_first=norm_first, rngs=nnx.Rngs(4))
    randomize_norms(jax_layer, rng)
    layer = load(TransformerEncoderLayer(DIM, num_heads=HEADS, ff_dim=2 * DIM, norm_first=norm_first), jax_layer)
    assert_layer_matches(jax_layer, layer, _inputs(5, 7), seed=1)


@pytest.mark.parametrize("norm_first", [False, True], ids=["norm_after", "norm_first"])
def test_decoder_layer(norm_first):
    rng = np.random.RandomState(6)
    jax_layer = JaxDecoderLayer(DIM, num_heads=HEADS, ff_dim=3 * DIM, norm_first=norm_first, rngs=nnx.Rngs(6))
    randomize_norms(jax_layer, rng)
    layer = load(TransformerDecoderLayer(DIM, num_heads=HEADS, ff_dim=3 * DIM, norm_first=norm_first), jax_layer)
    assert_layer_matches(jax_layer, layer, _inputs(7, 4, 11), seed=2)


def test_encoder_gelu_is_the_tanh_form():
    """The encoder's GELU is ``jax.nn.gelu``'s tanh approximation: ``F.gelu``'s
    default (the erf form) misses it by over 1e-4 on its own, and in the
    layer's place misses JAX's output beyond the forward's tolerance."""
    jax_layer = JaxEncoderLayer(DIM, num_heads=HEADS, rngs=nnx.Rngs(8))
    randomize_norms(jax_layer, np.random.RandomState(8))
    jax_layer.eval()
    layer = load(TransformerEncoderLayer(DIM, num_heads=HEADS), jax_layer).eval()
    (x,) = _inputs(9, 6)
    x = x * 3
    want = np.asarray(jax_layer(jnp.asarray(x)))
    with torch.no_grad():
        assert_forward_close(layer(torch.from_numpy(x)).numpy(), want)
        layer.ff.act = F.gelu
        erf = layer(torch.from_numpy(x)).numpy()
    with pytest.raises(AssertionError):
        assert_forward_close(erf, want)
    z = np.linspace(-4, 4, 801, dtype=np.float32)
    jax_gelu = np.asarray(nnx.gelu(jnp.asarray(z)))
    np.testing.assert_allclose(_ACTS["gelu"](torch.from_numpy(z)).numpy(), jax_gelu, rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(z)).numpy() - jax_gelu).max() > 1e-4
