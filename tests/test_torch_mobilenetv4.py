"""The port's MobileNetV4 feature nets against the JAX package's (CPU), as
``tests/test_torch_mobilenet.py`` holds MobileNet.

Compared, for mobilenetv4_conv_small and mobilenetv4_hybrid_medium (its
Mobile-MQA blocks at strides 16 and 32), in eval mode and with train-mode
BatchNorm: the port's f64 levels within 1e-9 of JAX's f64 levels (the
MQA's f32 casts read as f64 there, ``test_torch_convnext.f64_statistics``),
its f32 levels within 1e-5 in eval mode and ``F32_TRAIN_LIMIT`` in train
mode, and its f32 levels against JAX's stock f32 forward in eval mode.
One MQA block alone against JAX's, forward and input gradient, f32 and f64.
Every name of ``MOBILENETV4_CONFIGS`` builds with JAX's channels, level
modules (the stem, then each level's ``("blocks", i)`` pairs) and
parameter layout; freezing agrees with JAX's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu.backbones import _FEATURE_FACTORIES as JAX_FACTORIES
from sihl_tpu.backbones.mobilenetv4 import MOBILENETV4_CONFIGS as JAX_MOBILENETV4_CONFIGS
from sihl_tpu.backbones.mobilenetv4 import MobileMQA as JaxMobileMQA
from sihl_tpu_torch.backbones.mobilenetv4 import MOBILENETV4_CONFIGS, MobileMQA
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.policy import compute_dtype_scope

from test_torch_convnext import SECOND_PART, assert_layout_matches_on_meta, f64_statistics
from test_torch_hybrid_slice import jax_f64
from test_torch_mobilenet import assert_freezing_matches, assert_level_maps_match, jax_net, port_net
from torch_parity import flat_state, numpy_filled, relative_max_error, stub_layout, to_numpy, to_torch

NUMERIC = ("mobilenetv4_conv_small", "mobilenetv4_hybrid_medium")


def test_configs_are_jax_configs():
    """The specs, the hybrids' interleaved MQA blocks among them, entry for
    entry."""
    assert MOBILENETV4_CONFIGS == JAX_MOBILENETV4_CONFIGS
    assert sum(e == ("mqa",) for e in MOBILENETV4_CONFIGS["mobilenetv4_hybrid_medium"]) == 5


@pytest.mark.parametrize("name", NUMERIC)
def test_level_maps_match_jax(name):
    with f64_statistics():
        assert_level_maps_match(name)


def test_hybrid_f32_level_maps_match_stock_jax_f32():
    """The port's f32 levels against JAX's own f32 forward (the MQA logits
    in f32 on both sides), eval mode, within 1e-5 of each level's largest."""
    name = "mobilenetv4_hybrid_medium"
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jax32 = jax_net(name)
    model = port_net(name, flat_state(jax32))
    jax32.eval()
    want = nnx.jit(lambda m, xx: m(xx))(jax32, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(to_torch(x))
    for level, (g, w) in enumerate(zip(got, want), start=1):
        assert relative_max_error(to_numpy(g, nhwc=True), np.asarray(w)) <= 1e-5, level


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_mqa_block_matches_jax(dtype):
    """``MobileMQA(64)`` on (2, 64, 6, 5) maps, its weights and LayerNorm
    random: the output and the input's gradient (of the output's inner
    product with a random cotangent) against JAX's, within 1e-5 (f32) or
    1e-9 (f64) of the largest."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 5, 64).astype(np.float32)
    cot = rng.randn(2, 6, 5, 64).astype(np.float32)
    f64 = dtype == torch.float64
    jdt = jnp.float64 if f64 else jnp.float32
    reference = (jax_f64(), f64_statistics()) if f64 else ()
    with contextlib.ExitStack() as stack:
        for context in reference:
            stack.enter_context(context)
        block = numpy_filled(nnx.eval_shape(lambda: JaxMobileMQA(64, rngs=nnx.Rngs(0))), 3)
        flat = flat_state(block)
        want, vjp = jax.vjp(lambda xx: block(xx), jnp.asarray(x, jdt))
        (want_dx,) = vjp(jnp.asarray(cot, jdt))
    with compute_dtype_scope(dtype):
        port = MobileMQA(64, generator=torch.Generator().manual_seed(0), device="cpu")
    port.load_state_dict(state_dict_from_flat(flat, port), strict=True)
    assert port.q.bias is None and port.kv.bias is None and port.out.bias is None
    xt = to_torch(x).to(dtype).requires_grad_(True)
    got = port(xt)
    got.backward(to_torch(cot).to(dtype))
    limit = 1e-9 if f64 else 1e-5
    assert got.dtype == dtype
    assert relative_max_error(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want)) <= limit
    assert relative_max_error(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_dx)) <= limit


@pytest.mark.parametrize("name", sorted(JAX_MOBILENETV4_CONFIGS))
def test_every_name_builds_with_jax_layout(name, monkeypatch):
    assert_layout_matches_on_meta(name, monkeypatch)


def test_stub_layout_is_eval_shape_layout(monkeypatch):
    """The stub layers give the real JAX net's module paths and leaf shapes,
    the MQA blocks' LayerNorms and bias-free Linears among them."""
    name = "mobilenetv4_hybrid_medium"

    def layout(module):
        state = nnx.state(module, nnx.Any(nnx.Param, nnx.BatchStat))
        return {".".join(map(str, path)): tuple(v.shape) for path, v in nnx.to_flat_state(state)}

    real = layout(nnx.eval_shape(lambda: JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))))
    stub_layout(monkeypatch, *SECOND_PART)
    assert layout(JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))) == real


@pytest.mark.parametrize("name", NUMERIC)
def test_pair_freezing_matches_jax(name, monkeypatch):
    assert_freezing_matches(name, monkeypatch, families=SECOND_PART)
