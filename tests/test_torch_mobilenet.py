"""The port's MobileNet v2 / v3 feature nets against the JAX package's (CPU).

The JAX nets are built by ``nnx.eval_shape`` and filled from a seeded
numpy generator (``torch_parity.numpy_filled``), their weights carried to
the port by ``state_dict_from_flat`` (strict).  Inputs are N(0, 1) images,
2 at 64 px: no activation input lies on a kink of ReLU6, hardswish or
hardsigmoid.

Compared, for mobilenet_v2, v3-large, v3-small and one width variant,
against the JAX net in f64 (``jax_f64``: its BatchNorms the stock
``nnx.BatchNorm``), in eval mode and then with train-mode BatchNorm: the
port's f64 levels within 1e-9 of each level's largest magnitude, and its
running statistics after the train-mode step within f32's rounding; its
f32 levels within 1e-5 in eval mode and within ``F32_TRAIN_LIMIT`` in
train mode.  An f32 train-mode forward through 16-60
  BatchNorms over 2 images drifts from f64 by up to 1.3e-4 of a level's
  largest (the port) and 3.2e-4 (JAX's own f32 forward, whose fused
  BatchNorm keeps f32 statistics), so neither f32 forward is the other's
  reference at 1e-5.

Every name of ``MOBILENET_CONFIGS`` builds in the port with JAX's
``feature_channels``, ``level_modules`` and parameter layout (the JAX side
with stub convs and norms, ``torch_parity.stub_layout``, checked against
``nnx.eval_shape``'s layout); freezing by ``(attr, index)`` pairs agrees
with JAX's ``is_frozen_param`` for every ``level_modules`` entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu.backbones import _FEATURE_FACTORIES as JAX_FACTORIES
from sihl_tpu.backbones import efficientnet as jax_efficientnet
from sihl_tpu.backbones import mnasnet as jax_mnasnet
from sihl_tpu.backbones import mobilenet as jax_mobilenet
from sihl_tpu.backbones.base import PyramidBackbone as JaxPyramidBackbone
from sihl_tpu.backbones.mobilenet import MOBILENET_CONFIGS as JAX_MOBILENET_CONFIGS
from sihl_tpu_torch import Backbone
from sihl_tpu_torch.backbones import _FEATURE_FACTORIES
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.layers import convblocks
from sihl_tpu_torch.layers.convblocks import BatchNorm2d
from sihl_tpu_torch.policy import compute_dtype_scope

from test_torch_hybrid_slice import jax_f64
from torch_parity import flat_state, numpy_filled, relative_max_error, stub_layout, to_numpy, to_torch

F32_TRAIN_LIMIT = 3e-4
NUMERIC = ("mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small", "mobilenet_v3_small_075")
JAX_FAMILIES = (jax_mobilenet, jax_efficientnet, jax_mnasnet)


def jax_net(name: str, seed: int = 0):
    """The JAX feature net of ``name``, its leaves from ``numpy_filled``, in
    the compute dtype of the scope it is built in."""
    return numpy_filled(nnx.eval_shape(lambda: JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))), seed)


def port_net(name: str, flat: dict, dtype=torch.float32):
    """The port's feature net of ``name`` holding a JAX net's ``flat_state``
    (built with zero draws: every parameter is loaded)."""
    with compute_dtype_scope(dtype), pytest.MonkeyPatch.context() as mp:
        mp.setattr(convblocks, "lecun_normal", lambda shape, fan_in, generator: torch.zeros(shape))
        features = _FEATURE_FACTORIES[name](name, device="cpu")
    features.load_state_dict(state_dict_from_flat(flat, features), strict=True)
    return features


def _forward(module, x):
    return nnx.jit(lambda m, xx: m(xx))(module, x)


def assert_level_maps_match(name: str, seed: int = 0, train_modes=(False, True), level1_stride: int = 2,
                            build=jax_net, forward=_forward, jax_f32_drift: bool = False) -> None:
    """The JAX net in f64 (``jax_f64``) in eval mode, then in train mode
    (one step of its running statistics), against the port's in f64 and f32,
    as the module docstring sets out; ``train_modes`` (False) leaves out
    the train mode of a net without BatchNorm, and ``level1_stride`` is 4
    for a net whose level 1 the pyramid wrapper resizes (ConvNeXt).
    ``build(name, seed)`` makes the JAX net and ``forward(net, x)`` runs
    it, its running statistics updated in train mode.  With
    ``jax_f32_drift`` a train-mode level is held within the larger of
    ``F32_TRAIN_LIMIT`` and JAX's own f32 train-mode forward's error from
    its f64 one on that level: the port keeps as many digits as the
    reference's f32."""
    x = np.random.RandomState(seed + 1).randn(2, 64, 64, 3).astype(np.float32)
    drift = [0.0] * 5
    if jax_f32_drift:
        jax32 = build(name, seed)
        jax32.train()
        drift = [np.asarray(w) for w in forward(jax32, jnp.asarray(x))]
    with jax_f64():
        jax64 = build(name, seed)
        initial = flat_state(jax64)
        jax64.eval()
        want_eval = forward(jax64, jnp.asarray(x, jnp.float64))
        jax64.train()
        want_train = forward(jax64, jnp.asarray(x, jnp.float64)) if True in train_modes else None
        jax_state = flat_state(jax64)
    if jax_f32_drift:
        drift = [relative_max_error(d, w) for d, w in zip(drift, want_train)]
    models = {dtype: port_net(name, initial, dtype) for dtype in (torch.float64, torch.float32)}
    for train, want in ((False, want_eval), (True, want_train)):
        if train not in train_modes:
            continue
        for model in models.values():
            model.train(train)
        with torch.no_grad():
            got = {dtype: model(to_torch(x).to(dtype)) for dtype, model in models.items()}
        assert len(want) == 5
        for level, (g64, g32, w) in enumerate(zip(got[torch.float64], got[torch.float32], want), start=1):
            side = 64 // level1_stride if level == 1 else 64 >> level
            assert tuple(g32.shape) == (2, models[torch.float32].feature_channels[level - 1], side, side)
            assert g64.dtype == torch.float64 and g32.dtype == torch.float32
            assert relative_max_error(g64.permute(0, 2, 3, 1).numpy(), w) <= 1e-9, (name, train, level)
            limit = max(F32_TRAIN_LIMIT, drift[level - 1]) if train else 1e-5
            assert relative_max_error(to_numpy(g32, nhwc=True), w) <= limit, (name, train, "f32", level)
    stats = state_dict_from_flat(jax_state, models[torch.float64])
    for key, buf in models[torch.float64].state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), stats[key].numpy(), rtol=1e-6, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("name", NUMERIC)
def test_level_maps_match_jax(name):
    assert_level_maps_match(name)


def assert_layout_matches(name: str, monkeypatch, families=JAX_FAMILIES) -> None:
    """``Backbone(name)`` in the port (zero draws) against the JAX net built
    with stub layers: feature channels, level modules, and the JAX state
    loading strictly through ``state_dict_from_flat``; the pyramid's shapes
    at 64 px."""
    monkeypatch.setattr(convblocks, "lecun_normal", lambda shape, fan_in, generator: torch.zeros(shape))
    with monkeypatch.context() as mp:
        stub_layout(mp, *families)
        jax_features = JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))
    bb = Backbone(name, device="cpu").eval()
    assert bb.features.feature_channels == jax_features.feature_channels
    assert bb.features.level_modules == jax_features.level_modules
    bb.features.load_state_dict(state_dict_from_flat(flat_state(jax_features), bb.features), strict=True)
    with torch.no_grad():
        out = bb(torch.rand(1, 3, 64, 64))
    assert [tuple(o.shape[1:]) for o in out] == [(c, 64 >> i, 64 >> i) for i, c in enumerate(bb.out_channels)]


@pytest.mark.parametrize("name", sorted(JAX_MOBILENET_CONFIGS))
def test_every_name_builds_with_jax_layout(name, monkeypatch):
    assert_layout_matches(name, monkeypatch)


@pytest.mark.parametrize("name", ["mobilenet_v3_small", "mobilenet_v2_050"])
def test_stub_layout_is_eval_shape_layout(name, monkeypatch):
    """The stub layers give the real JAX net's module paths and leaf shapes."""
    def layout(module):
        state = nnx.state(module, nnx.Any(nnx.Param, nnx.BatchStat))
        return {".".join(map(str, path)): tuple(v.shape) for path, v in nnx.to_flat_state(state)}

    real = layout(nnx.eval_shape(lambda: JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))))
    stub_layout(monkeypatch, *JAX_FAMILIES)
    assert layout(JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))) == real


def assert_freezing_matches(name: str, monkeypatch, families=JAX_FAMILIES, pairs: bool = True) -> None:
    """For every frozen prefix (0-5 levels, and all): the frozen entries, the
    parameter test on every parameter path and the BatchNorms that
    ``_set_frozen_bn_eval`` puts in eval mode agree with the JAX package's
    ``PyramidBackbone``; every ``level_modules`` entry is frozen with its
    level.  ``pairs``: the net's ``level_modules`` hold ``(attr, index)``
    pairs."""
    monkeypatch.setattr(convblocks, "lecun_normal", lambda shape, fan_in, generator: torch.zeros(shape))
    with monkeypatch.context() as mp:
        stub_layout(mp, *families)
        jax_bb = JaxPyramidBackbone(name, JAX_FACTORIES[name](name, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(0))
    bb = Backbone(name, device="cpu")
    entries = [e for level in bb.features.level_modules for e in level]
    assert any(isinstance(e, tuple) for e in entries) == pairs or name == "mobilenet_v3_small"
    for k in (0, 1, 2, 3, 4, 5, -1):
        jax_bb.set_frozen_levels(k)
        bb.set_frozen_levels(k)
        assert bb.frozen_attr_names() == jax_bb.frozen_attr_names()
        frozen = set(bb.frozen_attr_names())
        levels = bb.features.level_modules if k < 0 else bb.features.level_modules[:k]
        assert frozen == {e for level in levels for e in level}
        for pname, _ in bb.features.named_parameters():
            path = pname.split(".")
            assert bb.is_frozen_param(path) == jax_bb.is_frozen_param(path), (k, pname)
        bb.train()
        bb._set_frozen_bn_eval()
        for mname, module in bb.features.named_modules():
            if isinstance(module, BatchNorm2d):
                path = mname.split(".")
                assert module.training == (not bb.is_frozen_param(path)), (k, mname)


@pytest.mark.parametrize("name", ["mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small"])
def test_pair_freezing_matches_jax(name, monkeypatch):
    assert_freezing_matches(name, monkeypatch)


def test_activations_split_the_gradient_at_their_kinks_as_jax():
    """ReLU6, hardswish and hardsigmoid at their kinks (0, 6, +-3) and away
    from them: values and gradients equal to ``jax.grad`` of the JAX
    formulas."""
    from sihl_tpu_torch.backbones.mobilenet import hardsigmoid, hardswish, relu6

    pts = np.array([-7.0, -3.0, -1.5, 0.0, 2.5, 3.0, 6.0, 7.5])
    jax_acts = {
        relu6: lambda v: jnp.clip(jnp.maximum(v, 0.0), 0.0, 6.0),
        hardswish: jax_mobilenet._hardswish,
        hardsigmoid: jax_mobilenet._hardsigmoid,
    }
    with jax.enable_x64(True):
        for fn, jfn in jax_acts.items():
            x = torch.tensor(pts, dtype=torch.float64, requires_grad=True)
            fn(x).sum().backward()
            want = jax.grad(lambda v: jfn(v).sum())(jnp.asarray(pts))
            np.testing.assert_array_equal(fn(x.detach()).numpy(), np.asarray(jfn(jnp.asarray(pts))))
            np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want), err_msg=fn.__name__)
