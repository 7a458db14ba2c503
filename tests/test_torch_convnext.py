"""The port's ConvNeXt v1 / v2 feature nets against the JAX package's (CPU),
as ``tests/test_torch_mobilenet.py`` holds MobileNet.

The JAX nets are built by ``nnx.eval_shape`` and filled from a seeded
numpy generator (``torch_parity.numpy_filled``: layer scales U(0.1, 0.5),
GRN's scale and shift U(-0.5, 0.5), so that no block is the identity),
their weights carried to the port by ``state_dict_from_flat`` (strict).

Compared, for convnext_atto and convnextv2_atto (the net has no BatchNorm,
so eval mode only): the port's f64 levels within 1e-9 of JAX's f64 levels
and its f32 levels within 1e-5, both of each level's largest magnitude.
JAX's GRN casts to f32 explicitly (as do MobileNetV4's attention and
DenseNet's average pool), which would hold an f64 run to f32's digits; its f64 reference reads that cast
as f64 (``f64_statistics``), and the port's f32 levels are held against
JAX's stock f32 forward as well.  flax's LayerNorm takes the "fast
variance" E[x^2] - E[x]^2 where the port's takes two passes: on the stem's
output (eps 1e-6) the two agree within 1e-5 in f32 and 1e-9 in f64.

Every name of ``CONVNEXT_CONFIGS`` builds in the port with JAX's
``feature_channels``, ``level_modules`` and parameter names and shapes (the
port on the meta device, the JAX net with stub layers,
``torch_parity.stub_layout``); freezing by ``(attr, index)`` pairs agrees
with JAX's; ``state_dict_from_flat`` passes ``gamma`` and ``beta`` through;
the weight-decay labels agree with JAX's ``_is_no_decay`` (the layer scale
and GRN's scale and shift decayed, the LayerNorms not) for convnext_atto,
convnextv2_atto and mobilenetv4_hybrid_medium with level 1 frozen; and
``TimmBackbone`` builds each of the 25 convnext, convnextv2, densenet and
mobilenetv4 aliases, and four DLA and HRNet aliases with JAX's channels.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.backbones import _FEATURE_FACTORIES as JAX_FACTORIES
from sihl_tpu.backbones import _TIMM_ALIASES as JAX_TIMM_ALIASES
from sihl_tpu.backbones import convnext as jax_convnext
from sihl_tpu.backbones import densenet as jax_densenet
from sihl_tpu.backbones import dla as jax_dla
from sihl_tpu.backbones import hrnet as jax_hrnet
from sihl_tpu.backbones import mobilenetv4 as jax_mobilenetv4
from sihl_tpu.backbones import shufflenet as jax_shufflenet
from sihl_tpu.backbones.base import PyramidBackbone as JaxPyramidBackbone
from sihl_tpu.backbones.convnext import CONVNEXT_CONFIGS as JAX_CONVNEXT_CONFIGS
from sihl_tpu.heads import MulticlassClassification as JaxMulticlassClassification
from sihl_tpu.ops import image as jax_image
from sihl_tpu.training.optim import _is_no_decay
from sihl_tpu_torch import TIMM_BACKBONE_NAMES, Backbone, SihlModel, TimmBackbone
from sihl_tpu_torch.backbones.convnext import ConvNeXtFeatures
from sihl_tpu_torch.backbones.densenet import DenseNetFeatures
from sihl_tpu_torch.backbones.mobilenetv4 import MobileNetV4Features
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import MulticlassClassification
from sihl_tpu_torch.layers import convblocks, mlp
from sihl_tpu_torch.layers.mlp import LayerNorm
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training.optim import param_labels

from test_torch_hybrid_slice import jax_f64
from test_torch_mobilenet import assert_freezing_matches, assert_level_maps_match, jax_net, port_net
from torch_parity import flat_state, relative_max_error, stub_layout, to_numpy, to_torch

SECOND_PART = (jax_convnext, jax_mobilenetv4, jax_densenet, jax_shufflenet)
NUMERIC = ("convnext_atto", "convnextv2_atto")
NEW_FAMILIES = (ConvNeXtFeatures, MobileNetV4Features, DenseNetFeatures)
NEW_TIMM = sorted(alias for alias, native in JAX_TIMM_ALIASES.items()
                  if native.startswith(("convnext", "densenet", "mobilenetv4")))


class _Jnp64:
    """``jax.numpy`` whose ``float32`` is ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def f64_statistics():
    """Inside the block, the explicit f32 casts of JAX's GRN, MobileMQA and
    image ops (``x.astype(jnp.float32)``, ``logits.astype(jnp.float32)``,
    DenseNet's average pool) cast to f64, as the port's ``upcast`` does in
    an f64 run; in f32 and bf16 runs both packages take those sums in f32."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_convnext, jax_mobilenetv4, jax_image):
            mp.setattr(module, "jnp", _Jnp64())
        yield


def meta_init(monkeypatch) -> None:
    """The port's initial draws as meta tensors: a net of any size builds in
    a second and holds no memory."""
    def empty(shape, fan_in, generator):
        return torch.empty(shape, device="meta")

    monkeypatch.setattr(convblocks, "lecun_normal", empty)
    monkeypatch.setattr(mlp, "lecun_normal", empty)


def assert_layout_matches_on_meta(name: str, monkeypatch, families=SECOND_PART) -> None:
    """``Backbone(name)`` built on the meta device against the JAX net built
    with stub layers (in the JAX modules ``families``): feature channels,
    level modules, every parameter's and buffer's name and shape after
    ``state_dict_from_flat``, and the pyramid's shapes at 64 px."""
    meta_init(monkeypatch)
    with monkeypatch.context() as mp:
        stub_layout(mp, *families)
        jax_features = JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))
    bb = Backbone(name, device="meta").eval()
    assert bb.features.feature_channels == jax_features.feature_channels
    assert bb.features.level_modules == jax_features.level_modules
    want, chunk, size = {}, {}, 0
    for path, value in flat_state(jax_features).items():
        # a few leaves a call: the state dict copies them (846 million
        # parameters in convnext_xxlarge), and each call walks the modules
        chunk[path], size = value, size + value.size
        if size >= 2**24:
            want.update({k: tuple(t.shape) for k, t in state_dict_from_flat(chunk, bb.features).items()})
            chunk, size = {}, 0
    want.update({k: tuple(t.shape) for k, t in state_dict_from_flat(chunk, bb.features).items()})
    assert {k: tuple(v.shape) for k, v in bb.features.state_dict().items()} == want
    out = bb(torch.empty(1, 3, 64, 64, device="meta"))
    assert [tuple(o.shape[1:]) for o in out] == [(c, 64 >> i, 64 >> i) for i, c in enumerate(bb.out_channels)]


@pytest.mark.parametrize("name", NUMERIC)
def test_level_maps_match_jax(name):
    with f64_statistics():
        assert_level_maps_match(name, train_modes=(False,), level1_stride=4)


@pytest.mark.parametrize("name", NUMERIC)
def test_f32_level_maps_match_stock_jax_f32(name):
    """The port's f32 levels against JAX's own f32 forward (GRN's statistic
    in f32 on both sides), within 1e-5 of each level's largest."""
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jax32 = jax_net(name)
    model = port_net(name, flat_state(jax32))
    jax32.eval()
    want = nnx.jit(lambda m, xx: m(xx))(jax32, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(to_torch(x))
    for level, (g, w) in enumerate(zip(got, want), start=1):
        assert relative_max_error(to_numpy(g, nhwc=True), np.asarray(w)) <= 1e-5, (name, level)


@pytest.mark.parametrize("name", sorted(JAX_CONVNEXT_CONFIGS))
def test_every_name_builds_with_jax_layout(name, monkeypatch):
    assert_layout_matches_on_meta(name, monkeypatch)


@pytest.mark.parametrize("name", NUMERIC)
def test_stub_layout_is_eval_shape_layout(name, monkeypatch):
    """The stub layers give the real JAX net's module paths and leaf shapes,
    the LayerNorms, Linears and bare parameters among them."""
    def layout(module):
        state = nnx.state(module, nnx.Any(nnx.Param, nnx.BatchStat))
        return {".".join(map(str, path)): tuple(v.shape) for path, v in nnx.to_flat_state(state)}

    real = layout(nnx.eval_shape(lambda: JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))))
    stub_layout(monkeypatch, *SECOND_PART)
    assert layout(JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))) == real


@pytest.mark.parametrize("name", NUMERIC)
def test_pair_freezing_matches_jax(name, monkeypatch):
    assert_freezing_matches(name, monkeypatch, families=SECOND_PART)


def test_layer_norm_matches_flax_fast_variance():
    """The port's two-pass LayerNorm against flax's fast variance (eps 1e-6)
    on convnext_atto's stem conv output of images in [0, 1], whose channels
    sit off zero: f32 within 1e-5, f64 within 1e-9 of the largest output."""
    rng = np.random.RandomState(4)
    net = jax_net("convnext_atto")
    h = np.asarray(net.stem_conv(jnp.asarray(rng.rand(2, 32, 32, 3), jnp.float32)))
    scale, bias = rng.uniform(0.8, 1.2, 40).astype(np.float32), rng.uniform(-0.1, 0.1, 40).astype(np.float32)
    for dtype, limit in ((torch.float32, 1e-5), (torch.float64, 1e-9)):
        jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
        with jax_f64() if dtype == torch.float64 else contextlib.nullcontext():
            ln = nnx.LayerNorm(40, epsilon=1e-6, dtype=jdt, param_dtype=jdt, rngs=nnx.Rngs(0))
            ln.scale[...], ln.bias[...] = jnp.asarray(scale, jdt), jnp.asarray(bias, jdt)
            want = np.asarray(ln(jnp.asarray(h, jdt)))
        with compute_dtype_scope(dtype):
            port = LayerNorm(40, eps=1e-6, device="cpu")
        port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
        with torch.no_grad():
            got = port(torch.from_numpy(h.copy()).to(dtype))
        assert got.dtype == dtype
        assert relative_max_error(got.numpy(), want) <= limit, dtype


@pytest.mark.parametrize("name", NUMERIC)
def test_convert_passes_gamma_and_beta_through(name):
    """``state_dict_from_flat`` maps the bare 1-D ``gamma`` and ``beta``
    leaves (the layer scale; GRN's scale and shift) to parameters of the same
    name, as they are."""
    flat = flat_state(jax_net(name))
    bare = {k: v for k, v in flat.items() if k.endswith((".gamma", ".beta"))}
    assert bare and all(v.ndim == 1 for v in bare.values())
    assert any(".grn." in k for k in bare) == name.startswith("convnextv2")
    sd = state_dict_from_flat(flat)
    for k, v in bare.items():
        assert sd[k].dtype == torch.float32 and np.array_equal(sd[k].numpy(), v), k


@pytest.mark.parametrize("name", ["convnext_atto", "convnextv2_atto", "mobilenetv4_hybrid_medium"])
def test_weight_decay_labels_match_jax(name, monkeypatch):
    """With level 1 frozen, each parameter's label in the port
    (``param_labels``) is the JAX trainer's: "frozen" where the backbone
    freezes it, else by ``_is_no_decay`` of its nnx path.  The layer scale
    and GRN's ``gamma`` and ``beta`` are decayed; the LayerNorms' weights,
    the MQA block's among them, are not."""
    with monkeypatch.context() as mp:
        stub_layout(mp, *SECOND_PART)
        jax_bb = JaxPyramidBackbone(name, JAX_FACTORIES[name](name, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(0))
    jax_model = JaxSihlModel(jax_bb, None, [JaxMulticlassClassification(jax_bb.out_channels, 10, rngs=nnx.Rngs(0))])
    jax_bb.set_frozen_levels(1)
    bb = Backbone(name, device="cpu")
    bb.set_frozen_levels(1)
    model = SihlModel(bb, None, [MulticlassClassification(bb.out_channels, 10, device="cpu")])
    want = {}
    for path, value in nnx.to_flat_state(nnx.state(jax_model, nnx.Param)):
        keys = tuple(map(str, path))
        ((port_name, _),) = state_dict_from_flat({".".join(keys): np.asarray(value[...])}, model).items()
        if keys[:2] == ("backbone", "features") and jax_bb.is_frozen_param(keys[2:]):
            want[port_name] = "frozen"
        else:
            part = "backbone" if keys[0] == "backbone" else "rest"
            want[port_name] = f"{part}_{'no_decay' if _is_no_decay(keys) else 'decay'}"
    labels = param_labels(model)
    assert labels == want
    assert "frozen" in labels.values()
    for n, label in labels.items():
        if n.endswith((".gamma", ".beta")) and label != "frozen":
            assert label == "backbone_decay", n
        if n.startswith("backbone.") and n.endswith("norm.weight") and label != "frozen":
            assert label == "backbone_no_decay", n


def test_timm_aliases_of_the_new_families():
    """25 aliases, all now built by the port."""
    assert len(NEW_TIMM) == 25
    assert set(NEW_TIMM) <= set(TIMM_BACKBONE_NAMES)


@pytest.mark.parametrize("alias", NEW_TIMM)
def test_timm_backbone_builds_each_alias(alias, monkeypatch):
    """``TimmBackbone(alias)`` builds the native net the JAX table names,
    with JAX's channels (the port on the meta device, the JAX side with stub
    layers)."""
    native = JAX_TIMM_ALIASES[alias]
    meta_init(monkeypatch)
    with monkeypatch.context() as mp:
        stub_layout(mp, *SECOND_PART)
        jax_bb = JaxPyramidBackbone(native, JAX_FACTORIES[native](native, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(0))
    bb = TimmBackbone(alias, device="meta")
    assert isinstance(bb.features, NEW_FAMILIES) and bb.name == native
    assert bb.out_channels == jax_bb.out_channels


@pytest.mark.parametrize("alias", ["dla34", "dla169", "hrnet_w18", "hrnet_w64"])
def test_dla_and_hrnet_aliases_still_raise(alias, monkeypatch):
    """The DLA and HRNet aliases, which raised until those families were
    ported, build the native net with JAX's out channels (the port on the
    meta device, the JAX side with stub layers)."""
    meta_init(monkeypatch)
    with monkeypatch.context() as mp:
        stub_layout(mp, jax_dla, jax_hrnet)
        jax_bb = JaxPyramidBackbone(alias, JAX_FACTORIES[alias](alias, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(0))
    bb = TimmBackbone(alias, device="meta")
    assert bb.name == JAX_TIMM_ALIASES[alias] == alias
    assert bb.out_channels == jax_bb.out_channels
