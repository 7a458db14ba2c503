"""The port's DLA and HRNet feature nets against the JAX package's (CPU), as
``tests/test_torch_mobilenet.py`` holds MobileNet.

The JAX nets are built layer by layer under ``nnx.eval_shape``
(``quick_jax_net``: one abstract conv or norm at a time, where one
``eval_shape`` over the whole of hrnet_w18 takes 30 s) and filled from a
seeded numpy generator (``torch_parity.numpy_filled``, the same leaves in
the same order as a whole ``eval_shape``); their forwards run with each
block compiled on its own, XLA's backend optimisation off, and cached by
structure (``quick_forward``).  Weights cross by ``state_dict_from_flat``
(strict).

Compared, for dla34, dla60 (bottleneck blocks), dla102 (residual roots)
and hrnet_w18, in eval mode and with train-mode BatchNorm: the port's f64
levels within 1e-9 of JAX's f64 levels, its f32 levels within 1e-5 in eval
mode, and the running statistics after the train-mode forward.  In train
mode the f32 levels are held within the larger of ``F32_TRAIN_LIMIT``
(3e-4) and JAX's own f32 forward's error from f64 on that level: the
deepest DLA trees normalise 8 values a channel at level 5 (2 images at 2 x
2), and f32 itself keeps fewer digits there (JAX's f32 read 3.1e-3 on
dla60's level 5, the port's 1.9e-3; 7.4e-4 and 4.0e-4 on dla102's;
hrnet_w18 stays within 9.3e-5 and 4.5e-5).  For dla34 and hrnet_w18 the
port's f32 eval levels are also held against JAX's own f32 forward within
1e-5.  A wrong
order of a DLA root's concatenation, or of an HRNet fusion's links, keeps
every shape: only these value checks see it.

Every name of ``DLA_CONFIGS`` and ``HRNET_CONFIGS`` builds with JAX's
channels, level modules and parameter layout (``links.i.j`` keeping its
indices past the diagonal's placeholder); the stub layout is
``quick_jax_net``'s (111 and 915 parameter leaves for dla34 and
hrnet_w18), and for dla34 ``nnx.eval_shape``'s of the whole net; level
freezing agrees with JAX's ``frozen_attr_names``; and ``TimmBackbone``
builds each of the 11 DLA and HRNet aliases with JAX's channels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu.backbones import _FEATURE_FACTORIES as JAX_FACTORIES
from sihl_tpu.backbones import _TIMM_ALIASES as JAX_TIMM_ALIASES
from sihl_tpu.backbones import dla as jax_dla
from sihl_tpu.backbones import hrnet as jax_hrnet
from sihl_tpu.backbones.base import PyramidBackbone as JaxPyramidBackbone
from sihl_tpu.layers import convblocks as jax_convblocks
from sihl_tpu.policy import compute_dtype as jax_compute_dtype
from sihl_tpu_torch import TimmBackbone
from sihl_tpu_torch.backbones.dla import DLA_CONFIGS, DlaFeatures
from sihl_tpu_torch.backbones.hrnet import HRNET_CONFIGS, HrnetFeatures

from test_torch_convnext import assert_layout_matches_on_meta, meta_init
from test_torch_mobilenet import assert_freezing_matches, assert_level_maps_match, port_net
from torch_parity import flat_state, numpy_filled, relative_max_error, stub_layout, to_numpy, to_torch

FAMILIES = (jax_dla, jax_hrnet)
NAMES = sorted({**DLA_CONFIGS, **HRNET_CONFIGS})
NUMERIC = ("dla34", "dla60", "dla102", "hrnet_w18")
# the names whose f32 train-mode levels are held against JAX's own f32 drift
# (module docstring)
F32_DRIFT = ("dla60", "dla102")
# XLA's CPU backend without its optimisation passes
QUICK_COMPILE = {"xla_backend_optimization_level": 0}
# the JAX modules that ``quick_forward`` compiles one at a time
JITTED = (jax_dla._ConvBNReLU, jax_dla.DlaBasic, jax_dla.DlaBottleneck, jax_dla._Root, jax_hrnet._ConvBN,
          jax_hrnet._Bottleneck, jax_hrnet._Module)
_CALLS = {cls: cls.__call__ for cls in JITTED}


@functools.lru_cache(maxsize=None)
def _abstract_net(name: str, x64: bool, dtype, hrnet_stages):
    """The JAX feature net of ``name`` with abstract leaves, in the compute
    dtype ``dtype`` (HRNet with ``hrnet_stages`` as its ``_STAGES``), each
    conv and norm built by an ``nnx.eval_shape`` of its own."""
    def abstract_conv(*args, rngs=None, **kwargs):
        return nnx.eval_shape(lambda: jax_convblocks.make_conv(*args, rngs=nnx.Rngs(0), **kwargs))

    def abstract_norm(kind, num_features, groupnorm_groups=1, rngs=None):
        return nnx.eval_shape(lambda: jax_convblocks.make_norm(kind, num_features, groupnorm_groups, nnx.Rngs(0)))

    with pytest.MonkeyPatch.context() as mp:
        for module in FAMILIES:
            mp.setattr(module, "make_conv", abstract_conv)
            mp.setattr(module, "make_norm", abstract_norm)
        return JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))


def quick_jax_net(name: str, seed: int = 0):
    """The JAX feature net of ``name`` in the compute dtype of the scope it
    is built in (``_abstract_net``, built once a dtype), every leaf drawn
    by ``numpy_filled``."""
    return numpy_filled(_abstract_net(name, jax.config.jax_enable_x64, jax_compute_dtype(), jax_hrnet._STAGES), seed)


@functools.partial(jax.jit, static_argnums=0, compiler_options=QUICK_COMPILE)
def _apply(graphdef, state, args):
    module = nnx.merge(graphdef, state)
    return _CALLS[type(module)](module, *args), nnx.state(module)


def _compiled_call(self, *args):
    """A ``JITTED`` module's call as one compiled function of its structure
    and state (``_apply``); inside another's trace, its own call."""
    if any(isinstance(a, jax.core.Tracer) for a in jax.tree_util.tree_leaves(args)):
        return _CALLS[type(self)](self, *args)
    graphdef, state = nnx.split(self)
    out, state = _apply(graphdef, state, args)
    nnx.update(self, state)
    return out


def quick_forward(module, x):
    """``module(x)`` with each ``JITTED`` module's call compiled
    (``QUICK_COMPILE``) and cached by its structure and input shapes:
    hrnet_w18's eight fusion modules compile three times, where one compile
    of the whole net takes 13 s a mode.  The state (a train-mode
    BatchNorm's running statistics) is updated as ``nnx.jit`` would."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in JITTED:
            mp.setattr(cls, "__call__", _compiled_call)
        return module(x)


@pytest.mark.parametrize("name", NUMERIC)
def test_level_maps_match_jax(name):
    assert_level_maps_match(name, build=quick_jax_net, forward=quick_forward, jax_f32_drift=name in F32_DRIFT)


@pytest.mark.parametrize("name", ["dla34", "hrnet_w18"])
def test_f32_level_maps_match_stock_jax_f32(name):
    """The port's f32 levels against JAX's own f32 forward (its fused
    BatchNorm), eval mode, within 1e-5 of each level's largest."""
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jax32 = quick_jax_net(name)
    model = port_net(name, flat_state(jax32))
    jax32.eval()
    want = quick_forward(jax32, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(to_torch(x))
    for level, (g, w) in enumerate(zip(got, want), start=1):
        assert relative_max_error(to_numpy(g, nhwc=True), np.asarray(w)) <= 1e-5, (name, level)


@pytest.mark.parametrize("name", NAMES)
def test_every_name_builds_with_jax_layout(name, monkeypatch):
    assert_layout_matches_on_meta(name, monkeypatch, families=FAMILIES)


@pytest.mark.parametrize("name, leaves", [("dla34", 111), ("hrnet_w18", 915)])
def test_stub_and_quick_layouts_are_eval_shape_layout(name, leaves, monkeypatch):
    """The stub layers give ``quick_jax_net``'s module paths and leaf shapes,
    ``leaves`` parameter leaves, hrnet_w18's ``links.i.j`` among them; and
    for dla34 both are ``nnx.eval_shape``'s of the whole net (30 s for
    hrnet_w18)."""
    def layout(module, kind=nnx.Any(nnx.Param, nnx.BatchStat)):
        return {".".join(map(str, path)): tuple(v.shape) for path, v in nnx.to_flat_state(nnx.state(module, kind))}

    quick = quick_jax_net(name)
    assert len(layout(quick, nnx.Param)) == leaves
    if name == "dla34":
        assert layout(nnx.eval_shape(lambda: JAX_FACTORIES[name](name, rngs=nnx.Rngs(0)))) == layout(quick)
        assert {"stages.1.tree1.root.conv.conv.kernel", "stages.1.tree1.project.bn.scale"} <= set(layout(quick))
    else:
        assert {"stage2.0.links.0.1.convs.0.conv.kernel", "stage2.0.links.1.0.convs.0.bn.scale"} <= set(layout(quick))
    stub_layout(monkeypatch, *FAMILIES)
    assert layout(JAX_FACTORIES[name](name, rngs=nnx.Rngs(0))) == layout(quick)


@pytest.mark.parametrize("name", ["dla34", "dla102", "hrnet_w18"])
def test_level_freezing_matches_jax(name, monkeypatch):
    """Every frozen prefix, level 1 among them: the frozen entries (DLA's
    ``(stages, i)`` pairs, HRNet's stage lists), the parameter test and the
    BatchNorms put in eval mode agree with JAX's ``PyramidBackbone``."""
    assert_freezing_matches(name, monkeypatch, families=FAMILIES, pairs=name.startswith("dla"))


@pytest.mark.parametrize("alias", sorted(a for a, native in JAX_TIMM_ALIASES.items()
                                          if native in DLA_CONFIGS or native in HRNET_CONFIGS))
def test_timm_backbone_builds_each_dla_and_hrnet_alias(alias, monkeypatch):
    """``TimmBackbone(alias)`` builds the native net the JAX table names, with
    JAX's out channels (the port on the meta device, JAX with stub layers)."""
    native = JAX_TIMM_ALIASES[alias]
    meta_init(monkeypatch)
    with monkeypatch.context() as mp:
        stub_layout(mp, *FAMILIES)
        jax_bb = JaxPyramidBackbone(native, JAX_FACTORIES[native](native, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(0))
    bb = TimmBackbone(alias, device="meta")
    assert isinstance(bb.features, (DlaFeatures, HrnetFeatures)) and bb.name == native
    assert bb.out_channels == jax_bb.out_channels
