"""The port's EfficientNet and MNASNet feature nets against the JAX
package's (CPU), as ``tests/test_torch_mobilenet.py`` holds MobileNet:
level maps in eval mode and with train-mode BatchNorm for efficientnet_b0
(MBConv with squeeze-excitation), efficientnet_v2_s (FusedMBConv stages),
efficientnet_lite0 (ReLU6, no SE) and mnasnet0_5; every name of
``EFFICIENTNET_CONFIGS`` and ``MNASNET_CONFIGS`` built with JAX's channels,
level modules and parameter layout; freezing by ``("stages", j)`` and
``("stacks", i)`` pairs against JAX's; and ``TimmBackbone`` for each timm
alias of the three families.
"""

import pytest
import torch
from flax import nnx

from sihl_tpu.backbones import _FEATURE_FACTORIES as JAX_FACTORIES
from sihl_tpu.backbones import _TIMM_ALIASES as JAX_TIMM_ALIASES
from sihl_tpu.backbones.base import PyramidBackbone as JaxPyramidBackbone
from sihl_tpu.backbones.efficientnet import EFFICIENTNET_CONFIGS as JAX_EFFICIENTNET_CONFIGS
from sihl_tpu.backbones.mnasnet import MNASNET_CONFIGS as JAX_MNASNET_CONFIGS
from sihl_tpu.backbones.mobilenet import MOBILENET_CONFIGS as JAX_MOBILENET_CONFIGS
from sihl_tpu_torch import TIMM_BACKBONE_NAMES, TimmBackbone
from sihl_tpu_torch.backbones.efficientnet import EfficientNetFeatures
from sihl_tpu_torch.backbones.mnasnet import MnasNetFeatures
from sihl_tpu_torch.backbones.mobilenet import MobileNetFeatures
from sihl_tpu_torch.layers import convblocks

from test_torch_mobilenet import (JAX_FAMILIES, assert_freezing_matches, assert_layout_matches,
                                  assert_level_maps_match)
from torch_parity import stub_layout

NEW_FAMILIES = {**{n: MobileNetFeatures for n in JAX_MOBILENET_CONFIGS},
                **{n: EfficientNetFeatures for n in JAX_EFFICIENTNET_CONFIGS},
                **{n: MnasNetFeatures for n in JAX_MNASNET_CONFIGS}}
NEW_TIMM = sorted(alias for alias, native in JAX_TIMM_ALIASES.items() if native in NEW_FAMILIES)


@pytest.mark.parametrize("name", ["efficientnet_b0", "efficientnet_v2_s", "efficientnet_lite0", "mnasnet0_5"])
def test_level_maps_match_jax(name):
    assert_level_maps_match(name)


@pytest.mark.parametrize("name", sorted({**JAX_EFFICIENTNET_CONFIGS, **JAX_MNASNET_CONFIGS}))
def test_every_name_builds_with_jax_layout(name, monkeypatch):
    assert_layout_matches(name, monkeypatch)


@pytest.mark.parametrize("name", ["efficientnet_b0", "efficientnet_v2_s", "mnasnet0_5"])
def test_pair_freezing_matches_jax(name, monkeypatch):
    assert_freezing_matches(name, monkeypatch)


def test_timm_aliases_of_the_new_families():
    """19 aliases, all now built by the port."""
    assert len(NEW_TIMM) == 19
    assert set(NEW_TIMM) <= set(TIMM_BACKBONE_NAMES)


@pytest.mark.parametrize("alias", NEW_TIMM)
def test_timm_backbone_builds_each_alias(alias, monkeypatch):
    """``TimmBackbone(alias)`` builds the native net the JAX table names,
    with JAX's channels (the JAX side with stub layers)."""
    native = JAX_TIMM_ALIASES[alias]
    monkeypatch.setattr(convblocks, "lecun_normal", lambda shape, fan_in, generator: torch.zeros(shape))
    with monkeypatch.context() as mp:
        stub_layout(mp, *JAX_FAMILIES)
        jax_bb = JaxPyramidBackbone(native, JAX_FACTORIES[native](native, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(0))
    bb = TimmBackbone(alias, device="cpu")
    assert isinstance(bb.features, NEW_FAMILIES[native]) and bb.name == native
    assert bb.out_channels == jax_bb.out_channels
