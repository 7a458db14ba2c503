"""The port's torchvision-format export against the committed key and shape
manifests (``tests/fixtures/tv_manifests``, the JAX package's record of
torchvision's layout), for every arch that has one: the ResNet family,
EfficientNet, MobileNet, MNASNet, ConvNeXt, DenseNet and ShuffleNetV2.
Each case builds the arch at full size on the CPU with zero kernels: a
manifest records keys and shapes only, and the truncated-normal draws of
the largest archs took 10 s each."""

import json
import os

import pytest
import torch

from sihl_tpu_torch.backbones import _FEATURE_FACTORIES
from sihl_tpu_torch.backbones.resnet import make_resnet_features
from sihl_tpu_torch.backbones.torchvision_import import dump_state_dict
from sihl_tpu_torch.layers import convblocks, mlp

MANIFESTS = os.path.join(os.path.dirname(__file__), "fixtures", "tv_manifests")
INVERTED_RESIDUAL_FAMILIES = (
    "efficientnet_b0", "efficientnet_b1", "efficientnet_b2", "efficientnet_b3", "efficientnet_b4", "efficientnet_b5",
    "efficientnet_b6", "efficientnet_b7", "efficientnet_v2_s", "efficientnet_v2_m", "efficientnet_v2_l",
    "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small", "mnasnet0_5", "mnasnet0_75", "mnasnet1_0",
    "mnasnet1_3",
)
LAST_FAMILIES = (
    "convnext_tiny", "convnext_small", "convnext_base", "convnext_large", "densenet121", "densenet161",
    "densenet169", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
)
RESNET_FAMILY = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
                 "resnext101_32x8d", "resnext101_64x4d", "wide_resnet50_2", "wide_resnet101_2")


def test_every_resnet_family_manifest_is_covered():
    names = {f[:-5] for f in os.listdir(MANIFESTS) if f.endswith(".json")}
    assert {n for n in names if n.startswith(("resnet", "resnext", "wide_resnet"))} == set(RESNET_FAMILY)


@pytest.mark.parametrize("name", RESNET_FAMILY)
def test_dump_matches_committed_manifest(name, monkeypatch):
    monkeypatch.setattr(convblocks, "lecun_normal", lambda shape, fan_in, generator: torch.zeros(shape))
    with open(os.path.join(MANIFESTS, f"{name}.json")) as f:
        manifest = json.load(f)
    sd = dump_state_dict(make_resnet_features(name, device="cpu"), name)
    got = {k: list(v.shape) for k, v in sd.items()}
    assert got == manifest, (sorted(set(got) - set(manifest))[:5], sorted(set(manifest) - set(got))[:5])


def test_every_inverted_residual_family_manifest_is_covered():
    names = {f[:-5] for f in os.listdir(MANIFESTS) if f.endswith(".json")}
    assert {n for n in names if n.startswith(("efficientnet", "mobilenet", "mnasnet"))} == set(
        INVERTED_RESIDUAL_FAMILIES)


@pytest.mark.parametrize("name", INVERTED_RESIDUAL_FAMILIES)
def test_inverted_residual_dump_matches_committed_manifest(name, monkeypatch):
    """EfficientNet, MobileNet and MNASNet: every conv (the squeeze-excitation
    convs with their biases) and BatchNorm under torchvision's key."""
    monkeypatch.setattr(convblocks, "lecun_normal", lambda shape, fan_in, generator: torch.zeros(shape))
    with open(os.path.join(MANIFESTS, f"{name}.json")) as f:
        manifest = json.load(f)
    sd = dump_state_dict(_FEATURE_FACTORIES[name](name, device="cpu"), name)
    got = {k: list(v.shape) for k, v in sd.items()}
    assert got == manifest, (sorted(set(got) - set(manifest))[:5], sorted(set(manifest) - set(got))[:5])


def test_every_manifest_is_covered():
    """All 39 committed manifests are held by one of the three dump tests."""
    names = {f[:-5] for f in os.listdir(MANIFESTS) if f.endswith(".json")}
    assert len(names) == 39
    assert names == set(RESNET_FAMILY) | set(INVERTED_RESIDUAL_FAMILIES) | set(LAST_FAMILIES)


@pytest.mark.parametrize("name", LAST_FAMILIES)
def test_last_families_dump_matches_committed_manifest(name, monkeypatch):
    """ConvNeXt (the stem's and every conv's bias, the LayerNorms, the
    Linears (out, in) and the layer scale (C, 1, 1)), DenseNet (no
    ``norm5``) and ShuffleNetV2: every tensor under torchvision's key."""
    zeros = lambda shape, fan_in, generator: torch.zeros(shape)  # noqa: E731
    monkeypatch.setattr(convblocks, "lecun_normal", zeros)
    monkeypatch.setattr(mlp, "lecun_normal", zeros)
    with open(os.path.join(MANIFESTS, f"{name}.json")) as f:
        manifest = json.load(f)
    sd = dump_state_dict(_FEATURE_FACTORIES[name](name, device="cpu"), name)
    got = {k: list(v.shape) for k, v in sd.items()}
    assert got == manifest, (sorted(set(got) - set(manifest))[:5], sorted(set(manifest) - set(got))[:5])
