"""The port's torchvision-format export against the committed key and shape
manifests (``tests/fixtures/tv_manifests``, the JAX package's record of
torchvision's layout), for every ResNet-family arch that has one.  Each
case builds the arch at full size on the CPU with zero kernels: a manifest
records keys and shapes only, and the truncated-normal draws of the
largest archs took 10 s each."""

import json
import os

import pytest
import torch

from sihl_tpu_torch.backbones.resnet import make_resnet_features
from sihl_tpu_torch.backbones.torchvision_import import dump_state_dict
from sihl_tpu_torch.layers import convblocks

MANIFESTS = os.path.join(os.path.dirname(__file__), "fixtures", "tv_manifests")
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
