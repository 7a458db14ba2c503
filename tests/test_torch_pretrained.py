"""Pretrained trunks in the port against the JAX package (CPU): torchvision-
format files read from ``torch.hub.get_dir()/checkpoints`` under a
temporary ``TORCH_HOME``, ``Normalize`` in front, level 1 frozen.

The files are written here from a seed: the JAX package's
``dump_state_dict`` of a ResNet with random weights and random BatchNorm
statistics, saved with ``torch.save`` as ``{arch}-{8 hex digits}.pth``,
with a classifier (``fc.``) and ``num_batches_tracked`` counters beside it
as torchvision's files have them.  The JAX side loads the same tensors
with its ``load_state_dict`` and wraps them in ``PyramidBackbone(...,
pretrained=True, frozen_levels=1)`` directly (its ``Backbone(pretrained=
True)`` needs torchvision).  Every level's f32 output agrees to relative
L2 1e-5 (summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu import TIMM_BACKBONE_NAMES as JAX_TIMM_NAMES
from sihl_tpu import TORCHVISION_BACKBONE_NAMES as JAX_TORCHVISION_NAMES
from sihl_tpu.backbones import _TIMM_ALIASES as JAX_TIMM_ALIASES
from sihl_tpu.backbones.base import PyramidBackbone as JaxPyramidBackbone
from sihl_tpu.backbones.resnet import make_resnet_features as jax_make_resnet_features
from sihl_tpu.backbones.torchvision_import import dump_state_dict as jax_dump_state_dict
from sihl_tpu.backbones.torchvision_import import load_state_dict as jax_load_state_dict
from sihl_tpu_torch import TIMM_BACKBONE_NAMES, TORCHVISION_BACKBONE_NAMES, Backbone, TimmBackbone, TorchvisionBackbone
from sihl_tpu_torch.backbones import _TIMM_ALIASES
from sihl_tpu_torch.backbones.resnet import ResNetV2Features, make_resnet_features
from sihl_tpu_torch.backbones.torchvision_import import dump_state_dict, load_state_dict, weights_file
from sihl_tpu_torch.convert import state_dict_from_flat

from torch_parity import flat_state, randomize_norms, to_numpy, to_torch


def write_weights(torch_home, name: str, sd, tag: str = "0123abcd") -> None:
    """``sd`` (numpy arrays or tensors) as torchvision's cached file of
    ``name``, with a classifier and BatchNorm counters beside it."""
    directory = torch_home / "hub" / "checkpoints"
    directory.mkdir(parents=True, exist_ok=True)
    tensors = {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}
    tensors.update({"fc.weight": torch.zeros(10, 4), "fc.bias": torch.zeros(10)})
    tensors.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
                    for k in sd if k.endswith("running_mean")})
    torch.save(tensors, directory / f"{name}-{tag}.pth")


def jax_weights(name: str, seed: int = 0) -> dict:
    """The JAX package's torchvision-format export of a random ResNet whose
    BatchNorms have random statistics and affine parameters."""
    features = jax_make_resnet_features(name, rngs=nnx.Rngs(seed))
    randomize_norms(features, np.random.RandomState(seed))
    return jax_dump_state_dict(features, name)


def _relative_l2(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_pretrained_backbone_matches_jax_importer(name, tmp_path, monkeypatch):
    """The port's ``Backbone(name, pretrained=True, frozen_levels=1)`` reads
    the file, normalises its input and freezes level 1 as JAX's importer
    and ``PyramidBackbone`` do; ``state_dict_from_flat`` maps the JAX
    trunk's state one to one (strict) onto the same tensors."""
    sd = jax_weights(name)
    write_weights(tmp_path, name, sd)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    jax_features = jax_make_resnet_features(name, rngs=nnx.Rngs(1))
    jax_load_state_dict(jax_features, name, sd)
    jax_bb = JaxPyramidBackbone(name, jax_features, pretrained=True, frozen_levels=1, rngs=nnx.Rngs(1))
    jax_bb.eval()
    bb = Backbone(name, pretrained=True, frozen_levels=1, device="cpu").eval()

    assert bb.normalize is not None and jax_bb.normalize is not None
    assert "normalize.mean" not in bb.state_dict()
    from_jax = state_dict_from_flat(flat_state(jax_bb), bb)
    assert sorted(from_jax) == sorted(bb.state_dict())
    assert all(torch.equal(from_jax[k], v) for k, v in bb.state_dict().items())

    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    want = jax_bb(jnp.asarray(x))
    with torch.no_grad():
        got = bb(to_torch(x))
    assert len(got) == len(want) == 6
    np.testing.assert_array_equal(to_numpy(got[0], nhwc=True), x)
    for level, (g, w) in enumerate(zip(got[1:], want[1:]), start=1):
        assert _relative_l2(to_numpy(g, nhwc=True), w) <= 1e-5, level

    assert bb.frozen_levels == jax_bb.frozen_levels == 1 and bb.features._sg_levels == 1
    frozen = {n for n, _ in bb.features.named_parameters() if bb.is_frozen_param(n.split("."))}
    assert frozen == {"stem.conv.weight", "stem.bn.weight", "stem.bn.bias"}
    for n, _ in bb.features.named_parameters():
        assert bb.is_frozen_param(n.split(".")) == jax_bb.is_frozen_param(n.split(".")), n


def test_frozen_levels_need_pretrained():
    """As in the JAX package, ``frozen_levels`` takes effect only with
    ``pretrained``, and no ``Normalize`` runs without it."""
    bb = Backbone("resnet18", frozen_levels=2, device="cpu")
    assert bb.frozen_levels == 0 and bb.features._sg_levels == 0 and bb.normalize is None
    assert tuple(bb.dummy_input.shape) == (1, 3, 64, 64)
    assert len(bb.eval()(bb.dummy_input)) == 6


def test_port_dump_load_round_trip():
    """dump → load in the port: every parameter and buffer bit for bit, and
    the same forward."""
    a = make_resnet_features("resnet18", generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for name, buf in a.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(len(name))) + 0.5)
    b = make_resnet_features("resnet18", generator=torch.Generator().manual_seed(1), device="cpu")
    load_state_dict(b, "resnet18", dump_state_dict(a, "resnet18"))
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        assert all(torch.equal(p, q) for p, q in zip(a.eval()(x), b.eval()(x)))


@pytest.mark.parametrize("fault, match", [
    ("shape", "layer1.0.conv1.weight"),
    ("missing", "missing tensor 'layer2.0.downsample.1.running_var'"),
    ("unconsumed", "unconsumed"),
])
def test_load_refusals(fault, match):
    """A tensor of the wrong shape, a missing tensor and a tensor that no
    module takes (outside ``fc.``) each raise, naming the key."""
    features = make_resnet_features("resnet18", device="cpu")
    sd = dump_state_dict(features, "resnet18")
    if fault == "shape":
        sd["layer1.0.conv1.weight"] = torch.zeros(64, 64, 5, 5)
    elif fault == "missing":
        del sd["layer2.0.downsample.1.running_var"]
    else:
        sd["layer5.0.conv1.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match=match):
        load_state_dict(features, "resnet18", sd)


@pytest.mark.parametrize("tags", [(), ("0123abcd", "89abcdef")], ids=["none", "two"])
def test_weights_file_refuses_missing_or_ambiguous(tags, tmp_path, monkeypatch):
    """No file, or two, for the arch: a ``RuntimeError`` naming the directory
    and the pattern, and nothing downloaded."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    sd = dump_state_dict(make_resnet_features("resnet18", device="cpu"), "resnet18")
    for tag in tags:
        write_weights(tmp_path, "resnet18", sd, tag)
    write_weights(tmp_path, "resnet34", {}, "0123abcd")  # another arch's file matches nothing
    with pytest.raises(RuntimeError, match=r"resnet18-\*\.pth") as info:
        Backbone("resnet18", pretrained=True, device="cpu")
    assert str(tmp_path / "hub" / "checkpoints") in str(info.value)
    assert f"{len(tags)} files match" in str(info.value)
    assert sorted(p.name for p in (tmp_path / "hub" / "checkpoints").iterdir()) == sorted(
        [f"resnet18-{t}.pth" for t in tags] + ["resnet34-0123abcd.pth"])


def test_grayscale_trunk_keeps_its_input_conv(tmp_path, monkeypatch):
    """``input_channels=1``: the file's 3-channel ``conv1`` is skipped (the
    port's own initialisation stays), every other tensor is loaded, and no
    ``Normalize`` is built."""
    sd = jax_weights("resnet18")
    write_weights(tmp_path, "resnet18", sd)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    bb = Backbone("resnet18", pretrained=True, input_channels=1, frozen_levels=1,
                  generator=torch.Generator().manual_seed(3), device="cpu")
    fresh = Backbone("resnet18", input_channels=1, generator=torch.Generator().manual_seed(3), device="cpu")
    assert bb.normalize is None and bb.frozen_levels == 1
    assert torch.equal(bb.features.stem.conv.weight, fresh.features.stem.conv.weight)
    loaded = dump_state_dict(bb.features, "resnet18")
    for k, v in loaded.items():
        if k != "conv1.weight":
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert tuple(bb.eval()(torch.rand(2, 1, 64, 64))[5].shape) == (2, 512, 2, 2)


@pytest.mark.parametrize("name, match", [
    ("efficientnet_b0", "M17"),
    ("mobilenet_v3_large", "M17"),
    ("convnext_tiny", "M17"),
    ("resnetv2_50", "not a torchvision arch"),
    ("vgg16", "not a torchvision arch"),
])
def test_importer_family_refusals(name, match):
    with pytest.raises(NotImplementedError, match=match):
        dump_state_dict(None, name)


def test_backbone_name_tables():
    """The timm table is the JAX package's whole; the public name tuples
    list what the port builds, a subset of the JAX package's; a timm name
    whose family the port lacks raises naming M17."""
    assert _TIMM_ALIASES == JAX_TIMM_ALIASES
    assert set(TIMM_BACKBONE_NAMES) <= set(JAX_TIMM_NAMES)
    assert set(TORCHVISION_BACKBONE_NAMES) <= set(JAX_TORCHVISION_NAMES)
    assert {"resnetv2_50", "resnetv2_101", "resnet50"} <= set(TIMM_BACKBONE_NAMES)
    assert TorchvisionBackbone is Backbone
    with pytest.raises(NotImplementedError, match="M17"):
        TimmBackbone("mobilenetv2_100", device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        TimmBackbone("vit_base_patch16_224", device="cpu")
    with pytest.raises(NotImplementedError, match="not a torchvision arch"):
        TimmBackbone("resnetv2_50", pretrained=True, device="cpu")
    assert isinstance(TimmBackbone("resnetv2_50", device="cpu").features, ResNetV2Features)


def test_weights_file_honours_torch_home(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    write_weights(tmp_path, "resnet50", {}, "11ad3fa6")
    assert weights_file("resnet50") == str(tmp_path / "hub" / "checkpoints" / "resnet50-11ad3fa6.pth")
