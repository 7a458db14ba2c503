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
from sihl_tpu_torch.backbones import _FEATURE_FACTORIES, _TIMM_ALIASES
from sihl_tpu_torch.backbones.resnet import ResNetV2Features, make_resnet_features
from sihl_tpu_torch.backbones.torchvision_import import dump_state_dict, load_state_dict, weights_file
from sihl_tpu_torch.convert import state_dict_from_flat

from torch_parity import flat_state, randomize_norms, to_numpy, to_torch


def write_weights(torch_home, name: str, sd, tag: str = "0123abcd", classifier: str = "fc") -> None:
    """``sd`` (numpy arrays or tensors) as torchvision's cached file of
    ``name``, with a classifier (``fc.`` of a ResNet, ``classifier.1.`` of
    the other families) and BatchNorm counters beside it."""
    directory = torch_home / "hub" / "checkpoints"
    directory.mkdir(parents=True, exist_ok=True)
    tensors = {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}
    tensors.update({f"{classifier}.weight": torch.zeros(10, 4), f"{classifier}.bias": torch.zeros(10)})
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
    ("convnextv2_atto", "not a torchvision arch"),
    ("mobilenetv4_conv_small", "not a torchvision arch"),
    ("dla34", "not a torchvision arch"),
    ("resnetv2_50", "not a torchvision arch"),
    ("efficientnet_lite0", "not a torchvision arch"),
    ("vgg16", "not a torchvision arch"),
])
def test_importer_family_refusals(name, match):
    with pytest.raises(NotImplementedError, match=match):
        dump_state_dict(None, name)


def test_backbone_name_tables():
    """The timm table is the JAX package's whole, and the public name tuples
    equal the JAX package's (77 and 68 names): the inverted-residual
    families, ConvNeXt, MobileNetV4, DenseNet, ShuffleNetV2, DLA and HRNet
    among them."""
    assert _TIMM_ALIASES == JAX_TIMM_ALIASES
    assert TIMM_BACKBONE_NAMES == JAX_TIMM_NAMES and len(TIMM_BACKBONE_NAMES) == 68
    assert TORCHVISION_BACKBONE_NAMES == JAX_TORCHVISION_NAMES and len(TORCHVISION_BACKBONE_NAMES) == 77
    assert {"resnetv2_50", "resnetv2_101", "resnet50", "mobilenetv2_100", "efficientnet_lite0",
            "mnasnet_050"} <= set(TIMM_BACKBONE_NAMES)
    assert {"efficientnet_b7", "efficientnet_v2_l", "mobilenet_v3_small_075", "mnasnet1_3"} <= set(
        TORCHVISION_BACKBONE_NAMES)
    assert TorchvisionBackbone is Backbone
    assert {"convnext_tiny", "convnextv2_atto", "densenet121", "mobilenetv4_conv_small"} <= set(TIMM_BACKBONE_NAMES)
    assert {"convnext_xxlarge", "densenet201", "shufflenet_v2_x2_0", "mobilenetv4_hybrid_large"} <= set(
        TORCHVISION_BACKBONE_NAMES)
    assert {"dla34", "dla169", "hrnet_w18", "hrnet_w64"} <= set(TORCHVISION_BACKBONE_NAMES)
    with pytest.raises(ValueError, match="not supported"):
        TimmBackbone("vit_base_patch16_224", device="cpu")
    with pytest.raises(NotImplementedError, match="not a torchvision arch"):
        TimmBackbone("resnetv2_50", pretrained=True, device="cpu")
    assert isinstance(TimmBackbone("resnetv2_50", device="cpu").features, ResNetV2Features)


def test_weights_file_honours_torch_home(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    write_weights(tmp_path, "resnet50", {}, "11ad3fa6")
    assert weights_file("resnet50") == str(tmp_path / "hub" / "checkpoints" / "resnet50-11ad3fa6.pth")


@pytest.mark.parametrize("name", ["efficientnet_b0", "mobilenet_v3_large", "mnasnet1_0"])
def test_inverted_residual_pretrained_round_trip(name, tmp_path, monkeypatch):
    """A seeded file (random weights, biases and BatchNorm statistics, the
    squeeze-excitation convs' biases among them) → ``Backbone(name,
    pretrained=True, frozen_levels=1)`` → ``dump_state_dict``: every tensor
    equal to the file's; ``Normalize`` in front; level 1 frozen by its
    ``level_modules`` entries, pairs included."""
    gen = torch.Generator().manual_seed(5)
    source = _FEATURE_FACTORIES[name](name, generator=gen, device="cpu")
    with torch.no_grad():
        for key, t in source.state_dict().items():
            if t.dim() == 1:
                t.copy_(torch.rand(t.shape, generator=gen) + (0.5 if key.endswith(("running_var", "bn.weight")) else -0.5))
    sd = dump_state_dict(source, name)
    assert any(k.endswith("fc1.bias") for k in sd) == (name != "mnasnet1_0")
    write_weights(tmp_path, name, sd, classifier="classifier.1")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    bb = Backbone(name, pretrained=True, frozen_levels=1, generator=torch.Generator().manual_seed(9), device="cpu")
    back = dump_state_dict(bb.features, name)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    assert bb.normalize is not None and bb.frozen_levels == 1
    frozen = {n.split(".")[0] if not n.split(".")[1].isdigit() else tuple(n.split(".")[:2])
              for n, _ in bb.features.named_parameters() if bb.is_frozen_param(n.split("."))}
    want = {e if isinstance(e, str) else (e[0], str(e[1])) for e in bb.features.level_modules[0]}
    assert frozen == want
    with torch.no_grad():
        assert all(torch.isfinite(o).all() for o in bb.eval()(torch.rand(1, 3, 64, 64)))


LAST_CLASSIFIERS = {"convnext_tiny": "classifier.2", "densenet121": "classifier", "shufflenet_v2_x1_0": "fc"}


def _seeded_file_tensors(name: str) -> dict:
    """A seeded trunk's torchvision-format export, every 1-D tensor random
    (the BatchNorms' statistics and affine parameters, the LayerNorms', the
    conv and Linear biases, ConvNeXt's layer scale)."""
    gen = torch.Generator().manual_seed(5)
    source = _FEATURE_FACTORIES[name](name, generator=gen, device="cpu")
    with torch.no_grad():
        for key, t in source.state_dict().items():
            if t.dim() == 1:
                t.copy_(torch.rand(t.shape, generator=gen) + (0.5 if key.endswith(("running_var", "weight")) else -0.5))
    return dump_state_dict(source, name)


@pytest.mark.parametrize("name", sorted(LAST_CLASSIFIERS))
def test_last_families_pretrained_round_trip(name, tmp_path, monkeypatch):
    """A seeded file in torchvision's layout (its classifier under the
    family's key; a DenseNet's ``features.norm5`` beside it, which no level
    reads) → ``Backbone(name, pretrained=True, frozen_levels=1)`` →
    ``dump_state_dict``: every tensor equal to the file's (ConvNeXt's layer
    scale (C, 1, 1) both ways); ``Normalize`` in front; level 1 frozen by its
    ``level_modules`` entries."""
    sd = _seeded_file_tensors(name)
    if name == "convnext_tiny":
        assert sd["features.1.0.layer_scale"].shape == (96, 1, 1)
    file_sd = dict(sd)
    if name.startswith("densenet"):
        file_sd.update({f"features.norm5.{k}": torch.rand(1024) + 0.5
                        for k in ("weight", "bias", "running_mean", "running_var")})
    write_weights(tmp_path, name, file_sd, classifier=LAST_CLASSIFIERS[name])
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    bb = Backbone(name, pretrained=True, frozen_levels=1, generator=torch.Generator().manual_seed(9), device="cpu")
    back = dump_state_dict(bb.features, name)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    assert bb.normalize is not None and bb.frozen_levels == 1
    frozen = {n.split(".")[0] for n, _ in bb.features.named_parameters() if bb.is_frozen_param(n.split("."))}
    assert frozen == set(bb.features.level_modules[0])
    with torch.no_grad():
        out = bb.eval()(torch.rand(1, 3, 64, 64))
    assert all(torch.isfinite(o).all() for o in out) and len(out) == 6


def test_densenet_file_with_an_unknown_tensor_is_refused(tmp_path, monkeypatch):
    """``norm5`` and the classifier are skipped by name; any other tensor the
    walker does not take still raises."""
    sd = _seeded_file_tensors("densenet121")
    sd["features.norm6.weight"] = torch.ones(1024)
    write_weights(tmp_path, "densenet121", sd, classifier="classifier")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="unconsumed"):
        Backbone("densenet121", pretrained=True, device="cpu")


def test_grayscale_convnext_keeps_its_stem_weight_and_bias(tmp_path, monkeypatch):
    """``input_channels=1`` on convnext_tiny: the file's 3-channel stem conv,
    weight and bias, counts as consumed and is not loaded (the port's own
    initialisation stays); every other tensor is loaded; no ``Normalize``."""
    sd = _seeded_file_tensors("convnext_tiny")
    write_weights(tmp_path, "convnext_tiny", sd, classifier="classifier.2")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    bb = Backbone("convnext_tiny", pretrained=True, input_channels=1, frozen_levels=1,
                  generator=torch.Generator().manual_seed(3), device="cpu")
    fresh = Backbone("convnext_tiny", input_channels=1, generator=torch.Generator().manual_seed(3), device="cpu")
    assert bb.normalize is None and bb.frozen_levels == 1
    assert torch.equal(bb.features.stem_conv.weight, fresh.features.stem_conv.weight)
    assert torch.equal(bb.features.stem_conv.bias, fresh.features.stem_conv.bias)
    assert not torch.equal(bb.features.stem_conv.bias, sd["features.0.0.bias"])
    loaded = dump_state_dict(bb.features, "convnext_tiny")
    for k, v in loaded.items():
        if not k.startswith("features.0.0."):
            assert torch.equal(v, sd[k]), k
    with torch.no_grad():
        assert tuple(bb.eval()(torch.rand(2, 1, 64, 64))[5].shape) == (2, 768, 2, 2)
