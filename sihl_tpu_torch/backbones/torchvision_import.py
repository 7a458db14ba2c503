"""torchvision-format weights into the port's feature nets (counterpart of
``sihl_tpu/backbones/torchvision_import.py``).

torchvision's layout is PyTorch's, so no axis moves: a conv weight is
(O, I, H, W) on both sides, and each tensor is copied as it is into the
parameter or buffer that the walker names.

A family's layout is written once as a *walker* that yields
``(kind, port_module, torchvision_key)`` specs; :func:`load_state_dict`
applies them, checking every shape, raising on a missing tensor and on
tensors left unconsumed outside the classifier, and :func:`dump_state_dict`
is its exact inverse (a torchvision-format export).  The port walks every
torchvision family of the JAX package: the ResNet family (resnet, resnext,
wide_resnet), EfficientNet B0-B7 and V2, MobileNet v2 and v3, ConvNeXt,
DenseNet, ShuffleNetV2 and MNASNet.  A size without a torchvision file
(``mobilenet_v2_050``, timm's ``convnext_atto``) walks like its family and
finds no file to load.

:func:`load_torchvision_weights` reads the file that torchvision keeps in
its cache, ``torch.hub.get_dir()/checkpoints/{arch}-{hash}.pth`` (under
``TORCH_HOME`` where that is set), and downloads nothing.
"""

import glob
import os
from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from sihl_tpu_torch.backbones.efficientnet import MBConv

Spec = Tuple[str, nn.Module, str]

# -- walkers ------------------------------------------------------------------
# Spec kinds: "conv" (a conv without bias), "convb" (a conv with a bias),
# "conv_first" and "convb_first" (the input conv, skipped when
# input_channels != 3), "bn" (a BatchNorm: weight, bias and running
# statistics), "ln" (a LayerNorm: weight and bias), "linear" (a Linear:
# weight (out, in) and bias) and "param" (a bare parameter, stored by
# torchvision in another shape of the same size: ConvNeXt's (C, 1, 1)
# layer scale).


def _cna(dst, prefix: str) -> Iterator[Spec]:
    """torchvision's ``Conv2dNormActivation``: ``{prefix}.0`` conv, ``.1`` bn."""
    yield ("conv", dst.conv, f"{prefix}.0")
    yield ("bn", dst.bn, f"{prefix}.1")


def _walk_resnet(features) -> Iterator[Spec]:
    yield ("conv_first", features.stem.conv, "conv1")
    yield ("bn", features.stem.bn, "bn1")
    layers = [features.layer1, features.layer2, features.layer3, features.layer4]
    for i, layer in enumerate(layers, start=1):
        for j, block in enumerate(layer.blocks):
            p = f"layer{i}.{j}"
            num_convs = 3 if hasattr(block, "conv3") else 2
            for k in range(1, num_convs + 1):
                cb = getattr(block, f"conv{k}")
                yield ("conv", cb.conv, f"{p}.conv{k}")
                yield ("bn", cb.bn, f"{p}.bn{k}")
            if block.downsample is not None:
                yield ("conv", block.downsample.conv, f"{p}.downsample.0")
                yield ("bn", block.downsample.bn, f"{p}.downsample.1")


def _walk_efficientnet(features) -> Iterator[Spec]:
    """``features.0`` the stem; ``features.{1..N}`` the stages, each block's
    layers under ``.block``; ``features.{N+1}`` the 1x1 head."""
    yield ("conv_first", features.stem.conv, "features.0.0")
    yield ("bn", features.stem.bn, "features.0.1")
    for si, stage in enumerate(features.stages, start=1):
        for bi, block in enumerate(stage.blocks):
            p = f"features.{si}.{bi}.block"
            if isinstance(block, MBConv):
                idx = 0
                if block.expand is not None:
                    yield from _cna(block.expand, f"{p}.{idx}")
                    idx += 1
                yield from _cna(block.depthwise, f"{p}.{idx}")
                idx += 1
                if block.se is not None:
                    yield ("convb", block.se.fc1, f"{p}.{idx}.fc1")
                    yield ("convb", block.se.fc2, f"{p}.{idx}.fc2")
                    idx += 1
                yield from _cna(block.project, f"{p}.{idx}")
            else:  # FusedMBConv
                yield from _cna(block.fused, f"{p}.0")
                if block.project is not None:
                    yield from _cna(block.project, f"{p}.1")
    yield from _cna(features.head, f"features.{len(features.stages) + 1}")


def _walk_mobilenet_v2(features) -> Iterator[Spec]:
    """Blocks at ``features.{1..17}.conv``: [expand,] depthwise, then the
    projection's bare conv and bn as the last two entries."""
    yield ("conv_first", features.stem.conv, "features.0.0")
    yield ("bn", features.stem.bn, "features.0.1")
    for i, block in enumerate(features.blocks, start=1):
        p = f"features.{i}.conv"
        idx = 0
        if block.expand is not None:
            yield from _cna(block.expand, f"{p}.{idx}")
            idx += 1
        yield from _cna(block.depthwise, f"{p}.{idx}")
        idx += 1
        yield ("conv", block.project.conv, f"{p}.{idx}")
        yield ("bn", block.project.bn, f"{p}.{idx + 1}")
    yield from _cna(features.head, f"features.{len(features.blocks) + 1}")


def _walk_mobilenet_v3(features) -> Iterator[Spec]:
    yield ("conv_first", features.stem.conv, "features.0.0")
    yield ("bn", features.stem.bn, "features.0.1")
    for i, block in enumerate(features.blocks, start=1):
        p = f"features.{i}.block"
        idx = 0
        if block.expand is not None:
            yield from _cna(block.expand, f"{p}.{idx}")
            idx += 1
        yield from _cna(block.depthwise, f"{p}.{idx}")
        idx += 1
        if block.se is not None:
            yield ("convb", block.se.fc1, f"{p}.{idx}.fc1")
            yield ("convb", block.se.fc2, f"{p}.{idx}.fc2")
            idx += 1
        yield from _cna(block.project, f"{p}.{idx}")
    yield from _cna(features.head, f"features.{len(features.blocks) + 1}")


def _walk_convnext(features) -> Iterator[Spec]:
    """``features.0`` the stem (conv with a bias, LayerNorm); odd indices the
    stages of CNBlocks (``block.{0,2,3,5}`` and ``layer_scale``); even
    indices from 2 the downsamples (LayerNorm, 2x2 conv)."""
    yield ("convb_first", features.stem_conv, "features.0.0")
    yield ("ln", features.stem_norm, "features.0.1")
    for si, stage in enumerate(features.stages):
        fi = 1 + 2 * si
        if si > 0:
            ds = features.downsamples[si - 1]
            yield ("ln", ds.norm, f"features.{fi - 1}.0")
            yield ("convb", ds.conv, f"features.{fi - 1}.1")
        for bi, block in enumerate(stage):
            p = f"features.{fi}.{bi}"
            yield ("convb", block.depthwise, f"{p}.block.0")
            yield ("ln", block.norm, f"{p}.block.2")
            yield ("linear", block.pw1, f"{p}.block.3")
            yield ("linear", block.pw2, f"{p}.block.5")
            yield ("param", block.gamma, f"{p}.layer_scale")


def _walk_densenet(features) -> Iterator[Spec]:
    """``features.conv0`` / ``norm0``, each dense layer under
    ``features.denseblock{i}.denselayer{j}``, the transitions under
    ``features.transition{i}``; ``norm5`` is no level's (skipped)."""
    yield ("conv_first", features.conv0, "features.conv0")
    yield ("bn", features.norm0, "features.norm0")
    for bi, block in enumerate(features.blocks, start=1):
        for li, layer in enumerate(block.layers, start=1):
            p = f"features.denseblock{bi}.denselayer{li}"
            yield ("bn", layer.norm1, f"{p}.norm1")
            yield ("conv", layer.conv1, f"{p}.conv1")
            yield ("bn", layer.norm2, f"{p}.norm2")
            yield ("conv", layer.conv2, f"{p}.conv2")
    for ti, trans in enumerate(features.transitions, start=1):
        yield ("bn", trans.norm, f"features.transition{ti}.norm")
        yield ("conv", trans.conv, f"features.transition{ti}.conv")


def _walk_shufflenet(features) -> Iterator[Spec]:
    """``conv1.{0,1}``, the units under ``stage{2,3,4}.{j}`` (``branch1.{0..3}``
    of a stride-2 unit, ``branch2.{0,1,3,4,5,6}``), ``conv5.{0,1}``."""
    yield ("conv_first", features.conv1.conv, "conv1.0")
    yield ("bn", features.conv1.bn, "conv1.1")
    for si, stage in enumerate(features.stages, start=2):
        for ui, unit in enumerate(stage):
            p = f"stage{si}.{ui}"
            if unit.branch1_dw is not None:
                yield ("conv", unit.branch1_dw.conv, f"{p}.branch1.0")
                yield ("bn", unit.branch1_dw.bn, f"{p}.branch1.1")
                yield ("conv", unit.branch1_pw.conv, f"{p}.branch1.2")
                yield ("bn", unit.branch1_pw.bn, f"{p}.branch1.3")
            yield ("conv", unit.branch2_pw1.conv, f"{p}.branch2.0")
            yield ("bn", unit.branch2_pw1.bn, f"{p}.branch2.1")
            yield ("conv", unit.branch2_dw.conv, f"{p}.branch2.3")
            yield ("bn", unit.branch2_dw.bn, f"{p}.branch2.4")
            yield ("conv", unit.branch2_pw2.conv, f"{p}.branch2.5")
            yield ("bn", unit.branch2_pw2.bn, f"{p}.branch2.6")
    yield ("conv", features.conv5.conv, "conv5.0")
    yield ("bn", features.conv5.bn, "conv5.1")


def _walk_mnasnet(features) -> Iterator[Spec]:
    """torchvision's flat ``layers.{0..16}``: the stem's conv and bn at 0 and
    1, the separable depthwise at 3 and 4, the projection at 6 and 7, the
    stacks at 8-13 (each unit's ``layers.{0,1,3,4,6,7}``), the head at 14
    and 15."""
    yield ("conv_first", features.stem.conv, "layers.0")
    yield ("bn", features.stem.bn, "layers.1")
    yield ("conv", features.sep_dw.conv, "layers.3")
    yield ("bn", features.sep_dw.bn, "layers.4")
    yield ("conv", features.sep_pw.conv, "layers.6")
    yield ("bn", features.sep_pw.bn, "layers.7")
    for si, stack in enumerate(features.stacks, start=8):
        for ui, unit in enumerate(stack):
            p = f"layers.{si}.{ui}.layers"
            for dst, base in ((unit.expand, 0), (unit.depthwise, 3), (unit.project, 6)):
                yield ("conv", dst.conv, f"{p}.{base}")
                yield ("bn", dst.bn, f"{p}.{base + 1}")
    yield ("conv", features.head.conv, "layers.14")
    yield ("bn", features.head.bn, "layers.15")


_FAMILIES = (
    (("resnet", "resnext", "wide_resnet"), _walk_resnet, ("fc.",)),
    (("efficientnet_b", "efficientnet_v2"), _walk_efficientnet, ("classifier.",)),
    (("mobilenet_v2",), _walk_mobilenet_v2, ("classifier.",)),
    (("mobilenet_v3",), _walk_mobilenet_v3, ("classifier.",)),
    (("convnext_",), _walk_convnext, ("classifier.",)),
    (("densenet",), _walk_densenet, ("classifier.", "features.norm5.")),
    (("shufflenet_v2",), _walk_shufflenet, ("fc.",)),
    (("mnasnet",), _walk_mnasnet, ("classifier.",)),
)
# timm's pre-activation ResNets share the "resnet" prefix but are no torchvision arch
_NOT_TORCHVISION = ("resnetv2_",)


def _family(name: str):
    if not name.startswith(_NOT_TORCHVISION):
        for prefixes, walker, skip in _FAMILIES:
            if name.startswith(prefixes):
                return walker, skip
    raise NotImplementedError(f"weight import not implemented for {name} (not a torchvision arch)")


# -- load ---------------------------------------------------------------------


def weights_file(name: str) -> str:
    """The one cached torchvision file of ``name``: ``{name}-*.pth`` in
    ``torch.hub.get_dir()/checkpoints``.  Raises where none or several
    match; never downloads."""
    directory = os.path.join(torch.hub.get_dir(), "checkpoints")
    pattern = f"{name}-*.pth"
    found = sorted(glob.glob(os.path.join(glob.escape(directory), pattern)))
    if len(found) != 1:
        listed = sorted(os.listdir(directory)) if os.path.isdir(directory) else "no such directory"
        raise RuntimeError(
            f"pretrained weights for {name!r}: {len(found)} files match {pattern!r} in {directory} "
            f"({[os.path.basename(f) for f in found] or listed}); place exactly one torchvision file there "
            f"(TORCH_HOME sets the directory), nothing is downloaded"
        )
    return found[0]


def load_torchvision_weights(features: nn.Module, name: str, input_channels: int = 3) -> None:
    """Load ``name``'s cached torchvision file (:func:`weights_file`) into
    ``features``."""
    _family(name)  # an arch with no walker raises before any file is looked for
    sd = torch.load(weights_file(name), weights_only=True, map_location="cpu")
    load_state_dict(features, name, sd, input_channels)


@torch.no_grad()
def load_state_dict(features: nn.Module, name: str, sd, input_channels: int = 3) -> None:
    """Apply a torchvision-format state dict (tensors or numpy arrays) to a
    port feature net; raises on a shape mismatch, a missing tensor, or
    tensors left unconsumed outside the classifier (``num_batches_tracked``
    aside).  With ``input_channels != 3`` the input conv keeps its own
    weights (and bias) and its torchvision tensors count as consumed."""
    walker, skip_prefixes = _family(name)
    used = set()

    def put(dst: torch.Tensor, key: str, by_count: bool = False) -> None:
        """Copy ``sd[key]`` into ``dst``, of the same shape or (``by_count``)
        of as many elements."""
        used.add(key)
        if key not in sd:
            raise RuntimeError(f"weight import for {name}: missing tensor {key!r} (torchvision layout mismatch?)")
        t = torch.as_tensor(sd[key])
        if (t.numel() != dst.numel()) if by_count else (tuple(t.shape) != tuple(dst.shape)):
            raise RuntimeError(
                f"weight import for {name}: {key!r} has shape {tuple(t.shape)}, "
                f"the port's module expects {tuple(dst.shape)}"
            )
        dst.copy_(t.reshape(dst.shape))

    for kind, dst, key in walker(features):
        if kind.endswith("_first") and input_channels != 3:
            used.add(f"{key}.weight")
            if kind == "convb_first":
                used.add(f"{key}.bias")
            continue
        if kind in ("conv", "convb", "conv_first", "convb_first", "linear", "ln"):
            put(dst.weight, f"{key}.weight")
            if kind not in ("conv", "conv_first"):
                put(dst.bias, f"{key}.bias")
        elif kind == "bn":
            put(dst.weight, f"{key}.weight")
            put(dst.bias, f"{key}.bias")
            put(dst.running_mean, f"{key}.running_mean")
            put(dst.running_var, f"{key}.running_var")
        elif kind == "param":
            put(dst, key, by_count=True)
        else:  # pragma: no cover
            raise AssertionError(kind)

    left = [
        k for k in sd
        if k not in used and not k.startswith(skip_prefixes) and not k.endswith("num_batches_tracked")
    ]
    if left:
        raise RuntimeError(
            f"weight import for {name} left {len(left)} unconsumed tensors, "
            f"layout mismatch? e.g. {sorted(left)[:8]}"
        )


# -- dump (torchvision-format export) ----------------------------------------


@torch.no_grad()
def dump_state_dict(features: nn.Module, name: str) -> Dict[str, torch.Tensor]:
    """A port feature net's weights in torchvision's state-dict format, as
    contiguous CPU tensors (the exact inverse of :func:`load_state_dict`)."""
    walker, _ = _family(name)
    sd: Dict[str, torch.Tensor] = {}

    def take(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True).contiguous()

    for kind, dst, key in walker(features):
        if kind in ("conv", "convb", "conv_first", "convb_first", "linear", "ln"):
            sd[f"{key}.weight"] = take(dst.weight)
            if kind not in ("conv", "conv_first"):
                sd[f"{key}.bias"] = take(dst.bias)
        elif kind == "bn":
            sd[f"{key}.weight"] = take(dst.weight)
            sd[f"{key}.bias"] = take(dst.bias)
            sd[f"{key}.running_mean"] = take(dst.running_mean)
            sd[f"{key}.running_var"] = take(dst.running_var)
        elif kind == "param":  # torchvision keeps the layer scale as (C, 1, 1)
            sd[key] = take(dst).reshape(-1, 1, 1)
    return sd
