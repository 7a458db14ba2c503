"""torchvision-format weights into the port's feature nets (counterpart of
``sihl_tpu/backbones/torchvision_import.py``).

torchvision's layout is PyTorch's, so no axis moves: a conv weight is
(O, I, H, W) on both sides, and each tensor is copied as it is into the
parameter or buffer that the walker names.

A family's layout is written once as a *walker* that yields
``(kind, port_module, torchvision_key)`` specs; :func:`load_state_dict`
applies them, checking every shape, raising on a missing tensor and on
tensors left unconsumed outside the classifier, and :func:`dump_state_dict`
is its exact inverse (a torchvision-format export).  The port walks the
ResNet family (resnet, resnext, wide_resnet); the other torchvision
families come with their feature nets (ROADMAP.md, M17).

:func:`load_torchvision_weights` reads the file that torchvision keeps in
its cache, ``torch.hub.get_dir()/checkpoints/{arch}-{hash}.pth`` (under
``TORCH_HOME`` where that is set), and downloads nothing.
"""

import glob
import os
from typing import Dict, Iterator, Tuple

import torch
from torch import nn

Spec = Tuple[str, nn.Module, str]

# -- walkers ------------------------------------------------------------------
# Spec kinds: "conv" (a conv without bias), "conv_first" (the input conv,
# skipped when input_channels != 3) and "bn" (a BatchNorm: weight, bias and
# running statistics).


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


_FAMILIES = ((("resnet", "resnext", "wide_resnet"), _walk_resnet, ("fc.",)),)
# torchvision families whose feature nets the port does not build yet
_LATER_FAMILIES = ("efficientnet_", "mobilenet_", "convnext_", "densenet", "shufflenet_v2", "mnasnet")
# timm's pre-activation ResNets share the "resnet" prefix but are no torchvision arch
_NOT_TORCHVISION = ("resnetv2_",)


def _family(name: str):
    if not name.startswith(_NOT_TORCHVISION):
        for prefixes, walker, skip in _FAMILIES:
            if name.startswith(prefixes):
                return walker, skip
    if name.startswith(_LATER_FAMILIES):
        raise NotImplementedError(
            f"weight import for {name} waits for its feature net in the port (ROADMAP.md, M17)"
        )
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
    weights and its torchvision tensors count as consumed."""
    walker, skip_prefixes = _family(name)
    used = set()

    def put(dst: torch.Tensor, key: str) -> None:
        used.add(key)
        if key not in sd:
            raise RuntimeError(f"weight import for {name}: missing tensor {key!r} (torchvision layout mismatch?)")
        t = torch.as_tensor(sd[key])
        if tuple(t.shape) != tuple(dst.shape):
            raise RuntimeError(
                f"weight import for {name}: {key!r} has shape {tuple(t.shape)}, "
                f"the port's module expects {tuple(dst.shape)}"
            )
        dst.copy_(t)

    for kind, dst, key in walker(features):
        if kind == "conv_first" and input_channels != 3:
            used.add(f"{key}.weight")
            continue
        if kind in ("conv", "conv_first"):
            put(dst.weight, f"{key}.weight")
        elif kind == "bn":
            put(dst.weight, f"{key}.weight")
            put(dst.bias, f"{key}.bias")
            put(dst.running_mean, f"{key}.running_mean")
            put(dst.running_var, f"{key}.running_var")
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
        if kind in ("conv", "conv_first"):
            sd[f"{key}.weight"] = take(dst.weight)
        elif kind == "bn":
            sd[f"{key}.weight"] = take(dst.weight)
            sd[f"{key}.bias"] = take(dst.bias)
            sd[f"{key}.running_mean"] = take(dst.running_mean)
            sd[f"{key}.running_var"] = take(dst.running_var)
    return sd
