"""Weight bridge from the JAX package to the port.

The port's module attributes mirror the nnx attribute paths, so the map is
mechanical: only the leaf name and, for kernels, the axis order change.
"""

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import ConvTranspose2d

_LEAF_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# plain ``nnx.Variable`` leaves that the port keeps as buffers of the same
# name and dtype: the panoptic head's step counter (int32)
_VARIABLE_LEAVES = {"step_counter"}


def state_dict_from_flat(
    flat: Dict[str, np.ndarray], module: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Turn the ``nnx.Param`` and ``nnx.BatchStat`` leaves of a JAX model,
    and its ``step_counter`` variables, as numpy arrays under dotted nnx
    paths (``"neck.smooth.0.conv.kernel"``), into a state dict for the
    port's ``load_state_dict(strict=True)``.

    * conv ``kernel`` (H, W, I, O) → ``weight`` (O, I, H, W);
    * transposed-conv ``kernel`` (H, W, I, O) → ``weight`` (I, O, H, W),
      flipped in space (flax's ``ConvTranspose`` correlates the dilated
      input with its kernel, ``F.conv_transpose2d`` with the kernel flipped
      in space): the rule for every kernel
      whose path names a :class:`ConvTranspose2d` of ``module``, the port's
      module that the state dict is for;
    * Linear ``kernel`` (in, out) → ``weight`` (out, in);
    * BatchNorm ``scale/bias/mean/var`` → ``weight/bias/running_mean/running_var``;
    * GroupNorm and LayerNorm ``scale/bias`` → ``weight/bias``;
    * BiFPN ``FastNormalizedFusion`` ``weights`` (1-D) → ``weights``, as is;
    * ``step_counter`` (an ``nnx.Variable``, int32) → the buffer
      ``step_counter``, its dtype kept.

    Without ``module`` every 4-D kernel takes the conv rule: a transposed
    conv's weight then comes out in the conv's axis order, which
    ``load_state_dict`` refuses on its shape unless its input and output
    channels are equal.
    """
    transposed = set() if module is None else {
        name for name, sub in module.named_modules() if isinstance(sub, ConvTranspose2d)
    }
    out = {}
    for path, value in flat.items():
        prefix, _, leaf = path.rpartition(".")
        if leaf in _VARIABLE_LEAVES:
            out[path] = torch.from_numpy(np.array(value, order="C"))
            continue
        value = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if value.ndim == 4 and prefix in transposed:
                value = value[::-1, ::-1].transpose(2, 3, 0, 1)
            elif value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 2:
                value = value.T
            else:
                raise ValueError(f"{path}: kernel of rank {value.ndim}")
            name = "weight"
        elif leaf in _LEAF_NAMES:
            name = _LEAF_NAMES[leaf]
        elif leaf == "weights" and value.ndim == 1:
            name = "weights"
        else:
            raise KeyError(f"{path}: no counterpart for leaf {leaf!r}")
        key = f"{prefix}.{name}" if prefix else name
        out[key] = torch.from_numpy(np.array(value, order="C"))
    return out
