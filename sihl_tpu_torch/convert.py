"""Weight bridge from the JAX package to the port.

The port's module attributes mirror the nnx attribute paths, so the map is
mechanical: only the leaf name and, for kernels, the axis order change.
"""

from typing import Dict

import numpy as np
import torch

_LEAF_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def state_dict_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Turn the ``nnx.Param`` and ``nnx.BatchStat`` leaves of a JAX model,
    as numpy arrays under dotted nnx paths (``"neck.smooth.0.conv.kernel"``),
    into a state dict for the port's ``load_state_dict(strict=True)``.

    * conv ``kernel`` (H, W, I, O) → ``weight`` (O, I, H, W);
    * Linear ``kernel`` (in, out) → ``weight`` (out, in);
    * BatchNorm ``scale/bias/mean/var`` → ``weight/bias/running_mean/running_var``;
    * LayerNorm ``scale/bias`` → ``weight/bias``;
    * BiFPN ``FastNormalizedFusion`` ``weights`` (1-D) → ``weights``, as is.
    """
    out = {}
    for path, value in flat.items():
        prefix, _, leaf = path.rpartition(".")
        value = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if value.ndim == 4:
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
