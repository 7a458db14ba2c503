"""Weight bridge from the JAX package to the port.

The port's module attributes mirror the nnx attribute paths, so the map is
mechanical: only the leaf name and, for kernels, the axis order change.
"""

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import ConvTranspose2d
from sihl_tpu_torch.layers.transformer import MergeHeadsLinear, SplitHeadsLinear

_LEAF_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# plain ``nnx.Variable`` leaves that the port keeps as buffers of the same
# name and dtype: the panoptic head's step counter (int32); the anomaly
# head's calibration scalars, reservoirs (f32) and their position and fill
# (int32)
VARIABLE_LEAVES = frozenset({
    "step_counter", "local_thresh", "global_thresh", "q_st_start", "q_st_end", "q_ae_start", "q_ae_end",
    "st_reservoir", "stae_reservoir", "reservoir_pos", "reservoir_filled",
})
# ``nnx.Variable`` leaves of shape (1, 1, 1, C), which the port keeps as
# (1, C, 1, 1) buffers: the anomaly head's teacher statistics
NHWC_VARIABLE_LEAVES = frozenset({"features_mean", "feature_std"})


def state_dict_from_flat(
    flat: Dict[str, np.ndarray], module: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Turn the ``nnx.Param`` and ``nnx.BatchStat`` leaves of a JAX model,
    and its variables named below, as numpy arrays under dotted nnx
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
    * attention kernels (the ``LinearGeneral`` projections of
      ``nnx.MultiHeadAttention``), of rank 3, by the port's module at their
      path: a query, key or value projection (:class:`SplitHeadsLinear`),
      (in, heads, head_dim) → ``weight`` (heads * head_dim, in); the output
      projection (:class:`MergeHeadsLinear`), (heads, head_dim, out) →
      ``weight`` (out, heads * head_dim).  Both readings fit a square
      kernel's shape, so a rank-3 kernel needs ``module``;
    * attention projection ``bias`` (heads, head_dim) → ``bias``
      (heads * head_dim,);
    * ``MetricLearning``'s root ``weight`` (subcentres, embedding,
      identities) → ``weight``, as is;
    * BatchNorm ``scale/bias/mean/var`` → ``weight/bias/running_mean/running_var``;
    * GroupNorm and LayerNorm ``scale/bias`` → ``weight/bias``;
    * BiFPN ``FastNormalizedFusion`` ``weights`` (1-D) → ``weights``, as is;
    * bare 1-D ``gamma`` and ``beta`` leaves (ConvNeXt's layer scale, GRN's
      scale and shift) → parameters of the same name, as they are;
    * the ``nnx.Variable`` leaves of :data:`VARIABLE_LEAVES` (the panoptic
      head's ``step_counter``, the anomaly head's calibration, reservoirs
      and their int32 position and fill) → buffers of the same name, their
      shape and dtype kept;
    * the anomaly head's ``features_mean`` and ``feature_std`` (1, 1, 1, C)
      → buffers (1, C, 1, 1).

    Without ``module`` every 4-D kernel takes the conv rule: a transposed
    conv's weight then comes out in the conv's axis order, which
    ``load_state_dict`` refuses on its shape unless its input and output
    channels are equal; and a rank-3 kernel raises.

    The JAX modules' ``RngKey`` / ``RngCount`` leaves (a dropout's, an
    attention's) have no counterpart here: leave them out of ``flat``.
    """
    modules = {} if module is None else dict(module.named_modules())
    out = {}
    for path, value in flat.items():
        prefix, _, leaf = path.rpartition(".")
        if leaf in VARIABLE_LEAVES:
            out[path] = torch.from_numpy(np.array(value, order="C"))
            continue
        if leaf in NHWC_VARIABLE_LEAVES:
            out[path] = torch.from_numpy(np.array(np.asarray(value).transpose(0, 3, 1, 2), order="C"))
            continue
        value = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            sub = modules.get(prefix)
            if value.ndim == 4 and isinstance(sub, ConvTranspose2d):
                value = value[::-1, ::-1].transpose(2, 3, 0, 1)
            elif value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 2:
                value = value.T
            elif value.ndim == 3 and isinstance(sub, SplitHeadsLinear):
                value = value.reshape(value.shape[0], -1).T
            elif value.ndim == 3 and isinstance(sub, MergeHeadsLinear):
                value = value.reshape(-1, value.shape[2]).T
            elif value.ndim == 3:
                raise ValueError(f"{path}: a rank-3 kernel needs the port's module to tell an attention input "
                                 f"projection from an output projection")
            else:
                raise ValueError(f"{path}: kernel of rank {value.ndim}")
            name = "weight"
        elif leaf == "bias" and value.ndim == 2:
            value, name = value.reshape(-1), "bias"
        elif leaf == "weight" and value.ndim == 3:
            name = "weight"
        elif leaf in _LEAF_NAMES:
            name = _LEAF_NAMES[leaf]
        elif leaf == "weights" and value.ndim == 1:
            name = "weights"
        elif leaf in ("gamma", "beta") and value.ndim == 1:
            name = leaf
        else:
            raise KeyError(f"{path}: no counterpart for leaf {leaf!r}")
        key = f"{prefix}.{name}" if prefix else name
        out[key] = torch.from_numpy(np.array(value, order="C"))
    return out
