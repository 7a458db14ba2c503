"""Head protocol (counterpart of ``sihl_tpu/heads/base.py``).

A head is an ``nn.Module`` with ``output_shapes`` (the static-shape
contract of its outputs), ``forward(inputs)``, the inference path, and
``training_step(inputs, *targets) -> (loss, metrics)``, whose loss and
metrics are f32 scalar tensors computed without a host sync.  Targets are
padded, fixed-shape tensors.

Validation is the JAX package's functional triple: ``metrics_init() ->
state`` (sums on the head's device, ``sihl_tpu_torch.training.metrics``),
``validation_step(state, inputs, *targets) -> (state, loss, aux)``, run
under ``torch.no_grad()`` in eval mode, and ``validation_end(state,
collected) -> dict``, where ``collected`` is the host-side (numpy) list of
each batch's ``aux``, for metrics such as COCO mAP that do not accumulate
in fixed-shape device state.
"""

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import SequentialConvBlocks, default_generator, make_conv

TensorShape = Tuple[Union[str, int], ...]


class Head(nn.Module):
    output_shapes: Dict[str, TensorShape] = {}

    def forward(self, inputs: List[torch.Tensor]) -> Any:
        raise NotImplementedError

    def training_step(self, inputs, *targets) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def metrics_init(self):
        return {}

    def validation_step(self, state, inputs, *targets):
        loss, metrics = self.training_step(inputs, *targets)
        return state, loss, metrics

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        """``collected`` is the host-side list of per-batch ``aux`` dicts
        returned by ``validation_step``, their tensors as numpy arrays."""
        return {}

    def _device(self) -> torch.device:
        """The device of the head's parameters, where its metric states live."""
        return next(self.parameters()).device


class GlobalPoolReadout(nn.Module):
    """Conv tower → 1x1 conv → the mean over H and W, shared by the
    classification heads: (B, C, H, W) → (B, num_outputs) in the compute
    dtype."""

    def __init__(
        self,
        in_channels: int,
        num_channels: int,
        num_outputs: int,
        num_layers: int,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        generator = default_generator(generator)
        self.convs = SequentialConvBlocks(
            in_channels, num_channels, num_layers, generator=generator, device=device
        )
        self.out_conv = make_conv(num_channels, num_outputs, 1, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_conv(self.convs(x)).mean(dim=(2, 3))
