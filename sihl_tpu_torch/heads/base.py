"""Head protocol (counterpart of ``sihl_tpu/heads/base.py``).

A head is an ``nn.Module`` with ``output_shapes`` (the static-shape
contract of its outputs), ``forward(inputs)``, the inference path, and
``training_step(inputs, *targets) -> (loss, metrics)``, whose loss and
metrics are f32 scalar tensors computed without a host sync.  Targets are
padded, fixed-shape tensors.  Validation comes with detection eval
(ROADMAP.md, M9).
"""

from typing import Any, Dict, List, Tuple, Union

import torch
from torch import nn

TensorShape = Tuple[Union[str, int], ...]


class Head(nn.Module):
    output_shapes: Dict[str, TensorShape] = {}

    def forward(self, inputs: List[torch.Tensor]) -> Any:
        raise NotImplementedError

    def training_step(self, inputs, *targets) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError
