"""Head protocol (counterpart of ``sihl_tpu/heads/base.py``).

A head is an ``nn.Module`` with ``output_shapes`` (the static-shape
contract of its outputs) and ``forward(inputs)``, the inference path.
Training and validation come with the training slice.
"""

from typing import Any, Dict, List, Tuple, Union

import torch
from torch import nn

TensorShape = Tuple[Union[str, int], ...]


class Head(nn.Module):
    output_shapes: Dict[str, TensorShape] = {}

    def forward(self, inputs: List[torch.Tensor]) -> Any:
        raise NotImplementedError

    def training_step(self, inputs, *targets):
        raise NotImplementedError(
            "training steps come with the training slice (ROADMAP.md, M1 and M5)"
        )
