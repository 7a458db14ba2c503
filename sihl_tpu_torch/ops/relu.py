"""ReLU (counterpart of ``sihl_tpu/ops/relu.py``).

Only the stock op is ported.  The output-mask backward there saves TPU
memory traffic in training and changes no value.
"""

from torch.nn.functional import relu

__all__ = ["relu"]
