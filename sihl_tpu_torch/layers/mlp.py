"""MLP (counterpart of ``sihl_tpu/layers/mlp.py``): each hidden layer is
Linear → LayerNorm (eps 1e-5) → SiLU and the final layer is a bare Linear;
``final_bias_init`` sets the last bias (the loc head's -5)."""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sihl_tpu_torch.layers.convblocks import default_generator, lecun_normal
from sihl_tpu_torch.policy import compute_dtype, resolve_device, upcast


class Linear(nn.Module):
    """``x @ W.T + b`` with input, weight and bias cast to the compute dtype
    (as flax's ``nnx.Linear(dtype=...)`` does); ``bias=False`` leaves ``b``
    out (``use_bias=False``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *, generator, device=None):
        super().__init__()
        self.dtype = compute_dtype()
        device = resolve_device(device)
        weight = lecun_normal((out_features, in_features), in_features, generator)
        self.weight = nn.Parameter(weight.to(device))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis: statistics and affine in f32 (f64 for
    the f64 compute dtype), result in the compute dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = compute_dtype()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upcast(x)
        y = F.layer_norm(x, self.weight.shape, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps)
        return y.to(self.dtype)


class MLP(nn.Module):
    def __init__(
        self,
        in_channels: int,
        hidden_channels: Sequence[int],
        final_bias_init: Optional[float] = None,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        generator = default_generator(generator)
        self.dtype = compute_dtype()
        dims = [in_channels] + list(hidden_channels)
        self.linears = nn.ModuleList()
        self.norms = nn.ModuleList()
        for i in range(len(dims) - 1):
            self.linears.append(Linear(dims[i], dims[i + 1], generator=generator, device=device))
            if i < len(dims) - 2:
                self.norms.append(LayerNorm(dims[i + 1], eps=1e-5, device=device))
        if final_bias_init is not None:
            with torch.no_grad():
                self.linears[-1].bias.fill_(final_bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, linear in enumerate(self.linears):
            x = linear(x)
            if i < len(self.norms):
                x = F.silu(self.norms[i](x))
        return x
