"""Conv building blocks (counterpart of ``sihl_tpu/layers/convblocks.py``).

Layout: NCHW tensors in ``channels_last`` memory; conv weights are stored
channels_last too, so cuDNN runs its NHWC kernels and no layout copies are
made between layers.  All convs use explicit symmetric padding
``(k-1)//2 * dilation``.

Parameters are float32 and initialised from an explicit ``torch.Generator``
(flax's defaults: LeCun-normal kernels, zero biases, unit norm scales).
Every module casts its input and weights to the compute dtype it read from
the policy at construction.

Activations (``_ACTS``) are the JAX package's: ``gelu`` is
``jax.nn.gelu``'s default, the tanh approximation, and ``softmax`` runs over
the channels (JAX's last axis of NHWC, ``dim=1`` here).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sihl_tpu_torch.ops.relu import relu
from sihl_tpu_torch.policy import compute_dtype, resolve_device, upcast

# flax's truncated-normal initializers divide by this to keep the variance
_TRUNC_STD = 0.87962566103423978


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal (±2 std) of variance 1/fan_in,
    drawn on the CPU so the values do not depend on the target device."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(
        torch.empty(shape), std=std, a=-2 * std, b=2 * std, generator=generator
    )


class Conv2d(nn.Module):
    """2-D convolution computed in the construction-time compute dtype."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        dilation: int = 1,
        groups: int = 1,
        bias: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.dtype = compute_dtype()
        device = resolve_device(device)
        fan_in = in_channels // groups * kernel_size * kernel_size
        weight = lecun_normal(
            (out_channels, in_channels // groups, kernel_size, kernel_size),
            fan_in,
            default_generator(generator),
        )
        self.weight = nn.Parameter(
            weight.to(device).contiguous(memory_format=torch.channels_last)
        )
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(
            x.to(self.dtype),
            self.weight.to(self.dtype),
            bias,
            self.stride,
            self.padding,
            self.dilation,
            self.groups,
        )


class ConvTranspose2d(nn.Module):
    """Transposed 2-D convolution with a bias and no padding (flax's
    ``ConvTranspose`` with ``kernel_size == strides``, where "SAME" pads
    nothing), computed in the construction-time compute dtype.  The weight is laid out (I, O, H, W)
    as ``F.conv_transpose2d`` reads it; flax's (H, W, I, O) kernel maps to it
    flipped in space (``convert.state_dict_from_flat`` does this)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if kernel_size != stride:
            raise ValueError(f"only kernel_size == stride is ported, got {kernel_size} and {stride}")
        self.stride = stride
        self.dtype = compute_dtype()
        device = resolve_device(device)
        weight = lecun_normal(
            (in_channels, out_channels, kernel_size, kernel_size),
            in_channels * kernel_size * kernel_size,
            default_generator(generator),
        )
        self.weight = nn.Parameter(weight.to(device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv_transpose2d(
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype), self.stride
        )
        return out.contiguous(memory_format=torch.channels_last)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm over (B, C, H, W) with the batch statistics
    differentiated through (counterpart of ``sihl_tpu/ops/fused_bn.py``).

    Forward: "fast variance" statistics in f32 (f64 for f64 inputs),
    ``E[x^2] - E[x]^2`` clipped at 0; ``y = (x - mu) * (r * scale) + bias``
    in that dtype, cast to ``x``'s dtype.
    Backward, with ``xhat = (x - mu) * r`` and n = B*H*W:
    ``dx = scale * r * (dy - sum(dy) / n - xhat * sum(dy * xhat) / n)``.
    Only ``x`` and the (C,) statistics are saved, not f32 copies of ``x``.
    """

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        xf = upcast(x)
        mu = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mu * mu, min=0.0)
        r = torch.rsqrt(var + eps)
        y = (xf - mu[:, None, None]) * (r * scale)[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(x, mu, r, scale)
        ctx.mark_non_differentiable(mu, var)
        return y.to(x.dtype), mu, var

    @staticmethod
    def backward(ctx, dy, _dmu, _dvar):
        x, mu, r, scale = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        dyf = upcast(dy)
        xhat = (upcast(x) - mu[:, None, None]) * r[:, None, None]
        dbeta = dyf.sum(dim=(0, 2, 3))
        dgamma = (dyf * xhat).sum(dim=(0, 2, 3))
        dx = (scale * r)[:, None, None] * (
            dyf - (dbeta / n)[:, None, None] - xhat * (dgamma / n)[:, None, None]
        )
        return dx.to(x.dtype), dgamma, dbeta, None


class BatchNorm2d(nn.Module):
    """BatchNorm (eps 1e-5) in the input's compute dtype.

    Eval: normalisation in f32 (f64 for an f64 input) against the running
    statistics and parameters; the result comes back in the input's dtype.
    Training: :class:`_BatchNormTrain` on the batch statistics, with scale and bias
    first rounded to the input's dtype (flax's ``promote_dtype``), and the
    running statistics updated with the *biased* batch variance at flax's
    momentum 0.9 (``running = 0.9 * running + 0.1 * batch``, which is
    torch's momentum 0.1).
    """

    momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            stats = (self.running_mean, self.running_var, self.weight, self.bias)
            if x.dtype == torch.float64:  # a reference run: the normalisation in f64
                stats = tuple(t.double() for t in stats)
            return F.batch_norm(x, *stats, False, 0.0, self.eps)
        scale = upcast(self.weight.to(x.dtype))
        bias = upcast(self.bias.to(x.dtype))
        y, mu, var = _BatchNormTrain.apply(x, scale, bias, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mu)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


def make_conv(
    in_channels: int,
    out_channels: int,
    kernel_size: int = 3,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
    padding: Optional[int] = None,
    bias: bool = True,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Conv2d:
    pad = padding if padding is not None else (kernel_size - 1) // 2 * dilation
    return Conv2d(
        in_channels,
        out_channels,
        kernel_size,
        stride=stride,
        padding=pad,
        dilation=dilation,
        groups=groups,
        bias=bias,
        generator=generator,
        device=device,
    )


class GroupNorm(nn.Module):
    """Group normalisation (eps 1e-5) as ``nnx.GroupNorm`` computes it, in
    training and eval alike: scale and bias rounded to the input's dtype;
    each group's statistics over its channels and all pixels in f32 (f64
    for f64 inputs), the variance ``E[x^2] - E[x]^2`` clipped at 0; ``y =
    (x - mu) * (rsqrt(var + eps) * scale) + bias`` in that dtype, returned
    in the input's dtype.  Autograd differentiates through the statistics."""

    def __init__(self, num_features: int, num_groups: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f"{num_features} features do not split into {num_groups} groups")
        device = resolve_device(device)
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xf = upcast(x)
        grouped = xf.reshape(b, self.num_groups, c // self.num_groups, h, w)
        mu = grouped.mean(dim=(2, 3, 4))
        var = torch.clamp((grouped * grouped).mean(dim=(2, 3, 4)) - mu * mu, min=0.0)
        mu = mu.repeat_interleave(c // self.num_groups, dim=1)[:, :, None, None]
        var = var.repeat_interleave(c // self.num_groups, dim=1)[:, :, None, None]
        scale = upcast(self.weight.to(x.dtype))[:, None, None]
        bias = upcast(self.bias.to(x.dtype))[:, None, None]
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * scale) + bias
        return y.to(x.dtype)


def make_norm(kind: Optional[str], num_features: int, groupnorm_groups: int = 1, *, device=None):
    """A BatchNorm, a GroupNorm of ``groupnorm_groups`` groups, or None."""
    if kind == "batch":
        return BatchNorm2d(num_features, eps=1e-5, device=device)
    if kind == "group":
        return GroupNorm(num_features, groupnorm_groups, eps=1e-5, device=device)
    if kind is None:
        return None
    raise ValueError(f"unknown norm {kind!r}")


_ACTS = {
    "relu": relu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "softmax": lambda x: torch.softmax(x, dim=1),
    None: None,
}


class SeparableConv2d(nn.Module):
    """Depthwise conv (one filter a channel) then a 1x1 pointwise conv."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[int] = 1,
        dilation: int = 1,
        bias: bool = False,
        groups: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        generator = default_generator(generator)
        self.depthwise = make_conv(
            in_channels, in_channels, kernel_size, stride=stride, padding=padding, dilation=dilation,
            groups=in_channels, bias=bias, generator=generator, device=device,
        )
        self.pointwise = make_conv(
            in_channels, out_channels, 1, groups=groups, bias=bias, generator=generator, device=device
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class StandardConvNormAct(nn.Module):
    """torchvision ``Conv2dNormActivation``: conv → norm → act."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        dilation: int = 1,
        groups: int = 1,
        padding: Optional[int] = None,
        norm: Optional[str] = "batch",
        act: Optional[str] = "relu",
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.conv = make_conv(
            in_channels,
            out_channels,
            kernel_size,
            stride=stride,
            dilation=dilation,
            groups=groups,
            padding=padding,
            bias=norm is None,
            generator=default_generator(generator),
            device=device,
        )
        self.norm = make_norm(norm, out_channels, max(out_channels // 8, 1), device=device)
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act is not None:
            x = self.act(x)
        return x


class ConvNormAct(nn.Module):
    """sihl's conv block: conv → act → norm (the JAX package keeps this order
    for parity with upstream sihl).  The conv has a bias where there is no
    norm, unless ``bias`` says otherwise; ``separable`` makes a conv wider
    than 1x1 a :class:`SeparableConv2d`.  A group norm has
    ``max(in_channels // 8, 1)`` groups, as in the JAX package."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        dilation: int = 1,
        groups: int = 1,
        padding: Optional[int] = None,
        norm: Optional[str] = "batch",
        act: Optional[str] = "relu",
        bias: Optional[bool] = None,
        separable: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        use_bias = (norm is None) if bias is None else bias
        generator = default_generator(generator)
        if separable and kernel_size > 1:
            self.conv = SeparableConv2d(
                in_channels,
                out_channels,
                kernel_size,
                stride=stride,
                padding=padding if padding is not None else (kernel_size - 1) // 2 * dilation,
                dilation=dilation,
                bias=use_bias,
                groups=groups,
                generator=generator,
                device=device,
            )
        else:
            self.conv = make_conv(
                in_channels,
                out_channels,
                kernel_size,
                stride=stride,
                dilation=dilation,
                groups=groups,
                padding=padding,
                bias=use_bias,
                generator=generator,
                device=device,
            )
        self.act = _ACTS[act]
        self.norm = make_norm(norm, out_channels, max(in_channels // 8, 1), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.act is not None:
            x = self.act(x)
        if self.norm is not None:
            x = self.norm(x)
        return x


class Identity(nn.Module):
    def forward(self, x):
        return x


class SequentialConvBlocks(nn.Module):
    """``num_layers`` stacked ``conv_block``\\ s (none for ``num_layers <= 0``):
    the first maps ``in_channels`` to ``out_channels``, the rest keep
    ``out_channels``; ``kwargs`` go to every block."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_layers: int,
        kernel_size: int = 3,
        conv_block=ConvNormAct,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
        **kwargs,
    ):
        super().__init__()
        generator = default_generator(generator)
        self.blocks = nn.ModuleList(
            conv_block(
                in_channels if i == 0 else out_channels,
                out_channels,
                kernel_size=kernel_size,
                generator=generator,
                device=device,
                **kwargs,
            )
            for i in range(max(num_layers, 0))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x
