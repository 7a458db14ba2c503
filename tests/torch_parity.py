"""Helpers of the parity tests between ``sihl_tpu`` (JAX, CPU) and its
PyTorch port ``sihl_tpu_torch``: weights go from the JAX model to the port
through ``state_dict_from_flat``; data crosses as numpy arrays, NHWC on the
JAX side and NCHW in channels_last memory on the torch side."""

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from sihl_tpu_torch.convert import NHWC_VARIABLE_LEAVES, VARIABLE_LEAVES, state_dict_from_flat
from sihl_tpu_torch.layers.convblocks import BatchNorm2d
from sihl_tpu_torch.policy import set_default_device

# the test suite runs several pytest workers on one host, none with a card
torch.set_num_threads(1)
set_default_device("cpu")


def flat_state(module) -> dict:
    """The module's Param and BatchStat leaves, and the variables that
    ``state_dict_from_flat`` carries (the panoptic head's ``step_counter``,
    the anomaly head's calibration and reservoirs), as numpy arrays under
    dotted paths."""
    names = sorted(VARIABLE_LEAVES | NHWC_VARIABLE_LEAVES)
    state = nnx.state(module, nnx.Any(nnx.Param, nnx.BatchStat, *(nnx.PathContains(n) for n in names)))
    return {
        ".".join(str(p) for p in path): np.asarray(v[...])
        for path, v in nnx.to_flat_state(state)
    }


def randomize_norms(module, rng: np.random.RandomState) -> None:
    """Give every BatchNorm random running statistics, and every BatchNorm
    and LayerNorm random affine parameters, so that no norm is the identity."""

    def uniform(lo, hi, shape):
        return jnp.asarray(rng.uniform(lo, hi, shape), jnp.float32)

    for _, sub in nnx.iter_graph(module):
        if isinstance(sub, (nnx.BatchNorm, nnx.LayerNorm)):
            c = sub.scale[...].shape
            sub.scale[...] = uniform(0.8, 1.2, c)
            sub.bias[...] = uniform(-0.1, 0.1, c)
        if isinstance(sub, nnx.BatchNorm):
            sub.mean[...] = uniform(-0.2, 0.2, c)
            sub.var[...] = uniform(0.5, 1.5, c)


def damp_residual_branches(module, rng: np.random.RandomState, lo: float = 0.01, hi: float = 0.03) -> None:
    """Scale the last BatchNorm of every bottleneck branch (``conv3.bn``) to
    U(lo, hi), so that each residual block starts near the identity, as
    zero-init-residual ResNets do.  At full BatchNorm scales the f32
    gradients of a random-weight ResNet in training mode lose most of their
    digits (their error against f64 reaches 1e-2), which no fixed tolerance
    between two f32 implementations can absorb."""
    for path, sub in nnx.iter_graph(module):
        if isinstance(sub, nnx.BatchNorm) and tuple(path[-2:]) == ("conv3", "bn"):
            sub.scale[...] = jnp.asarray(rng.uniform(lo, hi, sub.scale[...].shape), jnp.float32)


@torch.no_grad()
def batch_stats_from_data(module: torch.nn.Module, images: torch.Tensor) -> None:
    """Every BatchNorm of ``module`` (a port backbone) takes the statistics of
    one training-mode forward of ``images`` as its running statistics: a
    random frozen teacher's stand-in for pretrained statistics.  With the
    initial ones, a stem filter that is negative on every pixel of images in
    [0, 1] leaves its channel 0 everywhere, down to the anomaly head's
    teacher level, whose standard deviation is then 0."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.momentum = 0.0
    module.train()
    module(images)
    module.eval()
    for m in norms:
        del m.momentum


def copy_batch_stats(port_module: torch.nn.Module, jax_module) -> None:
    """The port module's BatchNorm running statistics into the JAX module's
    BatchNorms at the same paths."""
    state = port_module.state_dict()
    for path, sub in nnx.iter_graph(jax_module):
        if isinstance(sub, nnx.BatchNorm):
            prefix = ".".join(str(p) for p in path)
            sub.mean[...] = jnp.asarray(state[f"{prefix}.running_mean"].numpy())
            sub.var[...] = jnp.asarray(state[f"{prefix}.running_var"].numpy())


def load_from_jax(port_module: torch.nn.Module, jax_module) -> torch.nn.Module:
    """Carry the JAX module's weights into the port's counterpart (strict),
    the port's module telling ``state_dict_from_flat`` which kernels are
    transposed convs' and attention projections'."""
    port_module.load_state_dict(state_dict_from_flat(flat_state(jax_module), port_module), strict=True)
    return port_module.eval()


def to_torch(x_nhwc) -> torch.Tensor:
    """NHWC array → NCHW tensor in channels_last memory."""
    return torch.from_numpy(np.asarray(x_nhwc)).permute(0, 3, 1, 2)


def to_numpy(x: torch.Tensor, nhwc: bool = False) -> np.ndarray:
    x = x.detach().float()
    if nhwc:
        x = x.permute(0, 2, 3, 1)
    return x.numpy()


def assert_detections_match(got, want, box_atol):
    """num_instances, top-k order and classes exact; scores to 1e-5; boxes
    to ``box_atol`` pixels."""
    num, scores, classes, boxes = got
    w_num, w_scores, w_classes, w_boxes = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(num.numpy(), w_num)
    np.testing.assert_array_equal(classes.numpy(), w_classes)
    np.testing.assert_allclose(to_numpy(scores), w_scores, atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_numpy(boxes), w_boxes, atol=box_atol, rtol=0)


def assert_within_one_bf16_step(got, want) -> None:
    """Each element of ``got`` within one bf16 step of ``want``: the spacing
    of bf16 values at the larger magnitude of the two (2^-7 of its power of
    two).  Two roundings to bf16 of f32 sums taken in different orders agree
    so where the sums keep more digits than bf16."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    step = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    bad = np.abs(got - want) > step
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} elements beyond one bf16 step, e.g. {got[bad][:4]} vs {want[bad][:4]}"


def numpy_filled(abstract, seed: int):
    """A JAX module from ``nnx.eval_shape``'s abstract one, every leaf drawn
    from a seeded numpy generator: conv and linear kernels N(0, 1/fan_in),
    biases U(-0.1, 0.1), norm scales U(0.8, 1.2), running means U(-0.2, 0.2)
    and variances U(0.5, 1.5), a BiFPN fusion's ``weights`` U(0.5, 1.5) (the
    package starts them at 1); ConvNeXt's layer scales (``gamma``) U(0.1,
    0.5) and a GRN's ``gamma`` and ``beta`` U(-0.5, 0.5), where the JAX
    package starts them at 1e-6 and 0, which would make every block the
    identity to six digits.  Building a deep JAX net this way takes a trace
    and no compile."""
    graphdef, state = nnx.split(abstract)
    rng = np.random.RandomState(seed)
    draws = {
        "kernel": lambda s: rng.randn(*s) / np.sqrt(np.prod(s[:-1])),
        "bias": lambda s: rng.uniform(-0.1, 0.1, s),
        "scale": lambda s: rng.uniform(0.8, 1.2, s),
        "mean": lambda s: rng.uniform(-0.2, 0.2, s),
        "var": lambda s: rng.uniform(0.5, 1.5, s),
        "weights": lambda s: rng.uniform(0.5, 1.5, s),
        "gamma": lambda s: rng.uniform(0.1, 0.5, s),
        "beta": lambda s: rng.uniform(-0.5, 0.5, s),
        "grn.gamma": lambda s: rng.uniform(-0.5, 0.5, s),
    }

    def draw(path, shape):
        key = "grn.gamma" if tuple(map(str, path[-2:])) == ("grn", "gamma") else str(path[-1])
        return draws[key](shape)

    flat = [(path, var.replace(jnp.asarray(draw(path, var.shape), var.dtype)))
            for path, var in nnx.to_flat_state(state)]
    return nnx.merge(graphdef, nnx.from_flat_state(flat))


def _zeros(shape) -> np.ndarray:
    """Read-only f32 zeros of ``shape`` that take no memory (a broadcast
    view): convnext_xxlarge's layout holds 846 million parameters."""
    return np.broadcast_to(np.zeros((), np.float32), shape)


class _StubConv(nnx.Module):
    """``make_conv``'s leaves (kernel (k, k, in / groups, out), bias) as
    numpy zeros: the layout of a JAX net without initialising it."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, dilation=1, groups=1, padding=None, bias=True, *,
                 rngs=None):
        self.kernel = nnx.Param(_zeros((kernel_size, kernel_size, cin // groups, cout)))
        self.bias = nnx.Param(_zeros((cout,))) if bias else None


class _StubBatchNorm(nnx.Module):
    def __init__(self, kind, num_features, groupnorm_groups=1, rngs=None):
        assert kind == "batch", kind
        self.scale = nnx.Param(np.ones((num_features,), np.float32))
        self.bias = nnx.Param(_zeros((num_features,)))
        self.mean = nnx.BatchStat(_zeros((num_features,)))
        self.var = nnx.BatchStat(np.ones((num_features,), np.float32))


class _StubLayerNorm(nnx.Module):
    """``nnx.LayerNorm``'s leaves (scale, bias)."""

    def __init__(self, num_features, *args, rngs=None, **kwargs):
        self.scale = nnx.Param(np.ones((num_features,), np.float32))
        self.bias = nnx.Param(_zeros((num_features,)))


class _StubLinear(nnx.Module):
    """``nnx.Linear``'s leaves (kernel (in, out), bias where ``use_bias``)."""

    def __init__(self, in_features, out_features, *args, use_bias=True, rngs=None, **kwargs):
        self.kernel = nnx.Param(_zeros((in_features, out_features)))
        self.bias = nnx.Param(_zeros((out_features,))) if use_bias else None


class _StubNnx:
    """``flax.nnx`` with ``LayerNorm`` and ``Linear`` stubbed."""

    LayerNorm = _StubLayerNorm
    Linear = _StubLinear

    def __getattr__(self, name):
        return getattr(nnx, name)


class _StubJnp:
    """``jax.numpy`` whose ``full`` and ``zeros`` (a bare ``nnx.Param``'s
    initial value: ConvNeXt's layer scale, GRN's scale and shift) give
    numpy zeros."""

    @staticmethod
    def full(shape, fill_value, dtype=None):
        return _zeros(shape)

    @staticmethod
    def zeros(shape, dtype=None):
        return _zeros(shape)

    def __getattr__(self, name):
        return getattr(jnp, name)


def stub_layout(monkeypatch, *jax_modules) -> None:
    """Make the JAX modules' ``make_conv``, ``make_norm``, ``nnx.LayerNorm``,
    ``nnx.Linear`` and bare ``nnx.Param`` values build stubs
    (:class:`_StubConv`, :class:`_StubBatchNorm`, :class:`_StubLayerNorm`,
    :class:`_StubLinear`, zeros that take no memory): a net then builds in
    milliseconds with the real one's module paths and leaf shapes, where
    ``nnx.eval_shape`` takes up to 23 s (EfficientNet V2-L)."""
    for module in jax_modules:
        for name, stub in (("make_conv", _StubConv), ("make_norm", _StubBatchNorm), ("nnx", _StubNnx()),
                           ("jnp", _StubJnp())):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, stub)


def relative_max_error(got, want) -> float:
    """The largest absolute difference over the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())
