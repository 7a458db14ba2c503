"""The port's DenseNet and ShuffleNetV2 feature nets against the JAX
package's (CPU), as ``tests/test_torch_mobilenet.py`` holds MobileNet.

Compared, for densenet121 and shufflenet_v2_x0_5, in eval mode and with
train-mode BatchNorm: the port's f64 levels within 1e-9 of JAX's f64
levels (JAX's average pool casts to f32 explicitly, which its f64
reference reads as f64: ``test_torch_convnext.f64_statistics``), its f32
levels within 1e-5 in eval mode and ``F32_TRAIN_LIMIT`` in
train mode, and the running statistics after the train-mode forward.
DenseNet's level 1 is the stem's ReLU output and level 5 ``denseblock4``
(no ``norm5``); ShuffleNetV2's level 2 is the max pool's output.  The
channel shuffle on channels that are all distinct against JAX's, in
channels_last memory, and a stride-1 unit that passes its first half
through against JAX's.  Every name of ``DENSENET_CONFIGS`` and
``SHUFFLENET_CONFIGS`` builds with JAX's channels, level modules and
parameter layout; freezing agrees with JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu.backbones.densenet import DENSENET_CONFIGS as JAX_DENSENET_CONFIGS
from sihl_tpu.backbones.shufflenet import SHUFFLENET_CONFIGS as JAX_SHUFFLENET_CONFIGS
from sihl_tpu.backbones.shufflenet import _channel_shuffle as jax_channel_shuffle
from sihl_tpu.backbones.shufflenet import _ShuffleUnit as JaxShuffleUnit
from sihl_tpu_torch.backbones.shufflenet import _ShuffleUnit, channel_shuffle
from sihl_tpu_torch.convert import state_dict_from_flat

from test_torch_convnext import SECOND_PART, assert_layout_matches_on_meta, f64_statistics
from test_torch_mobilenet import assert_freezing_matches, assert_level_maps_match
from torch_parity import flat_state, numpy_filled, relative_max_error, to_numpy, to_torch


@pytest.mark.parametrize("name", ["densenet121", "shufflenet_v2_x0_5"])
def test_level_maps_match_jax(name):
    with f64_statistics():  # the transitions' average pool sums in f64 in both f64 runs
        assert_level_maps_match(name)


@pytest.mark.parametrize("groups", [2, 4])
def test_channel_shuffle_matches_jax(groups):
    """Every channel distinct (its index, plus a position code): the port's
    shuffle is JAX's NHWC shuffle, and its result stays channels_last."""
    b, c, h, w = 2, 12, 3, 5
    x = (np.arange(c)[None, None, None, :] + 100 * np.arange(b * h * w).reshape(b, h, w, 1)).astype(np.float32)
    got = channel_shuffle(to_torch(x).contiguous(memory_format=torch.channels_last), groups)
    want = np.asarray(jax_channel_shuffle(jnp.asarray(x), groups))
    np.testing.assert_array_equal(to_numpy(got, nhwc=True), want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    x_nchw = to_torch(x).contiguous()
    reference = x_nchw.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)
    assert torch.equal(channel_shuffle(x_nchw, groups), reference)


def test_stride1_unit_passes_its_first_half_through():
    """A stride-1 unit (48 channels) in eval mode against JAX's on maps whose
    channels are distinct: the output equal within 1e-5, the first half of
    the input unchanged at every even output channel."""
    unit = numpy_filled(nnx.eval_shape(lambda: JaxShuffleUnit(48, 48, 1, rngs=nnx.Rngs(0))), 2)
    unit.eval()
    x = np.random.RandomState(3).randn(2, 6, 6, 48).astype(np.float32) + np.arange(48, dtype=np.float32)
    want = np.asarray(unit(jnp.asarray(x)))
    port = _ShuffleUnit(48, 48, 1, generator=torch.Generator().manual_seed(0), device="cpu")
    port.load_state_dict(state_dict_from_flat(flat_state(unit), port), strict=True)
    with torch.no_grad():
        got = to_numpy(port.eval()(to_torch(x)), nhwc=True)
    assert relative_max_error(got, want) <= 1e-5
    np.testing.assert_array_equal(got[..., 0::2], x[..., :24])


@pytest.mark.parametrize("name", sorted({**JAX_DENSENET_CONFIGS, **JAX_SHUFFLENET_CONFIGS}))
def test_every_name_builds_with_jax_layout(name, monkeypatch):
    assert_layout_matches_on_meta(name, monkeypatch)


@pytest.mark.parametrize("name", ["densenet121", "shufflenet_v2_x1_0"])
def test_pair_freezing_matches_jax(name, monkeypatch):
    assert_freezing_matches(name, monkeypatch, families=SECOND_PART)
