"""Parity of the port's ObjectDetection inference with the JAX package (f32, CPU)."""

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.heads import ObjectDetection as JaxObjectDetection
from sihl_tpu_torch.heads import ObjectDetection
from sihl_tpu_torch.heads import anchors

from torch_parity import assert_detections_match, load_from_jax, randomize_norms, to_torch


def test_object_detection_matches_jax():
    rng = np.random.RandomState(0)
    pyramid = make_pyramid(batch_size=2, height=128, width=128, rng=rng)
    in_channels = [p.shape[-1] for p in pyramid]
    kw = dict(bottom_level=3, top_level=5, num_channels=32)
    jax_head = JaxObjectDetection(in_channels, 5, rngs=nnx.Rngs(0), **kw)
    randomize_norms(jax_head, rng)
    # spread the loc logits so that some anchors clear the 0.5 score line
    jax_head.loc_head.linears[-1].bias[...] = jnp.full((1,), -0.7, jnp.float32)
    jax_head.eval()
    head = load_from_jax(ObjectDetection(in_channels, 5, **kw), jax_head)

    want = jax_head([jnp.asarray(p) for p in pyramid])
    with torch.no_grad():
        got = head([to_torch(p) for p in pyramid])
    assert 0 < int(np.asarray(want[0]).sum()) < 200
    for (name, shape), g in zip(head.output_shapes.items(), got):
        assert g.shape == tuple(2 if s == "batch_size" else s for s in shape), name
    assert_detections_match(got, want, box_atol=1e-3)


def test_cell_anchors_and_gather():
    pyramid = [to_torch(p) for p in make_pyramid(batch_size=1, height=64, width=64)]
    offsets, scales = anchors.cell_anchors(pyramid, range(3, 6))
    assert offsets.shape == scales.shape == (8 * 8 + 4 * 4 + 2 * 2, 4)
    # h-major then w within a level; the first cell of level 3 is centred at 1/16
    np.testing.assert_allclose(offsets[:2].numpy(), [[1 / 16, 1 / 16] * 2, [3 / 16, 1 / 16] * 2])
    np.testing.assert_allclose(scales[0].numpy(), [-1 / 16, -1 / 16, 1 / 16, 1 / 16])
    feats = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    idx = torch.tensor([[4, 0], [1, 1]])
    np.testing.assert_array_equal(
        anchors.gather_anchor_rows(feats, idx).numpy(),
        np.take_along_axis(feats.numpy(), idx.numpy()[..., None], axis=1),
    )
