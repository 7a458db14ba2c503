"""The multitask slice of the port against the JAX package's (CPU): the
tests of ``tests/test_torch_hybrid_slice.py`` on its four-head model
(resnet18 with level 1 frozen → FPN 32 wide over levels 3-5 →
ObjectDetection, TextRecognition, DepthEstimation and MetricLearning; 4
images at 64 px), and one ``Trainer.validate`` over two batches after the
metric head's index is populated with ``extend_validation_index_set`` on a
third batch's features (eval mode), as ``examples/metric_learning.py``
does: every metric of the four heads within 1e-4 relative (the text head's
tokens and edit distances come from its ``aux``, the metric head returns
none), the running statistics unchanged; then ``Trainer.predict``, the
text head's (scores, tokens) pair among its outputs, against JAX's.
"""

import copy

import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu_torch.training import Trainer

from test_torch_hybrid_slice import (OPTIMIZER, _batch, _flatten, _pair, jax_step,  # noqa: F401
                                     test_forward_matches_jax, test_train_step_losses_gradients_and_stats_match_jax,
                                     test_trainer_step_metrics_and_update_match_jax)

KIND = "multitask"


@pytest.fixture(scope="module")
def pair():
    return _pair(KIND)


def test_validate_and_predict_match_jax(pair):
    kind, jax_model, models = pair
    batches = [_batch(kind, 4), _batch(kind, 5)]
    (jx, jt), (x, t) = _batch(kind, 6)
    jax_trainer = JaxTrainer(nnx.clone(jax_model), **OPTIMIZER)
    jax_trainer.model.eval()
    jax_trainer.model.heads[3].extend_validation_index_set(jax_trainer.model.extract_features(jx), jt[3])
    want = jax_trainer.validate([b[0] for b in batches])

    model = copy.deepcopy(models[torch.float32])
    trainer = Trainer(model, **OPTIMIZER)
    model.eval()
    with torch.no_grad():
        model.heads[3].extend_validation_index_set(model.extract_features(x), t[3])
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    got = trainer.validate([b[1] for b in batches])
    assert sorted(got) == sorted(want)
    assert {"head1/valid/edit_distance", "head2/valid/rmse", "head3/valid/r_precision"} <= set(got)
    for k, v in got.items():
        assert v == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k
    assert all(torch.equal(b, buffers[n]) for n, b in model.named_buffers())

    want = _flatten(jax_trainer.predict(batches[0][0][0]))
    got = _flatten(trainer.predict(batches[0][1][0]))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
