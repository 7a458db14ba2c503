"""The tests of ``tests/test_torch_ssl_slice.py`` on its view-invariance (Barlow Twins) model."""

import pytest

from test_torch_ssl_slice import (_pair, jax_step, test_forward_matches_jax,  # noqa: F401
                                  test_train_step_losses_gradients_and_stats_match_jax,
                                  test_trainer_step_metrics_and_update_match_jax, test_validate_matches_jax)

KIND = "view_invariance"


@pytest.fixture(scope="module")
def pair():
    return _pair(KIND)
