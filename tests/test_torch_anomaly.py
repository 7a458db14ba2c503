"""Parity of the port's EfficientAD head (``AnomalyDetection``) with the
JAX package's (CPU), and its state:

* ``compute_distances`` in eval and training mode, and the serving map
  with calibration quantiles that put pixels below, inside and above
  [0, 1], against JAX's f32 head;
* the hard-mined loss and its parts, and every gradient, of the port's f64
  head against JAX's f64 head (which casts the distances to f32, so the
  two agree to f32's digits: the losses within 1e-5 relative), on inputs
  whose k-th and (k+1)-th distance lie apart (``topk_margin``);
* the reservoir over a wrap of its ring (size 100, 48 samples a step,
  three steps: position 44, full), its contents against JAX's, and no
  write while validating;
* ``on_validation_start``: the four quantiles against JAX's, and nothing
  while the reservoir is empty;
* the pretraining protocol (``pretrain_init`` / ``pretrain_step`` /
  ``pretrain_end``): the teacher's mean and standard deviation against
  JAX's;
* the validation triple on a normal and an anomalous batch;
* a checkpoint saved in mid-ring and restored into a fresh trainer (torch
  only; the teacher's BatchNorm statistics from the data,
  ``batch_stats_from_data``): every buffer bitwise, and the next step's
  reservoir writes at the same position on both.

The head at the size of ``tests/heads``: a synthetic pyramid of 4 images
at 64 px, the teacher at level 2 (16 channels, 16 x 16), 16 channels for
the student, 8 for the autoencoder, whose bottleneck maps are 8 x 8;
weights and variables carried by ``state_dict_from_flat``.  Tolerances:
distances, maps, losses and reservoir values within 1e-5 relative
(``assert_forward_close``); f64 gradients within relative L2 1e-5, the
f64 limit of ``tests/test_torch_hybrid_slice.py``; quantiles and teacher
statistics within 1e-5 relative; validation metrics within 1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.heads import AnomalyDetection as JaxAnomalyDetection
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import AnomalyDetection
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer, restore_checkpoint, save_checkpoint

from test_torch_convblocks import assert_forward_close, load, randomize_all_norms, relative_l2
from test_torch_hybrid_slice import F64_LIMIT, jax_f64
from torch_parity import batch_stats_from_data, to_torch

BATCH, LEVEL = 4, 2
KWARGS = dict(num_channels=16, autoencoder_channels=8, reservoir_size=100, samples_per_step=48)


def pyramids(seed: int = 0):
    levels = make_pyramid(batch_size=BATCH, rng=np.random.RandomState(seed))
    return [jnp.asarray(p) for p in levels], [to_torch(p) for p in levels]


def in_channels():
    return [p.shape[-1] for p in make_pyramid(batch_size=1)]


@functools.lru_cache(maxsize=1)
def _jax_head():
    """The JAX head, built once under ``nnx.jit`` (eagerly its construction
    takes seconds)."""
    return nnx.jit(lambda: JaxAnomalyDetection(in_channels(), rngs=nnx.Rngs(0), **KWARGS))()


def head_pair():
    """The JAX head with random norms and teacher statistics, and the port's
    head carrying its weights and variables."""
    rng = np.random.RandomState(1)
    jax_head = nnx.clone(_jax_head())
    randomize_all_norms(jax_head, rng)
    c = jax_head.out_channels
    jax_head.features_mean[...] = jnp.asarray(rng.uniform(0.3, 0.7, (1, 1, 1, c)), jnp.float32)
    jax_head.feature_std[...] = jnp.asarray(rng.uniform(0.2, 0.4, (1, 1, 1, c)), jnp.float32)
    return jax_head, load(AnomalyDetection(in_channels(), **KWARGS), jax_head)


def calibrate(jax_head, head, distances) -> None:
    """Quantiles of the channel-mean distances as the calibration, so that
    the serving map has pixels below, inside and above [0, 1]."""
    st, _, stae = (np.asarray(d).mean(-1) for d in distances)
    for name, values, q in (("q_st_start", st, 0.3), ("q_st_end", st, 0.5), ("q_ae_start", stae, 0.3),
                            ("q_ae_end", stae, 0.5)):
        getattr(jax_head, name)[...] = jnp.asarray(np.quantile(values, q), jnp.float32)
    jax_head.local_thresh[...] = jnp.asarray(0.4, jnp.float32)
    load(head, jax_head)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_distances_and_serving_map(train):
    jax_head, head = head_pair()
    jax_inputs, inputs = pyramids(2)
    jax_head.train() if train else jax_head.eval()
    head.train(train)
    want = nnx.jit(lambda m, xs: m.compute_distances(xs))(jax_head, jax_inputs)
    with torch.no_grad():
        got = head.compute_distances(inputs)
    for g, w in zip(got, want):
        assert g.shape == (BATCH, 16, 16, 16) and g.dtype == torch.float32
        assert_forward_close(g.permute(0, 2, 3, 1).numpy(), w)
    if train:
        return
    calibrate(jax_head, head, want)
    want_map = np.asarray(nnx.jit(lambda m, xs: m(xs))(jax_head, jax_inputs))
    with torch.no_grad():
        got_map = head(inputs)
    assert got_map.shape == (BATCH, 64, 64)
    assert 0.1 < (want_map == 0).mean() < 0.9 and (want_map == 1).any() and ((want_map > 0) & (want_map < 1)).any()
    assert_forward_close(got_map.numpy(), want_map)


def topk_margin(distance_st: torch.Tensor, k: int) -> float:
    """The least gap, over the images, between the k-th and (k+1)-th largest
    student-teacher distance, relative to the image's largest."""
    top = distance_st.reshape(distance_st.shape[0], -1).topk(k + 1, dim=1).values
    return float(((top[:, k - 1] - top[:, k]) / top[:, 0]).min())


def test_hard_mined_loss_and_gradients_match_jax_f64():
    jax_head, head = head_pair()
    jax_inputs, inputs = pyramids(3)
    with jax_f64():
        jax64 = nnx.jit(lambda: JaxAnomalyDetection(in_channels(), rngs=nnx.Rngs(0), **KWARGS))()
        nnx.update(jax64, jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64) if v.dtype == jnp.float32 else v, nnx.state(jax_head)))
        jax64.train()

        @nnx.jit
        def value_and_grad(m, xs):
            return nnx.value_and_grad(lambda mm: mm.training_step(xs), has_aux=True)(m)

        (want, want_parts), grads = value_and_grad(jax64, [jnp.asarray(p, jnp.float64) for p in jax_inputs])
        want_grads = {".".join(map(str, p)): np.asarray(v[...], np.float64) for p, v in nnx.to_flat_state(grads)}
    with compute_dtype_scope(torch.float64):
        head64 = AnomalyDetection(in_channels(), **KWARGS)
    head64.load_state_dict(head.state_dict())
    inputs = [x.double() for x in inputs]
    head64.train()
    with torch.no_grad():
        k = max(1, round(16 * 16 * 16 * (1 - head64.p_hard)))
        assert k == 4 and topk_margin(head64.compute_distances(inputs)[0], k) > 1e-4
    loss, parts = head64.training_step(inputs)
    loss.backward()
    assert loss.dtype == torch.float64
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert sorted(parts) == sorted(want_parts)
    for name, v in parts.items():
        assert float(v.detach()) == pytest.approx(float(want_parts[name]), rel=1e-5), name
    want_grads = state_dict_from_flat(want_grads, head64)
    for name, p in head64.named_parameters():
        err = relative_l2(p.grad.numpy(), want_grads[name].numpy())
        assert err <= F64_LIMIT, (name, err)


def _train_steps(jax_head, head, seeds):
    """One training step of each head on each seed's pyramid (the JAX step
    jitted, its reservoir updated in place by nnx)."""

    @nnx.jit
    def step(m, xs):
        return m.training_step(xs)[0]

    jax_head.train()
    head.train()
    for seed in seeds:
        jax_inputs, inputs = pyramids(seed)
        step(jax_head, jax_inputs)
        with torch.no_grad():
            head.training_step(inputs)


def test_reservoir_wraps_its_ring_and_calibrates_the_quantiles():
    jax_head, head = head_pair()
    # nothing to calibrate from yet: the quantiles stay
    before = {n: b.clone() for n, b in head.named_buffers() if n.startswith("q_")}
    head.on_validation_start()
    assert all(torch.equal(b, before[n]) for n, b in head.named_buffers() if n.startswith("q_"))

    _train_steps(jax_head, head, seeds=(4, 5))
    assert int(head.reservoir_pos) == 96 and int(head.reservoir_filled) == 96
    assert float(head.st_reservoir[96:].abs().max()) == 0.0
    _train_steps(jax_head, head, seeds=(6,))
    assert head.reservoir_pos.dtype == head.reservoir_filled.dtype == torch.int32
    assert int(head.reservoir_pos) == int(jax_head.reservoir_pos[...]) == 44
    assert int(head.reservoir_filled) == int(jax_head.reservoir_filled[...]) == 100
    for name in ("st_reservoir", "stae_reservoir"):
        want = np.asarray(getattr(jax_head, name)[...])
        assert_forward_close(getattr(head, name).numpy(), want)
        assert (want > 0).all()

    # validation writes nothing
    reservoir = head.st_reservoir.clone()
    with torch.no_grad():
        head.eval().validation_step(head.metrics_init(), pyramids(7)[1])
    assert torch.equal(head.st_reservoir, reservoir) and int(head.reservoir_pos) == 44

    jax_head.on_validation_start()
    head.on_validation_start()
    for name in ("q_st_start", "q_st_end", "q_ae_start", "q_ae_end"):
        got, want = float(getattr(head, name)), float(getattr(jax_head, name)[...])
        assert got == pytest.approx(want, rel=1e-5), name
    assert float(head.q_st_start) < float(head.q_st_end)


def test_pretrain_statistics_match_jax():
    jax_head, head = head_pair()
    jax_head.eval()
    head.eval()
    jax_state, state = jax_head.pretrain_init(), head.pretrain_init()
    for seed in (8, 9, 10):
        jax_inputs, inputs = pyramids(seed)
        jax_state = jax_head.pretrain_step(jax_state, jax_inputs)
        state = head.pretrain_step(state, inputs)
    jax_head.pretrain_end(jax_state)
    head.pretrain_end(state)
    assert head.features_mean.shape == head.feature_std.shape == (1, 16, 1, 1)
    for name in ("features_mean", "feature_std"):
        want = np.asarray(getattr(jax_head, name)[...]).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(getattr(head, name).numpy(), want, rtol=1e-5)


def test_validation_on_normal_and_anomalous_batches():
    jax_head, head = head_pair()
    jax_inputs, inputs = pyramids(11)
    jax_head.eval()
    head.eval()
    calibrate(jax_head, head, jax_head.compute_distances(jax_inputs))
    jax_state, state = jax_head.metrics_init(), head.metrics_init()
    jax_step = nnx.jit(lambda m, st, xs, t: m.validation_step(st, xs, t))
    for seed, value in ((11, 0.0), (12, 1.0)):
        jax_inputs, inputs = pyramids(seed)
        target = np.full((BATCH, 64, 64), value, np.float32)
        jax_state, want_loss, _ = jax_step(jax_head, jax_state, jax_inputs, jnp.asarray(target))
        with torch.no_grad():
            state, loss, aux = head.validation_step(state, inputs, torch.from_numpy(target))
        assert aux == {}
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    want = jax_head.validation_end(jax_state)
    got = head.validation_end(state)
    assert sorted(got) == sorted(want) == ["accuracy", "loss", "mean_iou"]
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


def _anomaly_model(seed: int):
    gen = torch.Generator().manual_seed(seed)
    bb = Backbone("resnet18", top_level=5, freeze_batchnorms=True, generator=gen)
    bb.set_frozen_levels(-1)
    head = AnomalyDetection(bb.out_channels, num_channels=16, autoencoder_channels=8, reservoir_size=2000,
                            samples_per_step=768, generator=gen)
    return SihlModel(bb, None, [head])


def test_checkpoint_in_mid_ring_round_trip(tmp_path):
    """Three steps leave the ring (2,000 entries, 768 a step) at 304, after a
    wrap; the restored trainer carries the reservoirs, position, fill and
    calibration bitwise, and its next step writes where the original's does."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(2, 3, 64, 64).astype(np.float32))
    model = _anomaly_model(0)
    batch_stats_from_data(model.backbone, x)
    trainer = Trainer(model, optimizer_kwargs={"lr": 1e-3})
    trainer.pretrain([(x, None), (x.flip(3), None)])
    for _ in range(3):
        trainer.training_step(x, None)
    trainer.validate([(x, torch.zeros(2, 64, 64))])
    head = trainer.model.heads[0]
    assert int(head.reservoir_pos) == 304 and int(head.reservoir_filled) == 2000
    assert float(head.q_st_start) != 0.0 and float(head.feature_std.min()) > 0
    save_checkpoint(trainer, str(tmp_path / "ckpt"))
    other = Trainer(_anomaly_model(1), optimizer_kwargs={"lr": 1e-3})
    restore_checkpoint(other, str(tmp_path / "ckpt"))
    for (name, b), o in zip(trainer.model.named_buffers(), other.model.buffers()):
        assert b.dtype == o.dtype and torch.equal(b, o), name
    assert other.step == trainer.step == 3
    for t in (trainer, other):
        t.training_step(x, None)
    restored = other.model.heads[0]
    assert int(restored.reservoir_pos) == int(head.reservoir_pos) == (304 + 768) % 2000
    assert torch.equal(restored.st_reservoir, head.st_reservoir)
    assert torch.equal(restored.stae_reservoir, head.stae_reservoir)
