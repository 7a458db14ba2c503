"""Parity of the port's text-recognition and metric-learning heads
(``heads/text_recognition.py``, ``heads/metric_learning.py``) and of its
copy of ``utils/text_metrics.py`` with the JAX package's, on the CPU; the
port's dropout (``layers/dropout.py``) on its own; the bridge's rules for
the heads' leaves.

Heads on a synthetic pyramid of 4 images at 64 px, each image with its own
contrast and brightness (the text head's train-mode BatchNorm runs on the
level's mean over its pixels, one sample an image, whose f32 fast variance
cancels when the samples are nearly equal): the text head reads level 3
(8 x 8, 32 channels) at 16 channels, 4 heads, a 32-wide feed-forward, 5
tokens and sequences of 6; the metric head reads level 4 (4 x 4, 64
channels) with 8-dimensional embeddings, 6 identities and 2 sub-centres.
Both packages' text heads are built with dropout 0 for the comparisons:
their random streams cannot agree.  Tolerances: forwards and losses within
1e-5 relative; the gradients of the port's f64 and f32 steps within
relative L2 1e-3 of JAX's jitted f32 step, the heads' limit of the slice
tests; validation metrics within 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.heads import MetricLearning as JaxMetricLearning
from sihl_tpu.heads import TextRecognition as JaxTextRecognition
from sihl_tpu.heads.text_recognition import sinusoidal_position_table as jax_position_table
from sihl_tpu.utils import text_metrics as jax_text_metrics
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import MetricLearning, TextRecognition
from sihl_tpu_torch.heads.text_recognition import sinusoidal_position_table
from sihl_tpu_torch.layers.dropout import Dropout
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.utils import text_metrics

from test_torch_convblocks import assert_forward_close, randomize_all_norms, relative_l2
from torch_parity import flat_state, to_torch

BATCH, TOKENS, LENGTH, IDENTITIES = 4, 5, 6, 6
HEAD_GRAD_REL = 1e-3
TEXT_KW = dict(level=3, num_channels=16, num_heads=4, embedding_dim=32, dropout=0.0)
METRIC_KW = dict(embedding_dim=8, level=4, num_subcenters=2)


def pyramids(seed: int):
    rng = np.random.RandomState(seed)
    gain, shift = rng.uniform(0.25, 1.0, (BATCH, 1, 1, 1)), rng.uniform(0.0, 0.75, (BATCH, 1, 1, 1))
    levels = [(p * gain + shift).astype(np.float32) for p in make_pyramid(batch_size=BATCH, rng=rng)]
    return [jnp.asarray(p) for p in levels], [to_torch(p) for p in levels]


def in_channels():
    return [p.shape[-1] for p in make_pyramid(batch_size=1)]


def texts(seed: int) -> np.ndarray:
    """(B, LENGTH) token grids of 1-LENGTH tokens, padded with TOKENS."""
    rng = np.random.RandomState(seed)
    out = np.full((BATCH, LENGTH), TOKENS, np.int32)
    for b in range(BATCH):
        n = rng.randint(1, LENGTH + 1)
        out[b, :n] = rng.randint(0, TOKENS, n)
    return out


def head_pair(kind: str, dtype=torch.float32):
    if kind == "text":
        jax_head = JaxTextRecognition(in_channels(), TOKENS, LENGTH, **TEXT_KW, rngs=nnx.Rngs(0))
        build = lambda: TextRecognition(in_channels(), TOKENS, LENGTH, **TEXT_KW)  # noqa: E731
    else:
        jax_head = JaxMetricLearning(in_channels(), IDENTITIES, **METRIC_KW, rngs=nnx.Rngs(1))
        build = lambda: MetricLearning(in_channels(), IDENTITIES, **METRIC_KW)  # noqa: E731
    randomize_all_norms(jax_head, np.random.RandomState(2))
    for _, sub in nnx.iter_graph(jax_head):
        if isinstance(sub, nnx.LayerNorm):
            sub.scale[...] = jnp.asarray(np.random.RandomState(3).uniform(0.8, 1.2, sub.scale[...].shape), jnp.float32)
    with compute_dtype_scope(dtype):
        head = build()
    head.load_state_dict(state_dict_from_flat(flat_state(jax_head), head), strict=True)
    return jax_head, head


def targets(kind: str, seed: int):
    t = texts(seed) if kind == "text" else np.random.RandomState(seed).randint(0, IDENTITIES, BATCH)
    return jnp.asarray(t), torch.from_numpy(t)


# -- forward and training step -------------------------------------------------------


@pytest.mark.parametrize("kind", ["text", "metric"])
def test_forward(kind):
    jax_head, head = head_pair(kind)
    jax_inputs, inputs = pyramids(0)
    jax_head.eval()
    want = jax_head(jax_inputs)
    with torch.no_grad():
        got = head.eval()(inputs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert head.output_shapes == jax_head.output_shapes
    for (name, shape), g, w in zip(head.output_shapes.items(), got, want):
        assert tuple(g.shape) == tuple(BATCH if isinstance(d, str) else d for d in shape), name
        if g.is_floating_point():
            assert g.dtype == torch.float32
            assert_forward_close(g.numpy(), w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if kind == "metric":
        np.testing.assert_allclose(np.linalg.norm(got[0].numpy(), axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("kind", ["text", "metric"])
def test_training_step(kind):
    """The loss and every parameter's gradient in train mode (dropout 0), the
    port in f64 and in f32; the running statistics after the step."""
    jax_head = head_pair(kind)[0]
    jax_inputs, inputs = pyramids(3)
    jax_target, target = targets(kind, 3)
    jax_head.train()

    @nnx.jit
    def value_and_grad(m, xs, t):
        return nnx.value_and_grad(lambda mm: mm.training_step(xs, t)[0])(m)

    want, grads = value_and_grad(jax_head, jax_inputs, jax_target)
    flat_grads = {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(grads)}
    for dtype in (torch.float64, torch.float32):
        head = head_pair(kind, dtype)[1]
        want_grads = state_dict_from_flat(flat_grads, head)
        loss, metrics = head.train().training_step([x.to(dtype) for x in inputs], target)
        loss.backward()
        assert metrics == {} and loss.dtype == (torch.float64 if dtype == torch.float64 else torch.float32)
        assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
        largest = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
        for name, p in head.named_parameters():
            if name.endswith("key.bias"):  # zero in exact arithmetic (tests/test_torch_transformer.py)
                assert max(float(p.grad.norm()), float(want_grads[name].norm())) <= 1e-6 * largest, name
                continue
            err = relative_l2(p.grad.numpy(), want_grads[name].numpy())
            assert err <= HEAD_GRAD_REL, (dtype, name, err)
        jax_stats = state_dict_from_flat(flat_state(jax_head), head)
        for name, b in head.named_buffers():
            if name != "pos_table":  # a constant, not state
                np.testing.assert_allclose(b.double().numpy(), jax_stats[name].numpy(), rtol=1e-5, atol=1e-7)


def test_text_loss_counts_the_pad_as_a_class():
    """Padding is ``num_tokens``, a class of the ``num_tokens + 1`` logits: a
    grid of pads alone has a finite, nonzero loss, as in JAX."""
    jax_head, head = head_pair("text")
    jax_inputs, inputs = pyramids(6)
    pads = np.full((BATCH, LENGTH), TOKENS, np.int32)
    jax_head.eval()
    want, _ = jax_head.training_step(jax_inputs, jnp.asarray(pads))
    with torch.no_grad():
        got, _ = head.eval().training_step(inputs, torch.from_numpy(pads))
    assert float(got) > 0 and float(got) == pytest.approx(float(want), rel=1e-5)


# -- validation ------------------------------------------------------------------------


def test_text_validation():
    """Two batches; the second batch's first two rows are the head's own
    predictions (one of them with a token changed), so that accuracy and the
    edit distances lie strictly between their bounds."""
    jax_head, head = head_pair("text")
    jax_head.eval()
    head.eval()
    jax_state, state = jax_head.metrics_init(), head.metrics_init()
    jax_collected, collected = [], []
    for seed in (4, 5):
        jax_inputs, inputs = pyramids(seed)
        t = texts(seed)
        if seed == 5:
            with torch.no_grad():
                own = head(inputs)[1].numpy()
            t[:2] = own[:2]
            t[1, 0] = (t[1, 0] + 1) % TOKENS
        jax_state, want_loss, want_aux = jax_head.validation_step(jax_state, jax_inputs, jnp.asarray(t))
        with torch.no_grad():
            state, loss, aux = head.validation_step(state, inputs, torch.from_numpy(t))
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
        assert sorted(aux) == sorted(want_aux) == ["gt_tokens", "pred_tokens"]
        np.testing.assert_array_equal(aux["pred_tokens"].numpy(), np.asarray(want_aux["pred_tokens"]))
        jax_collected.append({k: np.asarray(v) for k, v in want_aux.items()})
        collected.append({k: v.numpy() for k, v in aux.items()})
    want = jax_head.validation_end(jax_state, jax_collected)
    got = head.validation_end(state, collected)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    assert 0 < got["accuracy"] < 1 and got["edit_distance"] > 0


def test_text_metrics_copy():
    rng = np.random.RandomState(7)
    preds = [list(rng.randint(0, 4, rng.randint(0, 7))) for _ in range(20)] + [[]]
    gts = [list(rng.randint(0, 4, rng.randint(0, 7))) for _ in range(20)] + [[1, 2]]
    for a, b in zip(preds, gts):
        assert text_metrics.levenshtein(a, b) == jax_text_metrics.levenshtein(a, b)
    assert text_metrics.levenshtein("kitten", "sitting") == 3
    assert text_metrics.token_error_rate(preds, gts) == jax_text_metrics.token_error_rate(preds, gts)
    assert text_metrics.total_edit_distance(preds, gts) == jax_text_metrics.total_edit_distance(preds, gts)
    assert text_metrics.total_edit_distance([], []) == 0.0


def test_position_table():
    for max_len, dim in ((6, 16), (12, 256)):
        np.testing.assert_array_equal(sinusoidal_position_table(max_len, dim), jax_position_table(max_len, dim))


def _index(jax_head, head, seed: int, ids: np.ndarray):
    jax_inputs, inputs = pyramids(seed)
    jax_head.extend_validation_index_set(jax_inputs, jnp.asarray(ids))
    head.extend_validation_index_set(inputs, torch.from_numpy(ids))


def test_metric_index_and_validation():
    """The index holds batch 8 twice, under its own ids and under other ids,
    and batch 9: each query of batch 8 meets its two copies at equal
    similarity, and the lower index (its own id) must rank first, as
    ``lax.top_k`` ranks it, and drop as the query itself."""
    jax_head, head = head_pair("metric")
    jax_head.eval()
    head.eval()
    ids = np.array([0, 1, 2, 1], np.int32)
    _index(jax_head, head, 8, ids)
    _index(jax_head, head, 8, (ids + 3) % IDENTITIES)
    _index(jax_head, head, 9, np.array([1, 0, 1, 2], np.int32))
    np.testing.assert_allclose(head.index_embeddings.numpy(), np.asarray(jax_head.index_embeddings), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(head.index_ids.numpy(), np.asarray(jax_head.index_ids))
    assert not any(n.startswith("index") for n in head.state_dict())
    jax_state, state = jax_head.metrics_init(), head.metrics_init()
    for seed, t in ((8, ids), (9, np.array([1, 1, 0, 2], np.int32))):
        jax_inputs, inputs = pyramids(seed)
        jax_state, want_loss, want_aux = jax_head.validation_step(jax_state, jax_inputs, jnp.asarray(t))
        with torch.no_grad():
            state, loss, aux = head.validation_step(state, inputs, torch.from_numpy(t))
        assert aux == {} == want_aux and float(loss) == float(want_loss) == 0.0
    want = jax_head.validation_end(jax_state)
    got = head.validation_end(state)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    # the tie: queries of batch 8 rank their own copy first, so the second
    # copy (another id) is every query's first candidate, never relevant
    with torch.no_grad():
        sims = head(pyramids(8)[1]) @ head.index_embeddings.T
    top = torch.sort(sims, dim=1, descending=True, stable=True)[1][:, :2]
    assert torch.equal(sims.gather(1, top)[:, 0], sims.gather(1, top)[:, 1])
    np.testing.assert_array_equal(top.numpy(), np.stack([np.arange(BATCH), np.arange(BATCH) + BATCH], axis=1))
    head.reset_validation_index_set()
    assert head.index_embeddings is None and head.index_ids is None
    with pytest.raises(RuntimeError, match="extend_validation_index_set"):
        head.validation_step(head.metrics_init(), pyramids(8)[1], torch.from_numpy(ids))


# -- dropout ----------------------------------------------------------------------------


def test_dropout():
    """The kept share within five standard deviations of 1 - rate, kept
    elements scaled by 1 / (1 - rate) and the rest 0; the identity in eval
    mode and at rate 0; the same masks from the same seed; the stream
    carried by the state dict."""
    rate, n = 0.25, 200_000
    x = torch.rand(n) + 0.5
    drop = Dropout(rate, generator=torch.Generator().manual_seed(0)).train()
    y = drop(x)
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=0, atol=0)
    assert not torch.equal(drop(x) != 0, kept)  # the next call draws a new mask
    twin = Dropout(rate, generator=torch.Generator().manual_seed(0)).train()
    assert torch.equal(twin(x) != 0, kept)
    assert drop.eval()(x) is x and Dropout(0.0).train()(x) is x
    state = drop.state_dict()
    assert list(state) == ["rng"] and state["rng"].tolist() == [drop.seed, 2]
    other = Dropout(rate, generator=torch.Generator().manual_seed(5)).train()
    other.load_state_dict(state, strict=True)
    assert torch.equal(other(x), drop.train()(x))
    with pytest.raises(ValueError):
        Dropout(1.0)


def test_text_head_dropout_trains_and_serves():
    """With dropout 0.1 the train-mode logits differ from eval's; eval's
    equal a dropout-0 head's; the stream rides in the head's state dict."""
    with compute_dtype_scope(torch.float32):
        head = TextRecognition(in_channels(), TOKENS, LENGTH, **{**TEXT_KW, "dropout": 0.1})
    still = TextRecognition(in_channels(), TOKENS, LENGTH, **TEXT_KW)
    still.load_state_dict(head.state_dict(), strict=True)
    inputs = pyramids(10)[1]
    with torch.no_grad():
        head.eval()
        torch.testing.assert_close(head.logits(inputs), still.eval().logits(inputs), rtol=0, atol=0)
        trained = head.train().logits(inputs)
        head.eval()
        assert not torch.allclose(trained, head.logits(inputs))
    assert head.state_dict()["dropout.rng"][1] == 1


# -- the bridge's rules ---------------------------------------------------------------


def test_bridge_rules_for_the_heads():
    """The metric head's rank-3 root ``weight`` crosses as it is, the text
    head's attention biases (heads, head_dim) flatten; the dropout's
    ``RngKey`` / ``RngCount`` leaves have no counterpart, so they are left
    out of the flat state (``flat_state``), and the bridge refuses them."""
    jax_metric, metric = head_pair("metric")
    flat = flat_state(jax_metric)
    assert flat["weight"].shape == (2, 8, IDENTITIES)
    np.testing.assert_array_equal(metric.weight.detach().numpy(), flat["weight"])
    jax_text = JaxTextRecognition(in_channels(), TOKENS, LENGTH, **{**TEXT_KW, "dropout": 0.1}, rngs=nnx.Rngs(0))
    flat = flat_state(jax_text)
    assert flat["decoder_layers.0.cross_attn.value.bias"].shape == (4, 4)
    text = TextRecognition(in_channels(), TOKENS, LENGTH, **{**TEXT_KW, "dropout": 0.1})
    sd = state_dict_from_flat(flat, text)
    np.testing.assert_array_equal(sd["decoder_layers.0.cross_attn.value.bias"].numpy(),
                                  flat["decoder_layers.0.cross_attn.value.bias"].reshape(-1))
    text.load_state_dict(sd, strict=True)
    rng_leaves = {".".join(map(str, p)): v for p, v in nnx.to_flat_state(nnx.state(jax_text, nnx.RngState))}
    assert sorted(rng_leaves) == ["dropout.rngs.count", "dropout.rngs.key"] and not set(rng_leaves) & set(flat)
    with pytest.raises(KeyError, match="count"):
        state_dict_from_flat({"dropout.rngs.count": np.asarray(rng_leaves["dropout.rngs.count"][...])}, text)
