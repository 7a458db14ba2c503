"""Transformer encoder and decoder layers (counterpart of
``sihl_tpu/layers/transformer.py``): the HybridEncoder's one-layer encoder
on the stride-32 map and the text-recognition head's decoder.

Attention is flax's ``nnx.MultiHeadAttention`` without dropout, which runs
``jax.nn.dot_product_attention``'s XLA path: per head, the logits
``q k^T`` in f32 (products of the compute-dtype operands summed in f32),
scaled by ``1 / sqrt(head_dim)`` after the product, an f32 softmax over the
keys, the probabilities cast back to the compute dtype and multiplied by
the values.  It is written out as those products and that softmax, on the
CPU and on the card alike; the projections are linear layers whose
outputs split into (heads, head_dim), heads first, as flax's ``LinearGeneral``
lays out its (in, heads, head_dim) kernel.

LayerNorms are :class:`~sihl_tpu_torch.layers.mlp.LayerNorm` (eps 1e-5 as
passed, statistics in f32); ``gelu`` is the tanh approximation
(``jax.nn.gelu``'s default).  The feed-forward's activation is the
attribute ``act``, so that a caller may wrap a ReLU on a raw output.
"""

from typing import Optional

import torch
from torch import nn

from sihl_tpu_torch.layers.convblocks import _ACTS, default_generator
from sihl_tpu_torch.layers.mlp import LayerNorm, Linear
from sihl_tpu_torch.policy import upcast


class SplitHeadsLinear(Linear):
    """A query, key or value projection: ``Linear(in, heads * head_dim)``
    whose output splits into (heads, head_dim).  flax keeps its kernel as
    (in, heads, head_dim) and its bias as (heads, head_dim)."""


class MergeHeadsLinear(Linear):
    """The output projection: ``Linear(heads * head_dim, out)`` over the
    merged heads.  flax keeps its kernel as (heads, head_dim, out)."""


class MultiHeadAttention(nn.Module):
    """``nnx.MultiHeadAttention(num_heads, in_features=dim, qkv_features=dim,
    out_features=dim)`` without dropout or masks: ``forward(inputs_q,
    inputs_k)`` with (B, T, dim) queries and (B, S, dim) keys and values."""

    def __init__(self, dim: int, num_heads: int, *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator = default_generator(generator)
        if dim % num_heads:
            raise ValueError(f"Memory dimension ({dim}) must be divisible by 'num_heads' heads ({num_heads}).")
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.query = SplitHeadsLinear(dim, dim, generator=generator, device=device)
        self.key = SplitHeadsLinear(dim, dim, generator=generator, device=device)
        self.value = SplitHeadsLinear(dim, dim, generator=generator, device=device)
        self.out = MergeHeadsLinear(dim, dim, generator=generator, device=device)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, heads * head_dim) → (B, heads, L, head_dim)."""
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, inputs_q: torch.Tensor, inputs_k: torch.Tensor) -> torch.Tensor:
        q = self._heads(self.query(inputs_q))
        k = self._heads(self.key(inputs_k))
        v = self._heads(self.value(inputs_k))
        logits = torch.matmul(upcast(q), upcast(k).transpose(2, 3)) * (1.0 / self.head_dim**0.5)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        x = torch.matmul(probs, v).transpose(1, 2)
        return self.out(x.reshape(x.shape[0], x.shape[1], -1))


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, activation: str, *, generator: torch.Generator, device=None):
        super().__init__()
        self.linear1 = Linear(dim, hidden_dim, generator=generator, device=device)
        self.linear2 = Linear(hidden_dim, dim, generator=generator, device=device)
        self.act = _ACTS[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.act(self.linear1(x)))


class TransformerEncoderLayer(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        ff_dim: Optional[int] = None,
        activation: str = "gelu",
        norm_first: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        generator = default_generator(generator)
        ff_dim = ff_dim if ff_dim is not None else 4 * dim
        self.self_attn = MultiHeadAttention(dim, num_heads, generator=generator, device=device)
        self.ff = _FeedForward(dim, ff_dim, activation, generator=generator, device=device)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.norm_first = norm_first

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_first:
            h = self.norm1(x)
            x = x + self.self_attn(h, h)
            x = x + self.ff(self.norm2(x))
        else:
            x = self.norm1(x + self.self_attn(x, x))
            x = self.norm2(x + self.ff(x))
        return x


class TransformerDecoderLayer(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        ff_dim: Optional[int] = None,
        activation: str = "relu",
        norm_first: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        generator = default_generator(generator)
        ff_dim = ff_dim if ff_dim is not None else 4 * dim
        self.self_attn = MultiHeadAttention(dim, num_heads, generator=generator, device=device)
        self.cross_attn = MultiHeadAttention(dim, num_heads, generator=generator, device=device)
        self.ff = _FeedForward(dim, ff_dim, activation, generator=generator, device=device)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.norm3 = LayerNorm(dim, eps=1e-5, device=device)
        self.norm_first = norm_first

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        if self.norm_first:
            h = self.norm1(tgt)
            tgt = tgt + self.self_attn(h, h)
            h = self.norm2(tgt)
            tgt = tgt + self.cross_attn(h, memory)
            tgt = tgt + self.ff(self.norm3(tgt))
        else:
            tgt = self.norm1(tgt + self.self_attn(tgt, tgt))
            tgt = self.norm2(tgt + self.cross_attn(tgt, memory))
            tgt = self.norm3(tgt + self.ff(tgt))
        return tgt
