"""Non-autoregressive text recognition head, HRGA style (counterpart of
``sihl_tpu/heads/text_recognition.py``): the globally pooled visual
encoding is repeated as L parallel queries, a transformer decoder
cross-attends over the flattened feature map, and every position is
classified in one shot.

Targets are padded token grids (B, L) with pad id ``num_tokens``, which is
a class of the ``num_tokens + 1`` logits like any other.  The memory is the
level's pixels in row-major (H, W) order, as the JAX package flattens its
NHWC map.  The position table is added before a :class:`Dropout` that
draws from the head's own stream (``layers/dropout.py``).  The decoder's
feed-forward ReLUs are ``ff.act`` of each layer, so a caller may wrap them.
"""

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.layers.convblocks import StandardConvNormAct, default_generator
from sihl_tpu_torch.layers.dropout import Dropout
from sihl_tpu_torch.layers.mlp import Linear
from sihl_tpu_torch.layers.transformer import TransformerDecoderLayer
from sihl_tpu_torch.ops.losses import cross_entropy
from sihl_tpu_torch.policy import resolve_device, upcast
from sihl_tpu_torch.training import metrics as M
from sihl_tpu_torch.utils.text_metrics import token_error_rate, total_edit_distance


def sinusoidal_position_table(max_len: int, dim: int) -> np.ndarray:
    """(max_len, dim) f32: sin in the even channels, cos in the odd ones, at
    frequencies ``10000 ** (-2i / dim)``."""
    position = np.arange(max_len)[:, None]
    div_term = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class TextRecognition(Head):
    """https://arxiv.org/abs/1904.01375 (holistic-representation decoding)."""

    def __init__(
        self,
        in_channels: List[int],
        num_tokens: int,
        max_sequence_length: int,
        level: int = 3,
        num_channels: int = 256,
        num_layers: int = 1,
        num_heads: int = 4,
        embedding_dim: int = 1024,
        dropout: float = 0.1,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if num_tokens <= 0 or max_sequence_length <= 0:
            raise ValueError(f"num_tokens and max_sequence_length must be > 0, got {num_tokens}, {max_sequence_length}")
        if level >= len(in_channels):
            raise ValueError(f"level {level} is not among {len(in_channels)} inputs")
        generator = default_generator(generator)
        self.num_tokens = num_tokens
        self.max_sequence_length = max_sequence_length
        self.level = level
        self.pad = num_tokens

        self.visual_encoding = StandardConvNormAct(
            in_channels[level], num_channels, 1, act="silu", generator=generator, device=device)
        self.lateral_conv = StandardConvNormAct(
            in_channels[level], num_channels, 1, act="silu", generator=generator, device=device)
        self.dropout = Dropout(dropout, generator=generator, device=device)
        self.decoder_layers = nn.ModuleList(
            TransformerDecoderLayer(num_channels, num_heads=num_heads, ff_dim=embedding_dim, activation="relu",
                                    norm_first=False, generator=generator, device=device)
            for _ in range(num_layers)
        )
        self.token_projection = Linear(num_channels, num_tokens + 1, generator=generator, device=device)
        table = torch.from_numpy(sinusoidal_position_table(max_sequence_length, num_channels))
        self.register_buffer("pos_table", table.to(resolve_device(device)), persistent=False)
        self.output_shapes = {
            "scores": ("batch_size", max_sequence_length),
            "tokens": ("batch_size", max_sequence_length),
        }

    def logits(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        """(B, L, num_tokens + 1) logits in the compute dtype."""
        x = inputs[self.level]
        b, _, h, w = x.shape
        # the mean over the pixels first, then the 1x1 conv block
        pooled = x.mean(dim=(2, 3), keepdim=True)
        visual = self.visual_encoding(pooled).reshape(b, 1, -1)
        queries = visual.expand(b, self.max_sequence_length, visual.shape[-1])
        memory = self.lateral_conv(x).permute(0, 2, 3, 1).reshape(b, h * w, -1)
        y = self.dropout(queries + self.pos_table[None].to(queries.dtype))
        for layer in self.decoder_layers:
            y = layer(y, memory)
        return self.token_projection(y)

    def forward(self, inputs: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores, tokens): each position's largest f32 logit and its token
        id (the lowest among equal logits), both (B, L)."""
        logits = upcast(self.logits(inputs))
        return logits.amax(dim=2), torch.argmax(logits, dim=2)

    def training_step(self, inputs, texts: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """texts: (B, max_sequence_length) int tokens padded with ``num_tokens``."""
        loss = torch.nan_to_num(cross_entropy(self.logits(inputs), texts), nan=0.0)
        return loss.mean(), {}

    def metrics_init(self):
        return {"loss": M.mean_init(self._device())}

    def validation_step(self, state, inputs, texts):
        scores, tokens = self(inputs)
        loss, _ = self.training_step(inputs, texts)
        state = {"loss": M.mean_update(state["loss"], loss)}
        return state, loss, {"pred_tokens": tokens, "gt_tokens": texts}

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        preds, gts = [], []
        for aux in collected:
            for p, t in zip(np.asarray(aux["pred_tokens"]), np.asarray(aux["gt_tokens"])):
                preds.append([int(v) for v in p if v != self.pad])
                gts.append([int(v) for v in t if v != self.pad])
        matches = [p == t for p, t in zip(preds, gts)]
        return {
            "loss": float(M.mean_compute(state["loss"])),
            "token_error_rate": token_error_rate(preds, gts),
            "edit_distance": total_edit_distance(preds, gts),
            "accuracy": sum(matches) / max(len(matches), 1),
        }
