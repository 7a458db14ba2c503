"""(Sub-center) ArcFace metric-learning head (counterpart of
``sihl_tpu/heads/metric_learning.py``).

The forward is a 1x1 conv on one level, its mean over the pixels, in f32
and normalised to unit length.  Training is ArcFace over
``num_subcenters`` centres an identity: the cosine of each embedding with
each identity's nearest centre (``amax``, which splits a tie's gradient
evenly, as ``jnp.max`` does), clipped to [-1 + EPS, 1 - EPS] by
``minimum(maximum())`` (``jnp.clip``'s split gradient at a bound), the
margin added to the target's angle unless that angle exceeds pi - margin,
and the cross-entropy of the cosines scaled by sqrt(2) log(I - 1).

Validation retrieves against an explicit index set, populated through
``reset_validation_index_set`` / ``extend_validation_index_set`` before
:meth:`Trainer.validate`; the index embeddings and ids are plain
attributes, not parameters or buffers, as the JAX package keeps them.  The
six nearest index entries of each embedding come from a stable descending
sort, so equal similarities rank the lower index first, as ``lax.top_k``
ranks them; the first (the query itself, when the index holds it) is
dropped, and P@k, kNN accuracy and R-precision are counted over the rest.
"""

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from sihl_tpu_torch.heads.base import Head
from sihl_tpu_torch.layers.convblocks import default_generator, make_conv
from sihl_tpu_torch.ops.losses import cross_entropy
from sihl_tpu_torch.policy import resolve_device, upcast
from sihl_tpu_torch.training import metrics as M
from sihl_tpu_torch.utils import EPS


def _normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


class MetricLearning(Head):
    """https://arxiv.org/abs/1801.07698 (ArcFace)."""

    def __init__(
        self,
        in_channels: List[int],
        num_identities: int,
        embedding_dim: int = 256,
        level: int = 5,
        margin: float = 0.5,
        num_subcenters: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if num_identities <= 0 or embedding_dim <= 0:
            raise ValueError(f"num_identities and embedding_dim must be > 0, got {num_identities}, {embedding_dim}")
        if level >= len(in_channels):
            raise ValueError(f"level {level} is not among {len(in_channels)} inputs")
        generator = default_generator(generator)
        self.num_identities = num_identities
        self.level = level
        self.num_subcenters = num_subcenters
        self.embed_conv = make_conv(in_channels[level], embedding_dim, 1, generator=generator, device=device)
        self.scale = math.sqrt(2) * math.log(num_identities - 1)
        self.margin = margin
        # flax glorot_uniform(in_axis=1, out_axis=2): the sub-centre axis is
        # the receptive field, so fan_in + fan_out = (E + I) * S
        limit = math.sqrt(6.0 / ((embedding_dim + num_identities) * num_subcenters))
        weight = torch.rand((num_subcenters, embedding_dim, num_identities), generator=generator) * 2 * limit - limit
        self.weight = nn.Parameter(weight.to(resolve_device(device)))
        self.index_embeddings: Optional[torch.Tensor] = None
        self.index_ids: Optional[torch.Tensor] = None
        self.output_shapes = {"embeddings": ("batch_size", embedding_dim)}

    def forward(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        """(B, embedding_dim) unit-length embeddings in f32 (f64 for the f64
        compute dtype)."""
        x = upcast(self.embed_conv(inputs[self.level]).mean(dim=(2, 3)))
        return _normalize(x, dim=1)

    def training_step(self, inputs, targets: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """targets: (B,) integer identities."""
        feats = self(inputs)
        w = _normalize(self.weight.to(feats.dtype), dim=1)
        cos_theta = torch.einsum("be,sei->sbi", feats, w).amax(dim=0)  # (B, I)
        lo, hi = (torch.full((), v, dtype=cos_theta.dtype, device=cos_theta.device) for v in (-1 + EPS, 1 - EPS))
        theta = torch.arccos(torch.minimum(torch.maximum(cos_theta, lo), hi))
        one_hot = targets[:, None] == torch.arange(self.num_identities, device=targets.device)
        selected = one_hot & ~(theta > math.pi - self.margin)
        logits = torch.cos(torch.where(selected, theta + self.margin, theta)) * self.scale
        return cross_entropy(logits, targets).mean(), {}

    # -- retrieval index hooks ---------------------------------------------
    def reset_validation_index_set(self) -> None:
        self.index_embeddings = None
        self.index_ids = None

    def extend_validation_index_set(self, inputs, ids) -> None:
        with torch.no_grad():
            emb = self(inputs)
        ids = torch.as_tensor(ids, device=emb.device)
        if self.index_embeddings is None:
            self.index_embeddings, self.index_ids = emb, ids
        else:
            self.index_embeddings = torch.cat([self.index_embeddings, emb])
            self.index_ids = torch.cat([self.index_ids, ids])

    def metrics_init(self):
        device = self._device()
        zero = torch.zeros((), dtype=torch.float32, device=device)
        state = {"loss": M.mean_init(device), "count": zero}
        for k in (1, 3, 5):
            state[f"p_at_{k}"] = M.mean_init(device)
            state[f"knn_{k}"] = zero
        state["r_precision"] = M.mean_init(device)
        return state

    def validation_step(self, state, inputs, targets):
        if self.index_embeddings is None:
            raise RuntimeError("populate the index set via extend_validation_index_set first")
        embeddings = self(inputs)
        batch = embeddings.shape[0]
        sims = embeddings @ self.index_embeddings.T  # (B, N)
        k6 = min(sims.shape[1], 6)
        top_idx = torch.sort(sims, dim=1, descending=True, stable=True)[1][:, :k6]
        top_ids = self.index_ids[top_idx]
        # drop rank 0 (the query itself, when the index holds it)
        relevant = (top_ids[:, 1:] == targets[:, None]).float()  # (B, <= 5)
        n_cand = relevant.shape[1]

        new_state = dict(state)
        for k in (1, 3, 5):
            kk = min(k, n_cand)
            p_at_k = (relevant[:, :kk].sum(dim=1) / kk).mean()
            new_state[f"p_at_{k}"] = M.mean_update(state[f"p_at_{k}"], p_at_k, batch)
            new_state[f"knn_{k}"] = state[f"knn_{k}"] + relevant[:, :kk].sum()
        # R-precision: the precision at rank R, R the relevant candidates' count
        r = relevant.sum(dim=1).long()
        cums = torch.cumsum(relevant, dim=1)
        at_r = torch.take_along_dim(cums, torch.clamp(r - 1, min=0)[:, None], dim=1)[:, 0]
        r_prec = torch.where(r > 0, at_r / torch.clamp(r, min=1), 0.0)
        new_state["r_precision"] = M.mean_update(state["r_precision"], r_prec.mean(), batch)
        new_state["count"] = state["count"] + batch
        new_state["loss"] = M.mean_update(state["loss"], 0.0)
        return new_state, torch.zeros((), device=embeddings.device), {}

    def validation_end(self, state, collected=()) -> Dict[str, float]:
        out = {"loss": float(M.mean_compute(state["loss"]))}
        n = max(float(state["count"]), 1.0)
        for k in (1, 3, 5):
            out[f"precision_at_{k}"] = float(M.mean_compute(state[f"p_at_{k}"]))
            out[f"{k}nn_accuracy"] = float(state[f"knn_{k}"]) / n / k
        out["r_precision"] = float(M.mean_compute(state["r_precision"]))
        return out
