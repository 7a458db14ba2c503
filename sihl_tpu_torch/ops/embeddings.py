"""Coordinate grids and sinusoidal position embeddings (counterpart of
``sihl_tpu/ops/embeddings.py``).

Every table is computed in f32 on ``device`` (the CPU by default) and
returned in f32; callers cast it to their compute dtype.
"""

import math

import torch


def coordinate_grid(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """2D grid of normalized pixel-center coordinates, shape (H, W, 2) = (x, y)."""
    y_min, x_min = 1.0 / height / 2.0, 1.0 / width / 2.0
    ys = torch.linspace(y_min, 1.0 - y_min, height, dtype=dtype, device=device)
    xs = torch.linspace(x_min, 1.0 - x_min, width, dtype=dtype, device=device)
    xs = torch.broadcast_to(xs[None, :], (height, width))
    ys = torch.broadcast_to(ys[:, None], (height, width))
    return torch.stack([xs, ys], dim=2)


def sine_embedding_1d(positions, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of positions; output shape positions.shape + (dim,):
    [sin, cos] of the positions at ``dim / 2`` frequencies spaced
    geometrically from 1 to ``1 / temperature``."""
    if dim % 2 != 0:
        raise ValueError(f"Embedding dimension must be even, got {dim}")
    positions = torch.atleast_1d(torch.as_tensor(positions)).to(torch.float32)
    half_dim = dim // 2
    scale = math.log(temperature) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=positions.device) * -scale)
    angles = positions[..., None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def sine_embedding_2d(height_pos, width_pos, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """2D sinusoidal embedding: half the channels embed y, half embed x."""
    if dim % 4 != 0:
        raise ValueError(f"Embedding dimension must be divisible by 4, got {dim}")
    dim_per_axis = dim // 2
    height_emb = sine_embedding_1d(height_pos, dim_per_axis, temperature)
    width_emb = sine_embedding_1d(width_pos, dim_per_axis, temperature)
    return torch.cat([height_emb, width_emb], dim=-1)


def sine_embedding_2d_grid(height: int, width: int, dim: int, temperature: float = 10000.0,
                           device=None) -> torch.Tensor:
    """Dense (H, W, dim) sinusoidal position embedding grid."""
    y_pos = torch.arange(height, dtype=torch.float32, device=device)
    x_pos = torch.arange(width, dtype=torch.float32, device=device)
    y_grid = torch.broadcast_to(y_pos[:, None], (height, width))
    x_grid = torch.broadcast_to(x_pos[None, :], (height, width))
    return sine_embedding_2d(y_grid, x_grid, dim, temperature)
