"""3D rotary position tables (hyvideo_prfl_tpu/models/rope.py).

Tables are built host-side in float64 numpy and cast to fp32, exactly as
the JAX package does, so the two agree bit for bit. q and k stay in the
JAX "half" layout (x[..., i] pairs with x[..., D/2 + i]); checkpoints in
the reference's adjacent-pair layout are permuted at load time
(utils/checkpoint.py), which leaves attention unchanged because q and k
permute together.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=32)
def rope_tables_np(grid: tuple, head_dim: int, theta: float = 10000.0):
    """cos/sin tables for an (F, H, W) grid, each [L, head_dim // 2] fp32.

    Row-major token order (w fastest), matching patchify. The half-dim
    c = head_dim / 2 splits into bands (c - 2 (c // 3), c // 3, c // 3)
    for (t, h, w)."""
    f, h, w = grid
    c = head_dim // 2
    ct = c - 2 * (c // 3)
    ch = c // 3
    cw = c // 3

    def freqs(n_pos, dim):
        inv = 1.0 / np.power(theta, np.arange(0, dim, dtype=np.float64) / dim)
        return np.outer(np.arange(n_pos, dtype=np.float64), inv)

    ang_t = freqs(f, ct)
    ang_h = freqs(h, ch)
    ang_w = freqs(w, cw)
    ang = np.concatenate(
        [
            np.broadcast_to(ang_t[:, None, None, :], (f, h, w, ct)),
            np.broadcast_to(ang_h[None, :, None, :], (f, h, w, ch)),
            np.broadcast_to(ang_w[None, None, :, :], (f, h, w, cw)),
        ],
        axis=-1,
    ).reshape(f * h * w, c)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rope_permutation(head_dim: int) -> np.ndarray:
    """Index map from the reference's adjacent-pair layout to the half
    layout: ours[..., i] = ref[..., 2i], ours[..., D/2 + i] = ref[..., 2i+1],
    so gather old indices [0, 2, 4, ..., 1, 3, 5, ...]."""
    return np.concatenate([np.arange(0, head_dim, 2),
                           np.arange(1, head_dim, 2)])


@functools.lru_cache(maxsize=32)
def rope_tables_rolled_np(grid: tuple, head_dim: int, theta: float = 10000.0):
    """Expanded [L, D] tables C = [cos|cos], S = [-sin|sin] for the roll
    formulation out = x * C + roll(x, D/2) * S."""
    cos, sin = rope_tables_np(grid, head_dim, theta)
    return (np.concatenate([cos, cos], axis=-1),
            np.concatenate([-sin, sin], axis=-1))
