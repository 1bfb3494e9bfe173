"""3-D rotary positional tables for CogVideoX-style video DiTs.

Port of `tokensgen_tpu/core/rope.py`. The static tables are built in numpy
exactly as there and returned as float32 tensors on ``device``;
`get_3d_rotary_pos_embed_v2_torch` builds them from grids that are tensors
(the FIFO sampler's rolling temporal grids).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

Rope = Tuple[torch.Tensor, torch.Tensor]  # (cos, sin), each [S, D] or [B, S, D]


def get_1d_rotary_pos_embed(dim: int, pos: np.ndarray, theta: float = 10000.0):
    """cos/sin numpy tables of shape [len(pos), dim], pair-interleaved."""
    assert dim % 2 == 0, dim
    pos = np.asarray(pos, dtype=np.float32)
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    angles = np.outer(pos, freqs)
    cos = np.repeat(np.cos(angles), 2, axis=1).astype(np.float32)
    sin = np.repeat(np.sin(angles), 2, axis=1).astype(np.float32)
    return cos, sin


def _combine_thw(ft, fh, fw):
    out = []
    for i in range(2):  # cos, sin
        t, h, w = ft[i], fh[i], fw[i]
        T, H, W = t.shape[0], h.shape[0], w.shape[0]
        t = np.broadcast_to(t[:, None, None, :], (T, H, W, t.shape[-1]))
        h = np.broadcast_to(h[None, :, None, :], (T, H, W, h.shape[-1]))
        w = np.broadcast_to(w[None, None, :, :], (T, H, W, w.shape[-1]))
        out.append(np.concatenate([t, h, w], axis=-1).reshape(T * H * W, -1))
    return out[0], out[1]


def get_3d_rotary_pos_embed(
    embed_dim: int,
    crops_coords: Tuple[Sequence[float], Sequence[float]],
    grid_size: Tuple[int, int, int],
    theta: float = 10000.0,
    device=None,
) -> Rope:
    """3-D rotary tables over a cropped (f, h, w) region."""
    start, stop = crops_coords
    nt, nh, nw = grid_size
    grid_t = np.linspace(start[0], stop[0], nt, endpoint=False, dtype=np.float32)
    grid_h = np.linspace(start[1], stop[1], nh, endpoint=False, dtype=np.float32)
    grid_w = np.linspace(start[2], stop[2], nw, endpoint=False, dtype=np.float32)
    return get_3d_rotary_pos_embed_v2(embed_dim, grid_t, grid_h, grid_w, theta=theta,
                                      device=device)


def get_3d_rotary_pos_embed_v2(
    embed_dim: int,
    grid_t: np.ndarray,
    grid_h: np.ndarray,
    grid_w: np.ndarray,
    dim_t: int | None = None,
    dim_h: int | None = None,
    dim_w: int | None = None,
    theta: float = 10000.0,
    device=None,
) -> Rope:
    """3-D rotary tables from raw per-axis position grids (numpy)."""
    dim_t = embed_dim // 4 if dim_t is None else dim_t
    dim_h = embed_dim // 8 * 3 if dim_h is None else dim_h
    dim_w = embed_dim // 8 * 3 if dim_w is None else dim_w
    ft = get_1d_rotary_pos_embed(dim_t, grid_t, theta)
    fh = get_1d_rotary_pos_embed(dim_h, grid_h, theta)
    fw = get_1d_rotary_pos_embed(dim_w, grid_w, theta)
    cos, sin = _combine_thw(ft, fh, fw)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def apply_rotary_emb(x: torch.Tensor, freqs: Rope) -> torch.Tensor:
    """Interleaved rotary embedding on ``x`` [..., S, D] in float32,
    ``(x0, x1) -> (-x1, x0)``; tables [S, D] or batched [B, S, D]."""
    cos, sin = freqs
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    elif cos.dim() == 3:
        cos, sin = cos[:, None], sin[:, None]
    xf = x.float()
    pair = xf.reshape(*xf.shape[:-1], -1, 2)
    rotated = torch.stack([-pair[..., 1], pair[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos + rotated * sin).to(x.dtype)


def _rotary_1d_torch(dim: int, pos: torch.Tensor, theta: float = 10000.0):
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim))
    angles = pos.float()[:, None] * freqs[None, :]
    cos = torch.repeat_interleave(torch.cos(angles), 2, dim=1)
    sin = torch.repeat_interleave(torch.sin(angles), 2, dim=1)
    return cos, sin


def get_3d_rotary_pos_embed_v2_torch(
    embed_dim: int,
    grid_t: torch.Tensor,
    grid_h: torch.Tensor,
    grid_w: torch.Tensor,
    dim_t: int | None = None,
    dim_h: int | None = None,
    dim_w: int | None = None,
    theta: float = 10000.0,
) -> Rope:
    """Tensor-grid variant of :func:`get_3d_rotary_pos_embed_v2` (the JAX
    package's traced `_v2_jnp`): tables land on the grids' device.

    ``grid_t`` may be per sample, [B, T]: the tables are then [B, T*H*W, D],
    what the JAX package builds with ``jax.vmap`` over the temporal grids
    (`train/staging.py`)."""
    dim_t = embed_dim // 4 if dim_t is None else dim_t
    dim_h = embed_dim // 8 * 3 if dim_h is None else dim_h
    dim_w = embed_dim // 8 * 3 if dim_w is None else dim_w
    batch = grid_t.shape[:-1]  # () or (B,)
    ft = _rotary_1d_torch(dim_t, grid_t.reshape(-1), theta)
    fh = _rotary_1d_torch(dim_h, grid_h, theta)
    fw = _rotary_1d_torch(dim_w, grid_w, theta)
    T, H, W = grid_t.shape[-1], fh[0].shape[0], fw[0].shape[0]
    out = []
    for i in range(2):
        t = ft[i].reshape(*batch, T, 1, 1, dim_t).expand(*batch, T, H, W, dim_t)
        h = fh[i][:, None, :].expand(*batch, T, H, W, dim_h)
        w = fw[i].expand(*batch, T, H, W, dim_w)
        out.append(torch.cat([t, h, w], dim=-1).reshape(*batch, T * H * W, -1))
    return out[0], out[1]
