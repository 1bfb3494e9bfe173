"""Shared building blocks: timestep embedding, LayerNorm, feed-forward, AdaLN
variants (port of `tokensgen_tpu/models/layers.py`).

Linear layers hold their weights in the model's compute dtype (the JAX package
keeps f32 params and casts them to the compute dtype at use, which gives the
same values); LayerNorm affine parameters stay float32 and normalize with
float32 statistics, as there.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def timestep_sinusoidal(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                        freq_shift: float = 0.0) -> torch.Tensor:
    """[N] int timesteps -> [N, dim] sinusoidal features (float32)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    """2-layer silu MLP: [N, in_dim] sinusoidal features -> [N, time_embed_dim]."""

    def __init__(self, in_dim: int, time_embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim, dtype=dtype)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim, dtype=dtype)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics regardless of compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
            self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y.to(x.dtype)


class _GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int, dtype):
        super().__init__()
        self.proj = nn.Linear(dim, inner, dtype=dtype)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """gelu-approximate MLP, mult 4 (diffusers `FeedForward` layout:
    ``net.0.proj`` and ``net.2``)."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(dim, dim * mult, dtype), nn.Identity(),
                                  nn.Linear(dim * mult, dim, dtype=dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


def _per_frame_expand(t: torch.Tensor, hw: int) -> torch.Tensor:
    """[B, F, C] -> [B, F*hw, C] by repeating each frame's vector over its tokens."""
    b, f, c = t.shape
    return t[:, :, None, :].expand(b, f, hw, c).reshape(b, f * hw, c)


class AdaLNZero(nn.Module):
    """CogVideoX 6-way AdaLN with per-frame temb; returns (norm_hidden,
    norm_text, gate, text_gate)."""

    def __init__(self, dim: int, temb_dim: int, dtype=torch.float32):
        super().__init__()
        self.linear = nn.Linear(temb_dim, 6 * dim, dtype=dtype)
        self.norm = LayerNorm(dim)

    def forward(self, hidden, text, temb) -> Tuple[torch.Tensor, ...]:
        f = temb.shape[1]
        hw = hidden.shape[1] // f
        mods = self.linear(F.silu(temb))
        shift, scale, gate, e_shift, e_scale, e_gate = torch.chunk(mods, 6, dim=-1)
        h = self.norm(hidden) * (1 + _per_frame_expand(scale, hw)) + _per_frame_expand(shift, hw)
        t = self.norm(text) * (1 + e_scale[:, :1]) + e_shift[:, :1]
        return h, t, _per_frame_expand(gate, hw), e_gate[:, :1]


class VIPAdaLN(nn.Module):
    """3-way AdaLN for the vip token stream; frame-0 temb."""

    def __init__(self, dim: int, temb_dim: int, dtype=torch.float32):
        super().__init__()
        self.linear = nn.Linear(temb_dim, 3 * dim, dtype=dtype)
        self.norm = LayerNorm(dim)

    def forward(self, vip, temb):
        mods = self.linear(F.silu(temb))
        shift, scale, gate = torch.chunk(mods, 3, dim=-1)
        return self.norm(vip) * (1 + scale[:, :1]) + shift[:, :1], gate[:, :1]


class AdaLayerNormOut(nn.Module):
    """Output-head AdaLN: silu(temb) -> (shift, scale), per-frame."""

    def __init__(self, dim: int, temb_dim: int, dtype=torch.float32,
                 elementwise_affine: bool = True):
        super().__init__()
        self.linear = nn.Linear(temb_dim, 2 * dim, dtype=dtype)
        self.norm = LayerNorm(dim, affine=elementwise_affine)

    def forward(self, x, temb):
        f = temb.shape[1]
        hw = x.shape[1] // f
        mods = self.linear(F.silu(temb))
        shift, scale = torch.chunk(mods, 2, dim=-1)
        y = self.norm(x)
        return y * (1 + _per_frame_expand(scale, hw)) + _per_frame_expand(shift, hw)
