"""Perceiver Resampler: condenses a chunk's patch tokens into VIP tokens
(port of `tokensgen_tpu/models/resampler.py`, without the PCA bottleneck,
which the edit path does not use).

Parameter names follow `tokensgen_tpu.convert.export.export_resampler`
(``layers.{i}.0`` attention, ``layers.{i}.1`` feed-forward). The attention is
`kernels/attention.py::flash_attention_bhsd` (the Hopper kernel replacing the
TPU `_flash_kernel`) with LayerNorm and RoPE applied outside it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from tokensgen_tpu_torch.core.rope import Rope, apply_rotary_emb
from tokensgen_tpu_torch.kernels.attention import flash_attention_bhsd
from tokensgen_tpu_torch.models.layers import FeedForward, LayerNorm


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 3072
    depth: int = 4
    dim_head: int = 64
    heads: int = 16
    num_height_queries: int = 8
    num_width_queries: int = 12
    num_temporal_queries: int = 4
    embedding_dim: int = 3072  # input token dim (after the DiT's patch_embed.proj)
    output_dim: int = 3072
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_queries(self) -> int:
        return self.num_temporal_queries * self.num_height_queries * self.num_width_queries

    @classmethod
    def tiny(cls, **kw) -> "ResamplerConfig":
        defaults = dict(dim=32, depth=2, dim_head=16, heads=2, num_height_queries=2,
                        num_width_queries=3, num_temporal_queries=2, embedding_dim=16,
                        output_dim=24, dtype=torch.float32)
        defaults.update(kw)
        return cls(**defaults)


class PerceiverAttention(nn.Module):
    def __init__(self, cfg: ResamplerConfig):
        super().__init__()
        self.cfg = cfg
        inner, dt = cfg.dim_head * cfg.heads, cfg.dtype
        self.norm1 = LayerNorm(cfg.dim)
        self.norm2 = LayerNorm(cfg.dim)
        self.to_q = nn.Linear(cfg.dim, inner, bias=False, dtype=dt)
        self.to_kv = nn.Linear(cfg.dim, 2 * inner, bias=False, dtype=dt)
        self.to_out = nn.Linear(inner, cfg.dim, bias=False, dtype=dt)
        self.norm_q = LayerNorm(cfg.dim_head, eps=1e-6)
        self.norm_k = LayerNorm(cfg.dim_head, eps=1e-6)

    def forward(self, x, latents, image_rotary_emb: Optional[Rope] = None,
                sampling_rotary_emb: Optional[Rope] = None):
        cfg = self.cfg
        b, l, _ = latents.shape
        x = self.norm1(x)
        latents = self.norm2(latents)
        q = self.to_q(latents)
        k, v = torch.chunk(self.to_kv(torch.cat([x, latents], dim=1)), 2, dim=-1)

        def heads(t):
            return t.reshape(b, t.shape[1], cfg.heads, cfg.dim_head).permute(0, 2, 1, 3)

        q, k, v = heads(q), heads(k), heads(v)
        q = self.norm_q(q)
        k = self.norm_k(k)
        if image_rotary_emb is not None:
            k = torch.cat([apply_rotary_emb(k[:, :, :-l], image_rotary_emb), k[:, :, -l:]], dim=2)
        if sampling_rotary_emb is not None:
            q = apply_rotary_emb(q, sampling_rotary_emb)
            k = torch.cat([k[:, :, :-l], apply_rotary_emb(k[:, :, -l:], sampling_rotary_emb)],
                          dim=2)
        out = flash_attention_bhsd(q, k, v, scale=cfg.dim_head ** -0.5)
        out = out.permute(0, 2, 1, 3).reshape(b, l, cfg.heads * cfg.dim_head)
        return self.to_out(out)


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.latents = nn.Parameter(torch.zeros(1, cfg.num_queries, cfg.dim))
        self.proj_in = nn.Linear(cfg.embedding_dim, cfg.dim, dtype=dt)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(cfg), FeedForward(cfg.dim, dtype=dt)])
            for _ in range(cfg.depth))
        self.proj_out = nn.Linear(cfg.dim, cfg.output_dim, dtype=dt)
        self.norm_out = LayerNorm(cfg.output_dim)

    def forward(self, x, image_rotary_emb: Optional[Rope] = None,
                sampling_rotary_emb: Optional[Rope] = None):
        """x: [B, F, N, embedding_dim] per-frame patch tokens -> VIP tokens
        [B, Tq, output_dim, Hq, Wq]."""
        cfg = self.cfg
        b, f, n, _ = x.shape
        x = self.proj_in(x.to(cfg.dtype)).reshape(b, f * n, cfg.dim)
        lat = self.latents.to(cfg.dtype).expand(b, -1, -1)
        for attn, ff in self.layers:
            lat = attn(x, lat, image_rotary_emb, sampling_rotary_emb) + lat
            lat = ff(lat) + lat
        lat = self.norm_out(self.proj_out(lat))
        t, hq, wq = cfg.num_temporal_queries, cfg.num_height_queries, cfg.num_width_queries
        return lat.reshape(b, t, hq, wq, cfg.output_dim).permute(0, 1, 4, 2, 3)
