"""T5 v1.1 encoder, the text encoder feeding the DiT (port of
`tokensgen_tpu/models/t5.py`; T5-XXL: 4096 wide, 24 layers, 226 tokens).

An encoder-only stack of pre-norm residual blocks:
* RMSNorm (scale only, eps 1e-6) computed in f32 and cast back,
* attention with no 1/sqrt(d) scale, scored in f32, plus a relative position
  bias (32 buckets, max distance 128, bidirectional) that layer 0 owns and
  every layer adds, then -1e9 on masked keys (also in f32),
* a gated feed-forward ``wo(gelu(wi_0 x) * wi_1 x)`` with the exact (erf)
  GELU, as the JAX module has it; HF's "gated-gelu" is the tanh form,
* no biases.

Parameter names are those of HF's ``T5EncoderModel`` (``shared``,
``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}``, ...), so an HF
checkpoint loads with ``load_state_dict(strict=True)``; the JAX tree maps in
through `convert/from_jax.py::t5_state_dict`. Prompt encoding is a one-time
cost per prompt, so the attention is plain tensor products and a softmax, as
the JAX package computes it in XLA outside its kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def xxl(cls, **kw) -> "T5Config":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        defaults = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                        num_heads=4, dtype=torch.float32)
        defaults.update(kw)
        return cls(**defaults)


def _relative_position_bucket(rel_pos: np.ndarray, num_buckets: int, max_distance: int):
    """Bidirectional T5 bucket function (host-side; positions are static)."""
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int64) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(n.clip(1) / max_exact) / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


class T5LayerNorm(nn.Module):
    """RMSNorm: f32 statistics and scale, cast back to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        inner, dt = cfg.num_heads * cfg.d_kv, cfg.dtype
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False, dtype=dt)
        self.k = nn.Linear(cfg.d_model, inner, bias=False, dtype=dt)
        self.v = nn.Linear(cfg.d_model, inner, bias=False, dtype=dt)
        self.o = nn.Linear(inner, cfg.d_model, bias=False, dtype=dt)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, dtype=torch.float32)

    def forward(self, x, pos_bias, mask_bias):
        """``pos_bias``: f32 [1, H, S, S]; ``mask_bias``: f32 [B, 1, 1, S]
        (0 or -1e9) or None. Added one after the other, as the JAX module does."""
        b, s, _ = x.shape
        h, d = self.cfg.num_heads, self.cfg.d_kv

        def heads(t):
            return t.reshape(b, s, h, d).transpose(1, 2).float()

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = q @ k.transpose(-1, -2) + pos_bias
        if mask_bias is not None:
            scores = scores + mask_bias
        p = torch.softmax(scores, dim=-1)
        out = (p @ v).to(x.dtype).transpose(1, 2).reshape(b, s, h * d)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x, pos_bias, mask_bias):
        return x + self.SelfAttention(self.layer_norm(x), pos_bias, mask_bias)


class T5DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=cfg.dtype)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=cfg.dtype)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, dtype=cfg.dtype)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x)) * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedGelu(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_bias), T5LayerFF(cfg)])

    def forward(self, x, pos_bias, mask_bias):
        return self.layer[1](self.layer[0](x, pos_bias, mask_bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, embed_tokens: nn.Embedding):
        super().__init__()
        self.embed_tokens = embed_tokens
        self.block = nn.ModuleList([T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Encoder(nn.Module):
    """``forward(input_ids [B, S], attention_mask [B, S] or None)`` ->
    hidden states [B, S, d_model] in ``cfg.dtype``."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype)
        self.encoder = T5Stack(cfg, self.shared)  # tied, as in HF
        self._buckets: Dict[int, np.ndarray] = {}

    def position_bias(self, s: int) -> torch.Tensor:
        """f32 [1, H, S, S] from layer 0's bucket table."""
        if s not in self._buckets:
            pos = np.arange(s)
            self._buckets[s] = _relative_position_bucket(
                pos[None, :] - pos[:, None], self.cfg.relative_attention_num_buckets,
                self.cfg.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        idx = torch.from_numpy(self._buckets[s]).to(table.device)
        return table[idx].permute(2, 0, 1)[None].float()

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        pos_bias = self.position_bias(input_ids.shape[1])
        mask_bias = None
        if attention_mask is not None:
            keep = attention_mask.to(torch.bool)[:, None, None, :]
            mask_bias = torch.where(keep, 0.0, -1e9).to(torch.float32)
        x = self.shared(input_ids)
        for blk in self.encoder.block:
            x = blk(x, pos_bias, mask_bias)
        return self.encoder.final_layer_norm(x)
