"""Shared building blocks: timestep embedding, LayerNorm, feed-forward, AdaLN
variants (port of `tokensgen_tpu/models/layers.py`).

Linear layers hold their weights in the model's compute dtype (the JAX package
keeps f32 params and casts them to the compute dtype at use, which gives the
same values); LayerNorm affine parameters stay float32 and normalize with
float32 statistics, as there. For training, the trainable Linear weights are
float32 masters (`train/to2v.py`): `Linear` casts its weight to the input's
dtype at use, as flax's Dense does; `Conv2d` does the same for the patch conv,
which the T2To trainer's full finetune trains.
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


class Linear(nn.Linear):
    """`nn.Linear` computing in its input's dtype: a float32 weight (a
    trainable master) is cast at use; in the compute dtype the cast is a
    no-op. With a LoRA adapter (``lora_a`` [in, r], ``lora_b`` [r, out] and
    ``lora_scale`` α/r, added by `train/lora.py`) it adds the low-rank term
    in factored form, ``(x·a)·b·α/r``: the function of the merged weight
    ``W + (a·b·α/r)ᵀ`` without making that weight."""

    lora_scale = None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.linear(x, self.weight.to(x.dtype), bias)
        if self.lora_scale is not None:
            y = y + (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype) * self.lora_scale
        return y


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in its input's dtype, as `Linear`."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class TimestepEmbedding(nn.Module):
    """2-layer silu MLP: [N, in_dim] sinusoidal features -> [N, time_embed_dim]."""

    def __init__(self, in_dim: int, time_embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim, dtype=dtype)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim, dtype=dtype)

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


QUANT_MODES = ("w8a16", "w8a8")


def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [N, K] int8 -> [M, N] int32, exact (`torch._int_mm`;
    on the card cuBLASLt, which takes M > 16 and K, N multiples of 8: the
    DiT's projections have >= 960 rows and widths of 3072 / 12288)."""
    return torch._int_mm(xq, wq.t())


class QuantLinear(nn.Module):
    """int8 Linear (`QuantDense`): ``weight_q`` int8 [out, in], per-output
    channel f32 ``scale`` [out] (absmax / 127), optional f32 ``bias``; made
    from a float Linear by `from_linear` (the JAX `quantize_dit_params`
    formula). Inference only: the tensors are buffers.

    * ``w8a16``: the codes cast to the compute dtype, a float matmul, then
      the per-channel scale in f32.
    * ``w8a8``: per-row dynamic activation quantization (absmax / 127, floor
      1e-6), an exact int8 x int8 -> int32 product, dequantized in f32 by the
      row and channel scales.
    """

    def __init__(self, in_features: int, out_features: int, mode: str = "w8a16",
                 bias: bool = True, dtype=torch.bfloat16, device=None):
        super().__init__()
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {mode!r}")
        self.mode, self.dtype = mode, dtype
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(out_features, in_features,
                                                     dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32,
                                                 device=device))
        self.register_buffer("bias", torch.zeros(out_features, dtype=torch.float32,
                                                 device=device) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear, mode: str, dtype) -> "QuantLinear":
        w = lin.weight.float()  # [out, in]
        q = cls(lin.in_features, lin.out_features, mode, lin.bias is not None, dtype,
                device=w.device)
        q.scale.copy_(torch.clamp_min(w.abs().amax(dim=1), 1e-12) / 127.0)
        q.weight_q.copy_(torch.clamp(torch.round(w / q.scale[:, None]), -127, 127))
        if lin.bias is not None:
            q.bias.copy_(lin.bias.float())
        return q

    def forward(self, x):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, self.in_features)
        if self.mode == "w8a8":
            x32 = x2.float()
            rs = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True), 1e-6) / 127.0
            xq = torch.clamp(torch.round(x32 / rs), -127, 127).to(torch.int8)
            y = (_int8_matmul(xq, self.weight_q).float() * rs * self.scale).to(self.dtype)
        else:
            y = F.linear(x2.to(self.dtype), self.weight_q.to(self.dtype))
            y = (y.float() * self.scale).to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y.reshape(*lead, self.out_features)


def make_linear(in_features: int, out_features: int, *, quant=None, bias: bool = True,
                dtype=torch.float32):
    """`Linear` or its `QuantLinear` drop-in, by the config's ``quant``."""
    if quant:
        return QuantLinear(in_features, out_features, quant, bias, dtype)
    return Linear(in_features, out_features, bias=bias, dtype=dtype)


class _GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int, dtype, quant=None):
        super().__init__()
        self.proj = make_linear(dim, inner, quant=quant, dtype=dtype)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """gelu-approximate MLP, mult 4 (diffusers `FeedForward` layout:
    ``net.0.proj`` and ``net.2``), int8 under ``quant``."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32, quant=None):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(dim, dim * mult, dtype, quant), nn.Identity(),
                                  make_linear(dim * mult, dim, quant=quant, dtype=dtype)])

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
        self.linear = Linear(temb_dim, 6 * dim, dtype=dtype)
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
        self.linear = Linear(temb_dim, 3 * dim, dtype=dtype)
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
        self.linear = Linear(temb_dim, 2 * dim, dtype=dtype)
        self.norm = LayerNorm(dim, affine=elementwise_affine)

    def forward(self, x, temb):
        f = temb.shape[1]
        hw = x.shape[1] // f
        mods = self.linear(F.silu(temb))
        shift, scale = torch.chunk(mods, 2, dim=-1)
        y = self.norm(x)
        return y * (1 + _per_frame_expand(scale, hw)) + _per_frame_expand(shift, hw)
