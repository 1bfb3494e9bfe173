"""CogVideoX 3-D diffusion transformer with the VIP branch (func_type "1").

Port of `tokensgen_tpu/models/dit.py`. Module and parameter names follow the
reference (diffusers) layout that `tokensgen_tpu.convert.export.export_dit`
emits, so a JAX tree moves in through `convert/from_jax.py` with
``load_state_dict(strict=True)``. Blocks are an ``nn.ModuleList`` run in a
Python loop (the JAX package scans stacked parameters). Attention goes
through `kernels/attention.py::fused_flash_attention`: the qk-norm and RoPE
run inside the kernels as prologue tables.

Covered: rotary models (CogVideoX-5b) with the output projection, VIP
func_type "1". The sincos (2b) path, raw-token output (T2To), func_types
"2"-"4", fused qkv and int8 modes are later work and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from tokensgen_tpu_torch.core.rope import Rope
from tokensgen_tpu_torch.kernels.attention import fused_flash_attention, make_prologue, slice_tabs
from tokensgen_tpu_torch.models.layers import (
    AdaLNZero,
    AdaLayerNormOut,
    FeedForward,
    LayerNorm,
    TimestepEmbedding,
    VIPAdaLN,
    timestep_sinusoidal,
)


@dataclasses.dataclass(frozen=True)
class VIPConfig:
    length: int = 480  # vip tokens per forward = 5 query-frames x 8 x 12
    scale: float = 1.0
    func_type: str = "1"
    output_dim: int = 3072  # resampler output dim feeding vip_proj
    num_temporal_queries: int = 4
    num_height_queries: int = 8
    num_width_queries: int = 12


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    num_attention_heads: int = 30
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    num_layers: int = 30
    patch_size: int = 2
    sample_width: int = 90
    sample_height: int = 60
    sample_frames: int = 49
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    use_rotary_positional_embeddings: bool = True
    use_output_projection: bool = True
    attention_bias: bool = True
    qk_norm: bool = True
    vip: Optional[VIPConfig] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def cogvideox_5b(cls, **kw) -> "DiTConfig":
        defaults = dict(num_attention_heads=48, num_layers=42,
                        use_rotary_positional_embeddings=True)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny(cls, **kw) -> "DiTConfig":
        """2-layer debug config (the JAX package's `DiTConfig.tiny`)."""
        defaults = dict(num_attention_heads=2, attention_head_dim=16, num_layers=2,
                        time_embed_dim=32, text_embed_dim=24, max_text_seq_length=8,
                        sample_width=16, sample_height=8,
                        use_rotary_positional_embeddings=True, dtype=torch.float32)
        defaults.update(kw)
        return cls(**defaults)


class QKNorm(nn.Module):
    """Per-head-dim LayerNorm parameters (eps 1e-6, affine). The normalization
    itself runs inside the attention prologue."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))


class _VIPProcessor(nn.Module):
    """The VIP branch's projections (reference name ``attn1.processor``)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        inner, dt = cfg.inner_dim, cfg.dtype
        self.vip_to_q = nn.Linear(inner, inner, bias=cfg.attention_bias, dtype=dt)
        self.vip_to_k = nn.Linear(inner, inner, bias=cfg.attention_bias, dtype=dt)
        self.vip_to_v = nn.Linear(inner, inner, bias=cfg.attention_bias, dtype=dt)
        if cfg.qk_norm:
            self.vip_norm_q = QKNorm(cfg.attention_head_dim)
            self.vip_norm_k = QKNorm(cfg.attention_head_dim)


def _ln_params(mod: Optional[QKNorm]):
    return (None, None) if mod is None else (mod.weight, mod.bias)


class JointVIPAttention(nn.Module):
    """Joint self-attention over [text‖video] plus the VIP branch (func_type
    "1"): text_video→vip cross-attention added with the vip scale, and
    vip→[text_video‖vip] attention for the vip stream."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        if cfg.vip is not None and cfg.vip.func_type != "1":
            raise NotImplementedError(f"VIP func_type {cfg.vip.func_type!r} is not ported yet")
        self.cfg = cfg
        inner, dt = cfg.inner_dim, cfg.dtype
        self.to_q = nn.Linear(inner, inner, bias=cfg.attention_bias, dtype=dt)
        self.to_k = nn.Linear(inner, inner, bias=cfg.attention_bias, dtype=dt)
        self.to_v = nn.Linear(inner, inner, bias=cfg.attention_bias, dtype=dt)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner, bias=True, dtype=dt)])
        self.norm_q = QKNorm(cfg.attention_head_dim) if cfg.qk_norm else None
        self.norm_k = QKNorm(cfg.attention_head_dim) if cfg.qk_norm else None
        self.processor = _VIPProcessor(cfg) if cfg.vip is not None else None

    def _attn(self, q, k, v, tq, tk):
        cfg = self.cfg
        return fused_flash_attention(q, k, v, tq, tk, heads=cfg.num_attention_heads,
                                     norm_q=cfg.qk_norm, norm_k=cfg.qk_norm)

    def forward(self, text_video, vip, text_len: int, image_rotary_emb: Optional[Rope],
                vip_image_rotary_emb: Optional[Rope], vip_condition_rotary_emb: Optional[Rope],
                vip_scale=None):
        cfg = self.cfg
        d = cfg.attention_head_dim
        sm_scale = d ** -0.5
        dev = text_video.device
        q, k, v = self.to_q(text_video), self.to_k(text_video), self.to_v(text_video)
        gq, bq = _ln_params(self.norm_q)
        gk, bk = _ln_params(self.norm_k)
        base_segs = [(None, text_len), (image_rotary_emb, text_video.shape[1] - text_len)]
        tabs_q = make_prologue(d, base_segs, gq, bq, fold=sm_scale, device=dev)
        tabs_k = make_prologue(d, base_segs, gk, bk, device=dev)
        out = self._attn(q, k, v, tabs_q, tabs_k)  # [B, T+Sv, H*D]

        vip_attn_out = None
        if cfg.vip is not None:
            p = self.processor
            tv_len, lv = text_video.shape[1], vip.shape[1]
            op = torch.cat([text_video, vip], dim=1)
            vq, vk, vv = p.vip_to_q(op), p.vip_to_k(op), p.vip_to_v(op)
            vgq, vbq = _ln_params(getattr(p, "vip_norm_q", None))
            vgk, vbk = _ln_params(getattr(p, "vip_norm_k", None))
            segs = [(None, text_len), (vip_image_rotary_emb, tv_len - text_len),
                    (vip_condition_rotary_emb, lv)]
            vtabs_q = make_prologue(d, segs, vgq, vbq, fold=sm_scale, device=dev)
            vtabs_k = make_prologue(d, segs, vgk, vbk, device=dev)
            tv_cross = self._attn(vq[:, :tv_len], vk[:, tv_len:], vv[:, tv_len:],
                                  slice_tabs(vtabs_q, 0, tv_len),
                                  slice_tabs(vtabs_k, tv_len, tv_len + lv))
            scale = cfg.vip.scale if vip_scale is None else vip_scale
            if isinstance(scale, torch.Tensor):  # per-sample [B]
                scale = scale.to(out.dtype).reshape(scale.shape + (1,) * (out.dim() - scale.dim()))
            else:  # rounded to the compute dtype as in the JAX package, kept on the host:
                # a scalar tensor copy to the card would block the host every layer
                scale = torch.tensor(scale, dtype=out.dtype).item()
            out = out + scale * tv_cross
            vip_attn_out = self._attn(vq[:, tv_len:], vk, vv,
                                      slice_tabs(vtabs_q, tv_len, tv_len + lv), vtabs_k)

        merged = out if vip_attn_out is None else torch.cat([out, vip_attn_out], dim=1)
        proj = self.to_out[0](merged)
        text_out = proj[:, :text_len]
        if cfg.vip is not None:
            vip_len = vip.shape[1]
            return proj[:, text_len:-vip_len], text_out, proj[:, -vip_len:]
        return proj[:, text_len:], text_out, None


class DiTBlock(nn.Module):
    """AdaLN-zero -> joint(+vip) attention -> AdaLN-zero -> FF; the vip stream
    has its own 3-way AdaLN and a pass through the shared FF."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        inner, dt, te = cfg.inner_dim, cfg.dtype, cfg.time_embed_dim
        self.norm1 = AdaLNZero(inner, te, dtype=dt)
        self.attn1 = JointVIPAttention(cfg)
        self.norm2 = AdaLNZero(inner, te, dtype=dt)
        self.ff = FeedForward(inner, dtype=dt)
        if cfg.vip is not None:
            self.vip_norm1 = VIPAdaLN(inner, te, dtype=dt)
            self.vip_norm2 = VIPAdaLN(inner, te, dtype=dt)

    def forward(self, hidden, text, vip, temb, ropes, vip_scale=None):
        text_len = text.shape[1]
        norm_h, norm_t, gate, t_gate = self.norm1(hidden, text, temb)
        norm_vip = vip_gate = None
        if vip is not None:
            norm_vip, vip_gate = self.vip_norm1(vip, temb)
        tv = torch.cat([norm_t, norm_h], dim=1)
        video_attn, text_attn, vip_attn = self.attn1(tv, norm_vip, text_len, *ropes, vip_scale)
        hidden = hidden + gate * video_attn
        text = text + t_gate * text_attn
        if vip is not None:
            vip = vip + vip_gate * vip_attn

        norm_h, norm_t, gate2, t_gate2 = self.norm2(hidden, text, temb)
        ff_out = self.ff(torch.cat([norm_t, norm_h], dim=1))
        hidden = hidden + gate2 * ff_out[:, text_len:]
        text = text + t_gate2 * ff_out[:, :text_len]
        if vip is not None:
            norm_vip2, vip_gate2 = self.vip_norm2(vip, temb)
            vip = vip + vip_gate2 * self.ff(norm_vip2)
        return hidden, text, vip


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        inner, dt, p = cfg.inner_dim, cfg.dtype, cfg.patch_size
        self.text_proj = nn.Linear(cfg.text_embed_dim, inner, dtype=dt)
        self.proj = nn.Conv2d(cfg.in_channels, inner, p, stride=p, dtype=dt)
        if cfg.vip is not None:
            self.vip_proj = nn.Linear(cfg.vip.output_dim, inner, dtype=dt)


class CogVideoXTransformer(nn.Module):
    """Full DiT: [B, F, C, H, W] latents, [B, T, text_dim] text, [B] or [B, F]
    timesteps, VIP tokens [B, Tq, Cv, Hq, Wq] -> [B, F, C, H, W] prediction."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        if not cfg.use_rotary_positional_embeddings or not cfg.use_output_projection:
            raise NotImplementedError("only rotary models with the output projection are ported")
        self.cfg = cfg
        inner, dt = cfg.inner_dim, cfg.dtype
        self.patch_embed = _PatchEmbed(cfg)
        self.time_embedding = TimestepEmbedding(inner, cfg.time_embed_dim, dtype=dt)
        self.transformer_blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.num_layers))
        self.norm_final = LayerNorm(inner)
        self.norm_out = AdaLayerNormOut(inner, cfg.time_embed_dim, dtype=dt)
        self.proj_out = nn.Linear(inner, cfg.patch_size ** 2 * cfg.out_channels, dtype=dt)

    def forward(self, hidden_states, encoder_hidden_states, timestep, vip_hidden_states=None,
                image_rotary_emb: Optional[Rope] = None,
                vip_image_rotary_emb: Optional[Rope] = None,
                vip_condition_rotary_emb: Optional[Rope] = None, vip_scale=None):
        cfg = self.cfg
        b, f, c, h, w = hidden_states.shape
        p, dt = cfg.patch_size, cfg.dtype

        ts = timestep if timestep.dim() == 2 else timestep[:, None]
        t_feat = timestep_sinusoidal(ts.reshape(-1), cfg.inner_dim).to(dt)
        temb = self.time_embedding(t_feat).reshape(b, ts.shape[1], cfg.time_embed_dim)

        text = self.patch_embed.text_proj(encoder_hidden_states.to(dt))
        x = self.patch_embed.proj(hidden_states.to(dt).reshape(b * f, c, h, w))
        video = x.permute(0, 2, 3, 1).reshape(b, f * (h // p) * (w // p), cfg.inner_dim)
        vip = None
        if cfg.vip is not None:
            bv, tq, cv, hv, wv = vip_hidden_states.shape
            vtokens = vip_hidden_states.to(dt).permute(0, 1, 3, 4, 2).reshape(bv, tq * hv * wv, cv)
            vip = self.patch_embed.vip_proj(vtokens)

        ropes = (image_rotary_emb, vip_image_rotary_emb, vip_condition_rotary_emb)
        for block in self.transformer_blocks:
            video, text, vip = block(video, text, vip, temb, ropes, vip_scale)

        # the reference normalizes [text (‖ vip) ‖ video] and keeps the video tail
        joint = torch.cat([text] + ([vip] if vip is not None else []) + [video], dim=1)
        hidden = self.norm_final(joint)[:, -video.shape[1]:]
        hidden = self.norm_out(hidden, temb)
        hidden = self.proj_out(hidden)
        out = hidden.reshape(b, f, h // p, w // p, cfg.out_channels, p, p)
        return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, f, cfg.out_channels, h, w)


@torch.no_grad()
def graft_vip_params(model: CogVideoXTransformer) -> CogVideoXTransformer:
    """Initialise the VIP branch from the base attention weights, in place
    (vip_to_{q,k,v} <- to_{q,k,v}, vip_norm_{q,k} <- norm_{q,k}), as the
    reference does when grafting adapters onto a pretrained model."""
    for block in model.transformer_blocks:
        at = block.attn1
        if at.processor is None:
            continue
        for base, vip in (("to_q", "vip_to_q"), ("to_k", "vip_to_k"), ("to_v", "vip_to_v"),
                          ("norm_q", "vip_norm_q"), ("norm_k", "vip_norm_k")):
            src, dst = getattr(at, base), getattr(at.processor, vip, None)
            if src is None or dst is None:
                continue
            for name, t in dst.named_parameters():
                t.copy_(getattr(src, name))
    return model
