"""CogVideoX 3-D diffusion transformer with the VIP branch.

Port of `tokensgen_tpu/models/dit.py`. Module and parameter names follow the
reference (diffusers) layout that `tokensgen_tpu.convert.export.export_dit`
emits, so a JAX tree moves in through `convert/from_jax.py` with
``load_state_dict(strict=True)``. Blocks are an ``nn.ModuleList`` run in a
Python loop (the JAX package scans stacked parameters), each checkpointed
under ``DiTConfig.remat``. Attention goes through
`kernels/attention.py::fused_flash_attention`: the qk-norm and RoPE run
inside the kernels as prologue tables, and under autograd the backward is
the K5 kernel.

Covered: rotary models (CogVideoX-5b, and the T2To clone with patch size 1)
and the sincos CogVideoX-2b mode (absolute 3-D sin/cos video embeddings,
``vip_pos_embedding``, the final norm on the video only); the output
projection or the raw-token output mode (``use_output_projection=False``:
a dense patch embedding and a non-affine output norm); VIP func_types
"1"-"4" (`VIPConfig`); and the int8 serving modes (``quant`` w8a16 /
w8a8 for the block projections via `quantize_dit`, ``quant_attn`` for the
int8-score joint attention kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tokensgen_tpu_torch.core.rope import Rope, get_3d_sincos_pos_embed
from tokensgen_tpu_torch.kernels.attention import (concat_tabs, fused_flash_attention,
                                                   make_prologue, slice_tabs)
from tokensgen_tpu_torch.models.layers import (
    AdaLNZero,
    AdaLayerNormOut,
    Conv2d,
    FeedForward,
    LayerNorm,
    Linear,
    QuantLinear,
    TimestepEmbedding,
    VIPAdaLN,
    make_linear,
    timestep_sinusoidal,
)

FUNC_TYPES = ("1", "2", "3", "4")


@dataclasses.dataclass(frozen=True)
class VIPConfig:
    """The VIP conditioning branch. ``func_type`` selects the processor:
      "1": [text‖video]→vip cross-attention added with ``scale``, the vip
          stream attends [text‖video‖vip];
      "2": video-only queries for the cross-attention (text untouched by
          vip), the vip stream attends [video‖vip];
      "3": the video→vip cross-attention only; the vip stream passes
          through the blocks unchanged (no vip AdaLN);
      "4": the leading ``ar_length`` video tokens form an autoregressive
          context stream with its own AdaLN, [text‖video] attends them as
          well (added with ``scale_ar``), and one joint [ar‖vip] ->
          [text‖video‖ar‖vip] attention serves both streams; the ar frames
          are dropped from the prediction."""

    length: int = 480  # vip tokens per forward = 5 query-frames x 8 x 12
    scale: float = 1.0
    scale_ar: float = 1.0
    func_type: str = "1"
    ar_length: int = 0  # "4" only: leading video tokens forming the ar stream
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
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0
    use_rotary_positional_embeddings: bool = True
    use_output_projection: bool = True
    attention_bias: bool = True
    qk_norm: bool = True
    vip: Optional[VIPConfig] = None
    dtype: torch.dtype = torch.bfloat16
    # gradient checkpointing per block (`nn.remat(DiTBlock)` in the JAX
    # package): under autograd each block keeps only its inputs and runs its
    # forward again in the backward
    remat: bool = False
    # accepted for the JAX package's configs and ignored (the same math
    # either way): the JAX package runs the joint feed-forward in ff_chunks
    # sequence chunks to fit a 16 GB chip, and under fuse_qkv / fuse_vip_qkv
    # one to_qkv Linear instead of to_q / to_k / to_v; the port runs the FF
    # whole and keeps the three projections (`convert/from_jax.py` splits a
    # fused tree)
    ff_chunks: int = 1
    fuse_qkv: bool = False
    fuse_vip_qkv: bool = False
    # int8 serving modes (the JAX package's fields): None | "w8a16" | "w8a8"
    # for the per-block attention / FF projections (`quantize_dit` turns a
    # float model into that layout), and the int8 score product in the joint
    # self-attention kernel (inference only; gradients stay bf16)
    quant: Optional[str] = None
    quant_attn: bool = False

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
    def cogvideox_2b(cls, **kw) -> "DiTConfig":
        """CogVideoX-2b: 30 heads x 64, 30 layers, absolute sin/cos
        positions (no RoPE)."""
        defaults = dict(use_rotary_positional_embeddings=False)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def t2to_5b(cls, **kw) -> "DiTConfig":
        """T2To: the 5b clone with patch_size=1 denoising condensed tokens
        [B, 4*chunks, 16, 8, 12]."""
        defaults = dict(num_attention_heads=48, num_layers=42,
                        use_rotary_positional_embeddings=True, patch_size=1,
                        sample_width=12, sample_height=8)
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
        _make_qkv(self, cfg, "vip_")
        if cfg.qk_norm:
            self.vip_norm_q = QKNorm(cfg.attention_head_dim)
            self.vip_norm_k = QKNorm(cfg.attention_head_dim)


_QKV_NAMES = ("to_q", "to_k", "to_v")


def _make_qkv(owner: nn.Module, cfg: DiTConfig, prefix: str) -> None:
    inner, dt, qt = cfg.inner_dim, cfg.dtype, cfg.quant
    for name in _QKV_NAMES:
        setattr(owner, prefix + name, make_linear(inner, inner, quant=qt,
                                                  bias=cfg.attention_bias, dtype=dt))


def _qkv(owner: nn.Module, prefix: str, *segments):
    """(q, k, v) of the concatenated ``segments``."""
    op = segments[0] if len(segments) == 1 else torch.cat(segments, dim=1)
    return tuple(getattr(owner, prefix + name)(op) for name in _QKV_NAMES)


def _ln_params(mod: Optional[QKNorm]):
    return (None, None) if mod is None else (mod.weight, mod.bias)


def _as_scale(scale, like: torch.Tensor):
    """A per-sample [B] tensor broadcast against ``like``, or a scalar
    rounded to the compute dtype as in the JAX package and kept on the host
    (a scalar tensor copy to the card would block the host every layer)."""
    if isinstance(scale, torch.Tensor):
        return scale.to(like.dtype).reshape(scale.shape + (1,) * (like.dim() - scale.dim()))
    return torch.tensor(scale, dtype=like.dtype).item()


class JointVIPAttention(nn.Module):
    """Joint self-attention over [text‖video] plus the VIP branch of the
    config's func_type (see `VIPConfig`)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        if cfg.vip is not None and cfg.vip.func_type not in FUNC_TYPES:
            raise ValueError(f"VIP func_type {cfg.vip.func_type!r} not in {FUNC_TYPES}")
        self.cfg = cfg
        _make_qkv(self, cfg, "")
        self.to_out = nn.ModuleList([make_linear(cfg.inner_dim, cfg.inner_dim, quant=cfg.quant,
                                                 dtype=cfg.dtype)])
        self.norm_q = QKNorm(cfg.attention_head_dim) if cfg.qk_norm else None
        self.norm_k = QKNorm(cfg.attention_head_dim) if cfg.qk_norm else None
        self.processor = _VIPProcessor(cfg) if cfg.vip is not None else None

    def _attn(self, q, k, v, tq, tk, key_bias=None):
        cfg = self.cfg
        return fused_flash_attention(q, k, v, tq, tk, key_bias, heads=cfg.num_attention_heads,
                                     norm_q=cfg.qk_norm, norm_k=cfg.qk_norm,
                                     int8_scores=cfg.quant_attn)

    def forward(self, text_video, vip, text_len: int, image_rotary_emb: Optional[Rope],
                vip_image_rotary_emb: Optional[Rope], vip_condition_rotary_emb: Optional[Rope],
                vip_scale=None, key_bias: Optional[torch.Tensor] = None,
                ar: Optional[torch.Tensor] = None):
        """-> (video_out, text_out, vip_out). ``key_bias``: optional additive
        f32 [B, T+Sv] mask on the base attention's keys (the T2To padded
        chunks); the VIP branch takes none. ``ar``: the normed ar stream
        (func_type "4"); its output leads video_out."""
        cfg = self.cfg
        d = cfg.attention_head_dim
        sm_scale = d ** -0.5
        dev = text_video.device
        q, k, v = _qkv(self, "", text_video)
        gq, bq = _ln_params(self.norm_q)
        gk, bk = _ln_params(self.norm_k)
        base_segs = [(None, text_len), (image_rotary_emb, text_video.shape[1] - text_len)]
        tabs_q = make_prologue(d, base_segs, gq, bq, fold=sm_scale, device=dev)
        tabs_k = make_prologue(d, base_segs, gk, bk, device=dev)
        out = self._attn(q, k, v, tabs_q, tabs_k, key_bias)  # [B, T+Sv, H*D]

        ft = cfg.vip.func_type if cfg.vip is not None else None
        p = self.processor
        vip_attn_out = ar_attn_out = None
        if ft is not None:
            vgq, vbq = _ln_params(getattr(p, "vip_norm_q", None))
            vgk, vbk = _ln_params(getattr(p, "vip_norm_k", None))
            lv = vip.shape[1]
        if ft == "4":
            la, tv_len = ar.shape[1], text_video.shape[1]
            vq, vk, vv = _qkv(p, "vip_", text_video, vip, ar)
            # the ar tokens take the leading temporal positions of the
            # vip-image table, the video the rest; vip the condition table.
            # Segments: [text ‖ video ‖ vip ‖ ar]
            ar_rope = vid_rope = None
            if vip_image_rotary_emb is not None:
                vi_cos, vi_sin = vip_image_rotary_emb
                ar_rope = (vi_cos[..., :la, :], vi_sin[..., :la, :])
                vid_rope = (vi_cos[..., la:, :], vi_sin[..., la:, :])
            segs = [(None, text_len), (vid_rope, tv_len - text_len),
                    (vip_condition_rotary_emb, lv), (ar_rope, la)]
            vtq = make_prologue(d, segs, vgq, vbq, fold=sm_scale, device=dev)
            vtk = make_prologue(d, segs, vgk, vbk, device=dev)
            bounds = ((0, tv_len), (tv_len, tv_len + lv), (tv_len + lv, tv_len + lv + la))
            (q_tv, q_vip, q_ar), (k_tv, k_vip, k_ar), (v_tv, v_vip, v_ar) = (
                [x[:, a:b] for a, b in bounds] for x in (vq, vk, vv))
            (tq_tv, tq_vip, tq_ar), (tk_tv, tk_vip, tk_ar) = (
                [slice_tabs(tabs, a, b) for a, b in bounds] for tabs in (vtq, vtk))
            cross_vip = self._attn(q_tv, k_vip, v_vip, tq_tv, tk_vip)
            cross_ar = self._attn(q_tv, k_ar, v_ar, tq_tv, tk_ar)
            scale = _as_scale(cfg.vip.scale if vip_scale is None else vip_scale, out)
            out = out + scale * cross_vip + _as_scale(cfg.vip.scale_ar, out) * cross_ar
            arvip = self._attn(torch.cat([q_ar, q_vip], dim=1),
                               torch.cat([k_tv, k_ar, k_vip], dim=1),
                               torch.cat([v_tv, v_ar, v_vip], dim=1),
                               concat_tabs(tq_ar, tq_vip), concat_tabs(tk_tv, tk_ar, tk_vip))
            ar_attn_out, vip_attn_out = arvip[:, :la], arvip[:, la:]
        elif ft is not None:
            # "1": vip-projected queries / keys over [text‖video]; "2" / "3":
            # over the video only, which takes the vip-image table whole
            tv_input = text_video if ft == "1" else text_video[:, text_len:]
            tv_len = tv_input.shape[1]
            vq, vk, vv = _qkv(p, "vip_", tv_input, vip)
            if ft == "1":
                tv_segs = [(None, text_len), (vip_image_rotary_emb, tv_len - text_len)]
            else:
                tv_segs = [(vip_image_rotary_emb, tv_len)]
            segs = tv_segs + [(vip_condition_rotary_emb, lv)]
            vtabs_q = make_prologue(d, segs, vgq, vbq, fold=sm_scale, device=dev)
            vtabs_k = make_prologue(d, segs, vgk, vbk, device=dev)
            # (text_)video -> vip cross-attention, added with the vip scale
            tv_cross = self._attn(vq[:, :tv_len], vk[:, tv_len:], vv[:, tv_len:],
                                  slice_tabs(vtabs_q, 0, tv_len),
                                  slice_tabs(vtabs_k, tv_len, tv_len + lv))
            scale = _as_scale(cfg.vip.scale if vip_scale is None else vip_scale, out)
            if ft == "1":
                out = out + scale * tv_cross
            else:  # video positions only; the text is untouched
                out = torch.cat([out[:, :text_len], out[:, text_len:] + scale * tv_cross], dim=1)
            if ft != "3":  # vip -> [(text_)video ‖ vip]
                vip_attn_out = self._attn(vq[:, tv_len:], vk, vv,
                                          slice_tabs(vtabs_q, tv_len, tv_len + lv), vtabs_k)

        if ft == "4":  # [text ‖ ar ‖ video ‖ vip] through the shared to_out
            merged = torch.cat([out[:, :text_len], ar_attn_out, out[:, text_len:], vip_attn_out],
                               dim=1)
        elif vip_attn_out is not None:
            merged = torch.cat([out, vip_attn_out], dim=1)
        else:
            merged = out
        proj = self.to_out[0](merged)
        text_out = proj[:, :text_len]
        if ft is not None and ft != "3":
            return proj[:, text_len:-lv], text_out, proj[:, -lv:]
        # "3": the vip stream bypasses the attention
        return proj[:, text_len:], text_out, vip


class DiTBlock(nn.Module):
    """AdaLN-zero -> joint(+vip) attention -> AdaLN-zero -> FF; the vip stream
    (the ar stream under func_type "4") has its own 3-way AdaLN and a pass
    through the shared FF; under "3" the vip stream passes through."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        inner, dt, te = cfg.inner_dim, cfg.dtype, cfg.time_embed_dim
        ft = cfg.vip.func_type if cfg.vip is not None else None
        self.norm1 = AdaLNZero(inner, te, dtype=dt)
        self.attn1 = JointVIPAttention(cfg)
        self.norm2 = AdaLNZero(inner, te, dtype=dt)
        self.ff = FeedForward(inner, dtype=dt, quant=cfg.quant)
        if ft is not None and ft != "3":
            self.vip_norm1 = VIPAdaLN(inner, te, dtype=dt)
            self.vip_norm2 = VIPAdaLN(inner, te, dtype=dt)
        if ft == "4":
            self.ar_norm1 = VIPAdaLN(inner, te, dtype=dt)
            self.ar_norm2 = VIPAdaLN(inner, te, dtype=dt)

    def forward(self, hidden, text, vip, temb, ropes, vip_scale=None, key_bias=None):
        cfg = self.cfg
        ft = cfg.vip.func_type if cfg.vip is not None else None
        streams = vip is not None and ft != "3"  # the vip stream has AdaLNs
        text_len = text.shape[1]
        ar = norm_ar = None
        if ft == "4":  # the leading ar context tokens form their own stream
            la = cfg.vip.ar_length
            ar, hidden = hidden[:, :la], hidden[:, la:]
        norm_h, norm_t, gate, t_gate = self.norm1(hidden, text, temb)
        norm_vip = vip
        if streams:
            norm_vip, vip_gate = self.vip_norm1(vip, temb)
        if ft == "4":
            norm_ar, ar_gate = self.ar_norm1(ar, temb)
        tv = torch.cat([norm_t, norm_h], dim=1)
        video_attn, text_attn, vip_attn = self.attn1(tv, norm_vip, text_len, *ropes, vip_scale,
                                                     key_bias, ar=norm_ar)
        if ft == "4":
            ar = ar + ar_gate * video_attn[:, :la]
            video_attn = video_attn[:, la:]
        hidden = hidden + gate * video_attn
        text = text + t_gate * text_attn
        if streams:
            vip = vip + vip_gate * vip_attn

        norm_h, norm_t, gate2, t_gate2 = self.norm2(hidden, text, temb)
        ff_out = self.ff(torch.cat([norm_t, norm_h], dim=1))
        hidden = hidden + gate2 * ff_out[:, text_len:]
        text = text + t_gate2 * ff_out[:, :text_len]
        if streams:
            norm_vip2, vip_gate2 = self.vip_norm2(vip, temb)
            vip = vip + vip_gate2 * self.ff(norm_vip2)
        if ft == "4":
            norm_ar2, ar_gate2 = self.ar_norm2(ar, temb)
            ar = ar + ar_gate2 * self.ff(norm_ar2)
            hidden = torch.cat([ar, hidden], dim=1)
        return hidden, text, vip


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        inner, dt, p = cfg.inner_dim, cfg.dtype, cfg.patch_size
        self.text_proj = Linear(cfg.text_embed_dim, inner, dtype=dt)
        if cfg.use_output_projection:
            self.proj = Conv2d(cfg.in_channels, inner, p, stride=p, dtype=dt)
        else:  # raw-token mode: a dense projection of each latent pixel
            self.proj = Linear(cfg.in_channels, inner, dtype=dt)
        if cfg.vip is not None:
            self.vip_proj = Linear(cfg.vip.output_dim, inner, dtype=dt)


class CogVideoXTransformer(nn.Module):
    """Full DiT: [B, F, C, H, W] latents, [B, T, text_dim] text, [B] or [B, F]
    timesteps, VIP tokens [B, Tq, Cv, Hq, Wq] -> [B, F, C, H, W] prediction
    (under func_type "4" without the ar frames; in raw-token mode the normed
    hidden states as [B, F, inner, H, W]). ``key_bias``: optional additive
    f32 [B, T+Sv] mask on the base attention's keys (T2To training's padded
    chunks), carried through every block, checkpointed ones included.
    ``vip_pos_embedding``: [B or 1, Lv, inner] added to the vip tokens in
    the sincos mode."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        inner, dt = cfg.inner_dim, cfg.dtype
        self.patch_embed = _PatchEmbed(cfg)
        self.time_embedding = TimestepEmbedding(inner, cfg.time_embed_dim, dtype=dt)
        self.transformer_blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.num_layers))
        self.norm_final = LayerNorm(inner)
        self.norm_out = AdaLayerNormOut(inner, cfg.time_embed_dim, dtype=dt,
                                        elementwise_affine=cfg.use_output_projection)
        if cfg.use_output_projection:
            self.proj_out = Linear(inner, cfg.patch_size ** 2 * cfg.out_channels, dtype=dt)
        self._sincos = {}  # (frames, h, w, device) -> the sincos video table, f32

    def _sincos_table(self, f: int, hp: int, wp: int, device) -> torch.Tensor:
        key = (f, hp, wp, str(device))
        if key not in self._sincos:
            cfg = self.cfg
            pe = get_3d_sincos_pos_embed(cfg.inner_dim, (wp, hp), f,
                                         cfg.spatial_interpolation_scale,
                                         cfg.temporal_interpolation_scale)
            self._sincos[key] = torch.from_numpy(pe.reshape(1, -1, cfg.inner_dim)).to(device)
        return self._sincos[key]

    def forward(self, hidden_states, encoder_hidden_states, timestep, vip_hidden_states=None,
                image_rotary_emb: Optional[Rope] = None,
                vip_image_rotary_emb: Optional[Rope] = None,
                vip_condition_rotary_emb: Optional[Rope] = None, vip_scale=None,
                key_bias: Optional[torch.Tensor] = None,
                vip_pos_embedding: Optional[torch.Tensor] = None):
        cfg = self.cfg
        b, f, c, h, w = hidden_states.shape
        p, dt = cfg.patch_size, cfg.dtype

        ts = timestep if timestep.dim() == 2 else timestep[:, None]
        t_feat = timestep_sinusoidal(ts.reshape(-1), cfg.inner_dim).to(dt)
        temb = self.time_embedding(t_feat).reshape(b, ts.shape[1], cfg.time_embed_dim)

        text = self.patch_embed.text_proj(encoder_hidden_states.to(dt))
        if cfg.use_output_projection:
            x = self.patch_embed.proj(hidden_states.to(dt).reshape(b * f, c, h, w))
            video = x.permute(0, 2, 3, 1).reshape(b, f * (h // p) * (w // p), cfg.inner_dim)
        else:
            video = self.patch_embed.proj(
                hidden_states.to(dt).permute(0, 1, 3, 4, 2).reshape(b, f * h * w, c))
        vip = None
        if cfg.vip is not None:
            bv, tq, cv, hv, wv = vip_hidden_states.shape
            vtokens = vip_hidden_states.to(dt).permute(0, 1, 3, 4, 2).reshape(bv, tq * hv * wv, cv)
            vip = self.patch_embed.vip_proj(vtokens)
        if not cfg.use_rotary_positional_embeddings:
            # 2b: absolute sincos video embeddings; the text takes none
            video = video + self._sincos_table(f, h // p, w // p, video.device).to(dt)
            if vip is not None and vip_pos_embedding is not None:
                vip = vip + vip_pos_embedding.to(dt)

        ropes = (image_rotary_emb, vip_image_rotary_emb, vip_condition_rotary_emb)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.transformer_blocks:
            if remat:
                video, text, vip = checkpoint(block, video, text, vip, temb, ropes, vip_scale,
                                              key_bias, use_reentrant=False)
            else:
                video, text, vip = block(video, text, vip, temb, ropes, vip_scale, key_bias)

        if not cfg.use_rotary_positional_embeddings:
            hidden = self.norm_final(video)
        else:  # the reference normalizes [text (‖ vip) ‖ video] and keeps the video tail
            joint = torch.cat([text] + ([vip] if vip is not None else []) + [video], dim=1)
            hidden = self.norm_final(joint)[:, -video.shape[1]:]
        f_out = f
        if cfg.vip is not None and cfg.vip.func_type == "4":
            # drop the ar context tokens from the prediction
            hidden = hidden[:, cfg.vip.ar_length:]
            f_out = f - cfg.vip.ar_length // ((h // p) * (w // p))
        hidden = self.norm_out(hidden, temb)
        if not cfg.use_output_projection:
            return hidden.reshape(b, f, h, w, -1).permute(0, 1, 4, 2, 3)
        hidden = self.proj_out(hidden)
        out = hidden.reshape(b, f_out, h // p, w // p, cfg.out_channels, p, p)
        return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, f_out, cfg.out_channels, h, w)


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


# per-block projections that the `quant` modes make QuantLinear (the JAX
# package's `_QUANTIZED_DENSE`, as the port's module paths; the port keeps
# no fused qkv layout)
_QUANTIZED_LINEAR = (
    "attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0",
    "attn1.processor.vip_to_q", "attn1.processor.vip_to_k", "attn1.processor.vip_to_v",
    "ff.net.0.proj", "ff.net.2",
)


def _without_quant(cfg: DiTConfig) -> DiTConfig:
    return dataclasses.replace(cfg, quant=None, quant_attn=False)


@torch.no_grad()
def quantize_dit(model: CogVideoXTransformer, config: DiTConfig) -> CogVideoXTransformer:
    """A float DiT -> the int8 layout of ``config`` (`quantize_dit_params`),
    in place on the model's device: under ``config.quant`` each per-block
    attention / FF Linear becomes a `QuantLinear` (int8 codes and f32 scales
    by the JAX formula; the embeddings and output head stay float), and the
    model takes ``config``, so ``quant_attn`` reaches its attention. Apply
    after `graft_vip_params`: quantization is the last transform."""
    if _without_quant(config) != _without_quant(model.cfg):
        raise ValueError("quantize_dit: the config differs from the model's beyond quant")
    if config.quant:
        for block in model.transformer_blocks:
            for path in _QUANTIZED_LINEAR:
                parent_path, _, name = path.rpartition(".")
                try:
                    parent = block.get_submodule(parent_path)
                except AttributeError:  # no VIP branch
                    continue
                lin = getattr(parent, name)
                if isinstance(lin, Linear):
                    setattr(parent, name, QuantLinear.from_linear(lin, config.quant, config.dtype))
    for mod in model.modules():
        if isinstance(getattr(mod, "cfg", None), DiTConfig):
            mod.cfg = config
    return model
