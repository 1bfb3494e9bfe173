"""T2To pipeline: text -> the condensed-token sequence of a whole long video
(port of `tokensgen_tpu/pipelines/t2to.py`).

* denoises token latents [B, 4*num_chunks, 16, 8, 12]; the DiT is the 5b
  clone with patch_size=1 (`DiTConfig.t2to_5b`), run in bf16,
* RoPE over raw grids with per-axis dims (52, 6, 6),
* the CFG DPM loop of `sampling/base.py` on the vip_1 schedule,
* post-process: un-normalise with the training std/mean (first 16 dims),
  zero-pad 16 -> 3072 and lift through the fitted PCA: tokens come back as
  [B, F, 3072, 8, 12] token frames, ready to condition To2V.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tokensgen_tpu_torch.core import pca as pca_lib
from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2
from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig
from tokensgen_tpu_torch.sampling import base as base_sampler
from tokensgen_tpu_torch.sampling.base import NoiseFn, generator_noise


@dataclasses.dataclass(frozen=True)
class T2ToConfig:
    num_frames_per_chunk: int = 4  # token frames per chunk (at most 4)
    num_inference_steps: int = 52
    guidance_scale: float = 6.0
    use_dynamic_cfg: bool = False
    token_dim: int = 3072
    latent_channels: int = 16
    height: int = 8
    width: int = 12
    rope_dims: tuple = (52, 6, 6)
    stochastic: bool = True


class T2ToPipeline:
    """The T2To DiT, its schedule (vip_1 unless given) and the PCA / token
    statistics, all on ``device``."""

    def __init__(self, cfg: T2ToConfig, dit_config: DiTConfig, dit: CogVideoXTransformer,
                 sched: Optional[S.DiffusionSchedule] = None,
                 pca: Optional[pca_lib.PCAState] = None,
                 token_mean: Optional[torch.Tensor] = None,  # [1, >=16]
                 token_std: Optional[torch.Tensor] = None, device=None):
        if cfg.num_frames_per_chunk > 4:
            raise ValueError("num_frames_per_chunk must be <= 4 (static pos embeds)")
        self.cfg = cfg
        self.dit_config = dit_config
        self.dit = dit
        self.device = torch.device(device) if device is not None else next(dit.parameters()).device
        self.sched = (sched or S.make_schedule(S.ScheduleConfig(beta_schedule="vip_1"))).to(
            self.device)
        move = (lambda x: None if x is None else x.to(self.device, torch.float32))
        self.pca = None if pca is None else pca_lib.PCAState(*(move(x) for x in pca))
        self.token_mean, self.token_std = move(token_mean), move(token_std)

    def rope(self, num_frames: int):
        dt, dh, dw = self.cfg.rope_dims
        f32 = np.float32
        return get_3d_rotary_pos_embed_v2(
            self.dit_config.attention_head_dim, np.arange(num_frames, dtype=f32),
            np.arange(self.cfg.height, dtype=f32), np.arange(self.cfg.width, dtype=f32),
            dim_t=dt, dim_h=dh, dim_w=dw, device=self.device)

    @torch.no_grad()
    def generate_tokens(self, prompt_embeds, negative_embeds, num_chunks: int,
                        noise_fn: Optional[NoiseFn] = None,
                        latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Denoised 16-dim token latents [B, 4*num_chunks, 16, 8, 12]. The
        initial latents (tag ``("latents",)``) and the sampler's noise come
        from ``noise_fn`` (default: a generator seeded with 0)."""
        cfg = self.cfg
        if noise_fn is None:
            noise_fn = generator_noise(torch.Generator(device=self.device).manual_seed(0))
        b = prompt_embeds.shape[0]
        f = num_chunks * cfg.num_frames_per_chunk
        if latents is None:
            latents = noise_fn(("latents",), (b, f, cfg.latent_channels, cfg.height, cfg.width))
        rope = self.rope(f)
        text_cfg = torch.cat([negative_embeds, prompt_embeds]).to(self.device)

        def model_fn(lat_cfg, tvec):
            return self.dit(lat_cfg.to(self.dit_config.dtype), text_cfg, tvec,
                            image_rotary_emb=rope)

        scfg = base_sampler.SamplerConfig(
            num_inference_steps=cfg.num_inference_steps, guidance_scale=cfg.guidance_scale,
            use_dynamic_cfg=cfg.use_dynamic_cfg, stochastic=cfg.stochastic)
        return base_sampler.denoise(model_fn, self.sched, scfg, latents.to(self.device),
                                    noise_fn).latents

    def postprocess(self, latents: torch.Tensor) -> torch.Tensor:
        """16-dim normalised token latents -> [B, F, token_dim, 8, 12] token frames."""
        b, f, c, h, w = latents.shape
        flat = latents.float().permute(0, 1, 3, 4, 2).reshape(-1, c)
        if self.token_std is not None:
            flat = flat * self.token_std[:, :c] + self.token_mean[:, :c]
        full = torch.zeros(flat.shape[0], self.cfg.token_dim, device=flat.device)
        full[:, :c] = flat
        if self.pca is not None:
            full = pca_lib.inverse_transform(self.pca, full)
        return full.reshape(b, f, h, w, self.cfg.token_dim).permute(0, 1, 4, 2, 3)

    def __call__(self, prompt_embeds, negative_embeds, num_chunks: int,
                 noise_fn: Optional[NoiseFn] = None, latents=None) -> torch.Tensor:
        return self.postprocess(self.generate_tokens(prompt_embeds, negative_embeds, num_chunks,
                                                     noise_fn, latents))


def extend_generated_tokens(image_embeddings: torch.Tensor, num_chunks: int) -> torch.Tensor:
    """Pad T2To tokens with repeats of the final token frame, as the To2V
    pipeline does when fed precomputed embeddings."""
    reps = image_embeddings.shape[1] // num_chunks
    pad = image_embeddings[:, -1:].expand(-1, reps, *image_embeddings.shape[2:])
    return torch.cat([image_embeddings, pad], dim=1)
