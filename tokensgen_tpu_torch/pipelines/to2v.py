"""To2V pipeline: video-conditioned (VIP) long-video generation, the edit
workload (port of `tokensgen_tpu/pipelines/to2v.py`).

Stages: VIP-encode the source video (VAE encode, the DiT's patch conv, the
Perceiver resampler) -> CFG-batched base denoise of chunk 0 with FIFO-seed
snapshots -> the FIFO diagonal-denoising loop -> chunked VAE decode.

Not ported here: the single-chip offload orchestration (a 16 GB TPU
workaround), the DINOv2 path, `denoise_together`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed, get_3d_rotary_pos_embed_v2
from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig
from tokensgen_tpu_torch.models.resampler import Resampler, ResamplerConfig
from tokensgen_tpu_torch.models.vae3d import VAERunner, sample_latent
from tokensgen_tpu_torch.sampling import base as base_sampler
from tokensgen_tpu_torch.sampling import fifo as fifo_engine
from tokensgen_tpu_torch.sampling.base import NoiseFn, generator_noise


@dataclasses.dataclass(frozen=True)
class To2VConfig:
    height: int = 480
    width: int = 720
    num_frames_per_chunk: int = 49  # pixel frames
    num_inference_steps: int = 52
    guidance_scale: float = 6.0
    guidance_scale_img: float = 1.5
    use_dynamic_cfg: bool = False
    use_separate_guidance: bool = False
    vip_scale: float = 0.6
    video_ipadapter_start_frame_idx: int = 1000
    num_partitions: int = 4
    lookahead_denoising: bool = True
    use_adaptive_padding: bool = True
    vae_scale_factor_spatial: int = 8
    vae_scale_factor_temporal: int = 4
    stochastic: bool = True
    tail_renoise_mode: str = "xt"

    @property
    def nf_latent(self) -> int:
        return (self.num_frames_per_chunk - 1) // self.vae_scale_factor_temporal + 1


def apply_patch_proj(dit_config: DiTConfig, patch_proj: nn.Conv2d, latents: torch.Tensor):
    """The DiT's patch conv on latent frames: [B, F, C, H, W] -> [B, F, h*w, inner]."""
    b, f, c, h, w = latents.shape
    y = patch_proj(latents.to(dit_config.dtype).reshape(b * f, c, h, w))
    return y.permute(0, 2, 3, 1).reshape(b, f, -1, dit_config.inner_dim)


class To2VPipeline:
    """Bundles the modules, configs and schedule; all on ``device``."""

    def __init__(self, cfg: To2VConfig, dit_config: DiTConfig, dit: CogVideoXTransformer,
                 resampler_config: ResamplerConfig, resampler: Resampler,
                 vae: Optional[VAERunner], sched: Optional[S.DiffusionSchedule] = None,
                 device=None):
        if cfg.num_frames_per_chunk > 49:
            raise ValueError("num_frames_per_chunk must be <= 49 (static positional embeddings)")
        self.cfg = cfg
        self.dit_config = dit_config
        self.dit = dit
        self.resampler_config = resampler_config
        self.resampler = resampler
        self.vae = vae
        self.device = torch.device(device) if device is not None else next(dit.parameters()).device
        self.sched = (sched or S.make_schedule(S.ScheduleConfig())).to(self.device)
        self.grid_h = cfg.height // (cfg.vae_scale_factor_spatial * dit_config.patch_size)
        self.grid_w = cfg.width // (cfg.vae_scale_factor_spatial * dit_config.patch_size)

    # ------------------------------------------------------------------ ropes

    def base_image_rope(self):
        nf = self.cfg.nf_latent
        crops = ([0, 0, 0], [nf, self.grid_h, self.grid_w])
        return get_3d_rotary_pos_embed(self.dit_config.attention_head_dim, crops,
                                       (nf, self.grid_h, self.grid_w), device=self.device)

    def vip_grids(self, num_chunks: int):
        """Host-side grid arrays of the VIP image and condition streams."""
        rc = self.resampler_config
        nf = self.cfg.nf_latent
        off = self.cfg.video_ipadapter_start_frame_idx
        img_t = np.arange(num_chunks * nf, dtype=np.float32)
        img_h = np.arange(self.grid_h, dtype=np.float32)
        img_w = np.arange(self.grid_w, dtype=np.float32)
        cond_t = np.concatenate([
            np.linspace(off + i * nf, off + (i + 1) * nf, rc.num_temporal_queries,
                        endpoint=False, dtype=np.float32)
            for i in range(num_chunks + 1)])
        cond_h = np.linspace(0, self.grid_h, rc.num_height_queries, endpoint=False,
                             dtype=np.float32)
        cond_w = np.linspace(0, self.grid_w, rc.num_width_queries, endpoint=False,
                             dtype=np.float32)
        return img_t, img_h, img_w, cond_t, cond_h, cond_w

    def resampler_ropes(self):
        rc = self.resampler_config
        d = self.dit_config.attention_head_dim
        nf = self.cfg.nf_latent
        off = self.cfg.video_ipadapter_start_frame_idx
        f32 = np.float32
        image = get_3d_rotary_pos_embed_v2(
            d, np.arange(nf, dtype=f32), np.arange(self.grid_h, dtype=f32),
            np.arange(self.grid_w, dtype=f32), device=self.device)
        sampling = get_3d_rotary_pos_embed_v2(
            d, np.linspace(off, off + nf, rc.num_temporal_queries, endpoint=False, dtype=f32),
            np.linspace(0, self.grid_h, rc.num_height_queries, endpoint=False, dtype=f32),
            np.linspace(0, self.grid_w, rc.num_width_queries, endpoint=False, dtype=f32),
            device=self.device)
        return image, sampling

    # ------------------------------------------------------- vip conditioning

    @torch.no_grad()
    def vip_encode_video(self, frames: torch.Tensor, noise_fn: Optional[NoiseFn] = None,
                         do_cfg: bool = True) -> torch.Tensor:
        """[B, F_px, H, W, 3] in [-1, 1] -> CFG-batched VIP tokens
        [nB, 4*(chunks+1), Cv, 8, 12]. The VAE latents are sampled with
        ``noise_fn`` (tags ``("vip", chunk)``), or their mode when it is None.
        One chunk at a time moves to the device."""
        cfg = self.cfg
        nf_px = cfg.num_frames_per_chunk
        video = torch.cat([frames, frames[:, -1:].expand(-1, nf_px, -1, -1, -1)], dim=1)
        img_rope, smp_rope = self.resampler_ropes()
        sf = self.vae.config.scaling_factor

        def encode_chunks(video):
            toks = []
            for cid in range(video.shape[1] // nf_px):
                chunk = video[:, cid * nf_px:(cid + 1) * nf_px].to(self.device, torch.float32)
                moments = self.vae.encode(chunk)
                noise = None
                if noise_fn is not None:
                    noise = noise_fn(("vip", cid), moments.shape[:-1] + (moments.shape[-1] // 2,))
                lat = (sample_latent(moments, noise) * sf).permute(0, 1, 4, 2, 3)
                tokens = apply_patch_proj(self.dit_config, self.dit.patch_embed.proj, lat)
                toks.append(self.resampler(tokens, img_rope, smp_rope))
            return torch.cat(toks, dim=1)

        cond = encode_chunks(video)
        if not do_cfg:
            return cond
        if cfg.use_separate_guidance:
            # the zero-video uncond tokens are used by 3-way guidance only
            return torch.cat([cond, encode_chunks(torch.zeros_like(video)), cond], dim=0)
        return torch.cat([cond, cond], dim=0)

    # --------------------------------------------------------------- model fn

    def _model_fn(self, text_embeds_cfg: torch.Tensor, image_rotary_emb):
        """(lat_cfg, t2d, vip_kwargs) -> noise prediction."""

        def model_fn(lat_cfg, t2d, vip_kwargs):
            return self.dit(lat_cfg.to(self.dit_config.dtype), text_embeds_cfg, t2d,
                            image_rotary_emb=image_rotary_emb, vip_scale=self.cfg.vip_scale,
                            **(vip_kwargs or {}))

        return model_fn

    def cfg_text(self, prompt_embeds, negative_embeds):
        if self.cfg.use_separate_guidance:
            return torch.cat([negative_embeds, prompt_embeds, prompt_embeds])
        return torch.cat([negative_embeds, prompt_embeds])

    # -------------------------------------------------------------- base pass

    @torch.no_grad()
    def base_denoise(self, prompt_embeds, negative_embeds, image_embeddings, num_chunks: int,
                     noise_fn: NoiseFn, latents: Optional[torch.Tensor] = None):
        """Denoise the base clip (chunk 0) -> (result, base rope, model_fn)."""
        cfg = self.cfg
        nf = cfg.nf_latent
        b = prompt_embeds.shape[0]
        if latents is None:
            latents = noise_fn(("latents",), (b, nf, 16, cfg.height // cfg.vae_scale_factor_spatial,
                                              cfg.width // cfg.vae_scale_factor_spatial))
        image_rope = self.base_image_rope()
        model_fn = self._model_fn(self.cfg_text(prompt_embeds, negative_embeds).to(self.device),
                                  image_rope)
        vip_kwargs = None
        if image_embeddings is not None:
            img_t, img_h, img_w, cond_t, cond_h, cond_w = self.vip_grids(num_chunks)
            d = self.dit_config.attention_head_dim
            n_vip = min(self.resampler_config.num_temporal_queries + 1, nf)
            vip_kwargs = {
                "vip_hidden_states": image_embeddings[:, :n_vip],
                "vip_image_rotary_emb": get_3d_rotary_pos_embed_v2(
                    d, img_t[:nf], img_h, img_w, device=self.device),
                "vip_condition_rotary_emb": get_3d_rotary_pos_embed_v2(
                    d, cond_t[:n_vip], cond_h, cond_w, device=self.device),
            }

        def base_model(lat_cfg, tvec):
            t2d = tvec[:, None].expand(lat_cfg.shape[0], lat_cfg.shape[1])
            return model_fn(lat_cfg, t2d, vip_kwargs)

        scfg = base_sampler.SamplerConfig(
            num_inference_steps=cfg.num_inference_steps, guidance_scale=cfg.guidance_scale,
            guidance_scale_img=cfg.guidance_scale_img, use_dynamic_cfg=cfg.use_dynamic_cfg,
            use_separate_guidance=cfg.use_separate_guidance, collect_fifo=True,
            stochastic=cfg.stochastic)
        res = base_sampler.denoise(base_model, self.sched, scfg, latents.to(self.device),
                                   noise_fn)
        return res, image_rope, model_fn

    # -------------------------------------------------------------- fifo pass

    def fifo_seed(self, res, image_rope, image_embeddings, num_chunks: int):
        """The FIFO engine's seed: extended grids and embeddings."""
        cfg = self.cfg
        nf = cfg.nf_latent
        steps = cfg.num_inference_steps
        r_nf = nf // 2
        num_iters = num_chunks * nf + steps - nf
        ts = S.inference_timesteps(self.sched.config, steps)
        vip_state = None
        if image_embeddings is not None:
            img_t, img_h, img_w, cond_t, cond_h, cond_w = self.vip_grids(num_chunks)
            vq = self.resampler_config.num_temporal_queries
            initial = np.concatenate([np.full(r_nf + steps - nf, img_t[0], dtype=np.float32),
                                      img_t[:nf]])
            queue = np.concatenate([
                img_t[nf:],
                np.linspace(img_t[-1] + 1, img_t[-1] + 1 + steps, steps, endpoint=False,
                            dtype=np.float32)])
            g_full = np.concatenate([initial, queue])
            assert len(g_full) == r_nf + steps + num_iters, (len(g_full), num_iters)
            n_ext = steps // nf + 1
            cond_ext = np.concatenate([cond_t] + [cond_t[-vq:] + (i + 1) * nf
                                                  for i in range(n_ext)])
            emb_ext = torch.cat([image_embeddings] + [image_embeddings[:, -vq:]] * n_ext, dim=1)

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

            vip_state = fifo_engine.VIPState(
                image_embeddings=emb_ext, image_grid_t_full=t(g_full), condition_grid_t=t(cond_ext),
                image_grid_h=t(img_h), image_grid_w=t(img_w), condition_grid_h=t(cond_h),
                condition_grid_w=t(cond_w), vip_nf_per_chunk=vq)
        return fifo_engine.FIFOSeed(res.fifo_latents, res.fifo_old_x0, res.fifo_old_valid, ts,
                                    image_rope, vip_state)

    def fifo_config(self, num_chunks: int) -> fifo_engine.FIFOConfig:
        cfg, d = self.cfg, self.dit_config.attention_head_dim
        return fifo_engine.FIFOConfig(
            nf_per_chunk=cfg.nf_latent, num_partitions=cfg.num_partitions,
            num_inference_steps=cfg.num_inference_steps, num_frames=num_chunks * cfg.nf_latent,
            lookahead_denoising=cfg.lookahead_denoising,
            use_adaptive_padding=cfg.use_adaptive_padding, guidance_scale=cfg.guidance_scale,
            guidance_scale_img=cfg.guidance_scale_img, use_dynamic_cfg=cfg.use_dynamic_cfg,
            use_separate_guidance=cfg.use_separate_guidance, stochastic=cfg.stochastic,
            tail_renoise_mode=cfg.tail_renoise_mode,
            video_ipadapter_start_frame_idx=cfg.video_ipadapter_start_frame_idx,
            vip_rope_dims=(d // 4, d // 8 * 3, d // 8 * 3))

    @torch.no_grad()
    def generate(self, prompt_embeds, negative_embeds, frames=None, image_embeddings=None,
                 num_chunks: int = 4, noise_fn: Optional[NoiseFn] = None, decode: bool = True,
                 timings: Optional[Dict[str, float]] = None, cache_idx: Tuple[int, ...] = (),
                 emit_callback=None, state_callback=None,
                 resume_from=None) -> Dict[str, torch.Tensor]:
        """Edit/generation run: VIP encode -> base pass -> FIFO -> decode.

        ``noise_fn`` supplies every random draw (default: a generator seeded
        with 0 on the pipeline's device). ``timings``, when given, receives
        each phase's wall seconds (synchronised on the device).
        ``cache_idx``, ``emit_callback``, ``state_callback`` and
        ``resume_from`` go to the FIFO engine (`sampling.fifo.fifo_generate`);
        the FIFO's latents and cache tracks come back on the host, and with
        ``decode`` each cache track's valid frames, cut to whole decode
        chunks, are decoded into ``cache_videos``."""
        if noise_fn is None:
            noise_fn = generator_noise(torch.Generator(device=self.device).manual_seed(0))
        clock = _PhaseClock(self.device, timings)
        prompt_embeds = prompt_embeds.to(self.device)
        negative_embeds = negative_embeds.to(self.device)
        if image_embeddings is None and frames is not None:
            image_embeddings = self.vip_encode_video(frames, noise_fn)
            clock.lap("vip_encode")
        res, image_rope, model_fn = self.base_denoise(prompt_embeds, negative_embeds,
                                                      image_embeddings, num_chunks, noise_fn)
        clock.lap("base_denoise")
        seed = self.fifo_seed(res, image_rope, image_embeddings, num_chunks)
        fifo_res = fifo_engine.fifo_generate(
            model_fn, self.sched, self.fifo_config(num_chunks), seed, noise_fn,
            cache_idx=cache_idx, emit_callback=emit_callback, state_callback=state_callback,
            resume_from=resume_from)
        clock.lap("fifo")
        out = {"latents": fifo_res.latents, "orig_latents": res.latents,
               "cache_x0": fifo_res.cache_x0, "cache_valid": fifo_res.cache_valid}
        if decode and self.vae is not None:
            out["video"] = self.decode_latents(fifo_res.latents)
            out["orig_video"] = self.decode_latents(res.latents)
            if fifo_res.cache_x0 is not None:
                # one output frame's x0 along its denoise trajectory, as a video
                nf = self.cfg.nf_latent
                out["cache_videos"] = []
                for track, valid in zip(fifo_res.cache_x0, fifo_res.cache_valid):
                    track = track[valid].transpose(0, 1)  # [B, T, C, H, W]
                    t_use = (track.shape[1] // nf) * nf
                    if t_use:
                        out["cache_videos"].append(self.decode_latents(track[:, :t_use]))
            clock.lap("decode")
        return out

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Chunked decode: [B, F, C, h, w] -> [B, F_px, H, W, 3]."""
        nf = self.cfg.nf_latent
        z = (latents.to(self.device) / self.vae.config.scaling_factor).permute(0, 1, 3, 4, 2)
        if z.shape[1] == 0:
            raise ValueError("decode_latents: empty latent sequence")
        return torch.cat([self.vae.decode(z[:, s:s + nf]) for s in range(0, z.shape[1], nf)],
                         dim=1)


class _PhaseClock:
    """Wall seconds per phase, synchronised on a CUDA device."""

    def __init__(self, device, timings: Optional[Dict[str, float]]):
        self.device = torch.device(device)
        self.timings = timings
        self.t0 = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = now - self.t0
        self.t0 = now
