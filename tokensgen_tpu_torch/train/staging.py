"""To2V training-batch staging: VAE encode, random windows, VIP conditioning,
per-sample rotary tables (port of `tokensgen_tpu/train/staging.py`).

The reference trainer's per-step data flow (`train_cogvideo_to2v.py:1727-1976`):
* encode the 2-chunk pixel window chunk by chunk;
* pick a random 13-latent-frame window per sample;
* VIP conditioning from the VAE latents, or, for samples whose embedding is
  dropped (CFG dropout), from the latents of a zeros video, through the DiT's
  patch conv; the trainable resampler runs inside the loss;
* select the window's VIP token frames by searchsorted;
* absolute grids: the VIP grids start at ``start_frame_idx`` (+1000 for the
  condition stream), the model's global clock.

One difference in work, not in results: the zeros-video latents are
constant, so they are encoded only when a sample of the batch drops its
embedding, and kept in ``zero_cache`` for later batches (the JAX package
encodes them every step).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from tokensgen_tpu_torch.core.rope import (
    get_3d_rotary_pos_embed,
    get_3d_rotary_pos_embed_v2,
    get_3d_rotary_pos_embed_v2_torch,
)
from tokensgen_tpu_torch.models.dit import DiTConfig
from tokensgen_tpu_torch.models.resampler import ResamplerConfig
from tokensgen_tpu_torch.models.vae3d import VAERunner, sample_latent
from tokensgen_tpu_torch.pipelines.to2v import apply_patch_proj

# noise_fn(tag, shape) -> standard-normal tensor; tags ("encode", chunk)
NoiseFn = Callable[[tuple, tuple], torch.Tensor]


@torch.no_grad()
def encode_video_chunks(vae: VAERunner, pixel_values: torch.Tensor, nf_px: int,
                        noise_fn: Optional[NoiseFn]) -> torch.Tensor:
    """[B, F_px, H, W, 3] -> latents [B, F_lat, C, h, w] on the VAE's device,
    chunk by chunk; sampled with ``noise_fn`` (tags ``("encode", chunk)``),
    or the mode when it is None."""
    device = next(vae.model.parameters()).device
    outs = []
    for cid in range(pixel_values.shape[1] // nf_px):
        chunk = pixel_values[:, cid * nf_px:(cid + 1) * nf_px].to(device, torch.float32)
        moments = vae.encode(chunk)
        noise = None
        if noise_fn is not None:
            noise = noise_fn(("encode", cid), moments.shape[:-1] + (moments.shape[-1] // 2,))
            noise = noise.to(moments.device, moments.dtype)
        lat = sample_latent(moments, noise) * vae.config.scaling_factor
        outs.append(lat.permute(0, 1, 4, 2, 3))
    return torch.cat(outs, dim=1)


def window_starts(host_rng: np.random.Generator, b: int, f_all: int, nf: int) -> np.ndarray:
    """[b] random starts of an ``nf``-frame window in ``f_all`` latent frames."""
    return np.asarray([host_rng.integers(0, max(1, f_all - nf - 1 + 1)) for _ in range(b)])


@torch.no_grad()
def stage_to2v_batch(
    dit_config: DiTConfig,
    patch_proj: torch.nn.Conv2d,
    resampler_config: ResamplerConfig,
    vae: VAERunner,
    pixel_values: torch.Tensor,  # [B, chunks*nf_px, H, W, 3]
    start_frame_idx: np.ndarray,  # [B] absolute compressed-frame start
    drop_image_embed: np.ndarray,  # [B] 0/1 CFG dropout
    text_embeds: torch.Tensor,
    noise_fn: Optional[NoiseFn],
    nf_px: int = 49,
    video_ipadapter_start_frame_idx: int = 1000,
    host_rng: Optional[np.random.Generator] = None,
    zero_cache: Optional[Dict] = None,
    rel: Optional[np.ndarray] = None,
) -> Dict:
    """The batch dict consumed by `train/to2v.py::to2v_loss`, on the patch
    conv's device. ``zero_cache``: a dict the caller keeps across steps for
    the zeros-video latents. ``rel``: each sample's window start, drawn by
    the caller (a data-parallel rank's rows of `window_starts` over the
    global batch); else drawn here from ``host_rng``."""
    device = patch_proj.weight.device
    host_rng = host_rng or np.random.default_rng(0)
    b = pixel_values.shape[0]
    num_chunks = pixel_values.shape[1] // nf_px
    nf = (nf_px - 1) // 4 + 1  # 13
    rc = resampler_config
    d = dit_config.attention_head_dim
    vq = rc.num_temporal_queries
    n_vip = min(vq + 1, nf)

    all_latents = encode_video_chunks(vae, pixel_values, nf_px, noise_fn)
    f_all = all_latents.shape[1]

    # random window per sample (`:1731-1738`)
    if rel is None:
        rel = window_starts(host_rng, b, f_all, nf)
    idx = torch.from_numpy(rel[:, None] + np.arange(nf)[None, :]).to(device)
    latents = torch.gather(all_latents, 1,
                           idx[:, :, None, None, None].expand(-1, -1, *all_latents.shape[2:]))

    # VIP conditioning: CFG dropout swaps in the zeros-video latents (`:1743,1962`)
    drop = np.asarray(drop_image_embed).astype(bool)
    cond_latents = all_latents
    if drop.any():
        if zero_cache is None:
            zero_cache = {}
        key = tuple(pixel_values.shape)
        if key not in zero_cache:
            zero_cache[key] = encode_video_chunks(vae, torch.zeros(pixel_values.shape), nf_px,
                                                  None)
        mask = torch.from_numpy(drop).to(device)[:, None, None, None, None]
        cond_latents = torch.where(mask, zero_cache[key], all_latents)

    gh = dit_config.sample_height // dit_config.patch_size
    gw = dit_config.sample_width // dit_config.patch_size
    grid_h_full = np.arange(gh, dtype=np.float32)
    grid_w_full = np.arange(gw, dtype=np.float32)
    cond_h = np.linspace(0, gh, rc.num_height_queries, endpoint=False, dtype=np.float32)
    cond_w = np.linspace(0, gw, rc.num_width_queries, endpoint=False, dtype=np.float32)
    # the resampler's tables at its own head width (the JAX package builds
    # them at the DiT's, the same number in each of its configs)
    rs_image_rope = get_3d_rotary_pos_embed_v2(rc.dim_head, np.arange(nf, dtype=np.float32),
                                               grid_h_full, grid_w_full, device=device)
    rs_sampling_rope = get_3d_rotary_pos_embed_v2(
        rc.dim_head, np.linspace(video_ipadapter_start_frame_idx, video_ipadapter_start_frame_idx + nf, vq,
                       endpoint=False, dtype=np.float32), cond_h, cond_w, device=device)

    # patch-projected per-chunk tokens; the resampler runs inside the loss
    vip_input_chunks = torch.stack(
        [apply_patch_proj(dit_config, patch_proj, cond_latents[:, c * nf:(c + 1) * nf])
         for c in range(num_chunks)], dim=1)  # [B, C, nf, N, E]

    # window-aligned token-frame indices by searchsorted (`:1950-1976`)
    rel_grid = np.concatenate([
        np.linspace(c * nf, (c + 1) * nf, vq, endpoint=False, dtype=np.float32)
        for c in range(num_chunks)])
    emb_idx = np.searchsorted(rel_grid, rel, side="right") - 1
    emb_sel = np.minimum(emb_idx[:, None] + np.arange(n_vip)[None, :], vq * num_chunks - 1)

    # ropes: static base table, per-sample VIP image / condition tables
    image_rope = get_3d_rotary_pos_embed(d, ([0, 0, 0], [nf, gh, gw]), (nf, gh, gw),
                                         device=device)
    abs_idx = torch.from_numpy(np.asarray(start_frame_idx, dtype=np.float32))
    img_grid_t = abs_idx[:, None] + torch.from_numpy(rel)[:, None] + torch.arange(nf)[None, :]
    vip_image_rope = get_3d_rotary_pos_embed_v2_torch(
        d, img_grid_t.float().to(device), torch.from_numpy(grid_h_full).to(device),
        torch.from_numpy(grid_w_full).to(device))
    cond_grid = (video_ipadapter_start_frame_idx + abs_idx)[:, None] + torch.from_numpy(rel_grid)
    cond_sel = torch.gather(cond_grid, 1, torch.from_numpy(emb_sel))
    vip_cond_rope = get_3d_rotary_pos_embed_v2_torch(
        d, cond_sel.float().to(device), torch.from_numpy(cond_h).to(device),
        torch.from_numpy(cond_w).to(device))

    return {
        "latents": latents,
        "vip_input_chunks": vip_input_chunks,
        "vip_emb_sel": torch.from_numpy(emb_sel).to(device),
        "resampler_image_rotary_emb": rs_image_rope,
        "resampler_sampling_rotary_emb": rs_sampling_rope,
        "text_embeds": text_embeds.to(device),
        "image_rotary_emb": image_rope,
        "vip_image_rotary_emb": vip_image_rope,
        "vip_condition_rotary_emb": vip_cond_rope,
        "relative_start_idx": rel,
    }
