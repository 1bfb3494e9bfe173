"""Classifier-free-guidance math on torch tensors (port of
`tokensgen_tpu/core/cfg.py`)."""

from __future__ import annotations

import numpy as np
import torch


def dynamic_scale_table(guidance_scale: float, num_inference_steps: int,
                        num_train_timesteps: int = 1000) -> np.ndarray:
    """[T] float64-computed table of the CogVideoX dynamic CFG ramp over raw
    timesteps: ``1 + g·(1 - cos(π·((steps - t)/steps)^5))/2``."""
    t = np.arange(num_train_timesteps, dtype=np.float64)
    ratio = (num_inference_steps - t) / num_inference_steps
    return (1.0 + guidance_scale * (1.0 - np.cos(np.pi * ratio**5.0)) / 2.0).astype(np.float32)


def combine(
    noise_pred: torch.Tensor,
    guidance_scale,
    guidance_scale_img=None,
    use_separate_guidance: bool = False,
) -> torch.Tensor:
    """Collapse a CFG-batched prediction ([2B or 3B, ...]) to [B, ...], uncond
    first. ``guidance_scale`` is a scalar or a per-frame [F] tensor."""
    if use_separate_guidance:
        u_txt, u_img, ti = torch.chunk(noise_pred, 3, dim=0)
        g = _expand(guidance_scale, ti)
        gi = _expand(guidance_scale_img, ti)
        return ti + (g - 1.0) * (ti - u_txt) + (gi - 1.0) * (ti - u_img)
    uncond, text = torch.chunk(noise_pred, 2, dim=0)
    g = _expand(guidance_scale, text)
    return uncond + g * (text - uncond)


def _expand(scale, like: torch.Tensor):
    if not isinstance(scale, torch.Tensor):
        # rounded to like's dtype, kept on the host (no blocking copy to the card)
        return torch.tensor(scale, dtype=like.dtype).item()
    scale = scale.to(like.dtype)
    if scale.dim() == 0:
        return scale
    return scale.reshape((1,) + tuple(scale.shape) + (1,) * (like.dim() - scale.dim() - 1))


def batch_for_cfg(latents: torch.Tensor, do_cfg: bool,
                  use_separate_guidance: bool = False) -> torch.Tensor:
    """Tile latents along batch for the CFG forward ([B]->[2B] or [3B])."""
    if not do_cfg:
        return latents
    n = 3 if use_separate_guidance else 2
    return torch.cat([latents] * n, dim=0)
