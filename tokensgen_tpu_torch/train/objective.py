"""Training objective and timestep sampling (port of
`tokensgen_tpu/train/objective.py`).

* The loss is the v-prediction evaluated in x0 space with the per-timestep
  weight 1/(1-ᾱ_t): ``x0_pred = get_velocity(model_output, noisy, t)``,
  target the clean latents, a mean per sample, then over the batch.
* Timesteps come from two regimes mixed by ``diff_timesteps_ratio``: per-frame
  FIFO ramps, or one uniform timestep per sample, optionally stratified by
  data-parallel rank.

Each sampler draws from an explicit ``torch.Generator`` and hands its draws to
a deterministic function of them (`fifo_ramp_timesteps`,
`stratified_timesteps`), which the tests hold against the JAX functions on
the JAX package's own draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tokensgen_tpu_torch.core import schedule as S


def x0_weights(sched: S.DiffusionSchedule, timesteps: torch.Tensor) -> torch.Tensor:
    """The loss's per-timestep weight 1/(1-ᾱ_t), shaped like ``timesteps``."""
    ap = sched.alphas_cumprod[timesteps.clamp(0, sched.config.num_train_timesteps - 1).long()]
    return 1.0 / (1.0 - ap)


def x0_sample_losses(sched: S.DiffusionSchedule, model_output: torch.Tensor,
                     noisy_input: torch.Tensor, clean_input: torch.Tensor,
                     timesteps: torch.Tensor, loss_mask: Optional[torch.Tensor] = None):
    """[B] per-sample losses mean_elems( w·(x0_pred − x0)² ); ``timesteps``
    [B] or [B, F]. With ``loss_mask`` (broadcastable to the output; T2To's
    padded chunks) each sample's mean runs over its unmasked elements only
    (at least one)."""
    x0_pred = S.get_velocity(sched, model_output, noisy_input, timesteps)
    w = x0_weights(sched, timesteps)
    w = w.reshape(w.shape + (1,) * (model_output.dim() - w.dim()))
    sq = w * (x0_pred - clean_input) ** 2
    b = model_output.shape[0]
    if loss_mask is None:
        return sq.reshape(b, -1).mean(1)
    mask = torch.broadcast_to(loss_mask, sq.shape).to(sq.dtype)
    return (sq * mask).reshape(b, -1).sum(1) / mask.reshape(b, -1).sum(1).clamp_min(1.0)


def x0_weighted_loss(sched: S.DiffusionSchedule, model_output: torch.Tensor,
                     noisy_input: torch.Tensor, clean_input: torch.Tensor,
                     timesteps: torch.Tensor, loss_mask: Optional[torch.Tensor] = None):
    """Scalar loss: the batch mean of `x0_sample_losses`."""
    return x0_sample_losses(sched, model_output, noisy_input, clean_input, timesteps,
                            loss_mask).mean()


def stratified_timesteps(u: torch.Tensor, process_index: torch.Tensor, num_processes: int,
                         num_train_timesteps: int = 1000) -> torch.Tensor:
    """[B] timesteps from uniform draws ``u`` in [0, 1), in the stratum of
    each sample's data-parallel rank (`train_cogvideo_to2v.py:1797-1818`)."""
    interval = num_train_timesteps // num_processes
    shift = num_train_timesteps % interval if interval > 0 else 0
    lo = torch.where(process_index == 0, 0, process_index * interval + shift)
    hi = torch.where(process_index == 0, interval + shift, (process_index + 1) * interval + shift)
    return (lo + u * (hi - lo)).long()


def sample_uniform_timesteps(generator: torch.Generator, batch: int,
                             num_train_timesteps: int = 1000,
                             process_index: Optional[torch.Tensor] = None,
                             num_processes: int = 1, device=None) -> torch.Tensor:
    """[B] timesteps, uniform over [0, T), or stratified by rank."""
    if process_index is None or num_processes <= 1:
        return torch.randint(0, num_train_timesteps, (batch,), generator=generator,
                             device=device)
    u = torch.rand(batch, generator=generator, device=device)
    return stratified_timesteps(u, process_index.to(u.device), num_processes,
                                num_train_timesteps)


def fifo_ramp_high(num_frames: int, num_train_timesteps: int = 1000,
                   inference_timesteps: int = 52) -> int:
    """Exclusive upper end of a ramp's first-frame timestep."""
    interv = (num_train_timesteps - 1) / (inference_timesteps - 1)
    return int(num_train_timesteps - interv * (num_frames - 1))


def fifo_ramp_timesteps(base: torch.Tensor, num_frames: int, num_train_timesteps: int = 1000,
                        inference_timesteps: int = 52) -> torch.Tensor:
    """[B, F] per-frame ramps from the first frames' timesteps ``base`` [B]:
    linearly up by (T-1)/(inference_steps-1) per frame, as the FIFO queue
    holds them (`train_cogvideo_to2v.py:1773-1795`)."""
    interv = (num_train_timesteps - 1) / (inference_timesteps - 1)
    base = base.float()
    end = torch.round(base + interv * (num_frames - 1))
    frac = torch.from_numpy(np.linspace(0.0, 1.0, num_frames, dtype=np.float32)).to(base.device)
    ramp = base[:, None] + frac[None, :] * (end - base)[:, None]
    return torch.round(ramp).clamp(0, num_train_timesteps - 1).long()


def sample_fifo_ramp_timesteps(generator: torch.Generator, batch: int, num_frames: int,
                               num_train_timesteps: int = 1000, inference_timesteps: int = 52,
                               device=None) -> torch.Tensor:
    hi = fifo_ramp_high(num_frames, num_train_timesteps, inference_timesteps)
    base = torch.randint(0, hi, (batch,), generator=generator, device=device)
    return fifo_ramp_timesteps(base, num_frames, num_train_timesteps, inference_timesteps)


def sample_timesteps(generator: torch.Generator, batch: int, num_frames: int,
                     diff_timesteps_ratio: float, num_train_timesteps: int = 1000,
                     inference_timesteps: int = 52, device=None,
                     num_processes: int = 1) -> torch.Tensor:
    """[B, F] timesteps of one micro-batch, as the JAX train step draws
    them: with probability ``diff_timesteps_ratio`` the whole batch takes
    FIFO ramps, else one uniform timestep per sample for all its frames,
    with ``num_processes`` > 1 stratified by batch position (position i in
    stratum i mod ``num_processes``, the JAX step's stand-in for the
    reference's per-rank strata). A data-parallel rank draws the global
    batch and keeps its rows."""
    strata = (torch.arange(batch, device=device) % num_processes if num_processes > 1
              else None)
    t_uniform = sample_uniform_timesteps(generator, batch, num_train_timesteps, strata,
                                         num_processes, device=device)
    t_ramp = sample_fifo_ramp_timesteps(generator, batch, num_frames, num_train_timesteps,
                                        inference_timesteps, device)
    use_ramp = torch.rand((), generator=generator, device=device) < diff_timesteps_ratio
    return torch.where(use_ramp, t_ramp, t_uniform[:, None].expand(batch, num_frames))
