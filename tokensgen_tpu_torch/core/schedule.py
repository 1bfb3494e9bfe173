"""CogVideoX diffusion schedules and solver steps on torch tensors.

Port of `tokensgen_tpu/core/schedule.py`: the coefficient tables are built in
float64 numpy exactly as there and stored as float32 tensors; every ``*_step``
takes its timesteps as integer tensors of any shape broadcastable against the
sample's leading dims, so one call advances a whole FIFO window whose frames sit
at different noise levels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.0120
    beta_schedule: str = "scaled_linear"  # "linear" | "scaled_linear" | "vip_1"
    snr_shift_scale: float = 3.0
    rescale_betas_zero_snr: bool = True
    set_alpha_to_one: bool = True
    timestep_spacing: str = "trailing"  # "linspace" | "leading" | "trailing"
    steps_offset: int = 0
    prediction_type: str = "v_prediction"  # "epsilon" | "sample" | "v_prediction"


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor  # [T] original betas (used by add_noise_to_xt)
    alphas_cumprod: torch.Tensor  # [T] after SNR shift / zero-SNR / vip_1 warp
    final_alpha_cumprod: torch.Tensor  # scalar
    config: ScheduleConfig

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(self.betas.to(device), self.alphas_cumprod.to(device),
                                 self.final_alpha_cumprod.to(device), self.config)


def _rescale_zero_terminal_snr(ac: np.ndarray) -> np.ndarray:
    s = np.sqrt(ac)
    s0, sT = s[0], s[-1]
    s = (s - sT) * (s0 / (s0 - sT))
    return s**2


def _vip_1_warp(ac: np.ndarray, T: int) -> np.ndarray:
    a1, na1 = int(T * 0.5), int(T * 0.3)
    a2, na2 = int(T * 0.8), int(T * 0.5)

    def shift(a: int, b: int, na: int, nb: int) -> np.ndarray:
        seg = ac[na:nb]
        return (seg - ac[na]) / (ac[nb - 1] - ac[na]) * (ac[b - 1] - ac[a]) + ac[a]

    return np.concatenate([shift(0, a1, 0, na1), shift(a1, a2, na1, na2), shift(a2, T, na2, T)])


def make_schedule(config: ScheduleConfig = ScheduleConfig(), device=None) -> DiffusionSchedule:
    T = config.num_train_timesteps
    if config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, T, dtype=np.float64)
    elif config.beta_schedule in ("scaled_linear", "vip_1"):
        betas = np.linspace(config.beta_start**0.5, config.beta_end**0.5, T,
                            dtype=np.float64) ** 2
    else:
        raise NotImplementedError(config.beta_schedule)

    ac = np.cumprod(1.0 - betas)
    s = config.snr_shift_scale
    ac = ac / (s + (1.0 - s) * ac)
    if config.rescale_betas_zero_snr:
        ac = _rescale_zero_terminal_snr(ac)
    if config.beta_schedule == "vip_1":
        ac = _vip_1_warp(ac, T)

    final = 1.0 if config.set_alpha_to_one else float(ac[0])
    f32 = torch.float32
    return DiffusionSchedule(
        betas=torch.tensor(betas.astype(np.float32), dtype=f32, device=device),
        alphas_cumprod=torch.tensor(ac.astype(np.float32), dtype=f32, device=device),
        final_alpha_cumprod=torch.tensor(np.float32(final), dtype=f32, device=device),
        config=config,
    )


def inference_timesteps(config: ScheduleConfig, num_inference_steps: int) -> np.ndarray:
    """Descending int timestep vector (host-side; mirrors `set_timesteps`)."""
    T = config.num_train_timesteps
    if num_inference_steps > T:
        raise ValueError(f"num_inference_steps {num_inference_steps} > {T}")
    if config.timestep_spacing == "linspace":
        ts = np.linspace(0, T - 1, num_inference_steps).round()[::-1].astype(np.int64)
    elif config.timestep_spacing == "leading":
        step_ratio = T // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        ts = ts + config.steps_offset
    elif config.timestep_spacing == "trailing":
        step_ratio = T / num_inference_steps
        ts = np.round(np.arange(T, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(config.timestep_spacing)
    return ts.copy()


def _bcast(coef: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """Right-pad coefficient dims so [B] / [B,F] broadcasts against [B,F,C,H,W]."""
    return coef.reshape(coef.shape + (1,) * (sample.dim() - coef.dim()))


def _alpha_at(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """alphas_cumprod[t], with t < 0 mapping to final_alpha_cumprod."""
    safe = t.clamp(0, sched.config.num_train_timesteps - 1).long()
    return torch.where(t >= 0, sched.alphas_cumprod[safe], sched.final_alpha_cumprod)


def pred_original_sample(sched, model_output, sample, t, prediction_type: Optional[str] = None):
    prediction_type = prediction_type or sched.config.prediction_type
    ap = _bcast(_alpha_at(sched, t), sample)
    bp = 1.0 - ap
    if prediction_type == "epsilon":
        return (sample - bp**0.5 * model_output) / ap**0.5
    if prediction_type == "sample":
        return model_output
    if prediction_type == "v_prediction":
        return ap**0.5 * sample - bp**0.5 * model_output
    raise ValueError(prediction_type)


def ddim_step(sched, model_output, sample, t, prev_t) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic DDIM step -> (prev_sample, pred_x0)."""
    x0 = pred_original_sample(sched, model_output, sample, t)
    ap = _bcast(_alpha_at(sched, t), sample)
    ap_prev = _bcast(_alpha_at(sched, prev_t), sample)
    a_t = ((1.0 - ap_prev) / (1.0 - ap)) ** 0.5
    b_t = ap_prev**0.5 - ap**0.5 * a_t
    return a_t * sample + b_t * x0, x0


def dpm_step(
    sched: DiffusionSchedule,
    model_output: torch.Tensor,
    sample: torch.Tensor,
    t: torch.Tensor,
    prev_t: torch.Tensor,
    t_back: Optional[torch.Tensor] = None,
    old_pred_original_sample: Optional[torch.Tensor] = None,
    old_valid: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    noise2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic DPM-Solver++(2M) step -> (prev_sample, pred_x0); the same
    masked form of the reference's branches as the JAX `dpm_step`. ``noise``
    and ``noise2`` are injected by the caller; None gives the deterministic
    update with the same means."""
    x0 = pred_original_sample(sched, model_output, sample, t)
    ap = _bcast(_alpha_at(sched, t), sample)
    ap_prev = _bcast(_alpha_at(sched, prev_t), sample)

    lamb = torch.log((ap / (1.0 - ap)) ** 0.5)
    lamb_next = torch.log((ap_prev / (1.0 - ap_prev)) ** 0.5)
    h = lamb_next - lamb

    mult1 = ((1.0 - ap_prev) / (1.0 - ap)) ** 0.5 * torch.exp(-h)
    mult2 = torch.expm1(-2.0 * h) * ap_prev**0.5
    mult_noise = (1.0 - ap_prev) ** 0.5 * (1.0 - torch.exp(-2.0 * h)) ** 0.5

    def first_order(n):
        out = mult1 * sample - mult2 * x0
        return out + mult_noise * n if n is not None else out

    if t_back is None or old_pred_original_sample is None:
        return first_order(noise), x0

    ap_back = _bcast(_alpha_at(sched, t_back), sample)
    lamb_prev = torch.log((ap_back / (1.0 - ap_back)) ** 0.5)
    r = (lamb - lamb_prev) / h
    mult3 = 1.0 + 1.0 / (2.0 * r)
    mult4 = 1.0 / (2.0 * r)

    denoised_d = mult3 * x0 - mult4 * old_pred_original_sample
    n2 = noise2 if noise2 is not None else noise
    multistep = mult1 * sample - mult2 * denoised_d
    if n2 is not None:
        multistep = multistep + mult_noise * n2

    use_multi = _bcast(prev_t >= 0, sample)
    if old_valid is not None:
        use_multi = use_multi & _bcast(old_valid, sample)
    return torch.where(use_multi, multistep, first_order(noise)), x0


def add_noise(sched, original_samples, noise, t):
    ap = _bcast(_alpha_at(sched, t), original_samples).to(original_samples.dtype)
    return ap**0.5 * original_samples + (1.0 - ap) ** 0.5 * noise


def get_velocity(sched, sample, noise, t):
    """``sqrt(ᾱ_t)·noise − sqrt(1−ᾱ_t)·sample`` (the training loss calls it
    with (model_output, noisy) to get the x0 estimate of a v-prediction)."""
    ap = _bcast(_alpha_at(sched, t), sample).to(sample.dtype)
    return ap**0.5 * noise - (1.0 - ap) ** 0.5 * sample


def add_noise_to_xt(sched, xt_previous, noise, t):
    """Single-beta renoise `x_t = sqrt(1-β_t)·x_{t-1} + sqrt(β_t)·ε` of the
    recycled FIFO tail frame. Uses the *original* betas."""
    beta = _bcast(sched.betas[t.long()], xt_previous)
    return (1.0 - beta) ** 0.5 * xt_previous + beta**0.5 * noise
