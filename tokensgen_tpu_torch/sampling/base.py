"""Base (per-clip) denoising loop (port of `tokensgen_tpu/sampling/base.py`).

A Python loop over the inference timesteps: CFG batching with 2-way or 3-way
guidance (optionally the dynamic CFG ramp), DPM-Solver++(2M) or DDIM steps,
and the FIFO-seed snapshots (before step i the frame ``max(0, F-1-i)`` of the
latents and the previous x0 are recorded; returned cleanest first).

Randomness comes from a noise source ``noise_fn(tag, shape) -> Tensor``; the
tags name the draw (``("base", step, 0 | 1)``) so a test can replay another
framework's noise. `generator_noise` turns a `torch.Generator` into one (draws
in call order); `keyed_noise` makes each draw a function of the seed and its
tag alone, so a run resumed part way reproduces the uninterrupted run's noise.
Both have a ``spec()`` from which `noise_from_spec` continues them on
another process's device (the queue-sharded FIFO's other ranks).

`ddim_invert` runs the deterministic DDIM inversion (clean latents -> their
generating noise). With ``TOKENSGEN_DEBUG=1`` each step prints the noise
prediction's value range (`utils.debug`).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tokensgen_tpu_torch.core import cfg as cfg_lib
from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.utils import debug

NoiseFn = Callable[[tuple, Tuple[int, ...]], torch.Tensor]


class GeneratorNoise:
    """Standard-normal float32 draws from ``generator`` on its device, in
    call order."""

    keyed = False  # a draw depends on every draw before it

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, tag: tuple, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device, dtype=torch.float32)

    def spec(self) -> tuple:
        """What `noise_from_spec` needs to draw on from here on another
        device of the same type: the generator's state."""
        return ("generator", self.generator.device.type, self.generator.get_state())


class KeyedNoise:
    """Standard-normal float32 draws on ``device``, each from a fresh
    generator seeded with a 63-bit hash of ``(seed, tag)``: a draw depends
    on nothing else, whatever was drawn before it (the counterpart of the
    JAX engine's per-iteration keys, `jax.random.split` + `fold_in`)."""

    keyed = True

    def __init__(self, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)

    def __call__(self, tag: tuple, shape) -> torch.Tensor:
        key = "/".join(str(x) for x in (self.seed, *tag)).encode()
        digest = hashlib.blake2b(key, digest_size=8).digest()
        gen = torch.Generator(device=self.device).manual_seed(
            int.from_bytes(digest, "little") >> 1)
        return torch.randn(tuple(shape), generator=gen, device=self.device, dtype=torch.float32)

    def spec(self) -> tuple:
        return ("keyed", self.seed)


def generator_noise(generator: torch.Generator) -> NoiseFn:
    """Standard-normal float32 draws from ``generator`` on its device."""
    return GeneratorNoise(generator)


def keyed_noise(seed: int, device) -> NoiseFn:
    """Draws that depend only on ``(seed, tag)`` (`KeyedNoise`)."""
    return KeyedNoise(seed, device)


def noise_from_spec(spec: tuple, device) -> NoiseFn:
    """The noise source a `GeneratorNoise.spec` or `KeyedNoise.spec`
    describes, drawing on ``device``: another rank's source, continued."""
    if spec[0] == "keyed":
        return KeyedNoise(spec[1], device)
    device = torch.device(device)
    if spec[1] != device.type:
        raise ValueError(f"a {spec[1]} generator's state cannot seed a {device.type} generator")
    gen = torch.Generator(device=device)
    gen.set_state(spec[2].cpu())  # a state crosses on the group's device
    return GeneratorNoise(gen)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_inference_steps: int = 52
    guidance_scale: float = 6.0
    guidance_scale_img: float = 1.5
    use_dynamic_cfg: bool = False
    use_separate_guidance: bool = False
    do_classifier_free_guidance: bool = True
    scheduler: str = "dpm"  # "dpm" | "ddim"
    stochastic: bool = True
    collect_fifo: bool = False


class DenoiseResult(NamedTuple):
    latents: torch.Tensor  # [B, F, C, H, W]
    fifo_latents: Optional[torch.Tensor]  # [B, steps, C, H, W] cleanest first
    fifo_old_x0: Optional[torch.Tensor]
    fifo_old_valid: Optional[torch.Tensor]  # [steps] bool


def guidance_tables(scale: float, scale_img: float, steps: int, sched: S.DiffusionSchedule):
    """Dynamic CFG tables [T] (text, image) on the schedule's device."""
    dev = sched.alphas_cumprod.device
    t = sched.config.num_train_timesteps
    return (torch.from_numpy(cfg_lib.dynamic_scale_table(scale, steps, t)).to(dev),
            torch.from_numpy(cfg_lib.dynamic_scale_table(scale_img, steps, t)).to(dev))


@torch.no_grad()
def denoise(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sched: S.DiffusionSchedule,
    scfg: SamplerConfig,
    latents: torch.Tensor,
    noise_fn: Optional[NoiseFn] = None,
) -> DenoiseResult:
    """Run the denoise loop. ``model_fn(latents_cfg, timestep_vec [nB]) ->
    noise_pred`` closes over CFG-batched conditioning (uncond first)."""
    ts = np.asarray(S.inference_timesteps(sched.config, scfg.num_inference_steps))
    n = len(ts)
    prev_ts = np.concatenate([ts[1:], [-1]])
    back_ts = np.concatenate([[-1], ts[:-1]])
    f = latents.shape[1]
    dev = latents.device
    if scfg.stochastic and scfg.scheduler == "dpm" and noise_fn is None:
        raise ValueError("a stochastic DPM denoise needs a noise source")
    g_table = gi_table = None
    if scfg.use_dynamic_cfg:
        g_table, gi_table = guidance_tables(scfg.guidance_scale, scfg.guidance_scale_img, n,
                                            sched)

    latents = latents.float()
    old_x0 = torch.zeros_like(latents)
    old_valid = False
    b = latents.shape[0]
    snaps_l, snaps_x, snaps_v = [], [], []
    for i in range(n):
        t, prev_t, back_t = int(ts[i]), int(prev_ts[i]), int(back_ts[i])
        if scfg.collect_fifo:
            idx = max(0, f - 1 - i)
            snaps_l.append(latents[:, idx].clone())
            snaps_x.append(old_x0[:, idx].clone())
            snaps_v.append(old_valid)
        lat_in = cfg_lib.batch_for_cfg(latents, scfg.do_classifier_free_guidance,
                                       scfg.use_separate_guidance)
        tvec = torch.full((lat_in.shape[0],), t, dtype=torch.int64, device=dev)
        noise_pred = debug.stats("noise_pred", model_fn(lat_in, tvec).float())
        if scfg.do_classifier_free_guidance:
            g = g_table[t] if g_table is not None else scfg.guidance_scale
            gi = gi_table[t] if gi_table is not None else scfg.guidance_scale_img
            noise_pred = cfg_lib.combine(noise_pred, g, gi, scfg.use_separate_guidance)

        def full(v):
            return torch.full((b,), v, dtype=torch.int64, device=dev)

        if scfg.scheduler == "ddim":
            latents, x0 = S.ddim_step(sched, noise_pred, latents, full(t), full(prev_t))
        else:
            noise = noise2 = None
            if scfg.stochastic:
                noise = noise_fn(("base", i, 0), latents.shape)
                noise2 = noise_fn(("base", i, 1), latents.shape)
            latents, x0 = S.dpm_step(
                sched, noise_pred, latents, full(t), full(prev_t), t_back=full(back_t),
                old_pred_original_sample=old_x0,
                old_valid=torch.full((b,), old_valid, dtype=torch.bool, device=dev),
                noise=noise, noise2=noise2)
        old_x0, old_valid = x0, True

    if not scfg.collect_fifo:
        return DenoiseResult(latents, None, None, None)
    return DenoiseResult(
        latents,
        torch.stack(snaps_l[::-1], dim=1),
        torch.stack(snaps_x[::-1], dim=1),
        torch.tensor(snaps_v[::-1], dtype=torch.bool, device=dev),
    )


@torch.no_grad()
def ddim_invert(model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                sched: S.DiffusionSchedule, latents: torch.Tensor,
                num_inference_steps: int = 52) -> torch.Tensor:
    """Deterministic DDIM inversion: clean latents [B, F, C, H, W] -> their
    generating noise, f32. The inference grid runs ascending with
    `S.ddim_invert_step`, the model unconditional (``model_fn(x, t [B])``,
    no CFG: guidance makes inversion non-invertible); each step's model call
    sees the current noise level (the first, t = -1, queried at 0)."""
    ts = np.asarray(S.inference_timesteps(sched.config, num_inference_steps))[::-1]
    src_ts = np.concatenate([[-1], ts[:-1]])  # -1 => alpha_cumprod = 1 (clean)
    b, dev = latents.shape[0], latents.device
    x = latents.float()
    for src_t, dst_t in zip(src_ts, ts):
        tvec = torch.full((b,), max(int(src_t), 0), dtype=torch.int64, device=dev)
        eps = model_fn(x, tvec).float()
        x = S.ddim_invert_step(sched, eps, x, torch.full((b,), int(src_t), device=dev),
                               torch.full((b,), int(dst_t), device=dev))
    return x
