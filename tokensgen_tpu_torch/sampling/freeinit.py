"""FreeInit iterative noise re-initialisation (port of
`tokensgen_tpu/sampling/freeinit.py`): after each full denoise pass, keep the
low spatio-temporal frequencies of the re-diffused result, take the high
ones from fresh noise, and denoise again.

Randomness comes from a noise source ``noise_fn(tag, shape)``
(`sampling.base.generator_noise` over an explicit generator, or one that
replays another framework's draws): pass ``it``'s denoise draws under
``("freeinit", it) + tag`` and its two fresh draws as ``("freeinit", it,
"fresh")`` (the re-diffusion noise) and ``("freeinit", it, "fresh2")`` (the
high frequencies).
"""

from __future__ import annotations

from typing import Callable

import torch

from tokensgen_tpu_torch.sampling.base import NoiseFn


def butterworth_low_pass_3d(shape, d_s: float = 0.25, d_t: float = 0.25, order: int = 4,
                            device=None) -> torch.Tensor:
    """[F, H, W] float32 low-pass mask in centred frequency space."""
    f, h, w = shape
    tt = (torch.arange(f, device=device) / f - 0.5)[:, None, None]
    hh = (torch.arange(h, device=device) / h - 0.5)[None, :, None]
    ww = (torch.arange(w, device=device) / w - 0.5)[None, None, :]
    d_sq = (tt / max(d_t, 1e-6)) ** 2 + (hh / max(d_s, 1e-6)) ** 2 + (ww / max(d_s, 1e-6)) ** 2
    return 1.0 / (1.0 + d_sq ** order)


def freq_mix_3d(x: torch.Tensor, noise: torch.Tensor, lpf: torch.Tensor) -> torch.Tensor:
    """Low frequencies from ``x``, high frequencies from ``noise``, over the
    frame, height and width axes of [B, F, C, H, W]; ``lpf`` [F, H, W]."""
    dims = (1, 3, 4)

    def spectrum(z):
        return torch.fft.fftshift(torch.fft.fftn(z.to(torch.complex64), dim=dims), dim=dims)

    m = lpf[None, :, None, :, :]
    mixed = spectrum(x) * m + spectrum(noise) * (1 - m)
    return torch.fft.ifftn(torch.fft.ifftshift(mixed, dim=dims), dim=dims).real.to(x.dtype)


def freeinit_refine(denoise_fn: Callable[[torch.Tensor, NoiseFn], torch.Tensor],
                    add_noise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    initial_noise: torch.Tensor, noise_fn: NoiseFn, num_iters: int = 3,
                    d_s: float = 0.25, d_t: float = 0.25) -> torch.Tensor:
    """``num_iters`` denoise passes with frequency re-initialisation between
    them. ``denoise_fn(latents, noise_fn) -> clean latents``;
    ``add_noise_fn(clean, noise) -> x_T`` re-diffuses to the first timestep."""
    f, _, h, w = initial_noise.shape[1:]
    lpf = butterworth_low_pass_3d((f, h, w), d_s, d_t, device=initial_noise.device)
    latents, clean = initial_noise, None
    for it in range(num_iters):
        def draw(tag, shape, it=it):
            return noise_fn(("freeinit", it) + tuple(tag), shape)

        clean = denoise_fn(latents, draw)
        if it == num_iters - 1:
            break
        diffused = add_noise_fn(clean, noise_fn(("freeinit", it, "fresh"), clean.shape))
        latents = freq_mix_3d(diffused, noise_fn(("freeinit", it, "fresh2"), clean.shape), lpf)
    return clean
