"""Random parameter initialisation on the module's own device."""

from __future__ import annotations

import math

import torch
import torch.nn as nn


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init, in place and on the parameters' device (a 7 B
    parameter model is initialised on the card, not copied there).

    Matrices and conv kernels: normal(0, 1/sqrt(fan_in)) (the JAX package's
    lecun-normal scale); biases 0; 1-D norm weights 1; the resampler's latent
    queries normal(0, 1/sqrt(dim)). ``generator`` must live on the
    parameters' device.
    """
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "latents":
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
        elif leaf == "bias":
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            fan_in = p[0].numel()
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
    return module


def build_on_device(ctor, device, generator: torch.Generator) -> nn.Module:
    """Construct ``ctor()`` without allocating on the host, then materialise
    it on ``device`` and initialise it there with ``generator``."""
    with torch.device("meta"):
        module = ctor()
    module = module.to_empty(device=device)
    return init_params_(module, generator).eval()
