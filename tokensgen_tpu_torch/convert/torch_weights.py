"""Loaders of the reference's artifact layout (the loading half of
`tokensgen_tpu/convert/torch_weights.py`).

* `read_safetensors_dir`: every top-level ``*.safetensors`` of a dir as one
  state dict, as the JAX inference CLI reads ``pretrained_model_name_or_path``
  for the DiT (diffusers names, which are the port's module names, so the
  dict loads with ``load_state_dict(strict=True)``; a DiT variant's too:
  ``ar_norm1`` / ``ar_norm2`` of VIP func_type "4", no ``vip_norm*`` for "3",
  ``patch_embed.proj`` as a Linear in the raw-token mode), and the DINOv2
  encoder's HF dir;
* `load_pca_artifact`: a pickled torch PCA module (``pca.pt``) -> `PCAState`;
* `load_gen_pca`: the gen workload's ``longvgen_pca`` safetensors
  (``mean_``, ``components_``) and, through `load_token_stats`, the
  ``longvgen_mean`` / ``longvgen_std`` ``.npy`` files;
* `vae_from_diffusers`: a diffusers ``AutoencoderKLCogVideoX`` state dict
  (an HF ``vae/`` dir) -> the port's VAE names (the JAX package's
  ``convert_vae``); `vae_to_diffusers` is its inverse, which writes such a
  dir.

The other diffusers -> JAX converters (``convert_dit``, ``convert_t5``,
``load_torch_state_dict``) have no counterpart: the port's DiT, resampler
and T5 names are the diffusers ones, and ``convert_weights.py`` stays the
JAX package's tool.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

from tokensgen_tpu_torch.convert.safetensors_io import load_safetensors
from tokensgen_tpu_torch.core.pca import PCAState


def read_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of every ``*.safetensors`` directly in ``path`` (not in
    its subdirs), merged in file-name order; empty when there are none."""
    sd: Dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.endswith(".safetensors") and os.path.isfile(full):
            sd.update(load_safetensors(full))
    return sd


def load_pca_artifact(path: str) -> PCAState:
    """``pca.pt`` (a pickled torch PCA module with ``mean_`` and
    ``components_``) -> `PCAState`, float32 on the CPU. Unpickling runs the
    file's code: load only artifacts from a trusted checkpoint."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return PCAState(mean=obj.mean_.float(), components=obj.components_.float())


def load_token_stats(mean_path: str, std_path: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The token mean and std ``.npy`` files, float32 on ``device``."""
    return tuple(torch.from_numpy(np.asarray(np.load(p), np.float32)).to(device)
                 for p in (mean_path, std_path))


def load_gen_pca(pca_path: str, mean_path: str, std_path: str,
                 device) -> Tuple[PCAState, torch.Tensor, torch.Tensor]:
    """(PCAState, token mean, token std) on ``device``, float32: the PCA from
    a safetensors file (``mean_``, ``components_``), mean and std from
    ``.npy`` files."""
    sd = load_safetensors(pca_path)
    state = PCAState(mean=sd["mean_"].float().to(device),
                     components=sd["components_"].float().to(device))
    return (state, *load_token_stats(mean_path, std_path, device))


# the port's VAE module names (the JAX package's flax scopes) <-> diffusers'
_VAE_NAMES = (
    (r"(encoder)\.down_(\d+)_res_(\d+)\.", r"\1.down_blocks.\2.resnets.\3."),
    (r"(encoder)\.down_(\d+)_downsample\.", r"\1.down_blocks.\2.downsamplers.0."),
    (r"(decoder)\.up_(\d+)_res_(\d+)\.", r"\1.up_blocks.\2.resnets.\3."),
    (r"(decoder)\.up_(\d+)_upsample\.", r"\1.up_blocks.\2.upsamplers.0."),
    (r"(encoder|decoder)\.mid_res_(\d+)\.", r"\1.mid_block.resnets.\2."),
)
_SAMPLER_CONV = re.compile(r"\.(down|up)samplers\.0\.conv\.weight$")


def vae_to_diffusers(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's VAE state dict -> diffusers names and layouts (the down-
    and upsamplers' convs are 2-D there: [O, I, 3, 3])."""
    out = {}
    for key, val in sd.items():
        for pat, rep in _VAE_NAMES:
            key = re.sub("^" + pat, rep, key)
        out[key] = val[:, :, 0] if _SAMPLER_CONV.search(key) else val
    return out


def vae_from_diffusers(sd: Dict[str, torch.Tensor], model: torch.nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """A diffusers VAE state dict -> the state dict of the port's ``model``
    (the JAX package's ``convert_vae``): the keys ``model`` has, each
    renamed and, for the samplers' 2-D convs, given a time axis of 1. Keys
    it has no use for are ignored; a missing one raises KeyError."""
    port_of = {}
    for key in model.state_dict():
        diff = key
        for pat, rep in _VAE_NAMES:
            diff = re.sub("^" + pat, rep, diff)
        port_of[diff] = key
    missing = sorted(set(port_of) - set(sd))
    if missing:
        raise KeyError(f"diffusers VAE state dict lacks {len(missing)} keys, e.g. {missing[:3]}")
    return {port: (sd[diff][:, :, None] if _SAMPLER_CONV.search(diff) else sd[diff])
            for diff, port in port_of.items()}
