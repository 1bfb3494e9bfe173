"""Loaders of the reference's artifact layout (the loading half of
`tokensgen_tpu/convert/torch_weights.py`).

* `read_safetensors_dir`: every top-level ``*.safetensors`` of a dir as one
  state dict, as the JAX inference CLI reads ``pretrained_model_name_or_path``
  for the DiT (diffusers names, which are the port's module names, so the
  dict loads with ``load_state_dict(strict=True)``);
* `load_pca_artifact`: a pickled torch PCA module (``pca.pt``) -> `PCAState`;
* `load_gen_pca`: the gen workload's ``longvgen_pca`` safetensors
  (``mean_``, ``components_``) and, through `load_token_stats`, the
  ``longvgen_mean`` / ``longvgen_std`` ``.npy`` files.

The diffusers -> JAX converters (``convert_dit``, ``convert_vae``,
``convert_t5``, ``load_torch_state_dict``) have no counterpart: the port's
names are the diffusers ones, and ``convert_weights.py`` stays the JAX
package's tool.
"""

from __future__ import annotations

import os
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
