"""Checkpoint and resume (port of `tokensgen_tpu/train/checkpoint.py`).

One ``checkpoint-{step}/state.pt`` per saved step (``torch.save`` of the
trainable parameters, the optimizer state and the step), rotated to keep the
newest ``total_limit``; resume finds the latest. Loading uses
``weights_only=True``: the files hold tensors, dicts and numbers only.
`export_reference_artifacts` writes trained weights in the reference's
artifact layout (the port's DiT and resampler names are the reference's).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors

_STATE = "state.pt"


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"checkpoint-{step}")


def save_checkpoint(root: str, step: int, state: Dict[str, Any],
                    total_limit: Optional[int] = None) -> str:
    """Save ``state`` under checkpoint-{step} (written to a temporary name
    first, so a cut-off save leaves no half checkpoint); rotate old ones."""
    path = os.path.abspath(_ckpt_dir(root, step))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _STATE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, _STATE))
    if total_limit is not None:
        for old in list_checkpoints(root)[:-total_limit]:
            shutil.rmtree(_ckpt_dir(root, old), ignore_errors=True)
    return path


def list_checkpoints(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and os.path.exists(os.path.join(root, name, _STATE)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(root: str) -> Optional[int]:
    steps = list_checkpoints(root)
    return steps[-1] if steps else None


def restore_checkpoint(root: str, map_location=None
                       ) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
    """(state, step) of the latest checkpoint, (None, None) if there is none."""
    step = latest_checkpoint(root)
    if step is None:
        return None, None
    path = os.path.join(_ckpt_dir(root, step), _STATE)
    return torch.load(path, map_location=map_location, weights_only=True), step


def _f32(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in sd.items()}


def export_vip_only(dit_state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The ``vip.pt`` artifact: the DiT's entries with ``vip_`` in their
    name, float32."""
    return _f32({k: v for k, v in dit_state.items() if "vip_" in k})


def export_resampler(resampler_state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The resampler's reference state dict, float32."""
    return _f32(resampler_state)


def export_reference_artifacts(out_dir: str, dit_state=None, resampler_state=None, pca=None,
                               token_mean=None, token_std=None) -> None:
    """Writes the reference artifact layout from the port's state dicts:
    ``vip.safetensors`` (the DiT's ``vip_*`` weights),
    ``resampler/diffusion_flax_model.safetensors``, ``pca.safetensors``
    (``mean_``, ``components_`` of a `PCAState`), ``mean.npy`` and
    ``std.npy``; each only when given."""
    os.makedirs(out_dir, exist_ok=True)
    if dit_state is not None:
        save_safetensors(os.path.join(out_dir, "vip.safetensors"), export_vip_only(dit_state))
    if resampler_state is not None:
        rs_dir = os.path.join(out_dir, "resampler")
        os.makedirs(rs_dir, exist_ok=True)
        save_safetensors(os.path.join(rs_dir, "diffusion_flax_model.safetensors"),
                         export_resampler(resampler_state))
    if pca is not None:
        save_safetensors(os.path.join(out_dir, "pca.safetensors"),
                         _f32({"mean_": pca.mean, "components_": pca.components}))
    for name, val in (("mean.npy", token_mean), ("std.npy", token_std)):
        if val is not None:
            np.save(os.path.join(out_dir, name),
                    val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val))
