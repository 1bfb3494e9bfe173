"""Checkpoint and resume (port of `tokensgen_tpu/train/checkpoint.py`).

One ``checkpoint-{step}/state.pt`` per saved step (``torch.save`` of the
trainable parameters, the optimizer state and the step), rotated to keep the
newest ``total_limit``; resume finds the latest. Loading uses
``weights_only=True``: the files hold tensors, dicts and numbers only.

A data-parallel group saves together: rank 0 writes ``state.pt``, and under
ZeRO-1 each rank writes its own part of the optimizer state with its
element ranges (``opt-rank{r}-of-{n}.pt``; no rank gathers the others'
moments), before ``state.pt``, so that a checkpoint with a ``state.pt`` is
whole. `restore_trainer` restores at any rank count, with or without
ZeRO-1: a rank reads its own part file where the layout is the one written,
else it cuts its part out of every part file, mapped, not read whole
(`sharding.zero.restore_part`).
`export_reference_artifacts` writes trained weights in the reference's
artifact layout (the port's DiT and resampler names are the reference's).
"""

from __future__ import annotations

import json
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


def _save(obj, path: str) -> None:
    """``torch.save`` to a temporary name first, so that a cut-off save
    leaves no half file."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _part_file(path: str, rank: int, ranks: int) -> str:
    return os.path.join(path, f"opt-rank{rank}-of-{ranks}.pt")


def save_checkpoint(root: str, step: int, state: Dict[str, Any],
                    total_limit: Optional[int] = None, group=None, part=None) -> str:
    """Save ``state`` under checkpoint-{step}; rotate old ones. With
    ``group`` every rank calls it and rank 0 alone writes ``state``; with
    ``part`` each rank first writes its own (a ZeRO-1 part)."""
    path = os.path.abspath(_ckpt_dir(root, step))
    os.makedirs(path, exist_ok=True)
    rank, ranks = (group.rank, group.size) if group is not None else (0, 1)
    if part is not None:
        _save(part, _part_file(path, rank, ranks))
    if group is not None:
        group.barrier()  # every part is down before state.pt marks the checkpoint whole
    if rank == 0:
        _save(state, os.path.join(path, _STATE))
        if total_limit is not None:
            for old in list_checkpoints(root)[:-total_limit]:
                shutil.rmtree(_ckpt_dir(root, old), ignore_errors=True)
    if group is not None:
        group.barrier()
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


def stream_states(gen: torch.Generator, *hosts: np.random.Generator) -> Dict[str, Any]:
    """The states of a trainer's random streams (a torch generator and host
    generators), for its checkpoint."""
    return {"torch": gen.get_state(),
            "host": [json.dumps(h.bit_generator.state) for h in hosts]}


def restore_streams(state: Dict[str, Any], gen: torch.Generator,
                    *hosts: np.random.Generator) -> None:
    """Restores the random streams a checkpoint's ``state`` holds under
    "streams" (older checkpoints hold none), so that a resumed run draws
    what the uninterrupted one drew."""
    saved = state.get("streams")
    if saved is None:
        return
    gen.set_state(saved["torch"].cpu())  # a generator's state is a host tensor
    for h, js in zip(hosts, saved["host"]):
        h.bit_generator.state = json.loads(js)


def save_trainer(root: str, step: int, params: Dict[str, torch.Tensor], optimizer,
                 total_limit: Optional[int] = None, group=None, layout=None,
                 extra: Optional[Dict[str, Any]] = None) -> str:
    """A trainer's checkpoint: the trained ``params``, ``step``, ``extra``
    and the optimizer state (each rank's part with a ZeRO-1 ``layout``)."""
    state = {"params": {n: p.detach() for n, p in params.items()}, "step": step, **(extra or {})}
    part = None
    if layout is not None:
        state["zero"] = {"ranks": layout.ranks}
        part = {"ranges": dict(layout.ranges), "state": optimizer.state_dict()}
    else:
        state["opt_state"] = optimizer.state_dict()
    return save_checkpoint(root, step, state, total_limit, group=group, part=part)


def optimizer_state(root: str, step: int, state: Dict[str, Any], numels: Dict[str, int],
                    layout=None, shapes=None) -> Dict[str, Any]:
    """The optimizer state that a trainer with ``layout`` (a ZeRO-1 layout,
    or None: the whole tensors, of ``shapes``) restores from the
    checkpoint of ``step`` whose ``state.pt`` holds ``state``."""
    from tokensgen_tpu_torch.sharding.zero import restore_part

    ranges = dict(layout.ranges) if layout is not None else {n: (0, k) for n, k in numels.items()}
    written = state.get("zero")
    if written is None:
        parts = [({n: (0, k) for n, k in numels.items()}, state["opt_state"])]
    else:
        path = _ckpt_dir(root, step)
        n = written["ranks"]
        if layout is not None and layout.ranks == n:  # the layout written: this rank's file
            own = torch.load(_part_file(path, layout.rank, n), map_location="cpu",
                             weights_only=True)
            if own["ranges"] == ranges:
                return own["state"]
        parts = [(p["ranges"], p["state"]) for p in (
            torch.load(_part_file(path, r, n), map_location="cpu", weights_only=True, mmap=True)
            for r in range(n))]
    return restore_part(parts, ranges, numels, shapes if layout is None else None)


def restore_trainer(root: str, params: Dict[str, torch.Tensor], optimizer, layout=None,
                    map_location=None) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
    """Restores ``params`` and the optimizer (this rank's part with a
    ZeRO-1 ``layout``) from the latest checkpoint under ``root``, written
    at any rank count, with or without ZeRO-1 -> (its state.pt, its step),
    or (None, None) where there is none."""
    state, step = restore_checkpoint(root, map_location=map_location)
    if state is None:
        return None, None
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(state["params"][name])
    optimizer.load_state_dict(optimizer_state(
        root, step, state, {n: p.numel() for n, p in params.items()}, layout,
        {n: p.shape for n, p in params.items()}))
    return state, step


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
