"""Checkpoint and resume (port of `tokensgen_tpu/train/checkpoint.py`).

One ``checkpoint-{step}/state.pt`` per saved step (``torch.save`` of the
trainable parameters, the optimizer state and the step), rotated to keep the
newest ``total_limit``; resume finds the latest. Loading uses
``weights_only=True``: the files hold tensors, dicts and numbers only. The
reference-layout artifact export (`export_reference_artifacts`) is not
ported yet.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

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
