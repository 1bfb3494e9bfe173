"""Observability (port of `tokensgen_tpu/utils/logging.py`): scalar logging,
the parameter audit files, a step-time EMA, a short form of a list of
floats for a log line.

`TBLogger` writes TensorBoard scalars where the ``tensorboard`` package is
installed, else the same scalars to ``scalars.csv`` (``step,tag,value``).
`ParamAudit` writes ``rec_para.txt`` (every parameter) and
``rec_para_train.txt`` (the trainable ones), as the reference trainer does
(`train_cogvideo_to2v.py:1504-1519`). The JAX package's `profile_trace`
(`jax.profiler`) is not ported: `torch.profiler` is the tool on the card.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import torch.nn as nn


class TBLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer = None
        self._csv = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            os.makedirs(log_dir, exist_ok=True)
            self._csv = open(os.path.join(log_dir, "scalars.csv"), "a")
        else:
            self._writer = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        else:
            self._csv.write(f"{step},{tag},{value}\n")
            self._csv.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
        if self._csv is not None:
            self._csv.close()


class ParamAudit:
    """Writes rec_para.txt (all parameters) and rec_para_train.txt (trainables)."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir

    def write(self, model: nn.Module, labels: Dict[str, str]) -> Dict[str, int]:
        total = trainable = 0
        with open(os.path.join(self.run_dir, "rec_para.txt"), "w") as f_all, \
                open(os.path.join(self.run_dir, "rec_para_train.txt"), "w") as f_tr:
            for name, p in sorted(model.named_parameters()):
                n = p.numel()
                line = f"{name}\t{tuple(p.shape)}\t{n}\n"
                total += n
                f_all.write(line)
                if labels.get(name) == "train":
                    trainable += n
                    f_tr.write(line)
            f_all.write(f"# total: {total}\n")
            f_tr.write(f"# trainable: {trainable} / {total}\n")
        return {"total": total, "trainable": trainable}


class StepTimer:
    """Per-step wall-clock EMA."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None

    def update(self, dt: float) -> float:
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return self.ema


def format_floats(values: Iterable[float]) -> str:
    """``[a, b, ...]`` with four significant digits each."""
    return "[" + ", ".join(f"{x:.4g}" for x in values) + "]"
