"""Observability (port of `tokensgen_tpu/utils/logging.py`): scalar logging,
the parameter audit files, a step-time EMA, a short form of a list of
floats for a log line.

`TBLogger` writes TensorBoard scalars where the ``tensorboard`` package is
installed, else the same scalars to ``scalars.csv`` (``step,tag,value``).
`RankLog` prints a data-parallel trainer's lines: rank 0's, and from every
rank the lines asked of each (its step times), marked with its rank;
`format_step` a step record's seconds split by `STEP_PARTS`.
`ParamAudit` writes ``rec_para.txt`` (every parameter) and
``rec_para_train.txt`` (the trainable ones), as the reference trainer does
(`train_cogvideo_to2v.py:1504-1519`). `profile_trace` is the JAX
package's trace context with `torch.profiler` in place of `jax.profiler`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, Optional

import torch
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


class RankLog:
    """``log(msg)`` prints on rank 0 of ``group`` (or in the one process);
    ``log(msg, every=True)`` on every rank, a group's lines marked
    ``[rank r/n]``."""

    def __init__(self, group=None):
        self.rank, self.size = (group.rank, group.size) if group is not None else (0, 1)

    def __call__(self, msg: str, every: bool = False) -> None:
        if self.size == 1:
            print(msg, flush=True)
        elif every:
            print(f"[rank {self.rank}/{self.size}] {msg}", flush=True)
        elif self.rank == 0:
            print(msg, flush=True)


# a step record's seconds, in the order a step spends them
STEP_PARTS = (("data_s", "data"), ("staging_s", "staging"), ("train_step_s", "train step"),
              ("all_reduce_s", "all-reduce"), ("optimizer_s", "optimizer"),
              ("all_gather_s", "all-gather"))


def step_seconds(rec: Dict) -> float:
    """The seconds of a trainer's step record, summed over `STEP_PARTS`."""
    return sum(rec.get(key) or 0.0 for key, _ in STEP_PARTS)


def format_step(rec: Dict, ema: float) -> str:
    """A step record's seconds, split by `STEP_PARTS` (those it has), with
    their moving average ``ema`` and the card's peak GiB where it has one."""
    parts = " + ".join(f"{label} {rec[key]:.2f}" for key, label in STEP_PARTS if key in rec)
    peak = rec.get("peak_gib")
    return (f"{step_seconds(rec):.2f} s/step ({parts}; EMA {ema:.2f})"
            + ("" if peak is None else f", peak {peak:.2f} GiB"))


def peak_gib(device) -> Optional[float]:
    """The card's peak allocated GiB in this process so far (None on the
    host)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


class ParamAudit:
    """Writes rec_para.txt (all parameters) and rec_para_train.txt
    (trainables); with no ``run_dir`` (a data-parallel rank other than 0)
    it only counts."""

    def __init__(self, run_dir: Optional[str]):
        self.run_dir = run_dir

    def write(self, model: nn.Module, labels: Dict[str, str]) -> Dict[str, int]:
        if self.run_dir is None:
            params = dict(model.named_parameters())
            return {"total": sum(p.numel() for p in params.values()),
                    "trainable": sum(p.numel() for n, p in params.items()
                                     if labels.get(n) == "train")}
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


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A `torch.profiler` trace of the body (host, and the card where there
    is one), written to ``<log_dir>/trace.json`` (Chrome trace format) with a
    table of the top operators in ``<log_dir>/top_ops.txt``; a no-op when
    ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort = "self_cuda_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(os.path.join(log_dir, "top_ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=25))


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
