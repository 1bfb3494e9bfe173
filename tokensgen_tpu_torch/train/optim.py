"""Optimizer and learning-rate schedule factory (port of
`tokensgen_tpu/train/optim.py`).

The schedules are the diffusers ``get_scheduler`` names (constant,
constant_with_warmup, linear, cosine, cosine_with_restarts, polynomial) with
the optax formulas the JAX package composes them from, as plain functions of
the update count. The optimizers are Adam with an L2 penalty folded into the
gradient (``adam``, `torch.optim.Adam` semantics), AdamW with decoupled decay
(``adamw``, optax's ``adamw``) and, with ``use_8bit``, the blockwise int8
AdamW of `train/adam8bit.py`. Prodigy is not ported.

Optimizers update the parameters in place (the JAX package returns new
trees; in place saves a copy of every trainable tensor). `TrainStep` is the
trainers' step around them: `optax.clip_by_global_norm` chained before the
optimizer, under `optax.MultiSteps` accumulation.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional, Union

import torch

from tokensgen_tpu_torch.train.objective import x0_weights

Schedule = Callable[[int], float]

_NAMES = ("constant", "constant_with_warmup", "linear", "cosine",
          "cosine_with_restarts", "polynomial")


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    def fn(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac ** power + end
    return fn


def _cosine(init: float, decay_steps: int) -> Schedule:
    def fn(count: int) -> float:
        count = min(count, decay_steps)
        return init * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    return fn


def _join(schedules, boundaries) -> Schedule:
    def fn(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return fn


def lr_schedule(name: str, learning_rate: float, warmup_steps: int = 0, total_steps: int = 1000,
                num_cycles: int = 1, power: float = 1.0, lr_end: float = 1e-7) -> Schedule:
    """Learning rate as a function of the update count (0 for the first
    update). ``total_steps`` counts optimizer updates; decay spans
    ``total_steps - warmup_steps``."""
    name = (name or "constant").lower()
    if name not in _NAMES:
        raise ValueError(f"unknown lr_scheduler {name!r}; expected {_NAMES}")
    decay_steps = max(1, total_steps - warmup_steps)
    if name in ("constant", "constant_with_warmup"):
        body = lambda count: learning_rate  # noqa: E731
    elif name == "linear":
        body = _polynomial(learning_rate, 0.0, 1.0, decay_steps)
    elif name == "cosine":
        body = _cosine(learning_rate, decay_steps)
    elif name == "cosine_with_restarts":
        n = max(1, int(num_cycles))
        per = max(1, decay_steps // n)
        body = _join([_cosine(learning_rate, per)] * n, [per * i for i in range(1, n)])
    else:  # polynomial
        body = _polynomial(learning_rate, lr_end, power, decay_steps)
    if warmup_steps <= 0:
        return body
    return _join([_polynomial(0.0, learning_rate, 1.0, warmup_steps), body], [warmup_steps])


class AdamW:
    """Adam over named float32 tensors. ``decoupled`` gives optax's adamw
    (``-lr·(m̂/(√v̂+eps) + wd·p)``); otherwise the decay is an L2 term added
    to the gradient first (``adam``)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: Schedule, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 1e-4,
                 decoupled: bool = True):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.decoupled = weight_decay, decoupled
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        lr = self.lr(self.count)
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for name, p in params.items():
            g = grads[name].float()
            if self.weight_decay and not self.decoupled:
                g = g + self.weight_decay * p
            mu = self.mu[name].mul_(self.b1).add_((1.0 - self.b1) * g)
            nu = self.nu[name].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay and self.decoupled:
                upd = upd + self.weight_decay * p
            p.add_(upd.to(p.dtype), alpha=-lr)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            for name, t in state[key].items():
                getattr(self, key)[name].copy_(t)


def base_optimizer(name: str, params: Dict[str, torch.Tensor], learning_rate: Union[float, Schedule],
                   b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                   weight_decay: float = 1e-4, use_8bit: bool = False):
    """adam | adamw over ``params``; ``use_8bit`` selects the int8-moment AdamW
    for both names, as the JAX package does."""
    name = (name or "adamw").lower()
    lr = learning_rate if callable(learning_rate) else (lambda count: learning_rate)
    if name == "prodigy":
        raise NotImplementedError("the prodigy optimizer is not ported yet: use adam or adamw")
    if name not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {name!r}; expected adam|adamw|prodigy")
    if use_8bit:
        from tokensgen_tpu_torch.train.adam8bit import AdamW8bit

        return AdamW8bit(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return AdamW(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 decoupled=name == "adamw")


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class TrainStep:
    """A trainer's step (`make_train_step` with its optax chain): each call
    runs one micro-batch's loss (the mean of its `sample_losses`) and
    backward; every ``accum_steps``-th call clips the mean gradient to
    ``max_grad_norm`` (optax `clip_by_global_norm`) and updates ``params``
    in place. Gradient accumulation has `optax.MultiSteps` semantics: the
    mean of k micro-batch gradients, one update. Returns the loss and each
    sample's term of it (``sample_losses``), the micro-batch's grad norm,
    whether it updated, the timesteps it was given and their mean loss
    weight 1/(1-ᾱ_t) under ``sched`` (``x0_weight``), and the
    device-synchronised seconds of the forward and backward
    (``train_step_s``) and of the update (``optimizer_s``)."""

    def __init__(self, params: Dict[str, torch.Tensor], optimizer, max_grad_norm: float, sched,
                 accum_steps: int = 1):
        self.params, self.optimizer, self.sched = params, optimizer, sched
        self.max_grad_norm, self.accum_steps = max_grad_norm, accum_steps
        self.mini_step = 0
        self.acc: Optional[Dict[str, torch.Tensor]] = None

    def sample_losses(self, batch: Dict, timesteps: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
        """[B] per-sample losses of the micro-batch."""
        raise NotImplementedError

    def __call__(self, batch: Dict, timesteps: torch.Tensor, noise: torch.Tensor) -> Dict:
        sync = _synchronizer(noise.device)
        t0 = time.perf_counter()
        per_sample = self.sample_losses(batch, timesteps, noise)
        loss = per_sample.mean()
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.params.items()}
        gnorm = global_norm(grads.values())
        for p in self.params.values():
            p.grad = None
        if self.accum_steps > 1:  # MultiSteps: running mean of the micro-batch grads
            if self.acc is None:
                self.acc = {n: torch.zeros_like(g) for n, g in grads.items()}
            for n, g in grads.items():
                self.acc[n].add_((g - self.acc[n]) / (self.mini_step + 1))
            grads = self.acc
        sync()
        t1 = time.perf_counter()
        self.mini_step += 1
        updated = self.mini_step == self.accum_steps
        if updated:
            mean_norm = gnorm if self.accum_steps == 1 else global_norm(grads.values())
            scale = torch.clamp(self.max_grad_norm / mean_norm, max=1.0)
            for g in grads.values():
                g.mul_(scale)
            self.optimizer.step(self.params, grads)
            self.mini_step = 0
            self.acc = None
        sync()
        t2 = time.perf_counter()
        return {"loss": loss.detach(), "sample_losses": per_sample.detach(),
                "grad_norm": gnorm, "updated": updated,
                "timesteps": timesteps.detach(),
                "x0_weight": x0_weights(self.sched, timesteps).mean().detach(),
                "train_step_s": t1 - t0, "optimizer_s": t2 - t1}


def _synchronizer(device):
    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None
