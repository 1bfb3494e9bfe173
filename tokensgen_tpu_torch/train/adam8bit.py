"""Blockwise 8-bit AdamW (port of `tokensgen_tpu/train/adam8bit.py`).

The first moment is stored as int8 with one f32 scale per block of 256 values
(absmax); the second, whose range within a block is far wider, as uint8 on a
log scale between the block's log-min and log-max. Each update dequantizes,
runs AdamW in f32 and quantizes again, with the JAX package's arithmetic.
Tensors under ``min_quant_size`` values keep f32 moments (judged on the
whole tensor: a ZeRO-1 part, `sharding/zero.py`, passes its tensor's size
in ``sizes``, so that a part quantizes where its tensor does). State: about 2.06
bytes per parameter against 8 for f32 Adam. Plain PyTorch: the JAX version is
XLA, not a Pallas kernel. The state is written back into the buffers made at
init (the JAX package returns new arrays): fresh state tensors every step
would settle inside the large freed blocks of the train step and keep them
from being returned to the device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

BLOCK = 256
_LOG_TINY = 1e-30


class Q8(NamedTuple):
    q: torch.Tensor  # int8, flat, padded to whole blocks
    scale: torch.Tensor  # f32 [n_blocks]


class QLog8(NamedTuple):
    q: torch.Tensor  # uint8, flat, padded to whole blocks
    lo: torch.Tensor  # f32 [n_blocks] log-min
    hi: torch.Tensor  # f32 [n_blocks] log-max


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)


def _unblock(flat: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return flat.reshape(-1)[:n].reshape(shape)


def quantize(x: torch.Tensor) -> Q8:
    blocks = _blocks(x)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(blocks / safe[:, None]).clamp(-127, 127).to(torch.int8)
    return Q8(q.reshape(-1), scale)


def dequantize(qv: Q8, shape) -> torch.Tensor:
    safe = torch.where(qv.scale > 0, qv.scale, torch.ones_like(qv.scale))
    return _unblock(qv.q.reshape(-1, BLOCK).float() * safe[:, None], shape)


def quantize_log(x: torch.Tensor) -> QLog8:
    blocks = torch.log(_blocks(x) + _LOG_TINY)
    lo = blocks.amin(dim=1)
    hi = blocks.amax(dim=1)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    q = torch.round((blocks - lo[:, None]) / span[:, None] * 255.0).clamp(0, 255)
    return QLog8(q.to(torch.uint8).reshape(-1), lo, hi)


def dequantize_log(qv: QLog8, shape) -> torch.Tensor:
    span = torch.where(qv.hi > qv.lo, qv.hi - qv.lo, torch.ones_like(qv.hi))
    vals = torch.exp(qv.q.reshape(-1, BLOCK).float() / 255.0 * span[:, None] + qv.lo[:, None])
    return _unblock((vals - _LOG_TINY).clamp_min(0.0), shape)


def _store(dst, src) -> None:
    """Copies a moment (a tensor or a quantized tuple) into ``dst`` in place."""
    for d, s in (zip(dst, src) if isinstance(dst, tuple) else ((dst, src),)):
        d.copy_(s)


class AdamW8bit:
    """AdamW with int8 moments over named tensors, updated in place:
    ``p -= lr·(m̂/(√v̂+eps) + wd·p)`` with m, v stored quantized. ``sizes``:
    each name's whole-tensor size where ``params`` are parts of tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 1e-4, min_quant_size: int = 4096,
                 sizes: Optional[Dict[str, int]] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.mu, self.nu = {}, {}
        for name, p in params.items():
            zeros = torch.zeros_like(p, dtype=torch.float32)
            big = (p.numel() if sizes is None else sizes[name]) >= min_quant_size
            self.mu[name] = quantize(zeros) if big else zeros
            self.nu[name] = quantize_log(zeros) if big else zeros.clone()

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        lr = self.lr(self.count)
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for name, p in params.items():
            g = grads[name].float()
            mu_q, nu_q = self.mu[name], self.nu[name]
            mu = dequantize(mu_q, g.shape) if isinstance(mu_q, Q8) else mu_q
            nu = dequantize_log(nu_q, g.shape) if isinstance(nu_q, QLog8) else nu_q
            mu = self.b1 * mu + (1 - self.b1) * g
            nu = self.b2 * nu + (1 - self.b2) * g * g
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p.float()
            _store(mu_q, quantize(mu) if isinstance(mu_q, Q8) else mu)
            _store(nu_q, quantize_log(nu) if isinstance(nu_q, QLog8) else nu)
            p.add_((-lr * upd).to(p.dtype))

    def state_dict(self) -> Dict:
        def plain(x):
            return x._asdict() if isinstance(x, (Q8, QLog8)) else x
        return {"count": self.count, "mu": {n: plain(v) for n, v in self.mu.items()},
                "nu": {n: plain(v) for n, v in self.nu.items()}}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            for name, v in state[key].items():
                _store(getattr(self, key)[name], tuple(v.values()) if isinstance(v, dict) else v)

    def state_nbytes(self) -> int:
        total = 0
        for store in (self.mu, self.nu):
            for v in store.values():
                for t in (v if isinstance(v, tuple) else (v,)):
                    total += t.numel() * t.element_size()
        return total
