"""Probe kernels: hand-written Hopper counterparts of the Pallas probes under
the JAX package's ``tools/``, with their plain PyTorch versions.

The JAX package wrote these probes to measure the TPU's ceilings: a flash
kernel's tile sweep, last-tile-only masking, the int8 against the bf16 rate
inside a flash loop, a hand GEMM against the compiler's, the exp2 throughput.
Here they measure the card's, as inputs to making the attention kernels fast.
Five entry points, one per TPU kernel, each with a launch counter
(``fn.launches``):

===================  ============================================================  ====
entry point          replaces (the JAX package's tools/)                           #
===================  ============================================================  ====
attention_sweep      `bench_attn_sweep.py` `_tpu` :73 (K4's `_flash_kernel`)        T1
attention_v2         `bench_attn_v2.py` `_kernel_v2` :23                            T2
flash_loop           `bench_pallas_int8.py` `_flash_like_kernel` :29                T6
matmul_hand          `bench_matmul_pallas.py` `_mm_kernel` :27                      T7
exp2_loop            `bench_vpu_exp2.py` `make_kernel` :30                          T8
===================  ============================================================  ====

Each computes the JAX function; the tiles are the card's (`SWEEP_CONFIGS`,
`V2_CONFIGS`), not the TPU's. A CPU tensor takes the plain version beside the
entry point; a CUDA tensor launches the kernel (CUDA C++ for sm_90a in
``csrc/probes.cu``, built by nvcc at first use, `kernels/build.py`) or raises.
The CLIs of ``tokensgen_tpu_torch/tools/`` drive them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tokensgen_tpu_torch.kernels import attention as A
from tokensgen_tpu_torch.kernels import build as _build

# T1: (block_q, block_kv, heads per block) built in csrc/probes.cu; not
# (128, 128), whose tiles exceed the 48 KB of static shared memory, nor
# (64, 32, 2), whose registers spill (36 bytes)
SWEEP_CONFIGS = tuple((bm, bn, hb) for hb in (1, 2) for bm in (64, 128) for bn in (32, 64, 128)
                      if (bm, bn) != (128, 128) and (bm, bn, hb) != (64, 32, 2))
V2_CONFIGS = ((64, 64), (128, 64), (64, 128))  # T2: (block_q, block_kv)
BIAS_MODES = ("full", "last")  # T2: key bias on every kv tile, or only on the last
FLASH_LOOP_D = 128  # T6: the head dim the kernel is built for
FLASH_LOOP_TILE = 64  # T6: keys per streamed tile (csrc FL_TN)
MATMUL_BK = 32  # T7: the kernel's k tile (csrc MM_BK)
EXP2_OPS = ("mul", "exp2", "exp2_add")  # T8


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def attention_sweep_plain(q, k, v, key_bias=None):
    """T1's plain version: softmax(q k^T / sqrt(d) + key_bias) v on
    [B, H, S, D] (`attention.attention_plain`: f32 scores, exact softmax)."""
    return A.attention_plain(q, k, v, A._bias_or_zeros(key_bias, k, None), q.shape[-1] ** -0.5)


def attention_v2_plain(q, k, v, key_bias=None, block_kv: int = 64, bias_mode: str = "full"):
    """T2's plain version: as T1, with ``bias_mode`` "last" applying the key
    bias only on the last kv tile of ``block_kv`` keys (the ragged keys past
    Skv are masked either way); the JAX probe's padding bias lives there."""
    bias = A._bias_or_zeros(key_bias, k, None)
    if bias_mode == "last":
        last0 = (k.shape[2] - 1) // block_kv * block_kv
        bias = bias.clone()
        bias[:, :last0] = 0.0
    elif bias_mode != "full":
        raise ValueError(f"bias_mode: expected one of {BIAS_MODES}, got {bias_mode!r}")
    return A.attention_plain(q, k, v, bias, q.shape[-1] ** -0.5)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def flash_loop_plain(q, k, v, iters: int, drop_first_tile: bool = False):
    """T6's plain version (`_flash_like_kernel`): ``iters`` steps of
    s = q @ k, p = requant(s), acc += p @ v, q = requant(s[:, :d]), for two
    identical chains, out = f32(acc_a + acc_b). bf16: f32 sums,
    requant = bf16(s / 64); int8: exact integer sums (float64 products of
    integers under 2^53) wrapped to int32 as JAX's, requant = clip(s >> 7,
    -127, 127). ``drop_first_tile`` leaves the last tile of 64 keys out of the
    first step's p @ v (the planted fault)."""
    d = q.shape[1]
    int8 = q.dtype == torch.int8
    work = torch.float64 if int8 else torch.float32
    kw, vw, qc = k.to(work), v.to(work), q
    acc = torch.zeros(q.shape[0], d, dtype=torch.int64 if int8 else torch.float32,
                      device=q.device)
    for i in range(iters):
        s = qc.to(work) @ kw
        if int8:
            s = s.long()
            p = torch.clamp(s >> 7, -127, 127)
            qc = torch.clamp(s[:, :d] >> 7, -127, 127)
        else:
            p = (s * (1.0 / 64.0)).bfloat16()
            qc = (s[:, :d] * (1.0 / 64.0)).bfloat16()
        if drop_first_tile and i == 0:
            p[:, -FLASH_LOOP_TILE:] = 0
        pv = p.to(work) @ vw
        acc = acc + (pv.long() if int8 else pv)
    # the two chains are the same arithmetic on the same inputs
    return _wrap_int32(acc + acc).float() if int8 else acc + acc


def matmul_plain(x, y, k_len: Optional[int] = None):
    """T7's plain version: bf16(x @ y) with f32 products and sums (TF32
    off); with ``k_len``, over the first ``k_len`` of K only (the planted
    fault)."""
    k_len = x.shape[1] if k_len is None else k_len
    return (x[:, :k_len].float() @ y[:k_len].float()).bfloat16()


def _exp2_pass(x, op: str):
    if op == "mul":
        return x * 1.0000001
    if op == "exp2":
        return torch.exp2(x * 0.5)
    if op == "exp2_add":
        return torch.exp2(x * 0.5 + 0.125)
    raise ValueError(f"op: expected one of {EXP2_OPS}, got {op!r}")


def exp2_loop_plain(x, n_iter: int, op: str):
    """T8's plain version: ``n_iter`` passes of ``op`` over f32 ``x``."""
    for _ in range(n_iter):
        x = _exp2_pass(x, op)
    return x


# ---------------------------------------------------------------------------
# Build and bind csrc/probes.cu
# ---------------------------------------------------------------------------


class _FlashLoopArgs(ctypes.Structure):
    """Mirror of `TGFlashLoopArgs` in csrc/probes.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "out")]
                + [(n, ctypes.c_int64) for n in ("m", "n", "iters")])


class _MatmulArgs(ctypes.Structure):
    """Mirror of `TGMatmulArgs` in csrc/probes.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("a", "b", "c")]
                + [(n, ctypes.c_int64) for n in ("m", "k", "n")])


def _bind(lib) -> None:
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    for name in ("tg_probe_attn_sweep", "tg_probe_attn_v2"):
        _build.bind(lib, name, ctypes.POINTER(A._Args), i64, i64, i64, ptr)
    _build.bind(lib, "tg_probe_flash_loop", ctypes.POINTER(_FlashLoopArgs), i64, ptr)
    _build.bind(lib, "tg_probe_matmul", ctypes.POINTER(_MatmulArgs), ptr)
    _build.bind(lib, "tg_probe_exp2_loop", ptr, ptr, i64, i64, i64, ptr)


_Library = _build.KernelLibrary("probes.cu", _bind)


def build_probes(force: bool = False):
    """Compile csrc/probes.cu for sm_90a (cached by source hash) and load it."""
    return _Library.build(force)


def _launch_attn(entry: str, q, k, v, key_bias, p0: int, p1: int, p2: int):
    lib = _Library.get()
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d != 64:
        raise ValueError(f"{entry}: head dim 64, got {d}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    a = A._Args()
    keep = [out]  # buffers that must outlive the launch call
    for name, x in (("q", q), ("k", k), ("v", v), ("o", out)):
        sb, ss, sh = A._check_operand(name, x, None, d)
        setattr(a, name, x.data_ptr())
        setattr(a, f"{name}_sb", sb)
        setattr(a, f"{name}_ss", ss)
        setattr(a, f"{name}_sh", sh)
    a.bias = A._bias_ptr(key_bias, b, skv, keep)
    a.b, a.h, a.sq, a.skv = b, h, sq, skv
    a.qscale = d ** -0.5 * A._LOG2E
    _build.check_launch(entry, getattr(lib, entry)(ctypes.byref(a), p0, p1, p2,
                                                   _build.stream_of(q)))
    return out


# ---------------------------------------------------------------------------
# Entry points: one per TPU kernel
# ---------------------------------------------------------------------------


def attention_sweep(q, k, v, key_bias=None, block_q: int = 128, block_kv: int = 64,
                    hblk: int = 1):
    """T1, K4's function on [B, H, S, 64] bf16 at explicit tiles: ``block_q``
    q rows per block, ``block_kv`` keys per tile, ``hblk`` heads per block
    (`SWEEP_CONFIGS`); optional f32 key bias [B, Skv] on every tile."""
    if q.device.type == "cpu":
        return attention_sweep_plain(q, k, v, key_bias)
    A._require_cuda(k, v, key_bias)
    if (block_q, block_kv, hblk) not in SWEEP_CONFIGS:
        raise ValueError(f"attention_sweep: ({block_q}, {block_kv}, {hblk}) not built; "
                         f"expected one of {SWEEP_CONFIGS}")
    out = _launch_attn("tg_probe_attn_sweep", q, k, v, key_bias, block_q, block_kv, hblk)
    attention_sweep.launches += 1
    return out


def attention_v2(q, k, v, key_bias=None, block_q: int = 128, block_kv: int = 64,
                 bias_mode: str = "last"):
    """T2, flash attention on [B, H, S, 64] bf16 with the key bias (and the
    ragged-kv mask) applied on every kv tile ("full") or only on the last
    ("last"), at the tiles of `V2_CONFIGS`."""
    if bias_mode not in BIAS_MODES:
        raise ValueError(f"bias_mode: expected one of {BIAS_MODES}, got {bias_mode!r}")
    if q.device.type == "cpu":
        return attention_v2_plain(q, k, v, key_bias, block_kv, bias_mode)
    A._require_cuda(k, v, key_bias)
    if (block_q, block_kv) not in V2_CONFIGS:
        raise ValueError(f"attention_v2: ({block_q}, {block_kv}) not built; expected one of "
                         f"{V2_CONFIGS}")
    out = _launch_attn("tg_probe_attn_v2", q, k, v, key_bias, block_q, block_kv,
                       BIAS_MODES.index(bias_mode))
    attention_v2.launches += 1
    return out


def flash_loop(q, k, v, iters: int):
    """T6, the chained flash inner loop: q [m, d], k [d, n], v [n, d], all
    bf16 (f32 sums) or all int8 (int32 sums); out f32 [m, d]. The card takes
    d = 128 and n a multiple of 16, n >= d."""
    if q.device.type == "cpu":
        return flash_loop_plain(q, k, v, iters)
    A._require_cuda(k, v)
    if not (q.dtype == k.dtype == v.dtype and q.dtype in (torch.bfloat16, torch.int8)):
        raise TypeError(f"flash_loop: q, k, v all bf16 or all int8, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    m, d = q.shape
    n = k.shape[1]
    if d != FLASH_LOOP_D or k.shape != (d, n) or v.shape != (n, d) or n % 16 or n < d:
        raise ValueError(f"flash_loop: q [m, {FLASH_LOOP_D}], k [d, n], v [n, d] with n a "
                         f"multiple of 16 >= d, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty(m, d, dtype=torch.float32, device=q.device)
    a = _FlashLoopArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m, n, iters)
    dtype = 1 if q.dtype == torch.int8 else 0
    _build.check_launch("tg_probe_flash_loop", _Library.get().tg_probe_flash_loop(
        ctypes.byref(a), dtype, _build.stream_of(q)))
    flash_loop.launches += 1
    return out


def matmul_hand(x, y):
    """T7, bf16(x @ y) with an f32 accumulator: x [M, K], y [K, N] bf16; the
    card takes K and N multiples of 8 (ragged tiles are masked)."""
    if x.device.type == "cpu":
        return matmul_plain(x, y)
    A._require_cuda(y)
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        raise TypeError(f"matmul_hand: bf16 operands, got {x.dtype}, {y.dtype}")
    (m, kdim), n = x.shape, y.shape[1]
    if y.shape[0] != kdim or kdim % 8 or n % 8:
        raise ValueError(f"matmul_hand: [M, K] x [K, N] with K, N multiples of 8, got "
                         f"{tuple(x.shape)} x {tuple(y.shape)}")
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    a = _MatmulArgs(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, kdim, n)
    _build.check_launch("tg_probe_matmul", _Library.get().tg_probe_matmul(
        ctypes.byref(a), _build.stream_of(x)))
    matmul_hand.launches += 1
    return out


def exp2_loop(x, n_iter: int, op: str = "exp2"):
    """T8, ``n_iter`` passes of ``op`` (`EXP2_OPS`) over f32 ``x``, each
    element held in registers throughout; the card takes a multiple of 4
    elements."""
    if op not in EXP2_OPS:
        raise ValueError(f"op: expected one of {EXP2_OPS}, got {op!r}")
    if x.device.type == "cpu":
        return exp2_loop_plain(x, n_iter, op)
    if x.dtype != torch.float32 or x.numel() % 4:
        raise ValueError(f"exp2_loop: f32 with a multiple of 4 elements, got {x.dtype}, "
                         f"{x.numel()}")
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.check_launch("tg_probe_exp2_loop", _Library.get().tg_probe_exp2_loop(
        x.data_ptr(), out.data_ptr(), x.numel(), n_iter, EXP2_OPS.index(op),
        _build.stream_of(x)))
    exp2_loop.launches += 1
    return out


PROBE_ENTRY_POINTS = (attention_sweep, attention_v2, flash_loop, matmul_hand, exp2_loop)


def reset_launch_counts():
    for fn in PROBE_ENTRY_POINTS:
        fn.launches = 0


reset_launch_counts()


def launch_counts():
    return {fn.__name__: fn.launches for fn in PROBE_ENTRY_POINTS}
