"""Attention for the joint [text‖video‖vip] sequence: table API, plain PyTorch
versions, and the hand-written Hopper kernels that replace the Pallas TPU ones.

Port of `tokensgen_tpu/kernels/attention.py`. Four kernel entry points, one per
TPU kernel on the edit path, each with a launch counter (``fn.launches``):

=============================  =============================================  ============================
entry point                    replaces (tokensgen_tpu/kernels/attention.py)  caller
=============================  =============================================  ============================
fused_attention_joint          `_flash_packed_kernel` :586 (K1)               models/dit.py base attention
fused_attention_cross_smallkv  `_cross_smallkv_kernel` :922 (K2)              models/dit.py text_video→vip
fused_attention_cross_smallq   `_cross_smallq_kernel` :1048 (K3)              models/dit.py vip→all
flash_attention_bhsd           `_flash_kernel` :54 (K4)                       models/resampler.py
=============================  =============================================  ============================

`flash_attention_bhsd` is the counterpart of the JAX `flash_attention`, and
`fused_flash_attention` routes among the first three as the JAX one does.

The CUDA C++ sources are `csrc/attention.cu`; `build_kernels` compiles them
with nvcc into a shared library with a plain C interface (loaded with ctypes)
under ``<repo>/build/kernels``. Dispatch goes by the tensor's device: a CPU
tensor takes the plain version (`attention_fused_plain` / `attention_plain`,
exact softmax, as `_xla_attention_fused` / `_xla_attention`); a CUDA tensor
launches the kernel or raises — on a failed build, a launch error, a head dim
other than 64 or a dtype other than bf16. No path falls back.

The prologue tables are those of the JAX package: ``(cosg, sin, add, Rg)``
from :func:`make_prologue`, with ``prologue(x) = LN0(x)∘cosg + (LN0(x)@Rg)∘sin
+ add``; the softmax scale is folded into the q tables.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_SRC = Path(__file__).resolve().parent / "csrc" / "attention.cu"
_REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = _REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LOG2E = 1.4426950408889634
_SMALLKV_MAX = 512  # kv rows K2 holds whole in shared memory (csrc SMALLKV_MAX)
MAX_SCORE_BYTES = 1 << 31  # f32 score tensor per q-row chunk of `attention_plain`


# ---------------------------------------------------------------------------
# Prologue table API (same math as the JAX package)
# ---------------------------------------------------------------------------


def rotation_matrix(d: int, device=None) -> torch.Tensor:
    """[D, D] signed permutation R with (x@R)[2i] = -x[2i+1], (x@R)[2i+1] = x[2i].
    Built from comparisons on the device (a scalar index_put would copy its
    value from host memory and block the host until the card catches up)."""
    i = torch.arange(d, device=device)[:, None]
    j = torch.arange(d, device=device)[None, :]
    even = i % 2 == 0
    return ((j == i + 1) & even).float() - ((j == i - 1) & ~even).float()


def make_prologue(d: int, segments, ln_scale: Optional[torch.Tensor] = None,
                  ln_bias: Optional[torch.Tensor] = None, fold: float = 1.0, device=None):
    """(cosg, sin, add, Rg) tables for the fused qk-norm + rope prologue.

    ``segments``: ``(rope_or_None, length)`` in sequence order; None gives
    identity rows. Rope tables may be [S, D] or batched [B, S, D]. Tables land
    on the ropes' device, else ``ln_scale``'s, else ``device``.
    """
    batch = None
    for rope, _ in segments:
        if rope is not None:
            device = rope[0].device
            if rope[0].dim() == 3:
                batch = rope[0].shape[0]
    if ln_scale is not None and not any(r is not None for r, _ in segments):
        device = ln_scale.device
    f32 = torch.float32
    cos_parts, sin_parts = [], []
    for rope, length in segments:
        if length == 0:
            continue
        if rope is None:
            shape = (length, d) if batch is None else (batch, length, d)
            cos_parts.append(torch.ones(shape, dtype=f32, device=device))
            sin_parts.append(torch.zeros(shape, dtype=f32, device=device))
        else:
            cos_r, sin_r = rope
            assert cos_r.shape[-2] == length, (cos_r.shape, length)
            cos_r, sin_r = cos_r.float(), sin_r.float()
            if batch is not None and cos_r.dim() == 2:
                cos_r = cos_r[None].expand(batch, *cos_r.shape)
                sin_r = sin_r[None].expand(batch, *sin_r.shape)
            cos_parts.append(cos_r)
            sin_parts.append(sin_r)
    cos = torch.cat(cos_parts, dim=-2) if len(cos_parts) > 1 else cos_parts[0]
    sin = torch.cat(sin_parts, dim=-2) if len(sin_parts) > 1 else sin_parts[0]
    r = rotation_matrix(d, device=cos.device)
    if ln_scale is not None:
        g = ln_scale.float()
        cosg = cos * g
        rg = g[:, None] * r
    else:
        cosg = cos
        rg = r
    if ln_bias is not None:
        b_ = ln_bias.float()
        add = b_ * cos + (b_ @ r) * sin
    else:
        add = torch.zeros_like(cos)
    if fold != 1.0:
        cosg, sin, add = cosg * fold, sin * fold, add * fold
    return cosg, sin, add, rg


def prologue_identity(seq_len: int, d: int, fold: float = 1.0, device=None):
    """Identity prologue (no norm, no rope): y = x * fold."""
    return make_prologue(d, [(None, seq_len)], fold=fold, device=device)


def slice_tabs(tabs, start: int, stop: int):
    """Row-slice prologue tables (attention over a sub-sequence)."""
    cosg, sin, add, rg = tabs
    return cosg[..., start:stop, :], sin[..., start:stop, :], add[..., start:stop, :], rg


def concat_tabs(*tabs_list):
    """Concatenate prologue tables along the sequence axis (same Rg)."""
    cosg = torch.cat([t[0] for t in tabs_list], dim=-2)
    sin = torch.cat([t[1] for t in tabs_list], dim=-2)
    add = torch.cat([t[2] for t in tabs_list], dim=-2)
    return cosg, sin, add, tabs_list[0][3]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (exact softmax)
# ---------------------------------------------------------------------------


def apply_prologue_plain(x: torch.Tensor, tabs, eps: float, normalize: bool) -> torch.Tensor:
    """Plain prologue (`_apply_prologue_xla`): x [..., S, D], tabs [(B,)S, D]."""
    cosg, sin, add, rg = tabs
    x32 = x.float()
    if normalize:
        mu = x32.mean(-1, keepdim=True)
        dlt = x32 - mu
        var = (dlt * dlt).mean(-1, keepdim=True)
        ln0 = dlt * torch.rsqrt(var + eps)
    else:
        ln0 = x32
    if cosg.dim() == 3 and x.dim() == 4:  # batched tables vs x [B, H, S, D]
        cosg, sin, add = cosg[:, None], sin[:, None], add[:, None]
    y = ln0 * cosg + (ln0 @ rg) * sin + add
    return y.to(x.dtype)


def attention_plain(q, k, v, key_bias, scale: float):
    """Plain attention (`_xla_attention`) on [B, H, S, D]: f32 scores, exact
    softmax, f32 p@v. Runs in q-row chunks that keep the f32 score tensor
    under ``MAX_SCORE_BYTES`` (the production joint shape would need 121 GB)."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    chunk = max(1, min(sq, MAX_SCORE_BYTES // (4 * b * h * skv)))
    kf, vf = k.float(), v.float()
    bias = key_bias.float()[:, None, None, :]
    outs = []
    for i in range(0, sq, chunk):
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i:i + chunk].float(), kf) * scale + bias
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype))
    return torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]


def attention_fused_plain(q, k, v, key_bias, tabs_q, tabs_k, eps, norm_q, norm_k):
    """Plain fused-prologue attention (`_xla_attention_fused`) on [B, H, S, D]."""
    qn = apply_prologue_plain(q, tabs_q, eps, norm_q)
    kn = apply_prologue_plain(k, tabs_k, eps, norm_k)
    return attention_plain(qn, kn, v, key_bias, 1.0)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _fused_plain_merged(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k):
    out = attention_fused_plain(split_heads(q, heads), split_heads(k, heads),
                                split_heads(v, heads), key_bias, tabs_q, tabs_k,
                                eps, norm_q, norm_k)
    return merge_heads(out)


# ---------------------------------------------------------------------------
# Build and bind the CUDA library
# ---------------------------------------------------------------------------


class _Args(ctypes.Structure):
    """Mirror of `TGAttnArgs` in csrc/attention.cu (every field 8 bytes)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "o", "bias", "q_cos", "q_sin", "q_add", "q_rot",
            "k_cos", "k_sin", "k_add", "k_rot")]
        + [(n, ctypes.c_int64) for n in (
            "q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh", "v_sb", "v_ss", "v_sh",
            "o_sb", "o_ss", "o_sh", "q_tb", "k_tb", "b", "h", "sq", "skv",
            "norm_q", "norm_k")]
        + [("qscale", ctypes.c_double), ("eps", ctypes.c_double)]
    )


_ENTRY_POINTS = ("tg_attention_joint", "tg_attention_cross_smallkv",
                 "tg_attention_cross_smallq", "tg_attention_bhsd")


class _Library:
    """The compiled kernels, built at first use (one per process)."""

    lib = None
    build_log = ""


def build_kernels(force: bool = False) -> Path:
    """Compile csrc/attention.cu for sm_90a with nvcc (cached by source hash)
    and load it. Returns the library path; raises with nvcc's output on failure."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libtg_attention_{tag}.so"
    if force or not out.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the attention kernels need the CUDA toolkit")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        _Library.build_log = proc.stdout + proc.stderr
    if _Library.lib is None or force:
        lib = ctypes.CDLL(str(out))
        for name in _ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _Library.lib = lib
    return out


def _lib():
    if _Library.lib is None:
        build_kernels()
    return _Library.lib


def _check_operand(name: str, x: torch.Tensor, merged_heads: Optional[int]):
    """(sb, ss, sh) element strides of a [B, S, H*64] (merged) or [B, H, S, 64]
    bf16 CUDA operand with a contiguous, 16-byte aligned head dim."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the attention kernels take bfloat16, got {x.dtype}")
    if merged_heads is not None:
        if x.dim() != 3 or x.shape[2] != 64 * merged_heads:
            raise ValueError(f"{name}: expected [B, S, {merged_heads}*64], got {tuple(x.shape)}")
        sb, ss, sc = x.stride()
        sh = 64
    else:
        if x.dim() != 4 or x.shape[3] != 64:
            raise ValueError(f"{name}: expected [B, H, S, 64], got {tuple(x.shape)}")
        sb, sh, ss, sc = x.stride()
    if sc != 1 or sb % 8 or ss % 8 or sh % 8 or x.data_ptr() % 16:
        raise ValueError(f"{name}: head dim must be contiguous with 16-byte aligned rows")
    return sb, ss, sh


def _check_tabs(name: str, tabs, seqlen: int, batch: int, device):
    """Contiguous f32 (cosg, sin, add) + pair-swap coefficients of Rg, and the
    tables' batch stride (0 when shared)."""
    cosg, sin, add, rg = tabs
    out = []
    for t in (cosg, sin, add):
        if t.device != device or t.dtype != torch.float32:
            raise TypeError(f"{name}: tables must be float32 on {device}")
        if t.shape[-2:] != (seqlen, 64) or (t.dim() == 3 and t.shape[0] not in (1, batch)):
            raise ValueError(f"{name}: table shape {tuple(t.shape)} for S={seqlen}, B={batch}")
        out.append(t.contiguous())
    tb = seqlen * 64 if cosg.dim() == 3 and cosg.shape[0] == batch and batch > 1 else 0
    # Rg = diag(g)·R is nonzero only on the pair swap (make_prologue); the
    # kernel reads those 64 entries and this device-side check holds it to it
    idx = torch.arange(64, device=device)
    rg = rg.float()
    rot = rg[idx ^ 1, idx].contiguous()
    pair = idx[:, None] == (idx[None, :] ^ 1)
    torch._assert_async(torch.all((rg == 0) | pair))
    return out, rot, tb


def _launch(entry: str, q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k,
            qscale: float):
    lib = _lib()
    b = q.shape[0]
    if heads is not None:
        h, sq, skv = heads, q.shape[1], k.shape[1]
    else:
        h, sq, skv = q.shape[1], q.shape[2], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    a = _Args()
    keep = [out]  # buffers that must outlive the launch call
    for name, x in (("q", q), ("k", k), ("v", v), ("o", out)):
        sb, ss, sh = _check_operand(name, x, heads)
        setattr(a, name, x.data_ptr())
        setattr(a, f"{name}_sb", sb)
        setattr(a, f"{name}_ss", ss)
        setattr(a, f"{name}_sh", sh)
    if key_bias is not None:
        kb = key_bias.float().contiguous()
        if kb.shape != (b, skv):
            raise ValueError(f"key_bias: expected [{b}, {skv}], got {tuple(kb.shape)}")
        keep.append(kb)
        a.bias = kb.data_ptr()
    for side, tabs, seqlen in (("q", tabs_q, sq), ("k", tabs_k, skv)):
        if tabs is None:
            continue
        (cosg, sin, add), rot, tb = _check_tabs(f"tabs_{side}", tabs, seqlen, b, q.device)
        keep += [cosg, sin, add, rot]
        setattr(a, f"{side}_cos", cosg.data_ptr())
        setattr(a, f"{side}_sin", sin.data_ptr())
        setattr(a, f"{side}_add", add.data_ptr())
        setattr(a, f"{side}_rot", rot.data_ptr())
        setattr(a, f"{side}_tb", tb)
    a.b, a.h, a.sq, a.skv = b, h, sq, skv
    a.norm_q, a.norm_k = int(norm_q), int(norm_k)
    a.qscale, a.eps = qscale, eps
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, entry)(ctypes.byref(a), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {err}")
    return out


def _require_cuda(*xs):
    for x in xs:
        if not x.is_cuda:
            raise ValueError("mixed CPU and CUDA operands")


# ---------------------------------------------------------------------------
# Entry points: one per TPU kernel
# ---------------------------------------------------------------------------


def fused_attention_joint(q, k, v, tabs_q, tabs_k, key_bias=None, heads: int = None,
                          eps: float = 1e-6, norm_q: bool = True, norm_k: bool = True):
    """K1, base joint self-attention on merged [B, S, H*64]: both prologues in
    the kernel, optional additive f32 key bias [B, Skv]."""
    if q.device.type == "cpu":
        return _fused_plain_merged(q, k, v, _bias_or_zeros(key_bias, k, heads), tabs_q,
                                   tabs_k, heads, eps, norm_q, norm_k)
    _require_cuda(k, v)
    out = _launch("tg_attention_joint", q, k, v, key_bias, tabs_q, tabs_k, heads, eps,
                  norm_q, norm_k, _LOG2E)
    fused_attention_joint.launches += 1
    return out


def fused_attention_cross_smallkv(q, k, v, tabs_q, tabs_k, key_bias=None, heads: int = None,
                                  eps: float = 1e-6, norm_q: bool = True, norm_k: bool = True):
    """K2, long q against kv <= 512 (text_video -> vip). The k-side prologue
    runs in plain torch (as the TPU wrapper runs it in XLA); K and V of one
    (b, h) then sit whole in shared memory."""
    if q.device.type == "cpu":
        return _fused_plain_merged(q, k, v, _bias_or_zeros(key_bias, k, heads), tabs_q,
                                   tabs_k, heads, eps, norm_q, norm_k)
    _require_cuda(k, v)
    if k.shape[1] > _SMALLKV_MAX:
        raise ValueError(f"fused_attention_cross_smallkv: Skv {k.shape[1]} > {_SMALLKV_MAX}")
    kn = merge_heads(apply_prologue_plain(split_heads(k, heads), tabs_k, eps, norm_k))
    out = _launch("tg_attention_cross_smallkv", q, kn, v, key_bias, tabs_q, None, heads,
                  eps, norm_q, False, _LOG2E)
    fused_attention_cross_smallkv.launches += 1
    return out


def fused_attention_cross_smallq(q, k, v, tabs_q, tabs_k, key_bias=None, heads: int = None,
                                 eps: float = 1e-6, norm_q: bool = True, norm_k: bool = True):
    """K3, short q (<= 512) against a long kv (vip -> [text_video‖vip]), both
    prologues in the kernel."""
    if q.device.type == "cpu":
        return _fused_plain_merged(q, k, v, _bias_or_zeros(key_bias, k, heads), tabs_q,
                                   tabs_k, heads, eps, norm_q, norm_k)
    _require_cuda(k, v)
    out = _launch("tg_attention_cross_smallq", q, k, v, key_bias, tabs_q, tabs_k, heads,
                  eps, norm_q, norm_k, _LOG2E)
    fused_attention_cross_smallq.launches += 1
    return out


def flash_attention_bhsd(q, k, v, key_bias=None, scale: Optional[float] = None):
    """K4, plain [B, H, S, 64] attention with a folded scale and an optional
    additive key bias (the resampler's Perceiver attention)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_plain(q, k, v, _bias_or_zeros(key_bias, k, None), scale)
    _require_cuda(k, v)
    out = _launch("tg_attention_bhsd", q, k, v, key_bias, None, None, None, 0.0,
                  False, False, scale * _LOG2E)
    flash_attention_bhsd.launches += 1
    return out


KERNEL_ENTRY_POINTS = (fused_attention_joint, fused_attention_cross_smallkv,
                       fused_attention_cross_smallq, flash_attention_bhsd)
for _fn in KERNEL_ENTRY_POINTS:
    _fn.launches = 0


def reset_launch_counts():
    for fn in KERNEL_ENTRY_POINTS:
        fn.launches = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in KERNEL_ENTRY_POINTS}


def _bias_or_zeros(key_bias, k, heads):
    b = k.shape[0]
    skv = k.shape[1] if heads is not None else k.shape[2]
    if key_bias is None:
        return torch.zeros(b, skv, dtype=torch.float32, device=k.device)
    return key_bias.float()


# ---------------------------------------------------------------------------
# Public dispatch (same routing as the JAX package)
# ---------------------------------------------------------------------------


def fused_flash_attention(q, k, v, tabs_q, tabs_k, key_bias=None, heads: int = None,
                          eps: float = 1e-6, norm_q: bool = True, norm_k: bool = True):
    """Attention with the qk-norm + RoPE prologue fused, on merged
    [B, S, H*D] operands. Routes one-tiny-side cross shapes to the small-side
    kernels exactly where the JAX `_flash_packed_diff` does."""
    if heads is None or q.dim() != 3:
        raise ValueError("fused_flash_attention takes merged [B, S, H*D] operands and heads")
    sq, skv = q.shape[1], k.shape[1]
    if norm_q and norm_k:
        if skv <= _SMALLKV_MAX and sq > 2048:
            return fused_attention_cross_smallkv(q, k, v, tabs_q, tabs_k, key_bias, heads,
                                                 eps, norm_q, norm_k)
        if sq <= 512 and skv > 2048:
            return fused_attention_cross_smallq(q, k, v, tabs_q, tabs_k, key_bias, heads,
                                                eps, norm_q, norm_k)
    return fused_attention_joint(q, k, v, tabs_q, tabs_k, key_bias, heads, eps, norm_q, norm_k)

