"""Attention for the joint [text‖video‖vip] sequence: table API, plain PyTorch
versions, and the hand-written Hopper kernels that replace the Pallas TPU ones.

Port of `tokensgen_tpu/kernels/attention.py`. Eight kernel entry points, one per
TPU kernel on the edit, training and generation paths (K4 twice: in bfloat16
and in float32), each with a launch counter
(``fn.launches``; K1, K4 and K6 also count their logsumexp launches in
``fn.lse_launches``):

=============================  =============================================  ============================
entry point                    replaces (tokensgen_tpu/kernels/attention.py)  caller
=============================  =============================================  ============================
fused_attention_joint          `_flash_packed_kernel` :586 (K1)               models/dit.py base attention
fused_attention_cross_smallkv  `_cross_smallkv_kernel` :922 (K2)              models/dit.py text_video→vip
fused_attention_cross_smallq   `_cross_smallq_kernel` :1048 (K3)              models/dit.py vip→all
flash_attention_bhsd           `_flash_kernel` :54 (K4)                       models/resampler.py
attention_backward             `_packed_bwd_kernel` :1220 (K5)                the two autograd Functions
fused_attention_joint_int8     `_flash_packed_kernel` :586, int8_scores (K7)  models/dit.py under quant_attn
fused_attention_bhsd           `_flash_fused_kernel` :256 (K6)                odd heads, head dim != 64, 4-D
flash_attention_bhsd_f32       `_flash_kernel` :54, float32 operands (K4)     models/dinov2.py
=============================  =============================================  ============================

The public dispatchers are those of the JAX package: `flash_attention` (K4,
by dtype: bfloat16 to its TMA / wgmma body, float32 to a 3xTF32 wgmma body
of its own, `flash_attention_bhsd_f32`; there is no float32 backward, so a
float32 card call that needs a gradient raises) and `fused_flash_attention`,
which routes as `_fused_dispatch` does. Merged [B, S, H*64] operands with
an even head count take the packed route (the JAX package's head-pair
kernel): K1, K2 or K3 by shape, K7 for the joint calls that ask for
``int8_scores``. Every other call (odd heads, a head dim
other than 64, 4-D operands) is split into its [B, H, S, D] view and runs K6
(`fused_attention_bhsd`), as the JAX package runs `_flash_fused_tpu`. When
autograd needs a gradient (grad mode on and an input that requires grad),
both take a `torch.autograd.Function` instead, the counterparts of
`_flash_packed_diff`, `_flash_fused_diff` and `_flash_attention_tpu_diff`:
the forward is K1 (for every packed shape, as the JAX custom_vjp forward
skips the K2/K3 routing), K6 or K4, each with its logsumexp; the backward is
K5, at the head dims K4 and K6 take (`HEAD_DIMS`). On the CPU both
directions run the plain versions.

The CUDA C++ sources are `csrc/attention.cu`, the mma.sync pieces it shares
with the probes, `csrc/flash_fwd.cuh`, K3's and K4's split-KV body,
`csrc/flash_splitkv.cuh` (the keys of a call cut into `kv_split_plan`'s
splits, each split's f32 partials merged by a combine pass), K1's, K6's and
K7's overlapped body on the same machinery (K7's with int8 scores) and K2's
K / V-resident form of it, `csrc/flash_ws.cuh`, and K5's one-pass backward
at head dims 64 and 128, `csrc/flash_bwd.cuh` and `csrc/flash_bwd128.cuh`
(at 16 and 32 the two-pass form of `csrc/attention.cu`); the float32 K4 is
`csrc/attention_f32.cu`, a library of its own. K1, K2, K3 and K6 run their
prologues once per row in a pass of their own (`prologue_pass_plain`'s function) into
a bf16 workspace; K7 quantizes in its pass (`quantize_pairs_plain`'s
function) into int8 codes and scales.
`build_kernels` compiles them with
nvcc (`kernels/build.py`) into a shared library with a plain C interface
(loaded with ctypes) under ``<repo>/build/kernels``. Dispatch goes by the
tensor's device: a CPU tensor takes the plain version (`attention_fused_plain` / `attention_plain`,
exact softmax, as `_xla_attention_fused` / `_xla_attention`); a CUDA tensor
launches the kernel or raises — on a failed build, a launch error, a head dim
the kernel does not take (64; K4, K5, K6: 16, 32, 64, 128; the float32 K4:
16, 32, 64) or a dtype other than bf16 (float32 too for K4). No path falls
back.

The prologue tables are those of the JAX package: ``(cosg, sin, add, Rg)``
from :func:`make_prologue`, with ``prologue(x) = LN0(x)∘cosg + (LN0(x)@Rg)∘sin
+ add``; the softmax scale is folded into the q tables.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import math
from pathlib import Path
from typing import Optional

import torch

from tokensgen_tpu_torch.kernels import build as _build
from tokensgen_tpu_torch.kernels.build import BUILD_DIR, NVCC_FLAGS  # noqa: F401  (public names)

_LOG2E = 1.4426950408889634
_SMALLKV_MAX = 512  # kv rows K2 holds whole in shared memory (csrc SMALLKV_MAX)
SMALLKV_BLOCK_Q = 256  # q rows per tile of K2's body (csrc WS_BM)
BWD_KV_BLOCK = 128  # keys per block of K5's one-pass bodies (csrc BW_BKV, B8_BKV)
BWD_Q_TILE = 128  # q rows per tile of their sweep at head dim 64 (csrc BW_BQ)
BWD_Q_TILE_128 = 64  # ... and at 128, where the registers hold m64n64 scores (csrc B8_BQ)
ONEPASS_HEAD_DIMS = (64, 128)  # head dims K5 runs in one pass (16 and 32: two passes)
HEAD_DIMS = (16, 32, 64, 128)  # head dims K4, K5 and K6 are built for (K1-K3, K7: 64)
F32_HEAD_DIMS = (16, 32, 64)  # head dims the float32 K4 is built for
MAX_SCORE_BYTES = 1 << 31  # f32 score tensor per q-row chunk of `attention_plain`
# K3's prologue pass writes rows in blocks of PRO_ROWS (csrc attention.cu)
PROLOGUE_ROWS = 32
SPLIT_MIN_TILES = 4  # kv tiles a split holds at least (splits chosen by `kv_split_plan`)
SPLIT_WS_BYTES = 32 << 20  # f32 partials of one call: well inside the 50 MB L2


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
    return _prologue32(x, tabs, eps, normalize).to(x.dtype)


def _prologue32(x: torch.Tensor, tabs, eps: float, normalize: bool) -> torch.Tensor:
    """The prologue in f32 (`apply_prologue_plain` before its cast)."""
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
    return ln0 * cosg + (ln0 @ rg) * sin + add


def _q_chunk(b: int, h: int, sq: int, skv: int) -> int:
    return max(1, min(sq, MAX_SCORE_BYTES // (4 * b * h * skv)))


def attention_plain(q, k, v, key_bias, scale: float, with_lse: bool = False):
    """Plain attention (`_xla_attention`) on [B, H, S, D]: f32 scores, exact
    softmax, f32 p@v. Runs in q-row chunks that keep the f32 score tensor
    under ``MAX_SCORE_BYTES`` (the production joint shape would need 121 GB).
    ``with_lse`` also returns the natural-log logsumexp of the scores, f32
    [B, H, Sq] (the kernels' lse output)."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    chunk = _q_chunk(b, h, sq, skv)
    kf, vf = k.float(), v.float()
    bias = key_bias.float()[:, None, None, :]
    outs, lses = [], []
    for i in range(0, sq, chunk):
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i:i + chunk].float(), kf) * scale + bias
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype))
        if with_lse:
            lses.append(torch.logsumexp(s, dim=-1))
    out = torch.cat(outs, dim=2)
    return (out, torch.cat(lses, dim=2)) if with_lse else out


def attention_bwd_plain(q, k, v, g, lse, dsum, key_bias, scale: float):
    """Plain attention backward (K5's plain version; `_blocked_attention_bwd`
    with the probabilities recomputed from the saved lse, as
    `_packed_bwd_kernel` does) on [B, H, S, D]. ``lse`` and ``dsum`` (=
    rowsum(g * out)): f32 [B, H, Sq]; ``key_bias``: [B, Skv] or None.
    Rounding points of the kernels: p and ds are f32 and rounded to the
    operands' dtype for the products, which accumulate in f32. Runs in q-row
    chunks under ``MAX_SCORE_BYTES``. Returns (dq, dk, dv) in the operands'
    dtype and dbias f32 [B, Skv]."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    dt = q.dtype
    chunk = _q_chunk(b, h, sq, skv)
    kf, vf = k.float(), v.float()
    bias = (torch.zeros(b, skv, device=q.device) if key_bias is None
            else key_bias.float())[:, None, None, :]
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    dbias = torch.zeros(b, skv, dtype=torch.float32, device=q.device)
    dqs = []
    for i in range(0, sq, chunk):
        sl = slice(i, i + chunk)
        qc, gc = q[:, :, sl].float(), g[:, :, sl].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale + bias
        p = torch.exp(s - lse[:, :, sl, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), gc)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", gc, vf) - dsum[:, :, sl, None])
        dsb = ds.to(dt).float()
        dqs.append((torch.einsum("bhqk,bhkd->bhqd", dsb, kf) * scale).to(dt))
        dk += torch.einsum("bhqk,bhqd->bhkd", dsb, qc) * scale
        dbias += ds.sum(dim=(1, 2))
    return torch.cat(dqs, dim=2), dk.to(dt), dv.to(dt), dbias


def bwd_q_tile(d: int) -> int:
    """q rows per tile of K5's one-pass sweep at head dim ``d`` (64 or 128):
    128 at 64; 64 at 128, where a warpgroup's dk and dv accumulators take 128
    registers a thread and leave room for m64n64 scores only."""
    return BWD_Q_TILE if d == 64 else BWD_Q_TILE_128


def attention_bwd_onepass_plain(q, k, v, g, lse, dsum, key_bias, scale: float,
                                kv_block: int = BWD_KV_BLOCK, q_tile: Optional[int] = None):
    """K5's one-pass decomposition (csrc flash_bwd.cuh and flash_bwd128.cuh,
    the card's form at head dims 64 and 128) on [B, H, S, D]: per block of
    ``kv_block`` keys and, within it, per tile of ``q_tile`` q rows (None:
    one tile of all Sq), in the transposed form of the kernel (keys on the
    rows, the log2 domain), s^T = k q^T, p^T = exp2(scale log2 e s^T + bias
    log2 e - lse log2 e), ds^T = p^T (v g^T - dsum); the block's dv = p^T g,
    dk = scale ds^T q and dbias = sum over q of ds^T summed over its tiles in
    f32, and each tile's share of dq, (ds^T)^T k, summed over the blocks in
    f32 (the kernel's workspace) and scaled once. (At 128 the kernel splits a
    share by d columns between its warpgroups: columns apart, no other sum.)
    Rounding points and arguments as `attention_bwd_plain`, which it
    equals."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    dt = q.dtype
    q_tile = sq if q_tile is None else q_tile
    qf, gf = q.float(), g.float()
    bias2 = (torch.zeros(b, skv, device=q.device) if key_bias is None
             else key_bias.float()) * _LOG2E
    lse2 = lse[:, :, None, :] * _LOG2E
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs, dbs = [], [], []
    for k0 in range(0, skv, kv_block):
        kb, vb = k[:, :, k0:k0 + kv_block].float(), v[:, :, k0:k0 + kv_block].float()
        dkb = torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
        dvb = torch.zeros(vb.shape, dtype=torch.float32, device=q.device)
        dbb = torch.zeros(b, kb.shape[2], dtype=torch.float32, device=q.device)
        for q0 in range(0, sq, q_tile):
            sl = slice(q0, q0 + q_tile)
            qt, gt = qf[:, :, sl], gf[:, :, sl]
            st = torch.einsum("bhkd,bhqd->bhkq", kb, qt)
            pt = torch.exp2(st * (scale * _LOG2E) + bias2[:, None, k0:k0 + kv_block, None]
                            - lse2[..., sl])
            dst = pt * (torch.einsum("bhkd,bhqd->bhkq", vb, gt) - dsum[:, :, None, sl])
            dsb = dst.to(dt).float()
            dvb += torch.einsum("bhkq,bhqd->bhkd", pt.to(dt).float(), gt)
            dkb += torch.einsum("bhkq,bhqd->bhkd", dsb, qt)
            dbb += dst.sum(dim=(1, 3))
            dq[:, :, sl] += torch.einsum("bhkq,bhkd->bhqd", dsb, kb)
        dvs.append(dvb)
        dks.append(dkb * scale)
        dbs.append(dbb)
    return ((dq * scale).to(dt), torch.cat(dks, dim=2).to(dt), torch.cat(dvs, dim=2).to(dt),
            torch.cat(dbs, dim=1))


def attention_fused_plain(q, k, v, key_bias, tabs_q, tabs_k, eps, norm_q, norm_k,
                          with_lse: bool = False):
    """Plain fused-prologue attention (`_xla_attention_fused`) on [B, H, S, D]
    (K6's plain version); ``with_lse`` as in `attention_plain`."""
    qn = apply_prologue_plain(q, tabs_q, eps, norm_q)
    kn = apply_prologue_plain(k, tabs_k, eps, norm_k)
    return attention_plain(qn, kn, v, key_bias, 1.0, with_lse=with_lse)


def split_block_q(d: int) -> int:
    """q rows per block of the split-KV body at head dim d (csrc
    `splitkv_bm`): two row blocks of 128 at d <= 64, one at 128."""
    return 256 if d <= 64 else 128


def kv_tile(d: int) -> int:
    """Keys per kv tile of the split-KV body at head dim d (csrc
    `splitkv_bn`)."""
    return 128 if d <= 64 else 64


SPLIT_BLOCK_SETUP = 2  # a block's set-up (q tile, first loads, epilogue) in kv tiles of work
SPLIT_COST = 1  # what a split adds (its partials, the combine's reads), in the same units


def _split_makespan(b: int, h: int, sq: int, tiles: int, d: int, sms: int, splits: int) -> int:
    """The time, in row-block x kv-tile units, that the split-KV body takes at
    ``splits`` splits when its blocks go, in launch order (q tile fastest,
    then split, head, batch row), to ``sms`` SMs that each run one block at a
    time (a block of 8 warps takes an SM's registers). A block costs its row
    blocks of 128 q rows times its kv tiles, plus `SPLIT_BLOCK_SETUP`."""
    bm = split_block_q(d)
    per = -(-tiles // splits)
    row_blocks = [-(-min(bm, sq - q0) // 128) for q0 in range(0, sq, bm)]
    free = [0] * sms
    for _ in range(b * h):
        for s in range(splits):
            t = min(per, tiles - s * per)
            for rb in row_blocks:
                start = heapq.heappop(free)
                heapq.heappush(free, start + rb * t + SPLIT_BLOCK_SETUP)
    return max(free)


@functools.lru_cache(maxsize=64)
def kv_split_plan(b: int, h: int, sq: int, skv: int, d: int, sms: int,
                  splits: Optional[int] = None):
    """(splits, split_len) of K3's and K4's split-KV forward: the keys cut
    into ranges of ``split_len`` keys (a whole number of `kv_tile` tiles),
    the last holding the rest (at least one key). From the shape alone (so a
    call with the lse and one without run the same splits): the fewest
    splits with the least `_split_makespan` on ``sms`` SMs plus `SPLIT_COST`
    a split (both fitted to the H100's device times of K4 at its four head
    dims over 1-24 splits and of K3 over 1-6), with at least
    `SPLIT_MIN_TILES` tiles a split and the f32 partials under
    `SPLIT_WS_BYTES`. ``splits`` asks for a count instead (the tests' and
    the smoke's forced splits); ranges are evened out, so it may come back
    smaller."""
    tiles = -(-skv // kv_tile(d))
    if splits is None:
        most = max(1, min(tiles // SPLIT_MIN_TILES, SPLIT_WS_BYTES // (b * h * sq * (d + 2) * 4)))
        splits = min(range(1, most + 1), key=lambda n: (
            _split_makespan(b, h, sq, tiles, d, sms, n) + SPLIT_COST * n, n))
    per = -(-tiles // max(1, min(splits, tiles)))
    return -(-tiles // per), per * kv_tile(d)


def splitkv_partials_plain(q, k, v, key_bias, scale: float, split_len: int):
    """The split pass of K3 / K4 on [B, H, S, D], in f32: per range of
    ``split_len`` keys, with x = (scale * q.k + bias) * log2 e, the row max
    m_s, l_s = sum 2^(x - m_s) and acc_s = sum 2^(x - m_s) v over its keys.
    Returns (acc [splits, B, H, Sq, D], m, l [splits, B, H, Sq])."""
    skv = k.shape[2]
    x = (torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
         + key_bias.float()[:, None, None, :]) * _LOG2E
    vf = v.float()
    accs, ms, ls = [], [], []
    for s0 in range(0, skv, split_len):
        xs = x[..., s0:s0 + split_len]
        m = xs.amax(dim=-1)
        p = torch.exp2(xs - m[..., None])
        accs.append(torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, s0:s0 + split_len]))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


def combine_plain(acc, m, l):
    """The combine of the split partials (`splitkv_partials_plain`'s):
    m = max_s m_s, l = sum_s l_s 2^(m_s - m), out = sum_s acc_s 2^(m_s - m) / l,
    lse = (m + log2 l) ln 2 (natural log). Returns (out, lse), f32."""
    mx = m.amax(dim=0)
    w = torch.exp2(m - mx)
    lsum = (l * w).sum(dim=0)
    out = (acc * w[..., None]).sum(dim=0) / lsum[..., None]
    return out, (mx + torch.log2(lsum)) * math.log(2.0)


def prologue_pass_plain(x, tabs, heads: Optional[int], eps: float, normalize: bool,
                        scale: float = 1.0):
    """The prologue pass of K1, K3 and K6 (csrc `prologue_rows`): per (row,
    head) the f32 LayerNorm (with ``normalize``), then RoPE with the tables
    [(B,) S, D] that every head of the row shares, times ``scale`` (log2 e
    on a q side), cast to x's dtype, in the workspace's layout: contiguous
    merged [B, S, H*D]. ``x`` is merged [B, S, H*D] (pass ``heads``) or
    [B, H, S, D] with any strides (``heads`` None: K6's operands)."""
    cosg, sin, add, rg = tabs
    if heads is None:
        x32 = x.float().permute(0, 2, 1, 3)
    else:
        b, s, hd = x.shape
        x32 = x.float().reshape(b, s, heads, hd // heads)
    b, s, h, d = x32.shape
    if normalize:
        dlt = x32 - x32.mean(-1, keepdim=True)
        x32 = dlt * torch.rsqrt((dlt * dlt).mean(-1, keepdim=True) + eps)
    y = (x32 * cosg[..., None, :] + (x32 @ rg) * sin[..., None, :] + add[..., None, :]) * scale
    return y.reshape(b, s, h * d).to(x.dtype)


def quantize_pairs_plain(x, tabs, eps: float, normalize: bool, scale: float = 1.0):
    """K7's quantizing prologue on [B, H, S, D] (H even): y = the f32
    prologue with ``scale`` folded into the tables (as the JAX wrapper folds
    log2 e into the q tables), and per (b, head pair, row) the absmax
    s = max(max|y| over the pair's 2*D features, 1e-30). Returns the codes
    clip(rint(y * (127 / s)), -127, 127) as f32 integers [B, H, S, D] and the
    dequant scales s * (1 / 127), f32 [B, H/2, S]."""
    cosg, sin, add, rg = tabs
    if scale != 1.0:
        tabs = (cosg * scale, sin * scale, add * scale, rg)
    y = _prologue32(x, tabs, eps, normalize)
    b, h, s, d = y.shape
    yp = y.reshape(b, h // 2, 2, s, d)
    amax = torch.clamp_min(yp.abs().amax(dim=(2, 4)), 1e-30)
    codes = torch.clamp(torch.round(yp * (127.0 / amax)[:, :, None, :, None]), -127, 127)
    return codes.reshape(b, h, s, d), amax * (1.0 / 127.0)


def attention_int8_plain(q8, qs, k8, ks, v, key_bias):
    """K7's attention from the codes and scales of `quantize_pairs_plain`
    (log2 e already in q's): scores (q8 . k8^T) * qs_row * ks_col + bias *
    log2 e, exact integer products (f32 holds them: |q8 . k8| < 2^24),
    softmax in base 2, p rounded to v's dtype for p@v, f32 sums. [B, H, S, D]
    in, v's dtype out; in q-row chunks under ``MAX_SCORE_BYTES``."""
    b, h, sq, _ = q8.shape
    skv = k8.shape[2]
    chunk = _q_chunk(b, h, sq, skv)
    qsh, ksh = qs.repeat_interleave(2, dim=1), ks.repeat_interleave(2, dim=1)
    bias = key_bias.float()[:, None, None, :] * _LOG2E
    vf = v.float()
    outs = []
    for i in range(0, sq, chunk):
        s = torch.einsum("bhqd,bhkd->bhqk", q8[:, :, i:i + chunk], k8)
        s.mul_(qsh[:, :, i:i + chunk, None]).mul_(ksh[:, :, None, :]).add_(bias)
        s.sub_(s.amax(dim=-1, keepdim=True)).exp2_()
        l = s.sum(dim=-1, keepdim=True)
        outs.append((torch.einsum("bhqk,bhkd->bhqd", s.to(v.dtype).float(), vf) / l).to(v.dtype))
    return torch.cat(outs, dim=2)


INT8_MAGIC = 0x4B400000  # the bits of 1.5 * 2^23 (csrc I8_MAGIC)


def int8_score_to_float(c: torch.Tensor) -> torch.Tensor:
    """K7's conversion of its s32 scores to f32 without an I2F (csrc
    `ws_body`'s I8): the bits of c + `INT8_MAGIC` read as a float are
    1.5 * 2^23 + c exactly while |c| < 2^22 (every score: |c| <= 64 * 127^2),
    and one f32 subtraction takes the offset off. ``c``: int32."""
    return (c + INT8_MAGIC).view(torch.float32) - 12582912.0


def int8_splitkv_partials_plain(q8, qs, k8, ks, v, key_bias, split_len: int):
    """The split pass of K7's body on [B, H, S, D] codes (`quantize_pairs_plain`'s
    codes and scales, log2 e in q's), in its order: per score the exact
    integer product, to f32 by `int8_score_to_float`, times the key's scale,
    then the row's (with the key bias times log2 e); per range of
    ``split_len`` keys the row max m_s, p = 2^(x - m_s), l_s = sum p (f32)
    and acc_s = sum bf16(p) v (p rounded to v's dtype, as the kernel's p.v).
    Returns (acc [splits, B, H, Sq, D], m, l [splits, B, H, Sq]) for
    `combine_plain`."""
    skv = k8.shape[2]
    # exact in f32: every partial sum is an integer under 2^24
    c = torch.einsum("bhqd,bhkd->bhqk", q8.float(), k8.float()).to(torch.int32)
    x = (int8_score_to_float(c) * ks.repeat_interleave(2, dim=1)[:, :, None, :]
         * qs.repeat_interleave(2, dim=1)[:, :, :, None]
         + key_bias.float()[:, None, None, :] * _LOG2E)
    vf = v.float()
    accs, ms, ls = [], [], []
    for s0 in range(0, skv, split_len):
        xs = x[..., s0:s0 + split_len]
        m = xs.amax(dim=-1)
        p = torch.exp2(xs - m[..., None])
        accs.append(torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                                 vf[:, :, s0:s0 + split_len]))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


def attention_fused_int8_plain(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k):
    """Plain K7 (the int8_scores branch of `_flash_packed_kernel`) on merged
    [B, S, H*D] operands, H even: both prologues quantized per (row, head
    pair), then `attention_int8_plain`."""
    q8, qs = quantize_pairs_plain(split_heads(q, heads), tabs_q, eps, norm_q, _LOG2E)
    k8, ks = quantize_pairs_plain(split_heads(k, heads), tabs_k, eps, norm_k)
    return merge_heads(attention_int8_plain(q8, qs, k8, ks, split_heads(v, heads), key_bias))


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


def cross_smallkv_plain(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k):
    """K2's card path in its plain version, on merged [B, S, H*64] operands
    with an f32 key bias [B, Skv]:
    the prologue pass of k and of q with log2 e folded in
    (`prologue_pass_plain`), then the K / V-resident body: per q row, the
    online softmax in base 2 over the keys' tiles of `kv_tile(64)` (128) keys,
    the running max, sum and output rescaled at each tile. Returns the
    output in q's dtype."""
    kp = split_heads(prologue_pass_plain(k, tabs_k, heads, eps, norm_k), heads).float()
    qp = split_heads(prologue_pass_plain(q, tabs_q, heads, eps, norm_q, _LOG2E), heads).float()
    vf = split_heads(v, heads).float()
    x = (torch.einsum("bhqd,bhkd->bhqk", qp, kp)
         + key_bias.float()[:, None, None, :] * _LOG2E)
    m = torch.full(x.shape[:-1], -math.inf, device=x.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(*x.shape[:-1], vf.shape[-1], device=x.device)
    bn = kv_tile(vf.shape[-1])
    for k0 in range(0, x.shape[-1], bn):
        xs = x[..., k0:k0 + bn]
        m_new = torch.maximum(m, xs.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(xs - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, k0:k0 + bn])
        m = m_new
    return merge_heads(acc / l[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# Build and bind the CUDA library
# ---------------------------------------------------------------------------


class _Args(ctypes.Structure):
    """Mirror of `TGAttnArgs` in csrc/attention.cu (every field 8 bytes)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "o", "bias", "lse", "q_cos", "q_sin", "q_add", "q_rot",
            "k_cos", "k_sin", "k_add", "k_rot")]
        + [(n, ctypes.c_int64) for n in (
            "q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh", "v_sb", "v_ss", "v_sh",
            "o_sb", "o_ss", "o_sh", "q_tb", "k_tb", "b", "h", "sq", "skv",
            "norm_q", "norm_k")]
        + [("qscale", ctypes.c_double), ("eps", ctypes.c_double)]
    )


class _BwdArgs(ctypes.Structure):
    """Mirror of `TGAttnBwdArgs` in csrc/attention.cu (every field 8 bytes)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "g", "lse", "dsum", "bias", "dq", "dk", "dv", "dbias")]
        + [(f"{n}_{s}", ctypes.c_int64) for n in ("q", "k", "v", "g", "dq", "dk", "dv")
           for s in ("sb", "ss", "sh")]
        + [(n, ctypes.c_int64) for n in ("b", "h", "sq", "skv")]
        + [("scale", ctypes.c_double)]
    )


class _QuantArgs(ctypes.Structure):
    """Mirror of `TGQuantArgs` in csrc/attention.cu (every field 8 bytes)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("x", "codes", "scales", "cos", "sin", "add", "rot")]
        + [(n, ctypes.c_int64) for n in ("sb", "ss", "tb", "b", "s", "pairs", "norm")]
        + [("scale", ctypes.c_double), ("eps", ctypes.c_double)]
    )


class _Int8Args(ctypes.Structure):
    """Mirror of `TGInt8Args` in csrc/attention.cu (every field 8 bytes)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("q8", "k8", "qs", "ks", "v", "o", "bias")]
        + [(n, ctypes.c_int64) for n in (
            "v_sb", "v_ss", "v_sh", "o_sb", "o_ss", "o_sh", "b", "h", "sq", "skv")]
    )


class _F32Args(ctypes.Structure):
    """Mirror of `TGF32Args` in csrc/attention_f32.cu (every field 8 bytes)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("q", "k", "v", "o", "bias")]
        + [(f"{n}_{s}", ctypes.c_int64) for n in ("q", "k", "v", "o") for s in ("sb", "ss", "sh")]
        + [(n, ctypes.c_int64) for n in ("b", "h", "sq", "skv")]
        + [("qscale", ctypes.c_double)]
    )


_K2_ENTRY_POINT = "tg_attention_cross_smallkv"  # q tiles per block, prologue workspace
_BWD_ENTRY_POINT = "tg_attention_bwd"  # head dim, then (at 64, 128) the lse / dsum table, dq's sums
_INT8_ENTRY_POINT = "tg_attention_joint_int8"  # splits, split_len, split workspace
_INT8_GEOMETRY = "tg_attention_joint_int8_geometry"  # the body's shared memory and threads
_K1_ENTRY_POINT = "tg_attention_joint"  # splits, split_len, prologue and split workspaces
_K6_ENTRY_POINT = "tg_attention_fused_bhsd"  # head dim, then as K1
_K3_ENTRY_POINT = "tg_attention_cross_smallq"  # splits, split_len, prologue and split workspaces
_K4_ENTRY_POINT = "tg_attention_bhsd"  # head dim, splits, split_len, split workspace


def _bind(lib) -> None:
    _build.bind(lib, _K2_ENTRY_POINT, ctypes.POINTER(_Args), ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p)
    _build.bind(lib, _K1_ENTRY_POINT, ctypes.POINTER(_Args), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
    _build.bind(lib, _K6_ENTRY_POINT, ctypes.POINTER(_Args), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
    _build.bind(lib, _K3_ENTRY_POINT, ctypes.POINTER(_Args), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
    _build.bind(lib, _K4_ENTRY_POINT, ctypes.POINTER(_Args), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p)
    _build.bind(lib, _BWD_ENTRY_POINT, ctypes.POINTER(_BwdArgs), ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p)
    _build.bind(lib, _INT8_ENTRY_POINT, ctypes.POINTER(_QuantArgs), ctypes.POINTER(_QuantArgs),
                ctypes.POINTER(_Int8Args), ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p)
    _build.bind(lib, _INT8_GEOMETRY, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64))


_Library = _build.KernelLibrary("attention.cu", _bind)  # the compiled kernels, one per process
_F32_ENTRY_POINT = "tg_attention_bhsd_f32"  # head dim
_F32_GEOMETRY = "tg_attention_bhsd_f32_geometry"  # head dim; threads, shared memory, blocks a SM


def _bind_f32(lib) -> None:
    _build.bind(lib, _F32_ENTRY_POINT, ctypes.POINTER(_F32Args), ctypes.c_int64, ctypes.c_void_p)
    _build.bind(lib, _F32_GEOMETRY, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64))


_F32Library = _build.KernelLibrary("attention_f32.cu", _bind_f32)  # the float32 K4


def build_kernels(force: bool = False) -> Path:
    """Compile csrc/attention.cu for sm_90a with nvcc (cached by source hash)
    and load it. Returns the library path; raises with nvcc's output on failure.
    The float32 K4's csrc/attention_f32.cu builds at its first use."""
    return _Library.build(force)


def _lib():
    return _Library.get()


def _check_operand(name: str, x: torch.Tensor, merged_heads: Optional[int], d: int = 64):
    """(sb, ss, sh) element strides of a [B, S, H*d] (merged) or [B, H, S, d]
    bf16 CUDA operand with a contiguous, 16-byte aligned head dim."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the attention kernels take bfloat16, got {x.dtype}")
    if merged_heads is not None:
        if x.dim() != 3 or x.shape[2] != d * merged_heads:
            raise ValueError(f"{name}: expected [B, S, {merged_heads}*{d}], got {tuple(x.shape)}")
        sb, ss, sc = x.stride()
        sh = d
    else:
        if x.dim() != 4 or x.shape[3] != d:
            raise ValueError(f"{name}: expected [B, H, S, {d}], got {tuple(x.shape)}")
        sb, sh, ss, sc = x.stride()
    if sc != 1 or sb % 8 or ss % 8 or sh % 8 or x.data_ptr() % 16:
        raise ValueError(f"{name}: head dim must be contiguous with 16-byte aligned rows")
    return sb, ss, sh


def _check_tabs(name: str, tabs, seqlen: int, batch: int, device, d: int = 64):
    """Contiguous f32 (cosg, sin, add) + pair-swap coefficients of Rg, and the
    tables' batch stride (0 when shared)."""
    cosg, sin, add, rg = tabs
    out = []
    for t in (cosg, sin, add):
        if t.device != device or t.dtype != torch.float32:
            raise TypeError(f"{name}: tables must be float32 on {device}")
        if t.shape[-2:] != (seqlen, d) or (t.dim() == 3 and t.shape[0] not in (1, batch)):
            raise ValueError(f"{name}: table shape {tuple(t.shape)} for S={seqlen}, B={batch}")
        out.append(t.contiguous())
    tb = seqlen * d if cosg.dim() == 3 and cosg.shape[0] == batch and batch > 1 else 0
    return out, _pair_coefficients(rg, d, device), tb


_CHECKED_RG: list = []  # [(Rg, its version, d, rot)] of the last tables checked, newest first


def _pair_coefficients(rg, d: int, device):
    """rot[j] = Rg[j ^ 1, j]: Rg = diag(g)·R is nonzero only on the pair swap
    (make_prologue); the kernels read those d entries, and a device-side
    check holds Rg to it. The DiT hands every layer the same table tensors,
    so an Rg seen before and not modified since (the same object at the
    same in-place version) reuses its coefficients and its check."""
    for ref, version, dd, rot in _CHECKED_RG:
        if ref is rg and dd == d and rg._version == version:
            return rot
    idx = torch.arange(d, device=device)
    r = rg.float()
    rot = r[idx ^ 1, idx].contiguous()
    pair = idx[:, None] == (idx[None, :] ^ 1)
    torch._assert_async(torch.all((r == 0) | pair))
    if not rg.is_inference():
        _CHECKED_RG.insert(0, (rg, rg._version, d, rot))
        del _CHECKED_RG[4:]
    return rot


def _bias_ptr(key_bias, b: int, skv: int, keep: list):
    """Device pointer of the f32 [B, Skv] key bias (None: no bias); the
    contiguous f32 copy is appended to ``keep``."""
    if key_bias is None:
        return None
    kb = key_bias.float().contiguous()
    if kb.shape != (b, skv):
        raise ValueError(f"key_bias: expected [{b}, {skv}], got {tuple(kb.shape)}")
    keep.append(kb)
    return kb.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def smallkv_tiles_per_block(b: int, h: int, sq: int, sms: int) -> int:
    """q tiles (of `SMALLKV_BLOCK_Q` rows, (b, h)-major) per block of K2's
    body: one wave of ``sms`` blocks, each a contiguous range of tiles that
    loads its (b, h)'s K and V once (twice where the range crosses into the
    next (b, h))."""
    tiles = b * h * -(-sq // SMALLKV_BLOCK_Q)
    return -(-tiles // sms)


def _launch_smallkv(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k,
                    per_block: Optional[int] = None):
    """K2 on merged [B, S, H*64] operands: the prologue pass of k and of q
    (log2 e folded into q') into a bf16 workspace, then the K / V-resident
    body, `smallkv_tiles_per_block` q tiles a block (``per_block`` forces a
    count)."""
    lib = _lib()
    a, out, keep = attn_args(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k,
                             _LOG2E)
    if per_block is None:
        per_block = smallkv_tiles_per_block(a.b, a.h, a.sq, _sm_count(q.device.index or 0))
    pro = torch.empty(a.b * (a.skv + a.sq) * a.h * 64, dtype=torch.bfloat16, device=q.device)
    keep.append(pro)
    _build.check_launch(_K2_ENTRY_POINT, getattr(lib, _K2_ENTRY_POINT)(
        ctypes.byref(a), per_block, pro.data_ptr(), _build.stream_of(q)))
    return out


def _split_workspace(plan, b: int, h: int, sq: int, d: int, device, keep: list):
    """The f32 partials of ``plan`` = (splits, split_len): acc [splits, B, H,
    Sq, d] then (m, l) [splits, B, H, Sq, 2] in one buffer; None (a null
    pointer) at one split, where the body writes the output itself."""
    splits = plan[0]
    if splits == 1:
        return None
    ws = torch.empty(splits * b * h * sq * (d + 2), dtype=torch.float32, device=device)
    keep.append(ws)
    return ws.data_ptr()


def _launch_smallq(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k,
                   splits: Optional[int] = None):
    """K3 on merged [B, S, H*64] operands: the prologue pass of q (log2 e
    folded in) and of k into a bf16 workspace, then the split-KV body in
    `kv_split_plan`'s splits (``splits`` forces a count), then the combine."""
    lib = _lib()
    a, out, keep = attn_args(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k,
                             _LOG2E)
    b, sq, skv = a.b, a.sq, a.skv
    plan = kv_split_plan(b, heads, sq, skv, 64, _sm_count(q.device.index or 0), splits)
    pad = lambda n: -(-n // PROLOGUE_ROWS) * PROLOGUE_ROWS  # noqa: E731
    pro = torch.empty(b * (pad(sq) + pad(skv)) * heads * 64, dtype=torch.bfloat16,
                      device=q.device)
    keep.append(pro)
    ws = _split_workspace(plan, b, heads, sq, 64, q.device, keep)
    _build.check_launch(_K3_ENTRY_POINT, getattr(lib, _K3_ENTRY_POINT)(
        ctypes.byref(a), *plan, pro.data_ptr(), ws, _build.stream_of(q)))
    return out


def _launch_fused(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k,
                  with_lse: bool = False, splits: Optional[int] = None):
    """K1 on merged [B, S, H*64] operands (pass ``heads``) or K6 on
    [B, H, S, D] ones by their strides (``heads`` None, D in `HEAD_DIMS`;
    the output keeps q's memory layout, so the [B, H, S, D] view of a merged
    tensor gives a merged output): the prologue passes of k and q (log2 e
    folded into q') into a bf16 workspace, the body in `kv_split_plan`'s
    splits (``splits`` forces a count), then the combine.
    Returns ``out`` or, ``with_lse``, (out, lse) with lse the natural-log
    logsumexp f32 [B, H, Sq]."""
    k6 = heads is None
    d = q.shape[-1] if k6 else 64
    entry = _K6_ENTRY_POINT if k6 else _K1_ENTRY_POINT
    if d not in HEAD_DIMS:
        raise ValueError(f"{entry}: head dim {d} not in {HEAD_DIMS}")
    lib = _lib()
    a, out, keep = attn_args(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k,
                             _LOG2E, d, keep_layout=k6)
    lse = None
    if with_lse:
        lse = torch.empty(a.b, a.h, a.sq, dtype=torch.float32, device=q.device)
        a.lse = lse.data_ptr()
    plan = kv_split_plan(a.b, a.h, a.sq, a.skv, d, _sm_count(q.device.index or 0), splits)
    pro = torch.empty(a.b * (a.skv + a.sq) * a.h * d, dtype=torch.bfloat16, device=q.device)
    keep.append(pro)
    ws = _split_workspace(plan, a.b, a.h, a.sq, d, q.device, keep)
    stream = _build.stream_of(q)
    fn = getattr(lib, entry)
    _build.check_launch(entry, fn(ctypes.byref(a), d, *plan, pro.data_ptr(), ws, stream) if k6
                        else fn(ctypes.byref(a), *plan, pro.data_ptr(), ws, stream))
    return (out, lse) if with_lse else out


def _launch_bhsd(q, k, v, key_bias, scale: float, with_lse: bool = False,
                 splits: Optional[int] = None):
    """K4 on [B, H, S, D] operands, D in `HEAD_DIMS`: the split-KV body in
    `kv_split_plan`'s splits (``splits`` forces a count), then the combine;
    returns ``out`` or, ``with_lse``, (out, lse)."""
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{_K4_ENTRY_POINT}: head dim {d} not in {HEAD_DIMS}")
    lib = _lib()
    a, out, keep = attn_args(q, k, v, key_bias, None, None, None, 0.0, False, False,
                             scale * _LOG2E, d)
    lse = None
    if with_lse:
        lse = torch.empty(a.b, a.h, a.sq, dtype=torch.float32, device=q.device)
        a.lse = lse.data_ptr()
    plan = kv_split_plan(a.b, a.h, a.sq, a.skv, d, _sm_count(q.device.index or 0), splits)
    ws = _split_workspace(plan, a.b, a.h, a.sq, d, q.device, keep)
    _build.check_launch(_K4_ENTRY_POINT, getattr(lib, _K4_ENTRY_POINT)(
        ctypes.byref(a), d, *plan, ws, _build.stream_of(q)))
    return (out, lse) if with_lse else out


def f32_geometry(d: int) -> tuple:
    """(threads, dynamic shared memory in bytes, resident blocks a SM) of a
    block of the float32 K4's body at head dim ``d``."""
    out = (ctypes.c_int64 * 3)()
    _build.check_launch(_F32_GEOMETRY, getattr(_F32Library.get(), _F32_GEOMETRY)(d, out))
    return tuple(out)


def _launch_bhsd_f32(q, k, v, key_bias, scale: float):
    """The float32 K4 on [B, H, S, D] float32 operands, D in `F32_HEAD_DIMS`,
    each with a contiguous head dim and 16-byte aligned rows; returns the
    contiguous output."""
    d = q.shape[-1]
    if d not in F32_HEAD_DIMS:
        raise ValueError(f"{_F32_ENTRY_POINT}: head dim {d} not in {F32_HEAD_DIMS}")
    lib = _F32Library.get()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    a = _F32Args()
    keep = [out]
    for name, x in (("q", q), ("k", k), ("v", v), ("o", out)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: the float32 K4 takes float32 operands, got {x.dtype}")
        if x.dim() != 4 or x.shape[3] != d or x.shape[:2] != q.shape[:2]:
            raise ValueError(f"{name}: expected [B, H, S, {d}], got {tuple(x.shape)}")
        sb, sh, ss, sc = x.stride()
        if sc != 1 or sb % 4 or sh % 4 or ss % 4 or x.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous with 16-byte aligned rows")
        setattr(a, name, x.data_ptr())
        setattr(a, f"{name}_sb", sb)
        setattr(a, f"{name}_ss", ss)
        setattr(a, f"{name}_sh", sh)
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    a.b, a.h, a.sq, a.skv = q.shape[0], q.shape[1], q.shape[2], k.shape[2]
    a.bias = _bias_ptr(key_bias, a.b, a.skv, keep)
    a.qscale = scale * _LOG2E
    _build.check_launch(_F32_ENTRY_POINT, getattr(lib, _F32_ENTRY_POINT)(
        ctypes.byref(a), d, _build.stream_of(q)))
    return out


def attn_args(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k, qscale: float,
              d: int = 64, keep_layout: bool = False):
    """The `TGAttnArgs` of a forward call, checked: (args, out, keep) with
    ``out`` the output it writes (contiguous, or in q's memory layout with
    ``keep_layout``) and ``keep`` the buffers that must outlive the launch.
    Operands merged [B, S, H*d] (pass ``heads``) or [B, H, S, d]; tables
    None for a side without a prologue."""
    b = q.shape[0]
    if heads is not None:
        h, sq, skv = heads, q.shape[1], k.shape[1]
    else:
        h, sq, skv = q.shape[1], q.shape[2], k.shape[2]
    out = (torch.empty_like(q) if keep_layout
           else torch.empty_like(q, memory_format=torch.contiguous_format))
    a = _Args()
    keep = [out]
    for name, x in (("q", q), ("k", k), ("v", v), ("o", out)):
        sb, ss, sh = _check_operand(name, x, heads, d)
        setattr(a, name, x.data_ptr())
        setattr(a, f"{name}_sb", sb)
        setattr(a, f"{name}_ss", ss)
        setattr(a, f"{name}_sh", sh)
    a.bias = _bias_ptr(key_bias, b, skv, keep)
    for side, tabs, seqlen in (("q", tabs_q, sq), ("k", tabs_k, skv)):
        if tabs is None:
            continue
        (cosg, sin, add), rot, tb = _check_tabs(f"tabs_{side}", tabs, seqlen, b, q.device, d)
        keep += [cosg, sin, add, rot]
        setattr(a, f"{side}_cos", cosg.data_ptr())
        setattr(a, f"{side}_sin", sin.data_ptr())
        setattr(a, f"{side}_add", add.data_ptr())
        setattr(a, f"{side}_rot", rot.data_ptr())
        setattr(a, f"{side}_tb", tb)
    a.b, a.h, a.sq, a.skv = b, h, sq, skv
    a.norm_q, a.norm_k = int(norm_q), int(norm_k)
    a.qscale, a.eps = qscale, eps
    return a, out, keep


def _launch_bwd(q, k, v, g, lse, dsum, key_bias, heads, scale: float, with_dbias: bool):
    lib = _lib()
    b = q.shape[0]
    if heads is not None:
        h, sq, skv, d = heads, q.shape[1], k.shape[1], q.shape[2] // heads
    else:
        h, sq, skv, d = q.shape[1], q.shape[2], k.shape[2], q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"attention_backward: head dim {d} not in {HEAD_DIMS}")
    grads = [torch.empty_like(x, memory_format=torch.contiguous_format) for x in (q, k, v)]
    a = _BwdArgs()
    keep = list(grads)  # buffers that must outlive the launch call
    for name, x in zip(("q", "k", "v", "g", "dq", "dk", "dv"), (q, k, v, g, *grads)):
        sb, ss, sh = _check_operand(name, x, heads, d)
        setattr(a, name, x.data_ptr())
        setattr(a, f"{name}_sb", sb)
        setattr(a, f"{name}_ss", ss)
        setattr(a, f"{name}_sh", sh)
    if g.shape != q.shape:
        raise ValueError(f"g: expected {tuple(q.shape)}, got {tuple(g.shape)}")
    for name, x in (("lse", lse), ("dsum", dsum)):
        if x.dtype != torch.float32 or x.shape != (b, h, sq) or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 [{b}, {h}, {sq}]")
        setattr(a, name, x.data_ptr())
    a.bias = _bias_ptr(key_bias, b, skv, keep)
    dbias = None
    if with_dbias:
        dbias = torch.empty(b, h, skv, dtype=torch.float32, device=q.device)
        a.dbias = dbias.data_ptr()
    a.b, a.h, a.sq, a.skv = b, h, sq, skv
    a.scale = scale
    aux = ws = None
    if d in ONEPASS_HEAD_DIMS:  # the one-pass body: its lse / dsum table and dq's f32 sums
        aux = bwd_aux_table(lse, dsum, bwd_q_tile(d))
        ws = torch.zeros(b, h, sq, d, dtype=torch.float32, device=q.device)
        keep += [aux, ws]
    err = getattr(lib, _BWD_ENTRY_POINT)(
        ctypes.byref(a), d, None if aux is None else aux.data_ptr(),
        None if ws is None else ws.data_ptr(), _build.stream_of(q))
    _build.check_launch(_BWD_ENTRY_POINT, err)
    return (*grads, None if dbias is None else dbias.sum(dim=1))


def bwd_aux_table(lse, dsum, tile: int = BWD_Q_TILE):
    """The per-q-tile table of K5's one-pass body: f32 [B * H, ceil(Sq /
    ``tile``), 2, ``tile``] (``tile``: `bwd_q_tile` of the head dim), each
    tile's lse * log2 e, then its dsum; past Sq lse * log2 e = +inf and
    dsum = 0, so that p = ds = 0 on the padding rows (which the kernel reads
    as zeros)."""
    b, h, sq = lse.shape
    nq = -(-sq // tile)
    pad = nq * tile - sq
    lse2 = torch.nn.functional.pad(lse.reshape(b * h, sq) * _LOG2E, (0, pad), value=math.inf)
    ds = torch.nn.functional.pad(dsum.reshape(b * h, sq), (0, pad))
    return torch.stack((lse2.view(b * h, nq, tile), ds.view(b * h, nq, tile)), dim=2)


def int8_scale_stride(s: int) -> int:
    """Row stride of K7's scale tables (csrc `int8_scale_stride`): S rounded
    up to 16 bytes, as the body's tensor maps need; they read [0, S) of a
    row (zeros past it), never the padding."""
    return -(-s // 4) * 4


def int8_geometry() -> tuple:
    """(dynamic shared memory in bytes, threads) of a block of K7's body."""
    smem, threads = ctypes.c_int64(), ctypes.c_int64()
    _build.check_launch(_INT8_GEOMETRY, getattr(_lib(), _INT8_GEOMETRY)(
        ctypes.byref(smem), ctypes.byref(threads)))
    return smem.value, threads.value


def _launch_int8(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k,
                 splits: Optional[int] = None):
    """Launches K7 (both quantizing prologues, then the int8-score body in
    `kv_split_plan`'s splits, K1's plan (``splits`` forces a count), then the
    combine); the int8 codes, the scales (rows `int8_scale_stride`) and the
    split partials are scratch allocated here."""
    lib = _lib()
    b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    keep = [out]  # buffers that must outlive the launch call
    sides = []
    for name, x, tabs, seqlen, norm, scale in (("q", q, tabs_q, sq, norm_q, _LOG2E),
                                               ("k", k, tabs_k, skv, norm_k, 1.0)):
        sb, ss, _ = _check_operand(name, x, heads)
        (cosg, sin, add), rot, tb = _check_tabs(f"tabs_{name}", tabs, seqlen, b, q.device)
        codes = torch.empty(b, seqlen, heads * 64, dtype=torch.int8, device=q.device)
        scales = torch.empty(b, heads // 2, int8_scale_stride(seqlen), dtype=torch.float32,
                             device=q.device)
        keep += [cosg, sin, add, rot, codes, scales]
        sides.append(_QuantArgs(
            x.data_ptr(), codes.data_ptr(), scales.data_ptr(), cosg.data_ptr(), sin.data_ptr(),
            add.data_ptr(), rot.data_ptr(), sb, ss, tb, b, seqlen, heads // 2, int(norm),
            scale, eps))
    a = _Int8Args()
    a.q8, a.qs, a.k8, a.ks = sides[0].codes, sides[0].scales, sides[1].codes, sides[1].scales
    for name, x in (("v", v), ("o", out)):
        sb, ss, sh = _check_operand(name, x, heads)
        setattr(a, name, x.data_ptr())
        setattr(a, f"{name}_sb", sb)
        setattr(a, f"{name}_ss", ss)
        setattr(a, f"{name}_sh", sh)
    a.bias = _bias_ptr(key_bias, b, skv, keep)
    a.b, a.h, a.sq, a.skv = b, heads, sq, skv
    plan = kv_split_plan(b, heads, sq, skv, 64, _sm_count(q.device.index or 0), splits)
    ws = _split_workspace(plan, b, heads, sq, 64, q.device, keep)
    _build.check_launch(_INT8_ENTRY_POINT, getattr(lib, _INT8_ENTRY_POINT)(
        ctypes.byref(sides[0]), ctypes.byref(sides[1]), ctypes.byref(a), *plan, ws,
        _build.stream_of(q)))
    return out


def _require_cuda(*xs):
    for x in xs:
        if x is not None and not x.is_cuda:
            raise ValueError("mixed CPU and CUDA operands")


# ---------------------------------------------------------------------------
# Entry points: one per TPU kernel
# ---------------------------------------------------------------------------


def fused_attention_joint(q, k, v, tabs_q, tabs_k, key_bias=None, heads: int = None,
                          eps: float = 1e-6, norm_q: bool = True, norm_k: bool = True,
                          with_lse: bool = False):
    """K1, base joint self-attention on merged [B, S, H*64]: both prologues in
    the kernel, optional additive f32 key bias [B, Skv]. ``with_lse`` also
    returns the rows' natural-log logsumexp, f32 [B, H, Sq] (the training
    forward's `with_lse`)."""
    if q.device.type == "cpu":
        qn = apply_prologue_plain(split_heads(q, heads), tabs_q, eps, norm_q)
        kn = apply_prologue_plain(split_heads(k, heads), tabs_k, eps, norm_k)
        res = attention_plain(qn, kn, split_heads(v, heads), _bias_or_zeros(key_bias, k, heads),
                              1.0, with_lse=with_lse)
        return (merge_heads(res[0]), res[1]) if with_lse else merge_heads(res)
    _require_cuda(k, v)
    res = _launch_fused(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k, with_lse)
    fused_attention_joint.launches += 1
    fused_attention_joint.lse_launches += int(with_lse)
    return res


def fused_attention_cross_smallkv(q, k, v, tabs_q, tabs_k, key_bias=None, heads: int = None,
                                  eps: float = 1e-6, norm_q: bool = True, norm_k: bool = True):
    """K2, long q against kv <= 512 (text_video -> vip): both prologues in a
    pass of their own (the k side, which the TPU wrapper runs in XLA,
    included), then the body with one (b, h)'s K and V whole in shared
    memory for a range of q tiles."""
    if q.device.type == "cpu":
        return _fused_plain_merged(q, k, v, _bias_or_zeros(key_bias, k, heads), tabs_q,
                                   tabs_k, heads, eps, norm_q, norm_k)
    _require_cuda(k, v)
    if k.shape[1] > _SMALLKV_MAX:
        raise ValueError(f"fused_attention_cross_smallkv: Skv {k.shape[1]} > {_SMALLKV_MAX}")
    out = _launch_smallkv(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k)
    fused_attention_cross_smallkv.launches += 1
    return out


def fused_attention_cross_smallq(q, k, v, tabs_q, tabs_k, key_bias=None, heads: int = None,
                                 eps: float = 1e-6, norm_q: bool = True, norm_k: bool = True):
    """K3, short q (<= 512) against a long kv (vip -> [text_video‖vip]): both
    prologues in a pass of their own (once per row), then the split-KV body
    and the combine."""
    if q.device.type == "cpu":
        return _fused_plain_merged(q, k, v, _bias_or_zeros(key_bias, k, heads), tabs_q,
                                   tabs_k, heads, eps, norm_q, norm_k)
    _require_cuda(k, v)
    out = _launch_smallq(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k)
    fused_attention_cross_smallq.launches += 1
    return out


def flash_attention_bhsd(q, k, v, key_bias=None, scale: Optional[float] = None,
                         with_lse: bool = False):
    """K4, plain [B, H, S, D] attention with a folded scale and an optional
    additive key bias (the resampler's Perceiver attention); ``with_lse`` as
    in `fused_attention_joint`. The card takes D in `HEAD_DIMS` (another
    raises ValueError); the plain version any D. Float32 operands on the card
    go to `flash_attention_bhsd_f32` (no lse)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_plain(q, k, v, _bias_or_zeros(key_bias, k, None), scale,
                               with_lse=with_lse)
    _require_cuda(k, v)
    if q.dtype == torch.float32:
        if with_lse:
            raise ValueError("flash_attention_bhsd: the float32 K4 writes no lse (there is no "
                             "float32 backward)")
        return flash_attention_bhsd_f32(q, k, v, key_bias, scale)
    res = _launch_bhsd(q, k, v, key_bias, scale, with_lse)
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.lse_launches += int(with_lse)
    return res


def flash_attention_bhsd_f32(q, k, v, key_bias=None, scale: Optional[float] = None):
    """K4 on float32 [B, H, S, D] operands (the DINOv2 encoder's attention),
    D in `F32_HEAD_DIMS` on the card: both products on the tensor cores by
    a 3xTF32 split (float32 accuracy), the softmax in float32; optional
    additive f32 key bias [B, Skv]. The plain version (`attention_plain` in
    float32) any D. Inference only."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_plain(q, k, v, _bias_or_zeros(key_bias, k, None), scale)
    _require_cuda(k, v)
    out = _launch_bhsd_f32(q, k, v, key_bias, scale)
    flash_attention_bhsd_f32.launches += 1
    return out


def attention_backward(q, k, v, g, lse, dsum, key_bias=None, heads: Optional[int] = None,
                       scale: float = 1.0, with_dbias: bool = False):
    """K5, the attention backward from the forward's saved lse: (dq, dk, dv,
    dbias) for ``softmax(scale * q k^T + key_bias) v`` with output gradient
    ``g``. Operands merged [B, S, H*D] (pass ``heads``) or [B, H, S, D], D
    in `HEAD_DIMS` on the card (another raises ValueError; the plain
    version takes any D);
    for the fused-prologue attention they are the PROLOGUED q/k and scale is
    1. ``lse`` (natural log) and ``dsum = rowsum(g * out)`` per head: f32
    [B, H, Sq]. dbias (f32 [B, Skv], summed over heads) is computed only
    ``with_dbias``, else None. On the card at D = 64 and 128 the one-pass
    body adds dq's shares across blocks of keys with TMA reduce-adds in no
    fixed order, so dq (not dk, dv or dbias) may differ from call to call in
    its last bits."""
    if q.device.type == "cpu":
        split = (lambda x: split_heads(x, heads)) if heads is not None else (lambda x: x)
        merge = merge_heads if heads is not None else (lambda x: x)
        dq, dk, dv, dbias = attention_bwd_plain(split(q), split(k), split(v), split(g), lse,
                                                dsum, key_bias, scale)
        return merge(dq), merge(dk), merge(dv), dbias if with_dbias else None
    _require_cuda(k, v, g, lse, dsum, key_bias)
    res = _launch_bwd(q, k, v, g, lse, dsum, key_bias, heads, scale, with_dbias)
    attention_backward.launches += 1
    return res


def fused_attention_joint_int8(q, k, v, tabs_q, tabs_k, key_bias=None, heads: int = None,
                               eps: float = 1e-6, norm_q: bool = True, norm_k: bool = True):
    """K7, base joint self-attention with the score product in int8 (the
    DiT's ``quant_attn``; inference only): K1's function with q and k
    quantized per (row, head pair) after their prologues, on merged
    [B, S, H*64] operands with H even. No lse, no gradient."""
    if heads is None or heads % 2:
        raise ValueError(f"fused_attention_joint_int8: heads must be even, got {heads}")
    if q.device.type == "cpu":
        return attention_fused_int8_plain(q, k, v, _bias_or_zeros(key_bias, k, heads), tabs_q,
                                          tabs_k, heads, eps, norm_q, norm_k)
    _require_cuda(k, v)
    out = _launch_int8(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, norm_q, norm_k)
    fused_attention_joint_int8.launches += 1
    return out


def fused_attention_bhsd(q, k, v, tabs_q, tabs_k, key_bias=None, eps: float = 1e-6,
                        norm_q: bool = True, norm_k: bool = True, with_lse: bool = False):
    """K6, fused-prologue attention on [B, H, S, D] operands given by their
    strides (a merged [B, S, H*D] tensor passes as its `split_heads` view,
    without a copy; the output then comes back in the merged layout): both
    prologues in the kernel, optional additive f32 key bias [B, Skv],
    ``with_lse`` as in `fused_attention_joint`. The card takes D in
    `HEAD_DIMS`; the plain version any D."""
    if q.device.type == "cpu":
        return attention_fused_plain(q, k, v, _bias_or_zeros(key_bias, k, None), tabs_q,
                                     tabs_k, eps, norm_q, norm_k, with_lse)
    _require_cuda(k, v)
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"fused_attention_bhsd: expected [B, H, S, D] with D in "
                         f"{HEAD_DIMS}, got {tuple(q.shape)}")
    res = _launch_fused(q, k, v, key_bias, tabs_q, tabs_k, None, eps, norm_q, norm_k, with_lse)
    fused_attention_bhsd.launches += 1
    fused_attention_bhsd.lse_launches += int(with_lse)
    return res


KERNEL_ENTRY_POINTS = (fused_attention_joint, fused_attention_cross_smallkv,
                       fused_attention_cross_smallq, flash_attention_bhsd, attention_backward,
                       fused_attention_joint_int8, fused_attention_bhsd, flash_attention_bhsd_f32)
LSE_ENTRY_POINTS = (fused_attention_joint, flash_attention_bhsd, fused_attention_bhsd)


def reset_launch_counts():
    for fn in KERNEL_ENTRY_POINTS:
        fn.launches = 0
    for fn in LSE_ENTRY_POINTS:
        fn.lse_launches = 0


reset_launch_counts()


def launch_counts():
    return {fn.__name__: fn.launches for fn in KERNEL_ENTRY_POINTS}


def lse_launch_counts():
    """Launches of K1, K4 and K6 with the logsumexp output (the training
    forward)."""
    return {fn.__name__: fn.lse_launches for fn in LSE_ENTRY_POINTS}


def _bias_or_zeros(key_bias, k, heads):
    b = k.shape[0]
    skv = k.shape[1] if heads is not None else k.shape[2]
    if key_bias is None:
        return torch.zeros(b, skv, dtype=torch.float32, device=k.device)
    return key_bias.float()


# ---------------------------------------------------------------------------
# Gradients: K1 / K4 / K6 forward with lse, K5 backward
# ---------------------------------------------------------------------------


def _row_dsum(g, out, heads: Optional[int]):
    """dsum = rowsum(g * out) per head, f32 [B, H, Sq] (plain torch, as the
    JAX package computes it in XLA)."""
    go = g.float() * out.float()
    if heads is None:
        return go.sum(-1).contiguous()
    b, s, hd = go.shape
    return go.reshape(b, s, heads, hd // heads).sum(-1).transpose(1, 2).contiguous()


def _prologue_grads(leaves, outs):
    """Carries the gradients ``outs`` [(prologued y, dy)] of the prologued
    q / k back through their autograd graphs to ``leaves`` (q, k and the
    tables); None where a leaf needs none."""
    outs = [(y, dy) for y, dy in outs if y.requires_grad]
    wanted = [x for x in leaves if x.requires_grad]
    found = iter(torch.autograd.grad([y for y, _ in outs], wanted, [dy for _, dy in outs],
                                     allow_unused=True) if outs else ())
    return [next(found) if x.requires_grad else None for x in leaves]


class _FusedAttention(torch.autograd.Function):
    """`_flash_packed_diff` with its custom_vjp (`_packed_diff_fwd` /
    `_packed_diff_bwd`). Forward: K1 with lse. Backward: the prologue is
    recomputed with `apply_prologue_plain` under autograd, K5 gives the
    gradients of the prologued qn/kn, v and the key bias, and
    `torch.autograd.grad` carries qn/kn's back through the prologue to q, k
    and the tables (so the qk-norm affine, folded into cosg/Rg/add, and
    per-sample rope tables get theirs)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, heads, eps, norm_q, norm_k, *tabs):
        out, lse = fused_attention_joint(q, k, v, tabs[:4], tabs[4:], key_bias, heads, eps,
                                         norm_q, norm_k, with_lse=True)
        ctx.save_for_backward(q, k, v, key_bias, out, lse, *tabs)
        ctx.cfg = (heads, eps, norm_q, norm_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, out, lse, *tabs = ctx.saved_tensors
        heads, eps, norm_q, norm_k = ctx.cfg
        need = ctx.needs_input_grad
        g = g.contiguous()
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(n)
                      for x, n in zip((q, k, *tabs), (need[0], need[1], *need[8:]))]
            qn = merge_heads(apply_prologue_plain(split_heads(leaves[0], heads),
                                                  tuple(leaves[2:6]), eps, norm_q))
            kn = merge_heads(apply_prologue_plain(split_heads(leaves[1], heads),
                                                  tuple(leaves[6:10]), eps, norm_k))
        dqn, dkn, dv, dbias = attention_backward(
            qn.detach(), kn.detach(), v, g, lse, _row_dsum(g, out, heads), key_bias, heads, 1.0,
            with_dbias=need[3])
        grads = _prologue_grads(leaves, ((qn, dqn), (kn, dkn)))
        return (grads[0], grads[1], dv if need[2] else None, dbias, None, None, None, None,
                *grads[2:])


class _FusedBhsdAttention(torch.autograd.Function):
    """`_flash_fused_diff` with its custom_vjp (`_fused_diff_fwd` /
    `_fused_diff_bwd`) on [B, H, S, D] operands. Forward: K6 with lse.
    Backward: as `_FusedAttention`, the prologue recomputed under autograd,
    K5 on the prologued [B, H, S, D] operands (the JAX package's XLA
    `_blocked_attention_bwd` here), the prologue's gradients by autograd. On
    the card both take D in `HEAD_DIMS` (K6's forward raises on another)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, eps, norm_q, norm_k, *tabs):
        out, lse = fused_attention_bhsd(q, k, v, tabs[:4], tabs[4:], key_bias, eps, norm_q,
                                        norm_k, with_lse=True)
        ctx.save_for_backward(q, k, v, key_bias, out, lse, *tabs)
        ctx.cfg = (eps, norm_q, norm_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, out, lse, *tabs = ctx.saved_tensors
        eps, norm_q, norm_k = ctx.cfg
        need = ctx.needs_input_grad
        g = g.contiguous()
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(n)
                      for x, n in zip((q, k, *tabs), (need[0], need[1], *need[7:]))]
            qn = apply_prologue_plain(leaves[0], tuple(leaves[2:6]), eps, norm_q)
            kn = apply_prologue_plain(leaves[1], tuple(leaves[6:10]), eps, norm_k)
        dqn, dkn, dv, dbias = attention_backward(
            qn.detach(), kn.detach(), v, g, lse, _row_dsum(g, out, None), key_bias, None, 1.0,
            with_dbias=need[3])
        grads = _prologue_grads(leaves, ((qn, dqn), (kn, dkn)))
        return (grads[0], grads[1], dv if need[2] else None, dbias, None, None, None,
                *grads[2:])


class _BhsdAttention(torch.autograd.Function):
    """`_flash_attention_tpu_diff`: forward K4 with lse, backward K5 on
    [B, H, S, D] strides with no prologue (D in `HEAD_DIMS` on the card)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, scale):
        out, lse = flash_attention_bhsd(q, k, v, key_bias, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        g = g.contiguous()
        dq, dk, dv, dbias = attention_backward(q, k, v, g, lse, _row_dsum(g, out, None),
                                               key_bias, None, ctx.scale,
                                               with_dbias=ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None


def _grad_needed(*xs) -> bool:
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs)


# ---------------------------------------------------------------------------
# Public dispatch (same routing as the JAX package)
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, key_bias=None, scale: Optional[float] = None):
    """[B, H, Sq, D] x [B, H, Skv, D] attention (the JAX `flash_attention`):
    K4 (bfloat16 or float32), or its autograd Function when a gradient is
    needed; float32 operands on the card have no backward and raise then."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if _grad_needed(q, k, v, key_bias):
        if q.is_cuda and q.dtype == torch.float32:
            raise ValueError("flash_attention: float32 operands on the card take the float32 K4, "
                             "which has no backward (inference only)")
        return _BhsdAttention.apply(q, k, v, key_bias, scale)
    return flash_attention_bhsd(q, k, v, key_bias, scale)


def _fused_bhsd_route(q, k, v, tabs_q, tabs_k, key_bias, eps, norm_q, norm_k):
    """K6, or `_FusedBhsdAttention` when a gradient is needed, on [B, H, S, D]."""
    if _grad_needed(q, k, v, key_bias, *tabs_q, *tabs_k):
        return _FusedBhsdAttention.apply(q, k, v, key_bias, eps, norm_q, norm_k, *tabs_q,
                                         *tabs_k)
    return fused_attention_bhsd(q, k, v, tabs_q, tabs_k, key_bias, eps, norm_q, norm_k)


def fused_flash_attention(q, k, v, tabs_q, tabs_k, key_bias=None, heads: int = None,
                          eps: float = 1e-6, norm_q: bool = True, norm_k: bool = True,
                          int8_scores: bool = False):
    """Attention with the qk-norm + RoPE prologue fused, on merged
    [B, S, H*D] operands (pass ``heads``) or [B, H, S, D] ones, routed as
    the JAX `_fused_dispatch` routes. Merged operands with even heads and
    D = 64 (the JAX package's packed head-pair kernel) take K1, except the
    one-tiny-side cross shapes, which go to the small-side kernels exactly
    where `_flash_packed_diff` sends them, and, with ``int8_scores``, the
    rest to K7; when a gradient is needed every such shape takes
    `_FusedAttention` (K1 with lse, then K5). Every other call (odd heads,
    other head dims, 4-D operands) runs K6 on the [B, H, S, D] view (merged
    operands are split and the output merged back), or `_FusedBhsdAttention`
    under autograd; ``int8_scores`` does not apply there. The JAX package
    keeps its bf16 fallbacks there too, except at D = 128 with even heads,
    which a TPU sends to its packed kernel, int8 scores included: no
    shipped config has such heads (ROADMAP, deliberate differences)."""
    if q.dim() == 4:
        return _fused_bhsd_route(q, k, v, tabs_q, tabs_k, key_bias, eps, norm_q, norm_k)
    if heads is None or q.dim() != 3:
        raise ValueError("fused_flash_attention takes merged [B, S, H*D] operands with heads, "
                         "or [B, H, S, D] ones")
    if heads % 2 or q.shape[2] != 64 * heads:
        out = _fused_bhsd_route(split_heads(q, heads), split_heads(k, heads),
                                split_heads(v, heads), tabs_q, tabs_k, key_bias, eps, norm_q,
                                norm_k)
        return merge_heads(out)
    if _grad_needed(q, k, v, key_bias, *(tabs_q or ()), *(tabs_k or ())):
        return _FusedAttention.apply(q, k, v, key_bias, heads, eps, norm_q, norm_k,
                                     *tabs_q, *tabs_k)
    sq, skv = q.shape[1], k.shape[1]
    if norm_q and norm_k:
        if skv <= _SMALLKV_MAX and sq > 2048:
            return fused_attention_cross_smallkv(q, k, v, tabs_q, tabs_k, key_bias, heads,
                                                 eps, norm_q, norm_k)
        if sq <= 512 and skv > 2048:
            return fused_attention_cross_smallq(q, k, v, tabs_q, tabs_k, key_bias, heads,
                                                eps, norm_q, norm_k)
    if int8_scores:
        return fused_attention_joint_int8(q, k, v, tabs_q, tabs_k, key_bias, heads, eps,
                                          norm_q, norm_k)
    return fused_attention_joint(q, k, v, tabs_q, tabs_k, key_bias, heads, eps, norm_q, norm_k)

