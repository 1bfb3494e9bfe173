"""Probe kernels: hand-written Hopper counterparts of the Pallas probes under
the JAX package's ``tools/``, with their plain PyTorch versions.

The JAX package wrote these probes to measure the TPU's ceilings: a flash
kernel's tile sweep, last-tile-only masking, the int8 against the bf16 rate
inside a flash loop, a hand GEMM against the compiler's, the exp2 throughput,
and structural variants of the attention kernels K1-K3 with a max-free
softmax. Here they measure the card's, as inputs to making the attention
kernels fast. Ten entry points, one per TPU kernel, each with a launch
counter (``fn.launches``):

=======================  ==========================================================  ====
entry point              replaces (the JAX package's tools/)                         #
=======================  ==========================================================  ====
attention_sweep          `bench_attn_sweep.py` `_tpu` :73 (K4's `_flash_kernel`)      T1
attention_v2             `bench_attn_v2.py` `_kernel_v2` :23                          T2
attention_splitpv        `bench_attn_r3.py` `_packed_kernel_splitpv` :62              T3a
attention_pair2          `bench_attn_r3.py` `_packed_kernel_pair2` :231               T3b
cross_smallkv_pairinner  `bench_cross_r3.py` `_smallkv_kernel` :84                    T4a
cross_smallq_splitkv     `bench_cross_r3.py` `_smallq_kernel` :200                    T4b
cross_smallkv_pairloop   `bench_cross_pairloop.py` `_smallkv_pairloop_kernel` :33     T5
flash_loop               `bench_pallas_int8.py` `_flash_like_kernel` :29              T6
matmul_hand              `bench_matmul_pallas.py` `_mm_kernel` :27                    T7
exp2_loop                `bench_vpu_exp2.py` `make_kernel` :30                        T8
=======================  ==========================================================  ====

T3a-T5 share their plain version, `attention_maxfree_plain`, and the score
shift C of their softmax, `score_shift` (no running max: exp2(min(s - C, 0))).
Each computes the JAX function; the tiles are the card's (`SWEEP_CONFIGS`,
`SPLITKV_BLOCK_KV`, ...), not the TPU's. A CPU tensor takes the plain version
beside the entry point; a CUDA tensor launches the kernel (CUDA C++ for
sm_90a in ``csrc/probes.cu`` and, T7's, ``csrc/probe_gemm.cu``, built by nvcc
at first use, `kernels/build.py`) or raises. T1, T2 (T1's kernels), T4a and
T4b (``csrc/probes_hopper.cuh``), T3a, T3b and T5
(``csrc/probes_maxfree.cuh``), T6 (k and v resident per key split,
`flash_loop_split`) and T7 are Hopper bodies: TMA (T6's int8: once-per-block
transposing) loads and wgmma products; T8 has no products.
The CLIs of ``tokensgen_tpu_torch/tools/`` drive them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tokensgen_tpu_torch.kernels import attention as A
from tokensgen_tpu_torch.kernels import build as _build

# T1's tile axes on the card (csrc/probes_hopper.cuh): block_q q rows a block
# (two warpgroups of 64 rows, at 256 two row blocks each), block_kv keys a K /
# V tile (the score product's N; 64 would give both products one wgmma
# shape), hblk heads a block (at 2 a warpgroup's two chains are two heads)
SWEEP_AXES = {"block_q": (128, 256), "block_kv": (128, 192), "hblk": (1, 2)}
# the combinations built in csrc/probes.cu (TG_SWEEP_CONFIGS): every one at
# block_kv 192 spilled its registers (ptxas, two of them also serializing
# their wgmmas), and (256, *, 2) would hold four chains a warpgroup
SWEEP_CONFIGS = ((128, 128, 1), (128, 128, 2), (256, 128, 1))
SWEEP_DEFAULT = (128, 128, 2)  # the fastest at the script's shape (PERF.md), the smoke's
SWEEP_MAX_SLOTS = 4  # csrc SW_MAX_SLOTS
SMEM_MAX = 232448  # shared memory a block may use on an H100
BIAS_MODES = ("full", "last")  # T2 (at T1's tiles): key bias on every kv tile, or only on the last
FLASH_LOOP_D = 128  # T6: the head dim the kernel is built for
FLASH_LOOP_TILE = 64  # T6: keys the planted fault leaves out of the first step (a bf16 chunk)
FLASH_LOOP_ROWS = 64  # T6: q rows a block (csrc FL_ROWS), one warpgroup a chain
# T6: keys a score product (csrc LoopGeom CHUNK) and the most a block holds
# resident (MAX_SPLIT), by dtype: int8 chunks of 128 (m64n128k32), bf16 of 64
FLASH_LOOP_CHUNK = {torch.int8: 128, torch.bfloat16: 64}
FLASH_LOOP_MAX_SPLIT = {torch.int8: 512, torch.bfloat16: 256}
MATMUL_BK = 64  # T7: the kernel's k tile (csrc GM_BK)
# T7's output tiles (csrc GM_BM x GM_BN) and the row tiles of a raster group
# (GM_GROUP): `matmul_tiles` gives their order
MATMUL_TILE = (128, 256)
MATMUL_GROUP = 8
EXP2_OPS = ("mul", "exp2", "exp2_add")  # T8
SHIFT_CAP = 120.0  # T3a-T5: the cap of the score shift C (log2 units), as the scripts'
SPLITPV_CONFIGS = ((128, 128), (64, 128))  # T3a: (q rows per head, keys per tile)
PAIR2_BLOCK_KV = (128,)  # T3b: keys per tile (csrc MF_BN)
PAIR2_BLOCK_Q = 128  # T3b: q rows a block (csrc P2_BM)
PAIRINNER_BLOCK_Q = (512, 1024, 2048)  # T4a: q rows per block
PAIRINNER_DEFAULT = 512  # T4a: the fastest block_q at the script's shape (PERF.md), the smoke's
PAIRINNER_SLOTS = 2  # T4a: q boxes of 64 rows a warpgroup (csrc PI_SLOTS)
SPLITKV_BLOCK_KV = (256, 384, 512)  # T4b: keys per split (whole K' / V tiles of 128)
SPLITKV_DEFAULT = 256  # T4b: the fastest split at the script's shape (PERF.md), the smoke's
# T5 cuts its work in units of (batch row, row block of PAIRLOOP_ROWS q rows,
# head), head fastest, and a block takes a contiguous range of them
# (`pairloop_plan`): ``block_q`` = PAIRLOOP_WAVE spreads the units evenly over
# one wave of blocks, one a SM (6,672 units of 51 or 50 at the script's
# 17,776 rows on 132 SMs); a multiple of PAIRLOOP_ROWS gives each block that
# many full-width rows (the script's 1,024 and 2,048; 128 / 256 / 512 give
# 139 / 70 / 35 blocks at 17,776 rows)
PAIRLOOP_ROWS = 128  # csrc PL_RB
PAIRLOOP_WAVE = 0
PAIRLOOP_BLOCK_Q = (PAIRLOOP_WAVE, 128, 256, 512, 1024, 2048)
RESIDENT_MAX = 512  # T4a / T4b: keys held whole in shared memory (csrc PI_MAX_KEYS)


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


def flash_loop_split(m: int, n: int, dtype: torch.dtype, sms: int) -> int:
    """T6's keys a block (csrc ``split``): the multiple of the dtype's chunk,
    up to what a block holds, with the least modelled time. The blocks (one
    a SM: ceil(n / split) x ceil(m / 64)) run in waves of ``sms``, each block
    a step's 2 split / 128 units of products (q @ k and p @ v over 128 keys
    each count 1) plus the chain's q @ k[:, :128] (1)."""
    chunk, most = FLASH_LOOP_CHUNK[dtype], FLASH_LOOP_MAX_SPLIT[dtype]
    rows = -(-m // FLASH_LOOP_ROWS)
    best = None
    for split in range(chunk, most + 1, chunk):
        waves = -(-(-(-n // split) * rows) // sms)
        cost = waves * (2 * split / 128 + 1)
        if best is None or cost < best[0]:
            best = (cost, split)
    return best[1]


def flash_loop_split_plain(q, k, v, iters: int, split: int):
    """T6's key-split form (csrc ``flash_loop_kernel``) on the host: per split
    of ``split`` keys and per chain, the chain's q stepped by the split's own
    product q @ k[:, :d] (the recomputed chain, as every block computes it),
    the split's acc += requant(q @ k_split) @ v_split, added into the
    workspace [2 chains][m][d] (int64 then wrapped to int32 for int8, f32
    for bf16); out = f32(ws_a + ws_b), the int32 sum wrapped first. The
    arithmetic of `flash_loop_plain`, which it equals (int8 bit for bit)."""
    d = q.shape[1]
    int8 = q.dtype == torch.int8
    work = torch.float64 if int8 else torch.float32
    ws = torch.zeros(2, q.shape[0], d, dtype=torch.int64 if int8 else torch.float32,
                     device=q.device)
    kw, vw = k.to(work), v.to(work)
    for n0 in range(0, k.shape[1], split):
        ks, vs = kw[:, n0:n0 + split], vw[n0:n0 + split]
        for chain in range(2):
            qc = q
            acc = torch.zeros_like(ws[chain])
            for _ in range(iters):
                s, sc = qc.to(work) @ ks, qc.to(work) @ kw[:, :d]
                if int8:
                    p = torch.clamp(s.long() >> 7, -127, 127)
                    qc = torch.clamp(sc.long() >> 7, -127, 127)
                else:
                    p = (s * (1.0 / 64.0)).bfloat16()
                    qc = (sc * (1.0 / 64.0)).bfloat16()
                pv = p.to(work) @ vs
                acc = acc + (pv.long() if int8 else pv)
            ws[chain] += _wrap_int32(acc) if int8 else acc
    return _wrap_int32(ws[0] + ws[1]).float() if int8 else ws[0] + ws[1]


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


def score_shift(tabs_q, tabs_k, key_bias=None) -> torch.Tensor:
    """The static score shift C of the max-free probes (T3a-T5), f32 0-dim:
    C = min(B_q B_k + max(max(key_bias log2 e), 0), `SHIFT_CAP`), as their
    wrappers compute it (`run_splitpv`, tools/bench_attn_r3.py:162-169;
    `run_smallkv`, tools/bench_cross_r3.py:136-142;
    `cross_smallkv_pairloop`, tools/bench_cross_pairloop.py:98-102). B is the JAX package's
    `_tabs_score_bound` (tokensgen_tpu/kernels/attention.py:563), a bound on
    the L2 norm of any prologued row, taken as there on the head-pair packed
    tables (`_pack_tabs` :749: the tables doubled to 2D wide, Rg
    block-diagonal: √2 the bound of the unpacked ones), the q side's scaled by
    log2 e. The wrappers' padded rows (`_pad_tabs` :313) are zero rows, whose
    bound 0 never raises the max, so they are left out."""
    def bound(tabs, scale):
        cosg, sin, add, rg = (x.float() for x in tabs)
        z = torch.zeros_like(rg)
        arg = torch.cat([torch.cat([rg, z], 1), torch.cat([z, rg], 1)], 0).abs()
        acg, asn, aad = (torch.cat([x, x], -1).mul(scale).abs() for x in (cosg, sin, add))
        c1 = (acg + asn * arg.sum(0)).amax(-1)  # ||M||_1 per position
        cinf = (acg + asn @ arg.T).amax(-1)  # ||M||_inf per position
        d2 = torch.tensor(float(arg.shape[0]), device=arg.device)
        row = torch.sqrt(d2) * torch.sqrt(c1 * cinf) + torch.sqrt((aad * aad).sum(-1))
        return row.max()

    c = bound(tabs_q, A._LOG2E) * bound(tabs_k, 1.0)
    if key_bias is not None:
        c = c + torch.clamp_min((key_bias.float() * A._LOG2E).max(), 0.0)
    return torch.clamp_max(c, SHIFT_CAP)


def pairloop_plan(batch: int, sq: int, heads: int, block_q: int, sms: int):
    """T5's launch: (units a block, blocks). A unit is (batch row, row block
    of `PAIRLOOP_ROWS` q rows, head); ``block_q`` = `PAIRLOOP_WAVE` spreads
    them over ``sms`` blocks (the fewest blocks of the same makespan), a
    multiple of `PAIRLOOP_ROWS` gives each block block_q full-width rows."""
    units = batch * -(-sq // PAIRLOOP_ROWS) * heads
    if block_q == PAIRLOOP_WAVE:
        per = -(-units // sms)
    elif block_q > 0 and block_q % PAIRLOOP_ROWS == 0:
        per = block_q // PAIRLOOP_ROWS * heads
    else:
        raise ValueError(f"pairloop_plan: block_q {PAIRLOOP_WAVE} or a multiple of "
                         f"{PAIRLOOP_ROWS}, got {block_q}")
    return per, -(-units // per)


def sweep_smem_bytes(block_q: int, block_kv: int, hblk: int) -> int:
    """T1's dynamic shared memory at a tile (csrc `SweepGeom::SMEM`): 1 KB
    of alignment slack, the q tile (hblk heads x block_q rows of 128 bytes),
    as many K / V slots (the K and V tiles of hblk heads, and the tile's
    block_kv + 4 f32 key biases from a 16-byte boundary, in a box of
    whole 128 bytes) as fit, up to `SWEEP_MAX_SLOTS`, and their
    mbarriers and q's."""
    qbytes = hblk * block_q * 128
    slot = hblk * 2 * block_kv * 128 + -(-(block_kv + 4) * 4 // 128) * 128
    slots = min(SWEEP_MAX_SLOTS, (SMEM_MAX - 1024 - qbytes - 8 * (2 * SWEEP_MAX_SLOTS + 1)) // slot)
    return 1024 + qbytes + slots * slot + 8 * (2 * slots + 1)


def pairinner_smem_bytes(skv: int) -> int:
    """T4a's dynamic shared memory for ``skv`` keys (csrc
    `pairinner_smem_bytes`): 1 KB of alignment slack, the resident K' / V
    tiles of 128 keys (32 KB each), each warpgroup's `PAIRINNER_SLOTS` q
    boxes and output staging box (8 KB each), the tiles' mbarriers and the q
    slots'."""
    tiles = -(-skv // 128)
    return 1024 + tiles * 32768 + 2 * (PAIRINNER_SLOTS + 1) * 8192 + 8 * (4 + 2 * PAIRINNER_SLOTS)


def splitkv_smem_bytes(split: int, warpgroups: int = 2) -> int:
    """T4b's dynamic shared memory at ``split`` keys a split (csrc
    `resident_smem_bytes` with its f32 staging): 1 KB of alignment slack, the
    split's resident K' / V tiles of 128 keys (32 KB each), each
    warpgroup's `PAIRINNER_SLOTS` q boxes (8 KB each) and its staging of a
    chunk's f32 acc (16 KB) and row sums (a 1 KB box), the tiles' mbarriers
    and the q slots'."""
    tiles = -(-split // 128)
    return (1024 + tiles * 32768 + warpgroups * (PAIRINNER_SLOTS * 8192 + 2 * 8192 + 1024)
            + 8 * (4 + warpgroups * PAIRINNER_SLOTS))


def splitkv_ws_bytes(batch: int, sq: int, skv: int, heads: int, parts: int = 1) -> int:
    """T4b's workspace (csrc `launch_splitkv`): the bf16 prologue rows of k
    and q (B (Skv + Sq) H 64), rounded up to 256 bytes, then the f32
    accumulator of ``parts`` partial sums ([parts][B H][Sq][64]) and row sums
    ([parts][B H][Sq], rows padded to a multiple of 4 for their tensor map):
    one part where the splits add into it by TMA reduce-add, else one a
    split."""
    pro = -(-batch * (sq + skv) * heads * 64 * 2 // 256) * 256
    return pro + parts * batch * heads * (sq * 64 + -(-sq // 4) * 4) * 4


def pairinner_waves(batch: int, sq: int, heads: int, block_q: int, sms: int, per_sm: int = 1):
    """T4a's launch: (blocks, waves, the idle share of the last wave's
    block slots). One block per (head, q block of ``block_q`` rows, batch
    row); ``per_sm`` blocks resident a SM."""
    blocks = heads * -(-sq // block_q) * batch
    slots = sms * per_sm
    waves = blocks / slots
    tail = blocks % slots
    return blocks, waves, (slots - tail) / slots if tail else 0.0


def matmul_tiles(m: int, n: int):
    """T7's `MATMUL_TILE` output tiles of an [m, n] product in the kernel's
    order (csrc `tile_coords`): (row tile, column tile) of tile id 0, 1, ...;
    block i of a grid of G takes ids i, i + G, ... Row tiles go in groups of
    `MATMUL_GROUP`, column by column within a group, so that the tiles in
    flight share rows of a and columns of b in L2."""
    tm, tn = -(-m // MATMUL_TILE[0]), -(-n // MATMUL_TILE[1])
    per = MATMUL_GROUP * tn
    order = []
    for t in range(tm * tn):
        first = t // per * MATMUL_GROUP
        rows = min(tm - first, MATMUL_GROUP)
        r = t % per
        order.append((first + r % rows, r // rows))
    return order


def _maxfree_operands(q, k, v, key_bias, tabs_q, tabs_k, heads: int, shift, eps: float,
                      k_prologued: bool = False):
    """`attention_maxfree_plain`'s operands, [B, H, S, 64]: qn, kn, v and the
    shifted key bias in the log2 domain [B, Skv]."""
    cosg, sin, add, rg = tabs_q
    qn = A._prologue32(A.split_heads(q, heads), (cosg * A._LOG2E, sin * A._LOG2E,
                                                 add * A._LOG2E, rg), eps, True).to(q.dtype)
    kh = A.split_heads(k, heads)
    kn = kh if k_prologued else A.apply_prologue_plain(kh, tabs_k, eps, True)
    bias = A._bias_or_zeros(key_bias, k, heads) * A._LOG2E - float(shift)
    return qn, kn, A.split_heads(v, heads), bias


def splitkv_partials_maxfree_plain(q, k, v, key_bias, tabs_q, tabs_k, heads: int, shift, split: int,
                                   eps: float = 1e-6):
    """T4b's split pass in plain torch: for each split of ``split`` keys the
    unnormalized f32 partial sums of `attention_maxfree_plain` over its keys,
    acc = bf16(p) v [B, H, Sq, 64] and l = sum p [B, H, Sq]. With no running
    max the splits' partials simply add: `combine_maxfree_plain`."""
    qn, kn, vh, bias = _maxfree_operands(q, k, v, key_bias, tabs_q, tabs_k, heads, shift, eps)
    parts = []
    for j in range(0, k.shape[1], split):
        s = torch.einsum("bhqd,bhkd->bhqk", qn.float(), kn[:, :, j:j + split].float())
        s.add_(bias[:, None, None, j:j + split]).clamp_max_(0.0).exp2_()
        parts.append((torch.einsum("bhqk,bhkd->bhqd", s.to(v.dtype).float(),
                                   vh[:, :, j:j + split].float()), s.sum(-1)))
    return parts


def combine_maxfree_plain(parts, dtype=torch.bfloat16):
    """The sum of T4b's partials (`splitkv_partials_maxfree_plain`, in the
    given order) normalized, acc / max(l, f32 tiny), merged [B, Sq, H*64]."""
    acc = sum(p[0] for p in parts)
    l = sum(p[1] for p in parts).clamp_min(torch.finfo(torch.float32).tiny)
    return A.merge_heads((acc / l[..., None]).to(dtype))


def attention_maxfree_plain(q, k, v, key_bias, tabs_q, tabs_k, heads: int, shift,
                            eps: float = 1e-6, k_prologued: bool = False):
    """The plain version of the five max-free probes (T3a, T3b, T4a, T4b, T5), on
    merged [B, S, H*64] operands: qn = bf16(prologue(q)) with log2 e folded
    into q's tables, kn = bf16(prologue(k)) (``k_prologued``: ``k`` is kn
    already, as T4a's wrapper makes it), s = qn kn^T + key_bias log2 e -
    ``shift``, p = exp2(min(s, 0)) in f32, l = sum p, out = (bf16(p) v) /
    max(l, f32 tiny). Both prologues normalize. In q-row chunks under
    `attention.MAX_SCORE_BYTES`."""
    qn, kn, vh, bias = _maxfree_operands(q, k, v, key_bias, tabs_q, tabs_k, heads, shift, eps,
                                         k_prologued)
    b, h, sq, _ = qn.shape
    chunk = A._q_chunk(b, h, sq, k.shape[1])
    kf, vf = kn.float(), vh.float()
    tiny = torch.finfo(torch.float32).tiny
    outs = []
    for i in range(0, sq, chunk):
        s = torch.einsum("bhqd,bhkd->bhqk", qn[:, :, i:i + chunk].float(), kf)
        s.add_(bias[:, None, None, :]).clamp_max_(0.0).exp2_()
        l = s.sum(-1, keepdim=True).clamp_min_(tiny)
        outs.append((torch.einsum("bhqk,bhkd->bhqd", s.to(v.dtype).float(), vf) / l).to(q.dtype))
    return A.merge_heads(torch.cat(outs, dim=2))


# ---------------------------------------------------------------------------
# Build and bind csrc/probes.cu
# ---------------------------------------------------------------------------


class _FlashLoopArgs(ctypes.Structure):
    """Mirror of `TGFlashLoopArgs` in csrc/probes.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "out")]
                + [(n, ctypes.c_int64) for n in ("m", "n", "iters")])


class _MatmulArgs(ctypes.Structure):
    """Mirror of `TGMatmulArgs` in csrc/probe_gemm.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("a", "b", "c")]
                + [(n, ctypes.c_int64) for n in ("m", "k", "n")])


def _bind(lib) -> None:
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    _build.bind(lib, "tg_probe_attn_sweep", ctypes.POINTER(A._Args), i64, i64, i64, ptr)
    _build.bind(lib, "tg_probe_attn_v2", ctypes.POINTER(A._Args), i64, i64, i64, i64, ptr)
    _build.bind(lib, "tg_probe_flash_loop", ctypes.POINTER(_FlashLoopArgs), i64, i64, ptr, ptr)
    _build.bind(lib, "tg_probe_exp2_loop", ptr, ptr, i64, i64, i64, ptr)
    for name in _MAXFREE_ENTRY_POINTS:
        _build.bind(lib, name, ctypes.POINTER(A._Args), i64, i64, ctypes.c_float, ptr, ptr)
    _build.bind(lib, "tg_probe_splitpv_geometry", i64, ctypes.POINTER(i64))
    _build.bind(lib, "tg_probe_sweep_geometry", i64, i64, i64, ctypes.POINTER(i64))
    _build.bind(lib, "tg_probe_pairinner_geometry", i64, ctypes.POINTER(i64))
    _build.bind(lib, "tg_probe_splitkv_geometry", i64, ctypes.POINTER(i64))


def _bind_gemm(lib) -> None:
    _build.bind(lib, "tg_probe_matmul", ctypes.POINTER(_MatmulArgs), ctypes.c_void_p)
    _build.bind(lib, "tg_probe_matmul_geometry", ctypes.POINTER(ctypes.c_int64))


_MAXFREE_ENTRY_POINTS = ("tg_probe_attn_splitpv", "tg_probe_attn_pair2",
                         "tg_probe_cross_pairinner", "tg_probe_cross_splitkv",
                         "tg_probe_cross_pairloop")


_Library = _build.KernelLibrary("probes.cu", _bind)
_GemmLibrary = _build.KernelLibrary("probe_gemm.cu", _bind_gemm)  # T7


def build_probes(force: bool = False):
    """Compile csrc/probes.cu and csrc/probe_gemm.cu for sm_90a (each cached
    by source hash) and load them; their paths."""
    return _Library.build(force), _GemmLibrary.build(force)


MATMUL_GEOMETRY = ("tile_rows", "tile_cols", "k_tile", "stages", "threads", "smem_bytes",
                   "raster_group")


def matmul_geometry() -> dict:
    """T7's build (csrc/probe_gemm.cu's constants and its dynamic shared
    memory), by the names of `MATMUL_GEOMETRY`. Builds the library."""
    out = (ctypes.c_int64 * len(MATMUL_GEOMETRY))()
    _build.check_launch("tg_probe_matmul_geometry", _GemmLibrary.get().tg_probe_matmul_geometry(out))
    return dict(zip(MATMUL_GEOMETRY, out))


def splitpv_geometry(block_q: int) -> dict:
    """T3a's build at ``block_q``: threads, dynamic shared memory (bytes),
    K / V slots and q rows a block. Builds the library."""
    out = (ctypes.c_int64 * 4)()
    _build.check_launch("tg_probe_splitpv_geometry",
                        _Library.get().tg_probe_splitpv_geometry(block_q, out))
    return dict(zip(("threads", "smem_bytes", "slots", "block_q"), out))


SWEEP_GEOMETRY = ("threads", "smem_bytes", "slots", "block_q", "block_kv", "hblk", "chains",
                  "blocks_per_sm")


def sweep_geometry(block_q: int, block_kv: int, hblk: int) -> dict:
    """T1's build at a tile of `SWEEP_CONFIGS`, by the names of
    `SWEEP_GEOMETRY`: threads, dynamic shared memory (bytes), K / V slots,
    the tile, chains a warpgroup and resident blocks a SM. Builds the
    library."""
    out = (ctypes.c_int64 * len(SWEEP_GEOMETRY))()
    _build.check_launch("tg_probe_sweep_geometry", _Library.get().tg_probe_sweep_geometry(
        block_q, block_kv, hblk, out))
    return dict(zip(SWEEP_GEOMETRY, out))


PAIRINNER_GEOMETRY = ("threads", "smem_bytes", "q_slots", "kv_tiles", "blocks_per_sm",
                      "prologue_pass")


def pairinner_geometry(skv: int) -> dict:
    """T4a's build for ``skv`` keys (<= `RESIDENT_MAX`), by the names of
    `PAIRINNER_GEOMETRY`: threads, dynamic shared memory (bytes), q slots a
    warpgroup, resident K' / V tiles, resident blocks a SM, and 1 where q's
    prologue runs as a pass of its own (the build's choice; 0: in place in
    the body). Builds the library."""
    out = (ctypes.c_int64 * len(PAIRINNER_GEOMETRY))()
    _build.check_launch("tg_probe_pairinner_geometry",
                        _Library.get().tg_probe_pairinner_geometry(skv, out))
    return dict(zip(PAIRINNER_GEOMETRY, out))


SPLITKV_GEOMETRY = ("threads", "smem_bytes", "kv_tiles", "q_slots", "blocks_per_sm",
                    "warpgroups", "reduce")


def splitkv_geometry(split: int) -> dict:
    """T4b's build at ``split`` keys a split (`SPLITKV_BLOCK_KV`), by the
    names of `SPLITKV_GEOMETRY`: threads, dynamic shared memory (bytes),
    resident K' / V tiles, q slots a warpgroup, resident blocks a SM,
    warpgroups a block, and 1 where the splits' partials are added into one
    accumulator by TMA reduce-add (the build's choice; 0: one a split,
    summed by the last pass). Builds the library."""
    out = (ctypes.c_int64 * len(SPLITKV_GEOMETRY))()
    _build.check_launch("tg_probe_splitkv_geometry",
                        _Library.get().tg_probe_splitkv_geometry(split, out))
    return dict(zip(SPLITKV_GEOMETRY, out))


def _launch_attn(entry: str, q, k, v, key_bias, *params: int):
    d = q.shape[-1]
    if d != 64:
        raise ValueError(f"{entry}: head dim 64, got {d}")
    a, out, _keep = A.attn_args(q, k, v, key_bias, None, None, None, 0.0, False, False,
                                d ** -0.5 * A._LOG2E)  # _keep: alive through the launch
    _build.check_launch(entry, getattr(_Library.get(), entry)(ctypes.byref(a), *params,
                                                              _build.stream_of(q)))
    return out


def _launch_maxfree(entry: str, q, k, v, key_bias, tabs_q, tabs_k, heads: int, eps: float,
                    shift, p0: int, p1: int = 0, ws_bytes: int = 0, prologue_rows: bool = False,
                    q_rows: bool = False):
    """Launches one of T3a-T5 on merged [B, S, H*64] bf16 operands (k
    prologued in the kernel when ``tabs_k`` is given) with the score shift
    as its own float; T4b gets its workspace of ``ws_bytes``
    (`splitkv_ws_bytes`: the prologue rows, then the f32 accumulator), T3a
    and T3b (``prologue_rows``) their bf16 workspace of the prologued k and
    q rows, T4a (``q_rows``) its bf16 workspace of the prologued q rows.
    Workspaces are freed with the call."""
    a, out, _keep = A.attn_args(q, k, v, key_bias, tabs_q, tabs_k, heads, eps, True,
                                tabs_k is not None, A._LOG2E)  # _keep: alive through the launch
    ws = None
    if ws_bytes:
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device)
    elif prologue_rows or q_rows:
        rows = a.sq + (a.skv if prologue_rows else 0)
        ws = torch.empty(a.b * rows * heads * 64, dtype=torch.bfloat16, device=q.device)
    _build.check_launch(entry, getattr(_Library.get(), entry)(
        ctypes.byref(a), p0, p1, float(shift), None if ws is None else ws.data_ptr(),
        _build.stream_of(q)))
    return out


# ---------------------------------------------------------------------------
# Entry points: one per TPU kernel
# ---------------------------------------------------------------------------


def attention_sweep(q, k, v, key_bias=None, block_q: int = SWEEP_DEFAULT[0],
                    block_kv: int = SWEEP_DEFAULT[1], hblk: int = SWEEP_DEFAULT[2]):
    """T1, K4's function on [B, H, S, 64] bf16 at explicit tiles: ``block_q``
    q rows per block, ``block_kv`` keys per tile, ``hblk`` heads per block
    (`SWEEP_CONFIGS`, on the axes of `SWEEP_AXES`); optional f32 key bias
    [B, Skv] on every tile. On the card q, K and V tiles come by TMA (16-byte
    aligned operands), both products run on wgmma, and the softmax scale
    and the bias join the FFMA that subtracts the running max (q is not
    rounded with the scale, as the plain version does not round it)."""
    if q.device.type == "cpu":
        return attention_sweep_plain(q, k, v, key_bias)
    A._require_cuda(k, v, key_bias)
    if (block_q, block_kv, hblk) not in SWEEP_CONFIGS:
        raise ValueError(f"attention_sweep: ({block_q}, {block_kv}, {hblk}) not built; "
                         f"expected one of {SWEEP_CONFIGS}")
    out = _launch_attn("tg_probe_attn_sweep", q, k, v, key_bias, block_q, block_kv, hblk)
    attention_sweep.launches += 1
    return out


def attention_v2(q, k, v, key_bias=None, block_q: int = SWEEP_DEFAULT[0],
                 block_kv: int = SWEEP_DEFAULT[1], bias_mode: str = "last",
                 hblk: int = SWEEP_DEFAULT[2]):
    """T2, flash attention on [B, H, S, 64] bf16 with the key bias applied on
    every kv tile ("full") or only on the last ("last"; the ragged-kv mask
    applies there either way), at T1's tiles (`SWEEP_CONFIGS`: block_q,
    block_kv, hblk). On the card both modes run T1's kernel at that tile:
    "full" is T1's launch itself; "last" loads the biases (by TMA) and adds
    them only on the last kv tile, every other tile taking the bias-free
    softmax."""
    if bias_mode not in BIAS_MODES:
        raise ValueError(f"bias_mode: expected one of {BIAS_MODES}, got {bias_mode!r}")
    if q.device.type == "cpu":
        return attention_v2_plain(q, k, v, key_bias, block_kv, bias_mode)
    A._require_cuda(k, v, key_bias)
    if (block_q, block_kv, hblk) not in SWEEP_CONFIGS:
        raise ValueError(f"attention_v2: ({block_q}, {block_kv}, {hblk}) not built; expected one "
                         f"of {SWEEP_CONFIGS}")
    out = _launch_attn("tg_probe_attn_v2", q, k, v, key_bias, block_q, block_kv, hblk,
                       BIAS_MODES.index(bias_mode))
    attention_v2.launches += 1
    return out


def flash_loop(q, k, v, iters: int):
    """T6, the chained flash inner loop: q [m, d], k [d, n], v [n, d], all
    bf16 (f32 sums) or all int8 (int32 sums); out f32 [m, d]. The card takes
    d = 128 and n a multiple of 16, n >= d. On the card a block holds 64
    rows and `flash_loop_split` keys of k and v in shared memory for all the
    steps, each warpgroup one chain, and recomputes the chain's q itself
    from k[:, :128]; the splits' partial sums meet in a workspace
    (`flash_loop_split_plain` is that form on the host)."""
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
    int8 = q.dtype == torch.int8
    split = flash_loop_split(m, n, q.dtype,
                             torch.cuda.get_device_properties(q.device).multi_processor_count)
    ws = torch.zeros(2, m, d, dtype=torch.int32 if int8 else torch.float32, device=q.device)
    a = _FlashLoopArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m, n, iters)
    _build.check_launch("tg_probe_flash_loop", _Library.get().tg_probe_flash_loop(
        ctypes.byref(a), int(int8), split, ws.data_ptr(), _build.stream_of(q)))
    flash_loop.launches += 1
    return out


def matmul_hand(x, y):
    """T7, bf16(x @ y) with an f32 accumulator: x [M, K], y [K, N] bf16; the
    card takes K and N multiples of 8 and 16-byte aligned operands (ragged
    tiles read zeros and are clipped). On the card one block an SM walks
    the `MATMUL_TILE` output tiles in `matmul_tiles`' order: a and b come
    by TMA in k tiles of `MATMUL_BK` through a ring of shared-memory slots,
    two warpgroups multiply by wgmma into f32 registers, and each tile goes
    out as bf16 by TMA stores (csrc/probe_gemm.cu)."""
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
    if (x.data_ptr() | y.data_ptr()) % 16:
        raise ValueError("matmul_hand: operands 16-byte aligned (the kernel loads by TMA)")
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    a = _MatmulArgs(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, kdim, n)
    _build.check_launch("tg_probe_matmul", _GemmLibrary.get().tg_probe_matmul(
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


def attention_splitpv(q, k, v, key_bias, tabs_q, tabs_k, heads: int, block_q: int = 128,
                      block_kv: int = 128, eps: float = 1e-6, shift=None):
    """T3a, K1's function max-free (`run_splitpv`): joint attention on
    merged [B, S, H*64] bf16, optional f32 key bias [B, Skv], softmax as
    exp2(min(s - C, 0)) with C = `score_shift` (pass ``shift`` to reuse one
    computed for these tables and bias). H even. Both prologues run first,
    once per row, into a bf16 workspace (K1's prologue pass); then each
    block owns ``block_q`` q rows of one head pair, one warpgroup a head:
    each K / V tile of ``block_kv`` keys holds both heads' columns, and
    each warpgroup multiplies its own half, scores and p.v (the split p@v),
    its ``block_q`` rows as two alternating row blocks of 64 at 128, one at
    64 (`SPLITPV_CONFIGS`)."""
    shift = score_shift(tabs_q, tabs_k, key_bias) if shift is None else shift
    if q.device.type == "cpu":
        return attention_maxfree_plain(q, k, v, key_bias, tabs_q, tabs_k, heads, shift, eps)
    A._require_cuda(k, v, key_bias)
    if (block_q, block_kv) not in SPLITPV_CONFIGS or heads % 2:
        raise ValueError(f"attention_splitpv: even heads and (block_q, block_kv) in "
                         f"{SPLITPV_CONFIGS}, got heads={heads}, ({block_q}, {block_kv})")
    out = _launch_maxfree("tg_probe_attn_splitpv", q, k, v, key_bias, tabs_q, tabs_k, heads,
                          eps, shift, block_q, block_kv, prologue_rows=True)
    attention_splitpv.launches += 1
    return out


def attention_pair2(q, k, v, key_bias, tabs_q, tabs_k, heads: int, block_kv: int = 128,
                    eps: float = 1e-6, shift=None):
    """T3b, `attention_splitpv`'s function (`run_pair2`) with two head pairs
    (4 heads) per block of 128 q rows. Both prologues run first, once per
    row, into a bf16 workspace (K1's prologue pass); then a block runs two
    passes over the keys, in each one head of each pair as its two
    independent chains: each warpgroup (64 rows) issues one chain's score
    product with the other chain's p.v. H a multiple of 4; kv tiles of
    ``block_kv`` (`PAIR2_BLOCK_KV`)."""
    shift = score_shift(tabs_q, tabs_k, key_bias) if shift is None else shift
    if q.device.type == "cpu":
        return attention_maxfree_plain(q, k, v, key_bias, tabs_q, tabs_k, heads, shift, eps)
    A._require_cuda(k, v, key_bias)
    if block_kv not in PAIR2_BLOCK_KV or heads % 4:
        raise ValueError(f"attention_pair2: heads a multiple of 4 and block_kv in "
                         f"{PAIR2_BLOCK_KV}, got heads={heads}, block_kv={block_kv}")
    out = _launch_maxfree("tg_probe_attn_pair2", q, k, v, key_bias, tabs_q, tabs_k, heads, eps,
                          shift, block_kv, prologue_rows=True)
    attention_pair2.launches += 1
    return out


def cross_smallkv_pairinner(q, k, v, key_bias, tabs_q, tabs_k, heads: int,
                            block_q: int = PAIRINNER_DEFAULT, eps: float = 1e-6, shift=None):
    """T4a, K2's function max-free (`run_smallkv`): long q against at most
    `RESIDENT_MAX` keys. k's prologue runs here in plain torch with the
    unpacked tables (as the wrapper runs it in XLA); in the kernel K' and V
    of one head sit whole in shared memory (by TMA) against ``block_q`` q
    rows (`PAIRINNER_BLOCK_Q`), the head fastest in the grid (the JAX grid's
    pair innermost); q's prologue runs first, once per row, into a bf16
    workspace (K1's prologue pass), and each warpgroup takes 64-row chunks
    of q' by TMA and multiplies by wgmma."""
    shift = score_shift(tabs_q, tabs_k, key_bias) if shift is None else shift
    kn = A.merge_heads(A.apply_prologue_plain(A.split_heads(k, heads), tabs_k, eps, True))
    if q.device.type == "cpu":
        return attention_maxfree_plain(q, kn, v, key_bias, tabs_q, tabs_k, heads, shift, eps,
                                       k_prologued=True)
    A._require_cuda(k, v, key_bias)
    if block_q not in PAIRINNER_BLOCK_Q or k.shape[1] > RESIDENT_MAX:
        raise ValueError(f"cross_smallkv_pairinner: Skv <= {RESIDENT_MAX} and block_q in "
                         f"{PAIRINNER_BLOCK_Q}, got Skv {k.shape[1]}, block_q={block_q}")
    out = pairinner_prologued(q, kn, v, key_bias, tabs_q, heads, shift, block_q, eps)
    cross_smallkv_pairinner.launches += 1
    return out


def pairinner_prologued(q, kn, v, key_bias, tabs_q, heads: int, shift,
                        block_q: int = PAIRINNER_DEFAULT, eps: float = 1e-6):
    """T4a's kernel alone, on k already prologued (``kn``), uncounted: what
    the CLI, the smoke and the ablations time apart from the wrapper's
    plain-torch k prologue. CUDA tensors only."""
    return _launch_maxfree("tg_probe_cross_pairinner", q, kn, v, key_bias, tabs_q, None, heads,
                           eps, shift, block_q, q_rows=True)


def cross_smallkv_pairloop(q, k, v, key_bias, tabs_q, tabs_k, heads: int,
                           block_q: int = PAIRLOOP_WAVE, eps: float = 1e-6, shift=None):
    """T5, `cross_smallkv_pairinner`'s function (the JAX script's
    `cross_smallkv_pairloop`) with no head axis in the grid: a block owns a
    contiguous range of (row block of `PAIRLOOP_ROWS` q rows, head) units,
    head fastest, so full-width rows of q and of the output with their heads
    in order (``block_q`` in `PAIRLOOP_BLOCK_Q`, `pairloop_plan`: by default
    one wave of blocks). Per head each warpgroup loads its 64 rows' columns
    of q and prologues them in shared memory, while the head's prologued K
    and V stream through a ring of 128-key tiles that runs on into the next
    head (all heads' K and V, which the TPU kernel keeps resident, do not
    fit an SM). k's prologue runs here in plain torch with the unpacked
    tables, as the script's wrapper runs it in XLA; any Skv."""
    shift = score_shift(tabs_q, tabs_k, key_bias) if shift is None else shift
    kn = A.merge_heads(A.apply_prologue_plain(A.split_heads(k, heads), tabs_k, eps, True))
    if q.device.type == "cpu":
        return attention_maxfree_plain(q, kn, v, key_bias, tabs_q, tabs_k, heads, shift, eps,
                                       k_prologued=True)
    A._require_cuda(k, v, key_bias)
    if block_q not in PAIRLOOP_BLOCK_Q:
        raise ValueError(f"cross_smallkv_pairloop: block_q in {PAIRLOOP_BLOCK_Q}, got {block_q}")
    out = pairloop_prologued(q, kn, v, key_bias, tabs_q, heads, shift, block_q, eps)
    cross_smallkv_pairloop.launches += 1
    return out


def pairloop_prologued(q, kn, v, key_bias, tabs_q, heads: int, shift, block_q: int = PAIRLOOP_WAVE,
                       eps: float = 1e-6):
    """T5's kernel alone, on k already prologued (``kn``), uncounted: what
    the CLI and the smoke time apart from the wrapper's plain-torch k
    prologue. CUDA tensors only."""
    per, _ = pairloop_plan(q.shape[0], q.shape[1], heads, block_q,
                           torch.cuda.get_device_properties(q.device).multi_processor_count)
    return _launch_maxfree("tg_probe_cross_pairloop", q, kn, v, key_bias, tabs_q, None, heads,
                           eps, shift, per)


def cross_smallq_splitkv(q, k, v, key_bias, tabs_q, tabs_k, heads: int,
                         block_kv: int = SPLITKV_DEFAULT, eps: float = 1e-6, shift=None):
    """T4b, K3's function max-free (`run_smallq`): short q against a long kv.
    Both prologues run first, once per row, into a bf16 workspace (K1's
    prologue pass). The keys are split in ``block_kv`` (`SPLITKV_BLOCK_KV`);
    a block per (split, head, batch row) holds its split's K' and V whole in
    shared memory (TMA) and runs every q' row against them in 64-row chunks
    (T4a's resident body: wgmma products), adding each chunk's f32 partial
    sums and row sums into one zeroed accumulator by TMA reduce-add; a last
    pass writes sum(acc) / max(sum(l), tiny): with no running max there is
    nothing to rescale, so the splits' partials simply add (in an order that
    varies from call to call: the last bits may too). The JAX kernel
    carries the same sums across its kv sweep."""
    shift = score_shift(tabs_q, tabs_k, key_bias) if shift is None else shift
    if q.device.type == "cpu":
        return attention_maxfree_plain(q, k, v, key_bias, tabs_q, tabs_k, heads, shift, eps)
    A._require_cuda(k, v, key_bias)
    if block_kv not in SPLITKV_BLOCK_KV:
        raise ValueError(f"cross_smallq_splitkv: block_kv in {SPLITKV_BLOCK_KV}, got {block_kv}")
    parts = 1 if splitkv_geometry(block_kv)["reduce"] else -(-k.shape[1] // block_kv)
    out = _launch_maxfree("tg_probe_cross_splitkv", q, k, v, key_bias, tabs_q, tabs_k, heads,
                          eps, shift, block_kv,
                          ws_bytes=splitkv_ws_bytes(q.shape[0], q.shape[1], k.shape[1], heads,
                                                    parts))
    cross_smallq_splitkv.launches += 1
    return out


PROBE_ENTRY_POINTS = (attention_sweep, attention_v2, flash_loop, matmul_hand, exp2_loop,
                      attention_splitpv, attention_pair2, cross_smallkv_pairinner,
                      cross_smallq_splitkv, cross_smallkv_pairloop)


def reset_launch_counts():
    for fn in PROBE_ENTRY_POINTS:
        fn.launches = 0


reset_launch_counts()


def launch_counts():
    return {fn.__name__: fn.launches for fn in PROBE_ENTRY_POINTS}
