"""K5's one-pass decomposition on the CPU (`attention_bwd_onepass_plain`, the
card's form: per block of keys, the block's dk, dv and dbias and its share
of dq, the shares summed in f32) held to K5's plain version
`attention_bwd_plain` (1e-5, f32) and to the JAX package: the packed Pallas
backward kernel in interpret mode (`_flash_packed_bwd_tpu`) and `jax.vjp`
of its XLA attention (2e-4, as tests/test_torch_train_attention.py holds the
plain version), at head dims 16, 32, 64 and 128 at the card's cut of each
(`bwd_kv_block`, `bwd_q_tile`, `BWD_Q_SHARES`), on merged and [B, H, S, D]
operands, ragged lengths, with and without a -1e9 key-bias mask; at head
dims 16 and 32 also with the padded-chunk key bias and Sq ragged to the q
tile and under one; at head dim 128 also at the card's q tile of 64 rows,
Sq ragged to it and under one tile; and the per-q-tile table the kernel
reads (`bwd_aux_table`, at every head dim). Inputs are made from a seed
with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.kernels import attention as JA
from tokensgen_tpu_torch.kernels import attention as TA
from tokensgen_tpu_torch.train.t2to import padded_chunk_masks

from _torch_parity import t

TOL = 1e-5  # f32: the one-pass form only regroups the plain version's sums
JAX_TOL = 2e-4  # the JAX kernel's own tolerance against its XLA reference
B, H, SQ, SKV = 2, 2, 203, 300  # ragged against the 128-row q tiles and key blocks


def _case(d: int, masked, seed: int, sq: int = SQ):
    """Merged f32 operands [B, S, H*d], the key bias (``masked``: False, True
    or "chunk", the padded-chunk bias of 12 text keys and 3 frames of 96,
    valid (3, 1)), and the forward's lse and dsum (from the plain
    forward)."""
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, sq, H * d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, SKV, H * d)).astype(np.float32) for _ in range(2))
    bias = np.zeros((B, SKV), np.float32)
    if masked == "chunk":
        bias = padded_chunk_masks(torch.tensor([3, 1]), 3, 96, 12)[0].numpy()
    elif masked:
        bias[1, SKV - 77:] = -1e9  # the last key block and part of the one before
    scale = d ** -0.5
    split = lambda x: TA.split_heads(t(x), H)  # noqa: E731
    out, lse = TA.attention_plain(split(q), split(k), split(v), t(bias), scale, with_lse=True)
    dsum = TA._row_dsum(split(g), out, None)
    return q, k, v, g, bias, scale, lse, dsum


def _operands(xs, layout):
    """The merged arrays as [B, H, S, d]: strided views of the merged
    tensors, or contiguous."""
    views = [TA.split_heads(t(x), H) for x in xs]
    return views if layout == "merged" else [x.contiguous() for x in views]


def _close(got, want, tol):
    for name, x, r in zip(("dq", "dk", "dv", "dbias"), got, want):
        x, r = np.asarray(x, np.float32), np.asarray(r, np.float32)
        assert np.abs(x - r).max() <= tol * np.abs(r).max(), name


def _cut(d: int) -> dict:
    """The card's cut at head dim ``d``: its block of keys, q tile and q
    shares."""
    return dict(kv_block=TA.bwd_kv_block(d), q_tile=TA.bwd_q_tile(d),
                q_shares=TA.BWD_Q_SHARES.get(d, 1))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["merged", "bhsd"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_onepass_matches_bwd_plain(d, layout, masked):
    """The decomposition at the card's cut of ``d`` against
    `attention_bwd_plain` on the same f32 operands: each gradient within
    1e-5 of its largest entry."""
    q, k, v, g, bias, scale, lse, dsum = _case(d, masked, seed=d + masked)
    q4, k4, v4, g4 = _operands((q, k, v, g), layout)
    got = TA.attention_bwd_onepass_plain(q4, k4, v4, g4, lse, dsum, t(bias), scale, **_cut(d))
    want = TA.attention_bwd_plain(q4, k4, v4, g4, lse, dsum, t(bias), scale)
    assert [x.shape for x in got] == [x.shape for x in want]
    _close(got, want, TOL)


@pytest.mark.parametrize("kv_block", [64, 300])
def test_onepass_key_blocks(kv_block):
    """The sum of dq's shares does not depend on the key blocks: one block
    of all 300 keys, and blocks of 64, against `attention_bwd_plain`."""
    q, k, v, g, bias, scale, lse, dsum = _case(64, True, seed=3)
    q4, k4, v4, g4 = _operands((q, k, v, g), "bhsd")
    got = TA.attention_bwd_onepass_plain(q4, k4, v4, g4, lse, dsum, t(bias), scale,
                                         kv_block=kv_block)
    _close(got, TA.attention_bwd_plain(q4, k4, v4, g4, lse, dsum, t(bias), scale), TOL)


@pytest.mark.parametrize("sq", [SQ, 40])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["merged", "bhsd"])
def test_onepass_d128_tile_matches_bwd_plain(layout, masked, sq):
    """At head dim 128 the card's body sweeps q tiles of 64 rows
    (`bwd_q_tile(128)`) and splits each tile's share of dq by d columns
    between its warpgroups: the decomposition at that tile (Sq ragged to it,
    and under one tile) against `attention_bwd_plain`, within 1e-5 of each
    gradient's largest entry."""
    d = 128
    q, k, v, g, bias, scale, lse, dsum = _case(d, masked, seed=40 + masked, sq=sq)
    q4, k4, v4, g4 = _operands((q, k, v, g), layout)
    tile = TA.bwd_q_tile(d)
    assert tile == 64 and TA.bwd_q_tile(64) == TA.BWD_Q_TILE
    got = TA.attention_bwd_onepass_plain(q4, k4, v4, g4, lse, dsum, t(bias), scale, q_tile=tile)
    _close(got, TA.attention_bwd_plain(q4, k4, v4, g4, lse, dsum, t(bias), scale), TOL)


@pytest.mark.parametrize("sq", [SQ, 40, 129])
@pytest.mark.parametrize("masked", [True, "chunk"])
@pytest.mark.parametrize("layout", ["merged", "bhsd"])
@pytest.mark.parametrize("d", [16, 32])
def test_onepass_small_cut_matches_bwd_plain(d, layout, masked, sq):
    """At head dims 16 and 32 the card's body takes 64 keys a warpgroup, q
    tiles of 64 rows and (at 16) two warpgroups a key group, each summing
    every other q tile: the decomposition at that cut, with the -1e9 mask
    and the padded-chunk key bias, Sq ragged to the tile (203, 129) and
    under one (40), Skv (300) ragged to the key groups, against
    `attention_bwd_plain`, within 1e-5 of each gradient's largest entry."""
    q, k, v, g, bias, scale, lse, dsum = _case(d, masked, seed=70 + d + sq, sq=sq)
    q4, k4, v4, g4 = _operands((q, k, v, g), layout)
    got = TA.attention_bwd_onepass_plain(q4, k4, v4, g4, lse, dsum, t(bias), scale, **_cut(d))
    _close(got, TA.attention_bwd_plain(q4, k4, v4, g4, lse, dsum, t(bias), scale), TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_onepass_matches_jax(d, masked):
    """The decomposition at the card's cut of ``d`` on merged operands
    (prologued: q carries the softmax scale, which the backward then takes
    as 1, as the fused attention's backward does) against
    `_flash_packed_bwd_tpu` in interpret mode and `jax.vjp` of
    `_xla_attention`: dq, dk, dv and dbias (summed over heads) within 2e-4."""
    _check_against_jax(d, masked, seed=20 + d + masked, **_cut(d))


@pytest.mark.parametrize("d", [16, 32])
def test_onepass_small_cut_chunk_bias_matches_jax(d):
    """The decomposition at the card's cut of 16 and 32 with the
    padded-chunk key bias against the same JAX references, within 2e-4."""
    _check_against_jax(d, "chunk", seed=80 + d, **_cut(d))


@pytest.mark.parametrize("masked", [False, True])
def test_onepass_d128_tile_matches_jax(masked):
    """The decomposition at head dim 128 and the card's q tile of 64 rows
    against the same JAX references, within 2e-4."""
    _check_against_jax(128, masked, seed=60 + masked, q_tile=TA.bwd_q_tile(128))


def _check_against_jax(d, masked, seed, **cut):
    q, k, v, g, bias, scale, _, _ = _case(d, masked, seed=seed)
    q = q * scale  # prologued: the softmax scale folded into q, as make_prologue folds it
    jq, jk, jv, jg, jb = (jnp.asarray(x) for x in (q, k, v, g, bias))

    def f(q_, k_, v_, b_):
        return JA._merge3(JA._xla_attention(JA._split3(q_, H), JA._split3(k_, H),
                                            JA._split3(v_, H), b_, 1.0))

    out, vjp = jax.vjp(f, jq, jk, jv, jb)
    want = vjp(jg)
    s = jnp.einsum("bhqd,bhkd->bhqk", JA._split3(jq, H), JA._split3(jk, H)) + jb[:, None, None]
    lse = jax.nn.logsumexp(s, axis=-1)  # [B, H, Sq]
    go = (g * np.asarray(out)).reshape(B, SQ, H // 2, 2, d).sum(-1)
    kernel = JA._flash_packed_bwd_tpu(jq, jk, jv, jg, lse.reshape(B, H // 2, 2, SQ),
                                      jnp.asarray(go.transpose(0, 2, 3, 1)), jb, H, 128, 128,
                                      True, interpret=True)
    q4, k4, v4, g4 = _operands((q, k, v, g), "merged")
    dsum = TA._row_dsum(t(g), t(out), H)
    got = TA.attention_bwd_onepass_plain(q4, k4, v4, g4, t(lse), dsum, t(bias), 1.0, **cut)
    got = [TA.merge_heads(x) for x in got[:3]] + [got[3]]
    for name, x, a, r in zip(("dq", "dk", "dv", "dbias"), got, kernel, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(a), rtol=JAX_TOL, atol=JAX_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=JAX_TOL, atol=JAX_TOL,
                                   err_msg=name)


def test_bwd_aux_table():
    """The kernel's per-q-tile table: each tile's lse * log2 e then its dsum,
    padded past Sq with +inf and 0, so that p and ds are 0 on the padding."""
    rng = np.random.default_rng(5)
    lse = t(rng.normal(size=(2, 3, 203)))
    dsum = t(rng.normal(size=(2, 3, 203)))
    aux = TA.bwd_aux_table(lse, dsum)
    assert aux.shape == (6, 2, 2, TA.BWD_Q_TILE) and aux.dtype == torch.float32
    rows = aux.permute(0, 2, 1, 3).reshape(6, 2, 2 * TA.BWD_Q_TILE)
    np.testing.assert_allclose(rows[:, 0, :203].numpy(),
                               (lse * 1.4426950408889634).reshape(6, 203).numpy(), rtol=1e-7)
    np.testing.assert_array_equal(rows[:, 1, :203].numpy(), dsum.reshape(6, 203).numpy())
    assert torch.all(rows[:, 0, 203:] == torch.inf) and torch.all(rows[:, 1, 203:] == 0)


def test_bwd_aux_table_d128_tile():
    """The table at head dim 128's q tile of 64 rows: 4 tiles for 203 rows,
    each tile's lse * log2 e then its dsum, +inf and 0 past Sq."""
    rng = np.random.default_rng(6)
    lse = t(rng.normal(size=(2, 3, 203)))
    dsum = t(rng.normal(size=(2, 3, 203)))
    tile = TA.bwd_q_tile(128)
    aux = TA.bwd_aux_table(lse, dsum, tile)
    assert aux.shape == (6, 4, 2, tile) and aux.dtype == torch.float32
    rows = aux.permute(0, 2, 1, 3).reshape(6, 2, 4 * tile)
    np.testing.assert_allclose(rows[:, 0, :203].numpy(),
                               (lse * 1.4426950408889634).reshape(6, 203).numpy(), rtol=1e-7)
    np.testing.assert_array_equal(rows[:, 1, :203].numpy(), dsum.reshape(6, 203).numpy())
    assert torch.all(rows[:, 0, 203:] == torch.inf) and torch.all(rows[:, 1, 203:] == 0)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bwd_tiles_and_table(d):
    """The card's cut at every head dim (keys a block or warpgroup, q rows a
    tile: 64 and 64 at 16 and 32, 128 and 128 at 64, 128 and 64 at 128) and
    the table the wrapper hands the kernel at that tile: at 16 and 32 an even
    number of tiles (4 for 203 rows), each tile's lse * log2 e then its
    dsum, +inf and 0 past Sq."""
    kv_block, tile = {16: (64, 64), 32: (64, 64), 64: (128, 128), 128: (128, 64)}[d]
    assert (TA.bwd_kv_block(d), TA.bwd_q_tile(d)) == (kv_block, tile)
    rng = np.random.default_rng(7 + d)
    lse = t(rng.normal(size=(2, 3, 203)))
    dsum = t(rng.normal(size=(2, 3, 203)))
    aux = TA.bwd_aux_table(lse, dsum, tile, 2 if d in TA.SMALL_HEAD_DIMS else 1)
    nq = 4 if d in (16, 32) else -(-203 // tile)
    assert aux.shape == (6, nq, 2, tile) and aux.dtype == torch.float32
    rows = aux.permute(0, 2, 1, 3).reshape(6, 2, nq * tile)
    np.testing.assert_allclose(rows[:, 0, :203].numpy(),
                               (lse * 1.4426950408889634).reshape(6, 203).numpy(), rtol=1e-7)
    np.testing.assert_array_equal(rows[:, 1, :203].numpy(), dsum.reshape(6, 203).numpy())
    assert torch.all(rows[:, 0, 203:] == torch.inf) and torch.all(rows[:, 1, 203:] == 0)
