"""T4b's split-and-reduce in plain torch (kernels/probes.py
`splitkv_partials_maxfree_plain`, `combine_maxfree_plain`): with no running
max the splits' f32 partial sums (acc = bf16(p) v, l = sum p) simply add,
in any order, which is what lets the card's kernel add them into one
accumulator by TMA reduce-add in whatever order its blocks finish. Held to
the shared max-free plain version (`attention_maxfree_plain`) on float32
operands, where neither rounds p or the output, at 1e-5; and T4b's host-side
geometry (`splitkv_smem_bytes`, `splitkv_ws_bytes`) against a block's and an
SM's shared memory. Inputs numpy-seeded; torch only."""

import numpy as np
import pytest
import torch

from tokensgen_tpu_torch.kernels import attention as A
from tokensgen_tpu_torch.kernels import probes as P

D, HEADS, SQ, SKV = 64, 2, 37, 1100  # 1,100 keys: every split size leaves a ragged last split


def _inputs(split, seed):
    """f32 merged operands of 2 batch rows with per-sample tables, a random
    key bias and a -1e9 mask over the whole second split of sample 1."""
    rng = np.random.default_rng(seed)
    b = 2

    def x(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v = x(b, SQ, HEADS * D), x(b, SKV, HEADS * D), x(b, SKV, HEADS * D)

    def tabs(s, fold):
        ang = x(s, D)
        t = A.make_prologue(D, [((ang.cos(), ang.sin()), s)], 1 + 0.1 * x(D), 0.1 * x(D),
                            fold=fold)
        return tuple(z[None].expand(b, *z.shape).clone() * (1 + 0.05 * i) for i, z in
                     enumerate(t[:3])) + (t[3],)

    bias = 0.3 * x(b, SKV)
    bias[1, split:2 * split] = -1e9
    return q, k, v, bias, tabs(SQ, D ** -0.5), tabs(SKV, 1.0)


@pytest.mark.parametrize("split", P.SPLITKV_BLOCK_KV)
def test_splitkv_partials_in_any_order_match_maxfree_plain(split):
    """At each split size: the partials of every split (the last ragged,
    sample 1's second split wholly masked: its l and acc are 0) summed in a
    shuffled order and normalized equal `attention_maxfree_plain` within
    1e-5 relative (f32 sums in another order), at the score shift of these
    tables and bias."""
    q, k, v, bias, tq, tk = _inputs(split, seed=split)
    shift = P.score_shift(tq, tk, bias)
    want = P.attention_maxfree_plain(q, k, v, bias, tq, tk, HEADS, shift)
    parts = P.splitkv_partials_maxfree_plain(q, k, v, bias, tq, tk, HEADS, shift, split)
    assert len(parts) == -(-SKV // split)
    assert parts[1][1][1].abs().max().item() == 0.0  # the masked split adds nothing to sample 1
    order = np.random.default_rng(split + 1).permutation(len(parts))
    got = P.combine_maxfree_plain([parts[i] for i in order], dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def test_splitkv_partials_without_a_split_fail():
    """The planted fault of the card's checks: the sum without the last
    split's partials is not the function."""
    q, k, v, bias, tq, tk = _inputs(512, seed=7)
    shift = P.score_shift(tq, tk, bias)
    want = P.attention_maxfree_plain(q, k, v, bias, tq, tk, HEADS, shift)
    parts = P.splitkv_partials_maxfree_plain(q, k, v, bias, tq, tk, HEADS, shift, 512)
    got = P.combine_maxfree_plain(parts[:-1], dtype=torch.float32)
    assert (got - want).norm() > 1e-2 * want.norm()


@pytest.mark.parametrize("split", P.SPLITKV_BLOCK_KV)
def test_splitkv_smem_fits_a_block(split):
    """T4b's shared memory at each split with two warpgroups fits a block
    (`SMEM_MAX`) and holds whole 128-key tiles; blocks of one warpgroup fit
    two a SM (228 KB, 1 KB reserved a block) at 256 keys only."""
    two = P.splitkv_smem_bytes(split, 2)
    assert two <= P.SMEM_MAX
    assert two - P.splitkv_smem_bytes(split - 128, 2) == 32768  # one K' / V tile more
    one = P.splitkv_smem_bytes(split, 1)
    assert (2 * (one + 1024) <= 233472) == (split == 256)


def test_splitkv_ws_at_the_script_shape():
    """T4b's workspace at the script's cross2 shape (480 q rows x 18,256
    keys, 48 heads): the bf16 prologue rows, then a 6.0 MB accumulator (acc
    and l of one part, reduce-add) against 215.7 MB with one part a split
    of 512 (36 splits: the per-split partials that the reduce-add removes)."""
    b, sq, skv, h = 1, 480, 18256, 48
    pro = b * (sq + skv) * h * 64 * 2
    one = P.splitkv_ws_bytes(b, sq, skv, h)
    assert one - pro == b * h * sq * 65 * 4 == 5_990_400
    assert P.splitkv_ws_bytes(b, sq, skv, h, 36) - pro == 215_654_400
    assert P.splitkv_ws_bytes(1, 3, 5, 1) % 4 == 0  # the accumulator starts f32-aligned
