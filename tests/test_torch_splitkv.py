"""The pieces of K3's and K4's split-KV forward that the card runs, in their
plain versions on the CPU: the split pass and the combine
(`splitkv_partials_plain`, `combine_plain`) against plain attention and the
JAX package's `_xla_attention`, the split plan (`kv_split_plan`) at the edit
path's shapes and the card tests' shapes, and K3's prologue pass
(`prologue_pass_plain`) against the per-head prologue. Inputs are made from a
seed with numpy, in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.kernels import attention as JA
from tokensgen_tpu_torch.kernels import attention as TA

# f32 throughout: the split form only reorders the softmax's sums
# (exp2 per split, rescaled by 2^(m_s - m)), ~1e-7 relative in f32
TOL = 1e-5
H100_SMS = 132


def _qkv(d, sq=70, skv=517, b=2, h=3, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32))
                 for s in (sq, skv, skv))


def _masked_bias(b, skv, split_len, splits):
    """Zeros, but on sample 1 a -1e9 bias over a whole split (the second of
    several; at one split the first third of the keys)."""
    bias = torch.zeros(b, skv)
    if splits > 1:
        bias[1, split_len:2 * split_len] = -1e9
    else:
        bias[1, : skv // 3] = -1e9
    return bias


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_combine_of_split_partials_matches_attention(d, splits):
    """Per-split (acc, m, l), then the combine, against `attention_plain`
    and its lse: 517 keys in ranges of whole kv tiles with a ragged last
    one, one range masked whole by a -1e9 bias on one sample."""
    q, k, v = _qkv(d)
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    n, split_len = TA.kv_split_plan(b, h, sq, skv, d, H100_SMS, splits)
    assert n == splits and skv % split_len != 0
    bias = _masked_bias(b, skv, split_len, n)
    scale = d ** -0.5
    out, lse = TA.combine_plain(*TA.splitkv_partials_plain(q, k, v, bias, scale, split_len))
    ref, ref_lse = TA.attention_plain(q, k, v, bias, scale, with_lse=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("splits", [2, 5])
def test_combine_matches_jax_reference_attention(splits):
    """The split form against the JAX package's plain attention
    (`_xla_attention`, what `_flash_attention_tpu` computes) on the same
    inputs, with a range masked whole."""
    q, k, v = _qkv(64, seed=1)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    n, split_len = TA.kv_split_plan(b, h, sq, skv, d, H100_SMS, splits)
    bias = _masked_bias(b, skv, split_len, n)
    out, _ = TA.combine_plain(*TA.splitkv_partials_plain(q, k, v, bias, 0.125, split_len))
    ref = JA._xla_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v, bias)), 0.125)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_dropping_a_split_is_caught():
    """The smoke's planted fault (the last split's partial left out of the
    combine) moves the output far outside the kernels' bounds."""
    q, k, v = _qkv(64, seed=2)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    _, split_len = TA.kv_split_plan(b, h, sq, skv, d, H100_SMS, 2)
    acc, m, l = TA.splitkv_partials_plain(q, k, v, torch.zeros(b, skv), 0.125, split_len)
    out, _ = TA.combine_plain(acc[:-1], m[:-1], l[:-1])
    ref = TA.attention_plain(q, k, v, torch.zeros(b, skv), 0.125)
    assert ((out - ref).norm() / ref.norm()).item() > 0.1


# (B, H, Sq, Skv, D): the edit path's K3 and K4 calls, K4 at its other head
# dims at the same width, and the card tests' shapes
PLAN_SHAPES = [
    (2, 48, 480, 18256, 64),
    (1, 16, 384, 17934, 64),
    (1, 8, 384, 17934, 128),
    (1, 32, 384, 17934, 32),
    (1, 64, 384, 17934, 16),
    (2, 4, 130, 2200, 64),
    (2, 4, 130, 517, 64),
    (2, 3, 300, 517, 16),
    (1, 1, 5, 3, 64),
]


def _ranges(skv, splits, split_len):
    return [(s * split_len, min(skv, (s + 1) * split_len)) for s in range(splits)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("forced", [None, 1, 2, 5])
def test_split_plan_covers_the_keys(shape, forced):
    """Every split but the last holds a whole number of kv tiles (128 keys at
    d <= 64, 64 at 128), the last at least one key, and together they cover
    the keys exactly once."""
    b, h, sq, skv, d = shape
    splits, split_len = TA.kv_split_plan(b, h, sq, skv, d, H100_SMS, forced)
    assert splits >= 1 and split_len % TA.kv_tile(d) == 0 and split_len > 0
    if forced is not None:
        assert splits <= forced
    ranges = _ranges(skv, splits, split_len)
    assert ranges[0][0] == 0 and ranges[-1][1] == skv
    assert all(lo < hi for lo, hi in ranges)
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(ranges, ranges[1:]))


def test_split_plan_depends_on_the_shape_alone():
    """The plan is a function of (B, H, Sq, Skv, D, SMs): the same shape
    gives the same splits, whatever was planned before (so K4 with and
    without its lse runs the same ranges). At the edit path's two calls it
    keeps the partials within the L2 and fills at least 96% of the SMs in
    each wave it runs (K3: 2 splits, 384 blocks in 3 waves; K4: 4 splits,
    128 blocks in one)."""
    plans = [TA.kv_split_plan(*s, H100_SMS) for s in PLAN_SHAPES]
    assert plans == [TA.kv_split_plan(*s, H100_SMS) for s in reversed(PLAN_SHAPES)][::-1]
    for (b, h, sq, skv, d), (splits, _) in zip(PLAN_SHAPES[:2], plans[:2]):
        blocks = -(-sq // TA.split_block_q(d)) * h * b * splits
        assert blocks >= 0.96 * H100_SMS * -(-blocks // H100_SMS)
        assert splits * b * h * sq * (d + 2) * 4 <= TA.SPLIT_WS_BYTES
    assert plans[0] == (2, 9216) and plans[1] == (4, 4608)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("batched", [False, True])
def test_prologue_pass_matches_per_head_prologue(normalize, batched):
    """K3's prologue pass on merged [B, S, H*64] (the tables shared by the
    heads, log2 e folded in after the prologue) against
    `apply_prologue_plain` per head with log2 e folded into the tables."""
    rng = np.random.default_rng(3)
    b, s, h, d, text = 2, 41, 3, 64, 5
    x = torch.from_numpy(rng.normal(size=(b, s, h * d)).astype(np.float32))
    ang_shape = (b, s - text, d) if batched else (s - text, d)
    ang = torch.from_numpy(rng.normal(size=ang_shape).astype(np.float32))
    g = torch.from_numpy((1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32))
    bb = torch.from_numpy((0.1 * rng.normal(size=(d,))).astype(np.float32))
    tabs = TA.make_prologue(d, [(None, text), ((ang.cos(), ang.sin()), s - text)], g, bb,
                            fold=d ** -0.5)
    log2e = 1.4426950408889634
    out = TA.prologue_pass_plain(x, tabs, h, 1e-6, normalize, log2e)
    folded = (tabs[0] * log2e, tabs[1] * log2e, tabs[2] * log2e, tabs[3])
    ref = TA.merge_heads(TA.apply_prologue_plain(TA.split_heads(x, h), folded, 1e-6, normalize))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


def test_bench_splitkv_cli_on_cpu(capsys):
    """The split sweep's CLI on the host: per shape the plan and the modelled
    cost of each split count (the kernels themselves run on the card alone)."""
    from tokensgen_tpu_torch.tools import bench_splitkv

    assert bench_splitkv.main(["--device", "cpu", "--max-splits", "6"]) == 0
    out = capsys.readouterr().out
    assert "K4 [1, 16, 384, 64] x 17,934: plan (4, 4608); 1: " in out
    assert "K3 [2, 48, 480, 64] x 18,256: plan (2, 9216); 1: " in out
    assert "| 4*: " in out and "| 2*: " in out
