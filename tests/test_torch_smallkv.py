"""K2's card path (`fused_attention_cross_smallkv`: the prologue pass of k
and of q with log2 e folded in, then the K / V-resident body's online
softmax over 128-key tiles) in its plain version on the CPU
(`cross_smallkv_plain`), held to the JAX package's XLA reference
(`_xla_attention_fused`, 1e-5) and to the Pallas K2 in interpret mode
(`_flash_cross_smallkv_tpu`) at 100, 480 and 512 keys, with and without a
key-bias mask; and the body's split of the q tiles over the blocks
(`smallkv_tiles_per_block`). Inputs are made from a seed with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest

from tokensgen_tpu.kernels import attention as JA
from tokensgen_tpu_torch.kernels import attention as TA

from _torch_parity import t

D = 64
XLA_TOL = 1e-5  # f32: the online softmax over key tiles only reorders the sums
# f32 against the Pallas K2 in interpret mode, whose max-free exp2 shifts
# the scores by a bound from the tables instead of the row maximum: measured
# 4.0e-6 at most on these inputs (the Pallas kernel sits as far from XLA)
PALLAS_TOL = 2e-4
B, H, SQ = 2, 4, 600  # 600 q rows: ragged against the body's 256-row tiles


def _tables(rng, s, fold):
    """JAX and port tables for one side (per-sample rope angles after a text
    prefix of 5 rows, a LayerNorm gain and shift)."""
    g = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    sh = (0.1 * rng.normal(size=(D,))).astype(np.float32)
    ang = rng.normal(size=(B, s - 5, D)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    jt = JA.make_prologue(D, [(None, 5), ((jnp.asarray(cos), jnp.asarray(sin)), s - 5)],
                          jnp.asarray(g), jnp.asarray(sh), fold=fold)
    tt = TA.make_prologue(D, [(None, 5), ((t(cos), t(sin)), s - 5)], t(g), t(sh), fold=fold)
    return jt, tt


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("skv", [100, 480, 512])
def test_smallkv_plain_matches_jax(skv, masked):
    """`cross_smallkv_plain` on merged f32 operands against the XLA fused
    attention (1e-5) and the Pallas K2 in interpret mode (2e-4)."""
    rng = np.random.default_rng(skv + masked)
    q = rng.normal(size=(B, SQ, H * D)).astype(np.float32)
    k, v = (rng.normal(size=(B, skv, H * D)).astype(np.float32) for _ in range(2))
    bias = np.zeros((B, skv), np.float32)
    if masked:
        bias[1, : skv // 3] = -1e9
    jq, tq = _tables(rng, SQ, D ** -0.5)
    jk, tk = _tables(rng, skv, 1.0)
    got = TA.cross_smallkv_plain(t(q), t(k), t(v), t(bias), tq, tk, H, 1e-6, True, True).numpy()
    xla = JA._merge3(JA._xla_attention_fused(
        JA._split3(jnp.asarray(q), H), JA._split3(jnp.asarray(k), H), JA._split3(jnp.asarray(v), H),
        jnp.asarray(bias), jq, jk, 1e-6, True, True))
    np.testing.assert_allclose(got, np.asarray(xla), rtol=XLA_TOL, atol=XLA_TOL)
    pallas = JA._flash_cross_smallkv_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(bias), jq, jk, H, 256, 1e-6, True, True,
                                         interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=PALLAS_TOL, atol=PALLAS_TOL)


@pytest.mark.parametrize("b,h,sq,sms", [(2, 48, 17776, 132), (1, 4, 600, 132), (3, 2, 9442, 7)])
def test_smallkv_tiles_per_block(b, h, sq, sms):
    """One wave: the q tiles of 256 rows, (b, h)-major, split into at most
    ``sms`` contiguous ranges of equal length (the last one shorter)."""
    tiles = b * h * -(-sq // TA.SMALLKV_BLOCK_Q)
    per = TA.smallkv_tiles_per_block(b, h, sq, sms)
    blocks = -(-tiles // per)
    assert blocks <= sms and per * blocks >= tiles and per * (blocks - 1) < tiles
    assert per == 1 or -(-tiles // (per - 1)) > sms
