"""The pieces of K1's and K6's card path (`fused_attention_joint`,
`fused_attention_bhsd`) in their plain versions on the CPU, held to the JAX
package: the prologue pass (`prologue_pass_plain`) at head dims 16-128 on
merged operands and on [B, H, S, D] views against `_apply_prologue_xla` per
head; the pass, then the split partials and their combine
(`splitkv_partials_plain`, `combine_plain`) against `_xla_attention_fused`
and the Pallas kernels in interpret mode (`_flash_fused_packed_tpu`,
`_flash_fused_tpu`), with a key-bias mask and per-sample tables; the split
plan at K1's and K6's shapes. Inputs are made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.kernels import attention as JA
from tokensgen_tpu_torch.kernels import attention as TA

from _torch_parity import t

TOL = 1e-5  # f32: the split form only reorders the softmax's sums
# f32 against the packed Pallas kernel (K1's): 2e-4, the JAX package's own
# tolerance for it; in interpret mode it sits 6.8e-5 from `_xla_attention_fused`
# on these inputs (its max-free softmax and matrix-product LayerNorm)
PACKED_TOL = 2e-4
H100_SMS = 132


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _tables(rng, s, d, batch, text, fold):
    """JAX and port tables [(B,) S, d]: random rope angles after an identity
    text prefix, a random LayerNorm gain and shift."""
    g = (1.0 + 0.2 * rng.normal(size=(d,))).astype(np.float32)
    sh = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    ang = rng.normal(size=((batch,) if batch else ()) + (s - text, d)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    jt = JA.make_prologue(d, [(None, text), ((jnp.asarray(cos), jnp.asarray(sin)), s - text)],
                          jnp.asarray(g), jnp.asarray(sh), fold=fold)
    tt = TA.make_prologue(d, [(None, text), ((t(cos), t(sin)), s - text)], t(g), t(sh), fold=fold)
    return jt, tt


def _operand(x: np.ndarray, layout: str, heads: int, dtype):
    """A merged [B, S, H*d] array as the port's operand: merged, the
    [B, H, S, d] view of the merged tensor (K6's strides), or contiguous
    [B, H, S, d]."""
    xt = t(x, dtype)
    if layout == "merged":
        return xt
    view = TA.split_heads(xt, heads)
    return view if layout == "view" else view.contiguous()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("layout", ["merged", "view", "contiguous"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_prologue_pass_matches_jax_prologue(d, layout, normalize, dtype):
    """The pass on merged [B, S, H*d] operands and on [B, H, S, d] ones
    (strided views or contiguous), shared tables at d = 16 / 64 and
    per-sample ones at 32 / 128, with and without the LayerNorm, against
    JAX `_apply_prologue_xla` per head, merged: 1e-5 in f32, one bf16 ulp in
    bf16 (both round the f32 prologue once)."""
    rng = np.random.default_rng(d)
    b, s, h = 2, 203, 3
    x = rng.normal(size=(b, s, h * d)).astype(np.float32)
    jt, tt = _tables(rng, s, d, b if d in (32, 128) else None, 11, 1.0)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    out = TA.prologue_pass_plain(_operand(x, layout, h, tdt), tt,
                                 h if layout == "merged" else None, 1e-6, normalize)
    assert out.shape == (b, s, h * d) and out.is_contiguous() and out.dtype == tdt
    xj = jnp.asarray(x, jdt).reshape(b, s, h, d).transpose(0, 2, 1, 3)
    ref = np.asarray(JA._apply_prologue_xla(xj, jt, 1e-6, normalize).astype(jnp.float32))
    ref = ref.transpose(0, 2, 1, 3).reshape(b, s, h * d)
    got = out.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    else:
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref))


# (kernel, heads, head dim, Sq, Skv): K1 on merged operands, K6 on views of
# merged ones (d = 16) and on contiguous [B, H, S, d] (d = 128)
COMPOSITION_CASES = [("K1", 2, 64, 300, 700), ("K6", 3, 16, 222, 517), ("K6", 2, 128, 200, 451)]


def _composition_inputs(h, d, sq, skv, seed):
    """Merged f32 operands [2, S, h*d] and per-sample JAX / port tables."""
    rng = np.random.default_rng(seed)
    b = 2
    q, k, v = (rng.normal(size=(b, s, h * d)).astype(np.float32) for s in (sq, skv, skv))
    (jq, tq), (jk, tk) = (_tables(rng, s, d, b, 13, fold) for s, fold in
                          ((sq, d ** -0.5), (skv, 1.0)))
    return (q, k, v), (jq, tq), (jk, tk)


def _masked_bias(b, skv, split_len, splits):
    """Zeros, but on sample 1 a -1e9 bias over the second split of several
    (at one split, over the first third of the keys)."""
    bias = np.zeros((b, skv), np.float32)
    if splits > 1:
        bias[1, split_len:2 * split_len] = -1e9
    else:
        bias[1, : skv // 3] = -1e9
    return bias


def _card_path_plain(q, k, v, bias, tq, tk, h, layout, split_len, dtype):
    """What the card runs, in its plain pieces: the prologue pass of q and
    k into merged workspaces, the split partials over ranges of
    ``split_len`` keys, the combine. Returns (out [B, H, Sq, d], lse)."""
    qs, ks, vs = (_operand(x, layout, h, dtype) for x in (q, k, v))
    heads = h if layout == "merged" else None
    qp = TA.split_heads(TA.prologue_pass_plain(qs, tq, heads, 1e-6, True), h)
    kp = TA.split_heads(TA.prologue_pass_plain(ks, tk, heads, 1e-6, True), h)
    v4 = TA.split_heads(vs, h) if layout == "merged" else vs
    acc, m, l = TA.splitkv_partials_plain(qp, kp, v4, t(bias), 1.0, split_len)
    out, lse = TA.combine_plain(acc, m, l)
    return out.to(dtype), lse


def _jax_reference(q, k, v, bias, jq, jk, h, jdt):
    """JAX `_xla_attention_fused` on the [B, H, S, d] operands and the
    natural-log logsumexp of its scores, f32 numpy."""
    qj, kj, vj = (jnp.asarray(x, jdt).reshape(x.shape[0], x.shape[1], h, -1).transpose(0, 2, 1, 3)
                  for x in (q, k, v))
    out = JA._xla_attention_fused(qj, kj, vj, jnp.asarray(bias), jq, jk, 1e-6, True, True)
    qn = JA._apply_prologue_xla(qj, jq, 1e-6, True).astype(jnp.float32)
    kn = JA._apply_prologue_xla(kj, jk, 1e-6, True).astype(jnp.float32)
    s = jnp.einsum("bhqd,bhkd->bhqk", qn, kn) + jnp.asarray(bias)[:, None, None, :]
    return np.asarray(out.astype(jnp.float32)), np.asarray(jax.nn.logsumexp(s, axis=-1))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("case", COMPOSITION_CASES, ids=lambda c: f"{c[0]}-d{c[2]}")
def test_prologue_pass_splits_and_combine_match_jax(case, splits, dtype):
    """Prologue pass -> split partials -> combine at 1 and 3 splits (ragged
    last split, one of them masked whole by a -1e9 bias on one sample),
    per-sample tables, against JAX `_xla_attention_fused` (the output) and
    the logsumexp of its scores (the lse): 1e-5 in f32; in bf16 within 2
    bf16 ulps of the output's largest magnitude."""
    kernel, h, d, sq, skv = case
    (q, k, v), (jq, tq), (jk, tk) = _composition_inputs(h, d, sq, skv, seed=d + splits)
    b = q.shape[0]
    n, split_len = TA.kv_split_plan(b, h, sq, skv, d, H100_SMS, splits)
    assert n == splits and skv % split_len != 0
    bias = _masked_bias(b, skv, split_len, n)
    layout = "merged" if kernel == "K1" else ("view" if d == 16 else "contiguous")
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    out, lse = _card_path_plain(q, k, v, bias, tq, tk, h, layout, split_len, tdt)
    ref, ref_lse = _jax_reference(q, k, v, bias, jq, jk, h, jdt)
    got = out.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
        np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=TOL, atol=TOL)
    else:
        assert np.abs(got - ref).max() <= 2 * _bf16_ulp(np.abs(ref).max())
        assert np.abs(lse.numpy() - ref_lse).max() <= 2 * _bf16_ulp(np.abs(ref_lse).max())


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("case", COMPOSITION_CASES, ids=lambda c: f"{c[0]}-d{c[2]}")
def test_prologue_pass_splits_and_combine_match_pallas_interpret(case, splits):
    """The same composition in f32 against the Pallas kernels in interpret
    mode: K6's `_flash_fused_tpu` (the output) within 1e-5; K1's
    `_flash_fused_packed_tpu` (its output and its lse, head pairs unpacked)
    within PACKED_TOL, the packed kernel's own distance from JAX's XLA
    reference (6.8e-5 here)."""
    kernel, h, d, sq, skv = case
    (q, k, v), (jq, tq), (jk, tk) = _composition_inputs(h, d, sq, skv, seed=7 + d)
    b = q.shape[0]
    n, split_len = TA.kv_split_plan(b, h, sq, skv, d, H100_SMS, splits)
    bias = _masked_bias(b, skv, split_len, n)
    layout = "merged" if kernel == "K1" else ("view" if d == 16 else "contiguous")
    out, lse = _card_path_plain(q, k, v, bias, tq, tk, h, layout, split_len, torch.float32)
    if kernel == "K1":
        ref, ref_lse = JA._flash_fused_packed_tpu(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), jq, jk, h, 128,
            256, True, 1e-6, True, True, interpret=True, with_lse=True)
        ref = np.asarray(ref).reshape(b, sq, h, d).transpose(0, 2, 1, 3)
        ref_lse = np.asarray(ref_lse).reshape(b, h, -1)[:, :, :sq]
        np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=PACKED_TOL, atol=PACKED_TOL)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=PACKED_TOL)
    else:
        q4, k4, v4 = (jnp.asarray(x).reshape(b, x.shape[1], h, d).transpose(0, 2, 1, 3)
                      for x in (q, k, v))
        ref = np.asarray(JA._flash_fused_tpu(q4, k4, v4, jnp.asarray(bias), jq, jk, 128, 256, True,
                                             1e-6, True, True, interpret=True))
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)


# (B, H, Sq, Skv, d): K1 at the edit path's joint shape and the T2To
# stage's, K6 at the T2To trainer's (d = 64 and its d = 128 form) and the
# tiny trainers' heads of 16
K1_K6_SHAPES = [(2, 48, 17776, 17776, 64), (2, 48, 9442, 9442, 64), (3, 48, 9442, 9442, 64),
                (3, 24, 9442, 9442, 128), (3, 2, 1544, 1544, 16)]


@pytest.mark.parametrize("shape", K1_K6_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("forced", [None, 2, 5])
def test_split_plan_at_k1_and_k6_shapes(shape, forced):
    """At K1's and K6's shapes the plan covers the keys once, in whole kv
    tiles but the last, and comes from the shape alone (the same whatever
    was planned before). Unforced it is one split at every production
    shape, where the f32 partials would exceed `SPLIT_WS_BYTES`: the body
    writes the output itself."""
    b, h, sq, skv, d = shape
    splits, split_len = TA.kv_split_plan(b, h, sq, skv, d, H100_SMS, forced)
    assert split_len % TA.kv_tile(d) == 0
    ranges = [(s * split_len, min(skv, (s + 1) * split_len)) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == skv and all(lo < hi for lo, hi in ranges)
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(ranges, ranges[1:]))
    if forced is None:
        assert splits == 1 or b * h * sq * (d + 2) * 4 * splits <= TA.SPLIT_WS_BYTES
        if skv > 9000:
            assert splits == 1
    else:
        assert splits == forced
    others = [TA.kv_split_plan(*s, H100_SMS) for s in reversed(K1_K6_SHAPES)]
    assert others and TA.kv_split_plan(b, h, sq, skv, d, H100_SMS, forced) == (splits, split_len)
