"""The pieces of K7's card path (`fused_attention_joint_int8`: the quantizing
pass, then K1's overlapped body with int8 scores, split over the keys as K1
is, and the combine) in their plain versions on the CPU: the split partials
of the body (`int8_splitkv_partials_plain`) and their combine
(`combine_plain`) against the one-pass plain version (`attention_int8_plain`)
and, on the Pallas kernel's own codes, against the Pallas K7 in interpret
mode (`_flash_fused_packed_tpu` with ``int8_scores``); the body's conversion
of its s32 scores to f32 without an I2F (`int8_score_to_float`) over every
reachable score; the split plan at K7's shapes. Inputs are made from a seed
with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.kernels import attention as JA
from tokensgen_tpu_torch.kernels import attention as TA

from _torch_parity import t

D = 64
TOL = 1e-5  # f32: the split form reorders the softmax's sums and the scales' products
# against the Pallas K7 in interpret mode, on its codes: tests/test_torch_attention.py's
# tolerance for the one-pass plain version (measured 1.0e-4: the Pallas
# kernel's max-free softmax rounds p to bf16 at another scale)
PALLAS_TOL = 5e-4
# codes of the port's quantizing prologue that differ from the Pallas
# kernel's (by one, at a rounding tie between the two f32 prologues' op
# orders): 0-2 of the ~400,000 of these cases, measured
MAX_TIES = 4
H100_SMS = 132
MAX_SCORE = 64 * 127 * 127  # |q codes . k codes| at most, head dim 64


def _tables(rng, sq, skv, batch, text):
    """JAX and port tables for q (softmax scale folded) and k: random rope
    angles after an identity text prefix, a random LayerNorm affine."""
    g = np.abs(rng.normal(size=(D,))).astype(np.float32)
    sh = (0.1 * rng.normal(size=(D,))).astype(np.float32)
    out = []
    for s, fold in ((sq, D ** -0.5), (skv, 1.0)):
        tx = min(text, s - 1)
        ang = rng.normal(size=((batch,) if batch else ()) + (s - tx, D)).astype(np.float32)
        cos, sin = np.cos(ang), np.sin(ang)
        jt = JA.make_prologue(D, [(None, tx), ((jnp.asarray(cos), jnp.asarray(sin)), s - tx)],
                              jnp.asarray(g), jnp.asarray(sh), fold=fold)
        tt = TA.make_prologue(D, [(None, tx), ((t(cos), t(sin)), s - tx)], t(g), t(sh),
                              fold=fold)
        out.append((jt, tt))
    return out


def _case(seed, b, h, sq, skv, masked, batch_tabs=False):
    """Merged f32 operands [b, S, h * 64], tables (JAX, port) for q and k, a
    [b, Skv] key bias (-1e9 on the first third of the last sample's keys
    when ``masked``, else zeros) and the port's codes and scales of q (log2 e
    folded in) and k, [B, H, S, D]."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h * D)).astype(np.float32) for s in (sq, skv, skv))
    bias = np.zeros((b, skv), np.float32)
    if masked:
        bias[-1, : max(1, skv // 3)] = -1e9
    (jq, tq), (jk, tk) = _tables(rng, sq, skv, b if batch_tabs else None, 5)
    q8, qs = TA.quantize_pairs_plain(TA.split_heads(t(q), h), tq, 1e-6, True, TA._LOG2E)
    k8, ks = TA.quantize_pairs_plain(TA.split_heads(t(k), h), tk, 1e-6, True)
    return dict(q=q, k=k, v=v, bias=bias, jq=jq, jk=jk, q8=q8, qs=qs, k8=k8, ks=ks, h=h)


def _pallas_codes(x, jtabs, h, fold, eps=1e-6):
    """The Pallas K7's quantizing prologue, as `_flash_packed_kernel` runs it
    on a head pair (its packed tables, the mean as a product with a block
    matrix of 1/64, the pair swap as a product with the block-diagonal Rg,
    ``fold`` = log2 e on the q side), in JAX on the CPU: codes f32 [B, H, S,
    D] and scales [B, H/2, S], as torch tensors."""
    cosg, sin, add, rg = JA._pack_tabs(jtabs)
    cosg, sin, add = cosg * fold, sin * fold, add * fold
    blk = jnp.full((D, D), 1.0 / D, jnp.float32)
    mu = jnp.block([[blk, jnp.zeros_like(blk)], [jnp.zeros_like(blk), blk]])

    def dot(a, m):
        return jax.lax.dot_general(a, m, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)

    codes, scales = [], []
    for p in range(h // 2):
        x32 = jnp.asarray(x[:, :, p * 2 * D:(p + 1) * 2 * D], jnp.float32)
        dlt = x32 - dot(x32, mu)
        ln0 = dlt * jax.lax.rsqrt(dot(dlt * dlt, mu) + eps)
        y = ln0 * cosg + dot(ln0, rg) * sin + add
        sc = jnp.maximum(jnp.max(jnp.abs(y), axis=2, keepdims=True), 1e-30)
        codes.append(np.asarray(jnp.clip(jnp.round(y * (127.0 / sc)), -127.0, 127.0)))
        scales.append(np.asarray(sc[..., 0] * (1.0 / 127.0)))
    return (TA.split_heads(torch.from_numpy(np.concatenate(codes, axis=2)), h),
            torch.from_numpy(np.stack(scales, axis=1)))


def _split_out(c, splits, codes=None):
    """K7's split pass at ``splits`` forced splits (the plan's evening out
    applied) and the combine, as [B, H, Sq, D] f32, with the split count run;
    on the port's codes and scales, or ``codes`` = (q8, qs, k8, ks)."""
    b, sq, skv = c["q"].shape[0], c["q"].shape[1], c["k"].shape[1]
    n, split_len = TA.kv_split_plan(b, c["h"], sq, skv, D, H100_SMS, splits)
    q8, qs, k8, ks = codes or (c["q8"], c["qs"], c["k8"], c["ks"])
    acc, m, l = TA.int8_splitkv_partials_plain(q8, qs, k8, ks, TA.split_heads(t(c["v"]), c["h"]),
                                               t(c["bias"]), split_len)
    assert acc.shape[0] == n
    return TA.combine_plain(acc, m, l)[0], n


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("b,h,sq,skv,masked", [
    (1, 2, 200, 517, False),   # Skv odd: not a multiple of 4 or of 128
    (2, 4, 131, 517, True),
    (2, 2, 96, 384, True),     # whole tiles
    (1, 2, 77, 390, True),     # 390: a multiple of neither 4 nor 128
    (2, 2, 5, 258, False),
])
def test_int8_split_partials_match_one_pass(b, h, sq, skv, masked, splits):
    """The split pass + combine at 1, 2 and 3 splits of whole kv tiles (the
    last ragged; the plan evens the ranges out, so 3 may run as 2) against
    `attention_int8_plain` on the same codes and scales (f32 operands, so p's
    rounding to v's dtype is exact): 1e-5, with and without a -1e9 key mask.
    Every forced count above 1 runs more than one split at these lengths."""
    c = _case(10 + sq + skv, b, h, sq, skv, masked)
    out, n = _split_out(c, splits)
    assert (n == 1) if splits == 1 else (2 <= n <= splits)
    ref = TA.attention_int8_plain(c["q8"], c["qs"], c["k8"], c["ks"],
                                  TA.split_heads(t(c["v"]), h), t(c["bias"]))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("masked,batch_tabs", [(False, False), (True, True)])
def test_int8_split_partials_match_pallas_interpret(masked, batch_tabs, splits):
    """The split pass + combine against the Pallas K7
    (`_flash_fused_packed_tpu(..., int8_scores=True)` in interpret mode) at
    256 q rows x 517 keys (a ragged last tile of 5 keys), 4 heads, shared or
    per-sample tables, with and without a key mask, on the Pallas kernel's
    own codes and scales (its prologue mirrored in JAX): 5e-4, as the
    one-pass plain version is held to it. The port's quantizing prologue
    gives the same codes but for a few at rounding ties (each off by one):
    one such code moves these outputs by up to ~6e-3, which is why the
    comparison takes the kernel's codes."""
    b, h, sq, skv = 2, 4, 256, 517
    c = _case(30 + splits, b, h, sq, skv, masked, batch_tabs)
    ref = JA._flash_fused_packed_tpu(jnp.asarray(c["q"]), jnp.asarray(c["k"]),
                                     jnp.asarray(c["v"]), jnp.asarray(c["bias"]), c["jq"],
                                     c["jk"], h, 128, 256, True, 1e-6, True, True,
                                     interpret=True, int8_scores=True)
    q8, qs = _pallas_codes(c["q"], c["jq"], h, TA._LOG2E)
    k8, ks = _pallas_codes(c["k"], c["jk"], h, 1.0)
    for ours, theirs in ((c["q8"], q8), (c["k8"], k8)):
        assert ((ours - theirs).abs() > 0).sum().item() <= MAX_TIES
        assert (ours - theirs).abs().max().item() <= 1
    for ours, theirs in ((c["qs"], qs), (c["ks"], ks)):
        torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=0)
    out, _ = _split_out(c, splits, (q8, qs, k8, ks))
    np.testing.assert_allclose(TA.merge_heads(out).numpy(), np.asarray(ref), rtol=0,
                               atol=PALLAS_TOL)


def test_int8_score_to_float_is_exact_over_every_score():
    """The body's dequant, c + the bits of 1.5 * 2^23 read as a float minus
    1.5 * 2^23, modelled in torch on int32, equals float(c) bit for bit over
    every score a 64-wide head of int8 codes can give, ±64 * 127^2."""
    c = torch.arange(-MAX_SCORE, MAX_SCORE + 1, dtype=torch.int32)
    got = TA.int8_score_to_float(c)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), c.float().view(torch.int32))


@pytest.mark.parametrize("shape,splits", [
    ((2, 48, 17776, 17776), 1),  # the gen path's To2V render: one split, K1's plan
    ((1, 48, 17776, 17776), 1),
    ((2, 4, 300, 517), 1),
    ((2, 48, 259, 100), 1),      # one kv tile: never split
])
def test_split_plan_at_k7_shapes(shape, splits):
    """K7 takes K1's plan: at the gen path's joint shape one split (the
    partials would exceed `SPLIT_WS_BYTES`), as at the card tests' small
    shapes; the scale tables' rows are the fewest whole 16 bytes that hold
    S scales (a tensor map's row stride)."""
    b, h, sq, skv = shape
    plan = TA.kv_split_plan(b, h, sq, skv, D, H100_SMS)
    assert plan[0] == splits and plan[0] * plan[1] >= skv
    for s in (sq, skv):
        stride = TA.int8_scale_stride(s)
        assert (stride * 4) % 16 == 0 and s <= stride < s + 4
