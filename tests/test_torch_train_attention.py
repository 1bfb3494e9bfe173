"""Port parity for the attention gradients of kernels/attention.py: K5's
plain version (`attention_bwd_plain`, what a CPU tensor takes) against the
JAX packed backward kernel in interpret mode and `jax.vjp`; the lse output
against the JAX kernel's `with_lse`; the two autograd Functions (fused
prologue, [B, H, S, D]) against `jax.grad` of the JAX package's XLA
attention, including the LayerNorm affine through `make_prologue`. The
kernels themselves are held to these plain versions on the card by
tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.kernels import attention as JA
from tokensgen_tpu_torch.kernels import attention as TA

from _torch_parity import t

D = 64


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_bwd_plain_matches_packed_bwd_kernel_interpret():
    """tests/test_attention.py:291-337's case: b1, h4, sq 256, skv 384, -1e9
    on the last 9 keys. The port's K5 entry point on CPU tensors (its plain
    version) against `_flash_packed_bwd_tpu(interpret=True)` and jax.vjp of
    the XLA attention: dq, dk, dv, dbias within 2e-4 (f32)."""
    rng = np.random.default_rng(11)
    b, h, sq, skv = 1, 4, 256, 384
    qn, kn, v, g = _np(rng, b, sq, h * D), _np(rng, b, skv, h * D), _np(rng, b, skv, h * D), \
        _np(rng, b, sq, h * D)
    bias = np.zeros((b, skv), np.float32)
    bias[0, skv - 9:] = -1e9

    def f(qn_, kn_, v_, bias_):
        return JA._merge3(JA._xla_attention(JA._split3(qn_, h), JA._split3(kn_, h),
                                            JA._split3(v_, h), bias_, 1.0))

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (qn, kn, v, bias)))
    want = vjp(jnp.asarray(g))
    s = jnp.einsum("bhqd,bhkd->bhqk", JA._split3(jnp.asarray(qn), h),
                   JA._split3(jnp.asarray(kn), h)) + bias[:, None, None, :]
    lse = jax.nn.logsumexp(s, axis=-1)  # [B, H, Sq]
    go = (g * np.asarray(out)).reshape(b, sq, h // 2, 2, D).sum(-1)
    kernel = JA._flash_packed_bwd_tpu(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(v),
                                      jnp.asarray(g), lse.reshape(b, h // 2, 2, sq),
                                      jnp.asarray(go.transpose(0, 2, 3, 1)), jnp.asarray(bias),
                                      h, 128, 128, True, interpret=True)
    dsum = TA._row_dsum(t(g), t(out), h)
    got = TA.attention_backward(t(qn), t(kn), t(v), t(g), t(lse), dsum, t(bias), heads=h,
                                with_dbias=True)
    for name, x, a, r in zip(("dq", "dk", "dv", "dbias"), got, kernel, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(a), rtol=2e-4, atol=2e-4, err_msg=name)
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4, err_msg=name)


def test_lse_matches_packed_kernel_with_lse_interpret():
    """K1's lse (natural log, [B, H, Sq]) on CPU tensors against the JAX
    packed kernel's `with_lse` output ([B, H/2, 2, Sq]); f32, 2e-4."""
    rng = np.random.default_rng(8)
    b, h, sq, skv = 1, 4, 256, 384
    q, k, v = _np(rng, b, sq, h * D), _np(rng, b, skv, h * D), _np(rng, b, skv, h * D)
    bias = np.zeros((b, skv), np.float32)
    bias[0, :20] = -1e9
    g_ln = (1.0 + 0.1 * _np(rng, D)).astype(np.float32)
    b_ln = (0.1 * _np(rng, D)).astype(np.float32)
    ang = _np(rng, skv, D)
    rope_j = (jnp.asarray(np.cos(ang)), jnp.asarray(np.sin(ang)))
    rope_t = (t(np.cos(ang)), t(np.sin(ang)))
    jq = JA.make_prologue(D, [(None, 16), ((rope_j[0][:sq - 16], rope_j[1][:sq - 16]), sq - 16)],
                          jnp.asarray(g_ln), jnp.asarray(b_ln), fold=D ** -0.5)
    jk = JA.make_prologue(D, [(rope_j, skv)], jnp.asarray(g_ln), jnp.asarray(b_ln))
    tq = TA.make_prologue(D, [(None, 16), ((rope_t[0][:sq - 16], rope_t[1][:sq - 16]), sq - 16)],
                          t(g_ln), t(b_ln), fold=D ** -0.5)
    tk = TA.make_prologue(D, [(rope_t, skv)], t(g_ln), t(b_ln))
    ref_out, ref_lse = JA._flash_fused_packed_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), jq, jk, h, 128, 128,
        True, 1e-6, True, True, interpret=True, with_lse=True)
    out, lse = TA.fused_attention_joint(t(q), t(k), t(v), tq, tk, t(bias), h, with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., :sq].reshape(b, h, sq),
                               rtol=2e-4, atol=2e-4)


def _rope(rng, s, batch=None):
    ang = _np(rng, *((batch,) if batch else ()), s, D)
    return np.cos(ang), np.sin(ang)


@pytest.mark.parametrize("batched", [False, True])
def test_fused_function_grads_match_jax(batched):
    """`fused_flash_attention` under autograd (the K1+lse / K5 Function; on
    CPU both directions plain) against jax.grad of `_xla_attention_fused`:
    grads of q, k, v, the key bias, the LayerNorm scale and bias (folded into
    the tables by make_prologue) and the rope tables (per-sample with
    ``batched``). f32: 1e-4 relative to each grad's largest entry."""
    rng = np.random.default_rng(21)
    b, h, text, sq, skv = 2, 2, 7, 40, 33
    q, k, v = _np(rng, b, sq, h * D), _np(rng, b, skv, h * D), _np(rng, b, skv, h * D)
    bias = (0.3 * _np(rng, b, skv)).astype(np.float32)
    bias[1, -5:] = -1e9
    g_ln = (1.0 + 0.1 * _np(rng, D)).astype(np.float32)
    b_ln = (0.1 * _np(rng, D)).astype(np.float32)
    cq, sq_ = _rope(rng, sq - text, b if batched else None)
    ck, sk = _rope(rng, skv)
    w = _np(rng, b, sq, h * D)

    def jloss(q_, k_, v_, bias_, g_, b_, cq_, sq2):
        tq = JA.make_prologue(D, [(None, text), ((cq_, sq2), sq - text)], g_, b_, fold=D ** -0.5)
        tk = JA.make_prologue(D, [((jnp.asarray(ck), jnp.asarray(sk)), skv)], g_, b_)
        out = JA._xla_attention_fused(JA._split3(q_, h), JA._split3(k_, h), JA._split3(v_, h),
                                      bias_, tq, tk, 1e-6, True, True)
        return jnp.sum(JA._merge3(out) * w)

    args = (q, k, v, bias, g_ln, b_ln, cq, sq_)
    want = jax.jit(jax.grad(jloss, argnums=tuple(range(8))))(*(jnp.asarray(x) for x in args))
    leaves = [t(x).requires_grad_() for x in args]
    tq = TA.make_prologue(D, [(None, text), ((leaves[6], leaves[7]), sq - text)], leaves[4],
                          leaves[5], fold=D ** -0.5)
    tk = TA.make_prologue(D, [((t(ck), t(sk)), skv)], leaves[4], leaves[5])
    out = TA.fused_flash_attention(leaves[0], leaves[1], leaves[2], tq, tk, key_bias=leaves[3],
                                   heads=h)
    got = torch.autograd.grad((out * t(w)).sum(), leaves)
    names = ("q", "k", "v", "key_bias", "ln_scale", "ln_bias", "rope_cos", "rope_sin")
    for name, x, r in zip(names, got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(x.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


def test_bhsd_function_grads_match_jax():
    """`flash_attention` under autograd (the K4+lse / K5 Function) against
    jax.grad of `_xla_attention` with a scale and a key bias; f32, 1e-4
    relative to each grad's largest entry."""
    rng = np.random.default_rng(22)
    b, h, sq, skv, scale = 1, 3, 24, 50, 0.3
    q, k, v, w = _np(rng, b, h, sq, D), _np(rng, b, h, skv, D), _np(rng, b, h, skv, D), \
        _np(rng, b, h, sq, D)
    bias = (0.5 * _np(rng, b, skv)).astype(np.float32)

    def jloss(q_, k_, v_, bias_):
        return jnp.sum(JA._xla_attention(q_, k_, v_, bias_, scale) * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(*(jnp.asarray(x) for x in (q, k, v, bias)))
    leaves = [t(x).requires_grad_() for x in (q, k, v, bias)]
    out = TA.flash_attention(*leaves[:3], key_bias=leaves[3], scale=scale)
    got = torch.autograd.grad((out * t(w)).sum(), leaves)
    for x, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(x.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_grad_routing_takes_the_lse_forward_for_every_shape(monkeypatch):
    """With an input that requires grad, every shape (here a K2 one) goes
    through the Function, whose forward is K1 with lse, as the JAX custom_vjp
    forward skips the K2/K3 routing; without grad the routing is unchanged."""
    calls = []
    real = TA.fused_attention_joint

    def joint(*a, with_lse=False, **k):
        calls.append("joint+lse" if with_lse else "joint")
        return real(*a, with_lse=with_lse, **k)

    monkeypatch.setattr(TA, "fused_attention_joint", joint)
    monkeypatch.setattr(TA, "fused_attention_cross_smallkv",
                        lambda *a, **k: calls.append("smallkv"))
    rng = np.random.default_rng(0)
    tabs_q, tabs_k = TA.prologue_identity(2100, D), TA.prologue_identity(96, D)
    # two heads of 64: the packed route (odd heads take K6, as in the JAX package)
    q = t(_np(rng, 1, 2100, 2 * D)).requires_grad_()
    k = t(_np(rng, 1, 96, 2 * D))
    TA.fused_flash_attention(q, k, k, tabs_q, tabs_k, heads=2)
    with torch.no_grad():
        TA.fused_flash_attention(q, k, k, tabs_q, tabs_k, heads=2)
    TA.fused_flash_attention(q.detach(), k, k, tabs_q, tabs_k, heads=2)
    assert calls == ["joint+lse", "smallkv", "smallkv"]


def _bhsd_case(rng, d, b=2, h=3, sq=200, skv=150, text=9):
    """[B, H, S, d] f32 operands, an output weight, a key bias masking keys
    of one sample, and prologue tables (LayerNorm affine, RoPE on the q
    side's rows after ``text``) for both frameworks."""
    q, k, v, w = _np(rng, b, h, sq, d), _np(rng, b, h, skv, d), _np(rng, b, h, skv, d), \
        _np(rng, b, h, sq, d)
    bias = (0.2 * _np(rng, b, skv)).astype(np.float32)
    bias[1, -13:] = -1e9
    g_ln = (1.0 + 0.1 * _np(rng, d)).astype(np.float32)
    b_ln = (0.1 * _np(rng, d)).astype(np.float32)
    ang = _np(rng, sq - text, d)
    tabs = {}
    for mod, conv in ((JA, jnp.asarray), (TA, t)):
        segs = [(None, text), ((conv(np.cos(ang)), conv(np.sin(ang))), sq - text)]
        tabs[mod] = (mod.make_prologue(d, segs, conv(g_ln), conv(b_ln), fold=d ** -0.5),
                     mod.make_prologue(d, [(None, skv)], conv(g_ln), conv(b_ln)))
    return q, k, v, w, bias, tabs


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bhsd_function_grads_match_fused_diff_vjp(d, monkeypatch):
    """`fused_flash_attention` on [B, H, S, d] under autograd (the
    `_FusedBhsdAttention` Function: K6 with lse, K5 on the prologued
    operands; plain versions here) against jax.vjp of the JAX package's
    `_flash_fused_diff` (its Pallas forward in interpret mode, its XLA
    backward) at head dims 16, 32, 64 and 128: the grads of q, k, v, the key
    bias and every prologue table. f32: 1e-4 of each grad's largest entry."""
    import functools

    monkeypatch.setattr(JA, "_flash_fused_tpu",
                        functools.partial(JA._flash_fused_tpu, interpret=True))
    rng = np.random.default_rng(50 + d)
    q, k, v, w, bias, tabs = _bhsd_case(rng, d)
    jq, jk = tabs[JA]

    def f(q_, k_, v_, bias_, tq_, tk_):
        return JA._flash_fused_diff(128, 128, True, 1e-6, True, True, q_, k_, v_, bias_, tq_, tk_)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v, bias)), jq, jk)
    dq, dk, dv, dbias, dtq, dtk = vjp(jnp.asarray(w))
    want = [dq, dk, dv, dbias, *dtq, *dtk]
    leaves = [t(x).requires_grad_() for x in (q, k, v, bias)]
    tq, tk = (tuple(x.detach().clone().requires_grad_() for x in tb) for tb in tabs[TA])
    out = TA.fused_flash_attention(*leaves[:3], tq, tk, key_bias=leaves[3])
    got = torch.autograd.grad((out * t(w)).sum(), leaves + list(tq) + list(tk))
    names = ["q", "k", "v", "key_bias"] + [f"tabs_{s}.{n}" for s in "qk"
                                            for n in ("cosg", "sin", "add", "rg")]
    for name, x, r in zip(names, got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(x.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bwd_plain_matches_jax_vjp_bhsd(d):
    """K5's entry point on [B, H, S, d] CPU tensors (its plain version, from
    the saved lse and dsum) against jax.vjp of the JAX package's XLA
    attention (`_xla_attention`, whose backward `_blocked_attention_bwd` is)
    with the softmax scale d^-0.5 and a key bias, at head dims 16, 32, 64
    and 128: dq, dk, dv and dbias. f32: 1e-4 of each grad's largest entry."""
    rng = np.random.default_rng(60 + d)
    q, k, v, g, bias, _ = _bhsd_case(rng, d)
    scale = d ** -0.5
    out, vjp = jax.vjp(lambda *a: JA._xla_attention(*a, scale),
                       *(jnp.asarray(x) for x in (q, k, v, bias)))
    want = vjp(jnp.asarray(g))
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k)) * scale + bias[:, None, None]
    lse = t(np.asarray(jax.nn.logsumexp(s, axis=-1)))
    dsum = TA._row_dsum(t(g), t(np.asarray(out)), None)
    got = TA.attention_backward(t(q), t(k), t(v), t(g), lse, dsum, t(bias), scale=scale,
                                with_dbias=True)
    for name, x, r in zip(("dq", "dk", "dv", "dbias"), got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(x.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)
