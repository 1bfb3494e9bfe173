"""Port parity: kernels/attention.py. Each plain PyTorch version (what a CPU
tensor takes) against its JAX Pallas kernel run in interpret mode, as
tests/test_attention.py runs them; the table API against the JAX one; the
dispatch by device. The Hopper kernels themselves are compared with their
plain versions on the card by tests/test_torch_kernels_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.kernels import attention as JA
from tokensgen_tpu_torch.kernels import attention as TA

from _torch_parity import t

D = 64


def _tabs_pair(rng, sq, skv, batch=None, text=0, d=D):
    """JAX and port tables for q (softmax scale folded) and k at head dim
    ``d``: random rope angles with an identity text prefix, random
    LayerNorm affine."""
    g = np.abs(rng.normal(size=(d,))).astype(np.float32)
    b_ = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    out = []
    for s, fold in ((sq, d ** -0.5), (skv, 1.0)):
        shape = ((batch,) if batch else ()) + (s - text, d)
        ang = rng.normal(size=shape).astype(np.float32)
        cos, sin = np.cos(ang), np.sin(ang)
        jt = JA.make_prologue(d, [(None, text), ((jnp.asarray(cos), jnp.asarray(sin)), s - text)],
                              jnp.asarray(g), jnp.asarray(b_), fold=fold)
        tt = TA.make_prologue(d, [(None, text), ((t(cos), t(sin)), s - text)], t(g), t(b_),
                              fold=fold)
        out.append((jt, tt))
    return out


def _merged(rng, b, s, h):
    return rng.normal(size=(b, s, h * D)).astype(np.float32)


@pytest.mark.parametrize("batched", [False, True])
def test_make_prologue_matches_jax(batched):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk) = _tabs_pair(rng, 96, 80, batch=2 if batched else None, text=7)
    for jt, tt in ((jq, tq), (jk, tk)):
        for a, b_ in zip(jt, tt):
            np.testing.assert_allclose(b_.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    js = JA.concat_tabs(JA.slice_tabs(jq, 0, 30), JA.slice_tabs(jq, 30, 96))
    ts = TA.concat_tabs(TA.slice_tabs(tq, 0, 30), TA.slice_tabs(tq, 30, 96))
    for a, b_ in zip(js, ts):
        np.testing.assert_allclose(b_.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    for a, b_ in zip(JA.prologue_identity(12, D, 0.5), TA.prologue_identity(12, D, 0.5)):
        np.testing.assert_array_equal(b_.numpy(), np.asarray(a))


@pytest.mark.parametrize("case", ["shared", "batched_masked"])
def test_joint_plain_matches_packed_kernel_interpret(case):
    """K1 (`_flash_packed_kernel`, interpret mode) vs fused_attention_joint's
    plain path. Both f32 with exact softmax: 2e-4 as the JAX kernel's own test."""
    rng = np.random.default_rng(8)
    batched = case == "batched_masked"
    b, h, sq, skv = (2 if batched else 1), 4, 256, 512
    q, k, v = _merged(rng, b, sq, h), _merged(rng, b, skv, h), _merged(rng, b, skv, h)
    bias = np.zeros((b, skv), np.float32)
    if batched:
        bias[0, skv - 17:] = -1e9
        bias[1, :40] = -1e9
    (jq, tq), (jk, tk) = _tabs_pair(rng, sq, skv, batch=b if batched else None, text=16)
    ref = JA._flash_fused_packed_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(bias), jq, jk, h, 128, 256, True, 1e-6,
                                     True, True, interpret=True)
    out = TA.fused_attention_joint(t(q), t(k), t(v), tq, tk, key_bias=t(bias), heads=h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_joint_int8_plain_matches_packed_kernel_interpret():
    """K7: `_flash_packed_kernel` with int8_scores (interpret mode) vs
    fused_attention_joint_int8's plain path at tests/test_attention.py:203's
    shapes (b=1, h=4, 256 x 512, d=64, masked tail). Same codes, scales and
    exact integer products; the f32 prologues differ in op order, which
    flips a rare code at a rounding tie: 5e-4 (measured 9e-5), where the
    int8 quantization itself moves the output by ~6e-2."""
    rng = np.random.default_rng(8)
    b, h, sq, skv = 1, 4, 256, 512
    q, k, v = _merged(rng, b, sq, h), _merged(rng, b, skv, h), _merged(rng, b, skv, h)
    bias = np.zeros((b, skv), np.float32)
    bias[0, skv - 17:] = -1e9
    (jq, tq), (jk, tk) = _tabs_pair(rng, sq, skv)
    ref = JA._flash_fused_packed_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(bias), jq, jk, h, 128, 256, True, 1e-6,
                                     True, True, interpret=True, int8_scores=True)
    out = TA.fused_attention_joint_int8(t(q), t(k), t(v), tq, tk, key_bias=t(bias), heads=h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=5e-4)
    exact = TA.fused_attention_joint(t(q), t(k), t(v), tq, tk, key_bias=t(bias), heads=h)
    assert (out - exact).abs().max().item() > 1e-2  # the int8 path really ran


def test_cross_smallkv_plain_matches_kernel_interpret():
    """K2 (`_cross_smallkv_kernel`): long q, kv of 96 (padded and masked in
    the TPU kernel). 6e-4: the TPU kernel's max-free exp2 runs deep below 1
    under the loose score bound of random tables (its own test's tolerance)."""
    rng = np.random.default_rng(12)
    b, h, sq, skv = 1, 4, 640, 96
    q, k, v = _merged(rng, b, sq, h), _merged(rng, b, skv, h), _merged(rng, b, skv, h)
    bias = np.zeros((b, skv), np.float32)
    (jq, tq), (jk, tk) = _tabs_pair(rng, sq, skv)
    ref = JA._flash_cross_smallkv_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(bias), jq, jk, h, 256, 1e-6, True, True,
                                      interpret=True)
    out = TA.fused_attention_cross_smallkv(t(q), t(k), t(v), tq, tk, heads=h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=6e-4, atol=6e-4)


def test_cross_smallq_plain_matches_kernel_interpret():
    """K3 (`_cross_smallq_kernel`): q of 96 against a long masked kv; 2e-4."""
    rng = np.random.default_rng(13)
    b, h, sq, skv = 1, 4, 96, 640
    q, k, v = _merged(rng, b, sq, h), _merged(rng, b, skv, h), _merged(rng, b, skv, h)
    bias = np.zeros((b, skv), np.float32)
    bias[0, skv - 9:] = -1e9
    (jq, tq), (jk, tk) = _tabs_pair(rng, sq, skv)
    ref = JA._flash_cross_smallq_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(bias), jq, jk, h, 256, 1e-6, True, True,
                                     interpret=True)
    out = TA.fused_attention_cross_smallq(t(q), t(k), t(v), tq, tk, key_bias=t(bias), heads=h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_bhsd_plain_matches_flash_kernel_interpret():
    """K4 (`_flash_kernel`) through pl.pallas_call(interpret=True) exactly as
    tests/test_attention.py:52-95 drives it, vs flash_attention_bhsd's plain
    path; f32, 1e-4 / 1e-5 as there."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(3)
    b, h, sq, skv = 1, 2, 256, 512
    q = rng.normal(size=(b, h, sq, D)).astype(np.float32)
    k = rng.normal(size=(b, h, skv, D)).astype(np.float32)
    v = rng.normal(size=(b, h, skv, D)).astype(np.float32)
    bias = np.zeros((b, skv), np.float32)
    bias[0, 500:] = -1e9
    scale = D ** -0.5
    block_q, block_kv, hblk = 128, 256, 2
    ref = pl.pallas_call(
        functools.partial(JA._flash_kernel, hblk=hblk, has_bias=True),
        grid=(b, h // hblk, sq // block_q, skv // block_kv),
        in_specs=[
            pl.BlockSpec((1, hblk, block_q, D), lambda b_, h_, i, j: (b_, h_, i, 0)),
            pl.BlockSpec((1, hblk, D, block_kv), lambda b_, h_, i, j: (b_, h_, 0, j)),
            pl.BlockSpec((1, hblk, block_kv, D), lambda b_, h_, i, j: (b_, h_, j, 0)),
            pl.BlockSpec((1, 1, block_kv), lambda b_, h_, i, j: (b_, 0, j)),
        ],
        out_specs=pl.BlockSpec((1, hblk, block_q, D), lambda b_, h_, i, j: (b_, h_, i, 0)),
        out_shape=jax.ShapeDtypeStruct((b, h, sq, D), jnp.float32),
        scratch_shapes=[pltpu.VMEM((hblk * block_q, JA._LANES), jnp.float32),
                        pltpu.VMEM((hblk * block_q, JA._LANES), jnp.float32),
                        pltpu.VMEM((hblk * block_q, D), jnp.float32)],
        interpret=True,
    )(jnp.asarray(q) * (scale * JA._LOG2E), jnp.asarray(k).transpose(0, 1, 3, 2),
      jnp.asarray(v), jnp.asarray(bias)[:, None, :] * JA._LOG2E)
    out = TA.flash_attention_bhsd(t(q), t(k), t(v), t(bias), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [16, 32, 128])
def test_bhsd_plain_matches_flash_attention_tpu_interpret(d, monkeypatch):
    """K4 at the head dims other than 64 that the card takes: the JAX
    package's wrapper `_flash_attention_tpu` (its `_flash_kernel` through
    pl.pallas_call, switched to interpret=True by monkeypatch) vs
    flash_attention_bhsd's plain path on [1, 2, 200, d] x 300 keys (ragged
    to the 128-row blocks: the wrapper pads and masks), with a key-bias
    mask; f32, 1e-4 / 1e-5 as the head-dim-64 case above."""
    monkeypatch.setattr(JA.pl, "pallas_call", functools.partial(JA.pl.pallas_call, interpret=True))
    rng = np.random.default_rng(30 + d)
    b, h, sq, skv = 1, 2, 200, 300
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, h, skv, d)).astype(np.float32)
    bias = np.zeros((b, skv), np.float32)
    bias[0, 250:] = -1e9
    scale = d ** -0.5
    ref = JA._flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(bias), scale, 128, 128)
    out = TA.flash_attention_bhsd(t(q), t(k), t(v), t(bias), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_bhsd_f32_matches_flash_attention_tpu_interpret_at_dinov2_tails(monkeypatch):
    """The float32 K4 at DINOv2's ragged length: [1, 2, 257, 64] against 257
    keys (a 1-row q tail and a 1-key kv tail past whole tiles), no key bias
    as the encoder calls it. The JAX wrapper `_flash_attention_tpu` (its
    `_flash_kernel` through pl.pallas_call, switched to interpret=True by
    monkeypatch; it pads to its 128 blocks and masks) vs
    flash_attention_bhsd_f32's CPU route; f32, 1e-4 / 1e-5 as the cases
    above."""
    monkeypatch.setattr(JA.pl, "pallas_call", functools.partial(JA.pl.pallas_call, interpret=True))
    rng = np.random.default_rng(257)
    b, h, s = 1, 2, 257
    q, k, v = (rng.normal(size=(b, h, s, D)).astype(np.float32) for _ in range(3))
    scale = D ** -0.5
    ref = JA._flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.zeros((b, s), jnp.float32), scale, 128, 128, has_bias=False)
    out = TA.flash_attention_bhsd_f32(t(q), t(k), t(v), None, scale)
    assert out.dtype == torch.float32 and out.shape == (b, h, s, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_plain_attention_chunking_matches_whole(monkeypatch):
    """The plain version's q-row chunking (for production sizes) changes values
    only at f32 rounding (the matmul blocking differs with the chunk size)."""
    rng = np.random.default_rng(4)
    q, k, v = (t(rng.normal(size=(1, 2, s, D))) for s in (50, 70, 70))
    bias = torch.zeros(1, 70)
    whole = TA.attention_plain(q, k, v, bias, 0.125)
    monkeypatch.setattr(TA, "MAX_SCORE_BYTES", 4 * 2 * 70 * 7)  # 7 q rows per chunk
    chunked = TA.attention_plain(q, k, v, bias, 0.125)
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """A CPU tensor never builds or launches a kernel: no launch is counted
    and the library loader is never reached."""
    def no_build():
        raise AssertionError("kernel library requested for CPU tensors")

    monkeypatch.setattr(TA, "_lib", no_build)
    TA.reset_launch_counts()
    rng = np.random.default_rng(5)
    (_, tq), (_, tk) = _tabs_pair(rng, 64, 64)
    x = t(_merged(rng, 1, 64, 2))
    TA.fused_attention_joint(x, x, x, tq, tk, heads=2)
    TA.fused_attention_cross_smallkv(x, x, x, tq, tk, heads=2)
    TA.fused_attention_cross_smallq(x, x, x, tq, tk, heads=2)
    TA.flash_attention_bhsd(TA.split_heads(x, 2), TA.split_heads(x, 2), TA.split_heads(x, 2))
    TA.fused_attention_joint_int8(x, x, x, tq, tk, heads=2)
    assert all(n == 0 for n in TA.launch_counts().values())


@pytest.mark.parametrize("sq,skv,expect", [
    (2100, 96, "fused_attention_cross_smallkv"),
    (96, 2100, "fused_attention_cross_smallq"),
    (300, 300, "fused_attention_joint"),
])
def test_dispatch_routes_like_jax(monkeypatch, sq, skv, expect):
    """fused_flash_attention routes one-tiny-side shapes to the small-side
    kernels where `_flash_packed_diff` does (kv <= 512 with q > 2048, q <= 512
    with kv > 2048). Two heads of 64: the packed route, which the JAX
    package takes for even heads only."""
    called = []
    for name in ("fused_attention_joint", "fused_attention_cross_smallkv",
                 "fused_attention_cross_smallq", "fused_attention_bhsd"):
        monkeypatch.setattr(TA, name, lambda *a, _n=name, **k: called.append(_n))
    q = torch.zeros(1, sq, 2 * D)
    k = torch.zeros(1, skv, 2 * D)
    TA.fused_flash_attention(q, k, k, None, None, heads=2)
    assert called == [expect]


@pytest.mark.parametrize("sq,skv,heads,d,grad,expect", [
    (300, 300, 2, 64, False, "fused_attention_joint_int8"),
    (300, 300, 1, 64, False, "fused_attention_bhsd"),
    (300, 300, 2, 16, False, "fused_attention_bhsd"),
    (2100, 96, 2, 64, False, "fused_attention_cross_smallkv"),
    (96, 2100, 2, 64, False, "fused_attention_cross_smallq"),
    (300, 300, 2, 64, True, "_FusedAttention"),
])
def test_int8_scores_route_like_jax(monkeypatch, sq, skv, heads, d, grad, expect):
    """With int8_scores, fused_flash_attention takes K7 where the JAX
    package's packed head-pair kernel takes its int8 branch (even heads,
    2*d = 128): the cross shapes still go to K2/K3, odd heads and other head
    dims take bf16 K6 (the JAX package's `_flash_fused_tpu`, which has no
    int8 branch), and under autograd the bf16 K1-with-lse Function runs (the
    JAX custom_vjp forward)."""
    called = []
    for name in ("fused_attention_joint", "fused_attention_cross_smallkv",
                 "fused_attention_cross_smallq", "fused_attention_joint_int8",
                 "fused_attention_bhsd"):  # each returns its q (K6's route merges it back)
        monkeypatch.setattr(TA, name, lambda *a, _n=name, **k: called.append(_n) or a[0])
    monkeypatch.setattr(TA._FusedAttention, "apply",
                        lambda *a, **k: called.append("_FusedAttention"))
    q = torch.zeros(1, sq, heads * d, requires_grad=grad)
    k = torch.zeros(1, skv, heads * d)
    tabs = TA.prologue_identity(max(sq, skv), d)
    TA.fused_flash_attention(q, k, k, tabs, tabs, heads=heads, int8_scores=True)
    assert called == [expect]


@pytest.mark.parametrize("d,heads", [(64, 2), (16, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_bhsd_plain_matches_fused_kernel_interpret(d, heads, masked):
    """K6 (`_flash_fused_kernel` through `_flash_fused_tpu(interpret=True)`,
    as tests/test_attention.py:166 runs it) vs fused_attention_bhsd's plain
    path on [B, H, S, D]: D = 64 with a head pair per block and D = 16 with
    3 heads (one head per block), with and without a key-bias mask. Both f32
    with exact softmax: 2e-4, as the JAX kernel's own test."""
    rng = np.random.default_rng(30 + d)
    b, sq, skv = 2, 256, 512
    q = rng.normal(size=(b, heads, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, heads, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, heads, skv, d)).astype(np.float32)
    bias = np.zeros((b, skv), np.float32)
    if masked:
        bias[0, skv - 23:] = -1e9
        bias[1, :70] = -1e9
    (jq, tq), (jk, tk) = _tabs_pair(rng, sq, skv, text=16, d=d)
    ref = JA._flash_fused_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                              jq, jk, 128, 256, masked, 1e-6, True, True, interpret=True)
    out = TA.fused_attention_bhsd(t(q), t(k), t(v), tq, tk, key_bias=t(bias) if masked else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("layout,heads,d", [("4d", 2, 64), ("odd_heads", 3, 64),
                                            ("merged_d16", 2, 16)])
def test_fused_flash_attention_k6_route_matches_jax(layout, heads, d):
    """`fused_flash_attention` on the calls the JAX package sends to K6 (4-D
    operands, odd heads, 2*d not a multiple of 128) against the JAX
    `fused_flash_attention` on the CPU (`_xla_attention_fused`): the output
    without grad (K6's plain version) to 1e-5, and under autograd (the
    `_FusedBhsdAttention` Function: K6 with lse, then K5's plain version) the
    grads of q, k, v and the LayerNorm affine against jax.grad to 1e-4 of
    each grad's largest entry. f32, a key-bias mask on one sample."""
    rng = np.random.default_rng(40 + heads)
    b, text, sq, skv = 2, 5, 48, 40
    shape = (lambda s: (b, heads, s, d)) if layout == "4d" else (lambda s: (b, s, heads * d))
    q, k, v = (rng.normal(size=shape(s)).astype(np.float32) for s in (sq, skv, skv))
    w = rng.normal(size=shape(sq)).astype(np.float32)
    bias = np.zeros((b, skv), np.float32)
    bias[1, -9:] = -1e9
    g_ln = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    b_ln = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    ang = rng.normal(size=(sq - text, d)).astype(np.float32)
    rope = (np.cos(ang), np.sin(ang))
    kw = {} if layout == "4d" else {"heads": heads}

    def tables(mod, conv, g_, b_):  # rope on the q side's video rows, LayerNorm on both
        segs = [(None, text), ((conv(rope[0]), conv(rope[1])), sq - text)]
        return (mod.make_prologue(d, segs, g_, b_, fold=d ** -0.5),
                mod.make_prologue(d, [(None, skv)], g_, b_))

    def jout(q_, k_, v_, g_, b_):
        tq, tk = tables(JA, jnp.asarray, g_, b_)
        return JA.fused_flash_attention(q_, k_, v_, tq, tk, key_bias=jnp.asarray(bias), **kw)

    jargs = [jnp.asarray(x) for x in (q, k, v, g_ln, b_ln)]
    want = np.asarray(jout(*jargs))
    want_g = jax.jit(jax.grad(lambda *a: jnp.sum(jout(*a) * w), argnums=tuple(range(5))))(*jargs)
    leaves = [t(x).requires_grad_() for x in (q, k, v, g_ln, b_ln)]
    with torch.no_grad():
        tq, tk = tables(TA, t, leaves[3], leaves[4])
        out = TA.fused_flash_attention(*leaves[:3], tq, tk, key_bias=t(bias), **kw)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    tq, tk = tables(TA, t, leaves[3], leaves[4])
    got = torch.autograd.grad((TA.fused_flash_attention(*leaves[:3], tq, tk, key_bias=t(bias),
                                                        **kw) * t(w)).sum(), leaves)
    for name, x, r in zip(("q", "k", "v", "ln_scale", "ln_bias"), got, want_g):
        r = np.asarray(r)
        np.testing.assert_allclose(x.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("layout,heads,d,grad,expect", [
    ("merged", 2, 64, False, "fused_attention_joint"),
    ("merged", 2, 64, True, "_FusedAttention"),
    ("merged", 1, 64, False, "fused_attention_bhsd"),
    ("merged", 3, 64, True, "_FusedBhsdAttention"),
    ("merged", 2, 16, False, "fused_attention_bhsd"),
    ("merged", 2, 16, True, "_FusedBhsdAttention"),
    ("4d", 2, 64, False, "fused_attention_bhsd"),
    ("4d", 2, 64, True, "_FusedBhsdAttention"),
])
def test_fused_dispatch_routes_like_jax(monkeypatch, layout, heads, d, grad, expect):
    """`_fused_dispatch`'s routing: merged operands with even heads and
    d = 64 (the JAX package's packed head-pair kernel) take K1, or the
    K1-with-lse Function under autograd; odd heads, other head dims and 4-D
    operands take K6 on the [B, H, S, D] view (the JAX `_flash_fused_tpu`),
    or its Function (`_flash_fused_diff`) under autograd. Each entry point
    records its call and returns its q."""
    called = []
    for name in ("fused_attention_joint", "fused_attention_bhsd"):
        monkeypatch.setattr(TA, name, lambda *a, _n=name, **k: called.append(_n) or a[0])
    for name in ("_FusedAttention", "_FusedBhsdAttention"):
        monkeypatch.setattr(getattr(TA, name), "apply",
                            lambda *a, _n=name, **k: called.append(_n) or a[0])
    shape = (1, heads, 300, d) if layout == "4d" else (1, 300, heads * d)
    q = torch.zeros(shape, requires_grad=grad)
    tabs = TA.prologue_identity(300, d)
    out = TA.fused_flash_attention(q, q.detach(), q.detach(), tabs, tabs,
                                   heads=heads if layout == "merged" else None)
    assert called == [expect] and out.shape == shape
