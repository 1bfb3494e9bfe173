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


def _tabs_pair(rng, sq, skv, batch=None, text=0):
    """JAX and port tables for q (softmax scale folded) and k: random rope
    angles with an identity text prefix, random LayerNorm affine."""
    g = np.abs(rng.normal(size=(D,))).astype(np.float32)
    b_ = (0.1 * rng.normal(size=(D,))).astype(np.float32)
    out = []
    for s, fold in ((sq, D ** -0.5), (skv, 1.0)):
        shape = ((batch,) if batch else ()) + (s - text, D)
        ang = rng.normal(size=shape).astype(np.float32)
        cos, sin = np.cos(ang), np.sin(ang)
        jt = JA.make_prologue(D, [(None, text), ((jnp.asarray(cos), jnp.asarray(sin)), s - text)],
                              jnp.asarray(g), jnp.asarray(b_), fold=fold)
        tt = TA.make_prologue(D, [(None, text), ((t(cos), t(sin)), s - text)], t(g), t(b_),
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
    with kv > 2048)."""
    called = []
    for name in ("fused_attention_joint", "fused_attention_cross_smallkv",
                 "fused_attention_cross_smallq"):
        monkeypatch.setattr(TA, name, lambda *a, _n=name, **k: called.append(_n))
    q = torch.zeros(1, sq, D)
    k = torch.zeros(1, skv, D)
    TA.fused_flash_attention(q, k, k, None, None, heads=1)
    assert called == [expect]


@pytest.mark.parametrize("sq,skv,heads,d,grad,expect", [
    (300, 300, 2, 64, False, "fused_attention_joint_int8"),
    (300, 300, 1, 64, False, "fused_attention_joint"),
    (300, 300, 2, 16, False, "fused_attention_joint"),
    (2100, 96, 2, 64, False, "fused_attention_cross_smallkv"),
    (96, 2100, 2, 64, False, "fused_attention_cross_smallq"),
    (300, 300, 2, 64, True, "_FusedAttention"),
])
def test_int8_scores_route_like_jax(monkeypatch, sq, skv, heads, d, grad, expect):
    """With int8_scores, fused_flash_attention takes K7 where the JAX
    package's packed head-pair kernel takes its int8 branch (even heads,
    2*d = 128): the cross shapes still go to K2/K3, odd heads and other head
    dims stay on bf16 K1, and under autograd the bf16 K1-with-lse Function
    runs (the JAX custom_vjp forward)."""
    called = []
    for name in ("fused_attention_joint", "fused_attention_cross_smallkv",
                 "fused_attention_cross_smallq", "fused_attention_joint_int8"):
        monkeypatch.setattr(TA, name, lambda *a, _n=name, **k: called.append(_n))
    monkeypatch.setattr(TA._FusedAttention, "apply",
                        lambda *a, **k: called.append("_FusedAttention"))
    q = torch.zeros(1, sq, heads * d, requires_grad=grad)
    k = torch.zeros(1, skv, heads * d)
    tabs = TA.prologue_identity(max(sq, skv), d)
    TA.fused_flash_attention(q, k, k, tabs, tabs, heads=heads, int8_scores=True)
    assert called == [expect]
