"""Port parity: the plain versions of the probe kernels (kernels/probes.py: T1,
T2, T6, T7, T8; T3a-T4b in tests/test_torch_probes_r3.py), which CPU
tensors take, against the JAX package's Pallas probes under tools/. Each
probe's own kernel body runs through ``pl.pallas_call(interpret=True)`` on
numpy-seeded inputs at a small size (the scripts' wrappers set TPU compiler
parameters, so the tests wrap the bodies themselves, as
tests/test_torch_attention.py does for K4). Then one ``--device cpu`` run of
each probe CLI at a tiny size. Tolerances are stated per test."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tokensgen_tpu.kernels import attention as JA
from tokensgen_tpu_torch.kernels import probes as P

from _torch_parity import t


def _tool(name):
    return importlib.import_module(f"tools.{name}")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_flash_loop_plain_matches_pallas_probe(dtype):
    """T6: `_flash_like_kernel` (tools/bench_pallas_int8.py) at m, n, d =
    32, 64, 16 for 3 steps. int8: exact integers and int32 sums, so the
    plain version is bit-equal. bf16: the same roundings (bf16(s / 64)) on
    f32 products whose sums may differ in the last bit, which can move one
    bf16 rounding of p or the next q: 1e-2 of the output's largest entry."""
    mod = _tool("bench_pallas_int8")
    rng = np.random.default_rng(1)
    m, n, d, iters = 32, 64, 16, 3
    shapes = ((m, d), (d, n), (n, d))
    if dtype == "int8":
        arrs = [rng.integers(-127, 127, s).astype(np.int8) for s in shapes]
        jdt, acc = jnp.int8, jnp.int32
    else:
        arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jdt, acc = jnp.bfloat16, jnp.float32
    jargs = [jnp.asarray(a, jdt) for a in arrs]
    want = np.asarray(pl.pallas_call(
        functools.partial(mod._flash_like_kernel, acc_t=acc, iters=iters),
        out_shape=jax.ShapeDtypeStruct((m, d), jnp.float32), interpret=True)(*jargs))
    targs = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
             for a in jargs]
    got = P.flash_loop(*targs, iters).numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())


def test_matmul_plain_matches_pallas_probe():
    """T7: `_mm_kernel` (tools/bench_matmul_pallas.py) on a (32, 16, 16)
    grid of blocks over 64 x 32 x 48: bf16 out of f32 sums; the sums run in
    another order, which can move a bf16 rounding by one ulp: 2^-8
    relative."""
    mod = _tool("bench_matmul_pallas")
    rng = np.random.default_rng(2)
    m, kdim, n, (bm, bn, bk) = 64, 32, 48, (32, 16, 16)
    x = jnp.asarray(rng.standard_normal((m, kdim)) * 0.1, jnp.bfloat16)
    y = jnp.asarray(rng.standard_normal((kdim, n)) * 0.1, jnp.bfloat16)
    want = pl.pallas_call(
        functools.partial(mod._mm_kernel, nk=kdim // bk),
        grid=(m // bm, n // bn, kdim // bk),
        in_specs=[pl.BlockSpec((bm, bk), lambda i, j, k: (i, k)),
                  pl.BlockSpec((bk, bn), lambda i, j, k: (k, j))],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j, k: (i, j)),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((bm, bn), jnp.float32)], interpret=True)(x, y)
    got = P.matmul_hand(t(np.asarray(x.astype(jnp.float32)), torch.bfloat16),
                        t(np.asarray(y.astype(jnp.float32)), torch.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("op", P.EXP2_OPS)
def test_exp2_loop_plain_matches_pallas_probe(op):
    """T8: `make_kernel(5, op)` (tools/bench_vpu_exp2.py) over [16, 128] f32
    uniform in [-1, 1): mul is the same IEEE product each pass (bit-equal);
    exp2 is XLA's against torch's, within a few f32 ulps per pass: 1e-6
    relative."""
    mod = _tool("bench_vpu_exp2")
    x = np.random.default_rng(3).uniform(-1, 1, (16, 128)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        mod.make_kernel(5, op), out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))
    got = P.exp2_loop(t(x), 5, op).numpy()
    if op == "mul":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _attention_inputs(seed, b=1, h=2, sq=100, skv=200, d=64):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for s in (sq, skv, skv))
    bias = rng.standard_normal((b, skv)).astype(np.float32)
    return q, k, v, bias


def _padded(q, k, v, bias, block_q, block_kv):
    """The probes' wrapper before its pallas_call (tools/bench_attn_v2.py
    `run_v2`, bench_attn_sweep.py `_tpu`): q scaled by d^-0.5 log2 e, padded
    to whole blocks, the padded keys' bias -1e9, the bias times log2 e."""
    d, sq, skv = q.shape[-1], q.shape[2], k.shape[2]
    sq_p, skv_p = -(-sq // block_q) * block_q, -(-skv // block_kv) * block_kv
    pad = lambda x, n: jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, n), (0, 0)))  # noqa: E731
    kb = jnp.pad(jnp.asarray(bias), ((0, 0), (0, skv_p - skv)), constant_values=-1e9)
    return (pad(q * (d ** -0.5 * JA._LOG2E), sq_p - sq), pad(k, skv_p - skv).transpose(0, 1, 3, 2),
            pad(v, skv_p - skv), kb[:, None, :] * JA._LOG2E, sq_p, skv_p)


def _specs(hblk, block_q, block_kv, d):
    return dict(
        in_specs=[
            pl.BlockSpec((1, hblk, block_q, d), lambda b_, h_, i, j: (b_, h_, i, 0)),
            pl.BlockSpec((1, hblk, d, block_kv), lambda b_, h_, i, j: (b_, h_, 0, j)),
            pl.BlockSpec((1, hblk, block_kv, d), lambda b_, h_, i, j: (b_, h_, j, 0)),
            pl.BlockSpec((1, 1, block_kv), lambda b_, h_, i, j: (b_, 0, j)),
        ],
        out_specs=pl.BlockSpec((1, hblk, block_q, d), lambda b_, h_, i, j: (b_, h_, i, 0)))


def _v2_probe(q, k, v, bias, bias_mode, hblk=2, block_q=32, block_kv=64):
    mod = _tool("bench_attn_v2")
    b, h, sq, d = q.shape
    qp, kt, vp, kb, sq_p, skv_p = _padded(q, k, v, bias, block_q, block_kv)
    return np.asarray(pl.pallas_call(
        functools.partial(mod._kernel_v2, hblk=hblk, bias_mode=bias_mode),
        grid=(b, h // hblk, sq_p // block_q, skv_p // block_kv),
        out_shape=jax.ShapeDtypeStruct((b, h, sq_p, d), jnp.float32),
        scratch_shapes=[pltpu.VMEM((hblk, block_q, mod._LANES), jnp.float32),
                        pltpu.VMEM((hblk, block_q, mod._LANES), jnp.float32),
                        pltpu.VMEM((hblk, block_q, d), jnp.float32)],
        interpret=True, **_specs(hblk, block_q, block_kv, d))(qp, kt, vp, kb)[:, :, :sq])


@pytest.mark.parametrize("bias_mode", P.BIAS_MODES)
def test_attention_v2_plain_matches_pallas_probe(bias_mode):
    """T2: `_kernel_v2` (tools/bench_attn_v2.py) over 200 keys in tiles of 64
    (the last ragged), both heads of a pair per block. "full" adds the key
    bias on every tile: a random bias. "last" adds it on the last tile only;
    the body's "last" branch does not trace here (its `pl.when` writes the
    scores into a list the enclosing trace reads, which pallas_call refuses
    as captured constants), so the probe body runs "full" on the script's own
    inputs (a zero bias: only the padding is masked), where the two modes are
    one function; and against a random bias "last" must equal the JAX XLA
    attention with the bias left on the last tile only. f32 with exact
    softmax: 1e-4 / 1e-5, as K4's test."""
    q, k, v, bias = _attention_inputs(4)
    if bias_mode == "last":
        zero = np.zeros_like(bias)
        got = P.attention_v2(t(q), t(k), t(v), t(zero), 32, 64, "last")
        np.testing.assert_allclose(got.numpy(), _v2_probe(q, k, v, zero, "full"), rtol=1e-4,
                                   atol=1e-5)
        last = bias.copy()
        last[:, :(k.shape[2] - 1) // 64 * 64] = 0.0
        want = JA._xla_attention(*(jnp.asarray(x) for x in (q, k, v, last)), q.shape[-1] ** -0.5)
        got = P.attention_v2(t(q), t(k), t(v), t(bias), 32, 64, "last")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        full = P.attention_v2(t(q), t(k), t(v), t(bias), 32, 64, "full")
        assert (full - got).abs().max().item() > 1e-2  # the earlier tiles' bias is left out
    else:
        got = P.attention_v2(t(q), t(k), t(v), t(bias), 32, 64, "full")
        np.testing.assert_allclose(got.numpy(), _v2_probe(q, k, v, bias, "full"), rtol=1e-4,
                                   atol=1e-5)


def test_attention_v2_last_plain_matches_run_v2_at_block_kv_128(monkeypatch):
    """T2 "last" at the card's block_kv of 128 (T1's tiles): the plain version
    against the JAX script's own wrapper `run_v2` (tools/bench_attn_v2.py)
    at block_q 32, block_kv 128, hblk 2, its pallas_call in interpret mode
    (monkeypatched), over 300 keys (the last tile of 128 ragged: 44 keys)
    with a random key bias. The script's "last" branch does not trace on the
    CPU (its `pl.when` writes the scores into a list the enclosing trace
    reads, which pallas_call refuses as captured constants), so `run_v2`
    runs "full" on the bias that "last" leaves: the random bias on the last
    tile, zero on the earlier ones (the padded keys -1e9 either way). "last"
    must differ from "full" there. f32 with exact softmax: 1e-4 / 1e-5, as
    K4's test."""
    mod = _tool("bench_attn_v2")
    call = mod.pl.pallas_call
    monkeypatch.setattr(mod.pl, "pallas_call", lambda *a, **kw: call(*a, interpret=True, **kw))
    q, k, v, bias = _attention_inputs(6, sq=100, skv=300)
    last = bias.copy()
    last[:, :(k.shape[2] - 1) // 128 * 128] = 0.0
    want = mod.run_v2(*(jnp.asarray(x) for x in (q, k, v, last)), 32, 128, 2, "full")
    got = P.attention_v2(t(q), t(k), t(v), t(bias), 128, 128, "last", 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    full = P.attention_v2(t(q), t(k), t(v), t(bias), 128, 128, "full", 2)
    assert (full - got).abs().max().item() > 1e-2  # the earlier tiles' bias is left out


def test_attention_sweep_plain_matches_k4_body_at_ragged_kv():
    """T1: K4's `_flash_kernel` at explicit blocks, as tools/bench_attn_sweep.py
    `_tpu` calls it (block_q 32, block_kv 64, hblk 2), over 200 keys (the
    last tile ragged, its padding masked by the bias) with a zero key bias,
    as the script, vs the plain version. f32: 1e-4 / 1e-5, as K4's test."""
    _tool("bench_attn_sweep")  # the script the case comes from
    q, k, v, _ = _attention_inputs(5)
    bias = np.zeros((1, k.shape[2]), np.float32)
    (b, h, sq, d), hblk, block_q, block_kv = q.shape, 2, 32, 64
    qp, kt, vp, kb, sq_p, skv_p = _padded(q, k, v, bias, block_q, block_kv)
    want = pl.pallas_call(
        functools.partial(JA._flash_kernel, hblk=hblk, has_bias=True),
        grid=(b, h // hblk, sq_p // block_q, skv_p // block_kv),
        out_shape=jax.ShapeDtypeStruct((b, h, sq_p, d), jnp.float32),
        scratch_shapes=[pltpu.VMEM((hblk * block_q, JA._LANES), jnp.float32),
                        pltpu.VMEM((hblk * block_q, JA._LANES), jnp.float32),
                        pltpu.VMEM((hblk * block_q, d), jnp.float32)],
        interpret=True, **_specs(hblk, block_q, block_kv, d))(qp, kt, vp, kb)[:, :, :sq]
    got = P.attention_sweep(t(q), t(k), t(v), t(bias), 128, 64, hblk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cli,args", [
    ("bench_attn_sweep", ["--heads", "2", "--seq", "70"]),
    ("bench_attn_v2", ["--heads", "2", "--seq", "70"]),
    ("bench_int8_loop", ["--shapes", "32x64x16", "--iters", "3", "--check-iters", "2"]),
    ("bench_matmul_hand", ["--m", "40", "--shapes", "32x48"]),
    ("bench_exp2", ["--rows", "8", "--cols", "64", "--n-iter", "4"]),
    ("bench_attn_r3", ["--heads", "4", "--text", "5", "--grid", "1x3x8", "--vip-grid", "1x4x5"]),
    ("bench_cross_r3", ["--heads", "4", "--text", "5", "--grid", "1x3x8", "--vip-grid", "1x4x5"]),
])
def test_probe_cli_runs_on_cpu(cli, args, capsys):
    """Each probe CLI with ``--device cpu`` at a tiny size: one line per case,
    the plain versions on the host (zero error against themselves), and no
    kernel launched."""
    P.reset_launch_counts()
    mod = importlib.import_module(f"tokensgen_tpu_torch.tools.{cli}")
    results = mod.main(["--device", "cpu", "--runs", "1", *args])
    out = capsys.readouterr().out
    assert results and all(r["rel_l2_err"] == 0.0 and r["ms"] > 0 for r in results)
    assert out.count(" ms ") >= len(results)
    assert all(n == 0 for n in P.launch_counts().values())
