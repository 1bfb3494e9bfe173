"""Port parity for T5, the pair-loop smallkv probe of kernels/probes.py
(`cross_smallkv_pairloop`), whose CPU path is the max-free probes' shared
plain version `attention_maxfree_plain`, against the JAX script's own
wrapper (tools/bench_cross_pairloop.py `cross_smallkv_pairloop`) run with
``interpret=True``; nothing in tools/ changes. The wrapper hands its
pallas_call the key bias bias * log2 e - C, so the score shift C it computed
is read there (at a key whose bias is 0) and held to `probes.score_shift`,
capped at 120 and not. Inputs: numpy-seeded, 4 heads of 64, 56 q rows (8
text + 1 x 4 x 12 video) against 40 vip keys, q blocks of 32 (ragged); the
tables are the script's (`make_prologue` with g = |N(0, 1)| + 0.5 and the
3-D RoPE), built by the JAX package and handed to both. Then the CLI with
``--device cpu``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2
from tokensgen_tpu.kernels import attention as JA
from tokensgen_tpu_torch.kernels import probes as P

from _torch_parity import t

D, HEADS, BLOCK_Q = 64, 4, 32
TEXT, GRID, VIP_GRID = 8, (1, 4, 12), (1, 4, 10)  # 56 q rows, 40 vip keys


def _pairloop(monkeypatch):
    """tools/bench_cross_pairloop.py with a pallas_call that records the key
    bias it is handed; returns the module and the dict that receives it."""
    mod = importlib.import_module("tools.bench_cross_pairloop")
    seen = {}
    call = mod.pl.pallas_call

    def recording_call(*args, **kwargs):
        fn = call(*args, **kwargs)

        def run(*operands):
            seen["key_bias"] = np.asarray(operands[3])
            return fn(*operands)
        return run

    monkeypatch.setattr(mod.pl, "pallas_call", recording_call)
    return mod, seen


def _inputs(seed, g_scale=1.0):
    """q over [text || video], the vip k / v, and the script's vip-side
    tables (q: the joint rows, k: the vip rows), as JAX arrays."""
    rng = np.random.default_rng(seed)
    s_q = TEXT + int(np.prod(GRID))
    s_vip = int(np.prod(VIP_GRID))

    def x(s):
        return jnp.asarray(rng.standard_normal((1, s, HEADS * D)).astype(np.float32), jnp.bfloat16)

    q, k, v = x(s_q), x(s_vip), x(s_vip)
    g = jnp.asarray(g_scale * (np.abs(rng.standard_normal(D)) + 0.5), jnp.float32)
    bs = jnp.asarray(0.1 * rng.standard_normal(D), jnp.float32)
    rope = get_3d_rotary_pos_embed_v2(D, np.arange(GRID[0]) + 1000,
                                      *(np.arange(n) for n in GRID[1:]))
    vip_rope = get_3d_rotary_pos_embed_v2(D, np.arange(VIP_GRID[0]) + 1000,
                                          *(np.arange(n) for n in VIP_GRID[1:]))
    segs = [(None, TEXT), (rope, s_q - TEXT), (vip_rope, s_vip)]
    vtq = JA.make_prologue(D, segs, g, bs, fold=D ** -0.5)
    vtk = JA.make_prologue(D, segs, g, bs)
    return q, k, v, JA.slice_tabs(vtq, 0, s_q), JA.slice_tabs(vtk, s_q, None)


def _tt(x):
    """A JAX array or table tuple as torch (bf16 operands, f32 tables)."""
    if isinstance(x, tuple):
        return tuple(t(np.asarray(a)) for a in x)
    return t(np.asarray(x.astype(jnp.float32)), torch.bfloat16)


@pytest.mark.parametrize("capped", [True, False], ids=["capped", "uncapped"])
def test_pairloop_plain_matches_jax_pairloop(monkeypatch, capped):
    """T5 on CPU tensors (the plain version) against the script's
    `cross_smallkv_pairloop(..., interpret=True)` at block_q 32, with a key
    bias up to 0.7 (0 at key 0): the output within 2 bf16 ulps of its
    largest magnitude (both round p and the output to bf16 after f32 sums
    taken in another order; T4a's test holds the same bound), and the
    wrapper's C equal to `score_shift` to 1e-6 relative. At the script's g (|N(0, 1)| + 0.5)
    the bound product is in the hundreds and the cap binds; at g / 20 it is
    below 1 and C is the bound plus the bias term."""
    mod, seen = _pairloop(monkeypatch)
    q, k, v, tq, tk = _inputs(20 if capped else 21, g_scale=1.0 if capped else 0.05)
    bias = np.zeros((1, k.shape[1]), np.float32)
    bias[0, 1:] = np.linspace(-0.5, 0.7, k.shape[1] - 1)
    with jax.disable_jit():  # the operands pallas_call receives are concrete arrays
        want = mod.cross_smallkv_pairloop(q, k, v, jnp.asarray(bias), tq, tk, HEADS, BLOCK_Q,
                                          1e-6, True, True, interpret=True)
    got = P.cross_smallkv_pairloop(_tt(q), _tt(k), _tt(v), t(bias), _tt(tq), _tt(tk), HEADS,
                                   BLOCK_Q)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape == (1, q.shape[1], HEADS * D)
    atol = 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    c_jax = -seen["key_bias"][0, 0, 0]
    c = P.score_shift(_tt(tq), _tt(tk), t(bias)).item()
    np.testing.assert_allclose(c, c_jax, rtol=1e-6)
    assert (c == P.SHIFT_CAP) == capped
    if not capped:
        assert 0.7 * JA._LOG2E < c < 3.0


def test_pairloop_cli_runs_on_cpu(capsys):
    """`python -m tokensgen_tpu_torch.tools.bench_cross_pairloop --device cpu`
    at a tiny size and B = 2: the shipped line, then one line per q block of
    `PAIRLOOP_BLOCK_Q` (the plain version against itself: zero error), and
    no kernel launched."""
    P.reset_launch_counts()
    mod = importlib.import_module("tokensgen_tpu_torch.tools.bench_cross_pairloop")
    results = mod.main(["--device", "cpu", "--runs", "1", "--batch", "2", "--heads", "4",
                        "--text", "5", "--grid", "1x3x8", "--vip-grid", "1x4x5"])
    out = capsys.readouterr().out
    assert [r["block_q"] for r in results] == list(P.PAIRLOOP_BLOCK_Q)
    assert all(r["rel_l2_err"] == 0.0 and r["ms"] > 0 and r["speedup"] > 0 for r in results)
    assert "(shipped)" in out and out.count("speedup") == len(results)
    assert all(n == 0 for n in P.launch_counts().values())
