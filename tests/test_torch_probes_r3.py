"""Port parity for the max-free attention probes of kernels/probes.py (T3a
`attention_splitpv`, T3b `attention_pair2`, T4a `cross_smallkv_pairinner`,
T4b `cross_smallq_splitkv`), whose CPU path is their shared plain version
`attention_maxfree_plain`, against the JAX scripts' own wrappers
(tools/bench_attn_r3.py `run_splitpv`, `run_pair2`; tools/bench_cross_r3.py
`run_smallkv`, `run_smallq`) run in interpret mode: the scripts'
`pl.pallas_call` takes interpret=True through monkeypatch, nothing in
tools/ changes. Each wrapper hands its pallas_call the key bias
bias * log2 e - C, so the score shift C it computed is read there (at a key
whose bias is 0) and held to `probes.score_shift`. Inputs: numpy-seeded,
heads 4 of 64, ragged tiles; the tables are the scripts' (`make_prologue`
with g = |N(0, 1)| + 0.5 and the 3-D RoPE), built by the JAX package and
handed to both. The two CLIs' --device cpu runs are cases of
tests/test_torch_probes.py::test_probe_cli_runs_on_cpu."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2
from tokensgen_tpu.kernels import attention as JA
from tokensgen_tpu_torch.kernels import probes as P

from _torch_parity import t

D, HEADS = 64, 4
TEXT, GRID, VIP_GRID = 5, (1, 3, 8), (1, 4, 5)  # 29 joint tokens, 20 vip tokens


def _tool(name, monkeypatch):
    """tools/<name>.py with its pallas_call in interpret mode; returns the
    module and a dict that receives the key bias of its last call."""
    mod = importlib.import_module(f"tools.{name}")
    seen = {}
    call = mod.pl.pallas_call

    def interpret_call(*args, **kwargs):
        fn = call(*args, interpret=True, **kwargs)

        def run(*operands):
            seen["key_bias"] = np.asarray(operands[3])
            return fn(*operands)
        return run

    monkeypatch.setattr(mod.pl, "pallas_call", interpret_call)
    return mod, seen


def _inputs(seed, g_offset=0.5, g_scale=1.0):
    """The scripts' tensors at a small size: q, k, v over the joint
    sequence, vip k / v and q, the joint tables (tq, tk) and the vip ones
    (tq_tv, tk_vip, tq_vip, vtk), as numpy / JAX arrays."""
    rng = np.random.default_rng(seed)
    s_joint = TEXT + int(np.prod(GRID))
    s_vip = int(np.prod(VIP_GRID))

    def x(s):
        return jnp.asarray(rng.standard_normal((1, s, HEADS * D)).astype(np.float32), jnp.bfloat16)

    q, k, v, kv, vv, qv = x(s_joint), x(s_joint), x(s_joint), x(s_vip), x(s_vip), x(s_vip)
    g = jnp.asarray(g_scale * (np.abs(rng.standard_normal(D)) + g_offset), jnp.float32)
    bs = jnp.asarray(0.1 * rng.standard_normal(D), jnp.float32)
    rope = get_3d_rotary_pos_embed_v2(D, *(np.arange(n) for n in GRID))
    segs = [(None, TEXT), (rope, s_joint - TEXT)]
    tq = JA.make_prologue(D, segs, g, bs, fold=D ** -0.5)
    tk = JA.make_prologue(D, segs, g, bs)
    vip_rope = get_3d_rotary_pos_embed_v2(D, np.arange(GRID[0]) + 1000,
                                          *(np.arange(n) for n in GRID[1:]))
    cond_rope = get_3d_rotary_pos_embed_v2(D, np.arange(VIP_GRID[0]) + 1000,
                                           *(np.arange(n) for n in VIP_GRID[1:]))
    vsegs = [(None, TEXT), (vip_rope, s_joint - TEXT), (cond_rope, s_vip)]
    vtq = JA.make_prologue(D, vsegs, g, bs, fold=D ** -0.5)
    vtk = JA.make_prologue(D, vsegs, g, bs)
    return dict(q=q, k=k, v=v, kv=kv, vv=vv, qv=qv, tq=tq, tk=tk,
                tq_tv=JA.slice_tabs(vtq, 0, s_joint), tk_vip=JA.slice_tabs(vtk, s_joint, None),
                tq_vip=JA.slice_tabs(vtq, s_joint, None), vtk=vtk)


def _tt(x):
    """A JAX array or table tuple as torch (bf16 operands, f32 tables)."""
    if isinstance(x, tuple):
        return tuple(t(np.asarray(a)) for a in x)
    return t(np.asarray(x.astype(jnp.float32)), torch.bfloat16)


def _bias(skv, positive: bool):
    """A key bias that is 0 at key 0 (where C is read) and, if ``positive``,
    up to 0.7 elsewhere (the max(bias, 0) term of C)."""
    bias = np.zeros((1, skv), np.float32)
    if positive:
        bias[0, 1:] = np.linspace(-0.5, 0.7, skv - 1)
    return bias


def _assert_close(got, want, c_jax, tabs_q, tabs_k, bias):
    """Output within 2 bf16 ulps of its largest magnitude (the plain version
    and the interpret-mode kernel round p and the output to bf16 after f32
    sums taken in another order); C to 1e-6 relative."""
    want = np.asarray(want.astype(jnp.float32))
    atol = 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    c = P.score_shift(tabs_q, tabs_k, None if bias is None else t(bias)).item()
    np.testing.assert_allclose(c, c_jax, rtol=1e-6)
    return c


def test_splitpv_plain_matches_run_splitpv(monkeypatch):
    """T3a: `run_splitpv` at block_q = block_kv = 16 over 29 joint tokens
    (ragged q and kv tiles), zero key bias, the scripts' tables: C capped."""
    mod, seen = _tool("bench_attn_r3", monkeypatch)
    c = _inputs(0)
    zb = np.zeros((1, c["k"].shape[1]), np.float32)
    want = mod.run_splitpv(c["q"], c["k"], c["v"], jnp.asarray(zb), c["tq"], c["tk"], HEADS,
                           16, 16)
    got = P.attention_splitpv(_tt(c["q"]), _tt(c["k"]), _tt(c["v"]), t(zb), _tt(c["tq"]),
                              _tt(c["tk"]), HEADS)
    shift = _assert_close(got, want, -seen["key_bias"][0, 0, 0], _tt(c["tq"]), _tt(c["tk"]), zb)
    assert shift == P.SHIFT_CAP


def test_pair2_plain_matches_run_pair2(monkeypatch):
    """T3b: `run_pair2` (both head pairs of the 4 heads in one step) at
    block_q = block_kv = 16 over 29 joint tokens, as T3a's test."""
    mod, seen = _tool("bench_attn_r3", monkeypatch)
    c = _inputs(1)
    zb = np.zeros((1, c["k"].shape[1]), np.float32)
    want = mod.run_pair2(c["q"], c["k"], c["v"], jnp.asarray(zb), c["tq"], c["tk"], HEADS, 16, 16)
    got = P.attention_pair2(_tt(c["q"]), _tt(c["k"]), _tt(c["v"]), t(zb), _tt(c["tq"]),
                            _tt(c["tk"]), HEADS)
    _assert_close(got, want, -seen["key_bias"][0, 0, 0], _tt(c["tq"]), _tt(c["tk"]), zb)


def test_smallkv_plain_matches_run_smallkv(monkeypatch):
    """T4a: `run_smallkv` (k prologued outside the kernel with the unpacked
    tables, block-diagonal K^T / V) at block_q 16: 29 q rows against 20 vip
    keys, zero key bias."""
    mod, seen = _tool("bench_cross_r3", monkeypatch)
    c = _inputs(2)
    zb = np.zeros((1, c["kv"].shape[1]), np.float32)
    want = mod.run_smallkv(c["q"], c["kv"], c["vv"], jnp.asarray(zb), c["tq_tv"], c["tk_vip"],
                           HEADS, 16)
    got = P.cross_smallkv_pairinner(_tt(c["q"]), _tt(c["kv"]), _tt(c["vv"]), t(zb),
                                    _tt(c["tq_tv"]), _tt(c["tk_vip"]), HEADS)
    _assert_close(got, want, -seen["key_bias"][0, 0, 0], _tt(c["tq_tv"]), _tt(c["tk_vip"]), zb)


def _smallq(monkeypatch, c, bias):
    mod, seen = _tool("bench_cross_r3", monkeypatch)
    kcat = jnp.concatenate([c["k"], c["kv"]], axis=1)
    vcat = jnp.concatenate([c["v"], c["vv"]], axis=1)
    want = mod.run_smallq(c["qv"], kcat, vcat, jnp.asarray(bias), c["tq_vip"], c["vtk"], HEADS,
                          16)
    got = P.cross_smallq_splitkv(_tt(c["qv"]), _tt(kcat), _tt(vcat), t(bias), _tt(c["tq_vip"]),
                                 _tt(c["vtk"]), HEADS)
    return _assert_close(got, want, -seen["key_bias"][0, 0, 0], _tt(c["tq_vip"]), _tt(c["vtk"]),
                         bias)


def test_smallq_plain_matches_run_smallq(monkeypatch):
    """T4b: `run_smallq` at block_kv 16: 20 vip q rows against the 49 keys of
    [joint || vip] (ragged), zero key bias. `_smallq_kernel` rotates k with
    the q side's Rg (bench_cross_r3.py:223); the plain version uses k's own,
    which is the same matrix for these tables."""
    c = _inputs(3)
    np.testing.assert_array_equal(np.asarray(c["tq_vip"][3]), np.asarray(c["vtk"][3]))
    assert _smallq(monkeypatch, c, _bias(c["k"].shape[1] + c["kv"].shape[1], False)) == P.SHIFT_CAP


@pytest.mark.parametrize("capped", [True, False], ids=["capped", "uncapped"])
def test_score_shift_matches_jax(monkeypatch, capped):
    """C = min(B_q B_k + max(max(bias log2 e), 0), 120) against the value
    `run_smallq` computes, with a key bias up to 0.7: at the scripts' g
    (|N(0, 1)| + 0.5) the bound product is in the hundreds and the cap
    binds; at g / 20 it is below 1 and C is the bound plus the bias term."""
    c = _inputs(4, g_scale=1.0 if capped else 0.05)
    shift = _smallq(monkeypatch, c, _bias(c["k"].shape[1] + c["kv"].shape[1], True))
    assert (shift == P.SHIFT_CAP) == capped
    if not capped:
        assert 0.7 * JA._LOG2E < shift < 3.0
