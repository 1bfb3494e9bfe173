"""Port parity: the int8 serving modes. `quantize_dit` against the JAX
`quantize_dit_params` (codes and scales bit-equal from the same f32
weights), `QuantLinear` against `QuantDense`, the tiny DiT at w8a16 and
w8a8 against the JAX one (quant_attn off: the JAX CPU path ignores
int8_scores), and quant_attn (K7's plain version on the host) within
tests/test_quant.py's w8a8 tolerance of the float model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2 as jrope
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.models.layers import QuantDense
from tokensgen_tpu_torch.convert.from_jax import dit_state_dict, to_torch
from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2 as trope
from tokensgen_tpu_torch.kernels import attention as TA
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.models.layers import QuantLinear, _int8_matmul

from _torch_parity import np_tree, t

F, H, W = 2, 8, 16  # latent frames and size of DiTConfig.tiny
VIP = dict(output_dim=24, num_temporal_queries=2, num_height_queries=2, num_width_queries=3,
           length=2 * 2 * 3)


def _configs(**kw):
    return (JD.DiTConfig.tiny(vip=JD.VIPConfig(**VIP), **kw),
            TD.DiTConfig.tiny(vip=TD.VIPConfig(**VIP), **kw))


def _ropes(d):
    grids = [(np.arange(F), np.arange(H // 2), np.arange(W // 2)),
             (np.arange(F) + 3.0, np.arange(H // 2), np.arange(W // 2)),
             (np.linspace(1000, 1002, 2, endpoint=False), np.arange(2), np.arange(3))]
    return [jrope(d, *g) for g in grids], [trope(d, *g) for g in grids]


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, F, 16, H, W)).astype(np.float32)
    text = rng.normal(size=(2, cfg.max_text_seq_length, cfg.text_embed_dim)).astype(np.float32)
    vip = rng.normal(size=(2, 2, 24, 2, 3)).astype(np.float32)
    return x, text, np.array([900, 300]), vip


@pytest.fixture(scope="module")
def float_params():
    jcfg, _ = _configs()
    jr, _ = _ropes(jcfg.attention_head_dim)
    x, text, ts, vip = _inputs(jcfg)
    params = jax.jit(JD.CogVideoXTransformer(jcfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(text), jnp.asarray(ts),
        vip_hidden_states=jnp.asarray(vip), image_rotary_emb=jr[0], vip_image_rotary_emb=jr[1],
        vip_condition_rotary_emb=jr[2])
    return JD.graft_vip_params(params["params"], jcfg)


def _float_port_model(tree, tcfg):
    model = TD.CogVideoXTransformer(dataclasses.replace(tcfg, quant=None, quant_attn=False))
    model.load_state_dict(to_torch(dit_state_dict(np_tree(tree), tcfg)), strict=True)
    return model.eval()


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_quantize_dit_codes_bit_equal_to_jax(float_params, mode):
    """Every int8 code and f32 scale of `quantize_dit` equals the JAX
    `quantize_dit_params` one from the same f32 weights, and the converted
    JAX quantized tree loads strictly into a port model built with ``quant``."""
    jcfg, tcfg = _configs(quant=mode)
    want = dit_state_dict(np_tree(JD.quantize_dit_params(float_params, jcfg)), tcfg)
    model = TD.quantize_dit(_float_port_model(float_params, tcfg), tcfg)
    got = model.state_dict()
    assert set(got) == set(want)
    quantized = [k for k in got if k.endswith((".weight_q", ".scale"))]
    assert len(quantized) == 2 * 9 * tcfg.num_layers  # 9 projections per block
    for k in quantized:
        assert got[k].dtype == (torch.int8 if k.endswith("weight_q") else torch.float32), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    loaded = TD.CogVideoXTransformer(tcfg)
    loaded.load_state_dict(to_torch(want), strict=True)


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_quant_linear_matches_quant_dense(mode):
    """QuantLinear vs QuantDense on the same codes, scales and input, f32
    compute: 1e-5 relative (the float epilogue in another order of the
    matmul's sums; the w8a8 integer product itself is exact)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 9, 32)).astype(np.float32)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    scale = np.maximum(np.abs(w).max(0), 1e-12).astype(np.float32) / np.float32(127.0)
    kq = np.clip(np.round(w / scale[None]), -127, 127).astype(np.int8)
    ref = QuantDense(features=24, mode=mode, dtype=jnp.float32).apply(
        {"params": {"kernel_q": kq, "scale": scale, "bias": b}}, jnp.asarray(x))
    lin = QuantLinear(32, 24, mode, dtype=torch.float32)
    lin.load_state_dict({"weight_q": torch.from_numpy(kq.T.copy()), "scale": t(scale),
                         "bias": t(b)})
    np.testing.assert_allclose(lin(t(x)).numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_int8_matmul_is_exact():
    """The w8a8 accumulator: int8 x int8 -> int32 equals the int64 product,
    including the extremes (+-127 over 4096-deep rows)."""
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, size=(20, 4096)).astype(np.int8)
    b = rng.integers(-127, 128, size=(24, 4096)).astype(np.int8)
    a[0], b[0] = 127, -127
    got = _int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_quant_dit_matches_jax(float_params, mode):
    """The tiny DiT (VIP "1") quantized on each side from the same weights,
    one forward: 1e-4 (f32; an activation code that lands on a rounding
    tie in one framework and not the other moves its row by one step)."""
    jcfg, tcfg = _configs(quant=mode)
    jr, tr = _ropes(jcfg.attention_head_dim)
    x, text, ts, vip = _inputs(jcfg, seed=2)
    ref = JD.CogVideoXTransformer(jcfg).apply(
        {"params": JD.quantize_dit_params(float_params, jcfg)}, jnp.asarray(x), jnp.asarray(text),
        jnp.asarray(ts), vip_hidden_states=jnp.asarray(vip), image_rotary_emb=jr[0],
        vip_image_rotary_emb=jr[1], vip_condition_rotary_emb=jr[2], vip_scale=jnp.asarray(0.6))
    model = TD.quantize_dit(_float_port_model(float_params, tcfg), tcfg)
    with torch.no_grad():
        out = model(t(x), t(text), torch.from_numpy(ts), t(vip), tr[0], tr[1], tr[2], 0.6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_quant_attn_tracks_float_model(monkeypatch):
    """A tiny d=64 DiT at w8a8 with quant_attn stays within 0.12 of the
    float model (max abs error over max |ref|, tests/test_quant.py:51's w8a8
    bound), and its attention went through K7's entry point (its plain
    version on the host) three times per block: at these lengths the VIP
    cross calls are joint calls too (the small-side routing starts past
    2048 rows, as in the JAX package)."""
    jcfg, tcfg = _configs(attention_head_dim=64)
    jr, tr = _ropes(64)
    x, text, ts, vip = _inputs(jcfg, seed=5)
    params = jax.jit(JD.CogVideoXTransformer(jcfg).init)(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(text), jnp.asarray(ts),
        vip_hidden_states=jnp.asarray(vip), image_rotary_emb=jr[0], vip_image_rotary_emb=jr[1],
        vip_condition_rotary_emb=jr[2])
    tree = JD.graft_vip_params(params["params"], jcfg)
    args = (t(x), t(text), torch.from_numpy(ts), t(vip), tr[0], tr[1], tr[2], 0.6)
    with torch.no_grad():
        ref = _float_port_model(tree, tcfg)(*args)
        calls = []
        real = TA.fused_attention_joint_int8
        monkeypatch.setattr(TA, "fused_attention_joint_int8",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        qcfg = dataclasses.replace(tcfg, quant="w8a8", quant_attn=True)
        out = TD.quantize_dit(_float_port_model(tree, tcfg), qcfg)(*args)
    assert len(calls) == 3 * tcfg.num_layers
    assert torch.isfinite(out).all()
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    assert 0 < err < 0.12, err
