"""Port parity: core math (schedule, rope, cfg) of tokensgen_tpu_torch against
tokensgen_tpu. Tables built by the same numpy code must be bit-equal; float32
tensor math is held to 1e-6 relative / 1e-5 absolute (op-order rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core import cfg as Jc
from tokensgen_tpu.core import rope as Jr
from tokensgen_tpu.core import schedule as Js
from tokensgen_tpu_torch.core import cfg as Tc
from tokensgen_tpu_torch.core import rope as Tr
from tokensgen_tpu_torch.core import schedule as Ts

from _torch_parity import t

SCHEDULES = [
    dict(),
    dict(beta_schedule="linear"),
    dict(beta_schedule="vip_1"),
    dict(rescale_betas_zero_snr=False, set_alpha_to_one=False),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_tables_bit_equal(kw):
    js = Js.make_schedule(Js.ScheduleConfig(**kw))
    ts = Ts.make_schedule(Ts.ScheduleConfig(**kw))
    np.testing.assert_array_equal(np.asarray(js.betas), ts.betas.numpy())
    np.testing.assert_array_equal(np.asarray(js.alphas_cumprod), ts.alphas_cumprod.numpy())
    np.testing.assert_array_equal(np.asarray(js.final_alpha_cumprod),
                                  ts.final_alpha_cumprod.numpy())


@pytest.mark.parametrize("spacing", ["linspace", "leading", "trailing"])
@pytest.mark.parametrize("steps", [13, 52])
def test_inference_timesteps_equal(spacing, steps):
    jcfg = Js.ScheduleConfig(timestep_spacing=spacing)
    tcfg = Ts.ScheduleConfig(timestep_spacing=spacing)
    np.testing.assert_array_equal(Js.inference_timesteps(jcfg, steps),
                                  Ts.inference_timesteps(tcfg, steps))


def _step_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shape = (2, 5, 3, 4, 6)
    sample, out, old, n1, n2 = (rng.normal(size=shape).astype(np.float32) for _ in range(5))
    ts = np.array([[999, 900, 500, 20, 0], [979, 960, 40, 19, 1]])
    prev = np.array([[960, 800, 400, 0, -1], [960, 940, 20, -1, -1]])
    back = np.array([[-1, 999, 600, 40, 20], [999, 979, 60, 39, 19]])
    valid = np.array([[False, True, True, True, True], [True, False, True, True, False]])
    return sample, out, old, n1, n2, ts, prev, back, valid


@pytest.mark.parametrize("stochastic", [True, False])
def test_dpm_step_matches_with_injected_noise(stochastic):
    sample, out, old, n1, n2, ts, prev, back, valid = _step_inputs()
    js, tsd = Js.make_schedule(), Ts.make_schedule()
    jn = (jnp.asarray(n1), jnp.asarray(n2)) if stochastic else (None, None)
    tn = (t(n1), t(n2)) if stochastic else (None, None)
    jl, jx = Js.dpm_step(js, jnp.asarray(out), jnp.asarray(sample), jnp.asarray(ts),
                         jnp.asarray(prev), t_back=jnp.asarray(back),
                         old_pred_original_sample=jnp.asarray(old), old_valid=jnp.asarray(valid),
                         noise=jn[0], noise2=jn[1])
    tl, tx = Ts.dpm_step(tsd, t(out), t(sample), torch.from_numpy(ts), torch.from_numpy(prev),
                         t_back=torch.from_numpy(back), old_pred_original_sample=t(old),
                         old_valid=torch.from_numpy(valid), noise=tn[0], noise2=tn[1])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-5)


def test_first_order_and_ddim_and_noise_ops():
    sample, out, _, n1, _, ts, prev, _, _ = _step_inputs(1)
    js, tsd = Js.make_schedule(), Ts.make_schedule()
    jl, _ = Js.dpm_step(js, jnp.asarray(out), jnp.asarray(sample), jnp.asarray(ts),
                        jnp.asarray(prev), noise=jnp.asarray(n1))
    tl, _ = Ts.dpm_step(tsd, t(out), t(sample), torch.from_numpy(ts), torch.from_numpy(prev),
                        noise=t(n1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-5)
    jd, jx = Js.ddim_step(js, jnp.asarray(out), jnp.asarray(sample), jnp.asarray(ts),
                          jnp.asarray(prev))
    td, tx = Ts.ddim_step(tsd, t(out), t(sample), torch.from_numpy(ts), torch.from_numpy(prev))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-5)
    t999 = np.full((2,), 999)
    np.testing.assert_allclose(
        Ts.add_noise_to_xt(tsd, t(sample), t(n1), torch.from_numpy(t999)).numpy(),
        np.asarray(Js.add_noise_to_xt(js, jnp.asarray(sample), jnp.asarray(n1),
                                      jnp.asarray(t999))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        Ts.add_noise(tsd, t(sample), t(n1), torch.from_numpy(ts)).numpy(),
        np.asarray(Js.add_noise(js, jnp.asarray(sample), jnp.asarray(n1), jnp.asarray(ts))),
        rtol=1e-6, atol=1e-6)


def test_rope_tables_equal():
    crops = ([0, 0, 0], [13, 30, 45])
    jc, js_ = Jr.get_3d_rotary_pos_embed(64, crops, (13, 30, 45))
    tc, ts_ = Tr.get_3d_rotary_pos_embed(64, crops, (13, 30, 45))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js_), ts_.numpy())
    g = (np.linspace(1000, 1013, 4, endpoint=False, dtype=np.float32),
         np.arange(8, dtype=np.float32), np.arange(12, dtype=np.float32))
    jc, js_ = Jr.get_3d_rotary_pos_embed_v2(64, *g, dim_t=16, dim_h=24, dim_w=24)
    tc, ts_ = Tr.get_3d_rotary_pos_embed_v2(64, *g, dim_t=16, dim_h=24, dim_w=24)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js_), ts_.numpy())


def test_tensor_grid_rope_matches_traced_variant():
    gt = np.array([3.0, 4.0, 5.0, 1000.0], np.float32)
    gh, gw = np.arange(4, dtype=np.float32), np.arange(6, dtype=np.float32)
    jc, js_ = Jr.get_3d_rotary_pos_embed_v2_jnp(64, jnp.asarray(gt), jnp.asarray(gh),
                                                jnp.asarray(gw))
    tc, ts_ = Tr.get_3d_rotary_pos_embed_v2_torch(64, t(gt), t(gh), t(gw))
    # the angle product of a 1000-position grid: cos/sin of ~1e3 rad in f32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), rtol=0, atol=1e-4)


@pytest.mark.parametrize("batched", [False, True])
def test_apply_rotary_emb(batched):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 10, 16)).astype(np.float32)
    ang = rng.normal(size=((2,) if batched else ()) + (10, 16)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    j = Jr.apply_rotary_emb(jnp.asarray(x), (jnp.asarray(cos), jnp.asarray(sin)))
    tt = Tr.apply_rotary_emb(t(x), (t(cos), t(sin)))
    np.testing.assert_allclose(tt.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("separate", [False, True])
@pytest.mark.parametrize("per_frame", [False, True])
def test_cfg_combine(separate, per_frame):
    rng = np.random.default_rng(3)
    n = 3 if separate else 2
    pred = rng.normal(size=(n, 5, 2, 3, 4)).astype(np.float32)
    g = rng.uniform(1, 7, size=(5,)).astype(np.float32) if per_frame else 6.0
    gi = rng.uniform(1, 2, size=(5,)).astype(np.float32) if per_frame else 1.5
    j = Jc.combine(jnp.asarray(pred), jnp.asarray(g), jnp.asarray(gi), separate)
    tt = Tc.combine(t(pred), torch.as_tensor(g), torch.as_tensor(gi), separate)
    np.testing.assert_allclose(tt.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    lat = rng.normal(size=(1, 5, 2, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(Tc.batch_for_cfg(t(lat), True, separate).numpy(),
                                  np.asarray(Jc.batch_for_cfg(jnp.asarray(lat), True, separate)))


def test_dynamic_scale_table_equal():
    np.testing.assert_array_equal(Jc.dynamic_scale_table(6.0, 52),
                                  Tc.dynamic_scale_table(6.0, 52))
