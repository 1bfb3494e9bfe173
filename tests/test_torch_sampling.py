"""Port parity: sampling/base.py `denoise` and sampling/fifo.py
`fifo_generate` against the JAX samplers, with the JAX package's own noise
replayed into the port. Geometry of tests/test_fifo.py (steps 8, 4-frame
windows, 2 partitions -> 4 lookahead ranks, 12 iterations). The model is the
exact-v oracle plus a CFG-branch offset and, with VIP, terms read from the
VIP tokens and rolling rope tables, so the bookkeeping of both shows.
f32 solver arithmetic over 20 steps: 2e-5 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core import schedule as JS
from tokensgen_tpu.sampling import base as JB
from tokensgen_tpu.sampling import fifo as JF
from tokensgen_tpu_torch.core import schedule as TS
from tokensgen_tpu_torch.sampling import base as TB
from tokensgen_tpu_torch.sampling import fifo as TF

from _torch_parity import jax_noise, t

STEPS, NF, PARTS = 8, 4, 2
TARGET = np.random.default_rng(0).normal(size=(1, 1, 2, 4, 4)).astype(np.float32)
CFG_OFFSET = np.array([0.0, 0.05], np.float32)  # uncond / cond branch


def _jax_model(sched):
    def model(params, lat_cfg, t2d, vip_kwargs=None):
        ap = sched.alphas_cumprod[jnp.clip(t2d, 0, 999)][:, :, None, None, None]
        v = (ap ** 0.5 * lat_cfg - TARGET) / (1 - ap) ** 0.5
        v = v + jnp.asarray(CFG_OFFSET)[:, None, None, None, None]
        if vip_kwargs is not None:
            v = v + 0.01 * jnp.mean(vip_kwargs["vip_hidden_states"], axis=(1, 2, 3, 4))[
                :, None, None, None, None]
            v = v + 0.01 * jnp.mean(vip_kwargs["vip_image_rotary_emb"][0])
            v = v + 0.01 * jnp.mean(vip_kwargs["vip_condition_rotary_emb"][1])
        return v
    return model


def _torch_model(sched):
    tgt, off = t(TARGET), t(CFG_OFFSET)

    def model(lat_cfg, t2d, vip_kwargs=None):
        ap = sched.alphas_cumprod[t2d.clamp(0, 999)][:, :, None, None, None]
        v = (ap ** 0.5 * lat_cfg - tgt) / (1 - ap) ** 0.5 + off[:, None, None, None, None]
        if vip_kwargs is not None:
            v = v + 0.01 * vip_kwargs["vip_hidden_states"].mean(dim=(1, 2, 3, 4))[
                :, None, None, None, None]
            v = v + 0.01 * vip_kwargs["vip_image_rotary_emb"][0].mean()
            v = v + 0.01 * vip_kwargs["vip_condition_rotary_emb"][1].mean()
        return v
    return model


@pytest.fixture(scope="module")
def base_run():
    jsched, tsched = JS.make_schedule(), TS.make_schedule()
    scfg = dict(num_inference_steps=STEPS, collect_fifo=True, stochastic=True,
                use_dynamic_cfg=True)
    lat0 = np.random.default_rng(1).normal(size=(1, NF, 2, 4, 4)).astype(np.float32)
    jm = _jax_model(jsched)
    rng = jax.random.PRNGKey(5)
    jres = JB.denoise(lambda lat, tv: jm(None, lat, tv[:, None] * jnp.ones((1, NF), jnp.int32)),
                      jsched, JB.SamplerConfig(**scfg), jnp.asarray(lat0), rng=rng)
    tm = _torch_model(tsched)
    tres = TB.denoise(lambda lat, tv: tm(lat, tv[:, None].expand(-1, NF)), tsched,
                      TB.SamplerConfig(**scfg), t(lat0),
                      noise_fn=jax_noise(base_rng=rng, base_steps=STEPS))
    return jsched, tsched, jres, tres


def test_denoise_matches_jax(base_run):
    _, _, jres, tres = base_run
    for name in ("latents", "fifo_latents", "fifo_old_x0"):
        np.testing.assert_allclose(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                   rtol=1e-5, atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(tres.fifo_old_valid.numpy(), np.asarray(jres.fifo_old_valid))


def _vip_states():
    rng = np.random.default_rng(4)
    q, iters = 2 + STEPS, 8 + STEPS - NF
    g_full = np.concatenate([np.zeros(6), np.arange(q + iters - 6)]).astype(np.float32)
    cond_t = (1000 + np.arange(12) * 2.0).astype(np.float32)
    emb = rng.normal(size=(2, 12, 3, 2, 2)).astype(np.float32)
    gh, gw = np.arange(2, dtype=np.float32), np.arange(2, dtype=np.float32)
    jv = JF.VIPState(jnp.asarray(emb), jnp.asarray(g_full), jnp.asarray(cond_t), gh, gw, gh, gw, 2)
    tv = TF.VIPState(t(emb), t(g_full), t(cond_t), t(gh), t(gw), t(gh), t(gw), 2)
    return jv, tv


@pytest.mark.parametrize("variant", ["stochastic_xt", "deterministic_randn", "vip_dynamic_cfg",
                                     "no_lookahead"])
def test_fifo_matches_jax(base_run, variant):
    jsched, tsched, jres, _ = base_run
    kw = dict(nf_per_chunk=NF, num_partitions=PARTS, num_inference_steps=STEPS, num_frames=8,
              stochastic=variant != "deterministic_randn",
              tail_renoise_mode="randn" if variant == "deterministic_randn" else "xt",
              use_dynamic_cfg=variant == "vip_dynamic_cfg",
              lookahead_denoising=variant != "no_lookahead")
    jfc, tfc = JF.FIFOConfig(**kw), TF.FIFOConfig(**kw)
    jv, tv = _vip_states() if variant == "vip_dynamic_cfg" else (None, None)
    ts = JS.inference_timesteps(jsched.config, STEPS)
    jseed = JF.FIFOSeed(jres.fifo_latents, jres.fifo_old_x0, jres.fifo_old_valid, ts, None, jv)
    tseed = TF.FIFOSeed(t(jres.fifo_latents), t(jres.fifo_old_x0),
                        torch.from_numpy(np.array(jres.fifo_old_valid)), ts, None, tv)
    rng = jax.random.PRNGKey(7)
    jout = JF.fifo_generate(_jax_model(jsched), None, jsched, jfc, jseed, rng=rng)
    tout = TF.fifo_generate(_torch_model(tsched), tsched, tfc, tseed,
                            jax_noise(fifo_rng=rng, fifo_iters=tfc.num_iterations))
    assert tout.all_emitted.shape == (1, tfc.num_iterations, 2, 4, 4)
    np.testing.assert_allclose(tout.all_emitted.numpy(), np.asarray(jout.all_emitted),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(tout.latents.numpy(), np.asarray(jout.latents),
                               rtol=1e-5, atol=2e-5)


def test_fifo_rejects_short_queue(base_run):
    _, tsched, _, tres = base_run
    fcfg = TF.FIFOConfig(nf_per_chunk=NF, num_partitions=PARTS, num_inference_steps=NF - 1)
    seed = TF.FIFOSeed(tres.fifo_latents, tres.fifo_old_x0, tres.fifo_old_valid,
                       np.arange(NF - 1)[::-1], None)
    with pytest.raises(ValueError, match="num_inference_steps >= nf_per_chunk"):
        TF.fifo_generate(_torch_model(tsched), tsched, fcfg, seed, lambda tag, s: torch.zeros(s))
