"""Port parity: sampling/base.py `denoise` and sampling/fifo.py
`fifo_generate` (its emit / state / resume / cache_idx hooks included)
against the JAX samplers, with the JAX package's own noise replayed into the
port. Geometry of tests/test_fifo.py (steps 8, 4-frame
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


# ---------------------------------------------------------------- FIFO hooks
# The engine's hooks against the JAX host loop (`fifo_generate(host_loop=True)`,
# the JAX noise replayed): the emit series, the cache tracks and a resume from
# a JAX snapshot at the file's tolerance, cache validity bit-equal; and the
# port's own resume drill and stream == one-shot bit-equal under keyed noise.
CACHE_IDX = (0, 5)
HOOK_KW = dict(nf_per_chunk=NF, num_partitions=PARTS, num_inference_steps=STEPS, num_frames=8)


def _seeds(jres):
    ts = JS.inference_timesteps(JS.make_schedule().config, STEPS)
    jv, tv = _vip_states()
    jseed = JF.FIFOSeed(jres.fifo_latents, jres.fifo_old_x0, jres.fifo_old_valid, ts, None, jv)
    tseed = TF.FIFOSeed(t(jres.fifo_latents), t(jres.fifo_old_x0),
                        torch.from_numpy(np.array(jres.fifo_old_valid)), ts, None, tv)
    return jseed, tseed


@pytest.fixture(scope="module")
def jax_host_loop(base_run):
    """JAX host-loop run with emit and state callbacks and cache tracks, and
    a JAX run resumed from its snapshot after iteration 4."""
    jsched, _, jres, _ = base_run
    jseed, _ = _seeds(jres)
    rng = jax.random.PRNGKey(11)
    kw = dict(rng=rng, cache_idx=CACHE_IDX, host_loop=True)
    emits, snaps = {}, {}

    def on_state(i, snapshot):
        snaps[i] = snapshot()

    full = JF.fifo_generate(_jax_model(jsched), None, jsched, JF.FIFOConfig(**HOOK_KW), jseed,
                            emit_callback=lambda i, em: emits.__setitem__(i, em),
                            state_callback=on_state, **kw)
    resumed = JF.fifo_generate(_jax_model(jsched), None, jsched, JF.FIFOConfig(**HOOK_KW), jseed,
                               resume_from=snaps[4], **kw)
    return rng, full, emits, snaps, resumed


def test_keyed_noise_depends_only_on_seed_and_tag():
    a, b = TB.keyed_noise(3, "cpu"), TB.keyed_noise(3, "cpu")
    x = a(("fifo", 2, 1, 0), (2, 3))
    a(("tail", 0), (4,))  # an earlier draw of another tag changes nothing
    assert x.dtype == torch.float32 and x.shape == (2, 3)
    assert torch.equal(b(("fifo", 2, 1, 0), (2, 3)), x)
    assert torch.equal(a(("fifo", np.int64(2), 1, 0), (2, 3)), x)
    assert not torch.equal(a(("fifo", 2, 1, 1), (2, 3)), x)
    assert not torch.equal(TB.keyed_noise(4, "cpu")(("fifo", 2, 1, 0), (2, 3)), x)


def test_fifo_emits_and_cache_tracks_match_jax(base_run, jax_host_loop):
    _, tsched, jres, _ = base_run
    rng, full, jemits, _, _ = jax_host_loop
    _, tseed = _seeds(jres)
    tfc = TF.FIFOConfig(**HOOK_KW)
    emits = {}
    out = TF.fifo_generate(_torch_model(tsched), tsched, tfc, tseed,
                           jax_noise(fifo_rng=rng, fifo_iters=tfc.num_iterations),
                           cache_idx=CACHE_IDX,
                           emit_callback=lambda i, em: emits.__setitem__(i, em))
    assert sorted(emits) == sorted(jemits) == list(range(tfc.num_iterations))
    for i, em in emits.items():
        assert em.device.type == "cpu" and em.shape == (1, 2, 4, 4)
        np.testing.assert_allclose(em.numpy(), np.asarray(jemits[i]), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(out.all_emitted.numpy(), np.asarray(full.all_emitted), rtol=1e-5,
                               atol=2e-5)
    assert out.cache_x0.shape == (2, tfc.num_iterations, 1, 2, 4, 4)
    np.testing.assert_allclose(out.cache_x0.numpy(), np.asarray(full.cache_x0), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(out.cache_valid.numpy(), np.asarray(full.cache_valid))
    assert out.cache_valid.any() and not out.cache_valid.all()


def test_fifo_resumes_from_a_jax_snapshot(base_run, jax_host_loop):
    _, tsched, jres, _ = base_run
    rng, full, _, snaps, resumed = jax_host_loop
    _, tseed = _seeds(jres)
    tfc = TF.FIFOConfig(**HOOK_KW)
    assert snaps[4]["iteration"] == 5
    out = TF.fifo_generate(_torch_model(tsched), tsched, tfc, tseed,
                           jax_noise(fifo_rng=rng, fifo_iters=tfc.num_iterations),
                           cache_idx=CACHE_IDX, resume_from=snaps[4])
    assert out.all_emitted.shape[1] == tfc.num_iterations - 5
    for got, want in ((out.all_emitted, resumed.all_emitted), (out.latents, resumed.latents),
                      (out.all_emitted, np.asarray(full.all_emitted)[:, 5:]),
                      (out.cache_x0, resumed.cache_x0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(out.cache_valid.numpy(), np.asarray(resumed.cache_valid))


def test_fifo_resume_drill_and_stream_are_bit_equal(base_run):
    """Keyed noise: a run killed from its emit callback and resumed from its
    last snapshot emits exactly the uninterrupted run's frames; the emits
    after warm-up, stacked, are exactly its latents; a snapshot thunk kept
    past the end of the run still returns that iteration's state, and a
    snapshot taken is unchanged by the iterations after it."""
    _, tsched, jres, _ = base_run
    _, tseed = _seeds(jres)
    tfc = TF.FIFOConfig(**HOOK_KW)

    def run(**kw):
        return TF.fifo_generate(_torch_model(tsched), tsched, tfc, tseed,
                                TB.keyed_noise(9, "cpu"), cache_idx=CACHE_IDX, **kw)

    full, thunks, taken, copies = {}, {}, {}, {}

    def on_state(i, snapshot):
        thunks[i] = snapshot
        taken[i] = snapshot()
        copies[i] = tuple(x.clone() for x in taken[i]["state"])

    ref = run(emit_callback=lambda i, em: full.__setitem__(i, em), state_callback=on_state)
    warm = STEPS - NF
    assert torch.equal(torch.stack([full[i] for i in sorted(full) if i >= warm], dim=1),
                       ref.latents)
    assert torch.equal(torch.stack([full[i] for i in sorted(full)], dim=1), ref.all_emitted)
    late = thunks[3]()
    assert late["iteration"] == taken[3]["iteration"] == 4
    for a, b, c in zip(late["state"], taken[3]["state"], copies[3]):
        assert torch.equal(a, c) and torch.equal(b, c)

    class Crash(RuntimeError):
        pass

    emits, states = {}, {}

    def on_emit(i, em):
        emits[i] = em
        if i == 6:
            raise Crash()

    def on_every_other(i, snapshot):
        if (i + 1) % 2 == 0:
            states[i] = snapshot()

    with pytest.raises(Crash):
        run(emit_callback=on_emit, state_callback=on_every_other)
    resume_i = max(states)
    assert resume_i == 5
    tail = {}
    out = run(resume_from=states[resume_i], emit_callback=lambda i, em: tail.__setitem__(i, em))
    assert sorted(tail) == list(range(resume_i + 1, tfc.num_iterations))
    stitched = {**{i: emits[i] for i in range(resume_i + 1)}, **tail}
    assert sorted(stitched) == sorted(full)
    for i in full:
        assert torch.equal(stitched[i], full[i]), i
    assert torch.equal(out.cache_x0, ref.cache_x0[:, resume_i + 1:])
    assert torch.equal(out.cache_valid, ref.cache_valid[:, resume_i + 1:])
