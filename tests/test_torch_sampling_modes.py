"""Port parity: the alternate sampling modes against the JAX package.
sampling/freeinit.py (the Butterworth mask, `freq_mix_3d`, `freeinit_refine`
with the JAX draws injected), `To2VPipeline.denoise_together` (plain and
with FreeInit passes, at the tiny geometry, the JAX draws replayed),
DDIM inversion (`core.schedule.ddim_invert_step` for each prediction type,
`sampling.base.ddim_invert`), and the `TOKENSGEN_DEBUG=1` value-range
prints. f32 on the CPU: 1e-5 per function, 1e-4 per pipeline."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core import schedule as JS
from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.models import resampler as JR
from tokensgen_tpu.pipelines import to2v as JP
from tokensgen_tpu.sampling import base as JB
from tokensgen_tpu.sampling import freeinit as JF
from tokensgen_tpu_torch.convert.from_jax import dit_state_dict, to_torch
from tokensgen_tpu_torch.core import schedule as TS
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.models import resampler as TR
from tokensgen_tpu_torch.pipelines import to2v as TP
from tokensgen_tpu_torch.sampling import base as TB
from tokensgen_tpu_torch.sampling import freeinit as TF
from tokensgen_tpu_torch.utils import debug

from _torch_parity import np_tree, random_params, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FN = dict(rtol=1e-5, atol=1e-5)
PIPE = dict(height=32, width=48, num_frames_per_chunk=9, num_inference_steps=4, num_partitions=2)
VIP = dict(output_dim=24, num_temporal_queries=2, num_height_queries=2, num_width_queries=3,
           length=3 * 2 * 3)
CHUNKS, NF = 2, 3


@pytest.mark.parametrize("shape,d_s,d_t,order", [((4, 8, 8), 0.25, 0.25, 4),
                                                 ((6, 5, 7), 1.0, 0.5, 8)])
def test_butterworth_mask_matches_jax(shape, d_s, d_t, order):
    ref = np.asarray(JF.butterworth_low_pass_3d(shape, d_s, d_t, order))
    out = TF.butterworth_low_pass_3d(shape, d_s, d_t, order)
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, **FN)


def test_freq_mix_3d_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 3, 8, 6)).astype(np.float32)
    noise = rng.normal(size=x.shape).astype(np.float32)
    lpf = JF.butterworth_low_pass_3d((4, 8, 6))
    ref = np.asarray(JF.freq_mix_3d(jnp.asarray(x), jnp.asarray(noise), lpf))
    out = TF.freq_mix_3d(t(x), t(noise), TF.butterworth_low_pass_3d((4, 8, 6)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **FN)


def _freeinit_draws(rng, num_iters, base_steps=0):
    """A port noise source replaying `freeinit_refine`'s JAX keys: iteration
    ``it`` splits (rng, r_d, r_n); its denoise's steps draw from split(r_d)
    (as `jax_noise`'s base tags), its fresh noise from r_n and fold_in(r_n, 1)."""
    keys = []
    for _ in range(num_iters):
        rng, r_d, r_n = jax.random.split(rng, 3)
        keys.append((r_d, r_n))

    def draw(tag, shape):
        assert tag[0] == "freeinit", tag
        r_d, r_n = keys[tag[1]]
        if tag[2] == "fresh":
            key = r_n
        elif tag[2] == "fresh2":
            key = jax.random.fold_in(r_n, 1)
        else:
            assert tag[2] == "base", tag
            key = jax.random.split(r_d, base_steps)[tag[3]]
            key = key if tag[4] == 0 else jax.random.fold_in(key, 1)
        return t(jax.random.normal(key, tuple(shape), jnp.float32))

    return draw


def test_freeinit_refine_matches_jax_with_its_draws():
    """Three passes of a denoiser that keeps a draw of its own (so the
    per-pass draws are checked too) with the schedule's re-diffusion."""
    sched_j, sched_t = JS.make_schedule(), TS.make_schedule(TS.ScheduleConfig())
    x = np.random.default_rng(1).normal(size=(1, 4, 2, 8, 6)).astype(np.float32)

    def j_denoise(lat, r):
        return 0.5 * lat + 0.1 * jax.random.normal(jax.random.split(r, 1)[0], lat.shape)

    def t_denoise(lat, draw):
        return 0.5 * lat + 0.1 * draw(("base", 0, 0), lat.shape)

    def j_add(clean, noise):
        return JS.add_noise(sched_j, clean, noise, jnp.full((clean.shape[0],), 901))

    def t_add(clean, noise):
        return TS.add_noise(sched_t, clean, noise, torch.full((clean.shape[0],), 901))

    rng = jax.random.PRNGKey(5)
    ref = JF.freeinit_refine(j_denoise, j_add, jnp.asarray(x), rng, num_iters=3)
    calls = []

    def counted(lat, draw):
        calls.append(1)
        return t_denoise(lat, draw)

    out = TF.freeinit_refine(counted, t_add, t(x), _freeinit_draws(rng, 3, base_steps=1),
                             num_iters=3)
    assert len(calls) == 3
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FN)


@pytest.fixture(scope="module")
def pipes():
    """The tiny To2V pipelines (DiT with the VIP branch, no VAE) and VIP
    tokens for 2 chunks."""
    jd = JD.DiTConfig.tiny(vip=JD.VIPConfig(**VIP), sample_height=4, sample_width=6)
    td = TD.DiTConfig.tiny(vip=TD.VIPConfig(**VIP), sample_height=4, sample_width=6)
    rkw = dict(embedding_dim=jd.inner_dim, output_dim=24, num_temporal_queries=2,
               num_height_queries=2, num_width_queries=3)
    rope = get_3d_rotary_pos_embed_v2(jd.attention_head_dim, np.arange(3), np.arange(2),
                                      np.arange(3))
    params = random_params(
        JD.CogVideoXTransformer(jd).init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 4, 6)),
        jnp.zeros((1, jd.max_text_seq_length, jd.text_embed_dim)), jnp.zeros((1,), jnp.int32),
        vip_hidden_states=jnp.zeros((1, 3, 24, 2, 3)), image_rotary_emb=rope,
        vip_image_rotary_emb=rope, vip_condition_rotary_emb=rope, seed=2)
    jpipe = JP.To2VPipeline(JP.To2VConfig(**PIPE), jd, params, JR.ResamplerConfig.tiny(**rkw),
                            None, None, JS.make_schedule())
    dit = TD.CogVideoXTransformer(td).eval()
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(params), td)), strict=True)
    tpipe = TP.To2VPipeline(TP.To2VConfig(**PIPE), td, dit, TR.ResamplerConfig.tiny(**rkw), None,
                            None, device="cpu")
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(2, (CHUNKS + 1) * 2, 24, 2, 3)).astype(np.float32)
    text = rng.normal(size=(1, 8, 24)).astype(np.float32)
    return jpipe, tpipe, emb, text


@pytest.mark.parametrize("freeinit_iters", [0, 2])
def test_denoise_together_matches_jax(pipes, freeinit_iters):
    """All chunks denoised jointly (one DiT forward per chunk and step, its
    own VIP slice and grids), plain and with FreeInit passes."""
    jpipe, tpipe, emb, text = pipes
    neg = np.zeros_like(text)
    key = jax.random.PRNGKey(7)
    ref = jpipe.denoise_together(jnp.asarray(text), jnp.asarray(neg), jnp.asarray(emb), CHUNKS,
                                 rng=key, freeinit_iters=freeinit_iters)
    rng, lat_key = jax.random.split(key)
    steps = PIPE["num_inference_steps"]
    if freeinit_iters:
        inner = _freeinit_draws(rng, freeinit_iters, base_steps=steps)
    else:
        base_keys = jax.random.split(rng, steps)

        def inner(tag, shape):
            assert tag[0] == "base", tag
            k = base_keys[tag[1]] if tag[2] == 0 else jax.random.fold_in(base_keys[tag[1]], 1)
            return t(jax.random.normal(k, tuple(shape), jnp.float32))

    def noise(tag, shape):
        if tag == ("latents",):
            return t(jax.random.normal(lat_key, tuple(shape), jnp.float32))
        return inner(tag, shape)

    out = tpipe.denoise_together(t(text), t(neg), t(emb), CHUNKS, noise_fn=noise,
                                 freeinit_iters=freeinit_iters)
    assert out.shape == (1, CHUNKS * NF, 16, 4, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
def test_ddim_invert_step_matches_jax(prediction_type):
    cfg = dict(prediction_type=prediction_type, rescale_betas_zero_snr=False)
    js, ts = JS.make_schedule(JS.ScheduleConfig(**cfg)), TS.make_schedule(TS.ScheduleConfig(**cfg))
    rng = np.random.default_rng(4)
    out_, x = (rng.normal(size=(3, 2, 4, 4)).astype(np.float32) for _ in range(2))
    t_, nxt = np.array([-1, 300, 700]), np.array([100, 500, 999])
    ref = JS.ddim_invert_step(js, jnp.asarray(out_), jnp.asarray(x), jnp.asarray(t_),
                              jnp.asarray(nxt))
    got = TS.ddim_invert_step(ts, t(out_), t(x), torch.from_numpy(t_), torch.from_numpy(nxt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FN)
    np.testing.assert_allclose(TS.pred_epsilon(ts, t(out_), t(x), torch.from_numpy(t_)).numpy(),
                               np.asarray(JS.pred_epsilon(js, jnp.asarray(out_), jnp.asarray(x),
                                                          jnp.asarray(t_))), **FN)


def test_ddim_invert_matches_jax_and_round_trips():
    """`ddim_invert` against the JAX one (a model whose eps depends on x and
    t), and a constant-eps model's DDIM denoise inverted back to its start."""
    cfg = dict(prediction_type="epsilon", rescale_betas_zero_snr=False)
    js, ts = JS.make_schedule(JS.ScheduleConfig(**cfg)), TS.make_schedule(TS.ScheduleConfig(**cfg))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 2, 3, 4, 4)).astype(np.float32)

    def j_model(lat, tv):
        return 0.3 * lat + (tv.astype(jnp.float32) / 1000.0)[:, None, None, None, None]

    def t_model(lat, tv):
        return 0.3 * lat + (tv.float() / 1000.0)[:, None, None, None, None]

    ref = JB.ddim_invert(j_model, js, jnp.asarray(x), num_inference_steps=8)
    out = TB.ddim_invert(t_model, ts, t(x), num_inference_steps=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FN)

    eps = t(rng.normal(size=x.shape).astype(np.float32))
    steps = np.asarray(TS.inference_timesteps(ts.config, 8))
    lat = start = t(x)
    for cur, nxt in zip(steps, np.concatenate([steps[1:], [-1]])):
        lat, _ = TS.ddim_step(ts, eps, lat, torch.full((2,), int(cur)), torch.full((2,), int(nxt)))
    recon = TB.ddim_invert(lambda z, tv: eps, ts, lat, num_inference_steps=8)
    np.testing.assert_allclose(recon.numpy(), start.numpy(), atol=2e-4)


_DEBUG_SCRIPT = """
import torch
from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.sampling import base as B
from tokensgen_tpu_torch.utils import debug
x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
assert debug.stats("probe", x) is x
lat = torch.ones(1, 2, 3, 4, 4)
scfg = B.SamplerConfig(num_inference_steps=2, stochastic=False)
B.denoise(lambda l, tv: 0.5 * l, S.make_schedule(S.ScheduleConfig()), scfg, lat)
print("done", debug.enabled())
"""


@pytest.mark.parametrize("flag", ["1", None])
def test_debug_prints_only_when_enabled(flag):
    """``TOKENSGEN_DEBUG=1``: `stats` prints min / max / mean / std (ddof 0)
    and the sampler prints each step's noise prediction; unset: silent."""
    env = {k: v for k, v in os.environ.items() if k != "TOKENSGEN_DEBUG"}
    env["PYTHONPATH"] = REPO
    if flag:
        env["TOKENSGEN_DEBUG"] = flag
    proc = subprocess.run([sys.executable, "-c", _DEBUG_SCRIPT], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    if flag:
        assert lines[0] == "probe: min 0.0000 max 5.0000 mean 2.5000 std 1.7078"
        assert sum(ln.startswith("noise_pred: min ") for ln in lines) == 2
        assert lines[-1] == "done True"
    else:
        assert lines == ["done False"]
    assert not debug.enabled() or os.environ.get("TOKENSGEN_DEBUG") == "1"
