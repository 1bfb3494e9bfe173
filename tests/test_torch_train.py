"""Port parity: the To2V adapter trainer (tokensgen_tpu_torch/train/,
train_to2v.py) against the JAX package's at tiny configs on the CPU, with the
same weights (convert/from_jax.py, which maps a grads tree as it maps params)
and the JAX package's random draws replayed: the objective and timestep
samplers, the lr schedules, the optimizers (f32 and blockwise int8), batch
staging, one train step's loss and trainable grads; remat, the frozen set,
checkpoints and the CLI. Tolerances are stated per test."""

import dataclasses
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tokensgen_tpu.core import schedule as JS
from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2 as jrope
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.models import resampler as JR
from tokensgen_tpu.models import vae3d as JV
from tokensgen_tpu.train import adam8bit as J8
from tokensgen_tpu.train import objective as JO
from tokensgen_tpu.train import optim as JOpt
from tokensgen_tpu.train import staging as JStage
from tokensgen_tpu.train import to2v as JT
from tokensgen_tpu_torch import train_to2v as CLI
from tokensgen_tpu_torch.convert.from_jax import (dit_state_dict, resampler_state_dict, to_torch,
                                                  vae_state_dict)
from tokensgen_tpu_torch.core import schedule as TS
from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2 as trope
from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2_torch
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.models import resampler as TR
from tokensgen_tpu_torch.models import vae3d as TV
from tokensgen_tpu_torch.train import adam8bit as T8
from tokensgen_tpu_torch.train import checkpoint as CK
from tokensgen_tpu_torch.train import objective as TO
from tokensgen_tpu_torch.train import optim as TOpt
from tokensgen_tpu_torch.train import staging as TStage
from tokensgen_tpu_torch.train import to2v as TT

from _torch_parity import np_tree, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAML = os.path.join(REPO, "tokensgen_tpu", "configs", "train_to2v.yaml")


def _random_params(init, *args, seed=0):
    """Random params of ``init``'s tree structure and shapes, without
    compiling it (`jax.eval_shape`): kernels normal(0, 1/sqrt(fan_in)), norm
    scales 1, biases 0, other leaves normal(0, 0.02)."""
    rng = np.random.default_rng(seed)
    shapes = flax.traverse_util.flatten_dict(jax.eval_shape(init, *args)["params"])
    out = {}
    for key, sd in shapes.items():
        if key[-1] == "kernel":
            val = rng.normal(size=sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))
        elif key[-1] == "scale":
            val = np.ones(sd.shape)
        elif key[-1] == "bias":
            val = np.zeros(sd.shape)
        else:
            val = 0.02 * rng.normal(size=sd.shape)
        out[key] = jnp.asarray(val.astype(np.float32))
    return {"params": flax.traverse_util.unflatten_dict(out)}


def test_objective_matches_jax():
    """x0_weighted_loss and get_velocity in f32 (1e-6 relative); the FIFO
    ramp and the stratified sampler, given the JAX package's own draws, equal
    its timesteps exactly."""
    rng = np.random.default_rng(0)
    shape = (2, 3, 4, 5, 6)
    out, noisy, clean = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    ts = np.array([[10, 500, 999], [0, 250, 998]])
    js, ts_ = JS.make_schedule(JS.ScheduleConfig()), TS.make_schedule(TS.ScheduleConfig())
    want = JO.x0_weighted_loss(js, jnp.asarray(out), jnp.asarray(noisy), jnp.asarray(clean),
                               jnp.asarray(ts))
    got = TO.x0_weighted_loss(ts_, t(out), t(noisy), t(clean), torch.from_numpy(ts))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        TS.get_velocity(ts_, t(out), t(noisy), torch.from_numpy(ts)).numpy(),
        np.asarray(JS.get_velocity(js, jnp.asarray(out), jnp.asarray(noisy), jnp.asarray(ts))),
        rtol=1e-6, atol=1e-6)
    key = jax.random.PRNGKey(3)
    b, f = 64, 13
    assert TO.fifo_ramp_high(f) == int(1000 - 999 / 51 * (f - 1))
    base = jax.random.randint(key, (b,), 0, TO.fifo_ramp_high(f))
    np.testing.assert_array_equal(
        TO.fifo_ramp_timesteps(torch.from_numpy(np.array(base)), f).numpy(),
        np.asarray(JO.sample_fifo_ramp_timesteps(key, b, f)))
    proc = np.arange(b) % 4
    u = jax.random.uniform(key, (b,))
    np.testing.assert_array_equal(
        TO.stratified_timesteps(t(np.asarray(u)), torch.from_numpy(proc), 4).numpy(),
        np.asarray(JO.sample_uniform_timesteps(key, b, 1000, jnp.asarray(proc), 4)))
    gen = torch.Generator().manual_seed(0)
    drawn = TO.sample_timesteps(gen, 8, f, 0.4)
    assert drawn.shape == (8, f) and int(drawn.min()) >= 0 and int(drawn.max()) <= 999


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine",
                                  "cosine_with_restarts", "polynomial"])
def test_lr_schedules_match_jax(name):
    """Each schedule against the JAX package's optax one at update counts
    across warmup, decay and the end: to 1e-6 of the peak rate (optax
    evaluates in f32, whose rounding near the end of a decay is that size
    against the peak)."""
    lr, kw = 2e-4, dict(warmup_steps=10, total_steps=100, num_cycles=3, power=2.0)
    want = JOpt.lr_schedule(name, lr, **kw)
    got = TOpt.lr_schedule(name, lr, **kw)
    for step in (0, 1, 5, 10, 11, 40, 49, 50, 70, 99, 100, 150):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=0, atol=1e-6 * lr,
                                   err_msg=f"{name} at {step}")
    assert TOpt.lr_schedule("constant", 3e-4)(7) == 3e-4 == JOpt.lr_schedule("constant", 3e-4)


def _opt_case():
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(64, 80)).astype(np.float32),  # 5120 values: quantized
              "b": rng.normal(size=(10,)).astype(np.float32)}  # under 4096: f32 moments
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (1.0, 0.3, 3.0)]
    return params, grads


@pytest.mark.parametrize("kind", ["adamw", "adam", "adamw_8bit"])
def test_optimizers_match_jax(kind):
    """Three updates against the JAX package's optimizer on the same params
    and grads: f32 Adam/AdamW to 1e-6 relative. The int8 AdamW to 1e-6 of
    the parameter scale: same arithmetic, but log/exp in the second moment's
    quantizer are other implementations, so a rounding may fall the other
    way for a value on the edge of a bin."""
    params, grads = _opt_case()
    lr = 1e-2
    jopt = (J8.adamw_8bit(lr) if kind == "adamw_8bit"
            else JOpt.base_optimizer(kind, lr))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    tp = {k: t(v) for k, v in params.items()}
    topt = TOpt.base_optimizer(kind.split("_")[0], tp, lr, use_8bit=kind == "adamw_8bit")
    assert type(topt).__name__ == ("AdamW8bit" if kind == "adamw_8bit" else "AdamW")
    for g in grads:
        updates, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.step(tp, {k: t(v) for k, v in g.items()})
        for k in params:
            if kind == "adamw_8bit":
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
            else:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                           atol=1e-7)
    with pytest.raises(NotImplementedError):
        TOpt.base_optimizer("prodigy", tp, lr)


def test_adam8bit_quantizers_match_jax():
    """The blockwise int8 and log-u8 quantizers: the same codes and scales as
    the JAX ones (exact for the linear one; the log one within one code, its
    log differing in the last bit), and the round trip error of the JAX
    package's own test (2% of the block scale)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1000, 7)) * 0.01).astype(np.float32)
    jq, tq = J8._quantize(jnp.asarray(x)), T8.quantize(t(x))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    back = T8.dequantize(tq, x.shape).numpy()
    np.testing.assert_array_equal(back, np.asarray(J8._dequantize(jq, x.shape)))
    assert np.abs(back - x).max() / np.abs(x).max() < 0.02
    v = (x * x).astype(np.float32)
    jl, tl = J8._quantize_log(jnp.asarray(v)), T8.quantize_log(t(v))
    assert np.abs(tl.q.numpy().astype(int) - np.asarray(jl.q).astype(int)).max() <= 1
    np.testing.assert_allclose(tl.lo.numpy(), np.asarray(jl.lo), rtol=1e-6)
    opt = T8.AdamW8bit({"w": torch.zeros(512, 512), "b": torch.zeros(8)}, lambda c: 1e-3)
    assert opt.state_nbytes() < 0.35 * 8 * (512 * 512 + 8)  # ~2.06 bytes/param vs 8


VIP = dict(output_dim=24, num_temporal_queries=2, num_height_queries=2, num_width_queries=3,
           length=3 * 2 * 3)


def test_stage_batch_matches_jax():
    """stage_to2v_batch against the JAX one: the same VAE and patch-conv
    weights, the JAX package's latent-sampling noise replayed, the same host
    rng; one sample drops its VIP embedding (the zeros-video path). f32
    through the VAE: 1e-4; the tables and indices exactly or to 1e-5."""
    jd = JD.DiTConfig.tiny(vip=JD.VIPConfig(**VIP), sample_height=4, sample_width=6)
    td = TD.DiTConfig.tiny(vip=TD.VIPConfig(**VIP), sample_height=4, sample_width=6)
    rkw = dict(embedding_dim=jd.inner_dim, output_dim=24, num_temporal_queries=2,
               num_height_queries=2, num_width_queries=3)
    jrc, trc = JR.ResamplerConfig.tiny(**rkw), TR.ResamplerConfig.tiny(**rkw)
    jvc = JV.VAEConfig.tiny(sample_height=32, sample_width=48)
    tvc = TV.VAEConfig.tiny(sample_height=32, sample_width=48)
    vae_params = _random_params(JV.AutoencoderKLCogVideoX(jvc).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 1, 16, 16, 3)))
    vae = TV.AutoencoderKLCogVideoX(tvc).eval()
    vae.load_state_dict(to_torch(vae_state_dict(np_tree(vae_params))), strict=True)
    # staging reads only the DiT's patch conv
    kernel = np.random.default_rng(1).normal(size=(2, 2, 16, jd.inner_dim)).astype(np.float32)
    patch = {"patch_proj": {"kernel": jnp.asarray(kernel / 8), "bias": jnp.full(jd.inner_dim, 0.1)}}
    conv = torch.nn.Conv2d(16, td.inner_dim, 2, stride=2)
    conv.load_state_dict({"weight": t(kernel.transpose(3, 2, 0, 1) / 8),
                          "bias": torch.full((td.inner_dim,), 0.1)})

    rng = np.random.default_rng(0)
    pixels = rng.uniform(-1, 1, size=(2, 18, 32, 48, 3)).astype(np.float32)
    text = rng.normal(size=(2, jd.max_text_seq_length, jd.text_embed_dim)).astype(np.float32)
    start, drop, key = np.asarray([0, 7]), np.asarray([0, 1]), jax.random.PRNGKey(4)
    want = JStage.stage_to2v_batch(jd, patch, jrc, JV.VAERunner(jvc, vae_params),
                                   jnp.asarray(pixels), start, drop, jnp.asarray(text), key,
                                   nf_px=9, host_rng=np.random.default_rng(1))
    r_enc, _ = jax.random.split(key)

    def noise(tag, shape):
        return t(jax.random.normal(jax.random.fold_in(r_enc, tag[1]), shape, jnp.float32))

    cache = {}
    got = TStage.stage_to2v_batch(td, conv, trc, TV.VAERunner(tvc, vae),
                                  t(pixels), start, drop, t(text), noise, nf_px=9,
                                  host_rng=np.random.default_rng(1), zero_cache=cache)
    assert len(cache) == 1  # the zeros-video latents, kept for later batches
    np.testing.assert_array_equal(got["relative_start_idx"], want["relative_start_idx"])
    np.testing.assert_array_equal(got["vip_emb_sel"].numpy(), np.asarray(want["vip_emb_sel"]))
    for name in ("latents", "vip_input_chunks", "text_embeds"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for name in ("resampler_image_rotary_emb", "resampler_sampling_rotary_emb",
                 "image_rotary_emb", "vip_image_rotary_emb", "vip_condition_rotary_emb"):
        for a, b_ in zip(got[name], want[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=0, atol=1e-5, err_msg=name)


def test_batched_rope_tables_match_vmap():
    """Per-sample traced-grid tables ([B, T] grids) against jax.vmap of the
    JAX package's `get_3d_rotary_pos_embed_v2_jnp`, as staging builds them."""
    from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2_jnp

    grid_t = np.array([[3.0, 4, 5], [1009, 1010, 1011]], np.float32)
    gh, gw = np.arange(2, dtype=np.float32), np.linspace(0, 4, 3, endpoint=False, dtype=np.float32)
    want = jax.vmap(lambda g: get_3d_rotary_pos_embed_v2_jnp(32, g, jnp.asarray(gh),
                                                             jnp.asarray(gw)))(jnp.asarray(grid_t))
    got = get_3d_rotary_pos_embed_v2_torch(32, t(grid_t), t(gh), t(gw))
    for a, b_ in zip(got, want):
        assert a.shape == (2, 3 * 2 * 3, 32)
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=0, atol=1e-5)


# ------------------------------------------------------------- train step


F_, HW = 3, (2, 3)  # latent frames; resampler input grid per frame


def _train_setup():
    """JAX params from `init_params` (VIP grafted) at the tiny config, and a
    staged batch in the per-chunk form with per-sample VIP tables."""
    jv, tv = JD.VIPConfig(**VIP), TD.VIPConfig(**VIP)
    jd, td = JD.DiTConfig.tiny(vip=jv), TD.DiTConfig.tiny(vip=tv)
    jrc = JR.ResamplerConfig.tiny(num_temporal_queries=2, num_height_queries=2,
                                  num_width_queries=3, output_dim=24)
    trc = TR.ResamplerConfig.tiny(num_temporal_queries=2, num_height_queries=2,
                                  num_width_queries=3, output_dim=24)
    d, b = jd.attention_head_dim, 2
    hp, wp = jd.sample_height // 2, jd.sample_width // 2
    rng = np.random.default_rng(0)
    img_t = np.array([[3.0, 4, 5], [9, 10, 11]], np.float32)
    cond_t = np.array([[1000.0, 1001, 1002], [1004, 1005, 1006]], np.float32)
    ar = lambda n: np.arange(n, dtype=np.float32)  # noqa: E731
    batch = {
        "latents": rng.normal(size=(b, F_, 16, jd.sample_height, jd.sample_width)),
        "vip_input_chunks": rng.normal(size=(b, 2, F_, HW[0] * HW[1], jrc.embedding_dim)),
        "vip_emb_sel": np.array([[0, 1, 2], [1, 2, 3]]),
        "text_embeds": rng.normal(size=(b, jd.max_text_seq_length, jd.text_embed_dim)),
    }
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in batch.items()}
    grids = {"resampler_image_rotary_emb": (ar(F_), ar(HW[0]), ar(HW[1])),
             "resampler_sampling_rotary_emb": (1000 + ar(2), ar(2), ar(3)),
             "image_rotary_emb": (ar(F_), ar(hp), ar(wp))}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k, g in grids.items():
        dd = jrc.dim_head if k.startswith("resampler") else d
        jb[k], tb[k] = jrope(dd, *g), trope(dd, *g)
    from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2_jnp as jrope_t

    for k, gt, (gh, gw) in (("vip_image_rotary_emb", img_t, (hp, wp)),
                            ("vip_condition_rotary_emb", cond_t, (2, 3))):
        jb[k] = jax.vmap(lambda g: jrope_t(d, g, jnp.arange(gh, dtype=jnp.float32),
                                           jnp.arange(gw, dtype=jnp.float32)))(jnp.asarray(gt))
        tb[k] = get_3d_rotary_pos_embed_v2_torch(d, t(gt), torch.arange(gh), torch.arange(gw))
    # init_params' example: the resampler's raw tokens (2 query frames) for
    # the DiT, so a 2-frame condition table; random weights of its shapes
    example = {"latents": jb["latents"], "text_embeds": jb["text_embeds"],
               "vip_input": jb["vip_input_chunks"][:, 0],
               "image_rotary_emb": jb["image_rotary_emb"],
               "vip_image_rotary_emb": jb["vip_image_rotary_emb"],
               "vip_condition_rotary_emb": jrope(d, 1000 + ar(2), ar(2), ar(3))}
    params = _random_params(lambda: {"params": JT.init_params(jd, jrc, jax.random.PRNGKey(0),
                                                              example)})["params"]
    return jd, td, jrc, trc, params, jb, tb


def _port_model(td, trc, params, remat=False):
    dit = TD.CogVideoXTransformer(dataclasses.replace(td, remat=remat))
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(params["dit"]), td)), strict=True)
    rs = TR.Resampler(trc)
    rs.load_state_dict(to_torch(resampler_state_dict(np_tree(params["resampler"]), trc.depth)),
                       strict=True)
    return TT.setup_trainable(TT.To2VModel(dit, rs).train())


def _capture_grads():
    """An optax transformation whose state becomes the incoming gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))


@pytest.fixture(scope="module")
def jax_step():
    """One JAX `make_train_step` call (jitted): its loss, its trainable
    gradients as a full params tree (zeros on frozen leaves), and the random
    draws its loss_fn made."""
    jd, td, jrc, trc, params, jb, tb = _train_setup()
    labels = JT.trainable_labels(params)
    opt = optax.multi_transform({"train": _capture_grads(), "freeze": optax.set_to_zero()},
                                labels)
    tcfg = JT.To2VTrainConfig()
    sched = JS.make_schedule(JS.ScheduleConfig())
    step = jax.jit(JT.make_train_step(jd, jrc, sched, tcfg, opt))
    rng = jax.random.PRNGKey(1)
    _, state, metrics = step(params, opt.init(params), jb, rng)
    flat_g = flax.traverse_util.flatten_dict(state.inner_states["train"].inner_state)
    flat_p = flax.traverse_util.flatten_dict(params)
    grads = flax.traverse_util.unflatten_dict({
        k: (np.asarray(flat_g[k]) if isinstance(flat_g.get(k), jax.Array)
            else np.zeros(v.shape, np.float32)) for k, v in flat_p.items()})
    # the loss_fn's draws (`train/to2v.py` make_train_step)
    r_t, r_noise, r_mix = jax.random.split(rng, 3)
    b, f = jb["latents"].shape[:2]
    t_uniform = JO.sample_uniform_timesteps(r_t, b, 1000, None, 1)
    t_ramp = JO.sample_fifo_ramp_timesteps(r_t, b, f, 1000, tcfg.inference_timesteps)
    use_ramp = jax.random.uniform(r_mix, ()) < tcfg.diff_timesteps_ratio
    ts = jnp.where(use_ramp, t_ramp, jnp.broadcast_to(t_uniform[:, None], (b, f)))
    noise = jax.random.normal(r_noise, jb["latents"].shape, jnp.float32)
    return dict(td=td, trc=trc, params=params, tb=tb, loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]), grads=grads,
                timesteps=torch.from_numpy(np.array(ts)), noise=t(noise))


def _port_grads(js, remat=False):
    model = _port_model(js["td"], js["trc"], js["params"], remat)
    sched = TS.make_schedule(TS.ScheduleConfig())
    loss = TT.to2v_loss(model, sched, js["tb"], js["timesteps"], js["noise"])
    loss.backward()
    return model, loss, {n: p.grad for n, p in TT.trainable_parameters(model).items()}


def test_train_step_loss_and_grads_match_jax(jax_step):
    """The port's loss and trainable grads against JAX `make_train_step`'s
    value_and_grad on the same params, batch, timesteps and noise. f32
    through two blocks, the resampler and back: loss to 1e-5 relative, each
    grad to 1e-4 of its largest entry; the grad norm to 1e-5 relative."""
    js = jax_step
    model, loss, grads = _port_grads(js)
    np.testing.assert_allclose(loss.item(), js["loss"], rtol=1e-5)
    want = {f"dit.{k}": v for k, v in dit_state_dict(js["grads"]["dit"], js["td"]).items()}
    want.update({f"resampler.{k}": v for k, v in
                 resampler_state_dict(js["grads"]["resampler"], js["trc"].depth).items()})
    labels = TT.trainable_labels(model)
    assert set(grads) == {k for k, v in labels.items() if v == "train"}
    assert any("vip_to_q" in k for k in grads) and any("vip_proj" in k for k in grads)
    assert not any(k.startswith("dit.") and ".to_q." in k and "vip" not in k for k in grads)
    for name, g in grads.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)
    norm = TOpt.global_norm(grads.values()).item()
    np.testing.assert_allclose(norm, js["grad_norm"], rtol=1e-5)


def test_remat_gives_the_same_grads(jax_step):
    """Per-block checkpointing changes no gradient (the recomputed forward is
    the same arithmetic): equal to 1e-6 of each grad's largest entry."""
    _, loss0, g0 = _port_grads(jax_step, remat=False)
    _, loss1, g1 = _port_grads(jax_step, remat=True)
    assert loss0.item() == loss1.item()
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(), rtol=0,
                                   atol=1e-6 * g0[name].abs().max().item(), err_msg=name)


def test_update_moves_only_trainable_params(jax_step):
    """One To2VTrainStep (clip, int8 AdamW): frozen parameters bit-unchanged
    and without grad; trainable ones float32 and most of them moved. With
    two-step accumulation the first call makes no update."""
    js = jax_step
    model = _port_model(js["td"], js["trc"], js["params"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    sched = TS.make_schedule(TS.ScheduleConfig())
    acc = TT.To2VTrainStep(model, sched, TT.To2VTrainConfig(), accum_steps=2)
    m = acc(js["tb"], js["timesteps"], js["noise"])
    assert not m["updated"]
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    m = acc(js["tb"], js["timesteps"], js["noise"])
    assert m["updated"] and np.isfinite(m["loss"].item()) and m["grad_norm"].item() > 0
    moved = 0
    for n, p in model.named_parameters():
        if TT.is_trainable(n):
            assert p.dtype == torch.float32 and p.requires_grad
            moved += not torch.equal(p, before[n])
        else:
            assert not p.requires_grad and torch.equal(p, before[n]), n
    n_train = sum(TT.is_trainable(n) for n, _ in model.named_parameters())
    assert moved > n_train // 2


def _jax_draws(key, jb, tcfg):
    """The JAX To2V loss_fn's timesteps and noise for ``key`` (`make_train_step`)."""
    r_t, r_noise, r_mix = jax.random.split(key, 3)
    b, f = jb["latents"].shape[:2]
    t_uniform = JO.sample_uniform_timesteps(r_t, b, 1000, None, 1)
    t_ramp = JO.sample_fifo_ramp_timesteps(r_t, b, f, 1000, tcfg.inference_timesteps)
    use_ramp = jax.random.uniform(r_mix, ()) < tcfg.diff_timesteps_ratio
    ts = jnp.where(use_ramp, t_ramp, jnp.broadcast_to(t_uniform[:, None], (b, f)))
    return (torch.from_numpy(np.array(ts)),
            t(jax.random.normal(r_noise, jb["latents"].shape, jnp.float32)))


def test_two_steps_match_jax(jax_step):
    """Two optimizer steps of `To2VTrainStep` with the shipped optimizer
    (clip 1.0, int8 AdamW) against two of JAX `make_train_step` with
    `make_optimizer` (the same chain under the trainable / frozen
    multi_transform), from the same params, batch and replayed draws: the
    trainable parameters after step 1 (the update, relative L2 over all of
    them, within 2e-4; measured 2.1e-5: Adam divides each gradient by its own
    magnitude, so f32 grads that differ in the last bits move entries near
    zero by up to 2 lr), the frozen ones bit-unchanged, and step 2's loss
    and grad norm, which read the updated parameters (2e-5 relative;
    measured 0 and 1.1e-7)."""
    js = jax_step
    jd, td, jrc, trc, _, jb, _ = _train_setup()
    params, tb = js["params"], js["tb"]
    jcfg, tcfg = JT.To2VTrainConfig(), TT.To2VTrainConfig()
    assert jcfg.use_8bit_adam and tcfg.use_8bit_adam  # as shipped
    opt = JT.make_optimizer(params, jcfg)
    step = jax.jit(JT.make_train_step(jd, jrc, JS.make_schedule(JS.ScheduleConfig()), jcfg, opt))
    state = opt.init(params)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    jax_out = []
    for key in keys:
        params, state, metrics = step(params, state, jb, key)
        tree = np_tree(params)
        flat = {f"dit.{k}": v for k, v in dit_state_dict(tree["dit"], td).items()}
        flat.update({f"resampler.{k}": v for k, v in
                     resampler_state_dict(tree["resampler"], trc.depth).items()})
        jax_out.append((flat, float(metrics["loss"]), float(metrics["grad_norm"])))
    model = _port_model(js["td"], js["trc"], js["params"])
    port = TT.To2VTrainStep(model, TS.make_schedule(TS.ScheduleConfig()), tcfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m1 = port(tb, *_jax_draws(keys[0], jb, jcfg))
    np.testing.assert_allclose(m1["loss"].item(), jax_out[0][1], rtol=1e-5)
    num = den = 0.0
    for n, p in model.named_parameters():
        if not TT.is_trainable(n):
            assert torch.equal(p, before[n]), n
            continue
        want = torch.from_numpy(np.array(jax_out[0][0][n])).double()
        num += float(((p.detach().double() - want) ** 2).sum())
        den += float(((want - before[n].double()) ** 2).sum())
    assert (num / den) ** 0.5 <= 2e-4, (num / den) ** 0.5
    m2 = port(tb, *_jax_draws(keys[1], jb, jcfg))
    np.testing.assert_allclose(m2["loss"].item(), jax_out[1][1], rtol=2e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(), jax_out[1][2], rtol=2e-5)


def test_checkpoint_round_trip(tmp_path):
    """save / list / latest / restore with rotation; the restored params and
    int8 optimizer state continue exactly as the originals."""
    root = str(tmp_path / "checkpoints")
    assert CK.restore_checkpoint(root) == (None, None)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(80, 64, generator=gen), "b": torch.randn(7, generator=gen)}
    opt = T8.AdamW8bit(params, lambda c: 1e-3)
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    for step in (1, 2, 3):
        opt.step(params, grads)
        CK.save_checkpoint(root, step, {"params": params, "opt_state": opt.state_dict(),
                                        "step": step}, total_limit=2)
    assert CK.list_checkpoints(root) == [2, 3] and CK.latest_checkpoint(root) == 3
    state, step = CK.restore_checkpoint(root)
    assert step == 3 and state["step"] == 3
    params2 = {k: torch.zeros_like(v) for k, v in params.items()}
    opt2 = T8.AdamW8bit(params2, lambda c: 1e-3)
    for k in params2:
        params2[k].copy_(state["params"][k])
    opt2.load_state_dict(state["opt_state"])
    opt.step(params, grads)
    opt2.step(params2, grads)
    for k in params:
        assert torch.equal(params[k], params2[k])


def test_cli_smoke_and_resume(tmp_path, capsys, monkeypatch):
    """`python -m tokensgen_tpu_torch.train_to2v --smoke --device cpu
    --max-steps 2`: finite loss lines, a checkpoint at the last step, the
    losses in scalars.csv (TBLogger's mode without TensorBoard, which is
    hidden here); then --resume continues from it to step 3."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import raises
    out = f"output_dir={tmp_path}"
    CLI.main(["--config", TRAIN_YAML, "--smoke", "--device", "cpu", "--max-steps", "2",
              "--set", out])
    assert CK.list_checkpoints(str(tmp_path / "checkpoints")) == [2]
    CLI.main(["--config", TRAIN_YAML, "--smoke", "--device", "cpu", "--max-steps", "3",
              "--resume", "--set", out])
    text = capsys.readouterr().out
    assert "resumed from step 2" in text and "step 3: loss" in text
    losses = [float(line.split("loss ")[1].split()[0]) for line in text.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert CK.latest_checkpoint(str(tmp_path / "checkpoints")) == 3
    with open(next(iter(tmp_path.glob("to2v_*/rec_para_train.txt")))) as f:
        assert f.read().splitlines()[-1].startswith("# trainable:")
    rows = [line.split(",") for path in sorted(tmp_path.glob("to2v_*/scalars.csv"))
            for line in open(path).read().splitlines()]
    assert [(r[0], r[1]) for r in rows] == [("1", "train_loss"), ("2", "train_loss"),
                                           ("3", "train_loss")]


def test_cli_needs_a_card_unless_told_cpu(monkeypatch):
    """The trainer runs on the card by default and refuses without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        CLI.main(["--config", TRAIN_YAML])
