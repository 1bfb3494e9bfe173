"""Port parity: the T2To trainer (tokensgen_tpu_torch/train/t2to.py and
train_t2to.py) against the JAX package's at the tiny T2To geometry of
tests/test_t2to.py (patch size 1, one head of 64 over an 8x12 token grid) on
the CPU, with the same weights (convert/from_jax.py) and the JAX train step's
random draws replayed: the padded-chunk masks, the PCA normalisation, the
masked loss, one train step's loss and grads (the attention through K6's and
K5's plain versions), the VAE-latent token encoder, and the CLI. Tolerances
are stated per test."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core import pca as JP
from tokensgen_tpu.core import schedule as JS
from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2 as jrope
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.models import resampler as JR
from tokensgen_tpu.train import objective as JO
from tokensgen_tpu.train import t2to as JT
from tokensgen_tpu_torch import train_t2to as CLI
from tokensgen_tpu_torch.convert.from_jax import (dit_state_dict, pca_state, resampler_state_dict,
                                                  to_torch)
from tokensgen_tpu_torch.core import schedule as TS
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.models import resampler as TR
from tokensgen_tpu_torch.train import checkpoint as CK
from tokensgen_tpu_torch.train import objective as TO
from tokensgen_tpu_torch.train import optim as TOpt
from tokensgen_tpu_torch.train import t2to as TT

from _torch_parity import np_tree, t
from test_torch_train import _capture_grads as capture_grads, _random_params as random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAML = os.path.join(REPO, "tokensgen_tpu", "configs", "train_t2to.yaml")
TINY = dict(patch_size=1, sample_height=8, sample_width=12, attention_head_dim=64,
            num_attention_heads=1)  # tests/test_t2to.py:14-18


@pytest.mark.parametrize("valid,num_frames,hw,text_len", [
    ([4, 2], 4, 6, 3),  # tests/test_t2to.py's case
    ([8, 4, 1], 8, 96, 8),  # the tiny T2To step's geometry
])
def test_padded_chunk_masks_bit_equal(valid, num_frames, hw, text_len):
    """key_bias and loss_mask equal the JAX ones bit for bit."""
    jkb, jlm = JT.padded_chunk_masks(jnp.asarray(valid), num_frames, hw, text_len)
    tkb, tlm = TT.padded_chunk_masks(torch.tensor(valid), num_frames, hw, text_len)
    assert tkb.dtype == torch.float32 and tlm.dtype == torch.float32
    np.testing.assert_array_equal(tkb.numpy(), np.asarray(jkb))
    np.testing.assert_array_equal(tlm.numpy(), np.asarray(jlm))


def test_pca_normalization_and_masked_loss_match_jax():
    """pca_normalization with the same PCAState, mean and std (keep 16 of 48)
    and x0_weighted_loss with a padded-chunk loss mask (one sample fully
    valid, one half): f32, 1e-6 relative."""
    rng = np.random.default_rng(2)
    js = JP.fit(jnp.asarray(rng.normal(size=(100, 48)), jnp.float32), None)
    mean = rng.normal(size=(1, 48)).astype(np.float32)
    std = rng.uniform(0.5, 2.0, size=(1, 48)).astype(np.float32)
    toks = rng.normal(size=(2, 4, 48, 2, 3)).astype(np.float32)
    want = JT.pca_normalization(jnp.asarray(toks), js, jnp.asarray(mean), jnp.asarray(std))
    got = TT.pca_normalization(t(toks), pca_state(js), t(mean), t(std))
    assert got.shape == (2, 4, 16, 2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    shape = (2, 4, 16, 8, 12)
    out, noisy, clean = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    ts = np.array([10, 700])
    _, mask = JT.padded_chunk_masks(jnp.asarray([4, 2]), 4, 96, 8)
    sched_j = JS.make_schedule(JS.ScheduleConfig(beta_schedule="vip_1"))
    sched_t = TS.make_schedule(TS.ScheduleConfig(beta_schedule="vip_1"))
    want = JO.x0_weighted_loss(sched_j, jnp.asarray(out), jnp.asarray(noisy), jnp.asarray(clean),
                               jnp.asarray(ts), loss_mask=mask)
    got = TO.x0_weighted_loss(sched_t, t(out), t(noisy), t(clean), torch.from_numpy(ts),
                              loss_mask=t(np.asarray(mask)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    unmasked = TO.x0_weighted_loss(sched_t, t(out), t(noisy), t(clean), torch.from_numpy(ts))
    assert abs(unmasked.item() - got.item()) > 1e-3  # the mask really applies


@pytest.mark.parametrize("masked", [True, False])
def test_sample_losses_are_each_samples_loss(masked):
    """x0_sample_losses (the per-sample terms the trainers log): term i is
    JAX's x0_weighted_loss of sample i alone, with T2To's padded-chunk mask
    and [B] timesteps or To2V's per-frame [B, F] timesteps, and their mean
    is x0_weighted_loss; f32, 1e-6 relative."""
    rng = np.random.default_rng(4)
    shape = (3, 4, 16, 8, 12)
    out, noisy, clean = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    ts = np.array([3, 400, 990]) if masked else rng.integers(0, 1000, size=(3, 4))
    mask = np.asarray(JT.padded_chunk_masks(jnp.asarray([4, 2, 1]), 4, 96, 8)[1]) if masked \
        else None
    sched_j = JS.make_schedule(JS.ScheduleConfig(beta_schedule="vip_1"))
    sched_t = TS.make_schedule(TS.ScheduleConfig(beta_schedule="vip_1"))
    got = TO.x0_sample_losses(sched_t, t(out), t(noisy), t(clean), torch.from_numpy(ts),
                              loss_mask=None if mask is None else t(mask))
    assert got.shape == (3,)
    for i in range(3):
        want = JO.x0_weighted_loss(
            sched_j, jnp.asarray(out[i:i + 1]), jnp.asarray(noisy[i:i + 1]),
            jnp.asarray(clean[i:i + 1]), jnp.asarray(ts[i:i + 1]),
            loss_mask=None if mask is None else jnp.asarray(mask[i:i + 1]))
        np.testing.assert_allclose(got[i].item(), float(want), rtol=1e-6)
    mean = TO.x0_weighted_loss(sched_t, t(out), t(noisy), t(clean), torch.from_numpy(ts),
                               loss_mask=None if mask is None else t(mask))
    np.testing.assert_allclose(got.mean().item(), mean.item(), rtol=1e-6)


# ------------------------------------------------------------- train step


@pytest.fixture(scope="module")
def jax_step():
    """One JAX `make_train_step` call (jitted) at the tiny geometry, 2
    samples of 8 token frames, the second with 4 valid: its loss, its grads
    and the loss_fn's draws (timesteps, noise)."""
    jd, td = JD.DiTConfig.tiny(**TINY), TD.DiTConfig.tiny(**TINY)
    rng = np.random.default_rng(3)
    b, f = 2, 8
    batch = {"latents": rng.normal(size=(b, f, 16, 8, 12)).astype(np.float32),
             "text_embeds": rng.normal(size=(b, jd.max_text_seq_length,
                                              jd.text_embed_dim)).astype(np.float32),
             "valid_frames": np.array([8, 4])}
    rope = jrope(64, np.arange(f), np.arange(8), np.arange(12), dim_t=52, dim_h=6, dim_w=6)
    dit = JD.CogVideoXTransformer(jd)
    params = random_params(lambda: dit.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["latents"]), jnp.asarray(batch["text_embeds"]),
        jnp.zeros((b,), jnp.int32), image_rotary_emb=rope))["params"]
    tcfg = JT.T2ToTrainConfig()
    sched = JS.make_schedule(JS.ScheduleConfig(beta_schedule="vip_1"))
    opt = capture_grads()
    step = jax.jit(JT.make_train_step(jd, sched, tcfg, opt))
    rng_key = jax.random.PRNGKey(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, grads, metrics = step(params, opt.init(params), jb, rng_key)
    r_t, r_noise = jax.random.split(rng_key)  # the loss_fn's draws
    ts = JO.sample_uniform_timesteps(r_t, b, 1000, None, 1)
    noise = jax.random.normal(r_noise, batch["latents"].shape, jnp.float32)
    return dict(td=td, params=params, batch=batch, loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]), grads=np_tree(grads),
                timesteps=torch.from_numpy(np.array(ts)), noise=t(noise))


def _port_step(js, remat=False):
    """The port's DiT with the JAX params (every parameter an f32 master)
    and its T2To step over the JAX batch, timesteps and noise."""
    dit = TD.CogVideoXTransformer(dataclasses.replace(js["td"], remat=remat))
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(js["params"]), js["td"])), strict=True)
    TT.setup_full_finetune(dit.train())
    sched = TS.make_schedule(TS.ScheduleConfig(beta_schedule="vip_1"))
    batch = {k: torch.from_numpy(v) for k, v in js["batch"].items()}
    return dit, sched, batch


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_loss_and_grads_match_jax(jax_step, remat):
    """The port's t2to_loss and the grads of every parameter against JAX
    `make_train_step`'s value_and_grad on the same params, batch (padded
    chunks masked in attention and loss), timesteps and noise. f32 through
    two blocks whose single-head attention takes K6 and, backward, K5
    (plain versions here): loss to 1e-5 relative, each grad to 1e-4 of its
    largest entry, the grad norm to 1e-5; with per-block checkpointing the
    same (the key bias rides through the checkpointed blocks)."""
    js = jax_step
    dit, sched, batch = _port_step(js, remat)
    loss = TT.t2to_loss(dit, sched, TT.T2ToTrainConfig(), batch, js["timesteps"], js["noise"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), js["loss"], rtol=1e-5)
    want = dit_state_dict(js["grads"], js["td"])
    grads = {n: p.grad for n, p in dit.named_parameters()}
    assert set(grads) == set(want) and all(g is not None for g in grads.values())
    for name, g in grads.items():
        w = want[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)
    norm = TOpt.global_norm(grads.values()).item()
    np.testing.assert_allclose(norm, js["grad_norm"], rtol=1e-5)


def test_train_step_updates_every_parameter(jax_step):
    """One T2ToTrainStep (clip, AdamW): every parameter an f32 master that
    moves. With two-step accumulation the first call makes no update; the
    second applies the mean gradient (whose norm the step reports)."""
    js = jax_step
    dit, sched, batch = _port_step(js)
    before = {n: p.detach().clone() for n, p in dit.named_parameters()}
    step = TT.T2ToTrainStep(dit, sched, TT.T2ToTrainConfig(), accum_steps=2)
    assert step.optimizer.__class__.__name__ == "AdamW"  # use_8bit_adam off, as shipped
    m = step(batch, js["timesteps"], js["noise"])
    assert not m["updated"]
    assert all(torch.equal(p, before[n]) for n, p in dit.named_parameters())
    m = step(batch, js["timesteps"], js["noise"])
    assert m["updated"] and np.isfinite(m["loss"].item())
    np.testing.assert_allclose(m["grad_norm"].item(), js["grad_norm"], rtol=1e-5)
    for n, p in dit.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, n
        assert not torch.equal(p, before[n]), n
    # LoRA mode: the base frozen, only the factors in the step
    TT.setup_lora_finetune(dit, TT.T2ToTrainConfig(lora_rank=4), torch.Generator().manual_seed(0))
    lora_step = TT.T2ToTrainStep(dit, sched, TT.T2ToTrainConfig(lora_rank=4))
    assert set(lora_step.params) == {n for n, _ in dit.named_parameters()
                                     if n.endswith((".lora_a", ".lora_b"))}
    assert len(lora_step.params) == 2 * 4 * js["td"].num_layers


def _jax_draws(key, shape):
    """The JAX T2To loss_fn's timesteps and noise for ``key`` (`make_train_step`)."""
    r_t, r_noise = jax.random.split(key)
    ts = JO.sample_uniform_timesteps(r_t, shape[0], 1000, None, 1)
    return (torch.from_numpy(np.array(ts)),
            t(jax.random.normal(r_noise, shape, jnp.float32)))


def _update_error(got: dict, before: dict, want: dict) -> float:
    """Relative L2 error, over every parameter together, of the port's update
    (got - before) against JAX's (want - before)."""
    num = sum(float(((got[n].double() - torch.from_numpy(np.array(want[n])).double()) ** 2).sum())
              for n in got)
    den = sum(float(((torch.from_numpy(np.array(want[n])).double() - before[n].double()) ** 2)
                    .sum()) for n in got)
    return (num / den) ** 0.5


@pytest.mark.parametrize("use_8bit", [False, True], ids=["adamw", "adamw_8bit"])
def test_two_steps_match_jax(jax_step, use_8bit):
    """Two optimizer steps of `T2ToTrainStep` against two of JAX
    `make_train_step` with the config's own optimizer (clip 1.0, then AdamW
    as shipped, or the int8 AdamW of ``use_8bit_adam: true``, what one card
    runs at full width) from the same params, batch and replayed draws: the
    parameters after step 1 (the update, relative L2 over all parameters,
    within 2e-4; measured 2.6e-5 with either optimizer: an Adam step divides
    each gradient by its own magnitude, so f32 grads that differ in the last
    bits move entries near zero by up to 2 lr), and step 2's loss and grad
    norm, which read those parameters (2e-5 relative; measured <= 2.4e-6)."""
    js = jax_step
    jd = JD.DiTConfig.tiny(**TINY)
    jcfg, tcfg = JT.T2ToTrainConfig(use_8bit_adam=use_8bit), TT.T2ToTrainConfig(
        use_8bit_adam=use_8bit)
    sched = JS.make_schedule(JS.ScheduleConfig(beta_schedule="vip_1"))
    opt = JT.make_optimizer(jcfg)
    step = jax.jit(JT.make_train_step(jd, sched, jcfg, opt))
    params, state = js["params"], opt.init(js["params"])
    jb = {k: jnp.asarray(v) for k, v in js["batch"].items()}
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    jax_out = []
    for key in keys:
        params, state, metrics = step(params, state, jb, key)
        jax_out.append((dit_state_dict(np_tree(params), js["td"]), float(metrics["loss"]),
                        float(metrics["grad_norm"])))
    dit, tsched, batch = _port_step(js)
    port = TT.T2ToTrainStep(dit, tsched, tcfg)
    assert type(port.optimizer).__name__ == ("AdamW8bit" if use_8bit else "AdamW")
    before = {n: p.detach().clone() for n, p in dit.named_parameters()}
    shape = js["batch"]["latents"].shape
    m1 = port(batch, *_jax_draws(keys[0], shape))
    np.testing.assert_allclose(m1["loss"].item(), jax_out[0][1], rtol=1e-5)
    err = _update_error({n: p.detach() for n, p in dit.named_parameters()}, before, jax_out[0][0])
    assert err <= 2e-4, err
    m2 = port(batch, *_jax_draws(keys[1], shape))
    np.testing.assert_allclose(m2["loss"].item(), jax_out[1][1], rtol=2e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(), jax_out[1][2], rtol=2e-5)


def test_vip_encode_video_latents_matches_jax():
    """VAE latents -> condensed tokens through the patch conv and the
    resampler (tests/test_t2to.py's geometry: 3 chunks of 3 latent frames),
    the same weights and rope tables as the JAX function: f32, 1e-5."""
    vkw = dict(output_dim=24, num_temporal_queries=2, num_height_queries=2, num_width_queries=3,
               length=3 * 2 * 3)
    jd = JD.DiTConfig.tiny(vip=JD.VIPConfig(**vkw), sample_height=4, sample_width=6)
    td = TD.DiTConfig.tiny(vip=TD.VIPConfig(**vkw), sample_height=4, sample_width=6)
    rkw = dict(embedding_dim=jd.inner_dim, output_dim=24, num_temporal_queries=2,
               num_height_queries=2, num_width_queries=3)
    jrc, trc = JR.ResamplerConfig.tiny(**rkw), TR.ResamplerConfig.tiny(**rkw)
    rng = np.random.default_rng(0)
    kernel = (rng.normal(size=(2, 2, 16, jd.inner_dim)) / 8).astype(np.float32)
    bias = (0.1 * rng.normal(size=(jd.inner_dim,))).astype(np.float32)
    rs_params = random_params(JR.Resampler(jrc).init, jax.random.PRNGKey(1),
                              jnp.zeros((1, 3, 6, jrc.embedding_dim)), seed=1)
    img = jrope(jrc.dim_head, np.arange(3), np.arange(2), np.arange(3))
    smp = jrope(jrc.dim_head, 1000 + np.arange(2), np.arange(2), np.arange(3))
    lat = rng.normal(size=(2, 9, 16, 4, 6)).astype(np.float32)
    want = JT.vip_encode_video_latents(
        jd, {"patch_proj": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, jrc,
        rs_params, jnp.asarray(lat), img, smp, nf_per_chunk=3)
    conv = TD.CogVideoXTransformer(td).patch_embed.proj
    conv.load_state_dict({"weight": t(kernel.transpose(3, 2, 0, 1)), "bias": t(bias)})
    rs = TR.Resampler(trc).eval()
    rs.load_state_dict(to_torch(resampler_state_dict(np_tree(rs_params), trc.depth)),
                       strict=True)
    got = TT.vip_encode_video_latents(td, conv, rs, t(lat), tuple(t(x) for x in img),
                                      tuple(t(x) for x in smp), nf_per_chunk=3)
    assert got.shape == (2, 3 * 2, 24, 2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------------- CLI


def test_cli_smoke_and_resume(tmp_path, capsys, monkeypatch):
    """`python -m tokensgen_tpu_torch.train_t2to --smoke --device cpu
    --max-steps 2`: finite loss lines with the valid-chunk counts, a
    checkpoint at the last step holding every parameter, the losses in
    scalars.csv (TensorBoard hidden here); then --resume continues from it
    to step 3."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import raises
    out = f"output_dir={tmp_path}"
    CLI.main(["--config", TRAIN_YAML, "--smoke", "--device", "cpu", "--max-steps", "2",
              "--set", out])
    root = str(tmp_path / "t2to_checkpoints")
    assert CK.list_checkpoints(root) == [2]
    state, _ = CK.restore_checkpoint(root)
    n_params = len(TD.CogVideoXTransformer(TD.DiTConfig.tiny(**TINY)).state_dict())
    assert len(state["params"]) == n_params
    CLI.main(["--config", TRAIN_YAML, "--smoke", "--device", "cpu", "--max-steps", "3",
              "--resume", "--set", out])
    text = capsys.readouterr().out
    assert "resumed from step 2" in text and "step 3: loss" in text
    lines = [line for line in text.splitlines() if line.startswith("step ")]
    losses = [float(line.split("loss ")[1].split()[0]) for line in lines]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert all("valid chunks [" in line for line in lines)
    rows = [line.split(",") for path in sorted(tmp_path.glob("t2to_*/scalars.csv"))
            for line in open(path).read().splitlines()]
    assert [(r[0], r[1]) for r in rows] == [("1", "train_loss"), ("2", "train_loss"),
                                           ("3", "train_loss")]


def test_cli_needs_a_card_unless_told_cpu(monkeypatch):
    """The trainer runs on the card by default and refuses without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        CLI.main(["--config", TRAIN_YAML, "--smoke"])


@pytest.mark.parametrize("override,match", [
    ("tp_devices=2", "A12"),
    ("sp_devices=2", "A12"),
    ("zero1=true", None),
])
def test_cli_refuses_what_is_not_ported(tmp_path, capsys, override, match):
    """Each option the port lacks raises NotImplementedError naming it
    (tensor and sequence parallelism, ROADMAP A12). ``zero1``, once refused
    here, now runs: one rank, its optimizer state in the ZeRO-1 layout
    (every tensor whole at one rank), a checkpoint with its part."""
    args = ["--config", TRAIN_YAML, "--device", "cpu", "--set", f"output_dir={tmp_path}",
            "--set", override, "--set", "model_size=tiny", "--smoke"]
    if match is None:
        CLI.main(args + ["--max-steps", "1"])
        assert "step 1: loss" in capsys.readouterr().out
        assert os.path.exists(tmp_path / "t2to_checkpoints" / "checkpoint-1" /
                              "opt-rank0-of-1.pt")
        return
    with pytest.raises(NotImplementedError, match=match):
        CLI.main(args)


@pytest.mark.parametrize("override", ["train_data_params.csv_file=data.csv", "lora_rank=8"])
def test_cli_runs_what_it_once_refused(tmp_path, capsys, override):
    """The two options this test file once held refused now run: under
    --smoke a csv_file is ignored for synthetic batches, as in the JAX CLI
    (no CSV exists here), and lora_rank trains LoRA factors and writes the
    merged export."""
    args = ["--config", TRAIN_YAML, "--device", "cpu", "--set", f"output_dir={tmp_path}",
            "--set", override, "--set", "model_size=tiny", "--smoke", "--max-steps", "1"]
    CLI.main(args)
    out = capsys.readouterr().out
    assert "step 1: loss" in out and "training done" in out
    if override.startswith("lora"):
        assert "lora: rank=8" in out and "lora-merged export saved" in out
    else:  # no dataset is read
        assert "data:" not in out
