"""Port parity: the trainers' data paths and their outputs against the JAX
package on the CPU at tiny geometry:

* the To2V validation render (`To2VTrainer.render_validation`: the adapted
  DiT with LoRA, deterministic sampling, the JAX noise replayed) against the
  JAX `To2VPipeline` on the merged weights: video within 1e-4, the metrics
  of the written render within 1e-6 relative;
* `export_reference_artifacts`: the same files and keys, arrays bit-equal;
* the text encoder both trainers build (T5 on the tiny T5 fixture against
  the JAX `make_text_encoder`, within 1e-5; a configured path that is
  missing raises outside --smoke);
* the trainers' batches from disk: To2V from MiraData (bit-equal to the JAX
  CLI's `batch_iterator` stream at ``dataloader_num_workers: 0``), T2To from
  condensed tokens and from VAE latents through the frozen encoder (within
  1e-5 of the JAX `vip_encode_video_latents` + `pca_normalization`);
* a step on each of those paths (LoRA, Prodigy), and the To2V CLI end to
  end with validation and --profile-steps."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core import pca as JP
from tokensgen_tpu.core import schedule as JS
from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2 as jrope
from tokensgen_tpu.data import mira as JM
from tokensgen_tpu.data.video_io import write_video
from tokensgen_tpu.metrics import quality as JQ
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.models import resampler as JR
from tokensgen_tpu.models import text_encoder as JTE
from tokensgen_tpu.models import vae3d as JV
from tokensgen_tpu.pipelines import to2v as JPipe
from tokensgen_tpu.train import checkpoint as JCK
from tokensgen_tpu.train import lora as JL
from tokensgen_tpu.train import t2to as JT2
from tokensgen_tpu_torch import train_t2to as T2CLI
from tokensgen_tpu_torch import train_to2v as CLI
from tokensgen_tpu_torch.convert.from_jax import (dit_state_dict, lora_state_dict, pca_state,
                                                  resampler_state_dict, to_torch, vae_state_dict)
from tokensgen_tpu_torch.convert.safetensors_io import load_safetensors, save_safetensors
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.models import resampler as TR
from tokensgen_tpu_torch.train import checkpoint as TCK
from tokensgen_tpu_torch.utils.config import load_config

from _tiny_t5 import write_tiny_t5_dir
from _torch_parity import jax_noise, np_tree, random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TO2V_YAML = os.path.join(REPO, "tokensgen_tpu", "configs", "train_to2v.yaml")
T2TO_YAML = os.path.join(REPO, "tokensgen_tpu", "configs", "train_t2to.yaml")
VIP = dict(output_dim=24, num_temporal_queries=2, num_height_queries=2, num_width_queries=3,
           length=3 * 2 * 3)
PROMPTS = ["a tiny red road", "snow mountain"]


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """TBLogger writes scalars.csv (importing TensorBoard pulls TensorFlow)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """Three 30 fps mp4s (72, 75 and 60 frames: 2 chunks of 9 at 10 fps)
    in the MiraData layout, and their CSV."""
    root = tmp_path_factory.mktemp("layout")
    rng = np.random.default_rng(0)
    for idx, n in ((7, 72), (1003, 75), (2048, 60)):
        path = JM.mira_video_path(str(root / "videos"), idx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_video(path, rng.uniform(0, 255, size=(n, 40, 60, 3)).astype(np.uint8), fps=30.0)
    (root / "videos.csv").write_text("index,dense_caption\n7,a red road\n1003,snow\n"
                                     "2048,a tiny mountain\n", encoding="ISO-8859-1")
    return root


# ------------------------------------------------------------ validation


def _to2v_jax_params():
    jd = JD.DiTConfig.tiny(vip=JD.VIPConfig(**VIP), sample_height=4, sample_width=6)
    jrc = JR.ResamplerConfig.tiny(embedding_dim=jd.inner_dim, output_dim=24,
                                  num_temporal_queries=2, num_height_queries=2,
                                  num_width_queries=3)
    jvc = JV.VAEConfig.tiny(sample_height=32, sample_width=48)
    rope = jrope(jd.attention_head_dim, np.arange(3), np.arange(2), np.arange(3))
    dit = random_params(JD.CogVideoXTransformer(jd).init, jax.random.PRNGKey(0),
                        jnp.zeros((1, 3, 16, 4, 6)),
                        jnp.zeros((1, jd.max_text_seq_length, jd.text_embed_dim)),
                        jnp.zeros((1,), jnp.int32), vip_hidden_states=jnp.zeros((1, 3, 24, 2, 3)),
                        image_rotary_emb=rope, vip_image_rotary_emb=rope,
                        vip_condition_rotary_emb=rope)["params"]
    dit = JD.graft_vip_params(jax.tree_util.tree_map(jnp.asarray, dit), jd)
    rs = random_params(JR.Resampler(jrc).init, jax.random.PRNGKey(1),
                       jnp.zeros((1, 3, 6, jrc.embedding_dim)), seed=1)["params"]
    vae = random_params(JV.AutoencoderKLCogVideoX(jvc).init, jax.random.PRNGKey(2),
                        jnp.zeros((1, 1, 16, 16, 3)), seed=2)["params"]
    lora = JL.init_lora(dit, jax.random.PRNGKey(3), rank=4)
    rng = np.random.default_rng(4)
    lora = {k: {"a": ab["a"], "b": jnp.asarray(0.05 * rng.normal(size=ab["b"].shape),
                                               jnp.float32)} for k, ab in lora.items()}
    return jd, jrc, jvc, dit, rs, vae, lora


def test_validation_render_matches_jax(tmp_path):
    """The tiny trainer's validation render (LoRA rank 4, its factors
    applied unmerged) against the JAX `To2VPipeline` on the merged weights
    with `PRNGKey(step)`'s draws replayed: the video within 1e-4; the mp4,
    the ``val/*`` scalars and the returned metrics those of `evaluate_video`
    on the render (1e-6 relative)."""
    jd, jrc, jvc, dit, rs, vae, lora = _to2v_jax_params()
    cfg = load_config(TO2V_YAML, {"output_dir": str(tmp_path), "lora_rank": 4})
    tr = CLI.To2VTrainer(cfg, smoke=True, device="cpu")
    model = tr.model
    res = model.dit.load_state_dict(to_torch(dit_state_dict(np_tree(dit), tr.dcfg)), strict=False)
    assert all(k.endswith((".lora_a", ".lora_b")) for k in res.missing_keys)
    model.dit.load_state_dict(to_torch(lora_state_dict(np_tree(lora))), strict=False)
    model.resampler.load_state_dict(to_torch(resampler_state_dict(np_tree(rs), jrc.depth)),
                                    strict=True)
    tr.vae.model.load_state_dict(to_torch(vae_state_dict(np_tree(vae))), strict=True)
    rng = np.random.default_rng(5)
    frames = rng.uniform(-1, 1, size=(1, 18, 32, 48, 3)).astype(np.float32)
    batch = {"pixel_values": frames, "prompt": ["a red road"]}
    step = 3
    key = jax.random.PRNGKey(step)
    _, r_vip, r_base, r_fifo = jax.random.split(key, 4)
    r_steps, r_latents = jax.random.split(r_base)
    noise = jax_noise(base_rng=r_steps, fifo_rng=r_fifo, base_steps=4,
                      fifo_iters=2 * 3 + 4 - 3, latents_key=r_latents, vip_rng=r_vip)
    got = tr.render_validation(step, batch, noise_fn=noise)
    tr.close()

    pcfg = JPipe.To2VConfig(height=32, width=48, num_frames_per_chunk=9, num_inference_steps=4,
                            num_partitions=2, stochastic=False)
    merged = JL.merge_lora(dit, lora, 4, 64.0)
    pipe = JPipe.To2VPipeline(pcfg, jd, {"params": merged}, jrc, {"params": rs},
                              JV.VAERunner(jvc, {"params": vae}), JS.make_schedule())
    text = jnp.asarray(tr.text_encoder(["a red road"]).numpy())
    want = np.asarray(pipe.generate(text, jnp.zeros_like(text), frames=jnp.asarray(frames),
                                    num_chunks=2, rng=key)["video"][0])
    err = float(np.abs(got["video"] - want).max())
    print(f"validation render: max |port - jax| {err:.3e} (bound 1e-4)")
    assert got["video"].shape == want.shape == (18, 32, 48, 3) and err <= 1e-4
    metrics = JQ.evaluate_video((got["video"] + 1) / 2, (frames[0] + 1) / 2)
    assert metrics.keys() == got.keys() - {"video"}
    for k, v in metrics.items():
        assert abs(got[k] - v) <= 1e-6 * abs(v), k
    assert os.path.getsize(os.path.join(tr.run_dir, f"val_step{step}.mp4")) > 0
    rows = open(os.path.join(tr.run_dir, "scalars.csv")).read().splitlines()
    assert sorted(r.split(",")[1] for r in rows) == ["val/delta_e", "val/psnr", "val/ssim"]


def test_export_reference_artifacts_matches_jax(tmp_path):
    """`export_reference_artifacts` from the port's state dicts (the DiT's
    vip weights, the resampler, a PCA, token mean / std) against the JAX
    one from the same trees: the same files and keys, arrays bit-equal."""
    jd, jrc, _, dit, rs, _, _ = _to2v_jax_params()
    pca = JP.fit(jnp.asarray(np.random.default_rng(0).normal(size=(50, 24))), 8)
    mean = np.random.default_rng(1).normal(size=(1, 24)).astype(np.float32)
    std = np.ones((1, 24), np.float32)
    JCK.export_reference_artifacts(str(tmp_path / "jax"), dit_params=dit, dit_config=jd,
                                   resampler_params=rs, resampler_depth=jrc.depth, pca=pca,
                                   token_mean=mean, token_std=std)
    tdit = TD.CogVideoXTransformer(TD.DiTConfig.tiny(vip=TD.VIPConfig(**VIP), sample_height=4,
                                                     sample_width=6))
    tdit.load_state_dict(to_torch(dit_state_dict(np_tree(dit), jd)), strict=True)
    trs = TR.Resampler(TR.ResamplerConfig.tiny(embedding_dim=jd.inner_dim, output_dim=24,
                                               num_temporal_queries=2, num_height_queries=2,
                                               num_width_queries=3))
    trs.load_state_dict(to_torch(resampler_state_dict(np_tree(rs), jrc.depth)), strict=True)
    TCK.export_reference_artifacts(str(tmp_path / "torch"), dit_state=tdit.state_dict(),
                                   resampler_state=trs.state_dict(), pca=pca_state(pca),
                                   token_mean=torch.from_numpy(mean), token_std=std)
    for name in ("vip.safetensors", "resampler/diffusion_flax_model.safetensors",
                 "pca.safetensors"):
        a, b = (load_safetensors(str(tmp_path / k / name)) for k in ("torch", "jax"))
        assert a.keys() == b.keys() and a, name
        for k in a:
            assert a[k].dtype == b[k].dtype == torch.float32
            assert torch.equal(a[k], b[k]), (name, k)
    assert all("vip_" in k for k in load_safetensors(str(tmp_path / "torch/vip.safetensors")))
    for name in ("mean.npy", "std.npy"):
        a, b = (np.load(tmp_path / k / name) for k in ("torch", "jax"))
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ----------------------------------------------------------- text encoder


@pytest.mark.parametrize("trainer", ["to2v", "t2to"])
def test_trainers_build_the_text_encoder_as_jax(tmp_path, trainer):
    """Outside --smoke a configured ``pretrained_text_encoder_path`` is
    loaded (T5 on the tiny fixture: the JAX `make_text_encoder`'s embeddings
    within 1e-5); a configured path that is missing raises RuntimeError, as
    in the JAX CLIs; under --smoke it falls back to the hash encoder."""
    t5 = str(tmp_path / "t5")
    write_tiny_t5_dir(t5, d_model=24)
    yaml_path, cls = (TO2V_YAML, CLI.To2VTrainer) if trainer == "to2v" else (
        T2TO_YAML, T2CLI.T2ToTrainer)
    base = {"output_dir": str(tmp_path / "out"), "model_size": "tiny", "longvgen_pca": None}
    tr = cls(load_config(yaml_path, dict(base, pretrained_text_encoder_path=t5)), smoke=False,
             device="cpu")
    want = np.asarray(JTE.make_text_encoder(t5, max_length=8, embed_dim=24)(PROMPTS))
    got = tr.text_encoder(PROMPTS).numpy()
    tr.close()
    err = float(np.abs(got - want).max())
    print(f"{trainer} T5 embeddings: max |port - jax| {err:.3e} (bound 1e-5)")
    assert got.shape == (2, 8, 24) and err <= 1e-5
    missing = dict(base, pretrained_text_encoder_path=str(tmp_path / "absent"))
    with pytest.raises(RuntimeError, match="failed to load T5"):
        cls(load_config(yaml_path, missing), smoke=False, device="cpu")
    tr = cls(load_config(yaml_path, missing), smoke=True, device="cpu")
    assert type(tr.text_encoder.inner).__name__ == "HashTextEncoder"
    tr.close()


# ------------------------------------------------------------ data paths


def test_to2v_batches_from_disk_bit_equal(layout, tmp_path):
    """The To2V trainer's MiraData stream (``dataloader_num_workers: 0``)
    equals the JAX CLI's `batch_iterator` stream over epochs (seed + epoch)
    bit for bit; with workers the batches keep their shapes and a step on
    them is finite."""
    over = {"output_dir": str(tmp_path), "model_size": "tiny", "dataloader_num_workers": 0,
            "train_data_params.csv_file": str(layout / "videos.csv"),
            "train_data_params.video_dir": str(layout / "videos")}
    tr = CLI.To2VTrainer(load_config(TO2V_YAML, over), smoke=False, device="cpu")
    ds = JM.MiraDataset(str(layout / "videos.csv"), str(layout / "videos"), height=32, width=48,
                        sample_fps=10, chunk_size=9, max_num_chunks=2, seed=42)
    want = [b for e in range(2) for b in JM.batch_iterator(ds, 2, seed=42 + e, num_workers=0)]
    got = [next(tr.batches) for _ in want]
    tr.close()
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
                    else a[k] == b[k]), k
    tr = CLI.To2VTrainer(load_config(TO2V_YAML, dict(over, dataloader_num_workers=3,
                                                     gradient_accumulation_steps=1)),
                         smoke=False, device="cpu")
    assert next(tr.batches)["pixel_values"].shape == (2, 18, 32, 48, 3)
    rec = tr.run(1, save_final=False)[0]
    tr.close()
    assert np.isfinite(rec["loss"]) and rec["updated"]


def _t2to_disk(root, kind):
    """Per-video condensed tokens, or VAE latents (3 frames a chunk) with the
    frozen encoder's files (JAX random weights in the reference layout)."""
    rng = np.random.default_rng(6)
    for idx, chunks in ((7, 2), (1003, 3), (2048, 1)):
        shard = root / kind / f"{idx // 1000:09d}"
        shard.mkdir(parents=True)
        if kind == "tokens":
            np.save(shard / f"{idx}_vip.npy", rng.normal(size=(4 * chunks, 48, 8, 12))
                    .astype(np.float32))
        else:
            np.save(shard / f"{idx}_vae_c{chunks:02d}.npy", rng.normal(size=(3 * chunks, 16, 4, 6))
                    .astype(np.float16))
    if kind == "tokens":
        return {"train_data_params.token_dir": str(root / kind)}, None
    jd = JD.DiTConfig.tiny(sample_height=4, sample_width=6)
    jrc = JR.ResamplerConfig.tiny(embedding_dim=jd.inner_dim, output_dim=48,
                                  num_temporal_queries=4, num_height_queries=8,
                                  num_width_queries=12)
    rs = random_params(JR.Resampler(jrc).init, jax.random.PRNGKey(1),
                       jnp.zeros((1, 3, 6, jrc.embedding_dim)), seed=7)["params"]
    (root / "to2v" / "resampler").mkdir(parents=True)
    save_safetensors(str(root / "to2v/resampler/diffusion_flax_model.safetensors"),
                     resampler_state_dict(np_tree(rs), jrc.depth))
    kernel = (rng.normal(size=(2, 2, 16, jd.inner_dim)) / 8).astype(np.float32)
    bias = (0.1 * rng.normal(size=(jd.inner_dim,))).astype(np.float32)
    save_safetensors(str(root / "proj.safetensors"),
                     {"proj.weight": np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)),
                      "proj.bias": bias})
    keys = {"train_data_params.latent_dir": str(root / kind),
            "pretrained_resampler_name_or_path": str(root / "to2v"),
            "patch_embed_proj_path": str(root / "proj.safetensors")}
    return keys, (jd, {"patch_proj": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                  jrc, {"params": rs})


@pytest.mark.parametrize("kind", ["tokens", "latents"])
def test_t2to_batches_from_disk_match_jax(layout, tmp_path, kind):
    """The T2To trainer's batches from disk against the JAX CLI's
    arithmetic on the same dataset stream: condensed tokens (or VAE latents
    through the frozen patch conv and resampler, `vip_encode_video_latents`)
    PCA-normalised with the trainer's PCA: within 1e-5; valid frames are the
    valid chunks x 4 token frames, prompts encoded. Then one step on that
    path, in LoRA mode from tokens (and the merged export), with Prodigy
    from latents: finite."""
    keys, enc = _t2to_disk(tmp_path, kind)
    over = {"output_dir": str(tmp_path / "out"), "model_size": "tiny", "longvgen_pca": None,
            "pretrained_text_encoder_path": None,
            "train_data_params.csv_file": str(layout / "videos.csv"), **keys,
            **({"lora_rank": 4} if kind == "tokens" else {"optimizer": "prodigy"})}
    tr = T2CLI.T2ToTrainer(load_config(T2TO_YAML, over), smoke=False, device="cpu")
    raw_ds = (JM.VIPMiraDataset(str(layout / "videos.csv"), keys["train_data_params.token_dir"],
                                max_num_chunks=4) if kind == "tokens" else
              JM.VAEMiraDataset(str(layout / "videos.csv"),
                                keys["train_data_params.latent_dir"], max_num_chunks=4,
                                nf_per_chunk=3))
    raw = next(JM.batch_iterator(raw_ds, 3, seed=42))
    got = tr.device_batch(next(tr.batches))
    rec = tr.run(1, save_final=False)[0]
    assert np.isfinite(rec["loss"]) and rec["grad_norm"] > 0
    assert type(tr.step_fn.optimizer).__name__ == ("AdamW" if kind == "tokens" else "Prodigy")
    if kind == "tokens":
        assert all(n.endswith((".lora_a", ".lora_b")) for n in tr.step_fn.params)
        assert os.path.exists(os.path.join(tr.export_lora_merged(), "state.pt"))
    tr.close()
    if kind == "tokens":
        toks = jnp.asarray(raw["vip_tokens"])
    else:
        jd, pp, jrc, rs = enc
        toks = JT2.vip_encode_video_latents(jd, pp, jrc, rs, jnp.asarray(raw["vae_latents"]),
                                            nf_per_chunk=3)
    pca = JP.PCAState(jnp.asarray(tr.pca.mean.numpy()), jnp.asarray(tr.pca.components.numpy()))
    want = np.asarray(JT2.pca_normalization(toks, pca, jnp.asarray(tr.token_mean.numpy()),
                                            jnp.asarray(tr.token_std.numpy())))
    err = float(np.abs(got["latents"].numpy() - want).max())
    print(f"t2to {kind} batch: max |port - jax| {err:.3e} (bound 1e-5)")
    assert got["latents"].shape == want.shape == (3, 16, 16, 8, 12) and err <= 1e-5
    np.testing.assert_array_equal(got["valid_frames"].numpy(), raw["valid_num_chunks"] * 4)
    assert got["text_embeds"].shape == (3, 8, 24)


def test_to2v_cli_with_options(layout, tmp_path, capsys):
    """`python -m tokensgen_tpu_torch.train_to2v --smoke` with LoRA,
    Prodigy, a validation set from the MiraData layout, validation_steps and
    --profile-steps: a finite step, the render, the trace and the merged
    LoRA export written (--smoke ignores the training CSV, as in the JAX
    CLI)."""
    args = ["--config", TO2V_YAML, "--device", "cpu", "--smoke", "--max-steps", "1",
            "--profile-steps", "1"]
    for kv in (f"output_dir={tmp_path}", "lora_rank=4", "optimizer=prodigy",
               "gradient_accumulation_steps=1", "validation_steps=1",
               f"train_data_params.csv_file={layout / 'absent.csv'}",
               f"val_data_params.csv_file={layout / 'videos.csv'}",
               f"val_data_params.video_dir={layout / 'videos'}", "val_data_params.indices=[1]"):
        args += ["--set", kv]
    CLI.main(args)
    out = capsys.readouterr().out
    run_dir = next(p for p in tmp_path.iterdir() if p.name.startswith("to2v_"))
    assert "step 1: loss" in out and "validation step 1:" in out and "lora: rank=4" in out
    assert os.path.getsize(run_dir / "val_step1.mp4") > 0
    assert os.path.getsize(run_dir / "profile" / "trace.json") > 0
    assert (run_dir / "lora_merged" / "checkpoint-1" / "state.pt").exists()
    state = TCK.restore_checkpoint(str(run_dir / "lora_merged"))[0]
    assert not any(k.endswith(".lora_a") for k in state["params"]["dit"])
