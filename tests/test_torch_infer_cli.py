"""The port's inference CLI on the edit workload as shipped, in-process, at
the `--smoke` geometry: a config that names a written mp4 source, a tiny
HF-layout T5 dir (tests/_tiny_t5.py) and a `converted_weights_dir` written
by the JAX package. `tokensgen_tpu_torch.infer.main` writes the source,
orig and fifo mp4s and the latents; its text embeddings, loaded weights and
source frames equal what the JAX CLI's build functions (root `infer.py`:
`build_text_encoder`, `build_pipeline`, `load_video`) make of the same
config (embeddings 1e-5, the rest bit-equal), and its latents match the JAX
pipeline's `generate` on them at 1e-4, the JAX noise replayed."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infer as jax_infer
from tokensgen_tpu.data.video_io import load_video as jax_load_video
from tokensgen_tpu.data.video_io import read_frames as jax_read_frames
from tokensgen_tpu.data.video_io import write_video as jax_write_video
from tokensgen_tpu.utils.config import input_items
from tokensgen_tpu.utils.config import load_config as jax_load_config
from tokensgen_tpu_torch import infer
from tokensgen_tpu_torch.convert.from_jax import (dit_state_dict, resampler_state_dict, to_torch,
                                                  vae_state_dict)
from tokensgen_tpu_torch.data.video_io import load_video
from tokensgen_tpu_torch.utils.config import load_config

from _tiny_t5 import write_tiny_t5_dir
from _torch_parity import jax_noise, np_tree
from _torch_weights import smoke_trees, write_converted_dir

SEED = 3
CHUNKS = 2
STEPS, NF = 6, 3  # the smoke's steps and latent frames per chunk


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    src = str(root / "src.mp4")
    rng = np.random.default_rng(0)
    jax_write_video(src, rng.uniform(-1, 1, size=(40, 40, 56, 3)).astype(np.float32), fps=20)
    t5 = str(root / "t5")
    write_tiny_t5_dir(t5, d_model=24)
    conv = write_converted_dir(str(root / "conv"), smoke_trees(seed=7))
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(f"""
name_prefix: edit
output_dir: {root}/out
seed: {SEED}
converted_weights_dir: {conv}
pretrained_text_encoder_path: {t5}
fuse_qkv: false
video_ipadapter_params:
  scale: [0.6]
input_config:
  public:
    sample_fps: 10
    output_fps: 10
    crop_to_fit: true
  item_a:
    prompt: "the red vehicle on a snow mountain road"
    video: {src}
    params:
      max_num_chunks: {CHUNKS}
""")
    return str(cfg_path), root


def test_embeddings_weights_and_frames_equal_the_jax_cli(setup):
    path, _ = setup
    cfg, jcfg = load_config(path), jax_load_config(path)
    item = input_items(jcfg)[0]
    prompts = [item["prompt"], ""]
    enc = infer.build_text_encoder(cfg, smoke=True, device="cpu")
    jenc = jax_infer.build_text_encoder(jcfg, smoke=True)
    assert type(enc.inner).__name__ == type(jenc.inner).__name__ == "T5TextEncoder"
    np.testing.assert_allclose(enc(prompts).numpy(), np.asarray(jenc(prompts)), rtol=1e-5,
                               atol=1e-5)

    pipe, dcfg = infer.build_pipeline(cfg, smoke=True, device="cpu")
    jpipe, _ = jax_infer.build_pipeline(jcfg, smoke=True)
    for module, want in ((pipe.dit, dit_state_dict(np_tree(jpipe.dit_params), dcfg)),
                         (pipe.resampler, resampler_state_dict(
                             np_tree(jpipe.resampler_params), pipe.resampler_config.depth)),
                         (pipe.vae.model, vae_state_dict(np_tree(jpipe.vae.params)))):
        got = module.state_dict()
        assert set(got) == set(want)
        for k, v in to_torch(want).items():
            assert torch.equal(got[k], v), k

    kw = dict(sample_fps=10, output_res=(32, 48), max_frames=CHUNKS * 9)
    frames = load_video(item["video"], **kw)
    np.testing.assert_array_equal(frames, jax_load_video(item["video"], **kw))
    assert frames.shape == (1, CHUNKS * 9, 32, 48, 3)


def test_cli_writes_the_outputs_and_matches_jax_generate(setup, monkeypatch):
    path, _ = setup
    key = jax.random.PRNGKey(SEED)
    _, r_vip, r_base, r_fifo = jax.random.split(key, 4)
    r_steps, r_latents = jax.random.split(r_base)
    noise = jax_noise(base_rng=r_steps, fifo_rng=r_fifo, base_steps=STEPS,
                      fifo_iters=CHUNKS * NF + STEPS - NF, latents_key=r_latents, vip_rng=r_vip)
    monkeypatch.setattr(infer, "generator_noise", lambda _gen: noise)
    run_dir = infer.main(["--config", path, "--smoke", "--device", "cpu"])
    for suffix in ("source.mp4", "orig.mp4", "fifo.mp4", "latents.npy"):
        assert glob.glob(os.path.join(run_dir, f"item_a_{suffix}")), suffix
    lat = np.load(os.path.join(run_dir, "item_a_latents.npy"))
    assert lat.shape == (1, CHUNKS * NF, 16, 4, 6) and np.isfinite(lat).all()
    assert jax_read_frames(os.path.join(run_dir, "item_a_fifo.mp4")).shape == (
        CHUNKS * 9, 32, 48, 3)

    # the JAX CLI's path on the same config: its build functions, then generate
    jcfg = jax_load_config(path)
    item = input_items(jcfg)[0]
    jenc = jax_infer.build_text_encoder(jcfg, smoke=True)
    jpipe, _ = jax_infer.build_pipeline(jcfg, smoke=True)
    src = jax_load_video(item["video"], sample_fps=10, output_res=(32, 48),
                         max_frames=CHUNKS * 9)
    ref = jpipe.generate(jnp.asarray(jenc([item["prompt"]])), jnp.asarray(jenc([""])),
                         frames=jnp.asarray(src), num_chunks=CHUNKS, rng=key)
    np.testing.assert_allclose(lat, np.asarray(ref["latents"]), rtol=1e-4, atol=1e-4)


def test_cli_refuses_what_is_not_ported(setup):
    """Sequence parallelism (ROADMAP A12) raises; with queue devices too,
    the JAX CLI's ValueError (the two axes exclude each other)."""
    path, _ = setup
    with pytest.raises(NotImplementedError, match="A12"):
        infer.main(["--config", path, "--smoke", "--device", "cpu", "--set", "sp_devices=2"])
    for args in (["--set", "sampling_params.queue_devices=2"], ["--queue-devices", "2"]):
        with pytest.raises(ValueError, match="mutually exclusive"):
            infer.main(["--config", path, "--smoke", "--device", "cpu", "--set", "sp_devices=2",
                        *args])


def test_cli_writes_cache_tracks(setup):
    """`cache_idx: [0]`: output frame 0's x0 over its denoise trajectory is
    decoded and written as ``{name}_cache0.mp4``: its valid iterations (4 at
    the smoke's 6 steps, 3 frames per chunk) cut to one decode chunk, 9
    frames of 48x32."""
    path, _ = setup
    run_dir = infer.main(["--config", path, "--smoke", "--device", "cpu",
                          "--set", "cache_idx=[0]"])
    assert not glob.glob(os.path.join(run_dir, "item_a_cache1.mp4"))
    frames = jax_read_frames(os.path.join(run_dir, "item_a_cache0.mp4"))
    assert frames.shape == (9, 32, 48, 3)


def test_edit_item_without_a_video_raises_outside_smoke(setup):
    path, _ = setup
    with pytest.raises(ValueError, match="needs a `video:` path"):
        infer.main(["--config", path, "--device", "cpu", "--set", "input_config.item_a.video=null"])
