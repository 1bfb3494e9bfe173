"""Port parity: the whole edit slice at the `infer.py --smoke` geometry
(720x480 cut to 48x32, 9 frames per chunk, 6 steps, 2 partitions, tiny
DiT / resampler / VAE): VIP encode -> base denoise -> FIFO -> decode, JAX
package vs port with the same weights (convert/from_jax.py) and the JAX
noise replayed. f32 through ~25 DiT forwards and two decodes: 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core import schedule as JS
from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.models import resampler as JR
from tokensgen_tpu.models import vae3d as JV
from tokensgen_tpu.pipelines import to2v as JP
from tokensgen_tpu_torch.convert.from_jax import (dit_state_dict, resampler_state_dict, to_torch,
                                                  vae_state_dict)
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.models import resampler as TR
from tokensgen_tpu_torch.models import vae3d as TV
from tokensgen_tpu_torch.pipelines import to2v as TP

from _torch_parity import jax_noise, np_tree, t

PIPE = dict(height=32, width=48, num_frames_per_chunk=9, num_inference_steps=6, num_partitions=2)
VIP = dict(output_dim=24, num_temporal_queries=2, num_height_queries=2, num_width_queries=3,
           length=3 * 2 * 3)


@pytest.fixture(scope="module")
def pipes():
    jv, tv = JD.VIPConfig(**VIP), TD.VIPConfig(**VIP)
    jd = JD.DiTConfig.tiny(vip=jv, sample_height=4, sample_width=6)
    td = TD.DiTConfig.tiny(vip=tv, sample_height=4, sample_width=6)
    rkw = dict(embedding_dim=jd.inner_dim, output_dim=24, num_temporal_queries=2,
               num_height_queries=2, num_width_queries=3)
    jrc, trc = JR.ResamplerConfig.tiny(**rkw), TR.ResamplerConfig.tiny(**rkw)
    jvc, tvc = JV.VAEConfig.tiny(sample_height=32, sample_width=48), TV.VAEConfig.tiny(
        sample_height=32, sample_width=48)
    r1, r2, r3 = jax.random.split(jax.random.PRNGKey(0), 3)
    vae_params = jax.jit(JV.AutoencoderKLCogVideoX(jvc).init)(r1, jnp.zeros((1, 1, 16, 16, 3)))
    rs_params = jax.jit(JR.Resampler(jrc).init)(r2, jnp.zeros((1, 3, 6, jrc.embedding_dim)))
    d = jd.attention_head_dim
    rope = get_3d_rotary_pos_embed_v2(d, np.arange(3), np.arange(2), np.arange(3))
    dit_params = jax.jit(JD.CogVideoXTransformer(jd).init)(
        r3, jnp.zeros((1, 3, 16, 4, 6)), jnp.zeros((1, jd.max_text_seq_length, jd.text_embed_dim)),
        jnp.zeros((1,), jnp.int32), vip_hidden_states=jnp.zeros((1, 3, 24, 2, 3)),
        image_rotary_emb=rope, vip_image_rotary_emb=rope, vip_condition_rotary_emb=rope)
    dit_params = {"params": JD.graft_vip_params(dit_params["params"], jd)}
    jpipe = JP.To2VPipeline(JP.To2VConfig(**PIPE), jd, dit_params, jrc, rs_params,
                            JV.VAERunner(jvc, vae_params), JS.make_schedule())

    dit = TD.CogVideoXTransformer(td).eval()
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(dit_params), td)), strict=True)
    rs = TR.Resampler(trc).eval()
    rs.load_state_dict(to_torch(resampler_state_dict(np_tree(rs_params), trc.depth)), strict=True)
    vae = TV.AutoencoderKLCogVideoX(tvc).eval()
    vae.load_state_dict(to_torch(vae_state_dict(np_tree(vae_params))), strict=True)
    tpipe = TP.To2VPipeline(TP.To2VConfig(**PIPE), td, dit, trc, rs, TV.VAERunner(tvc, vae),
                            device="cpu")
    return jpipe, tpipe


def test_vip_encode_matches_jax(pipes):
    jpipe, tpipe = pipes
    frames = np.random.default_rng(0).uniform(-1, 1, size=(1, 18, 32, 48, 3)).astype(np.float32)
    ref = jpipe.vip_encode_video(jnp.asarray(frames), rng=None)
    out = tpipe.vip_encode_video(t(frames), noise_fn=None)
    assert out.shape == (2, 2 * 3, 24, 2, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_generate_matches_jax(pipes):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(2, 2 * 3, 24, 2, 3)).astype(np.float32)
    text = rng.normal(size=(1, 8, 24)).astype(np.float32)
    neg = np.zeros_like(text)
    key = jax.random.PRNGKey(2)
    ref = jpipe.generate(jnp.asarray(text), jnp.asarray(neg), image_embeddings=jnp.asarray(emb),
                         num_chunks=2, rng=key)
    # the JAX pipeline's key derivation: generate splits 4, base_denoise splits
    # its key for the initial latents, the samplers split per step / iteration
    _, _, r_base, r_fifo = jax.random.split(key, 4)
    r_steps, r_latents = jax.random.split(r_base)
    noise = jax_noise(base_rng=r_steps, fifo_rng=r_fifo, base_steps=6,
                      fifo_iters=2 * 3 + 6 - 3, latents_key=r_latents)
    out = tpipe.generate(t(text), t(neg), image_embeddings=t(emb), num_chunks=2, noise_fn=noise)
    for name, shape in (("latents", (1, 6, 16, 4, 6)), ("orig_latents", (1, 3, 16, 4, 6)),
                        ("video", (1, 18, 32, 48, 3)), ("orig_video", (1, 9, 32, 48, 3))):
        assert out[name].shape == shape, name
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_infer_cli_smoke(tmp_path):
    """The port's edit CLI at --smoke geometry on the host: config overrides,
    random weights made on the device from the seed, latents written."""
    import glob
    import os

    from tokensgen_tpu_torch import infer

    cfg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tokensgen_tpu", "configs", "infer_edit.yaml")
    infer.main(["--config", cfg, "--smoke", "--device", "cpu", "--set", "quant=null",
                "--set", f"output_dir={tmp_path}",
                "--set", "input_config.edit_item_1.params.max_num_chunks=2"])
    (path,) = glob.glob(str(tmp_path / "edit_*" / "edit_item_1_latents.npy"))
    lat = np.load(path)
    assert lat.shape == (1, 6, 16, 4, 6) and np.isfinite(lat).all()
    with pytest.raises(NotImplementedError, match="int8"):
        infer.main(["--config", cfg, "--smoke", "--device", "cpu",
                    "--set", f"output_dir={tmp_path}"])
