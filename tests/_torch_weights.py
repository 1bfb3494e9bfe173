"""JAX param trees at the inference CLIs' `--smoke` geometry (random values
at the shapes `jax.eval_shape` gives, nothing compiled), written as a
`converted_weights_dir` by the JAX package's `save_param_tree`: the files
the port's loaders are held to in tests/test_torch_weights_load.py and
tests/test_torch_infer_cli.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from tokensgen_tpu.convert.safetensors_io import save_param_tree
from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.models import resampler as JR
from tokensgen_tpu.models import vae3d as JV
from tokensgen_tpu.pipelines import t2to as JT

from _torch_parity import random_params

# the JAX CLI's --smoke geometry (root infer.py build_pipeline)
VIP = dict(output_dim=24, num_temporal_queries=2, num_height_queries=2, num_width_queries=3,
           length=3 * 2 * 3)


def smoke_configs(vip=True):
    """(DiTConfig, ResamplerConfig, VAEConfig) of the JAX CLI's smoke."""
    jd = JD.DiTConfig.tiny(vip=JD.VIPConfig(**VIP) if vip else None, sample_height=4,
                           sample_width=6)
    jrc = JR.ResamplerConfig.tiny(embedding_dim=jd.inner_dim, output_dim=24,
                                  num_temporal_queries=2, num_height_queries=2,
                                  num_width_queries=3)
    return jd, jrc, JV.VAEConfig.tiny(sample_height=32, sample_width=48)


def smoke_trees(vip=True, t2to=False, seed=0):
    """name -> param tree (numpy) of the converted files of the smoke:
    ``to2v_dit``, ``resampler``, ``vae`` (and ``t2to_dit``)."""
    jd, jrc, jvc = smoke_configs(vip)
    d = jd.attention_head_dim
    rope = get_3d_rotary_pos_embed_v2(d, np.arange(3), np.arange(2), np.arange(3))
    vip_kw = dict(vip_hidden_states=jnp.zeros((1, 3, 24, 2, 3)), vip_image_rotary_emb=rope,
                  vip_condition_rotary_emb=rope) if vip else {}
    trees = {
        "to2v_dit": random_params(
            JD.CogVideoXTransformer(jd).init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 4, 6)),
            jnp.zeros((1, jd.max_text_seq_length, jd.text_embed_dim)), jnp.zeros((1,), jnp.int32),
            image_rotary_emb=rope, seed=seed, **vip_kw),
        "resampler": random_params(JR.Resampler(jrc).init, jax.random.PRNGKey(0),
                                   jnp.zeros((1, 3, 6, jrc.embedding_dim)), seed=seed + 1),
        "vae": random_params(JV.AutoencoderKLCogVideoX(jvc).init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 1, 16, 16, 3)), seed=seed + 2),
    }
    if t2to:
        t2cfg = JT.T2ToConfig(num_inference_steps=4, num_frames_per_chunk=2, token_dim=24,
                              height=2, width=3, stochastic=False)
        t2d = JD.DiTConfig.tiny(patch_size=1, sample_height=2, sample_width=3,
                                attention_head_dim=64, num_attention_heads=1)
        f0 = 2 * t2cfg.num_frames_per_chunk
        trees["t2to_dit"] = random_params(
            JD.CogVideoXTransformer(t2d).init, jax.random.PRNGKey(0),
            jnp.zeros((1, f0, 16, 2, 3)), jnp.zeros((1, t2d.max_text_seq_length, t2d.text_embed_dim)),
            jnp.zeros((1,), jnp.int32), image_rotary_emb=JT.T2ToPipeline(t2cfg, t2d, None).rope(f0),
            seed=seed + 3)
    return {k: v["params"] for k, v in trees.items()}


def write_converted_dir(d, trees):
    """``{name}.safetensors`` per tree, by the JAX package's writer."""
    os.makedirs(d, exist_ok=True)
    for name, tree in trees.items():
        save_param_tree(os.path.join(d, name + ".safetensors"), tree)
    return d
