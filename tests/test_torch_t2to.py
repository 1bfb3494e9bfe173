"""Port parity: the generation workload's first stage. `core/pca.py` against
the JAX PCA, `pipelines/t2to.py` (the tiny patch-size-1 T2To DiT moved by
convert/from_jax.py, the JAX noise replayed) against the JAX T2To pipeline,
`extend_generated_tokens`, and the gen CLI at --smoke on the host."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.core import pca as JP
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.pipelines import t2to as JT
from tokensgen_tpu_torch.convert.from_jax import dit_state_dict, pca_state, to_torch
from tokensgen_tpu_torch.core import pca as TPCA
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.pipelines import t2to as TT

from _torch_parity import jax_noise, np_tree, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(seed=0, n=200, d=12):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) @ np.diag(np.linspace(3, 0.1, d))).astype(np.float32)


def test_pca_fit_matches_jax():
    """fit on data with well-separated singular values: mean and the
    sign-flipped components to 1e-5 (f32 SVDs of two libraries)."""
    x = _data()
    js, ts = JP.fit(jnp.asarray(x), 4), TPCA.fit(t(x), 4)
    np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.components.numpy(), np.asarray(js.components), rtol=1e-5,
                               atol=1e-5)


def test_pca_transforms_match_jax():
    """transform, inverse_transform and bottleneck with the same state: 1e-5."""
    x = _data(1, 100, 32)
    js = JP.fit(jnp.asarray(x), None)
    ts = pca_state(js)
    y = np.random.default_rng(2).normal(size=(7, 32)).astype(np.float32)
    for jf, tf in ((JP.transform, TPCA.transform), (JP.inverse_transform, TPCA.inverse_transform)):
        np.testing.assert_allclose(tf(ts, t(y)).numpy(), np.asarray(jf(js, jnp.asarray(y))),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TPCA.bottleneck(ts, t(x), keep=16).numpy(),
                               np.asarray(JP.bottleneck(js, jnp.asarray(x), keep=16)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_chunks", [1, 2])
def test_extend_generated_tokens_matches_jax(num_chunks):
    toks = np.random.default_rng(3).normal(size=(2, 4 * num_chunks, 5, 2, 3)).astype(np.float32)
    want = np.asarray(JT.extend_generated_tokens(jnp.asarray(toks), num_chunks))
    got = TT.extend_generated_tokens(t(toks), num_chunks).numpy()
    np.testing.assert_array_equal(got, want)


def test_t2to_5b_config_matches_jax():
    j, p = JD.DiTConfig.t2to_5b(), TD.DiTConfig.t2to_5b()
    for f in ("num_attention_heads", "attention_head_dim", "num_layers", "patch_size",
              "sample_height", "sample_width", "text_embed_dim", "in_channels", "out_channels"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.vip is None and p.quant is None


@pytest.mark.parametrize("stochastic", [False, True])
def test_t2to_pipeline_matches_jax(stochastic):
    """Tiny T2To (patch size 1, 8x12 grid, one 64-wide head, no VIP), 4
    CFG DPM steps over 2 chunks, then the un-normalise and PCA lift: the
    JAX pipeline vs the port with its weights and (stochastic) its noise
    replayed. f32 through 4 DiT forwards: 1e-4."""
    dcfg_kw = dict(patch_size=1, sample_height=8, sample_width=12, attention_head_dim=64,
                   num_attention_heads=1)
    jd, td = JD.DiTConfig.tiny(**dcfg_kw), TD.DiTConfig.tiny(**dcfg_kw)
    cfg = dict(num_inference_steps=4, token_dim=48, stochastic=stochastic)
    rng = np.random.default_rng(0)
    pca = JP.fit(jnp.asarray(rng.normal(size=(200, 48)), jnp.float32), None)
    mean = rng.normal(size=(1, 48)).astype(np.float32)
    std = rng.uniform(0.5, 2.0, size=(1, 48)).astype(np.float32)
    jpipe = JT.T2ToPipeline(JT.T2ToConfig(**cfg), jd, None, pca=pca,
                            token_mean=jnp.asarray(mean), token_std=jnp.asarray(std))
    f = 8
    params = jax.jit(JD.CogVideoXTransformer(jd).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, f, 16, 8, 12)),
        jnp.zeros((2, jd.max_text_seq_length, jd.text_embed_dim)), jnp.zeros((2,), jnp.int32),
        image_rotary_emb=jpipe.rope(f))
    jpipe.dit_params = params
    dit = TD.CogVideoXTransformer(td).eval()
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(params), td)), strict=True)
    tpipe = TT.T2ToPipeline(TT.T2ToConfig(**cfg), td, dit, pca=pca_state(pca),
                            token_mean=t(mean), token_std=t(std), device="cpu")
    assert tpipe.sched.config.beta_schedule == "vip_1"

    text = rng.normal(size=(1, 8, 24)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    ref = jpipe(jnp.asarray(text), jnp.zeros((1, 8, 24)), num_chunks=2, rng=key)
    # generate_tokens splits the key once: the latents' key, then the sampler's
    r_steps, r_latents = jax.random.split(key)
    noise = jax_noise(base_rng=r_steps, base_steps=4, latents_key=r_latents)
    out = tpipe(t(text), torch.zeros(1, 8, 24), num_chunks=2, noise_fn=noise)
    assert out.shape == (1, 8, 48, 8, 12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quant_attn", [False, True])
def test_gen_cli_smoke(tmp_path, quant_attn):
    """The gen CLI at --smoke on the host with infer_gen.yaml as shipped
    (quant: w8a8), with and without quant_attn: T2To tokens of 2 chunks
    (2 token frames each, the tiny resampler's), extended, rendered by To2V;
    tokens and latents written, finite."""
    from tokensgen_tpu_torch import infer

    cfg = os.path.join(REPO, "tokensgen_tpu", "configs", "infer_gen.yaml")
    infer.main(["--config", cfg, "--smoke", "--device", "cpu", "--set", f"output_dir={tmp_path}",
                "--set", f"quant_attn={str(quant_attn).lower()}",
                "--set", "input_config.gen_item_1.params.max_num_chunks=2"])
    (run,) = glob.glob(str(tmp_path / "gen_*"))
    toks = np.load(os.path.join(run, "gen_item_1_tokens.npy"))
    lat = np.load(os.path.join(run, "gen_item_1_latents.npy"))
    assert toks.shape == (1, 4, 24, 2, 3) and np.isfinite(toks).all()
    assert lat.shape == (1, 6, 16, 4, 6) and np.isfinite(lat).all()
