"""Port parity: models/vae3d.py against the JAX causal VAE at the tiny
config, weights mapped by convert/from_jax.py::vae_state_dict. Covers the
frame-batched encode with the carried conv cache, the batched decode, and
the tiled decode with overlap blending. f32 convolutions summed in another
order (cuDNN-style 3-D conv vs per-tap 2-D convs): 1e-4 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.models import vae3d as JV
from tokensgen_tpu_torch.convert.from_jax import to_torch, vae_state_dict
from tokensgen_tpu_torch.models import vae3d as TV

from _torch_parity import np_tree, t


@pytest.fixture(scope="module")
def vaes():
    jcfg, tcfg = JV.VAEConfig.tiny(), TV.VAEConfig.tiny()
    # jitted: eager flax init of the conv stack dispatches op by op (~45 s)
    params = jax.jit(JV.AutoencoderKLCogVideoX(jcfg).init)(jax.random.PRNGKey(0),
                                                           jnp.zeros((1, 1, 16, 16, 3)))
    tmodel = TV.AutoencoderKLCogVideoX(tcfg).eval()
    tmodel.load_state_dict(to_torch(vae_state_dict(np_tree(params))), strict=True)
    return jcfg, params, tcfg, tmodel


def test_encode_matches_jax(vaes):
    jcfg, params, tcfg, tmodel = vaes
    x = np.random.default_rng(0).uniform(-1, 1, size=(1, 9, 32, 48, 3)).astype(np.float32)
    ref = JV.VAERunner(jcfg, params).encode(jnp.asarray(x))
    out = TV.VAERunner(tcfg, tmodel).encode(t(x))
    assert out.shape == (1, 3, 4, 6, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    noise = np.random.default_rng(1).normal(size=(1, 3, 4, 6, 16)).astype(np.float32)
    np.testing.assert_array_equal(TV.sample_latent(t(ref), None).numpy(),
                                  np.asarray(JV.sample_latent(ref, None)))
    mean, logvar = np.split(np.asarray(ref), 2, axis=-1)
    np.testing.assert_allclose(TV.sample_latent(t(ref), t(noise)).numpy(),
                               mean + np.exp(0.5 * np.clip(logvar, -30, 20)) * noise,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tiled", [False, True])
def test_decode_matches_jax(vaes, tiled):
    jcfg, params, tcfg, tmodel = vaes
    z = np.random.default_rng(2).normal(size=(1, 4, 4, 6, 16)).astype(np.float32)
    kw = dict(use_tiling=True, tile_sample_min_height=24, tile_sample_min_width=32) if tiled else {}
    ref = JV.VAERunner(jcfg, params, **kw).decode(jnp.asarray(z))
    out = TV.VAERunner(tcfg, tmodel, **kw).decode(t(z))
    assert out.shape == ref.shape == (1, 16, 32, 48, 3)  # 2 batches of 2 -> 8 px frames each
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
