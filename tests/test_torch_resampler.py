"""Port parity: models/resampler.py against the JAX Perceiver resampler at
the tiny config, weights moved by convert/from_jax.py. f32: 1e-5 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tokensgen_tpu.convert.export import export_resampler
from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2 as jrope
from tokensgen_tpu.models import resampler as JR
from tokensgen_tpu_torch.convert.from_jax import resampler_state_dict, to_torch
from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2 as trope
from tokensgen_tpu_torch.models import resampler as TR

from _torch_parity import np_tree, t


def test_resampler_matches_jax():
    jcfg, tcfg = JR.ResamplerConfig.tiny(), TR.ResamplerConfig.tiny()
    f, gh, gw = 3, 2, 3
    jmodel = JR.Resampler(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, f, gh * gw, jcfg.embedding_dim)))
    tree = np_tree(params)
    tmodel = TR.Resampler(tcfg).eval()
    sd = resampler_state_dict(tree, tcfg.depth)
    assert set(sd) == set(export_resampler(tree, jcfg.depth))
    tmodel.load_state_dict(to_torch(sd), strict=True)

    img_g = (np.arange(f), np.arange(gh), np.arange(gw))
    smp_g = (np.linspace(1000, 1003, 2, endpoint=False), np.linspace(0, gh, 2, endpoint=False),
             np.linspace(0, gw, 3, endpoint=False))
    x = np.random.default_rng(1).normal(size=(2, f, gh * gw, 16)).astype(np.float32)
    ref = jmodel.apply(params, jnp.asarray(x), jrope(16, *img_g), jrope(16, *smp_g))
    with torch.no_grad():
        out = tmodel(t(x), trope(16, *img_g), trope(16, *smp_g))
    assert out.shape == (2, 2, 24, 2, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
