"""Port parity: models/dit.py (with models/layers.py) against the JAX DiT at
the tiny config with the VIP branch, weights moved by convert/from_jax.py.
f32 on the CPU; two blocks of matmuls and softmaxes: 1e-5 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.convert.export import export_dit
from tokensgen_tpu.core.rope import get_3d_rotary_pos_embed_v2 as jrope
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu_torch.convert.from_jax import dit_state_dict, to_torch
from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2 as trope
from tokensgen_tpu_torch.models import dit as TD

from _torch_parity import np_tree, t

F, H, W = 2, 8, 16  # latent frames and size of DiTConfig.tiny


def _configs():
    jv = JD.VIPConfig(output_dim=24, num_temporal_queries=2, num_height_queries=2,
                      num_width_queries=3, length=2 * 2 * 3)
    tv = TD.VIPConfig(output_dim=24, num_temporal_queries=2, num_height_queries=2,
                      num_width_queries=3, length=2 * 2 * 3)
    return JD.DiTConfig.tiny(vip=jv), TD.DiTConfig.tiny(vip=tv)


def _ropes(d):
    grids = [(np.arange(F), np.arange(H // 2), np.arange(W // 2)),
             (np.arange(F) + 3.0, np.arange(H // 2), np.arange(W // 2)),
             (np.linspace(1000, 1002, 2, endpoint=False), np.arange(2), np.arange(3))]
    return [jrope(d, *g) for g in grids], [trope(d, *g) for g in grids]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs()
    jr, _ = _ropes(jcfg.attention_head_dim)
    jmodel = JD.CogVideoXTransformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, F, 16, H, W)),
                         jnp.zeros((1, jcfg.max_text_seq_length, jcfg.text_embed_dim)),
                         jnp.zeros((1,), jnp.int32), vip_hidden_states=jnp.zeros((1, 2, 24, 2, 3)),
                         image_rotary_emb=jr[0], vip_image_rotary_emb=jr[1],
                         vip_condition_rotary_emb=jr[2])
    # un-grafted random VIP weights, so the branch differs from the base
    tmodel = TD.CogVideoXTransformer(tcfg).eval()
    tmodel.load_state_dict(to_torch(dit_state_dict(np_tree(params), tcfg)), strict=True)
    return jcfg, jmodel, params, tmodel


def test_state_dict_keys_are_the_reference_layout(models):
    jcfg, _, params, tmodel = models
    assert set(tmodel.state_dict()) == set(export_dit(np_tree(params), jcfg))


@pytest.mark.parametrize("per_frame_t", [False, True])
def test_forward_matches_jax(models, per_frame_t):
    jcfg, jmodel, params, tmodel = models
    jr, tr = _ropes(jcfg.attention_head_dim)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, F, 16, H, W)).astype(np.float32)
    text = rng.normal(size=(2, jcfg.max_text_seq_length, jcfg.text_embed_dim)).astype(np.float32)
    vip = rng.normal(size=(2, 2, 24, 2, 3)).astype(np.float32)
    ts = np.array([[900, 850], [300, 250]]) if per_frame_t else np.array([900, 300])
    ref = jmodel.apply(params, jnp.asarray(x), jnp.asarray(text), jnp.asarray(ts),
                       vip_hidden_states=jnp.asarray(vip), image_rotary_emb=jr[0],
                       vip_image_rotary_emb=jr[1], vip_condition_rotary_emb=jr[2],
                       vip_scale=jnp.asarray(0.6))
    with torch.no_grad():
        out = tmodel(t(x), t(text), torch.from_numpy(ts), t(vip), tr[0], tr[1], tr[2], 0.6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_graft_vip_params_matches_jax(models):
    jcfg, _, params, _ = models
    _, tcfg = _configs()
    grafted = JD.graft_vip_params(params["params"], jcfg)
    tmodel = TD.CogVideoXTransformer(tcfg)
    tmodel.load_state_dict(to_torch(dit_state_dict(np_tree(params), tcfg)), strict=True)
    TD.graft_vip_params(tmodel)
    want = dit_state_dict(np_tree(grafted), tcfg)
    for k, v in tmodel.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)

