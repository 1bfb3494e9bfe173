"""Port parity: the DiT's variants in models/dit.py against the JAX DiT at the
tiny config, weights moved by convert/from_jax.py: VIP func_types "1"-"4",
the JAX package's fused q/k/v trees moved into the port's unfused layout
(both settings of fuse_vip_qkv, the round trip, grafting and quantizing on
fused layouts), the sincos (CogVideoX-2b) mode
with vip_pos_embedding, the raw-token output mode, the sincos tables, and
the port's state-dict names read by the JAX package's diffusers reader
(`convert_dit`) and, as a checkpoint, by the port's own. f32 on the CPU:
1e-5 absolute (rtol 1e-4) per forward."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokensgen_tpu.convert.torch_weights import convert_dit
from tokensgen_tpu.core import rope as JR
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu_torch.convert.from_jax import dit_state_dict, to_torch
from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors
from tokensgen_tpu_torch.core import rope as TR
from tokensgen_tpu_torch.infer import load_checkpoint_dit
from tokensgen_tpu_torch.models import dit as TD

from _torch_parity import np_tree, random_params, t

F, H, W = 2, 8, 16  # latent frames and size of DiTConfig.tiny
HW = (H // 2) * (W // 2)
F_AR = 1  # func_type "4": the leading latent frame is the ar context
VIP = dict(output_dim=24, num_temporal_queries=2, num_height_queries=2, num_width_queries=3,
           length=2 * 2 * 3)
FWD = dict(rtol=1e-4, atol=1e-5)


def _vip(ft):
    kw = dict(VIP, func_type=ft)
    if ft == "4":
        kw.update(ar_length=F_AR * HW, scale_ar=0.7)
    return JD.VIPConfig(**kw), TD.VIPConfig(**kw)


def _configs(ft="1", **kw):
    jv, tv = _vip(ft) if ft is not None else (None, None)
    return JD.DiTConfig.tiny(vip=jv, **kw), TD.DiTConfig.tiny(vip=tv, **kw)


def _ropes(jcfg, f=F):
    """(JAX, port) keyword ropes: the base table over the frames the base
    attention sees (not the ar frame), the vip-image one over all frames."""
    d = jcfg.attention_head_dim
    if not jcfg.use_rotary_positional_embeddings:
        return {}, {}
    f_base = f - (F_AR if jcfg.vip is not None and jcfg.vip.func_type == "4" else 0)
    grids = {"image_rotary_emb": (np.arange(f_base), np.arange(H // 2), np.arange(W // 2))}
    if jcfg.vip is not None:
        grids["vip_image_rotary_emb"] = (np.arange(f) + 3.0, np.arange(H // 2), np.arange(W // 2))
        grids["vip_condition_rotary_emb"] = (np.linspace(1000, 1002, 2, endpoint=False),
                                             np.arange(2), np.arange(3))
    return ({k: JR.get_3d_rotary_pos_embed_v2(d, *g) for k, g in grids.items()},
            {k: TR.get_3d_rotary_pos_embed_v2(d, *g) for k, g in grids.items()})


def _inputs(jcfg, seed=1, f=F, h=H, w=W):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, f, 16, h, w)).astype(np.float32)
    text = rng.normal(size=(2, jcfg.max_text_seq_length, jcfg.text_embed_dim)).astype(np.float32)
    vip = rng.normal(size=(2, 2, 24, 2, 3)).astype(np.float32) if jcfg.vip is not None else None
    return x, text, np.array([900, 300]), vip


def _jax_params(jcfg, x, text, ts, vip, jr, seed=0):
    kw = dict(jr, vip_hidden_states=None if vip is None else jnp.asarray(vip))
    return random_params(JD.CogVideoXTransformer(jcfg).init, jax.random.PRNGKey(0),
                         jnp.asarray(x), jnp.asarray(text), jnp.asarray(ts), seed=seed, **kw)


def _port(tcfg, tree):
    model = TD.CogVideoXTransformer(tcfg).eval()
    model.load_state_dict(to_torch(dit_state_dict(tree, tcfg)), strict=True)
    return model


def _run_jax(jcfg, params, x, text, ts, vip, jr, **kw):
    vkw = {} if vip is None else dict(vip_hidden_states=jnp.asarray(vip),
                                      vip_scale=jnp.asarray(0.6))
    return np.asarray(JD.CogVideoXTransformer(jcfg).apply(
        params, jnp.asarray(x), jnp.asarray(text), jnp.asarray(ts), **jr, **vkw, **kw))


def _run_port(model, x, text, ts, vip, tr, **kw):
    vkw = {} if vip is None else dict(vip_hidden_states=t(vip), vip_scale=0.6)
    with torch.no_grad():
        return model(t(x), t(text), torch.from_numpy(ts), **tr, **vkw, **kw).numpy()


def _flat(tree):
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree).items()}


@pytest.mark.parametrize("ft", ["1", "2", "3", "4"])
def test_func_types_match_jax(ft):
    """Each VIP func_type against the JAX module, un-grafted random weights
    (the VIP branch differs from the base); "4" drops its ar frame."""
    jcfg, tcfg = _configs(ft)
    jr, tr = _ropes(jcfg)
    x, text, ts, vip = _inputs(jcfg)
    params = _jax_params(jcfg, x, text, ts, vip, jr)
    model = _port(tcfg, np_tree(params))
    ref = _run_jax(jcfg, params, x, text, ts, vip, jr)
    out = _run_port(model, x, text, ts, vip, tr)
    assert out.shape == (2, F - (F_AR if ft == "4" else 0), 16, H, W)
    np.testing.assert_allclose(out, ref, **FWD)
    names = {k.split(".", 2)[2] for k in model.state_dict()
             if k.startswith("transformer_blocks.0.")}
    assert ("vip_norm1.linear.weight" in names) == (ft != "3")
    assert ("ar_norm1.linear.weight" in names) == (ft == "4")


def _raw_token_setup():
    """Configs, ropes and inputs of the raw-token mode (T2To's: patch size
    1, no VIP) over 2 frames of 4 x 6 latents; ``ff_chunks`` set, as the
    JAX package's CLIs set it."""
    jcfg, tcfg = _configs(None, use_output_projection=False, patch_size=1, ff_chunks=2)
    d = jcfg.attention_head_dim
    grid = (np.arange(F), np.arange(4), np.arange(6))
    jr = {"image_rotary_emb": JR.get_3d_rotary_pos_embed_v2(d, *grid)}
    tr = {"image_rotary_emb": TR.get_3d_rotary_pos_embed_v2(d, *grid)}
    return jcfg, tcfg, jr, tr, _inputs(jcfg, h=4, w=6)


@pytest.mark.parametrize("variant", ["1", "2", "3", "4", "raw_token", "sincos", "fused"])
def test_convert_dit_reads_the_port_state_dict(variant, tmp_path):
    """The port's state dict (diffusers names) read by the JAX package's
    `convert_dit` gives back the JAX tree it came from (fused: the port's
    layout is unfused, so the unfused form of that tree); written as a
    diffusers checkpoint, it loads
    back strictly through `convert.torch_weights.read_safetensors_dir` and
    `infer.load_checkpoint_dit`."""
    if variant == "raw_token":
        jcfg, tcfg, jr, _, (x, text, ts, vip) = _raw_token_setup()
    else:
        kw = dict(use_rotary_positional_embeddings=False) if variant == "sincos" else {}
        if variant == "fused":
            kw = dict(fuse_qkv=True, fuse_vip_qkv=True)
        jcfg, tcfg = _configs(variant if variant in "1234" else "1", **kw)
        jr, _ = _ropes(jcfg)
        x, text, ts, vip = _inputs(jcfg)
    tree = np_tree(_jax_params(jcfg, x, text, ts, vip, jr))
    model = _port(tcfg, tree)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if variant == "fused":
        assert "to_qkv" in tree["blocks"]["attn1"] and "vip_to_qkv" in tree["blocks"]["attn1"]
        jcfg = dataclasses.replace(jcfg, fuse_qkv=False, fuse_vip_qkv=False)
        tree = JD.unfuse_qkv_params(tree)
    got, want = _flat(convert_dit(sd, jcfg)), _flat(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    save_safetensors(str(tmp_path / "model.safetensors"), model.state_dict())
    loaded = load_checkpoint_dit(str(tmp_path), tcfg, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


@pytest.mark.parametrize("fuse_vip", [False, True])
def test_fused_matches_unfused_and_jax(fuse_vip):
    """A fused JAX tree (`fuse_qkv_params`, with and without the VIP group)
    moved into the port: its state dict is bit-equal to the unfused tree's
    and to that of the JAX round trip (`unfuse_qkv_params`), and its forward
    matches the JAX fused forward and the JAX unfused one. The port takes
    the fuse flags and builds the same modules."""
    jcfg, tcfg = _configs("1")
    jr, tr = _ropes(jcfg)
    x, text, ts, vip = _inputs(jcfg)
    params = _jax_params(jcfg, x, text, ts, vip, jr)
    jfcfg = dataclasses.replace(jcfg, fuse_qkv=True, fuse_vip_qkv=fuse_vip)
    jfused = JD.fuse_qkv_params(params["params"], fuse_vip=fuse_vip)
    assert ("vip_to_qkv" in jfused["blocks"]["attn1"]) == fuse_vip
    model = _port(dataclasses.replace(tcfg, fuse_qkv=True, fuse_vip_qkv=fuse_vip),
                  np_tree(jfused))
    got = model.state_dict()
    for tree in (params["params"], JD.unfuse_qkv_params(jfused)):
        want = to_torch(dit_state_dict(np_tree(tree), tcfg))
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    out = _run_port(model, x, text, ts, vip, tr)
    np.testing.assert_allclose(out, _run_jax(jfcfg, {"params": jfused}, x, text, ts, vip, jr),
                               **FWD)
    np.testing.assert_allclose(out, _run_jax(jcfg, params, x, text, ts, vip, jr), **FWD)


@pytest.mark.parametrize("layout", [(True, True), (True, False), (False, True)])
def test_graft_on_fused_layouts_matches_jax(layout):
    """`graft_vip_params` on the port loaded from a JAX tree of each fused
    layout equals the JAX graft of the unfused tree (the JAX CLI's order:
    graft, then fuse) and, where the base is fused, the JAX graft of the
    fused tree itself (fused: vip_to_qkv <- to_qkv; mixed, base fused and
    vip not: the vip projections take to_qkv's thirds)."""
    fuse, fuse_vip = layout
    jcfg, tcfg = _configs("1", fuse_qkv=fuse, fuse_vip_qkv=fuse_vip)
    jr, _ = _ropes(jcfg)
    x, text, ts, vip = _inputs(jcfg)
    params = _jax_params(jcfg, x, text, ts, vip, jr)
    model = TD.graft_vip_params(_port(tcfg, np_tree(params)))
    got = model.state_dict()
    unfused_cfg = dataclasses.replace(jcfg, fuse_qkv=False, fuse_vip_qkv=False)
    grafts = [JD.graft_vip_params(JD.unfuse_qkv_params(params["params"]), unfused_cfg)]
    if fuse:
        grafts.append(JD.graft_vip_params(params["params"], jcfg))
    for tree in grafts:
        want = to_torch(dit_state_dict(np_tree(tree), tcfg))
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_quantize_after_fusing_matches_jax():
    """The JAX `quantize_dit_params` of a fused tree (fused, then quantized,
    as the JAX CLI orders them), moved into the port, is bit-equal to the
    port's `quantize_dit` of the unfused model: each output column's code
    and scale split off the fused ones exactly."""
    jcfg, tcfg = _configs("1")
    jr, _ = _ropes(jcfg)
    x, text, ts, vip = _inputs(jcfg)
    params = _jax_params(jcfg, x, text, ts, vip, jr)
    fused = JD.fuse_qkv_params(params["params"], fuse_vip=True)
    qcfg = dataclasses.replace(jcfg, fuse_qkv=True, fuse_vip_qkv=True, quant="w8a16")
    qtree = JD.quantize_dit_params(fused, qcfg)
    assert "kernel_q" in qtree["blocks"]["attn1"]["vip_to_qkv"]
    want = to_torch(dit_state_dict(np_tree(qtree), tcfg))
    model = _port(tcfg, np_tree(params))
    TD.quantize_dit(model, dataclasses.replace(model.cfg, quant="w8a16"))
    got = model.state_dict()
    assert "transformer_blocks.1.attn1.processor.vip_to_q.weight_q" in got
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_sincos_mode_with_vip_pos_embedding():
    """The CogVideoX-2b mode (absolute sincos video table, no RoPE, the final
    norm on the video only) with the VIP branch and a vip_pos_embedding."""
    jcfg, tcfg = _configs("1", use_rotary_positional_embeddings=False)
    assert not TD.DiTConfig.cogvideox_2b().use_rotary_positional_embeddings
    assert TD.DiTConfig.cogvideox_2b() == dataclasses.replace(
        TD.DiTConfig(), use_rotary_positional_embeddings=False)
    x, text, ts, vip = _inputs(jcfg)
    pos = np.random.default_rng(4).normal(size=(1, VIP["length"], jcfg.inner_dim))
    pos = pos.astype(np.float32)
    params = _jax_params(jcfg, x, text, ts, vip, {})
    model = _port(tcfg, np_tree(params))
    ref = _run_jax(jcfg, params, x, text, ts, vip, {}, vip_pos_embedding=jnp.asarray(pos))
    out = _run_port(model, x, text, ts, vip, {}, vip_pos_embedding=t(pos))
    np.testing.assert_allclose(out, ref, **FWD)
    without = _run_port(model, x, text, ts, vip, {})
    assert not np.allclose(without, out)


def test_raw_token_mode():
    """``use_output_projection=False`` (the T2To raw-token mode, patch size
    1): the dense patch embedding, the affine-free output norm, the normed
    hidden states out as [B, F, inner, H, W]; ``ff_chunks`` accepted and
    ignored."""
    jcfg, tcfg, jr, tr, (x, text, ts, _) = _raw_token_setup()
    params = _jax_params(jcfg, x, text, ts, None, jr)
    model = _port(tcfg, np_tree(params))
    assert model.patch_embed.proj.weight.dim() == 2 and model.norm_out.norm.weight is None
    ref = _run_jax(jcfg, params, x, text, ts, None, jr)
    out = _run_port(model, x, text, ts, None, tr)
    assert out.shape == (2, F, jcfg.inner_dim, 4, 6)
    np.testing.assert_allclose(out, ref, **FWD)


@pytest.mark.parametrize("case", ["3d", "v2"])
def test_sincos_tables_equal_jax(case):
    if case == "3d":
        args = (1920, (45, 30), 13, 1.875, 1.0)
        got, want = TR.get_3d_sincos_pos_embed(*args), JR.get_3d_sincos_pos_embed(*args)
    else:
        grids = (np.arange(8, dtype=np.float32) / 2, np.arange(12, dtype=np.float32),
                 np.linspace(1000, 1013, 4, endpoint=False, dtype=np.float32))
        got, want = TR.get_3d_sincos_pos_embed_v2(64, *grids), JR.get_3d_sincos_pos_embed_v2(
            64, *grids)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
