"""Port parity: the DINOv2 conditioning path (``use_vae_as_encoder: false``)
against the JAX package: models/dinov2.py's encoder (weights moved by
convert/from_jax.dinov2_state_dict, f32: 1e-5) and `preprocess_frames`
(720x480 -> 224: 2e-5, the JAX package's own f32 resize being 1.5e-5 from a
float64 one where the port's is 6e-7; below 1e-6 elsewhere), `load_dinov2`
on an HF-layout dir, the pipeline's `encode_image_dinov2` and `generate`
(1e-4), and the CLI (`infer.main --smoke --set use_vae_as_encoder=false`)
and `VideoService.edit` on that config against the JAX CLI's
`build_pipeline` (1e-4), the JAX noise replayed."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infer as jax_infer
from tokensgen_tpu.core import schedule as JS
from tokensgen_tpu.data.video_io import load_video as jax_load_video
from tokensgen_tpu.data.video_io import write_video as jax_write_video
from tokensgen_tpu.models import dinov2 as JDv
from tokensgen_tpu.models import dit as JD
from tokensgen_tpu.models import resampler as JR
from tokensgen_tpu.pipelines import to2v as JP
from tokensgen_tpu.serving import VideoService as JVideoService
from tokensgen_tpu.utils.config import input_items
from tokensgen_tpu.utils.config import load_config as jax_load_config
from tokensgen_tpu_torch import infer
from tokensgen_tpu_torch.convert.from_jax import (dinov2_state_dict, dit_state_dict,
                                                  resampler_state_dict, to_torch)
from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors
from tokensgen_tpu_torch.models import dinov2 as TDv
from tokensgen_tpu_torch.models import dit as TD
from tokensgen_tpu_torch.models import resampler as TR
from tokensgen_tpu_torch.pipelines import to2v as TP
from tokensgen_tpu_torch.serving import VideoService
from tokensgen_tpu_torch.utils.config import load_config

from _torch_parity import jax_noise, np_tree, random_params, t
from _torch_weights import smoke_trees, write_converted_dir

PIPE = dict(height=32, width=48, num_frames_per_chunk=9, num_inference_steps=6, num_partitions=2,
            use_vae_as_encoder=False)
VIP = dict(output_dim=24, num_temporal_queries=2, num_height_queries=2, num_width_queries=3,
           length=3 * 2 * 3)
CHUNKS, STEPS, NF = 2, 6, 3
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_encoder(cfg, key=0):
    return JDv.DINOv2Encoder(cfg).init(jax.random.PRNGKey(key),
                                       jnp.zeros((1, 3, cfg.image_size, cfg.image_size)))


def _port_encoder(params, cfg):
    enc = TDv.DINOv2Encoder(TDv.DINOv2Config.tiny()).eval()
    enc.load_state_dict(to_torch(dinov2_state_dict(np_tree(params), cfg.num_layers)), strict=True)
    return enc


def _hf_state_dict(params, cfg):
    """The HF ``Dinov2Model`` file of a JAX tree: the port's names, plus the
    keys an HF checkpoint carries that the path does not read."""
    sd = to_torch(dinov2_state_dict(np_tree(params), cfg.num_layers))
    d = cfg.hidden_size
    last = f"encoder.layer.{cfg.num_layers - 1}"
    sd.update({"embeddings.mask_token": torch.zeros(1, d), "layernorm.weight": torch.ones(d),
               "layernorm.bias": torch.zeros(d), f"{last}.norm1.weight": torch.ones(d)})
    return sd


def test_encoder_matches_jax():
    cfg = JDv.DINOv2Config.tiny()
    params = random_params(JDv.DINOv2Encoder(cfg).init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 3, 32, 32)), seed=3)
    px = np.random.default_rng(0).normal(size=(2, 3, 32, 32)).astype(np.float32)
    ref = JDv.DINOv2Encoder(cfg).apply(params, jnp.asarray(px))
    with torch.no_grad():
        out = _port_encoder(params, cfg)(t(px))
    assert out.shape == (2, 1 + cfg.num_patches, cfg.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,size,tol", [((3, 480, 720, 3), 224, 2e-5),
                                            ((3, 17, 23, 3), 32, 1e-6)])
def test_preprocess_frames_matches_jax(shape, size, tol):
    """The antialiased linear resize + ImageNet normalisation against the JAX
    `preprocess_frames` (``jax.image.resize``), at ``tol`` absolute; the
    port's resize is also held to a float64 one at 1e-6."""
    frames = np.random.default_rng(1).uniform(-1, 1, size=shape).astype(np.float32)
    ref = np.asarray(JDv.preprocess_frames(jnp.asarray(frames), size))
    out = TDv.preprocess_frames(t(frames), size).numpy()
    assert out.shape == (shape[0], 3, size, size)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    wh = TDv._resize_weights(shape[1], size, "cpu").double().numpy()
    ww = TDv._resize_weights(shape[2], size, "cpu").double().numpy()
    x64 = np.einsum("nhwc,wW->nhWc", np.einsum("nhwc,hH->nHwc",
                                              (frames.astype(np.float64) + 1) / 2, wh), ww)
    x64 = ((x64 - TDv.IMAGENET_MEAN) / TDv.IMAGENET_STD).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(out, x64, rtol=0, atol=1e-6)
    white = TDv.preprocess_frames(torch.ones(1, 8, 8, 3), 16).numpy()
    np.testing.assert_allclose(white[0, :, 0, 0], (1 - TDv.IMAGENET_MEAN) / TDv.IMAGENET_STD,
                               atol=1e-5)


def test_load_dinov2_reads_an_hf_dir(tmp_path):
    """`load_dinov2` on an HF-layout dir (two shards, with the keys the path
    does not read) equals the tree it was written from; the JAX package's
    `convert_dinov2` reads the same names; a position table for another
    image size and a missing key raise."""
    cfg = JDv.DINOv2Config.tiny()
    params = _jax_encoder(cfg)
    sd = _hf_state_dict(params, cfg)
    names = sorted(sd)
    save_safetensors(str(tmp_path / "model-1.safetensors"), {k: sd[k] for k in names[::2]})
    save_safetensors(str(tmp_path / "model-2.safetensors"), {k: sd[k] for k in names[1::2]})
    enc = TDv.load_dinov2(str(tmp_path), TDv.DINOv2Config.tiny(), device="cpu")
    want = to_torch(dinov2_state_dict(np_tree(params), cfg.num_layers))
    got = enc.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    back = JDv.convert_dinov2({k: v.numpy() for k, v in sd.items()}, cfg)
    for k, v in to_torch(dinov2_state_dict(back, cfg.num_layers)).items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match="position_embeddings"):
        TDv.convert_dinov2(sd, TDv.DINOv2Config.tiny(image_size=48))
    with pytest.raises(KeyError):
        TDv.convert_dinov2({k: v for k, v in sd.items() if "fc2" not in k},
                           TDv.DINOv2Config.tiny())


@pytest.fixture(scope="module")
def pipes():
    """The JAX and port To2V pipelines on the DINOv2 path at the smoke
    geometry (the JAX DiT fused as the JAX CLI fuses it in bf16, the port's
    loaded from that fused tree, the tiny resampler as wide as the tiny
    encoder), without a VAE."""
    ecfg = JDv.DINOv2Config.tiny()
    enc_params = _jax_encoder(ecfg, key=7)
    jd = JD.DiTConfig.tiny(vip=JD.VIPConfig(**VIP), sample_height=4, sample_width=6,
                           fuse_qkv=True)
    td = TD.DiTConfig.tiny(vip=TD.VIPConfig(**VIP), sample_height=4, sample_width=6)
    rkw = dict(embedding_dim=ecfg.hidden_size, output_dim=24, num_temporal_queries=2,
               num_height_queries=2, num_width_queries=3)
    jrc, trc = JR.ResamplerConfig.tiny(**rkw), TR.ResamplerConfig.tiny(**rkw)
    trees = smoke_trees(seed=5)
    rs_params = random_params(JR.Resampler(jrc).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 9, 16, jrc.embedding_dim)), seed=9)
    jfused = JD.fuse_qkv_params(trees["to2v_dit"])
    jpipe = JP.To2VPipeline(JP.To2VConfig(**PIPE), jd, {"params": jfused}, jrc, rs_params, None,
                            JS.make_schedule(),
                            image_encoder=(JDv.DINOv2Encoder(ecfg), enc_params))
    dit = TD.CogVideoXTransformer(td).eval()
    dit.load_state_dict(to_torch(dit_state_dict(np_tree(jfused), td)), strict=True)
    rs = TR.Resampler(trc).eval()
    rs.load_state_dict(to_torch(resampler_state_dict(np_tree(rs_params), trc.depth)), strict=True)
    tpipe = TP.To2VPipeline(TP.To2VConfig(**PIPE), dit.cfg, dit, trc, rs, None, device="cpu",
                            image_encoder=_port_encoder(enc_params, ecfg))
    return jpipe, tpipe


def test_encode_image_dinov2_matches_jax(pipes):
    """The CFG pair [uncond (zero images through the encoder), cond], 2
    chunks x 2 temporal queries; also without CFG."""
    jpipe, tpipe = pipes
    frames = np.random.default_rng(2).uniform(-1, 1, size=(1, 18, 32, 48, 3)).astype(np.float32)
    ref = np.asarray(jpipe.encode_image_dinov2(jnp.asarray(frames)))
    out = tpipe.encode_image_dinov2(t(frames)).numpy()
    assert out.shape == (2, 4, 24, 2, 3)
    np.testing.assert_allclose(out, ref, **TOL)
    assert not np.allclose(out[0], out[1])
    one = tpipe.encode_image_dinov2(t(frames), do_cfg=False).numpy()
    np.testing.assert_allclose(one, out[1:], rtol=0, atol=1e-6)


def test_generate_matches_jax(pipes):
    """`generate` with ``use_vae_as_encoder=False`` from source frames,
    undecoded: the DINOv2 encode, the base pass and the FIFO."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(3)
    frames = rng.uniform(-1, 1, size=(1, CHUNKS * 9, 32, 48, 3)).astype(np.float32)
    text = rng.normal(size=(1, 8, 24)).astype(np.float32)
    neg = np.zeros_like(text)
    key = jax.random.PRNGKey(4)
    ref = jpipe.generate(jnp.asarray(text), jnp.asarray(neg), frames=jnp.asarray(frames),
                         num_chunks=CHUNKS, rng=key, decode=False)
    _, _, r_base, r_fifo = jax.random.split(key, 4)
    r_steps, r_latents = jax.random.split(r_base)
    noise = jax_noise(base_rng=r_steps, fifo_rng=r_fifo, base_steps=STEPS,
                      fifo_iters=CHUNKS * NF + STEPS - NF, latents_key=r_latents)
    out = tpipe.generate(t(text), t(neg), frames=t(frames), num_chunks=CHUNKS, noise_fn=noise,
                         decode=False)
    for name in ("latents", "orig_latents"):
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), err_msg=name, **TOL)


# ------------------------------------------------------- the CLI and the server


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A smoke config of the edit CLI with ``use_vae_as_encoder: false`` and a
    converted_weights_dir; the port's copy also names an HF dir holding the
    DINOv2 weights the JAX CLI draws at random (its seed 7), which the JAX
    CLI cannot read at the smoke's size (its loader takes DINOv2-large)."""
    root = tmp_path_factory.mktemp("dinov2_cli")
    src = str(root / "src.mp4")
    jax_write_video(src, np.random.default_rng(0).uniform(-1, 1, size=(40, 40, 56, 3)).astype(
        np.float32), fps=20)
    conv = write_converted_dir(str(root / "conv"), smoke_trees(seed=7))
    ecfg = JDv.DINOv2Config.tiny()
    enc_dir = root / "dinov2"
    enc_dir.mkdir()
    save_safetensors(str(enc_dir / "model.safetensors"),
                     _hf_state_dict(_jax_encoder(ecfg, key=7), ecfg))
    body = f"""
name_prefix: edit
output_dir: {root}/out
seed: 3
converted_weights_dir: {conv}
use_vae_as_encoder: false
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
"""
    (root / "jax.yaml").write_text(body)
    (root / "port.yaml").write_text(body + f"image_encoder_path: {enc_dir}\n")
    jcfg = jax_load_config(str(root / "jax.yaml"))
    jpipe, _ = jax_infer.build_pipeline(jcfg, smoke=True)
    return root, jcfg, jpipe


def _jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    _, _, r_base, r_fifo = jax.random.split(key, 4)
    r_steps, r_latents = jax.random.split(r_base)
    return key, jax_noise(base_rng=r_steps, fifo_rng=r_fifo, base_steps=STEPS,
                          fifo_iters=CHUNKS * NF + STEPS - NF, latents_key=r_latents)


def test_cli_dinov2_matches_jax_build_pipeline(cli, monkeypatch, capsys):
    root, jcfg, jpipe = cli
    key, noise = _jax_draws(3)
    monkeypatch.setattr(infer, "generator_noise", lambda _gen: noise)
    run_dir = infer.main(["--config", str(root / "port.yaml"), "--smoke", "--device", "cpu"])
    assert "dinov2=checkpoint" in capsys.readouterr().out
    for suffix in ("source.mp4", "orig.mp4", "fifo.mp4", "latents.npy"):
        assert glob.glob(os.path.join(run_dir, f"item_a_{suffix}")), suffix
    lat = np.load(os.path.join(run_dir, "item_a_latents.npy"))
    item = input_items(jcfg)[0]
    jenc = jax_infer.build_text_encoder(jcfg, smoke=True)
    src = jax_load_video(item["video"], sample_fps=10, output_res=(32, 48), max_frames=CHUNKS * 9)
    ref = jpipe.generate(jnp.asarray(jenc([item["prompt"]])), jnp.asarray(jenc([""])),
                         frames=jnp.asarray(src), num_chunks=CHUNKS, rng=key, decode=False)
    assert lat.shape == (1, CHUNKS * NF, 16, 4, 6)
    np.testing.assert_allclose(lat, np.asarray(ref["latents"]), **TOL)


def test_video_service_edit_on_the_dinov2_config(cli):
    """`VideoService.edit` on the port's build of that config against the JAX
    service on the JAX build, the request's seed replayed as JAX draws."""
    root, jcfg, jpipe = cli
    cfg = load_config(str(root / "port.yaml"))
    pipe, _ = infer.build_pipeline(cfg, smoke=True, device="cpu")
    assert pipe.image_encoder is not None
    frames = np.random.default_rng(5).uniform(-1, 1, size=(1, CHUNKS * 9, 32, 48, 3)).astype(
        np.float32)
    service = VideoService(pipe, infer.build_text_encoder(cfg, smoke=True, device="cpu"),
                           noise_for_seed=lambda seed: _jax_draws(seed)[1])
    out = service.edit("a red car", frames, num_chunks=CHUNKS, seed=11, decode=False)
    jservice = JVideoService(jpipe, jax_infer.build_text_encoder(jcfg, smoke=True))
    ref = jservice.edit("a red car", frames, num_chunks=CHUNKS, seed=11, decode=False)
    np.testing.assert_allclose(out["latents"], ref["latents"], **TOL)
