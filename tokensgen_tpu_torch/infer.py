"""Inference CLI of the port, the edit and generation workloads:

    python -m tokensgen_tpu_torch.infer --config tokensgen_tpu/configs/infer_edit.yaml [--smoke]
    python -m tokensgen_tpu_torch.infer --config tokensgen_tpu/configs/infer_gen.yaml [--smoke]

Reads the same config keys as the JAX package's `infer.py` and runs on
``--device`` (the card unless told ``cpu``):
* prompts: every prompt is encoded first by T5 (`converted_weights_dir`'s
  ``t5.safetensors``, `pretrained_text_encoder_path`, or
  `<pretrained_model_name_or_path>/text_encoder`, with a ``tokenizer.json``
  read through the ``tokenizers`` package), then the encoder is freed; the
  hash encoder only under ``--smoke`` or `allow_hash_text_encoder`;
* weights: `converted_weights_dir` (the JAX param trees), else the DiT from
  the top-level ``*.safetensors`` of `pretrained_model_name_or_path`
  (diffusers layout), else random weights from the config's seed, with a
  warning outside ``--smoke``; the gen workload's T2To stage takes
  ``t2to_dit`` and the `longvgen_pca` / `longvgen_mean` / `longvgen_std`
  artifacts;
* an edit item's `video:` is read with cv2 (`sample_fps`, `start_t`,
  `end_t`, `crop_to_fit`, `pad_to_fit`, chunks x frames per chunk).

Per item it writes ``{name}_source.mp4`` (edit), ``{name}_fifo.mp4``,
``{name}_orig.mp4``, ``{name}_latents.npy``, on gen ``{name}_tokens.npy``,
and for each `cache_idx` track ``{name}_cache{i}.mp4`` into a timestamped
run dir, at `output_fps`. ``quant`` (w8a16 / w8a8) and ``quant_attn`` run as
configured; ``fuse_qkv`` / ``fuse_vip_qkv`` are accepted and ignored (the
port keeps the DiT's q / k / v projections apart: ROADMAP, deliberate
differences). ``use_vae_as_encoder: false`` conditions on the DINOv2 image
encoder (`image_encoder_path`, an HF dir, else random weights: DINOv2-large,
tiny under ``--smoke``). ``--smoke`` runs the tiny
geometry of the JAX package's smoke (and synthesizes the source video of an
edit item that has none); without it the full CogVideoX-5b width runs. The
CLI builds VIP func_type "1" (the JAX CLI does, whatever the config says)
and refuses another value.

``--queue-devices N`` (or `sampling_params.queue_devices: N`) runs the
FIFO's rank windows over N processes, one card each (NCCL; on the host
with ``--device cpu``, Gloo): rank 0 encodes the prompts, runs every stage
but the FIFO and writes the outputs; every rank builds the pipeline on its
own device and runs its block of each FIFO iteration
(`pipelines.to2v.To2VPipeline.follow`). The outputs equal those of one
process for the same seed. N must divide the FIFO's rank windows (2 x
num_partitions with lookahead) and, under NCCL, not exceed the visible
cards; both are checked before anything is spawned. `sp_devices` > 1
raises NotImplementedError (ROADMAP A12), and with `queue_devices` > 1
ValueError, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from tokensgen_tpu_torch.convert.from_jax import (dit_state_dict, resampler_state_dict,
                                                  vae_state_dict)
from tokensgen_tpu_torch.convert.safetensors_io import load_param_tree
from tokensgen_tpu_torch.convert.torch_weights import load_gen_pca, read_safetensors_dir
from tokensgen_tpu_torch.core import pca as pca_lib
from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.data.video_io import load_video, write_video
from tokensgen_tpu_torch.models.dinov2 import DINOv2Config, DINOv2Encoder, load_dinov2
from tokensgen_tpu_torch.models.dit import (CogVideoXTransformer, DiTConfig, VIPConfig,
                                            graft_vip_params, quantize_dit)
from tokensgen_tpu_torch.models.resampler import Resampler, ResamplerConfig
from tokensgen_tpu_torch.models.text_encoder import CachedTextEncoder, make_text_encoder
from tokensgen_tpu_torch.models.vae3d import AutoencoderKLCogVideoX, VAEConfig, VAERunner
from tokensgen_tpu_torch.pipelines.t2to import T2ToConfig, T2ToPipeline, extend_generated_tokens
from tokensgen_tpu_torch.pipelines.to2v import To2VConfig, To2VPipeline
from tokensgen_tpu_torch.sampling.base import generator_noise
from tokensgen_tpu_torch.sampling.fifo import check_queue_split
from tokensgen_tpu_torch.sharding import mesh
from tokensgen_tpu_torch.utils.config import create_output_folders, input_items
from tokensgen_tpu_torch.utils.params import build_on_device, load_on_device, param_fingerprint


def _load_converted(cfg, name: str):
    """`converted_weights_dir`'s ``{name}.safetensors`` (a JAX param tree,
    as ``convert_weights.py`` writes it) as a nested dict of CPU tensors, or
    None when the dir is unset or lacks the file."""
    conv_dir = cfg.get("converted_weights_dir")
    if not conv_dir:
        return None
    path = os.path.join(conv_dir, name + ".safetensors")
    if not os.path.isfile(path):
        return None
    tree = load_param_tree(path)
    print(f"loaded converted {name} weights from {path}", flush=True)
    return tree


def _tensors(sd) -> dict:
    """A `convert/from_jax.py` state dict (numpy, views of the loaded tree)
    as CPU tensors, uncopied."""
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _report_weight_provenance(prov: dict, smoke: bool) -> None:
    """One line of where every module's weights came from, and a loud
    warning when a run outside --smoke is conditioned on random weights."""
    print("weights: " + "  ".join(f"{k}={v}" for k, v in prov.items()), flush=True)
    rand = [k for k, v in prov.items() if v.startswith("random")]
    if rand and not smoke:
        print("WARNING: non-smoke run with RANDOM weights for: " + ", ".join(rand)
              + " — outputs are not real videos. Set `converted_weights_dir` "
              "(convert_weights.py) or `pretrained_model_name_or_path`.", flush=True)


def _tree_has_vip(tree) -> bool:
    """True when any key of the nested param tree belongs to the VIP branch."""
    if isinstance(tree, dict):
        return any(("vip" in str(k)) or _tree_has_vip(v) for k, v in tree.items())
    return False


def build_text_encoder(cfg, smoke: bool, device) -> CachedTextEncoder:
    """T5 on ``device`` whenever a checkpoint is configured; the hash
    encoder only under --smoke or `allow_hash_text_encoder: true`.

    Checkpoint order: `converted_weights_dir/t5.safetensors` ->
    `pretrained_text_encoder_path` -> `<pretrained_model_name_or_path>/
    text_encoder`. The tokenizer comes from `pretrained_tokenizer_path` or
    `<pretrained_model_name_or_path>/tokenizer`, else the weights dir itself
    or its sibling `tokenizer/`."""
    probe = DiTConfig.tiny() if smoke else DiTConfig.cogvideox_5b()
    conv_dir = cfg.get("converted_weights_dir")
    conv_t5 = os.path.join(conv_dir, "t5.safetensors") if conv_dir else None
    if conv_t5 and not os.path.isfile(conv_t5):
        conv_t5 = None
    enc_dir = cfg.get("pretrained_text_encoder_path")
    ckpt = cfg.get("pretrained_model_name_or_path")
    if not enc_dir and ckpt and os.path.isdir(os.path.join(ckpt, "text_encoder")):
        enc_dir = os.path.join(ckpt, "text_encoder")
    tok_dir = cfg.get("pretrained_tokenizer_path")
    if not tok_dir and ckpt and os.path.isdir(os.path.join(ckpt, "tokenizer")):
        tok_dir = os.path.join(ckpt, "tokenizer")
    allow_hash = smoke or bool(cfg.get("allow_hash_text_encoder", False))
    if not (conv_t5 or enc_dir) and not allow_hash:
        raise ValueError(
            "no text encoder configured: set `pretrained_text_encoder_path` (HF T5 dir), "
            "`converted_weights_dir` (with t5.safetensors), or opt into pseudo-embeddings "
            "with `allow_hash_text_encoder: true` / --smoke")
    return make_text_encoder(enc_dir, probe.max_text_seq_length, probe.text_embed_dim,
                             allow_hash_fallback=allow_hash, converted_path=conv_t5,
                             tokenizer_dir=tok_dir, device=device)


def _configs(cfg, smoke: bool, device: torch.device):
    vp = cfg.get("video_ipadapter_params", {})
    rp = vp.get("resampler_params", {})
    if vp.get("func_type", "1") != "1":
        raise NotImplementedError(
            f"VIP func_type {vp.get('func_type')!r}: this CLI builds func_type \"1\", as the JAX "
            "CLI does whatever the config says (ROADMAP, deliberate differences); build another "
            "variant through models.dit.VIPConfig")
    vip_scale = (vp.get("scale") or [1.0])[0]
    quant = dict(quant=cfg.get("quant") or None, quant_attn=bool(cfg.get("quant_attn", False)))
    use_vae = bool(cfg.get("use_vae_as_encoder", True))
    renoise = cfg.get_path("sampling_params.tail_renoise_mode", "xt")
    if smoke:
        # the JAX package's smoke geometry; on a card, heads of 64 in bf16,
        # which is what the attention kernels take
        card = dict(dtype=torch.bfloat16) if device.type == "cuda" else {}
        vc = VIPConfig(output_dim=24, num_temporal_queries=2, num_height_queries=2,
                       num_width_queries=3, length=3 * 2 * 3)
        dcfg = DiTConfig.tiny(vip=vc, sample_height=4, sample_width=6, **quant,
                              **(dict(card, attention_head_dim=64) if card else {}))
        rcfg = ResamplerConfig.tiny(embedding_dim=dcfg.inner_dim, output_dim=24,
                                    num_temporal_queries=2, num_height_queries=2,
                                    num_width_queries=3,
                                    **(dict(card, dim_head=64) if card else {}))
        vcfg = VAEConfig.tiny(sample_height=32, sample_width=48)
        pcfg = To2VConfig(height=32, width=48, num_frames_per_chunk=9, num_inference_steps=6,
                          num_partitions=2, vip_scale=vip_scale,
                          use_dynamic_cfg=cfg.get("use_dynamic_cfg", False),
                          tail_renoise_mode=renoise, use_vae_as_encoder=use_vae)
        return dcfg, rcfg, vcfg, pcfg
    vc = VIPConfig(length=vp.get("length", 480), scale=vip_scale,
                   output_dim=rp.get("output_dim", 3072),
                   num_temporal_queries=rp.get("num_temporal_queries", 4),
                   num_height_queries=rp.get("num_height_queries", 8),
                   num_width_queries=rp.get("num_width_queries", 12))
    dcfg = DiTConfig.cogvideox_5b(vip=vc, **quant)
    rcfg = ResamplerConfig(**{k: v for k, v in rp.items()
                              if k in ResamplerConfig.__dataclass_fields__})
    vcfg = VAEConfig.cogvideox()
    pcfg = To2VConfig(
        num_inference_steps=cfg.get("num_inference_steps", 52),
        num_frames_per_chunk=cfg.get("num_frames_per_chunk", 49),
        guidance_scale=cfg.get("guidance_scale", 6.0),
        guidance_scale_img=cfg.get("guidance_scale_img", 1.5),
        use_separate_guidance=cfg.get("use_separate_guidance", False),
        num_partitions=cfg.get_path("sampling_params.num_partitions", 4),
        lookahead_denoising=cfg.get_path("sampling_params.lookahead_denoising", True),
        use_adaptive_padding=cfg.get_path("sampling_params.use_adaptive_padding", True),
        vip_scale=vip_scale, use_dynamic_cfg=cfg.get("use_dynamic_cfg", False),
        tail_renoise_mode=renoise, use_vae_as_encoder=use_vae)
    return dcfg, rcfg, vcfg, pcfg


def load_checkpoint_dit(ckpt: Optional[str], float_cfg: DiTConfig,
                        device) -> Optional[CogVideoXTransformer]:
    """The DiT of `pretrained_model_name_or_path`, as the JAX CLI reads it:
    every top-level ``*.safetensors`` of ``ckpt`` (diffusers names, the VIP
    branch's included; subdirs such as ``transformer/`` are not read),
    loaded strictly into a float model on ``device``. None when there is no
    such file."""
    sd = read_safetensors_dir(ckpt) if ckpt and os.path.isdir(ckpt) else {}
    if not sd:
        return None
    return load_on_device(lambda: CogVideoXTransformer(float_cfg), sd, device)


def build_image_encoder(cfg, smoke: bool, rcfg: ResamplerConfig, device, prov: dict):
    """The DINOv2 encoder of ``use_vae_as_encoder: false``, on ``device``:
    DINOv2-large, or under ``--smoke`` the tiny one (on a card as wide as the
    resampler's input, in heads of 64); its weights from the HF dir
    `image_encoder_path` when that dir exists, else random from seed 7."""
    if not smoke:
        ecfg = DINOv2Config.large()
    elif device.type == "cuda":
        ecfg = DINOv2Config.tiny(hidden_size=rcfg.embedding_dim,
                                 num_heads=rcfg.embedding_dim // 64)
    else:
        ecfg = DINOv2Config.tiny()
    enc_dir = cfg.get("image_encoder_path")
    if enc_dir and os.path.isdir(enc_dir):
        enc = load_dinov2(enc_dir, ecfg, device=device)
        print(f"loaded DINOv2 image encoder from {enc_dir}", flush=True)
        prov["dinov2"] = "checkpoint"
    else:
        enc = build_on_device(lambda: DINOv2Encoder(ecfg), device,
                              torch.Generator(device=device).manual_seed(7))
        prov["dinov2"] = "random"
    if ecfg.hidden_size != rcfg.embedding_dim:
        raise ValueError(
            f"the DINOv2 encoder's width {ecfg.hidden_size} is not the resampler's input width "
            f"{rcfg.embedding_dim}: set video_ipadapter_params.resampler_params.embedding_dim")
    return enc


def build_pipeline(cfg, smoke: bool, device):
    """-> (To2VPipeline, DiTConfig) on ``device``. Weights, as the JAX CLI
    takes them: `converted_weights_dir`'s ``vae`` / ``resampler`` /
    ``to2v_dit`` trees; else, for the DiT, the top-level ``*.safetensors``
    of `pretrained_model_name_or_path` (diffusers layout, VIP keys
    included); else random weights made on ``device`` from the config's
    ``seed`` (the DiT's VIP branch grafted from its base attention). The DiT
    is quantized under ``quant`` last. ``use_vae_as_encoder: false`` adds the DINOv2 encoder
    (`build_image_encoder`)."""
    device = torch.device(device)
    dcfg, rcfg, vcfg, pcfg = _configs(cfg, smoke, device)
    gen = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 42)))
    prov = {}
    vae_tree = _load_converted(cfg, "vae")
    if vae_tree is not None:
        vae_model = load_on_device(lambda: AutoencoderKLCogVideoX(vcfg),
                                   _tensors(vae_state_dict(vae_tree)), device)
        prov["vae"] = "converted"
    else:
        vae_model = build_on_device(lambda: AutoencoderKLCogVideoX(vcfg), device, gen)
        prov["vae"] = "random"
    vae = VAERunner(vcfg, vae_model, use_tiling=not smoke)
    rs_tree = _load_converted(cfg, "resampler")
    if rs_tree is not None:
        resampler = load_on_device(lambda: Resampler(rcfg),
                                   _tensors(resampler_state_dict(rs_tree, rcfg.depth)), device)
        prov["resampler"] = "converted"
    else:
        resampler = build_on_device(lambda: Resampler(rcfg), device, gen)
        prov["resampler"] = "random"
    # loading and grafting run on the float layout; quantization comes last
    float_cfg = dataclasses.replace(dcfg, quant=None, quant_attn=False)
    dit_tree = _load_converted(cfg, "to2v_dit")
    ckpt = cfg.get("pretrained_model_name_or_path")
    if dit_tree is not None:
        if not _tree_has_vip(dit_tree):
            raise ValueError(
                "converted to2v_dit tree has no VIP branch (vip.pt was absent at "
                "convert_weights.py time — manifest records to2v_dit.vip: false). Re-convert "
                "with TokensGen-To2V/vip.pt in place; VIP-conditioned inference needs the "
                "trained adapters.")
        dit = load_on_device(lambda: CogVideoXTransformer(float_cfg),
                             _tensors(dit_state_dict(dit_tree, float_cfg)), device)
        prov["to2v_dit"] = "converted"
    else:
        dit = load_checkpoint_dit(ckpt, float_cfg, device)
        if dit is not None:
            print(f"loaded DiT weights from {ckpt}", flush=True)
            prov["to2v_dit"] = "torch-checkpoint"
        else:
            dit = graft_vip_params(build_on_device(lambda: CogVideoXTransformer(float_cfg),
                                                   device, gen))
            prov["to2v_dit"] = "random(grafted vip)"
    dit = quantize_dit(dit, dcfg)
    if dcfg.quant:
        print(f"quantized DiT dense projections: {dcfg.quant} (quant_attn {dcfg.quant_attn})",
              flush=True)
    image_encoder = None
    if not pcfg.use_vae_as_encoder:
        image_encoder = build_image_encoder(cfg, smoke, rcfg, device, prov)
    _report_weight_provenance(prov, smoke)
    sched = S.make_schedule(S.ScheduleConfig(), device=device)
    return To2VPipeline(pcfg, dcfg, dit, rcfg, resampler, vae, sched, device=device,
                        image_encoder=image_encoder), dcfg


def t2to_pca(cfg, smoke: bool, token_dim: int, device):
    """(PCAState, token mean, token std, provenance) of the T2To stage:
    outside --smoke the `longvgen_pca` / `longvgen_mean` / `longvgen_std`
    artifacts, else a PCA fitted to random data with zero mean and unit std
    (the JAX CLI's weights-free stand-in)."""
    if not smoke and cfg.get("longvgen_pca"):
        return (*load_gen_pca(cfg.longvgen_pca, cfg.longvgen_mean, cfg.longvgen_std, device),
                "artifacts")
    # as many samples as dims: inverse_transform needs the square component
    # matrix (the SVD yields min(n_samples, dim) components)
    data = np.random.default_rng(0).normal(size=(token_dim + 64, token_dim))
    pca = pca_lib.fit(torch.from_numpy(data.astype(np.float32)).to(device), None)
    return pca, torch.zeros(1, token_dim), torch.ones(1, token_dim), "random(identity-scale)"


def build_t2to_pipeline(cfg, smoke: bool, pipe: To2VPipeline, device) -> T2ToPipeline:
    """The T2To token generator (the gen workload's first stage) on
    ``device``: `converted_weights_dir`'s ``t2to_dit`` tree, else random
    weights (seed 1, as the JAX package's init key); outside --smoke the
    `longvgen_pca` / `longvgen_mean` / `longvgen_std` artifacts, else a PCA
    fitted to random data as the JAX package fits its weights-free
    stand-in."""
    device = torch.device(device)
    if smoke:
        rc = pipe.resampler_config
        t2cfg = T2ToConfig(num_inference_steps=4, num_frames_per_chunk=rc.num_temporal_queries,
                           token_dim=rc.output_dim, height=rc.num_height_queries,
                           width=rc.num_width_queries, stochastic=False)
        card = dict(dtype=torch.bfloat16) if device.type == "cuda" else {}
        t2dcfg = DiTConfig.tiny(patch_size=1, sample_height=t2cfg.height,
                                sample_width=t2cfg.width, attention_head_dim=64,
                                num_attention_heads=1, **card)
    else:
        t2cfg = T2ToConfig(num_inference_steps=cfg.get("num_inference_steps", 52))
        t2dcfg = DiTConfig.t2to_5b()
    prov = {}
    t2_tree = _load_converted(cfg, "t2to_dit")
    if t2_tree is not None:
        dit = load_on_device(lambda: CogVideoXTransformer(t2dcfg),
                             _tensors(dit_state_dict(t2_tree, t2dcfg)), device)
        prov["t2to_dit"] = "converted"
    else:
        gen = torch.Generator(device=device).manual_seed(1)
        dit = build_on_device(lambda: CogVideoXTransformer(t2dcfg), device, gen)
        prov["t2to_dit"] = "random"
    pca, mean, std, prov["pca"] = t2to_pca(cfg, smoke, t2cfg.token_dim, device)
    _report_weight_provenance(prov, smoke)
    return T2ToPipeline(t2cfg, t2dcfg, dit, pca=pca, token_mean=mean, token_std=std,
                        device=device)


def gen_image_embeddings(t2to_pipe: T2ToPipeline, pipe: To2VPipeline, prompt_embeds,
                         negative_embeds, num_chunks: int, noise_fn) -> tuple:
    """The gen workload's first stage: T2To tokens [1, 4*chunks, 3072, 8, 12]
    from the prompt, and the CFG-batched, extended VIP embeddings that To2V
    renders. Returns (tokens, image_embeddings)."""
    toks = t2to_pipe(prompt_embeds, negative_embeds, num_chunks=num_chunks, noise_fn=noise_fn)
    ext = extend_generated_tokens(toks, num_chunks)
    parts = [ext, torch.zeros_like(ext), ext] if pipe.cfg.use_separate_guidance else [ext, ext]
    return toks, torch.cat(parts, dim=0)


def load_cli_config(path: str, sets):
    """The config at ``path`` with each ``KEY=VALUE`` of ``sets`` applied (a
    dotted key; the value parsed as yaml)."""
    import yaml

    from tokensgen_tpu_torch.utils.config import load_config

    overrides = {}
    for kv in sets:
        key, _, val = kv.partition("=")
        overrides[key] = yaml.safe_load(val)
    return load_config(path, overrides)


def queue_devices(cfg, requested: Optional[int] = None) -> int:
    """The run's queue devices (``requested``, else
    `sampling_params.queue_devices`, else 1). `sp_devices` > 1 raises
    NotImplementedError (ROADMAP A12), and with queue devices > 1 the JAX
    CLI's ValueError."""
    nq = int(requested or cfg.get_path("sampling_params.queue_devices", 1) or 1)
    if int(cfg.get("sp_devices") or 1) > 1:
        if nq > 1:
            raise ValueError("sp_devices and queue_devices are mutually exclusive — pick one "
                             "parallel axis per run")
        raise NotImplementedError("`sp_devices` > 1: sequence parallelism over several GPUs is "
                                  "not ported yet (ROADMAP A12)")
    return nq


def prepare_queue_group(cfg, smoke: bool, device, nq: int) -> None:
    """Before spawning ``nq`` ranks: raises unless they can run this
    config's FIFO on ``device``'s type (its rank windows split evenly, a
    card a rank under NCCL), then, on the card, builds the kernel libraries
    once here (nvcc's per-process lock does not guard several processes)."""
    pcfg = _configs(cfg, smoke, torch.device(device))[3]
    check_queue_split(pcfg.num_partitions * (2 if pcfg.lookahead_denoising else 1), nq)
    mesh.check_ranks(nq, device)
    if torch.device(device).type == "cuda":
        from tokensgen_tpu_torch.kernels.attention import build_kernels

        build_kernels(f32=not cfg.get("use_vae_as_encoder", True))


def check_weights_agree(group, pipe) -> None:
    """Raises on every rank unless each built the same To2V DiT."""
    if group is not None and group.size > 1:
        group.check_agree("the To2V DiT's weights", param_fingerprint(pipe.dit))


def main(argv=None):
    ap = argparse.ArgumentParser(description="edit / generation inference (PyTorch/CUDA port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queue-devices", type=int, default=None,
                    help="run the FIFO's rank windows over this many processes, a card each")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config key (dotted path; the value is parsed as yaml)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the host")

    cfg = load_cli_config(args.config, args.set)
    nq = queue_devices(cfg, args.queue_devices)
    if nq > 1:
        prepare_queue_group(cfg, args.smoke, device, nq)
        return mesh.launch(_rank_main, nq, (args, cfg), device=device)
    return run(args, cfg, device)


def _rank_main(group, args, cfg):
    """One rank of ``main``'s queue group: rank 0 returns the run dir."""
    return run(args, cfg, group.device, group)


def run(args, cfg, device, group=None):
    """The CLI's work on ``device``; with a queue ``group``, rank 0 does it
    all but the other ranks' FIFO blocks, and those ranks build the
    pipeline and follow it (None)."""
    if group is not None and not group.leader:
        pipe, _ = build_pipeline(cfg, args.smoke, device)
        check_weights_agree(group, pipe)
        while pipe.follow(group):
            pass
        return None
    try:
        return _lead(args, cfg, device, group)
    finally:
        if group is not None and group.size > 1:
            group.send(None)  # the other ranks' stop


def _lead(args, cfg, device, group):
    items = list(input_items(cfg))
    if not (args.smoke or cfg.get("use_2nd_stage")):
        for item in items:
            if not item.get("video"):
                raise ValueError(f"item {item['name']}: the edit workload needs a `video:` path, "
                                 "or `use_2nd_stage: true` for text-to-long-video generation")
    run_dir = create_output_folders(cfg.get("output_dir", "./outputs"),
                                    cfg.get("name_prefix", "infer"), args.config)
    # every prompt (and the CFG negative "") is encoded before any other
    # model is built, then the encoder (9.5 GB for T5-XXL in bf16) is freed
    prompts = sorted({it.get("prompt", "") for it in items} | {""})
    text_enc = build_text_encoder(cfg, args.smoke, device)
    t0 = time.time()
    embeds = {p: text_enc([p])[0] for p in prompts}
    print(f"encoded {len(prompts)} prompts in {time.time() - t0:.1f}s "
          f"({type(text_enc.inner).__name__})", flush=True)
    del text_enc
    if device.type == "cuda":
        torch.cuda.empty_cache()

    pipe, _ = build_pipeline(cfg, args.smoke, device)
    check_weights_agree(group, pipe)
    t2to_pipe = build_t2to_pipeline(cfg, args.smoke, pipe, device) if cfg.get(
        "use_2nd_stage") else None
    pc = pipe.cfg
    for item in items:
        name = item["name"]
        print(f"--- item {name}", flush=True)
        fps = item.get("output_fps", 10)
        num_chunks = min(item.get("max_num_chunks", 2), item.get("max_num_chunks_w_fifo", 25))
        prompt, negative = embeds[item.get("prompt", "")][None], embeds[""][None]
        frames = image_embeddings = None
        if t2to_pipe is not None and not item.get("video"):
            t2_noise = generator_noise(
                torch.Generator(device=device).manual_seed(int(cfg.get("seed_2nd", 42))))
            toks, image_embeddings = gen_image_embeddings(t2to_pipe, pipe, prompt, negative,
                                                          num_chunks, t2_noise)
            np.save(os.path.join(run_dir, f"{name}_tokens.npy"), toks.float().cpu().numpy())
        if item.get("video"):
            src = load_video(item["video"], sample_fps=item.get("sample_fps", 10),
                             start_t=item.get("start_t", 0.0), end_t=item.get("end_t", -1.0),
                             output_res=(pc.height, pc.width),
                             crop_to_fit=item.get("crop_to_fit", True),
                             pad_to_fit=item.get("pad_to_fit", False),
                             max_frames=num_chunks * pc.num_frames_per_chunk)
            frames = torch.from_numpy(src)
            write_video(os.path.join(run_dir, f"{name}_source.mp4"), src[0], fps=fps)
        if frames is None and image_embeddings is None:  # --smoke only
            rng0 = np.random.default_rng(0)
            frames = torch.from_numpy(rng0.uniform(
                -1, 1, size=(1, num_chunks * pc.num_frames_per_chunk, pc.height, pc.width, 3)
            ).astype(np.float32))
            print(f"item {name}: smoke — synthesized random source video", flush=True)
        noise = generator_noise(torch.Generator(device=device).manual_seed(int(cfg.get("seed", 42))))
        out = pipe.generate(prompt, negative, frames=frames, image_embeddings=image_embeddings,
                            num_chunks=num_chunks, noise_fn=noise,
                            cache_idx=tuple(cfg.get("cache_idx") or ()), group=group)
        video = out["video"][0].float().cpu().numpy()
        write_video(os.path.join(run_dir, f"{name}_fifo.mp4"), video, fps=fps)
        write_video(os.path.join(run_dir, f"{name}_orig.mp4"),
                    out["orig_video"][0].float().cpu().numpy(), fps=fps)
        np.save(os.path.join(run_dir, f"{name}_latents.npy"), out["latents"].float().cpu().numpy())
        for ci, cv in enumerate(out.get("cache_videos") or []):
            write_video(os.path.join(run_dir, f"{name}_cache{ci}.mp4"),
                        cv[0].float().cpu().numpy(), fps=fps)
        print(f"item {name}: wrote {video.shape[0]} frames", flush=True)
    print(f"done -> {run_dir}", flush=True)
    return run_dir


if __name__ == "__main__":
    main()
