"""Inference CLI of the port, the edit workload:

    python -m tokensgen_tpu_torch.infer --config tokensgen_tpu/configs/infer_edit.yaml [--smoke]

Reads the same config keys as the JAX package's `infer.py`, builds the To2V
pipeline on ``--device`` (random weights made there from the config's seed:
no checkpoint loading is ported yet), encodes the prompts with the hash text
encoder (T5 is not ported yet), and writes ``{name}_latents.npy`` per item
into a timestamped run dir. ``--smoke`` runs the tiny geometry of the JAX
package's smoke (and synthesizes the source video); without it the full
CogVideoX-5b width runs. ``quant`` must be unset: the int8 modes are not
ported yet (override it with ``--set quant=null``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig, VIPConfig, graft_vip_params
from tokensgen_tpu_torch.models.resampler import Resampler, ResamplerConfig
from tokensgen_tpu_torch.models.text_encoder import CachedTextEncoder, HashTextEncoder
from tokensgen_tpu_torch.models.vae3d import AutoencoderKLCogVideoX, VAEConfig, VAERunner
from tokensgen_tpu_torch.pipelines.to2v import To2VConfig, To2VPipeline
from tokensgen_tpu_torch.sampling.base import generator_noise
from tokensgen_tpu_torch.utils.params import build_on_device


def build_text_encoder(cfg, smoke: bool):
    """The hash text encoder, under --smoke or `allow_hash_text_encoder: true`."""
    if not (smoke or cfg.get("allow_hash_text_encoder", False)):
        raise NotImplementedError(
            "the T5 text encoder is not ported yet: set `allow_hash_text_encoder: true` "
            "(or --smoke) to run with deterministic hash pseudo-embeddings")
    probe = DiTConfig.tiny() if smoke else DiTConfig.cogvideox_5b()
    return CachedTextEncoder(HashTextEncoder(probe.max_text_seq_length, probe.text_embed_dim))


def _configs(cfg, smoke: bool, device: torch.device):
    vp = cfg.get("video_ipadapter_params", {})
    rp = vp.get("resampler_params", {})
    if vp.get("func_type", "1") != "1":
        raise NotImplementedError(f"VIP func_type {vp.get('func_type')!r} is not ported yet")
    if cfg.get("quant") or cfg.get("quant_attn"):
        raise NotImplementedError("the int8 serving modes are not ported yet: set `quant: null`")
    if not cfg.get("use_vae_as_encoder", True):
        raise NotImplementedError("the DINOv2 conditioning path is not ported yet")
    vip_scale = (vp.get("scale") or [1.0])[0]
    renoise = cfg.get_path("sampling_params.tail_renoise_mode", "xt")
    if smoke:
        # the JAX package's smoke geometry; on a card, heads of 64 in bf16,
        # which is what the attention kernels take
        card = dict(dtype=torch.bfloat16) if device.type == "cuda" else {}
        vc = VIPConfig(output_dim=24, num_temporal_queries=2, num_height_queries=2,
                       num_width_queries=3, length=3 * 2 * 3)
        dcfg = DiTConfig.tiny(vip=vc, sample_height=4, sample_width=6,
                              **(dict(card, attention_head_dim=64) if card else {}))
        rcfg = ResamplerConfig.tiny(embedding_dim=dcfg.inner_dim, output_dim=24,
                                    num_temporal_queries=2, num_height_queries=2,
                                    num_width_queries=3,
                                    **(dict(card, dim_head=64) if card else {}))
        vcfg = VAEConfig.tiny(sample_height=32, sample_width=48)
        pcfg = To2VConfig(height=32, width=48, num_frames_per_chunk=9, num_inference_steps=6,
                          num_partitions=2, vip_scale=vip_scale,
                          use_dynamic_cfg=cfg.get("use_dynamic_cfg", False),
                          tail_renoise_mode=renoise)
        return dcfg, rcfg, vcfg, pcfg
    vc = VIPConfig(length=vp.get("length", 480), scale=vip_scale,
                   output_dim=rp.get("output_dim", 3072),
                   num_temporal_queries=rp.get("num_temporal_queries", 4),
                   num_height_queries=rp.get("num_height_queries", 8),
                   num_width_queries=rp.get("num_width_queries", 12))
    dcfg = DiTConfig.cogvideox_5b(vip=vc)
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
        tail_renoise_mode=renoise)
    return dcfg, rcfg, vcfg, pcfg


def build_pipeline(cfg, smoke: bool, device):
    """-> (To2VPipeline, DiTConfig) with random weights made on ``device``
    from the config's ``seed`` (VIP branch grafted from the base attention)."""
    device = torch.device(device)
    ckpt = cfg.get("pretrained_model_name_or_path")
    if cfg.get("converted_weights_dir") or (ckpt and os.path.isdir(ckpt)):
        raise NotImplementedError("loading checkpoints is not ported yet")
    dcfg, rcfg, vcfg, pcfg = _configs(cfg, smoke, device)
    gen = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 42)))
    vae_model = build_on_device(lambda: AutoencoderKLCogVideoX(vcfg), device, gen)
    vae = VAERunner(vcfg, vae_model, use_tiling=not smoke)
    resampler = build_on_device(lambda: Resampler(rcfg), device, gen)
    dit = graft_vip_params(build_on_device(lambda: CogVideoXTransformer(dcfg), device, gen))
    print("weights: vae=random resampler=random to2v_dit=random(grafted vip)", flush=True)
    if not smoke:
        print("WARNING: non-smoke run with RANDOM weights: outputs are not real videos",
              flush=True)
    sched = S.make_schedule(S.ScheduleConfig(), device=device)
    return To2VPipeline(pcfg, dcfg, dit, rcfg, resampler, vae, sched, device=device), dcfg


def main(argv=None):
    from tokensgen_tpu_torch.utils.config import create_output_folders, input_items, load_config

    ap = argparse.ArgumentParser(description="To2V edit inference (PyTorch/CUDA port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config key (dotted path; the value is parsed as yaml)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the host")

    import yaml

    overrides = {}
    for kv in args.set:
        key, _, val = kv.partition("=")
        overrides[key] = yaml.safe_load(val)
    cfg = load_config(args.config, overrides)
    run_dir = create_output_folders(cfg.get("output_dir", "./outputs"),
                                    cfg.get("name_prefix", "infer"), args.config)
    items = list(input_items(cfg))
    prompts = sorted({it.get("prompt", "") for it in items} | {""})
    text_enc = build_text_encoder(cfg, args.smoke)
    t0 = time.time()
    embeds = {p: text_enc([p])[0] for p in prompts}
    print(f"encoded {len(prompts)} prompts in {time.time() - t0:.1f}s", flush=True)

    pipe, _ = build_pipeline(cfg, args.smoke, device)
    for item in items:
        name = item["name"]
        print(f"--- item {name}", flush=True)
        num_chunks = min(item.get("max_num_chunks", 2), item.get("max_num_chunks_w_fifo", 25))
        if item.get("video"):
            raise NotImplementedError("loading a source video is not ported yet")
        if not args.smoke:
            raise ValueError(f"item {name}: the edit workload needs a `video:` path")
        rng0 = np.random.default_rng(0)
        frames = torch.from_numpy(rng0.uniform(
            -1, 1, size=(1, num_chunks * pipe.cfg.num_frames_per_chunk, pipe.cfg.height,
                         pipe.cfg.width, 3)).astype(np.float32))
        print(f"item {name}: smoke — synthesized random source video", flush=True)
        noise = generator_noise(torch.Generator(device=device).manual_seed(int(cfg.get("seed", 42))))
        out = pipe.generate(embeds[item.get("prompt", "")][None], embeds[""][None], frames=frames,
                            num_chunks=num_chunks, noise_fn=noise)
        np.save(os.path.join(run_dir, f"{name}_latents.npy"), out["latents"].cpu().numpy())
        print(f"item {name}: wrote {out['video'].shape[1]} frames of latents/video", flush=True)
    print(f"done -> {run_dir}", flush=True)


if __name__ == "__main__":
    main()
