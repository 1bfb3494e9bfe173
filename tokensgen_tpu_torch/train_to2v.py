"""To2V adapter training CLI of the port (counterpart of the JAX package's
root `train_to2v.py`):

    python -m tokensgen_tpu_torch.train_to2v --config tokensgen_tpu/configs/train_to2v.yaml \
        [--smoke] [--device cpu] [--max-steps N] [--resume] [--profile-steps N] \
        [--set KEY=VALUE]

Reads the JAX package's YAML as data. Trains the DiT's ``vip_*`` parameters,
the resampler and, with ``lora_rank`` > 0, LoRA factors on the DiT's
attention projections, on ``--device`` (the card by default; it refuses to
run without one unless given ``--device cpu``). No checkpoint is in the
repository, so the weights are random (from ``seed``). With
``train_data_params.csv_file`` (and not ``--smoke``) the batches come from
the MiraData layout through `MiraDataset` (scene detect with
``use_scene_detect`` / ``scene_detect_file``) on ``dataloader_num_workers``
decode threads (default 4); otherwise they are synthetic pixel videos from a
seeded generator, as in the JAX CLI. Prompts go through T5 when
``pretrained_text_encoder_path`` is set (a missing one raises unless
``--smoke``), else the hash text encoder. ``--smoke`` runs the JAX smoke's
tiny geometry; without it, CogVideoX-5b at the config's width with per-block
gradient checkpointing. Each step prints its loss, each sample's term of
it, grad norm, sampled timesteps and their mean loss weight 1/(1-ᾱ_t), and
seconds split into data wait, staging, train step (forward and backward)
and optimizer; a checkpoint of the trainable parameters and the optimizer
state is written every ``checkpointing_steps`` and at the last step. Every
``validation_steps`` a validation render (the `val_data_params` items, or
the step's batch) goes through `To2VPipeline` with the current adapters, to
``val_step{N}.mp4``, and its quality metrics to the ``val/*`` scalars.
``--profile-steps N`` traces the first N steps with `torch.profiler` into
``<run_dir>/profile``. With LoRA, the merged weights are exported to
``<run_dir>/lora_merged`` at the end. Not ported yet: multi-GPU data /
tensor / sequence parallelism and ZeRO-1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.data.mira import MiraDataset, collate, epoch_batches
from tokensgen_tpu_torch.models.dit import DiTConfig, VIPConfig
from tokensgen_tpu_torch.models.resampler import ResamplerConfig
from tokensgen_tpu_torch.models.text_encoder import make_text_encoder
from tokensgen_tpu_torch.models.vae3d import AutoencoderKLCogVideoX, VAEConfig, VAERunner
from tokensgen_tpu_torch.train import checkpoint as CK
from tokensgen_tpu_torch.train import lora, objective, staging, to2v
from tokensgen_tpu_torch.utils.config import create_output_folders, load_config
from tokensgen_tpu_torch.utils.logging import (ParamAudit, StepTimer, TBLogger, format_floats,
                                               profile_trace)
from tokensgen_tpu_torch.utils.params import build_on_device


def model_configs(cfg, smoke: bool, device: torch.device):
    """(DiTConfig, ResamplerConfig, VAEConfig, height, width, frames per chunk)."""
    if smoke or cfg.get("model_size") == "tiny":
        # the JAX smoke geometry; on a card in bf16, which is what the
        # attention kernels take: the DiT's 2 heads of 16 run K6 / K5, the
        # resampler's 2 heads of 16 K4 / K5
        card = dict(dtype=torch.bfloat16) if device.type == "cuda" else {}
        vc = VIPConfig(output_dim=24, num_temporal_queries=2, num_height_queries=2,
                       num_width_queries=3, length=3 * 2 * 3)
        dcfg = DiTConfig.tiny(vip=vc, sample_height=4, sample_width=6, **card)
        rcfg = ResamplerConfig.tiny(embedding_dim=dcfg.inner_dim, output_dim=24,
                                    num_temporal_queries=2, num_height_queries=2,
                                    num_width_queries=3, **card)
        return dcfg, rcfg, VAEConfig.tiny(sample_height=32, sample_width=48), 32, 48, 9
    vp = cfg.get("video_ipadapter_params", {})
    rp = vp.get("resampler_params", {})
    if vp.get("func_type", "1") != "1":
        raise NotImplementedError(
            f"VIP func_type {vp.get('func_type')!r}: this CLI builds func_type \"1\", as the JAX "
            "trainer does whatever the config says (ROADMAP, deliberate differences); build "
            "another variant through models.dit.VIPConfig")
    vc = VIPConfig(length=vp.get("length", 480), scale=(vp.get("scale") or [1.0])[0],
                   output_dim=rp.get("output_dim", 3072),
                   num_temporal_queries=rp.get("num_temporal_queries", 4),
                   num_height_queries=rp.get("num_height_queries", 8),
                   num_width_queries=rp.get("num_width_queries", 12))
    dcfg = DiTConfig.cogvideox_5b(vip=vc, remat=True)
    rcfg = ResamplerConfig(**{k: v for k, v in rp.items()
                              if k in ResamplerConfig.__dataclass_fields__})
    return (dcfg, rcfg, VAEConfig.cogvideox(), cfg.get_path("train_data_params.height", 480),
            cfg.get_path("train_data_params.width", 720),
            cfg.get_path("train_data_params.chunk_size", 49))


def train_config(cfg) -> to2v.To2VTrainConfig:
    for key in ("tp_devices", "sp_devices", "zero1"):
        if cfg.get(key):
            raise NotImplementedError(f"`{key}` is not ported yet")
    tcfg = to2v.To2VTrainConfig(
        learning_rate=cfg.get("learning_rate", 2e-4),
        diff_timesteps_ratio=cfg.get("diff_timesteps_ratio", 0.4),
        use_8bit_adam=cfg.get("use_8bit_adam", True), optimizer=cfg.get("optimizer", "adamw"),
        lr_scheduler=cfg.get("lr_scheduler", "constant"),
        lr_warmup_steps=cfg.get("lr_warmup_steps", 0), lr_num_cycles=cfg.get("lr_num_cycles", 1),
        lr_power=cfg.get("lr_power", 1.0), max_train_steps=cfg.get("max_train_steps", 1000),
        lora_rank=int(cfg.get("lora_rank") or 0), lora_alpha=float(cfg.get("lora_alpha", 64.0)),
        lora_targets=tuple(cfg.get("lora_targets", ["to_q", "to_k", "to_v", "to_out"])))
    if cfg.get("scale_lr"):  # `--scale_lr`: lr *= accumulation * per-device batch (one rank)
        scale = cfg.get("gradient_accumulation_steps", 1) * cfg.get("per_gpu_batch_size", 1)
        tcfg = dataclasses.replace(tcfg, learning_rate=tcfg.learning_rate * scale)
    return tcfg


def synthetic_batches(batch: int, num_chunks: int, nf_px: int, height: int, width: int,
                      seed: int = 0):
    """Random pixel videos in [-1, 1] with random start frames and a 5% CFG
    drop of the VIP embedding (the JAX CLI's `synthetic_batches`)."""
    host = np.random.default_rng(seed)
    while True:
        yield {
            "pixel_values": host.uniform(-1, 1, size=(batch, num_chunks * nf_px, height, width, 3)
                                         ).astype(np.float32),
            "start_frame_idx": host.integers(0, 50, size=(batch,)),
            "drop_image_embed": (host.uniform(size=(batch,)) < 0.05).astype(np.int32),
            "prompt": ["synthetic"] * batch,
        }


def mira_dataset(cfg, key: str, height: int, width: int, nf_px: int, max_chunks: int,
                 **kwargs) -> MiraDataset:
    """`MiraDataset` over the CSV and videos of ``cfg[key]``
    (``train_data_params`` or ``val_data_params``)."""
    return MiraDataset(cfg.get_path(f"{key}.csv_file"), cfg.get_path(f"{key}.video_dir"),
                       height=height, width=width,
                       sample_fps=cfg.get_path(f"{key}.sample_fps", 10), chunk_size=nf_px,
                       max_num_chunks=max_chunks, **kwargs)


class To2VTrainer:
    """The trainer of the CLI: ``__init__`` builds the models, optimizer and
    data from the config (and restores the latest checkpoint with
    ``resume``); `run` trains."""

    def __init__(self, cfg, smoke: bool, device, resume: bool = False):
        self.cfg, self.smoke = cfg, smoke
        self.device = device = torch.device(device)
        self.dcfg, self.rcfg, vcfg, height, width, self.nf_px = model_configs(cfg, smoke, device)
        self.tcfg = tcfg = train_config(cfg)
        self.batch_size = int(cfg.get("per_gpu_batch_size", 1))
        num_chunks = int(cfg.get_path("train_data_params.max_num_chunks", 2))
        self.seed = seed = int(cfg.get("seed", 42))
        self.ckpt_root = os.path.join(cfg.get("output_dir", "./outputs"), "checkpoints")
        self.run_dir = run_dir = create_output_folders(cfg.get("output_dir", "./outputs"),
                                                       cfg.get("name_prefix", "to2v"))
        log(f"run dir: {run_dir}")
        # first: a configured T5 path that does not load fails before any model is built
        self.text_encoder = make_text_encoder(
            cfg.get("pretrained_text_encoder_path"), self.dcfg.max_text_seq_length,
            self.dcfg.text_embed_dim, allow_hash_fallback=smoke, device=device)

        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.vae = VAERunner(vcfg, build_on_device(lambda: AutoencoderKLCogVideoX(vcfg), device,
                                                   self.gen))
        self.model = to2v.init_model(self.dcfg, self.rcfg, device, self.gen, tcfg)
        to2v.setup_trainable(self.model, frozen_dtype=self.dcfg.dtype)
        self.param_counts = ParamAudit(run_dir).write(self.model,
                                                      to2v.trainable_labels(self.model))
        log(f"weights: random from seed {seed} (vae, resampler, DiT with grafted vip); "
            f"trainable {self.param_counts['trainable']:,} of "
            f"{self.param_counts['total']:,} parameters")
        if tcfg.lora_rank > 0:
            log(f"lora: rank={tcfg.lora_rank} alpha={tcfg.lora_alpha} "
                f"targets={list(tcfg.lora_targets)} "
                f"({lora.lora_param_count(lora.lora_factors(self.model.dit)) / 1e6:.2f}M params)")
        self.sched = S.make_schedule(S.ScheduleConfig(), device=device)
        self.step_fn = to2v.To2VTrainStep(
            self.model, self.sched, tcfg, accum_steps=int(cfg.get("gradient_accumulation_steps", 1)))
        self.step = 0
        if resume:
            state, found = CK.restore_checkpoint(self.ckpt_root, map_location=device)
            if state is not None:
                with torch.no_grad():
                    for name, p in self.step_fn.params.items():
                        p.copy_(state["params"][name])
                self.step_fn.optimizer.load_state_dict(state["opt_state"])
                self.step = found
                log(f"resumed from step {found}")
        if smoke or not cfg.get_path("train_data_params.csv_file"):
            self.batches = synthetic_batches(self.batch_size, num_chunks, self.nf_px, height,
                                             width)
        else:
            ds = mira_dataset(
                cfg, "train_data_params", height, width, self.nf_px, num_chunks,
                use_scene_detect=bool(cfg.get_path("train_data_params.use_scene_detect", False)),
                scene_detect_file=cfg.get_path("train_data_params.scene_detect_file"), seed=seed)
            log(f"data: {len(ds)} videos from {cfg.get_path('train_data_params.csv_file')}")
            self.batches = epoch_batches(ds, self.batch_size, seed,
                                         num_workers=int(cfg.get("dataloader_num_workers", 4)))
        # validation items: a held-out CSV at fixed indices
        self.val_batch = None
        if cfg.get_path("val_data_params.csv_file"):
            val_ds = mira_dataset(cfg, "val_data_params", height, width, self.nf_px,
                                  cfg.get_path("val_data_params.max_num_chunks", 2),
                                  random_sample=False, i_drop_rate=0, t_drop_rate=0,
                                  ti_drop_rate=0)
            self.val_batch = collate([val_ds[i]
                                      for i in cfg.get_path("val_data_params.indices", [0])])
        self.host_rng = np.random.default_rng(seed)
        self.zero_cache: Dict = {}
        self.tb = TBLogger(run_dir)
        self.val_metrics: Optional[Dict] = None  # the last validation render's

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save(self) -> str:
        fn = self.step_fn
        return CK.save_checkpoint(
            self.ckpt_root, self.step,
            {"params": {n: p.detach() for n, p in fn.params.items()},
             "opt_state": fn.optimizer.state_dict(), "step": self.step},
            total_limit=self.cfg.get("checkpoints_total_limit", 3))

    def render_validation(self, step: int, batch: Dict, noise_fn=None) -> Dict:
        """The validation render (the JAX CLI's ``run_validation``): the
        first video of ``batch`` through `To2VPipeline` with the current
        DiT (its LoRA factors applied) and resampler, deterministic
        sampling, noise from a generator seeded by ``step`` unless
        ``noise_fn``; writes ``val_step{step}.mp4`` and logs the quality
        metrics against the source frames as ``val/*``. Returns the metrics
        (and the video, ``[F, H, W, 3]`` in [-1, 1], under ``video``)."""
        from tokensgen_tpu_torch.data.video_io import write_video
        from tokensgen_tpu_torch.metrics.quality import evaluate_video
        from tokensgen_tpu_torch.pipelines.to2v import To2VConfig, To2VPipeline
        from tokensgen_tpu_torch.sampling.base import generator_noise

        cfg, nf_px = self.cfg, self.nf_px
        frames = torch.from_numpy(np.asarray(batch["pixel_values"][:1]))
        pcfg = To2VConfig(
            height=frames.shape[2], width=frames.shape[3], num_frames_per_chunk=nf_px,
            num_inference_steps=min(cfg.get("num_inference_steps", 52), 4 if self.smoke else 52),
            num_partitions=2 if self.smoke else 4, stochastic=False)
        model = self.model
        pipe = To2VPipeline(pcfg, self.dcfg, model.dit, self.rcfg, model.resampler, self.vae,
                            self.sched, device=self.device)
        if noise_fn is None:
            noise_fn = generator_noise(torch.Generator(device=self.device).manual_seed(step))
        text = self.text_encoder(list(batch["prompt"][:1]))
        was_training = model.training
        model.eval()
        try:
            out = pipe.generate(text, torch.zeros_like(text), frames=frames,
                                num_chunks=frames.shape[1] // nf_px, noise_fn=noise_fn)
        finally:
            model.train(was_training)
        vid = out["video"][0].float().cpu().numpy()
        write_video(os.path.join(self.run_dir, f"val_step{step}.mp4"), vid, fps=10)
        src = (frames[0, : vid.shape[0]].numpy() + 1) / 2
        lpips_params = None
        if cfg.get("lpips_vgg_path") and cfg.get("lpips_lins_path"):
            from tokensgen_tpu_torch.metrics.lpips import load_lpips_params

            lpips_params = load_lpips_params(cfg.get("lpips_vgg_path"),
                                             cfg.get("lpips_lins_path"), device=self.device)
        m = evaluate_video((vid + 1) / 2, src, lpips_params=lpips_params)
        for k, v in m.items():
            self.tb.scalar(f"val/{k}", v, step)
        log(f"validation step {step}: {m}")
        return dict(m, video=vid)

    def run(self, max_steps: Optional[int] = None, save_final: bool = True,
            profile_steps: int = 0) -> List[Dict]:
        """Train micro-steps up to ``max_steps`` (default: the config's
        ``max_train_steps``); checkpoint every ``checkpointing_steps`` and,
        with ``save_final``, at the last step; render a validation every
        ``validation_steps``; trace the first ``profile_steps`` steps into
        ``<run_dir>/profile``. Returns a record per step."""
        cfg, dev, gen, tcfg = self.cfg, self.device, self.gen, self.tcfg
        max_steps = max_steps or cfg.get("max_train_steps", 100)
        ckpt_every = cfg.get("checkpointing_steps", 500)
        val_every = cfg.get("validation_steps") or 0
        nf = (self.nf_px - 1) // 4 + 1
        timer = StepTimer()
        records = []
        trace = contextlib.ExitStack()
        if profile_steps > 0:
            trace.enter_context(profile_trace(os.path.join(self.run_dir, "profile")))
        traced = 0
        with trace:
            while self.step < max_steps:
                t0 = time.perf_counter()
                batch = next(self.batches)
                t1 = time.perf_counter()
                if dev.type == "cuda":
                    # the train step leaves its freed blocks cached in sizes the
                    # VAE encode cannot use (at batch 2 on an H100: 29.5 GiB
                    # reserved but unallocated when step 2's encode ran out)
                    torch.cuda.empty_cache()
                staged = staging.stage_to2v_batch(
                    self.dcfg, self.model.dit.patch_embed.proj, self.rcfg, self.vae,
                    torch.from_numpy(batch["pixel_values"]), batch["start_frame_idx"],
                    batch["drop_image_embed"], self.text_encoder(list(batch["prompt"])),
                    lambda tag, shape: torch.randn(shape, generator=gen, device=dev),
                    nf_px=self.nf_px, host_rng=self.host_rng, zero_cache=self.zero_cache)
                timesteps = objective.sample_timesteps(
                    gen, self.batch_size, nf, tcfg.diff_timesteps_ratio,
                    inference_timesteps=tcfg.inference_timesteps, device=dev)
                noise = torch.randn(staged["latents"].shape, generator=gen, device=dev)
                self._sync()
                data_s, staging_s = t1 - t0, time.perf_counter() - t1
                m = self.step_fn(staged, timesteps, noise)
                self.step += 1
                rec = {"step": self.step, "loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]), "updated": m["updated"],
                       "data_s": data_s, "staging_s": staging_s,
                       "train_step_s": m["train_step_s"], "optimizer_s": m["optimizer_s"],
                       "sample_losses": m["sample_losses"].tolist(),
                       "timesteps": m["timesteps"].tolist(), "x0_weight": float(m["x0_weight"]),
                       "dropped": int(np.sum(batch["drop_image_embed"]))}
                records.append(rec)
                self.tb.scalar("train_loss", rec["loss"], self.step)
                total = data_s + staging_s + m["train_step_s"] + m["optimizer_s"]
                log(f"step {self.step}: loss {rec['loss']:.4f} (per sample "
                    f"{format_floats(rec['sample_losses'])}) grad_norm {rec['grad_norm']:.4f} "
                    f"timesteps {format_timesteps(rec['timesteps'])} mean x0 weight "
                    f"{rec['x0_weight']:.4g}; {total:.2f} s/step (data {data_s:.2f} + staging "
                    f"{staging_s:.2f} + train step {m['train_step_s']:.2f} + optimizer "
                    f"{m['optimizer_s']:.2f}; EMA {timer.update(total):.2f})")
                del staged, timesteps, noise, m  # freed before the next step's staging
                traced += 1
                if traced == profile_steps:
                    trace.close()
                    log(f"profile trace of {traced} step(s) written to {self.run_dir}/profile")
                if val_every and self.step % val_every == 0:
                    self.val_metrics = self.render_validation(self.step, self.val_batch or batch)
                if self.step % ckpt_every == 0 or (save_final and self.step == max_steps):
                    log(f"checkpoint saved at step {self.step}: {self.save()}")
        return records

    def export_lora_merged(self) -> str:
        """The DiT with its LoRA factors merged (`lora.merge_lora`) and the
        resampler, saved as ``<run_dir>/lora_merged/checkpoint-{step}``."""
        model, tcfg = self.model, self.tcfg
        merged = lora.merge_lora(model.dit.state_dict(), lora.lora_factors(model.dit),
                                 tcfg.lora_rank, tcfg.lora_alpha)
        path = CK.save_checkpoint(
            os.path.join(self.run_dir, "lora_merged"), self.step,
            {"params": {"dit": merged, "resampler": model.resampler.state_dict()}},
            total_limit=1)
        log(f"lora-merged export saved to {path}")
        return path

    def close(self) -> None:
        """Stops the data threads and closes the scalar log."""
        close = getattr(self.batches, "close", None)
        if close is not None:
            close()
        self.tb.close()


def format_timesteps(timesteps: List[List[int]]) -> str:
    """Per-sample timesteps of a [B, F] draw: one value where the sample's
    frames share it, else its FIFO ramp as first..last."""
    return "[" + ", ".join(str(t[0]) if min(t) == max(t) else f"{t[0]}..{t[-1]}"
                           for t in timesteps) + "]"


def log(msg: str) -> None:
    print(msg, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="To2V adapter training (PyTorch/CUDA port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--smoke", action="store_true", help="tiny models + synthetic data, "
                    "CPU-friendly")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="trace the first N steps with torch.profiler into <run_dir>/profile")
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
    trainer = To2VTrainer(cfg, args.smoke, device, resume=args.resume)
    try:
        trainer.run(args.max_steps, profile_steps=args.profile_steps)
        if trainer.tcfg.lora_rank > 0:
            trainer.export_lora_merged()
    finally:
        trainer.close()
    print("training done", flush=True)


if __name__ == "__main__":
    main()
