"""To2V adapter training CLI of the port (counterpart of the JAX package's
root `train_to2v.py`):

    python -m tokensgen_tpu_torch.train_to2v --config tokensgen_tpu/configs/train_to2v.yaml \
        [--smoke] [--device cpu] [--max-steps N] [--resume] [--set KEY=VALUE]

Reads the JAX package's YAML as data. Trains the DiT's ``vip_*`` parameters
and the resampler on ``--device`` (the card by default; it refuses to run
without one unless given ``--device cpu``). No checkpoint, MiraData CSV or T5
weights are in the repository, so the weights are random (from ``seed``),
the batches synthetic pixel videos from a seeded generator (what the JAX CLI
does without ``csv_file``) and the prompts go through the hash text encoder.
``--smoke`` runs the JAX smoke's tiny geometry; without it, CogVideoX-5b at
the config's width with per-block gradient checkpointing. Each step prints
its loss, each sample's term of it, grad norm, sampled timesteps and their
mean loss weight
1/(1-ᾱ_t), and seconds split into staging, train step (forward and
backward) and optimizer; a checkpoint of the trainable parameters and the
optimizer state is written every ``checkpointing_steps`` and at the last
step. Not ported yet: LoRA, validation renders, MiraData loading, multi-GPU
data / tensor / sequence parallelism and ZeRO-1, ``--profile-steps``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.models.dit import DiTConfig, VIPConfig
from tokensgen_tpu_torch.models.resampler import ResamplerConfig
from tokensgen_tpu_torch.models.text_encoder import CachedTextEncoder, HashTextEncoder
from tokensgen_tpu_torch.models.vae3d import AutoencoderKLCogVideoX, VAEConfig, VAERunner
from tokensgen_tpu_torch.train import checkpoint as CK
from tokensgen_tpu_torch.train import objective, staging, to2v
from tokensgen_tpu_torch.utils.config import create_output_folders, load_config
from tokensgen_tpu_torch.utils.logging import ParamAudit, StepTimer, TBLogger, format_floats
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
        raise NotImplementedError(f"VIP func_type {vp.get('func_type')!r} is not ported yet")
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
    for key in ("lora_rank", "tp_devices", "sp_devices", "zero1"):
        if cfg.get(key):
            raise NotImplementedError(f"`{key}` is not ported yet")
    if cfg.get_path("train_data_params.csv_file"):
        raise NotImplementedError("MiraData loading is not ported yet: set "
                                  "train_data_params.csv_file to null for synthetic batches")
    if cfg.get("validation_steps") or cfg.get_path("val_data_params.csv_file"):
        raise NotImplementedError("validation renders are not ported yet")
    tcfg = to2v.To2VTrainConfig(
        learning_rate=cfg.get("learning_rate", 2e-4),
        diff_timesteps_ratio=cfg.get("diff_timesteps_ratio", 0.4),
        use_8bit_adam=cfg.get("use_8bit_adam", True), optimizer=cfg.get("optimizer", "adamw"),
        lr_scheduler=cfg.get("lr_scheduler", "constant"),
        lr_warmup_steps=cfg.get("lr_warmup_steps", 0), lr_num_cycles=cfg.get("lr_num_cycles", 1),
        lr_power=cfg.get("lr_power", 1.0), max_train_steps=cfg.get("max_train_steps", 1000))
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


class To2VTrainer:
    """The trainer of the CLI: ``__init__`` builds the models, optimizer and
    data from the config (and restores the latest checkpoint with
    ``resume``); `run` trains."""

    def __init__(self, cfg, smoke: bool, device, resume: bool = False):
        self.cfg = cfg
        self.device = device = torch.device(device)
        self.dcfg, self.rcfg, vcfg, height, width, self.nf_px = model_configs(cfg, smoke, device)
        self.tcfg = train_config(cfg)
        self.batch_size = int(cfg.get("per_gpu_batch_size", 1))
        num_chunks = int(cfg.get_path("train_data_params.max_num_chunks", 2))
        seed = int(cfg.get("seed", 42))
        self.ckpt_root = os.path.join(cfg.get("output_dir", "./outputs"), "checkpoints")
        self.run_dir = run_dir = create_output_folders(cfg.get("output_dir", "./outputs"),
                                                       cfg.get("name_prefix", "to2v"))
        log(f"run dir: {run_dir}")

        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.vae = VAERunner(vcfg, build_on_device(lambda: AutoencoderKLCogVideoX(vcfg), device,
                                                   self.gen))
        self.model = to2v.init_model(self.dcfg, self.rcfg, device, self.gen)
        to2v.setup_trainable(self.model, frozen_dtype=self.dcfg.dtype)
        self.param_counts = ParamAudit(run_dir).write(self.model,
                                                      to2v.trainable_labels(self.model))
        log(f"weights: random from seed {seed} (vae, resampler, DiT with grafted vip); "
            f"trainable {self.param_counts['trainable']:,} of "
            f"{self.param_counts['total']:,} parameters")
        self.step_fn = to2v.To2VTrainStep(
            self.model, S.make_schedule(S.ScheduleConfig(), device=device), self.tcfg,
            accum_steps=int(cfg.get("gradient_accumulation_steps", 1)))
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
        self.text_encoder = CachedTextEncoder(HashTextEncoder(self.dcfg.max_text_seq_length,
                                                              self.dcfg.text_embed_dim))
        self.batches = synthetic_batches(self.batch_size, num_chunks, self.nf_px, height, width)
        self.host_rng = np.random.default_rng(seed)
        self.zero_cache: Dict = {}

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

    def run(self, max_steps: Optional[int] = None, save_final: bool = True) -> List[Dict]:
        """Train micro-steps up to ``max_steps`` (default: the config's
        ``max_train_steps``); checkpoint every ``checkpointing_steps`` and,
        with ``save_final``, at the last step. Returns a record per step."""
        cfg, dev, gen, tcfg = self.cfg, self.device, self.gen, self.tcfg
        max_steps = max_steps or cfg.get("max_train_steps", 100)
        ckpt_every = cfg.get("checkpointing_steps", 500)
        nf = (self.nf_px - 1) // 4 + 1
        tb = TBLogger(self.run_dir)
        timer = StepTimer()
        records = []
        while self.step < max_steps:
            batch = next(self.batches)
            t0 = time.perf_counter()
            if dev.type == "cuda":
                # the train step leaves its freed blocks cached in sizes the
                # VAE encode cannot use (at batch 2 on an H100: 29.5 GiB
                # reserved but unallocated when step 2's encode ran out)
                torch.cuda.empty_cache()
            staged = staging.stage_to2v_batch(
                self.dcfg, self.model.dit.patch_embed.proj, self.rcfg, self.vae,
                torch.from_numpy(batch["pixel_values"]), batch["start_frame_idx"],
                batch["drop_image_embed"], self.text_encoder(batch["prompt"]),
                lambda tag, shape: torch.randn(shape, generator=gen, device=dev),
                nf_px=self.nf_px, host_rng=self.host_rng, zero_cache=self.zero_cache)
            timesteps = objective.sample_timesteps(
                gen, self.batch_size, nf, tcfg.diff_timesteps_ratio,
                inference_timesteps=tcfg.inference_timesteps, device=dev)
            noise = torch.randn(staged["latents"].shape, generator=gen, device=dev)
            self._sync()
            staging_s = time.perf_counter() - t0
            m = self.step_fn(staged, timesteps, noise)
            self.step += 1
            rec = {"step": self.step, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "updated": m["updated"], "staging_s": staging_s,
                   "train_step_s": m["train_step_s"], "optimizer_s": m["optimizer_s"],
                   "sample_losses": m["sample_losses"].tolist(),
                   "timesteps": m["timesteps"].tolist(), "x0_weight": float(m["x0_weight"]),
                   "dropped": int(batch["drop_image_embed"].sum())}
            records.append(rec)
            tb.scalar("train_loss", rec["loss"], self.step)
            total = staging_s + m["train_step_s"] + m["optimizer_s"]
            log(f"step {self.step}: loss {rec['loss']:.4f} (per sample "
                f"{format_floats(rec['sample_losses'])}) grad_norm {rec['grad_norm']:.4f} "
                f"timesteps {format_timesteps(rec['timesteps'])} mean x0 weight "
                f"{rec['x0_weight']:.4g}; {total:.2f} s/step (staging {staging_s:.2f} + train "
                f"step {m['train_step_s']:.2f} + optimizer {m['optimizer_s']:.2f}; "
                f"EMA {timer.update(total):.2f})")
            del staged, timesteps, noise, m  # freed before the next step's staging
            if self.step % ckpt_every == 0 or (save_final and self.step == max_steps):
                log(f"checkpoint saved at step {self.step}: {self.save()}")
        tb.close()
        return records


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
    ap.add_argument("--smoke", action="store_true", help="tiny models, CPU-friendly")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
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
    To2VTrainer(cfg, args.smoke, device, resume=args.resume).run(args.max_steps)
    print("training done", flush=True)


if __name__ == "__main__":
    main()
