"""T2To training CLI of the port (counterpart of the JAX package's root
`train_t2to.py`): a full finetune of the patch-size-1 T2To DiT.

    python -m tokensgen_tpu_torch.train_t2to --config tokensgen_tpu/configs/train_t2to.yaml \
        [--smoke] [--device cpu] [--max-steps N] [--resume] [--set KEY=VALUE]

Reads the JAX package's YAML as data and trains every parameter of the DiT on
``--device`` (the card by default; it refuses to run without one unless given
``--device cpu``). ``--smoke`` (or ``model_size: tiny``) runs the JAX smoke's
tiny geometry (one head of 64, 4 chunks of 4 token frames of 8x12);
without it, `DiTConfig.t2to_5b` with per-block gradient checkpointing at the
config's ``per_gpu_batch_size`` and ``max_num_chunks``. No checkpoint or
dataset is in the repository, so the weights are random (from ``seed``),
the batches synthetic PCA-normalised token latents with random valid-chunk
counts (padded chunks masked in attention and loss) and prompts through the
hash text encoder. Outside ``--smoke`` a configured ``longvgen_pca``
(``pca.pt``, a pickled torch PCA module) with ``longvgen_mean`` /
``longvgen_std`` (``.npy``) is loaded, as the JAX CLI loads it; else the PCA
is a random stand-in with zero mean and unit std. Each step prints its loss, grad
norm, each sample's term of the loss, sampled timesteps and their mean loss
weight 1/(1-ᾱ_t), and seconds
split into data upload, train step (forward and backward) and optimizer; a checkpoint of the parameters and the optimizer state is
written every ``checkpointing_steps`` and at the last step. Not ported yet,
each raising: MiraData loading and the token / latent datasets
(``train_data_params.csv_file``), LoRA (``lora_rank``), multi-GPU data /
tensor / sequence parallelism and ZeRO-1.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tokensgen_tpu_torch.convert.torch_weights import load_pca_artifact, load_token_stats
from tokensgen_tpu_torch.core import pca as pca_lib
from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig
from tokensgen_tpu_torch.models.text_encoder import HashTextEncoder
from tokensgen_tpu_torch.train import checkpoint as CK
from tokensgen_tpu_torch.train import objective, t2to
from tokensgen_tpu_torch.utils.config import create_output_folders, load_config
from tokensgen_tpu_torch.utils.logging import ParamAudit, StepTimer, TBLogger, format_floats
from tokensgen_tpu_torch.utils.params import build_on_device

TOKENS_PER_CHUNK = 4  # token frames per chunk


def model_config(cfg, smoke: bool, device: torch.device):
    """(DiTConfig, max chunks, token dim)."""
    if smoke or cfg.get("model_size") == "tiny":
        # the JAX smoke geometry (1 head: odd, so the attention runs K6); on
        # a card in bf16, which is what the attention kernels take
        card = dict(dtype=torch.bfloat16) if device.type == "cuda" else {}
        dcfg = DiTConfig.tiny(patch_size=1, sample_height=8, sample_width=12,
                              attention_head_dim=64, num_attention_heads=1, **card)
        return dcfg, 4, 48
    return (DiTConfig.t2to_5b(remat=True),
            int(cfg.get_path("train_data_params.max_num_chunks", 24)), 3072)


def train_config(cfg) -> t2to.T2ToTrainConfig:
    for key in ("tp_devices", "sp_devices", "dp_devices"):
        if int(cfg.get(key) or 1) > 1:
            raise NotImplementedError(f"`{key}` > 1: multi-GPU training is not ported yet "
                                      "(ROADMAP A12)")
    if cfg.get("zero1"):
        raise NotImplementedError("`zero1` (ZeRO-1 optimizer sharding) is not ported yet "
                                  "(ROADMAP A12)")
    if cfg.get_path("train_data_params.csv_file"):
        kind = ("token dataset (VIPMiraDataset)" if cfg.get_path("train_data_params.token_dir")
                else "latent dataset (VAEMiraDataset, calculate_vae_latents.py)")
        raise NotImplementedError(f"MiraData loading and the {kind} are not ported yet "
                                  "(ROADMAP A13): set train_data_params.csv_file to null for "
                                  "synthetic batches")
    tcfg = t2to.T2ToTrainConfig(
        learning_rate=cfg.get("learning_rate", 3e-4), optimizer=cfg.get("optimizer", "adamw"),
        use_8bit_adam=bool(cfg.get("use_8bit_adam", False)),
        lr_scheduler=cfg.get("lr_scheduler", "constant"),
        lr_warmup_steps=cfg.get("lr_warmup_steps", 0), lr_num_cycles=cfg.get("lr_num_cycles", 1),
        lr_power=cfg.get("lr_power", 1.0), max_train_steps=cfg.get("max_train_steps", 100),
        lora_rank=int(cfg.get("lora_rank") or 0))
    if cfg.get("scale_lr"):  # lr *= accumulation * per-device batch (one rank)
        scale = cfg.get("gradient_accumulation_steps", 1) * cfg.get("per_gpu_batch_size", 1)
        tcfg = dataclasses.replace(tcfg, learning_rate=tcfg.learning_rate * scale)
    return tcfg


def random_pca(host: np.random.Generator, token_dim: int, device, samples: int = 256):
    """(PCAState, mean zeros [1, D], std ones [1, D]): the weights-free
    stand-in the JAX CLI fits when no pca/mean/std artifacts are given, from
    ``samples`` standard normal draws of ``host``."""
    data = torch.from_numpy(host.normal(size=(samples, token_dim)).astype(np.float32))
    zeros = torch.zeros(1, token_dim, device=device)
    return pca_lib.fit(data.to(device), None), zeros, torch.ones_like(zeros)


def synthetic_batches(host: np.random.Generator, batch: int, max_chunks: int, height: int,
                      width: int):
    """PCA-normalised token latents [B, 4*max_chunks, 16, h, w] with
    1..max_chunks valid chunks per sample (the JAX CLI's
    `synthetic_batches`), and one distinct prompt per sample."""
    f = max_chunks * TOKENS_PER_CHUNK
    serial = itertools.count()
    while True:
        valid = host.integers(1, max_chunks + 1, size=(batch,)) * TOKENS_PER_CHUNK
        yield {
            "latents": host.normal(size=(batch, f, 16, height, width)).astype(np.float32),
            "valid_frames": valid,
            "prompt": [f"synthetic {next(serial)}" for _ in range(batch)],
        }


class T2ToTrainer:
    """The trainer of the CLI: ``__init__`` builds the model, optimizer and
    data from the config (and restores the latest checkpoint with
    ``resume``); `run` trains."""

    def __init__(self, cfg, smoke: bool, device, resume: bool = False):
        self.cfg = cfg
        self.device = device = torch.device(device)
        self.dcfg, self.max_chunks, token_dim = model_config(cfg, smoke, device)
        self.tcfg = tcfg = train_config(cfg)
        self.batch_size = int(cfg.get("per_gpu_batch_size", 1))
        seed = int(cfg.get("seed", 42))
        self.ckpt_root = os.path.join(cfg.get("output_dir", "./outputs"), "t2to_checkpoints")
        self.run_dir = create_output_folders(cfg.get("output_dir", "./outputs"),
                                             cfg.get("name_prefix", "t2to"))
        log(f"run dir: {self.run_dir}")

        self.host_rng = np.random.default_rng(seed)
        if not smoke and cfg.get("longvgen_pca"):
            # the trained PCA (a pickled torch module) and the token mean / std
            pca = load_pca_artifact(cfg.longvgen_pca)
            self.pca = pca_lib.PCAState(pca.mean.to(device), pca.components.to(device))
            self.token_mean, self.token_std = load_token_stats(cfg.longvgen_mean,
                                                               cfg.longvgen_std, device)
            log(f"pca: artifacts {cfg.longvgen_pca}, {cfg.longvgen_mean}, {cfg.longvgen_std}")
        else:
            # the stand-in PCA (zero mean, unit std) that the dataset branches
            # would normalise with; synthetic batches are normalised already
            self.pca, self.token_mean, self.token_std = random_pca(self.host_rng, token_dim,
                                                                   device)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.dit = build_on_device(lambda: CogVideoXTransformer(self.dcfg), device, self.gen)
        t2to.setup_full_finetune(self.dit.train())
        if device.type == "cuda":
            torch.cuda.empty_cache()  # the bf16 copies the f32 masters replaced
        self.param_counts = ParamAudit(self.run_dir).write(
            self.dit, {n: "train" for n, _ in self.dit.named_parameters()})
        log(f"weights: random from seed {seed}; full finetune of "
            f"{self.param_counts['trainable']:,} parameters (f32 masters, "
            f"{str(self.dcfg.dtype).split('.')[-1]} compute)")
        self.sched = S.make_schedule(
            S.ScheduleConfig(beta_schedule=cfg.get("beta_schedule", "vip_1")), device=device)
        self.step_fn = t2to.T2ToTrainStep(
            self.dit, self.sched, tcfg, accum_steps=int(cfg.get("gradient_accumulation_steps", 1)))
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
        self.text_encoder = HashTextEncoder(self.dcfg.max_text_seq_length,
                                            self.dcfg.text_embed_dim)
        self.batches = synthetic_batches(self.host_rng, self.batch_size, self.max_chunks,
                                         tcfg.height, tcfg.width)

    def save(self) -> str:
        fn = self.step_fn
        return CK.save_checkpoint(
            self.ckpt_root, self.step,
            {"params": {n: p.detach() for n, p in fn.params.items()},
             "opt_state": fn.optimizer.state_dict(), "step": self.step},
            total_limit=self.cfg.get("checkpoints_total_limit", 3))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, max_steps: Optional[int] = None, save_final: bool = True) -> List[Dict]:
        """Train micro-steps up to ``max_steps`` (default: the config's
        ``max_train_steps``); checkpoint every ``checkpointing_steps`` and,
        with ``save_final``, at the last step. Returns a record per step."""
        cfg, dev, gen = self.cfg, self.device, self.gen
        max_steps = max_steps or cfg.get("max_train_steps", 100)
        ckpt_every = cfg.get("checkpointing_steps", 500)
        tb = TBLogger(self.run_dir)
        timer = StepTimer()
        records = []
        while self.step < max_steps:
            raw = next(self.batches)
            if dev.type == "cuda":
                # as in the To2V trainer: hand the last step's freed blocks back
                # before the next one, so they do not fragment its allocations
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            batch = {"latents": torch.from_numpy(raw["latents"]).to(dev),
                     "text_embeds": self.text_encoder(raw["prompt"]).to(dev),
                     "valid_frames": torch.from_numpy(raw["valid_frames"]).to(dev)}
            timesteps = objective.sample_uniform_timesteps(
                gen, self.batch_size, self.sched.config.num_train_timesteps, device=dev)
            noise = torch.randn(batch["latents"].shape, generator=gen, device=dev)
            self._sync()
            data_s = time.perf_counter() - t0
            m = self.step_fn(batch, timesteps, noise)
            self.step += 1
            rec = {"step": self.step, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "updated": m["updated"], "data_s": data_s, "train_step_s": m["train_step_s"],
                   "optimizer_s": m["optimizer_s"], "sample_losses": m["sample_losses"].tolist(),
                   "timesteps": m["timesteps"].tolist(),
                   "x0_weight": float(m["x0_weight"]),
                   "valid_chunks": (raw["valid_frames"] // TOKENS_PER_CHUNK).tolist()}
            records.append(rec)
            tb.scalar("train_loss", rec["loss"], self.step)
            total = data_s + m["train_step_s"] + m["optimizer_s"]
            log(f"step {self.step}: loss {rec['loss']:.4f} (per sample "
                f"{format_floats(rec['sample_losses'])}) grad_norm {rec['grad_norm']:.4f} "
                f"timesteps {rec['timesteps']} mean x0 weight {rec['x0_weight']:.4g}; "
                f"{total:.2f} s/step (data {data_s:.2f} + train step {m['train_step_s']:.2f} + "
                f"optimizer {m['optimizer_s']:.2f}; EMA {timer.update(total):.2f}); valid "
                f"chunks {rec['valid_chunks']} of {self.max_chunks}")
            del batch, timesteps, noise, m
            if self.step % ckpt_every == 0 or (save_final and self.step == max_steps):
                log(f"checkpoint saved at step {self.step}: {self.save()}")
        tb.close()
        return records


def log(msg: str) -> None:
    print(msg, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="T2To full-finetune training (PyTorch/CUDA port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--smoke", action="store_true", help="tiny model, CPU-friendly")
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
    T2ToTrainer(cfg, args.smoke, device, resume=args.resume).run(args.max_steps)
    print("training done", flush=True)


if __name__ == "__main__":
    main()
