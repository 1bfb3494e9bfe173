"""To2V adapter training (port of `tokensgen_tpu/train/to2v.py`).

Reference semantics (`train_cogvideo_to2v.py`): freeze the whole DiT except its
``vip_*`` parameters, train those and the whole resampler (`:1455-1481`);
timesteps from two regimes mixed by ``diff_timesteps_ratio`` (`:1773-1818`);
the x0-space weighted v-prediction loss (`:1995-2004`); grad clip 1.0; AdamW;
bf16 compute with float32 master weights.

Port design: the DiT and the resampler sit in one `To2VModel`, so a
parameter's name carries its place (``dit.…`` / ``resampler.…``) and the
JAX package's label rule applies to it unchanged. With ``lora_rank`` > 0
the DiT's attention projections carry LoRA factors (`train/lora.py`),
trained alongside the adapters. Frozen parameters do not
require grad, so autograd computes no weight gradient for them; trainable
ones are float32 masters that `models.layers.Linear` casts to the compute
dtype at use. Gradient accumulation has `optax.MultiSteps` semantics: the
mean of k micro-batch gradients, one update. The loss takes the timesteps
and the noise as arguments; the CLI draws them from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig, graft_vip_params
from tokensgen_tpu_torch.models.resampler import Resampler, ResamplerConfig
from tokensgen_tpu_torch.train import lora, objective, optim
from tokensgen_tpu_torch.utils.params import build_on_device


@dataclasses.dataclass(frozen=True)
class To2VTrainConfig:
    use_8bit_adam: bool = True  # reference default (`use_8bit_adam: true`)
    optimizer: str = "adamw"  # adam | adamw | prodigy
    learning_rate: float = 2e-4
    lr_scheduler: str = "constant"  # diffusers get_scheduler names
    lr_warmup_steps: int = 0
    lr_num_cycles: int = 1  # cosine_with_restarts
    lr_power: float = 1.0  # polynomial
    max_train_steps: int = 1000  # decay horizon for non-constant schedules
    weight_decay: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    diff_timesteps_ratio: float = 0.4
    inference_timesteps: int = 52
    # LoRA on the DiT's to_{q,k,v,out} (default off), trained alongside the
    # vip / resampler adapters
    lora_rank: int = 0
    lora_alpha: float = 64.0
    lora_targets: tuple = ("to_q", "to_k", "to_v", "to_out")


class To2VModel(nn.Module):
    """The trained pair: ``dit`` (frozen but for ``vip_*``) and ``resampler``."""

    def __init__(self, dit: CogVideoXTransformer, resampler: Resampler):
        super().__init__()
        self.dit = dit
        self.resampler = resampler


def is_trainable(name: str) -> bool:
    """`trainable_labels`' rule: every resampler parameter, every DiT
    parameter with ``vip_`` in its name, and the LoRA factors."""
    return (name.startswith("resampler.") or "vip_" in name
            or name.endswith((".lora_a", ".lora_b")))


def trainable_labels(model: nn.Module) -> Dict[str, str]:
    return {n: "train" if is_trainable(n) else "freeze" for n, _ in model.named_parameters()}


def trainable_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if is_trainable(n)}


@torch.no_grad()
def setup_trainable(model: nn.Module, frozen_dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Trainable parameters: float32 masters that require grad. Frozen ones:
    no grad, and float32 leaves cast to ``frozen_dtype`` when given (the JAX
    package's `cast_frozen_bf16`; the port's matmul and conv weights are in
    the compute dtype already)."""
    for name, p in model.named_parameters():
        train = is_trainable(name)
        if train:
            p.data = p.data.float()
        elif frozen_dtype is not None and p.dtype == torch.float32:
            p.data = p.data.to(frozen_dtype)
        p.requires_grad_(train)
    return model


def init_model(dit_config: DiTConfig, resampler_config: ResamplerConfig, device,
               generator: torch.Generator, cfg: Optional[To2VTrainConfig] = None) -> To2VModel:
    """Random weights made on ``device`` from ``generator``, the VIP branch
    grafted from the base attention (`init_params` with `graft_vip_params`),
    and LoRA factors on the DiT when ``cfg.lora_rank`` > 0."""
    resampler = build_on_device(lambda: Resampler(resampler_config), device, generator)
    dit = graft_vip_params(build_on_device(lambda: CogVideoXTransformer(dit_config), device,
                                           generator))
    if cfg is not None and cfg.lora_rank > 0:
        lora.init_lora(dit, generator, cfg.lora_rank, cfg.lora_alpha, cfg.lora_targets)
    return To2VModel(dit, resampler).train()


def vip_tokens(model: To2VModel, batch: Dict) -> torch.Tensor:
    """The resampler's VIP tokens for the batch, inside the loss (it is
    trained): per chunk, then the window's token frames (``vip_emb_sel``)."""
    rs_img = batch.get("resampler_image_rotary_emb")
    rs_smp = batch.get("resampler_sampling_rotary_emb")
    chunks = batch["vip_input_chunks"]
    vip_all = torch.cat([model.resampler(chunks[:, c], rs_img, rs_smp)
                         for c in range(chunks.shape[1])], dim=1)
    sel = batch["vip_emb_sel"].long()
    return torch.gather(vip_all, 1, sel[:, :, None, None, None].expand(-1, -1, *vip_all.shape[2:]))


def to2v_sample_losses(model: To2VModel, sched: S.DiffusionSchedule, batch: Dict,
                       timesteps: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """[B] per-sample terms of `to2v_loss`: ``timesteps`` [B, F], ``noise``
    like ``batch["latents"]``."""
    latents = batch["latents"]
    noisy = S.add_noise(sched, latents, noise, timesteps)
    out = model.dit(noisy, batch["text_embeds"], timesteps, vip_tokens(model, batch),
                    batch.get("image_rotary_emb"), batch.get("vip_image_rotary_emb"),
                    batch.get("vip_condition_rotary_emb")).float()
    return objective.x0_sample_losses(sched, out, noisy.float(), latents.float(), timesteps)


def to2v_loss(model: To2VModel, sched: S.DiffusionSchedule, batch: Dict,
              timesteps: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The JAX train step's ``loss_fn`` with its random draws passed in (see
    `to2v_sample_losses`)."""
    return to2v_sample_losses(model, sched, batch, timesteps, noise).mean()


def make_optimizer(params: Dict[str, torch.Tensor], cfg: To2VTrainConfig):
    lr = optim.lr_schedule(cfg.lr_scheduler, cfg.learning_rate, cfg.lr_warmup_steps,
                           cfg.max_train_steps, num_cycles=cfg.lr_num_cycles, power=cfg.lr_power)
    return optim.base_optimizer(cfg.optimizer, params, lr, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                                eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
                                use_8bit=cfg.use_8bit_adam)


class To2VTrainStep(optim.TrainStep):
    """`make_train_step` over the trainable parameters of ``model``, with
    `to2v_loss` (see `optim.TrainStep` for the clip, the accumulation and
    what each call returns)."""

    def __init__(self, model: To2VModel, sched: S.DiffusionSchedule, cfg: To2VTrainConfig,
                 accum_steps: int = 1, optimizer=None):
        self.model, self.sched, self.cfg = model, sched, cfg
        params = trainable_parameters(model)
        super().__init__(params, optimizer or make_optimizer(params, cfg), cfg.max_grad_norm,
                         sched, accum_steps)

    def sample_losses(self, batch: Dict, timesteps: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
        return to2v_sample_losses(self.model, self.sched, batch, timesteps, noise)
