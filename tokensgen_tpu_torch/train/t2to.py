"""T2To training: full finetune of the patch-size-1 T2To DiT on PCA-compressed
condensed-token latents (port of `tokensgen_tpu/train/t2to.py`).

Reference semantics (`train_cogvideo_t2to.py`): every transformer parameter
of the 5b clone with patch_size=1 is trained (`:1269-1284`); the inputs are
condensed tokens, precomputed or made from VAE latents by the frozen patch
conv and resampler (`vip_encode_video_latents`), normalised by
`pca_normalization`; padded chunks are hidden from the base self-attention's
keys by an additive key bias and zeroed in the loss (`padded_chunk_masks`);
RoPE dims (52, 6, 6) over the 8x12 token grid; the x0-space weighted
v-prediction loss; the `vip_1` schedule; clip 1.0, AdamW.

Port design: the parameters are float32 masters that `models.layers.Linear`
and `Conv2d` cast to the compute dtype at use (bf16 compute, as the To2V
trainer's trainable set). The step is `optim.TrainStep` (clip by global
norm, `optax.MultiSteps` accumulation) around `t2to_loss`, which takes the
timesteps and the noise as arguments; the CLI draws them from a
`torch.Generator`. With ``lora_rank`` > 0 (`train/lora.py`) the base is
frozen in its compute dtype and only the LoRA factors on the attention
projections train (the JAX package's LoRA mode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from tokensgen_tpu_torch.core import pca as pca_lib
from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2
from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig
from tokensgen_tpu_torch.models.resampler import Resampler
from tokensgen_tpu_torch.pipelines.to2v import apply_patch_proj
from tokensgen_tpu_torch.train import lora, objective, optim


@dataclasses.dataclass(frozen=True)
class T2ToTrainConfig:
    optimizer: str = "adamw"  # adam | adamw | prodigy
    use_8bit_adam: bool = False  # the T2To reference config trains full-precision
    learning_rate: float = 3e-4
    lr_scheduler: str = "constant"  # diffusers get_scheduler names
    lr_warmup_steps: int = 0
    lr_num_cycles: int = 1
    lr_power: float = 1.0
    max_train_steps: int = 1000
    weight_decay: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    rope_dims: tuple = (52, 6, 6)
    height: int = 8
    width: int = 12
    # LoRA finetune mode (default off): the base frozen, the factors trained
    lora_rank: int = 0
    lora_alpha: float = 64.0
    lora_targets: tuple = ("to_q", "to_k", "to_v", "to_out")


def pca_normalization(tokens: torch.Tensor, pca: pca_lib.PCAState, mean: torch.Tensor,
                      std: torch.Tensor, keep: int = 16) -> torch.Tensor:
    """Condensed tokens [B, F, C, h, w] -> [B, F, keep, h, w] normalised token
    latents: PCA transform, (y - mean) / std, the first ``keep`` components
    (`:1761-1773`)."""
    b, f, c, h, w = tokens.shape
    flat = tokens.permute(0, 1, 3, 4, 2).reshape(-1, c).float()
    y = (pca_lib.transform(pca, flat) - mean) / std
    return y[:, :keep].reshape(b, f, h, w, keep).permute(0, 1, 4, 2, 3)


def padded_chunk_masks(valid_frames: torch.Tensor, num_frames: int, hw: int, text_len: int):
    """(key_bias f32 [B, text_len + F*hw], loss_mask f32 [B, F, 1, 1, 1]) from
    per-sample valid token-frame counts: the keys of padded frames score
    -1e9 (text keys are always valid), their loss is masked."""
    frame_ids = torch.arange(num_frames, device=valid_frames.device)
    valid = frame_ids[None, :] < valid_frames[:, None]  # [B, F]
    token_valid = valid.repeat_interleave(hw, dim=1)
    text_ones = torch.ones(valid.shape[0], text_len, dtype=torch.bool, device=valid.device)
    key_valid = torch.cat([text_ones, token_valid], dim=1)
    key_bias = torch.where(key_valid, 0.0, -1e9).float()
    return key_bias, valid[:, :, None, None, None].float()


def setup_lora_finetune(model: nn.Module, cfg: T2ToTrainConfig,
                        generator: torch.Generator) -> nn.Module:
    """LoRA mode: every base parameter frozen as it is, float32 LoRA
    factors (from ``generator``) on the targets, which alone require grad."""
    for p in model.parameters():
        p.requires_grad_(False)
    lora.init_lora(model, generator, cfg.lora_rank, cfg.lora_alpha, cfg.lora_targets)
    return model


def setup_full_finetune(model: nn.Module) -> nn.Module:
    """Every parameter a float32 master that requires grad (the JAX
    package's f32 params under bf16 compute), converted in place."""
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.float()
            p.requires_grad_(True)
    return model


def make_optimizer(params: Dict[str, torch.Tensor], cfg: T2ToTrainConfig):
    """The optimizer of `make_optimizer`'s chain (adam | adamw, int8 moments
    with ``use_8bit_adam``) under the config's lr schedule; the clip and the
    accumulation are `optim.TrainStep`'s."""
    lr = optim.lr_schedule(cfg.lr_scheduler, cfg.learning_rate, cfg.lr_warmup_steps,
                           cfg.max_train_steps, num_cycles=cfg.lr_num_cycles, power=cfg.lr_power)
    return optim.base_optimizer(cfg.optimizer, params, lr, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                                eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
                                use_8bit=cfg.use_8bit_adam)


def t2to_rope(head_dim: int, cfg: T2ToTrainConfig, num_frames: int, device=None):
    """RoPE tables over the raw token grid with the per-axis dims of
    ``cfg.rope_dims``."""
    dt, dh, dw = cfg.rope_dims
    ar = lambda n: np.arange(n, dtype=np.float32)  # noqa: E731
    return get_3d_rotary_pos_embed_v2(head_dim, ar(num_frames), ar(cfg.height), ar(cfg.width),
                                      dim_t=dt, dim_h=dh, dim_w=dw, device=device)


def t2to_sample_losses(dit: CogVideoXTransformer, sched: S.DiffusionSchedule,
                       cfg: T2ToTrainConfig, batch: Dict, timesteps: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
    """[B] per-sample terms of `t2to_loss`: ``batch`` holds ``latents``
    [B, F, 16, h, w] (PCA-normalised), ``text_embeds`` [B, T, text_dim] and
    ``valid_frames`` [B]; ``timesteps`` [B]; ``noise`` like the latents."""
    latents = batch["latents"]
    f = latents.shape[1]
    noisy = S.add_noise(sched, latents, noise, timesteps)
    rope = t2to_rope(dit.cfg.attention_head_dim, cfg, f, latents.device)
    key_bias, loss_mask = padded_chunk_masks(batch["valid_frames"], f, cfg.height * cfg.width,
                                             batch["text_embeds"].shape[1])
    out = dit(noisy, batch["text_embeds"], timesteps, image_rotary_emb=rope,
              key_bias=key_bias).float()
    return objective.x0_sample_losses(sched, out, noisy.float(), latents.float(), timesteps,
                                      loss_mask=loss_mask)


def t2to_loss(dit: CogVideoXTransformer, sched: S.DiffusionSchedule, cfg: T2ToTrainConfig,
              batch: Dict, timesteps: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The JAX train step's ``loss_fn`` with its random draws passed in (see
    `t2to_sample_losses`)."""
    return t2to_sample_losses(dit, sched, cfg, batch, timesteps, noise).mean()


class T2ToTrainStep(optim.TrainStep):
    """`make_train_step`: the parameters of ``dit`` that require grad (all
    of them in a full finetune, the LoRA factors in LoRA mode), `t2to_loss`
    (see `optim.TrainStep` for the clip, the accumulation and what each
    call returns)."""

    def __init__(self, dit: CogVideoXTransformer, sched: S.DiffusionSchedule,
                 cfg: T2ToTrainConfig, accum_steps: int = 1, optimizer=None):
        self.dit, self.sched, self.cfg = dit, sched, cfg
        params = {n: p for n, p in dit.named_parameters() if p.requires_grad}
        super().__init__(params, optimizer or make_optimizer(params, cfg), cfg.max_grad_norm,
                         sched, accum_steps)

    def sample_losses(self, batch: Dict, timesteps: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
        return t2to_sample_losses(self.dit, self.sched, self.cfg, batch, timesteps, noise)


@torch.no_grad()
def vip_encode_video_latents(dit_config: DiTConfig, patch_proj: nn.Conv2d, resampler: Resampler,
                             vae_latents: torch.Tensor, resampler_image_rotary_emb=None,
                             resampler_sampling_rotary_emb=None,
                             nf_per_chunk: int = 13) -> torch.Tensor:
    """Precomputed VAE latents [B, nf_per_chunk * chunks, 16, H, W] ->
    condensed tokens through the frozen patch conv and resampler, chunk by
    chunk (`train_cogvideo_t2to.py:1715-1740`): [B, Tq * chunks, Cv, Hq, Wq]."""
    num_chunks = vae_latents.shape[1] // nf_per_chunk
    outs = []
    for cid in range(num_chunks):
        lat = vae_latents[:, cid * nf_per_chunk:(cid + 1) * nf_per_chunk]
        tokens = apply_patch_proj(dit_config, patch_proj, lat)
        outs.append(resampler(tokens, resampler_image_rotary_emb, resampler_sampling_rotary_emb))
    return torch.cat(outs, dim=1)
