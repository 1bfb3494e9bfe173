"""Training memory budgets per card (port of `tokensgen_tpu/train/memory.py`).

Per-card bytes of the two full-width trainers on a (data-parallel ranks,
ZeRO-1) layout, from the port's own modules built on the meta device (no
memory is allocated): the trained and frozen parameters as the trainers
hold them, the optimizer state as `sharding.zero` splits it
(`sharded_bytes_per_device`), and an activation model of the port's
per-block checkpointing (`models/dit.py`: `torch.utils.checkpoint` around
each block):

* checkpointed block inputs: each block keeps its input streams (video +
  text, and the VIP tokens) in the compute dtype until its backward ->
  ``L x B x S x D`` bf16;
* one block's recompute and backward: `BLOCK_WORK_COPIES` bf16 copies of
  ``[B, S, D]`` (its saved activations, the FF's 4x-wide pair among them,
  and their gradients), an over-estimate so that a verdict errs on the safe
  side.

Rows are summed as if every part peaked together (the gradients build up
while the block inputs are freed, so the measured peak is lower). The fit
verdict is against one H100 80 GB card (`CARD_GIB`, `USABLE_FRACTION` of it:
the CUDA context and the allocator's fragmentation take the rest).

Workloads (the shipped configs): To2V adapter training (bs 2 a card, 49-frame
720x480 chunks, int8 AdamW, accumulation 9 summed in ``.grad``, which adds
no buffer) and the T2To full finetune (bs 3, 24-chunk token sequences, f32
AdamW as `train_t2to.yaml` ships it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from tokensgen_tpu_torch.sharding.zero import sharded_bytes_per_device

CARD_GIB = 81559 / 1024  # an H100 80 GB: 81,559 MiB
USABLE_FRACTION = 0.93
BLOCK_WORK_COPIES = 24  # bf16 [B, S, D] copies live in one block's recompute + backward

GiB = 1024.0 ** 3


def _bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params)


@dataclasses.dataclass
class Budget:
    workload: str
    layout: str
    rows: Dict[str, float]  # component -> GiB per card

    @property
    def total_gib(self) -> float:
        return sum(self.rows.values())

    def fits(self) -> bool:
        return self.total_gib <= CARD_GIB * USABLE_FRACTION

    def table(self) -> str:
        lines = [f"### {self.workload} — {self.layout}", "", "| component | GiB/card |",
                 "|---|---|"]
        lines += [f"| {k} | {v:.2f} |" for k, v in self.rows.items()]
        lines.append(f"| **total** | **{self.total_gib:.2f}** |")
        verdict = "FITS" if self.fits() else "DOES NOT FIT"
        lines.append(f"| vs one H100 80 GB ({CARD_GIB:.1f} GiB, {USABLE_FRACTION:.0%} usable) | "
                     f"{verdict} |")
        return "\n".join(lines)


def _activation_gib(num_layers: int, b: int, s_total: int, inner: int) -> Dict[str, float]:
    carry = num_layers * b * s_total * inner * 2
    block = BLOCK_WORK_COPIES * b * s_total * inner * 2
    return {"checkpointed block inputs (bf16)": carry / GiB,
            f"one block's recompute + backward (~{BLOCK_WORK_COPIES} copies bf16)": block / GiB}


def to2v_budget(per_device_batch: int = 2, zero_ranks: int = 1) -> Budget:
    """To2V adapter training at full width: the frozen bf16 base, f32
    trainable masters (the ``vip_*`` parameters and the resampler), their
    f32 gradients, int8 AdamW state split ZeRO-1 over ``zero_ranks``, the
    frozen VAE, and the activations of ``per_device_batch`` 13-frame
    windows at 720x480."""
    from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig, VIPConfig
    from tokensgen_tpu_torch.models.resampler import Resampler, ResamplerConfig
    from tokensgen_tpu_torch.models.vae3d import AutoencoderKLCogVideoX, VAEConfig
    from tokensgen_tpu_torch.train import to2v

    vc = VIPConfig()
    dcfg = DiTConfig.cogvideox_5b(vip=vc, remat=True)
    with torch.device("meta"):
        model = to2v.To2VModel(CogVideoXTransformer(dcfg), Resampler(ResamplerConfig()))
        vae = AutoencoderKLCogVideoX(VAEConfig.cogvideox())
    to2v.setup_trainable(model, frozen_dtype=dcfg.dtype)
    train = to2v.trainable_parameters(model)
    frozen = [p for n, p in model.named_parameters() if n not in train]
    tcfg = to2v.To2VTrainConfig(use_8bit_adam=True)
    nf, h, w = 13, 60, 90
    s_tv = dcfg.max_text_seq_length + nf * (h // 2) * (w // 2)
    rows = {
        "frozen base params (bf16, replicated)": _bytes(frozen) / GiB,
        "trainable masters (f32, replicated)": _bytes(train.values()) / GiB,
        f"optimizer state (int8 AdamW, ZeRO-1/{zero_ranks})": sharded_bytes_per_device(
            lambda parts, sizes: to2v.make_optimizer(parts, tcfg, _zero(sizes)), train,
            zero_ranks) / GiB,
        "gradients (f32 trainable, summed in .grad)": _bytes(train.values()) / GiB,
        "VAE (frozen, encode)": _bytes(vae.parameters()) / GiB,
    }
    rows.update(_activation_gib(dcfg.num_layers, per_device_batch, s_tv + vc.length,
                                dcfg.inner_dim))
    return Budget("To2V adapter training", f"bs {per_device_batch}/card, dp{zero_ranks} + ZeRO-1",
                  rows)


def t2to_budget(per_device_batch: int = 3, zero_ranks: int = 1, max_chunks: int = 24,
                use_8bit_adam: bool = False) -> Budget:
    """T2To full finetune at full width: every parameter an f32 master with
    an f32 gradient, AdamW state (f32 as shipped, int8 with
    ``use_8bit_adam``) split ZeRO-1 over ``zero_ranks``, each block's bf16
    weight copies made at use, and the activations of
    ``per_device_batch`` sequences of ``max_chunks`` chunks."""
    from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig
    from tokensgen_tpu_torch.train import t2to

    dcfg = DiTConfig.t2to_5b(remat=True)
    with torch.device("meta"):
        dit = CogVideoXTransformer(dcfg)
    t2to.setup_full_finetune(dit)
    params = dict(dit.named_parameters())
    tcfg = t2to.T2ToTrainConfig(use_8bit_adam=use_8bit_adam)
    s_tv = dcfg.max_text_seq_length + max_chunks * 4 * 8 * 12
    kind = "int8" if use_8bit_adam else "f32"
    rows = {
        "params (f32 masters, replicated)": _bytes(params.values()) / GiB,
        "bf16 compute copy (per-block transient)":
            _bytes(params.values()) / 2 / dcfg.num_layers / GiB,
        f"optimizer state ({kind} AdamW, ZeRO-1/{zero_ranks})": sharded_bytes_per_device(
            lambda parts, sizes: t2to.make_optimizer(parts, tcfg, _zero(sizes)), params,
            zero_ranks) / GiB,
        "gradients (f32)": _bytes(params.values()) / GiB,
    }
    rows.update(_activation_gib(dcfg.num_layers, per_device_batch, s_tv, dcfg.inner_dim))
    return Budget("T2To full finetune", f"bs {per_device_batch}/card, dp{zero_ranks} + ZeRO-1",
                  rows)


def _zero(sizes):
    from tokensgen_tpu_torch.train.optim import ZeroParts

    return ZeroParts(None, sizes, frozenset(), None)
