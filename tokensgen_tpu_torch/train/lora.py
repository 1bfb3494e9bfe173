"""LoRA for the DiT (port of `tokensgen_tpu/train/lora.py`): low-rank
adapters on the attention projections ``to_q``, ``to_k``, ``to_v`` and
``to_out`` (the reference's peft targets).

* `init_lora` attaches ``lora_a`` [in, r] (normal, ``stddev``) and
  ``lora_b`` [r, out] (zeros, so the adapted model equals the base at step
  0) to each targeted `models.layers.Linear` and returns the factors keyed
  by module name; the Linear then adds ``(x·a)·b·α/r`` to its output;
* `merge_lora` folds the factors into a state dict's weights,
  ``W + (a·b·α/r)ᵀ``: the export the trainers write at the end;
* `lora_param_count` counts the factors.

Targets are chosen by exact module name, as the JAX package's ``_is_target``
does: a Linear whose name (or, for ``to_out.0``, its list's name) is a
target; ``vip_to_q`` is not ``to_q``. The JAX package merges the factors
into every targeted weight inside each step; the port keeps them factored,
which is the same function without a merged copy of each weight per step.
Its factors are drawn from the caller's generator (the JAX package seeds
each from ``hash(path)``, which Python salts per process).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from tokensgen_tpu_torch.models.layers import Linear

DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out")

Lora = Dict[str, Dict[str, torch.Tensor]]


def _leaf_name(module_name: str) -> str:
    """A module's own name: ``attn1.to_q`` -> ``to_q``, ``attn1.to_out.0``
    -> ``to_out`` (an element of a list goes by the list's name)."""
    parts = module_name.split(".")
    return parts[-2] if parts[-1].isdigit() and len(parts) > 1 else parts[-1]


def lora_target_modules(model: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS
                        ) -> Dict[str, Linear]:
    """The float Linears of ``model`` that LoRA adapts, by module name."""
    return {name: mod for name, mod in model.named_modules()
            if type(mod) is Linear and _leaf_name(name) in targets}


def init_lora(model: nn.Module, generator: torch.Generator, rank: int = 128,
              alpha: float = 64.0, targets: Sequence[str] = DEFAULT_TARGETS,
              stddev: float = 0.02) -> Lora:
    """Adds a rank-``rank`` adapter with scale ``alpha / rank`` to each
    target of ``model``: float32 factors on the weight's device, ``a`` from
    ``generator``, ``b`` zero. Returns them keyed by module name."""
    lora = {}
    for name, mod in lora_target_modules(model, targets).items():
        dev = mod.weight.device
        a = torch.randn(mod.in_features, rank, generator=generator, device=dev) * stddev
        b = torch.zeros(rank, mod.out_features, device=dev)
        mod.lora_a, mod.lora_b = nn.Parameter(a), nn.Parameter(b)
        mod.lora_scale = alpha / rank
        lora[name] = {"a": mod.lora_a, "b": mod.lora_b}
    if not lora:
        raise ValueError(f"no LoRA target among the model's Linears: {list(targets)}")
    return lora


def lora_factors(model: nn.Module) -> Lora:
    """The adapters `init_lora` attached, keyed by module name."""
    return {name: {"a": mod.lora_a, "b": mod.lora_b} for name, mod in model.named_modules()
            if isinstance(mod, Linear) and mod.lora_scale is not None}


@torch.no_grad()
def merge_lora(state_dict: Dict[str, torch.Tensor], lora: Lora, rank: int,
               alpha: float = 64.0) -> Dict[str, torch.Tensor]:
    """``state_dict`` with each adapted weight [out, in] replaced by
    ``W + (a·b·α/r)ᵀ`` in the weight's dtype, and the factors' own entries
    left out."""
    scale = alpha / rank
    out = {k: v for k, v in state_dict.items()
           if not k.endswith((".lora_a", ".lora_b"))}
    for name, ab in lora.items():
        w = out[f"{name}.weight"]
        delta = (ab["a"].float() @ ab["b"].float()) * scale
        out[f"{name}.weight"] = w + delta.t().to(device=w.device, dtype=w.dtype)
    return out


def lora_param_count(lora: Lora) -> int:
    return sum(int(v.numel()) for ab in lora.values() for v in (ab["a"], ab["b"]))
