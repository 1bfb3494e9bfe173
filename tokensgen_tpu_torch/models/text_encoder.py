"""Weights-free text conditioning (port of the hash and cached encoders of
`tokensgen_tpu/models/text_encoder.py`). The T5-XXL encoder waits until
weights and a tokenizer are in the repository."""

from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np
import torch


class HashTextEncoder:
    """Deterministic pseudo-embeddings keyed on the prompt string: the same
    numbers as the JAX package's `HashTextEncoder` (numpy generator seeded
    from the prompt's sha256), returned as a float32 CPU tensor."""

    def __init__(self, max_length: int = 226, embed_dim: int = 4096, scale: float = 0.02):
        self.max_length = max_length
        self.embed_dim = embed_dim
        self.scale = scale

    def __call__(self, prompts: List[str]) -> torch.Tensor:
        out = np.zeros((len(prompts), self.max_length, self.embed_dim), np.float32)
        for i, p in enumerate(prompts):
            seed = int.from_bytes(hashlib.sha256(p.encode()).digest()[:4], "little")
            out[i] = np.random.default_rng(seed).normal(
                size=(self.max_length, self.embed_dim)) * self.scale
        return torch.from_numpy(out)


class CachedTextEncoder:
    """Wraps an encoder with a per-prompt embedding cache."""

    def __init__(self, inner):
        self.inner = inner
        self._cache: Dict[str, torch.Tensor] = {}

    def __call__(self, prompts: List[str]) -> torch.Tensor:
        missing = [p for p in prompts if p not in self._cache]
        if missing:
            for p, e in zip(missing, self.inner(missing)):
                self._cache[p] = e
        return torch.stack([self._cache[p] for p in prompts])
