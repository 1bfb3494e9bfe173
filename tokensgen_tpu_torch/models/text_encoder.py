"""Text conditioning (port of `tokensgen_tpu/models/text_encoder.py`).

* `T5TextEncoder`: the T5 v1.1 encoder of `models/t5.py` and a tokenizer
  read from ``tokenizer.json`` through the ``tokenizers`` package (the Rust
  core of HF's fast tokenizers, without ``transformers``), padded and
  truncated to 226 tokens, for an HF checkpoint dir (`from_pretrained`) or a
  converted ``t5.safetensors`` (`from_converted`);
* `HashTextEncoder`: deterministic pseudo-embeddings keyed on the prompt
  (weights-free runs: smokes, dry runs);
* `CachedTextEncoder`: a per-prompt embedding cache around either;
* `make_text_encoder`: T5 when a checkpoint is configured (raising when it
  does not load, unless the hash fallback is allowed), the hash encoder
  otherwise.

``tokenizers`` is imported only when a tokenizer is read; a dir with only a
sentencepiece ``spiece.model`` is not read.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from tokensgen_tpu_torch.models.t5 import T5Config, T5Encoder


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


def _special_token(value) -> Optional[str]:
    return value.get("content") if isinstance(value, dict) else value


class FastTokenizer:
    """``tokenizer.json`` of ``tokenizer_dir`` through ``tokenizers``. The pad
    token is the one HF's tokenizer would take: ``tokenizer_config.json``'s,
    else ``special_tokens_map.json``'s, else the file's padding setting, else
    ``<pad>``."""

    def __init__(self, tokenizer_dir: str):
        path = os.path.join(tokenizer_dir, "tokenizer.json")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no tokenizer.json in {tokenizer_dir}")
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError("reading tokenizer.json needs the `tokenizers` package, which "
                              "is not installed") from e
        self.tokenizer = Tokenizer.from_file(path)
        pad = None
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            cfg_path = os.path.join(tokenizer_dir, name)
            if pad is None and os.path.isfile(cfg_path):
                with open(cfg_path) as f:
                    pad = _special_token(json.load(f).get("pad_token"))
        if pad is None:
            pad = (self.tokenizer.padding or {}).get("pad_token", "<pad>")
        self.pad_token = pad
        self.pad_id = self.tokenizer.token_to_id(pad)
        if self.pad_id is None:
            raise ValueError(f"pad token {pad!r} is not in {path}")

    def __call__(self, prompts: List[str], max_length: int):
        """-> (input ids, attention mask), int64 [B, max_length] each: padded
        to and truncated at ``max_length``, special tokens added."""
        self.tokenizer.enable_truncation(max_length)
        self.tokenizer.enable_padding(length=max_length, pad_id=self.pad_id,
                                      pad_token=self.pad_token)
        encs = self.tokenizer.encode_batch(prompts)
        ids = np.array([e.ids for e in encs], np.int64)
        mask = np.array([e.attention_mask for e in encs], np.int64)
        return ids, mask


def _load_tokenizer(model_dir: Optional[str], tokenizer_dir: Optional[str] = None):
    """The tokenizer of ``tokenizer_dir``, or else of ``model_dir`` itself or
    its sibling ``tokenizer/`` dir (the CogVideoX-5b layout keeps
    ``text_encoder/`` beside ``tokenizer/``): the first candidate that
    loads."""
    if tokenizer_dir:
        candidates = [tokenizer_dir]
    elif model_dir:
        candidates = [model_dir, os.path.join(os.path.dirname(model_dir.rstrip("/")), "tokenizer")]
    else:
        raise FileNotFoundError("no tokenizer dir given")
    last: Optional[Exception] = None
    for cand in candidates:
        if not os.path.isdir(cand):
            continue
        try:
            return FastTokenizer(cand)
        except (FileNotFoundError, ValueError) as e:
            last = e
    raise FileNotFoundError(f"no loadable tokenizer (tokenizer.json) in {candidates}: {last}")


def _config_from_state_dict(sd) -> T5Config:
    """The T5Config an HF-layout state dict's shapes pin down (checkpoints
    are read without their config.json); bf16 from 1024 wide on, as the JAX
    package sets it."""
    vocab, d_model = sd["shared.weight"].shape
    num_buckets, num_heads = sd[
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"].shape
    return T5Config(
        vocab_size=vocab, d_model=d_model,
        d_kv=sd["encoder.block.0.layer.0.SelfAttention.q.weight"].shape[0] // num_heads,
        d_ff=sd["encoder.block.0.layer.1.DenseReluDense.wi_0.weight"].shape[0],
        num_layers=1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.block.")),
        num_heads=num_heads, relative_attention_num_buckets=num_buckets,
        dtype=torch.bfloat16 if d_model >= 1024 else torch.float32)


def _config_from_param_tree(tree) -> T5Config:
    """The T5Config of a converted JAX `T5Encoder` tree, from its shapes."""
    vocab, d_model = tree["embed"]["embedding"].shape
    num_buckets, num_heads = tree["relative_attention_bias"].shape
    return T5Config(
        vocab_size=vocab, d_model=d_model,
        d_kv=tree["block_0"]["attn"]["q"]["kernel"].shape[1] // num_heads,
        d_ff=tree["block_0"]["wi_0"]["kernel"].shape[1],
        num_layers=sum(1 for k in tree if k.startswith("block_")),
        num_heads=num_heads, relative_attention_num_buckets=num_buckets,
        dtype=torch.bfloat16 if d_model >= 1024 else torch.float32)


class T5TextEncoder:
    """Tokenize (``tokenizer.json``) and encode (`T5Encoder` on its device):
    ``__call__(prompts)`` -> float32 CPU [B, max_length, d_model]."""

    def __init__(self, model: T5Encoder, tokenizer: FastTokenizer, max_length: int = 226):
        self.model = model
        self.tokenizer = tokenizer
        self.max_length = max_length

    @classmethod
    def from_pretrained(cls, model_dir: str, max_length: int = 226,
                        tokenizer_dir: Optional[str] = None, *, device) -> "T5TextEncoder":
        """An HF T5 dir: its ``*.safetensors`` (layer count and widths from
        the keys and shapes) and a tokenizer (`_load_tokenizer`)."""
        from tokensgen_tpu_torch.convert.safetensors_io import load_safetensors
        from tokensgen_tpu_torch.utils.params import load_on_device

        tokenizer = _load_tokenizer(model_dir, tokenizer_dir)
        sd = {}
        for name in sorted(os.listdir(model_dir)):
            if name.endswith(".safetensors"):
                sd.update(load_safetensors(os.path.join(model_dir, name)))
        if not sd:
            raise FileNotFoundError(f"no .safetensors weights in {model_dir}")
        # the embedding is tied: a checkpoint may hold either name
        emb = sd.get("encoder.embed_tokens.weight", sd.get("shared.weight"))
        if emb is None:
            raise KeyError(f"no shared.weight / encoder.embed_tokens.weight in {model_dir}")
        sd["shared.weight"] = sd["encoder.embed_tokens.weight"] = emb
        cfg = _config_from_state_dict(sd)
        return cls(load_on_device(lambda: T5Encoder(cfg), sd, device), tokenizer, max_length)

    @classmethod
    def from_converted(cls, t5_path: str, tokenizer_dir: Optional[str], max_length: int = 226,
                       *, device) -> "T5TextEncoder":
        """A converted ``t5.safetensors`` (the JAX param tree) and a tokenizer
        dir."""
        from tokensgen_tpu_torch.convert.from_jax import t5_state_dict
        from tokensgen_tpu_torch.convert.safetensors_io import load_param_tree
        from tokensgen_tpu_torch.utils.params import load_on_device

        tokenizer = _load_tokenizer(tokenizer_dir)
        tree = load_param_tree(t5_path)
        cfg = _config_from_param_tree(tree)
        sd = {k: torch.from_numpy(v) for k, v in t5_state_dict(tree, cfg.num_layers).items()}
        return cls(load_on_device(lambda: T5Encoder(cfg), sd, device), tokenizer, max_length)

    @torch.no_grad()
    def __call__(self, prompts: List[str]) -> torch.Tensor:
        ids, mask = self.tokenizer(prompts, self.max_length)
        dev = next(self.model.parameters()).device
        out = self.model(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
        return out.float().cpu()


def make_text_encoder(model_dir: Optional[str], max_length: int = 226, embed_dim: int = 4096,
                      allow_hash_fallback: bool = False, converted_path: Optional[str] = None,
                      tokenizer_dir: Optional[str] = None, *, device) -> CachedTextEncoder:
    """T5 when a checkpoint is given, the hash encoder otherwise; cached.

    ``converted_path`` (a converted ``t5.safetensors``) takes precedence over
    ``model_dir`` (an HF T5 dir). A configured checkpoint that fails to load
    raises (RuntimeError; ImportError when ``tokenizers`` is missing) rather
    than running on hash pseudo-embeddings, unless ``allow_hash_fallback``.
    """
    if converted_path or model_dir:
        try:
            if converted_path:
                if not os.path.isfile(converted_path):
                    raise FileNotFoundError(f"converted t5 weights not found: {converted_path}")
                enc = T5TextEncoder.from_converted(converted_path, tokenizer_dir, max_length,
                                                   device=device)
            else:
                if not os.path.isdir(model_dir):
                    raise FileNotFoundError(f"text encoder dir not found: {model_dir}")
                enc = T5TextEncoder.from_pretrained(model_dir, max_length, tokenizer_dir,
                                                    device=device)
            return CachedTextEncoder(enc)
        except (OSError, ValueError, KeyError, RuntimeError, ImportError) as e:
            if not allow_hash_fallback:
                kind = ImportError if isinstance(e, ImportError) else RuntimeError
                raise kind(
                    f"failed to load T5 text encoder from {converted_path or model_dir!r}: {e}. "
                    "Allow the hash fallback (or leave the path unset) to run with "
                    "deterministic hash pseudo-embeddings.") from e
            print(f"T5 load failed ({e}); falling back to hash text encoder", flush=True)
    return CachedTextEncoder(HashTextEncoder(max_length, embed_dim))
