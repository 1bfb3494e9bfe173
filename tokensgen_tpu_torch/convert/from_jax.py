"""JAX package param trees -> the port's state dicts (numpy only).

The trees are the JAX package's flax params as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params["params"])``). The DiT and the
resampler get the reference (diffusers) key names that
`tokensgen_tpu/convert/export.py` (`export_dit`, `export_resampler`) emits, which
are the port's module names; the VAE has no exporter there and is mapped here
onto the port's flax-mirroring names, and the T5 encoder onto the names of
HF's ``T5EncoderModel`` (the inverse of the JAX package's ``convert_t5``).
Weights come out as transposed views of the tree's arrays, not copies. Load
with ``model.load_state_dict(to_torch(sd), strict=True)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

StateDict = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    """A leaf of a tree (numpy, or a CPU tensor from
    `safetensors_io.load_param_tree`; bf16 read as f32) as numpy, uncopied
    where it can be."""
    if getattr(x, "dtype", None) is not None and str(x.dtype) == "torch.bfloat16":
        x = x.float()
    return np.asarray(x)


def _lin(sd: StateDict, name: str, p) -> None:
    """A Dense (``kernel`` [in, out]) or, from a quantized tree, a QuantDense
    (``kernel_q`` int8 [in, out], ``scale`` f32 [out]) -> the port's
    [out, in] ``weight`` / ``weight_q`` (+ ``scale``), and ``bias``."""
    if "kernel_q" in p:
        sd[f"{name}.weight_q"] = _np(p["kernel_q"]).T
        sd[f"{name}.scale"] = _np(p["scale"])
    else:
        sd[f"{name}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        sd[f"{name}.bias"] = _np(p["bias"])


def _ln(sd: StateDict, name: str, p) -> None:
    if "scale" in p:
        sd[f"{name}.weight"] = _np(p["scale"])
    if "bias" in p:
        sd[f"{name}.bias"] = _np(p["bias"])


def _conv2d(sd: StateDict, name: str, p) -> None:
    sd[f"{name}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[f"{name}.bias"] = _np(p["bias"])


def _layer(tree, i: int):
    """Layer ``i`` of a scan-stacked block tree (blocks stack on axis 0)."""
    return {k: _layer(v, i) if isinstance(v, dict) else _np(v)[i] for k, v in tree.items()}


def dit_state_dict(tree, cfg) -> StateDict:
    """`CogVideoXTransformer` tree -> port state dict (``cfg``: the port's or
    the JAX package's DiTConfig; only ``num_layers`` and ``vip`` are read).
    Takes the To2V and the T2To (no VIP, patch size 1) trees, float or
    quantized by `quantize_dit_params` (load into a model built with the
    same ``quant``)."""
    sd: StateDict = {}
    _lin(sd, "patch_embed.text_proj", tree["text_proj"])
    _conv2d(sd, "patch_embed.proj", tree["patch_proj"])
    if "vip_proj" in tree:
        _lin(sd, "patch_embed.vip_proj", tree["vip_proj"])
    _lin(sd, "time_embedding.linear_1", tree["time_embedding"]["linear_1"])
    _lin(sd, "time_embedding.linear_2", tree["time_embedding"]["linear_2"])
    for i in range(cfg.num_layers):
        blk = _layer(tree["blocks"], i)
        pre = f"transformer_blocks.{i}"
        for norm in ("norm1", "norm2"):
            _lin(sd, f"{pre}.{norm}.linear", blk[norm]["linear"])
            _ln(sd, f"{pre}.{norm}.norm", blk[norm]["norm"])
        at = blk["attn1"]
        for proj in ("to_q", "to_k", "to_v"):
            _lin(sd, f"{pre}.attn1.{proj}", at[proj])
        _lin(sd, f"{pre}.attn1.to_out.0", at["to_out"])
        _ln(sd, f"{pre}.attn1.norm_q", at["norm_q"]["ln"])
        _ln(sd, f"{pre}.attn1.norm_k", at["norm_k"]["ln"])
        _lin(sd, f"{pre}.ff.net.0.proj", blk["ff"]["net_0_proj"])
        _lin(sd, f"{pre}.ff.net.2", blk["ff"]["net_2"])
        if cfg.vip is not None:
            for norm in ("vip_norm1", "vip_norm2"):
                _lin(sd, f"{pre}.{norm}.linear", blk[norm]["linear"])
                _ln(sd, f"{pre}.{norm}.norm", blk[norm]["norm"])
            for proj in ("vip_to_q", "vip_to_k", "vip_to_v"):
                _lin(sd, f"{pre}.attn1.processor.{proj}", at[proj])
            _ln(sd, f"{pre}.attn1.processor.vip_norm_q", at["vip_norm_q"]["ln"])
            _ln(sd, f"{pre}.attn1.processor.vip_norm_k", at["vip_norm_k"]["ln"])
    _ln(sd, "norm_final", tree["norm_final"])
    _lin(sd, "norm_out.linear", tree["norm_out"]["linear"])
    _ln(sd, "norm_out.norm", tree["norm_out"]["norm"])
    _lin(sd, "proj_out", tree["proj_out"])
    return sd


def resampler_state_dict(tree, depth: int) -> StateDict:
    """`Resampler` tree -> port state dict."""
    sd: StateDict = {"latents": _np(tree["latents"])}
    _lin(sd, "proj_in", tree["proj_in"])
    _lin(sd, "proj_out", tree["proj_out"])
    _ln(sd, "norm_out", tree["norm_out"])
    for i in range(depth):
        at = tree[f"layers_{i}_attn"]
        for ln in ("norm1", "norm2", "norm_q", "norm_k"):
            _ln(sd, f"layers.{i}.0.{ln}", at[ln])
        for proj in ("to_q", "to_kv", "to_out"):
            _lin(sd, f"layers.{i}.0.{proj}", at[proj])
        ff = tree[f"layers_{i}_ff"]
        _lin(sd, f"layers.{i}.1.net.0.proj", ff["net_0_proj"])
        _lin(sd, f"layers.{i}.1.net.2", ff["net_2"])
    return sd


def vae_state_dict(tree) -> StateDict:
    """`AutoencoderKLCogVideoX` tree -> port state dict. Flax paths map to
    module paths one to one, except that the flax GroupNorm's own scope
    (``GroupNorm_0``) disappears, ``scale`` is ``weight``, and conv kernels
    [kt, kh, kw, in, out] become [out, in, kt, kh, kw]."""
    sd: StateDict = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path if key == "GroupNorm_0" else path + [key])
                continue
            arr = _np(val)
            if key == "kernel":
                sd[".".join(path + ["weight"])] = arr.transpose(4, 3, 0, 1, 2)
            elif key == "scale":
                sd[".".join(path + ["weight"])] = arr
            else:
                sd[".".join(path + [key])] = arr

    walk(tree, [])
    return sd


def t5_state_dict(tree, num_layers: int) -> StateDict:
    """`T5Encoder` tree -> port state dict (HF ``T5EncoderModel`` names; the
    embedding is tied: ``shared`` and ``encoder.embed_tokens``)."""
    emb = _np(tree["embed"]["embedding"])
    sd: StateDict = {"shared.weight": emb, "encoder.embed_tokens.weight": emb,
                     "encoder.final_layer_norm.weight": _np(tree["final_ln"]["scale"])}
    sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = _np(
        tree["relative_attention_bias"])
    for i in range(num_layers):
        blk, pre = tree[f"block_{i}"], f"encoder.block.{i}.layer"
        sd[f"{pre}.0.layer_norm.weight"] = _np(blk["ln1"]["scale"])
        sd[f"{pre}.1.layer_norm.weight"] = _np(blk["ln2"]["scale"])
        for proj in ("q", "k", "v", "o"):
            _lin(sd, f"{pre}.0.SelfAttention.{proj}", blk["attn"][proj])
        for proj in ("wi_0", "wi_1", "wo"):
            _lin(sd, f"{pre}.1.DenseReluDense.{proj}", blk[proj])
    return sd


def pca_state(state):
    """The JAX package's `PCAState` (or any (mean, components) pair) -> the
    port's, as float32 CPU tensors."""
    import torch

    from tokensgen_tpu_torch.core.pca import PCAState

    mean, components = state
    return PCAState(*(torch.from_numpy(np.array(x, dtype=np.float32)) for x in (mean, components)))


def to_torch(sd: StateDict):
    """numpy state dict -> torch tensors (CPU)."""
    import torch

    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}
