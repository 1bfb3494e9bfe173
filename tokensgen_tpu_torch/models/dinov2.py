"""DINOv2 image encoder for the non-VAE VIP conditioning path
(``use_vae_as_encoder: false``). Port of `tokensgen_tpu/models/dinov2.py`.

The pipeline resizes each frame to 224 with an antialiased linear filter,
ImageNet-normalises it, encodes it, and feeds the PENULTIMATE hidden state's
first ``num_patches`` tokens to the resampler. The architecture is HF's
``Dinov2Model``: patch conv + cls token + learned position embeddings,
pre-LN blocks with q/k/v bias, LayerScale on both branches, exact GELU MLP;
the module names are HF's, so a ``facebook/dinov2-*`` state dict loads
through `convert_dinov2` (its first ``num_layers - 1`` blocks; the last block
and the final norm feed nothing the pipeline reads). Everything runs in
float32; each block's attention is K4 on float32 operands
(`kernels.attention.flash_attention`, its plain version on the host). The
block norms take the JAX package's epsilon, 1e-5.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tokensgen_tpu_torch.kernels.attention import flash_attention
from tokensgen_tpu_torch.models.layers import Conv2d, LayerNorm, Linear

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class DINOv2Config:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 14
    image_size: int = 224
    layerscale: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def large(cls, **kw) -> "DINOv2Config":
        """facebook/dinov2-large: 16 x 16 + 1 tokens at 224; the pipeline
        consumes hidden_states[-2][:, :256]."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "DINOv2Config":
        defaults = dict(hidden_size=32, num_layers=3, num_heads=2, intermediate_size=64,
                        patch_size=8, image_size=32)
        defaults.update(kw)
        return cls(**defaults)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        d = cfg.hidden_size
        self.query, self.key, self.value = Linear(d, d), Linear(d, d), Linear(d, d)


class _Output(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)


class _Attention(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        self.cfg = cfg
        self.attention = _SelfAttention(cfg)
        self.output = _Output(cfg)

    def forward(self, h):
        cfg, at = self.cfg, self.attention
        b, s, d = h.shape

        def heads(x):
            return x.view(b, s, cfg.num_heads, d // cfg.num_heads).transpose(1, 2)

        out = flash_attention(heads(at.query(h)), heads(at.key(h)), heads(at.value(h)))
        return self.output.dense(out.transpose(1, 2).reshape(b, s, d))


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(dim))


class _MLP(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _Block(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        self.cfg = cfg
        self.norm1 = LayerNorm(cfg.hidden_size)
        self.attention = _Attention(cfg)
        self.norm2 = LayerNorm(cfg.hidden_size)
        self.mlp = _MLP(cfg)
        if cfg.layerscale:
            self.layer_scale1 = _LayerScale(cfg.hidden_size)
            self.layer_scale2 = _LayerScale(cfg.hidden_size)

    def forward(self, x):
        h = self.attention(self.norm1(x))
        if self.cfg.layerscale:
            h = h * self.layer_scale1.lambda1
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.cfg.layerscale:
            h = h * self.layer_scale2.lambda1
        return x + h


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        p = cfg.patch_size
        self.projection = Conv2d(3, cfg.hidden_size, p, stride=p)


class _Embeddings(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, 1 + cfg.num_patches, cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg)


class _Encoder(nn.Module):
    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        self.layer = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_layers - 1))


class DINOv2Encoder(nn.Module):
    """pixel_values [B, 3, H, W] (ImageNet-normalised) -> the penultimate
    hidden state [B, 1 + num_patches, hidden] (cls token first): the output
    of the first ``num_layers - 1`` blocks (HF ``hidden_states[-2]``)."""

    def __init__(self, cfg: DINOv2Config):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, pixel_values):
        emb = self.embeddings
        b = pixel_values.shape[0]
        x = emb.patch_embeddings.projection(pixel_values.float())  # [B, D, h, w]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([emb.cls_token.expand(b, -1, -1), x], dim=1) + emb.position_embeddings
        for block in self.encoder.layer:
            x = block(x)
        return x


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of an antialiased linear (triangle)
    resize, as `jax.image.resize(..., method="linear", antialias=True)`
    computes them: the kernel widened by the downscale factor, each output's
    weights normalised over the inputs they reach, outputs sampled outside
    the input range zero."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)  # a Python float, rounded to f32 at use, as there
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() / kernel_scale
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def preprocess_frames(frames: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[N, H, W, 3] in [-1, 1] -> ImageNet-normalised [N, 3, S, S] float32:
    the separable antialiased linear resize of `jax.image.resize` (the JAX
    package's preprocessing; written out, as PyTorch's antialiased
    interpolation is not its function), then the HF processor's
    normalisation."""
    n, h, w, _ = frames.shape
    dev = frames.device
    x = (frames.float() + 1.0) / 2.0
    if h != image_size:
        x = torch.einsum("nhwc,hH->nHwc", x, _resize_weights(h, image_size, dev))
    if w != image_size:
        x = torch.einsum("nhwc,wW->nhWc", x, _resize_weights(w, image_size, dev))
    mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
    std = torch.from_numpy(IMAGENET_STD).to(dev)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def convert_dinov2(sd, config: DINOv2Config) -> dict:
    """An HF ``Dinov2Model`` state dict -> the state dict of a
    `DINOv2Encoder` of ``config``: the keys it has, as tensors (the last
    block, the final norm and the mask token are left out). A missing key
    raises KeyError; a position table for another image size raises
    ValueError (the JAX package interpolates none either)."""
    with torch.device("meta"):
        names = list(DINOv2Encoder(config).state_dict())
    missing = [k for k in names if k not in sd]
    if missing:
        raise KeyError(f"DINOv2 state dict lacks {len(missing)} keys, e.g. {missing[:3]}")
    out = {k: torch.as_tensor(sd[k]) for k in names}
    pos = out["embeddings.position_embeddings"]
    if pos.shape[1] != 1 + config.num_patches:
        raise ValueError(f"position_embeddings hold {pos.shape[1] - 1} patches; the config's "
                         f"{config.image_size} px at patch {config.patch_size} takes "
                         f"{config.num_patches}")
    return out


def load_dinov2(model_dir: str, config: DINOv2Config = DINOv2Config.large(), *,
                device) -> DINOv2Encoder:
    """The encoder from the ``*.safetensors`` files of an HF model dir
    (read through `convert.safetensors_io`), materialised on ``device``."""
    from tokensgen_tpu_torch.convert.torch_weights import read_safetensors_dir
    from tokensgen_tpu_torch.utils.params import load_on_device

    sd = read_safetensors_dir(model_dir)
    if not sd:
        raise FileNotFoundError(f"no *.safetensors in {model_dir}")
    return load_on_device(lambda: DINOv2Encoder(config),
                          {k: v.float() for k, v in convert_dinov2(sd, config).items()}, device)
