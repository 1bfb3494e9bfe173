"""3-D causal VAE (CogVideoX family) with the conv cache carried between frame
batches (port of `tokensgen_tpu/models/vae3d.py`).

Public tensors keep the JAX package's channels-last layout [B, T, H, W, C];
inside, modules run on [B, C, T, H, W] with `nn.Conv3d` (the JAX package's
`Conv3dTap2d` existed only because XLA:TPU lowered conv3d poorly). Module
names mirror the flax tree (``encoder.down_0_res_0.conv1.conv``...), so
`convert/from_jax.py::vae_state_dict` maps it mechanically.

The causal conv cache is a plain dict keyed by each `CausalConv3d`'s module
path: pass ``{}`` on the first frame batch (causal convs replicate the first
frame), the same dict on later batches, or None to disable caching.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    temporal_compression_ratio: int = 4
    sample_height: int = 480
    sample_width: int = 720
    scaling_factor: float = 1.15258426
    dtype: torch.dtype = torch.float32

    @property
    def temporal_compress_level(self) -> int:
        return int(math.log2(self.temporal_compression_ratio))

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def cogvideox(cls, **kw) -> "VAEConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "VAEConfig":
        defaults = dict(block_out_channels=(8, 16, 16, 32), layers_per_block=1,
                        norm_num_groups=4, sample_height=32, sample_width=48)
        defaults.update(kw)
        return cls(**defaults)


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics; the output keeps the input dtype."""

    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight, self.bias, 1e-6).to(x.dtype)


class CausalConv3d(nn.Module):
    """Temporally causal 3-D conv. The cache holds the last k_t-1 *input*
    frames; without an entry the first frame is replicated."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=(3, 3, 3), dtype=torch.float32):
        super().__init__()
        kt, kh, kw = kernel_size
        self.kt = kt
        self.cache_key = ""  # the module path, set by AutoencoderKLCogVideoX
        self.conv = nn.Conv3d(in_ch, out_ch, kernel_size, padding=(0, kh // 2, kw // 2),
                              dtype=dtype)

    def forward(self, x, cache: Optional[Cache]):
        kt = self.kt
        if kt > 1:
            if cache is not None and self.cache_key in cache:
                prefix = cache[self.cache_key]
            else:
                prefix = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1)
            x = torch.cat([prefix.to(x.dtype), x], dim=2)
            if cache is not None:
                cache[self.cache_key] = x[:, :, x.shape[2] - (kt - 1):]
        return self.conv(x.to(self.conv.weight.dtype))


def _nearest_resize(x, size_thw):
    """Nearest-neighbour resize of [B, C, T, H, W] to (T', H', W')."""
    t, h, w = x.shape[2:]
    tt, th, tw = size_thw
    if tt % t == 0 and th % h == 0 and tw % w == 0:
        if tt != t:
            x = x.repeat_interleave(tt // t, dim=2)
        if th != h:
            x = x.repeat_interleave(th // h, dim=3)
        if tw != w:
            x = x.repeat_interleave(tw // w, dim=4)
        return x
    return F.interpolate(x, size=size_thw, mode="nearest-exact")


class SpatialNorm3D(nn.Module):
    """GroupNorm(f) modulated by conv(zq), first-frame-aware nearest resize.
    The 1x1x1 convs run at zq's resolution (they commute with the resize)."""

    def __init__(self, f_channels: int, zq_channels: int, groups: int, dtype=torch.float32):
        super().__init__()
        self.conv_y = CausalConv3d(zq_channels, f_channels, (1, 1, 1), dtype=dtype)
        self.conv_b = CausalConv3d(zq_channels, f_channels, (1, 1, 1), dtype=dtype)
        self.norm_layer = GroupNorm32(groups, f_channels)

    def forward(self, f, zq, cache: Optional[Cache]):
        t = f.shape[2]
        hw = tuple(f.shape[3:5])
        y_small = self.conv_y(zq, cache)
        b_small = self.conv_b(zq, cache)

        def resize(z):
            if t > 1 and t % 2 == 1:
                return torch.cat([_nearest_resize(z[:, :, :1], (1,) + hw),
                                  _nearest_resize(z[:, :, 1:], (t - 1,) + hw)], dim=2)
            return _nearest_resize(z, (t,) + hw)

        return self.norm_layer(f) * resize(y_small) + resize(b_small)


class ResnetBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int, zq_channels: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        self.spatial = zq_channels is not None
        if self.spatial:
            self.norm1 = SpatialNorm3D(in_ch, zq_channels, groups, dtype)
            self.norm2 = SpatialNorm3D(out_ch, zq_channels, groups, dtype)
        else:
            self.norm1 = GroupNorm32(groups, in_ch)
            self.norm2 = GroupNorm32(groups, out_ch)
        self.conv1 = CausalConv3d(in_ch, out_ch, dtype=dtype)
        self.conv2 = CausalConv3d(out_ch, out_ch, dtype=dtype)
        self.conv_shortcut = nn.Conv3d(in_ch, out_ch, 1, dtype=dtype) if in_ch != out_ch else None

    def forward(self, x, zq, cache: Optional[Cache]):
        h = self.norm1(x, zq, cache) if self.spatial else self.norm1(x)
        h = self.conv1(F.silu(h), cache)
        h = self.norm2(h, zq, cache) if self.spatial else self.norm2(h)
        h = self.conv2(F.silu(h), cache)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample3D(nn.Module):
    """Temporal avg-pool (first frame kept when odd) + strided spatial conv
    with right/bottom pad."""

    def __init__(self, ch: int, compress_time: bool, dtype=torch.float32):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv3d(ch, ch, (1, 3, 3), stride=(1, 2, 2), dtype=dtype)

    def forward(self, x):
        t = x.shape[2]
        if self.compress_time and t > 1:
            if t % 2 == 1:
                rest = x[:, :, 1:]
                x = torch.cat([x[:, :, :1], 0.5 * (rest[:, :, 0::2] + rest[:, :, 1::2])], dim=2)
            else:
                x = 0.5 * (x[:, :, 0::2] + x[:, :, 1::2])
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample3D(nn.Module):
    """Nearest x2 upsample (temporal keeps a causal-odd first frame single),
    then a 3x3 conv."""

    def __init__(self, ch: int, compress_time: bool, dtype=torch.float32):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv3d(ch, ch, (1, 3, 3), padding=(0, 1, 1), dtype=dtype)

    def forward(self, x):
        t = x.shape[2]

        def up_hw(z):
            return z.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)

        if self.compress_time and t > 1:
            if t % 2 == 1:
                x = torch.cat([up_hw(x[:, :, :1]),
                               up_hw(x[:, :, 1:].repeat_interleave(2, dim=2))], dim=2)
            else:
                x = up_hw(x.repeat_interleave(2, dim=2))
        else:
            x = up_hw(x)
        return self.conv(x)


class Encoder3D(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chans, g, dt = cfg.block_out_channels, cfg.norm_num_groups, cfg.dtype
        self.conv_in = CausalConv3d(cfg.in_channels, chans[0], dtype=dt)
        prev = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                setattr(self, f"down_{i}_res_{j}", ResnetBlock3D(prev, ch, g, dtype=dt))
                prev = ch
            if i < len(chans) - 1:
                setattr(self, f"down_{i}_downsample",
                        Downsample3D(ch, i < cfg.temporal_compress_level, dtype=dt))
        for j in range(2):
            setattr(self, f"mid_res_{j}", ResnetBlock3D(chans[-1], chans[-1], g, dtype=dt))
        self.norm_out = GroupNorm32(g, chans[-1])
        self.conv_out = CausalConv3d(chans[-1], 2 * cfg.latent_channels, dtype=dt)

    def forward(self, x, cache: Optional[Cache]):
        cfg = self.cfg
        chans = cfg.block_out_channels
        h = self.conv_in(x, cache)
        for i in range(len(chans)):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, None, cache)
            if i < len(chans) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        for j in range(2):
            h = getattr(self, f"mid_res_{j}")(h, None, cache)
        return self.conv_out(F.silu(self.norm_out(h)), cache)


class Decoder3D(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chans = tuple(reversed(cfg.block_out_channels))
        g, dt, zc = cfg.norm_num_groups, cfg.dtype, cfg.latent_channels
        self.conv_in = CausalConv3d(zc, chans[0], dtype=dt)
        for j in range(2):
            setattr(self, f"mid_res_{j}", ResnetBlock3D(chans[0], chans[0], g, zc, dtype=dt))
        prev = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{i}_res_{j}", ResnetBlock3D(prev, ch, g, zc, dtype=dt))
                prev = ch
            if i < len(chans) - 1:
                setattr(self, f"up_{i}_upsample",
                        Upsample3D(ch, i < cfg.temporal_compress_level, dtype=dt))
        self.norm_out = SpatialNorm3D(chans[-1], zc, g, dtype=dt)
        self.conv_out = CausalConv3d(chans[-1], cfg.out_channels, dtype=dt)

    def forward(self, z, cache: Optional[Cache]):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        h = self.conv_in(z, cache)
        for j in range(2):
            h = getattr(self, f"mid_res_{j}")(h, z, cache)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h, z, cache)
            if i < n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h, z, cache)), cache)


class AutoencoderKLCogVideoX(nn.Module):
    """Encoder + decoder; `encode` / `decode` take and return [B, T, H, W, C]
    and thread the conv-cache dict."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder3D(cfg)
        self.decoder = Decoder3D(cfg)
        for name, mod in self.named_modules():
            if isinstance(mod, CausalConv3d):
                mod.cache_key = name

    def encode(self, x, cache: Optional[Cache] = None):
        moments = self.encoder(x.permute(0, 4, 1, 2, 3), cache)
        return moments.permute(0, 2, 3, 4, 1), cache

    def decode(self, z, cache: Optional[Cache] = None):
        out = self.decoder(z.permute(0, 4, 1, 2, 3), cache)
        return out.permute(0, 2, 3, 4, 1), cache


def sample_latent(moments: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """DiagonalGaussian sample with the given standard-normal ``noise``, or the
    mode when ``noise`` is None. moments: [..., 2C]."""
    mean, logvar = torch.chunk(moments, 2, dim=-1)
    if noise is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return mean + std * noise


def _frame_batches(num_frames: int, batch: int):
    """Reference frame-batch split: the first batch gets batch + remainder."""
    if num_frames <= 1 or num_frames <= batch:
        return [(0, num_frames)]
    rem = num_frames % batch
    return [(batch * i + (0 if i == 0 else rem), batch * (i + 1) + rem)
            for i in range(num_frames // batch)]


class VAERunner:
    """Frame-batched and tiled encode/decode around the module: 8 pixel / 2
    latent frames per batch with the conv cache carried between batches,
    spatial tiles blended over their overlap (the reference's surface)."""

    def __init__(self, config: VAEConfig, model: AutoencoderKLCogVideoX, use_tiling: bool = False,
                 tile_sample_min_height: Optional[int] = None,
                 tile_sample_min_width: Optional[int] = None):
        self.config = config
        self.model = model
        self.use_tiling = use_tiling
        self.auto_tile_decode = True
        self.num_sample_frames_batch_size = 8
        self.num_latent_frames_batch_size = 2  # semantic: GroupNorm stats span a batch
        self.nf_per_chunk = 13
        self.tile_sample_min_height = tile_sample_min_height or config.sample_height // 2
        self.tile_sample_min_width = tile_sample_min_width or config.sample_width // 2
        self.tile_overlap_factor_height = 1 / 6
        self.tile_overlap_factor_width = 1 / 5
        sc = config.spatial_compression_ratio
        self.tile_latent_min_height = self.tile_sample_min_height // sc
        self.tile_latent_min_width = self.tile_sample_min_width // sc

    @torch.no_grad()
    def _encode_frames(self, x):
        cache: Cache = {}
        outs = [self.model.encode(x[:, s:e], cache)[0]
                for s, e in _frame_batches(x.shape[1], self.num_sample_frames_batch_size)]
        return torch.cat(outs, dim=1)

    def encode(self, x):
        """x: [B, F, H, W, 3] -> moments [B, f, h, w, 2C]."""
        if self.use_tiling and (x.shape[2] > self.tile_sample_min_height
                                or x.shape[3] > self.tile_sample_min_width):
            return self._tiled_encode(x)
        return self._encode_frames(x)

    @torch.no_grad()
    def _decode_frames(self, z):
        cache: Cache = {}
        outs = [self.model.decode(z[:, s:e], cache)[0]
                for s, e in _frame_batches(z.shape[1], self.num_latent_frames_batch_size)]
        return torch.cat(outs, dim=1)

    @torch.no_grad()
    def _decode_frames_chunked(self, z):
        """Tiled-decode frame layout: 13-latent chunks, each frame-batched
        2+rem, the conv cache carried across all chunks of one tile."""
        nf = self.nf_per_chunk
        cache: Cache = {}
        outs = []
        for c0 in range(0, z.shape[1], nf):
            chunk_f = min(nf, z.shape[1] - c0)
            for s, e in _frame_batches(chunk_f, self.num_latent_frames_batch_size):
                outs.append(self.model.decode(z[:, c0 + s:c0 + e], cache)[0])
        return torch.cat(outs, dim=1)

    def decode(self, z):
        """z: [B, f, h, w, C] -> [B, F, H, W, 3]."""
        big = z.shape[2] * z.shape[3] >= 2400
        if (self.use_tiling or (self.auto_tile_decode and big)) and (
                z.shape[2] > self.tile_latent_min_height or z.shape[3] > self.tile_latent_min_width):
            return self._tiled_decode(z)
        return self._decode_frames(z)

    @staticmethod
    def _blend_v(a, b, extent: int):
        extent = min(a.shape[2], b.shape[2], extent)
        if extent <= 0:
            return b
        w = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent).reshape(
            1, 1, extent, 1, 1)
        blended = a[:, :, a.shape[2] - extent:] * (1 - w) + b[:, :, :extent] * w
        return torch.cat([blended.to(b.dtype), b[:, :, extent:]], dim=2)

    @staticmethod
    def _blend_h(a, b, extent: int):
        extent = min(a.shape[3], b.shape[3], extent)
        if extent <= 0:
            return b
        w = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent).reshape(
            1, 1, 1, extent, 1)
        blended = a[:, :, :, a.shape[3] - extent:] * (1 - w) + b[:, :, :, :extent] * w
        return torch.cat([blended.to(b.dtype), b[:, :, :, extent:]], dim=3)

    def _tiled(self, x, tile_h, tile_w, overlap_h, overlap_w, blend_h, blend_w, limit_h,
               limit_w, fn, out_h, out_w):
        rows = [[fn(x[:, :, i:i + tile_h, j:j + tile_w]) for j in range(0, x.shape[3], overlap_w)]
                for i in range(0, x.shape[2], overlap_h)]
        result_rows = []
        for i, row in enumerate(rows):
            result_row = []
            for j, tile in enumerate(row):
                if i > 0:
                    tile = self._blend_v(rows[i - 1][j], tile, blend_h)
                if j > 0:
                    tile = self._blend_h(row[j - 1], tile, blend_w)
                rows[i][j] = tile  # the reference blends in place
                result_row.append(tile[:, :, :limit_h, :limit_w])
            result_rows.append(torch.cat(result_row, dim=3))
        return torch.cat(result_rows, dim=2)[:, :, :out_h, :out_w]

    def _tiled_encode(self, x):
        overlap_h = int(self.tile_sample_min_height * (1 - self.tile_overlap_factor_height))
        overlap_w = int(self.tile_sample_min_width * (1 - self.tile_overlap_factor_width))
        blend_h = int(self.tile_latent_min_height * self.tile_overlap_factor_height)
        blend_w = int(self.tile_latent_min_width * self.tile_overlap_factor_width)
        sc = self.config.spatial_compression_ratio
        return self._tiled(x, self.tile_sample_min_height, self.tile_sample_min_width, overlap_h,
                           overlap_w, blend_h, blend_w, self.tile_latent_min_height - blend_h,
                           self.tile_latent_min_width - blend_w, self._encode_frames,
                           x.shape[2] // sc, x.shape[3] // sc)

    def _tiled_decode(self, z):
        overlap_h = int(self.tile_latent_min_height * (1 - self.tile_overlap_factor_height))
        overlap_w = int(self.tile_latent_min_width * (1 - self.tile_overlap_factor_width))
        blend_h = int(self.tile_sample_min_height * self.tile_overlap_factor_height)
        blend_w = int(self.tile_sample_min_width * self.tile_overlap_factor_width)
        sc = self.config.spatial_compression_ratio
        return self._tiled(z, self.tile_latent_min_height, self.tile_latent_min_width, overlap_h,
                           overlap_w, blend_h, blend_w, self.tile_sample_min_height - blend_h,
                           self.tile_sample_min_width - blend_w, self._decode_frames_chunked,
                           z.shape[2] * sc, z.shape[3] * sc)
