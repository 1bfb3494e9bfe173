"""VAE-latent precompute of the port (counterpart of the JAX package's root
`calculate_vae_latents.py`), the data job behind T2To training:

    python -m tokensgen_tpu_torch.calculate_vae_latents \
        --config tokensgen_tpu/configs/dataprocess_vae_latents.yaml \
        [--num-shards N --shard-index i] [--fit-stats] [--smoke] [--device cpu]

For each video of the MiraData CSV (``train_data_params``: the first window,
no random sampling, no dropout), VAE-encodes each chunk of ``chunk_size``
frames on ``--device`` (the card unless given ``--device cpu``), samples the
latent with noise from a generator seeded by ``i * 100 + chunk`` (``i`` the
row), scales it by the VAE's ``scaling_factor`` and writes
``<latent_output_dir>/<index//1000:09d>/<index>_vae_c<NN>.npy``: float16
[13 * chunks, 16, h, w], which `VAEMiraDataset` of either package reads.
``--num-shards`` / ``--shard-index`` take every N-th row from the i-th.
``--fit-stats`` also writes ``mean_shard{i}.npy`` and ``std_shard{i}.npy``:
per-position mean and standard deviation (float32 [16 * h * w]) over every
latent frame written.

The VAE comes from ``vae_checkpoint``: a converted ``vae.safetensors`` (the
JAX package's param tree) or an HF ``CogVideoX-5b/vae`` directory of
diffusers ``*.safetensors``. Outside ``--smoke`` a run without it, or with a
path that does not exist, is refused: latents of a random VAE are not
training data. ``--smoke`` runs the JAX smoke's tiny VAE (32x48, 9 frames
per chunk) with random weights from ``seed``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from tokensgen_tpu_torch.convert.from_jax import vae_state_dict
from tokensgen_tpu_torch.convert.safetensors_io import load_param_tree
from tokensgen_tpu_torch.convert.torch_weights import read_safetensors_dir, vae_from_diffusers
from tokensgen_tpu_torch.data.mira import ITEM_ERRORS, MiraDataset
from tokensgen_tpu_torch.models.vae3d import (AutoencoderKLCogVideoX, VAEConfig, VAERunner,
                                              sample_latent)
from tokensgen_tpu_torch.utils.config import load_config
from tokensgen_tpu_torch.utils.params import build_on_device, load_on_device

# noise_fn(row, chunk, shape) -> a standard normal tensor of ``shape``
NoiseFn = Callable[[int, int, tuple], torch.Tensor]


def load_vae(path: str, vcfg: VAEConfig, device) -> AutoencoderKLCogVideoX:
    """The VAE of ``vae_checkpoint``: a converted param-tree file, or a
    directory of diffusers ``*.safetensors``."""
    ctor = lambda: AutoencoderKLCogVideoX(vcfg)  # noqa: E731
    if os.path.isfile(path):
        sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in vae_state_dict(load_param_tree(path)).items()}
        return load_on_device(ctor, sd, device)
    if os.path.isdir(path):
        sd = read_safetensors_dir(path)
        if not sd:
            raise FileNotFoundError(f"vae_checkpoint dir has no .safetensors: {path}")
        with torch.device("meta"):
            names = ctor()
        return load_on_device(ctor, vae_from_diffusers(sd, names), device)
    raise FileNotFoundError(f"vae_checkpoint not found: {path} (unset the key or fix the path: "
                            "random-VAE latents are not usable training data)")


def seeded_noise(device) -> NoiseFn:
    """Chunk ``cid`` of row ``i``: a generator on ``device`` seeded by
    ``i * 100 + cid`` (the JAX tool's ``PRNGKey(i * 100 + cid)``)."""
    def draw(i: int, cid: int, shape) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(i * 100 + cid)
        return torch.randn(shape, generator=gen, device=device)
    return draw


@torch.no_grad()
def encode_video_latents(vae: VAERunner, pixels: np.ndarray, nf_px: int, row: int,
                         noise_fn: NoiseFn, device) -> np.ndarray:
    """A video [F, H, W, 3] in [-1, 1] (whole chunks of ``nf_px`` frames) ->
    its scaled latent sample [13 * chunks, 16, h, w] float32 on the host."""
    chunks = pixels.shape[0] // nf_px
    lats = []
    for cid in range(chunks):
        x = torch.from_numpy(pixels[cid * nf_px:(cid + 1) * nf_px][None]).to(device)
        moments = vae.encode(x)
        mean_shape = moments.shape[:-1] + (moments.shape[-1] // 2,)
        lat = sample_latent(moments, noise_fn(row, cid, tuple(mean_shape)))
        lat = lat * vae.config.scaling_factor
        lats.append(lat.permute(0, 1, 4, 2, 3)[0].float().cpu().numpy())
    return np.concatenate(lats, axis=0)


def latent_file(out_dir: str, index: int, chunks: int) -> str:
    return os.path.join(out_dir, f"{index // 1000:09d}", f"{index}_vae_c{chunks:02d}.npy")


def main(argv=None, noise_fn: Optional[NoiseFn] = None) -> List[str]:
    """Runs the tool; returns the latent files written, in row order.
    ``noise_fn`` replaces the seeded noise (tests)."""
    ap = argparse.ArgumentParser(description="VAE-latent precompute (PyTorch/CUDA port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="tiny random VAE, CPU-friendly")
    ap.add_argument("--fit-stats", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the host")

    cfg = load_config(args.config)
    out_dir = cfg.get("latent_output_dir", "./latents")
    os.makedirs(out_dir, exist_ok=True)
    if args.smoke:
        vcfg = VAEConfig.tiny(sample_height=32, sample_width=48)
        height, width, nf_px = 32, 48, 9
    else:
        vcfg = VAEConfig.cogvideox()
        height = cfg.get_path("train_data_params.height", 480)
        width = cfg.get_path("train_data_params.width", 720)
        nf_px = cfg.get_path("train_data_params.chunk_size", 49)

    vae_ckpt = cfg.get("vae_checkpoint")
    if vae_ckpt and not args.smoke:
        model = load_vae(vae_ckpt, vcfg, device)
        print(f"loaded VAE weights from {vae_ckpt}", flush=True)
    elif not args.smoke:
        raise ValueError("no `vae_checkpoint` configured: non-smoke latent precompute requires "
                         "CogVideoX VAE weights (--smoke runs random-init for pipeline tests)")
    else:
        gen = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 42)))
        model = build_on_device(lambda: AutoencoderKLCogVideoX(vcfg), device, gen)
    vae = VAERunner(vcfg, model)
    noise_fn = noise_fn or seeded_noise(device)

    ds = MiraDataset(
        cfg.get_path("train_data_params.csv_file"), cfg.get_path("train_data_params.video_dir"),
        height=height, width=width, sample_fps=cfg.get_path("train_data_params.sample_fps", 10),
        chunk_size=nf_px, max_num_chunks=cfg.get_path("train_data_params.max_num_chunks", 25),
        random_sample=False, i_drop_rate=0, t_drop_rate=0, ti_drop_rate=0)

    written = []
    stats_sum = stats_sq = None
    stats_n = 0
    for i in range(args.shard_index, len(ds), args.num_shards):
        t0 = time.perf_counter()
        try:
            item = ds[i]
        except ITEM_ERRORS as e:
            print(f"[{i}] skipped: {e}", flush=True)
            continue
        t1 = time.perf_counter()
        lat_all = encode_video_latents(vae, item["pixel_values"], nf_px, i, noise_fn, device)
        chunks = item["pixel_values"].shape[0] // nf_px
        path = latent_file(out_dir, item["video_index"], chunks)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, lat_all.astype(np.float16))  # f16 on disk; the datasets read f32
        written.append(path)
        print(f"[{i}] video {item['video_index']}: {lat_all.shape} saved (decode "
              f"{t1 - t0:.2f} s, encode {time.perf_counter() - t1:.2f} s for {chunks} chunks)",
              flush=True)
        if args.fit_stats:
            flat = lat_all.reshape(lat_all.shape[0], -1)
            s, sq = flat.sum(0), (flat ** 2).sum(0)
            stats_sum = s if stats_sum is None else stats_sum + s
            stats_sq = sq if stats_sq is None else stats_sq + sq
            stats_n += flat.shape[0]

    if args.fit_stats and stats_n:
        mean = stats_sum / stats_n
        std = np.sqrt(stats_sq / stats_n - mean ** 2)
        np.save(os.path.join(out_dir, f"mean_shard{args.shard_index}.npy"), mean)
        np.save(os.path.join(out_dir, f"std_shard{args.shard_index}.npy"), std)
    print("done", flush=True)
    return written


if __name__ == "__main__":
    main()
