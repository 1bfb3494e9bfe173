"""FIFO diagonal denoising on one device (port of the single-device path of
`tokensgen_tpu/sampling/fifo.py`).

The queue [B, r_nf + steps, C, H, W], its x0 history and validity, and the
per-position (t, prev_t, next_t) follow the JAX engine exactly: each iteration
runs the lookahead rank windows in turn, merges their write regions into the
queue, emits the frame at ``r_nf``, then shifts and renoises the tail. Ranks
that the adaptive-padding ramp leaves inactive are skipped (the JAX engine's
`lax.cond`). The VIP rotary tables roll with the iteration, built from
tensor grids.

The loop runs on the host, as the JAX engine's ``host_loop=True``: each
iteration's emitted frame (and its ``cache_idx`` tracks) lands on the host
as it is made, ``emit_callback`` sees it there, ``state_callback`` can take a
host snapshot of the queue, and ``resume_from`` continues from one.

Not ported yet: the queue-sharded mesh path (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tokensgen_tpu_torch.core import cfg as cfg_lib
from tokensgen_tpu_torch.core import schedule as S
from tokensgen_tpu_torch.core.rope import Rope, get_3d_rotary_pos_embed_v2_torch
from tokensgen_tpu_torch.sampling.base import NoiseFn, guidance_tables


@dataclasses.dataclass(frozen=True)
class FIFOConfig:
    nf_per_chunk: int = 13
    num_partitions: int = 4
    num_inference_steps: int = 52
    num_frames: int = 52  # output latent frames
    lookahead_denoising: bool = True
    use_adaptive_padding: bool = True
    guidance_scale: float = 6.0
    guidance_scale_img: float = 1.5
    use_dynamic_cfg: bool = False
    use_separate_guidance: bool = False
    do_classifier_free_guidance: bool = True
    stochastic: bool = True
    renoise_timestep: int = 999
    tail_renoise_mode: str = "xt"  # "xt": one-beta renoise; "randn": fresh noise
    vip_rope_dims: Tuple[int, int, int] = (16, 24, 24)
    video_ipadapter_start_frame_idx: int = 1000

    @property
    def l_nf(self) -> int:
        return self.nf_per_chunk - self.nf_per_chunk // 2

    @property
    def r_nf(self) -> int:
        return self.nf_per_chunk // 2

    @property
    def num_ranks(self) -> int:
        return 2 * self.num_partitions if self.lookahead_denoising else self.num_partitions

    @property
    def queue_len(self) -> int:
        return self.r_nf + self.num_inference_steps

    @property
    def num_iterations(self) -> int:
        return self.num_frames + self.num_inference_steps - self.nf_per_chunk


class VIPState(NamedTuple):
    """Extended VIP conditioning (pipeline-prepared, engine-consumed)."""

    image_embeddings: torch.Tensor  # [nB, Fv_ext, Cv, hq, wq] CFG-batched tokens
    image_grid_t_full: torch.Tensor  # [queue_len + num_iterations] rolling grid
    condition_grid_t: torch.Tensor  # [Fv_ext] extended condition grid
    image_grid_h: torch.Tensor
    image_grid_w: torch.Tensor
    condition_grid_h: torch.Tensor
    condition_grid_w: torch.Tensor
    vip_nf_per_chunk: int


class FIFOSeed(NamedTuple):
    fifo_latents: torch.Tensor  # [B, steps, C, H, W] cleanest first
    fifo_old_x0: torch.Tensor
    fifo_old_valid: torch.Tensor  # [steps] bool
    timesteps: np.ndarray  # [steps] descending
    image_rotary_emb: Rope  # rope of one nf-frame window
    vip: Optional[VIPState] = None


class FIFOResult(NamedTuple):
    latents: torch.Tensor  # [B, num_frames, C, H, W] emitted clean frames (host)
    all_emitted: torch.Tensor  # [B, num_iterations, C, H, W] incl. warm-up (host)
    cache_x0: Optional[torch.Tensor] = None  # [n_cache, num_iterations, B, C, H, W] (host)
    cache_valid: Optional[torch.Tensor] = None  # [n_cache, num_iterations] bool


def _position_timesteps(ts: np.ndarray, fcfg: FIFOConfig):
    """Queue-position (t, prev_t, next_t); position 0 is the cleanest."""
    r = fcfg.r_nf
    ft = np.concatenate([ts, np.full(r, ts[-1])])
    fp = np.concatenate([ts[1:], np.full(r + 1, -1)])
    fn = np.concatenate([[-1], ts[:-1], np.full(r, ts[-2])])
    return ft[::-1].copy(), fp[::-1].copy(), fn[::-1].copy()


def prepare_queue(seed: FIFOSeed, fcfg: FIFOConfig):
    """Left-pad the seed with r copies of the cleanest entry."""
    r = fcfg.r_nf
    queue = torch.cat([seed.fifo_latents[:, :1].expand(-1, r, -1, -1, -1), seed.fifo_latents],
                      dim=1).float()
    x0 = torch.cat([seed.fifo_old_x0[:, :1].expand(-1, r, -1, -1, -1), seed.fifo_old_x0],
                   dim=1).float()
    valid = torch.cat([seed.fifo_old_valid[:1].expand(r), seed.fifo_old_valid])
    return queue, x0, valid


def _clamped(start: int, size: int, total: int) -> int:
    """Start of a ``size`` slice clamped into [0, total) (XLA dynamic_slice)."""
    return min(max(start, 0), total - size)


@torch.no_grad()
def fifo_generate(
    model_fn: Callable,
    sched: S.DiffusionSchedule,
    fcfg: FIFOConfig,
    seed: FIFOSeed,
    noise_fn: NoiseFn,
    cache_idx: Tuple[int, ...] = (),
    emit_callback: Optional[Callable] = None,
    state_callback: Optional[Callable] = None,
    resume_from: Optional[dict] = None,
) -> FIFOResult:
    """Run the FIFO loop. ``model_fn(lat_cfg [nB, nf, C, H, W], t2d [nB, nf],
    vip_kwargs | None) -> noise_pred`` CFG-batches its closed-over
    conditioning, uncond first. ``noise_fn`` supplies the DPM noise
    (tags ``("fifo", iteration, rank, 0 | 1)``) and the tail renoise
    (``("tail", iteration)``).

    ``cache_idx``: output frames whose x0 is tracked over their denoise
    trajectory (`FIFOResult.cache_x0` / ``cache_valid``).

    ``emit_callback(i, emitted)``: called after iteration ``i`` with its
    emitted frame [B, C, H, W], a host tensor (each one crosses to the host
    as it is made, so the device never holds ``num_iterations`` of them).

    ``state_callback(i, snapshot)``: called after iteration ``i`` with a
    zero-argument thunk returning ``{"iteration": i + 1, "state": (queue,
    x0_buf, x0_valid)}`` as host copies, which stay valid whenever the thunk
    is called and whatever the loop does after (the JAX thunk is only valid
    inside the callback). The ~40 MB copy is made only when it is called.
    Until then the thunk holds that iteration's device tensors, so a caller
    that keeps thunks without calling them keeps ~40 MB of card memory alive
    per iteration: call it inside the callback, or drop it.

    ``resume_from``: a snapshot's value (the port's or the JAX engine's);
    the loop continues from its iteration and, with a ``noise_fn`` whose
    draws depend only on their tags (`sampling.base.keyed_noise`),
    reproduces the uninterrupted run bit for bit. ``all_emitted`` /
    ``latents`` (and the cache tracks) then cover only the resumed
    iterations, as in the JAX engine."""
    nf, r_nf, l_nf = fcfg.nf_per_chunk, fcfg.r_nf, fcfg.l_nf
    R, Q = fcfg.num_ranks, fcfg.queue_len
    steps = fcfg.num_inference_steps
    if steps < nf:
        raise ValueError(
            f"FIFO requires num_inference_steps >= nf_per_chunk ({steps} < {nf}): the "
            f"denoise queue is shorter than one frame window")
    ts = np.asarray(seed.timesteps)
    pos_t, pos_prev, pos_next = _position_timesteps(ts, fcfg)
    start0 = [nf * (r // 2) + r_nf * (r % 2) for r in range(R)]
    mid = [s + (l_nf if r % 2 == 1 else r_nf) for r, s in enumerate(start0)]
    real_end = [s + nf for s in start0]
    g_table = gi_table = None
    if fcfg.use_dynamic_cfg:
        g_table, gi_table = guidance_tables(fcfg.guidance_scale, fcfg.guidance_scale_img,
                                            steps, sched)
    vip = seed.vip
    dt, dh, dw = fcfg.vip_rope_dims

    queue, x0_buf, x0_valid = prepare_queue(seed, fcfg)
    dev = queue.device
    b = queue.shape[0]
    pos = torch.arange(Q, device=dev)

    def window(rid: int, i: int, qs: int):
        """Rank ``rid``'s DPM step on its window -> (start, new_lat, new_x0, mask)."""
        s0, m, re = start0[rid], mid[rid], real_end[rid]
        start = _clamped(max(s0, qs), nf, Q)
        lat = queue[:, start:start + nf]
        old = x0_buf[:, start:start + nf]
        oldv = x0_valid[start:start + nf]
        t_w = torch.from_numpy(pos_t[start:start + nf]).to(dev)
        p_w = torch.from_numpy(pos_prev[start:start + nf]).to(dev)
        n_w = torch.from_numpy(pos_next[start:start + nf]).to(dev)

        vip_kwargs = None
        if vip is not None:
            g0 = _clamped(i + start, nf, vip.image_grid_t_full.shape[0])
            gt = vip.image_grid_t_full[g0:g0 + nf]
            img_rope = get_3d_rotary_pos_embed_v2_torch(
                sum(fcfg.vip_rope_dims), gt, vip.image_grid_h, vip.image_grid_w,
                dim_t=dt, dim_h=dh, dim_w=dw)
            target = gt[:1] + fcfg.video_ipadapter_start_frame_idx
            vs = int(torch.searchsorted(vip.condition_grid_t, target, right=True).item()) - 1
            n_vip = min(vip.vip_nf_per_chunk + 1, nf)
            vs = _clamped(vs, n_vip, vip.condition_grid_t.shape[0])
            cond_rope = get_3d_rotary_pos_embed_v2_torch(
                sum(fcfg.vip_rope_dims), vip.condition_grid_t[vs:vs + n_vip],
                vip.condition_grid_h, vip.condition_grid_w, dim_t=dt, dim_h=dh, dim_w=dw)
            ve = _clamped(vs, n_vip, vip.image_embeddings.shape[1])
            vip_kwargs = {"vip_hidden_states": vip.image_embeddings[:, ve:ve + n_vip],
                          "vip_image_rotary_emb": img_rope,
                          "vip_condition_rotary_emb": cond_rope}

        lat_in = cfg_lib.batch_for_cfg(lat, fcfg.do_classifier_free_guidance,
                                       fcfg.use_separate_guidance)
        t2d = t_w[None].expand(lat_in.shape[0], nf)
        noise_pred = model_fn(lat_in, t2d, vip_kwargs).float()
        if fcfg.do_classifier_free_guidance:
            if g_table is not None:
                g, gi = g_table[t_w], gi_table[t_w]  # per-frame dynamic CFG
            else:
                g, gi = fcfg.guidance_scale, fcfg.guidance_scale_img
            noise_pred = cfg_lib.combine(noise_pred, g, gi, fcfg.use_separate_guidance)

        noise = noise2 = None
        if fcfg.stochastic:
            noise = noise_fn(("fifo", i, rid, 0), lat.shape)
            noise2 = noise_fn(("fifo", i, rid, 1), lat.shape)
        new_lat, new_x0 = S.dpm_step(
            sched, noise_pred, lat, t_w[None].expand(b, nf), p_w[None].expand(b, nf),
            t_back=n_w[None].expand(b, nf), old_pred_original_sample=old,
            old_valid=(oldv & (n_w > 0))[None].expand(b, nf), noise=noise, noise2=noise2)

        clamped = s0 <= qs
        write_lo = max(r_nf, qs) if clamped else m
        write_hi = re if clamped else s0 + nf
        return start, new_lat, new_x0, (pos >= write_lo) & (pos < write_hi)

    start_i = 0
    if resume_from is not None:
        queue, x0_buf, x0_valid = (torch.as_tensor(np.array(x), device=dev)
                                   for x in resume_from["state"])
        start_i = int(resume_from["iteration"])
    cache_q = np.asarray(cache_idx, dtype=np.int64) + (steps - nf) + r_nf
    emitted, cache_x, cache_v = [], [], []
    for i in range(start_i, fcfg.num_iterations):
        qs = (max(0, (steps - l_nf) - i)
              if fcfg.use_adaptive_padding and fcfg.lookahead_denoising else 0)
        sum_l = torch.zeros_like(queue)
        sum_x = torch.zeros_like(queue)
        mask = torch.zeros(Q, dtype=torch.bool, device=dev)
        for rid in range(R):
            if not mid[rid] > qs:
                continue  # inactive during the adaptive-padding ramp
            start, new_lat, new_x0, m_r = window(rid, i, qs)
            mb = m_r[start:start + nf].to(queue.dtype)[None, :, None, None, None]
            sum_l[:, start:start + nf] += new_lat * mb
            sum_x[:, start:start + nf] += new_x0 * mb
            mask |= m_r
        mb = mask[None, :, None, None, None]
        queue = torch.where(mb, sum_l, queue)
        x0_buf = torch.where(mb, sum_x, x0_buf)
        x0_valid = x0_valid | mask
        emitted.append(queue[:, r_nf if fcfg.lookahead_denoising else 0].to("cpu", copy=True))
        if emit_callback is not None:
            emit_callback(i, emitted[-1])
        if len(cache_q):
            q_idx = cache_q - i
            cache_v.append(torch.from_numpy((q_idx >= max(r_nf, qs)) & (q_idx < Q)))
            safe = torch.from_numpy(np.clip(q_idx, 0, Q - 1)).to(dev)
            cache_x.append(x0_buf[:, safe].transpose(0, 1).to("cpu", copy=True))

        tail = queue[:, -1]
        tail_noise = noise_fn(("tail", i), tail.shape)
        if fcfg.tail_renoise_mode == "randn":
            tail = tail_noise
        else:
            tail = S.add_noise_to_xt(
                sched, tail, tail_noise,
                torch.full((b,), fcfg.renoise_timestep, dtype=torch.int64, device=dev))
        queue = torch.cat([queue[:, 1:], tail[:, None]], dim=1)
        x0_buf = torch.cat([x0_buf[:, 1:], torch.zeros_like(x0_buf[:, -1:])], dim=1)
        x0_valid = torch.cat([x0_valid[1:], torch.zeros(1, dtype=torch.bool, device=dev)])
        if state_callback is not None:
            # the loop rebinds these names and never writes into the tensors,
            # so the thunk's copies are of this iteration's state whenever it runs
            def snapshot(j=i, state=(queue, x0_buf, x0_valid)):
                return {"iteration": j + 1,
                        "state": tuple(x.to("cpu", copy=True) for x in state)}

            state_callback(i, snapshot)

    all_emitted = torch.stack(emitted, dim=1)
    caches = ((torch.stack(cache_x, dim=1), torch.stack(cache_v, dim=1)) if cache_x
              else (None, None))
    return FIFOResult(all_emitted[:, steps - nf:], all_emitted, *caches)
