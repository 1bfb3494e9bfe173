"""GPU smoke of the PyTorch/CUDA port (`tokensgen_tpu_torch`) on one H100.

    python3 chip_smoke.py                  # every phase, as a CI smoke
    python3 chip_smoke.py --phases kernels # a subset (no final result line)

Phases, each printing its own lines:
  env     card name and power limit (nvidia-smi), torch / CUDA versions;
          TF32 is switched off for matmuls and convolutions in every phase
  build   nvcc builds the attention kernels from kernels/csrc (timed)
  kernels K1-K4 at the edit path's production shapes against their plain
          PyTorch versions: error, kernel and plain times (CUDA events)
  dit     one full-width DiT forward (CogVideoX-5b, 42 layers, VIP "1", B=2),
          timed, then a second one traced with torch.profiler (device time
          by kernel group, idle share; trace in build/traces/)
  edit    the edit path end to end through infer.build_pipeline and
          To2VPipeline.generate at full width (1 chunk, 13 steps, 1 partition)

The last two lines are a JSON object of the kernels and their measurements,
and the result line ``{"ok": true, "device": {...}}``. Any failed phase
raises and the script exits non-zero. It refuses to run without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "kernels", "dit", "edit")

# A kernel agrees with its plain version (same bf16 inputs; the plain version
# keeps f32 where the kernel rounds the prologued q, with log2 e folded in, and
# p to bf16) when, over its whole output,
#   ||out - ref|| / ||ref|| <= REL_L2_BOUND  and  max|out - ref| <= MAX_ABS_REL * max|ref|.
# The measured errors are ~3e-3 relative L2 (mostly one-ulp disagreements of
# the bf16 output) and one bf16 ulp at the output's largest magnitude. The
# bounds stay well under what a wrong kernel gives: dropping the ragged last kv
# tile (48, 32, 16 and 14 keys at the four shapes) moves the output by
# sqrt(dropped / Skv) relative, 3-26%. Each kernel phase checks that this
# planted fault fails the bounds.
REL_L2_BOUND = 1e-2
MAX_ABS_REL = 2.0 ** -5  # 4-8 bf16 ulps at the output's largest magnitude
KV_TILE = 64  # the kernels' kv tile (csrc BN)

KERNELS = {
    # entry point: (TPU kernel it replaces)
    "fused_attention_joint": "tokensgen_tpu/kernels/attention.py:586",
    "fused_attention_cross_smallkv": "tokensgen_tpu/kernels/attention.py:922",
    "fused_attention_cross_smallq": "tokensgen_tpu/kernels/attention.py:1048",
    "flash_attention_bhsd": "tokensgen_tpu/kernels/attention.py:54",
}
SOURCE = "tokensgen_tpu_torch/kernels/csrc/attention.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def _cuda_time_ms(fn, runs: int) -> float:
    """Median over ``runs`` of one call's device time (CUDA events), after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------- phases


def phase_env(state: dict) -> None:
    import torch

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    state["smi"] = smi.stdout.strip().splitlines()[0]
    log(f"[env] nvidia-smi: {state['smi']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[env] TF32 off for matmuls and convolutions (allow_tf32=False)")
    state["device"] = torch.device("cuda", 0)
    state["kind"] = torch.cuda.get_device_name(0)
    state["count"] = torch.cuda.device_count()
    log(f"[env] device 0: {state['kind']} (count {state['count']})")


def phase_build(state: dict) -> None:
    from tokensgen_tpu_torch.kernels import attention as A

    t0 = time.perf_counter()
    path = A.build_kernels(force=True)
    dt = time.perf_counter() - t0
    log(f"[build] nvcc {' '.join(A.NVCC_FLAGS)} -> {os.path.relpath(path, REPO)} "
        f"in {dt:.1f} s")
    for line in A._Library.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def _rope_tables(d, nf, gh, gw, device, offset=0.0):
    import numpy as np

    from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2

    return get_3d_rotary_pos_embed_v2(
        d, np.arange(nf, dtype=np.float32) + offset, np.arange(gh, dtype=np.float32),
        np.arange(gw, dtype=np.float32), device=device)


def agreement(out, ref):
    """(relative L2 error, max abs error, max abs bound) of ``out`` against ``ref``."""
    diff = out.float() - ref.float()
    ref_f = ref.float()
    rel = (diff.norm() / ref_f.norm()).item()
    return rel, diff.abs().max().item(), MAX_ABS_REL * ref_f.abs().max().item()


def _agrees(rel, max_err, max_bound):
    return rel <= REL_L2_BOUND and max_err <= max_bound


def _compare(name, kernel_fn, plain_fn, state, fault_fn=None, runs=5, plain_runs=3,
             check_only=False):
    """Kernel vs plain version: error within the bounds, then both timed.
    ``fault_fn`` is a deliberately wrong plain version that must fail the bounds."""
    import torch

    out = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    torch.cuda.synchronize()
    rel, max_err, max_bound = agreement(out, ref)
    finite = bool(torch.isfinite(out).all().item())
    ok = finite and _agrees(rel, max_err, max_bound)
    msg = (f"[kernels] {name}: shape {tuple(out.shape)} rel_l2_err {rel:.3e} "
           f"(bound {REL_L2_BOUND:g}) max_abs_err {max_err:.3e} (bound {max_bound:.3e}) "
           f"finite {finite}")
    if check_only:
        log(msg)
    else:
        ms = _cuda_time_ms(kernel_fn, runs)
        plain_ms = _cuda_time_ms(plain_fn, plain_runs)
        log(f"{msg} kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        state.setdefault("kernel_rows", {})[name] = {
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    if fault_fn is not None:
        f_rel, f_max, f_bound = agreement(fault_fn(), ref)
        log(f"[kernels] {name}[planted fault: last ragged kv tile dropped]: rel_l2_err "
            f"{f_rel:.3e} max_abs_err {f_max:.3e}: "
            f"{'passes (bounds too loose)' if _agrees(f_rel, f_max, f_bound) else 'fails, as it must'}")
        if _agrees(f_rel, f_max, f_bound):
            raise RuntimeError(f"{name}: the bounds do not catch a dropped ragged kv tile")
    return max_err


def kernel_cases(device, text=226, nf=13, gh=30, gw=45, heads=48, batch=2,
                 vip_t=5, vq_h=8, vq_w=12, rs_heads=16, rs_lat=384, seed=0):
    """The four kernels' inputs at the edit path's shapes (defaults: production
    CogVideoX-5b at 720x480, 13 latent frames, VIP func_type "1")."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    d = 64
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16, std=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * std).to(dtype)

    sv = nf * gh * gw
    lv = vip_t * vq_h * vq_w
    tv = text + sv
    hd = heads * d
    img = _rope_tables(d, nf, gh, gw, device)
    cond = _rope_tables(d, vip_t, vq_h, vq_w, device, offset=1000.0)
    g = 1.0 + randn(d, dtype=torch.float32, std=0.1)
    bb = randn(d, dtype=torch.float32, std=0.1)
    scale = d ** -0.5
    base_segs = [(None, text), (img, sv)]
    cases = {}
    # K1: joint self-attention over [text || video]
    q, k, v = randn(batch, tv, hd), randn(batch, tv, hd), randn(batch, tv, hd)
    cases["fused_attention_joint"] = dict(
        q=q, k=k, v=v, tabs_q=A.make_prologue(d, base_segs, g, bb, fold=scale),
        tabs_k=A.make_prologue(d, base_segs, g, bb), key_bias=None, heads=heads)
    # K2: text_video -> vip
    segs = [(None, text), (img, sv), (cond, lv)]
    vtq = A.make_prologue(d, segs, g, bb, fold=scale)
    vtk = A.make_prologue(d, segs, g, bb)
    kv2, vv2 = randn(batch, lv, hd), randn(batch, lv, hd)
    cases["fused_attention_cross_smallkv"] = dict(
        q=q, k=kv2, v=vv2, tabs_q=A.slice_tabs(vtq, 0, tv),
        tabs_k=A.slice_tabs(vtk, tv, tv + lv), key_bias=None, heads=heads)
    # K3: vip -> [text_video || vip]
    q3 = randn(batch, lv, hd)
    cases["fused_attention_cross_smallq"] = dict(
        q=q3, k=torch.cat([k, kv2], 1), v=torch.cat([v, vv2], 1),
        tabs_q=A.slice_tabs(vtq, tv, tv + lv), tabs_k=vtk, key_bias=None, heads=heads)
    # K4: resampler Perceiver attention, [B, H, S, D], prologue applied outside
    cases["flash_attention_bhsd"] = dict(
        q=randn(1, rs_heads, rs_lat, d), k=randn(1, rs_heads, sv + rs_lat, d),
        v=randn(1, rs_heads, sv + rs_lat, d), scale=scale)
    return cases


def run_kernel(name, c):
    from tokensgen_tpu_torch.kernels import attention as A

    if name == "flash_attention_bhsd":
        return A.flash_attention_bhsd(c["q"], c["k"], c["v"], None, c["scale"])
    return getattr(A, name)(c["q"], c["k"], c["v"], c["tabs_q"], c["tabs_k"],
                            c["key_bias"], c["heads"])


def run_plain(name, c, kv_len=None):
    """The plain version of kernel ``name``; with ``kv_len``, over the first
    ``kv_len`` keys only (the planted fault)."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    q, k, v, bias = c["q"], c["k"], c["v"], c.get("key_bias")
    four_d = name == "flash_attention_bhsd"
    skv = k.shape[2] if four_d else k.shape[1]
    n = skv if kv_len is None else kv_len
    if bias is None:
        bias = torch.zeros(k.shape[0], skv, device=q.device)
    bias = bias[:, :n]
    if four_d:
        return A.attention_plain(q, k[:, :, :n], v[:, :, :n], bias, c["scale"])
    return A._fused_plain_merged(q, k[:, :n], v[:, :n], bias, c["tabs_q"],
                                 A.slice_tabs(c["tabs_k"], 0, n), c["heads"], 1e-6, True, True)


def _without_ragged_tile(name, c):
    skv = c["k"].shape[2 if name == "flash_attention_bhsd" else 1]
    dropped = skv % KV_TILE
    if dropped == 0:
        raise RuntimeError(f"{name}: Skv {skv} has no ragged kv tile to drop")
    return lambda: run_plain(name, c, kv_len=skv - dropped)


def phase_kernels(state: dict) -> None:
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    dev = state["device"]
    cases = kernel_cases(dev)
    for name in KERNELS:
        c = cases[name]
        _compare(name, lambda: run_kernel(name, c), lambda: run_plain(name, c), state,
                 fault_fn=_without_ragged_tile(name, c))
    # K1 with per-sample (batched) tables and a key-bias mask
    c = dict(cases["fused_attention_joint"])
    b = c["q"].shape[0]
    s = c["k"].shape[1]
    perturb = torch.linspace(0.9, 1.1, b, device=dev)[:, None, None]
    c["tabs_q"] = tuple(t[None].expand(b, *t.shape) * perturb for t in c["tabs_q"][:3]) + (
        c["tabs_q"][3],)
    c["tabs_k"] = tuple(t[None].expand(b, *t.shape).contiguous() for t in c["tabs_k"][:3]) + (
        c["tabs_k"][3],)
    bias = torch.zeros(b, s, device=dev)
    bias[0, s - 1000:] = -1e9
    bias[1, :3000] = -1e9
    c["key_bias"] = bias
    _compare("fused_attention_joint[batched tables, key bias]",
             lambda: run_kernel("fused_attention_joint", c),
             lambda: run_plain("fused_attention_joint", c), state, check_only=True)
    # K1 rows whose every score is far negative (q = -k, LayerNorm gain 50):
    # the online max keeps them finite and exact
    gen = torch.Generator(device=dev).manual_seed(1)
    d, h, s = 64, 4, 1024
    base = torch.randn(1, 1, h * d, generator=gen, device=dev)
    k = (base + 1e-3 * torch.randn(1, s, h * d, generator=gen, device=dev)).bfloat16()
    v = torch.randn(1, s, h * d, generator=gen, device=dev).bfloat16()
    gain = torch.full((d,), 50.0, device=dev)
    zero = torch.zeros(d, device=dev)
    c = dict(q=-k, k=k, v=v, heads=h, key_bias=None,
             tabs_q=A.make_prologue(d, [(None, s)], gain, zero, fold=d ** -0.5),
             tabs_k=A.make_prologue(d, [(None, s)], gain, zero))
    out = run_kernel("fused_attention_joint", c)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all().item()):
        raise RuntimeError("fused_attention_joint: non-finite output on all-negative rows")
    log("[kernels] fused_attention_joint[all-negative score rows]: finite")
    del cases
    torch.cuda.empty_cache()


# the edit path as `infer.py --config tokensgen_tpu/configs/infer_edit.yaml`
# runs it, at full width, with these listed cuts and port settings
EDIT_CONFIG = "tokensgen_tpu/configs/infer_edit.yaml"
EDIT_OVERRIDES = {
    "quant": None,  # bf16, the reference precision (int8 modes not ported)
    "allow_hash_text_encoder": True,  # no T5 weights or tokenizer in the repo
    "num_inference_steps": 13,  # cut from 52; FIFO needs steps >= 13 latent frames
    "sampling_params.num_partitions": 1,  # cut from 4: 2 lookahead rank windows
    "input_config.edit_item_1.params.max_num_chunks": 1,  # cut from 12
}


def _edit_config():
    from tokensgen_tpu_torch.utils.config import load_config

    return load_config(os.path.join(REPO, EDIT_CONFIG), EDIT_OVERRIDES)


def _small_reference_check(dev) -> None:
    """A 2-layer, head-dim-64 bf16 DiT with the VIP branch, one forward with
    the same weights and inputs on the host (plain attention) and on the
    card (the kernels): the outputs must agree to bf16 accuracy."""
    import copy

    import numpy as np
    import torch

    from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2
    from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig, VIPConfig
    from tokensgen_tpu_torch.utils.params import init_params_

    vc = VIPConfig(output_dim=64, num_temporal_queries=2, num_height_queries=4,
                   num_width_queries=6, length=3 * 4 * 6)
    cfg = DiTConfig.tiny(vip=vc, attention_head_dim=64, num_attention_heads=2,
                         sample_height=16, sample_width=24, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    cpu_model = init_params_(CogVideoXTransformer(cfg), gen).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    f = 3
    x = torch.randn(1, f, 16, 16, 24, generator=gen)
    text = torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim, generator=gen)
    vip = torch.randn(1, 3, 64, 4, 6, generator=gen)
    t = torch.tensor([[700, 650, 600]])
    img = get_3d_rotary_pos_embed_v2(64, np.arange(f), np.arange(8), np.arange(12))
    cond = get_3d_rotary_pos_embed_v2(64, np.arange(3) + 1000.0, np.arange(4), np.arange(6))

    def run(model, device):
        mv = lambda r: tuple(z.to(device) for z in r)  # noqa: E731
        with torch.no_grad():
            return model(x.to(device), text.to(device), t.to(device), vip.to(device),
                         mv(img), mv(img), mv(cond), 0.6).float().cpu()

    ref, out = run(cpu_model, "cpu"), run(gpu_model, dev)
    rel = ((out - ref).norm() / ref.norm()).item()
    log(f"[dit] small-input reference check (2 layers, d=64, bf16, host plain attention "
        f"vs card kernels): relative L2 error {rel:.3e} (bound 1e-2)")
    if not (rel < 1e-2 and torch.isfinite(out).all()):
        raise RuntimeError("the card's DiT forward disagrees with the host reference")


def phase_dit(state: dict) -> None:
    import torch

    from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2
    from tokensgen_tpu_torch.infer import build_pipeline, build_text_encoder
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.pipelines.to2v import apply_patch_proj

    dev = state["device"]
    _small_reference_check(dev)
    cfg = _edit_config()
    t0 = time.perf_counter()
    pipe, dcfg = build_pipeline(cfg, smoke=False, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.dit.parameters())
    log(f"[dit] build_pipeline (random weights made on the card): "
        f"{time.perf_counter() - t0:.1f} s, DiT {n_params / 1e9:.3f} B parameters, "
        f"{dcfg.num_layers} layers, {dcfg.num_attention_heads} heads x "
        f"{dcfg.attention_head_dim}")
    state["pipe"] = pipe
    pc = pipe.cfg
    nf, h, w = pc.nf_latent, pc.height // 8, pc.width // 8
    gen = torch.Generator(device=dev).manual_seed(7)
    text = build_text_encoder(cfg, smoke=False)(["a prompt", ""]).to(dev)
    latents = torch.randn(2, nf, 16, h, w, generator=gen, device=dev)
    img_rope, smp_rope = pipe.resampler_ropes()
    n_vip = min(pipe.resampler_config.num_temporal_queries + 1, nf)
    img_t, img_h, img_w, cond_t, cond_h, cond_w = pipe.vip_grids(1)
    d = dcfg.attention_head_dim
    vip_img = get_3d_rotary_pos_embed_v2(d, img_t[:nf], img_h, img_w, device=dev)
    vip_cond = get_3d_rotary_pos_embed_v2(d, cond_t[:n_vip], cond_h, cond_w, device=dev)
    base_rope = pipe.base_image_rope()
    timestep = torch.full((2,), 999, dtype=torch.int64, device=dev)

    def forward():
        # VIP tokens as the edit path makes them: patch conv + resampler over
        # two chunks of latents (cond + its repeated-last-frame pad chunk)
        with torch.no_grad():
            toks = [pipe.resampler(apply_patch_proj(dcfg, pipe.dit.patch_embed.proj,
                                                    latents[:1]), img_rope, smp_rope)
                    for _ in range(2)]
            vip = torch.cat(toks, dim=1)[:, :n_vip].expand(2, -1, -1, -1, -1)
            return vip, pipe.dit(latents, text, timestep, vip, base_rope, vip_img, vip_cond,
                                 pc.vip_scale)

    forward()  # warm-up (cuBLAS / cuDNN handles, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    vip, out = forward()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = A.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    finite = bool(torch.isfinite(out).all().item())
    log(f"[dit] full-width forward (resampler x2 + DiT, B=2, {nf}x{h}x{w} latents, "
        f"{dcfg.max_text_seq_length} text + {nf * (h // 2) * (w // 2)} video + "
        f"{vip.shape[1] * vip.shape[3] * vip.shape[4]} vip tokens): {dt:.3f} s, peak {peak:.2f} GiB, output "
        f"{tuple(out.shape)} finite {finite}")
    log(f"[dit] kernel launches in that forward: {json.dumps(counts)}")
    if not finite or tuple(out.shape) != (2, nf, 16, h, w):
        raise RuntimeError("the full-width DiT forward is not finite or has the wrong shape")
    if min(counts.values()) <= 0:
        raise RuntimeError(f"a kernel was not launched by the DiT forward: {counts}")
    del out
    _profile(forward)


def phase_edit(state: dict) -> None:
    import numpy as np
    import torch

    from tokensgen_tpu_torch.infer import build_pipeline, build_text_encoder
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.sampling.base import generator_noise
    from tokensgen_tpu_torch.utils.config import input_items

    dev = state["device"]
    cfg = _edit_config()
    pipe = state.get("pipe")
    if pipe is None:
        pipe, _ = build_pipeline(cfg, smoke=False, device=dev)
    item = input_items(cfg)[0]
    num_chunks = min(item.get("max_num_chunks", 2), item.get("max_num_chunks_w_fifo", 25))
    pc = pipe.cfg
    log(f"[edit] {EDIT_CONFIG} with {json.dumps(EDIT_OVERRIDES)}: {pc.width}x{pc.height}, "
        f"{pc.num_frames_per_chunk} frames/chunk, {num_chunks} chunk, "
        f"{pc.num_inference_steps} steps, {pc.num_partitions} partition")
    enc = build_text_encoder(cfg, smoke=False)
    prompt = enc([item.get("prompt", "")])
    negative = enc([""])
    # synthetic source video, as infer.py makes one under --smoke
    rng0 = np.random.default_rng(0)
    frames = torch.from_numpy(rng0.uniform(
        -1, 1, size=(1, num_chunks * pc.num_frames_per_chunk, pc.height, pc.width, 3)
    ).astype(np.float32))
    noise = generator_noise(torch.Generator(device=dev).manual_seed(int(cfg.get("seed", 42))))
    timings: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.generate(prompt, negative, frames=frames, num_chunks=num_chunks, noise_fn=noise,
                        timings=timings)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    state["launches"] = A.launch_counts()
    log(f"[edit] generate: {total:.1f} s; phases (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
        + f"; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"[edit] kernel launches on the main path: {json.dumps(state['launches'])}")
    nf = pc.nf_latent
    want = {"latents": (1, num_chunks * nf, 16, pc.height // 8, pc.width // 8),
            "orig_latents": (1, nf, 16, pc.height // 8, pc.width // 8),
            "video": (1, num_chunks * pc.num_frames_per_chunk, pc.height, pc.width, 3),
            "orig_video": (1, pc.num_frames_per_chunk, pc.height, pc.width, 3)}
    for key, shape in want.items():
        x = out[key]
        finite = bool(torch.isfinite(x).all().item())
        log(f"[edit] {key}: shape {tuple(x.shape)} finite {finite} "
            f"mean {x.float().mean().item():.4f} std {x.float().std().item():.4f}")
        if tuple(x.shape) != shape or not finite:
            raise RuntimeError(f"edit output {key}: expected finite {shape}")


_KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel name), first match wins
    ("attention K1 (joint_kernel)", ("joint_kernel",)),
    ("attention K2 (smallkv_kernel)", ("smallkv_kernel",)),
    ("attention K3 (smallq_kernel)", ("smallq_kernel",)),
    ("attention K4 (bhsd_kernel)", ("bhsd_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "nvjet")),
    ("convolution (cuDNN)", ("conv", "implicit", "winograd")),
    ("norm / reduce", ("norm", "reduce", "Reduce")),
    ("copy / cat", ("copy", "Copy", "cat", "Cat")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def _profile(forward) -> None:
    """A second, traced forward (the timed one runs with tracing off):
    device time by kernel group and the device's idle share; the trace and
    the top-kernel table go to build/traces/."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = next((g for g, keys in _KERNEL_GROUPS if any(k in evt.key for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
    busy = sum(groups.values())
    log(f"[dit] traced forward: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{max(0.0, 1 - busy / wall):.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[dit]   {g}: {ms:.1f} ms ({ms / busy:.1%})")
    out_dir = os.path.join(REPO, "build", "traces")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "dit_forward_trace.json"))
    with open(os.path.join(out_dir, "dit_forward_top_kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))


# ----------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    if not os.path.isdir(os.path.join(REPO, "tokensgen_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, REPO)
    state: dict = {}
    phase_env(state)  # always: it refuses to go on without a card
    for name in phases:
        if name == "env":
            continue
        t0 = time.perf_counter()
        globals()[f"phase_{name}"](state)
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s")
    if phases != list(PHASES):
        log("partial run: no result line")
        return 0
    rows = []
    launches = state["launches"]
    for name, replaces in KERNELS.items():
        r = state["kernel_rows"][name]
        rows.append({"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"]})
    missing = [r["name"] for r in rows if r["launches"] <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    print(state["smi"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                             "count": state["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
