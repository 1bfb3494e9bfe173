"""GPU smoke of the PyTorch/CUDA port (`tokensgen_tpu_torch`) on one H100.

    python3 chip_smoke.py                  # every phase, as a CI smoke
    python3 chip_smoke.py --phases kernels # a subset (no final result line)

Phases, each printing its own lines:
  env     card name and power limit (nvidia-smi), torch / CUDA versions,
          whether the `tokenizers` and `cv2` packages import; TF32 is switched
          off for matmuls and convolutions in every phase
  build   nvcc builds the four sources of kernels/csrc at once
          (attention.cu, probes.cu, attention_f32.cu, probe_gemm.cu; timed)
          and prints registers and spills per
          instantiation; none may spill; K7's body's SASS (cuobjdump) must
          hold int8 wgmma and no mma.sync and no I2F, T7's and T3a's bf16
          wgmma and no mma.sync; the float32 K4's threads, shared memory
          and resident blocks a SM per head dim, T7's and T3a's threads and
          shared memory
  kernels K1-K4 at the edit path's production shapes, K5 (the attention
          backward) at the training path's, K7 (int8 scores) at the gen
          path's and K6 (fused prologue on [B, H, S, D]) at the T2To
          trainer's, against their plain PyTorch versions: error, planted
          fault, kernel / plain / library times (CUDA events) and bound; the
          lse outputs of K1, K4 and K6; K3 and K4 at forced split counts
          1, 2 and 5 beside their plan's, K1 and K6 at 2 and 5 beside
          theirs (1), with a second planted fault (the last split left out
          of the combine) and each call's device time per kernel (prologue
          pass / body / combine), its kernels checked to fall in their own
          trace group; K2 per kernel and at 1,024-row chunks (4 q tiles a
          block) beside its plan's one wave; K5 per kernel, and whether two
          calls give bit-equal dq; K7 against bf16 K1, its launch geometry
          and at forced split counts 2 and 5 beside its plan's (1), with
          the quantizing pass's time apart; K1 at the T2To
          shape; K4 at head dims 16, 32 and 128 at its row's width; K6 as a
          strided view of merged operands and at head dims 16 and 32; K1
          and K5 at the T2To trainer's shape with its padded-chunk key bias;
          K5 at head dims 16, 32 and 128, and a gradient through K6 + K5
          there against autograd through the plain version; K6 and K5 at
          head dim 128 at the T2To trainer's width (24 heads of 128)
  probes  the probe kernels' CLIs (tokensgen_tpu_torch/tools: T1, T2, T3a,
          T3b, T4a, T4b, T5, T6, T7, T8) at their JAX scripts' shapes, then
          each kernel against its plain version with a planted fault, timed,
          with its bound (T5 at every q block it is built for); the max-free
          ones (T3a-T5) also against the shipped K1, K2 or K3 on the same
          inputs
  dit     one full-width DiT forward (CogVideoX-5b, 42 layers, VIP "1", B=2),
          timed, then a second one traced with torch.profiler (device time
          by kernel group, idle share; trace in build/traces/); then the same
          forward of a w8a8 + quant_attn copy, timed, traced, and its drift
          from the bf16 output
  edit    the edit path end to end through infer.build_pipeline and
          To2VPipeline.generate at full width (1 chunk, 13 steps, 1 partition,
          DiT depth cut to 2 of 42 layers), each FIFO iteration's time
  queue   the same generate from the edit phase's VIP tokens on
          (undecoded) over a queue group of 2 spawned processes sharing the
          card over Gloo (sharding/mesh.py: rank 0 runs every stage but the
          FIFO, each rank one of the FIFO's 2 rank windows, one all-reduce
          an iteration merges them): its latents
          bit-equal to the edit phase's one process, the FIFO iteration's
          time beside one process's, the merge's bytes and time; where 2 or
          more cards are visible, NCCL over 2 of them, and where 4 are, the
          FIFO at 2 partitions (R = 4) on one card and over four, each
          bit-equal to its reference
  variants the rest of single-GPU inference: each variant at a small size
          on the host against the card (VIP func_types "2"-"4", the sincos
          mode, the raw-token mode); the float32 K4 against its plain
          version at DINOv2-large's [49, 16, 257, 64] (timed, bound at the
          float32 peak, float32 SDPA as the library); the q / k / v
          projection of the CogVideoX-5b joint sequence as three GEMMs (the
          port's layout) and as one fused GEMM (the JAX package's
          fuse_qkv), timed; infer_edit.yaml with use_vae_as_encoder false
          through infer.build_pipeline (DINOv2-large, the resampler's input
          at 1,024): the DINOv2 edit path cut as the edit phase's (DiT depth
          2, 13 steps, 1 partition) but 2 chunks, undecoded, with the
          encoder's seconds per chunk and the float32 K4's launches; one
          full-width forward (2 layers) of CogVideoX-5b for each of
          func_types "2"-"4" (the ar context one latent frame) and of
          CogVideoX-2b in the sincos mode, each with its launches held to
          the port's routing and every attention call of its first layer
          held to the plain version on the same card tensors (planted
          fault: the last eighth of the keys dropped)
  load    the loaders on files the phase writes in a temp dir (and removes):
          an HF-layout T5-XXL dir (full width, 2 of 24 layers) read back
          through T5TextEncoder.from_pretrained, bit-equal, timed; the full
          24-layer T5-XXL from a seed encoding the two edit prompts at 226
          tokens (tokenized through tokenizers), timed; the full-width To2V
          DiT (2 of 42 layers, bf16, diffusers names) and resampler read back
          through infer.load_checkpoint_dit, bit-equal, then a VIP encode and
          a CFG forward on the T5 embeddings (K1-K4) bit-equal to the
          in-memory model's; the gen PCA artifacts at T2To's width; a
          49-frame 720x480 mp4 through load_video; and infer.main at --smoke
          geometry on tiny written files (a DiT dir, a T5 dir, a video),
          checking its four outputs; host RSS and device peaks beside each
          time
  gen     the generation path of infer_gen.yaml as shipped (w8a8) with
          quant_attn: T2To tokens, then the To2V render (1 chunk, 13 steps,
          1 partition, render DiT depth cut to 2 of 42 layers, undecoded:
          the serve phase decodes this path); then one T2To stage alone at
          the shipped 24 chunks
  serve   the serving path: serve.build_service on infer_gen.yaml as shipped
          (w8a8, quant_attn off; the edit phase's cuts) behind its threaded
          HTTP server on 127.0.0.1: POST /edit_stream of 2 chunks of
          synthetic 720x480 frames (~406 MB .npy), the request's parse, time
          to the first NDJSON line and the gap to the second, both mp4s read
          back as 49 frames, /health answered within 2 s during the stream;
          /edit with a wrong frame count refused with 400 and no kernel
          launch; /generate_stream of 1 chunk; then in process, undecoded, on
          T2To tokens: the crash-resume drill and stream == one-shot, both
          bit-equal, and a stream closed after its first chunk freeing the
          card within one FIFO iteration
  data    the training data on disk, in build/data_smoke/: a MiraData layout
          (3 mp4s of 10 s at 30 fps, 960x540; a CSV in ISO-8859-1 with a
          non-ASCII caption), a random full-width CogVideoX VAE written as an
          HF vae/ dir, calculate_vae_latents.main(--fit-stats) on the card at
          full width (files, shapes, f16 and finite stats checked, seconds per
          chunk), the latents read back by VAEMiraDataset through the native
          reader (g++ at first use) equal to np.load, and one To2V item's
          host decode timed
  train   2-layer train steps on the card against the host's (heads of 64,
          and the --smoke geometry: the DiT's 2 heads of 16 on K6 / K5, also
          with LoRA), 2 steps of the tiny trainer (--smoke) on the card, one
          step of it with LoRA, Prodigy, a validation render (its mp4 read
          back by cv2, finite metrics) and --profile-steps 1, then 1
          optimizer step of the To2V adapter trainer (train_to2v.To2VTrainer)
          at full width (42 layers, batch 2, 2-chunk 49-frame 720x480) on the
          data phase's videos through MiraDataset and 4 decode threads (a
          second step, cut for the dp phase's time, a traced one and a
          full-width validation render are cut for time); the step's data
          wait, sampled timesteps and mean x0 weight beside its loss
  t2to_train  the T2To trainer (train_t2to.T2ToTrainer): a tiny step (one
          head of 64: K6 forward, K5 backward) on the card against the
          host's, full finetune and LoRA, 2 steps of the tiny trainer on the
          card, then 2 full-finetune optimizer steps at full width (42 layers,
          batch 3, 24 chunks: 9,442 tokens per row, int8 AdamW) on the data
          phase's latents (latent_dir: random full-width frozen resampler and
          patch conv files, K4 in the encoder) and a third one traced; each
          step's sampled timesteps and mean x0 weight beside its loss
  dp      the trainers' data axis (sharding/mesh.py's DataGroup, sharding/
          zero.py's ZeRO-1 layout) over 2 spawned ranks sharing the card on
          Gloo (NCCL over 2 cards where 2 or more are visible):
          train_t2to.yaml as shipped (f32 AdamW) with zero1 at full width,
          DiT depth cut to 2 of 42, per_gpu_batch_size 3, 24 chunks, 2
          steps, every trained tensor after each step held to one process
          on the global batch of 6, each rank's optimizer-state bytes to
          half of one process's, K1 (with lse) / K5 launches per rank, the
          all-reduce and all-gather seconds; the tiny To2V trainer (--smoke:
          int8 AdamW, accumulation 2) with zero1, checkpointed after its
          first update and resumed from there on 2 ranks, held to one
          process; planted faults (a rank that keeps its own gradient, int8
          AdamW parts cut off the 256-value block boundaries) must fail

The card's name and power limit (nvidia-smi) and a JSON object of the
kernels and their measurements (launches of K1-K4 on the edit path, of the
float32 K4 on the DINOv2 edit path, of K1-K4 on each of the variants
phase's paths as `variants_launches`, and
apart from them, as `load_launches`, `cli_launches`, `queue_launches` and
`serve_launches`, in the load phase's forward on the loaded weights, in its
CLI run, on the queue phase's rank 0 and in the serve phase's requests over
the wire; of K5 on the train path, of K7 on the gen path, of K6 on the tiny T2To trainer, of
K4 in the T2To trainer's latent encoder as `t2to_train_launches`, of
K1 / K4 / K5 / K6 on the dp phase's rank 0 as `dp_launches`, of the
probe kernels in their CLIs' runs) come before the last line,
and the result line ``{"ok": true, "device": {...}}``. Any failed phase
raises and the script exits non-zero. It refuses to run without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from typing import Optional

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "build", "kernels", "probes", "dit", "edit", "queue", "variants", "load", "gen",
          "serve", "data", "train", "t2to_train", "dp")

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
# kv tile of the probes (csrc BN): the planted fault drops the keys past it
KV_TILE = 64
# K1's, K2's, K6's and K7's drops the keys past their body's kv tile,
# attention.kv_tile(d) (128 keys at d <= 64, 64 at 128); K5's past its
# one-pass body's block of keys, attention.bwd_kv_block(d) (128; 64 at 16, 32)

# K4 on float32 operands (the DINOv2 encoder's attention): a body of its own
F32_KERNEL = "flash_attention_bhsd_f32"
KERNELS = {
    # entry point: (TPU kernel it replaces)
    "fused_attention_joint": "tokensgen_tpu/kernels/attention.py:586",
    "fused_attention_cross_smallkv": "tokensgen_tpu/kernels/attention.py:922",
    "fused_attention_cross_smallq": "tokensgen_tpu/kernels/attention.py:1048",
    "flash_attention_bhsd": "tokensgen_tpu/kernels/attention.py:54",
    "attention_backward": "tokensgen_tpu/kernels/attention.py:1220",
    # the int8_scores branch of _flash_packed_kernel (:586)
    "fused_attention_joint_int8": "tokensgen_tpu/kernels/attention.py:634",
    "fused_attention_bhsd": "tokensgen_tpu/kernels/attention.py:256",
    # `_flash_kernel` (:54) as DINOv2 calls it, on float32 operands
    F32_KERNEL: "tokensgen_tpu/kernels/attention.py:54",
}
SOURCE = "tokensgen_tpu_torch/kernels/csrc/attention.cu"
F32_SOURCE = "tokensgen_tpu_torch/kernels/csrc/attention_f32.cu"
# The float32 K4 against its plain version (attention_plain in float32, TF32
# off) on the same inputs: both keep float32 throughout and differ only in
# summation order and in exp2 with the scale folded into q (5.7e-7 relative
# L2, 1.7e-6 max abs at DINOv2's shape on an H100). Bounds: relative L2 <=
# 1e-5 and max abs <= 2^-14 of max|ref|; dropping the last of its 257 keys
# moves the output ~6% relative.
F32_REL_L2_BOUND = 1e-5
F32_MAX_ABS_REL = 2.0 ** -14
# The lse outputs of K1 and K4 against the plain logsumexp: the kernels score
# bf16(q' * log2 e) where the plain version scores bf16(q'), one bf16
# rounding apart (1.9e-3 relative at most, ~1e-4 relative L2, measured on an
# H100 at small shapes). Bounds: relative L2 <= 1e-3, max <= 2^-7 of max|lse|.
LSE_REL_L2_BOUND = 1e-3
LSE_MAX_REL = 2.0 ** -7
# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): bf16 and int8 tensor cores and HBM3. A kernel's bound is the
# largest of its least matmul work over the first two, its exponentials
# (forward attention: one ex2 a score) over the MUFU's rate at the card's
# top SM clock, and the bytes it must move over the third.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
# float32 outside the tensor cores and TF32 on them (the same data sheet,
# dense): the float32 K4's products take the lesser of two forms, FMAs on the
# CUDA cores or three TF32 passes (its 3xTF32 split) on the tensor cores
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
# SFU (ex2) and FP32 results per clock per SM on Hopper, and its SMs: the
# exponentials' bound and the exp2 probe's are their counts over these at
# the SM clock nvidia-smi reports (clocks.max.sm)
SFU_PER_CLK_SM, FP32_PER_CLK_SM, SMS = 16, 128, 132


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
    for mod in ("tokenizers", "cv2"):  # the load phase needs both
        try:
            version = importlib.import_module(mod).__version__
        except ImportError:
            version = None
        log(f"[env] {mod}: " + (f"present ({version})" if version else "not installed"))
    state["device"] = torch.device("cuda", 0)
    state["kind"] = torch.cuda.get_device_name(0)
    state["count"] = torch.cuda.device_count()
    log(f"[env] device 0: {state['kind']} (count {state['count']})")


def phase_build(state: dict) -> None:
    """nvcc builds the four sources at once (one process each), then prints
    -Xptxas -v per instantiation: registers and spill bytes. The instantiated
    set leaves out what spills (probes.SWEEP_CONFIGS), so a spill fails; so
    does a K7 body whose SASS is not int8 wgmma scores without I2F, a T7,
    T3a, T1 / T2, T4a or T4b body whose SASS is not bf16 wgmma without
    mma.sync, a K5 one-pass body (d = 16, 32, 64, 128) or T6 body whose SASS is not
    wgmma (T6's int8: IGMMA) without mma.sync, and a line of ptxas's saying
    that it serialized the wgmmas of a T1 / T2, T4a, T4b, K5 one-pass or T6
    instantiation (C7515, C7518, "insufficient register resources")."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.kernels import build as B
    from tokensgen_tpu_torch.kernels import probes as P

    def build(lib):
        t0 = time.perf_counter()
        return lib.build(force=True), time.perf_counter() - t0

    t0 = time.perf_counter()
    libs = (A._Library, P._Library, A._F32Library, P._GemmLibrary)
    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(build, libs))
    log(f"[build] nvcc {' '.join(B.NVCC_FLAGS)}: {len(libs)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    spilled = []
    for lib, (path, dt) in zip(libs, built):
        log(f"[build] {os.path.relpath(lib.source, REPO)} -> {os.path.relpath(path, REPO)} "
            f"in {dt:.1f} s")
        for line in lib.build_log.splitlines():
            if "warning" in line or "Performance Loss" in line:
                log(f"[build]   {line.strip()}")
        for name, regs, spill in B.ptxas_report(lib.build_log):
            log(f"[build]   {name}: {regs} registers, {spill} bytes spilled")
            if spill:
                spilled.append(name)
    if spilled:
        raise RuntimeError(f"registers spill in {spilled}")
    for d in A.F32_HEAD_DIMS:
        threads, smem, blocks = A.f32_geometry(d)
        log(f"[build]   float32 K4 at head dim {d}: {threads} threads, {smem:,} B of dynamic "
            f"shared memory a block, {blocks} resident blocks a SM")
    for d in A.SMALL_HEAD_DIMS:
        g = A.bwd_small_geometry(d)
        log(f"[build]   K5 (attention_backward) at head dim {d}: {g['keys']} keys a block, "
            f"{g['q_shares']} warpgroup(s) a key group, q tiles of {g['q_tile']} rows, "
            f"{g['threads']} threads, {g['smem_bytes']:,} B of dynamic shared memory a block, "
            f"{g['blocks_per_sm']} resident a SM")
    _int8_sass_check(built[0][0])
    g = P.matmul_geometry()
    log(f"[build]   T7 (matmul_hand): {g['tile_rows']} x {g['tile_cols']} output tiles, k tile "
        f"{g['k_tile']}, {g['stages']} ring slots, {g['threads']} threads, {g['smem_bytes']:,} B "
        f"of dynamic shared memory a block (a producer warpgroup and two consumers), raster "
        f"group {g['raster_group']}")
    for bq, _ in P.SPLITPV_CONFIGS:
        g = P.splitpv_geometry(bq)
        log(f"[build]   T3a (attention_splitpv) at block_q {bq}: {g['threads']} threads, "
            f"{g['slots']} K / V slots, {g['smem_bytes']:,} B of dynamic shared memory a block")
    for bq, bkv, hb in P.SWEEP_CONFIGS:
        g = P.sweep_geometry(bq, bkv, hb)
        log(f"[build]   T1 (attention_sweep) at ({bq}, {bkv}, {hb}): {g['threads']} threads, "
            f"{g['chains']} chain(s) a warpgroup, {g['slots']} K / V slots, {g['smem_bytes']:,} B "
            f"of dynamic shared memory a block, {g['blocks_per_sm']} resident a SM")
    for skv in (128, 480, P.RESIDENT_MAX):
        g = P.pairinner_geometry(skv)
        log(f"[build]   T4a (cross_smallkv_pairinner) at {skv} keys: {g['threads']} threads, "
            f"{g['kv_tiles']} resident K' / V tiles, {g['q_slots']} q slots a warpgroup, "
            f"{g['smem_bytes']:,} B of dynamic shared memory a block, {g['blocks_per_sm']} "
            f"resident a SM")
    for split in P.SPLITKV_BLOCK_KV:
        g = P.splitkv_geometry(split)
        log(f"[build]   T4b (cross_smallq_splitkv) at {split} keys a split: {g['threads']} "
            f"threads ({g['warpgroups']} warpgroup(s)), {g['kv_tiles']} resident K' / V tiles, "
            f"{g['q_slots']} q slots a warpgroup, {g['smem_bytes']:,} B of dynamic shared memory "
            f"a block, {g['blocks_per_sm']} resident a SM, partials "
            f"{'reduce-added into one accumulator' if g['reduce'] else 'one a split'}")
    for dt, name in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
        splits = sorted({P.flash_loop_split(2048, n, dt, 132) for n in (1024, 2048)})
        log(f"[build]   T6 (flash_loop) {name}: {P.FLASH_LOOP_ROWS} q rows and up to "
            f"{P.FLASH_LOOP_MAX_SPLIT[dt]} keys a block (256 threads, a chain a warpgroup), "
            f"chunks of {P.FLASH_LOOP_CHUNK[dt]} keys; the CLI's shapes take {splits} keys a "
            f"block")
    # sweep_kernel: T1's instantiations and T2's "last" ones
    serialized = [line.strip() for lib in (A._Library, P._Library)
                  for line in lib.build_log.splitlines()
                  if "Performance Loss" in line
                  and any(k in line for k in ("sweep_kernel", "pairinner_tma_kernel",
                                              "splitkv_tma_kernel", "bwd_onepass",
                                              "bwd_small_kernel", "flash_loop_kernel"))]
    if serialized:
        raise RuntimeError(f"ptxas serialized the wgmmas of T1 / T2, T4a, T4b, K5's one-pass "
                           f"body or T6: {serialized}")
    for path, kernel in ((built[3][0], "gemm_kernel"), (built[1][0], "pair_splitpv_kernel"),
                         (built[1][0], "sweep_kernel"), (built[1][0], "pairinner_tma_kernel"),
                         (built[1][0], "splitkv_tma_kernel"), (built[0][0], "bwd_onepass_kernel"),
                         (built[0][0], "bwd_onepass128_kernel"),
                         (built[0][0], "bwd_small_kernel")):
        _wgmma_sass_check(path, kernel)
    _flash_loop_sass_check(built[1][0])


# K7's body in SASS (cuobjdump): the instructions that show its design, by
# opcode: its score product on int8 wgmma (IGMMA), p.v on bf16 wgmma (HGMMA),
# no mma.sync (IMMA / HMMA), and no integer-to-float conversion a score (I2F,
# I2FP: the unrolled softmaxes would hold 64 each; the block's integer
# divisions convert by I2F.U32.RP, counted apart, and the lse's log2f in the
# stores by a few I2FP)
INT8_SASS = {"IGMMA": r"\bIGMMA\.", "HGMMA": r"\bHGMMA\.", "mma.sync": r"\b[IH]MMA\.",
             "I2F": r"\bI2FP?\.(?!U32\.RP\b)", "I2F.U32.RP (divisions)": r"\bI2F\.U32\.RP\b"}
SCORE_TILE = 64  # scores a thread holds in one softmax (a per-score conversion's count)


@functools.lru_cache(maxsize=None)
def _sass_listing(lib_path) -> tuple:
    """The SASS (cuobjdump) of every function of ``lib_path``, disassembled
    once per library (attention.cu's takes seconds)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {proc.stderr.strip()[:400]}")
    return tuple(proc.stdout.split("Function : ")[1:])


def _sass_functions(lib_path, kernel: str) -> list:
    """The SASS of each function of ``lib_path`` whose mangled name holds
    ``kernel``."""
    return [f for f in _sass_listing(str(lib_path)) if kernel in f.split(None, 1)[0]]


def _wgmma_sass_check(lib_path, kernel: str) -> None:
    """Each instantiation of ``kernel`` multiplies by bf16 wgmma (HGMMA) and
    by no mma.sync (HMMA)."""
    bodies = _sass_functions(lib_path, kernel)
    if not bodies:
        raise RuntimeError(f"cuobjdump: no function named {kernel}")
    for body in bodies:
        counts = {k: len(re.findall(INT8_SASS[k], body)) for k in ("HGMMA", "mma.sync")}
        log(f"[build]   {body.split(None, 1)[0]} SASS: HGMMA {counts['HGMMA']}, mma.sync "
            f"{counts['mma.sync']}")
        if not counts["HGMMA"] or counts["mma.sync"]:
            raise RuntimeError(f"{kernel} is not bf16 wgmma without mma.sync: {counts}")


def _flash_loop_sass_check(lib_path) -> None:
    """T6's two instantiations multiply on wgmma (bf16: HGMMA; int8: IGMMA)
    and by no mma.sync."""
    bodies = _sass_functions(lib_path, "flash_loop_kernel")
    if len(bodies) != 2:
        raise RuntimeError(f"cuobjdump: {len(bodies)} functions named flash_loop_kernel")
    for body in bodies:
        counts = {k: len(re.findall(INT8_SASS[k], body)) for k in ("IGMMA", "HGMMA", "mma.sync")}
        log(f"[build]   {body.split(None, 1)[0]} SASS: " + ", ".join(
            f"{k} {n}" for k, n in counts.items()))
        if not (counts["IGMMA"] or counts["HGMMA"]) or counts["mma.sync"]:
            raise RuntimeError(f"T6's body is not wgmma without mma.sync: {counts}")


def _int8_sass_check(lib_path) -> None:
    body = _sass_functions(lib_path, "joint_int8_splitkv_kernel")
    if len(body) != 1:
        raise RuntimeError(f"cuobjdump: {len(body)} functions named joint_int8_splitkv_kernel")
    counts = {k: len(re.findall(rx, body[0])) for k, rx in INT8_SASS.items()}
    log(f"[build]   joint_int8_splitkv_kernel SASS: " + ", ".join(
        f"{k} {n}" for k, n in counts.items()))
    if (not counts["IGMMA"] or not counts["HGMMA"] or counts["mma.sync"]
            or counts["I2F"] >= SCORE_TILE):
        raise RuntimeError(f"K7's body is not int8 wgmma scores without I2F: {counts}")


def _rope_tables(d, nf, gh, gw, device, offset=0.0):
    import numpy as np

    from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2

    return get_3d_rotary_pos_embed_v2(
        d, np.arange(nf, dtype=np.float32) + offset, np.arange(gh, dtype=np.float32),
        np.arange(gw, dtype=np.float32), device=device)


def agreement(out, ref, max_abs_rel=MAX_ABS_REL):
    """(relative L2 error, max abs error, max abs bound) of ``out`` against ``ref``."""
    diff = out.float() - ref.float()
    ref_f = ref.float()
    rel = (diff.norm() / ref_f.norm()).item()
    return rel, diff.abs().max().item(), max_abs_rel * ref_f.abs().max().item()


def _agrees(rel, max_err, max_bound, rel_bound=REL_L2_BOUND):
    return rel <= rel_bound and max_err <= max_bound


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def f32_matmul_s(f32_flops: float) -> tuple:
    """Seconds of ``f32_flops`` float32 matmul FLOPs in its two forms: (FMAs at
    the CUDA cores' float32 peak, TF32_PASSES passes at the TF32 peak)."""
    return f32_flops / PEAK_F32_FLOPS, TF32_PASSES * f32_flops / PEAK_TF32_FLOPS


def bound_ms(flops: float, nbytes: float, int8_ops: float = 0.0, exps: float = 0.0,
             f32_flops: float = 0.0):
    """(least time in ms, "operations" or "bytes"): the largest of the matmul
    work (bf16 FLOPs at the bf16 peak plus int8 operations at the int8 peak
    plus float32 FLOPs in the lesser of their two forms, `f32_matmul_s`), the
    exponentials (ex2 at the MUFU's rate, SFU_PER_CLK_SM a clock on each of
    SMS SMs at the top SM clock) and the bytes at the memory peak."""
    t_ops = max(flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS + min(f32_matmul_s(f32_flops)),
                exps / (SFU_PER_CLK_SM * SMS * _sm_clock_hz()) if exps else 0.0)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _work_detail(work) -> str:
    """``work`` = (FLOPs, bytes[, int8 operations[, exponentials[, f32
    FLOPs]]]) in words."""
    flops, nbytes, int8_ops, exps, f32 = (*work, 0.0, 0.0, 0.0)[:5]
    return (f"{flops / 1e12:.3f} TFLOP" + (f", {int8_ops / 1e12:.3f} int8 TOP" if int8_ops else "")
            + (f", {f32 / 1e12:.3f} f32 TFLOP" if f32 else "")
            + (f", {exps / 1e9:.3f} G ex2" if exps else "") + f", {nbytes / 1e9:.3f} GB")


def _outputs(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _compare(name, kernel_fn, plain_fn, state, fault_fn=None, runs=5, plain_runs=3,
             check_only=False, work=None, library_fn=None, labels=None, phase="kernels",
             fault="last ragged kv tile dropped", bounds=(REL_L2_BOUND, MAX_ABS_REL)):
    """Kernel vs plain version: every output within the bounds (relative L2,
    max abs relative to max|ref|), then the
    kernel, the plain version and ``library_fn`` (one PyTorch call computing
    the same function, timed only) timed. ``work`` = (flops, bytes) of the
    function for its bound. ``fault_fn`` is a deliberately wrong plain
    version (``fault``) that must fail the bounds on at least one output."""
    import torch

    rel_bound, max_abs_rel = bounds
    outs = _outputs(kernel_fn())
    torch.cuda.synchronize()
    refs = _outputs(plain_fn())
    torch.cuda.synchronize()
    labels = labels or [f"out{i}" for i in range(len(outs))]
    ok, max_err, parts = True, 0.0, []
    for label, out, ref in zip(labels, outs, refs):
        rel, err, err_bound = agreement(out, ref, max_abs_rel)
        finite = bool(torch.isfinite(out).all().item())
        ok = ok and finite and _agrees(rel, err, err_bound, rel_bound)
        max_err = max(max_err, err)
        parts.append(f"{label} {tuple(out.shape)} rel_l2_err {rel:.3e} (bound {rel_bound:g}) "
                     f"max_abs_err {err:.3e} (bound {err_bound:.3e}) finite {finite}")
    msg = f"[{phase}] {name}: " + "; ".join(parts)
    if check_only:
        log(msg)
    else:
        ms = _cuda_time_ms(kernel_fn, runs)
        plain_ms = _cuda_time_ms(plain_fn, plain_runs)
        lib_ms = None if library_fn is None else _cuda_time_ms(library_fn, runs)
        b_ms, b_by = bound_ms(*work)
        log(f"{msg}; kernel {ms:.3f} ms plain {plain_ms:.3f} ms library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'} bound {b_ms:.3f} ms "
            f"({b_by}; {_work_detail(work)})")
        state.setdefault("kernel_rows", {})[name] = {
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    if fault_fn is not None:
        faults = _outputs(fault_fn())
        caught = [not _agrees(*agreement(f, r, max_abs_rel), rel_bound)
                  for f, r in zip(faults, refs)]
        detail = ", ".join(f"{label} rel_l2_err {agreement(f, r)[0]:.3e}"
                           for label, f, r in zip(labels, faults, refs))
        log(f"[{phase}] {name}[planted fault: {fault}]: {detail}: "
            f"{'fails, as it must' if any(caught) else 'passes (bounds too loose)'}")
        if not any(caught):
            raise RuntimeError(f"{name}: the bounds do not catch the planted fault ({fault})")
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
    # K7: the same joint call, as the gen path's To2V render makes it
    cases["fused_attention_joint_int8"] = cases["fused_attention_joint"]
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
    if name == "fused_attention_joint_int8":
        return A.attention_fused_int8_plain(q, k[:, :n], v[:, :n], bias, c["tabs_q"],
                                            A.slice_tabs(c["tabs_k"], 0, n), c["heads"], 1e-6,
                                            True, True)
    return A._fused_plain_merged(q, k[:, :n], v[:, :n], bias, c["tabs_q"],
                                 A.slice_tabs(c["tabs_k"], 0, n), c["heads"], 1e-6, True, True)


def _without_ragged_tile(name, c):
    from tokensgen_tpu_torch.kernels import attention as A

    skv = c["k"].shape[2 if name == "flash_attention_bhsd" else 1]
    body_tile = name in ("fused_attention_joint", "fused_attention_cross_smallkv",
                         "fused_attention_joint_int8")
    dropped = skv % (A.kv_tile(64) if body_tile else KV_TILE)
    if dropped == 0:
        raise RuntimeError(f"{name}: Skv {skv} has no ragged kv tile to drop")
    return lambda: run_plain(name, c, kv_len=skv - dropped)


FORWARD_KERNELS = ("fused_attention_joint", "fused_attention_cross_smallkv",
                   "fused_attention_cross_smallq", "flash_attention_bhsd")


def _heads_view(name, c):
    """(q, k, v) of a forward case as [B, H, S, 64], prologued for K1-K3,
    and the softmax scale left to apply."""
    from tokensgen_tpu_torch.kernels import attention as A

    if name == "flash_attention_bhsd":
        return c["q"], c["k"], c["v"], c["scale"]
    h = c["heads"]
    return (A.apply_prologue_plain(A.split_heads(c["q"], h), c["tabs_q"], 1e-6, True),
            A.apply_prologue_plain(A.split_heads(c["k"], h), c["tabs_k"], 1e-6, True),
            A.split_heads(c["v"], h), 1.0)


def forward_work(name, c):
    """(matmul FLOPs, bytes, int8 operations, exponentials) of a forward call:
    q k^T and p v; each input the kernel reads (operands, f32 prologue tables,
    bias) once, the output once; one ex2 a score. K7's q k^T is int8
    operations, its p v bf16 FLOPs."""
    q, k, v = c["q"], c["k"], c["v"]
    if name == "flash_attention_bhsd":
        (b, h, sq, d), skv = q.shape, k.shape[2]
        tabs = []
    else:
        h = c["heads"]
        (b, sq, hd), skv, d = q.shape, k.shape[1], q.shape[2] // h
        tabs = list(c["tabs_q"][:3]) + list(c["tabs_k"][:3])
    nbytes = _nbytes(q, k, v, q, c.get("key_bias"), *tabs)
    scores = float(b * h * sq * skv)
    if name == "fused_attention_joint_int8":
        return 2.0 * scores * d, nbytes, 2.0 * scores * d, scores
    return 4.0 * scores * d, nbytes, 0.0, scores


def _sdpa(q4, k4, v4, scale, key_bias=None):
    """The library call: flash attention, or with a key bias the
    memory-efficient kernel with the bias as an additive mask."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if key_bias is None:
        return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q4, k4, v4, scale=scale,
                                              attn_mask=key_bias[:, None, None, :].to(q4.dtype))


def _check_lse(name, lse, ref):
    rel = ((lse - ref).norm() / ref.norm()).item()
    err = (lse - ref).abs().max().item()
    err_bound = LSE_MAX_REL * ref.abs().max().item()
    log(f"[kernels] {name}[lse]: shape {tuple(lse.shape)} rel_l2_err {rel:.3e} "
        f"(bound {LSE_REL_L2_BOUND:g}) max_abs_err {err:.3e} (bound {err_bound:.3e})")
    if not (rel <= LSE_REL_L2_BOUND and err <= err_bound):
        raise RuntimeError(f"{name}: its lse disagrees with the plain logsumexp")


def _t2to_case(dev, batch, valid_chunks=None, chunks=24, text=226, heads=48, seed=5, d=64):
    """K1's inputs at the T2To shape (24 chunks of 4 token frames of 8 x 12
    and 226 text tokens: 9,442 per row; RoPE dims (52, 6, 6) at head dim
    64, scaled with ``d``), merged bf16 [B, S, heads*d]; with
    ``valid_chunks`` (one count per sample) the trainer's padded-chunk key
    bias (`train.t2to.padded_chunk_masks`)."""
    import numpy as np
    import torch

    from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.train.t2to import padded_chunk_masks

    f = 4 * chunks
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = text + f * 8 * 12
    q, k, v = (torch.randn(batch, s, heads * d, generator=gen, device=dev).bfloat16()
               for _ in range(3))
    rope = get_3d_rotary_pos_embed_v2(d, np.arange(f, dtype=np.float32),
                                      np.arange(8, dtype=np.float32),
                                      np.arange(12, dtype=np.float32), 52 * d // 64, 6 * d // 64,
                                      6 * d // 64, device=dev)
    segs = [(None, text), (rope, s - text)]
    g, bb = torch.ones(d, device=dev), torch.zeros(d, device=dev)
    bias = None
    if valid_chunks is not None:
        bias, _ = padded_chunk_masks(torch.tensor(valid_chunks, device=dev) * 4, f, 8 * 12, text)
    return dict(q=q, k=k, v=v, tabs_q=A.make_prologue(d, segs, g, bb, fold=d ** -0.5),
                tabs_k=A.make_prologue(d, segs, g, bb), key_bias=bias, heads=heads)


def _t2to_joint_case(dev, state):
    """K1 at the T2To stage's shape as infer_gen.yaml ships it (B=2, no
    bias): held to its plain version and timed."""
    c = _t2to_case(dev, 2)
    name = "fused_attention_joint"
    q4, k4, v4, scale = _heads_view(name, c)
    s = c["q"].shape[1]
    _compare(f"{name}[T2To {s:,}^2]", lambda: run_kernel(name, c), lambda: run_plain(name, c),
             state, work=forward_work(name, c), library_fn=lambda: _sdpa(q4, k4, v4, scale))


def _library_or_none(label, make):
    """``make()`` (the library callable; building it may run the library's
    forward) if one call of it runs here, else None, logged: the library
    time is a yardstick, not a check."""
    import torch

    try:
        fn = make()
        fn()
        torch.cuda.synchronize()
    except RuntimeError as e:  # no kernel for these inputs, or out of memory
        log(f"[kernels] {label}: no library time ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:200]})")
        torch.cuda.empty_cache()
        return None
    return fn


# the T2To trainer's batch as train_t2to.yaml ships it (per_gpu_batch_size 3),
# two of its samples padded (valid chunks of the 24)
T2TO_TRAIN_VALID_CHUNKS = (24, 13, 5)


def _k6_plain(q4, k4, v4, tq, tk, bias, n=None, with_lse=False):
    """K6's plain version, over the first ``n`` keys (the planted fault)."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    skv = k4.shape[2]
    n = skv if n is None else n
    if bias is None:
        bias = torch.zeros(k4.shape[0], skv, device=q4.device)
    return A.attention_fused_plain(q4, k4[:, :, :n], v4[:, :, :n], bias[:, :n], tq,
                                   A.slice_tabs(tk, 0, n), 1e-6, True, True, with_lse)


def _k6_work(q4, k4, v4, tq, tk, bias):
    (b, h, sq, d), skv = q4.shape, k4.shape[2]
    return (4.0 * b * h * sq * skv * d, _nbytes(q4, k4, v4, q4, bias, *tq[:3], *tk[:3]), 0.0,
            float(b * h * sq * skv))


def _k6_checks(dev, state) -> None:
    """K6 (`fused_attention_bhsd`) at the T2To trainer's shape [3, 48, 9,442,
    64]: contiguous operands (the kernels line's row: timed, planted fault,
    library = flash SDPA on the prologued q / k), its lse, then as the
    strided [B, H, S, 64] view of merged operands with the padded-chunk key
    bias (the output must come back in the merged layout); then at head dims
    16 and 32 (3 heads, ragged, a key-bias mask), each with a planted fault."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    name = "fused_attention_bhsd"
    c = _t2to_case(dev, len(T2TO_TRAIN_VALID_CHUNKS))
    h = c["heads"]
    q4, k4, v4 = (A.split_heads(c[n], h).contiguous() for n in ("q", "k", "v"))
    tq, tk = c["tabs_q"], c["tabs_k"]
    skv = k4.shape[2]
    qn = A.apply_prologue_plain(q4, tq, 1e-6, True)
    kn = A.apply_prologue_plain(k4, tk, 1e-6, True)
    log(f"[kernels] {name} at the T2To trainer's shape {tuple(q4.shape)}, no bias:")
    _compare(name, lambda: A.fused_attention_bhsd(q4, k4, v4, tq, tk),
             lambda: _k6_plain(q4, k4, v4, tq, tk, None), state,
             fault_fn=lambda: _k6_plain(q4, k4, v4, tq, tk, None, skv - skv % A.kv_tile(64)),
             work=_k6_work(q4, k4, v4, tq, tk, None),
             library_fn=lambda: _sdpa(qn, kn, v4, 1.0))
    out, lse = A.fused_attention_bhsd(q4, k4, v4, tq, tk, with_lse=True)
    ref_out, ref_lse = _k6_plain(q4, k4, v4, tq, tk, None, with_lse=True)
    if not _agrees(*agreement(out, ref_out)):
        raise RuntimeError(f"{name}: the output with lse disagrees with the plain version")
    _check_lse(name, lse, ref_lse)
    del q4, k4, v4, qn, kn, out, lse, ref_out, ref_lse
    cb = _t2to_case(dev, len(T2TO_TRAIN_VALID_CHUNKS), T2TO_TRAIN_VALID_CHUNKS)
    qv, kv, vv = (A.split_heads(cb[n], h) for n in ("q", "k", "v"))
    bias = cb["key_bias"]
    out = A.fused_attention_bhsd(qv, kv, vv, tq, tk, bias)
    merged = out.permute(0, 2, 1, 3).is_contiguous()
    log(f"[kernels] {name}[strided view of merged {tuple(cb['q'].shape)}]: output in the "
        f"merged layout {merged}")
    if not merged:
        raise RuntimeError(f"{name}: the output of a merged view is not in the merged layout")
    _compare(f"{name}[strided view of merged, padded-chunk bias {T2TO_TRAIN_VALID_CHUNKS}]",
             lambda: A.fused_attention_bhsd(qv, kv, vv, tq, tk, bias),
             lambda: _k6_plain(qv, kv, vv, tq, tk, bias), state, check_only=True,
             fault_fn=lambda: _k6_plain(qv, kv, vv, tq, tk, bias, skv - skv % A.kv_tile(64)))
    del cb, qv, kv, vv, out
    gen = torch.Generator(device=dev).manual_seed(9)
    b, hh, s, text = 2, 3, 4000, 226
    for d in (16, 32):
        q, k, v = (torch.randn(b, hh, s, d, generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        ang = torch.randn(s - text, d, generator=gen, device=dev)
        g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        bb = 0.1 * torch.randn(d, generator=gen, device=dev)
        segs = [(None, text), ((ang.cos(), ang.sin()), s - text)]
        tq_d = A.make_prologue(d, segs, g, bb, fold=d ** -0.5)
        tk_d = A.make_prologue(d, segs, g, bb)
        bias = torch.zeros(b, s, device=dev)
        bias[1, s - 1000:] = -1e9
        _compare(f"{name}[d={d}, {tuple(q.shape)}, key bias]",
                 lambda: A.fused_attention_bhsd(q, k, v, tq_d, tk_d, bias),
                 lambda: _k6_plain(q, k, v, tq_d, tk_d, bias), state, check_only=True,
                 fault_fn=lambda: _k6_plain(q, k, v, tq_d, tk_d, bias, s - s % A.kv_tile(d)))


def _t2to_train_checks(dev, state) -> None:
    """K1 with lse (the training forward) and K5 at the T2To trainer's shape
    (B=3, 9,442^2, 48 heads) with its padded-chunk key bias: each held to its
    plain version (planted fault: the ragged last kv tile dropped, which the
    fully valid sample shows) and timed; library: SDPA's memory-efficient
    kernel with the bias as a mask, where it takes these inputs."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    c = _t2to_case(dev, len(T2TO_TRAIN_VALID_CHUNKS), T2TO_TRAIN_VALID_CHUNKS)
    name = "fused_attention_joint"
    label = f"[T2To train 3 x 9,442^2, padded-chunk bias {T2TO_TRAIN_VALID_CHUNKS}]"
    q4, k4, v4, scale = _heads_view(name, c)
    bias = c["key_bias"]

    def kernel():
        return A.fused_attention_joint(c["q"], c["k"], c["v"], c["tabs_q"], c["tabs_k"], bias,
                                       c["heads"], with_lse=True)[0]

    _compare(name + label, kernel, lambda: run_plain(name, c), state,
             fault_fn=_without_ragged_tile(name, c), work=forward_work(name, c),
             library_fn=_library_or_none(name + label, lambda: (lambda: _sdpa(q4, k4, v4, scale,
                                                                              bias))))
    out, lse = A.fused_attention_joint(c["q"], c["k"], c["v"], c["tabs_q"], c["tabs_k"], bias,
                                       c["heads"], with_lse=True)
    ref_out, ref_lse = A.attention_plain(q4, k4, v4, bias, scale, with_lse=True)
    _check_lse(name + label, lse, ref_lse)
    gen = torch.Generator(device=dev).manual_seed(6)
    cb = dict(q4=q4, k4=k4, v4=v4, scale=scale, key_bias=bias, heads=c["heads"], lse=ref_lse,
              g4=torch.randn(q4.shape, generator=gen, device=dev).bfloat16())
    cb["dsum"] = A._row_dsum(cb["g4"], ref_out, None)
    del out, lse, ref_out
    kernel, plain, fault, library, work = _bwd_fns(cb)
    _compare("attention_backward" + label, kernel, plain, state, fault_fn=fault, work=work,
             library_fn=_library_or_none("attention_backward" + label, library),
             labels=["dq", "dk", "dv", "dbias"])


def backward_cases(dev, cases, seed=2):
    """K5's inputs at the training path's shapes: the prologued operands of
    the three DiT calls (scale folded, so scale 1), the joint one also with a
    key-bias mask, and the resampler's K4 call; a random output gradient g;
    lse and out from the plain forward on the same operands."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for label, name in (("joint 17,776^2", "fused_attention_joint"),
                        ("text_video->vip 17,776 x 480", "fused_attention_cross_smallkv"),
                        ("vip->all 480 x 18,256", "fused_attention_cross_smallq"),
                        ("resampler 384 x 17,934", "flash_attention_bhsd")):
        c = cases[name]
        q4, k4, v4, scale = _heads_view(name, c)
        out[label] = dict(q4=q4, k4=k4, v4=v4, scale=scale, key_bias=None,
                          heads=None if name == "flash_attention_bhsd" else c["heads"])
    joint = out["joint 17,776^2"]
    b, s = joint["k4"].shape[0], joint["k4"].shape[2]
    bias = torch.zeros(b, s, device=dev)
    bias[0, s - 1000:] = -1e9
    bias[1, :3000] = -1e9
    out["joint 17,776^2, key bias"] = dict(joint, key_bias=bias)
    for c in out.values():
        c["g4"] = torch.randn(c["q4"].shape, generator=gen, device=dev).bfloat16()
        zeros = torch.zeros(c["k4"].shape[0], c["k4"].shape[2], device=dev)
        out4, c["lse"] = A.attention_plain(c["q4"], c["k4"], c["v4"], (
            zeros if c["key_bias"] is None else c["key_bias"]), c["scale"], with_lse=True)
        c["dsum"] = A._row_dsum(c["g4"], out4, None)
    return out


def _bwd_fns(c):
    """(kernel, plain, fault, library, work) callables of one K5 case; all
    return (dq, dk, dv, dbias) in the operands' layout."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    h, scale, bias = c["heads"], c["scale"], c["key_bias"]
    merge = A.merge_heads if h is not None else (lambda x: x)
    q, k, v, g = (merge(c[n]) for n in ("q4", "k4", "v4", "g4"))
    skv = c["k4"].shape[2]

    def kernel():
        return A.attention_backward(q, k, v, g, c["lse"], c["dsum"], bias, h, scale,
                                    with_dbias=True)

    def plain(n=skv):
        dq, dk, dv, db = A.attention_bwd_plain(
            c["q4"], c["k4"][:, :, :n], c["v4"][:, :, :n], c["g4"], c["lse"], c["dsum"],
            None if bias is None else bias[:, :n], scale)
        pad = skv - n
        dk, dv = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (dk, dv))
        return merge(dq), merge(dk), merge(dv), torch.nn.functional.pad(db, (0, pad))

    def library():
        qg, kg, vg = (c[n].detach().requires_grad_() for n in ("q4", "k4", "v4"))
        out = _sdpa(qg, kg, vg, scale, bias)
        return lambda: torch.autograd.grad(out, (qg, kg, vg), c["g4"], retain_graph=True)

    b, hh, sq, d = c["q4"].shape
    work = (10.0 * b * hh * sq * skv * d,  # the 5 products of one pass
            _nbytes(q, k, v, g, c["lse"], c["dsum"], bias, q, k, v)
            + 4 * b * skv,  # dbias out
            0.0, float(b * hh * sq * skv))  # p recomputed: one ex2 a score
    tile = A.bwd_kv_block(d)
    return kernel, plain, (lambda: plain(skv - skv % tile)), library, work


# split counts of K3 and K4 (the split-KV forward) checked besides their plan's
SPLIT_COUNTS = (1, 2, 5)


def _splitkv_checks(dev, cases, state) -> None:
    """K3 and K4 at their production shapes at the split counts
    `SPLIT_COUNTS` and their plan's (the kernels line's row is the plan's):
    each held to its plain version, timed, and its device time broken down
    per kernel; at more than one split with a second planted fault, the
    combine (`combine_plain` of the plain split partials) without the last
    split's partial; K4's lse at each count."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("fused_attention_cross_smallq", "flash_attention_bhsd"):
        c = cases[name]
        q4, k4, v4, scale = _heads_view(name, c)
        (b, h, sq, d), skv = q4.shape, k4.shape[2]
        zeros = torch.zeros(b, skv, device=dev)
        merge = (lambda x: x) if name == "flash_attention_bhsd" else A.merge_heads
        plan = A.kv_split_plan(b, h, sq, skv, d, sms)
        log(f"[kernels] {name} {tuple(q4.shape)} x {skv:,}: planned splits (count, keys) "
            f"{plan} on {sms} SMs")
        for n in sorted({*SPLIT_COUNTS, plan[0]}):
            splits, split_len = A.kv_split_plan(b, h, sq, skv, d, sms, n)
            if name == "flash_attention_bhsd":
                def kernel(lse=False):
                    return A._launch_bhsd(c["q"], c["k"], c["v"], None, scale, lse, splits=n)
            else:
                def kernel():
                    return A._launch_smallq(c["q"], c["k"], c["v"], None, c["tabs_q"], c["tabs_k"],
                                            c["heads"], 1e-6, True, True, splits=n)

            def without_last_split():
                acc, m, l = A.splitkv_partials_plain(q4, k4, v4, zeros, scale, split_len)
                return merge(A.combine_plain(acc[:-1], m[:-1], l[:-1])[0])

            label = f"{name}[splits={splits} of {split_len:,} keys]"
            _compare(label, kernel, lambda: run_plain(name, c), state,
                     work=forward_work(name, c),
                     fault_fn=without_last_split if splits > 1 else None,
                     fault="the last split's partial left out of the combine")
            _kernel_breakdown(label, kernel, group=_group_named(
                "attention K4" if name == "flash_attention_bhsd" else "attention K3"))
            if name == "flash_attention_bhsd":
                out, lse = kernel(True)
                ref_lse = A.attention_plain(q4, k4, v4, zeros, scale, with_lse=True)[1]
                if not torch.equal(out, kernel()):
                    raise RuntimeError(f"{name}: the output with lse differs from the one without")
                _check_lse(f"{name}[splits={splits}]", lse, ref_lse)
        torch.cuda.empty_cache()


def _kernel_breakdown(label, fn, calls=5, group=None, traces=3) -> dict:
    """Device time per CUDA kernel of one call of ``fn`` (the mean over
    ``calls`` traced calls, torch.profiler), logged and returned ({kernel:
    ms}). With ``group`` (a `_KERNEL_GROUPS` name), every attention kernel of
    the call must fall in that group of the traces' table. Every ``fn`` here
    launches an attention kernel, so a trace that holds none lost its device
    records (CUPTI has, once in a whole run): it is taken again, up to
    ``traces`` times in all, and the check fails if none holds one; a trace
    that holds a kernel of another group fails at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        parts, found, events = {}, set(), prof.key_averages()
        for evt in events:
            us = (getattr(evt, "self_device_time_total", 0)
                  or getattr(evt, "self_cuda_time_total", 0))
            if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
                name = re.search(r"(\w+)(<[^()]*>)?\(",
                                 evt.key.replace("(anonymous namespace)", ""))
                key = name.group(1) if name else evt.key[:40]
                parts[key] = parts.get(key, 0.0) + us / calls / 1e3
                if re.search(r"(joint|smallkv|smallq|bhsd|int8|bwd)_\w*kernel", evt.key):
                    found.add(_kernel_group(evt.key))
        if found:
            break
        log(f"[kernels] {label}: trace {attempt} of {traces} holds no attention kernel "
            f"({len(events)} event keys, {len(parts)} with device time)")
    log(f"[kernels] {label} per kernel: " + "; ".join(f"{k} {ms:.4f} ms" for k, ms in parts.items()))
    if group is not None and found != {group}:
        raise RuntimeError(f"{label}: its kernels fall in trace groups {sorted(found)}, "
                           f"not {group!r} alone")
    return parts


def _without_last_split(q4, k4, v4, bias, split_len):
    """The combine (`combine_plain`) of the plain split partials without the
    last split's, over [B, H, S, d] prologued operands, in q-row chunks (K1's
    whole f32 score tensor would take 121 GB); f32."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    b, h, sq, _ = q4.shape
    chunk = A._q_chunk(b, h, sq, k4.shape[2])
    outs = []
    for i in range(0, sq, chunk):
        acc, m, l = A.splitkv_partials_plain(q4[:, :, i:i + chunk], k4, v4, bias, 1.0, split_len)
        outs.append(A.combine_plain(acc[:-1], m[:-1], l[:-1])[0])
        del acc, m, l
    return torch.cat(outs, dim=2)


# split counts of K1 and K6 checked besides their plan's (one at their shapes)
FUSED_SPLIT_COUNTS = (2, 5)


def _fused_split_checks(dev, cases, state) -> None:
    """K1 at the edit shape and K6 at the T2To trainer's [3, 48, 9,442, 64]
    at their plan's split count (1) and at `FUSED_SPLIT_COUNTS`: each held
    to its plain version (one reference per shape), its device time broken
    down per kernel (the prologue pass, the body, the combine) and its
    kernels checked to fall in their own trace group; at more than one split
    with the planted fault of the last split left out of the combine."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c = cases["fused_attention_joint"]
    q4, k4, v4, _ = _heads_view("fused_attention_joint", c)
    k6 = _t2to_case(dev, len(T2TO_TRAIN_VALID_CHUNKS))
    h6 = k6["heads"]
    x6 = [A.split_heads(k6[n], h6).contiguous() for n in ("q", "k", "v")]
    n6 = [A.apply_prologue_plain(x6[i], k6[t], 1e-6, True) for i, t in ((0, "tabs_q"),
                                                                       (1, "tabs_k"))]
    runs = (
        ("fused_attention_joint", "attention K1", A.merge_heads, (q4, k4, v4),
         lambda n: A._launch_fused(c["q"], c["k"], c["v"], None, c["tabs_q"], c["tabs_k"],
                                   c["heads"], 1e-6, True, True, splits=n),
         lambda: run_plain("fused_attention_joint", c)),
        ("fused_attention_bhsd", "attention K6", lambda x: x, (n6[0], n6[1], x6[2]),
         lambda n: A._launch_fused(*x6, None, k6["tabs_q"], k6["tabs_k"], None, 1e-6, True, True,
                                   splits=n),
         lambda: _k6_plain(*x6, k6["tabs_q"], k6["tabs_k"], None)))
    for name, group_key, merge, (qn, kn, vn), launch, plain in runs:
        group = _group_named(group_key)
        (b, h, sq, d), skv = qn.shape, kn.shape[2]
        plan = A.kv_split_plan(b, h, sq, skv, d, sms)
        ref = plain()
        zeros = torch.zeros(b, skv, device=dev)
        log(f"[kernels] {name} {tuple(qn.shape)} x {skv:,}: planned splits (count, keys) {plan} "
            f"on {sms} SMs")
        for n in (plan[0], *FUSED_SPLIT_COUNTS):
            splits, split_len = A.kv_split_plan(b, h, sq, skv, d, sms, n)
            label = f"{name}[splits={splits} of {split_len:,} keys]"
            _compare(label, lambda: launch(n), lambda: ref, state, check_only=True,
                     fault_fn=(lambda: merge(_without_last_split(qn, kn, vn, zeros, split_len)))
                     if splits > 1 else None,
                     fault="the last split's partial left out of the combine")
            _kernel_breakdown(label, lambda: launch(n), group=group)
        del ref
        torch.cuda.empty_cache()


def _int8_without_last_split(q8, qs, k8, ks, v4, bias, split_len):
    """The combine (`combine_plain`) of K7's plain split partials
    (`int8_splitkv_partials_plain`) without the last split's, in q-row
    chunks; f32."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    b, h, sq, _ = q8.shape
    chunk = A._q_chunk(b, h, sq, k8.shape[2]) // 2  # its score-sized temporaries
    outs = []
    for i in range(0, sq, chunk):
        acc, m, l = A.int8_splitkv_partials_plain(q8[:, :, i:i + chunk], qs[:, :, i:i + chunk],
                                                  k8, ks, v4, bias, split_len)
        outs.append(A.combine_plain(acc[:-1], m[:-1], l[:-1])[0])
        del acc, m, l
    return torch.cat(outs, dim=2)


def _int8_split_checks(dev, c, state) -> None:
    """K7 at the gen path's joint shape: its build (registers from this
    process's nvcc output, shared memory, blocks a call), then at its plan's
    split count (1, K1's plan) and at `FUSED_SPLIT_COUNTS`, each held to its
    plain version (one reference), its device time broken down per kernel
    (the quantizing prologue pass apart from the body and the combine) and
    its kernels checked to fall in K7's trace group; at more than one split
    with the planted fault of the last split left out of the combine."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.kernels import build as B

    name, group = "fused_attention_joint_int8", _group_named("attention K7")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    h = c["heads"]
    b, sq, skv = c["q"].shape[0], c["q"].shape[1], c["k"].shape[1]
    plan = A.kv_split_plan(b, h, sq, skv, 64, sms)
    smem, threads = A.int8_geometry()
    regs = [f"{k} {r} registers, {sp} bytes spilled"
            for k, r, sp in B.ptxas_report(A._Library.build_log) if "int8" in k]
    blocks = -(-sq // A.split_block_q(64)) * plan[0] * h * b
    log(f"[kernels] {name} [{b}, {sq:,}, {h}x64] x {skv:,}: body {threads} threads, "
        f"{smem:,} B of dynamic shared memory, {blocks:,} blocks at its plan {plan} on {sms} "
        f"SMs; {'; '.join(regs) or 'registers: not in this process build log'}")
    ref = run_plain(name, c)
    q8, qs = A.quantize_pairs_plain(A.split_heads(c["q"], h), c["tabs_q"], 1e-6, True, A._LOG2E)
    k8, ks = A.quantize_pairs_plain(A.split_heads(c["k"], h), c["tabs_k"], 1e-6, True)
    v4 = A.split_heads(c["v"], h)
    zeros = torch.zeros(b, skv, device=dev)
    for n in (plan[0], *FUSED_SPLIT_COUNTS):
        splits, split_len = A.kv_split_plan(b, h, sq, skv, 64, sms, n)
        label = f"{name}[splits={splits} of {split_len:,} keys]"

        def launch(n=n):
            return A._launch_int8(c["q"], c["k"], c["v"], None, c["tabs_q"], c["tabs_k"], h,
                                  1e-6, True, True, splits=n)

        def fault(split_len=split_len):
            return A.merge_heads(_int8_without_last_split(q8, qs, k8, ks, v4, zeros, split_len))

        _compare(label, launch, lambda: ref, state, check_only=True,
                 fault_fn=fault if splits > 1 else None,
                 fault="the last split's partial left out of the combine")
        parts = _kernel_breakdown(label, launch, group=group)
        pro = sum(ms for k, ms in parts.items() if "prologue" in k)
        log(f"[kernels] {label}: quantizing prologue pass (q and k) {pro:.4f} ms, body and "
            f"combine {sum(parts.values()) - pro:.4f} ms")
    del ref, q8, qs, k8, ks
    torch.cuda.empty_cache()


def _k4_head_dim_checks(dev, cases, state) -> None:
    """K4 (`flash_attention_bhsd`) at head dims 128, 32 and 16 at its row's
    shape and width (the resampler's 384 latents against 17,934 keys, 16
    heads of 64 as 8 of 128, 32 of 32 and 64 of 16): held to the plain
    version with the planted fault (the ragged last kv tile dropped), timed,
    flash SDPA as the library time."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    c = cases["flash_attention_bhsd"]
    b, h64, sq, _ = c["q"].shape
    skv = c["k"].shape[2]
    n = skv - skv % KV_TILE
    gen = torch.Generator(device=dev).manual_seed(14)
    for d in (128, 32, 16):
        h = h64 * 64 // d
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16()
                   for s in (sq, skv, skv))
        zeros = torch.zeros(b, skv, device=dev)
        scale = d ** -0.5
        _compare(f"flash_attention_bhsd[d={d}, {tuple(q.shape)} x {skv:,}]",
                 lambda: A.flash_attention_bhsd(q, k, v, None, scale),
                 lambda: A.attention_plain(q, k, v, zeros, scale), state,
                 fault_fn=lambda: A.attention_plain(q, k[:, :, :n], v[:, :, :n], zeros[:, :n],
                                                    scale),
                 work=(4.0 * b * h * sq * skv * d, _nbytes(q, k, v, q), 0.0,
                       float(b * h * sq * skv)),
                 library_fn=lambda: _sdpa(q, k, v, scale))


def _head_dim_128_checks(dev, state) -> None:
    """K6 and K5 at head dim 128 at the T2To trainer's shape: its 3,072
    width as 24 heads of 128, batch 3 with the padded-chunk key bias
    (`T2TO_TRAIN_VALID_CHUNKS`), [3, 24, 9,442, 128] (the products of K6's
    [3, 48, 9,442, 64] row). K6 held to its plain version with the planted
    fault (the ragged last kv tile dropped, which the fully valid sample
    shows), timed, library SDPA (memory-efficient, the bias as a mask) on
    the prologued operands; then K5 on those prologued operands (scale 1),
    timed likewise."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    name = "fused_attention_bhsd"
    c = _t2to_case(dev, len(T2TO_TRAIN_VALID_CHUNKS), T2TO_TRAIN_VALID_CHUNKS, heads=24, d=128)
    h, bias = c["heads"], c["key_bias"]
    q4, k4, v4 = (A.split_heads(c[n], h).contiguous() for n in ("q", "k", "v"))
    tq, tk = c["tabs_q"], c["tabs_k"]
    skv = k4.shape[2]
    qn = A.apply_prologue_plain(q4, tq, 1e-6, True)
    kn = A.apply_prologue_plain(k4, tk, 1e-6, True)
    label = f"{name}[d=128, {tuple(q4.shape)}, padded-chunk bias {T2TO_TRAIN_VALID_CHUNKS}]"
    _compare(label, lambda: A.fused_attention_bhsd(q4, k4, v4, tq, tk, bias),
             lambda: _k6_plain(q4, k4, v4, tq, tk, bias), state,
             fault_fn=lambda: _k6_plain(q4, k4, v4, tq, tk, bias, skv - skv % A.kv_tile(128)),
             work=_k6_work(q4, k4, v4, tq, tk, bias),
             library_fn=_library_or_none(label, lambda: (lambda: _sdpa(qn, kn, v4, 1.0, bias))))
    _kernel_breakdown(label, lambda: A.fused_attention_bhsd(q4, k4, v4, tq, tk, bias),
                      group=_group_named("attention K6"))
    del q4, k4, c
    gen = torch.Generator(device=dev).manual_seed(15)
    cb = dict(q4=qn, k4=kn, v4=v4, scale=1.0, key_bias=bias, heads=None,
              g4=torch.randn(qn.shape, generator=gen, device=dev).bfloat16())
    out4, cb["lse"] = A.attention_plain(qn, kn, v4, bias, 1.0, with_lse=True)
    cb["dsum"] = A._row_dsum(cb["g4"], out4, None)
    del out4
    kernel, plain, fault, library, work = _bwd_fns(cb)
    label = f"attention_backward[d=128, {tuple(qn.shape)}, padded-chunk bias]"
    _compare(label, kernel, plain, state, fault_fn=fault, work=work,
             library_fn=_library_or_none(label, library), labels=["dq", "dk", "dv", "dbias"])
    del cb, qn, kn, v4
    torch.cuda.empty_cache()


def _k5_head_dim_checks(dev, state) -> None:
    """K5 at head dims 16, 32 and 128 ([3, 2, 1,544, 16], [3, 4, 1,544, 32]
    and [3, 1, 1,544, 128]: the tiny DiTs' token count, 8 text + 16 frames
    of 8 x 12, with the padded-chunk key bias of valid frames (16, 8, 4)):
    held to the plain backward with the planted fault (16 and 32 also
    timed, by single-call events and, kernel and library call alike, as the
    device time of 10 queued calls, `queued_time_ms`, with the wrapper's
    host time a call, and broken down per CUDA kernel; 128's row is
    `_head_dim_128_checks`'); then a gradient through
    `fused_flash_attention` on [B, H, S, D] operands (the autograd Function
    of K6 + K5) against autograd through the plain version, on the card."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.tools._common import queued_time_ms
    from tokensgen_tpu_torch.train.t2to import padded_chunk_masks

    gen = torch.Generator(device=dev).manual_seed(12)
    bias, _ = padded_chunk_masks(torch.tensor([16, 8, 4], device=dev), 16, 96, 8)
    b, s = 3, 8 + 16 * 96
    for h, d in ((2, 16), (4, 32), (1, 128)):
        q4, k4, v4, g4 = (torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16()
                          for _ in range(4))
        c = dict(q4=q4, k4=k4, v4=v4, g4=g4, scale=d ** -0.5, key_bias=bias, heads=None)
        out4, c["lse"] = A.attention_plain(q4, k4, v4, bias, c["scale"], with_lse=True)
        c["dsum"] = A._row_dsum(g4, out4, None)
        kernel, plain, fault, library, work = _bwd_fns(c)
        label = f"attention_backward[d={d}, {tuple(q4.shape)}, padded-chunk bias]"
        timed = d != 128
        lib = _library_or_none(label, library) if timed else None
        _compare(label, kernel, plain, state, fault_fn=fault, work=work, check_only=not timed,
                 library_fn=lib, labels=["dq", "dk", "dv", "dbias"])
        if timed:
            alone = queued_time_ms(kernel, dev, 5)
            lib_alone = None if lib is None else queued_time_ms(lib, dev, 5)
            host = []
            for _ in range(20):  # the wrapper's host time: a call's return, not its device work
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kernel()
                host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            host_ms = sorted(host)[len(host) // 2]
            state["kernel_rows"][label].update(queued_ms=alone, library_queued_ms=lib_alone,
                                               host_ms=host_ms)
            log(f"[kernels] {label}: device alone (10 queued calls) kernel {alone:.4f} ms, "
                f"library {'n/a' if lib_alone is None else f'{lib_alone:.4f} ms'}; the "
                f"kernel's host time a call (median of 20) {host_ms:.4f} ms")
            _kernel_breakdown(label, kernel, group=_group_named("attention K5"))
        ang = torch.randn(s - 8, d, generator=gen, device=dev)
        segs = [(None, 8), ((ang.cos(), ang.sin()), s - 8)]
        gain = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        shift = 0.1 * torch.randn(d, generator=gen, device=dev)
        tq = A.make_prologue(d, segs, gain, shift, fold=d ** -0.5)
        tk = A.make_prologue(d, segs, gain, shift)
        grads = []
        before = A.attention_backward.launches
        for fn in (lambda *x: A.fused_flash_attention(*x, tq, tk, bias),
                   lambda *x: A.attention_fused_plain(*x, bias, tq, tk, 1e-6, True, True)):
            leaves = [x.detach().requires_grad_() for x in (q4, k4, v4)]
            out = fn(*leaves)
            torch.autograd.backward(out, g4)
            grads.append([x.grad for x in leaves])
        launched = A.attention_backward.launches - before
        parts, ok = [], launched == 1
        for label, got, ref in zip(("dq", "dk", "dv"), *grads):
            rel, err, err_bound = agreement(got, ref)
            ok = ok and _agrees(rel, err, err_bound) and bool(torch.isfinite(got).all())
            parts.append(f"{label} rel_l2_err {rel:.3e} max_abs_err {err:.3e} "
                         f"(bound {err_bound:.3e})")
        log(f"[kernels] fused_flash_attention gradient at d={d} {tuple(q4.shape)} (K6 + K5, "
            f"{launched} K5 launch) against autograd through the plain version: "
            + "; ".join(parts))
        if not ok:
            raise RuntimeError(f"the d={d} attention gradient on the card disagrees or skipped K5")


def _smallkv_checks(dev, cases) -> None:
    """K2 at the edit shape: its device time per kernel (the k and q prologue
    passes, the body), its kernels checked to fall in K2's trace group; then
    the body's q tiles per block, the plan's one wave against 1,024-row
    chunks of one (b, h) a block (4 tiles: the grid of K2's earlier mma.sync
    body), each held to the plain version and timed (CUDA events, median of
    5)."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    name = "fused_attention_cross_smallkv"
    c = cases[name]
    _kernel_breakdown(name, lambda: run_kernel(name, c), group=_group_named("attention K2"))
    (b, sq, _), h = c["q"].shape, c["heads"]
    ref = run_plain(name, c)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = A.smallkv_tiles_per_block(b, h, sq, sms)
    for per_block in (plan, 4):
        def kernel():
            return A._launch_smallkv(c["q"], c["k"], c["v"], None, c["tabs_q"], c["tabs_k"], h,
                                     1e-6, True, True, per_block=per_block)
        _compare(f"{name}[{per_block} q tiles per block]", kernel, lambda: ref, {},
                 check_only=True)
        log(f"[kernels] {name}[{per_block} q tiles per block]: {_cuda_time_ms(kernel, 5):.3f} ms")


def _k5_repeatability(kernel) -> None:
    """Whether two K5 calls on the same inputs give bit-equal outputs: dk, dv
    and dbias must (each has one writer); dq may differ in its last bits (its
    f32 sums cross blocks of keys in an order that changes from run to run),
    and is logged."""
    import torch

    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    same = [torch.equal(x, y) for x, y in zip(first, second)]
    log(f"[kernels] attention_backward twice on the same inputs: bit-equal dq {same[0]}, "
        f"dk {same[1]}, dv {same[2]}, dbias {same[3]}")
    if not all(same[1:]):
        raise RuntimeError("attention_backward: dk, dv or dbias differ between two calls")


def phase_kernels(state: dict) -> None:
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    dev = state["device"]
    cases = kernel_cases(dev)
    for name in FORWARD_KERNELS:
        c = cases[name]
        q4, k4, v4, scale = _heads_view(name, c)
        _compare(name, lambda: run_kernel(name, c), lambda: run_plain(name, c), state,
                 fault_fn=_without_ragged_tile(name, c), work=forward_work(name, c),
                 library_fn=lambda: _sdpa(q4, k4, v4, scale))
    _smallkv_checks(dev, cases)
    _splitkv_checks(dev, cases, state)
    _fused_split_checks(dev, cases, state)
    _k4_head_dim_checks(dev, cases, state)
    # K7 at the gen path's joint shape; then its error against bf16 K1 on the
    # same inputs (the int8 quantization's own cost, no bound)
    name = "fused_attention_joint_int8"
    c = cases[name]
    q4, k4, v4, scale = _heads_view(name, c)
    _compare(name, lambda: run_kernel(name, c), lambda: run_plain(name, c), state,
             fault_fn=_without_ragged_tile(name, c), work=forward_work(name, c),
             library_fn=lambda: _sdpa(q4, k4, v4, scale))
    rel, err, _ = agreement(run_kernel(name, c), run_kernel("fused_attention_joint", c))
    log(f"[kernels] {name} against bf16 fused_attention_joint on the same inputs "
        f"(quantization error): rel_l2_err {rel:.3e} max_abs_err {err:.3e}")
    _int8_split_checks(dev, c, state)
    _t2to_joint_case(dev, state)
    _k6_checks(dev, state)
    _t2to_train_checks(dev, state)
    torch.cuda.empty_cache()
    # the training forward's lse outputs (K1, K4) against the plain logsumexp
    for name in ("fused_attention_joint", "flash_attention_bhsd"):
        c = cases[name]
        q4, k4, v4, scale = _heads_view(name, c)
        zeros = torch.zeros(k4.shape[0], k4.shape[2], device=dev)
        ref_out, ref_lse = A.attention_plain(q4, k4, v4, zeros, scale, with_lse=True)
        if name == "flash_attention_bhsd":
            out, lse = A.flash_attention_bhsd(c["q"], c["k"], c["v"], None, scale, with_lse=True)
        else:
            out, lse = A.fused_attention_joint(c["q"], c["k"], c["v"], c["tabs_q"], c["tabs_k"],
                                               None, c["heads"], with_lse=True)
            ref_out = A.merge_heads(ref_out)
        rel, err, err_bound = agreement(out, ref_out)
        if not _agrees(rel, err, err_bound):
            raise RuntimeError(f"{name}: the output with lse disagrees with the plain version")
        _check_lse(name, lse, ref_lse)
    # K5 at the training path's shapes; the joint one is the kernels line's row
    for label, c in backward_cases(dev, cases).items():
        kernel, plain, fault, library, work = _bwd_fns(c)
        row = label == "joint 17,776^2"
        check_only = c["key_bias"] is not None
        _compare("attention_backward" if row else f"attention_backward[{label}]", kernel, plain,
                 state, fault_fn=fault, check_only=check_only, work=work,
                 library_fn=None if check_only else library(),
                 labels=["dq", "dk", "dv", "dbias"])
        if row:
            _k5_repeatability(kernel)
            _kernel_breakdown("attention_backward", kernel, group=_group_named("attention K5"))
    _k5_head_dim_checks(dev, state)
    _head_dim_128_checks(dev, state)
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


# The probe kernels (kernels/probes.py), each the counterpart of a Pallas
# probe under the JAX package's tools/: entry point -> the TPU kernel
PROBES = {
    "attention_sweep": "tools/bench_attn_sweep.py:73",  # `_tpu` -> K4's `_flash_kernel`
    "attention_v2": "tools/bench_attn_v2.py:23",  # `_kernel_v2`
    "flash_loop": "tools/bench_pallas_int8.py:29",  # `_flash_like_kernel`
    "matmul_hand": "tools/bench_matmul_pallas.py:27",  # `_mm_kernel`
    "exp2_loop": "tools/bench_vpu_exp2.py:30",  # `make_kernel`
    "attention_splitpv": "tools/bench_attn_r3.py:62",  # `_packed_kernel_splitpv`
    "attention_pair2": "tools/bench_attn_r3.py:231",  # `_packed_kernel_pair2`
    "cross_smallkv_pairinner": "tools/bench_cross_r3.py:84",  # `_smallkv_kernel`
    "cross_smallq_splitkv": "tools/bench_cross_r3.py:200",  # `_smallq_kernel`
    "cross_smallkv_pairloop": "tools/bench_cross_pairloop.py:33",  # `_smallkv_pairloop_kernel`
}
PROBE_SOURCE = "tokensgen_tpu_torch/kernels/csrc/probes.cu"
# the probes whose bodies live in probes.cu's headers of TMA / wgmma bodies,
# and T7's own source
PROBE_SOURCES = dict.fromkeys(("attention_splitpv", "attention_pair2", "cross_smallkv_pairloop"),
                              "tokensgen_tpu_torch/kernels/csrc/probes_maxfree.cuh")
PROBE_SOURCES.update(dict.fromkeys(("attention_sweep", "attention_v2", "cross_smallkv_pairinner",
                                    "cross_smallq_splitkv"),
                                   "tokensgen_tpu_torch/kernels/csrc/probes_hopper.cuh"))
PROBE_SOURCES["matmul_hand"] = "tokensgen_tpu_torch/kernels/csrc/probe_gemm.cu"
PROBE_CLIS = ("bench_attn_sweep", "bench_attn_v2", "bench_int8_loop", "bench_matmul_hand",
              "bench_exp2", "bench_attn_r3", "bench_cross_r3", "bench_cross_pairloop")
@functools.lru_cache(maxsize=None)
def _sm_clock_hz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def _probe_attention_rows(dev, state) -> None:
    """T1 and T2 at the scripts' shape [1, 48, 17,776, 64] (the CLIs' inputs),
    both at T1's default tile (`probes.SWEEP_DEFAULT`; T2 in "last", its
    plain version at that tile's block_kv), against their plain versions
    with the planted fault, timed; T1 also at every other tile of
    `probes.SWEEP_CONFIGS` (check and planted fault); T2 "full" at T1's tile
    (check only), and "last" where a random key bias on earlier tiles must
    be ignored."""
    import torch

    from tokensgen_tpu_torch.kernels import probes as P
    from tokensgen_tpu_torch.tools.bench_attn_sweep import make_inputs

    q, k, v, bias = make_inputs(dev, 1, 48, 17776)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    n = skv - skv % KV_TILE
    work = (4.0 * b * h * sq * skv * d, _nbytes(q, k, v, q, bias), 0.0, float(b * h * sq * skv))
    library = lambda: _sdpa(q, k, v, d ** -0.5)  # noqa: E731
    _compare("attention_sweep", lambda: P.attention_sweep(q, k, v, bias),
             lambda: P.attention_sweep_plain(q, k, v, bias), state,
             fault_fn=lambda: P.attention_sweep_plain(q, k[:, :, :n], v[:, :, :n], bias[:, :n]),
             work=work, library_fn=library, phase="probes")
    ref = P.attention_sweep_plain(q, k, v, bias)
    fault = P.attention_sweep_plain(q, k[:, :, :n], v[:, :, :n], bias[:, :n])
    for cfg in P.SWEEP_CONFIGS:
        if cfg != P.SWEEP_DEFAULT:
            _compare(f"attention_sweep[{cfg}]",
                     lambda cfg=cfg: P.attention_sweep(q, k, v, bias, *cfg), lambda: ref, state,
                     fault_fn=lambda: fault, check_only=True, phase="probes")
    del ref, fault
    bq, bkv, hb = P.SWEEP_DEFAULT
    _compare("attention_v2", lambda: P.attention_v2(q, k, v, bias, bq, bkv, "last", hb),
             lambda: P.attention_v2_plain(q, k, v, bias, bkv, "last"), state,
             fault_fn=lambda: P.attention_v2_plain(q, k[:, :, :n], v[:, :, :n], bias[:, :n], bkv,
                                                   "last"),
             work=work, library_fn=library, phase="probes")
    _compare(f"attention_v2[full, {P.SWEEP_DEFAULT}]",
             lambda: P.attention_v2(q, k, v, bias, bq, bkv, "full", hb),
             lambda: P.attention_v2_plain(q, k, v, bias, bkv, "full"), state, check_only=True,
             phase="probes")
    del q, k, v, bias
    gen = torch.Generator(device=dev).manual_seed(13)
    qs, ks, vs = (torch.randn(2, 4, 1000, 64, generator=gen, device=dev).bfloat16()
                  for _ in range(3))
    rb = torch.randn(2, 1000, generator=gen, device=dev)
    _compare("attention_v2[last, random key bias, (2, 4, 1000, 64)]",
             lambda: P.attention_v2(qs, ks, vs, rb, bq, bkv, "last", hb),
             lambda: P.attention_v2_plain(qs, ks, vs, rb, bkv, "last"), state, check_only=True,
             fault_fn=lambda: P.attention_v2_plain(qs, ks, vs, rb, bkv, "full"),
             fault="the bias applied on every tile", phase="probes")


def _probe_flash_loop_rows(dev, state) -> None:
    """T6 at (m, n, d) = (2048, 2048, 128): int8 at the CLI's 500 steps must
    be bit-equal to its plain version (exact integers, int32 wrap), and the
    planted fault (one chunk of keys left out of the first step) must not
    be; bf16 at 4 steps (its chain decays by ~11/64 a step) by the bounds,
    with the same fault. Both types timed at 500 steps at the CLI's two
    shapes (n = 2,048 and 1,024), each beside its bound and the share of the
    work that the recomputed chain adds (128 / (2 split): every block steps
    q by q @ k[:, :128] itself). The kernels line's row is the int8 case at
    n = 2,048."""
    import torch

    from tokensgen_tpu_torch.kernels import probes as P
    from tokensgen_tpu_torch.tools.bench_int8_loop import make_inputs

    m, n, d, iters = 2048, 2048, 128, 500
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qb, kb, vb = make_inputs(dev, m, n, d, torch.bfloat16)
    _compare("flash_loop[bf16, 4 steps]", lambda: P.flash_loop(qb, kb, vb, 4),
             lambda: P.flash_loop_plain(qb, kb, vb, 4), state, check_only=True,
             fault_fn=lambda: P.flash_loop_plain(qb, kb, vb, 4, drop_first_tile=True),
             fault="one kv chunk left out of the first step", phase="probes")
    del qb, kb, vb
    for nn in (2048, 1024):
        for dt, peak in ((torch.bfloat16, PEAK_BF16_FLOPS), (torch.int8, PEAK_INT8_OPS)):
            if dt == torch.int8 and nn == n:
                continue  # the kernels line's row, below
            x = make_inputs(dev, m, nn, d, dt)
            ms = _cuda_time_ms(lambda: P.flash_loop(*x, iters), 5)
            ops = iters * 2 * 4.0 * m * nn * d
            split = P.flash_loop_split(m, nn, dt, sms)
            blocks = -(-nn // split) * -(-m // P.FLASH_LOOP_ROWS)
            log(f"[probes] flash_loop[{'int8' if dt == torch.int8 else 'bf16'}, {iters} steps, "
                f"{(m, nn, d)}]: kernel {ms:.3f} ms, bound {ops / peak * 1e3:.3f} ms "
                f"(operations); {split} keys a block, {blocks} blocks on {sms} SMs, the "
                f"recomputed chain adds {128 / (2 * split):.1%} of the work")
            del x
    q8, k8, v8 = make_inputs(dev, m, n, d, torch.int8)
    out = P.flash_loop(q8, k8, v8, iters)
    ref = P.flash_loop_plain(q8, k8, v8, iters)
    equal = torch.equal(out, ref)
    fault_equal = torch.equal(out, P.flash_loop_plain(q8, k8, v8, iters, drop_first_tile=True))
    err = (out - ref).abs().max().item()
    ms = _cuda_time_ms(lambda: P.flash_loop(q8, k8, v8, iters), 5)
    plain_ms = _cuda_time_ms(lambda: P.flash_loop_plain(q8, k8, v8, iters), 3)
    ops = iters * 2 * 4.0 * m * n * d
    b_ms = ops / PEAK_INT8_OPS * 1e3
    split = P.flash_loop_split(m, n, torch.int8, sms)
    log(f"[probes] flash_loop[int8, {iters} steps, {(m, n, d)}]: bit-equal to the plain version "
        f"{equal} (max_abs_err {err:.3e}); planted fault (one kv chunk left out of the first "
        f"step) bit-equal {fault_equal}; kernel {ms:.3f} ms plain {plain_ms:.3f} ms library n/a "
        f"bound {b_ms:.3f} ms (operations; {ops / 1e12:.3f} int8 TOP); {split} keys a block, "
        f"the recomputed chain adds {128 / (2 * split):.1%} of the work")
    if not equal or fault_equal:
        raise RuntimeError("flash_loop int8: not bit-equal to its plain version, or the planted "
                           "fault is not caught")
    state.setdefault("kernel_rows", {})["flash_loop"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": "operations", "library_ms": None}


def _probe_matmul_rows(dev, state) -> None:
    """T7 at ff up ([36,352, 3072] x [3072, 12288], the CLI's inputs; library
    torch.matmul), planted fault: the last k tile (`probes.MATMUL_BK`) left
    out; the CLI's other three shapes (ff down's K = 12,288 the longest
    accumulation) held to the same bounds from the CLI's own errors, their
    kernel and torch.matmul times added to the row; then ragged M, N and K
    edges at a small shape."""
    import torch

    from tokensgen_tpu_torch.kernels import probes as P
    from tokensgen_tpu_torch.tools.bench_matmul_hand import M, make_inputs

    x, y = make_inputs(dev, M, 3072, 12288)
    kdim = x.shape[1]
    _compare("matmul_hand", lambda: P.matmul_hand(x, y), lambda: P.matmul_plain(x, y), state,
             fault_fn=lambda: P.matmul_plain(x, y, kdim - P.MATMUL_BK),
             fault="the last k tile left out", phase="probes",
             work=(2.0 * M * kdim * y.shape[1], _nbytes(x, y) + 2 * M * y.shape[1]),
             library_fn=lambda: torch.matmul(x, y))
    del x, y
    xs, ys = make_inputs(dev, 300, 200, 136, seed=1)
    _compare("matmul_hand[ragged (300, 200) x (200, 136)]", lambda: P.matmul_hand(xs, ys),
             lambda: P.matmul_plain(xs, ys), state, check_only=True,
             fault_fn=lambda: P.matmul_plain(xs, ys, 192), fault="the ragged k tile left out",
             phase="probes")
    shapes = {}
    for r in state["probe_cli_results"]["bench_matmul_hand"]:
        if (r["k"], r["n"]) == (kdim, 12288):
            continue
        bound = MAX_ABS_REL * r["ref_max"]
        b_ms = bound_ms(2.0 * r["m"] * r["k"] * r["n"],
                        2.0 * (r["m"] * r["k"] + r["k"] * r["n"] + r["m"] * r["n"]))[0]
        log(f"[probes] matmul_hand[{r['name']} [{r['m']},{r['k']}]x[{r['k']},{r['n']}], the "
            f"CLI's run]: rel_l2_err {r['rel_l2_err']:.3e} (bound {REL_L2_BOUND:g}) max_abs_err "
            f"{r['max_abs_err']:.3e} (bound {bound:.3e}); kernel {r['ms']:.3f} ms torch.matmul "
            f"{r['library_ms']:.3f} ms bound {b_ms:.3f} ms")
        if r["rel_l2_err"] > REL_L2_BOUND or r["max_abs_err"] > bound:
            raise RuntimeError(f"matmul_hand[{r['name']}]: kernel disagrees with its plain version")
        shapes[r["name"]] = {"ms": r["ms"], "library_ms": r["library_ms"], "bound_ms": b_ms}
    state["kernel_rows"]["matmul_hand"]["shapes"] = shapes


# T8's checks, at pass counts where one pass less fails them: exp2 draws
# every input to its fixed point 2 (x -> 2^(x/2) has slope ln 2 there), so
# after ~40 passes every count gives 2.0; exp2_add leaves the f32 range
# after ~30; mul by 1.0000001 moves by an ulp a pass, so it is held bit-equal
# (one correctly rounded f32 product a pass), at the CLI's 256 passes
EXP2_CHECK_PASSES = {"mul": 256, "exp2": 6, "exp2_add": 16}


def _probe_exp2_rows(dev, state) -> None:
    """T8 at the script's [2048, 2048] f32: each op against its plain loop at
    `EXP2_CHECK_PASSES` (exp2 and exp2_add by the bounds, mul bit-equal), with
    the planted fault of one pass less; then at the CLI's 256 passes checked
    to be infinite where the plain loop is, and timed. The row is exp2's.
    Bound: the exp2 passes at the SFU rate, mul at the FP32 rate, at the SM
    clock nvidia-smi reports (the 8 bytes per element read and written are
    far below)."""
    import torch

    from tokensgen_tpu_torch.kernels import probes as P
    from tokensgen_tpu_torch.tools.bench_exp2 import make_input

    x = make_input(dev, 2048, 2048)
    n_iter = 256
    clk = _sm_clock_hz()
    log(f"[probes] SM clock (nvidia-smi clocks.max.sm): {clk / 1e6:.0f} MHz")
    for op in P.EXP2_OPS:
        checked = EXP2_CHECK_PASSES[op]
        name, fault = f"exp2_loop[{op}, {checked} passes]", f"{checked - 1} passes"
        if op == "mul":
            out, ref = P.exp2_loop(x, checked, op), P.exp2_loop_plain(x, checked, op)
            equal = torch.equal(out, ref)
            fault_equal = torch.equal(out, P.exp2_loop_plain(x, checked - 1, op))
            err = (out - ref).abs().max().item()
            log(f"[probes] {name}: bit-equal to the plain version {equal} (max_abs_err "
                f"{err:.3e}); planted fault ({fault}) bit-equal {fault_equal}")
            if not equal or fault_equal:
                raise RuntimeError(f"{name}: not bit-equal to its plain version, or the planted "
                                   "fault is not caught")
        else:
            err = _compare(name, lambda: P.exp2_loop(x, checked, op),
                           lambda: P.exp2_loop_plain(x, checked, op), state, check_only=True,
                           fault_fn=lambda: P.exp2_loop_plain(x, checked - 1, op), fault=fault,
                           phase="probes")
        out, ref = P.exp2_loop(x, n_iter, op), P.exp2_loop_plain(x, n_iter, op)
        inf_alike = torch.equal(torch.isinf(out), torch.isinf(ref))
        ms = _cuda_time_ms(lambda: P.exp2_loop(x, n_iter, op), 5)
        plain_ms = _cuda_time_ms(lambda: P.exp2_loop_plain(x, n_iter, op), 3)
        per_clk = FP32_PER_CLK_SM if op == "mul" else SFU_PER_CLK_SM
        b_ms = x.numel() * n_iter / (SMS * per_clk * clk) * 1e3
        log(f"[probes] exp2_loop[{op}, {n_iter} passes]: infinite where the plain version is "
            f"{inf_alike} ({int(torch.isinf(ref).sum())} of {ref.numel()}); kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms library n/a bound {b_ms:.3f} ms (operations; "
            f"{x.numel() * n_iter / 1e9:.3f} G results at {per_clk} per clock per SM)")
        if not inf_alike:
            raise RuntimeError(f"exp2_loop[{op}]: infinite elsewhere than its plain version")
        if op == "exp2":
            state.setdefault("kernel_rows", {})["exp2_loop"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": "operations", "library_ms": None}


def _probe_maxfree_rows(dev, state) -> None:
    """T3a, T3b, T4a, T4b and T5 at their scripts' shapes (the CLIs' inputs:
    joint 17,776^2, cross1 17,776 x 480, cross2 480 x 18,256; 48 heads),
    each at its default tiles against the shared max-free plain version with
    a planted fault (T3a, T3b, T4a, T5: the ragged last kv tile of 64 left
    out; T4b: the keys of its last split left out, which the reduce-add must
    add), timed, with its bound and flash SDPA on the prologued operands as
    the library time; then against the shipped K1, K2 or K3 on the same
    inputs (check only: the same function, the online max against the
    shift). T3b also at the two cross shapes (check only); T5 also at every
    other q block it is built for (check and planted fault), and its kernel
    alone timed (`probes.pairloop_prologued`: the call also runs k's
    prologue in plain torch; the row's ``kernel_ms``); T4a likewise
    (`probes.pairinner_prologued`, every other block_q of
    `PAIRINNER_BLOCK_Q`); T4b's whole call (both prologue passes, the body,
    the last pass) also as the device time of 10 queued calls (the row's
    ``kernel_ms``: one call's events count its host time). The score shift
    is computed once per shape and passed in, so the times leave it out."""
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.kernels import probes as P
    from tokensgen_tpu_torch.tools._common import queued_time_ms
    from tokensgen_tpu_torch.tools.bench_attn_r3 import make_inputs

    x = make_inputs(dev)
    h = x["q"].shape[2] // 64
    shapes = {  # shape: (q, k, v, q tables, k tables, shipped kernel)
        "joint": (x["q"], x["k"], x["v"], x["tq"], x["tk"], A.fused_attention_joint),
        "cross1": (x["q"], x["kv"], x["vv"], x["tq_tv"], x["tk_vip"],
                   A.fused_attention_cross_smallkv),
        "cross2": (x["qv"], x["kcat"], x["vcat"], x["tq_vip"], x["tk_all"],
                   A.fused_attention_cross_smallq),
    }
    ragged = lambda n: n - n % KV_TILE  # noqa: E731
    cases = (  # (shape, probe, keys its planted fault keeps (None: check only), tile)
        ("joint", P.attention_splitpv, ragged, None),
        ("joint", P.attention_pair2, ragged, None),
        ("cross1", P.attention_pair2, None, None),
        ("cross2", P.attention_pair2, None, None),
        ("cross1", P.cross_smallkv_pairinner, ragged, None),
        ("cross2", P.cross_smallq_splitkv,  # at its default split
         lambda n: (n - 1) // P.SPLITKV_DEFAULT * P.SPLITKV_DEFAULT, None),
        ("cross1", P.cross_smallkv_pairloop, ragged, None),  # at its default, one wave
    ) + tuple(("cross1", P.cross_smallkv_pairloop, ragged, bq) for bq in P.PAIRLOOP_BLOCK_Q
              if bq != P.PAIRLOOP_WAVE) + tuple(
        ("cross1", P.cross_smallkv_pairinner, ragged, bq) for bq in P.PAIRINNER_BLOCK_Q
        if bq != P.PAIRINNER_DEFAULT)
    for shape, probe, kept, tile in cases:
        label, check_only, timed = probe.__name__, kept is None, kept is not None and tile is None
        q, k, v, tq, tk, shipped = shapes[shape]
        shift = P.score_shift(tq, tk).item()
        tiles = () if tile is None else (tile,)
        kernel = lambda: probe(q, k, v, None, tq, tk, h, *tiles, shift=shift)  # noqa: E731
        plain = lambda: P.attention_maxfree_plain(q, k, v, None, tq, tk, h, shift)  # noqa: E731
        n = None if check_only else kept(k.shape[1])
        fault = None if check_only else (
            lambda: P.attention_maxfree_plain(q, k[:, :n], v[:, :n], None, tq,
                                              A.slice_tabs(tk, 0, n), h, shift))
        work = library = None
        if timed:
            k_prologued = probe in (P.cross_smallkv_pairinner, P.cross_smallkv_pairloop)
            k_tabs = [] if k_prologued else list(tk[:3])
            work = (4.0 * q.shape[1] * k.shape[1] * h * 64, _nbytes(q, k, v, q, *tq[:3], *k_tabs),
                    0.0, float(q.shape[1] * k.shape[1] * h))
            q4 = A.apply_prologue_plain(A.split_heads(q, h), tq, 1e-6, True)
            k4 = A.apply_prologue_plain(A.split_heads(k, h), tk, 1e-6, True)
            v4 = A.split_heads(v, h)
            library = lambda: _sdpa(q4, k4, v4, 1.0)  # noqa: E731
        name = label if timed else (f"{label}[{shape} {q.shape[1]:,} x {k.shape[1]:,}]"
                                    if tile is None else f"{label}[block_q {tile}]")
        _compare(name, kernel, plain, state, fault_fn=fault, check_only=not timed, work=work,
                 library_fn=library, phase="probes",
                 fault="the keys of the last kv split left out"
                 if probe is P.cross_smallq_splitkv else "last ragged kv tile dropped")
        if timed:
            _compare(f"{label}[against the shipped {shipped.__name__}]", kernel,
                     lambda: shipped(q, k, v, tq, tk, None, h), state, check_only=True,
                     phase="probes")
        alone = {P.cross_smallkv_pairloop: P.pairloop_prologued,
                 P.cross_smallkv_pairinner: P.pairinner_prologued}.get(probe)
        if timed and alone is not None:
            kn = A.merge_heads(k4)
            ms = queued_time_ms(lambda: alone(q, kn, v, None, tq, h, shift), dev, 5)
            state["kernel_rows"][label]["kernel_ms"] = ms
            log(f"[probes] {label}[its kernel alone, k prologued once; device time of 10 queued "
                f"calls]: {ms:.3f} ms")
        elif timed and probe is P.cross_smallq_splitkv:
            ms = queued_time_ms(kernel, dev, 5)
            state["kernel_rows"][label]["kernel_ms"] = ms
            log(f"[probes] {label}[its whole call, device time of 10 queued calls]: {ms:.3f} ms")
    del x, shapes


def phase_probes(state: dict) -> None:
    """The probe kernels' main path: each CLI of tokensgen_tpu_torch/tools at
    its JAX script's shapes, with the launch counts set to 0 before and read
    after; then each kernel against its plain version with a planted fault,
    timed (CUDA events) for the kernels line."""
    import importlib

    import torch

    from tokensgen_tpu_torch.kernels import probes as P

    dev = state["device"]
    P.reset_launch_counts()
    for cli in PROBE_CLIS:
        log(f"[probes] python -m tokensgen_tpu_torch.tools.{cli} (its JAX script's shapes):")
        t0 = time.perf_counter()
        results = importlib.import_module(f"tokensgen_tpu_torch.tools.{cli}").main(
            ["--device", "cuda"])
        torch.cuda.synchronize()
        state.setdefault("probe_cli_results", {})[cli] = results
        log(f"[probes] {cli} done in {time.perf_counter() - t0:.1f} s")
    state["probe_launches"] = counts = P.launch_counts()
    log(f"[probes] kernel launches of the probe CLIs: {json.dumps(counts)}")
    if min(counts.values()) <= 0:
        raise RuntimeError(f"a probe CLI launched no kernel: {counts}")
    _probe_attention_rows(dev, state)
    _probe_flash_loop_rows(dev, state)
    _probe_matmul_rows(dev, state)
    _probe_exp2_rows(dev, state)
    _probe_maxfree_rows(dev, state)
    torch.cuda.empty_cache()


# the edit path as `infer.py --config tokensgen_tpu/configs/infer_edit.yaml`
# runs it, at full width, with these listed cuts and port settings
EDIT_CONFIG = "tokensgen_tpu/configs/infer_edit.yaml"
EDIT_OVERRIDES = {
    "quant": None,  # bf16, the reference precision (the gen phase runs w8a8 + quant_attn)
    "allow_hash_text_encoder": True,  # no T5 weights or tokenizer in the repo
    "num_inference_steps": 13,  # cut from 52; FIFO needs steps >= 13 latent frames
    "sampling_params.num_partitions": 1,  # cut from 4: 2 lookahead rank windows
    "input_config.edit_item_1.params.max_num_chunks": 1,  # cut from 12
}
# DiT depth on the edit path (and on the queue, variants, load and serve
# phases' runs of it), cut from 42 to keep the whole smoke within its time
# limit: the gen phase runs the same render cut likewise (GEN_RENDER_LAYERS),
# and the dit phase times the full-depth forward; every forward still runs
# K1-K3 in each block
EDIT_LAYERS = 2


def _edit_config(overrides: Optional[dict] = None):
    from tokensgen_tpu_torch.utils.config import load_config

    return load_config(os.path.join(REPO, EDIT_CONFIG), {**EDIT_OVERRIDES, **(overrides or {})})


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


def _vip_dit_forward(pipe, latents, text):
    """``forward(dit=pipe.dit, resampler=pipe.resampler)`` -> (VIP tokens,
    DiT output): the VIP tokens as the edit path makes them (the patch conv
    and the resampler over two chunks of ``latents[:1]``: the condition and
    its repeated-last-frame pad chunk; K4), then one CFG-batched DiT forward
    of ``latents`` on ``text`` at timestep 999 (K1-K3)."""
    import torch

    from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2
    from tokensgen_tpu_torch.pipelines.to2v import apply_patch_proj

    pc, dcfg, dev = pipe.cfg, pipe.dit_config, latents.device
    nf = pc.nf_latent
    img_rope, smp_rope = pipe.resampler_ropes()
    n_vip = min(pipe.resampler_config.num_temporal_queries + 1, nf)
    img_t, img_h, img_w, cond_t, cond_h, cond_w = pipe.vip_grids(1)
    d = dcfg.attention_head_dim
    vip_img = get_3d_rotary_pos_embed_v2(d, img_t[:nf], img_h, img_w, device=dev)
    vip_cond = get_3d_rotary_pos_embed_v2(d, cond_t[:n_vip], cond_h, cond_w, device=dev)
    base_rope = pipe.base_image_rope()
    timestep = torch.full((latents.shape[0],), 999, dtype=torch.int64, device=dev)

    def forward(dit=pipe.dit, resampler=pipe.resampler):
        with torch.no_grad():
            toks = [resampler(apply_patch_proj(dcfg, dit.patch_embed.proj, latents[:1]),
                              img_rope, smp_rope) for _ in range(2)]
            vip = torch.cat(toks, dim=1)[:, :n_vip].expand(latents.shape[0], -1, -1, -1, -1)
            return vip, dit(latents, text, timestep, vip, base_rope, vip_img, vip_cond,
                            pc.vip_scale)

    return forward


def phase_dit(state: dict) -> None:
    import torch

    from tokensgen_tpu_torch.infer import build_pipeline, build_text_encoder
    from tokensgen_tpu_torch.kernels import attention as A

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
    text = build_text_encoder(cfg, smoke=False, device=dev)(["a prompt", ""]).to(dev)
    latents = torch.randn(2, nf, 16, h, w, generator=gen, device=dev)
    forward = _vip_dit_forward(pipe, latents, text)
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
    if min(counts[k] for k in FORWARD_KERNELS) <= 0:
        raise RuntimeError(f"a kernel was not launched by the DiT forward: {counts}")
    _profile(forward, "dit", "dit_forward")
    _quantized_forward(pipe, dcfg, forward, out)


def _quantized_forward(pipe, dcfg, forward, ref) -> None:
    """The same forward through a copy of the DiT quantized to w8a8 with
    quant_attn (infer_gen.yaml's shipped quant, K7 on): timed after a
    warm-up, traced, and its relative L2 drift from the bf16 output ``ref``
    on the same weights and inputs."""
    import copy
    import dataclasses

    import torch

    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.models.dit import quantize_dit

    dev = ref.device
    qcfg = dataclasses.replace(dcfg, quant="w8a8", quant_attn=True)
    t0 = time.perf_counter()
    qdit = quantize_dit(copy.deepcopy(pipe.dit), qcfg)
    torch.cuda.synchronize()
    log(f"[dit] w8a8 + quant_attn copy of the DiT: quantize_dit {time.perf_counter() - t0:.1f} s")
    forward(qdit)  # warm-up (cuBLASLt int8 handles)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    _, out = forward(qdit)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = A.launch_counts()
    drift = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    finite = bool(torch.isfinite(out).all().item())
    log(f"[dit] w8a8 + quant_attn full-width forward: {dt:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, output {tuple(out.shape)} "
        f"finite {finite}; relative L2 drift from the bf16 output {drift:.4e}")
    log(f"[dit] kernel launches in that forward: {json.dumps(counts)}")
    layers = dcfg.num_layers
    if not finite or out.shape != ref.shape:
        raise RuntimeError("the w8a8 DiT forward is not finite or has the wrong shape")
    if (counts["fused_attention_joint_int8"], counts["fused_attention_joint"]) != (layers, 0):
        raise RuntimeError(f"the w8a8 + quant_attn forward did not run K7 per block: {counts}")
    del out
    _profile(lambda: forward(qdit), "dit", "dit_w8a8_forward")
    del qdit
    torch.cuda.empty_cache()


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
    pipe.dit.transformer_blocks = pipe.dit.transformer_blocks[:EDIT_LAYERS]
    torch.cuda.empty_cache()
    item = input_items(cfg)[0]
    num_chunks = min(item.get("max_num_chunks", 2), item.get("max_num_chunks_w_fifo", 25))
    pc = pipe.cfg
    log(f"[edit] {EDIT_CONFIG} with {json.dumps(EDIT_OVERRIDES)}: {pc.width}x{pc.height}, "
        f"{pc.num_frames_per_chunk} frames/chunk, {num_chunks} chunk, "
        f"{pc.num_inference_steps} steps, {pc.num_partitions} partition, DiT depth "
        f"{len(pipe.dit.transformer_blocks)} of 42 layers")
    enc = build_text_encoder(cfg, smoke=False, device=dev)
    prompt = enc([item.get("prompt", "")])
    negative = enc([""])
    # synthetic source video, as infer.py makes one under --smoke
    rng0 = np.random.default_rng(0)
    frames = torch.from_numpy(rng0.uniform(
        -1, 1, size=(1, num_chunks * pc.num_frames_per_chunk, pc.height, pc.width, 3)
    ).astype(np.float32))
    noise = generator_noise(torch.Generator(device=dev).manual_seed(int(cfg.get("seed", 42))))
    timings: dict = {}
    stamps: list = []  # each FIFO emit's host time (the engine syncs once an iteration)
    vip = {}  # the VIP tokens and the generator's state after them, for the queue phase
    encode = pipe.vip_encode_video

    def kept_encode(frames, noise_fn):
        vip["emb"] = encode(frames, noise_fn)
        vip["state"] = noise_fn.generator.get_state()
        return vip["emb"]

    pipe.vip_encode_video = kept_encode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.generate(prompt, negative, frames=frames, num_chunks=num_chunks, noise_fn=noise,
                        timings=timings,
                        emit_callback=lambda i, em: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    del pipe.vip_encode_video
    state["launches"] = A.launch_counts()
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    state["edit_run"] = {"latents": out["latents"], "prompt": prompt.cpu(),
                         "negative": negative.cpu(), "num_chunks": num_chunks, "iter_s": gaps,
                         "vip": vip["emb"].cpu(), "noise_state": vip["state"]}
    log(f"[edit] generate: {total:.1f} s; phases (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
        + f"; peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; FIFO iteration "
        f"(emit to emit, {len(gaps)}): median {statistics.median(gaps):.4f} s")
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


# ---------------------------------------------------------- the queue phase
# The queue-sharded FIFO (`sharding/mesh.py`, `sampling/fifo.py`'s group
# path) on the edit phase's run, through To2VPipeline.generate as `infer
# --queue-devices` drives it: 2 processes sharing the card over Gloo (NCCL
# refuses two ranks on one card), each building the pipeline as infer.py
# does (random weights from the config's seed, DiT depth EDIT_LAYERS),
# rank 0 running every stage before the FIFO, both running the FIFO (R = 2
# windows: one each). Rank 0 starts from the edit phase's VIP tokens and
# its noise generator's state right after them (the VAE encode, ~18 s, is
# not run again), so its latents must be bit-equal to the edit phase's one
# process. Where 2 cards are visible, NCCL over them as well; where 4 are,
# R = 4 windows (2 partitions) on one card and over four, bit-equal.
QUEUE_TIMEOUT_S = 300.0


def _queue_rank(group, cfg, run: dict):
    """One rank of the queue phase's group (a spawned process): the edit
    phase's generate from its VIP tokens on, undecoded, over ``group`` ->
    on rank 0 its latents and what it measured."""
    import torch

    from tokensgen_tpu_torch.infer import build_pipeline, check_weights_agree
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.sampling.base import generator_noise

    torch.backends.cuda.matmul.allow_tf32 = False  # as the env phase sets it
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    pipe, _ = build_pipeline(cfg, smoke=False, device=group.device)
    pipe.dit.transformer_blocks = pipe.dit.transformer_blocks[:EDIT_LAYERS]
    torch.cuda.empty_cache()
    check_weights_agree(group, pipe)
    build_s = time.perf_counter() - t0
    if not group.leader:
        while pipe.follow(group):
            pass
        return None
    group.timed = True  # each merge synchronised and timed
    gen = torch.Generator(device=group.device)
    gen.set_state(run["noise_state"])
    timings, stamps = {}, []
    A.reset_launch_counts()
    try:
        out = pipe.generate(run["prompt"], run["negative"],
                            image_embeddings=run["vip"].to(group.device),
                            num_chunks=run["num_chunks"], noise_fn=generator_noise(gen),
                            decode=False, timings=timings,
                            emit_callback=lambda i, em: stamps.append(time.perf_counter()),
                            group=group)
    finally:
        group.send(None)  # the other ranks' stop
    return {"latents": out["latents"], "timings": timings, "build_s": build_s,
            "iter_s": [b - a for a, b in zip(stamps, stamps[1:])], "merge": dict(group.stats),
            "launches": A.launch_counts(), "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _queue_run(label: str, n: int, backend: str, state: dict, ref: Optional[dict],
               overrides: Optional[dict] = None) -> dict:
    """`_queue_rank` on ``n`` ranks (the edit config with ``overrides``);
    fails unless its latents equal ``ref``'s, when given -> rank 0's
    result."""
    import torch

    from tokensgen_tpu_torch.sharding import mesh

    run = state["edit_run"]
    t0 = time.perf_counter()
    res = mesh.launch(_queue_rank, n, (_edit_config(overrides), {
        k: v for k, v in run.items() if k not in ("latents", "iter_s")}),
        device="cuda", backend=backend, timeout_s=QUEUE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    log(f"[queue] {label}: {n} rank(s), launch to result {wall:.1f} s (rank 0: pipeline built "
        f"and weights agreed in {res['build_s']:.1f} s; generate phases (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in res["timings"].items())
        + f"; peak {res['peak_gib']:.2f} GiB); FIFO iteration (emit to emit, "
        f"{len(res['iter_s'])}): median {statistics.median(res['iter_s']):.4f} s")
    merges = res["merge"]["all_reduce_s"]
    if merges:
        log(f"[queue] {label}: merge {len(merges)} all-reduces of "
            f"{res['merge']['all_reduce_bytes'] / len(merges) / 1e6:.2f} MB, median "
            f"{statistics.median(merges) * 1e3:.2f} ms, the first {merges[0] * 1e3:.2f} ms (device "
            f"synchronised around each, the wait for the slower rank included)")
    if ref is not None:
        got = res["latents"]
        same_shape = got.shape == ref["latents"].shape
        diff = (got.float() - ref["latents"].float()).abs().max().item() if same_shape else None
        equal = bool(same_shape and torch.equal(got, ref["latents"]))
        log(f"[queue] {label}: FIFO iteration against {ref['label']}'s "
            f"{statistics.median(ref['iter_s']):.4f} s; latents {tuple(got.shape)} against "
            f"{ref['label']}'s: max |difference| {diff}, bit-equal {equal}; rank 0's launches "
            f"{json.dumps(res['launches'])}")
        if not equal:
            raise RuntimeError(f"{label}: the sharded FIFO's latents differ from {ref['label']}'s")
    # rank 0 starts from the VIP tokens: the DiT's kernels, not the resampler's K4
    if min(res["launches"][k] for k in FORWARD_KERNELS if k != "flash_attention_bhsd") <= 0:
        raise RuntimeError(f"{label}: rank 0 did not run the DiT's kernels: {res['launches']}")
    return dict(res, label=label)


def phase_queue(state: dict) -> None:
    import torch

    if "edit_run" not in state:
        phase_edit(state)
    # the main process's pipeline is not needed here: the ranks build their own
    pipe = state.pop("pipe", None)
    del pipe
    torch.cuda.empty_cache()
    run = state["edit_run"]
    edit = {"latents": run["latents"], "iter_s": run["iter_s"],
            "label": "the edit phase's one process"}
    state["queue_launches"] = _queue_run("Gloo, one card shared", 2, "gloo", state,
                                         edit)["launches"]
    count = torch.cuda.device_count()
    if count < 2:
        log(f"[queue] NCCL (a card a rank): {count} card visible, not run")
        return
    _queue_run("NCCL over 2 cards", 2, "nccl", state, edit)  # R = 2 windows
    if count >= 4:  # R = 4 windows (2 partitions): one card, then four
        parts = {"sampling_params.num_partitions": 2}
        one = _queue_run("R = 4 on one card", 1, "nccl", state, None, parts)
        _queue_run("NCCL over 4 cards, R = 4", 4, "nccl", state, one, parts)


# -------------------------------------------------------- the variants phase
# The rest of single-GPU inference (PR 16's slice), each at full width with
# random weights: the DINOv2 edit path through the port's own builders
# (`infer_edit.yaml` with `use_vae_as_encoder: false` and the resampler's
# input at DINOv2-large's 1,024; the DiT cut as the edit phase's, EDIT_LAYERS
# deep, 13 steps, 1 partition, undecoded), the float32 K4 against its plain
# version at DINOv2's shape, the q / k / v projection three GEMMs against
# one fused GEMM, one CogVideoX-5b forward (depth VARIANT_LAYERS) for each of
# VIP func_types "2"-"4", and one CogVideoX-2b width sincos forward, each
# with its first layer's attention calls held to the plain version; first
# each variant at a small size on the host (plain attention) against the
# card (the kernels).
DINOV2_OVERRIDES = {
    "use_vae_as_encoder": False,
    "video_ipadapter_params.resampler_params.embedding_dim": 1024,  # DINOv2-large's width
    # cut from 12 to 2, not 1: the DINOv2 path adds no repeated-last-frame
    # chunk, so 1 chunk gives 4 temporal VIP frames where the base pass reads
    # 5 (the VAE path's pad chunk makes them 8), in the JAX package as here
    "input_config.edit_item_1.params.max_num_chunks": 2,
}
VARIANT_LAYERS = 2  # DiT depth of the func_type and sincos forwards, cut from 42 / 30
# host plain attention vs the card's kernels at the small size (bf16)
SMALL_REL_L2_BOUND = 1e-2


def _variant_inputs(dev, cfg, frames: int, gen, vip_frames: int = 5):
    """(latents, text, timestep, VIP tokens) for a DiT forward of ``cfg`` at
    the edit path's 60 x 90 latents (B=2, as the CFG pair), on ``dev``."""
    import torch

    vc = cfg.vip
    lat = torch.randn(2, frames, 16, cfg.sample_height, cfg.sample_width, generator=gen,
                      device=dev)
    text = 0.1 * torch.randn(2, cfg.max_text_seq_length, cfg.text_embed_dim, generator=gen,
                             device=dev)
    vip = torch.randn(2, vip_frames, vc.output_dim, vc.num_height_queries, vc.num_width_queries,
                      generator=gen, device=dev)
    return lat, text, torch.full((2,), 999, dtype=torch.int64, device=dev), vip


def _variant_ropes(dcfg, frames: int, ar_frames: int, device, vip_frames: int = 5):
    """Keyword ropes of a rotary DiT forward: the base table over the frames
    the base attention sees (without the ar frames) and, with a VIP branch,
    the vip-image one over all, the condition one over the VIP frames at
    offset 1000."""
    import numpy as np

    from tokensgen_tpu_torch.core.rope import get_3d_rotary_pos_embed_v2

    if not dcfg.use_rotary_positional_embeddings:
        return {}
    d, p = dcfg.attention_head_dim, dcfg.patch_size
    hp, wp = dcfg.sample_height // p, dcfg.sample_width // p
    vc = dcfg.vip

    def rope(t, h, w):
        return get_3d_rotary_pos_embed_v2(d, t, np.arange(h), np.arange(w), device=device)

    base = {"image_rotary_emb": rope(np.arange(frames - ar_frames), hp, wp)}
    if vc is None:
        return base
    return {**base, "vip_image_rotary_emb": rope(np.arange(frames), hp, wp),
            "vip_condition_rotary_emb": rope(np.arange(vip_frames) + 1000.0,
                                             vc.num_height_queries, vc.num_width_queries)}


def _small_variant_checks(dev) -> None:
    """Each variant at a small size (2 layers, 2 heads of 64, bf16): one
    forward on the host (plain attention) and one on the card (the kernels)
    with the same weights and inputs, within SMALL_REL_L2_BOUND: func_types
    "2"-"4", the sincos mode with a vip_pos_embedding, the raw-token output
    mode."""
    import copy

    import torch

    from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig, VIPConfig
    from tokensgen_tpu_torch.utils.params import init_params_

    vkw = dict(output_dim=64, num_temporal_queries=2, num_height_queries=4, num_width_queries=6,
               length=3 * 4 * 6)
    base = dict(attention_head_dim=64, num_attention_heads=2, sample_height=16, sample_width=24,
                dtype=torch.bfloat16)
    cases = {f"func_type {ft}": dict(vip=VIPConfig(func_type=ft, **vkw, **(
        dict(ar_length=8 * 12, scale_ar=0.7) if ft == "4" else {}))) for ft in "234"}
    cases["sincos"] = dict(vip=VIPConfig(**vkw), use_rotary_positional_embeddings=False)
    cases["raw-token"] = dict(vip=None, use_output_projection=False, patch_size=1,
                              sample_height=8, sample_width=12)
    for label, kw in cases.items():
        cfg = DiTConfig.tiny(**dict(base, **kw))
        gen = torch.Generator().manual_seed(3)
        host = init_params_(CogVideoXTransformer(cfg), gen).eval()
        card = copy.deepcopy(host).to(dev)
        f, ar = 3, (1 if cfg.vip is not None and cfg.vip.func_type == "4" else 0)
        x = torch.randn(1, f, 16, cfg.sample_height, cfg.sample_width, generator=gen)
        text = torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim, generator=gen)
        extra = {}
        if cfg.vip is not None:
            extra = dict(vip_hidden_states=torch.randn(1, 3, 64, 4, 6, generator=gen),
                         vip_scale=0.6)
            if label == "sincos":
                extra["vip_pos_embedding"] = torch.randn(1, 3 * 4 * 6, cfg.inner_dim,
                                                         generator=gen)
        ropes = (_variant_ropes(cfg, f, ar, None, vip_frames=3)
                 if cfg.use_rotary_positional_embeddings else {})

        def run(model, device):
            mv = {k: tuple(z.to(device) for z in r) for k, r in ropes.items()}
            kw = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                  for k, v in extra.items()}
            with torch.no_grad():
                return model(x.to(device), text.to(device), torch.tensor([700], device=device),
                             **mv, **kw).float().cpu()

        ref, out = run(host, "cpu"), run(card, dev)
        rel = ((out - ref).norm() / ref.norm()).item()
        log(f"[variants] small-input check, {label} (host plain attention vs card kernels): "
            f"output {tuple(out.shape)} relative L2 error {rel:.3e} (bound {SMALL_REL_L2_BOUND})")
        if not (rel < SMALL_REL_L2_BOUND and torch.isfinite(out).all()):
            raise RuntimeError(f"the card's {label} DiT forward disagrees with the host's")


def _timed_forward(model, args, kwargs, dev):
    """(output, device-synchronised seconds of the second of two calls,
    launches of that call)."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    with torch.no_grad():
        model(*args, **kwargs)
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        out = model(*args, **kwargs)
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, A.launch_counts()


def _qkv_projection_timing(dev) -> None:
    """The q / k / v projection of the CogVideoX-5b joint sequence (B=2,
    226 + 17,550 rows of 3,072, bf16) as the port runs it, three [3,072 ->
    3,072] GEMMs, and as the JAX package's fuse_qkv runs it, one [3,072 ->
    9,216] GEMM cut in thirds: CUDA-event times (median of 5) and the
    largest difference of the outputs (the port keeps the three: ROADMAP,
    deliberate differences)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn(2, 17776, 3072, generator=gen, device=dev).bfloat16()
    ws = [(0.02 * torch.randn(3072, 3072, generator=gen, device=dev)).bfloat16()
          for _ in range(3)]
    bs = [(0.02 * torch.randn(3072, generator=gen, device=dev)).bfloat16() for _ in range(3)]
    w3, b3 = torch.cat(ws), torch.cat(bs)

    def three():
        return [F.linear(x, w, b) for w, b in zip(ws, bs)]

    def fused():
        return F.linear(x, w3, b3).chunk(3, dim=-1)

    diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(three(), fused()))
    t3, tf = _cuda_time_ms(three, 5), _cuda_time_ms(fused, 5)
    log(f"[variants] q / k / v projection of [2, 17,776, 3,072] bf16: three GEMMs {t3:.3f} ms, "
        f"one fused GEMM {tf:.3f} ms; max abs difference {diff:.3e}")


def _f32_k4_row(dev, state) -> None:
    """The float32 K4 against its plain version at DINOv2-large's shape
    [49, 16, 257, 64] (a 1-row q tail and a 1-key kv tail), the operands as
    the encoder makes them (strided views of [49, 257, 1024]); the library
    call is float32 SDPA."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    gen = torch.Generator(device=dev).manual_seed(17)
    q, k, v = (torch.randn(49, 257, 1024, generator=gen, device=dev).view(49, 257, 16, 64)
               .transpose(1, 2) for _ in range(3))
    scale = 64 ** -0.5
    zeros = torch.zeros(49, 257, device=dev)
    b, h, sq, d = q.shape
    work = (0.0, _nbytes(q, k, v, q), 0.0, float(b * h * sq * sq), 4.0 * b * h * sq * sq * d)
    fma_s, tf32_s = f32_matmul_s(work[4])
    log(f"[variants] {F32_KERNEL} bound's products: {fma_s * 1e3:.3f} ms as FMAs on the CUDA "
        f"cores ({work[4] / 1e9:.2f} GFLOP at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s), "
        f"{tf32_s * 1e3:.3f} ms as {TF32_PASSES} TF32 passes on the tensor cores (at "
        f"{PEAK_TF32_FLOPS / 1e12:g} TFLOP/s); the lesser counts")
    _compare(F32_KERNEL, lambda: A.flash_attention_bhsd_f32(q, k, v, None, scale),
             lambda: A.attention_plain(q, k, v, zeros, scale), state,
             fault_fn=lambda: A.attention_plain(q, k[:, :, :-1], v[:, :, :-1], zeros[:, :-1],
                                                scale),
             fault="last key dropped", work=work, phase="variants",
             library_fn=lambda: _sdpa(q, k, v, scale),
             bounds=(F32_REL_L2_BOUND, F32_MAX_ABS_REL))


def _dinov2_edit(pipe, cfg, dev, state) -> None:
    """The DINOv2 edit path: To2VPipeline.generate on a synthetic source of
    2 chunks, the DiT cut to EDIT_LAYERS, undecoded (the edit phase decodes
    the same render); the encoder's seconds per chunk timed apart."""
    import numpy as np
    import torch

    from tokensgen_tpu_torch.infer import build_text_encoder
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.models.dinov2 import preprocess_frames
    from tokensgen_tpu_torch.sampling.base import generator_noise
    from tokensgen_tpu_torch.utils.config import input_items

    pc, enc = pipe.cfg, pipe.image_encoder
    item = input_items(cfg)[0]
    num_chunks = item.get("max_num_chunks", 2)
    pipe.dit.transformer_blocks = pipe.dit.transformer_blocks[:EDIT_LAYERS]
    torch.cuda.empty_cache()
    te = build_text_encoder(cfg, smoke=False, device=dev)
    prompt, negative = te([item.get("prompt", "")]), te([""])
    frames = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, size=(1, num_chunks * pc.num_frames_per_chunk, pc.height, pc.width, 3)
    ).astype(np.float32))
    # the encoder alone on one chunk of frames and on its zero images
    px = preprocess_frames(frames[0, :pc.num_frames_per_chunk].to(dev), enc.cfg.image_size)
    with torch.no_grad():
        for _ in range(2):  # a warm-up, then the timed pair
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = enc(px), enc(torch.zeros_like(px))
            torch.cuda.synchronize()
            t_enc = time.perf_counter() - t0
    log(f"[variants] DINOv2-large encode of one chunk ({tuple(px.shape)} frames and as many "
        f"zero images, float32): {t_enc:.3f} s; penultimate hidden state "
        f"{tuple(feats[0].shape)} finite {bool(torch.isfinite(feats[0]).all())}")
    timings: dict = {}
    noise = generator_noise(torch.Generator(device=dev).manual_seed(int(cfg.get("seed", 42))))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.generate(prompt, negative, frames=frames, num_chunks=num_chunks, noise_fn=noise,
                        decode=False, timings=timings)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = A.launch_counts()
    state["variants_launches"]["dinov2_edit"] = counts
    state["dinov2"] = dict(encode_chunk_s=t_enc, vip_encode_s=timings.get("vip_encode"),
                           generate_s=total)
    log(f"[variants] DINOv2 edit path ({num_chunks} chunks, {pc.num_inference_steps} steps, "
        f"{pc.num_partitions} partition, DiT depth {len(pipe.dit.transformer_blocks)} of 42, "
        f"undecoded): {total:.1f} s; phases (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
        + f" ({timings.get('vip_encode', 0.0) / num_chunks:.2f} s a chunk to VIP tokens); peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"[variants] kernel launches on the DINOv2 edit path: {json.dumps(counts)}")
    blocks = enc.cfg.num_layers - 1
    want_f32 = num_chunks * 2 * blocks  # each chunk's frames and zero images, each block
    nf = pc.nf_latent
    shape = (1, num_chunks * nf, 16, pc.height // 8, pc.width // 8)
    lat = out["latents"]
    finite = bool(torch.isfinite(lat).all()) and bool(torch.isfinite(out["orig_latents"]).all())
    log(f"[variants] latents {tuple(lat.shape)} finite {finite} mean "
        f"{lat.float().mean().item():.4f} std {lat.float().std().item():.4f}; float32 K4 "
        f"launches {counts[F32_KERNEL]} (expected {want_f32} = {num_chunks} chunks x 2 x "
        f"{blocks} blocks)")
    if tuple(lat.shape) != shape or not finite:
        raise RuntimeError(f"DINOv2 edit latents: expected finite {shape}")
    if counts[F32_KERNEL] != want_f32 or min(counts[k] for k in FORWARD_KERNELS) <= 0:
        raise RuntimeError(f"the DINOv2 edit path did not run the expected kernels: {counts}")


# each func_type's launches per DiT layer in one forward (the port's routing
# at these shapes): "2" / "3" video -> VIP (17,550 q x 480 kv) on K2, "2"'s
# VIP -> [video ‖ vip] (480 q x 18,030 kv) on K3; "4" the cross into ar
# (17,776 q x 1,350 kv) and [ar ‖ vip] (1,830 q x 19,606 kv) on K1, the
# cross into VIP on K2; the sincos 2b forward as "1" (K1, K2, K3)
VARIANT_ROUTES = {
    "2": {"fused_attention_joint": 1, "fused_attention_cross_smallkv": 1,
          "fused_attention_cross_smallq": 1},
    "3": {"fused_attention_joint": 1, "fused_attention_cross_smallkv": 1,
          "fused_attention_cross_smallq": 0},
    "4": {"fused_attention_joint": 3, "fused_attention_cross_smallkv": 1,
          "fused_attention_cross_smallq": 0},
    "sincos": {"fused_attention_joint": 1, "fused_attention_cross_smallkv": 1,
               "fused_attention_cross_smallq": 1},
}


def _first_layer_attention_checks(model, args, kwargs, label: str, n_calls: int) -> None:
    """The first ``n_calls`` attention calls of one forward (its first
    layer's), captured on their way through the DiT's
    `fused_flash_attention` with the kernel each launched, then each held to
    that kernel's plain version on the same card tensors; these launches
    are not the path's. Planted fault: the last eighth of the keys dropped
    (on these activations the ragged last kv tile, 112 of 17,776 keys,
    moved K1's output by 4.8e-3 relative L2, inside the bound)."""
    import torch

    import tokensgen_tpu_torch.models.dit as D
    from tokensgen_tpu_torch.kernels import attention as A

    real, calls = D.fused_flash_attention, []

    def capture(q, k, v, tabs_q, tabs_k, key_bias=None, heads=None, **kw):
        before = A.launch_counts()
        out = real(q, k, v, tabs_q, tabs_k, key_bias, heads=heads, **kw)
        if len(calls) < n_calls:
            after = A.launch_counts()
            launched = [name for name, n in after.items() if n != before[name]]
            if len(launched) != 1:
                raise RuntimeError(f"{label}: an attention call launched {launched}")
            calls.append((launched[0], dict(q=q, k=k, v=v, tabs_q=tabs_q, tabs_k=tabs_k,
                                            key_bias=key_bias, heads=heads)))
        return out

    D.fused_flash_attention = capture
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        D.fused_flash_attention = real
    if len(calls) != n_calls:
        raise RuntimeError(f"{label}: {len(calls)} attention calls captured, {n_calls} expected")
    for name, c in calls:
        sq, skv = c["q"].shape[1], c["k"].shape[1]
        _compare(f"{name}[{label}, {sq:,} q x {skv:,} kv, {c['heads']} heads]",
                 lambda: run_kernel(name, c), lambda: run_plain(name, c), {}, check_only=True,
                 fault_fn=lambda: run_plain(name, c, kv_len=skv - skv // 8),
                 fault="the last eighth of the keys dropped", phase="variants")


def _variant_forwards(dev, state) -> None:
    """One full-width forward (B=2, 13 latent frames of 60 x 90, VIP
    tokens of 5 x 8 x 12) for each of func_types "2"-"4" on CogVideoX-5b
    (for "4" one more latent frame, the ar context: 1,350 tokens) and for
    the sincos CogVideoX-2b (30 heads x 64, with a vip_pos_embedding), each
    VARIANT_LAYERS deep: its time, its launches against VARIANT_ROUTES, a
    finite output of the expected shape, and its first layer's attention
    calls held to their plain versions."""
    import torch

    from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig, VIPConfig
    from tokensgen_tpu_torch.utils.params import build_on_device

    for label, route in VARIANT_ROUTES.items():
        gen = torch.Generator(device=dev).manual_seed(23)
        ar = 1 if label == "4" else 0
        if label == "sincos":
            cfg = DiTConfig.cogvideox_2b(vip=VIPConfig(), num_layers=VARIANT_LAYERS)
        else:
            vc = VIPConfig(func_type=label, scale_ar=0.7, ar_length=ar * 45 * 30)
            cfg = DiTConfig.cogvideox_5b(vip=vc, num_layers=VARIANT_LAYERS)
        model = build_on_device(lambda: CogVideoXTransformer(cfg), dev, gen)
        lat, text, ts, vip = _variant_inputs(dev, cfg, 13 + ar, gen)
        kw = dict(vip_hidden_states=vip, vip_scale=0.6, **_variant_ropes(cfg, 13 + ar, ar, dev))
        if label == "sincos":
            kw["vip_pos_embedding"] = 0.1 * torch.randn(1, 480, cfg.inner_dim, generator=gen,
                                                        device=dev)
        out, dt, counts = _timed_forward(model, (lat, text, ts), kw, dev)
        state["variants_launches"][f"func_type_{label}" if label != "sincos" else label] = counts
        want = {k: n * cfg.num_layers for k, n in route.items()}
        shape = (2, 13, 16, 60, 90)
        finite = bool(torch.isfinite(out).all())
        name = "CogVideoX-2b sincos" if label == "sincos" else f"CogVideoX-5b func_type {label}"
        log(f"[variants] {name} forward ({cfg.num_layers} layers, {cfg.num_attention_heads} heads "
            f"x {cfg.attention_head_dim}, B=2, {13 + ar} latent frames{' (1 ar)' if ar else ''}): "
            f"{dt:.3f} s, output {tuple(out.shape)} finite {finite}; launches "
            f"{json.dumps({k: counts[k] for k in want})} (expected {json.dumps(want)})")
        if tuple(out.shape) != shape or not finite or any(counts[k] != n for k, n in want.items()):
            raise RuntimeError(f"the {name} forward: wrong shape, not finite or wrong routing")
        del out
        _first_layer_attention_checks(model, (lat, text, ts), kw, name, sum(route.values()))
        del model
        torch.cuda.empty_cache()


def phase_variants(state: dict) -> None:
    import gc

    import torch

    from tokensgen_tpu_torch.infer import build_pipeline
    from tokensgen_tpu_torch.utils.config import load_config

    dev = state["device"]
    state["variants_launches"] = {}
    _small_variant_checks(dev)
    _f32_k4_row(dev, state)
    _qkv_projection_timing(dev)
    cfg = load_config(os.path.join(REPO, EDIT_CONFIG), dict(EDIT_OVERRIDES, **DINOV2_OVERRIDES))
    log(f"[variants] {EDIT_CONFIG} with {json.dumps(dict(EDIT_OVERRIDES, **DINOV2_OVERRIDES))}")
    t0 = time.perf_counter()
    pipe, _ = build_pipeline(cfg, smoke=False, device=dev)
    torch.cuda.synchronize()
    enc = pipe.image_encoder
    log(f"[variants] build_pipeline (random weights made on the card, DINOv2-large included): "
        f"{time.perf_counter() - t0:.1f} s; encoder {enc.cfg.num_layers - 1} of "
        f"{enc.cfg.num_layers} blocks, {enc.cfg.num_heads} heads x "
        f"{enc.cfg.hidden_size // enc.cfg.num_heads}, float32, "
        f"{sum(p.numel() for p in enc.parameters()) / 1e6:.1f} M parameters")
    _dinov2_edit(pipe, cfg, dev, state)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    _variant_forwards(dev, state)


# ------------------------------------------------------------ the load phase
# The port's loaders on files this phase writes (no weights, tokenizer or
# video are in the repository): T5-XXL at full width, depth cut to
# LOAD_T5_LAYERS of 24, read back through T5TextEncoder.from_pretrained; the
# full 24-layer T5-XXL built from a seed encoding the edit prompts at 226
# tokens; the full-width To2V DiT (depth EDIT_LAYERS of 42, bf16, diffusers
# names) and resampler read back through infer.load_checkpoint_dit, then a
# CFG forward and a VIP encode (K1-K4) on them held bit-equal to the
# in-memory model's; the gen PCA artifacts at T2To's width; a 49-frame
# 720x480 mp4 through load_video; and the CLI itself on tiny written files.
LOAD_T5_LAYERS = 2
T2TO_TOKEN_DIM = 3072
PATH_KERNELS = ("fused_attention_joint", "fused_attention_cross_smallkv",
                "fused_attention_cross_smallq", "flash_attention_bhsd")
CLI_KERNELS = ("fused_attention_joint", "flash_attention_bhsd")


def write_wordlevel_tokenizer(d: str, words) -> None:
    """A ``tokenizer.json`` written as JSON (no tokenizer library needed):
    a WordLevel vocabulary of ``<pad>`` 0, ``</s>`` 1, ``<unk>`` 2 and
    ``words``, split on whitespace and punctuation, ``</s>`` appended, as
    tests/_tiny_t5.py builds one with the ``tokenizers`` package; and the
    ``tokenizer_config.json`` beside it."""
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    for w in words:
        vocab.setdefault(w, len(vocab))
    seq = lambda i, t: {"Sequence": {"id": i, "type_id": t}}  # noqa: E731
    eos = {"SpecialToken": {"id": "</s>", "type_id": 0}}
    tok = {
        "version": "1.0", "truncation": None,
        "padding": {"strategy": "BatchLongest", "direction": "Right", "pad_to_multiple_of": None,
                    "pad_id": 0, "pad_type_id": 0, "pad_token": "<pad>"},
        "added_tokens": [], "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": {
            "type": "TemplateProcessing", "single": [seq("A", 0), eos],
            "pair": [seq("A", 0), seq("B", 1)],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}}},
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
    }
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(tok, f)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
                   "eos_token": "</s>", "unk_token": "<unk>"}, f)


def _words(text: str) -> list:
    """``text`` split as the Whitespace pre-tokenizer splits it."""
    return re.findall(r"\w+|[^\w\s]+", text)


def _host_rss_gib() -> float:
    """VmRSS of this process, GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            key, _, val = line.partition(":")
            if key == "VmRSS":
                return int(val.split()[0]) / 2**20
    raise RuntimeError("no VmRSS in /proc/self/status")


class _HostRssPeak:
    """Peak VmRSS while open, sampled every 10 ms by a thread, beside its
    value at the start."""

    def __enter__(self):
        import threading

        self.start = self.peak = _host_rss_gib()
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(0.01):
                self.peak = max(self.peak, _host_rss_gib())

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def __str__(self):
        return (f"peak host RSS {self.peak:.2f} GiB (+{self.peak - self.start:.2f} over the "
                f"step's start)")


def _check_equal_state(label: str, module, want: dict) -> None:
    """Every tensor of ``module`` bit-equal to ``want`` (same dtype)."""
    import torch

    got = module.state_dict()
    bad = sorted(set(got) ^ set(want)) + [
        k for k in got if k in want and not (got[k].dtype == want[k].dtype
                                              and torch.equal(got[k], want[k]))]
    log(f"[load] {label}: {len(got)} tensors, "
        f"{sum(v.numel() for v in got.values()) / 1e9:.3f} B values, bit-equal to what was "
        f"written: {not bad}")
    if bad:
        raise RuntimeError(f"{label}: tensors differ from what was written: {bad[:5]}")


def _load_t5(dev, tmp: str, prompts, state) -> "torch.Tensor":
    """Steps 1 and 2: the HF-layout T5-XXL dir written and read back, then
    the full T5-XXL's encode of ``prompts``. Returns the embeddings (f32, on
    the card)."""
    import torch

    from tokensgen_tpu_torch.models.t5 import T5Config, T5Encoder
    from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors
    from tokensgen_tpu_torch.models.text_encoder import (CachedTextEncoder, FastTokenizer,
                                                         T5TextEncoder)
    from tokensgen_tpu_torch.utils.params import build_on_device

    gen = torch.Generator(device=dev).manual_seed(11)
    t5_dir = os.path.join(tmp, "text_encoder")
    os.makedirs(t5_dir)
    write_wordlevel_tokenizer(t5_dir, [w for p in prompts for w in _words(p)])
    cut = T5Config.xxl(num_layers=LOAD_T5_LAYERS)
    written = build_on_device(lambda: T5Encoder(cut), dev, gen)
    sd = {k: v for k, v in written.state_dict().items() if k != "encoder.embed_tokens.weight"}
    t0 = time.perf_counter()
    save_safetensors(os.path.join(t5_dir, "model.safetensors"), sd)  # tied: written once
    size = os.path.getsize(os.path.join(t5_dir, "model.safetensors")) / 2**30
    log(f"[load] T5-XXL HF dir written ({LOAD_T5_LAYERS} of 24 layers, d_model {cut.d_model}, "
        f"{cut.num_heads} heads x {cut.d_kv}, d_ff {cut.d_ff}, vocab {cut.vocab_size}, bf16): "
        f"{size:.2f} GiB in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with _HostRssPeak() as rss:
        t0 = time.perf_counter()
        enc = T5TextEncoder.from_pretrained(t5_dir, 226, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    log(f"[load] T5TextEncoder.from_pretrained: {dt:.2f} s ({size / dt:.2f} GiB/s), {rss}, "
        f"peak device {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
        f"config {enc.model.cfg}")
    _check_equal_state("T5 read back", enc.model, written.state_dict())
    del written, enc
    torch.cuda.empty_cache()

    full_cfg = T5Config.xxl()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    full = build_on_device(lambda: T5Encoder(full_cfg), dev, gen)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in full.parameters())
    log(f"[load] T5-XXL built on the card from a seed: {n / 1e9:.3f} B parameters, "
        f"{full_cfg.num_layers} layers, in {time.perf_counter() - t0:.1f} s")
    ids, mask = (torch.from_numpy(a).to(dev) for a in FastTokenizer(t5_dir)(prompts, 226))
    log(f"[load] prompts tokenized through tokenizers (tokenizer.json): "
        f"{mask.sum(1).tolist()} of 226 tokens")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        with torch.no_grad():
            out = full(ids, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    finite = bool(torch.isfinite(out).all().item())
    log(f"[load] T5-XXL encode of {len(prompts)} prompts x 226 tokens: first {times[0]:.3f} s, "
        f"then {times[1]:.3f} / {times[2]:.3f} s; peak device "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; output {tuple(out.shape)} "
        f"{out.dtype} finite {finite} std {out.float().std().item():.4f}")
    if not finite or tuple(out.shape) != (len(prompts), 226, full_cfg.d_model):
        raise RuntimeError("the T5-XXL encode is not finite or has the wrong shape")
    state["load_times"]["t5_encode_s"] = times[1]
    # freed as infer.main frees it: each prompt through CachedTextEncoder, then
    # the encoder dropped and the allocator's cache emptied
    nbytes = sum(p.numel() * p.element_size() for p in full.parameters()) / 2**30
    enc = CachedTextEncoder(T5TextEncoder(full, FastTokenizer(t5_dir), 226))
    del full
    embeds = {p: enc([p])[0] for p in prompts}
    held = torch.cuda.memory_allocated(dev) / 2**30
    del enc
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(dev) / 2**30
    log(f"[load] T5-XXL ({nbytes:.2f} GiB of weights) freed as infer.main frees it "
        f"({len(embeds)} prompts encoded through CachedTextEncoder first): device memory "
        f"allocated {held:.2f} GiB with it, {after:.2f} GiB after, reserved "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB")
    if held - after < nbytes:
        raise RuntimeError("the T5-XXL encoder's weights were not freed")
    return out.float()


def _load_dit(dev, tmp: str, cfg, text, state) -> dict:
    """Steps 3 and 4: the full-width To2V DiT (EDIT_LAYERS deep) and the
    resampler written in the diffusers layout and read back, then the VIP
    encode and CFG forward on both. Returns the loaded run's launches."""
    import dataclasses

    import torch

    from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors
    from tokensgen_tpu_torch.convert.torch_weights import read_safetensors_dir
    from tokensgen_tpu_torch.infer import _configs, load_checkpoint_dit
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, graft_vip_params
    from tokensgen_tpu_torch.models.resampler import Resampler
    from tokensgen_tpu_torch.pipelines.to2v import To2VPipeline
    from tokensgen_tpu_torch.utils.params import build_on_device, load_on_device

    dcfg, rcfg, _, pcfg = _configs(cfg, False, dev)
    dcfg = dataclasses.replace(dcfg, quant=None, quant_attn=False, num_layers=EDIT_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(13)
    written = graft_vip_params(build_on_device(lambda: CogVideoXTransformer(dcfg), dev, gen))
    written_rs = build_on_device(lambda: Resampler(rcfg), dev, gen)
    ckpt = os.path.join(tmp, "CogVideoX-5b")
    rs_dir = os.path.join(ckpt, "resampler")
    os.makedirs(rs_dir)
    t0 = time.perf_counter()
    save_safetensors(os.path.join(ckpt, "diffusion_pytorch_model.safetensors"),
                     written.state_dict())
    save_safetensors(os.path.join(rs_dir, "diffusion_pytorch_model.safetensors"),
                     written_rs.state_dict())
    size = sum(os.path.getsize(os.path.join(d, "diffusion_pytorch_model.safetensors"))
               for d in (ckpt, rs_dir)) / 2**30
    log(f"[load] DiT ({dcfg.num_layers} of 42 layers, {dcfg.num_attention_heads} heads x "
        f"{dcfg.attention_head_dim}, VIP \"1\", bf16) and resampler written in the diffusers "
        f"layout: {size:.2f} GiB in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with _HostRssPeak() as rss:
        t0 = time.perf_counter()
        dit = load_checkpoint_dit(ckpt, dcfg, dev)  # top level only: not resampler/
        torch.cuda.synchronize()
        t_dit = time.perf_counter() - t0
        t0 = time.perf_counter()
        resampler = load_on_device(lambda: Resampler(rcfg), read_safetensors_dir(rs_dir), dev)
        torch.cuda.synchronize()
        t_rs = time.perf_counter() - t0
    log(f"[load] load_checkpoint_dit {t_dit:.2f} s, resampler {t_rs:.2f} s "
        f"({size / (t_dit + t_rs):.2f} GiB/s); {rss}; peak device "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (both models resident)")
    state["load_times"].update(dit_load_s=t_dit, resampler_load_s=t_rs,
                               host_rss_gib=rss.peak)
    _check_equal_state("DiT read back", dit, written.state_dict())
    _check_equal_state("resampler read back", resampler, written_rs.state_dict())

    pipe = To2VPipeline(pcfg, dcfg, dit, rcfg, resampler, None, device=dev)
    nf, h, w = pcfg.nf_latent, pcfg.height // 8, pcfg.width // 8
    latents = torch.randn(2, nf, 16, h, w, generator=gen, device=dev)
    forward = _vip_dit_forward(pipe, latents, text.to(dev))
    vip_w, out_w = forward(written, written_rs)
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    vip_l, out_l = forward(dit, resampler)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = A.launch_counts()
    same = torch.equal(vip_l, vip_w) and torch.equal(out_l, out_w)
    log(f"[load] VIP encode + CFG forward on the loaded weights (T5 embeddings, B=2, "
        f"{nf}x{h}x{w} latents): {dt:.3f} s; output {tuple(out_l.shape)} finite "
        f"{bool(torch.isfinite(out_l).all().item())}; bit-equal to the in-memory model's: "
        f"{same}; launches {json.dumps({k: counts[k] for k in PATH_KERNELS})}")
    if not same:
        raise RuntimeError("the forward on the loaded weights differs from the written model's")
    del written, written_rs, dit, resampler, pipe, out_w, out_l
    torch.cuda.empty_cache()
    return counts


def _load_pca(dev, tmp: str) -> None:
    """Step 5: the gen workload's PCA artifacts at T2To's token width."""
    import numpy as np
    import torch

    from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors
    from tokensgen_tpu_torch.infer import t2to_pca
    from tokensgen_tpu_torch.utils.config import Config

    rng = np.random.default_rng(14)
    d = T2TO_TOKEN_DIM
    want = {"mean_": rng.normal(size=(1, d)).astype(np.float32),
            "components_": rng.normal(size=(d, d)).astype(np.float32),
            "mean": rng.normal(size=(1, d)).astype(np.float32),
            "std": rng.uniform(0.5, 2.0, size=(1, d)).astype(np.float32)}
    cfg = Config(longvgen_pca=os.path.join(tmp, "pca.safetensors"),
                 longvgen_mean=os.path.join(tmp, "mean.npy"),
                 longvgen_std=os.path.join(tmp, "std.npy"))
    save_safetensors(cfg.longvgen_pca, {k: want[k] for k in ("mean_", "components_")})
    np.save(cfg.longvgen_mean, want["mean"])
    np.save(cfg.longvgen_std, want["std"])
    t0 = time.perf_counter()
    pca, mean, std, prov = t2to_pca(cfg, smoke=False, token_dim=d, device=dev)
    torch.cuda.synchronize()
    got = {"mean_": pca.mean, "components_": pca.components, "mean": mean, "std": std}
    same = prov == "artifacts" and all(
        torch.equal(got[k].cpu(), torch.from_numpy(v)) for k, v in want.items())
    log(f"[load] gen PCA artifacts (components {d}x{d}, mean / std 1x{d}) loaded onto the card "
        f"in {time.perf_counter() - t0:.3f} s; equal to what was written: {same}")
    if not same:
        raise RuntimeError("the loaded PCA artifacts differ from what was written")


def _moving_frames(n: int, h: int, w: int) -> "np.ndarray":
    """uint8 [n, h, w, 3]: smooth colour waves moving a few pixels a frame."""
    import numpy as np

    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = [np.stack([np.sin((x + 3 * t) / 40.0), np.cos((y - 2 * t) / 30.0),
                        np.sin((x + y + 4 * t) / 60.0)], -1) for t in range(n)]
    return ((np.stack(frames) * 0.8 + 1.0) * 127.5).astype(np.uint8)


def _load_video(tmp: str, cfg) -> None:
    """Step 6: a 49-frame 720x480 mp4 written and read back through
    load_video at the edit config's settings."""
    import numpy as np

    from tokensgen_tpu_torch.data.video_io import load_video, write_video
    from tokensgen_tpu_torch.utils.config import input_items

    item = input_items(cfg)[0]
    frames = _moving_frames(49, 480, 720)
    path = os.path.join(tmp, "source.mp4")
    t0 = time.perf_counter()
    write_video(path, frames, fps=item.get("output_fps", 10))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    src = load_video(path, sample_fps=item.get("sample_fps", 10), output_res=(480, 720),
                     crop_to_fit=item.get("crop_to_fit", True), max_frames=49)
    t_read = time.perf_counter() - t0
    err = float(np.abs(src[0] - (frames.astype(np.float32) / 127.5 - 1.0)).mean())
    ok = (src.shape == (1, 49, 480, 720, 3) and src.dtype == np.float32
          and src.min() >= -1.0 and src.max() <= 1.0 and err < 0.05)
    log(f"[load] 49-frame 720x480 mp4: written in {t_write:.2f} s, load_video {t_read:.2f} s; "
        f"{src.shape} {src.dtype} in [{src.min():.3f}, {src.max():.3f}]; mean |read - written| "
        f"{err:.4f} (bound 0.05 of the [-1, 1] range, mp4v is lossy)")
    if not ok:
        raise RuntimeError("the video round trip failed its checks")


def _load_cli(dev, tmp: str) -> dict:
    """Step 7: tokensgen_tpu_torch.infer.main on the card at --smoke geometry,
    with a diffusers-layout DiT dir, a T5 dir and a video written here.
    Returns its launches."""
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch
    import yaml

    from tokensgen_tpu_torch import infer
    from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors
    from tokensgen_tpu_torch.data.video_io import write_video
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, graft_vip_params
    from tokensgen_tpu_torch.models.t5 import T5Config, T5Encoder
    from tokensgen_tpu_torch.utils.config import Config
    from tokensgen_tpu_torch.utils.params import build_on_device

    root = os.path.join(tmp, "cli")
    ckpt, t5_dir = os.path.join(root, "ckpt"), os.path.join(root, "text_encoder")
    os.makedirs(ckpt)
    os.makedirs(t5_dir)
    prompt = "a red vehicle on a snow mountain road"
    gen = torch.Generator().manual_seed(15)
    dcfg = infer._configs(Config(), True, dev)[0]
    dit = graft_vip_params(build_on_device(
        lambda: CogVideoXTransformer(dataclasses.replace(dcfg, quant=None)), "cpu", gen))
    save_safetensors(os.path.join(ckpt, "model.safetensors"), dit.state_dict())
    t5 = build_on_device(lambda: T5Encoder(T5Config.tiny(d_model=dcfg.text_embed_dim)), "cpu",
                         gen)
    save_safetensors(os.path.join(t5_dir, "model.safetensors"), t5.state_dict())
    write_wordlevel_tokenizer(t5_dir, _words(prompt))
    item = {"prompt": prompt, "params": {"max_num_chunks": 2}}
    cfg = {"name_prefix": "load", "output_dir": os.path.join(root, "out"), "seed": 3,
           "pretrained_model_name_or_path": ckpt, "pretrained_text_encoder_path": t5_dir,
           "video_ipadapter_params": {"scale": [0.6]},
           "input_config": {"public": {"sample_fps": 10, "output_fps": 10}, "item_a": item}}
    item["video"] = os.path.join(root, "src.mp4")
    write_video(item["video"], _moving_frames(20, 40, 56), fps=10)
    cfg_path = os.path.join(root, "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    captured = io.StringIO()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        run_dir = infer.main(["--config", cfg_path, "--smoke", "--device", str(dev)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = A.launch_counts()
    text = captured.getvalue()
    for line in text.splitlines():
        log(f"[load] cli| {line}")
    outputs = sorted(os.listdir(run_dir))
    lat = np.load(os.path.join(run_dir, "item_a_latents.npy"))
    want = {f"item_a_{x}" for x in ("source.mp4", "orig.mp4", "fifo.mp4", "latents.npy")}
    ok = (want <= set(outputs) and np.isfinite(lat).all()
          and "to2v_dit=torch-checkpoint" in text
          and "(T5TextEncoder)" in text)
    log(f"[load] cli on the card (--smoke geometry): {dt:.1f} s; wrote {outputs}; latents "
        f"{lat.shape} finite {bool(np.isfinite(lat).all())}; launches "
        f"{json.dumps({k: counts[k] for k in PATH_KERNELS})}")
    if not ok:
        raise RuntimeError("the CLI did not load its files or write its outputs")
    return counts


def phase_load(state: dict) -> None:
    import tempfile

    import torch

    from tokensgen_tpu_torch.utils.config import input_items

    dev = state["device"]
    state.pop("pipe", None)  # the edit phase's pipeline
    torch.cuda.empty_cache()
    log(f"[load] on {state['smi']}")
    cfg = _edit_config()
    item = input_items(cfg)[0]
    prompts = [item["prompt"], ""]
    state["load_times"] = {}
    tmp = tempfile.mkdtemp(prefix="tokensgen_load_")
    try:
        text = _load_t5(dev, tmp, prompts, state)
        counts = _load_dit(dev, tmp, cfg, text, state)
        _load_pca(dev, tmp)
        _load_video(tmp, cfg)
        cli = _load_cli(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # each run keeps its own counts: the forward on the loaded weights takes
    # K1-K4; the CLI at --smoke geometry takes K1 and K4 only (K2 and K3 need
    # a side of over 2,048 tokens, which its cross shapes do not have)
    state["load_launches"] = {k: counts[k] for k in PATH_KERNELS}
    state["cli_launches"] = {k: cli[k] for k in PATH_KERNELS}
    for label, got, want in (("the forward on the loaded weights", state["load_launches"],
                              PATH_KERNELS),
                             ("the CLI run", state["cli_launches"], CLI_KERNELS)):
        if min(got[k] for k in want) <= 0:
            raise RuntimeError(f"a kernel was not launched in {label}: {got}")


# the generation path as `infer.py --config tokensgen_tpu/configs/infer_gen.yaml`
# runs it, at full width and its shipped quant (w8a8), with these listed cuts
# and settings
GEN_CONFIG = "tokensgen_tpu/configs/infer_gen.yaml"
GEN_OVERRIDES = {
    "quant_attn": True,  # K7 on the render's joint calls (off unless set)
    "allow_hash_text_encoder": True,  # no T5 weights or tokenizer in the repo
    "longvgen_pca": None,  # no pca/mean/std artifacts in the repo: a random PCA
    "longvgen_mean": None,
    "longvgen_std": None,
    "num_inference_steps": 13,  # cut from 52 (both stages)
    "sampling_params.num_partitions": 1,  # cut from 4
    "input_config.gen_item_1.params.max_num_chunks": 1,  # cut from 24
}
GEN_T2TO_CHUNKS = 24  # the T2To stage alone, at the config's shipped chunks
# To2V render DiT depth on the gen path, cut from 42 (to 2 since the serve
# phase joined, which renders T2To tokens over the wire at EDIT_LAYERS) to
# keep every phase within 800 s: the dit phase times the full-depth w8a8 +
# quant_attn forward, and the T2To stage runs at its full 42 layers
GEN_RENDER_LAYERS = 2


def _count_calls(module) -> list:
    """Counts ``module``'s forward calls (a forward pre-hook)."""
    calls = []
    module.register_forward_pre_hook(lambda *_: calls.append(1))
    return calls


def phase_gen(state: dict) -> None:
    import gc

    import torch

    from tokensgen_tpu_torch.infer import (build_pipeline, build_t2to_pipeline,
                                           build_text_encoder, gen_image_embeddings)
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.sampling.base import generator_noise
    from tokensgen_tpu_torch.utils.config import input_items, load_config

    dev = state["device"]
    state.pop("pipe", None)  # the edit phase's pipeline
    gc.collect()
    torch.cuda.empty_cache()
    cfg = load_config(os.path.join(REPO, GEN_CONFIG), GEN_OVERRIDES)
    t0 = time.perf_counter()
    pipe, dcfg = build_pipeline(cfg, smoke=False, device=dev)
    pipe.dit.transformer_blocks = pipe.dit.transformer_blocks[:GEN_RENDER_LAYERS]
    t2 = build_t2to_pipeline(cfg, False, pipe, dev)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    item = input_items(cfg)[0]
    num_chunks = min(item.get("max_num_chunks", 2), item.get("max_num_chunks_w_fifo", 25))
    pc = pipe.cfg
    log(f"[gen] {GEN_CONFIG} (quant {cfg.get('quant')}) with {json.dumps(GEN_OVERRIDES)}: "
        f"built in {time.perf_counter() - t0:.1f} s; T2To DiT {t2.dit_config.num_layers} layers "
        f"bf16, To2V DiT quant {dcfg.quant} quant_attn {dcfg.quant_attn}, depth "
        f"{len(pipe.dit.transformer_blocks)} of {dcfg.num_layers} layers; {pc.width}x{pc.height}, "
        f"{num_chunks} chunk, {pc.num_inference_steps} steps, {pc.num_partitions} partition")
    enc = build_text_encoder(cfg, smoke=False, device=dev)
    prompt, negative = enc([item.get("prompt", "")]), enc([""])
    t2_calls, render_calls = _count_calls(t2.dit), _count_calls(pipe.dit)
    seed = int(cfg.get("seed", 42))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    toks, emb = gen_image_embeddings(
        t2, pipe, prompt, negative, num_chunks,
        generator_noise(torch.Generator(device=dev).manual_seed(int(cfg.get("seed_2nd", 42)))))
    torch.cuda.synchronize()
    t2to_s = time.perf_counter() - t0
    after_t2to = A.launch_counts()
    timings: dict = {}
    # undecoded: the serve phase's /generate_stream decodes this path's chunks
    # (the edit phase the orig clip), which kept every phase within 800 s
    out = pipe.generate(prompt, negative, image_embeddings=emb, num_chunks=num_chunks,
                        noise_fn=generator_noise(torch.Generator(device=dev).manual_seed(seed)),
                        timings=timings, decode=False)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = A.launch_counts()
    state["gen_launches"] = counts
    render = {k: counts[k] - after_t2to[k] for k in counts}
    log(f"[gen] generate: {total:.1f} s; t2to {t2to_s:.2f} s ({len(t2_calls)} T2To forwards), "
        "render phases (s): " + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
        + f" ({len(render_calls)} To2V forwards); peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"[gen] kernel launches on the gen path: T2To stage {json.dumps(after_t2to)}; "
        f"To2V render {json.dumps(render)}")
    nf, h, w = pc.nf_latent, pc.height // 8, pc.width // 8
    tc = t2.cfg
    want = {"tokens": (toks, (1, num_chunks * tc.num_frames_per_chunk, tc.token_dim, tc.height,
                              tc.width)),
            "latents": (out["latents"], (1, num_chunks * nf, 16, h, w)),
            "orig_latents": (out["orig_latents"], (1, nf, 16, h, w))}
    for key, (x, shape) in want.items():
        finite = bool(torch.isfinite(x).all().item())
        log(f"[gen] {key}: shape {tuple(x.shape)} finite {finite} "
            f"mean {x.float().mean().item():.4f} std {x.float().std().item():.4f}")
        if tuple(x.shape) != shape or not finite:
            raise RuntimeError(f"gen output {key}: expected finite {shape}")
    t2_layers, layers, n = t2.dit_config.num_layers, GEN_RENDER_LAYERS, len(render_calls)
    expect = [
        ("K1 per T2To forward", after_t2to["fused_attention_joint"], t2_layers * len(t2_calls)),
        ("K7 in the T2To stage", after_t2to["fused_attention_joint_int8"], 0),
        ("K1 in the render", render["fused_attention_joint"], 0),
        ("K7 per render forward", render["fused_attention_joint_int8"], layers * n),
        ("K2 per render forward", render["fused_attention_cross_smallkv"], layers * n),
        ("K3 per render forward", render["fused_attention_cross_smallq"], layers * n),
    ]
    log("[gen] " + "; ".join(f"{what}: {got} (expected {exp})" for what, got, exp in expect))
    if any(got != exp for _, got, exp in expect):
        raise RuntimeError("the gen path did not run its kernels as expected")
    del out, emb, toks
    # the T2To stage alone at the shipped chunk count: 4 x 24 token frames of
    # 8 x 12 plus 226 text tokens (9,442) per CFG row
    n0 = len(t2_calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = t2(prompt, negative, num_chunks=GEN_T2TO_CHUNKS,
              noise_fn=generator_noise(torch.Generator(device=dev).manual_seed(seed)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    finite = bool(torch.isfinite(toks).all().item())
    log(f"[gen] T2To stage alone at {GEN_T2TO_CHUNKS} chunks "
        f"({226 + 4 * GEN_T2TO_CHUNKS * tc.height * tc.width:,} tokens per row, "
        f"{len(t2_calls) - n0} forwards): {dt:.2f} s; tokens {tuple(toks.shape)} finite {finite}")
    if not finite or toks.shape[1] != 4 * GEN_T2TO_CHUNKS:
        raise RuntimeError("the T2To stage at 24 chunks is not finite or has the wrong shape")
    del t2, pipe, toks
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------- the serve phase
# The serving path as `python -m tokensgen_tpu_torch.serve --config
# tokensgen_tpu/configs/infer_gen.yaml` runs it: serve.build_service on the
# config as shipped (w8a8, quant_attn off, use_2nd_stage), at full width with
# the edit phase's listed cuts (DiT depth EDIT_LAYERS), behind its threaded
# HTTP server on 127.0.0.1; then the FIFO hooks in process, undecoded, on
# T2To tokens (no VIP encode), at a further cut depth.
SERVE_CONFIG = GEN_CONFIG
SERVE_OVERRIDES = {
    "allow_hash_text_encoder": True,  # no T5 weights or tokenizer in the repo
    "longvgen_pca": None,  # no pca/mean/std artifacts in the repo: a random PCA
    "longvgen_mean": None,
    "longvgen_std": None,
    "num_inference_steps": 13,  # cut from 52 (both stages)
    "sampling_params.num_partitions": 1,  # cut from 4
}
SERVE_STREAM_CHUNKS = 2  # the /edit_stream request's chunks
HEALTH_DEADLINE_S = 2.0  # /health while a stream holds the card (a threaded server)
DRILL_CRASH_AT, DRILL_EVERY = 5, 2  # the drill dies after emit 5; a snapshot every 2 iterations
# To2V DiT depth of the in-process runs (the drill, stream == one-shot, the
# closed stream), cut from the wire's EDIT_LAYERS to keep every phase within
# 800 s: what they check (bit-equal resumes, cancellation within one FIFO
# iteration) does not depend on the depth, and each forward still runs K1-K3
DRILL_LAYERS = 1


def _ndjson_line(resp) -> dict:
    line = resp.readline()
    if not line.endswith(b"\n"):
        raise RuntimeError(f"a stream line is not newline-terminated: {line[:200]!r}")
    return json.loads(line)


def _mp4_frames(b64: str, tmp: str):
    """The frames of a base64 mp4, read back through the port's cv2 reader."""
    import base64

    from tokensgen_tpu_torch.data.video_io import read_frames

    path = os.path.join(tmp, "chunk.mp4")
    with open(path, "wb") as f:
        f.write(base64.b64decode(b64))
    return read_frames(path)


def _serve_wire(service, port: int, dev, tmp: str) -> dict:
    """The three requests over the wire, every decode of their streams
    checked; returns the kernels' launches."""
    import torch

    pc = service.pipe.cfg
    px = (pc.num_frames_per_chunk, pc.height, pc.width, 3)
    # every decode the streams run, checked on the card before it becomes
    # uint8 frames (where a NaN or an inf would pass unseen)
    decoded, decode = [], service.pipe.decode_latents

    def checked_decode(latents):
        video = decode(latents)
        decoded.append((tuple(video.shape), bool(torch.isfinite(video).all().item())))
        return video

    def check_decodes(n, what):
        got, decoded[:] = list(decoded), []
        log(f"[serve] {what}: the stream's decodes (shape, finite): {got}")
        if got != [((1, *px), True)] * n:
            raise RuntimeError(f"{what}: expected {n} finite decodes of {(1, *px)}")

    service.pipe.decode_latents = checked_decode
    try:
        return _serve_requests(service, port, dev, tmp, px, check_decodes)
    finally:
        del service.pipe.decode_latents


def _serve_requests(service, port: int, dev, tmp: str, px, check_decodes) -> dict:
    """/edit_stream (2 chunks, /health probed during it), a refused /edit and
    /generate_stream (1 chunk); returns the kernels' launches."""
    import base64
    import http.client
    import io

    import numpy as np
    import torch

    from tokensgen_tpu_torch.kernels import attention as A

    def connect(timeout=1200):
        return http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)

    def check_chunk(line, want_chunk, what):
        frames = _mp4_frames(line["video_mp4_b64"], tmp)
        log(f"[serve] {what} chunk {line['chunk']}: mp4 of {len(line['video_mp4_b64']):,} base64 "
            f"bytes reads back as {frames.shape} uint8")
        if line["chunk"] != want_chunk or frames.shape != px:
            raise RuntimeError(f"{what}: expected chunk {want_chunk} of {px} frames")

    # 1. /edit_stream with a synthetic 2-chunk 720x480 source
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    frames = rng.random((1, SERVE_STREAM_CHUNKS * px[0], *px[1:]), dtype=np.float32)
    frames *= 2
    frames -= 1
    buf = io.BytesIO()
    np.save(buf, frames)
    npy_bytes = buf.getbuffer().nbytes
    del frames
    # the JSON object written around the base64 bytes (json.dumps would scan
    # the ~540 MB string for characters to escape; base64 has none)
    head = json.dumps({"prompt": "a red car on a snow mountain road", "seed": 3,
                       "num_chunks": SERVE_STREAM_CHUNKS,
                       "negative_prompt": "blurry, low quality"})[:-1]
    body = b"".join([head.encode(), b', "frames_npy": "', base64.b64encode(buf.getbuffer()),
                     b'"}'])
    del buf
    log(f"[serve] /edit_stream request: {SERVE_STREAM_CHUNKS} chunks of {px[0]} frames "
        f"{px[2]}x{px[1]}, .npy {npy_bytes / 2**20:.1f} MiB, JSON body {len(body) / 2**20:.1f} "
        f"MiB, built by the client in {time.perf_counter() - t0:.2f} s")
    before = service.health()["requests"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launch_counts()
    conn = connect()
    t0 = time.perf_counter()
    conn.request("POST", "/edit_stream", body=body, headers={"Content-Type": "application/json"})
    del body
    resp = conn.getresponse()
    t_headers = time.perf_counter() - t0
    if resp.status != 200 or resp.getheader("Content-Type") != "application/x-ndjson":
        raise RuntimeError(f"/edit_stream answered {resp.status}: {resp.read()[:500]!r}")
    line0 = _ndjson_line(resp)
    t_first = time.perf_counter() - t0
    # C3: the threaded server answers /health while the stream holds the card
    hconn = connect(timeout=HEALTH_DEADLINE_S)
    th = time.perf_counter()
    hconn.request("GET", "/health")
    hresp = hconn.getresponse()
    health = json.loads(hresp.read())
    health_s = time.perf_counter() - th
    hconn.close()
    line1 = _ndjson_line(resp)
    t_second = time.perf_counter() - t0
    rest = resp.read()
    total = time.perf_counter() - t0
    conn.close()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    parse_s = line0["parse_seconds"]
    log(f"[serve] /edit_stream: headers after {t_headers:.2f} s (the server's parse of the "
        f"request {parse_s:.2f} s, host), first line {t_first:.2f} s, second {t_second:.2f} s "
        f"(gap {t_second - t_first:.2f} s), stream ended {total:.2f} s; peak {peak:.2f} GiB")
    log(f"[serve] /health during the stream: {hresp.status} in {health_s:.3f} s (deadline "
        f"{HEALTH_DEADLINE_S} s), requests served {health['requests']} (before the stream "
        f"{before})")
    if hresp.status != 200 or health_s > HEALTH_DEADLINE_S:
        raise RuntimeError("/health did not answer within its deadline while the stream ran")
    if health["requests"] != before:  # the stream counts itself served when it ends
        raise RuntimeError("the first chunk arrived only after the stream had ended")
    if rest or "error" in line0 or "error" in line1:
        raise RuntimeError(f"/edit_stream: an error line or trailing data: {rest[:500]!r}")
    check_chunk(line0, 0, "/edit_stream")
    check_chunk(line1, 1, "/edit_stream")
    check_decodes(SERVE_STREAM_CHUNKS, "/edit_stream")

    # 2. a wrong frame count (one frame for a chunk of 49): 400 before any card work
    counts = A.launch_counts()
    buf = io.BytesIO()
    np.save(buf, np.zeros((1, 1, *px[1:]), np.float32))
    conn = connect()
    conn.request("POST", "/edit", body=json.dumps({
        "prompt": "x", "num_chunks": 1, "frames_npy": base64.b64encode(buf.getvalue()).decode()}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    err = json.loads(resp.read())
    conn.close()
    log(f"[serve] /edit with 1 frame: {resp.status} {err}; launches moved: "
        f"{A.launch_counts() != counts}")
    if resp.status != 400 or "requires" not in err.get("error", "") or A.launch_counts() != counts:
        raise RuntimeError("the bad request was not refused before any card work")

    # 3. /generate_stream, one chunk
    conn = connect()
    t0 = time.perf_counter()
    conn.request("POST", "/generate_stream", body=json.dumps({
        "prompt": "a red car on a snow mountain road", "num_chunks": 1, "seed": 5}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise RuntimeError(f"/generate_stream answered {resp.status}: {resp.read()[:500]!r}")
    line = _ndjson_line(resp)
    t_first = time.perf_counter() - t0
    rest = resp.read()
    conn.close()
    log(f"[serve] /generate_stream (1 chunk): first line {t_first:.2f} s, stream ended "
        f"{time.perf_counter() - t0:.2f} s")
    if rest or "error" in line:
        raise RuntimeError(f"/generate_stream: an error line or trailing data: {rest[:500]!r}")
    check_chunk(line, 0, "/generate_stream")
    check_decodes(1, "/generate_stream")
    return A.launch_counts()


def _serve_drill(service, dev) -> None:
    """The FIFO hooks on the card, in process and undecoded, on T2To tokens,
    the To2V DiT cut to DRILL_LAYERS: the crash-resume drill (JAX
    tests/test_serving.py's), stream == one-shot, and a stream closed after
    its first chunk."""
    import torch

    from tokensgen_tpu_torch.infer import gen_image_embeddings
    from tokensgen_tpu_torch.sampling.base import keyed_noise

    pipe, seed = service.pipe, 11
    pipe.dit.transformer_blocks = pipe.dit.transformer_blocks[:DRILL_LAYERS]
    nf = pipe.cfg.nf_latent
    warm = pipe.cfg.num_inference_steps - nf
    text = service.text_encoder(["a red car on a snow mountain road"])
    neg = service.text_encoder([""])
    _, emb = gen_image_embeddings(service.t2to_pipe, pipe, text, neg, 1, keyed_noise(seed + 1, dev))
    kw = dict(image_embeddings=emb, num_chunks=1, decode=False)

    full, stamps = {}, {}

    def on_full(i, em):
        full[i] = em
        stamps[i] = time.perf_counter()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = pipe.generate(text, neg, noise_fn=keyed_noise(seed, dev), emit_callback=on_full, **kw)
    run_s = time.perf_counter() - t0
    gaps = [stamps[i] - stamps[i - 1] for i in sorted(stamps)[1:]]
    iter_s = max(gaps)
    # bookkeeping: the emits the callback was handed make up the returned latents
    emitted = torch.stack([full[i] for i in sorted(full) if i >= warm], dim=1)
    bookkeeping = bool(torch.equal(emitted, ref["latents"]))
    log(f"[serve] uninterrupted run (1 chunk, undecoded, DiT depth {DRILL_LAYERS}): "
        f"{run_s:.2f} s, {len(full)} emits on the host; FIFO iteration "
        f"{min(gaps):.3f}-{iter_s:.3f} s; emits after warm-up stacked == returned latents "
        f"{tuple(ref['latents'].shape)}: {bookkeeping}")
    # stream == one-shot: the service's threaded path (a worker drives the FIFO,
    # this thread groups its emits into chunks) against the one-shot run
    t0 = time.perf_counter()
    chunks = list(service._stream_fifo(text, neg, {"image_embeddings": emb}, 1, seed,
                                       decode=False))
    stream_s = time.perf_counter() - t0
    one_shot = [c["chunk"] for c in chunks] == [0] and bool(torch.equal(
        torch.cat([torch.from_numpy(c["latents"]) for c in chunks], dim=1), ref["latents"]))
    log(f"[serve] the threaded stream (1 chunk, undecoded): {stream_s:.2f} s, "
        f"{len(chunks)} chunk(s); its chunks bit-equal to the one-shot run's latents: {one_shot}")

    class Crash(RuntimeError):
        pass

    emits, states = {}, {}

    def on_emit(i, em):
        emits[i] = em
        if i == DRILL_CRASH_AT:
            raise Crash()

    def on_state(i, snapshot):
        if (i + 1) % DRILL_EVERY == 0:
            states[i] = snapshot()

    t0 = time.perf_counter()
    try:
        pipe.generate(text, neg, noise_fn=keyed_noise(seed, dev), emit_callback=on_emit,
                      state_callback=on_state, **kw)
        raise RuntimeError("the drill's run did not crash")
    except Crash:
        pass
    crash_s = time.perf_counter() - t0
    resume_i = max(states)
    tail = {}
    t0 = time.perf_counter()
    pipe.generate(text, neg, noise_fn=keyed_noise(seed, dev), resume_from=states[resume_i],
                  emit_callback=lambda i, em: tail.__setitem__(i, em), **kw)
    resume_s = time.perf_counter() - t0
    stitched = {**{i: emits[i] for i in range(resume_i + 1)}, **tail}
    drill = sorted(stitched) == sorted(full) and all(torch.equal(stitched[i], full[i])
                                                     for i in full)
    snap_mb = sum(x.numel() * x.element_size() for x in states[resume_i]["state"]) / 2**20
    log(f"[serve] crash-resume drill: died after emit {DRILL_CRASH_AT} ({crash_s:.2f} s), "
        f"resumed from the snapshot after iteration {resume_i} ({snap_mb:.1f} MiB on the host) "
        f"in {resume_s:.2f} s; stitched emits bit-equal to the uninterrupted run: {drill}")
    if not (bookkeeping and one_shot and drill):
        raise RuntimeError("the stream or the resumed run is not bit-equal to the one-shot run")

    # a client that goes away after the first chunk of two
    gen = service.generate_stream("a red car on a snow mountain road", 2, seed=seed,
                                  decode=False)
    t0 = time.perf_counter()
    first = next(gen)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen.close()
    free = service._lock.acquire(timeout=60)
    close_s = time.perf_counter() - t0
    if free:
        service._lock.release()
    log(f"[serve] a 2-chunk stream closed after chunk {first['chunk']} ({t_first:.2f} s): the "
        f"service lock free {close_s:.3f} s later (one FIFO iteration: {iter_s:.3f} s)")
    if not free or close_s > 1.25 * iter_s:
        raise RuntimeError("the closed stream's worker held the card past one FIFO iteration")


def phase_serve(state: dict) -> None:
    import gc
    import tempfile
    import threading

    import torch

    from tokensgen_tpu_torch.serve import build_service
    from tokensgen_tpu_torch.serving import make_server
    from tokensgen_tpu_torch.utils.config import load_config

    dev = state["device"]
    cfg = load_config(os.path.join(REPO, SERVE_CONFIG), SERVE_OVERRIDES)
    t0 = time.perf_counter()
    service = build_service(cfg, smoke=False, device=dev)
    service.pipe.dit.transformer_blocks = service.pipe.dit.transformer_blocks[:EDIT_LAYERS]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    pc, dcfg = service.pipe.cfg, service.pipe.dit_config
    log(f"[serve] serve.build_service({SERVE_CONFIG} with {json.dumps(SERVE_OVERRIDES)}): "
        f"{time.perf_counter() - t0:.1f} s; To2V DiT quant {dcfg.quant} quant_attn "
        f"{dcfg.quant_attn}, depth {len(service.pipe.dit.transformer_blocks)} of "
        f"{dcfg.num_layers} layers; T2To DiT {service.t2to_pipe.dit_config.num_layers} layers; "
        f"{pc.width}x{pc.height}, {pc.num_inference_steps} steps, {pc.num_partitions} partition")
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, name="serve-http", daemon=True)
    thread.start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            counts = _serve_wire(service, server.server_address[1], dev, tmp)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    state["serve_launches"] = counts
    log(f"[serve] kernel launches over the wire (/edit_stream, the refused /edit, "
        f"/generate_stream): {json.dumps(counts)}")
    if thread.is_alive() or min(counts[k] for k in PATH_KERNELS) <= 0:
        raise RuntimeError(f"a kernel of the serve path was not launched: {counts}")
    _serve_drill(service, dev)
    log(f"[serve] requests served {service.health()['requests']}, mean "
        f"{service.health()['avg_seconds']:.2f} s")
    del service, server
    gc.collect()
    torch.cuda.empty_cache()


# The data phase's MiraData layout: three videos (one mp4, copied) of 10 s at
# 30 fps, 960x540 (larger than 720x480, so the resize, the crop and the fps
# resampling to 10 run), a CSV in ISO-8859-1 with a non-ASCII caption, under
# build/data_smoke/; a random full-width CogVideoX VAE as an HF vae/ dir
# (diffusers names); its latents from calculate_vae_latents
DATA_DIR = os.path.join("build", "data_smoke")
DATA_CAPTIONS = {7: "a red kite over the dunes", 1003: "un café au coin de la rue",
                 2048: "waves breaking at dusk"}
DATA_FRAMES, DATA_FPS, DATA_HW = 300, 30.0, (540, 960)
LATENTS_CONFIG = "tokensgen_tpu/configs/dataprocess_vae_latents.yaml"


def _write_mira_layout(root: str) -> dict:
    """The videos and the CSV; returns their paths."""
    import numpy as np

    from tokensgen_tpu_torch.data.mira import mira_video_path
    from tokensgen_tpu_torch.data.video_io import write_video

    videos = os.path.join(root, "videos")
    t0 = time.perf_counter()
    first = None
    for idx in DATA_CAPTIONS:
        path = mira_video_path(videos, idx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if first is None:
            h, w = DATA_HW  # a pan across a wide still: 3 pixels a frame
            still = _moving_frames(1, h, w + 3 * DATA_FRAMES)[0]
            write_video(path, np.stack([still[:, 3 * t:3 * t + w] for t in range(DATA_FRAMES)]),
                        fps=DATA_FPS)
            first = path
        else:
            shutil.copyfile(first, path)
    csv_path = os.path.join(root, "videos.csv")
    with open(csv_path, "w", encoding="ISO-8859-1", newline="") as f:
        f.write("index,dense_caption\n")
        for idx, caption in DATA_CAPTIONS.items():
            f.write(f"{idx},{caption}\n")
    log(f"[data] MiraData layout in {time.perf_counter() - t0:.1f} s: {len(DATA_CAPTIONS)} "
        f"videos of {DATA_FRAMES} frames at {DATA_FPS:g} fps, {DATA_HW[1]}x{DATA_HW[0]}; "
        f"{csv_path} in ISO-8859-1")
    return {"csv": csv_path, "videos": videos}


def _write_vae_dir(dev, root: str) -> str:
    """A random full-width CogVideoX VAE (seed 42) written as an HF vae/ dir."""
    import torch

    from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors
    from tokensgen_tpu_torch.convert.torch_weights import vae_to_diffusers
    from tokensgen_tpu_torch.models.vae3d import AutoencoderKLCogVideoX, VAEConfig
    from tokensgen_tpu_torch.utils.params import build_on_device

    t0 = time.perf_counter()
    vae = build_on_device(lambda: AutoencoderKLCogVideoX(VAEConfig.cogvideox()), dev,
                          torch.Generator(device=dev).manual_seed(42))
    out = os.path.join(root, "vae")
    os.makedirs(out, exist_ok=True)
    sd = vae_to_diffusers(vae.state_dict())
    save_safetensors(os.path.join(out, "diffusion_pytorch_model.safetensors"), sd)
    n = sum(v.numel() for v in sd.values())
    log(f"[data] random full-width VAE ({n:,} parameters) written as {out} (diffusers names) "
        f"in {time.perf_counter() - t0:.1f} s")
    del vae, sd
    torch.cuda.empty_cache()
    return out


def phase_data(state: dict) -> None:
    """The training data path on disk: the MiraData layout, the latents tool
    on the card at full width, the latents read back on the native reader,
    and one To2V item's host decode timed."""
    import gc

    import numpy as np
    import torch
    import yaml

    from tokensgen_tpu_torch import calculate_vae_latents as CVL
    from tokensgen_tpu_torch.data import native_store
    from tokensgen_tpu_torch.data.mira import MiraDataset, VAEMiraDataset, read_csv_rows

    dev = state["device"]
    state.pop("pipe", None)  # the edit phase's pipeline
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(REPO, DATA_DIR)
    shutil.rmtree(root, ignore_errors=True)
    data = _write_mira_layout(root)
    captions = [r["dense_caption"] for r in read_csv_rows(data["csv"])]
    if captions != list(DATA_CAPTIONS.values()):
        raise RuntimeError(f"the CSV read back as {captions}")
    vae_dir = _write_vae_dir(dev, root)
    with open(os.path.join(REPO, LATENTS_CONFIG)) as f:
        lcfg = yaml.safe_load(f)
    data["latents"] = os.path.join(root, "latents")
    lcfg.update(latent_output_dir=data["latents"], vae_checkpoint=vae_dir)
    lcfg["train_data_params"].update(csv_file=data["csv"], video_dir=data["videos"])
    cfg_path = os.path.join(root, "dataprocess_vae_latents.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(lcfg, f)
    log(f"[data] {LATENTS_CONFIG} with latent_output_dir, vae_checkpoint and the layout's "
        f"csv_file / video_dir; calculate_vae_latents.main([--config, --fit-stats]) on the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = CVL.main(["--config", cfg_path, "--fit-stats"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nf_px = lcfg["train_data_params"]["chunk_size"]
    chunks = DATA_FRAMES * 10 // int(DATA_FPS) // nf_px  # 10 fps resampling
    want = [CVL.latent_file(data["latents"], idx, chunks) for idx in DATA_CAPTIONS]
    shape = (13 * chunks, 16, 480 // 8, 720 // 8)
    lats = [np.load(p) for p in want]
    mean = np.load(os.path.join(data["latents"], "mean_shard0.npy"))
    std = np.load(os.path.join(data["latents"], "std_shard0.npy"))
    log(f"[data] latents tool: {len(written)} videos x {chunks} chunks in {secs:.1f} s "
        f"({secs / (len(written) * chunks):.2f} s per full-width chunk, decode included); files "
        f"{[os.path.relpath(p, root) for p in written]}, {lats[0].shape} {lats[0].dtype}; stats "
        f"mean / std {mean.shape} {mean.dtype}, std in [{std.min():.4f}, {std.max():.4f}]")
    if (written != want or any(x.shape != shape or x.dtype != np.float16
                               or not np.isfinite(x).all() for x in lats)
            or mean.shape != (16 * shape[2] * shape[3],) or not np.isfinite(mean).all()
            or not (np.isfinite(std).all() and std.min() > 0)):
        raise RuntimeError(f"the latents tool's files are not as expected: {written}")
    # read back as the T2To trainer does: VAEMiraDataset on the native reader
    ds = VAEMiraDataset(data["csv"], data["latents"], max_num_chunks=24)
    t0 = time.perf_counter()
    items = ds.load_many(list(range(len(ds))))
    t_read = time.perf_counter() - t0
    plain = native_store.load_npy_plain(want)
    same = all(np.array_equal(it["vae_latents"][:13 * chunks], p.astype(np.float32))
               for it, p in zip(items, plain))
    log(f"[data] VAEMiraDataset.load_many of {len(items)} items in {t_read:.3f} s through the "
        f"native reader {os.path.relpath(native_store._Native.path, REPO)} ("
        f"{'built by g++ in this run' if native_store._Native.built_here else 'cached build'});"
        f" latents equal to np.load: {same}; padded to {items[0]['vae_latents'].shape}, valid "
        f"chunks {[it['valid_num_chunks'] for it in items]}, prompts "
        f"{[it['prompt'] for it in items]}")
    if not same or native_store._Native.lib is None:
        raise RuntimeError("the native reader did not read the latents as np.load does")
    # one To2V item's host decode (read, fps resampling, resize, crop)
    mira = MiraDataset(data["csv"], data["videos"], seed=42)
    times = []
    for i in range(2):
        t0 = time.perf_counter()
        item = mira[i]
        times.append(time.perf_counter() - t0)
    state["decode_s"] = min(times)
    log(f"[data] MiraDataset item (2 x 49 frames of {DATA_HW[1]}x{DATA_HW[0]} -> 720x480): "
        f"host decode {', '.join(f'{t:.2f}' for t in times)} s, {item['pixel_values'].shape}, "
        f"start_frame_idx {item['start_frame_idx']}")
    state["data"] = data


def _data_layout(state: dict) -> dict:
    """The data phase's layout (the phase runs first when it has not)."""
    if "data" not in state:
        phase_data(state)
    return state["data"]


# the trainer as `python -m tokensgen_tpu_torch.train_to2v --config
# tokensgen_tpu/configs/train_to2v.yaml` runs it, at full width (42 layers,
# 48 x 64 heads, 2-chunk 49-frame 720x480 batches), with these listed cuts
TRAIN_CONFIG = "tokensgen_tpu/configs/train_to2v.yaml"
TRAIN_OVERRIDES = {
    "per_gpu_batch_size": 2,  # as the config
    "gradient_accumulation_steps": 1,  # cut from 9: each step updates
    "output_dir": "build/train_smoke",
}
TRAIN_STEPS = 2  # the tiny trainer's; no checkpoint is written
# the full-width run's: cut from max_train_steps 100000 (from 2 since the dp
# phase came: each full-width step stages ~24 s and trains ~10 s)
TRAIN_FULL_STEPS = 1
TINY_LORA_RANK = 4  # the tiny trainers' LoRA checks
# The small train check: trainable grads of a train step through the kernels
# (card) against the same step through the plain versions (host), both bf16,
# by relative L2 over all trainable grads together. Measured 5.8e-3 on an
# H100 (bf16 roundings that fall differently through two layers and back).
TRAIN_GRAD_REL_L2_BOUND = 2e-2


def _small_train_batch(dcfg, rcfg, b=2, f=3, chunks=2, seed=4):
    """A staged batch of the tiny geometry (two resampler chunks, per-sample
    VIP rope tables), its timesteps and noise, on the host."""
    import numpy as np
    import torch

    from tokensgen_tpu_torch.core.rope import (get_3d_rotary_pos_embed_v2,
                                               get_3d_rotary_pos_embed_v2_torch)

    gen = torch.Generator().manual_seed(seed)
    d = dcfg.attention_head_dim
    gh, gw = dcfg.sample_height // 2, dcfg.sample_width // 2
    hq, wq, tq = rcfg.num_height_queries, rcfg.num_width_queries, rcfg.num_temporal_queries
    n_vip = min(tq + 1, f)
    ar = lambda n: np.arange(n, dtype=np.float32)  # noqa: E731
    batch = {
        "latents": torch.randn(b, f, 16, dcfg.sample_height, dcfg.sample_width, generator=gen),
        "vip_input_chunks": torch.randn(b, chunks, f, gh * gw, dcfg.inner_dim, generator=gen),
        "vip_emb_sel": torch.tensor([[0, 1, 2], [1, 2, 3]])[:, :n_vip],
        "text_embeds": torch.randn(b, dcfg.max_text_seq_length, dcfg.text_embed_dim,
                                   generator=gen),
        "resampler_image_rotary_emb": get_3d_rotary_pos_embed_v2(rcfg.dim_head, ar(f), ar(gh),
                                                                 ar(gw)),
        "resampler_sampling_rotary_emb": get_3d_rotary_pos_embed_v2(
            rcfg.dim_head, 1000 + ar(tq), ar(hq), ar(wq)),
        "image_rotary_emb": get_3d_rotary_pos_embed_v2(d, ar(f), ar(gh), ar(gw)),
        "vip_image_rotary_emb": get_3d_rotary_pos_embed_v2_torch(
            d, torch.tensor([[3.0, 4, 5], [9, 10, 11]]), torch.arange(gh), torch.arange(gw)),
        "vip_condition_rotary_emb": get_3d_rotary_pos_embed_v2_torch(
            d, torch.tensor([[1000.0, 1001, 1002], [1004, 1005, 1006]]), torch.arange(hq),
            torch.arange(wq)),
    }
    timesteps = torch.tensor([[900, 850, 800], [300, 300, 300]])
    return batch, timesteps, torch.randn(batch["latents"].shape, generator=gen)


def _to(x, dev):
    if isinstance(x, (tuple, list)):
        return type(x)(_to(y, dev) for y in x)
    return x.to(dev)


def _random_lora_b(model, seed: int) -> None:
    """LoRA's b factors made random (init gives zeros, which leave a's grads
    zero), so that a grad check sees both factors."""
    import torch

    from tokensgen_tpu_torch.train import lora

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for ab in lora.lora_factors(model).values():
            ab["b"].copy_(0.02 * torch.randn(ab["b"].shape, generator=gen))


def _small_train_check(dev, dcfg, rcfg, label: str, lora_rank: int = 0) -> dict:
    """A 2-layer bf16 DiT + resampler train step (loss and backward) with the
    same weights and inputs on the host (the plain versions in both
    directions) and on the card (the kernels): the trainable grads must agree
    within TRAIN_GRAD_REL_L2_BOUND. With ``lora_rank``, LoRA factors (b made
    random) on the DiT's attention projections train too. Returns the card's
    launch counts."""
    import copy

    import torch

    from tokensgen_tpu_torch.core import schedule as S
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.train import to2v

    tcfg = to2v.To2VTrainConfig(lora_rank=lora_rank)
    host = to2v.init_model(dcfg, rcfg, "cpu", torch.Generator().manual_seed(3), tcfg)
    if lora_rank:
        _random_lora_b(host.dit, 5)
    host = to2v.setup_trainable(host, torch.bfloat16)
    card = copy.deepcopy(host).to(dev)
    batch, timesteps, noise = _small_train_batch(dcfg, rcfg)
    grads, losses = [], []
    for model, device in ((host, torch.device("cpu")), (card, dev)):
        sched = S.make_schedule(S.ScheduleConfig(), device=device)
        A.reset_launch_counts()
        loss = to2v.to2v_loss(model, sched, {k: _to(v, device) for k, v in batch.items()},
                              timesteps.to(device), noise.to(device))
        loss.backward()
        counts = A.launch_counts()
        grads.append(torch.cat([p.grad.float().flatten().cpu()
                                for p in to2v.trainable_parameters(model).values()]))
        losses.append(loss.item())
    rel = ((grads[1] - grads[0]).norm() / grads[0].norm()).item()
    log(f"[train] small train check ({label}, bf16, VIP + resampler; host plain versions vs "
        f"card kernels): loss {losses[0]:.6f} / {losses[1]:.6f}, trainable grads relative L2 "
        f"error {rel:.3e} (bound {TRAIN_GRAD_REL_L2_BOUND:g}) over {grads[0].numel():,} values; "
        f"card launches {json.dumps(counts)}")
    if not (rel <= TRAIN_GRAD_REL_L2_BOUND and torch.isfinite(grads[1]).all()):
        raise RuntimeError("the card's train step disagrees with the host reference")
    return counts


def _small_train_checks(dev) -> None:
    """`_small_train_check` with the DiT at head dim 64 (its attention on K1
    / K5) and the tiny resampler's heads of 16 (K4 / K5), and at the tiny
    trainer's geometry (`train_to2v.model_configs` with --smoke on the card:
    the DiT's 2 heads of 16 on K6 / K5, the resampler's on K4 / K5)."""
    import torch

    from tokensgen_tpu_torch.models.dit import DiTConfig, VIPConfig
    from tokensgen_tpu_torch.models.resampler import ResamplerConfig
    from tokensgen_tpu_torch.train_to2v import model_configs
    from tokensgen_tpu_torch.utils.config import load_config

    vc = VIPConfig(output_dim=64, num_temporal_queries=2, num_height_queries=4,
                   num_width_queries=6, length=3 * 4 * 6)
    dcfg = DiTConfig.tiny(vip=vc, attention_head_dim=64, num_attention_heads=2,
                          sample_height=16, sample_width=24, dtype=torch.bfloat16, remat=True)
    rcfg = ResamplerConfig.tiny(dim=64, heads=2, embedding_dim=dcfg.inner_dim,
                                output_dim=64, num_temporal_queries=2, num_height_queries=4,
                                num_width_queries=6, dtype=torch.bfloat16)
    _small_train_check(dev, dcfg, rcfg, f"2 layers, DiT d=64, resampler d={rcfg.dim_head}")
    dcfg, rcfg = model_configs(load_config(os.path.join(REPO, TRAIN_CONFIG)), True, dev)[:2]
    for rank in (0, TINY_LORA_RANK):
        counts = _small_train_check(dev, dcfg, rcfg, f"the --smoke geometry: DiT "
                                    f"{dcfg.num_attention_heads} x {dcfg.attention_head_dim}, "
                                    f"resampler {rcfg.heads} x {rcfg.dim_head}"
                                    + (f", LoRA rank {rank}" if rank else ""), lora_rank=rank)
        if min(counts[k] for k in ("fused_attention_bhsd", "attention_backward")) <= 0:
            raise RuntimeError(f"the d={dcfg.attention_head_dim} train check skipped K6 / K5: "
                               f"{counts}")


def _tiny_to2v_trainer(dev) -> None:
    """Two steps of the tiny To2V trainer (`train_to2v --smoke`) on the card:
    the DiT's 2 heads of 16 take K6 forward and K5 backward. Accumulation is
    cut to 1 as at full width, so each step runs the int8 AdamW update and a
    trainable weight moves."""
    import torch

    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.train_to2v import To2VTrainer
    from tokensgen_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, TRAIN_CONFIG),
                      {"gradient_accumulation_steps": 1,
                       "output_dir": os.path.join(REPO, "build", "train_smoke_tiny")})
    tiny = To2VTrainer(cfg, smoke=True, device=dev)
    vip_q = tiny.model.dit.transformer_blocks[0].attn1.processor.vip_to_q.weight
    before = vip_q.detach().clone()
    A.reset_launch_counts()
    records = tiny.run(TRAIN_STEPS, save_final=False)
    counts = A.launch_counts()
    moved = not torch.equal(before, vip_q.detach())
    _log_steps("train", "tiny trainer (--smoke) on the card", records)
    log(f"[train] tiny trainer: DiT {tiny.dcfg.num_attention_heads} x "
        f"{tiny.dcfg.attention_head_dim} heads, optimizer "
        f"{type(tiny.step_fn.optimizer).__name__}; kernel launches {json.dumps(counts)}; "
        f"vip dit.transformer_blocks.0.attn1.processor.vip_to_q.weight "
        f"{'changed' if moved else 'bit-unchanged'}")
    if min(counts[k] for k in ("fused_attention_bhsd", "attention_backward")) <= 0 or not all(
            math.isfinite(r["loss"]) and r["grad_norm"] > 0 and r["updated"] for r in records):
        raise RuntimeError(f"the tiny To2V trainer did not run K6 / K5, or a step has no finite "
                           f"loss and gradient or made no update: {counts}")
    if not moved:
        raise RuntimeError("the tiny To2V trainer's updates left a trainable weight unchanged")


def _tiny_to2v_options(dev) -> None:
    """The tiny To2V trainer (--smoke) on the card with the options of the
    CLI that the full-width run leaves off: LoRA (rank TINY_LORA_RANK),
    Prodigy, a validation render after its one step, and --profile-steps 1.
    The step must be finite and move a LoRA factor; the render's mp4 must
    read back through cv2 with its metrics finite; the trace must be
    written; the merged LoRA export too."""
    import numpy as np
    import torch

    from tokensgen_tpu_torch.data.video_io import read_frames
    from tokensgen_tpu_torch.train_to2v import To2VTrainer
    from tokensgen_tpu_torch.utils.config import load_config

    overrides = {"gradient_accumulation_steps": 1, "lora_rank": TINY_LORA_RANK,
                 "optimizer": "prodigy", "validation_steps": 1,
                 "output_dir": os.path.join(REPO, "build", "train_smoke_options")}
    tiny = To2VTrainer(load_config(os.path.join(REPO, TRAIN_CONFIG), overrides), smoke=True,
                       device=dev)
    lora_b = tiny.model.dit.transformer_blocks[0].attn1.to_q.lora_b
    before = lora_b.detach().clone()
    t0 = time.perf_counter()
    records = tiny.run(1, save_final=False, profile_steps=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    merged = tiny.export_lora_merged()
    tiny.close()
    _log_steps("train", f"tiny trainer with {json.dumps(overrides)}, --profile-steps 1", records)
    video = os.path.join(tiny.run_dir, "val_step1.mp4")
    frames = read_frames(video)
    vals = {k: v for k, v in (tiny.val_metrics or {}).items() if k != "video"}
    trace = os.path.join(tiny.run_dir, "profile", "trace.json")
    trace_bytes = os.path.getsize(trace) if os.path.exists(trace) else 0
    moved = not torch.equal(before, lora_b.detach())
    log(f"[train] tiny trainer options: optimizer {type(tiny.step_fn.optimizer).__name__} (d "
        f"{float(tiny.step_fn.optimizer.estim_lr):.3g}), LoRA "
        f"dit.transformer_blocks.0.attn1.to_q.lora_b {'changed' if moved else 'bit-unchanged'}; "
        f"validation render {os.path.relpath(video, REPO)}: {frames.shape} read back by cv2, "
        f"metrics {json.dumps(vals)}; profile trace "
        f"{os.path.relpath(trace, REPO)} {trace_bytes:,} bytes; lora_merged "
        f"{os.path.relpath(merged, REPO)}; {secs:.1f} s. A full-width validation render (52 "
        f"steps, 4 partitions over 2 chunks) is cut for time")
    if not (all(math.isfinite(r["loss"]) and r["updated"] for r in records) and moved):
        raise RuntimeError("the tiny trainer's LoRA + Prodigy step is not finite or moved nothing")
    if frames.shape[0] != 2 * 9 or not vals or not all(np.isfinite(v) for v in vals.values()):
        raise RuntimeError(f"the validation render is not as expected: {frames.shape}, {vals}")
    if trace_bytes <= 0:
        raise RuntimeError("--profile-steps 1 wrote no trace")


def _log_steps(phase: str, what: str, records) -> None:
    """Each step's loss and its per-sample terms, grad norm, sampled
    timesteps and mean x0 weight 1/(1-ᾱ_t) (the loss's per-timestep weight)
    beside its seconds."""
    from tokensgen_tpu_torch.utils.logging import format_floats

    for r in records:
        secs = ", ".join(f"{k[:-2].replace('_', ' ')} {r[k]:.3f} s" for k in r if k.endswith("_s"))
        log(f"[{phase}] {what} step {r['step']}: {secs}; loss {r['loss']:.6f} (per sample "
            f"{format_floats(r['sample_losses'])}) grad_norm {r['grad_norm']:.6f}; timesteps {r['timesteps']} "
            f"mean x0 weight {r['x0_weight']:.6g}" + (f"; valid chunks {r['valid_chunks']}"
                                        if "valid_chunks" in r else "")
            + (f"; {r['dropped']} VIP embedding(s) dropped" if "dropped" in r else ""))


def phase_train(state: dict) -> None:
    import gc

    import torch

    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.train_to2v import To2VTrainer
    from tokensgen_tpu_torch.utils.config import load_config

    dev = state["device"]
    state.pop("pipe", None)  # the edit phase's pipeline
    gc.collect()
    torch.cuda.empty_cache()
    data = _data_layout(state)
    _small_train_checks(dev)
    _tiny_to2v_trainer(dev)
    _tiny_to2v_options(dev)
    overrides = dict(TRAIN_OVERRIDES, **{"train_data_params.csv_file": data["csv"],
                                         "train_data_params.video_dir": data["videos"]})
    cfg = load_config(os.path.join(REPO, TRAIN_CONFIG),
                      dict(overrides, output_dir=os.path.join(REPO, "build", "train_smoke")))
    log(f"[train] {TRAIN_CONFIG} with {json.dumps(TRAIN_OVERRIDES)} and the data phase's "
        f"csv_file / video_dir, {TRAIN_FULL_STEPS} step(s) (cut from max_train_steps "
        f"{cfg.get('max_train_steps')}), no checkpoint written; random weights, batches from "
        f"disk through MiraDataset + batch_iterator with {cfg.get('dataloader_num_workers', 4)} "
        f"decode threads, hash text encoder (the config sets no pretrained_text_encoder_path)")
    t0 = time.perf_counter()
    trainer = To2VTrainer(cfg, smoke=False, device=dev)
    torch.cuda.synchronize()
    model = trainer.model
    dcfg, rcfg = trainer.dcfg, trainer.rcfg
    log(f"[train] built in {time.perf_counter() - t0:.1f} s: {dcfg.num_layers} layers, "
        f"{dcfg.num_attention_heads} x {dcfg.attention_head_dim} heads, remat {dcfg.remat}, "
        f"batch {trainer.batch_size}; trainable {trainer.param_counts['trainable']:,} of "
        f"{trainer.param_counts['total']:,} parameters; optimizer "
        f"{type(trainer.step_fn.optimizer).__name__}")
    watch = {
        "frozen dit.transformer_blocks.0.attn1.to_q.weight":
            model.dit.transformer_blocks[0].attn1.to_q.weight,
        "vip dit.transformer_blocks.0.attn1.processor.vip_to_q.weight":
            model.dit.transformer_blocks[0].attn1.processor.vip_to_q.weight,
        "resampler resampler.layers.0.0.to_q.weight": model.resampler.layers[0][0].to_q.weight,
    }
    before = {k: v.detach().clone() for k, v in watch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    records = trainer.run(TRAIN_FULL_STEPS, save_final=False)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts, lse_counts = A.launch_counts(), A.lse_launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    state["train_launches"] = counts
    _log_steps("train", "full width", records)
    log(f"[train] {len(records)} steps in {total:.1f} s, peak {peak:.2f} GiB")
    log(f"[train] kernel launches on the train path: {json.dumps(counts)}; with lse: "
        f"{json.dumps(lse_counts)}")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0):
            raise RuntimeError(f"train step {r['step']}: loss or grad norm not finite and > 0")
        if not r["updated"]:
            raise RuntimeError(f"train step {r['step']} made no update")
    for key, old in before.items():
        same = torch.equal(old, watch[key].detach())
        log(f"[train] {key}: {'bit-unchanged' if same else 'changed'}")
        if same != key.startswith("frozen"):
            raise RuntimeError(f"{key}: expected {'unchanged' if key.startswith('frozen') else 'changed'}")
    # K5 per micro-step: the DiT's three attention calls per block, except
    # block 0's base attention, whose inputs depend on no trainable parameter
    # (so autograd, like jax.grad, never differentiates it), plus the
    # resampler's depth calls per chunk
    chunks = int(cfg.get_path("train_data_params.max_num_chunks", 2))
    want = TRAIN_FULL_STEPS * (3 * dcfg.num_layers - 1 + chunks * rcfg.depth)
    log(f"[train] K5 launches {counts['attention_backward']} (expected {want} = "
        f"{TRAIN_FULL_STEPS} x (3 x {dcfg.num_layers} - 1 + {chunks} x {rcfg.depth}))")
    # the To2V path's training forwards: K1 (the DiT) and K4 (the resampler)
    if counts["attention_backward"] != want or min(
            lse_counts[k] for k in ("fused_attention_joint", "flash_attention_bhsd")) <= 0:
        raise RuntimeError(f"the train path did not run K5 / the lse forwards as expected: "
                           f"{counts}, {lse_counts}")
    log("[train] a traced full-width step is cut for time (with the profiler's processing it "
        "took ~120 s of the phase): PERF.md keeps its last breakdown")
    if "decode_s" in state:
        steps = ", ".join(f"{r['staging_s'] + r['train_step_s'] + r['optimizer_s']:.2f}"
                          for r in records)
        waits = ", ".join(f"{r['data_s']:.2f}" for r in records)
        log(f"[train] host decode of one item {state['decode_s']:.2f} s x batch "
            f"{trainer.batch_size} on {cfg.get('dataloader_num_workers', 4)} threads, against "
            f"steps of {steps} s (staging + train step + optimizer); data wait per step "
            f"{waits} s")
    trainer.close()
    del trainer, model, watch, before
    gc.collect()
    torch.cuda.empty_cache()


# the T2To trainer as `python -m tokensgen_tpu_torch.train_t2to --config
# tokensgen_tpu/configs/train_t2to.yaml` runs it at full width (DiTConfig.t2to_5b
# with remat: 42 layers, 48 x 64 heads; per_gpu_batch_size 3; 24 chunks of 4
# token frames of 8 x 12 + 226 text = 9,442 tokens per row), with these
# listed cuts
T2TO_CONFIG = "tokensgen_tpu/configs/train_t2to.yaml"
T2TO_OVERRIDES = {
    # the config's f32 AdamW keeps 16 B per parameter (f32 master, grad, m,
    # v): 83.0 GiB for the 5,569,988,112 parameters, more than one 80 GB
    # card; the JAX package shards that state with ZeRO-1 across a mesh. The
    # config's own int8 AdamW switch brings it to ~10 B per parameter.
    "use_8bit_adam": True,
    "longvgen_pca": None,  # no pca/mean/std artifacts in the repo: the random stand-in
    # no T5-XXL weights in the repo either: unset, the hash text encoder (the
    # JAX CLI outside --smoke raises on the shipped path that names no files)
    "pretrained_text_encoder_path": None,
}
T2TO_STEPS = 2  # cut from max_train_steps 100000; no checkpoint is written


def _write_frozen_encoder(dev, root: str) -> dict:
    """Random full-width files of the T2To latent path's frozen encoder, in
    the layout the JAX CLI reads: the resampler (reference names, f32) as
    <root>/resampler/diffusion_flax_model.safetensors, CogVideoX-5b's patch
    conv as <root>/patch_embed_proj.safetensors (proj.weight, proj.bias).
    Returns the config keys that name them."""
    import torch

    from tokensgen_tpu_torch.convert.safetensors_io import save_safetensors
    from tokensgen_tpu_torch.models.resampler import Resampler, ResamplerConfig
    from tokensgen_tpu_torch.utils.params import build_on_device

    gen = torch.Generator(device=dev).manual_seed(7)
    rs = build_on_device(lambda: Resampler(ResamplerConfig()), dev, gen)
    os.makedirs(os.path.join(root, "resampler"), exist_ok=True)
    save_safetensors(os.path.join(root, "resampler", "diffusion_flax_model.safetensors"),
                     {k: v.float() for k, v in rs.state_dict().items()})
    inner = 3072
    pp = os.path.join(root, "patch_embed_proj.safetensors")
    save_safetensors(pp, {"proj.weight": torch.randn(inner, 16, 2, 2, generator=gen,
                                                     device=dev) / 8.0,
                          "proj.bias": 0.02 * torch.randn(inner, generator=gen, device=dev)})
    del rs
    log(f"[t2to_train] frozen encoder files (random, full width) in {root}")
    return {"pretrained_resampler_name_or_path": root, "patch_embed_proj_path": pp}
# The tiny T2To check: all grads of a train step through the kernels (card:
# K6 forward, K5 backward) against the same step through the plain versions
# (host), both bf16, by relative L2 over all grads together, as the To2V
# trainer's small check (TRAIN_GRAD_REL_L2_BOUND).
T2TO_TINY = dict(patch_size=1, sample_height=8, sample_width=12, attention_head_dim=64,
                 num_attention_heads=1)  # the trainer's --smoke DiT


def _t2to_tiny_check(dev, lora_rank: int = 0) -> None:
    """One tiny T2To train step (loss and backward; one head of 64, so K6
    forward and K5 backward on the card) with the same weights and inputs on
    the host (plain versions) and on the card: every grad within
    TRAIN_GRAD_REL_L2_BOUND, and the card's launches as the routing says.
    With ``lora_rank``, the LoRA mode: the base frozen, LoRA factors (b made
    random) trained."""
    import copy

    import torch

    from tokensgen_tpu_torch.core import schedule as S
    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.models.dit import CogVideoXTransformer, DiTConfig
    from tokensgen_tpu_torch.train import t2to
    from tokensgen_tpu_torch.utils.params import init_params_

    dcfg = DiTConfig.tiny(dtype=torch.bfloat16, **T2TO_TINY)
    gen = torch.Generator().manual_seed(11)
    tcfg = t2to.T2ToTrainConfig(lora_rank=lora_rank)
    host = init_params_(CogVideoXTransformer(dcfg), gen).train()
    if lora_rank:
        t2to.setup_lora_finetune(host, tcfg, gen)
        _random_lora_b(host, 12)
    else:
        t2to.setup_full_finetune(host)
    card = copy.deepcopy(host).to(dev)
    f = 16  # 4 chunks of 4 token frames: 8 + 16 x 96 = 1,544 tokens per row
    batch = {"latents": torch.randn(3, f, 16, 8, 12, generator=gen),
             "text_embeds": 0.02 * torch.randn(3, dcfg.max_text_seq_length, dcfg.text_embed_dim,
                                               generator=gen),
             "valid_frames": torch.tensor([16, 8, 4])}
    timesteps, noise = torch.tensor([900, 500, 100]), torch.randn(3, f, 16, 8, 12, generator=gen)
    grads, losses = [], []
    for model, device in ((host, torch.device("cpu")), (card, dev)):
        sched = S.make_schedule(S.ScheduleConfig(beta_schedule="vip_1"), device=device)
        A.reset_launch_counts()
        loss = t2to.t2to_loss(model, sched, tcfg, {k: v.to(device) for k, v in batch.items()},
                              timesteps.to(device), noise.to(device))
        loss.backward()
        counts, lse_counts = A.launch_counts(), A.lse_launch_counts()
        grads.append(torch.cat([p.grad.float().flatten().cpu() for p in model.parameters()
                                if p.requires_grad]))
        losses.append(loss.item())
    rel = ((grads[1] - grads[0]).norm() / grads[0].norm()).item()
    lora_note = f", LoRA rank {lora_rank} on a frozen base" if lora_rank else ""
    log(f"[t2to_train] tiny step (1 head x 64, 2 layers, bf16{lora_note}, B=3 x 1,544 tokens, "
        f"valid frames [16, 8, 4]; host plain versions vs card kernels): loss {losses[0]:.6f} / "
        f"{losses[1]:.6f}, grads relative L2 error {rel:.3e} (bound "
        f"{TRAIN_GRAD_REL_L2_BOUND:g}) over {grads[0].numel():,} values; card launches "
        f"{json.dumps(counts)}, with lse {json.dumps(lse_counts)}")
    layers = dcfg.num_layers
    if not (rel <= TRAIN_GRAD_REL_L2_BOUND and torch.isfinite(grads[1]).all()):
        raise RuntimeError("the card's tiny T2To step disagrees with the host's")
    if (lse_counts["fused_attention_bhsd"], counts["attention_backward"],
            counts["fused_attention_joint"]) != (layers, layers, 0):
        raise RuntimeError(f"the tiny T2To step did not run K6 + K5 per layer: {counts}")


def phase_t2to_train(state: dict) -> None:
    import gc

    import torch

    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.train_t2to import T2ToTrainer
    from tokensgen_tpu_torch.utils.config import load_config

    dev = state["device"]
    gc.collect()
    torch.cuda.empty_cache()
    data = _data_layout(state)
    _t2to_tiny_check(dev)
    _t2to_tiny_check(dev, lora_rank=TINY_LORA_RANK)
    out_dir = os.path.join(REPO, "build", "t2to_train_smoke")
    # the tiny trainer (the CLI's --smoke) on the card: the path K6 serves
    cfg = load_config(os.path.join(REPO, T2TO_CONFIG), {"output_dir": out_dir})
    tiny = T2ToTrainer(cfg, smoke=True, device=dev)
    A.reset_launch_counts()
    records = tiny.run(T2TO_STEPS, save_final=False)
    torch.cuda.synchronize()
    state["t2to_launches"] = counts = A.launch_counts()
    _log_steps("t2to_train", "tiny trainer (--smoke) on the card", records)
    log(f"[t2to_train] tiny trainer: kernel launches {json.dumps(counts)}")
    want = T2TO_STEPS * tiny.dcfg.num_layers
    if (counts["fused_attention_bhsd"], counts["attention_backward"]) != (want, want) or not all(
            math.isfinite(r["loss"]) for r in records):
        raise RuntimeError(f"the tiny T2To trainer did not run K6 / K5 as expected: {counts}")
    tiny.close()
    del tiny
    files = _write_frozen_encoder(dev, os.path.join(REPO, DATA_DIR, "frozen_encoder"))
    disk = {"train_data_params.csv_file": data["csv"],
            "train_data_params.latent_dir": data["latents"], **files}
    cfg = load_config(os.path.join(REPO, T2TO_CONFIG),
                      dict(T2TO_OVERRIDES, output_dir=out_dir, **disk))
    log(f"[t2to_train] {T2TO_CONFIG} with {json.dumps(T2TO_OVERRIDES)}, the data phase's "
        f"csv_file / latent_dir and the frozen encoder's files, {T2TO_STEPS} steps (cut from "
        f"max_train_steps {cfg.get('max_train_steps')}), no checkpoint written; random weights; "
        "pretrained_text_encoder_path overridden to null (no T5-XXL weights in the repository): "
        "the hash text encoder, as the JAX CLI gives when the path is unset")
    t0 = time.perf_counter()
    trainer = T2ToTrainer(cfg, smoke=False, device=dev)
    torch.cuda.synchronize()
    dcfg = trainer.dcfg
    f = trainer.max_chunks * 4
    tokens = dcfg.max_text_seq_length + f * dcfg.sample_height * dcfg.sample_width
    log(f"[t2to_train] built in {time.perf_counter() - t0:.1f} s: {dcfg.num_layers} layers, "
        f"{dcfg.num_attention_heads} x {dcfg.attention_head_dim} heads, patch size "
        f"{dcfg.patch_size}, remat {dcfg.remat}, batch {trainer.batch_size} x {tokens:,} tokens; "
        f"{trainer.param_counts['trainable']:,} parameters, all trained; optimizer "
        f"{type(trainer.step_fn.optimizer).__name__}; allocated "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    watch = trainer.dit.transformer_blocks[0].attn1.to_q.weight
    before = watch.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    records = trainer.run(T2TO_STEPS, save_final=False)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts, lse_counts = A.launch_counts(), A.lse_launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _log_steps("t2to_train", "full width", records)
    log(f"[t2to_train] {len(records)} steps in {total:.1f} s, peak {peak:.2f} GiB")
    log(f"[t2to_train] kernel launches on the T2To train path: {json.dumps(counts)}; with lse: "
        f"{json.dumps(lse_counts)}")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
                and r["updated"]):
            raise RuntimeError(f"T2To step {r['step']}: no finite loss, grad norm or update")
    if torch.equal(before, watch.detach()):
        raise RuntimeError("the T2To steps left transformer_blocks.0.attn1.to_q.weight unchanged")
    # per step: K1 with lse in each block's forward and again in its
    # recompute (remat), K5 once per block (every block trains)
    layers = dcfg.num_layers
    # and the frozen latent encoder: K4 in each resampler layer, each chunk
    # (padded ones included), each step
    depth = trainer.encoder[2].cfg.depth
    expect = {"fused_attention_joint": 2 * layers * T2TO_STEPS,
              "attention_backward": layers * T2TO_STEPS, "fused_attention_bhsd": 0,
              "flash_attention_bhsd": T2TO_STEPS * trainer.max_chunks * depth}
    state["t2to_k4_launches"] = counts["flash_attention_bhsd"]
    log("[t2to_train] " + "; ".join(f"{k} {counts[k]} (expected {v})" for k, v in expect.items()))
    if any(counts[k] != v for k, v in expect.items()) or (
            lse_counts["fused_attention_joint"] != counts["fused_attention_joint"]):
        raise RuntimeError(f"the T2To train path did not run K1 + K5 + K4 as expected: {counts}")
    _profile(lambda: trainer.run(T2TO_STEPS + 1, save_final=False), "t2to_train",
             "t2to_train_step", chrome=False)
    trainer.close()
    del trainer, watch, before
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- the dp phase
# The trainers' data axis (`sharding/mesh.py`'s DataGroup, `sharding/zero.py`):
# 2 ranks sharing the card over Gloo (NCCL, a card a rank, needs as many
# cards). `train_t2to.yaml` as shipped, f32 AdamW, with `zero1: true`, at full
# width (48 x 64 heads, 24 chunks, 9,442 tokens a row) with its DiT cut to
# DP_T2TO_LAYERS of 42, per_gpu_batch_size 3 (as shipped), DP_STEPS steps;
# then the tiny To2V trainer (--smoke: int8 AdamW, accumulation 2) with
# `zero1`, 4 micro-steps (2 updates), checkpointed after the first update and
# resumed from there. Each is held to one process on the global batch (the
# tiny To2V's uniform timesteps stratified over 2 positions, as the 2 ranks
# draw them): the gradient each update applies and the parameters' change
# from their start, by relative L2 over every trained tensor; the planted
# faults (rank 1 keeps its own gradient instead of the all-reduced mean; int8
# AdamW parts cut on 128-value boundaries, splitting a block) must fail.
DP_T2TO_LAYERS = 2
DP_T2TO_OVERRIDES = {
    "zero1": True,  # the optimizer state split over the ranks; the optimizer as shipped
    "longvgen_pca": None,  # as the t2to_train phase: no artifacts, no T5-XXL weights
    "pretrained_text_encoder_path": None,
    "checkpointing_steps": 1000,  # no checkpoint in the T2To run
}
DP_TO2V_OVERRIDES = {"zero1": True, "per_gpu_batch_size": 1, "gradient_accumulation_steps": 2,
                     "checkpointing_steps": 2}
DP_STEPS = 2
DP_FAULT_STEPS = 1  # optimizer updates of each planted-fault run
# further tiny To2V readings against one process, each run as the first
# (2 updates, no checkpoint): other seeds, and f32 moments in place of int8
DP_TO2V_WITNESSES = (("seed 7", {"seed": 7}), ("seed 8", {"seed": 8}),
                     ("f32 AdamW", {"use_8bit_adam": False}))
DP_CUT_RANKS = 3  # ranks of the int8 block-cut check (see `_dp_int8_cut_check`)
DP_TIMEOUT_S = 900.0
# Against one process on the global batch, relative L2 over all trained
# tensors; each bound sits between the largest sound reading and the
# smallest planted fault's (H100 80GB HBM3, 700 W). The gradient each update
# applies (the all-reduced mean, clipped): both runs compute in bf16, and
# the ranks' GEMMs over 3 rows of 9,442 tokens round differently from one
# over 6, as the train phase's card-vs-host grads do; sound 2.1e-3 / 3.9e-3
# (T2To) and 6.3e-4 / 8.8e-3 (tiny To2V), the fault's (rank 1's own
# gradient) 0.25 and 1.28. The parameters' change from their start: the
# first Adam update moves each entry by about lr * sign(g), so an entry
# whose gradient sits within that rounding of 0 flips; sound 9.8e-3 / 7.6e-3
# (T2To) and 5.5e-2-6.8e-2 (tiny To2V at seeds 42, 7, 8, and 6.4e-2 with f32
# moments: not the int8 codes; on the host in f32, 2.4e-5); a rank that
# keeps its own gradient moves its part of every split tensor by its own
# signs: 0.59 (T2To), 0.69 (tiny To2V). A resume from the dp=2 checkpoint
# against the uninterrupted run: K5's dq sums in a varying order (measured 0).
DP_GRAD_BOUND = 2e-2
DP_T2TO_BOUND = 5e-2
DP_TO2V_BOUND = 0.2
DP_RESUME_BOUND = 1e-3


def _cut_t2to_depth(layers: int) -> None:
    """`train_t2to.model_config` with the full-width DiT cut to ``layers``
    blocks (this process)."""
    import dataclasses

    from tokensgen_tpu_torch import train_t2to

    full = getattr(train_t2to.model_config, "full", train_t2to.model_config)

    def cut(cfg, smoke, device):
        dcfg, chunks, dim = full(cfg, smoke, device)
        return (dcfg if smoke else dataclasses.replace(dcfg, num_layers=layers)), chunks, dim

    cut.full = full
    train_t2to.model_config = cut


def _dp_trainer(kind, overrides: dict, device, group=None, resume=False):
    from tokensgen_tpu_torch.train_t2to import T2ToTrainer
    from tokensgen_tpu_torch.train_to2v import To2VTrainer
    from tokensgen_tpu_torch.utils.config import load_config

    if kind == "t2to":
        return T2ToTrainer(load_config(os.path.join(REPO, T2TO_CONFIG), overrides), smoke=False,
                           device=device, group=group, resume=resume)
    return To2VTrainer(load_config(os.path.join(REPO, TRAIN_CONFIG), overrides), smoke=True,
                       device=device, group=group, resume=resume)


def _dp_steps(trainer, steps: int, every: int = 1):
    """``steps`` micro-steps -> (records, the trained tensors after each
    ``every``-th, on the card)."""
    records, snaps = [], []
    for n in range(every, steps + 1, every):
        records += trainer.run(n, save_final=False)
        snaps.append({k: p.detach().clone() for k, p in trainer.step_fn.params.items()})
    return records, snaps


def _dp_capture_grads(trainer) -> list:
    """A list that gets, at each update, the gradient the optimizer is
    handed: the parameters' ``.grad`` after the all-reduce and the clip
    (whole tensors, also under ZeRO-1)."""
    fn, grads = trainer.step_fn, []
    step = fn.optimizer.step

    def capture(params, parts):
        grads.append({n: p.grad.detach().clone() for n, p in fn.params.items()})
        step(params, parts)

    fn.optimizer.step = capture
    return grads


def _dp_rel_l2(got: dict, want: dict, start: Optional[dict] = None) -> float:
    """Relative L2 over every tensor together of ``got`` against ``want``
    (with ``start``: of their changes from it)."""
    num = sum(float((got[n].double() - want[n].double()).pow(2).sum()) for n in want)
    base = {n: 0 if start is None else start[n].double() for n in want}
    den = sum(float((want[n].double() - base[n]).pow(2).sum()) for n in want)
    return (num / den) ** 0.5


def _dp_fault_run(kind: str, overrides: dict, dev, group, steps: int, grads_path: str) -> dict:
    """The planted fault: ``steps`` micro-steps in which rank 1 all-reduces
    a copy of its gradient and keeps its own -> the trained tensors. Rank 1
    saves the gradient of its first update at ``grads_path``."""
    import torch

    trainer = _dp_trainer(kind, overrides, dev, group)
    reduce = group.mean_all_reduce_
    grads = []
    if group.rank == 1:
        group.mean_all_reduce_ = lambda ts, divisor=None: reduce([t.clone() for t in ts], divisor)
        grads = _dp_capture_grads(trainer)
    try:
        trainer.run(steps, save_final=False)
    finally:
        group.mean_all_reduce_ = reduce
    if grads:  # saved before rank 1 joins its next collective
        torch.save({n: g.cpu() for n, g in grads[0].items()}, grads_path)
    out = {k: p.detach().clone() for k, p in trainer.step_fn.params.items()}
    trainer.close()
    return out


def _dp_tiny_ref(overrides: dict, dev, size: int):
    """The tiny To2V trainer in one process on the global batch of ``size``
    ranks (its timesteps stratified over ``size`` positions, as theirs)."""
    ref = _dp_trainer("to2v", dict(overrides, zero1=False, per_gpu_batch_size=size), dev)
    ref.tcfg = dataclasses.replace(ref.tcfg, num_processes=size)
    return ref


def _dp_rank(group, out_dir: str):
    """One rank of the dp phase: the T2To run over the group (its launches,
    collectives' seconds, the gradient of each update), the planted fault's
    run, the tiny To2V run with its checkpoint, its fault's run and a resume
    from the checkpoint; then rank 0 alone runs each on the global batch in
    one process and returns the errors."""
    import shutil

    import torch

    from tokensgen_tpu_torch.kernels import attention as A
    from tokensgen_tpu_torch.sharding.zero import state_nbytes

    torch.backends.cuda.matmul.allow_tf32 = False  # as the env phase sets it
    torch.backends.cudnn.allow_tf32 = False
    _cut_t2to_depth(DP_T2TO_LAYERS)
    dev = group.device
    res = {}

    def gathered_bytes(opt) -> list:
        nbytes = torch.zeros(group.size, dtype=torch.float64, device=dev)
        nbytes[group.rank] = state_nbytes(opt.state_dict())
        return group.sum_(nbytes).tolist()

    def empty(*trainers):
        for t in trainers:
            t.close()
        torch.cuda.empty_cache()

    t2to_over = dict(DP_T2TO_OVERRIDES, output_dir=os.path.join(out_dir, "t2to"))
    trainer = _dp_trainer("t2to", t2to_over, dev, group)
    start = {k: p.detach().clone() for k, p in trainer.step_fn.params.items()}
    grads = _dp_capture_grads(trainer) if group.leader else []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    records, snaps = _dp_steps(trainer, DP_STEPS)
    torch.cuda.synchronize()
    res["t2to"] = dict(records=records, wall=time.perf_counter() - t0,
                       launches=A.launch_counts(), lse=A.lse_launch_counts(),
                       opt_bytes=gathered_bytes(trainer.step_fn.optimizer),
                       peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                       layers=trainer.dcfg.num_layers, params=trainer.param_counts["trainable"],
                       optimizer=type(trainer.step_fn.optimizer).__name__,
                       split=len(trainer.step_fn.zero.layout.gather_items(start)),
                       tensors=len(start))
    empty(trainer)
    fault_grads = os.path.join(out_dir, "fault_grads_{}.pt")
    fault = _dp_fault_run("t2to", t2to_over, dev, group, DP_FAULT_STEPS,
                          fault_grads.format("t2to"))
    torch.cuda.empty_cache()
    # the tiny To2V trainer: 4 micro-steps (2 updates), checkpoint-2, resume
    to2v_over = dict(DP_TO2V_OVERRIDES, output_dir=os.path.join(out_dir, "to2v"))
    tiny = _dp_trainer("to2v", to2v_over, dev, group)
    tiny_start = {k: p.detach().clone() for k, p in tiny.step_fn.params.items()}
    tiny_grads = _dp_capture_grads(tiny) if group.leader else []
    A.reset_launch_counts()
    tiny_records = tiny.run(2 * DP_STEPS)
    tiny_launches = A.launch_counts()
    tiny_end = {k: p.detach().clone() for k, p in tiny.step_fn.params.items()}
    tiny_bytes = gathered_bytes(tiny.step_fn.optimizer)
    tiny.close()
    tiny_fault = _dp_fault_run("to2v", dict(to2v_over, output_dir=os.path.join(
        out_dir, "to2v_fault")), dev, group, 2 * DP_FAULT_STEPS, fault_grads.format("to2v"))
    resume_over = dict(to2v_over, output_dir=os.path.join(out_dir, "to2v_resume"))
    if group.leader:
        src = os.path.join(out_dir, "to2v", "checkpoints", "checkpoint-2")
        shutil.copytree(src, os.path.join(out_dir, "to2v_resume", "checkpoints", "checkpoint-2"))
        parts = sorted(os.listdir(src))
    group.barrier()
    again = _dp_trainer("to2v", resume_over, dev, group, resume=True)
    again.run(2 * DP_STEPS)
    resumed = {k: p.detach().clone() for k, p in again.step_fn.params.items()}
    again.close()
    witnesses = []  # (label, overrides, start, end) of each further reading
    for i, (label, extra) in enumerate(DP_TO2V_WITNESSES):
        over = dict(to2v_over, checkpointing_steps=1000, **extra,
                    output_dir=os.path.join(out_dir, f"to2v_witness{i}"))
        run = _dp_trainer("to2v", over, dev, group)
        w_start = {k: p.detach().clone() for k, p in run.step_fn.params.items()}
        run.run(2 * DP_STEPS, save_final=False)
        witnesses.append((label, over, w_start,
                          {k: p.detach().clone() for k, p in run.step_fn.params.items()}))
        run.close()
    if not group.leader:
        return None
    res["to2v"] = dict(records=tiny_records, launches=tiny_launches, opt_bytes=tiny_bytes,
                       parts=parts, resumed_step=again.step)
    # one process on the global batch of each
    ref = _dp_trainer("t2to", dict(t2to_over, zero1=False, per_gpu_batch_size=3 * group.size,
                                   output_dir=os.path.join(out_dir, "t2to_ref")), dev)
    ref_grads = _dp_capture_grads(ref)
    ref_records, errors = [], []
    for n in range(1, DP_STEPS + 1):
        ref_records += ref.run(n, save_final=False)
        want = {k: p.detach() for k, p in ref.step_fn.params.items()}
        errors.append(_dp_rel_l2(snaps[n - 1], want, start))
        if n == DP_FAULT_STEPS:
            res["t2to"]["fault"] = _dp_rel_l2(fault, want, start)
    res["t2to"].update(errors=errors, ref_records=ref_records,
                       fault_grad=_dp_rel_l2(torch.load(fault_grads.format("t2to"),
                                                        map_location=dev), ref_grads[0]),
                       grad_errors=[_dp_rel_l2(g, w) for g, w in zip(grads, ref_grads)],
                       ref_opt_bytes=state_nbytes(ref.step_fn.optimizer.state_dict()))
    del snaps, fault, want, grads, ref_grads
    empty(ref)
    tiny_ref = _dp_tiny_ref(dict(to2v_over, output_dir=os.path.join(out_dir, "to2v_ref")), dev,
                            group.size)
    ref_grads = _dp_capture_grads(tiny_ref)
    _, tiny_snaps = _dp_steps(tiny_ref, 2 * DP_STEPS, every=2)
    res["to2v"].update(
        error=_dp_rel_l2(tiny_end, tiny_snaps[-1], tiny_start),
        fault=_dp_rel_l2(tiny_fault, tiny_snaps[DP_FAULT_STEPS - 1], tiny_start),
        grad_errors=[_dp_rel_l2(g, w) for g, w in zip(tiny_grads, ref_grads)],
        fault_grad=_dp_rel_l2(torch.load(fault_grads.format("to2v"), map_location=dev),
                              ref_grads[0]),
        resume_error=_dp_rel_l2(resumed, tiny_end, tiny_start), witnesses={})
    empty(tiny_ref)
    for label, over, w_start, w_end in witnesses:
        ref = _dp_tiny_ref(dict(over, output_dir=over["output_dir"] + "_ref"), dev, group.size)
        ref.run(2 * DP_STEPS, save_final=False)
        res["to2v"]["witnesses"][label] = _dp_rel_l2(
            w_end, {k: p.detach() for k, p in ref.step_fn.params.items()}, w_start)
        empty(ref)
    return res


def _dp_int8_cut_check(dev) -> dict:
    """The int8 AdamW on the card over the tiny To2V trainer's trainable
    tensors, random values and gradients: DP_CUT_RANKS ranks' ZeRO-1 parts,
    each on its own copy, the split tensors' parts copied across (the
    all-gather), are bit-equal to the replicated update after 2 steps;
    parts cut on 128-value boundaries (a 256-value block cut in two) are
    not. (At 2 ranks every tensor of this set, each a power-of-two
    multiple of 1,024 values, halves on a block boundary whatever the
    alignment, so the fault could not show there.)"""
    import torch

    from tokensgen_tpu_torch.sharding.zero import ZeroLayout
    from tokensgen_tpu_torch.train.adam8bit import AdamW8bit

    tiny = _dp_trainer("to2v", {"output_dir": os.path.join(REPO, "build", "dp_smoke", "cut")},
                       dev)
    shapes = {n: p.shape for n, p in tiny.step_fn.params.items()}
    tiny.close()
    gen = torch.Generator(device=dev).manual_seed(11)
    params = {n: torch.randn(s, generator=gen, device=dev) for n, s in shapes.items()}
    grads = [{n: torch.randn(s, generator=gen, device=dev) for n, s in shapes.items()}
             for _ in range(2)]
    sizes = {n: p.numel() for n, p in params.items()}
    full = {n: p.clone() for n, p in params.items()}
    ref = AdamW8bit(full, lambda c: 1e-3)
    for g in grads:
        ref.step(full, g)

    def parts(align):
        copies = [{n: p.clone() for n, p in params.items()} for _ in range(DP_CUT_RANKS)]
        lays = [ZeroLayout.of(params, DP_CUT_RANKS, r, align) for r in range(DP_CUT_RANKS)]
        opts = [AdamW8bit(lay.owned(c), lambda c_: 1e-3, sizes=sizes)
                for lay, c in zip(lays, copies)]
        for g in grads:
            for lay, opt, c in zip(lays, opts, copies):
                opt.step(lay.owned(c), lay.owned(g))
            for lay, c in zip(lays, copies):
                for other in copies:
                    for n, part in lay.owned(c).items():
                        if lay.split(n):
                            lay.owned(other)[n].copy_(part)
        return copies[0], sum(lay.split(n) for lay in lays[:1] for n in params)

    whole, split = parts(256)
    cut, _ = parts(128)
    same = [n for n in full if torch.equal(whole[n], full[n])]
    cut_same = [n for n in full if torch.equal(cut[n], full[n])]
    return {"tensors": len(full), "split": split, "bit_equal": len(same),
            "cut_bit_equal": len(cut_same)}


def phase_dp(state: dict) -> None:
    import gc

    import torch

    from tokensgen_tpu_torch.sharding import mesh

    dev = state["device"]
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(REPO, "build", "dp_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    count = torch.cuda.device_count()
    backend = "nccl" if count >= 2 else "gloo"
    log(f"[dp] {T2TO_CONFIG} with {json.dumps(DP_T2TO_OVERRIDES)}, DiT cut to {DP_T2TO_LAYERS} "
        f"of 42 layers, {DP_STEPS} steps, and the tiny To2V trainer with "
        f"{json.dumps(DP_TO2V_OVERRIDES)}, over 2 ranks on {backend.upper()} "
        f"({count} card(s) visible{', shared' if backend == 'gloo' else ''})")
    t0 = time.perf_counter()
    res = mesh.launch(_dp_rank, 2, (out_dir,), device="cuda", backend=backend,
                      timeout_s=DP_TIMEOUT_S, group_cls=mesh.DataGroup)
    wall = time.perf_counter() - t0
    t2, tiny = res["t2to"], res["to2v"]
    _log_steps("dp", f"T2To rank 0 of 2 ({t2['optimizer']}, zero1)", t2["records"])
    _log_steps("dp", "T2To one process, batch 6", t2["ref_records"])
    comm = [(r["all_reduce_s"], r["all_gather_s"]) for r in t2["records"]]
    log(f"[dp] launch to result {wall:.1f} s; T2To: {t2['layers']} layers, {t2['params']:,} "
        f"parameters, {t2['split']} of {t2['tensors']} tensors split; {DP_STEPS} steps in "
        f"{t2['wall']:.1f} s on rank 0, peak {t2['peak_gib']:.2f} GiB; all-reduce / all-gather "
        f"s per update {comm}")
    ratio = [b / t2["ref_opt_bytes"] for b in t2["opt_bytes"]]
    log(f"[dp] T2To optimizer state bytes by rank {t2['opt_bytes']} against one process's "
        f"{t2['ref_opt_bytes']:,} (ratio {[round(r, 4) for r in ratio]})")
    log(f"[dp] T2To against one process on the global batch: the gradient of each update "
        f"{t2['grad_errors']} (bound {DP_GRAD_BOUND}), the parameters' change after each step "
        f"{t2['errors']} (bound {DP_T2TO_BOUND}); planted fault (rank 1 keeps its own gradient) "
        f"after {DP_FAULT_STEPS} step(s): {t2['fault']}")
    layers = t2["layers"]
    expect = {"fused_attention_joint": 2 * layers * DP_STEPS,
              "attention_backward": layers * DP_STEPS}
    log(f"[dp] T2To rank 0 launches {json.dumps(t2['launches'])} (expected {json.dumps(expect)}"
        f"); with lse {json.dumps(t2['lse'])}")
    _log_steps("dp", "tiny To2V rank 0 of 2 (zero1, accumulation 2)", tiny["records"])
    log(f"[dp] tiny To2V: optimizer bytes by rank {tiny['opt_bytes']}; launches "
        f"{json.dumps(tiny['launches'])}; checkpoint-2 {tiny['parts']}; against one process: "
        f"the gradient of each update {tiny['grad_errors']} (bound {DP_GRAD_BOUND}), the "
        f"parameters' change {tiny['error']:.3e} (bound {DP_TO2V_BOUND}), planted fault after "
        f"{DP_FAULT_STEPS} update(s) {tiny['fault']:.3e}; resumed at step 2 on 2 ranks to step "
        f"{tiny['resumed_step']}: against the uninterrupted run {tiny['resume_error']:.3e} "
        f"(bound {DP_RESUME_BOUND})")
    log(f"[dp] tiny To2V, the parameters' change against one process, further runs: "
        f"{json.dumps(tiny['witnesses'])} (bound {DP_TO2V_BOUND}); the planted fault's gradient "
        f"(rank 1's own) against one process's: T2To {t2['fault_grad']:.3e}, tiny To2V "
        f"{tiny['fault_grad']:.3e} (bound {DP_GRAD_BOUND})")
    cut = _dp_int8_cut_check(dev)
    log(f"[dp] int8 AdamW over the tiny To2V trainable tensors, {DP_CUT_RANKS} ranks' parts: "
        f"{cut}")
    state["dp_launches"] = {k: t2["launches"][k] + tiny["launches"][k]
                            for k in t2["launches"] if t2["launches"][k] + tiny["launches"][k]}
    failed = []
    if any(t2["launches"][k] != v for k, v in expect.items()) or (
            t2["lse"]["fused_attention_joint"] != t2["launches"]["fused_attention_joint"]):
        failed.append(f"T2To launches {t2['launches']}")
    if min(tiny["launches"][k] for k in ("fused_attention_bhsd", "attention_backward",
                                         "flash_attention_bhsd")) <= 0:
        failed.append(f"tiny To2V launches {tiny['launches']}")
    if not all(math.isfinite(r["loss"]) and r["updated"] for r in t2["records"]):
        failed.append("a T2To step made no finite update")
    if not all(r["all_reduce_s"] > 0 and r["all_gather_s"] > 0 for r in t2["records"]):
        failed.append("a T2To update has no all-reduce or all-gather seconds")
    for name, r, bound in (("T2To", t2, DP_T2TO_BOUND), ("tiny To2V", tiny, DP_TO2V_BOUND)):
        errors = r["errors"] if name == "T2To" else [r["error"], *r["witnesses"].values()]
        if (len(r["grad_errors"]) != DP_STEPS or max(r["grad_errors"]) > DP_GRAD_BOUND
                or max(errors) > bound or r["fault"] <= bound
                or r["fault_grad"] <= DP_GRAD_BOUND):
            failed.append(f"{name} against one process: grads {r['grad_errors']}, change "
                          f"{errors}, fault {r['fault']}, its gradient {r['fault_grad']}")
    if not all(0.45 < r < 0.55 for r in ratio):
        failed.append(f"T2To optimizer state is not halved: {ratio}")
    if tiny["resume_error"] > DP_RESUME_BOUND or tiny["resumed_step"] != 2 * DP_STEPS:
        failed.append(f"tiny To2V resumed: {tiny['resume_error']} at {tiny['resumed_step']}")
    if tiny["parts"] != ["opt-rank0-of-2.pt", "opt-rank1-of-2.pt", "state.pt"]:
        failed.append(f"checkpoint files {tiny['parts']}")
    if cut["bit_equal"] != cut["tensors"] or cut["cut_bit_equal"] == cut["tensors"]:
        failed.append(f"int8 parts: {cut}")
    if failed:
        raise RuntimeError("the dp phase failed: " + "; ".join(failed))


_KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel name), first match wins
    ("attention K7 (int8_prologue + joint_int8_splitkv + joint_int8_combine)",
     ("int8_prologue_kernel", "joint_int8_splitkv_kernel", "joint_int8_combine_kernel")),
    ("attention K5 (bwd_aux + bwd_onepass / bwd_onepass128 / bwd_small + bwd_dq_store)",
     ("bwd_aux_kernel", "bwd_onepass_kernel", "bwd_onepass128_kernel", "bwd_small_kernel",
      "bwd_dq_store_kernel")),
    ("attention K1 (joint_prologue + joint_splitkv + joint_combine)",
     ("joint_prologue_kernel", "joint_splitkv_kernel", "joint_combine_kernel")),
    ("attention K2 (smallkv_prologue + smallkv)", ("smallkv_prologue_kernel", "smallkv_kernel")),
    ("attention K3 (smallq_prologue + smallq_splitkv + smallq_combine)",
     ("smallq_prologue_kernel", "smallq_splitkv_kernel", "smallq_combine_kernel")),
    # before K4: "fused_bhsd_splitkv_kernel" holds K4's "bhsd_splitkv_kernel"
    ("attention K6 (fused_bhsd_prologue + fused_bhsd_splitkv + fused_bhsd_combine)",
     ("fused_bhsd_prologue_kernel", "fused_bhsd_splitkv_kernel", "fused_bhsd_combine_kernel")),
    ("attention K4 (bhsd_splitkv + bhsd_combine)", ("bhsd_splitkv_kernel", "bhsd_combine_kernel")),
    # before matmul: cuDNN's implicit-GEMM convolutions also have "gemm" in their names
    ("convolution (cuDNN)", ("conv", "implicit", "winograd", "fprop", "dgrad", "wgrad")),
    ("matmul (cuBLAS / cuBLASLt)", ("gemm", "sm90_xmma", "cutlass", "nvjet", "igemm")),
    ("norm / reduce", ("norm", "reduce", "Reduce")),
    ("copy / cat", ("copy", "Copy", "cat", "Cat")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def _group_named(prefix: str) -> str:
    """The `_KERNEL_GROUPS` group whose name starts with ``prefix`` + " "."""
    return next(g for g, _ in _KERNEL_GROUPS if g.startswith(prefix + " "))


def _kernel_group(key: str) -> str:
    """The `_KERNEL_GROUPS` group of a CUDA kernel's trace name, or "other"."""
    return next((g for g, keys in _KERNEL_GROUPS if any(k in key for k in keys)), "other")


def _profile(fn, phase: str, name: str, chrome: bool = True) -> None:
    """Runs ``fn`` once more under torch.profiler (the timed run has tracing
    off): device time by kernel group and the device's idle share over the
    call's wall time; the top-kernel table (and, with ``chrome``, the trace)
    go to build/traces/{name}_*."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = _kernel_group(evt.key)
        groups[group] = groups.get(group, 0.0) + us / 1e3
    busy = sum(groups.values())
    log(f"[{phase}] traced {name.replace('_', ' ')}: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall):.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[{phase}]   {g}: {ms:.1f} ms ({ms / busy:.1%})")
    out_dir = os.path.join(REPO, "build", "traces")
    os.makedirs(out_dir, exist_ok=True)
    if chrome:
        prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    with open(os.path.join(out_dir, f"{name}_top_kernels.txt"), "w") as f:
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
    launches = dict(state["launches"], attention_backward=state["train_launches"][
        "attention_backward"], fused_attention_joint_int8=state["gen_launches"][
        "fused_attention_joint_int8"], fused_attention_bhsd=state["t2to_launches"][
        "fused_attention_bhsd"])
    launches[F32_KERNEL] = state["variants_launches"]["dinov2_edit"][F32_KERNEL]
    for name, replaces in KERNELS.items():
        row = {"name": name, "route": "cuda",
               "source": F32_SOURCE if name == F32_KERNEL else SOURCE, "replaces": replaces,
               "launches": launches[name], **state["kernel_rows"][name]}
        if name in PATH_KERNELS:  # the variants phase's paths, each counted on its own
            row["variants_launches"] = {path: counts[name]
                                        for path, counts in state["variants_launches"].items()}
        if name == "flash_attention_bhsd":  # K4 in the T2To trainer's frozen latent encoder
            row["t2to_train_launches"] = state["t2to_k4_launches"]
        if name in state["dp_launches"]:  # the dp phase's rank 0 (both trainers)
            row["dp_launches"] = state["dp_launches"][name]
        if name in PATH_KERNELS:  # the load, queue and serve phases' runs, each on its own
            row.update(load_launches=state["load_launches"][name],
                       cli_launches=state["cli_launches"][name],
                       queue_launches=state["queue_launches"][name],
                       serve_launches=state["serve_launches"][name])
        rows.append(row)
    for name, replaces in PROBES.items():
        rows.append({"name": name, "route": "cuda", "source": PROBE_SOURCES.get(name, PROBE_SOURCE),
                     "replaces": replaces, "launches": state["probe_launches"][name],
                     **state["kernel_rows"][name]})
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
