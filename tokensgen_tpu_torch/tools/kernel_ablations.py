"""Ablations of the design choices that K5 (`attention_backward` at head dim
64, csrc/flash_bwd.cuh), K2 (`fused_attention_cross_smallkv`,
csrc/flash_ws.cuh's `smallkv_body`), K7 (`fused_attention_joint_int8`,
flash_ws.cuh's `ws_body` with int8 scores), the float32 K4
(`flash_attention_bhsd_f32`, csrc/attention_f32.cu) and the probes T3a
(`probes.attention_splitpv`), T3b (`probes.attention_pair2`), T5
(`probes.cross_smallkv_pairloop`, csrc/probes_maxfree.cuh), T7
(`probes.matmul_hand`, csrc/probe_gemm.cu), T1 (`probes.attention_sweep`),
T2 (`probes.attention_v2`), T4a (`probes.cross_smallkv_pairinner`) and T4b
(`probes.cross_smallq_splitkv`, csrc/probes_hopper.cuh) keep: kernels/csrc is
built once per variant (the shipped source, and copies in which one choice
is undone by a text patch), one nvcc per variant at once; each build's
registers and spills are printed; then each variant's K5 at the joint
training shape ([2, 48, 17,776, 64] against itself), K2 at the edit shape
(17,776 q rows against 480 keys, 48 heads of 64), K7 at the gen path's
joint shape (17,776 x 17,776, 48 heads of 64, batch 2) and the float32 K4 at
DINOv2-large's [49, 16, 257, 64], T3a and T3b at their script's joint shape
([1, 17,776, 48*64]^2, the round-3 tables, no key bias), T7 at the four
shapes of its CLI (with torch.matmul on the same inputs in the same turns)
T1 and T2 at their script's [1, 48, 17,776, 64] (zero key bias) at every
built tile, T5's and T4a's kernels at their script's cross1 shape (17,776 q
rows x 480 prologued keys) and T4b at its cross2 shape (480 q rows x 18,256
keys) are timed through
the port's wrappers in turns (CUDA events, median), each call held to its
plain version. With
--stamps, a build with clock64() stamps prints the clocks of one K5 q tile
(block 40 of head 3, tiles 50 and 51) per phase. The card only.

A parent arm (``*_parent``) builds an older commit's source with that
commit's own csrc/ (its headers beside it), so that deleting a body that
only an old source calls breaks no parent: `--parents DIR` reads DIR/<commit>/
(written where the checkout has git history by `--export-parents DIR`; a
copy of the repository without .git, such as the card's, needs it), else
each file comes from `git show`.

The float32 K4's variants (names f32_*) build attention_f32.cu alone, each
--f32-builds times (separate nvcc runs), and f32_parent builds the
one-thread-a-row CUDA-core body that the 3xTF32 body replaced (commit
8af06c8). Each of its samples is the device time of 10 back-to-back calls
over 10: its ~0.3 ms is of the order of the wrapper's host time, which one
call's events would count.

The probes' variants (t3a_*, t3b_*, t5_*, mf_*; t7_*; t1_*, t4a_*; t2_*,
t4b_*) build probes.cu (T7's: probe_gemm.cu) alone, each --probe-builds
times, and the parents build the synchronous mma.sync bodies that the TMA /
wgmma ones replaced: t3b_parent and t5_parent commit 128c05f's, t3a_parent
and t7_parent commit 3aa7498's, t1_parent and t4a_parent commit cfce16a's,
t2_parent and t4b_parent commit 656b20a's, each timed at every tile it was
built for (T3a: (128, 64), (128, 32) and (64, 64); T3b: 64 and 32 keys; T5:
128-2,048 q rows a block; T7: its one; T1: its nine (block_q, block_kv,
hblk); T4a: 512-2,048 q rows a block; T2: (64, 64), (128, 64) and (64, 128)
in "last"; T4b: 256, 384 and 512 keys a split) through the same C entry
points. T5 and T4a are timed as their kernels alone, on k prologued once
(`probes.pairloop_prologued`, `probes.pairinner_prologued`), and T4b as its
whole call, each the device time of 10 calls queued behind a device sleep
(`_common.queued_time_ms`: one call's events would count the wrapper's host
time); the shipped T5 also at whole row blocks of 128 and 1,024 rows
(``@128``, ``@1024``) besides its one-wave plan. T4a's lines give each
block_q's blocks, waves (one block a SM) and the last wave's idle share;
T4b's each split's blocks and waves. The shipped T2 runs "last" at every
tile of `probes.SWEEP_CONFIGS` and "full" (every tile biased) at its
default.

    python -m tokensgen_tpu_torch.tools.kernel_ablations [--rounds 2] [--runs 5]
        [--only shipped,k5_atomics,...] [--stamps]
    python -m tokensgen_tpu_torch.tools.kernel_ablations --export-parents DIR
    python -m tokensgen_tpu_torch.tools.kernel_ablations --only f32_parent,f32_shipped,\
        f32_1xtf32,f32_warp_split,f32_serial_stage --parents DIR [--f32-builds 2]
    python -m tokensgen_tpu_torch.tools.kernel_ablations --only t3b_parent,t5_parent,\
        mf_shipped,mf_scaled_p,mf_serial,t3b_two_slots,t5_two_slots \
        --parents DIR [--probe-builds 2] [--probe-stamps]
    python -m tokensgen_tpu_torch.tools.kernel_ablations --only t7_parent,t7_shipped,\
        t7_stages3,t7_128x128,t7_256x128,t7_one_tile,t7_elected,t7_direct_store,\
        t7_row_major,t3a_parent,t3a_shipped,t3a_two_slots --parents DIR
    python -m tokensgen_tpu_torch.tools.kernel_ablations --only t1_parent,t1_shipped,\
        t1_producer,t1_refill_flip,t1_scale_fmul,t4a_parent,t4a_shipped,t4a_tables_in_place,\
        t4a_three_slots --parents DIR
    python -m tokensgen_tpu_torch.tools.kernel_ablations --only t2_parent,t2_shipped,\
        t4b_parent,t4b_shipped,t4b_combine,t4b_one_block --parents DIR
    python -m tokensgen_tpu_torch.tools.kernel_ablations --only prologue_parent,\
        prologue_shipped --parents DIR --rounds 3
    python -m tokensgen_tpu_torch.tools.kernel_ablations --only k5d128_parent,\
        k5d128_shipped,t6_parent,t6_shipped,t6_no_chain,t6_overlap,t6_staged_p --parents DIR

The prologue form times K1, K2 and K3 at the edit shapes (batch 2) built
from commit 128c05f's attention.cu, where the prologue pass and the tensor
maps lived before they moved to flash_prologue.cuh, against the shipped
one. The last form times K5 at head dim 128 ([3, 24, 9,442, 128], the
padded-chunk key bias) built from commit 1d190d4's attention.cu (the
two-pass mma.sync form) against the shipped one-pass body
(csrc/flash_bwd128.cuh), and T6 at its CLI's shapes (int8 and bf16, n =
2,048 and 1,024, 500 steps) built from that commit's probes.cu (the
streaming mma.sync loop) against the shipped key-split body, the shipped
body without its recomputed chain (t6_no_chain: what the chain costs), with
its chunks overlapped (t6_overlap) and with int8 p staged in shared memory
(t6_staged_p).
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from tokensgen_tpu_torch.kernels import attention as A
from tokensgen_tpu_torch.kernels import build as B
from tokensgen_tpu_torch.kernels import probes as P
from tokensgen_tpu_torch.tools import _common

BWD, WS, FWD, CU = "flash_bwd.cuh", "flash_ws.cuh", "flash_fwd.cuh", "attention.cu"
F32 = "attention_f32.cu"
F32_PARENT_COMMIT = "8af06c8"  # the CUDA-core body's last commit
PROBES, MF, GEMM, HOP = "probes.cu", "probes_maxfree.cuh", "probe_gemm.cu", "probes_hopper.cuh"
MF_PARENT_COMMIT = "128c05f"  # T3b's and T5's mma.sync bodies' last commit; the prologue
# pass and the tensor maps still in attention.cu
PROBES_PARENT_COMMIT = "3aa7498"  # T3a's and T7's mma.sync bodies' last commit
SWEEP_PARENT_COMMIT = "cfce16a"  # T1's and T4a's mma.sync bodies' last commit
V2_PARENT_COMMIT = "656b20a"  # T2's and T4b's mma.sync bodies' last commit
# the two-pass K5 at head dim 128's and T6's mma.sync loop's last commit
BWD128_PARENT_COMMIT = "1d190d4"
PARENT_COMMITS = (F32_PARENT_COMMIT, MF_PARENT_COMMIT, PROBES_PARENT_COMMIT, SWEEP_PARENT_COMMIT,
                  V2_PARENT_COMMIT, BWD128_PARENT_COMMIT)
CSRC_PATH = "tokensgen_tpu_torch/kernels/csrc"
# T1's tiles in that commit's probes.cu: (block_q, block_kv, heads per block)
SWEEP_PARENT_CONFIGS = ((64, 32, 1), (64, 64, 1), (64, 128, 1), (128, 32, 1), (128, 64, 1),
                        (64, 64, 2), (64, 128, 2), (128, 32, 2), (128, 64, 2))

# K5's dq share added by float2 atomics instead of the staging and TMA reduce
_K5_ATOMICS = [
    (BWD, "                                                 const CUtensorMap* dqmap, "
          "const float* aux) {",
     "                                                 const CUtensorMap* dqmap, "
     "const float* aux, float* dqws) {"),
    (BWD, "    if ((threadIdx.x & 127) == 0 && j > 0) reduce_dq(j - 1);\n", ""),
    (BWD, "    reduce_dq(nq - 1);\n", ""),
    (BWD, """#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      unsigned char* w = dqs_row0 + (j & 1) * DQ_BUF + (dt >> 2) * BW_DQ_BOX +
                         ((((dt & 3) * 2 + (t >> 1)) ^ g) << 4);
      *reinterpret_cast<float2*>(w) = make_float2(dq[dt][0], dq[dt][1]);
      *reinterpret_cast<float2*>(w + 8 * 128) = make_float2(dq[dt][2], dq[dt][3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");  // the warpgroup's staging
""", """    const int r0 = j * BW_BQ + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      float* row = dqws + bh * sq * 64 + dt * 8 + t * 2;
      if (r0 < sq)
        atomicAdd(reinterpret_cast<float2*>(row + (long long)r0 * 64),
                  make_float2(dq[dt][0], dq[dt][1]));
      if (r1 < sq)
        atomicAdd(reinterpret_cast<float2*>(row + (long long)r1 * 64),
                  make_float2(dq[dt][2], dq[dt][3]));
    }
"""),
    (CU, """    const float* aux) {
  bwd_onepass_body(a, &qmap, &gmap, &kmap, &vmap, &dqmap, aux);""", """    const float* aux, float* dqws) {
  bwd_onepass_body(a, &qmap, &gmap, &kmap, &vmap, &dqmap, aux, dqws);"""),
    (CU, """                                               static_cast<const float*>(aux));""",
     """                                               static_cast<const float*>(aux),
                                               static_cast<float*>(dqws));"""),
]

# K5's p^T, ds^T and the ds^T stores in one loop per half (a store between
# every two loads of lse2 / dsum)
_K5_THREE_PASSES = """#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {  // p^T in place
        const int nt = half * 8 + n8;
        const float2 l = *reinterpret_cast<const float2*>(lse2 + nt * 8 + t * 2);
        s[nt][0] = exp2_ftz(fmaf(s[nt][0], c1, bA - l.x));
        s[nt][1] = exp2_ftz(fmaf(s[nt][1], c1, bA - l.y));
        s[nt][2] = exp2_ftz(fmaf(s[nt][2], c1, bB - l.x));
        s[nt][3] = exp2_ftz(fmaf(s[nt][3], c1, bB - l.y));
      }
      uint32_t dsb[8][2];  // bf16 ds^T, for shared memory
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {  // ds^T, its row sums; bf16 p^T and ds^T
        const int nt = half * 8 + n8;
        const float2 ds = *reinterpret_cast<const float2*>(dsm + nt * 8 + t * 2);
        const float d0 = s[nt][0] * (dp[nt][0] - ds.x), d1 = s[nt][1] * (dp[nt][1] - ds.y);
        const float d2 = s[nt][2] * (dp[nt][2] - ds.x), d3 = s[nt][3] * (dp[nt][3] - ds.y);
        dbA += d0 + d1;
        dbB += d2 + d3;
        pa[nt / 2][(nt & 1) * 2] = pack_bf16(s[nt][0], s[nt][1]);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
        dsb[n8][0] = pack_bf16(d0, d1);
        dsb[n8][1] = pack_bf16(d2, d3);
      }
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        unsigned char* w = dst_row0 + half * BW_DST_BOX + ((n8 ^ g) << 4);
        *reinterpret_cast<uint32_t*>(w) = dsb[n8][0];
        *reinterpret_cast<uint32_t*>(w + 8 * 128) = dsb[n8][1];
      }
"""
_K5_ONE_LOOP = """#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int nt = half * 8 + n8;
        const float2 l = *reinterpret_cast<const float2*>(lse2 + nt * 8 + t * 2);
        const float2 ds = *reinterpret_cast<const float2*>(dsm + nt * 8 + t * 2);
        const float p0 = exp2_ftz(fmaf(s[nt][0], c1, bA - l.x));
        const float p1 = exp2_ftz(fmaf(s[nt][1], c1, bA - l.y));
        const float p2 = exp2_ftz(fmaf(s[nt][2], c1, bB - l.x));
        const float p3 = exp2_ftz(fmaf(s[nt][3], c1, bB - l.y));
        const float d0 = p0 * (dp[nt][0] - ds.x), d1 = p1 * (dp[nt][1] - ds.y);
        const float d2 = p2 * (dp[nt][2] - ds.x), d3 = p3 * (dp[nt][3] - ds.y);
        dbA += d0 + d1;
        dbB += d2 + d3;
        pa[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
        unsigned char* w = dst_row0 + half * BW_DST_BOX + ((n8 ^ g) << 4);
        *reinterpret_cast<uint32_t*>(w) = pack_bf16(d0, d1);
        *reinterpret_cast<uint32_t*>(w + 8 * 128) = pack_bf16(d2, d3);
      }
"""

# K2: q's prologue applied to the loaded q tile in place (the pass for k only)
_K2_Q_ON_TILE = [
    (WS, """    mbar_wait(qfull + i % SKV_QSTAGES, (i / SKV_QSTAGES) & 1);
    pin_regs(s);""", """    mbar_wait(qfull + i % SKV_QSTAGES, (i / SKV_QSTAGES) & 1);
    {
      unsigned char* Qw = Qs + (i % SKV_QSTAGES) * QBOX;
      const Side pq = side_q(a);
      const float eps = static_cast<float>(a.eps), qsc = static_cast<float>(a.qscale);
      constexpr unsigned TPR = HD / 8;
      const int c0 = static_cast<int>(threadIdx.x % TPR) * 8;
      for (int r = static_cast<int>(threadIdx.x / TPR); r < WS_BM; r += WS_NT / TPR) {
        const int row = q0 + r;
        uint4* cell = reinterpret_cast<uint4*>(Qw + r * G::RB + (((c0 / 8) ^ (r & 7)) << 4));
        const uint4 raw = *cell;
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float x[8], y[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          x[2 * e] = f.x;
          x[2 * e + 1] = f.y;
        }
        if (pq.norm) {
          float sum = 0.f, vs = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += x[e];
          const float mu = row_sum<TPR>(sum) * (1.f / HD);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            x[e] -= mu;
            vs += x[e] * x[e];
          }
          const float inv = rsqrtf(row_sum<TPR>(vs) * (1.f / HD) + eps);
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] *= inv;
        }
        const long long toff = (long long)b * pq.tb + (long long)row * HD + c0;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          y[e] = row < sq ? (x[e] * pq.cosg[toff + e] + x[e ^ 1] * pq.rot[c0 + e] *
                             pq.sin[toff + e] + pq.add[toff + e]) * qsc : 0.f;
        *cell = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                           pack_bf16(y[6], y[7]));
      }
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
      __syncthreads();
    }
    pin_regs(s);"""),
    (CU, """  TGAttnArgs p;
  cudaError_t err = prologue_passes<D>(smallkv_prologue_kernel, a, pro, s, &p);""",
     """  TGAttnArgs p = *a;
  const long long hd = a->h * D;
  const dim3 pgrid(static_cast<unsigned>((a->skv + prologue_block_rows(D) - 1) /
                                         prologue_block_rows(D)), static_cast<unsigned>(a->b));
  smallkv_prologue_kernel<<<pgrid, NTHREADS, 0, s>>>(*a, 1, static_cast<__nv_bfloat16*>(pro),
                                                    a->skv * hd);
  cudaError_t err = cudaGetLastError();
  p.k = pro;
  p.k_sb = a->skv * hd;
  p.k_ss = hd;
  p.k_sh = D;"""),
]

# clock64() stamps of one K5 q tile, read back by tg_prof_read
_K5_STAMPS = [
    (BWD, "namespace {\n\nconstexpr int BW_NT = 256;",
     "__device__ long long g_prof[64];\n"
     "#define STAMP(k) if (blockIdx.x == 40 && blockIdx.y == 3 && blockIdx.z == 0 && "
     "(threadIdx.x & 127) == 0 && (j == 50 || j == 51)) "
     "g_prof[(j - 50) * 32 + wg * 16 + (k)] = clock64()\n"
     "namespace {\n\nconstexpr int BW_NT = 256;"),
    (BWD, "    const int st = j % BW_STAGES;\n", "    STAMP(0);\n    const int st = j % BW_STAGES;\n"),
    (BWD, "    mbar_wait(full + st, (j / BW_STAGES) & 1);\n",
     "    mbar_wait(full + st, (j / BW_STAGES) & 1);\n    STAMP(1);\n"),
    (BWD, "    wgmma_wait<0>();\n    pin_regs(s);\n    pin_regs(dp);\n",
     "    wgmma_wait<0>();\n    pin_regs(s);\n    pin_regs(dp);\n    STAMP(2);\n"),
    (BWD, "      wgmma_commit();\n    }\n    __syncthreads();  // ds^T of both",
     "      wgmma_commit();\n      STAMP(3 + half);\n    }\n    __syncthreads();  // ds^T of both"),
    (BWD, "    pin_regs(dq);\n    // dq's share", "    pin_regs(dq);\n    STAMP(5);\n    // dq's share"),
    (BWD, '    asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");  // the warpgroup\'s '
          'staging\n',
     '    asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");  // the warpgroup\'s '
     'staging\n    STAMP(6);\n'),
    (CU, 'extern "C" {\n', 'extern "C" {\n\nint tg_prof_read(long long* out) {\n'
     '  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 64));\n}\n'),
]
STAMP_PHASES = ("tile start", "stage landed", "score products", "half 0", "half 1", "dq product",
                "dq staged")

# clock64() stamps of T3b (block (40, 3), pass 0, kv tiles 50 and 51) and of
# T5 (block 40, steps 100-103: unit 25's four kv tiles at 480 keys), warp 0
# of each warpgroup, and of T3a at 128 rows (block (40, 3), kv tiles 50 and
# 51; every thread of a warpgroup writes its stamp, so that no branch on the
# thread sits in a product's window), read back by tg_prof_read
_MF_STAMP_DEFS = (
    "__device__ long long g_prof[192];\n"
    "#define SPSTAMP(k) if (blockIdx.x == 40 && blockIdx.y == 3 && blockIdx.z == 0 && "
    "(t == 50 || t == 51)) g_prof[128 + (t - 50) * 32 + wg * 16 + (k)] = clock64()\n"
    "#define P2STAMP(k) if (blockIdx.x == 40 && blockIdx.y == 3 && blockIdx.z == 0 && "
    "(threadIdx.x & 127) == 0 && pass == 0 && (t == 50 || t == 51)) "
    "g_prof[(t - 50) * 32 + wg * 16 + (k)] = clock64()\n"
    "#define PLSTAMP(k) if (blockIdx.x == 40 && (threadIdx.x & 127) == 0 && n >= 100 && "
    "n < 104) g_prof[64 + (n - 100) * 16 + wg * 8 + (k)] = clock64()\n")
_MF_STAMPS = [
    (MF, "namespace {\n\nconstexpr int MF_NT", _MF_STAMP_DEFS + "namespace {\n\nconstexpr int MF_NT"),
    (MF, """      const int na = n0 + 2 * t;
      step_wait(na);
      turn(0, na, 1, na - 1);
      softmax(0, t);
      repack(1, na - 1);
      step_wait(na + 1);
      turn(1, na + 1, 0, na);
      softmax(1, t);
      repack(0, na);
""", """      const int na = n0 + 2 * t;
      P2STAMP(0);
      step_wait(na);
      P2STAMP(1);
      turn(0, na, 1, na - 1);
      P2STAMP(2);
      softmax(0, t);
      P2STAMP(3);
      repack(1, na - 1);
      P2STAMP(4);
      step_wait(na + 1);
      P2STAMP(5);
      turn(1, na + 1, 0, na);
      P2STAMP(6);
      softmax(1, t);
      P2STAMP(7);
      repack(0, na);
      P2STAMP(8);
"""),
    (MF, "    const int k = n / nt, t = n % nt;\n    if (threadIdx.x == 0) ring.fill(n, load_kv);\n"
         "    ring.wait(n);\n",
     "    const int k = n / nt, t = n % nt;\n    PLSTAMP(0);\n"
     "    if (threadIdx.x == 0) ring.fill(n, load_kv);\n    ring.wait(n);\n    PLSTAMP(1);\n"),
    (MF, "    pin_regs(s);\n    float ls[2];\n    const int b = unit_b(k);\n",
     "    pin_regs(s);\n    PLSTAMP(2);\n    float ls[2];\n    const int b = unit_b(k);\n"),
    (MF, "    if (n > 0) {\n      wgmma_wait<0>();\n      pin_regs(acc);\n",
     "    PLSTAMP(3);\n    if (n > 0) {\n      wgmma_wait<0>();\n      pin_regs(acc);\n"),
    (MF, "    if (t == 0 && n > 0) {  // the last unit's p.v are all in: its output\n",
     "    PLSTAMP(4);\n    if (t == 0 && n > 0) {  // the last unit's p.v are all in: its output\n"),
    (MF, "    pack_p<MF_BN>(pa, s);\n    // this unit's scores are done",
     "    pack_p<MF_BN>(pa, s);\n    PLSTAMP(5);\n    // this unit's scores are done"),
    (MF, "      if (wtid == 0 && k + 2 < count) load_q(k + 2);\n    }\n",
     "      if (wtid == 0 && k + 2 < count) load_q(k + 2);\n    }\n    PLSTAMP(6);\n"),
    (MF, """  for (int t = 1; t < nt; ++t) {
    step_wait(t);
    turn(0, t, RB - 1, t - 1);
    softmax(0, t);
    repack(RB - 1, t - 1);
    if constexpr (RB == 2) {
      turn(1, t, 0, t);
      softmax(1, t);
      repack(0, t);
    }
  }
""", """  for (int t = 1; t < nt; ++t) {
    SPSTAMP(0);
    step_wait(t);
    SPSTAMP(1);
    turn(0, t, RB - 1, t - 1);
    SPSTAMP(2);
    softmax(0, t);
    SPSTAMP(3);
    repack(RB - 1, t - 1);
    SPSTAMP(4);
    if constexpr (RB == 2) {
      turn(1, t, 0, t);
      SPSTAMP(5);
      softmax(1, t);
      SPSTAMP(6);
      repack(0, t);
      SPSTAMP(7);
    }
  }
"""),
    (PROBES, 'extern "C" {\n', 'extern "C" {\n\nint tg_prof_read(long long* out) {\n'
     '  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 192));\n}\n'),
]
P2_STAMP_PHASES = ("a: tile start", "a: slot landed", "a: scores", "a: softmax", "a: last p.v",
                   "b: slot landed", "b: scores", "b: softmax", "b: last p.v")
PL_STAMP_PHASES = ("step start", "slot landed", "scores", "softmax", "last p.v", "store + pack",
                   "next q prologued")
SP_STAMP_PHASES = ("tile start", "slot landed", "rb 0: scores", "rb 0: softmax",
                   "rb 1: last p.v", "rb 1: scores", "rb 1: softmax", "rb 0: p.v")

# K7: its row scale by a multiply of its own in the dequant, not in the exp2's FMA
_K7_ROW_FMUL = [
    (WS, "                     (i & 1 ? k2.y : k2.x);",
     "                     (i & 1 ? k2.y : k2.x) * (i < 2 ? rsc.x : rsc.y);"),
    (WS, "acc[rb].m, ls, rsc);", "acc[rb].m, ls);"),
]

# T3b / T5: each turn waiting for its p.v with its scores (the p.v no
# longer runs under the softmax)
_MF_SERIAL = [
    (MF, "      wgmma_wait<1>();  // the scores\n", "      wgmma_wait<0>();\n"),
    (MF, "    if (n > 0)\n      wgmma_wait<1>();\n    else\n      wgmma_wait<0>();\n",
     "    wgmma_wait<0>();\n"),
]

# T7: the loads issued by the consumers' first thread as it reaches each k
# tile (no producer warpgroup)
_T7_ELECTED = [
    (GEMM, "constexpr int GM_NT = GM_CONSUMERS + 128;", "constexpr int GM_NT = GM_CONSUMERS;"),
    (GEMM, """    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }""", """    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    ring.fill(-1, load);
  }"""),
    (GEMM, """    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n");\n""", ""),
    (GEMM, """    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n");\n""", ""),
    (GEMM, "        ring.wait(n);\n", "        if (threadIdx.x == 0) ring.fill(n, load);\n"
     "        ring.wait(n);\n"),
]

# T7: each thread's bf16 pairs stored from its registers (no staging, no TMA
# store)
_T7_DIRECT_STORE = [
    (GEMM, "                                                        int M, int N, int K) {",
     "                                                        __nv_bfloat16* c, int M, int N, "
     "int K) {"),
    (GEMM, "amap, bmap, cmap, static_cast<int>(p->m)",
     "amap, bmap, cmap, static_cast<__nv_bfloat16*>(p->c), static_cast<int>(p->m)"),
    (GEMM, """          // box (mb, j) through buffer e % GM_EPI_BUFS, once its last store has read it
          const int e = mb * (GM_BN / 64) + j;
          unsigned char* box = epi + (wg * GM_EPI_BUFS + e % GM_EPI_BUFS) * GM_EPI_BOX;
          if (wtid == 0)
            asm volatile("cp.async.bulk.wait_group.read %0;\\n" ::"n"(GM_EPI_BUFS - 1) : "memory");
          wg_sync(wg);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            unsigned char* cell = box + wrow * 128 + ((q ^ g) << 4) + t * 4;
            *reinterpret_cast<uint32_t*>(cell) =
                pack_bf16(acc[mb][j * 8 + q][0], acc[mb][j * 8 + q][1]);
            *reinterpret_cast<uint32_t*>(cell + 8 * 128) =
                pack_bf16(acc[mb][j * 8 + q][2], acc[mb][j * 8 + q][3]);
          }
          asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
          wg_sync(wg);
          if (wtid == 0) {
            tma_store_2d(&cmap, box, nt * GM_BN + j * 64, r0 + mb * 64);
            asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
          }
""", """          const int r = r0 + mb * 64 + wrow;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int col = nt * GM_BN + j * 64 + q * 8 + t * 2;
            if (col >= N) continue;
            if (r < M)
              *reinterpret_cast<__nv_bfloat162*>(c + (long long)r * N + col) =
                  __floats2bfloat162_rn(acc[mb][j * 8 + q][0], acc[mb][j * 8 + q][1]);
            if (r + 8 < M)
              *reinterpret_cast<__nv_bfloat162*>(c + (long long)(r + 8) * N + col) =
                  __floats2bfloat162_rn(acc[mb][j * 8 + q][2], acc[mb][j * 8 + q][3]);
          }
"""),
]

# T6 without its chain (the result is wrong: q stays q0): the last chunk's
# p.v waited for where the chain's product was
_T6_CHAIN = """    // q's next value: requant(q @ k[:, :128]), the same in every block
    Acc sc[16][4];
    pin_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (I8)
        wgmma_s8_rs(sc, qa[kk], smem_desc(k0 + kk * 32, 16, 1024, 1), kk > 0);
      else
        wgmma_rs<128, 1>(sc, qa[kk], smem_desc(k0 + kk * 2048, FL_BOX, 1024, 1), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin_regs(sc);
    pin_regs(acc);
    pin_regs(pa);
    pin_regs(qa);
    if constexpr (I8)
      requant_s8(qa, sc);
    else
      requant_bf16(qa, sc);
"""
_T6_NO_CHAIN = [(PROBES, _T6_CHAIN, """    wgmma_wait<0>();
    pin_regs(acc);
    pin_regs(pa);
""")]
# T6's int8 p staged in shared memory (a buffer a warpgroup) and read by p.v
# from there, instead of the accumulator registers as the A operand
_T6_STAGED_P = [
    (PROBES, "FL_D * FL_D * static_cast<int>(sizeof(T)) + 8;",
     "FL_D * FL_D * static_cast<int>(sizeof(T)) + 8 + 2 * 8192;"),
    (PROBES, "template <int N>\n__device__ __forceinline__ void pin_regs(int (&x)[N][4]) {",
     """__device__ __forceinline__ void wgmma_s8_ss(int (&d)[16][4], uint64_t adesc, uint64_t bdesc,
                                            int scale_d) {
  asm volatile(
      "{\\n.reg .pred p;\\n"
      "setp.ne.b32 p, %66, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\\n}\\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void pin_regs(int (&x)[N][4]) {"""),
    (PROBES, """        requant_s8(pa, s);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)  // acc += p @ v_chunk, 32 keys a k-step
          wgmma_s8_rs(acc, pa[j], smem_desc(vS + c * FL_BOX + j * 32, 16, 1024, 1), 1);
""", """        requant_s8(pa, s);
        unsigned char* ps = vS + (split / L::CHUNK) * FL_BOX + wg * 8192;
        const int pr = (warp & 3) * 16 + g;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<uint32_t*>(ps + sw128(pr + (i & 1) * 8, 32 * j + (i >> 1) * 16 +
                                                    4 * t)) = pa[j][i];
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_s8_ss(acc, smem_desc(ps + j * 32, 16, 1024, 1),
                      smem_desc(vS + c * FL_BOX + j * 32, 16, 1024, 1), 1);
""")]
# T6 with each chunk's next scores issued before its p.v and p in two
# register sets (even and odd chunks), so that waiting for the scores
# leaves the p.v running through the next requant
_T6_SERIAL = """  uint32_t pa[4][4];  // p of a chunk: the A operand of p.v (4 k-steps for both types)

  for (long long it = 0; it < a.iters; ++it) {
    for (int c = 0; c < nch; ++c) {
      if constexpr (I8) {
        int s[16][4];  // s = q @ k_chunk, 128 keys
        pin_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_s8_rs(s, qa[kk], smem_desc(kS + c * FL_BOX + kk * 32, 16, 1024, 1), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();  // and the previous chunk's p.v: pa is free
        pin_regs(s);
        pin_regs(acc);
        pin_regs(pa);
        requant_s8(pa, s);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)  // acc += p @ v_chunk, 32 keys a k-step
          wgmma_s8_rs(acc, pa[j], smem_desc(vS + c * FL_BOX + j * 32, 16, 1024, 1), 1);
        wgmma_commit();
      } else {
        float s[8][4];  // s = q @ k_chunk, 64 keys (k MN-major: 16 rows of d a k-step)
        pin_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_rs<64, 1>(s, qa[kk], smem_desc(kS + c * FL_BOX + kk * 2048, FL_BOX, 1024, 1),
                          kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin_regs(s);
        pin_regs(acc);
        pin_regs(pa);
        requant_bf16(pa, s);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)  // acc += p @ v_chunk, 16 keys a k-step (two column boxes)
          wgmma_rs<128, 1>(acc, pa[j], smem_desc(vS + c * FL_BOX + j * 2048, FL_BOX / 2, 1024, 1),
                           1);
        wgmma_commit();
      }
    }
    // q's next value: requant(q @ k[:, :128]), the same in every block
    Acc sc[16][4];
    pin_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (I8)
        wgmma_s8_rs(sc, qa[kk], smem_desc(k0 + kk * 32, 16, 1024, 1), kk > 0);
      else
        wgmma_rs<128, 1>(sc, qa[kk], smem_desc(k0 + kk * 2048, FL_BOX, 1024, 1), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin_regs(sc);
    pin_regs(acc);
    pin_regs(pa);
    pin_regs(qa);
    if constexpr (I8)
      requant_s8(qa, sc);
    else
      requant_bf16(qa, sc);
  }

"""
_T6_OVERLAP = [
    (PROBES, _T6_SERIAL, """  // p of the even and of the odd chunks (the A operand of p.v, 4 k-steps in
  // both types): a chunk's p.v reads one while the next chunk's requant
  // writes the other
  uint32_t pa0[4][4], pa1[4][4];
  typename L::Score s;  // a chunk's scores
  Acc sc[16][4];        // the chain's, q @ k[:, :128]
  auto issue_scores = [&](int c) {  // s = q @ k_chunk
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (I8)
        wgmma_s8_rs(s, qa[kk], smem_desc(kS + c * FL_BOX + kk * 32, 16, 1024, 1), kk > 0);
      else  // k MN-major: 16 rows of d a k-step
        wgmma_rs<64, 1>(s, qa[kk], smem_desc(kS + c * FL_BOX + kk * 2048, FL_BOX, 1024, 1),
                        kk > 0);
    }
  };
  auto issue_chain = [&]() {  // sc = q @ k[:, :128], the same in every block
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (I8)
        wgmma_s8_rs(sc, qa[kk], smem_desc(k0 + kk * 32, 16, 1024, 1), kk > 0);
      else
        wgmma_rs<128, 1>(sc, qa[kk], smem_desc(k0 + kk * 2048, FL_BOX, 1024, 1), kk > 0);
    }
  };
  // chunk c: its p from its scores, then the next chunk's scores (or the
  // chain's product after the last chunk) and this chunk's p.v issued in that
  // order, so that waiting for the scores leaves p.v running through the
  // next requant
  auto chunk = [&](int c, uint32_t(&p)[4][4]) {
    if constexpr (I8)
      requant_s8(p, s);
    else
      requant_bf16(p, s);
    wgmma_fence();
    if (c + 1 < nch)
      issue_scores(c + 1);
    else
      issue_chain();
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // acc += p @ v_chunk
      if constexpr (I8)  // 32 keys a k-step
        wgmma_s8_rs(acc, p[j], smem_desc(vS + c * FL_BOX + j * 32, 16, 1024, 1), 1);
      else  // 16 keys a k-step, two column boxes
        wgmma_rs<128, 1>(acc, p[j], smem_desc(vS + c * FL_BOX + j * 2048, FL_BOX / 2, 1024, 1),
                         1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the scores (or the chain's): this p.v may still run
    pin_regs(s);
    pin_regs(sc);
    pin_regs(pa0);
    pin_regs(pa1);
  };

  for (long long it = 0; it < a.iters; ++it) {
    pin_regs(s);
    wgmma_fence();
    issue_scores(0);
    wgmma_commit();
    wgmma_wait<0>();  // and the last step's p.v
    pin_regs(s);
    pin_regs(acc);
    pin_regs(pa0);
    pin_regs(pa1);
    for (int c = 0; c < nch; c += 2) {
      chunk(c, pa0);
      if (c + 1 < nch) chunk(c + 1, pa1);
    }
    pin_regs(qa);
    if constexpr (I8)  // q's next value, from the chain's scores
      requant_s8(qa, sc);
    else
      requant_bf16(qa, sc);
  }
  wgmma_wait<0>();
  pin_regs(acc);
  pin_regs(pa0);
  pin_regs(pa1);

"""),
    (PROBES, "template <> struct LoopGeom<__nv_bfloat16> {\n  using Acc = float;\n",
     "template <> struct LoopGeom<__nv_bfloat16> {\n  using Acc = float;\n"
     "  using Score = float[8][4];\n"),
    (PROBES, "template <> struct LoopGeom<int8_t> {\n  using Acc = int;\n",
     "template <> struct LoopGeom<int8_t> {\n  using Acc = int;\n  using Score = int[16][4];\n")]

# name: (kernel, what the variant undoes, patches)
VARIANTS = {
    "shipped": ("all", "nothing", []),
    "k5_generic_base": ("K5", "the shared base through an integer: generic loads and stores", [
        (BWD, "  unsigned char* Ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);",
         "  unsigned char* Ks = reinterpret_cast<unsigned char*>(\n"
         "      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));")]),
    "k5_one_loop": ("K5", "p, ds and the ds^T stores in one loop per half",
                    [(BWD, _K5_THREE_PASSES, _K5_ONE_LOOP)]),
    "k5_early_issue": ("K5", "the next tile's loads at the tile's start, the dq reduce at its end", [
        (BWD, "    if (threadIdx.x == 0 && j + BW_STAGES - 1 < nq) load_tile(j + BW_STAGES - 1);\n"
              "    if ((threadIdx.x & 127) == 0 && j > 0) reduce_dq(j - 1);\n", ""),
        (BWD, "    const int st = j % BW_STAGES;\n",
         "    if (threadIdx.x == 0 && j + BW_STAGES - 1 < nq) load_tile(j + BW_STAGES - 1);\n"
         "    const int st = j % BW_STAGES;\n"),
        (BWD, '"r"(1 + wg) : "memory");  // the warpgroup\'s staging\n',
         '"r"(1 + wg) : "memory");  // the warpgroup\'s staging\n'
         "    if ((threadIdx.x & 127) == 0) reduce_dq(j);\n"),
        (BWD, "    reduce_dq(nq - 1);\n", ""),
        (BWD, "cp.async.bulk.wait_group.read 0;", "cp.async.bulk.wait_group.read 1;")]),
    "k5_atomics": ("K5", "dq added by float2 atomics (no staging, no TMA reduce)", _K5_ATOMICS),
    "k2_division": ("K2", "store_out dividing by l (IEEE divisions)", [
        (FWD, "  const float i0 = 1.f / l0, i1 = 1.f / l1;\n", ""),
        (FWD, "acc.o[dt][0] * i0, acc.o[dt][1] * i0", "acc.o[dt][0] / l0, acc.o[dt][1] / l0"),
        (FWD, "acc.o[dt][2] * i1, acc.o[dt][3] * i1", "acc.o[dt][2] / l1, acc.o[dt][3] / l1")]),
    "k2_q_on_tile": ("K2", "q's prologue on the loaded tile (the pass for k only)", _K2_Q_ON_TILE),
    "k7_i2f": ("K7", "each s32 score to f32 by an I2F, not the magic-number add", [
        (WS, "(__uint_as_float(__float_as_uint(s[nt][i]) + I8_MAGIC) - I8_MAGICF)",
         "static_cast<float>(static_cast<int>(__float_as_uint(s[nt][i])))")]),
    "k7_row_fmul": ("K7", "the row scale by its own multiply, not in the exp2's FMA", _K7_ROW_FMUL),
    # the float32 K4: attention_f32.cu's switches, one flipped a variant
    "f32_parent": ("F32", f"the split on the tensor cores: commit {F32_PARENT_COMMIT}'s "
                   "one-thread-a-row CUDA-core body", None),
    "f32_shipped": ("F32", "nothing", []),
    "f32_1xtf32": ("F32", "the split: one TF32 pass, hi.hi (timed only: outside the bounds)",
                   [(F32, "#define F32_TERMS 3 ", "#define F32_TERMS 1 ")]),
    "f32_warp_split": ("F32", "the staging: each warp splits its own K / V fragments from the "
                       "raw tiles (mma.sync m16n8k8)",
                       [(F32, "#define F32_WARP_SPLIT 0", "#define F32_WARP_SPLIT 1")]),
    "f32_serial_stage": ("F32", "the overlap: the next tile's staging after each product's "
                         "wait, not while the tensor cores compute it", [
                             (F32, "  wgmma_commit();\n  stage_k();\n  wgmma_wait_all();",
                              "  wgmma_commit();\n  wgmma_wait_all();\n  stage_k();"),
                             (F32, "  wgmma_commit();\n  stage_v();\n  wgmma_wait_all();",
                              "  wgmma_commit();\n  wgmma_wait_all();\n  stage_v();")]),
    # the probes T3b and T5 (csrc/probes_maxfree.cuh)
    "t3b_parent": ("T3B", f"the TMA / wgmma body: commit {MF_PARENT_COMMIT}'s synchronous "
                   "mma.sync pair2 body (64 q rows, 4 heads a block, K prologued per block)", None),
    "t5_parent": ("T5", f"the TMA / wgmma body: commit {MF_PARENT_COMMIT}'s resident "
                  "mma.sync pair-loop body (each head's K / V whole, a grid of q blocks)", None),
    "mf_shipped": ("MF", "nothing", []),
    # K1-K3 through the prologue pass and tensor maps, moved from attention.cu to
    # flash_prologue.cuh: the same code, so the same times
    "prologue_parent": ("K123", f"the move: commit {MF_PARENT_COMMIT}'s attention.cu", None),
    "prologue_shipped": ("K123", "nothing", []),
    "mf_scaled_p": ("MF", "the exact subnormal p: p' = 2^32 p summed and multiplied "
                    "(one FMUL a score less; the l floor scaled)", [
                        (MF, "exp2_ftz(fminf(x, MF_PK)) * MF_PINV;", "exp2_ftz(fminf(x, MF_PK));"),
                        (MF, "MF_LMIN = FLT_MIN;", "MF_LMIN = FLT_MIN * 4294967296.f;")]),
    "mf_serial": ("MF", "the overlap: each turn waits for its p.v with its scores", _MF_SERIAL),
    "t3b_two_slots": ("T3B", "the ring's depth: 2 K / V slots, not 5",
                      [(MF, "constexpr int P2_SLOTS = 5;", "constexpr int P2_SLOTS = 2;")]),
    "t5_two_slots": ("T5", "the ring's depth: 2 K' / V slots, not 3",
                     [(MF, "constexpr int PL_SLOTS = 3;", "constexpr int PL_SLOTS = 2;")]),
    # the probe T7 (csrc/probe_gemm.cu's switches, one flipped a variant)
    "t7_parent": ("T7", f"the Hopper GEMM: commit {PROBES_PARENT_COMMIT}'s synchronous mma.sync "
                  "body (128 x 128 tiles, k tile 32, one tile a block)", None),
    "t7_shipped": ("T7", "nothing", []),
    "t7_stages3": ("T7", "the ring's depth: 3 slots, not 4",
                   [(GEMM, "constexpr int GM_STAGES = 4;", "constexpr int GM_STAGES = 3;")]),
    "t7_128x128": ("T7", "the tile: 128 x 128 (m64n128 a warpgroup), not 128 x 256",
                   [(GEMM, "constexpr int GM_BN = 256;", "constexpr int GM_BN = 128;")]),
    "t7_256x128": ("T7", "the tile: 256 x 128 (two m64n128 row blocks a warpgroup), not 128 x 256",
                   [(GEMM, "constexpr int GM_BM = 128;", "constexpr int GM_BM = 256;"),
                    (GEMM, "constexpr int GM_BN = 256;", "constexpr int GM_BN = 128;")]),
    "t7_one_tile": ("T7", "the persistent walk: one output tile a block",
                    [(GEMM, "const long long grid = tiles < sms ? tiles : sms;",
                      "const long long grid = tiles;")]),
    "t7_elected": ("T7", "the loader: one consumer thread, not a producer warpgroup (256 "
                   "threads, its branch in the k loop)", _T7_ELECTED),
    "t7_direct_store": ("T7", "the TMA store: bf16x2 stores from registers", _T7_DIRECT_STORE),
    "t7_row_major": ("T7", "the raster groups: tiles row by row (groups of one row tile)",
                     [(GEMM, "constexpr int GM_GROUP = 8;", "constexpr int GM_GROUP = 1;")]),
    # the probe T3a (csrc/probes_maxfree.cuh)
    "t3a_parent": ("T3A", f"the TMA / wgmma body: commit {PROBES_PARENT_COMMIT}'s synchronous "
                   "mma.sync split-p@v body (K prologued in every q block)", None),
    "t3a_shipped": ("T3A", "nothing", []),
    "t3a_two_slots": ("T3A", "the ring's depth: 2 K / V slots, not 3",
                      [(MF, "constexpr int SP_SLOTS = 3;", "constexpr int SP_SLOTS = 2;")]),
    # the probes T1 and T4a (csrc/probes_hopper.cuh's switches, one flipped a variant)
    "t1_parent": ("T1", f"the TMA / wgmma body: commit {SWEEP_PARENT_COMMIT}'s synchronous "
                  "mma.sync sweep body (flash_fwd.cuh's, 64 / 128 q rows, 32-128 keys)", None),
    "t1_shipped": ("T1", "nothing", []),
    "t1_producer": ("T1", "the loader: a producer warpgroup (384 threads, setmaxnreg), not "
                    "warpgroup 1's first thread",
                    [(HOP, "constexpr bool SW_PRODUCER = false;",
                      "constexpr bool SW_PRODUCER = true;")]),
    "t1_refill_flip": ("T1", "the refill point: at each tile's start at block_q 256, right after "
                       "the loader's release (waiting for the other warpgroup's) at 128",
                       [(HOP, "static constexpr bool REFILL_AFTER_RELEASE = RB == 2;",
                         "static constexpr bool REFILL_AFTER_RELEASE = RB != 2;")]),
    "t1_scale_fmul": ("T1", "the fold: the scores scaled by a multiply of their own before the "
                      "max, the bias added after, p = 2^(x - m)",
                      [(HOP, "constexpr bool SW_FOLD = true;", "constexpr bool SW_FOLD = false;")]),
    "t4a_parent": ("T4A", f"the TMA / wgmma body: commit {SWEEP_PARENT_COMMIT}'s resident "
                   "mma.sync body (128-row q tiles, plain loads, a block barrier each)", None),
    "t4a_shipped": ("T4A", "nothing", []),
    "t4a_tables_in_place": ("T4A", "the tables path: each chunk of raw q prologued in place "
                            "from the tables in global memory, not K1's prologue pass first",
                            [(HOP, "constexpr bool PI_PROLOGUE_PASS = true;",
                              "constexpr bool PI_PROLOGUE_PASS = false;")]),
    "t4a_three_slots": ("T4A", "the q ring's depth: 3 slots a warpgroup, not 2",
                        [(HOP, "constexpr int PI_SLOTS = 2;", "constexpr int PI_SLOTS = 3;")]),
    # the probes T2 (T1's kernels) and T4b (csrc/probes_hopper.cuh's resident body)
    "t2_parent": ("T2", f"T1's TMA / wgmma body: commit {V2_PARENT_COMMIT}'s synchronous "
                  "mma.sync v2 body (flash_fwd.cuh's, 64 / 128 q rows, 64 / 128 keys)", None),
    "t2_shipped": ("T2", "nothing", []),
    "t4b_parent": ("T4B", f"the prologue pass, the TMA / wgmma body and the reduce-add: commit "
                   f"{V2_PARENT_COMMIT}'s resident mma.sync body (K prologued on load, q in "
                   "every block, per-split partials and a combine)", None),
    "t4b_shipped": ("T4B", "nothing", []),
    "t4b_combine": ("T4B", "the reduce-add: each split's partials stored apart, summed by the "
                    "last pass", [(HOP, "constexpr bool SK_REDUCE = true;",
                                   "constexpr bool SK_REDUCE = false;")]),
    "t4b_one_block": ("T4B", "two blocks a SM: at 256 keys a split, blocks of two warpgroups, "
                      "one resident a SM", [(HOP, "constexpr bool SK_TWO_BLOCKS = true;",
                                             "constexpr bool SK_TWO_BLOCKS = false;")]),
    # K5 at head dim 128 (csrc/flash_bwd128.cuh) and the probe T6 (probes.cu)
    "k5d128_parent": ("K5D128", f"the one-pass TMA / wgmma body: commit {BWD128_PARENT_COMMIT}'s "
                      "two-pass mma.sync form (bwd_dkdv_kernel<128> + bwd_dq_kernel<128>, "
                      "synchronous loads)", None),
    "k5d128_shipped": ("K5D128", "nothing", []),
    "t6_parent": ("T6", f"k and v resident per key split, on wgmma: commit "
                  f"{BWD128_PARENT_COMMIT}'s mma.sync loop (16 rows a block, k and v streamed "
                  "from L2 in every step)", None),
    "t6_shipped": ("T6", "nothing", []),
    "t6_no_chain": ("T6", "the recomputed chain: q kept from step to step, no q @ k[:, :128] "
                    "(a wrong result, timed only)", _T6_NO_CHAIN),
    "t6_overlap": ("T6", "the chunks in turn: each chunk's next scores issued before its p.v, "
                   "p in two register sets (ptxas: C7513 serializes the wgmmas; int8 spills)",
                   _T6_OVERLAP),
    "t6_staged_p": ("T6", "p in registers as p.v's A operand (int8; bf16 unchanged): p stored to "
                    "shared memory and read from there", _T6_STAGED_P),
}
# the kernels each probe (or K1-K3) variant times
PROBE_KINDS = {"T3B": ("T3B",), "T5": ("T5",), "MF": ("T3B", "T5"), "K123": ("K1", "K2", "K3"),
               "T6": ("T6",),
               "T7": ("T7",), "T3A": ("T3A",), "T1": ("T1",), "T4A": ("T4A",), "T2": ("T2",),
               "T4B": ("T4B",)}
# each kind's parent commit (the probes not named: MF_PARENT_COMMIT's)
PARENT_OF = {"F32": F32_PARENT_COMMIT, "K123": MF_PARENT_COMMIT, "T7": PROBES_PARENT_COMMIT,
             "K5D128": BWD128_PARENT_COMMIT, "T6": BWD128_PARENT_COMMIT,
             "T3A": PROBES_PARENT_COMMIT, "T1": SWEEP_PARENT_COMMIT, "T4A": SWEEP_PARENT_COMMIT,
             "T2": V2_PARENT_COMMIT, "T4B": V2_PARENT_COMMIT}
# the probes timed as 10 calls queued behind a device sleep (T5, T4a: their kernels alone)
QUEUED_KINDS = ("T5", "T4A", "T4B")


def _patched(name: str, patches, root, source=CU, files=None):
    """A copy of csrc with ``patches`` applied (or, given ``files``, a
    parent's csrc: {file name: text}), ``source`` built; (name, rc, nvcc
    output, seconds)."""
    d = root / name
    shutil.rmtree(d, ignore_errors=True)
    if files is None:
        shutil.copytree(B.CSRC, d)
    else:
        d.mkdir(parents=True)
        for f, text in files.items():
            (d / f).write_text(text)
    for f, old, new in patches:
        text = (d / f).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: patch of {f} does not apply: {old[:60]!r}")
        (d / f).write_text(text.replace(old, new))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *B.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / source)],
                          capture_output=True, text=True)
    return name, proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


def _git(*args: str) -> str:
    proc = subprocess.run(["git", *args], capture_output=True, text=True, cwd=B.CSRC.parents[2])
    if proc.returncode != 0:
        raise RuntimeError(f"git {' '.join(args)} failed (pass --parents DIR where the checkout "
                           f"has no git history): {proc.stderr}")
    return proc.stdout


def _parent_files(parents: str, commit: str) -> dict:
    """Every file of csrc/ at ``commit``, {name: text}: from
    ``parents``/<commit>/, else git."""
    if parents:
        return {f.name: f.read_text() for f in sorted((pathlib.Path(parents) / commit).iterdir())}
    names = _git("ls-tree", "--name-only", f"{commit}:{CSRC_PATH}").split()
    return {n: _git("show", f"{commit}:{CSRC_PATH}/{n}") for n in names}


def export_parents(root: str) -> None:
    """csrc/ of every parent commit into ``root``/<commit>/ (for --parents)."""
    for commit in PARENT_COMMITS:
        d = pathlib.Path(root) / commit
        d.mkdir(parents=True, exist_ok=True)
        for name, text in _parent_files("", commit).items():
            (d / name).write_text(text)
        print(f"{commit}: {len(list(d.iterdir()))} files in {d}")


def _k5_case(dev):
    gen = torch.Generator(dev).manual_seed(2)
    q, k, v, g = (torch.randn(2, 48, 17776, 64, generator=gen, device=dev).bfloat16()
                  for _ in range(4))
    zeros = torch.zeros(2, 17776, device=dev)
    out, lse = A.attention_plain(q, k, v, zeros, 0.125, with_lse=True)
    dsum = A._row_dsum(g, out, None)
    del out
    ref = A.attention_bwd_plain(q, k, v, g, lse, dsum, None, 0.125)
    return (lambda: A.attention_backward(q, k, v, g, lse, dsum, None, None, 0.125,
                                         with_dbias=True)), ref


def _k2_case(dev, sq=17776, skv=480, fn=A.fused_attention_cross_smallkv):
    """K2 at the edit shape (or, with ``sq``, ``skv`` and ``fn``, K1 / K3 at
    theirs), random tables."""
    gen = torch.Generator(dev).manual_seed(3)
    b, h = 2, 48
    q, k, v = (torch.randn(b, s, h * 64, generator=gen, device=dev).bfloat16()
               for s in (sq, skv, skv))
    gain = 1 + 0.1 * torch.randn(64, generator=gen, device=dev)
    shift = 0.1 * torch.randn(64, generator=gen, device=dev)
    tabs = [A.make_prologue(64, [((ang.cos(), ang.sin()), n)], gain, shift, fold=fold)
            for n, fold in ((sq, 0.125), (skv, 1.0))
            for ang in [torch.randn(n, 64, generator=gen, device=dev)]]
    ref = A._fused_plain_merged(q, k, v, torch.zeros(b, skv, device=dev), tabs[0], tabs[1], h,
                                1e-6, True, True)
    return (lambda: fn(q, k, v, tabs[0], tabs[1], heads=h)), ref


def _k1_case(dev):
    return _k2_case(dev, 17776, 17776, A.fused_attention_joint)


def _k3_case(dev):
    return _k2_case(dev, 480, 18256, A.fused_attention_cross_smallq)


def _k7_case(dev):
    """K7 at the gen path's joint shape, random tables."""
    gen = torch.Generator(dev).manual_seed(4)
    b, h, s = 2, 48, 17776
    q, k, v = (torch.randn(b, s, h * 64, generator=gen, device=dev).bfloat16() for _ in range(3))
    gain = 1 + 0.1 * torch.randn(64, generator=gen, device=dev)
    shift = 0.1 * torch.randn(64, generator=gen, device=dev)
    ang = torch.randn(s, 64, generator=gen, device=dev)
    tabs = [A.make_prologue(64, [((ang.cos(), ang.sin()), s)], gain, shift, fold=fold)
            for fold in (0.125, 1.0)]
    ref = A.attention_fused_int8_plain(q, k, v, torch.zeros(b, s, device=dev), tabs[0], tabs[1],
                                       h, 1e-6, True, True)
    return (lambda: A.fused_attention_joint_int8(q, k, v, tabs[0], tabs[1], heads=h)), ref


def _f32_case(dev):
    """The float32 K4 at DINOv2-large's [49, 16, 257, 64], the operands as
    the encoder makes them (strided views of [49, 257, 1024]); the plain
    version with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(dev).manual_seed(17)
    q, k, v = (torch.randn(49, 257, 1024, generator=gen, device=dev).view(49, 257, 16, 64)
               .transpose(1, 2) for _ in range(3))
    ref = A.attention_plain(q, k, v, torch.zeros(49, 257, device=dev), 0.125)
    return (lambda: A.flash_attention_bhsd_f32(q, k, v, None, 0.125)), ref


def _t3b_case(dev):
    """T3b at its script's joint shape: {style: [(label, fn)]} (the parent's
    entry point at its two tiles, the shipped wrapper) and the plain
    version."""
    from tokensgen_tpu_torch.tools.bench_attn_r3 import make_inputs

    x = make_inputs(dev)
    q, k, v, tq, tk = x["q"], x["k"], x["v"], x["tq"], x["tk"]
    h = q.shape[2] // 64
    shift = P.score_shift(tq, tk).item()
    ref = P.attention_maxfree_plain(q, k, v, None, tq, tk, h, shift)
    parent = [(f"bkv={bn}", lambda bn=bn: P._launch_maxfree(
        "tg_probe_attn_pair2", q, k, v, None, tq, tk, h, 1e-6, shift, bn)) for bn in (64, 32)]
    shipped = [("", lambda: P.attention_pair2(q, k, v, None, tq, tk, h, shift=shift))]
    return {"parent": parent, "shipped": shipped}, ref


def _t5_case(dev):
    """T5's kernel alone at its script's cross1 shape, k prologued once:
    {style: [(label, fn)]} (the parent's entry point at each q block it was
    built for; the shipped one-wave plan and whole row blocks of 128 and
    1,024 rows) and the plain version."""
    from tokensgen_tpu_torch.tools.bench_attn_r3 import make_inputs

    x = make_inputs(dev)
    q, k, v, tq, tk = x["q"], x["kv"], x["vv"], x["tq_tv"], x["tk_vip"]
    h = q.shape[2] // 64
    shift = P.score_shift(tq, tk).item()
    kn = A.merge_heads(A.apply_prologue_plain(A.split_heads(k, h), tk, 1e-6, True))
    ref = P.attention_maxfree_plain(q, kn, v, None, tq, tk, h, shift, k_prologued=True)
    parent = [(f"@{bq}", lambda bq=bq: P._launch_maxfree(
        "tg_probe_cross_pairloop", q, kn, v, None, tq, None, h, 1e-6, shift, bq))
        for bq in (128, 256, 512, 1024, 2048)]
    shipped = [("" if bq == P.PAIRLOOP_WAVE else f"@{bq}",
                lambda bq=bq: P.pairloop_prologued(q, kn, v, None, tq, h, shift, bq))
               for bq in (P.PAIRLOOP_WAVE, 128, 1024)]
    return {"parent": parent, "shipped": shipped}, ref


def _t7_case(dev):
    """T7 at the CLI's four shapes (M = 36,352): {style: [(label, fn, plain
    output)]}, each kernel call and, in the same turns, torch.matmul on the
    same inputs (``lib@``)."""
    from tokensgen_tpu_torch.tools.bench_matmul_hand import M, NAMES, make_inputs

    entries = []
    for (kdim, n), name in NAMES.items():
        x, y = make_inputs(dev, M, kdim, n)
        ref = P.matmul_plain(x, y)
        label = "@" + name.replace(" ", "_")
        entries.append((label, lambda x=x, y=y: P.matmul_hand(x, y), ref))
        entries.append(("lib" + label, lambda x=x, y=y: torch.matmul(x, y), ref))
    return {"parent": [e for e in entries if not e[0].startswith("lib")],
            "shipped": entries}, None


def _t3a_case(dev):
    """T3a at its script's joint shape: {style: [(label, fn)]} (the
    parent's entry point at its three tiles, the shipped wrapper at both of
    its tiles) and the plain version."""
    from tokensgen_tpu_torch.tools.bench_attn_r3 import make_inputs

    x = make_inputs(dev)
    q, k, v, tq, tk = x["q"], x["k"], x["v"], x["tq"], x["tk"]
    h = q.shape[2] // 64
    shift = P.score_shift(tq, tk).item()
    ref = P.attention_maxfree_plain(q, k, v, None, tq, tk, h, shift)
    parent = [(f"@{bq}x{bn}", lambda bq=bq, bn=bn: P._launch_maxfree(
        "tg_probe_attn_splitpv", q, k, v, None, tq, tk, h, 1e-6, shift, bq, bn))
        for bq, bn in ((128, 64), (128, 32), (64, 64))]
    shipped = [(f"@{bq}x{bn}", lambda bq=bq, bn=bn: P.attention_splitpv(
        q, k, v, None, tq, tk, h, bq, bn, shift=shift)) for bq, bn in P.SPLITPV_CONFIGS]
    return {"parent": parent, "shipped": shipped}, ref


def _t1_case(dev):
    """T1 at its script's [1, 48, 17,776, 64] with its zero key bias:
    {style: [(label, fn)]} (the parent's entry point at each of its tiles;
    the shipped wrapper at each of `SWEEP_CONFIGS` and at its default with
    no bias, ``-nobias``) and the plain version. (The library call is
    chip_smoke.py's: the port calls no library attention.)"""
    from tokensgen_tpu_torch.tools.bench_attn_sweep import make_inputs

    q, k, v, bias = make_inputs(dev, 1, 48, 17776)
    ref = P.attention_sweep_plain(q, k, v, bias)
    label = lambda c: "@" + "x".join(map(str, c))  # noqa: E731
    parent = [(label(c), lambda c=c: P._launch_attn("tg_probe_attn_sweep", q, k, v, bias, *c))
              for c in SWEEP_PARENT_CONFIGS]
    shipped = [(label(c), lambda c=c: P.attention_sweep(q, k, v, bias, *c))
               for c in P.SWEEP_CONFIGS]
    # the same function with no bias (the bias is zero): the kernel's build without it
    shipped.append((label(P.SWEEP_DEFAULT) + "-nobias",
                    lambda: P.attention_sweep(q, k, v, None, *P.SWEEP_DEFAULT)))
    return {"parent": parent, "shipped": shipped}, ref


def _t4a_case(dev):
    """T4a's kernel alone at its script's cross1 shape, k prologued once:
    {style: [(label, fn)]} (`probes.pairinner_prologued` at each q block of
    `PAIRINNER_BLOCK_Q`) and the plain version.
    Prints each block_q's blocks, waves and the last wave's idle share."""
    from tokensgen_tpu_torch.tools.bench_attn_r3 import make_inputs

    x = make_inputs(dev)
    q, k, v, tq, tk = x["q"], x["kv"], x["vv"], x["tq_tv"], x["tk_vip"]
    h = q.shape[2] // 64
    shift = P.score_shift(tq, tk).item()
    kn = A.merge_heads(A.apply_prologue_plain(A.split_heads(k, h), tk, 1e-6, True))
    ref = P.attention_maxfree_plain(q, kn, v, None, tq, tk, h, shift, k_prologued=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for bq in P.PAIRINNER_BLOCK_Q:
        blocks, waves, idle = P.pairinner_waves(1, q.shape[1], h, bq, sms)
        print(f"T4a@{bq}: {blocks} blocks, {waves:.2f} waves of {sms} (one a SM), last wave "
              f"{idle:.0%} idle", flush=True)
    # the same entry point in every build (the parent leaves the q' workspace unused)
    entries = [(f"@{bq}", lambda bq=bq: P.pairinner_prologued(q, kn, v, None, tq, h, shift, bq))
               for bq in P.PAIRINNER_BLOCK_Q]
    return {"parent": entries, "shipped": entries}, ref


def _t2_case(dev):
    """T2 at its script's [1, 48, 17,776, 64] with its zero key bias (every
    mode and tile the same function): {style: [(label, fn)]} (the parent's
    entry point at each of its tiles in "last" and the parent commit's T1 at
    T1's default; the shipped wrapper in "last" at each of `SWEEP_CONFIGS`
    and in "full", every tile biased, at its default: T1's launch) and the
    plain version."""
    from tokensgen_tpu_torch.tools.bench_attn_sweep import make_inputs

    q, k, v, bias = make_inputs(dev, 1, 48, 17776)
    ref = P.attention_sweep_plain(q, k, v, bias)
    label = lambda c: "@" + "x".join(map(str, c))  # noqa: E731
    d = P.SWEEP_DEFAULT
    parent = [(f"@{bq}x{bn}-last", lambda bq=bq, bn=bn: P._launch_attn(
        "tg_probe_attn_v2", q, k, v, bias, bq, bn, 1)) for bq, bn in ((64, 64), (128, 64), (64, 128))]
    # "full" at the default is T1's launch: the parent commit's T1 beside it
    parent.append((label(d) + "-full", lambda: P._launch_attn("tg_probe_attn_sweep", q, k, v, bias,
                                                              *d)))
    shipped = [(label(c) + "-last", lambda c=c: P.attention_v2(q, k, v, bias, c[0], c[1], "last",
                                                               c[2])) for c in P.SWEEP_CONFIGS]
    shipped.append((label(d) + "-full", lambda: P.attention_v2(q, k, v, bias, d[0], d[1], "full",
                                                               d[2])))
    return {"parent": parent, "shipped": shipped}, ref


def _t4b_case(dev):
    """T4b at its script's cross2 shape (480 q rows x 18,256 keys, 48 heads):
    {style: [(label, fn)]} (the parent's entry point and the shipped wrapper
    at each split of `SPLITKV_BLOCK_KV`) and the plain version. Prints each
    split's blocks and waves (one block a SM)."""
    from tokensgen_tpu_torch.tools.bench_attn_r3 import make_inputs

    x = make_inputs(dev)
    q, k, v, tq, tk = x["qv"], x["kcat"], x["vcat"], x["tq_vip"], x["tk_all"]
    b, sq, skv, h = q.shape[0], q.shape[1], k.shape[1], q.shape[2] // 64
    shift = P.score_shift(tq, tk).item()
    ref = P.attention_maxfree_plain(q, k, v, None, tq, tk, h, shift)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for split in P.SPLITKV_BLOCK_KV:
        blocks = -(-skv // split) * h * b
        print(f"T4b@{split}: {blocks} blocks, {blocks / sms:.2f} waves of {sms} (one a SM)",
              flush=True)
    # the parent's workspace: f32 partials of every split (B H splits Sq 65)
    parent = [(f"@{split}", lambda split=split: P._launch_maxfree(
        "tg_probe_cross_splitkv", q, k, v, None, tq, tk, h, 1e-6, shift, split,
        ws_bytes=b * h * -(-skv // split) * sq * 65 * 4)) for split in P.SPLITKV_BLOCK_KV]
    shipped = [(f"@{split}", lambda split=split: P.cross_smallq_splitkv(
        q, k, v, None, tq, tk, h, split, shift=shift)) for split in P.SPLITKV_BLOCK_KV]
    return {"parent": parent, "shipped": shipped}, ref


def _k5d128_case(dev):
    """K5 at head dim 128 at the T2To width's [3, 24, 9,442, 128] with the
    padded-chunk key bias of (24, 13, 5) valid chunks (chip_smoke.py's row):
    {style: [(label, fn)]} (the parent's entry point, which takes no table
    and no workspace at 128, and the shipped wrapper) and the plain
    version."""
    from tokensgen_tpu_torch.train.t2to import padded_chunk_masks

    gen = torch.Generator(dev).manual_seed(15)
    b, h, s, d, text = 3, 24, 9442, 128, 226
    q, k, v, g = (torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16() for _ in range(4))
    bias, _ = padded_chunk_masks(torch.tensor([24, 13, 5], device=dev) * 4, 96, 96, text)
    scale = d ** -0.5
    out, lse = A.attention_plain(q, k, v, bias, scale, with_lse=True)
    dsum = A._row_dsum(g, out, None)
    del out
    ref = A.attention_bwd_plain(q, k, v, g, lse, dsum, bias, scale)

    def shipped():
        return A.attention_backward(q, k, v, g, lse, dsum, bias, None, scale, with_dbias=True)

    def parent():  # the wrapper as it was at 128: no table, no workspace
        saved, A.ONEPASS_HEAD_DIMS = A.ONEPASS_HEAD_DIMS, (64,)
        try:
            return shipped()
        finally:
            A.ONEPASS_HEAD_DIMS = saved

    return {"parent": [("", parent)], "shipped": [("", shipped)]}, ref


def _flash_loop_parent(q, k, v, iters):
    """The parent commit's T6 entry point (no split, no workspace)."""
    m, n = q.shape[0], k.shape[1]
    out = torch.empty(m, P.FLASH_LOOP_D, dtype=torch.float32, device=q.device)
    a = P._FlashLoopArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m, n, iters)
    B.check_launch("tg_probe_flash_loop", P._Library.get().tg_probe_flash_loop(
        ctypes.byref(a), int(q.dtype == torch.int8), B.stream_of(q)))
    return out


def _t6_case(dev):
    """T6 at its CLI's shapes (2,048 x 2,048 and 2,048 x 1,024 keys, d = 128)
    in int8 and bf16 at 500 steps: {style: [(label, fn, plain output)]} (the
    parent's entry point, the shipped wrapper)."""
    from tokensgen_tpu_torch.tools.bench_int8_loop import make_inputs

    iters = 500
    parent, shipped = [], []
    for n in (2048, 1024):
        for dt, name in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
            x = make_inputs(dev, 2048, n, 128, dt)
            ref = P.flash_loop_plain(*x, iters)
            label = f"@{name}x{n}"
            parent.append((label, lambda x=x: _flash_loop_parent(*x, iters), ref))
            shipped.append((label, lambda x=x: P.flash_loop(*x, iters), ref))
    return {"parent": parent, "shipped": shipped}, None


def _bind_parent_probes(lib) -> None:
    """An older probes.cu's entry points that the cases call: the max-free
    ones, T1's and, where it has it, T7's (older builds have no geometry
    queries; T7 left probes.cu with its redesign)."""
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    for name in P._MAXFREE_ENTRY_POINTS:
        B.bind(lib, name, ctypes.POINTER(A._Args), i64, i64, ctypes.c_float, ptr, ptr)
    B.bind(lib, "tg_probe_attn_sweep", ctypes.POINTER(A._Args), i64, i64, i64, ptr)
    B.bind(lib, "tg_probe_attn_v2", ctypes.POINTER(A._Args), i64, i64, i64, ptr)
    # T6's entry point before its key-split body: no split, no workspace
    B.bind(lib, "tg_probe_flash_loop", ctypes.POINTER(P._FlashLoopArgs), i64, ptr)
    if hasattr(lib, "tg_probe_matmul"):
        B.bind(lib, "tg_probe_matmul", ctypes.POINTER(P._MatmulArgs), ptr)


# every output within these of its plain version: relative L2 and max abs
# relative to max|ref| (the float32 K4: its card bounds)
BOUNDS = {"F32": (1e-5, 2.0 ** -14)}


def _agrees(out, ref, bounds=(1e-2, 2.0 ** -5)) -> bool:
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for x, r in zip(outs, refs):
        diff, r = x.float() - r.float(), r.float()
        if not (torch.isfinite(x).all() and diff.norm() <= bounds[0] * r.norm()
                and diff.abs().max() <= bounds[1] * r.abs().max()):
            return False
    return True


def _f32_time_ms(fn, runs: int, calls: int = 10) -> float:
    """Median over ``runs`` of the device time of ``calls`` back-to-back
    calls, per call: the float32 K4 takes ~0.3 ms, of the order of the
    wrapper's host time, which a single call's events would count."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[len(times) // 2]


def _f32_errors(out, ref) -> str:
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    parts = []
    for x, r in zip(outs, refs):
        diff, r = x.float() - r.float(), r.float()
        parts.append(f"rel_l2 {(diff.norm() / r.norm()).item():.2e} "
                     f"max_abs {diff.abs().max().item():.2e}")
    return "; ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2, help="turns over the variants")
    ap.add_argument("--runs", type=int, default=5, help="timed calls per case (median)")
    ap.add_argument("--only", default="", help="comma-separated variants (default: all)")
    ap.add_argument("--stamps", action="store_true", help="clock64() stamps of one K5 q tile")
    ap.add_argument("--parents", default="",
                    help="DIR/<commit>/ holds the parent commits' csrc (--export-parents); "
                    "default: git")
    ap.add_argument("--build-only", action="store_true",
                    help="build every listed variant, print its ptxas lines, time nothing")
    ap.add_argument("--export-parents", default="", metavar="DIR",
                    help=f"write csrc/ of {', '.join(PARENT_COMMITS)} into DIR/<commit>/ and exit")
    ap.add_argument("--f32-builds", type=int, default=2,
                    help="nvcc builds of each float32 K4 variant, each timed")
    ap.add_argument("--probe-builds", type=int, default=2,
                    help="nvcc builds of each T3b / T5 variant, each timed")
    ap.add_argument("--probe-stamps", action="store_true",
                    help="clock64() stamps of two T3b kv tiles, four T5 steps and two "
                    "T3a kv tiles")
    args = ap.parse_args(argv)
    if args.export_parents:
        export_parents(args.export_parents)
        return 0
    dev = _common.device_of(argparse.Namespace(device="cuda"))
    names = [n for n in args.only.split(",") if n] or list(VARIANTS)
    # build key -> (variant, source, a parent's csrc files or None, patches)
    builds = {}
    for n in names:
        kernel, _, patches = VARIANTS[n]
        files = (_parent_files(args.parents, PARENT_OF.get(kernel, MF_PARENT_COMMIT))
                 if patches is None else None)
        if kernel == "F32":
            for i in range(args.f32_builds):
                builds[f"{n}.{i}"] = (n, F32, files, patches or [])
        elif kernel in ("K123", "K5D128"):
            builds[n] = (n, CU, files, patches or [])
        elif kernel in PROBE_KINDS:
            source = GEMM if kernel == "T7" and patches is not None else PROBES
            for i in range(args.probe_builds):
                builds[f"{n}.{i}"] = (n, source, files, patches or [])
        else:
            builds[n] = (n, CU, None, patches)
    if args.stamps:
        builds["k5_stamps"] = ("k5_stamps", CU, None, _K5_STAMPS)
    if args.probe_stamps:
        builds["mf_stamps"] = ("mf_stamps", PROBES, None, _MF_STAMPS)
    root = B.BUILD_DIR / "ablations"
    root.mkdir(parents=True, exist_ok=True)
    print(f"{_common.device_name(dev)}; {len(builds)} builds", flush=True)
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda kv: _patched(kv[0], kv[1][3], root, kv[1][1], kv[1][2]),
                              builds.items()))
    libs = {}
    for key, rc, log, dt in built:
        if rc:
            raise RuntimeError(f"{key}: nvcc failed ({rc}):\n{log[-4000:]}")
        regs = [f"{label} {r} registers, {s} bytes spilled" for k, r, s in B.ptxas_report(log)
                for tag, label in (("bwd_onepass_kernel", "K5"), ("smallkv_kernel", "K2"),
                                   ("joint_int8_splitkv_kernel", "K7"),
                                   ("bhsd_f32_kernelILi64", "float32 K4 at d = 64"),
                                   ("pair2_kernel", "T3b"), ("pairloop_kernel", "T5"),
                                   ("11gemm_kernel", "T7"), ("13matmul_kernel", "T7 (parent)"),
                                   ("pair_splitpv_kernelILi2", "T3a at 128 rows"),
                                   ("pair_splitpv_kernelILi1", "T3a at 64 rows"),
                                   ("14splitpv_kernel", "T3a (parent)"),
                                   ("12sweep_kernel", "T1"), ("17attn_sweep_kernel", "T1 (parent)"),
                                   ("20pairinner_tma_kernel", "T4a"),
                                   ("16pairinner_kernel", "T4a (parent)"),
                                   ("18splitkv_tma_kernelILi2", "T4b"),
                                   ("18splitkv_tma_kernelILi1", "T4b (one warpgroup)"),
                                   ("14splitkv_kernel", "T4b (parent)"),
                                   ("14attn_v2_kernel", "T2 (parent)"),
                                   ("bwd_onepass128_kernel", "K5 at d = 128"),
                                   ("bwd_dkdv_kernelILi128", "K5 at d = 128, dk / dv pass (parent)"),
                                   ("bwd_dq_kernelILi128", "K5 at d = 128, dq pass (parent)"),
                                   ("17flash_loop_kernelIa", "T6 int8"),
                                   ("17flash_loop_kernelI13__nv_bfloat16", "T6 bf16"))
                if tag in k]
        print(f"[build] {key} in {dt:.0f} s: " + "; ".join(regs), flush=True)
        for line in log.splitlines():
            if "Performance Loss" in line:
                print(f"[build]   {line.strip()}", flush=True)
        if args.build_only:
            continue
        lib = ctypes.CDLL(str(root / key / "lib.so"))
        if builds[key][1] == F32:  # the entry point only: the parent has no geometry query
            B.bind(lib, A._F32_ENTRY_POINT, ctypes.POINTER(A._F32Args), ctypes.c_int64,
                   ctypes.c_void_p)
        elif builds[key][1] == GEMM:
            P._bind_gemm(lib)
        elif builds[key][1] == PROBES and builds[key][2] is not None:
            _bind_parent_probes(lib)
        elif builds[key][1] == PROBES:
            P._bind(lib)
        else:
            A._bind(lib)
        libs[key] = lib
    if args.build_only:
        return 0
    stamp_keys = ("k5_stamps", "mf_stamps")
    kinds = {VARIANTS[builds[key][0]][0] for key in builds if key not in stamp_keys}
    kernels = {k for kind in kinds for k in PROBE_KINDS.get(kind, (kind,))}
    makers = {"K5": _k5_case, "K2": _k2_case, "K7": _k7_case, "F32": _f32_case,
              "K5D128": _k5d128_case, "T6": _t6_case,
              "T3B": _t3b_case, "T5": _t5_case, "K1": _k1_case, "K3": _k3_case,
              "T7": _t7_case, "T3A": _t3a_case, "T1": _t1_case, "T4A": _t4a_case,
              "T2": _t2_case, "T4B": _t4b_case}
    cases = {k: make(dev) for k, make in makers.items()
             if k in kernels or ("all" in kernels and k in ("K5", "K2", "K7"))}
    order = [key for key in builds if key not in stamp_keys]
    times = {}
    for rnd in range(args.rounds):
        for key in order if rnd % 2 == 0 else order[::-1]:
            name = builds[key][0]
            kind = VARIANTS[name][0]
            if builds[key][1] == F32:
                A._F32Library.lib = libs[key]
            elif builds[key][1] == GEMM:
                P._GemmLibrary.lib = libs[key]
            elif builds[key][1] == PROBES:
                P._Library.lib = libs[key]
                if kind == "T7":  # a parent: T7 still in probes.cu
                    P._GemmLibrary.lib = libs[key]
            else:
                A._Library.lib = libs[key]
            for kernel, (fns, ref) in cases.items():
                if kind == "all":
                    if kernel not in ("K5", "K2", "K7"):
                        continue
                elif kernel not in PROBE_KINDS.get(kind, (kind,)):
                    continue
                labelled = (fns.get("parent" if VARIANTS[name][2] is None else "shipped")
                            if isinstance(fns, dict) else [("", fns)])
                for label, fn, *own in labelled:  # an entry may bring its own plain output
                    want = own[0] if own else ref
                    out = fn()
                    ok = _agrees(out, want, BOUNDS.get(kernel, (1e-2, 2.0 ** -5)))
                    detail = (f" ({_f32_errors(out, want)})"
                              if kernel in ("F32", "T3B", "T5", "T7", "T3A", "T1", "T4A", "T2", "T4B",
                                            "K5D128", "T6")
                              else "")
                    del out
                    ms = (_f32_time_ms(fn, args.runs) if kernel == "F32"
                          else _common.queued_time_ms(fn, dev, args.runs)
                          if kernel in QUEUED_KINDS
                          else _common.time_ms(fn, dev, args.runs))
                    times.setdefault((key, kernel + label), []).append(ms)
                    print(f"round {rnd} {key} {kernel}{label} {ms:.4f} ms agrees {ok}{detail}",
                          flush=True)
    for (key, kernel), ms in times.items():
        print(f"{key:16s} {kernel}: " + " / ".join(f"{x:.4f}" for x in ms)
              + f" ms  ({VARIANTS[builds[key][0]][1]})")
    if args.stamps:
        if "K5" not in cases:
            cases["K5"] = _k5_case(dev)
        A._Library.lib = libs["k5_stamps"]
        cases["K5"][0]()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 64)()
        libs["k5_stamps"].tg_prof_read(buf)
        for tile in (0, 1):
            for wg in (0, 1):
                base = buf[tile * 32]
                stamps = ", ".join(f"{p} {buf[tile * 32 + wg * 16 + i] - base}"
                                   for i, p in enumerate(STAMP_PHASES))
                print(f"K5 tile {50 + tile} warpgroup {wg} clocks: {stamps}")
        print(f"K5 tile 50 -> tile 51: {buf[32] - buf[0]} clocks")
    if args.probe_stamps:
        P._Library.lib = libs["mf_stamps"]
        for kernel, maker in (("T3B", _t3b_case), ("T5", _t5_case), ("T3A", _t3a_case)):
            if kernel not in cases:
                cases[kernel] = maker(dev)
            cases[kernel][0]["shipped"][0][1]()  # T3a: at 128 rows
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 192)()
        libs["mf_stamps"].tg_prof_read(buf)
        for tile in (0, 1):
            for wg in (0, 1):
                base = buf[tile * 32]
                stamps = ", ".join(f"{p} {buf[tile * 32 + wg * 16 + i] - base}"
                                   for i, p in enumerate(P2_STAMP_PHASES))
                print(f"T3b tile {50 + tile} warpgroup {wg} clocks: {stamps}")
        for step in range(4):
            for wg in (0, 1):
                base = buf[64 + step * 16]
                stamps = ", ".join(f"{p} {buf[64 + step * 16 + wg * 8 + i] - base}"
                                   for i, p in enumerate(PL_STAMP_PHASES))
                print(f"T5 step {100 + step} warpgroup {wg} clocks: {stamps}")
        for tile in (0, 1):
            for wg in (0, 1):
                base = buf[128 + tile * 32]
                stamps = ", ".join(f"{p} {buf[128 + tile * 32 + wg * 16 + i] - base}"
                                   for i, p in enumerate(SP_STAMP_PHASES))
                print(f"T3a tile {50 + tile} warpgroup {wg} clocks: {stamps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
