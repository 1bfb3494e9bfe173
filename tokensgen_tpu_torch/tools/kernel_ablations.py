"""Ablations of the design choices that K5 (`attention_backward` at head dim
64, csrc/flash_bwd.cuh) and K2 (`fused_attention_cross_smallkv`,
csrc/flash_ws.cuh's `smallkv_body`) keep: kernels/csrc is built once per
variant (the shipped source, and copies in which one choice is undone by a
text patch), one nvcc per variant at once; each build's registers and
spills for the two kernels are printed; then each variant's K5 at the joint
training shape ([2, 48, 17,776, 64] against itself) and K2 at the edit
shape (17,776 q rows against 480 keys, 48 heads of 64) are timed through
the port's wrappers in turns (CUDA events, median), each call held to its
plain version. With --stamps, a build with clock64() stamps prints the
clocks of one K5 q tile (block 40 of head 3, tiles 50 and 51) per phase.
The card only.

    python -m tokensgen_tpu_torch.tools.kernel_ablations [--rounds 2] [--runs 5]
        [--only shipped,k5_atomics,...] [--stamps]
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from tokensgen_tpu_torch.kernels import attention as A
from tokensgen_tpu_torch.kernels import build as B
from tokensgen_tpu_torch.tools import _common

BWD, WS, FWD, CU = "flash_bwd.cuh", "flash_ws.cuh", "flash_fwd.cuh", "attention.cu"

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

# name: (kernel, what the variant undoes, patches)
VARIANTS = {
    "shipped": ("both", "nothing", []),
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
}


def _patched(name: str, patches, root):
    """A copy of csrc with ``patches`` applied, built; (name, rc, nvcc output, seconds)."""
    d = root / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(B.CSRC, d)
    for f, old, new in patches:
        text = (d / f).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: patch of {f} does not apply: {old[:60]!r}")
        (d / f).write_text(text.replace(old, new))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *B.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "attention.cu")],
                          capture_output=True, text=True)
    return name, proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


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


def _k2_case(dev):
    gen = torch.Generator(dev).manual_seed(3)
    b, h, sq, skv = 2, 48, 17776, 480
    q, k, v = (torch.randn(b, s, h * 64, generator=gen, device=dev).bfloat16()
               for s in (sq, skv, skv))
    gain = 1 + 0.1 * torch.randn(64, generator=gen, device=dev)
    shift = 0.1 * torch.randn(64, generator=gen, device=dev)
    tabs = [A.make_prologue(64, [((ang.cos(), ang.sin()), n)], gain, shift, fold=fold)
            for n, fold in ((sq, 0.125), (skv, 1.0))
            for ang in [torch.randn(n, 64, generator=gen, device=dev)]]
    ref = A._fused_plain_merged(q, k, v, torch.zeros(b, skv, device=dev), tabs[0], tabs[1], h,
                                1e-6, True, True)
    return (lambda: A.fused_attention_cross_smallkv(q, k, v, tabs[0], tabs[1], heads=h)), ref


def _agrees(out, ref) -> bool:
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for x, r in zip(outs, refs):
        diff, r = x.float() - r.float(), r.float()
        if not (torch.isfinite(x).all() and diff.norm() <= 1e-2 * r.norm()
                and diff.abs().max() <= 2.0 ** -5 * r.abs().max()):
            return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2, help="turns over the variants")
    ap.add_argument("--runs", type=int, default=5, help="timed calls per case (median)")
    ap.add_argument("--only", default="", help="comma-separated variants (default: all)")
    ap.add_argument("--stamps", action="store_true", help="clock64() stamps of one K5 q tile")
    args = ap.parse_args(argv)
    dev = _common.device_of(argparse.Namespace(device="cuda"))
    names = [n for n in args.only.split(",") if n] or list(VARIANTS)
    builds = {n: VARIANTS[n][2] for n in names}
    if args.stamps:
        builds["k5_stamps"] = _K5_STAMPS
    root = B.BUILD_DIR / "ablations"
    root.mkdir(parents=True, exist_ok=True)
    print(f"{_common.device_name(dev)}; {len(builds)} builds", flush=True)
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda kv: _patched(kv[0], kv[1], root), builds.items()))
    libs = {}
    for name, rc, log, dt in built:
        if rc:
            raise RuntimeError(f"{name}: nvcc failed ({rc}):\n{log[-4000:]}")
        regs = [f"{label} {r} registers, {s} bytes spilled" for k, r, s in B.ptxas_report(log)
                for key, label in (("bwd_onepass_kernel", "K5"), ("smallkv_kernel", "K2"))
                if key in k]
        print(f"[build] {name} in {dt:.0f} s: " + "; ".join(regs), flush=True)
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        A._bind(lib)
        libs[name] = lib
    cases = {"K5": _k5_case(dev), "K2": _k2_case(dev)}
    times = {(n, c): [] for n in names for c in cases}
    for rnd in range(args.rounds):
        for name in names if rnd % 2 == 0 else names[::-1]:
            A._Library.lib = libs[name]
            for kernel, (fn, ref) in cases.items():
                if VARIANTS[name][0] not in ("both", kernel):
                    continue
                ok = _agrees(fn(), ref)
                ms = _common.time_ms(fn, dev, args.runs)
                times[(name, kernel)].append(ms)
                print(f"round {rnd} {name} {kernel} {ms:.3f} ms agrees {ok}", flush=True)
    for (name, kernel), ms in times.items():
        if ms:
            print(f"{name:16s} {kernel}: " + " / ".join(f"{x:.3f}" for x in ms)
                  + f" ms  ({VARIANTS[name][1]})")
    if args.stamps:
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
