// The Hopper bodies of four probes of probes.cu: T1 (tg_probe_attn_sweep,
// K4's flash attention at a tile sweep) and T2 (tg_probe_attn_v2, the same
// with the key bias on the last kv tile only), T4a
// (tg_probe_cross_pairinner, the head-fastest resident small-kv cross
// attention) and T4b (tg_probe_cross_splitkv, the split-kv small-q cross
// attention). They load their tiles by TMA onto mbarriers and multiply by
// wgmma, on the pieces that
// probes_maxfree.cuh's bodies share (tma_ring.cuh's slot ring,
// flash_prologue.cuh's tensor maps, flash_splitkv.cuh's and flash_ws.cuh's
// wgmma helpers). Only probes.cu includes this header.
//
// T1, sweep_kernel<BQ, BN, HB> (<- tools/bench_attn_sweep.py `_tpu`, K4's
// `_flash_kernel` of tokensgen_tpu/kernels/attention.py:54 at explicit
// block_q / block_kv / hblk): softmax(q k^T / sqrt(d) + key bias) v on
// [B, H, S, 64] bf16, an exact online max. The JAX script's three tile axes,
// read on this card's terms:
// * block_q (BQ) in {128, 256}: q rows a block, over two warpgroups of 64
//   rows each; at 256 each warpgroup holds two row blocks (rows 128 rb +
//   64 w), its two chains, as K1's body (flash_ws.cuh).
// * block_kv (BN) in {128, 192}: keys a K / V tile, the score product's N
//   (m64nBNk16). 64 is out: the score and p.v products must differ in
//   wgmma shape (m64n64k16 twice gave wrong scores).
// * hblk (HB) in {1, 2}: heads a block. At 2 each warpgroup's two chains are
//   one row block of each head, and a ring slot holds both heads' K / V
//   tiles: the TPU kernel's two-head interleave (its docstring: one head's
//   products overlap the other's softmax), done by a warpgroup's two chains.
//   Two row blocks of two heads (4 chains) are not built: four 64 x 64
//   accumulators beside a score and a p tile leave ptxas no registers.
// Per block: the q tile (HB heads x BQ rows, raw bf16) comes once by TMA;
// K / V tiles stream through a ring of slots (tma_ring.cuh's StepRing),
// released by each warp's predicated arrive after its last p.v of the tile
// and filled by warpgroup 1's first thread (SW_LOADER) when no wgmma is in
// flight: with two row blocks a warpgroup (block_q 256) right after its
// own release, waiting for the other warpgroup's (K1's form: 12.0-12.2
// against 13.4-13.5 ms at (256, 128, 1)); otherwise at each tile's start,
// not waiting (11.5-11.7 against 12.3-12.5 at (128, 128, 2); the wait cost
// 1 ms at (128, 128, 1), whose warpgroups run apart).
// With a key bias each slot also takes the tile's BN biases by TMA (a 1-D
// map over the flat [B * Skv] bias: no row stride to align; the box starts
// at the 16-byte boundary below the tile's first key, as TMA needs, and
// holds 4 more); each thread loads its BN / 4 of them into registers while
// the tile's scores are in flight (sweep_bias). Read from global memory a
// score at a time they cost 7 ms of 17.4 at the script's shape; from shared
// memory in the softmax, 0.3 ms more than from registers. Even so the bias
// costs 2.6 ms (12.1 against 9.5 without, at (256, 128, 1)): its FFMA and
// loads sit on the softmax's path between the scores and the max.
// With one chain a warpgroup issues tile t's scores with tile t - 1's p.v
// and runs tile t's softmax meanwhile, rescaling the accumulator once that
// p.v is in (FA3's intra-warpgroup overlap); with two, the chains take
// turns as in K1 (one chain's scores issued with the other's p.v). Scores
// wgmma SS (q and K from shared memory), p.v wgmma RS (p from registers).
// q is staged raw, so the softmax scale is not rounded into bf16 q: it
// joins the FFMA that subtracts the running max, p = 2^(s sc - m sc), with
// the max taken on the raw scores; with a key bias the scores become x =
// s + bias d^1/2 in one FFMA, the max and p taken on x alike, so that
// tiles with and without biases share one running max. Keys past Skv score
// -inf (TMA reads them as zeros); rows past Sq are not stored.
//
// T2 (<- tools/bench_attn_v2.py `_kernel_v2`) is T1's function with the key
// bias on every kv tile ("full": T1's launch itself) or only on the last
// ("last", where the JAX probe keeps its padding mask). "last" is T1's body
// at the same tiles with the template flag LAST: every tile but the last
// takes T1's bias-free path (the max on the raw scores, no bias box in the
// slot, no bias FFMA); the last tile, which also holds the ragged mask,
// stages its biases by the 1-D map (its box from the same 16-byte
// boundary), its slot's mbarrier alone expecting their bytes, and adds
// them in raw-score units (x = s + bias d^1/2) so that its max joins the
// bias-free tiles'. A runtime per-tile predicate in T1's own instantiations
// instead ran "last" as fast but T1 ("full") 6% slower (12.07-12.24 ms
// against 11.32-11.52 at (128, 128, 2) on an H100 80GB HBM3 at 700 W,
// tools/kernel_ablations.py), so T1's instantiations keep their code and
// "last" has its own three.
// Bound: the two products at the bf16 tensor-core rate, the exponentials at
// the MUFU's. tools/kernel_ablations.py times the loader, the refill point
// and the fold against their removal (SW_PRODUCER, SW_FOLD below).
//
// T4a, pairinner_tma_kernel (<- tools/bench_cross_r3.py `_smallkv_kernel`): K2's
// function max-free (probes_maxfree.cuh's softmax: p = 2^min(s + bias log2 e
// - C, 0), C the wrapper's static shift; p kept down to f32's subnormals),
// k prologued by the wrapper (in plain torch, as the JAX wrapper runs it in
// XLA). K' / V resident (128 KB) and q's three f32 tables (3 x 16 KB a
// warpgroup, as T5 holds them) do not fit a block's shared memory together,
// so q's LayerNorm + RoPE prologue runs as K1's prologue pass
// (flash_prologue.cuh, once per row, every head of it) into a bf16 q'
// workspace ahead of the body (PI_PROLOGUE_PASS). Grid (H, ceil(Sq /
// block_q), B), the head fastest, as the JAX grid's pair innermost: the 48
// blocks of one q block run side by side. A block holds its head's K' and V
// whole (up to 512 keys: four 128-key tiles, the last ragged, 128 KB), by
// TMA once, one mbarrier a tile, then runs its block_q rows against them in
// chunks of 64 rows, warpgroup w taking chunks w, w + 2, ... on its own:
// * q' (64-row boxes of the 128-byte swizzle) by TMA through PI_SLOTS
//   slots a warpgroup, loaded a chunk ahead, once the chunk's last scores
//   are waited for, with no wgmma in flight;
// * scores wgmma SS over the <= 4 resident tiles, p.v wgmma RS, one tile's
//   p.v under the next tile's softmax (no running max: nothing to rescale);
//   keys past Skv take p = 0 (TMA fills K' with zeros there, whose score 0
//   would count);
// * the output normalized into a staging box in the 128-byte swizzle, then
//   stored by TMA (rows past Sq clipped).
// Without PI_PROLOGUE_PASS (the ablation) each chunk of raw q is prologued
// in place, the table values read from global memory (L2: the head-fastest
// grid) into registers (prologue_q_global): 7-10% slower at the script's
// shape than the pass, which reads each table row once for all 48 heads.
// Bound: the two products at the bf16 tensor-core rate.
//
// T4b, splitkv_tma_kernel<WG> (<- tools/bench_cross_r3.py `_smallq_kernel`):
// K3's function max-free, short q against a long kv, both prologues in the
// call. T4a's problem with the roles swapped: K1's prologue pass writes k'
// and q' once per row into a bf16 workspace, then grid (kv splits, H, B): a
// block holds its split's K' and V whole (split 256 / 384 / 512 keys: 2-4
// tiles, keys past Skv masked) and runs every q' row against them through
// T4a's resident body (resident_body<WG, true>). Only the output differs:
// each 64-row chunk's f32 acc and row sums are staged (the acc in the
// 128-byte swizzle, two boxes of 32 columns) and added by TMA reduce-add
// (cp.reduce.async.bulk.tensor .add.f32) into one accumulator [B * H][Sq]
// x (64 + 1) that the launcher zeroes; its maps have an Sq dimension of
// their own, so that a chunk past Sq (480 rows: 7.5 chunks) is clipped
// rather than added into the next head's rows. With no running max the
// splits' partials simply add; a last pass writes o = acc / max(l,
// FLT_MIN) in bf16. The parent wrote B * H * splits * Sq * 65 f32 partials
// (215.7 MB at split 512) and read them back; the reduce-add's order varies
// from call to call, and so may the last bits (as K5's dq). SK_REDUCE (the
// ablation) stores each split's partials apart and sums them in the last
// pass. SK_TWO_BLOCKS runs split 256, the default, as blocks of one
// warpgroup (8 chunks in turn), two resident a SM, so that one block's
// K' / V load runs under the other's products (at two warpgroups a block
// their registers, 162 a thread, allow one); 384 and 512 take two
// warpgroups, one block a SM.
// Bound: the two products at the bf16 tensor-core rate, the exponentials at
// the MUFU's.

#pragma once

#include <cfloat>

#include "probes_maxfree.cuh"

namespace {

// d (m64 x n192 f32) += A (m64 x k16, shared memory, K-major) x B (k16 x
// n192, K-major): T1's score product at block_kv 192.
template <>
__device__ __forceinline__ void wgmma_ss<192>(float (&d)[24][4], uint64_t adesc, uint64_t bdesc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

// one box of a 1-D tensor map at element c0, completing on ``bar``
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// one 64-row box of shared memory into the tensor of a 4-D ``map`` at (c0,
// c1, c2, c3), in the issuing thread's bulk async-group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// T1
// ---------------------------------------------------------------------------

constexpr int SW_NT = 256;         // two consumer warpgroups
constexpr int SW_MAX_SLOTS = 4;    // K / V slots at most
constexpr int SW_SMEM_MAX = 232448;  // shared memory a block may use
// the softmax scale (and the key bias) folded into the FFMA that subtracts
// the running max; false: the scores scaled by a multiply of their own first
constexpr bool SW_FOLD = true;
// false: thread SW_LOADER fills the ring; true: a third, producer
// warpgroup does (384 threads, setmaxnreg)
constexpr bool SW_PRODUCER = false;
constexpr int SW_LOADER = 128;  // warpgroup 1's first thread
constexpr double LOG2E_D = 1.4426950408889634;

template <int BQ, int BN, int HB>
struct SweepGeom {
  static_assert(BQ == 128 || BQ == 256, "block_q 128 or 256");
  static_assert(BN == 128 || BN == 192, "block_kv 128 or 192");
  static constexpr int RB = BQ / 128;              // row blocks a warpgroup
  static constexpr int CHAINS = RB * HB;           // a warpgroup's accumulators
  static constexpr uint32_t QHEAD = BQ * 128;      // one head's q rows
  static constexpr uint32_t KV = BN * 128;         // one head's K (or V) tile
  static constexpr uint32_t SLOT = HB * 2 * KV;    // the K and V tiles of HB heads
  static constexpr int BIASN = BN + 4;             // a tile's key biases from a 16-byte boundary
  static constexpr uint32_t BIAS = (BIASN * 4 + 127) / 128 * 128;  // their box, 128-byte aligned
  static constexpr int FIT = static_cast<int>(
      (SW_SMEM_MAX - 1024 - HB * QHEAD - 8 * (2 * SW_MAX_SLOTS + 1)) / (SLOT + BIAS));
  static constexpr int SLOTS = FIT < SW_MAX_SLOTS ? FIT : SW_MAX_SLOTS;
  // dynamic shared memory: alignment slack, the q tile, the slots, their
  // key biases, their full and empty mbarriers and q's
  static constexpr int SMEM =
      static_cast<int>(1024 + HB * QHEAD + SLOTS * (SLOT + BIAS)) + 8 * (2 * SLOTS + 1);
  static constexpr int NT = SW_PRODUCER ? SW_NT + 128 : SW_NT;
  // the ring refilled right after the loader's release (waiting for the
  // other warpgroup's), else at each tile's start (not waiting)
  static constexpr bool REFILL_AFTER_RELEASE = RB == 2;
  static_assert(CHAINS <= 2, "at most two chains a warpgroup");
  static_assert(SLOTS >= 2, "two K / V slots at least");
};

// s = q.k^T over one tile of BN keys for this warpgroup's 64 q rows (q by
// ``qdesc``, K from ``Ks``), issued asynchronously; as issue_scores_ss
template <int BN>
__device__ __forceinline__ void sweep_scores(float (&s)[BN / 8][4], uint64_t qdesc,
                                             const unsigned char* Ks) {
  asm volatile("" : "+l"(qdesc));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<BN>(s, qdesc + kk * 2, smem_desc(Ks + kk * 32, 16, 8 * 128, 1), kk > 0);
}

// o += p.v over one tile of BN keys: V (MN-major) k-step j 16 keys on
template <int BN>
__device__ __forceinline__ void sweep_pv(float (&o)[8][4], const uint32_t (&pa)[BN / 16][4],
                                         const unsigned char* Vs) {
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wgmma_rs<64, 1>(o, pa[j], smem_desc(Vs + j * 2 * 8 * 128, BN * 128, 8 * 128, 1), 1);
}

// This thread's BN / 4 key biases of one tile (keys 8 nt + 2 t and the
// next, at bv[2 nt] and bv[2 nt + 1]) from the tile's biases in shared
// memory: loaded while the scores are in flight, off the softmax's path
template <int BN>
__device__ __forceinline__ void sweep_bias(float (&bv)[BN / 4], const float* bias) {
  const int t = threadIdx.x & 3;
  // 8-byte aligned pairs where the row starts on an even element (the same
  // for the whole block)
  if ((smem_addr(bias) & 7) == 0) {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(bias + nt * 8 + t * 2);
      bv[2 * nt] = b2.x;
      bv[2 * nt + 1] = b2.y;
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      bv[2 * nt] = bias[nt * 8 + t * 2];
      bv[2 * nt + 1] = bias[nt * 8 + t * 2 + 1];
    }
  }
}

// The softmax of one tile of BN keys (kv0 on) for this thread's two rows,
// from the raw scores ``s``: the running max ``m`` updated, p in place, the
// rows' sums in ``ls``; returns the factors by which the earlier acc and l
// shrink. ``sc`` = d^-1/2 log2 e. Without a key bias the max is taken on
// the raw scores and p = 2^(s sc - m sc), one FFMA a score; with one, x =
// s d^-1/2 + bias (one FFMA) and p = 2^(x log2 e - m log2 e), or with RAW
// (T2's "last", whose tiles with and without biases share one running max)
// x = s + bias d^1/2 (``rb`` = d^1/2; one FFMA) and p = 2^(x sc - m sc).
// ``bias``: the tile takes its key biases, ``bv`` this thread's
// (sweep_bias). Keys from kvend on score -inf.
template <int BN, bool RAW>
__device__ __forceinline__ float2 sweep_softmax(float (&s)[BN / 8][4], int kv0, int kvend,
                                                bool bias, const float (&bv)[BN / 4], float sc,
                                                float rb, float (&m)[2], float (&ls)[2]) {
  const int t = threadIdx.x & 3;
  const bool ragged = kv0 + BN > kvend;
  float e;  // the scale of the FFMA that subtracts the max
  if constexpr (SW_FOLD) {
    if (bias) {
      const float r = sc * LN2;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int j = nt * 8 + t * 2;
        const float b0 = bv[2 * nt], b1 = bv[2 * nt + 1];
        if constexpr (RAW) {
          s[nt][0] = fmaf(b0, rb, s[nt][0]);
          s[nt][1] = fmaf(b1, rb, s[nt][1]);
          s[nt][2] = fmaf(b0, rb, s[nt][2]);
          s[nt][3] = fmaf(b1, rb, s[nt][3]);
        } else {
          s[nt][0] = fmaf(s[nt][0], r, b0);
          s[nt][1] = fmaf(s[nt][1], r, b1);
          s[nt][2] = fmaf(s[nt][2], r, b0);
          s[nt][3] = fmaf(s[nt][3], r, b1);
        }
        if (ragged) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (kv0 + j + (i & 1) >= kvend) s[nt][i] = -INFINITY;
        }
      }
      e = RAW ? sc : LOG2E;
    } else {
      if (ragged) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (kv0 + nt * 8 + t * 2 + (i & 1) >= kvend) s[nt][i] = -INFINITY;
      }
      e = sc;
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = nt * 8 + t * 2 + (i & 1);
        s[nt][i] *= sc;
        if (bias || ragged)
          s[nt][i] = kv0 + j >= kvend ? -INFINITY
                                      : (bias ? fmaf(bv[2 * nt + (i & 1)], LOG2E, s[nt][i])
                                              : s[nt][i]);
      }
    e = 1.f;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float m0 = fmaxf(m[0], mx0), m1 = fmaxf(m[1], mx1);
  // a row with nothing finite yet keeps a zero shift (no inf - inf)
  const float base0 = m0 == -INFINITY ? 0.f : m0, base1 = m1 == -INFINITY ? 0.f : m1;
  const float2 alpha = make_float2(exp2_ftz((m[0] - base0) * e), exp2_ftz((m[1] - base1) * e));
  m[0] = m0;
  m[1] = m1;
  const float nb0 = -base0 * e, nb1 = -base1 * e;
  ls[0] = ls[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    s[nt][0] = exp2_ftz(fmaf(s[nt][0], e, nb0));
    s[nt][1] = exp2_ftz(fmaf(s[nt][1], e, nb0));
    s[nt][2] = exp2_ftz(fmaf(s[nt][2], e, nb1));
    s[nt][3] = exp2_ftz(fmaf(s[nt][3], e, nb1));
    ls[0] += s[nt][0] + s[nt][1];
    ls[1] += s[nt][2] + s[nt][3];
  }
  return alpha;
}

// Grid (ceil(Sq / BQ), H / HB, B). qmap: raw q (boxes of BQ rows); kmap,
// vmap: BN rows; bmap: the flat key bias (boxes of BN), read only with a
// bias: on every kv tile (T1), or with LAST (T2's "last") on the last tile
// only. rb = d^1/2 (sweep_softmax's RAW). Warpgroup w's chain c: head h0 +
// c / RB, rows 128 (c % RB) + 64 w of the block's BQ.
template <int BQ, int BN, int HB, bool LAST>
__global__ void __launch_bounds__(SweepGeom<BQ, BN, HB>::NT, 1) sweep_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap bmap, float rb) {
  using G = SweepGeom<BQ, BN, HB>;
  constexpr int C = G::CHAINS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* slots = Qs + HB * G::QHEAD;
  float* kbias = reinterpret_cast<float*>(slots + G::SLOTS * G::SLOT);  // [slot][BIAS / 4]
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + G::SLOTS * (G::SLOT + G::BIAS));
  uint64_t* qbar = full + 2 * G::SLOTS;
  const int q0 = blockIdx.x * BQ, h0 = blockIdx.y * HB, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int nt = (skv + BN - 1) / BN;
  const bool biased = a.bias != nullptr;
  // kv tile n takes its key biases (every tile, or with LAST the last one)
  auto tile_biased = [&](int n) { return biased && (!LAST || n == nt - 1); };
  constexpr int BSTRIDE = G::BIAS / 4;  // floats between two slots' key biases
  const int bias0 = b * skv % 4;  // the row's first bias in a box that starts 16-byte aligned
  // step n: kv tile n, the K and V tiles of the block's HB heads
  StepRing<G::SLOTS> ring{full, full + G::SLOTS, 0, nt};
  auto load = [&](int n, int slot) {
    unsigned char* dst = slots + slot * G::SLOT;
    const bool nb = tile_biased(n);  // the bias box counted only where it is loaded
    mbar_expect_tx(ring.full + slot, G::SLOT + (nb ? G::BIASN * 4 : 0));
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      tma_load_4d(dst + hh * 2 * G::KV, &kmap, ring.full + slot, 0, n * BN, h0 + hh, b);
      tma_load_4d(dst + hh * 2 * G::KV + G::KV, &vmap, ring.full + slot, 0, n * BN, h0 + hh, b);
    }
    // keys past Skv read the next row's biases (or zeros): the softmax masks them
    if (nb) tma_load_1d(kbias + slot * BSTRIDE, &bmap, ring.full + slot, b * skv + n * BN - bias0);
  };
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, HB * G::QHEAD);
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) tma_load_4d(Qs + hh * G::QHEAD, &qmap, qbar, 0, q0, h0 + hh, b);
  }
  __syncthreads();  // the mbarriers' initialization
  if (!SW_PRODUCER && threadIdx.x == SW_LOADER) ring.fill(-1, load);

  const int warp = threadIdx.x >> 5, wg = warp >> 2;
  if constexpr (SW_PRODUCER) {
    if (wg == 2) {  // the producer: every load, in step order
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
      if (threadIdx.x == SW_NT) ring.fill(ring.total, load);
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  }
  const float sc = static_cast<float>(a.qscale);
  // chain c's 64 rows in the q tile, and its head's K tile of step n (V: + KV)
  auto qrows = [&](int c) {
    return q_desc(Qs + (c / G::RB) * G::QHEAD + ((c % G::RB) * 128 + wg * 64) * 128);
  };
  auto kslot = [&](int n, int c) {
    return slots + (n % G::SLOTS) * G::SLOT + (c / G::RB) * 2 * G::KV;
  };
  AccT<64> acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) init_acc(acc[c]);
  float s[BN / 8][4];
  uint32_t pa[BN / 16][4];  // bf16 p of the last softmax: the A operand of its p.v
  float bv[BN / 4];         // this thread's key biases of the tile whose scores are in flight
  // the tile's biases into bv, while its scores are in flight
  auto biases = [&](int t) {
    if (tile_biased(t)) sweep_bias<BN>(bv, kbias + (t % G::SLOTS) * BSTRIDE + bias0);
  };
  auto step_wait = [&](int n) {
    if (!SW_PRODUCER && !G::REFILL_AFTER_RELEASE && threadIdx.x == SW_LOADER) ring.fill(n, load);
    ring.wait(n);
  };
  // tile t - 1 released by this thread's warp: its slot takes tile t - 1 + SLOTS
  auto refill = [&](int t) {
    if (!SW_PRODUCER && G::REFILL_AFTER_RELEASE && threadIdx.x == SW_LOADER)
      ring.fill(t - 1 + G::SLOTS, load);
  };
  // chain c's softmax of tile t (its row sums updated); returns its alpha
  auto softmax = [&](int c, int t) {
    float ls[2];
    const float2 alpha =
        sweep_softmax<BN, LAST>(s, t * BN, skv, tile_biased(t), bv, sc, rb, acc[c].m, ls);
    acc[c].l[0] = acc[c].l[0] * alpha.x + ls[0];
    acc[c].l[1] = acc[c].l[1] * alpha.y + ls[1];
    return alpha;
  };
  // tile 0: chain 0's scores alone
  step_wait(0);
  mbar_wait(qbar, 0);
  zero_tile(s);
  pin_regs(s);
  wgmma_fence();
  sweep_scores<BN>(s, qrows(0), kslot(0, 0));
  wgmma_commit();
  biases(0);
  wgmma_wait<0>();
  pin_regs(s);
  rescale(acc[0], softmax(0, 0));
  pack_p<BN>(pa, s);
  if constexpr (C == 1) {
    // tile t's scores with tile t - 1's p.v, which runs under tile t's softmax
    for (int t = 1; t < nt; ++t) {
      step_wait(t);
      pin_regs(s);
      pin_regs(acc[0].o);
      pin_regs(pa);
      wgmma_fence();
      sweep_scores<BN>(s, qrows(0), kslot(t, 0));
      wgmma_commit();
      sweep_pv<BN>(acc[0].o, pa, kslot(t - 1, 0) + G::KV);
      wgmma_commit();
      biases(t);
      wgmma_wait<1>();  // the scores
      pin_regs(s);
      const float2 alpha = softmax(0, t);
      wgmma_wait<0>();
      pin_regs(acc[0].o);
      pin_regs(pa);
      ring.release(t - 1);
      refill(t);
      rescale(acc[0], alpha);
      pack_p<BN>(pa, s);
    }
  } else {
    // chain cs's scores of tile ts with the p.v of the p in registers (chain
    // cp's, tile tp); the scores are waited for, the p.v left running
    auto turn = [&](int cs, int ts, int cp, int tp) {
      pin_regs(s);
      pin_regs(acc[cp].o);
      pin_regs(pa);
      wgmma_fence();
      sweep_scores<BN>(s, qrows(cs), kslot(ts, cs));
      wgmma_commit();
      sweep_pv<BN>(acc[cp].o, pa, kslot(tp, cp) + G::KV);
      wgmma_commit();
      biases(ts);
      wgmma_wait<1>();  // the scores
      pin_regs(s);
    };
    // the p.v issued by the last turn, then p repacked from s
    auto repack = [&](int cp) {
      wgmma_wait<0>();
      pin_regs(acc[cp].o);
      pin_regs(pa);
      pack_p<BN>(pa, s);
    };
    // chain 0's softmax rescales an accumulator whose p.v is done (the last
    // repack waited for it) while chain 1's p.v runs, and the other way round
    turn(1, 0, 0, 0);
    rescale(acc[1], softmax(1, 0));
    repack(0);
    for (int t = 1; t < nt; ++t) {
      step_wait(t);
      turn(0, t, 1, t - 1);
      rescale(acc[0], softmax(0, t));
      repack(1);
      ring.release(t - 1);
      refill(t);
      turn(1, t, 0, t);
      rescale(acc[1], softmax(1, t));
      repack(0);
    }
  }
  // the last p.v: the last chain's of the last tile
  pin_regs(acc[C - 1].o);
  pin_regs(pa);
  wgmma_fence();
  sweep_pv<BN>(acc[C - 1].o, pa, kslot(nt - 1, C - 1) + G::KV);
  wgmma_commit();
  wgmma_wait<0>();
  pin_regs(acc[C - 1].o);
  pin_regs(pa);
  ring.release(nt - 1);
#pragma unroll
  for (int c = 0; c < C; ++c)
    store_out(acc[c],
              static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + (h0 + c / G::RB) * a.o_sh,
              a.o_ss, q0 + (c % G::RB) * 128, sq, nullptr);
}

// The 1-D tensor map of the flat f32 key bias ([B * Skv]): boxes of ``box``
// elements (from a multiple of 4: TMA's 16 bytes); past the end read as zeros.
cudaError_t bias_map(CUtensorMap* map, const void* bias, long long n, int box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};  // (rank 1: not read)
  const cuuint32_t boxdim[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(bias), dims,
                            strides, boxdim, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// T1 on [B, H, S, 64] operands by their strides, at (BQ, BN, HB); with
// LAST (T2's "last") the key bias on the last kv tile only.
template <int BQ, int BN, int HB, bool LAST>
int launch_sweep(const TGAttnArgs* a, cudaStream_t s) {
  using G = SweepGeom<BQ, BN, HB>;
  if (a->sq <= 0 || a->skv <= 0 || a->h % HB) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap, bmap = {};
  cudaError_t err =
      kv_tensor_map<D>(&qmap, a->q, a->sq, a->h, a->b, a->q_ss, a->q_sh, a->q_sb, BQ);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&kmap, a->k, a->skv, a->h, a->b, a->k_ss, a->k_sh, a->k_sb, BN);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&vmap, a->v, a->skv, a->h, a->b, a->v_ss, a->v_sh, a->v_sb, BN);
  if (err == cudaSuccess && a->bias != nullptr)
    err = bias_map(&bmap, a->bias, a->b * a->skv, G::BIASN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_kernel<BQ, BN, HB, LAST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a->sq + BQ - 1) / BQ), static_cast<unsigned>(a->h / HB),
                  static_cast<unsigned>(a->b));
  const float rb = static_cast<float>(LOG2E_D / a->qscale);  // d^1/2: qscale is d^-1/2 log2 e
  sweep_kernel<BQ, BN, HB, LAST><<<grid, G::NT, G::SMEM, s>>>(*a, qmap, kmap, vmap, bmap, rb);
  return static_cast<int>(cudaGetLastError());
}

// T1's build at (BQ, BN, HB): threads, dynamic shared memory (bytes), K / V
// slots, block_q, block_kv, hblk, chains a warpgroup, resident blocks a SM.
template <int BQ, int BN, int HB>
int sweep_geometry(long long* out) {
  using G = SweepGeom<BQ, BN, HB>;
  cudaError_t err = cudaFuncSetAttribute(sweep_kernel<BQ, BN, HB, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sweep_kernel<BQ, BN, HB, false>,
                                                        G::NT, G::SMEM);
  const long long g[8] = {G::NT, G::SMEM, G::SLOTS, BQ, BN, HB, G::CHAINS, blocks};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// T4a and T4b
// ---------------------------------------------------------------------------

constexpr int PI_MAX_KEYS = 4 * MF_BN;  // keys held whole: four K' / V tiles (128 KB)
constexpr int PI_SLOTS = 2;             // q boxes a warpgroup
constexpr uint32_t PI_BOX = 64 * 128;   // 64 rows of one head (8 KB)
// true: K1's prologue pass writes q' into a workspace first; false: each
// chunk of raw q prologued in place from the tables in global memory
constexpr bool PI_PROLOGUE_PASS = true;
// T4b: true: the splits' partial sums added by TMA reduce-add into one
// zeroed accumulator; false: each split's stored apart, then summed by the
// last pass
constexpr bool SK_REDUCE = true;
// T4b: true: at 256 keys a split, blocks of one warpgroup, two resident a
// SM (one's K' / V load under the other's products; 0.472-0.474 ms at the
// script's shape against 0.518-0.520 at one block of two warpgroups, and
// 0.488-0.489 at 512 keys a split, H100 80GB HBM3 at 700 W,
// tools/kernel_ablations.py); false: two
// warpgroups a block at every split, one block a SM
constexpr bool SK_TWO_BLOCKS = true;

// a warpgroup's output staging: T4a's bf16 box; T4b's f32 acc (two boxes of
// 32 columns) and its row sums (a box of 64, padded to the boxes' 1 KB)
__host__ __device__ constexpr uint32_t resident_stage_bytes(bool partial) {
  return partial ? 2 * PI_BOX + 1024 : PI_BOX;
}

// dynamic shared memory of the resident body for nt K' / V tiles and wg
// warpgroups: alignment slack, the tiles, each warpgroup's q slots and its
// output staging, the tiles' mbarriers and the q slots'
__host__ __device__ constexpr int resident_smem_bytes(int nt, int wg, bool partial) {
  return static_cast<int>(1024 + nt * MF_SLOT + wg * (PI_SLOTS * PI_BOX + resident_stage_bytes(partial))) +
         8 * (4 + wg * PI_SLOTS);
}

__host__ __device__ constexpr int pairinner_smem_bytes(int nt) {
  return resident_smem_bytes(nt, 2, false);
}

// T4b's warpgroups a block at ``split`` keys a split
__host__ __device__ constexpr int splitkv_warpgroups(long long split) {
  return SK_TWO_BLOCKS && split <= 2 * MF_BN ? 1 : 2;
}

// one box of shared memory into (REDUCE: added, f32) the tensor of a 3-D
// ``map`` at (c0, c1, c2), in the issuing thread's bulk async-group
template <bool REDUCE>
__device__ __forceinline__ void tma_out_3d(const CUtensorMap* map, const void* src, int c0, int c1,
                                           int c2) {
  if constexpr (REDUCE)
    asm volatile(
        "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
        " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// as tma_out_3d, a 2-D map at (c0, c1)
template <bool REDUCE>
__device__ __forceinline__ void tma_out_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  if constexpr (REDUCE)
    asm volatile(
        "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group"
        " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(src)), "r"(c0), "r"(c1)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(src)), "r"(c0), "r"(c1)
        : "memory");
}

// The prologue of 64 raw q rows of one head in place (the warpgroup's 128
// threads; ``Qw``: the rows in the 128-byte swizzle, q row row0 + r at r),
// as prologue_q_rows with the table rows read from global memory (``cosg``,
// ``sin``, ``add`` at the batch row: [S][64] f32). Rows past sq give zeros.
__device__ __forceinline__ void prologue_q_global(unsigned char* Qw, const float* cosg,
                                                  const float* sin, const float* add, int row0,
                                                  int sq, const float (&rc)[8], bool norm,
                                                  float eps, float scale) {
  const int tid = threadIdx.x & 127, j = tid & 7, c0 = j * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 3) + 16 * i, row = row0 + r;
    float cg[8], sn[8], ad[8];
    if (row < sq) {
      const long long off = (long long)row * 64 + c0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 c4 = __ldg(reinterpret_cast<const float4*>(cosg + off) + e);
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(sin + off) + e);
        const float4 a4 = __ldg(reinterpret_cast<const float4*>(add + off) + e);
        cg[4 * e] = c4.x; cg[4 * e + 1] = c4.y; cg[4 * e + 2] = c4.z; cg[4 * e + 3] = c4.w;
        sn[4 * e] = s4.x; sn[4 * e + 1] = s4.y; sn[4 * e + 2] = s4.z; sn[4 * e + 3] = s4.w;
        ad[4 * e] = a4.x; ad[4 * e + 1] = a4.y; ad[4 * e + 2] = a4.z; ad[4 * e + 3] = a4.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) cg[e] = sn[e] = ad[e] = 0.f;
    }
    uint4* cell = reinterpret_cast<uint4*>(Qw + r * 128 + ((j ^ (r & 7)) << 4));
    const uint4 raw = *cell;
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float x[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
    if (norm) {  // every lane of the warp: its 8-lane rows' shuffles
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += x[e];
      const float mu = row_sum<8>(sum) * (1.f / 64);
      float vs = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] -= mu;
        vs += x[e] * x[e];
      }
      const float inv = rsqrtf(row_sum<8>(vs) * (1.f / 64) + eps);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] *= inv;
    }
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = (x[e] * cg[e] + x[e ^ 1] * rc[e] * sn[e] + ad[e]) * scale;
    *cell = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                       pack_bf16(y[6], y[7]));
  }
}

// The resident body that T4a and T4b share: head h of batch row b, the keys
// [kv0, kv0 + nkeys) (nkeys <= PI_MAX_KEYS) held whole in shared memory
// (TMA, one mbarrier a 128-key tile; keys past Skv masked), against the q
// rows [r0, r0 + rows) in chunks of 64, warpgroup w of WG taking chunks w,
// w + WG, ... . qmap: raw q (or q', PI_PROLOGUE_PASS) or, with PARTIAL,
// q' (boxes of 64 rows); kmap: k' (MF_BN rows), vmap; c = MF_PK - C.
// Without PARTIAL (T4a) each chunk's output, normalized, goes out by TMA
// through ``omap`` (4-D, boxes of 64 rows); with PARTIAL (T4b) its f32 acc
// by ``omap`` (3-D: 64 columns, Sq rows, accumulator rows; boxes of 32 x 64
// in the 128-byte swizzle) and its row sums by ``lmap`` (2-D: Sq, accumulator
// rows; boxes of 64), both into accumulator row ``obh``: added (SK_REDUCE)
// or stored.
template <int WG, bool PARTIAL>
__device__ __forceinline__ void resident_body(const TGAttnArgs& a, const CUtensorMap* qmap,
                                              const CUtensorMap* kmap, const CUtensorMap* vmap,
                                              const CUtensorMap* omap, const CUtensorMap* lmap,
                                              int h, int b, int r0, int rows, int kv0, int nkeys,
                                              int obh, float c) {
  constexpr uint32_t STAGE = resident_stage_bytes(PARTIAL);
  constexpr bool IN_PLACE = !PARTIAL && !PI_PROLOGUE_PASS;  // q's prologue on each chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int nt = (nkeys + MF_BN - 1) / MF_BN;
  unsigned char* kv = align1024(smem_raw);  // tile t: K' at t * MF_SLOT, V MF_KV on
  unsigned char* Qs = kv + nt * MF_SLOT;
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(Qs + WG * (PI_SLOTS * PI_BOX + STAGE));  // [tile]
  uint64_t* qfull = kvbar + 4;  // [warpgroup][slot]
  const int warp = threadIdx.x >> 5, wg = warp >> 2, wtid = threadIdx.x & 127;
  // each warpgroup's chunks, wg, wg + WG, ...: as many for each (a chunk
  // count that depends on the warpgroup would put every wgmma on a
  // divergent path); a last chunk may lie past the rows (zeros in,
  // nothing stored past Sq)
  const int count = ((rows + 63) / 64 + WG - 1) / WG;
  auto chunk_row = [&](int k) { return r0 + (WG * k + wg) * 64; };
  unsigned char* Qw = Qs + wg * (PI_SLOTS * PI_BOX + STAGE);  // this warpgroup's q slots
  unsigned char* St = Qw + PI_SLOTS * PI_BOX;                 // and its output staging
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 4 + WG * PI_SLOTS; ++i) mbar_init(kvbar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < nt; ++t) {
      mbar_expect_tx(kvbar + t, MF_SLOT);
      tma_load_4d(kv + t * MF_SLOT, kmap, kvbar + t, 0, kv0 + t * MF_BN, h, b);
      tma_load_4d(kv + t * MF_SLOT + MF_KV, vmap, kvbar + t, 0, kv0 + t * MF_BN, h, b);
    }
  }
  __syncthreads();  // the mbarriers' initialization
  // (the warpgroup's first thread) chunk k's q rows into slot k % PI_SLOTS
  auto load_q = [&](int k) {
    uint64_t* bar = qfull + wg * PI_SLOTS + k % PI_SLOTS;
    mbar_expect_tx(bar, PI_BOX);
    tma_load_4d(Qw + (k % PI_SLOTS) * PI_BOX, qmap, bar, 0, chunk_row(k), h, b);
  };
  if (wtid == 0)
    for (int k = 0; k < min(PI_SLOTS, count); ++k) load_q(k);
  float rc[8];  // this thread's rot coefficients (columns 8 (wtid & 7) on of every row)
#pragma unroll
  for (int e = 0; e < 8; ++e)
    rc[e] = IN_PLACE ? __ldg(static_cast<const float*>(a.q_rot) + (wtid & 7) * 8 + e) : 0.f;
  const long long toff = (long long)b * a.q_tb;
  const float* cosg = static_cast<const float*>(a.q_cos) + toff;
  const float* sinq = static_cast<const float*>(a.q_sin) + toff;
  const float* addq = static_cast<const float*>(a.q_add) + toff;
  const float eps = static_cast<float>(a.eps), qscale = static_cast<float>(a.qscale);
  // chunk k's q rows in place and visible to the tensor cores; past the
  // warpgroup's barrier every thread is done with chunk k - 1's slot
  auto prologue = [&](int k) {
    unsigned char* Qk = Qw + (k % PI_SLOTS) * PI_BOX;
    mbar_wait(qfull + wg * PI_SLOTS + k % PI_SLOTS, (k / PI_SLOTS) & 1);
    if constexpr (IN_PLACE) {
      prologue_q_global(Qk, cosg, sinq, addq, chunk_row(k), sq, rc, a.norm_q != 0, eps, qscale);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    wg_sync(wg);
  };
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  float acc[8][4], l[2];
  float s[MF_BN / 8][4];
  uint32_t pa[MF_BN / 16][4];  // bf16 p of the last softmax: the A operand of its p.v
  zero_tile(s);
  zero_tile(acc);  // defined before the loop's first wgmma (its first p.v overwrites it)
  l[0] = l[1] = 0.f;
  // chunk k's output into the staging (once its last TMA has read it), then
  // by TMA: T4a acc / l in bf16, T4b acc and l in f32
  auto store = [&](int k) {
    if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    wg_sync(wg);
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int r = (warp & 3) * 16 + g;  // this thread's rows r and r + 8 of the chunk's 64
    if constexpr (PARTIAL) {
      // column 8 dt + 2 t4 in box dt / 4, its 16-byte chunk swizzled by the row (r & 7 = g)
      unsigned char* row = St + r * 128 + (t4 & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        unsigned char* cell = row + (dt >> 2) * PI_BOX + ((((dt & 3) * 2 + (t4 >> 1)) ^ g) << 4);
        *reinterpret_cast<float2*>(cell) = make_float2(acc[dt][0], acc[dt][1]);
        *reinterpret_cast<float2*>(cell + 8 * 128) = make_float2(acc[dt][2], acc[dt][3]);
      }
      float* Ls = reinterpret_cast<float*>(St + 2 * PI_BOX);
      const float l0 = row_sum<4>(l[0]), l1 = row_sum<4>(l[1]);
      if (t4 == 0) {
        Ls[r] = l0;
        Ls[r + 8] = l1;
      }
    } else {
      const float i0 = 1.f / fmaxf(row_sum<4>(l[0]), MF_LMIN);
      const float i1 = 1.f / fmaxf(row_sum<4>(l[1]), MF_LMIN);
      unsigned char* row = St + r * 128 + t4 * 4;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        unsigned char* cell = row + ((dt ^ g) << 4);
        *reinterpret_cast<uint32_t*>(cell) = pack_bf16(acc[dt][0] * i0, acc[dt][1] * i0);
        *reinterpret_cast<uint32_t*>(cell + 8 * 128) = pack_bf16(acc[dt][2] * i1, acc[dt][3] * i1);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(wg);
    if (wtid == 0) {
      if constexpr (PARTIAL) {
        tma_out_3d<SK_REDUCE>(omap, St, 0, chunk_row(k), obh);
        tma_out_3d<SK_REDUCE>(omap, St + PI_BOX, 32, chunk_row(k), obh);
        tma_out_2d<SK_REDUCE>(lmap, St + 2 * PI_BOX, chunk_row(k), obh);
      } else {
        tma_store_4d(omap, St, 0, chunk_row(k), h, b);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  };
  prologue(0);
  // step n: chunk n / nt, resident tile n % nt
  const int steps = count * nt;
  for (int n = 0; n < steps; ++n) {
    const int k = n / nt, t = n % nt;
    if (k == 0) mbar_wait(kvbar + t, 0);
    // this step's scores, with the last step's p.v
    pin_regs(s);
    pin_regs(acc);
    pin_regs(pa);
    wgmma_fence();
    issue_scores_ss<64>(s, q_desc(Qw + (k % PI_SLOTS) * PI_BOX), kv + t * MF_SLOT);
    wgmma_commit();
    if (n > 0) {  // a chunk's first p.v starts its accumulator
      const unsigned char* Vs = kv + ((n - 1) % nt) * MF_SLOT + MF_KV;
      if ((n - 1) % nt == 0)
        issue_pv_new(acc, pa, Vs);
      else
        issue_pv<64>(acc, pa, Vs);
      wgmma_commit();
    }
    if (n > 0)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    pin_regs(s);
    float ls[2];
    const int kt = kv0 + t * MF_BN;
    if (bias != nullptr || kt + MF_BN > skv)
      maxfree_tile<true>(s, kt, skv, bias, c, ls);
    else
      maxfree_tile<false>(s, kt, skv, nullptr, c, ls);
    if (n > 0) {
      wgmma_wait<0>();
      pin_regs(acc);
      pin_regs(pa);
    }
    if (t == 0 && n > 0) {  // the last chunk's p.v are all in: its output
      store(k - 1);
      l[0] = ls[0];
      l[1] = ls[1];
    } else {
      l[0] += ls[0];
      l[1] += ls[1];
    }
    pack_p<MF_BN>(pa, s);
    // this chunk's scores are done: the next chunk prologued with no wgmma
    // in flight, then this chunk's slot takes chunk k + PI_SLOTS
    if (t == nt - 1 && k + 1 < count) {
      prologue(k + 1);
      if (wtid == 0 && k + PI_SLOTS < count) load_q(k + PI_SLOTS);
    }
  }
  // the last p.v
  pin_regs(acc);
  pin_regs(pa);
  wgmma_fence();
  if ((steps - 1) % nt == 0)
    issue_pv_new(acc, pa, kv + ((steps - 1) % nt) * MF_SLOT + MF_KV);
  else
    issue_pv<64>(acc, pa, kv + ((steps - 1) % nt) * MF_SLOT + MF_KV);
  wgmma_commit();
  wgmma_wait<0>();
  pin_regs(acc);
  pin_regs(pa);
  store(count - 1);
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// T4a. Grid (H, ceil(Sq / block_q), B), block_q a multiple of 128. qmap: raw
// q (or q', PI_PROLOGUE_PASS) in boxes of 64 rows; kmap: k' (prologued by
// the wrapper), vmap (MF_BN rows); omap: the output (64 rows); c = MF_PK - C.
__global__ void __launch_bounds__(MF_NT, 1) pairinner_tma_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap omap, int block_q, float c) {
  const int r0 = blockIdx.y * block_q;
  resident_body<2, false>(a, &qmap, &kmap, &vmap, &omap, nullptr, blockIdx.x, blockIdx.z, r0,
                          min(static_cast<int>(a.sq) - r0, block_q), 0, static_cast<int>(a.skv),
                          0, c);
}

// T4b. Grid (splits, H, B): split s holds the keys [s split, (s + 1) split)
// (split a multiple of MF_BN, at most PI_MAX_KEYS), against every q' row.
// qmap: q', kmap: k' (both from the prologue pass), vmap; accmap, lmap: the
// f32 accumulator and row sums ([parts][B * H][Sq] rows: parts 1 with
// SK_REDUCE, else one a split); c = MF_PK - C.
template <int WG>
__global__ void __launch_bounds__(WG * 128, 3 - WG) splitkv_tma_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap accmap, const __grid_constant__ CUtensorMap lmap,
    int split, float c) {
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kv0 = sp * split;
  const int bh = b * static_cast<int>(a.h) + h;
  const int obh = SK_REDUCE ? bh : bh * static_cast<int>(gridDim.x) + sp;
  resident_body<WG, true>(a, &qmap, &kmap, &vmap, &accmap, &lmap, h, b, 0,
                          static_cast<int>(a.sq), kv0, min(split, static_cast<int>(a.skv) - kv0),
                          obh, c);
}

// T4b's row sums: rows of Sq padded to a multiple of 4 (a tensor map's row
// stride is a multiple of 16 bytes)
__host__ __device__ constexpr long long splitkv_lsum_pitch(long long sq) { return (sq + 3) / 4 * 4; }

// T4b's last pass: o = (sum of the parts' acc) / max(sum of their l,
// MF_LMIN) in bf16, ``acc`` [B * H * parts][Sq][64], ``lsum`` [B * H *
// parts][splitkv_lsum_pitch(Sq)]. Grid (ceil(Sq / 32), H, B), 8 threads a
// row, 8 columns each.
__global__ void __launch_bounds__(256) splitkv_normalize_kernel(const TGAttnArgs a, int parts,
                                                                const float* acc,
                                                                const float* lsum) {
  const int row = blockIdx.x * 32 + threadIdx.x / 8, c0 = (threadIdx.x % 8) * 8;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= a.sq) return;
  float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float l = 0.f;
  const long long bh = (long long)b * a.h + h;
  for (int part = 0; part < parts; ++part) {
    const long long r = (bh * parts + part) * a.sq + row;
    const float4* p = reinterpret_cast<const float4*>(acc + r * 64 + c0);
    const float4 x0 = p[0], x1 = p[1];
    o[0] += x0.x; o[1] += x0.y; o[2] += x0.z; o[3] += x0.w;
    o[4] += x1.x; o[5] += x1.y; o[6] += x1.z; o[7] += x1.w;
    l += lsum[(bh * parts + part) * splitkv_lsum_pitch(a.sq) + row];
  }
  l = fmaxf(l, MF_LMIN);
  const uint4 out = make_uint4(pack_bf16(o[0] / l, o[1] / l), pack_bf16(o[2] / l, o[3] / l),
                               pack_bf16(o[4] / l, o[5] / l), pack_bf16(o[6] / l, o[7] / l));
  *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh +
                            (long long)row * a.o_ss + c0) = out;
}

// T4a on raw q with its tables and prologued k (``a->k``), ``block_q`` q
// rows a block; ``ws`` takes q' (bf16 B * Sq * H * 64; unused without
// PI_PROLOGUE_PASS).
int launch_pairinner(const TGAttnArgs* a, long long block_q, float shift, void* ws,
                     cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0 || a->skv > PI_MAX_KEYS || block_q <= 0 || block_q % 128 ||
      a->q_rot == nullptr || (PI_PROLOGUE_PASS && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  TGAttnArgs p = *a;
  cudaError_t err = cudaSuccess;
  if constexpr (PI_PROLOGUE_PASS) {  // q's side of K1's prologue pass
    const long long hd = a->h * D;
    constexpr int rows = prologue_block_rows(D);
    const dim3 pgrid(static_cast<unsigned>((a->sq + rows - 1) / rows), static_cast<unsigned>(a->b));
    maxfree_prologue_kernel<<<pgrid, NTHREADS, 0, s>>>(*a, 0, static_cast<__nv_bfloat16*>(ws),
                                                       a->sq * hd);
    err = cudaGetLastError();
    p.q = ws;
    p.q_sb = a->sq * hd;
    p.q_ss = hd;
    p.q_sh = D;
    p.qscale = 1.0;  // folded into q' by its prologue
  }
  CUtensorMap qmap, kmap, vmap, omap;
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&qmap, p.q, p.sq, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, 64);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&kmap, p.k, p.skv, p.h, p.b, p.k_ss, p.k_sh, p.k_sb, MF_BN);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&vmap, p.v, p.skv, p.h, p.b, p.v_ss, p.v_sh, p.v_sb, MF_BN);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&omap, p.o, p.sq, p.h, p.b, p.o_ss, p.o_sh, p.o_sb, 64);
  const int smem = pairinner_smem_bytes(static_cast<int>((a->skv + MF_BN - 1) / MF_BN));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pairinner_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a->h),
                  static_cast<unsigned>((a->sq + block_q - 1) / block_q),
                  static_cast<unsigned>(a->b));
  pairinner_tma_kernel<<<grid, MF_NT, smem, s>>>(p, qmap, kmap, vmap, omap,
                                                 static_cast<int>(block_q), MF_PK - shift);
  return static_cast<int>(cudaGetLastError());
}

// T4a's build for ``skv`` keys: threads, dynamic shared memory (bytes), q
// slots a warpgroup, resident K' / V tiles, resident blocks a SM, and 1
// with the prologue pass (else 0).
int pairinner_geometry(long long skv, long long* out) {
  if (skv <= 0 || skv > PI_MAX_KEYS) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = static_cast<int>((skv + MF_BN - 1) / MF_BN);
  const int smem = pairinner_smem_bytes(nt);
  cudaError_t err =
      cudaFuncSetAttribute(pairinner_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pairinner_tma_kernel, MF_NT, smem);
  const long long g[6] = {MF_NT, smem, PI_SLOTS, nt, blocks, PI_PROLOGUE_PASS ? 1 : 0};
  for (int i = 0; i < 6; ++i) out[i] = g[i];
  return static_cast<int>(err);
}

// The 3-D f32 tensor map of T4b's accumulator [rows][Sq][64]: boxes of 32
// columns x 64 rows in the 128-byte swizzle; or, with ``sums``, the 2-D map
// of its row sums [rows][Sq] (rows splitkv_lsum_pitch(Sq) apart), boxes of
// 64. Rows past Sq are clipped.
cudaError_t acc_map(CUtensorMap* map, void* base, long long sq, long long rows, bool sums) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {sums ? static_cast<cuuint64_t>(sq) : 64,
                              sums ? static_cast<cuuint64_t>(rows) : static_cast<cuuint64_t>(sq),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {sums ? static_cast<cuuint64_t>(splitkv_lsum_pitch(sq)) * 4 : 64 * 4,
                                 static_cast<cuuint64_t>(sq) * 64 * 4};
  const cuuint32_t box[3] = {sums ? 64u : 32u, sums ? 1u : 64u, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sums ? 2 : 3, base, dims, strides,
                            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            sums ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// T4b's bytes of the bf16 prologue rows at the head of its workspace
// (B * (Skv + Sq) * H * 64), rounded up to 256: the accumulator follows
__host__ __device__ constexpr long long splitkv_pro_bytes(long long b, long long sq, long long skv,
                                                          long long h) {
  return (b * (sq + skv) * h * D * 2 + 255) / 256 * 256;
}

// T4b at ``split`` keys a split: the prologue passes of k and q into the
// head of ``ws``, then the body at WG warpgroups a block, its f32 partials
// into the accumulator that follows (zeroed here with SK_REDUCE; [parts][B
// * H][Sq][64], then the row sums [parts][B * H][splitkv_lsum_pitch(Sq)]),
// then the last pass.
template <int WG>
int launch_splitkv_wg(const TGAttnArgs* a, long long split, float shift, void* ws,
                      cudaStream_t s) {
  const long long splits = (a->skv + split - 1) / split;
  const long long parts = SK_REDUCE ? 1 : splits;
  const long long rows = a->b * a->h * parts;
  TGAttnArgs p;
  cudaError_t err = prologue_passes<D>(maxfree_prologue_kernel, a, ws, s, &p);
  float* acc = reinterpret_cast<float*>(static_cast<unsigned char*>(ws) +
                                        splitkv_pro_bytes(a->b, a->sq, a->skv, a->h));
  float* lsum = acc + rows * a->sq * 64;
  if (err == cudaSuccess && SK_REDUCE)
    err = cudaMemsetAsync(
        acc, 0, static_cast<size_t>(rows * (a->sq * 64 + splitkv_lsum_pitch(a->sq))) * sizeof(float),
        s);
  CUtensorMap qmap, kmap, vmap, accmap, lmap;
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&qmap, p.q, p.sq, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, 64);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&kmap, p.k, p.skv, p.h, p.b, p.k_ss, p.k_sh, p.k_sb, MF_BN);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&vmap, p.v, p.skv, p.h, p.b, p.v_ss, p.v_sh, p.v_sb, MF_BN);
  if (err == cudaSuccess) err = acc_map(&accmap, acc, a->sq, rows, false);
  if (err == cudaSuccess) err = acc_map(&lmap, lsum, a->sq, rows, true);
  const int nt = static_cast<int>((split + MF_BN - 1) / MF_BN);
  const int smem = resident_smem_bytes(nt, WG, true);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(splitkv_tma_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(a->h),
                  static_cast<unsigned>(a->b));
  splitkv_tma_kernel<WG><<<grid, WG * 128, smem, s>>>(p, qmap, kmap, vmap, accmap, lmap,
                                                       static_cast<int>(split), MF_PK - shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 ngrid(static_cast<unsigned>((a->sq + 31) / 32), static_cast<unsigned>(a->h),
                   static_cast<unsigned>(a->b));
  splitkv_normalize_kernel<<<ngrid, 256, 0, s>>>(*a, static_cast<int>(parts), acc, lsum);
  return static_cast<int>(cudaGetLastError());
}

// T4b on raw q and k with their tables; ``ws`` holds splitkv_pro_bytes,
// then B * H * parts * (Sq * 64 + splitkv_lsum_pitch(Sq)) floats.
int launch_splitkv(const TGAttnArgs* a, long long split, float shift, void* ws, cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0 || split < MF_BN || split > PI_MAX_KEYS || split % MF_BN ||
      ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (SK_TWO_BLOCKS)
    if (splitkv_warpgroups(split) == 1) return launch_splitkv_wg<1>(a, split, shift, ws, s);
  return launch_splitkv_wg<2>(a, split, shift, ws, s);
}

// T4b's build at ``split`` keys a split: threads, dynamic shared memory
// (bytes), resident K' / V tiles, q slots a warpgroup, resident blocks a SM,
// warpgroups a block, and 1 where the splits' partials are reduce-added into
// one accumulator (else 0: one a split).
template <int WG>
int splitkv_geometry_wg(long long split, long long* out) {
  const int nt = static_cast<int>((split + MF_BN - 1) / MF_BN);
  const int smem = resident_smem_bytes(nt, WG, true);
  cudaError_t err = cudaFuncSetAttribute(splitkv_tma_kernel<WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, splitkv_tma_kernel<WG>, WG * 128,
                                                        smem);
  const long long g[7] = {WG * 128, smem, nt, PI_SLOTS, blocks, WG, SK_REDUCE ? 1 : 0};
  for (int i = 0; i < 7; ++i) out[i] = g[i];
  return static_cast<int>(err);
}

int splitkv_geometry(long long split, long long* out) {
  if (split < MF_BN || split > PI_MAX_KEYS || split % MF_BN)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (SK_TWO_BLOCKS)
    if (splitkv_warpgroups(split) == 1) return splitkv_geometry_wg<1>(split, out);
  return splitkv_geometry_wg<2>(split, out);
}

}  // namespace
