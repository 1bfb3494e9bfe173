// The Hopper bodies of three max-free probes of probes.cu: T3a
// (tg_probe_attn_splitpv, the split-p.v joint attention), T3b
// (tg_probe_attn_pair2, the pair2 joint attention) and T5
// (tg_probe_cross_pairloop, the pair-loop small-kv cross attention). Each
// computes what probes.cu's other max-free probes compute (see its round-3
// comment): per head, s = q'.k' + key bias * log2 e - C (log2 domain, C the
// wrapper's static score shift), p = exp2(min(s, 0)), l = sum p, out =
// (bf16(p) . v) / max(l, FLT_MIN); the ragged last kv tile is masked and
// rows past Sq are not stored. Only probes.cu includes this header.
//
// Common to all three (flash_splitkv.cuh's and flash_ws.cuh's primitives):
// * K / V tiles of MF_BN = 128 keys come by TMA (4-D tensor maps, rows past
//   the tensor read as zeros) into 128-byte swizzled boxes, through a ring of
//   slots that one thread fills in step order (tma_ring.cuh's StepRing): a
//   slot's "full" mbarrier completes when its bytes land, its "empty" one
//   when the 8 warps have released it after their p.v. No block barrier in
//   the kv loop.
// * Scores are wgmma SS (q' from shared memory by descriptor, K-major K),
//   p.v wgmma RS (p from registers, MN-major V): m64n128k16 and m64n64k16,
//   two shapes (two products of one shape gave wrong scores on this card).
// * The max-free softmax needs no rescale of the accumulator, so a
//   warpgroup's p.v of one step runs while it computes the next step's
//   softmax: each turn issues the next scores and the last p.v together,
//   waits for the scores, runs the softmax, then waits for the p.v.
// * Subnormal p: at the scripts' tables C sits at its cap of 120 and p
//   spans 2^-80 .. 2^-160, past f32's normal range (2^-126). ex2.approx.ftz
//   (one MUFU op) flushes results below 2^-126, so the exponential runs on
//   x + MF_PK (MF_PK folded into the per-key constant): p' = 2^MF_PK p is
//   normal down to p = 2^-158, and one FMUL by 2^-MF_PK gives p itself,
//   rounded into f32's subnormals as the plain version's exp2 rounds it;
//   its bf16 rounding (bf16 keeps subnormals down to 2^-133) is the plain
//   version's too, and the tensor cores take the subnormal bf16 p (an H100:
//   the card test with every p subnormal). Summing and multiplying p'
//   itself instead (the power of two cancels in acc / l) saves the FMUL
//   but keeps more bits than the plain version below 2^-126
//   (tools/kernel_ablations.py's mf_scaled_p).
//
// T3a, pair_splitpv_kernel<RB> (<- tools/bench_attn_r3.py
// `_packed_kernel_splitpv`): the prologue pass once per row for k and for q
// (as T3b's), then a block owns 64 RB q rows of one head pair (heads h0,
// h0 + 1) and warpgroup w owns head h0 + w. A slot of the SP_SLOTS-slot ring
// holds one 128-key tile of the pair: K and V of each head as 64-column
// boxes (64 KB), and each warpgroup reads only its head's half: the split
// p.v of the JAX kernel, whose two halves of the packed p@v are here the
// two warpgroups' own products. Each warpgroup's RB row blocks of 64 rows
// are its chains: with RB = 2 one's scores are issued with the other's
// p.v, which runs under this one's softmax (T3b's turns on one slot), and a
// slot serves 128 q rows of each head, 2x K1's bytes per product; with RB =
// 1, one chain (T5's turns), 64 rows. The q' rows of both heads come once
// by TMA. A slot is refilled once both warpgroups have released it.
//
// T3b, pair2_kernel (<- tools/bench_attn_r3.py `_packed_kernel_pair2`): the
// prologue (LayerNorm + RoPE, log2 e folded into q's) runs once per row, in
// flash_prologue.cuh's pass, for k and for q, into a bf16 workspace (K1's
// three-launch form; the JAX kernel prologues K once into scratch). Grid
// (ceil(Sq / 128), H / 4, B); a block owns 128 q rows of two head pairs
// (heads h0 .. h0 + 3) and runs two passes; in pass j its two chains are
// head h0 + j of the first pair and h0 + 2 + j of the second, the JAX
// kernel's two independent head-pair chains. Each warpgroup holds 64 rows of
// both chains (two accumulators, one score tile, one p tile): one chain's
// scores are issued with the other's p.v, which runs while this chain's
// softmax does (flash_ws.cuh's alternation of two row blocks, here two
// heads). The q' rows of all four heads (64 KB) come once by TMA; the K / V
// tiles of both chains' heads (32 KB a head and tile) stream through
// P2_SLOTS slots, in the order chain a, chain b of each tile, across the
// pass boundary. Each K / V tile serves 128 q rows.
//
// T5, pairloop_kernel (<- tools/bench_cross_pairloop.py
// `_smallkv_pairloop_kernel`): no head axis in the grid. The work is cut in
// units of (batch row, row block of PL_RB = 128 q rows, head), head fastest;
// a block owns a contiguous range of `per_block` units: full-width rows,
// their heads in order (the wrapper's plan: one wave of blocks over the
// card's SMs, or whole row blocks of block_q rows). Each warpgroup holds 64
// rows of the row block and, per unit, loads its rows' 64 columns of that
// head by TMA (raw q, one unit ahead, two buffers) and prologues them in
// shared memory with q's tables (log2 e folded, as the script's kernel does
// on its q block), the tables of its 64 rows held in shared memory (48 KB)
// and reloaded only when the row block changes. K' (prologued by the
// wrapper) and V tiles stream through one ring of PL_SLOTS slots that runs
// across unit boundaries: the next head's first tiles land while this
// head's last tile computes; one head's K' + V at 480 keys is 123 KB, so
// whole heads are not held. Each K' / V tile serves 128 q rows.
//
// Bound: the two products at the bf16 tensor-core rate.

#pragma once

#include <cfloat>

#include "flash_prologue.cuh"
#include "flash_ws.cuh"
#include "tma_ring.cuh"

namespace {

constexpr int MF_NT = 256;                           // two warpgroups
constexpr int MF_BN = 128;                           // keys a K / V tile
constexpr uint32_t MF_KV = MF_BN * 128;              // one K or V tile (16 KB)
constexpr uint32_t MF_SLOT = 2 * MF_KV;              // one head's K and V tile
constexpr float MF_PK = 32.f;                        // exp2 runs on x + MF_PK
constexpr float MF_PINV = 2.3283064365386963e-10f;   // 2^-MF_PK
constexpr float MF_LMIN = FLT_MIN;                   // the floor of a row sum

// one box of a 3-D tensor map at (c0, c1, c2), completing on ``bar``
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The max-free softmax of one tile of MF_BN keys (kv0 on) for this thread's
// two rows, in place: p = 2^(min(s + key shift + MF_PK, MF_PK)) 2^-MF_PK,
// ``c`` = MF_PK - C; keys from kvend on give 0; ``ls`` gets the rows' sums.
// MASKED: the per-key path (a key bias, or keys past kvend in the tile);
// else every key takes c.
template <bool MASKED>
__device__ __forceinline__ void maxfree_tile(float (&s)[MF_BN / 8][4], int kv0, int kvend,
                                             const float* bias, float c, float (&ls)[2]) {
  const int t = threadIdx.x & 3;
  ls[0] = ls[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < MF_BN / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = s[nt][i] + c;
      if (MASKED) {
        const int j = kv0 + nt * 8 + t * 2 + (i & 1);
        if (j >= kvend)
          x = -INFINITY;
        else if (bias != nullptr)
          x = fmaf(__ldg(bias + j), LOG2E, s[nt][i]) + c;
      }
      const float p = exp2_ftz(fminf(x, MF_PK)) * MF_PINV;
      s[nt][i] = p;
      ls[i >> 1] += p;
    }
  }
}

// o = acc / max(l, MF_LMIN) for this warp's 16 rows from q row r0w (``o``
// at (b, head), row stride os); rows past sq are not stored.
__device__ __forceinline__ void store_maxfree_rows(const float (&acc)[8][4], const float (&l)[2],
                                                   __nv_bfloat16* o, long long os, int r0w,
                                                   int sq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float i0 = 1.f / fmaxf(row_sum<4>(l[0]), MF_LMIN);
  const float i1 = 1.f / fmaxf(row_sum<4>(l[1]), MF_LMIN);
  const int r0 = r0w + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r0 * os + c) =
          __floats2bfloat162_rn(acc[dt][0] * i0, acc[dt][1] * i0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r1 * os + c) =
          __floats2bfloat162_rn(acc[dt][2] * i1, acc[dt][3] * i1);
  }
}

template <int N>
__device__ __forceinline__ void zero_tile(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
}

// o = p.v over one tile (issue_pv<64> adds to o): a new accumulator
// without writing its registers outside wgmma, which makes ptxas serialize
// every wgmma of the loop
__device__ __forceinline__ void issue_pv_new(float (&o)[8][4], const uint32_t (&pa)[MF_BN / 16][4],
                                             const unsigned char* Vs) {
  using G = TileGeom<64>;
#pragma unroll
  for (int j = 0; j < MF_BN / 16; ++j)
    wgmma_rs<64, 1>(o, pa[j], smem_desc(Vs + j * 2 * G::SBO, G::BOX, G::SBO, G::MODE), j > 0);
}

// the descriptor of 64 rows of a 128-byte-row swizzled q tile
__device__ __forceinline__ uint64_t q_desc(const unsigned char* rows) {
  return smem_desc(rows, 16, 8 * 128, 1);
}

// ---------------------------------------------------------------------------
// T3a
// ---------------------------------------------------------------------------

constexpr int SP_SLOTS = 3;                 // K / V slots (a head pair's tile each)
constexpr uint32_t SP_SLOT = 2 * MF_SLOT;   // K and V of two heads (64 KB)

// dynamic shared memory: alignment slack, the q' rows of both heads (RB
// row blocks of 64 each), the slots, their full and empty mbarriers and q's
template <int RB>
__host__ __device__ constexpr int splitpv_smem_bytes() {
  return static_cast<int>(1024 + 2 * RB * 64 * 128 + SP_SLOTS * SP_SLOT) + 8 * (2 * SP_SLOTS + 1);
}

// Grid (ceil(Sq / (64 RB)), H / 2, B); q' and k' prologued (qmap: boxes of
// 64 RB rows; kmap, vmap: MF_BN rows); c = MF_PK - C. Warpgroup w owns
// head h0 + w: its RB row blocks of 64 q rows are its chains.
template <int RB>
__global__ void __launch_bounds__(MF_NT, 1) pair_splitpv_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap, float c) {
  constexpr uint32_t QHEAD = RB * 64 * 128;  // one head's q' rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* slots = Qs + 2 * QHEAD;
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + SP_SLOTS * SP_SLOT);
  uint64_t* qbar = full + 2 * SP_SLOTS;
  const int q0 = blockIdx.x * RB * 64, h0 = 2 * blockIdx.y, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int nt = (skv + MF_BN - 1) / MF_BN;
  // step n: kv tile n, both heads' K and V (head j's at j * MF_SLOT)
  StepRing<SP_SLOTS> ring{full, full + SP_SLOTS, 0, nt};
  auto load = [&](int n, int slot) {
    unsigned char* dst = slots + slot * SP_SLOT;
    mbar_expect_tx(ring.full + slot, SP_SLOT);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tma_load_4d(dst + j * MF_SLOT, &kmap, ring.full + slot, 0, n * MF_BN, h0 + j, b);
      tma_load_4d(dst + j * MF_SLOT + MF_KV, &vmap, ring.full + slot, 0, n * MF_BN, h0 + j, b);
    }
  };
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, 2 * QHEAD);
#pragma unroll
    for (int j = 0; j < 2; ++j) tma_load_4d(Qs + j * QHEAD, &qmap, qbar, 0, q0, h0 + j, b);
    ring.fill(-1, load);
  }
  __syncthreads();  // the mbarriers' initialization

  const int warp = threadIdx.x >> 5, wg = warp >> 2;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  // this warpgroup's row block rb in the q' tile, and its head's half of step n's slot
  auto qrows = [&](int rb) { return q_desc(Qs + wg * QHEAD + rb * 64 * 128); };
  auto kv = [&](int n) { return slots + (n % SP_SLOTS) * SP_SLOT + wg * MF_SLOT; };
  float acc[RB][8][4];
  float l[RB][2];
  float s[MF_BN / 8][4];
  uint32_t pa[MF_BN / 16][4];  // bf16 p of the last softmax: the A operand of its p.v
  zero_tile(s);
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    zero_tile(acc[rb]);  // defined before the first wgmma (each chain's first p.v overwrites it)
    l[rb][0] = l[rb][1] = 0.f;
  }
  auto step_wait = [&](int n) {
    if (threadIdx.x == 0) ring.fill(n, load);
    ring.wait(n);
  };
  auto softmax = [&](int rb, int t) {
    float ls[2];
    if (bias != nullptr || (t + 1) * MF_BN > skv)
      maxfree_tile<true>(s, t * MF_BN, skv, bias, c, ls);
    else
      maxfree_tile<false>(s, t * MF_BN, skv, nullptr, c, ls);
    l[rb][0] += ls[0];
    l[rb][1] += ls[1];
  };
  // chain rp's p.v of step np (a chain's first, np = 0, starts its accumulator)
  auto issue_pv_of = [&](int rp, int np) {
    if (np == 0)
      issue_pv_new(acc[rp], pa, kv(np) + MF_KV);
    else
      issue_pv<64>(acc[rp], pa, kv(np) + MF_KV);
  };
  // chain rs's scores of step ns with the p.v of the p in registers (chain
  // rp's, step np); the scores are waited for, the p.v left running
  auto turn = [&](int rs, int ns, int rp, int np) {
    pin_regs(s);
    pin_regs(acc[rp]);
    pin_regs(pa);
    wgmma_fence();
    issue_scores_ss<64>(s, qrows(rs), kv(ns));
    wgmma_commit();
    issue_pv_of(rp, np);
    wgmma_commit();
    wgmma_wait<1>();  // the scores
    pin_regs(s);
  };
  // the p.v issued by the last turn (step np released with the last chain's), p repacked
  auto repack = [&](int rp, int np) {
    wgmma_wait<0>();
    pin_regs(acc[rp]);
    pin_regs(pa);
    if (rp == RB - 1) ring.release(np);
    pack_p<MF_BN>(pa, s);
  };
  mbar_wait(qbar, 0);
  // step 0: chain 0's scores alone, then (RB = 2) chain 1's with chain 0's p.v
  step_wait(0);
  pin_regs(s);
  wgmma_fence();
  issue_scores_ss<64>(s, qrows(0), kv(0));
  wgmma_commit();
  wgmma_wait<0>();
  pin_regs(s);
  softmax(0, 0);
  pack_p<MF_BN>(pa, s);
  if constexpr (RB == 2) {
    turn(1, 0, 0, 0);
    softmax(1, 0);
    repack(0, 0);
  }
  for (int t = 1; t < nt; ++t) {
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
  // the last p.v: the last chain's of the last step
  pin_regs(acc[RB - 1]);
  pin_regs(pa);
  wgmma_fence();
  issue_pv_of(RB - 1, nt - 1);
  wgmma_commit();
  wgmma_wait<0>();
  pin_regs(acc[RB - 1]);
  pin_regs(pa);
  ring.release(nt - 1);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + (h0 + wg) * a.o_sh;
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
    store_maxfree_rows(acc[rb], l[rb], o, a.o_ss, q0 + rb * 64 + (warp & 3) * 16, sq);
}

// ---------------------------------------------------------------------------
// T3b
// ---------------------------------------------------------------------------

constexpr int P2_BM = 128;                // q rows a block
constexpr int P2_SLOTS = 5;               // K / V slots (a head's tile each)
constexpr uint32_t P2_QBOX = P2_BM * 128;  // one head's q' rows (16 KB)

// dynamic shared memory: alignment slack, the q' rows of four heads, the
// slots, their full and empty mbarriers and q's
__host__ __device__ constexpr int pair2_smem_bytes() {
  return static_cast<int>(1024 + 4 * P2_QBOX + P2_SLOTS * MF_SLOT) + 8 * (2 * P2_SLOTS + 1);
}

// Grid (ceil(Sq / P2_BM), H / 4, B); q' and k' prologued (qmap: boxes of
// P2_BM rows; kmap, vmap: MF_BN rows); c = MF_PK - C.
__global__ void __launch_bounds__(MF_NT, 1) pair2_kernel(const TGAttnArgs a,
                                                         const __grid_constant__ CUtensorMap qmap,
                                                         const __grid_constant__ CUtensorMap kmap,
                                                         const __grid_constant__ CUtensorMap vmap,
                                                         float c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* slots = Qs + 4 * P2_QBOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + P2_SLOTS * MF_SLOT);
  uint64_t* qbar = full + 2 * P2_SLOTS;
  const int q0 = blockIdx.x * P2_BM, h0 = 4 * blockIdx.y, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int nt = (skv + MF_BN - 1) / MF_BN;
  // step n: pass n / (2 nt), tile (n / 2) % nt, chain n % 2 (head h0 + 2
  // chain + pass)
  StepRing<P2_SLOTS> ring{full, full + P2_SLOTS, 0, 4 * nt};
  auto load = [&](int n, int slot) {
    unsigned char* dst = slots + slot * MF_SLOT;
    const int h = h0 + 2 * (n & 1) + n / (2 * nt), kv0 = ((n >> 1) % nt) * MF_BN;
    mbar_expect_tx(ring.full + slot, MF_SLOT);
    tma_load_4d(dst, &kmap, ring.full + slot, 0, kv0, h, b);
    tma_load_4d(dst + MF_KV, &vmap, ring.full + slot, 0, kv0, h, b);
  };
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, 4 * P2_QBOX);
#pragma unroll
    for (int j = 0; j < 4; ++j) tma_load_4d(Qs + j * P2_QBOX, &qmap, qbar, 0, q0, h0 + j, b);
    ring.fill(-1, load);
  }
  __syncthreads();  // the mbarriers' initialization

  const int warp = threadIdx.x >> 5, wg = warp >> 2;

  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  auto slot = [&](int n) { return slots + (n % P2_SLOTS) * MF_SLOT; };
  float acc[2][8][4];  // chains a and b
  float l[2][2];
  float s[MF_BN / 8][4];
  uint32_t pa[MF_BN / 16][4];  // bf16 p of the last softmax: the A operand of its p.v
  zero_tile(s);
  auto step_wait = [&](int n) {
    if (threadIdx.x == 0) ring.fill(n, load);
    ring.wait(n);
  };
  mbar_wait(qbar, 0);
  for (int pass = 0; pass < 2; ++pass) {
    const int n0 = pass * 2 * nt;
    // this warpgroup's 64 rows of chain ch's head in the q' tile
    auto qrows = [&](int ch) { return q_desc(Qs + (2 * ch + pass) * P2_QBOX + wg * 64 * 128); };
    auto softmax = [&](int ch, int t) {
      float ls[2];
      if (bias != nullptr || (t + 1) * MF_BN > skv)
        maxfree_tile<true>(s, t * MF_BN, skv, bias, c, ls);
      else
        maxfree_tile<false>(s, t * MF_BN, skv, nullptr, c, ls);
      l[ch][0] += ls[0];
      l[ch][1] += ls[1];
    };
    // chain cs's scores of step ns with the p.v of the p in registers
    // (chain cp's, step np); the scores are waited for, the p.v left running
    auto turn = [&](int cs, int ns, int cp, int np) {
      pin_regs(s);
      pin_regs(acc[cp]);
      pin_regs(pa);
      wgmma_fence();
      issue_scores_ss<64>(s, qrows(cs), slot(ns));
      wgmma_commit();
      issue_pv<64>(acc[cp], pa, slot(np) + MF_KV);
      wgmma_commit();
      wgmma_wait<1>();  // the scores
      pin_regs(s);
    };
    // the p.v issued by the last turn (its step then released), p repacked
    auto repack = [&](int cp, int np) {
      wgmma_wait<0>();
      pin_regs(acc[cp]);
      pin_regs(pa);
      ring.release(np);
      pack_p<MF_BN>(pa, s);
    };
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      zero_tile(acc[ch]);
      l[ch][0] = l[ch][1] = 0.f;
    }
    // tile 0: chain a's scores alone, then chain b's with a's p.v
    step_wait(n0);
    pin_regs(s);
    wgmma_fence();
    issue_scores_ss<64>(s, qrows(0), slot(n0));
    wgmma_commit();
    wgmma_wait<0>();
    pin_regs(s);
    softmax(0, 0);
    pack_p<MF_BN>(pa, s);
    step_wait(n0 + 1);
    turn(1, n0 + 1, 0, n0);
    softmax(1, 0);
    repack(0, n0);
    for (int t = 1; t < nt; ++t) {
      const int na = n0 + 2 * t;
      step_wait(na);
      turn(0, na, 1, na - 1);
      softmax(0, t);
      repack(1, na - 1);
      step_wait(na + 1);
      turn(1, na + 1, 0, na);
      softmax(1, t);
      repack(0, na);
    }
    // the last p.v: chain b's of the last tile
    const int nl = n0 + 2 * nt - 1;
    pin_regs(acc[1]);
    pin_regs(pa);
    wgmma_fence();
    issue_pv<64>(acc[1], pa, slot(nl) + MF_KV);
    wgmma_commit();
    wgmma_wait<0>();
    pin_regs(acc[1]);
    pin_regs(pa);
    ring.release(nl);
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
      store_maxfree_rows(acc[ch], l[ch],
                         static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + (h0 + 2 * ch + pass) * a.o_sh,
                         a.o_ss, q0 + warp * 16, sq);
  }
}

// ---------------------------------------------------------------------------
// T5
// ---------------------------------------------------------------------------

constexpr int PL_RB = 128;                   // q rows of a row block (2 warpgroups x 64)
constexpr int PL_SLOTS = 3;                  // K' / V slots
constexpr uint32_t PL_QWG = 64 * 128;        // a warpgroup's q rows of one head (8 KB)
constexpr uint32_t PL_TAB = 64 * 64 * 4;     // one table's 64 rows (16 KB)

// dynamic shared memory: alignment slack, each warpgroup's tables (cosg,
// sin, add of its 64 rows) and two q buffers, the K' / V slots, their full
// and empty mbarriers, the q buffers' and the tables'
__host__ __device__ constexpr int pairloop_smem_bytes() {
  return static_cast<int>(1024 + 2 * 3 * PL_TAB + 2 * 2 * PL_QWG + PL_SLOTS * MF_SLOT) +
         8 * (2 * PL_SLOTS + 4 + 2);
}

// The prologue of one head's 64 q rows in place (the warpgroup's 128
// threads; ``Qw``: the raw rows in the 128-byte swizzle), as load_rows'
// arithmetic: f32 LayerNorm (with ``norm``), y = (ln0 cosg + ln0[j ^ 1]
// rot[j] sin + add) * scale, from the rows' tables ``tab`` (cosg, sin, add,
// [64][64] f32 each) and this thread's 8 rot coefficients ``rc``. Rows past
// Sq read zeros and give zeros.
__device__ __forceinline__ void prologue_q_rows(unsigned char* Qw, const float* tab,
                                                const float (&rc)[8], bool norm, float eps,
                                                float scale) {
  const int tid = threadIdx.x & 127, j = tid & 7, c0 = j * 8;
#pragma unroll 1
  for (int r = tid >> 3; r < 64; r += 16) {
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
    if (norm) {
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
    const float* tr = tab + r * 64 + c0;
    float cg[8], sn[8], ad[8];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 c4 = reinterpret_cast<const float4*>(tr)[e];
      const float4 s4 = reinterpret_cast<const float4*>(tr + 64 * 64)[e];
      const float4 a4 = reinterpret_cast<const float4*>(tr + 2 * 64 * 64)[e];
      cg[4 * e] = c4.x; cg[4 * e + 1] = c4.y; cg[4 * e + 2] = c4.z; cg[4 * e + 3] = c4.w;
      sn[4 * e] = s4.x; sn[4 * e + 1] = s4.y; sn[4 * e + 2] = s4.z; sn[4 * e + 3] = s4.w;
      ad[4 * e] = a4.x; ad[4 * e + 1] = a4.y; ad[4 * e + 2] = a4.z; ad[4 * e + 3] = a4.w;
    }
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = (x[e] * cg[e] + x[e ^ 1] * rc[e] * sn[e] + ad[e]) * scale;
    *cell = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                       pack_bf16(y[6], y[7]));
  }
}

// Grid: ceil(units / per_block) blocks, units (b, row block, head) head
// fastest. qmap: raw q (boxes of 64 rows); kmap: k' (prologued by the
// wrapper), vmap (MF_BN rows); cmap / smap / amap: q's tables (3-D:
// columns, rows, table batch rows; boxes of 64 rows); c = MF_PK - C.
__global__ void __launch_bounds__(MF_NT, 1) pairloop_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap smap,
    const __grid_constant__ CUtensorMap amap, int per_block, float c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* Qs = base + 6 * PL_TAB;
  unsigned char* slots = Qs + 4 * PL_QWG;
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + PL_SLOTS * MF_SLOT);
  uint64_t* qfull = full + 2 * PL_SLOTS;  // [warpgroup][buffer]
  uint64_t* tbar = qfull + 4;             // [warpgroup]
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int heads = static_cast<int>(a.h);
  const int nt = (skv + MF_BN - 1) / MF_BN, nrb = (sq + PL_RB - 1) / PL_RB;
  const int units = static_cast<int>(a.b) * nrb * heads;
  const int first = blockIdx.x * per_block;
  const int count = min(units, first + per_block) - first;  // units of this block
  const int warp = threadIdx.x >> 5, wg = warp >> 2, wtid = threadIdx.x & 127;
  auto unit_b = [&](int k) { return (first + k) / (nrb * heads); };
  auto unit_rb = [&](int k) { return (first + k) / heads % nrb; };
  auto unit_h = [&](int k) { return (first + k) % heads; };
  // step n: unit n / nt, kv tile n % nt
  StepRing<PL_SLOTS> ring{full, full + PL_SLOTS, 0, count * nt};
  auto load_kv = [&](int n, int slot) {
    unsigned char* dst = slots + slot * MF_SLOT;
    const int k = n / nt, kv0 = (n % nt) * MF_BN;
    mbar_expect_tx(ring.full + slot, MF_SLOT);
    tma_load_4d(dst, &kmap, ring.full + slot, 0, kv0, unit_h(k), unit_b(k));
    tma_load_4d(dst + MF_KV, &vmap, ring.full + slot, 0, kv0, unit_h(k), unit_b(k));
  };
  unsigned char* Qw = Qs + wg * 2 * PL_QWG;  // this warpgroup's two q buffers
  float* tab = reinterpret_cast<float*>(base) + wg * 3 * (PL_TAB / 4);
  // (the warpgroup's first thread) unit k's raw q rows into buffer k % 2
  auto load_q = [&](int k) {
    uint64_t* bar = qfull + 2 * wg + (k & 1);
    mbar_expect_tx(bar, PL_QWG);
    tma_load_4d(Qw + (k & 1) * PL_QWG, &qmap, bar, 0, unit_rb(k) * PL_RB + wg * 64, unit_h(k),
                unit_b(k));
  };
  // (the warpgroup's first thread) the tables of unit k's rows
  auto load_tabs = [&](int k) {
    uint64_t* bar = tbar + wg;
    const int row = unit_rb(k) * PL_RB + wg * 64, bt = a.q_tb ? unit_b(k) : 0;
    mbar_expect_tx(bar, 3 * PL_TAB);
    tma_load_3d(tab, &cmap, bar, 0, row, bt);
    tma_load_3d(tab + PL_TAB / 4, &smap, bar, 0, row, bt);
    tma_load_3d(tab + PL_TAB / 2, &amap, bar, 0, row, bt);
  };
  if (threadIdx.x == 0) {
    ring.init();
#pragma unroll
    for (int i = 0; i < 6; ++i) mbar_init(qfull + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    ring.fill(-1, load_kv);
  }
  __syncthreads();  // the mbarriers' initialization
  if (wtid == 0) {
    load_tabs(0);
    load_q(0);
    if (count > 1) load_q(1);
  }

  float rc[8];  // this thread's rot coefficients (columns c0 .. c0 + 7 of every row)
  {
    const float* rot = static_cast<const float*>(a.q_rot) + (wtid & 7) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) rc[e] = __ldg(rot + e);
  }
  const float eps = static_cast<float>(a.eps), qscale = static_cast<float>(a.qscale);
  int tloads = 1, trows = unit_b(0) * nrb + unit_rb(0);  // the tables' loads, their rows
  // unit k's q rows prologued in buffer k % 2 and visible to the tensor cores
  auto prologue = [&](int k) {
    const int rows = unit_b(k) * nrb + unit_rb(k);
    if (rows != trows) {  // the last prologue is past every warp's barrier
      if (wtid == 0) load_tabs(k);
      ++tloads;
      trows = rows;
    }
    mbar_wait(tbar + wg, (tloads - 1) & 1);
    mbar_wait(qfull + 2 * wg + (k & 1), (k >> 1) & 1);
    prologue_q_rows(Qw + (k & 1) * PL_QWG, tab, rc, a.norm_q != 0, eps, qscale);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(wg);
  };
  auto slot = [&](int n) { return slots + (n % PL_SLOTS) * MF_SLOT; };
  float acc[8][4], l[2];
  float s[MF_BN / 8][4];
  uint32_t pa[MF_BN / 16][4];  // bf16 p of the last softmax: the A operand of its p.v
  zero_tile(s);
  zero_tile(acc);  // defined before the loop's first wgmma (its first p.v overwrites it)
  l[0] = l[1] = 0.f;
  auto store = [&](int k) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + unit_b(k) * a.o_sb + unit_h(k) * a.o_sh;
    store_maxfree_rows(acc, l, o, a.o_ss, unit_rb(k) * PL_RB + warp * 16, sq);
  };
  prologue(0);
  const int steps = count * nt;
  for (int n = 0; n < steps; ++n) {
    const int k = n / nt, t = n % nt;
    if (threadIdx.x == 0) ring.fill(n, load_kv);
    ring.wait(n);
    // this step's scores, with the last step's p.v
    pin_regs(s);
    pin_regs(acc);
    pin_regs(pa);
    wgmma_fence();
    issue_scores_ss<64>(s, q_desc(Qw + (k & 1) * PL_QWG), slot(n));
    wgmma_commit();
    if (n > 0) {  // a unit's first p.v starts its accumulator
      if ((n - 1) % nt == 0)
        issue_pv_new(acc, pa, slot(n - 1) + MF_KV);
      else
        issue_pv<64>(acc, pa, slot(n - 1) + MF_KV);
      wgmma_commit();
    }
    if (n > 0)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    pin_regs(s);
    float ls[2];
    const int b = unit_b(k);
    const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
    if (bias != nullptr || (t + 1) * MF_BN > skv)
      maxfree_tile<true>(s, t * MF_BN, skv, bias, c, ls);
    else
      maxfree_tile<false>(s, t * MF_BN, skv, nullptr, c, ls);
    if (n > 0) {
      wgmma_wait<0>();
      pin_regs(acc);
      pin_regs(pa);
      ring.release(n - 1);
    }
    if (t == 0 && n > 0) {  // the last unit's p.v are all in: its output
      store(k - 1);
      l[0] = ls[0];
      l[1] = ls[1];
    } else {
      l[0] += ls[0];
      l[1] += ls[1];
    }
    pack_p<MF_BN>(pa, s);
    // this unit's scores are done: the next unit's q rows prologued with no
    // wgmma in flight (between an issue and its wait, ptxas serialized every
    // wgmma), then, past prologue's barrier, this unit's buffer takes unit
    // k + 2
    if (t == nt - 1 && k + 1 < count) {
      prologue(k + 1);
      if (wtid == 0 && k + 2 < count) load_q(k + 2);
    }
  }
  // the last p.v
  pin_regs(acc);
  pin_regs(pa);
  wgmma_fence();
  if ((steps - 1) % nt == 0)
    issue_pv_new(acc, pa, slot(steps - 1) + MF_KV);
  else
    issue_pv<64>(acc, pa, slot(steps - 1) + MF_KV);
  wgmma_commit();
  wgmma_wait<0>();
  pin_regs(acc);
  pin_regs(pa);
  store(count - 1);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A 3-D f32 tensor map of one q table ([Bt][S][64], Bt = B with a batch
// stride ``tb`` in elements, else 1): boxes of 64 columns x 64 rows, no
// swizzle; rows past S read as zeros.
cudaError_t table_map(CUtensorMap* map, const void* base, long long s, long long b, long long tb) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {64, static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(tb ? b : 1)};
  const cuuint64_t strides[2] = {64 * 4, static_cast<cuuint64_t>(tb ? tb : s * 64) * 4};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

__global__ void __launch_bounds__(NTHREADS) maxfree_prologue_kernel(const TGAttnArgs a, int k_side,
                                                                  __nv_bfloat16* out,
                                                                  long long out_sb) {
  prologue_rows<D>(a, k_side, out, out_sb);
}

// T3a: the prologue passes of k and q into ``pro`` (bf16, B * (Skv + Sq) *
// H * 64), then the body with RB row blocks a warpgroup.
template <int RB>
int launch_pair_splitpv(const TGAttnArgs* a, float shift, void* pro, cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0 || a->h % 2 || pro == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  TGAttnArgs p;
  cudaError_t err = prologue_passes<D>(maxfree_prologue_kernel, a, pro, s, &p);
  CUtensorMap qmap, kmap, vmap;
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&qmap, p.q, p.sq, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, RB * 64);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&kmap, p.k, p.skv, p.h, p.b, p.k_ss, p.k_sh, p.k_sb, MF_BN);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&vmap, p.v, p.skv, p.h, p.b, p.v_ss, p.v_sh, p.v_sb, MF_BN);
  constexpr int smem = splitpv_smem_bytes<RB>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pair_splitpv_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.sq + RB * 64 - 1) / (RB * 64)),
                  static_cast<unsigned>(p.h / 2), static_cast<unsigned>(p.b));
  pair_splitpv_kernel<RB><<<grid, MF_NT, smem, s>>>(p, qmap, kmap, vmap, MF_PK - shift);
  return static_cast<int>(cudaGetLastError());
}

// T3b: the prologue passes of k and q into ``pro`` (bf16, B * (Skv + Sq) *
// H * 64), then the body.
int launch_pair2(const TGAttnArgs* a, float shift, void* pro, cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0 || a->h % 4 || pro == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  TGAttnArgs p;
  cudaError_t err = prologue_passes<D>(maxfree_prologue_kernel, a, pro, s, &p);
  CUtensorMap qmap, kmap, vmap;
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&qmap, p.q, p.sq, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, P2_BM);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&kmap, p.k, p.skv, p.h, p.b, p.k_ss, p.k_sh, p.k_sb, MF_BN);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&vmap, p.v, p.skv, p.h, p.b, p.v_ss, p.v_sh, p.v_sb, MF_BN);
  constexpr int smem = pair2_smem_bytes();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pair2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.sq + P2_BM - 1) / P2_BM),
                  static_cast<unsigned>(p.h / 4), static_cast<unsigned>(p.b));
  pair2_kernel<<<grid, MF_NT, smem, s>>>(p, qmap, kmap, vmap, MF_PK - shift);
  return static_cast<int>(cudaGetLastError());
}

// T5 on raw q and prologued k (``a->k``), ``per_block`` units a block.
int launch_pairloop(const TGAttnArgs* a, long long per_block, float shift, cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0 || per_block < 1 || a->q_rot == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap, cmap, smap, amap;
  cudaError_t err = kv_tensor_map<D>(&qmap, a->q, a->sq, a->h, a->b, a->q_ss, a->q_sh, a->q_sb, 64);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&kmap, a->k, a->skv, a->h, a->b, a->k_ss, a->k_sh, a->k_sb, MF_BN);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&vmap, a->v, a->skv, a->h, a->b, a->v_ss, a->v_sh, a->v_sb, MF_BN);
  if (err == cudaSuccess) err = table_map(&cmap, a->q_cos, a->sq, a->b, a->q_tb);
  if (err == cudaSuccess) err = table_map(&smap, a->q_sin, a->sq, a->b, a->q_tb);
  if (err == cudaSuccess) err = table_map(&amap, a->q_add, a->sq, a->b, a->q_tb);
  constexpr int smem = pairloop_smem_bytes();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pairloop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = a->b * ((a->sq + PL_RB - 1) / PL_RB) * a->h;
  pairloop_kernel<<<static_cast<unsigned>((units + per_block - 1) / per_block), MF_NT, smem, s>>>(
      *a, qmap, kmap, vmap, cmap, smap, amap, static_cast<int>(per_block), MF_PK - shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
