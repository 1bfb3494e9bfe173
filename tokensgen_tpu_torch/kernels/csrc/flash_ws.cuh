// The overlapped flash-attention forward of K1 (joint self-attention,
// `joint_*_kernel`) and K6 at head dims <= 64 (fused-prologue [B, H, S, D],
// `fused_bhsd_*_kernel<HD>`) in attention.cu: flash_splitkv.cuh's machinery
// (TMA ring, wgmma, split ranges and their combine) with each warpgroup's
// products overlapped with its softmax.
//
// Why: K1 is bound by operations on this card, and twice over: its two
// products at the bf16 tensor-core rate and its exponentials at the MUFU's
// ex2 rate (16 a clock per SM) take about the same time (7.85 and 7.95 ms
// at the edit shape). In flash_splitkv.cuh's body a warpgroup waits for
// its scores, then runs the softmax while its tensor cores idle, and every
// kv tile ends on a block barrier, so the two pipes take turns.
//
// Per block (two warpgroups, each two row blocks of 64 q rows):
// * The q tile (prologued and scaled by the prologue pass) and the K / V
//   tiles come by TMA, K / V through a ring of SK_STAGES stages. A stage is
//   refilled once every warp has arrived on its "empty" mbarrier: no
//   block-wide barrier in the loop. The first thread of warpgroup 1 issues
//   the loads as it releases a stage.
// * Within a warpgroup the row blocks alternate: one row block's scores are
//   issued with the other's p.v, whose softmax ran last, and the p.v runs
//   while this softmax does (FA3's intra-warpgroup overlap). Live at once:
//   one score tile, one p tile (its registers pinned until its wait) and
//   the two accumulators.
// * The score product reads q from shared memory (wgmma's SS form), p.v its
//   p from registers: with q's fragments in registers as well, ptxas ran
//   short and serialized the wgmmas ("insufficient register resources"),
//   which undoes the overlap; with a p tile per row block it spilled.
// Measured on an H100 and left out: a producer warp or warpgroup (288 / 384
// threads cap the launch at 168 registers a thread, ptxas counting whole
// warpgroups, and the consumers spilled whatever setmaxnreg moved); one row
// block per warpgroup (no faster than flash_splitkv.cuh's body); the two
// warpgroups taking turns at the tensor cores by named barriers (4-6%
// slower than leaving them to the warp schedulers); a sixteenth or an
// eighth of the exponentials on the FMA pipe, by a Cody-Waite split and a
// cubic (slower: the FMA pipe's issue slots are no freer than the MUFU).
// Shapes as flash_splitkv.cuh at HD <= 64: 128-key tiles (the score and p.v
// products must differ in wgmma shape).

#pragma once

#include "flash_splitkv.cuh"

namespace {

constexpr int WS_NT = 256;      // two warpgroups
constexpr int WS_BM = 256;      // q rows per block: two row blocks of 128
constexpr int WS_LOADER = 128;  // the thread that issues the loads: warpgroup 1's first

// dynamic shared memory: 1 KB of alignment slack, the q tile and the K / V
// ring (all in TMA's swizzled boxes), the full and empty mbarriers and q's
template <int HD>
__host__ __device__ constexpr int ws_smem_bytes() {
  return 1024 + static_cast<int>(sizeof(__nv_bfloat16)) *
                    (2 * SK_STAGES * splitkv_bn(HD) * HD + WS_BM * HD) +
         16 * SK_STAGES + 8;
}

// d (m64 x N f32) += A (m64 x k16 from shared memory by descriptor, K-major)
// x B (k16 x N, K-major): the score product with q in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t adesc, uint64_t bdesc,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t adesc, uint64_t bdesc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[16][4], uint64_t adesc, uint64_t bdesc,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

// s = q.k^T for this warpgroup's 64 q rows of one row block: q (A) from the
// swizzled q tile by ``qdesc``, the descriptor of its first rows (boxes
// ``qbox`` bytes apart), K (B) from the stage as issue_scores reads it;
// k-step kk starts 32 bytes on within its box, in both. The k-steps' q
// descriptors are qdesc plus their offset in 16-byte units (the address
// field cannot carry: shared memory is under 2^18 bytes); qdesc is made
// opaque so that the compiler adds them here instead of holding all eight
// of a block's in registers across the loop.
template <int HD>
__device__ __forceinline__ void issue_scores_ss(float (&s)[splitkv_bn(HD) / 8][4],
                                                uint64_t qdesc, uint32_t qbox,
                                                const unsigned char* Ks) {
  using G = TileGeom<HD>;
  asm volatile("" : "+l"(qdesc));
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = kk * 16 / splitkv_box_cols(HD), in = kk * 16 % splitkv_box_cols(HD);
    wgmma_ss<G::BN>(s, qdesc + ((box * qbox + in * 2) >> 4),
                    smem_desc(Ks + box * G::BOX + in * 2, 16, G::SBO, G::MODE), kk > 0);
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// p (f32 probabilities in the score layout) as the bf16 A fragments of p.v
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4], const float (&s)[BN / 8][4]) {
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

template <int HD>
__device__ __forceinline__ void rescale(AccT<HD>& acc, float2 alpha) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    acc.o[dt][0] *= alpha.x;
    acc.o[dt][1] *= alpha.x;
    acc.o[dt][2] *= alpha.y;
    acc.o[dt][3] *= alpha.y;
  }
}

// The block of q rows [q0, q0 + WS_BM) of head h of batch row b against the
// keys of range ``split`` (as splitkv_body: one split writes the output and
// lse, more write f32 partials for combine_rows). Row block rb holds rows
// q0 + 128 rb + [0, 128), warpgroup w rows 64 w + [0, 64) of each (the
// warps' fragments follow the global warp index, as store_out and
// store_partial read it). q comes by ``qmap`` (prologued, scaled), K and V
// by ``kmap`` and ``vmap`` (4-D: columns, rows, heads, batch rows; q's
// boxes WS_BM rows, K / V's BN).
template <int HD>
__device__ __forceinline__ void ws_body(const TGAttnArgs& a, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, const CUtensorMap* qmap, int h,
                                        int b, int q0, int split, int split_len, int splits,
                                        float* ws) {
  using G = TileGeom<HD>;
  constexpr int BN = G::BN;
  static_assert(BN != HD, "the two products must differ in wgmma shape");
  constexpr int NBOX = HD / splitkv_box_cols(HD);
  constexpr uint32_t STAGE = 2 * G::BYTES;  // one K tile and one V tile
  constexpr uint32_t QBOX = WS_BM * G::RB;  // bytes per box of the q tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = Qs + NBOX * QBOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SK_STAGES * STAGE);
  uint64_t* empty = full + SK_STAGES;
  uint64_t* qbar = empty + SK_STAGES;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int kvbeg = split * split_len, kvend = min(skv, kvbeg + split_len);
  const int ntiles = (kvend - kvbeg + BN - 1) / BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // tile t into stage t % SK_STAGES (its last use released)
  auto load_tile = [&](int t) {
    const int st = t % SK_STAGES;
    unsigned char* dst = ring + st * STAGE;
    mbar_expect_tx(full + st, STAGE);
#pragma unroll
    for (int i = 0; i < NBOX; ++i) {
      tma_load_4d(dst + i * G::BOX, kmap, full + st, i * splitkv_box_cols(HD), kvbeg + t * BN, h,
                  b);
      tma_load_4d(dst + G::BYTES + i * G::BOX, vmap, full + st, i * splitkv_box_cols(HD),
                  kvbeg + t * BN, h, b);
    }
  };
  if (threadIdx.x == WS_LOADER) {
#pragma unroll
    for (int st = 0; st < SK_STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, WS_NT / 32);  // lane 0 of every warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, WS_BM * HD * 2);
#pragma unroll
    for (int i = 0; i < NBOX; ++i)
      tma_load_4d(Qs + i * QBOX, qmap, qbar, i * splitkv_box_cols(HD), q0, h, b);
    for (int t = 0; t < min(SK_STAGES, ntiles); ++t) load_tile(t);
  }
  __syncthreads();  // the mbarriers' initialization

  const int wg = warp >> 2;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  // the descriptor of this warpgroup's 64 rows of row block rb in the q tile
  auto qrows = [&](int rb) {
    return smem_desc(Qs + (rb * 128 + wg * 64) * G::RB, 16, G::SBO, G::MODE);
  };
  AccT<HD> acc[2];
  init_acc(acc[0]);
  init_acc(acc[1]);
  float s[BN / 8][4];
  uint32_t pa[BN / 16][4];  // bf16 p of the last softmax: the A operand of its p.v
  auto softmax = [&](int rb, int kv0) {
    float ls[2];
    const float2 alpha = softmax_tile<BN>(s, kv0, kvend, bias, acc[rb].m, ls);
    acc[rb].l[0] = acc[rb].l[0] * alpha.x + ls[0];
    acc[rb].l[1] = acc[rb].l[1] * alpha.y + ls[1];
    rescale(acc[rb], alpha);  // its p.v is done: each turn waits for it below
  };
  // row block rs's scores of tile ts with the p.v of the p in registers
  // (row block rp's of tile tp); the scores are waited for, the p.v left
  // running
  auto turn = [&](int rs, int ts, int rp, int tp) {
    pin_regs(s);  // the score product's first k-step ignores s's values
    pin_regs(acc[rp].o);
    pin_regs(pa);
    wgmma_fence();
    issue_scores_ss<HD>(s, qrows(rs), QBOX, ring + (ts % SK_STAGES) * STAGE);
    wgmma_commit();
    issue_pv<HD>(acc[rp].o, pa, ring + (tp % SK_STAGES) * STAGE + G::BYTES);
    wgmma_commit();
    wgmma_wait<1>();  // the scores
    pin_regs(s);
  };
  // the p.v issued by the last turn, then p repacked from s
  auto repack = [&](int rp) {
    wgmma_wait<0>();
    pin_regs(acc[rp].o);
    pin_regs(pa);
    pack_p<BN>(pa, s);
  };

  // tile 0: row block 0's scores alone, then row block 1's with 0's p.v
  mbar_wait(qbar, 0);
  mbar_wait(full, 0);
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
  pin_regs(s);
  wgmma_fence();
  issue_scores_ss<HD>(s, qrows(0), QBOX, ring);
  wgmma_commit();
  wgmma_wait<0>();
  pin_regs(s);
  softmax(0, kvbeg);
  pack_p<BN>(pa, s);
  turn(1, 0, 0, 0);
  softmax(1, kvbeg);
  repack(0);
  for (int j = 1; j < ntiles; ++j) {
    const int kv0 = kvbeg + j * BN;
    mbar_wait(full + j % SK_STAGES, (j / SK_STAGES) & 1);
    turn(0, j, 1, j - 1);
    softmax(0, kv0);
    repack(1);
    // every warp arrives on tile j - 1's stage, now done; the loader refills it
    if (lane == 0) mbar_arrive(empty + (j - 1) % SK_STAGES);
    if (threadIdx.x == WS_LOADER && j - 1 + SK_STAGES < ntiles) {
      mbar_wait(empty + (j - 1) % SK_STAGES, ((j - 1) / SK_STAGES) & 1);
      load_tile(j - 1 + SK_STAGES);
    }
    turn(1, j, 0, j);
    softmax(1, kv0);
    repack(0);
  }
  // the last p.v: row block 1's of the last tile
  pin_regs(acc[1].o);
  pin_regs(pa);
  wgmma_fence();
  issue_pv<HD>(acc[1].o, pa, ring + ((ntiles - 1) % SK_STAGES) * STAGE + G::BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  pin_regs(acc[1].o);
  pin_regs(pa);

  const long long part = ((long long)split * a.b + b) * a.h + h;
  const long long rows = (long long)splits * a.b * a.h * sq;
#pragma unroll
  for (int rb = 0; rb < 2; ++rb) {
    if (splits == 1) {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
      float* lse = a.lse ? static_cast<float*>(a.lse) + ((long long)b * a.h + h) * sq : nullptr;
      store_out(acc[rb], o, a.o_ss, q0 + rb * 128, sq, lse);
    } else {
      store_partial<HD>(acc[rb], ws + part * sq * HD, ws + rows * HD + part * sq * 2,
                        q0 + rb * 128, sq);
    }
  }
}

}  // namespace
