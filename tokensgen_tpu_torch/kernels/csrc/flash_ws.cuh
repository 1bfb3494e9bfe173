// The overlapped flash-attention forward of K1 (joint self-attention,
// `joint_*_kernel`), K6 at head dims <= 64 (fused-prologue [B, H, S, D],
// `fused_bhsd_*_kernel<HD>`) and K7 (K1 with int8 scores,
// `joint_int8_*_kernel`: ws_body's I8) in attention.cu: flash_splitkv.cuh's
// machinery (TMA ring, wgmma, split ranges and their combine) with each
// warpgroup's products overlapped with its softmax.
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

// K7's scores (I8 = true): q and K as int8 codes, one 64-byte row a head
// (the 64-byte swizzle), the product in s32 by wgmma. Each score then
// becomes f32 without an integer-to-float conversion: its integer c fits in
// 22 bits (|c| <= 64 * 127^2 < 2^22), so c + the bits of 1.5 * 2^23 are the
// bits of the float 1.5 * 2^23 + c, exactly, and one FP32 add takes the
// offset off (tools/kernel_ablations.py times it against the conversion).
constexpr uint32_t I8_MAGIC = 0x4B400000u;  // the bits of 1.5 * 2^23
constexpr float I8_MAGICF = 12582912.f;     // 1.5 * 2^23

// row stride of K7's scale tables ([B, H / 2, int8_scale_stride(S)] f32):
// S rounded up to 16 bytes, as a tensor map's rows must be; the body's maps
// read [0, S) of each row (past S they read zeros), never the padding
__host__ __device__ constexpr long long int8_scale_stride(long long s) { return (s + 3) / 4 * 4; }

// The layout of ws_body's tiles: q and a stage's K tile in bf16 (TileGeom's)
// or, with I8, int8 codes; V always bf16 (TileGeom's).
template <int HD, bool I8>
struct WsGeom {
  static_assert(HD == splitkv_box_cols(HD), "one box a row");
  static_assert(!I8 || HD == 64, "K7 takes heads of 64");
  using G = TileGeom<HD>;
  static constexpr int BN = G::BN;
  static constexpr uint32_t RB = I8 ? HD : G::RB;     // bytes per q / K row
  static constexpr uint32_t SBO = 8 * RB;
  static constexpr uint32_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr uint32_t KBYTES = BN * RB;          // one K tile
  static constexpr uint32_t STAGE = KBYTES + G::BYTES; // one K tile and one V tile
  static constexpr uint32_t QBOX = WS_BM * RB;         // the q tile
  static constexpr uint32_t KSC = I8 ? BN * 4 : 0;     // a tile's key scales (f32)
  static constexpr uint32_t QSC = I8 ? WS_BM * 4 : 0;  // the q tile's row scales (f32)
};

// dynamic shared memory: 1 KB of alignment slack, the q tile and the K / V
// ring (all in TMA's swizzled boxes), K7's key scales per stage and row
// scales, the full and empty mbarriers and q's
template <int HD, bool I8 = false>
__host__ __device__ constexpr int ws_smem_bytes() {
  using W = WsGeom<HD, I8>;
  return static_cast<int>(1024 + W::QBOX + SK_STAGES * (W::STAGE + W::KSC) + W::QSC) +
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

// d (m64 x n128 s32) += A (m64 x k32 s8 from shared memory by descriptor,
// K-major) x B (k32 x n128 s8, K-major): K7's score product. The integer
// form takes neither scale nor transpose operands (8-bit operands are
// K-major only). ``d`` holds the s32 bits in f32 registers: the scores
// become floats in place, without a second tile of registers.
__device__ __forceinline__ void wgmma_s8(float (&d)[16][4], uint64_t adesc, uint64_t bdesc,
                                         int scale_d) {
  uint32_t(&u)[16][4] = reinterpret_cast<uint32_t(&)[16][4]>(d);
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(u[0][0]), "+r"(u[0][1]), "+r"(u[0][2]), "+r"(u[0][3]),
        "+r"(u[1][0]), "+r"(u[1][1]), "+r"(u[1][2]), "+r"(u[1][3]),
        "+r"(u[2][0]), "+r"(u[2][1]), "+r"(u[2][2]), "+r"(u[2][3]),
        "+r"(u[3][0]), "+r"(u[3][1]), "+r"(u[3][2]), "+r"(u[3][3]),
        "+r"(u[4][0]), "+r"(u[4][1]), "+r"(u[4][2]), "+r"(u[4][3]),
        "+r"(u[5][0]), "+r"(u[5][1]), "+r"(u[5][2]), "+r"(u[5][3]),
        "+r"(u[6][0]), "+r"(u[6][1]), "+r"(u[6][2]), "+r"(u[6][3]),
        "+r"(u[7][0]), "+r"(u[7][1]), "+r"(u[7][2]), "+r"(u[7][3]),
        "+r"(u[8][0]), "+r"(u[8][1]), "+r"(u[8][2]), "+r"(u[8][3]),
        "+r"(u[9][0]), "+r"(u[9][1]), "+r"(u[9][2]), "+r"(u[9][3]),
        "+r"(u[10][0]), "+r"(u[10][1]), "+r"(u[10][2]), "+r"(u[10][3]),
        "+r"(u[11][0]), "+r"(u[11][1]), "+r"(u[11][2]), "+r"(u[11][3]),
        "+r"(u[12][0]), "+r"(u[12][1]), "+r"(u[12][2]), "+r"(u[12][3]),
        "+r"(u[13][0]), "+r"(u[13][1]), "+r"(u[13][2]), "+r"(u[13][3]),
        "+r"(u[14][0]), "+r"(u[14][1]), "+r"(u[14][2]), "+r"(u[14][3]),
        "+r"(u[15][0]), "+r"(u[15][1]), "+r"(u[15][2]), "+r"(u[15][3])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

// s = q.k^T for this warpgroup's 64 q rows of one row block: q (A) from the
// swizzled q tile by ``qdesc``, the descriptor of its first rows, K (B) from
// the stage; k-step kk starts 32 bytes on within the row, in both. The
// k-steps' q descriptors are qdesc plus their offset in 16-byte units (the
// address field cannot carry: shared memory is under 2^18 bytes); qdesc is
// made opaque so that the compiler adds them here instead of holding all of
// a block's in registers across the loop. bf16 (16 columns a k-step) into
// f32 ``s``, or with I8 int8 codes (32 a k-step) into s32 bits in ``s``.
template <int HD, bool I8 = false>
__device__ __forceinline__ void issue_scores_ss(float (&s)[splitkv_bn(HD) / 8][4], uint64_t qdesc,
                                                const unsigned char* Ks) {
  using W = WsGeom<HD, I8>;
  asm volatile("" : "+l"(qdesc));
#pragma unroll
  for (int kk = 0; kk < W::RB / 32; ++kk) {
    const uint64_t kdesc = smem_desc(Ks + kk * 32, 16, W::SBO, W::MODE);
    if constexpr (I8)
      wgmma_s8(s, qdesc + kk * 2, kdesc, kk > 0);
    else
      wgmma_ss<W::BN>(s, qdesc + kk * 2, kdesc, kk > 0);
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
// With I8 (K7), q and K are int8 codes and ``qsmap`` / ``ksmap`` the 2-D
// maps of their scale tables (rows b * H / 2 + h / 2, one scale per row
// and head pair; boxes of WS_BM and BN scales): a score is
// int32(cq . ck) * ks_key * qs_row. The key scales come with each K stage,
// the row scales with the q tile, by TMA on the same mbarriers; the row
// scale joins the exp2's FMA (softmax_tile's ``r``).
template <int HD, bool I8 = false>
__device__ __forceinline__ void ws_body(const TGAttnArgs& a, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, const CUtensorMap* qmap, int h,
                                        int b, int q0, int split, int split_len, int splits,
                                        float* ws, const CUtensorMap* qsmap = nullptr,
                                        const CUtensorMap* ksmap = nullptr) {
  using W = WsGeom<HD, I8>;
  constexpr int BN = W::BN;
  static_assert(BN != HD, "the two products must differ in wgmma shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = Qs + W::QBOX;
  // I8: the key scales [stage][BN], then the row scales [WS_BM], which the
  // threads load: addressed off smem_raw itself (through the integer-aligned
  // Qs, the compiler loses that they are shared memory: generic loads; the
  // tensor cores and TMA read everything else by its shared address)
  float* ksc = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023) +
                                        W::QBOX + SK_STAGES * W::STAGE);
  float* qsc = ksc + SK_STAGES * W::KSC / 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SK_STAGES * (W::STAGE + W::KSC) + W::QSC);
  uint64_t* empty = full + SK_STAGES;
  uint64_t* qbar = empty + SK_STAGES;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int kvbeg = split * split_len, kvend = min(skv, kvbeg + split_len);
  const int ntiles = (kvend - kvbeg + BN - 1) / BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // tile t into stage t % SK_STAGES (its last use released)
  auto load_tile = [&](int t) {
    const int st = t % SK_STAGES;
    unsigned char* dst = ring + st * W::STAGE;
    mbar_expect_tx(full + st, W::STAGE + W::KSC);
    tma_load_4d(dst, kmap, full + st, 0, kvbeg + t * BN, h, b);
    tma_load_4d(dst + W::KBYTES, vmap, full + st, 0, kvbeg + t * BN, h, b);
    if constexpr (I8)
      tma_load_2d(ksc + st * BN, ksmap, full + st, kvbeg + t * BN,
                  static_cast<int>(b * (a.h / 2)) + h / 2);
  };
  if (threadIdx.x == WS_LOADER) {
#pragma unroll
    for (int st = 0; st < SK_STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, WS_NT / 32);  // lane 0 of every warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, W::QBOX + W::QSC);
    tma_load_4d(Qs, qmap, qbar, 0, q0, h, b);
    if constexpr (I8) tma_load_2d(qsc, qsmap, qbar, q0, static_cast<int>(b * (a.h / 2)) + h / 2);
    for (int t = 0; t < min(SK_STAGES, ntiles); ++t) load_tile(t);
  }
  __syncthreads();  // the mbarriers' initialization

  const int wg = warp >> 2;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  // the descriptor of this warpgroup's 64 rows of row block rb in the q tile
  auto qrows = [&](int rb) {
    return smem_desc(Qs + (rb * 128 + wg * 64) * W::RB, 16, W::SBO, W::MODE);
  };
  AccT<HD> acc[2];
  init_acc(acc[0]);
  init_acc(acc[1]);
  float s[BN / 8][4];        // the scores (I8: their s32 bits until the softmax)
  uint32_t pa[BN / 16][4];  // bf16 p of the last softmax: the A operand of its p.v
  auto issue_scores = [&](int rb, int t) {
    issue_scores_ss<HD, I8>(s, qrows(rb), ring + (t % SK_STAGES) * W::STAGE);
  };
  // row block rb's softmax of tile t (with I8 first its scores in f32, in
  // place: c exactly, times the key's scale)
  auto softmax = [&](int rb, int t) {
    // this thread's two rows' scales (I8; rows past Sq read 0 from the
    // map and take 1, without their row index, which the stores compute)
    float2 rsc = make_float2(1.f, 1.f);
    if constexpr (I8) {
      const float* qr = qsc + rb * 128 + warp * 16 + (lane >> 2);
      rsc = make_float2(qr[0] > 0.f ? qr[0] : 1.f, qr[8] > 0.f ? qr[8] : 1.f);
      const float* kc = ksc + (t % SK_STAGES) * BN + (lane & 3) * 2;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const float2 k2 = *reinterpret_cast<const float2*>(kc + nt * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[nt][i] = (__uint_as_float(__float_as_uint(s[nt][i]) + I8_MAGIC) - I8_MAGICF) *
                     (i & 1 ? k2.y : k2.x);
      }
    }
    float ls[2];
    const float2 alpha = softmax_tile<BN, I8>(s, kvbeg + t * BN, kvend, bias, acc[rb].m, ls, rsc);
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
    issue_scores(rs, ts);
    wgmma_commit();
    issue_pv<HD>(acc[rp].o, pa, ring + (tp % SK_STAGES) * W::STAGE + W::KBYTES);
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
  issue_scores(0, 0);
  wgmma_commit();
  wgmma_wait<0>();
  pin_regs(s);
  softmax(0, 0);
  pack_p<BN>(pa, s);
  turn(1, 0, 0, 0);
  softmax(1, 0);
  repack(0);
  for (int j = 1; j < ntiles; ++j) {
    mbar_wait(full + j % SK_STAGES, (j / SK_STAGES) & 1);
    turn(0, j, 1, j - 1);
    softmax(0, j);
    repack(1);
    // every warp arrives on tile j - 1's stage, now done; the loader refills it
    if (lane == 0) mbar_arrive(empty + (j - 1) % SK_STAGES);
    if (threadIdx.x == WS_LOADER && j - 1 + SK_STAGES < ntiles) {
      mbar_wait(empty + (j - 1) % SK_STAGES, ((j - 1) / SK_STAGES) & 1);
      load_tile(j - 1 + SK_STAGES);
    }
    turn(1, j, 0, j);
    softmax(1, j);
    repack(0);
  }
  // the last p.v: row block 1's of the last tile
  pin_regs(acc[1].o);
  pin_regs(pa);
  wgmma_fence();
  issue_pv<HD>(acc[1].o, pa, ring + ((ntiles - 1) % SK_STAGES) * W::STAGE + W::KBYTES);
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


// ---------------------------------------------------------------------------
// K2 (`smallkv_kernel` in attention.cu): long q against at most
// SK_STAGES * 128 = 512 keys (text_video -> vip). The keys of one (b, h) fit
// in shared memory whole, so a block loads its (b, h)'s prologued K and V
// once, by TMA, into the SK_STAGES K / V stages that ws_body streams through,
// and then runs a contiguous range of the call's q tiles of WS_BM rows
// against them (tiles in (b, h)-major order, `per_block` a block; when the
// range reaches the next (b, h), the block reloads K and V). The q' tiles
// (prologued with log2 e folded in by the prologue pass) come by TMA through
// a ring of SKV_QSTAGES, one tile ahead. Each q tile is ws_body's loop over
// the <= 4 kv tiles: two row blocks per warpgroup, one row block's scores
// issued with the other's p.v, the score product reading q' from shared
// memory (SS), p.v its p from registers. The TPU kernel scores the whole
// pre-prologued K in one matmul; here the ragged last kv tile is masked
// (keys past Skv score -inf), and rows past Sq are not stored.
constexpr int SKV_QSTAGES = 2;

// dynamic shared memory: 1 KB of alignment slack, the q' ring, K / V (all in
// TMA's swizzled boxes), the q' stages' mbarriers and K / V's
template <int HD>
__host__ __device__ constexpr int smallkv_smem_bytes() {
  return 1024 + static_cast<int>(sizeof(__nv_bfloat16)) *
                    (SKV_QSTAGES * WS_BM * HD + 2 * SK_STAGES * splitkv_bn(HD) * HD) +
         8 * (SKV_QSTAGES + 1);
}

template <int HD>
__device__ __forceinline__ void smallkv_body(const TGAttnArgs& a, const CUtensorMap* kmap,
                                             const CUtensorMap* vmap, const CUtensorMap* qmap,
                                             int per_block) {
  using G = TileGeom<HD>;
  constexpr int BN = G::BN;
  static_assert(BN != HD, "the two products must differ in wgmma shape");
  static_assert(HD == splitkv_box_cols(HD), "one box per row");
  constexpr uint32_t KVT = 2 * G::BYTES;    // one K tile and one V tile
  constexpr uint32_t QBOX = WS_BM * G::RB;  // one q' tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* kv = Qs + SKV_QSTAGES * QBOX;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(kv + SK_STAGES * KVT);
  uint64_t* kvbar = qfull + SKV_QSTAGES;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int heads = static_cast<int>(a.h);
  const int ntiles = (skv + BN - 1) / BN;  // <= SK_STAGES
  const int nqt = (sq + WS_BM - 1) / WS_BM;
  const long long first = (long long)blockIdx.x * per_block;
  const long long last = min(a.b * a.h * nqt, first + per_block);
  const int wg = threadIdx.x >> 7;

  auto load_kv = [&](long long bh) {
    const int b = static_cast<int>(bh / heads), h = static_cast<int>(bh % heads);
    mbar_expect_tx(kvbar, ntiles * KVT);
    for (int i = 0; i < ntiles; ++i) {
      tma_load_4d(kv + i * KVT, kmap, kvbar, 0, i * BN, h, b);
      tma_load_4d(kv + i * KVT + G::BYTES, vmap, kvbar, 0, i * BN, h, b);
    }
  };
  auto load_q = [&](long long tile, int st) {
    const long long bh = tile / nqt;
    mbar_expect_tx(qfull + st, QBOX);
    tma_load_4d(Qs + st * QBOX, qmap, qfull + st, 0, static_cast<int>(tile % nqt) * WS_BM,
                static_cast<int>(bh % heads), static_cast<int>(bh / heads));
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < SKV_QSTAGES; ++st) mbar_init(qfull + st, 1);
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_kv(first / nqt);
    for (int st = 0; st < SKV_QSTAGES && first + st < last; ++st) load_q(first + st, st);
  }
  __syncthreads();  // the mbarriers' initialization

  long long cur = first / nqt;  // the (b, h) whose K / V are loaded
  int kv_loads = 1;
  float s[BN / 8][4];
  uint32_t pa[BN / 16][4];  // bf16 p of the last softmax: the A operand of its p.v
  for (long long tile = first; tile < last; ++tile) {
    const int i = static_cast<int>(tile - first);
    const long long bh = tile / nqt;
    if (bh != cur) {  // the same for the whole block; the last tile's barrier freed K / V
      if (threadIdx.x == 0) load_kv(bh);
      cur = bh;
      ++kv_loads;
    }
    const int b = static_cast<int>(bh / heads), h = static_cast<int>(bh % heads);
    const int q0 = static_cast<int>(tile % nqt) * WS_BM;
    const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
    const unsigned char* Qt = Qs + (i % SKV_QSTAGES) * QBOX;
    // the descriptor of this warpgroup's 64 rows of row block rb in the q' tile
    auto qrows = [&](int rb) {
      return smem_desc(Qt + (rb * 128 + wg * 64) * G::RB, 16, G::SBO, G::MODE);
    };
    AccT<HD> acc[2];
    init_acc(acc[0]);
    init_acc(acc[1]);
    auto softmax = [&](int rb, int kv0) {
      float ls[2];
      const float2 alpha = softmax_tile<BN>(s, kv0, skv, bias, acc[rb].m, ls);
      acc[rb].l[0] = acc[rb].l[0] * alpha.x + ls[0];
      acc[rb].l[1] = acc[rb].l[1] * alpha.y + ls[1];
      rescale(acc[rb], alpha);
    };
    // as ws_body's: row block rs's scores of kv tile ts with the p.v of the
    // p in registers (row block rp's of tile tp), the p.v left running
    auto turn = [&](int rs, int ts, int rp, int tp) {
      pin_regs(s);
      pin_regs(acc[rp].o);
      pin_regs(pa);
      wgmma_fence();
      issue_scores_ss<HD>(s, qrows(rs), kv + ts * KVT);
      wgmma_commit();
      issue_pv<HD>(acc[rp].o, pa, kv + tp * KVT + G::BYTES);
      wgmma_commit();
      wgmma_wait<1>();
      pin_regs(s);
    };
    auto repack = [&](int rp) {
      wgmma_wait<0>();
      pin_regs(acc[rp].o);
      pin_regs(pa);
      pack_p<BN>(pa, s);
    };
    mbar_wait(kvbar, (kv_loads - 1) & 1);
    mbar_wait(qfull + i % SKV_QSTAGES, (i / SKV_QSTAGES) & 1);
    pin_regs(s);
    wgmma_fence();
    issue_scores_ss<HD>(s, qrows(0), kv);
    wgmma_commit();
    wgmma_wait<0>();
    pin_regs(s);
    softmax(0, 0);
    pack_p<BN>(pa, s);
    turn(1, 0, 0, 0);
    softmax(1, 0);
    repack(0);
    for (int j = 1; j < ntiles; ++j) {
      turn(0, j, 1, j - 1);
      softmax(0, j * BN);
      repack(1);
      turn(1, j, 0, j);
      softmax(1, j * BN);
      repack(0);
    }
    pin_regs(acc[1].o);
    pin_regs(pa);
    wgmma_fence();
    issue_pv<HD>(acc[1].o, pa, kv + (ntiles - 1) * KVT + G::BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    pin_regs(acc[1].o);
    pin_regs(pa);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
    store_out(acc[0], o, a.o_ss, q0, sq, nullptr);
    store_out(acc[1], o, a.o_ss, q0 + 128, sq, nullptr);
    __syncthreads();  // this q' stage (and, before a reload, K / V) read by both warpgroups
    if (threadIdx.x == 0 && tile + SKV_QSTAGES < last) load_q(tile + SKV_QSTAGES, i % SKV_QSTAGES);
  }
}

}  // namespace
