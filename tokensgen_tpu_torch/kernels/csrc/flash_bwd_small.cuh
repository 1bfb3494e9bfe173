// K5's one-pass attention backward at head dims 16 and 32
// (`bwd_small_kernel<HD>` in attention.cu, then `bwd_dq_store_kernel<HD>`):
// flash_bwd.cuh's form at 64 (what it computes, from the forward's lse, at
// the JAX kernel's rounding points, is stated there), re-cut for rows of 32
// and 64 bytes and for the shapes that run it, the tiny trainers'
// [3, 2, 1,544, 16] and [3, 4, 1,544, 32]. It replaces FA2's two-pass form
// (7 tile products instead of 5, every tile loaded by every thread with a
// block barrier per tile, mma.sync).
//
// The cut. At these shapes the work is small and the sweep over the q tiles
// is what takes the time: d = 64's 128-key blocks of two warpgroups make 78
// blocks at d = 16 for 132 SMs (59%) and 156 at d = 32 (1.18 waves, one
// block a SM), each sweeping all 1,544 q rows. Here a warpgroup owns 64
// keys and sweeps q tiles of BQ rows, independently of the block's other
// warpgroups (its own ring, ds^T, dq staging and named barrier; no block
// barrier in the loop); a block holds NK groups of 64 keys times QS
// warpgroups per group, warpgroup (k, w) sweeping the q tiles w, w + QS, ...
// against group k's keys, which are loaded once for the block. With QS > 1
// the group's dk, dv and dbias are summed at the end through shared memory,
// in warpgroup order (dk, dv and dbias stay the same from run to run; dq's
// reduce-adds land in an order that varies, as at 64 and 128). The shipped
// cuts (`BsCut`; tools/kernel_ablations.py sweeps the others):
// * d = 16 (6 heads of 1,544 keys: 25 groups of 64 each, 150 in all): QS = 2,
//   q tiles of 64: 150 blocks of 256 threads, at most 128 registers so that
//   two fit a SM: one wave of 264 slots, each warpgroup 12 or 13 of the 25
//   q tiles;
// * d = 32 (12 heads: 300 groups): QS = 1, q tiles of 64: 300 blocks of 128
//   threads, three a SM (396 slots): one wave, 25 q tiles a warpgroup.
// Per warpgroup and q tile (two ring stages, one tile ahead; Q and G by TMA
// in the head dim's own swizzle: 32-byte rows at 16, 64-byte at 32; lse2 and
// dsum by a bulk copy of the launcher's table of 64-row tiles):
// * s^T = K.Q^T and dp^T = V.G^T (m64nBQk16, both from shared memory,
//   K-major, HD / 16 k-steps);
// * per half of the tile's q columns: p^T, ds^T (its row sums into dbias),
//   bf16 p^T packed as the A operand of dv, bf16 ds^T stored to shared
//   memory (keys on the rows, 128-byte swizzle: its rows are q columns),
//   then dv += p^T.G (m64nHDk16, A in registers, G MN-major) and dk +=
//   ds^T.Q (ds^T K-major from shared memory, Q MN-major) issued;
// * dq = ds.K (m64nHDk16 per 64 q rows, ds^T MN-major as A, K MN-major as
//   B, 4 k-steps over the group's keys), staged f32 in the swizzle of its
//   HD * 4-byte rows (two buffers, one per tile parity) and added into the
//   f32 workspace by a TMA reduce, issued with the next tile's products.
// Ragged lengths as at 64: keys past Skv score -inf, q rows past Sq read as
// zeros with lse2 = +inf and dsum = 0 from the table's padding (it holds an
// even number of 64-row tiles, so a 128-row q tile reads inside it); their
// dq is clipped by the tensor map.
// Registers 128 (d = 16) and 139 (d = 32), no spill; 58,408 and 52,248 B of
// shared memory a block. Measured on an H100 (tools/kernel_ablations.py,
// device time of 10 queued calls, the launcher's table, memset and dq store
// included): 0.038 ms at d = 16 and 0.061 at 32, against the two-pass
// form's 0.087 and 0.151; the other cuts at 16: one warpgroup a key group
// 0.043, four 0.041 (1.14 waves), 128-key blocks 0.045, q tiles of 128
// 0.040; at 32: two warpgroups a key group 0.070 (1.14 waves), 128-key
// blocks 0.078, q tiles of 128 0.077; a ring of 3 or 4 q tiles no faster.
// The body alone takes 0.026 / 0.048 ms, ~2,500 clocks a q tile (clock64()
// stamps: the score products ~500, each half ~520, dq ~250, its staging
// ~220, the barriers between tiles ~300): the chain of one warpgroup's
// products and exponentials, not the card's rates, bounds it.

#pragma once

#include "flash_bwd.cuh"

namespace {

// The cut at head dim HD: NK groups of 64 keys a block, QS warpgroups a
// group (each a share of the q tiles), q tiles of BQ rows, MINB blocks a SM
// (the register budget: 65,536 / (128 NK QS MINB) a thread).
template <int HD>
struct BsCut;
template <>
struct BsCut<16> {
  static constexpr int NK = 1, QS = 2, BQ = 64, MINB = 2;
};
template <>
struct BsCut<32> {
  static constexpr int NK = 1, QS = 1, BQ = 64, MINB = 3;
};

constexpr int BS_KEYS = 64;      // keys per warpgroup (a wgmma's 64 rows)
constexpr int BS_AUX_ROWS = 64;  // q rows per tile of the launcher's lse2 / dsum table

template <int HD>
struct BsGeom {
  using C = BsCut<HD>;
  static constexpr int NK = C::NK, QS = C::QS, BQ = C::BQ, WGS = NK * QS, NT = 128 * WGS;
  static constexpr int STAGES = 2;                     // q tiles in a warpgroup's ring
  static constexpr uint32_t RB = 2 * HD;               // bytes per row of K, V, Q, G
  static constexpr uint32_t SBO = 8 * RB;              // bytes per group of 8 rows
  static constexpr uint32_t MODE = RB == 64 ? 2 : 3;   // 64- or 32-byte swizzle
  static constexpr uint32_t KV = NK * BS_KEYS * RB;    // the block's K (or V)
  static constexpr uint32_t TILE = BQ * RB;            // a Q or G tile
  static constexpr uint32_t AUX = 2 * BQ * 4;          // lse2 and dsum of a q tile
  static constexpr uint32_t STAGE = 2 * TILE + 1024;   // Q, G, the table's rows (padded)
  static constexpr uint32_t DST_BOX = BS_KEYS * 128;   // ds^T: 64 keys x 64 q columns
  static constexpr uint32_t DST = BQ / 64 * DST_BOX;
  static constexpr uint32_t DQ_RB = HD * 4;            // bytes per row of dq's f32 staging
  static constexpr uint32_t DQ_M = 64 * DQ_RB;         // 64 q rows of it: one TMA box
  static constexpr uint32_t DQ_BUF = BQ / 64 * DQ_M;   // one q tile's
  static constexpr uint32_t WG_BYTES = DST + 2 * DQ_BUF + STAGES * STAGE;
  // dynamic shared memory: 1 KB of alignment slack, K, V, each warpgroup's
  // ds^T, dq staging and ring, the rings' mbarriers and K / V's
  static constexpr int SMEM = static_cast<int>(1024 + 2 * KV + WGS * WG_BYTES) +
                              8 * (WGS * STAGES + 1);
  static_assert(HD == 16 || HD == 32, "the small head dims");
  static_assert(BQ % BS_AUX_ROWS == 0 && BQ <= 2 * BS_AUX_ROWS, "a q tile is 1 or 2 table tiles");
  static_assert(AUX <= 1024 && TILE % 1024 == 0 && KV % 1024 == 0, "tiles on 1,024 bytes");
  static_assert(STAGES * STAGE >= 128 * (HD + 2) * 4, "the ring holds the end's partial sums");
};

// d (m64 x nN f32, N = 16 or 32) += A (m64 x k16 from shared memory: TA = 0
// K-major, 1 MN-major) x B (k16 x nN, MN-major from shared memory): dk =
// ds^T.Q (TA 0) and dq = ds.K (TA 1) with ds^T, Q and K as stored.
template <int N, int TA>
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[N / 8][4], uint64_t adesc, uint64_t bdesc,
                                            int scale_d) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TA));
  } else {
    static_assert(N == 32, "m64n16 or m64n32");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TA));
  }
}

template <int M, int N>
__device__ __forceinline__ void pin_regs(float (&x)[M][N][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m) pin_regs(x[m]);
}

// The block's keys [kv0, kv0 + 64 NK) of head h of batch row b: Q, G, K and
// V by their 4-D tensor maps (boxes of HD columns x BQ rows, x 64 NK for K
// and V), lse2 and dsum by bulk copies from ``aux`` ([B * H][64-row tiles]
// [lse2 | dsum][64], padded with +inf / 0 past Sq to an even tile count);
// dq's partial sums are added by ``dqmap`` (3-D: HD columns, Sq rows,
// B * H; boxes of HD x 64, f32) into the workspace, zeroed by the caller.
template <int HD>
__device__ __forceinline__ void bwd_small_body(const TGAttnBwdArgs& a, const CUtensorMap* qmap,
                                               const CUtensorMap* gmap, const CUtensorMap* kmap,
                                               const CUtensorMap* vmap, const CUtensorMap* dqmap,
                                               const float* aux) {
  using S = BsGeom<HD>;
  constexpr int BQ = S::BQ, QS = S::QS, NT8 = BQ / 8, H8 = NT8 / 2;  // n8 tiles: a tile, a half
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the first 1,024-byte boundary, by pointer arithmetic on smem_raw (through
  // an integer every access below would be a generic load or store)
  unsigned char* Ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Vs = Ks + S::KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x & 127;
  const int kg = wg / QS, wq = wg % QS;  // this warpgroup's key group and q share
  unsigned char* dsT = Vs + S::KV + wg * S::WG_BYTES;  // [box of 64 q columns][64 keys][128 B]
  unsigned char* dqs = dsT + S::DST;                   // [tile & 1][64-row box][64][DQ_RB]
  unsigned char* ring = dqs + 2 * S::DQ_BUF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + S::KV + S::WGS * S::WG_BYTES);
  uint64_t* full = bars + wg * S::STAGES;
  uint64_t* kvbar = bars + S::WGS * S::STAGES;
  const int kv0 = blockIdx.x * (S::NK * BS_KEYS), h = blockIdx.y, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int nq = (sq + BQ - 1) / BQ;
  const int mine = wq < nq ? (nq - wq + QS - 1) / QS : 0;  // this warpgroup's q tiles
  const long long bh = (long long)b * a.h + h;
  const int aux_tiles = ((sq + 2 * BS_AUX_ROWS - 1) / (2 * BS_AUX_ROWS)) * 2;
  const float* aux_bh = aux + bh * aux_tiles * (2 * BS_AUX_ROWS);
  // this warpgroup's q tile i (tile wq + i QS) into stage i % STAGES (its last use released)
  auto load_tile = [&](int i) {
    const int st = i % S::STAGES, q0 = (wq + i * QS) * BQ;
    unsigned char* dst = ring + st * S::STAGE;
    mbar_expect_tx(full + st, 2 * S::TILE + S::AUX);
    tma_load_4d(dst, qmap, full + st, 0, q0, h, b);
    tma_load_4d(dst + S::TILE, gmap, full + st, 0, q0, h, b);
    bulk_load(dst + 2 * S::TILE, aux_bh + (long long)q0 * 2, S::AUX, full + st);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < S::WGS * S::STAGES; ++i) mbar_init(bars + i, 1);
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kvbar, 2 * S::KV);
    tma_load_4d(Ks, kmap, kvbar, 0, kv0, h, b);
    tma_load_4d(Vs, vmap, kvbar, 0, kv0, h, b);
  }
  __syncthreads();  // the mbarriers' initialization
  if (tid == 0)
    for (int i = 0; i < S::STAGES - 1 && i < mine; ++i) load_tile(i);

  // this thread's two keys (rows of s^T): bias in the log2 domain, -inf past Skv
  const int rA = kv0 + kg * BS_KEYS + (warp & 3) * 16 + g, rB = rA + 8;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  const float bA = rA < skv ? (bias ? bias[rA] * LOG2E : 0.f) : -INFINITY;
  const float bB = rB < skv ? (bias ? bias[rB] * LOG2E : 0.f) : -INFINITY;
  const float c1 = static_cast<float>(a.scale) * LOG2E;
  // the group's rows of K and V: A of the score products (K-major) and K, B
  // of dq (MN-major)
  const unsigned char* Kg = Ks + kg * BS_KEYS * S::RB;
  const unsigned char* Vg = Vs + kg * BS_KEYS * S::RB;
  // ds^T's row r (key), q columns c, c + 1: its 4-byte word in box c / 64 (the
  // 16-byte chunks of each row swizzled by the row's index mod 8)
  unsigned char* dst_row0 = dsT + ((warp & 3) * 16 + g) * 128 + t * 4;
  // dq's staging: row r (this warp's q row g of 64), columns c, c + 1: the
  // 16-byte chunk c / 4 swizzled by r mod 8 (128-byte rows) or r / 2 mod 4 (64)
  constexpr int DQ_SW = S::DQ_RB == 128 ? 0 : 1;
  unsigned char* dqs_row0 = dqs + ((warp & 3) * 16 + g) * S::DQ_RB + (t & 1) * 8;
  auto reduce_dq = [&](int i) {  // tile i's staged share of dq, added into the workspace
    const int q0 = (wq + i * QS) * BQ;
#pragma unroll
    for (int m = 0; m < BQ / 64; ++m)
      tma_reduce_add_3d(dqmap, dqs + (i & 1) * S::DQ_BUF + m * S::DQ_M, 0, q0 + m * 64,
                        static_cast<int>(bh));
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[dt][i] = dv[dt][i] = 0.f;
  float dbA = 0.f, dbB = 0.f;
  mbar_wait(kvbar, 0);

  for (int i = 0; i < mine; ++i) {
    if (i > 0) {
      // tile i - 2's dq staging read by its reduce (issued in tile i - 1; this
      // tile writes that buffer again), tile i - 1's stage and ds^T consumed
      // by the warpgroup's four warps
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    const int st = i % S::STAGES;
    mbar_wait(full + st, (i / S::STAGES) & 1);
    const unsigned char* Qt = ring + st * S::STAGE;
    const unsigned char* Gt = Qt + S::TILE;
    const float* tab = reinterpret_cast<const float*>(Gt + S::TILE);  // [64-row tile][2][64]
    uint64_t kdesc = smem_desc(Kg, 16, S::SBO, S::MODE), vdesc = smem_desc(Vg, 16, S::SBO, S::MODE);
    uint64_t qdesc = smem_desc(Qt, 16, S::SBO, S::MODE), gdesc = smem_desc(Gt, 16, S::SBO, S::MODE);
    asm volatile("" : "+l"(kdesc), "+l"(vdesc), "+l"(qdesc), "+l"(gdesc));
    float s[NT8][4], dp[NT8][4];
    pin_regs(s);  // the first k-step of each product ignores the accumulator's values
    pin_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)  // s^T = K.Q^T (k-step kk: 32 bytes on in the rows)
      wgmma_ss<BQ>(s, kdesc + kk * 2, qdesc + kk * 2, kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)  // dp^T = V.G^T
      wgmma_ss<BQ>(dp, vdesc + kk * 2, gdesc + kk * 2, kk > 0);
    wgmma_commit();
    // the next tile's loads and the previous tile's dq reduce, while the products run
    if (tid == 0 && i + S::STAGES - 1 < mine) load_tile(i + S::STAGES - 1);
    if (tid == 0 && i > 0) reduce_dq(i - 1);
    wgmma_wait<0>();
    pin_regs(s);
    pin_regs(dp);
    uint32_t pa[BQ / 16][4];  // bf16 p^T: the A operand of dv
    uint64_t adk = smem_desc(dsT, 16, 1024, 1);                  // K-major rows
    uint64_t bdk = smem_desc(Qt, S::TILE, S::SBO, S::MODE);      // MN-major
    uint64_t bdv = smem_desc(Gt, S::TILE, S::SBO, S::MODE);
    asm volatile("" : "+l"(adk), "+l"(bdk), "+l"(bdv));
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // q columns [BQ / 2 half, BQ / 2 (half + 1))
#pragma unroll
      for (int n8 = 0; n8 < H8; ++n8) {  // p^T in place
        const int nt = half * H8 + n8;
        const float2 l = *reinterpret_cast<const float2*>(tab + (nt >> 3) * 128 + (nt & 7) * 8 +
                                                          t * 2);
        s[nt][0] = exp2_ftz(fmaf(s[nt][0], c1, bA - l.x));
        s[nt][1] = exp2_ftz(fmaf(s[nt][1], c1, bA - l.y));
        s[nt][2] = exp2_ftz(fmaf(s[nt][2], c1, bB - l.x));
        s[nt][3] = exp2_ftz(fmaf(s[nt][3], c1, bB - l.y));
      }
      uint32_t dsb[H8][2];  // bf16 ds^T, for shared memory
#pragma unroll
      for (int n8 = 0; n8 < H8; ++n8) {  // ds^T, its row sums; bf16 p^T and ds^T
        const int nt = half * H8 + n8;
        const float2 ds = *reinterpret_cast<const float2*>(tab + (nt >> 3) * 128 + 64 +
                                                           (nt & 7) * 8 + t * 2);
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
      for (int n8 = 0; n8 < H8; ++n8) {
        const int nt = half * H8 + n8;
        unsigned char* w = dst_row0 + (nt >> 3) * S::DST_BOX + (((nt & 7) ^ g) << 4);
        *reinterpret_cast<uint32_t*>(w) = dsb[n8][0];
        *reinterpret_cast<uint32_t*>(w + 8 * 128) = dsb[n8][1];
      }
      // this half's ds^T rows are read by the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      pin_regs(dv);
      pin_regs(dk);
      pin_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < BQ / 32; ++jj) {  // the half's q rows: dv += p^T.G, dk += ds^T.Q
        const int k16 = half * (BQ / 32) + jj;
        wgmma_rs<HD, 1>(dv, pa[k16], bdv + k16 * (2 * S::SBO >> 4), 1);
        wgmma_ss_tb<HD, 0>(dk, adk + (((k16 >> 2) * S::DST_BOX + (k16 & 3) * 32) >> 4),
                           bdk + k16 * (2 * S::SBO >> 4), 1);
      }
      wgmma_commit();
    }
    float dq[BQ / 64][HD / 8][4];  // dq = ds.K per 64 q rows, over the group's 64 keys
    uint64_t adq = smem_desc(dsT, S::DST_BOX, 1024, 1);        // MN-major: q contiguous
    uint64_t bdq = smem_desc(Kg, S::KV, S::SBO, S::MODE);      // MN-major: d contiguous
    asm volatile("" : "+l"(adq), "+l"(bdq));
    pin_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < BQ / 64; ++m)
#pragma unroll
      for (int kk = 0; kk < BS_KEYS / 16; ++kk)
        wgmma_ss_tb<HD, 1>(dq[m], adq + ((m * S::DST_BOX + kk * 2 * 1024) >> 4),
                           bdq + kk * (2 * S::SBO >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin_regs(dk);
    pin_regs(dv);
    pin_regs(pa);
    pin_regs(dq);
    // dq's share: staged (f32, swizzled), then added by the warpgroup's first thread
#pragma unroll
    for (int m = 0; m < BQ / 64; ++m)
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        unsigned char* w = dqs_row0 + (i & 1) * S::DQ_BUF + m * S::DQ_M +
                           (((dt * 2 + (t >> 1)) ^ (g >> DQ_SW)) << 4);
        *reinterpret_cast<float2*>(w) = make_float2(dq[m][dt][0], dq[m][dt][1]);
        *reinterpret_cast<float2*>(w + 8 * S::DQ_RB) = make_float2(dq[m][dt][2], dq[m][dt][3]);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's staging
  }
  if (tid == 0 && mine > 0) {
    reduce_dq(mine - 1);
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }

  if constexpr (QS > 1) {
    // the group's q shares summed in warpgroup order: each warpgroup past the
    // first leaves its sums in its ring (every load landed and was read)
    float* part = reinterpret_cast<float*>(ring) + tid;
    if (wq > 0) {
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[(dt * 4 + e) * 128] = dk[dt][e];
          part[(HD / 2 + dt * 4 + e) * 128] = dv[dt][e];
        }
      part[HD * 128] = dbA;
      part[(HD + 1) * 128] = dbB;
    }
    __syncthreads();
    if (wq > 0) return;
#pragma unroll 1
    for (int w = 1; w < QS; ++w) {
      const float* o = reinterpret_cast<const float*>(ring + w * S::WG_BYTES) + tid;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk[dt][e] += o[(dt * 4 + e) * 128];
          dv[dt][e] += o[(HD / 2 + dt * 4 + e) * 128];
        }
      dbA += o[HD * 128];
      dbB += o[(HD + 1) * 128];
    }
  }

  const float scale = static_cast<float>(a.scale);
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk) + b * a.dk_sb + h * a.dk_sh;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv) + b * a.dv_sb + h * a.dv_sh;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (rA < skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + (long long)rA * a.dk_ss + c) =
          __floats2bfloat162_rn(dk[dt][0] * scale, dk[dt][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + (long long)rA * a.dv_ss + c) =
          __floats2bfloat162_rn(dv[dt][0], dv[dt][1]);
    }
    if (rB < skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + (long long)rB * a.dk_ss + c) =
          __floats2bfloat162_rn(dk[dt][2] * scale, dk[dt][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + (long long)rB * a.dv_ss + c) =
          __floats2bfloat162_rn(dv[dt][2], dv[dt][3]);
    }
  }
  if (a.dbias != nullptr) {
    dbA += __shfl_xor_sync(0xffffffffu, dbA, 1);
    dbA += __shfl_xor_sync(0xffffffffu, dbA, 2);
    dbB += __shfl_xor_sync(0xffffffffu, dbB, 1);
    dbB += __shfl_xor_sync(0xffffffffu, dbB, 2);
    float* db = static_cast<float*>(a.dbias) + bh * skv;
    if (t == 0 && rA < skv) db[rA] = dbA;
    if (t == 0 && rB < skv) db[rB] = dbB;
  }
}

}  // namespace
