// K5's one-pass attention backward at head dim 64 (`bwd_onepass_kernel` in
// attention.cu, with `bwd_dq_store_kernel<64>` after it), on flash_splitkv.cuh's
// and flash_ws.cuh's machinery: TMA tiles in the 128-byte swizzle, mbarriers,
// every product on wgmma. It replaced FA2's two-pass form at 64;
// flash_bwd128.cuh holds its form at 128, flash_bwd_small.cuh at 16 and 32.
//
// What it computes, from the forward's natural-log lse (in the log2 domain:
// lse2 = lse log2 e, c = scale log2 e, bias2 = bias log2 e):
//
//   p^T  = exp2(c k.q^T + bias2 - lse2)      f32, rounded to bf16 for dv
//   ds^T = p^T * (v.g^T - dsum)              f32, rounded to bf16 for dk, dq
//   dv = p^T g,  dk = scale ds^T q,  dq = scale ds k,  dbias = sum_q ds
//
// the rounding points of the JAX kernel (`_packed_bwd_kernel`), which works in
// this transposed form too (keys on the rows).
//
// Why: the two-pass form made 7 tile products where one pass makes 5 (s and
// dp in both passes), every tile loaded by every thread with a block barrier
// per tile and no load overlapping a product, on mma.sync: 10% of its bound
// (the products at the bf16 tensor-core rate). The JAX kernel keeps the q
// side in VMEM and carries dq from grid step to grid step; Hopper blocks run
// in no order and share nothing, so here a block owns 128 keys of one (b, h)
// and dq crosses blocks through an f32 workspace.
//
// Per block (two warpgroups, 64 keys each):
// * K and V of the block's keys are loaded once by TMA and stay in shared
//   memory; the q tiles (Q, G: 128 rows each; lse2 and dsum of their rows)
//   stream through a ring of BW_STAGES stages, loaded by TMA (lse2 and dsum
//   by a bulk copy of the caller's padded [B * H][q tiles][2][128] table),
//   BW_STAGES - 1 tiles ahead of the one multiplied.
// * Per q tile: s^T = K.Q^T and dp^T = V.G^T (m64n128k16, both operands
//   from shared memory); then, per 8 q columns, p^T, ds^T, the row sums
//   of ds^T, bf16 p^T packed as the A operand of dv and bf16 ds^T written
//   to shared memory (in the 128-byte swizzle, keys on the rows), in three
//   passes per half of the q columns (p^T; ds^T and the packing; the
//   stores), so that no store stands between a load of lse2 / dsum and the
//   next one. After each half, that half's dv += p^T.G (m64n64k16, A in
//   registers, the tile MN-major) and dk += ds^T.Q (the warpgroup's own
//   rows of ds^T, K-major, as A) are issued, so that the first half's
//   products run during the second half's exponentials; the block then meets at a
//   barrier for dq = ds.K (ds^T MN-major as A, K MN-major as B; 64 q rows
//   per warpgroup over the block's 128 keys).
// * The next tile's loads and the previous tile's dq reduce are issued
//   right after the score products, whose time hides their issue (at the
//   tile's start and end they held up the warp that issues them, and the
//   tile's barriers passed that on to the whole block).
// * dq's share goes to the f32 workspace [B, H, Sq, 64] by a TMA reduce
//   (`cp.reduce.async.bulk.tensor ... add`, rows past Sq clipped) of each
//   warpgroup's 64 x 64 tile, staged in shared memory in the 128-byte
//   swizzle, two tiles' staging in turn so that a reduce has the next
//   tile's products to read its staging in: the blocks' adds land in an
//   order that differs from run to run.
// * dk, dv (bf16) and dbias (f32, per (b, h, key); the caller sums the
//   heads) are written by the block that owns the keys; `bwd_dq_store_kernel`
//   then writes dq = scale * workspace in bf16.
// * Ragged lengths: keys past Skv score -inf (their rows of K, V read as
//   zeros); q rows past Sq read as zeros with lse2 = +inf and dsum = 0 in
//   the caller's padding, so p = ds = 0 there, and their dq is not added.
// Registers: dk, dv (32 each), s^T and dp^T (64 each) live at once; the
// score, dk and dq products read their A operands (K, V, ds^T) from shared
// memory (SS form), and the descriptors that do not change from tile to
// tile are made opaque, so that the compiler adds their offsets at each use
// instead of holding them all in registers.
// Measured on an H100 at the joint training shape against copies with one
// choice undone (tools/kernel_ablations.py, two rounds): 40.8 / 43.8 ms;
// the shared base through an integer 44.5 / 45.2; p, ds and the ds^T
// stores in one loop 44.8 / 45.6; the loads and the reduce issued at the
// tile's start and end 46.8 / 44.9; float2 atomics (`red.global.add`) for
// dq instead of the staging and reduce 50.3 / 49.7. Its clock64() stamps
// of one q tile (4,975 clocks): the score products with the issues 1,120,
// each half ~1,100, dq 750, its staging 580. Tried and not kept: dk from
// registers (spilled), one staging buffer, sweeps started on different q
// tiles, the loads issued by another warp, `prefetch.tensormap`.

#pragma once

#include "flash_ws.cuh"

// Backward argument block shared with the Python wrapper (every field 8
// bytes). lse and dsum: f32 [B, H, Sq]; bias: f32 [B, Skv] or null; dbias:
// f32 [B, H, Skv] out or null. Strides in elements; scale is the natural
// softmax scale of the scores (1 for prologued operands).
struct TGAttnBwdArgs {
  const void* q; const void* k; const void* v; const void* g;
  const void* lse; const void* dsum; const void* bias;
  void* dq; void* dk; void* dv; void* dbias;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  long long b, h, sq, skv;
  double scale;
};

namespace {

constexpr int BW_NT = 256;       // two warpgroups
constexpr int BW_BKV = 128;      // keys per block: 64 per warpgroup
constexpr int BW_BQ = 128;       // q rows per tile of the sweep
constexpr int BW_STAGES = 2;     // q tiles in the ring
constexpr uint32_t BW_TILE = BW_BQ * 64 * 2;               // a bf16 [128][64] tile, 16 KB
constexpr uint32_t BW_AUX = 2 * BW_BQ * 4;                 // lse2 and dsum of a q tile
constexpr uint32_t BW_STAGE = 2 * BW_TILE + BW_AUX;        // Q, G, lse2 | dsum
constexpr uint32_t BW_DST_BOX = BW_BKV * 128;              // ds^T: 64 q columns of 128 keys
constexpr uint32_t BW_DQ_BOX = 64 * 128;                   // dq staging: 32 f32 columns of 64 rows

static_assert(BW_BKV == splitkv_bn(64) && BW_BQ == splitkv_bn(64),
              "the K, V, Q and G tiles take TileGeom<64>'s boxes");
static_assert(BW_STAGE % 1024 == 0, "each stage's tiles start on 1,024 bytes");

// dynamic shared memory: 1 KB of alignment slack, K, V, ds^T (two boxes of
// 64 q columns), dq's staging (two buffers of two boxes per warpgroup), the
// ring, the stages' mbarriers and K / V's
constexpr int bw_smem_bytes() {
  return 1024 +
         static_cast<int>(2 * BW_TILE + 2 * BW_DST_BOX + 8 * BW_DQ_BOX + BW_STAGES * BW_STAGE) +
         8 * (BW_STAGES + 1);
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// d (m64 x n64 f32) += A (m64 x k16 from shared memory: TA = 0 K-major, 1
// MN-major) x B (k16 x n64, MN-major from shared memory): dk = ds^T.Q (TA 0)
// and dq = ds.K (TA 1) with ds^T, Q and K as stored.
template <int TA>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t adesc, uint64_t bdesc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TA));
}

// one box of a 3-D tensor map at (c0, c1, c2) added (f32) from shared memory
// into global memory, in the issuing thread's bulk async-group
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The block of keys [kv0, kv0 + 128) of head h of batch row b: Q, G, K and
// V come by their 4-D tensor maps (boxes of 64 columns x 128 rows), lse2 and
// dsum by bulk copies from ``aux`` ([B * H][q tiles][lse2 | dsum][128],
// padded with +inf / 0 past Sq); dq's partial sums are added by ``dqmap``
// (3-D: 64 columns, Sq rows, B * H; boxes of 32 x 64, f32) into the
// workspace, zeroed by the caller.
__device__ __forceinline__ void bwd_onepass_body(const TGAttnBwdArgs& a, const CUtensorMap* qmap,
                                                 const CUtensorMap* gmap,
                                                 const CUtensorMap* kmap,
                                                 const CUtensorMap* vmap,
                                                 const CUtensorMap* dqmap, const float* aux) {
  using G = TileGeom<64>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the first 1,024-byte boundary (the swizzled tiles' alignment), by pointer
  // arithmetic on smem_raw: through an integer the compiler loses the state
  // space and makes every access below a generic load or store
  unsigned char* Ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Vs = Ks + BW_TILE;
  unsigned char* dsT = Vs + BW_TILE;
  unsigned char* dqs = dsT + 2 * BW_DST_BOX;  // [tile & 1][warpgroup][column box][64][128 B]
  unsigned char* ring = dqs + 8 * BW_DQ_BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + BW_STAGES * BW_STAGE);
  uint64_t* kvbar = full + BW_STAGES;
  const int kv0 = blockIdx.x * BW_BKV, h = blockIdx.y, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int nq = (sq + BW_BQ - 1) / BW_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * a.h + h;
  const float* aux_bh = aux + bh * nq * (2 * BW_BQ);
  // q tile j into stage j % BW_STAGES (its last use released)
  auto load_tile = [&](int j) {
    const int st = j % BW_STAGES, q0 = j * BW_BQ;
    unsigned char* dst = ring + st * BW_STAGE;
    mbar_expect_tx(full + st, BW_STAGE);
    tma_load_4d(dst, qmap, full + st, 0, q0, h, b);
    tma_load_4d(dst + BW_TILE, gmap, full + st, 0, q0, h, b);
    bulk_load(dst + 2 * BW_TILE, aux_bh + (long long)q0 * 2, BW_AUX, full + st);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < BW_STAGES; ++st) mbar_init(full + st, 1);
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kvbar, 2 * BW_TILE);
    tma_load_4d(Ks, kmap, kvbar, 0, kv0, h, b);
    tma_load_4d(Vs, vmap, kvbar, 0, kv0, h, b);
    for (int j = 0; j < BW_STAGES - 1 && j < nq; ++j) load_tile(j);
  }
  __syncthreads();  // the mbarriers' initialization

  // this thread's two keys (rows of s^T): bias in the log2 domain, -inf past Skv
  const int rA = kv0 + warp * 16 + g, rB = rA + 8;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  const float bA = rA < skv ? (bias ? bias[rA] * LOG2E : 0.f) : -INFINITY;
  const float bB = rB < skv ? (bias ? bias[rB] * LOG2E : 0.f) : -INFINITY;
  const float c1 = static_cast<float>(a.scale) * LOG2E;
  // A of the score products: this warpgroup's 64 rows of K / V, K-major
  const uint64_t kdesc = smem_desc(Ks + wg * 64 * G::RB, 16, G::SBO, G::MODE);
  const uint64_t vdesc = smem_desc(Vs + wg * 64 * G::RB, 16, G::SBO, G::MODE);
  // ds^T's row r (key), q columns c, c + 1: its 4-byte word in box c / 64 (the
  // 16-byte chunks of each row swizzled by the row's index mod 8)
  unsigned char* dst_row0 = dsT + (warp * 16 + g) * 128 + t * 4;
  // dq's staging: row r (this warp's q row g of the warpgroup's 64), columns
  // c, c + 1 in box c / 32, swizzled likewise
  unsigned char* dqs_wg = dqs + wg * 2 * BW_DQ_BOX;
  unsigned char* dqs_row0 = dqs_wg + ((warp & 3) * 16 + g) * 128 + (t & 1) * 8;
  constexpr uint32_t DQ_BUF = 4 * BW_DQ_BOX;  // one tile's staging, both warpgroups
  auto reduce_dq = [&](int jj) {  // tile jj's staged share of dq, added into the workspace
    const int q0 = jj * BW_BQ + wg * 64;
    const unsigned char* src = dqs_wg + (jj & 1) * DQ_BUF;
    tma_reduce_add_3d(dqmap, src, 0, q0, static_cast<int>(bh));
    tma_reduce_add_3d(dqmap, src + BW_DQ_BOX, 32, q0, static_cast<int>(bh));
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[dt][i] = dv[dt][i] = 0.f;
  float dbA = 0.f, dbB = 0.f;
  mbar_wait(kvbar, 0);

  for (int j = 0; j < nq; ++j) {
    if (j > 0) {
      // tile j - 2's dq staging read by its reduce (issued in tile j - 1; this
      // tile writes that buffer again), tile j - 1's stage and ds^T consumed
      // by both warpgroups
      if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncthreads();
    }
    const int st = j % BW_STAGES;
    mbar_wait(full + st, (j / BW_STAGES) & 1);
    const unsigned char* Qt = ring + st * BW_STAGE;
    const unsigned char* Gt = Qt + BW_TILE;
    const float* lse2 = reinterpret_cast<const float*>(Gt + BW_TILE);
    const float* dsm = lse2 + BW_BQ;
    float s[16][4], dp[16][4];
    pin_regs(s);  // the first k-step of each product ignores the accumulator's values
    pin_regs(dp);
    wgmma_fence();
    issue_scores_ss<64>(s, kdesc, Qt);  // s^T = K.Q^T
    issue_scores_ss<64>(dp, vdesc, Gt);  // dp^T = V.G^T
    wgmma_commit();
    // the next tile's loads and the previous tile's dq reduce, while the products run
    if (threadIdx.x == 0 && j + BW_STAGES - 1 < nq) load_tile(j + BW_STAGES - 1);
    if ((threadIdx.x & 127) == 0 && j > 0) reduce_dq(j - 1);
    wgmma_wait<0>();
    pin_regs(s);
    pin_regs(dp);
    uint32_t pa[8][4];  // bf16 p^T: the A operand of dv
    uint64_t adk = smem_desc(dsT + wg * 64 * G::RB, 16, G::SBO, G::MODE);  // K-major rows
    uint64_t bdk = smem_desc(Qt, G::BOX, G::SBO, G::MODE);
    asm volatile("" : "+l"(adk), "+l"(bdk));
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // q columns [64 half, 64 half + 64)
#pragma unroll
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
      // this half's ds^T rows (this warpgroup's keys) are read by the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      pin_regs(dv);
      pin_regs(dk);
      pin_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // the half's 64 q rows: dv += p^T.G, dk += ds^T.Q
        const int k16 = half * 4 + jj;
        wgmma_rs<64, 1>(dv, pa[k16], smem_desc(Gt + k16 * 2 * G::SBO, G::BOX, G::SBO, G::MODE),
                        1);
        wgmma_ss_n64<0>(dk, adk + ((half * BW_DST_BOX + jj * 32) >> 4),
                        bdk + k16 * (2 * G::SBO >> 4), 1);
      }
      wgmma_commit();
    }
    __syncthreads();  // ds^T of both warpgroups' keys in shared memory
    float dq[8][4];
    uint64_t adq = smem_desc(dsT + wg * BW_DST_BOX, BW_DST_BOX, G::SBO, G::MODE);  // MN-major
    uint64_t bdq = smem_desc(Ks, G::BOX, G::SBO, G::MODE);
    asm volatile("" : "+l"(adq), "+l"(bdq));
    pin_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BW_BKV / 16; ++kk)  // dq = ds.K over the block's keys
      wgmma_ss_n64<1>(dq, adq + kk * (2 * G::SBO >> 4), bdq + kk * (2 * G::SBO >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin_regs(dk);
    pin_regs(dv);
    pin_regs(pa);
    pin_regs(dq);
    // dq's share: staged (f32, swizzled), then added by one thread of the warpgroup
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      unsigned char* w = dqs_row0 + (j & 1) * DQ_BUF + (dt >> 2) * BW_DQ_BOX +
                         ((((dt & 3) * 2 + (t >> 1)) ^ g) << 4);
      *reinterpret_cast<float2*>(w) = make_float2(dq[dt][0], dq[dt][1]);
      *reinterpret_cast<float2*>(w + 8 * 128) = make_float2(dq[dt][2], dq[dt][3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's staging
  }
  if ((threadIdx.x & 127) == 0) {
    reduce_dq(nq - 1);
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }

  const float scale = static_cast<float>(a.scale);
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk) + b * a.dk_sb + h * a.dk_sh;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv) + b * a.dv_sb + h * a.dv_sh;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
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

// dq = scale * the workspace [B, H, Sq, HD], in bf16 at dq's strides: one
// thread per 8 columns of a row (B * H * Sq * HD / 8 threads)
template <int HD>
__device__ __forceinline__ void bwd_dq_store(const TGAttnBwdArgs& a, const float* dqws) {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128, "K5's head dims");
  constexpr int SH = HD == 16 ? 1 : HD == 32 ? 2 : HD == 64 ? 3 : 4;  // log2 of the threads a row
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx >> SH;  // (b * H + h) * Sq + r
  if (row >= a.b * a.h * a.sq) return;
  const int c0 = static_cast<int>(idx & ((1 << SH) - 1)) * 8;
  const int r = static_cast<int>(row % a.sq);
  const long long bh = row / a.sq;
  const int b = static_cast<int>(bh / a.h), h = static_cast<int>(bh % a.h);
  const float4* p = reinterpret_cast<const float4*>(dqws + row * HD + c0);
  const float4 x0 = p[0], x1 = p[1];
  const float s = static_cast<float>(a.scale);
  uint4 out;
  out.x = pack_bf16(x0.x * s, x0.y * s);
  out.y = pack_bf16(x0.z * s, x0.w * s);
  out.z = pack_bf16(x1.x * s, x1.y * s);
  out.w = pack_bf16(x1.z * s, x1.w * s);
  *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.dq) + b * a.dq_sb + h * a.dq_sh +
                            (long long)r * a.dq_ss + c0) = out;
}

}  // namespace
