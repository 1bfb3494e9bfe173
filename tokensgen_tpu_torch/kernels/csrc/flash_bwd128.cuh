// K5's one-pass attention backward at head dim 128 (`bwd_onepass128_kernel`
// in attention.cu, then `bwd_dq_store_kernel<128>`): flash_bwd.cuh's form at
// 64, with its registers and shared memory re-cut for rows twice as wide. It
// computes what flash_bwd.cuh's header states (p^T, ds^T with the JAX
// kernel's rounding points; dv = p^T g, dk = scale ds^T q, dq = scale ds k,
// dbias = sum over q of ds^T), and replaces FA2's two-pass form there (7
// tile products instead of 5, synchronous loads, mma.sync).
//
// The budget that shapes it: at 128 columns the dk and dv accumulators of a
// warpgroup's 64 keys are m64n128 (64 registers each). Beside them s^T and
// dp^T fit only as m64n64, so the q tiles are 64 rows (not 128 as at 64),
// and dq = ds.K, m64n128 over the block's keys, is split between the two
// warpgroups by d columns (64 each, 32 registers) and run after s^T and dp^T
// are dead. Per block (two warpgroups, 64 keys each, 256 threads):
// * K and V of the block's 128 keys are loaded once by TMA (two boxes of 64
//   columns a row each, 128-byte swizzle) and stay in shared memory; the q
//   tiles (Q, G: 64 rows each, two boxes; lse2 and dsum of their rows by a
//   bulk copy of the caller's [B * H][q tiles][2][64] table) stream through
//   a 2-stage ring, one tile ahead of the one multiplied.
// * Per q tile: s^T = K.Q^T and dp^T = V.G^T (m64n64k16, both operands from
//   shared memory, 8 k-steps over d); per half of the 64 q columns, p^T,
//   ds^T (its row sums into dbias), bf16 p^T packed as the A operand of dv,
//   bf16 ds^T stored to shared memory (keys on the rows, 128-byte swizzle),
//   then dv += p^T.G (m64n128k16, A in registers, G MN-major) and
//   dk += ds^T.Q (m64n128k16, ds^T K-major and Q MN-major from shared
//   memory) issued; after a block barrier, dq[:, 64 w : 64 w + 64] = ds.K
//   for warpgroup w (ds^T MN-major as A, K's box w MN-major as B, 8 k-steps
//   over the block's keys).
// * Each warpgroup's 64 x 64 share of dq is staged f32 (two buffers, one per
//   tile parity) and added by a TMA reduce into the f32 workspace
//   [B, H, Sq, 128]; the next tile's loads and the previous tile's reduce
//   are issued right after the score products, as at 64.
// * Ragged lengths as at 64: keys past Skv score -inf (their rows of K, V
//   read as zeros), q rows past Sq read as zeros with lse2 = +inf and dsum =
//   0 from the caller's padding; their dq is clipped by the tensor map.
// Shared memory: K, V 64 KB, ds^T 16 KB, dq staging 64 KB, the ring 2 x 33
// KB (Q, G and the 512-byte table padded to 1,024 bytes): 216,088 B with the
// alignment slack and the mbarriers; 247 registers, no spill.
// Measured on an H100 at [3, 24, 9,442, 128] with the padded-chunk key bias
// (tools/kernel_ablations.py, two rounds): 15.2 / 15.8 ms against the
// two-pass form's 89.5 / 90.1 (bound 8.308: the five products at the bf16
// tensor-core rate).

#pragma once

#include "flash_bwd.cuh"

namespace {

constexpr int B8_BKV = 128;                                 // keys per block: 64 per warpgroup
constexpr int B8_BQ = 64;                                   // q rows per tile
constexpr int B8_STAGES = 2;                                // q tiles in the ring
constexpr uint32_t B8_QBOX = B8_BQ * 128;                   // 64 rows x 64 bf16 columns: 8 KB
constexpr uint32_t B8_TILE = 2 * B8_QBOX;                   // Q or G tile, [64][128]
constexpr uint32_t B8_AUX = 2 * B8_BQ * 4;                  // lse2 and dsum of a q tile
constexpr uint32_t B8_STAGE = 2 * B8_TILE + 1024;           // Q, G, lse2 | dsum (padded)
constexpr uint32_t B8_KBOX = B8_BKV * 128;                  // 128 keys x 64 bf16 columns: 16 KB
constexpr uint32_t B8_DST = B8_BKV * 128;                   // ds^T: 128 keys x 64 q columns
constexpr uint32_t B8_DQ_BOX = 64 * 128;                    // dq staging: 32 f32 columns x 64 rows
constexpr uint32_t B8_DQ_BUF = 4 * B8_DQ_BOX;               // one tile's staging, both warpgroups

static_assert(B8_AUX <= 1024 && B8_STAGE % 1024 == 0, "each stage's tiles start on 1,024 bytes");

// dynamic shared memory: 1 KB of alignment slack, K, V, ds^T, dq's staging,
// the ring, the stages' mbarriers and K / V's
constexpr int bw128_smem_bytes() {
  return 1024 + static_cast<int>(4 * B8_KBOX + B8_DST + 2 * B8_DQ_BUF + B8_STAGES * B8_STAGE) +
         8 * (B8_STAGES + 1);
}

// d (m64 x n128 f32) += A (m64 x k16 from shared memory, K-major) x B (k16 x
// n128, MN-major from shared memory: two 64-column boxes, LBO apart):
// dk = ds^T.Q with ds^T and Q as stored.
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[16][4], uint64_t adesc,
                                                 uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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

// The block of keys [kv0, kv0 + 128) of head h of batch row b: Q and G by
// their 4-D tensor maps (boxes of 64 columns x 64 rows), K and V by theirs
// (64 columns x 128 rows), lse2 and dsum by bulk copies from ``aux`` ([B * H]
// [q tiles][lse2 | dsum][64], padded with +inf / 0 past Sq); dq's partial
// sums are added by ``dqmap`` (3-D: 128 columns, Sq rows, B * H; boxes of
// 32 x 64, f32) into the workspace, zeroed by the caller.
__device__ __forceinline__ void bwd_onepass128_body(const TGAttnBwdArgs& a,
                                                    const CUtensorMap* qmap,
                                                    const CUtensorMap* gmap,
                                                    const CUtensorMap* kmap,
                                                    const CUtensorMap* vmap,
                                                    const CUtensorMap* dqmap, const float* aux) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the first 1,024-byte boundary, by pointer arithmetic on smem_raw (through
  // an integer every access below would be a generic load or store)
  unsigned char* Ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Vs = Ks + 2 * B8_KBOX;
  unsigned char* dsT = Vs + 2 * B8_KBOX;
  unsigned char* dqs = dsT + B8_DST;  // [tile & 1][warpgroup][column box][64][128 B]
  unsigned char* ring = dqs + 2 * B8_DQ_BUF;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + B8_STAGES * B8_STAGE);
  uint64_t* kvbar = full + B8_STAGES;
  const int kv0 = blockIdx.x * B8_BKV, h = blockIdx.y, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int nq = (sq + B8_BQ - 1) / B8_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * a.h + h;
  const float* aux_bh = aux + bh * nq * (2 * B8_BQ);
  // q tile j into stage j % B8_STAGES (its last use released)
  auto load_tile = [&](int j) {
    const int st = j % B8_STAGES, q0 = j * B8_BQ;
    unsigned char* dst = ring + st * B8_STAGE;
    mbar_expect_tx(full + st, 2 * B8_TILE + B8_AUX);
    tma_load_4d(dst, qmap, full + st, 0, q0, h, b);
    tma_load_4d(dst + B8_QBOX, qmap, full + st, 64, q0, h, b);
    tma_load_4d(dst + B8_TILE, gmap, full + st, 0, q0, h, b);
    tma_load_4d(dst + B8_TILE + B8_QBOX, gmap, full + st, 64, q0, h, b);
    bulk_load(dst + 2 * B8_TILE, aux_bh + (long long)q0 * 2, B8_AUX, full + st);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < B8_STAGES; ++st) mbar_init(full + st, 1);
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kvbar, 4 * B8_KBOX);
    tma_load_4d(Ks, kmap, kvbar, 0, kv0, h, b);
    tma_load_4d(Ks + B8_KBOX, kmap, kvbar, 64, kv0, h, b);
    tma_load_4d(Vs, vmap, kvbar, 0, kv0, h, b);
    tma_load_4d(Vs + B8_KBOX, vmap, kvbar, 64, kv0, h, b);
    for (int j = 0; j < B8_STAGES - 1 && j < nq; ++j) load_tile(j);
  }
  __syncthreads();  // the mbarriers' initialization

  // this thread's two keys (rows of s^T): bias in the log2 domain, -inf past Skv
  const int rA = kv0 + warp * 16 + g, rB = rA + 8;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  const float bA = rA < skv ? (bias ? bias[rA] * LOG2E : 0.f) : -INFINITY;
  const float bB = rB < skv ? (bias ? bias[rB] * LOG2E : 0.f) : -INFINITY;
  const float c1 = static_cast<float>(a.scale) * LOG2E;
  // A of the score products: this warpgroup's 64 rows of K / V, K-major, box 0
  // (k-step kk: box kk / 4, 32 bytes a k-step within it)
  uint64_t kdesc = smem_desc(Ks + wg * 64 * 128, 16, 1024, 1);
  uint64_t vdesc = smem_desc(Vs + wg * 64 * 128, 16, 1024, 1);
  asm volatile("" : "+l"(kdesc), "+l"(vdesc));
  // ds^T's row r (key), q columns c, c + 1: its 4-byte word (the 16-byte
  // chunks of each row swizzled by the row's index mod 8)
  unsigned char* dst_row0 = dsT + (warp * 16 + g) * 128 + t * 4;
  // dq's staging: row r (this warp's q row g of the tile's 64), columns c, c +
  // 1 of the warpgroup's 64 in box c / 32, swizzled likewise
  unsigned char* dqs_wg = dqs + wg * 2 * B8_DQ_BOX;
  unsigned char* dqs_row0 = dqs_wg + ((warp & 3) * 16 + g) * 128 + (t & 1) * 8;
  auto reduce_dq = [&](int jj) {  // tile jj's staged share of dq, added into the workspace
    const unsigned char* src = dqs_wg + (jj & 1) * B8_DQ_BUF;
    tma_reduce_add_3d(dqmap, src, wg * 64, jj * B8_BQ, static_cast<int>(bh));
    tma_reduce_add_3d(dqmap, src + B8_DQ_BOX, wg * 64 + 32, jj * B8_BQ, static_cast<int>(bh));
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };
  float dk[16][4], dv[16][4];
#pragma unroll
  for (int dt = 0; dt < 16; ++dt)
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
    const int st = j % B8_STAGES;
    mbar_wait(full + st, (j / B8_STAGES) & 1);
    const unsigned char* Qt = ring + st * B8_STAGE;
    const unsigned char* Gt = Qt + B8_TILE;
    const float* lse2 = reinterpret_cast<const float*>(Gt + B8_TILE);
    const float* dsm = lse2 + B8_BQ;
    uint64_t qdesc = smem_desc(Qt, 16, 1024, 1), gdesc = smem_desc(Gt, 16, 1024, 1);
    asm volatile("" : "+l"(qdesc), "+l"(gdesc));
    float s[8][4], dp[8][4];
    pin_regs(s);  // the first k-step of each product ignores the accumulator's values
    pin_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)  // s^T = K.Q^T
      wgmma_ss<64>(s, kdesc + (((kk >> 2) * B8_KBOX + (kk & 3) * 32) >> 4),
                   qdesc + (((kk >> 2) * B8_QBOX + (kk & 3) * 32) >> 4), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)  // dp^T = V.G^T
      wgmma_ss<64>(dp, vdesc + (((kk >> 2) * B8_KBOX + (kk & 3) * 32) >> 4),
                   gdesc + (((kk >> 2) * B8_QBOX + (kk & 3) * 32) >> 4), kk > 0);
    wgmma_commit();
    // the next tile's loads and the previous tile's dq reduce, while the products run
    if (threadIdx.x == 0 && j + B8_STAGES - 1 < nq) load_tile(j + B8_STAGES - 1);
    if ((threadIdx.x & 127) == 0 && j > 0) reduce_dq(j - 1);
    wgmma_wait<0>();
    pin_regs(s);
    pin_regs(dp);
    uint32_t pa[4][4];  // bf16 p^T: the A operand of dv
    uint64_t adk = smem_desc(dsT + wg * 64 * 128, 16, 1024, 1);  // K-major rows
    uint64_t bdk = smem_desc(Qt, B8_QBOX, 1024, 1);              // MN-major, two boxes
    uint64_t bdv = smem_desc(Gt, B8_QBOX, 1024, 1);
    asm volatile("" : "+l"(adk), "+l"(bdk), "+l"(bdv));
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // q columns [32 half, 32 half + 32)
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {  // p^T in place
        const int nt = half * 4 + n8;
        const float2 l = *reinterpret_cast<const float2*>(lse2 + nt * 8 + t * 2);
        s[nt][0] = exp2_ftz(fmaf(s[nt][0], c1, bA - l.x));
        s[nt][1] = exp2_ftz(fmaf(s[nt][1], c1, bA - l.y));
        s[nt][2] = exp2_ftz(fmaf(s[nt][2], c1, bB - l.x));
        s[nt][3] = exp2_ftz(fmaf(s[nt][3], c1, bB - l.y));
      }
      uint32_t dsb[4][2];  // bf16 ds^T, for shared memory
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {  // ds^T, its row sums; bf16 p^T and ds^T
        const int nt = half * 4 + n8;
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
      for (int n8 = 0; n8 < 4; ++n8) {
        unsigned char* w = dst_row0 + (((half * 4 + n8) ^ g) << 4);
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
      for (int jj = 0; jj < 2; ++jj) {  // the half's 32 q rows: dv += p^T.G, dk += ds^T.Q
        const int k16 = half * 2 + jj;
        wgmma_rs<128, 1>(dv, pa[k16], bdv + k16 * (2 * 1024 >> 4), 1);
        wgmma_ss_n128_tb(dk, adk + (k16 * 32 >> 4), bdk + k16 * (2 * 1024 >> 4), 1);
      }
      wgmma_commit();
    }
    __syncthreads();  // ds^T of both warpgroups' keys in shared memory
    float dq[8][4];
    uint64_t adq = smem_desc(dsT, B8_DST, 1024, 1);             // MN-major: q contiguous
    uint64_t bdq = smem_desc(Ks + wg * B8_KBOX, B8_KBOX, 1024, 1);  // box wg, MN-major
    asm volatile("" : "+l"(adq), "+l"(bdq));
    pin_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < B8_BKV / 16; ++kk)  // dq[:, 64 wg:] = ds.K over the block's keys
      wgmma_ss_n64<1>(dq, adq + kk * (2 * 1024 >> 4), bdq + kk * (2 * 1024 >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin_regs(dk);
    pin_regs(dv);
    pin_regs(pa);
    pin_regs(dq);
    // dq's share: staged (f32, swizzled), then added by one thread of the warpgroup
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      unsigned char* w = dqs_row0 + (j & 1) * B8_DQ_BUF + (dt >> 2) * B8_DQ_BOX +
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
  for (int dt = 0; dt < 16; ++dt) {
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
