// The split-KV flash-attention forward shared by K3 (vip -> all,
// `smallq_*_kernel`) and K4 (the resampler's [B, H, S, D] attention,
// `bhsd_*_kernel<HD>`) in attention.cu: the keys of one call are cut into
// `splits` contiguous ranges of `split_len` keys (a whole number of kv
// tiles; the last range holds the rest), a block owns splitkv_bm(HD) q rows
// of one (b, h) and one range, and a combine pass merges the ranges'
// partial results.
//
// Why: K4's call has 3 q tiles x 16 heads = 48 blocks of 128 rows for 132
// SMs, each sweeping 281 kv tiles one after another; K3's 384. Split over
// the keys, both fill the card with >= 2 waves of blocks (the split count
// comes from the host, `attention.kv_split_plan`, from the shape alone).
//
// Per block (two warpgroups, f32 softmax in the log2 domain with an exact
// online max, as K1):
// * K / V tiles of splitkv_bn(HD) keys stream through a ring of SK_STAGES
//   stages in dynamic shared memory, loaded by the Tensor Memory
//   Accelerator: one thread issues a tile's boxes (`cp.async.bulk.tensor`,
//   4-D tensor maps over the operands' strides, rows past the tensor read
//   as zeros) and they complete on the stage's mbarrier, SK_STAGES - 1
//   tiles ahead of the one multiplied, one block barrier per tile. Loads by
//   every thread (cp.async, 16 bytes each) throttled the warps that issue
//   them: with them the body ran at half the speed it runs without loads,
//   whatever the depth of the ring.
// * Both products run on wgmma (m64nNk16, bf16 in, f32 accumulators in
//   registers): s = q.k^T with the q fragments in registers and the K tile
//   read by the tensor cores from shared memory (K-major), then o += p.v
//   with p in registers and the V tile from shared memory (MN-major, the
//   transpose flag), the tiles in the TMA's 32 / 64 / 128-byte swizzle
//   (rows of 16 / 32 / 64 bf16; at HD = 128 two boxes of 64 columns).
// * At HD <= 64 a block holds two row blocks of 128 q rows (each warpgroup
//   64 rows of each), so every staged K / V tile serves 256 q rows; at 128
//   one (registers).
// * The q tile is loaded once, scaled (softmax scale * log2 e, or 1 where
//   the caller folded it in), and kept as A fragments in registers.
// * One split: the block writes the normalized output (and the natural-log
//   lse) itself. More: it writes its rows' f32 partials (acc, m, l) to the
//   workspace and `combine_rows` reduces them, in split order with no
//   atomics (the output is the same from run to run):
//     m = max_s m_s,  l = sum_s l_s 2^(m_s - m),
//     out = sum_s acc_s 2^(m_s - m) / l,  lse = (m + log2 l) ln 2.
//   A range whose keys a -1e9 bias masks whole keeps a finite m_s and drops
//   out by its weight.
//
// Workspace (f32), part = (split * B + b) * H + h:
//   acc [splits][B][H][Sq][HD], then (m, l) [splits][B][H][Sq][2].

#pragma once

#include <cuda.h>

#include "flash_fwd.cuh"

namespace {

constexpr int SK_STAGES = 4;   // K / V tiles in the ring
constexpr int SK_NT = 256;     // threads per block: two warpgroups
constexpr int CMB_NT = 256;    // threads per combine block (HD / 8 per row)

// Row blocks of 128 q rows per block: two at HD <= 64, one at 128 (its
// accumulators alone take 64 registers a thread per row block).
__host__ __device__ constexpr int splitkv_row_blocks(int hd) { return hd <= 64 ? 2 : 1; }
__host__ __device__ constexpr int splitkv_bm(int hd) { return 128 * splitkv_row_blocks(hd); }
// Keys per kv tile: the score product is m64 x BN, p.v m64 x HD; the two
// must differ in shape. With both m64n64k16 (HD = 64, 64-key tiles), the
// scores of every tile after the first came out wrong on the H100 (at
// ptxas -O1 too), while any two distinct shapes were right.
__host__ __device__ constexpr int splitkv_bn(int hd) { return hd <= 64 ? 128 : 64; }
// columns of one TMA box (its rows are 32, 64 or 128 bytes: the swizzle span)
__host__ __device__ constexpr int splitkv_box_cols(int hd) { return hd < 64 ? hd : 64; }

// dynamic shared memory of the body: 1 KB of alignment slack (swizzled
// tiles start on 1,024 bytes), the K / V ring, the q tile (padded rows, read
// once into fragments) and the stages' mbarriers
template <int HD>
__host__ __device__ constexpr int splitkv_smem_bytes() {
  return 1024 + static_cast<int>(sizeof(__nv_bfloat16)) *
                    (2 * SK_STAGES * splitkv_bn(HD) * HD + splitkv_bm(HD) * pitch(HD)) +
         8 * SK_STAGES;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x in one instruction (MUFU.EX2; -inf gives 0, denormal results flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// one arrival that also announces ``bytes`` of TMA transactions to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of ``bar`` with the given parity to complete. A load
// that never lands (a bad tensor map) traps after ~2^32 clocks instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) asm volatile("trap;");
  }
}

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into shared
// memory, completing on ``bar``
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers at this point of the program. The compiler takes a wgmma
// for a synchronous instruction: accumulators must not be read before its
// wait (the wgmma in flight writes them behind the compiler's back), A
// fragments must be written before the wgmma.fence that precedes their use
// and must keep their registers until the wait (the wgmma in flight still
// reads them; dead to the compiler after the issue, they would be reused).
template <int N>
__device__ __forceinline__ void pin_regs(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(x[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void pin_regs(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint32_t mode) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(mode) << 62);
}

// d (m64 x N f32, the mma.sync accumulator layout per warp) += a (the m64k16
// A fragment in registers: warp w of the warpgroup holds rows 16w..16w+15
// as mma.sync's m16n8k16 A fragment) x B (k16 x N from shared memory by
// descriptor; TB = 0: K-major, 1: MN-major). scale_d = 0 ignores d's input.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<64, 0>(float (&d)[8][4], const uint32_t (&a)[4],
                                                  uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128, 0>(float (&d)[16][4], const uint32_t (&a)[4],
                                                  uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16, 1>(float (&d)[2][4], const uint32_t (&a)[4],
                                                  uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32, 1>(float (&d)[4][4], const uint32_t (&a)[4],
                                                  uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 1>(float (&d)[8][4], const uint32_t (&a)[4],
                                                  uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128, 1>(float (&d)[16][4], const uint32_t (&a)[4],
                                                  uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The swizzled tile of one matrix (K or V) of BN rows: box b (columns
// [64 b, 64 b + 64) at HD = 128) at byte b * BN * RB, row r at r * RB
// (RB = 2 * box columns) with its 16-byte chunks swizzled within each
// group of 8 rows.
template <int HD>
struct TileGeom {
  static constexpr int BN = splitkv_bn(HD);
  static constexpr uint32_t RB = 2 * splitkv_box_cols(HD);  // bytes per row of a box
  static constexpr uint32_t SBO = 8 * RB;                   // bytes per group of 8 rows
  static constexpr uint32_t BOX = BN * RB;                  // bytes per box
  static constexpr uint32_t MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr uint32_t BYTES = BN * HD * 2;            // bytes per matrix
};

// The products of one kv tile for this warpgroup's 64 q rows of one row
// block, issued asynchronously (the caller commits and waits).
// s = q.k^T: K is B with N = keys, K = d, K-major; k-step kk (16 d) starts
// 32 bytes on within its box.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[splitkv_bn(HD) / 8][4],
                                             const uint32_t (&qa)[HD / 16][4],
                                             const unsigned char* Ks) {
  using G = TileGeom<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = kk * 16 / splitkv_box_cols(HD), in = kk * 16 % splitkv_box_cols(HD);
    wgmma_rs<G::BN, 0>(s, qa[kk], smem_desc(Ks + box * G::BOX + in * 2, 16, G::SBO, G::MODE),
                       kk > 0);
  }
}

// o += p.v: V is B with K = keys, N = d, MN-major (boxes G::BOX apart
// along d); k-step j (16 keys) starts two groups of 8 rows on.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 8][4],
                                         const uint32_t (&pa)[splitkv_bn(HD) / 16][4],
                                         const unsigned char* Vs) {
  using G = TileGeom<HD>;
  static_assert(G::BN != HD, "the two products must differ in wgmma shape");
#pragma unroll
  for (int j = 0; j < G::BN / 16; ++j)
    wgmma_rs<HD, 1>(o, pa[j], smem_desc(Vs + j * 2 * G::SBO, G::BOX, G::SBO, G::MODE), 1);
}

// The softmax half of one kv tile for this thread's two rows, from the
// tile's finished scores: the key bias and the range's end mask, the new
// row maxima, p = exp2(s - m) in place and its row sums; returns the
// factors alpha = exp2(m_old - m_new) by which the earlier acc and l shrink.
template <int BN>
__device__ __forceinline__ float2 softmax_tile(float (&s)[BN / 8][4], int kv0, int kvend,
                                               const float* bias, float (&m)[2], float (&ls)[2]) {
  const int t = threadIdx.x & 3;
  if (bias != nullptr || kv0 + BN > kvend) {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = kv0 + nt * 8 + t * 2 + (i & 1);
        if (j >= kvend)
          s[nt][i] = -INFINITY;
        else if (bias != nullptr)
          s[nt][i] += __ldg(bias + j) * LOG2E;
      }
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
  const float base0 = m0 == -INFINITY ? 0.f : m0;
  const float base1 = m1 == -INFINITY ? 0.f : m1;
  const float2 alpha = make_float2(exp2_ftz(m[0] - base0), exp2_ftz(m[1] - base1));
  m[0] = m0;
  m[1] = m1;
  ls[0] = ls[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    s[nt][0] = exp2_ftz(s[nt][0] - base0);
    s[nt][1] = exp2_ftz(s[nt][1] - base0);
    s[nt][2] = exp2_ftz(s[nt][2] - base1);
    s[nt][3] = exp2_ftz(s[nt][3] - base1);
    ls[0] += s[nt][0] + s[nt][1];
    ls[1] += s[nt][2] + s[nt][3];
  }
  return alpha;
}

// This warp's 16 rows' unnormalized partials: acc at ws_acc[row][HD], (m,
// l) at ws_ml[row][2] (both already at this block's (split, b, h)).
template <int HD>
__device__ __forceinline__ void store_partial(const AccT<HD>& acc, float* ws_acc, float* ws_ml,
                                              int q0, int sq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float l0 = acc.l[0], l1 = acc.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < sq)
      *reinterpret_cast<float2*>(ws_acc + (long long)r0 * HD + c) =
          make_float2(acc.o[dt][0], acc.o[dt][1]);
    if (r1 < sq)
      *reinterpret_cast<float2*>(ws_acc + (long long)r1 * HD + c) =
          make_float2(acc.o[dt][2], acc.o[dt][3]);
  }
  if (t == 0) {
    if (r0 < sq) *reinterpret_cast<float2*>(ws_ml + 2LL * r0) = make_float2(acc.m[0], l0);
    if (r1 < sq) *reinterpret_cast<float2*>(ws_ml + 2LL * r1) = make_float2(acc.m[1], l1);
  }
}

// One kv tile for this warpgroup's row blocks: per row block, its score
// product, the softmax, acc rescaled and its p.v issued; the next row
// block's scores run while p.v does. All done at return.
template <int HD, int RB, int R>
__device__ __forceinline__ void splitkv_tile(const uint32_t (&qa)[RB][HD / 16][4],
                                             AccT<HD> (&acc)[RB], const unsigned char* Ks,
                                             const unsigned char* Vs, int kv0, int kvend,
                                             const float* bias) {
  constexpr int BN = splitkv_bn(HD);
  uint32_t pa[BN / 16][4];  // bf16 p: the A operand of a row block's p.v
#pragma unroll
  for (int rb = 0; rb < R; ++rb) {
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    pin_regs(s);
    wgmma_fence();
    issue_scores<HD>(s, qa[rb], Ks);
    wgmma_commit();
    wgmma_wait<0>();  // the scores, and the previous row block's p.v: pa is free
    pin_regs(s);
    if (rb > 0) {
      pin_regs(acc[rb - 1].o);
      pin_regs(pa);
    }
    float ls[2];
    const float2 alpha = softmax_tile<BN>(s, kv0, kvend, bias, acc[rb].m, ls);
    acc[rb].l[0] = acc[rb].l[0] * alpha.x + ls[0];
    acc[rb].l[1] = acc[rb].l[1] * alpha.y + ls[1];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[rb].o[dt][0] *= alpha.x;
      acc[rb].o[dt][1] *= alpha.x;
      acc[rb].o[dt][2] *= alpha.y;
      acc[rb].o[dt][3] *= alpha.y;
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
    }
    pin_regs(acc[rb].o);
    pin_regs(pa);
    wgmma_fence();
    issue_pv<HD>(acc[rb].o, pa, Vs);
    wgmma_commit();
  }
  wgmma_wait<0>();
  pin_regs(acc[R - 1].o);
  pin_regs(pa);
}

// The block of q rows [q0, q0 + splitkv_bm(HD)) of head h of batch row b
// against the keys of range ``split``: row block rb holds rows q0 + 128 rb
// + [0, 128), warpgroup w rows 64 w + [0, 64) of each. ``a`` carries no
// prologue: q is scaled by a.qscale on load; K and V come by ``kmap`` and
// ``vmap`` (4-D: columns, rows, heads, batch rows; boxes of
// splitkv_box_cols(HD) x BN).
template <int HD>
__device__ __forceinline__ void splitkv_body(const TGAttnArgs& a, const CUtensorMap* kmap,
                                             const CUtensorMap* vmap, int h, int b, int q0,
                                             int split, int split_len, int splits, float* ws) {
  using G = TileGeom<HD>;
  constexpr int RB = splitkv_row_blocks(HD);
  constexpr int BN = G::BN;
  constexpr int ld = pitch(HD);
  constexpr int NBOX = HD / splitkv_box_cols(HD);
  constexpr uint32_t STAGE = 2 * G::BYTES;  // one K tile and one V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(ring + SK_STAGES * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(Qs + splitkv_bm(HD) * ld);
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int kvbeg = split * split_len, kvend = min(skv, kvbeg + split_len);
  const int ntiles = (kvend - kvbeg + BN - 1) / BN;
  const bool full_rows = q0 + (RB - 1) * 128 < sq;  // the last row block holds rows
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;

  // thread 0 issues every load: tile t into stage t % SK_STAGES
  auto load_tile = [&](int t) {
    unsigned char* st = ring + (t % SK_STAGES) * STAGE;
    uint64_t* bar = full + t % SK_STAGES;
    mbar_expect_tx(bar, STAGE);
#pragma unroll
    for (int i = 0; i < NBOX; ++i) {
      tma_load_4d(st + i * G::BOX, kmap, bar, i * splitkv_box_cols(HD), kvbeg + t * BN, h, b);
      tma_load_4d(st + G::BYTES + i * G::BOX, vmap, bar, i * splitkv_box_cols(HD),
                  kvbeg + t * BN, h, b);
    }
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < SK_STAGES; ++st) mbar_init(full + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < SK_STAGES - 1; ++t)
      if (t < ntiles) load_tile(t);
  }
  load_rows<false, HD, SK_NT>(Qs, ld, q, a.q_ss, q0, splitkv_bm(HD), sq, Side{}, b,
                              static_cast<float>(a.qscale), 0.f);
  __syncthreads();  // the q tile and the mbarriers' initialization
  uint32_t qa[RB][HD / 16][4];
  AccT<HD> acc[RB];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    load_q_frags<HD>(qa[rb], Qs + rb * 128 * ld);
    init_acc(acc[rb]);
  }
  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) __syncthreads();  // tile j - 1's stage is consumed by every warpgroup
    if (threadIdx.x == 0 && j + SK_STAGES - 1 < ntiles) load_tile(j + SK_STAGES - 1);
    mbar_wait(full + j % SK_STAGES, (j / SK_STAGES) & 1);
    const unsigned char* Ks = ring + (j % SK_STAGES) * STAGE;
    const int kv0 = kvbeg + j * BN;
    if (RB == 1 || full_rows)
      splitkv_tile<HD, RB, RB>(qa, acc, Ks, Ks + G::BYTES, kv0, kvend, bias);
    else
      splitkv_tile<HD, RB, 1>(qa, acc, Ks, Ks + G::BYTES, kv0, kvend, bias);
  }
  const long long part = ((long long)split * a.b + b) * a.h + h;
  const long long rows = (long long)splits * a.b * a.h * sq;
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    if (rb > 0 && !full_rows) break;
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

// The combine over the ``splits`` partials of the workspace: one thread per
// 8 columns of one output row (B * H * Sq rows, HD / 8 threads each).
template <int HD>
__device__ __forceinline__ void combine_rows(const TGAttnArgs& a, int splits, const float* ws) {
  constexpr int CPR = HD / 8;
  const long long rows = a.b * a.h * a.sq;  // per split
  const long long idx = (long long)blockIdx.x * CMB_NT + threadIdx.x;
  const long long row = idx / CPR;  // (b * H + h) * Sq + r
  if (row >= rows) return;
  const int c0 = static_cast<int>(idx % CPR) * 8;
  const int r = static_cast<int>(row % a.sq);
  const long long bh = row / a.sq;
  const int b = static_cast<int>(bh / a.h), h = static_cast<int>(bh % a.h);
  const float* ml = ws + splits * rows * HD;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[2 * (s * rows + row)]);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 ml_s = *reinterpret_cast<const float2*>(ml + 2 * (s * rows + row));
    const float w = ml_s.x == -INFINITY ? 0.f : exp2f(ml_s.x - m);
    l += ml_s.y * w;
    const float4* p = reinterpret_cast<const float4*>(ws + (s * rows + row) * HD + c0);
    const float4 x0 = p[0], x1 = p[1];
    acc[0] += w * x0.x; acc[1] += w * x0.y; acc[2] += w * x0.z; acc[3] += w * x0.w;
    acc[4] += w * x1.x; acc[5] += w * x1.y; acc[6] += w * x1.z; acc[7] += w * x1.w;
  }
  uint4 out;
  out.x = pack_bf16(acc[0] / l, acc[1] / l);
  out.y = pack_bf16(acc[2] / l, acc[3] / l);
  out.z = pack_bf16(acc[4] / l, acc[5] / l);
  out.w = pack_bf16(acc[6] / l, acc[7] / l);
  *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh +
                            (long long)r * a.o_ss + c0) = out;
  if (a.lse != nullptr && c0 == 0) static_cast<float*>(a.lse)[row] = (m + log2f(l)) * LN2;
}

}  // namespace
