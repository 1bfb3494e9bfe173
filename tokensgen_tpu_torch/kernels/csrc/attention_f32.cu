// K4 on float32 operands: plain [B, H, S, head_dim] attention in float32 for
// Hopper (sm_90a), the body `flash_attention_bhsd` takes for float32 tensors
// (the DINOv2 image encoder hands its float32 q / k / v to the TPU's
// `_flash_kernel`, tokensgen_tpu/kernels/attention.py:54, through
// `flash_attention`). The bfloat16 body stays in attention.cu.
//
//   tg_attention_bhsd_f32            bhsd_f32_kernel<HD>, head_dim 16, 32 or 64
//   tg_attention_bhsd_f32_geometry   a block's threads, shared memory and blocks per SM
//
// What it computes: softmax(scale * q . k^T + key_bias) . v per (b, h) with
// float32 accuracy, both products on the tensor cores by a 3xTF32 split:
// each operand x is hi + lo with hi = tf32(x) and lo = tf32(x - hi) (rounded
// to nearest, ties away, as cvt.rna; x - hi - lo is under 2^-22 |x|), and
// each product is hi.lo + lo.hi + hi.hi accumulated in f32, small terms
// first (the lo.lo term, ~2^-22 of the product, is dropped). One TF32 pass
// keeps ~3 decimal digits, far outside the float32 bounds the callers hold
// it to; bf16 keeps fewer.
//
// Bound: at DINOv2-large's [49, 16, 257, 64] the two products are 13.25
// GFLOP: 0.198 ms as FMAs on the CUDA cores (67 TFLOP/s), 0.080 ms as three
// TF32 passes on the tensor cores (495 TFLOP/s); the bytes take 0.062 ms.
//
// Design (one warpgroup, 128 threads, per 64 q rows of one (b, h)):
// * q, pre-scaled by scale * log2 e, is split once into hi / lo A fragments
//   in registers. Both products are wgmma m64nNk8 .tf32 with A from
//   registers and B from shared memory (K-major, 32-byte swizzle: one k-step
//   of 8 values is one 32-byte row).
// * K / V tiles of F32_BN keys come in raw by TMA (4-D tensor maps over the
//   operands' strides; rows past Skv read as zeros), two tiles ahead,
//   completing on an mbarrier a stage.
// * Staging: the block reads each raw tile once and writes K_hi / K_lo
//   (keys x d, K-major for s = q.k^T) and V_hi^T / V_lo^T (d x keys, K-major
//   for o += p.v: TF32 wgmma takes no transposed B) into a second ring of
//   two stages, with the tile's key bias (times log2 e; -inf past Skv). The
//   next tile's K is staged while the tensor cores compute this tile's
//   scores, its V while they compute p.v.
// * p stays in registers: the score accumulator of keys (8j + 2t, 8j + 2t +
//   1) becomes the A fragment of k-step j with its columns (t, t + 4), so
//   V^T's k-step j holds keys 8j + {0, 2, 4, 6, 1, 3, 5, 7}: the permutation
//   rides along with the transpose.
// * Online softmax in f32 in the exp2 domain, as the TPU kernel. Each tile's
//   p.v goes to a fresh accumulator, added to the running output in
//   registers (the tensor cores round their accumulation toward zero: a
//   chain over 2,053 keys drifted past the bounds). A last tile of 1 key
//   (DINOv2's 257 = 8 x 32 + 1) runs as a whole one: as an n8 product it
//   was no faster.
// * Ragged lengths are masked from the lengths: q rows past Sq are computed
//   on zeros and not stored; keys past Skv score -inf. No padded copies. A
//   last q tile of 1 row (DINOv2's 257 = 4 x 64 + 1) costs a whole block.
//
// kernel_ablations.py builds copies with one of the F32_* switches below
// flipped, to time each choice against its removal.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define F32_TERMS 3       // products a tile pair: 3 (the split) or 1 (hi.hi: one TF32 pass)
#define F32_WARP_SPLIT 0  // 1: no staging; each warp splits its own K / V fragments (mma.sync)

// Every field 8 bytes (mirrored by attention.py's _F32Args). Strides in
// elements; the head dim is contiguous and each row 16-byte aligned.
struct TGF32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  const float* bias;  // f32 [B, Skv] or null
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  long long b, h, sq, skv;
  double qscale;  // softmax scale * log2 e
};

namespace {

constexpr int F32_BM = 64;     // q rows a block: one warpgroup's wgmma M
constexpr int F32_BN = 32;     // keys a tile
constexpr int F32_NT = 128;    // threads: one warpgroup
constexpr int F32_STAGES = 2;  // raw tiles in flight, and split tiles (one staged, one used)
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory of one block (byte offsets from a 1024-aligned
// base). Split stage s holds K_hi, K_lo, V_hi^T, V_lo^T, each SPLIT bytes
// (a multiple of 2048: the swizzle's 256-byte groups stay aligned). A raw
// K or V tile is as TMA writes it: boxes of RB-byte rows (HD floats, at most
// 32) in the swizzle of their width, so that a warp's reads of a column of
// 8 rows or of a row's 8 chunks hit 8 distinct 16-byte bank groups.
template <int HD>
struct F32Geom {
  static constexpr int RB = (HD < 32 ? HD : 32) * 4;                       // bytes a box row
  static constexpr uint32_t SPLIT = F32_WARP_SPLIT ? 0 : F32_BN * HD * 4;  // one split matrix
  static constexpr uint32_t RAWTILE = F32_BN * HD * 4;                     // one raw K or V tile
  static constexpr uint32_t RK = F32_STAGES * 4 * SPLIT;        // raw stage s: K, then V
  static constexpr uint32_t BS = RK + F32_STAGES * 2 * RAWTILE;  // key bias of stage s
  static constexpr uint32_t BAR = BS + F32_STAGES * F32_BN * 4;  // one mbarrier a raw stage
  static constexpr uint32_t BYTES = BAR + 8 * F32_STAGES + 1024;  // + the base's alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// one arrival that also announces ``bytes`` of copies to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of ``bar`` with the given parity to complete; a copy
// that never lands traps after ~2^32 clocks instead of hanging the card.
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

// Byte offset of element (row r, column d) in a raw tile of F32_BN rows:
// box d / 32, its RB-byte row r, 16-byte chunk c in the swizzle of RB bytes
// (address bits [4, 4 + log2(RB / 16)) ^= bits [7, ...)).
template <int HD>
__device__ __forceinline__ uint32_t raw_off(int r, int d) {
  constexpr int RB = F32Geom<HD>::RB;
  const int box = d * 4 / RB, c = d * 4 % RB / 16;
  return box * F32_BN * RB + r * RB + ((c ^ ((r * RB >> 7) & (RB / 16 - 1))) << 4) + d % 4 * 4;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins registers at this point of the program: the compiler takes a wgmma
// for a synchronous instruction, so accumulators are pinned after its wait
// (not read early) and A fragments before its issue and after its wait
// (their registers not reused while it still reads them)
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

// Shared-memory matrix descriptor of a K-major tile of 32-byte rows in the
// 32-byte swizzle (mode 3): groups of 8 rows 256 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{256 >> 4} << 32) | (uint64_t{3} << 62);
}

// The 16-byte chunk (0 or 1) at which chunk ``c`` of 32-byte row ``r`` lies
// in the 32-byte swizzle (address bit 4 ^= bit 7).
__device__ __forceinline__ int swz(int r, int c) { return c ^ ((r >> 2) & 1); }

// x rounded to TF32 (10 mantissa bits), ties away from zero: the result of
// cvt.rna.tf32.f32 for finite x, by an integer add and mask on its bits
// (the conversion instruction made the body ~10% slower)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (lo unused with one pass)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = F32_TERMS == 3 ? tf32(x - __uint_as_float(hi)) : 0u;
}

__device__ __forceinline__ float4 split_hi(float4 x, float4& lo) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                     __uint_as_float(h[3]));
}

// d (m64 x N f32, N = 8 x its first extent; warp w rows 16w..16w+15 in
// mma.sync's accumulator layout) += a (m64 x k8 TF32 in registers:
// mma.sync m16n8k8's A fragment a warp) x B (k8 x N TF32 from shared memory,
// K-major, by descriptor). scale_d = 0 ignores d's input.
__device__ __forceinline__ void wgmma_tf32(float (&d)[2][4], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[4][4], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

#if F32_WARP_SPLIT
// d += a (m16 x k8) x b (k8 x n8), TF32 in, f32 accumulators (mma.sync):
// the ablation in which each warp splits its own K / V fragments
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#endif

constexpr int F32_NB = F32_BN / 8;  // blocks of 8 keys a tile

// s = q'.k^T over HD, the three terms small first: for each term, each
// k-step of 8 d.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[F32_NB][4],
                                             const uint32_t (&qh)[HD / 8][4],
                                             const uint32_t (&ql)[HD / 8][4],
                                             const unsigned char* kh, const unsigned char* kl) {
#pragma unroll
  for (int term = 0; term < F32_TERMS; ++term) {
    const unsigned char* kb = term == 0 && F32_TERMS == 3 ? kl : kh;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
      wgmma_tf32(s, term == 1 ? ql[kk] : qh[kk], kmajor_desc(kb + kk * F32_BN * 32),
                 term > 0 || kk > 0);
  }
}

// ot = p.v over F32_NB k-steps of 8 keys, the three terms small first, into a
// fresh accumulator: the tensor cores round each accumulation toward zero,
// which biases a long chain (the running output over a long kv) by up to an
// ulp a step; the running output is updated in registers instead.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&ot)[HD / 8][4], const uint32_t (&ph)[F32_NB][4],
                                         const uint32_t (&pl)[F32_NB][4], const unsigned char* vh,
                                         const unsigned char* vl) {
#pragma unroll
  for (int term = 0; term < F32_TERMS; ++term) {
    const unsigned char* vb = term == 0 && F32_TERMS == 3 ? vl : vh;
#pragma unroll
    for (int j = 0; j < F32_NB; ++j)
      wgmma_tf32(ot, term == 1 ? pl[j] : ph[j], kmajor_desc(vb + j * HD * 32),
                 term > 0 || j > 0);
  }
}

// The running state of this thread's two rows (16w + g and + 8): the output
// accumulator, the row maxima and this thread's share of the row sums.
template <int HD>
struct RowState {
  float o[HD / 8][4];
  float m[2];
  float l[2];
};

// One kv tile: scores, key bias and mask, online softmax, p.v. The next
// tile's staging runs while the tensor cores compute the products: its K
// (``stage_k``) with the scores, its V (``stage_v``) with p.v.
// ``tiles``: the tile's K_hi, K_lo, V_hi^T, V_lo^T; ``rk`` / ``rv`` its raw
// tiles (read with F32_WARP_SPLIT only); ``bs`` its key bias.
template <int HD, class StageK, class StageV>
__device__ __forceinline__ void tile(RowState<HD>& st, uint32_t (&qh)[HD / 8][4],
                                     uint32_t (&ql)[HD / 8][4], const unsigned char* tiles,
                                     const float* bs, const float* rk, const float* rv,
                                     StageK&& stage_k, StageV&& stage_v) {
  using G = F32Geom<HD>;
  const int t = threadIdx.x & 3;
  float s[F32_NB][4];
#if !F32_WARP_SPLIT
  pin_regs(qh);
  pin_regs(ql);
  wgmma_fence();
  issue_scores<HD>(s, qh, ql, tiles, tiles + G::SPLIT);
  wgmma_commit();
  stage_k();
  wgmma_wait_all();
  pin_regs(s);
  pin_regs(qh);
  pin_regs(ql);
#else
  const int g = (threadIdx.x & 31) >> 2;
  const unsigned char* kr = reinterpret_cast<const unsigned char*>(rk);
#pragma unroll
  for (int j = 0; j < F32_NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int j = 0; j < F32_NB; ++j) {
      uint32_t h0, l0, h1, l1;
      split(*reinterpret_cast<const float*>(kr + raw_off<HD>(8 * j + g, 8 * kk + t)), h0, l0);
      split(*reinterpret_cast<const float*>(kr + raw_off<HD>(8 * j + g, 8 * kk + t + 4)), h1, l1);
      if (F32_TERMS == 3) {
        mma_tf32(s[j], qh[kk], l0, l1);
        mma_tf32(s[j], ql[kk], h0, h1);
      }
      mma_tf32(s[j], qh[kk], h0, h1);
    }
#endif

  // key bias (times log2 e; -inf past Skv), row maxima over the quad
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < F32_NB; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
    s[j][0] += b.x;
    s[j][1] += b.y;
    s[j][2] += b.x;
    s[j][3] += b.y;
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float m0 = fmaxf(st.m[0], mx0), m1 = fmaxf(st.m[1], mx1);
  // a row with no key yet keeps a zero shift (no inf - inf)
  const float base0 = m0 == -INFINITY ? 0.f : m0, base1 = m1 == -INFINITY ? 0.f : m1;
  const float alpha0 = exp2f(st.m[0] - base0), alpha1 = exp2f(st.m[1] - base1);
  st.m[0] = m0;
  st.m[1] = m1;
  float l0 = 0.f, l1 = 0.f;
  uint32_t ph[F32_NB][4], pl[F32_NB][4];
#pragma unroll
  for (int j = 0; j < F32_NB; ++j) {
    const float p0 = exp2f(s[j][0] - base0), p1 = exp2f(s[j][1] - base0);
    const float p2 = exp2f(s[j][2] - base1), p3 = exp2f(s[j][3] - base1);
    l0 += p0 + p1;
    l1 += p2 + p3;
    // keys 8j + 2t and 8j + 2t + 1 as A columns t and t + 4
    split(p0, ph[j][0], pl[j][0]);
    split(p2, ph[j][1], pl[j][1]);
    split(p1, ph[j][2], pl[j][2]);
    split(p3, ph[j][3], pl[j][3]);
  }
  st.l[0] = st.l[0] * alpha0 + l0;
  st.l[1] = st.l[1] * alpha1 + l1;

  float ot[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) ot[n][0] = ot[n][1] = ot[n][2] = ot[n][3] = 0.f;
#if !F32_WARP_SPLIT
  pin_regs(ph);
  pin_regs(pl);
  wgmma_fence();
  issue_pv<HD>(ot, ph, pl, tiles + 2 * G::SPLIT, tiles + 3 * G::SPLIT);
  wgmma_commit();
  stage_v();
  wgmma_wait_all();
  pin_regs(ot);
  pin_regs(ph);
  pin_regs(pl);
#else
  const unsigned char* vr = reinterpret_cast<const unsigned char*>(rv);
#pragma unroll
  for (int j = 0; j < F32_NB; ++j)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      uint32_t h0, l0_, h1, l1_;
      split(*reinterpret_cast<const float*>(vr + raw_off<HD>(8 * j + 2 * t, 8 * n + g)), h0, l0_);
      split(*reinterpret_cast<const float*>(vr + raw_off<HD>(8 * j + 2 * t + 1, 8 * n + g)), h1,
            l1_);
      if (F32_TERMS == 3) {
        mma_tf32(ot[n], ph[j], l0_, l1_);
        mma_tf32(ot[n], pl[j], h0, h1);
      }
      mma_tf32(ot[n], ph[j], h0, h1);
    }
#endif
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    st.o[n][0] = fmaf(st.o[n][0], alpha0, ot[n][0]);
    st.o[n][1] = fmaf(st.o[n][1], alpha0, ot[n][1]);
    st.o[n][2] = fmaf(st.o[n][2], alpha1, ot[n][2]);
    st.o[n][3] = fmaf(st.o[n][3], alpha1, ot[n][3]);
  }
}

// This tile's key bias into ``bs`` (times log2 e; -inf past Skv) for the
// keys from ``key0``.
__device__ __forceinline__ void stage_bias(float* bs, const float* bias, long long key0,
                                           long long skv) {
  const int tid = threadIdx.x;
  if (tid < F32_BN) {
    const long long key = key0 + tid;
    bs[tid] = key < skv ? (bias != nullptr ? bias[key] * kLog2e : 0.f) : -INFINITY;
  }
}

// Staging: the raw K tile split into ``tiles``' K_hi / K_lo (keys x d,
// k-step kk of 8 d at kk * F32_BN * 32 bytes), the raw V tile into V_hi^T /
// V_lo^T (d x keys, k-step j of 8 keys at j * HD * 32 bytes, keys in the p
// fragments' order), each 32-byte row in the 32-byte swizzle. Keys past Skv
// came in as zeros.
template <int HD>
__device__ __forceinline__ void stage_k(unsigned char* tiles, const unsigned char* rk) {
  using G = F32Geom<HD>;
  constexpr int UNITS = F32_BN * HD / 4 / F32_NT;  // 16-byte chunks a thread
  static_assert(F32_BN * HD / 4 % F32_NT == 0, "whole units a thread");
  const int tid = threadIdx.x;
  // one 16-byte chunk (row r, d 4c..4c+3) a unit, a warp on 32 rows
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = tid + i * F32_NT;
    const int r = u % F32_BN, c = u / F32_BN;
    const float4 x = *reinterpret_cast<const float4*>(rk + raw_off<HD>(r, 4 * c));
    float4 lo;
    const float4 hi = split_hi(x, lo);
    const uint32_t off = (c >> 1) * F32_BN * 32 + r * 32 + swz(r, c & 1) * 16;
    *reinterpret_cast<float4*>(tiles + off) = hi;
    if (F32_TERMS == 3) *reinterpret_cast<float4*>(tiles + G::SPLIT + off) = lo;
  }
}

template <int HD>
__device__ __forceinline__ void stage_v(unsigned char* tiles, const unsigned char* rv) {
  using G = F32Geom<HD>;
  constexpr int UNITS = F32_BN * HD / 4 / F32_NT;
  const int tid = threadIdx.x;
  // column d of keys 8j + par + {0, 2, 4, 6} a unit (16-byte chunk par of
  // row d of k-step j), a warp on 32 columns
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = tid + i * F32_NT;
    const int d = u % HD, par = (u / HD) & 1, j = u / (2 * HD);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = *reinterpret_cast<const float*>(rv + raw_off<HD>(8 * j + par + 2 * e, d));
    float4 lo;
    const float4 hi = split_hi(make_float4(x[0], x[1], x[2], x[3]), lo);
    const uint32_t off = j * HD * 32 + d * 32 + swz(d, par) * 16;
    *reinterpret_cast<float4*>(tiles + 2 * G::SPLIT + off) = hi;
    if (F32_TERMS == 3) *reinterpret_cast<float4*>(tiles + 3 * G::SPLIT + off) = lo;
  }
}

template <int HD>
__global__ void __launch_bounds__(F32_NT)
    bhsd_f32_kernel(const TGF32Args a, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap) {
  using G = F32Geom<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the layout's base, 1024-aligned in the shared window (an offset taken
  // from the shared address, so that every access stays a shared one)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::BAR);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long skv = a.skv;
  const float* biasb = a.bias != nullptr ? a.bias + bb * skv : nullptr;
  const int ntiles = static_cast<int>((skv + F32_BN - 1) / F32_BN);
  // tile j's stages: raw K (its V follows), split matrices, key bias
  auto raw = [&](int j) { return smem + G::RK + (j % F32_STAGES) * 2 * G::RAWTILE; };
  auto split_of = [&](int j) { return smem + (j % F32_STAGES) * 4 * G::SPLIT; };
  auto bias_of = [&](int j) {
    return reinterpret_cast<float*>(smem + G::BS + (j % F32_STAGES) * F32_BN * 4);
  };
  // tile j's K and V boxes by TMA from thread 0, after it has announced
  // their bytes on the stage's mbarrier (rows past Skv come as zeros)
  auto load = [&](int j) {
    if (tid != 0) return;
#pragma unroll
    for (int box = 0; box < HD * 4 / G::RB; ++box) {
      tma_load_4d(raw(j) + box * F32_BN * G::RB, &kmap, bars + j % F32_STAGES, box * G::RB / 4,
                  j * F32_BN, hh, bb);
      tma_load_4d(raw(j) + G::RAWTILE + box * F32_BN * G::RB, &vmap, bars + j % F32_STAGES,
                  box * G::RB / 4, j * F32_BN, hh, bb);
    }
  };
  auto announce = [&](int j) { mbar_expect_tx(bars + j % F32_STAGES, 2 * G::RAWTILE); };
  auto landed = [&](int j) {  // waits for tile j's raw rows; thread 0 announces tile j + 2's
    mbar_wait(bars + j % F32_STAGES, (j / F32_STAGES) & 1);
    if (tid == 0 && j + F32_STAGES < ntiles) announce(j + F32_STAGES);
  };
  // tile j staged: split, with its key bias, for wgmma's reads
  auto stage_tile_k = [&](int j) {
    landed(j);
    stage_k<HD>(split_of(j), raw(j));
    stage_bias(bias_of(j), biasb, static_cast<long long>(j) * F32_BN, skv);
  };
  auto stage_tile_v = [&](int j) {
    stage_v<HD>(split_of(j), raw(j) + G::RAWTILE);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  if (tid == 0) {
    for (int i = 0; i < F32_STAGES; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < F32_STAGES && j < ntiles; ++j) announce(j);
  }
  __syncthreads();
  for (int j = 0; j < F32_STAGES && j < ntiles; ++j) load(j);

  // q' = q * scale * log2 e as hi / lo A fragments: (row g, d t), (g + 8,
  // t), (g, t + 4), (g + 8, t + 4) of each k-step of 8 d; rows past Sq zero
  uint32_t qh[HD / 8][4], ql[HD / 8][4];
  {
    const float qscale = static_cast<float>(a.qscale);
    const long long r0 = static_cast<long long>(blockIdx.x) * F32_BM + warp * 16 + g;
    const float* qp = a.q + bb * a.q_sb + hh * a.q_sh;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long r = r0 + (i & 1) * 8;
        const float x = r < a.sq ? qp[r * a.q_ss + 8 * kk + t + (i >> 1) * 4] * qscale : 0.f;
        split(x, qh[kk][i], ql[kk][i]);
      }
  }

  RowState<HD> st;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) st.o[j][0] = st.o[j][1] = st.o[j][2] = st.o[j][3] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;

  // Staged: tile j is split while tile j - 1's products are computed, its
  // raw stage then refilled with tile j + 2. F32_WARP_SPLIT: tile j's raw
  // stage is read by its products and refilled after them.
  if (!F32_WARP_SPLIT) {
    stage_tile_k(0);
    stage_tile_v(0);
  }
  __syncthreads();
  if (!F32_WARP_SPLIT && F32_STAGES < ntiles) load(F32_STAGES);
  for (int j = 0; j < ntiles; ++j) {
    const float* rk = reinterpret_cast<const float*>(raw(j));
    const float* rv = reinterpret_cast<const float*>(raw(j) + G::RAWTILE);
    if (F32_WARP_SPLIT) {
      landed(j);
      stage_bias(bias_of(j), biasb, static_cast<long long>(j) * F32_BN, skv);
      __syncthreads();
    }
    const bool next = !F32_WARP_SPLIT && j + 1 < ntiles;
    auto stage_k_next = [&] {
      if (next) stage_tile_k(j + 1);
    };
    auto stage_v_next = [&] {
      if (next) stage_tile_v(j + 1);
    };
    tile<HD>(st, qh, ql, split_of(j), bias_of(j), rk, rv, stage_k_next, stage_v_next);
    __syncthreads();  // tile j's stages read; tile j + 1 staged
    if (!F32_WARP_SPLIT && j + 1 + F32_STAGES < ntiles) load(j + 1 + F32_STAGES);
    if (F32_WARP_SPLIT && j + F32_STAGES < ntiles) load(j + F32_STAGES);
  }

  // o / l, rows past Sq not stored
  float l0 = st.l[0], l1 = st.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const long long r0 = static_cast<long long>(blockIdx.x) * F32_BM + warp * 16 + g;
  float* op = a.o + bb * a.o_sb + hh * a.o_sh;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < a.sq)
      *reinterpret_cast<float2*>(op + r0 * a.o_ss + 8 * j + 2 * t) =
          make_float2(st.o[j][0] * inv0, st.o[j][1] * inv0);
    if (r0 + 8 < a.sq)
      *reinterpret_cast<float2*>(op + (r0 + 8) * a.o_ss + 8 * j + 2 * t) =
          make_float2(st.o[j][2] * inv1, st.o[j][3] * inv1);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (the library links no libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The 4-D tensor map of a float32 K or V operand: (HD columns, Skv rows, H
// heads, B) at element strides (ss, sh, sb); boxes of RB-byte rows x F32_BN
// rows in the swizzle of their width; rows past Skv read as zeros.
template <int HD>
cudaError_t raw_map(CUtensorMap* map, const float* base, const TGF32Args* a, long long ss,
                    long long sh, long long sb) {
  constexpr int RB = F32Geom<HD>::RB;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(a->skv), static_cast<cuuint64_t>(a->h),
                              static_cast<cuuint64_t>(a->b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss * 4), static_cast<cuuint64_t>(sh * 4),
                                 static_cast<cuuint64_t>(sb * 4)};
  const cuuint32_t box[4] = {RB / 4, F32_BN, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
int launch_f32(const TGF32Args* a, cudaStream_t s) {
  constexpr int smem = static_cast<int>(F32Geom<HD>::BYTES);
  static const cudaError_t attr = cudaFuncSetAttribute(
      bhsd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  // once
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap kmap, vmap;
  cudaError_t err = raw_map<HD>(&kmap, a->k, a, a->k_ss, a->k_sh, a->k_sb);
  if (err == cudaSuccess) err = raw_map<HD>(&vmap, a->v, a, a->v_ss, a->v_sh, a->v_sb);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a->sq + F32_BM - 1) / F32_BM),
                  static_cast<unsigned>(a->h), static_cast<unsigned>(a->b));
  bhsd_f32_kernel<HD><<<grid, F32_NT, smem, s>>>(*a, kmap, vmap);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int geometry_f32(long long* out) {
  constexpr int smem = static_cast<int>(F32Geom<HD>::BYTES);
  cudaError_t err = cudaFuncSetAttribute(bhsd_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bhsd_f32_kernel<HD>, F32_NT,
                                                        smem);
  out[0] = F32_NT;
  out[1] = smem;
  out[2] = blocks;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// K4 on float32 operands, head_dim 16, 32 or 64. Returns a cudaError_t.
int tg_attention_bhsd_f32(const TGF32Args* a, long long head_dim, void* stream) {
  if (a->sq <= 0 || a->skv <= 0 || a->b <= 0 || a->h <= 0 || a->h > 65535 || a->b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_f32<16>(a, s);
    case 32: return launch_f32<32>(a, s);
    case 64: return launch_f32<64>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The body at ``head_dim``: out = (threads, dynamic shared memory in bytes,
// resident blocks a SM). Returns a cudaError_t.
int tg_attention_bhsd_f32_geometry(long long head_dim, long long* out) {
  switch (head_dim) {
    case 16: return geometry_f32<16>(out);
    case 32: return geometry_f32<32>(out);
    case 64: return geometry_f32<64>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
