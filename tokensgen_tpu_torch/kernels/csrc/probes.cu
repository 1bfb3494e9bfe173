// Hopper (sm_90a) counterparts of the Pallas probes under tools/, which the
// JAX package wrote to find the TPU's ceilings. Here they measure the card's:
//
//   tg_probe_attn_sweep  sweep_kernel<BQ, BN, HB> (probes_hopper.cuh)
//        <- tools/bench_attn_sweep.py `_tpu` (K4's _flash_kernel at explicit
//           block_q / block_kv / hblk)                                        T1
//   tg_probe_attn_v2     sweep_kernel<BQ, BN, HB, LAST> (T1's body; "full" T1's launch)
//        <- tools/bench_attn_v2.py `_kernel_v2` (key bias on every kv tile,
//           "full", or only on the last, "last")                              T2
//   tg_probe_flash_loop  flash_loop_kernel<T>
//        <- tools/bench_pallas_int8.py `_flash_like_kernel` (the flash inner
//           loop chained through requantized scores, bf16 or int8)            T6
//   tg_probe_exp2_loop   exp2_loop_kernel<OP>
//        <- tools/bench_vpu_exp2.py `make_kernel` (register-resident
//           elementwise passes: mul, exp2, exp2 with an add)                  T8
//   tg_probe_attn_splitpv, tg_probe_attn_pair2, tg_probe_cross_pairinner,
//   tg_probe_cross_splitkv, tg_probe_cross_pairloop
//        <- the max-free attention probes of tools/bench_attn_r3.py,
//           tools/bench_cross_r3.py and tools/bench_cross_pairloop.py
//           (below)                                                  T3a-T4b, T5
//
// T7, tg_probe_matmul (<- tools/bench_matmul_pallas.py `_mm_kernel`), is
// its own source, probe_gemm.cu. Each computes the JAX function, not the
// TPU's blocking. T1, T2, T4a and T4b (probes_hopper.cuh), T3a, T3b and T5
// (probes_maxfree.cuh), T6 (below: k and v resident per key split, wgmma)
// and T7 are Hopper bodies (TMA or once-per-block loads, wgmma); T8 has no
// products and is a plain register loop.

#include <cfloat>

#include "probes_hopper.cuh"
#include "probes_maxfree.cuh"

namespace {

// ---------------------------------------------------------------------------
// T6: `iters` steps of two chains of the flash inner loop, per the JAX probe:
//
//   s = q @ k  (acc type: f32 for bf16, s32 for int8)
//   p = requant(s);  acc += p @ v;  q = requant(s[:, :d])
//   requant: bf16 -> bf16(s * 1/64) (round to nearest even);
//            int8 -> clip(s >> 7, -127, 127) (arithmetic shift)
//   out = f32(acc_a + acc_b)   (int32 sums wrap, as JAX's)
//
// q [m, d], k [d, n], v [n, d] row-major, d = 128; out f32 [m, d]. Bound:
// iters x 2 chains x 4 m n d operations at the bf16 or int8 tensor-core
// rate (no library call computes it).
//
// Design: the keys are split so that a block's share of k and v stays in
// shared memory through every step, which then reads no global memory (the
// first version streamed all of k and v from L2 in each of the 500 steps).
// * A block owns 64 rows of q and one split of `split` keys (grid (splits,
//   ceil(m / 64)); the host's `probes.flash_loop_split` picks the split);
//   warpgroup w runs chain w on those rows: the two chains are computed in
//   full, each on its own, as on the TPU.
// * q's next value is requant(s[:, :d]), over n's first 128 keys, which one
//   split does not hold. So every block also keeps k[:, :128] and computes
//   it itself, q @ k[:, :128] after the split's products, by the same
//   instructions in the same order in every block: each block's q is every
//   other's, and no block waits for another between steps. That adds 128 /
//   (2 split) of the work (1/8 at 512 keys a split).
// * Per step and chunk of the split's keys: s = q @ k_chunk on wgmma (q as A
//   from registers), p = requant(s) packed in registers as the A operand of
//   acc += p @ v_chunk (wgmma). bf16: chunks of 64 keys (scores m64n64k16,
//   p.v m64n128k16; the f32 accumulator's layout is the bf16 A fragment's);
//   k and v are loaded once by TMA in the 128-byte swizzle and read
//   MN-major. int8: chunks of 128 keys (m64n128k32 both). 8-bit wgmma reads
//   both operands K-major only, so the block's threads transpose k
//   (d-major) and v (key-major) once into shared memory; and the s32
//   accumulator's columns are not the s8 A fragment's (thread (g, t) holds
//   columns 2t, 2t + 1, 8 + 2t, 9 + 2t of each 16 where the fragment holds
//   4t .. 4t + 3). Both products sum over their inner index, so k's rows (d)
//   and v's rows (keys) are stored in that order (FA3's FP8 trick): the
//   accumulator registers, requantized and packed four to a register, are
//   then the next product's A operand as they stand, p for p @ v and q's
//   next value for the next step's q @ k, with no trip through shared
//   memory.
// * A warpgroup's chunks run in turn (scores, requant, p.v); the other
//   warpgroup's chain fills the tensor cores while one requantizes. Issuing
//   the next chunk's scores before this chunk's p.v, p in two register sets,
//   made ptxas serialize every wgmma (C7513) and spill in int8
//   (tools/kernel_ablations.py t6_overlap).
// * The splits' partial acc are added (red.global.add) into a workspace
//   [2 chains][m][d], int32 for int8 (wrapping sums are the same in any
//   order: out stays bit-equal to the plain version), f32 for bf16;
//   `flash_loop_out_kernel` writes out = f32(acc_a + acc_b), the int32 sum
//   wrapping first.
// * Ragged m and n: rows past m are zeros (q = p = 0; not stored), keys past
//   n are zeros in k and v (TMA's fill; the int8 loads' zeros): s = p = 0.
// Measured on an H100 at 2,048 x 2,048 x 128, 500 steps, against copies
// with one choice undone (tools/kernel_ablations.py, two builds, two rounds;
// ms): int8 2.15-2.23, bf16 3.28-3.44 (the first version 83.4-83.8 and
// 145.3-145.7; bounds 1.085 and 2.170); without the chain (a wrong result)
// 1.84-1.93 and 2.68-2.88; int8 p staged in shared memory 2.35-2.41; the
// overlapped chunks 10.1 (int8, spilled) and 3.70-3.81. 186 (int8) and 203
// (bf16) registers; 148,488 B of shared memory at 512 int8 keys, 164,872 B
// at 256 bf16 keys.
// ---------------------------------------------------------------------------

constexpr int FL_D = 128;           // the probe's head dim
constexpr int FL_ROWS = 64;         // q rows a block: one warpgroup's 64 a chain
constexpr int FL_NT = 256;          // two warpgroups: chain 0, chain 1
constexpr uint32_t FL_BOX = 16384;  // one chunk of k or of v in shared memory

template <typename T> struct LoopGeom;
template <> struct LoopGeom<__nv_bfloat16> {
  using Acc = float;
  static constexpr int CHUNK = 64;       // keys a score product
  static constexpr int MAX_SPLIT = 256;  // keys a block holds
};
template <> struct LoopGeom<int8_t> {
  using Acc = int;
  static constexpr int CHUNK = 128;
  static constexpr int MAX_SPLIT = 512;
};

// dynamic shared memory at ``split`` keys: 1 KB of alignment slack, the
// split's k chunks, k[:, :128], the v chunks, the mbarrier
template <typename T>
constexpr int flash_loop_smem_bytes(int split) {
  return 1024 + 2 * (split / LoopGeom<T>::CHUNK) * static_cast<int>(FL_BOX) +
         FL_D * FL_D * static_cast<int>(sizeof(T)) + 8;
}

// d (m64 x n128 s32) += A (m64 x k32 s8 in registers) x B (k32 x n128 s8,
// K-major from shared memory). The sums wrap (no .satfinite), as JAX's int32.
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[16][4], const uint32_t (&a)[4],
                                            uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void pin_regs(int (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// The stored order of k's rows (d) and v's rows (keys) for the int8 body:
// byte j of word w of a stored row (position 4 w + j) holds element
// fl_elem(w, j), the s32 accumulator's column that thread t = w % 4 holds
// there: 2t, 2t + 1, 8 + 2t, 9 + 2t of its group of 16.
__device__ __forceinline__ int fl_elem(int w, int j) {
  return (w >> 2) * 16 + (w & 3) * 2 + (j >> 1) * 8 + (j & 1);
}

// byte c (a multiple of 4) of row r of a [rows][128 B] tile in the 128-byte
// swizzle (16-byte chunks permuted by the row's index mod 8)
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// o[e] = bytes e of r[0], r[1], r[2], r[3] (a 4 x 4 byte transpose)
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&o)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140), hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140), hi23 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

// int8 k^T of keys [key0, key0 + rows): boxes of 128 keys, row = key, its
// 128 bytes d in the stored order; zeros past n. Threads of a warp read one
// row of k, 32 words of 4 keys.
__device__ void load_kt_s8(unsigned char* dst, const int8_t* k, int n, int key0, int rows) {
  const int groups = rows / 4;
  for (int u = threadIdx.x; u < groups * 32; u += FL_NT) {
    const int i0 = (u % groups) * 4, w = u / groups;
    uint32_t r[4] = {0u, 0u, 0u, 0u}, o[4];
    if (key0 + i0 < n) {  // n % 16 == 0: the 4 keys are all in or all out
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = *reinterpret_cast<const uint32_t*>(k + (long long)fl_elem(w, j) * n + key0 + i0);
    }
    transpose4x4(r, o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = i0 + e;
      *reinterpret_cast<uint32_t*>(dst + (row >> 7) * FL_BOX + sw128(row & 127, 4 * w)) = o[e];
    }
  }
}

// int8 v^T of keys [key0, key0 + rows): a box of [128 d][128 keys] a chunk,
// the keys of each row in the stored order; zeros past n. Threads of a warp
// read 4 columns each of one key's row.
__device__ void load_vt_s8(unsigned char* dst, const int8_t* v, int n, int key0, int rows) {
  for (int u = threadIdx.x; u < rows / 4 * 32; u += FL_NT) {
    const int d0 = (u & 31) * 4, w = u >> 5;
    const int c = w >> 5, wc = w & 31;  // the chunk, the word within its 128 keys
    uint32_t r[4], o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + c * 128 + fl_elem(wc, j);
      r[j] = key < n ? *reinterpret_cast<const uint32_t*>(v + (long long)key * FL_D + d0) : 0u;
    }
    transpose4x4(r, o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<uint32_t*>(dst + c * FL_BOX + sw128(d0 + e, 4 * wc)) = o[e];
  }
}

// This thread's A fragments of q0's rows r and r + 8 (zeros past m): bf16,
// 8 k-steps of 16 columns; int8, 4 k-steps of 32 with d in the stored order.
template <typename T, int KS>
__device__ void load_q0_frags(uint32_t (&qa)[KS][4], const T* q, int m, int r) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + (i & 1) * 8, half = i >> 1;
      uint32_t x = 0u;
      if (row < m) {
        const unsigned char* p = reinterpret_cast<const unsigned char*>(q + (long long)row * FL_D);
        if constexpr (sizeof(T) == 2) {
          x = *reinterpret_cast<const uint32_t*>(p + kk * 32 + half * 16 + t * 4);
        } else {
          const int c = kk * 32 + half * 16 + t * 2;
          x = *reinterpret_cast<const uint16_t*>(p + c) |
              (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p + c + 8)) << 16);
        }
      }
      qa[kk][i] = x;
    }
}

// requant(s) of an s32 accumulator tile [64 x 32 kk .. 32 kk + 31] as the
// s8 A fragments of k-steps kk (clip(s >> 7, -127, 127), four to a register)
template <int KS>
__device__ __forceinline__ void requant_s8(uint32_t (&a)[KS][4], const int (&s)[16][4]) {
  auto q8 = [](int x) { return static_cast<uint32_t>(max(-127, min(127, x >> 7))); };
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n0 = 4 * kk + (i >> 1) * 2, e = (i & 1) * 2;  // n8 tiles n0, n0 + 1; rows by e
      const uint32_t lo = __byte_perm(q8(s[n0][e]), q8(s[n0][e + 1]), 0x0040);
      const uint32_t hi = __byte_perm(q8(s[n0 + 1][e]), q8(s[n0 + 1][e + 1]), 0x0040);
      a[kk][i] = __byte_perm(lo, hi, 0x5410);
    }
}

// requant(s) of an f32 accumulator tile as bf16 A fragments: bf16(s / 64)
template <int KS, int NT>
__device__ __forceinline__ void requant_bf16(uint32_t (&a)[KS][4], const float (&s)[NT][4]) {
  static_assert(NT == 2 * KS, "16 columns a k-step");
  constexpr float r = 1.f / 64.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0] * r, s[2 * kk][1] * r);
    a[kk][1] = pack_bf16(s[2 * kk][2] * r, s[2 * kk][3] * r);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0] * r, s[2 * kk + 1][1] * r);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2] * r, s[2 * kk + 1][3] * r);
  }
}

}  // namespace

// T6 arguments shared with the Python wrapper (every field 8 bytes).
struct TGFlashLoopArgs {
  const void* q; const void* k; const void* v; float* out;
  long long m, n, iters;
};

namespace {

// Grid (ceil(n / split), ceil(m / 64)), 256 threads: warpgroup w runs chain
// w over the block's 64 rows; dynamic shared memory flash_loop_smem_bytes.
// bf16: k and v by their tensor maps (k [d][n]: boxes of 64 keys x 128
// rows; v [n][d]: 64 columns x 64 keys). ``ws``: [2][m][128] of Acc, zeroed.
template <typename T>
__global__ void __launch_bounds__(FL_NT, 1) flash_loop_kernel(
    const TGFlashLoopArgs a, int split, void* ws, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap) {
  using L = LoopGeom<T>;
  using Acc = typename L::Acc;
  constexpr bool I8 = sizeof(T) == 1;
  constexpr int KS = I8 ? FL_D / 32 : FL_D / 16;  // k-steps over d
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* kS = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* k0 = kS + (split / L::CHUNK) * FL_BOX;  // k[:, :128]
  unsigned char* vS = k0 + FL_D * FL_D * sizeof(T);
  const int m = static_cast<int>(a.m), n = static_cast<int>(a.n);
  const int n0 = blockIdx.x * split, row0 = blockIdx.y * FL_ROWS;
  const int nch = (min(split, n - n0) + L::CHUNK - 1) / L::CHUNK;  // chunks holding keys
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int r = row0 + (warp & 3) * 16 + g;  // this thread's rows r, r + 8
  if constexpr (I8) {
    const int8_t* k = static_cast<const int8_t*>(a.k);
    load_kt_s8(kS, k, n, n0, nch * L::CHUNK);
    load_kt_s8(k0, k, n, 0, FL_D);
    load_vt_s8(vS, static_cast<const int8_t*>(a.v), n, n0, nch * L::CHUNK);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // read by wgmma
    __syncthreads();
  } else {
    uint64_t* bar = reinterpret_cast<uint64_t*>(vS + (split / L::CHUNK) * FL_BOX);
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(bar, (2 * nch + 2) * FL_BOX);
      for (int c = 0; c < nch; ++c) {
        tma_load_4d(kS + c * FL_BOX, &kmap, bar, n0 + c * L::CHUNK, 0, 0, 0);
        tma_load_4d(vS + c * FL_BOX, &vmap, bar, 0, n0 + c * L::CHUNK, 0, 0);
        tma_load_4d(vS + c * FL_BOX + FL_BOX / 2, &vmap, bar, 64, n0 + c * L::CHUNK, 0, 0);
      }
      tma_load_4d(k0, &kmap, bar, 0, 0, 0, 0);
      tma_load_4d(k0 + FL_BOX, &kmap, bar, 64, 0, 0, 0);
    }
    __syncthreads();  // the mbarrier's initialization
    mbar_wait(bar, 0);
  }
  uint32_t qa[KS][4];
  load_q0_frags<T, KS>(qa, static_cast<const T*>(a.q), m, r);
  Acc acc[16][4];
#pragma unroll
  for (int dt = 0; dt < 16; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = Acc(0);
  uint32_t pa[4][4];  // p of a chunk: the A operand of p.v (4 k-steps for both types)

  for (long long it = 0; it < a.iters; ++it) {
    for (int c = 0; c < nch; ++c) {
      if constexpr (I8) {
        int s[16][4];  // s = q @ k_chunk, 128 keys
        pin_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_s8_rs(s, qa[kk], smem_desc(kS + c * FL_BOX + kk * 32, 16, 1024, 1), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();  // and the previous chunk's p.v: pa is free
        pin_regs(s);
        pin_regs(acc);
        pin_regs(pa);
        requant_s8(pa, s);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)  // acc += p @ v_chunk, 32 keys a k-step
          wgmma_s8_rs(acc, pa[j], smem_desc(vS + c * FL_BOX + j * 32, 16, 1024, 1), 1);
        wgmma_commit();
      } else {
        float s[8][4];  // s = q @ k_chunk, 64 keys (k MN-major: 16 rows of d a k-step)
        pin_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_rs<64, 1>(s, qa[kk], smem_desc(kS + c * FL_BOX + kk * 2048, FL_BOX, 1024, 1),
                          kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin_regs(s);
        pin_regs(acc);
        pin_regs(pa);
        requant_bf16(pa, s);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)  // acc += p @ v_chunk, 16 keys a k-step (two column boxes)
          wgmma_rs<128, 1>(acc, pa[j], smem_desc(vS + c * FL_BOX + j * 2048, FL_BOX / 2, 1024, 1),
                           1);
        wgmma_commit();
      }
    }
    // q's next value: requant(q @ k[:, :128]), the same in every block
    Acc sc[16][4];
    pin_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (I8)
        wgmma_s8_rs(sc, qa[kk], smem_desc(k0 + kk * 32, 16, 1024, 1), kk > 0);
      else
        wgmma_rs<128, 1>(sc, qa[kk], smem_desc(k0 + kk * 2048, FL_BOX, 1024, 1), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin_regs(sc);
    pin_regs(acc);
    pin_regs(pa);
    pin_regs(qa);
    if constexpr (I8)
      requant_s8(qa, sc);
    else
      requant_bf16(qa, sc);
  }

  // this chain's partial sums into the workspace (rows past m not stored)
  Acc* wsp = static_cast<Acc*>(ws) + (long long)wg * m * FL_D;
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r < m) {
      atomicAdd(wsp + (long long)r * FL_D + c, acc[dt][0]);
      atomicAdd(wsp + (long long)r * FL_D + c + 1, acc[dt][1]);
    }
    if (r + 8 < m) {
      atomicAdd(wsp + (long long)(r + 8) * FL_D + c, acc[dt][2]);
      atomicAdd(wsp + (long long)(r + 8) * FL_D + c + 1, acc[dt][3]);
    }
  }
}

// out = f32(acc_a + acc_b) from the workspace [2][m * 128] (the int32 sum
// wraps, then rounds to f32 as astype(float32))
template <typename T>
__global__ void __launch_bounds__(256) flash_loop_out_kernel(const void* ws, float* out,
                                                             long long count) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= count) return;
  if constexpr (sizeof(T) == 1) {
    const unsigned* w = static_cast<const unsigned*>(ws);
    out[i] = static_cast<float>(static_cast<int>(w[i] + w[i + count]));
  } else {
    const float* w = static_cast<const float*>(ws);
    out[i] = w[i] + w[i + count];
  }
}

// ---------------------------------------------------------------------------
// T8: n_iter register-resident passes over a f32 array (the probe's VMEM
// block): mul x * 1.0000001, exp2 2^(x * 0.5), exp2_add 2^(x * 0.5 + 0.125).
// Each thread holds 4 elements through every pass (one 16-byte load, one
// store, nothing in between); each pass depends on the last and the result is
// stored, so nvcc can neither hoist nor fold the loop (the f32 products do not
// reassociate without fast math). exp2 is the instruction ex2.approx.f32, the
// one K1's softmax (exp2f) runs on: written in CUDA C++ rather than Triton so
// that the probe pins that instruction's rate and no other. Bound: the exp2
// passes at the SFU rate (16 results per clock per SM), mul at the FP32 rate
// (128 per clock per SM).
// ---------------------------------------------------------------------------

constexpr int OP_MUL = 0, OP_EXP2 = 1, OP_EXP2_ADD = 2;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int OP>
__device__ __forceinline__ float pass(float x) {
  if constexpr (OP == OP_MUL) return x * 1.0000001f;
  else if constexpr (OP == OP_EXP2) return ex2_approx(x * 0.5f);
  else return ex2_approx(x * 0.5f + 0.125f);
}

// Grid (ceil(n / 1024)), 256 threads, 4 consecutive elements each (n % 4 == 0).
template <int OP>
__global__ void __launch_bounds__(256) exp2_loop_kernel(const float* x, float* o, long long n,
                                                        int n_iter) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  const float4 in = *reinterpret_cast<const float4*>(x + i);
  float e0 = in.x, e1 = in.y, e2 = in.z, e3 = in.w;
  for (int it = 0; it < n_iter; ++it) {
    e0 = pass<OP>(e0);
    e1 = pass<OP>(e1);
    e2 = pass<OP>(e2);
    e3 = pass<OP>(e3);
  }
  *reinterpret_cast<float4*>(o + i) = make_float4(e0, e1, e2, e3);
}


// ---------------------------------------------------------------------------
// T3a, T3b, T4a, T4b: the round-3 attention probes of tools/bench_attn_r3.py
// and tools/bench_cross_r3.py, and T5, tools/bench_cross_pairloop.py's
// pair-loop smallkv. Each computes K1's, K2's or K3's function
// with the TPU kernels' max-free softmax: no running max. The scores (log2
// domain: log2 e folded into q's prologue as qscale) are shifted by a static
// C that the wrapper computes from the prologue tables (probes.score_shift:
// a bound on |q.k| plus the largest key bias, capped at 120) and passes as
// its own float (TGAttnArgs stays K1-K7's ABI):
//
//   p = exp2(min(s + bias * log2 e - C, 0))   f32; keys past Skv: p = 0
//   l = sum p (f32),  acc += bf16(p) @ v (f32),  o = acc / max(l, FLT_MIN)
//
// At the scripts' tables C is the cap, 120, so every p lies far below 1
// (2^-80 .. 2^-160 for scores of a few tens): the row sums are carried by
// the normal values and the shift cancels in acc / l. exp2f keeps
// subnormals (no -ftz); T3a, T3b, T4a and T5 run ex2.approx.ftz on a
// shifted argument instead (probes_maxfree.cuh); a row whose every score is below
// about -29 would underflow, as on the TPU.
//
// Designs (T3a, T3b and T5: probes_maxfree.cuh's TMA / wgmma bodies; T4a
// and T4b: probes_hopper.cuh's):
// * T3a pair_splitpv_kernel<RB> (<- _packed_kernel_splitpv,
//   probes_maxfree.cuh): the prologue pass once per row (K1's), then a
//   block owns 64 RB q rows of one head pair, warpgroup w head h0 + w: each
//   K / V slot of the ring holds the pair's 128 columns of one 128-key tile
//   (both heads' boxes), and each warpgroup multiplies only its head's
//   half, its scores (wgmma SS) and its own half of p.v (wgmma RS): the
//   split p.v, with no block-diagonal zero half to multiply as on the TPU.
//   With RB = 2 each warpgroup alternates its two row blocks of 64 rows
//   (one's scores issued with the other's p.v), so a slot serves 128 q rows
//   of each head; with RB = 1 a slot serves 64, one chain a warpgroup.
// * T3b pair2_kernel (<- _packed_kernel_pair2, probes_maxfree.cuh): the
//   prologue pass once per row (K1's), then a block owns 128 q rows of two
//   head pairs and runs two passes, in each one head of each pair as its
//   two chains; a warpgroup issues one chain's scores (wgmma SS) with the
//   other's p.v (wgmma RS), whose softmax runs meanwhile; K / V tiles of
//   128 keys by TMA through a 5-slot ring.
// * T4a pairinner_tma_kernel (<- _smallkv_kernel, probes_hopper.cuh): q's
//   prologue pass once per row (K1's), then grid (H, q blocks, B), the head
//   fastest (the TPU grid's pair innermost); a block holds its head's
//   prologued K' and V whole (TMA, <= 4 tiles of 128 keys) and each
//   warpgroup runs 64-row chunks of its q' rows against them, by TMA a
//   chunk ahead; scores wgmma SS, p.v wgmma RS, the output by TMA stores.
// * T4b splitkv_tma_kernel (<- _smallq_kernel, probes_hopper.cuh): K3's
//   function split over the keys: the prologue pass once per row for k and
//   q (K1's), then grid (kv splits, H, B), each block T4a's resident body
//   on its split's keys (K' / V whole by TMA) against every q' row in
//   64-row chunks; each chunk's f32 acc and l are added by TMA reduce-add
//   into one zeroed accumulator, and a last pass writes sum(acc) /
//   max(sum(l), FLT_MIN): with no running max there is nothing to rescale
//   (the TPU kernel carries the same sums across its kv sweep).
// * T5 pairloop_kernel (<- _smallkv_pairloop_kernel, probes_maxfree.cuh):
//   T4a's function with the head loop in the block: no head axis in the
//   grid; a block owns a contiguous range of (row block of 128 q rows,
//   head) units, head fastest (full-width rows, their heads in order; by
//   default one wave of blocks over the SMs). Per unit each warpgroup
//   loads its 64 rows of that head's q by TMA one unit ahead and prologues
//   them in shared memory with q's tables (held for the row block); K'
//   (prologued by the wrapper) and V stream in 128-key tiles through one
//   TMA ring across head boundaries, all 48 heads' (5.9 MB at 480 keys)
//   fitting in no SM. Scores wgmma SS, p.v wgmma RS, the p.v of one tile
//   under the next tile's softmax.
// Bound: the two products at the bf16 tensor-core rate.
// ---------------------------------------------------------------------------

// T6: the key-split body, then out from the workspace.
template <typename T>
int launch_flash_loop(const TGFlashLoopArgs* a, long long split, void* ws, cudaStream_t s) {
  using L = LoopGeom<T>;
  if (split < L::CHUNK || split > L::MAX_SPLIT || split % L::CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap kmap{}, vmap{};
  cudaError_t err = cudaSuccess;
  if constexpr (sizeof(T) == 2) {  // k [d][n]: 64 keys x 128 rows a box; v [n][d]: 64 x 64
    const long long dn = FL_D * a->n;
    err = tensor_map_4d(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a->k, static_cast<int>(a->n),
                        FL_D, 1, 1, a->n, dn, dn, 64, FL_D);
    if (err == cudaSuccess)
      err = tensor_map_4d(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a->v, FL_D, a->n, 1, 1, FL_D,
                          dn, dn, 64, 64);
  }
  const int smem = flash_loop_smem_bytes<T>(static_cast<int>(split));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_loop_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               flash_loop_smem_bytes<T>(L::MAX_SPLIT));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a->n + split - 1) / split),
                  static_cast<unsigned>((a->m + FL_ROWS - 1) / FL_ROWS));
  flash_loop_kernel<T><<<grid, FL_NT, smem, s>>>(*a, static_cast<int>(split), ws, kmap, vmap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count = a->m * FL_D;
  flash_loop_out_kernel<T><<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(ws, a->out,
                                                                                     count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// T1's built (block_q, block_kv, hblk), probes.SWEEP_CONFIGS. Of the axes'
// other combinations (probes_hopper.cuh), ptxas (-O3, on the card) spilled
// every one at block_kv 192: (128, 192, 1) 255 registers and 1,012 bytes;
// (128, 192, 2) and (256, 192, 1) 396 and 400 bytes, with "(C7512)
// Potential Performance Loss: wgmma.mma_async instructions are serialized
// due to insufficient register resources"; (256, *, 2), four chains a
// warpgroup, is not written.
#define TG_SWEEP_CONFIGS(X) X(128, 128, 1) X(128, 128, 2) X(256, 128, 1)

// T1 at (bm, bn, hb), one of TG_SWEEP_CONFIGS.
int tg_probe_attn_sweep(const TGAttnArgs* a, long long bm, long long bn, long long hb,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TG_SWEEP(BQ, BN_, HB) \
  if (bm == BQ && bn == BN_ && hb == HB) return launch_sweep<BQ, BN_, HB, false>(a, s);
  TG_SWEEP_CONFIGS(TG_SWEEP)
#undef TG_SWEEP
  return static_cast<int>(cudaErrorInvalidValue);
}

// T1's build at (bm, bn, hb) (sweep_geometry's eight values).
int tg_probe_sweep_geometry(long long bm, long long bn, long long hb, long long* out) {
#define TG_SWEEP(BQ, BN_, HB) \
  if (bm == BQ && bn == BN_ && hb == HB) return sweep_geometry<BQ, BN_, HB>(out);
  TG_SWEEP_CONFIGS(TG_SWEEP)
#undef TG_SWEEP
  return static_cast<int>(cudaErrorInvalidValue);
}

// T2 at (bm, bn, hb), one of TG_SWEEP_CONFIGS: mode 0 = key bias on every
// kv tile ("full": T1's launch itself), 1 = only on the last ("last": T1's
// body with its LAST flag).
int tg_probe_attn_v2(const TGAttnArgs* a, long long bm, long long bn, long long hb, long long mode,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
#define TG_SWEEP(BQ, BN_, HB)                                                       \
  if (bm == BQ && bn == BN_ && hb == HB)                                            \
    return mode == 1 ? launch_sweep<BQ, BN_, HB, true>(a, s) : launch_sweep<BQ, BN_, HB, false>(a, s);
  TG_SWEEP_CONFIGS(TG_SWEEP)
#undef TG_SWEEP
  return static_cast<int>(cudaErrorInvalidValue);
}

// T6: dtype 0 = bf16 (f32 sums), 1 = int8 (s32 sums); d = 128, n a multiple
// of 16 and >= 128; ``split`` keys a block (a multiple of 64 up to 256 in
// bf16, of 128 up to 512 in int8); ``ws``: [2][m][128] int32 (int8) or f32
// (bf16), zeroed.
int tg_probe_flash_loop(const TGFlashLoopArgs* a, long long dtype, long long split, void* ws,
                        void* stream) {
  if (a->m <= 0 || a->n < FL_D || a->n % 16 || a->iters < 0 || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_flash_loop<__nv_bfloat16>(a, split, ws, s);
  if (dtype == 1) return launch_flash_loop<int8_t>(a, split, ws, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// T8: op 0 = mul, 1 = exp2, 2 = exp2_add; n a multiple of 4.
int tg_probe_exp2_loop(const float* x, float* o, long long n, long long n_iter, long long op,
                       void* stream) {
  if (n <= 0 || n % 4 || n_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n / 4 + 255) / 256));
  const int it = static_cast<int>(n_iter);
  switch (op) {
    case OP_MUL: exp2_loop_kernel<OP_MUL><<<grid, 256, 0, s>>>(x, o, n, it); break;
    case OP_EXP2: exp2_loop_kernel<OP_EXP2><<<grid, 256, 0, s>>>(x, o, n, it); break;
    case OP_EXP2_ADD: exp2_loop_kernel<OP_EXP2_ADD><<<grid, 256, 0, s>>>(x, o, n, it); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// T3a-T5 share one signature: (args, tile parameters p0 and p1, the score
// shift C, the workspace (T3a, T3b: the bf16 prologue rows; T4a: q'; T4b:
// the prologue rows and the f32 accumulator; else null), stream).

// T3a: (block_q, block_kv) in {(128, 128), (64, 128)}; H even; ws: the
// prologued k and q rows, bf16 B * (Skv + Sq) * H * 64.
int tg_probe_attn_splitpv(const TGAttnArgs* a, long long bm, long long bn, float shift,
                          float* ws, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn != MF_BN) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 128) return launch_pair_splitpv<2>(a, shift, ws, s);
  if (bm == 64) return launch_pair_splitpv<1>(a, shift, ws, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// T3a's build at block_q ``bm``: threads, dynamic shared memory (bytes),
// K / V slots, q rows a block.
int tg_probe_splitpv_geometry(long long bm, long long* out) {
  if (bm != 128 && bm != 64) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = MF_NT;
  out[1] = bm == 128 ? splitpv_smem_bytes<2>() : splitpv_smem_bytes<1>();
  out[2] = SP_SLOTS;
  out[3] = bm;
  return 0;
}

// T3b: block_kv 128 (128 q rows a block); H a multiple of 4; ws: the
// prologued k and q rows, bf16 B * (Skv + Sq) * H * 64.
int tg_probe_attn_pair2(const TGAttnArgs* a, long long bn, long long unused, float shift,
                        float* ws, void* stream) {
  (void)unused;
  if (bn != MF_BN) return static_cast<int>(cudaErrorInvalidValue);
  return launch_pair2(a, shift, ws, static_cast<cudaStream_t>(stream));
}

// T4a: q rows per block a multiple of 128; Skv <= 512; k already prologued,
// q's tables given; ws: q' (bf16 B * Sq * H * 64).
int tg_probe_cross_pairinner(const TGAttnArgs* a, long long block_q, long long unused,
                             float shift, float* ws, void* stream) {
  (void)unused;
  return launch_pairinner(a, block_q, shift, ws, static_cast<cudaStream_t>(stream));
}

// T4a's build for ``skv`` keys (pairinner_geometry's six values).
int tg_probe_pairinner_geometry(long long skv, long long* out) {
  return pairinner_geometry(skv, out);
}

// T5: ``per_block`` (batch row, 128-row block, head) units a block, head
// fastest; k already prologued, q's tables given.
int tg_probe_cross_pairloop(const TGAttnArgs* a, long long per_block, long long unused,
                            float shift, float* ws, void* stream) {
  (void)unused;
  (void)ws;
  return launch_pairloop(a, per_block, shift, static_cast<cudaStream_t>(stream));
}

// T4b: keys per split a multiple of 128, at most 512; ws holds the bf16
// prologue rows, then the f32 accumulator (probes.splitkv_ws_bytes).
int tg_probe_cross_splitkv(const TGAttnArgs* a, long long split, long long unused, float shift,
                           float* ws, void* stream) {
  (void)unused;
  return launch_splitkv(a, split, shift, ws, static_cast<cudaStream_t>(stream));
}

// T4b's build at ``split`` keys a split (splitkv_geometry's seven values).
int tg_probe_splitkv_geometry(long long split, long long* out) {
  return splitkv_geometry(split, out);
}

}  // extern "C"
