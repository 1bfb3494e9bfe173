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
// (probes_maxfree.cuh) and T7 are Hopper bodies (TMA loads on mbarriers,
// wgmma); T6 and T8 are simple first versions (synchronous loads, mma.sync;
// T8 no products), right before fast.

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
// q [m, d], k [d, n], v [n, d] row-major; out f32 [m, d]. Rows of q evolve
// independently, so the m rows are split over blocks of 16 (m / 16 blocks:
// one wave for m = 2048 on 132 SMs); the two chains of a block run in its two
// warps on the same rows (they are independent, as on the TPU, where they let
// the matrix unit pipeline). k and v do not fit in an SM (bf16 k of 128 x 1024
// is 256 KB), so they stream through shared memory in tiles of 64 keys, k
// transposed to [key][d] and v to [d][key] (the mma B-fragment layouts).
// bf16 products are mma.sync m16n8k16 with f32 sums and p fed back as
// registers; int8 products m16n8k32 with s32 sums (they wrap), p and the next
// q going through a per-warp shared tile because the s32 accumulator layout
// is not the s8 A-fragment layout. The next q is staged in shared memory for
// both types. Bound: iters x 2 chains x 4 m n d operations at the bf16 or int8
// tensor-core rate.
// ---------------------------------------------------------------------------

constexpr int FL_D = 128;   // the probe's head dim
constexpr int FL_TN = 64;   // keys per streamed tile
constexpr int FL_ROWS = 16;  // q rows per block

__device__ __forceinline__ void mma16832_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dst[c * ldd + r] = src[(row0 + r) * lds + col0 + c] for r < nrows, c < ncols
// (zero outside [rows, cols)), 16-byte reads along c, by the block's threads.
template <typename T>
__device__ void load_transposed(T* dst, int ldd, const T* src, long long lds, int row0, int nrows,
                                int rows, int col0, int ncols, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = ncols / V;
  for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * V;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows && col0 + c < cols)
      raw = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * lds + col0 + c);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) dst[(c + e) * ldd + r] = vals[e];
  }
}

template <typename T> struct LoopTypes;
template <> struct LoopTypes<__nv_bfloat16> {
  using Acc = float;
  static constexpr int K = 16;  // mma depth
  static constexpr int PAD = 8;
};
template <> struct LoopTypes<int8_t> {
  using Acc = int;
  static constexpr int K = 32;
  static constexpr int PAD = 16;
};

__device__ __forceinline__ int8_t requant_s8(int s) {
  return static_cast<int8_t>(max(-127, min(127, s >> 7)));
}

// A fragments of a [16][FL_D] row-major tile (pitch ld elements) for k-steps
// of LoopTypes<T>::K: bf16 m16n8k16 and s8 m16n8k32 read the same 32-bit words
// at (row g / g+8, word t) and (+8 bf16 / +16 bytes).
template <typename T>
__device__ __forceinline__ void load_a_frags(uint32_t (&qa)[FL_D / LoopTypes<T>::K][4],
                                             const T* tile, int ld) {
  constexpr int K = LoopTypes<T>::K;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
  const int ldb = ld * static_cast<int>(sizeof(T));
#pragma unroll
  for (int kk = 0; kk < FL_D / K; ++kk) {
    const unsigned char* p = base + g * ldb + kk * 32 + t * 4;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ldb);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 16);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ldb + 16);
  }
}

}  // namespace

// T6 arguments shared with the Python wrapper (every field 8 bytes).
struct TGFlashLoopArgs {
  const void* q; const void* k; const void* v; float* out;
  long long m, n, iters;
};

namespace {

// Grid (ceil(m / 16)), 64 threads: warp w runs chain w.
template <typename T>
__global__ void __launch_bounds__(64) flash_loop_kernel(const TGFlashLoopArgs a) {
  using Acc = typename LoopTypes<T>::Acc;
  constexpr int K = LoopTypes<T>::K, PAD = LoopTypes<T>::PAD;
  constexpr int LDK = FL_D + PAD, LDV = FL_TN + PAD, LDQ = FL_D + PAD, LDP = FL_TN + PAD;
  constexpr int KT_BYTES = FL_TN * LDK * sizeof(T);  // k tile transposed: [key][d]
  constexpr int VT_BYTES = FL_D * LDV * sizeof(T);   // v tile transposed: [d][key]
  constexpr int QN_BYTES = FL_ROWS * LDQ * sizeof(T);  // per chain: the next q
  constexpr int PS_BYTES = sizeof(T) == 1 ? FL_ROWS * LDP : 0;  // per chain: int8 p tile
  static_assert(FL_ROWS * FL_D * sizeof(Acc) <= KT_BYTES + VT_BYTES, "partner sums");
  __shared__ __align__(16) unsigned char smem[KT_BYTES + VT_BYTES + 2 * QN_BYTES + 2 * PS_BYTES];
  T* Kt = reinterpret_cast<T*>(smem);
  T* Vt = reinterpret_cast<T*>(smem + KT_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* qn = reinterpret_cast<T*>(smem + KT_BYTES + VT_BYTES + warp * QN_BYTES);
  int8_t* ps = reinterpret_cast<int8_t*>(smem + KT_BYTES + VT_BYTES + 2 * QN_BYTES +
                                         warp * PS_BYTES);
  const int m = static_cast<int>(a.m), n = static_cast<int>(a.n);
  const int row0 = blockIdx.x * FL_ROWS;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  // q0 rows -> this chain's staging tile (zeros past m)
  {
    constexpr int V = 16 / sizeof(T);
    for (int i = lane; i < FL_ROWS * FL_D / V; i += 32) {
      const int r = i / (FL_D / V), c = (i % (FL_D / V)) * V;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < m) raw = *reinterpret_cast<const uint4*>(q + (long long)(row0 + r) * FL_D + c);
      *reinterpret_cast<uint4*>(qn + r * LDQ + c) = raw;
    }
  }
  __syncwarp();
  uint32_t qa[FL_D / K][4];
  load_a_frags<T>(qa, qn, LDQ);
  Acc acc[FL_D / 8][4];
#pragma unroll
  for (int dt = 0; dt < FL_D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = Acc(0);

  for (long long it = 0; it < a.iters; ++it) {
    for (int n0 = 0; n0 < n; n0 += FL_TN) {
      __syncthreads();  // the previous tiles consumed by both warps
      load_transposed<T>(Kt, LDK, k, n, 0, FL_D, FL_D, n0, FL_TN, n);
      load_transposed<T>(Vt, LDV, v, FL_D, n0, FL_TN, n, 0, FL_D, FL_D);
      __syncthreads();
      Acc s[FL_TN / 8][4];
#pragma unroll
      for (int nt = 0; nt < FL_TN / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = Acc(0);
#pragma unroll
      for (int kk = 0; kk < FL_D / K; ++kk) {
#pragma unroll
        for (int nt = 0; nt < FL_TN / 8; ++nt) {
          const T* kp = Kt + (nt * 8 + g) * LDK;
          const unsigned char* kb = reinterpret_cast<const unsigned char*>(kp) + kk * 32 + t * 4;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + 16);
          if constexpr (sizeof(T) == 2)
            mma16816(reinterpret_cast<float*>(s[nt]), qa[kk], b0, b1);
          else
            mma16832_s8(reinterpret_cast<int*>(s[nt]), qa[kk], b0, b1);
        }
      }
      // s[:, :d] -> the next q (requantized), staged in this chain's tile
      if (n0 < FL_D) {
#pragma unroll
        for (int nt = 0; nt < FL_TN / 8; ++nt) {
          const int c = n0 + nt * 8 + t * 2;
          if (c < FL_D) {
            if constexpr (sizeof(T) == 2) {
              *reinterpret_cast<uint32_t*>(qn + g * LDQ + c) =
                  pack_bf16(s[nt][0] * (1.f / 64.f), s[nt][1] * (1.f / 64.f));
              *reinterpret_cast<uint32_t*>(qn + (g + 8) * LDQ + c) =
                  pack_bf16(s[nt][2] * (1.f / 64.f), s[nt][3] * (1.f / 64.f));
            } else {
              qn[g * LDQ + c] = requant_s8(s[nt][0]);
              qn[g * LDQ + c + 1] = requant_s8(s[nt][1]);
              qn[(g + 8) * LDQ + c] = requant_s8(s[nt][2]);
              qn[(g + 8) * LDQ + c + 1] = requant_s8(s[nt][3]);
            }
          }
        }
      }
      // p = requant(s); acc += p @ v over this tile's keys
      if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int j = 0; j < FL_TN / 16; ++j) {
          uint32_t pa[4];
          pa[0] = pack_bf16(s[2 * j][0] * (1.f / 64.f), s[2 * j][1] * (1.f / 64.f));
          pa[1] = pack_bf16(s[2 * j][2] * (1.f / 64.f), s[2 * j][3] * (1.f / 64.f));
          pa[2] = pack_bf16(s[2 * j + 1][0] * (1.f / 64.f), s[2 * j + 1][1] * (1.f / 64.f));
          pa[3] = pack_bf16(s[2 * j + 1][2] * (1.f / 64.f), s[2 * j + 1][3] * (1.f / 64.f));
#pragma unroll
          for (int dt = 0; dt < FL_D / 8; ++dt) {
            const T* vp = Vt + (dt * 8 + g) * LDV + j * 16 + t * 2;
            mma16816(reinterpret_cast<float*>(acc[dt]), pa,
                     *reinterpret_cast<const uint32_t*>(vp),
                     *reinterpret_cast<const uint32_t*>(vp + 8));
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < FL_TN / 8; ++nt) {
          const int c = nt * 8 + t * 2;
          ps[g * LDP + c] = requant_s8(s[nt][0]);
          ps[g * LDP + c + 1] = requant_s8(s[nt][1]);
          ps[(g + 8) * LDP + c] = requant_s8(s[nt][2]);
          ps[(g + 8) * LDP + c + 1] = requant_s8(s[nt][3]);
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < FL_TN / 32; ++j) {
          uint32_t pa[4];
          const int8_t* pp = ps + g * LDP + j * 32 + t * 4;
          pa[0] = *reinterpret_cast<const uint32_t*>(pp);
          pa[1] = *reinterpret_cast<const uint32_t*>(pp + 8 * LDP);
          pa[2] = *reinterpret_cast<const uint32_t*>(pp + 16);
          pa[3] = *reinterpret_cast<const uint32_t*>(pp + 8 * LDP + 16);
#pragma unroll
          for (int dt = 0; dt < FL_D / 8; ++dt) {
            const int8_t* vp = reinterpret_cast<const int8_t*>(Vt) + (dt * 8 + g) * LDV + j * 32 +
                               t * 4;
            mma16832_s8(reinterpret_cast<int*>(acc[dt]), pa,
                        *reinterpret_cast<const uint32_t*>(vp),
                        *reinterpret_cast<const uint32_t*>(vp + 16));
          }
        }
        __syncwarp();  // p tile read before the next tile overwrites it
      }
    }
    __syncwarp();  // every lane's part of the next q written
    load_a_frags<T>(qa, qn, LDQ);
    __syncwarp();  // read before the next iteration overwrites it
  }

  // out = f32(acc_0 + acc_1): chain 1 hands its sums over through shared
  // memory, in the k / v tiles' room once both warps are past the loop
  Acc (*partner)[FL_D] = reinterpret_cast<Acc (*)[FL_D]>(smem);
  __syncthreads();
  if (warp == 1) {
#pragma unroll
    for (int dt = 0; dt < FL_D / 8; ++dt) {
      const int c = dt * 8 + t * 2;
      partner[g][c] = acc[dt][0];
      partner[g][c + 1] = acc[dt][1];
      partner[g + 8][c] = acc[dt][2];
      partner[g + 8][c + 1] = acc[dt][3];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int dt = 0; dt < FL_D / 8; ++dt) {
      const int c = dt * 8 + t * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i < 2 ? g : g + 8;
        const int cc = c + (i & 1);
        float val;
        if constexpr (sizeof(T) == 2) {
          val = acc[dt][i] + partner[r][cc];
        } else {  // int32 sum wraps, then rounds to f32 as astype(float32)
          val = static_cast<float>(static_cast<int>(static_cast<unsigned>(acc[dt][i]) +
                                                    static_cast<unsigned>(partner[r][cc])));
        }
        if (row0 + r < m) a.out[(long long)(row0 + r) * FL_D + cc] = val;
      }
    }
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

// T6: dtype 0 = bf16 (f32 sums), 1 = int8 (s32 sums); d = 128, n a multiple of 16.
int tg_probe_flash_loop(const TGFlashLoopArgs* a, long long dtype, void* stream) {
  if (a->m <= 0 || a->n < FL_D || a->n % 16 || a->iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((a->m + FL_ROWS - 1) / FL_ROWS));
  if (dtype == 0)
    flash_loop_kernel<__nv_bfloat16><<<grid, 64, 0, s>>>(*a);
  else if (dtype == 1)
    flash_loop_kernel<int8_t><<<grid, 64, 0, s>>>(*a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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
