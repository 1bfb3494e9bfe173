// Flash-attention forward kernels for the four attention calls of the To2V
// edit path, written for Hopper (sm_90a), head dim 64, bf16 operands with f32
// softmax and accumulation on mma.sync m16n8k16 tensor-core tiles.
//
// Replaces the Pallas TPU kernels of tokensgen_tpu/kernels/attention.py:
//   tg_attention_joint          joint_kernel    <- _flash_packed_kernel  (_flash_fused_packed_tpu)
//   tg_attention_cross_smallkv  smallkv_kernel  <- _cross_smallkv_kernel (_flash_cross_smallkv_tpu)
//   tg_attention_cross_smallq   smallq_kernel   <- _cross_smallq_kernel  (_flash_cross_smallq_tpu)
//   tg_attention_bhsd           bhsd_kernel     <- _flash_kernel         (_flash_attention_tpu)
//
// What each computes: softmax(P_q(q) . P_k(k)^T + key_bias) . v per head,
// where the prologue P is the per-head LayerNorm (f32 statistics, eps) folded
// with interleaved RoPE as  y = ln0*cosg + (ln0 @ Rg)*sin + add  (tables from
// make_prologue; Rg = diag(g) . R has nonzeros only on the pair swap, so the
// kernel takes the 64 coefficients rot[j] = Rg[j^1, j]), then cast to bf16.
// Without a prologue the q rows are only scaled (softmax scale and log2 e)
// before the bf16 cast, as the TPU wrapper does.
//
// Design for this card (simple first version; see PERF.md for the times):
// * The TPU kernels keep the prologued K in VMEM across the q sweep of one
//   head pair. Hopper blocks run in no order and carry nothing between them,
//   so each block of 128 q rows sweeps all kv tiles itself and applies the k
//   prologue on load. This re-reads the f32 k tables once per q tile, which
//   is the first cost to remove (L2 traffic, not tensor-core time).
// * Online-max softmax in the exp2 domain (the TPU's max-free shift by a
//   table bound is a TPU trick; exact softmax is what both compute).
// * p is rounded to bf16 before p@v; l sums the f32 p; o = acc / l.
// * No TMA, wgmma or warp specialisation yet; plain loads into padded
//   shared memory. These are for the PRs that make the kernels fast.
// * Ragged Sq / Skv are masked here from the lengths: rows past Sq are not
//   stored, keys past Skv score -inf. No padded copies are made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;               // head dim
constexpr int BM = 128;             // q rows per block: 8 warps x 16 rows
constexpr int BN = 64;              // kv rows per tile
constexpr int NTHREADS = (BM / 16) * 32;
constexpr int ROWS_PER_PASS = NTHREADS / 8;  // 8 threads load one 64-wide row
constexpr int LDS = D + 8;          // smem pitch (bf16) of q/k tiles: conflict-free fragments
constexpr int LDV = BN + 8;         // smem pitch of the transposed v tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMALLKV_MAX = 512;    // kv rows held whole in shared memory
constexpr int SMALLKV_QCHUNK = 1024;  // q rows per smallkv block

}  // namespace

// Argument block shared with the Python wrapper (ctypes). Every field is
// 8 bytes wide so the layout has no padding. Strides are in elements.
struct TGAttnArgs {
  const void* q; const void* k; const void* v; void* o;
  const void* bias;                                   // [B, Skv] f32 or null
  const void* q_cos; const void* q_sin; const void* q_add; const void* q_rot;
  const void* k_cos; const void* k_sin; const void* k_add; const void* k_rot;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long q_tb, k_tb;                               // table batch strides (0 = shared)
  long long b, h, sq, skv;
  long long norm_q, norm_k;
  double qscale, eps;
};

namespace {

struct Side {
  const float* cosg; const float* sin; const float* add; const float* rot;
  long long tb; bool norm;
};

struct Acc {
  float o[8][4];
  float m[2];
  float l[2];
};

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// Loads rows [row0, row0 + nrows) of one head (``src`` already points at
// (b, h)) into shared memory ``dst`` (pitch ``ld``) as bf16. With PRO the
// qk-norm + RoPE prologue runs on the way, in f32; the result is multiplied
// by ``scale`` before the bf16 cast. Eight threads share a row, each holding
// eight consecutive values, so the LayerNorm sums are 3-step shuffles.
// ``nrows`` must be a multiple of ROWS_PER_PASS (uniform shuffles).
template <bool PRO>
__device__ void load_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, long long ss,
                          int row0, int nrows, int seqlen, const Side& pro, int b, float scale,
                          float eps) {
  const int tid = threadIdx.x;
  const int c0 = (tid & 7) * 8;
  for (int r = tid >> 3; r < nrows; r += ROWS_PER_PASS) {
    const int row = row0 + r;
    const bool valid = row < seqlen;
    float x[8];
    if (valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (long long)row * ss + c0);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    float y[8];
    if (PRO) {
      float ln0[8];
      if (pro.norm) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s += x[e];
        const float mu = row_sum8(s) * (1.f / D);
        float vs = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ln0[e] = x[e] - mu;
          vs += ln0[e] * ln0[e];
        }
        const float inv = rsqrtf(row_sum8(vs) * (1.f / D) + eps);
#pragma unroll
        for (int e = 0; e < 8; ++e) ln0[e] *= inv;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) ln0[e] = x[e];
      }
      if (valid) {
        const long long toff = (long long)b * pro.tb + (long long)row * D + c0;
        const float4* cp = reinterpret_cast<const float4*>(pro.cosg + toff);
        const float4* sp = reinterpret_cast<const float4*>(pro.sin + toff);
        const float4* ap = reinterpret_cast<const float4*>(pro.add + toff);
        const float4* rp = reinterpret_cast<const float4*>(pro.rot + c0);
        float cg[8], sn[8], ad[8], rc[8];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 c4 = cp[e], s4 = sp[e], a4 = ap[e], r4 = rp[e];
          cg[4 * e] = c4.x; cg[4 * e + 1] = c4.y; cg[4 * e + 2] = c4.z; cg[4 * e + 3] = c4.w;
          sn[4 * e] = s4.x; sn[4 * e + 1] = s4.y; sn[4 * e + 2] = s4.z; sn[4 * e + 3] = s4.w;
          ad[4 * e] = a4.x; ad[4 * e + 1] = a4.y; ad[4 * e + 2] = a4.z; ad[4 * e + 3] = a4.w;
          rc[4 * e] = r4.x; rc[4 * e + 1] = r4.y; rc[4 * e + 2] = r4.z; rc[4 * e + 3] = r4.w;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float rot = ln0[e ^ 1] * rc[e];
          y[e] = (ln0[e] * cg[e] + rot * sn[e] + ad[e]) * scale;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = x[e] * scale;
    }
    uint4 out;
    out.x = pack_bf16(y[0], y[1]);
    out.y = pack_bf16(y[2], y[3]);
    out.z = pack_bf16(y[4], y[5]);
    out.w = pack_bf16(y[6], y[7]);
    *reinterpret_cast<uint4*>(dst + r * ld + c0) = out;
  }
}

// Loads v rows [row0, row0 + nrows) transposed: dst[d * ldv + r] (so the
// p@v B-fragments are contiguous pairs along kv).
__device__ void load_vt(__nv_bfloat16* dst, int ldv, const __nv_bfloat16* src, long long ss,
                        int row0, int nrows, int seqlen) {
  const int tid = threadIdx.x;
  const int c0 = (tid & 7) * 8;
  for (int r = tid >> 3; r < nrows; r += ROWS_PER_PASS) {
    const int row = row0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < seqlen) raw = *reinterpret_cast<const uint4*>(src + (long long)row * ss + c0);
    const __nv_bfloat16* vals = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(c0 + e) * ldv + r] = vals[e];
  }
}

// A-fragments of this warp's 16 q rows (4 k-steps of 16 over d = 64).
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[4][4], const __nv_bfloat16* Qs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* p = Qs + (warp * 16 + g) * LDS + kk * 16 + t * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
  }
}

__device__ __forceinline__ void init_acc(Acc& acc) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc.o[dt][i] = 0.f;
  acc.m[0] = acc.m[1] = -INFINITY;
  acc.l[0] = acc.l[1] = 0.f;
}

// One kv tile of BN keys for this warp's 16 rows: s = q.k^T (+ bias) in the
// log2 domain, online max, p = exp2(s - m), acc = alpha*acc + bf16(p) @ v.
// ``Ks``: tile rows (pitch LDS); ``Vt``: transposed tile columns (pitch ldv).
__device__ __forceinline__ void attend_tile(const uint32_t (&qa)[4][4], const __nv_bfloat16* Ks,
                                            const __nv_bfloat16* Vt, int ldv, int kv0, int skv,
                                            const float* bias, Acc& acc) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LDS + kk * 16 + t * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
      mma16816(s[nt], qa[kk], b0, b1);
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = kv0 + nt * 8 + t * 2 + (i & 1);
      float v = s[nt][i];
      if (j >= skv) {
        v = -INFINITY;
      } else if (bias != nullptr) {
        v += bias[j] * LOG2E;
      }
      s[nt][i] = v;
      if (i < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float m0 = fmaxf(acc.m[0], mx0), m1 = fmaxf(acc.m[1], mx1);
  // a row with nothing finite yet keeps a zero shift (no inf - inf)
  const float base0 = m0 == -INFINITY ? 0.f : m0;
  const float base1 = m1 == -INFINITY ? 0.f : m1;
  const float alpha0 = exp2f(acc.m[0] - base0), alpha1 = exp2f(acc.m[1] - base1);
  acc.m[0] = m0;
  acc.m[1] = m1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = exp2f(s[nt][0] - base0);
    s[nt][1] = exp2f(s[nt][1] - base0);
    s[nt][2] = exp2f(s[nt][2] - base1);
    s[nt][3] = exp2f(s[nt][3] - base1);
    ls0 += s[nt][0] + s[nt][1];
    ls1 += s[nt][2] + s[nt][3];
  }
  acc.l[0] = acc.l[0] * alpha0 + ls0;
  acc.l[1] = acc.l[1] * alpha1 + ls1;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    acc.o[dt][0] *= alpha0;
    acc.o[dt][1] *= alpha0;
    acc.o[dt][2] *= alpha1;
    acc.o[dt][3] *= alpha1;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const __nv_bfloat16* vp = Vt + (dt * 8 + g) * ldv + j * 16 + t * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vp + 8);
      mma16816(acc.o[dt], pa, b0, b1);
    }
  }
}

// o = acc / l for this warp's 16 rows starting at q row ``q0 + warp*16``.
__device__ __forceinline__ void store_out(Acc& acc, __nv_bfloat16* o, long long os, int q0, int sq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float l0 = acc.l[0], l1 = acc.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r0 * os + c) =
          __floats2bfloat162_rn(acc.o[dt][0] / l0, acc.o[dt][1] / l0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r1 * os + c) =
          __floats2bfloat162_rn(acc.o[dt][2] / l1, acc.o[dt][3] / l1);
  }
}

__device__ __forceinline__ Side side_q(const TGAttnArgs& a) {
  return Side{static_cast<const float*>(a.q_cos), static_cast<const float*>(a.q_sin),
              static_cast<const float*>(a.q_add), static_cast<const float*>(a.q_rot), a.q_tb,
              a.norm_q != 0};
}

__device__ __forceinline__ Side side_k(const TGAttnArgs& a) {
  return Side{static_cast<const float*>(a.k_cos), static_cast<const float*>(a.k_sin),
              static_cast<const float*>(a.k_add), static_cast<const float*>(a.k_rot), a.k_tb,
              a.norm_k != 0};
}

// Grid (ceil(Sq / BM), H, B). Each block owns 128 q rows of one (b, h) and
// sweeps every kv tile. PRO_Q / PRO_K select the fused prologues. The body is
// shared; each TPU kernel gets its own __global__ below, so a trace names
// them apart.
template <bool PRO_Q, bool PRO_K>
__device__ __forceinline__ void flash_fwd_body(const TGAttnArgs& a) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * LDV];
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const float eps = static_cast<float>(a.eps);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  const Side pq = side_q(a), pk = side_k(a);

  load_rows<PRO_Q>(Qs, LDS, q, a.q_ss, q0, BM, sq, pq, b, static_cast<float>(a.qscale), eps);
  __syncthreads();
  uint32_t qa[4][4];
  load_q_frags(qa, Qs);
  Acc acc;
  init_acc(acc);
  for (int kv0 = 0; kv0 < skv; kv0 += BN) {
    __syncthreads();  // previous tile consumed by every warp
    load_rows<PRO_K>(Ks, LDS, k, a.k_ss, kv0, BN, skv, pk, b, 1.f, eps);
    load_vt(Vt, LDV, v, a.v_ss, kv0, BN, skv);
    __syncthreads();
    attend_tile(qa, Ks, Vt, LDV, kv0, skv, bias, acc);
  }
  store_out(acc, o, a.o_ss, q0, sq);
}

// K1: base joint self-attention, both prologues fused.
__global__ void __launch_bounds__(NTHREADS) joint_kernel(const TGAttnArgs a) {
  flash_fwd_body<true, true>(a);
}

// K3: vip -> [text_video || vip] cross-attention, both prologues fused.
__global__ void __launch_bounds__(NTHREADS) smallq_kernel(const TGAttnArgs a) {
  flash_fwd_body<true, true>(a);
}

// K4: plain [B, H, S, 64] attention; qscale = softmax scale * log2 e.
__global__ void __launch_bounds__(NTHREADS) bhsd_kernel(const TGAttnArgs a) {
  flash_fwd_body<false, false>(a);
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

size_t smallkv_smem_bytes(int skv) {
  const int skv_p = round_up(skv, BN);
  return sizeof(__nv_bfloat16) * (size_t)(skv_p * LDS + D * (skv_p + 8) + BM * LDS);
}

// Grid (ceil(Sq / SMALLKV_QCHUNK), H, B). K (already prologued by the
// caller, as the TPU wrapper does it in XLA) and V of one (b, h) are loaded
// whole into shared memory once; the block then runs its 1024 q rows in
// tiles of 128 against them with the q prologue fused.
__global__ void __launch_bounds__(NTHREADS) smallkv_kernel(const TGAttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int skv_p = round_up(skv, BN);
  const int ldv = skv_p + 8;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vt = Ks + skv_p * LDS;
  __nv_bfloat16* Qs = Vt + D * ldv;
  const float eps = static_cast<float>(a.eps);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  const Side pq = side_q(a), pk = side_k(a);

  load_rows<false>(Ks, LDS, k, a.k_ss, 0, skv_p, skv, pk, b, 1.f, eps);
  load_vt(Vt, ldv, v, a.v_ss, 0, skv_p, skv);
  const int qbeg = blockIdx.x * SMALLKV_QCHUNK;
  const int qend = min(sq, qbeg + SMALLKV_QCHUNK);
  for (int q0 = qbeg; q0 < qend; q0 += BM) {
    __syncthreads();  // K/V resident (first tile); Qs free (later tiles)
    load_rows<true>(Qs, LDS, q, a.q_ss, q0, BM, sq, pq, b, static_cast<float>(a.qscale), eps);
    __syncthreads();
    uint32_t qa[4][4];
    load_q_frags(qa, Qs);
    Acc acc;
    init_acc(acc);
    for (int kv0 = 0; kv0 < skv; kv0 += BN)
      attend_tile(qa, Ks + kv0 * LDS, Vt + kv0, ldv, kv0, skv, bias, acc);
    store_out(acc, o, a.o_ss, q0, sq);
  }
}

int launch_flash(void (*kernel)(TGAttnArgs), const TGAttnArgs* a, cudaStream_t stream) {
  if (a->sq <= 0 || a->skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a->sq + BM - 1) / BM), static_cast<unsigned>(a->h),
                  static_cast<unsigned>(a->b));
  kernel<<<grid, NTHREADS, 0, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tg_attention_joint(const TGAttnArgs* a, void* stream) {
  return launch_flash(joint_kernel, a, static_cast<cudaStream_t>(stream));
}

int tg_attention_cross_smallq(const TGAttnArgs* a, void* stream) {
  return launch_flash(smallq_kernel, a, static_cast<cudaStream_t>(stream));
}

int tg_attention_bhsd(const TGAttnArgs* a, void* stream) {
  return launch_flash(bhsd_kernel, a, static_cast<cudaStream_t>(stream));
}

// K2: text_video -> vip cross-attention, kv <= 512 held whole in shared memory.
int tg_attention_cross_smallkv(const TGAttnArgs* a, void* stream) {
  if (a->sq <= 0 || a->skv <= 0 || a->skv > SMALLKV_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smallkv_smem_bytes(static_cast<int>(a->skv));
  cudaError_t err = cudaFuncSetAttribute(smallkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a->sq + SMALLKV_QCHUNK - 1) / SMALLKV_QCHUNK),
                  static_cast<unsigned>(a->h), static_cast<unsigned>(a->b));
  smallkv_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
