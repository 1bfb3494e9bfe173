// The mma.sync flash-attention forward pieces shared by the attention kernels
// (attention.cu: K7's tiles, K5's loads at head dims 16, 32 and 128; the
// argument block, the prologue tables and the accumulator that the
// TMA / wgmma bodies of K1-K4 and K6 also use) and the whole body of the K4-family probes (probes.cu:
// T1, T2): bf16 operands, mma.sync m16n8k16 tensor-core tiles, f32 online
// softmax in the log2 domain, optional fused qk-norm + RoPE prologue.
// Templated on the head dim HD (16, 32, 64, 128), the q rows per block BM_
// (16 per warp), the kv tile BN_ and where the key bias and the ragged mask
// apply (every kv tile, or only the last). The probes sweep the latter.
//
// The lse the forward kernels may write is in the NATURAL log base (lse = ln
// sum_j exp(s_j), s the natural-domain scores scale*q.k + bias), as the TPU
// kernel's with_lse output; inside, the body runs in the log2 domain (log2 e
// folded into q), so it stores (m + log2 l) * ln 2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;               // head dim (K4, K5, K6: HD = 16, 32, 64 or 128)
constexpr int BM = 128;             // q rows per block: 8 warps x 16 rows
constexpr int BN = 64;              // kv rows per tile
constexpr int NTHREADS = (BM / 16) * 32;
// smem pitch (bf16) of q/k tiles of head dim hd: conflict-free fragments, 16-byte rows
__host__ __device__ constexpr int pitch(int hd) { return hd + 8; }
constexpr int LDV = BN + 8;         // smem pitch of the transposed v tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// where the key bias and the ragged-kv mask apply
constexpr int MASK_EVERY_TILE = 0;  // every kv tile (K1-K7; T1; T2 "full")
constexpr int MASK_LAST_TILE = 1;   // only the last kv tile (T2 "last")

}  // namespace

// Argument block shared with the Python wrapper (ctypes). Every field is
// 8 bytes wide so the layout has no padding. Strides are in elements.
struct TGAttnArgs {
  const void* q; const void* k; const void* v; void* o;
  const void* bias;                                   // [B, Skv] f32 or null
  void* lse;                                          // [B, H, Sq] f32 out or null
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

template <int HD>
struct AccT {
  float o[HD / 8][4];
  float m[2];
  float l[2];
};
using Acc = AccT<D>;

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

// Sum over the TPR consecutive lanes that share a row (TPR a power of two).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < TPR; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// Loads rows [row0, row0 + nrows) of one head of dim HD (``src`` already
// points at (b, h)) into shared memory ``dst`` (pitch ``ld``) as bf16, with NT
// threads. With PRO the qk-norm + RoPE prologue runs on the way, in f32; the
// result is multiplied by ``scale`` before the bf16 cast. HD / 8 threads share
// a row, each holding eight consecutive values, so the LayerNorm sums are
// log2(HD / 8)-step shuffles. ``nrows`` must be a multiple of the 256 / HD
// rows one warp covers: a warp then runs each pass whole or not at all
// (uniform shuffles).
template <bool PRO, int HD = D, int NT = NTHREADS>
__device__ void load_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, long long ss,
                          int row0, int nrows, int seqlen, const Side& pro, int b, float scale,
                          float eps) {
  constexpr unsigned TPR = HD / 8;  // threads per row (unsigned: / and % are a shift and a mask)
  const int c0 = static_cast<int>(threadIdx.x % TPR) * 8;
  constexpr int step = NT / TPR;
  for (int r = static_cast<int>(threadIdx.x / TPR); r < nrows; r += step) {
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
        const float mu = row_sum<TPR>(s) * (1.f / HD);
        float vs = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ln0[e] = x[e] - mu;
          vs += ln0[e] * ln0[e];
        }
        const float inv = rsqrtf(row_sum<TPR>(vs) * (1.f / HD) + eps);
#pragma unroll
        for (int e = 0; e < 8; ++e) ln0[e] *= inv;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) ln0[e] = x[e];
      }
      if (valid) {
        const long long toff = (long long)b * pro.tb + (long long)row * HD + c0;
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

// Loads v rows [row0, row0 + nrows) of head dim HD transposed, with NT
// threads: dst[d * ldv + r] (so the p@v B-fragments are contiguous pairs
// along kv).
template <int HD = D, int NT = NTHREADS>
__device__ void load_vt(__nv_bfloat16* dst, int ldv, const __nv_bfloat16* src, long long ss,
                        int row0, int nrows, int seqlen) {
  constexpr unsigned TPR = HD / 8;
  const int c0 = static_cast<int>(threadIdx.x % TPR) * 8;
  constexpr int step = NT / TPR;
  for (int r = static_cast<int>(threadIdx.x / TPR); r < nrows; r += step) {
    const int row = row0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < seqlen) raw = *reinterpret_cast<const uint4*>(src + (long long)row * ss + c0);
    const __nv_bfloat16* vals = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(c0 + e) * ldv + r] = vals[e];
  }
}

// A-fragments of this warp's 16 q rows (HD / 16 k-steps of 16 over the head
// dim; ``Qs`` pitch pitch(HD)).
template <int HD = D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[HD / 16][4], const __nv_bfloat16* Qs) {
  constexpr int ld = pitch(HD);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* p = Qs + (warp * 16 + g) * ld + kk * 16 + t * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
  }
}

template <int HD>
__device__ __forceinline__ void init_acc(AccT<HD>& acc) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc.o[dt][i] = 0.f;
  acc.m[0] = acc.m[1] = -INFINITY;
  acc.l[0] = acc.l[1] = 0.f;
}

// The softmax half of one kv tile of BN_ keys for this warp's 16 rows, from
// their log2-domain scores ``s`` (mma accumulator layout): key bias and the
// ragged-tile mask (on every tile, or with MASK_LAST_TILE only on the tile
// that holds the last key), online max, p = exp2(s - m), acc = alpha*acc +
// bf16(p) @ v. ``Vt``: the tile's HD transposed v columns (pitch ldv).
template <int HD, int BN_ = BN, int MASK = MASK_EVERY_TILE>
__device__ __forceinline__ void softmax_pv(float (&s)[BN_ / 8][4], const __nv_bfloat16* Vt,
                                           int ldv, int kv0, int skv, const float* bias,
                                           AccT<HD>& acc) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool mask_tile = MASK == MASK_EVERY_TILE || kv0 + BN_ >= skv;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < BN_ / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = kv0 + nt * 8 + t * 2 + (i & 1);
      float v = s[nt][i];
      if (mask_tile) {
        if (j >= skv) {
          v = -INFINITY;
        } else if (bias != nullptr) {
          v += bias[j] * LOG2E;
        }
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
  for (int nt = 0; nt < BN_ / 8; ++nt) {
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
  for (int dt = 0; dt < HD / 8; ++dt) {
    acc.o[dt][0] *= alpha0;
    acc.o[dt][1] *= alpha0;
    acc.o[dt][2] *= alpha1;
    acc.o[dt][3] *= alpha1;
  }
#pragma unroll
  for (int j = 0; j < BN_ / 16; ++j) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const __nv_bfloat16* vp = Vt + (dt * 8 + g) * ldv + j * 16 + t * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vp + 8);
      mma16816(acc.o[dt], pa, b0, b1);
    }
  }
}

// One kv tile of BN_ keys for this warp's 16 rows: s = q.k^T in the log2
// domain on bf16 tensor cores, then `softmax_pv`. ``Ks``: tile rows (pitch
// pitch(HD)).
template <int HD, int BN_ = BN, int MASK = MASK_EVERY_TILE>
__device__ __forceinline__ void attend_tile(const uint32_t (&qa)[HD / 16][4],
                                            const __nv_bfloat16* Ks, const __nv_bfloat16* Vt,
                                            int ldv, int kv0, int skv, const float* bias,
                                            AccT<HD>& acc) {
  constexpr int ld = pitch(HD);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float s[BN_ / 8][4];
#pragma unroll
  for (int nt = 0; nt < BN_ / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < BN_ / 8; ++nt) {
      const __nv_bfloat16* kp = Ks + (nt * 8 + g) * ld + kk * 16 + t * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
      mma16816(s[nt], qa[kk], b0, b1);
    }
  }
  softmax_pv<HD, BN_, MASK>(s, Vt, ldv, kv0, skv, bias, acc);
}

// o = acc / l for this warp's 16 rows starting at q row ``q0 + warp*16``
// (as acc times one reciprocal a row: 64 IEEE divisions a thread made K2's
// call 0.992 / 1.021 ms against 0.905 / 1.001 on an H100,
// tools/kernel_ablations.py); with ``lse`` (already at (b, h)), also the
// rows' natural-log logsumexp.
template <int HD>
__device__ __forceinline__ void store_out(AccT<HD>& acc, __nv_bfloat16* o, long long os, int q0,
                                          int sq, float* lse) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float l0 = acc.l[0], l1 = acc.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  if (lse != nullptr && t == 0) {
    // acc.m is the row max of the log2-domain scores (reduced over the 4
    // threads of a row in softmax_pv)
    if (r0 < sq) lse[r0] = (acc.m[0] + log2f(l0)) * LN2;
    if (r1 < sq) lse[r1] = (acc.m[1] + log2f(l1)) * LN2;
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r0 * os + c) =
          __floats2bfloat162_rn(acc.o[dt][0] * i0, acc.o[dt][1] * i0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r1 * os + c) =
          __floats2bfloat162_rn(acc.o[dt][2] * i1, acc.o[dt][3] * i1);
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

// Grid (ceil(Sq / BM_), H / heads per block, B). The block owns BM_ q rows
// (BM_ / 16 warps) of head ``h`` of batch row blockIdx.z and sweeps every kv
// tile of BN_ keys. PRO_Q / PRO_K select the fused prologues; HD is the head
// dim; MASK where the bias and the ragged mask apply. The body is shared;
// each TPU kernel gets its own __global__, so a trace names them apart.
//
// The q tile is dead once its rows sit in registers as A fragments, so the
// k and v^T tiles take its shared memory: the block holds the larger of the
// two, not their sum. At HD = 128 that is 35.8 KB of static shared memory
// (the q tile 34.8 KB, the k and v^T tiles 35.8 KB) where the three side by
// side would need 70.7 KB, above the 49,152 bytes a static allocation may
// hold.
template <int HD, int BM_, int BN_>
__host__ __device__ constexpr int fwd_smem_elems() {
  return BM_ * pitch(HD) > BN_ * pitch(HD) + HD * (BN_ + 8) ? BM_ * pitch(HD)
                                                            : BN_ * pitch(HD) + HD * (BN_ + 8);
}

template <bool PRO_Q, bool PRO_K, int HD = D, int BM_ = BM, int BN_ = BN,
          int MASK = MASK_EVERY_TILE>
__device__ __forceinline__ void flash_fwd_body(const TGAttnArgs& a, int h) {
  constexpr int ld = pitch(HD);
  constexpr int NT = (BM_ / 16) * 32;
  constexpr int ldv = BN_ + 8;
  __shared__ __align__(16) __nv_bfloat16 smem[fwd_smem_elems<HD, BM_, BN_>()];
  __nv_bfloat16* Qs = smem;             // [BM_ q rows][ld], until the fragments are loaded
  __nv_bfloat16* Ks = smem;             // [BN_ kv rows][ld]
  __nv_bfloat16* Vt = smem + BN_ * ld;  // [HD][ldv]
  const int q0 = blockIdx.x * BM_, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const float eps = static_cast<float>(a.eps);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  float* lse = a.lse ? static_cast<float*>(a.lse) + ((long long)b * a.h + h) * sq : nullptr;
  const Side pq = side_q(a), pk = side_k(a);

  load_rows<PRO_Q, HD, NT>(Qs, ld, q, a.q_ss, q0, BM_, sq, pq, b,
                           static_cast<float>(a.qscale), eps);
  __syncthreads();
  uint32_t qa[HD / 16][4];
  load_q_frags<HD>(qa, Qs);
  AccT<HD> acc;
  init_acc(acc);
  for (int kv0 = 0; kv0 < skv; kv0 += BN_) {
    __syncthreads();  // q fragments read (first tile); previous tile consumed by every warp
    load_rows<PRO_K, HD, NT>(Ks, ld, k, a.k_ss, kv0, BN_, skv, pk, b, 1.f, eps);
    load_vt<HD, NT>(Vt, ldv, v, a.v_ss, kv0, BN_, skv);
    __syncthreads();
    attend_tile<HD, BN_, MASK>(qa, Ks, Vt, ldv, kv0, skv, bias, acc);
  }
  store_out(acc, o, a.o_ss, q0, sq, lse);
}

}  // namespace
