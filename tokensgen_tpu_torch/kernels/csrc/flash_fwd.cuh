// The flash-attention pieces that the TMA / wgmma bodies of K1-K7 and the
// probes share: the argument block, the prologue tables, row loads with the
// fused qk-norm + RoPE prologue, A fragments in the mma.sync m16n8k16
// layout (that of a wgmma's A in registers), bf16
// packing, the accumulator and the output store; f32 softmax in the log2
// domain. Templated on the head dim HD (16, 32, 64, 128).
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
constexpr int NTHREADS = (BM / 16) * 32;
// smem pitch (bf16) of q/k tiles of head dim hd: conflict-free fragments, 16-byte rows
__host__ __device__ constexpr int pitch(int hd) { return hd + 8; }
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

}  // namespace
