// The prologue pass and the tensor maps of the TMA bodies, shared by
// attention.cu (K1-K3, K6, K7) and probes.cu (the max-free probes T3b and
// T5): the f32 LayerNorm + RoPE of every head of a row into a bf16
// workspace, once per row, and the 4-D tensor maps by which the bodies'
// threads have the Tensor Memory Accelerator load their tiles.

#pragma once

#include <cuda.h>

#include "flash_fwd.cuh"
#include "flash_splitkv.cuh"

namespace {

// The prologue pass of K1, K3 and K6: the f32 LayerNorm + RoPE of every head
// of a row (K1's prologue arithmetic, load_rows'), times ``scale``, into a
// contiguous bf16 workspace ``out`` ([B][S'][H * HD], batch stride
// ``out_sb``, S' >= S). Grid (ceil(S / prologue_block_rows(HD)), B); HD / 8
// threads per row, 8 columns each. A thread reads its row's table entries
// once ([S, HD] shared or [B, S, HD] per sample; they do not depend on the
// head) and keeps them in registers for every head, PRO_HEADS heads' loads
// in flight together. The operand comes by its strides (merged [B, S, H *
// HD], or K6's [B, H, S, HD] views). Bound by bytes: at K1's edit shape the
// k side reads and writes 2 x 17,776 x 3,072 bf16 once each (437 MB).
constexpr int PRO_HEADS = 16;  // heads a thread loads before it computes

__host__ __device__ constexpr int prologue_block_rows(int hd) { return NTHREADS / (hd / 8); }

template <int HD>
__device__ __forceinline__ void prologue_rows(const TGAttnArgs& a, int k_side, __nv_bfloat16* out,
                                              long long out_sb) {
  constexpr unsigned TPR = HD / 8;  // threads per row
  const int b = blockIdx.y;
  const int r = blockIdx.x * prologue_block_rows(HD) + static_cast<int>(threadIdx.x / TPR);
  const int c0 = static_cast<int>(threadIdx.x % TPR) * 8;
  const int seqlen = static_cast<int>(k_side ? a.skv : a.sq);
  const bool valid = r < seqlen;  // the same for the TPR lanes of a row
  const long long sh = k_side ? a.k_sh : a.q_sh;
  const long long sb = k_side ? a.k_sb : a.q_sb, ss = k_side ? a.k_ss : a.q_ss;
  const __nv_bfloat16* x =
      static_cast<const __nv_bfloat16*>(k_side ? a.k : a.q) + b * sb + (long long)r * ss + c0;
  const Side pro = k_side ? side_k(a) : side_q(a);
  const float scale = k_side ? 1.f : static_cast<float>(a.qscale);
  const float eps = static_cast<float>(a.eps);
  const int heads = static_cast<int>(a.h);
  __nv_bfloat16* dst = out + b * out_sb + (long long)r * heads * HD + c0;
  float cg[8], sn[8], ad[8], rc[8];
  if (valid) {
    const long long toff = (long long)b * pro.tb + (long long)r * HD + c0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 c4 = reinterpret_cast<const float4*>(pro.cosg + toff)[e];
      const float4 s4 = reinterpret_cast<const float4*>(pro.sin + toff)[e];
      const float4 a4 = reinterpret_cast<const float4*>(pro.add + toff)[e];
      const float4 r4 = reinterpret_cast<const float4*>(pro.rot + c0)[e];
      cg[4 * e] = c4.x; cg[4 * e + 1] = c4.y; cg[4 * e + 2] = c4.z; cg[4 * e + 3] = c4.w;
      sn[4 * e] = s4.x; sn[4 * e + 1] = s4.y; sn[4 * e + 2] = s4.z; sn[4 * e + 3] = s4.w;
      ad[4 * e] = a4.x; ad[4 * e + 1] = a4.y; ad[4 * e + 2] = a4.z; ad[4 * e + 3] = a4.w;
      rc[4 * e] = r4.x; rc[4 * e + 1] = r4.y; rc[4 * e + 2] = r4.z; rc[4 * e + 3] = r4.w;
    }
  }
  for (int h0 = 0; h0 < heads; h0 += PRO_HEADS) {
    uint4 raw[PRO_HEADS];
#pragma unroll
    for (int u = 0; u < PRO_HEADS; ++u) {
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (valid && h0 + u < heads) raw[u] = *reinterpret_cast<const uint4*>(x + (h0 + u) * sh);
    }
#pragma unroll
    for (int u = 0; u < PRO_HEADS; ++u) {
      if (h0 + u >= heads) break;  // the same for the whole block
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      float ln0[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        ln0[2 * e] = f.x;
        ln0[2 * e + 1] = f.y;
      }
      if (pro.norm) {
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += ln0[e];
        const float mu = row_sum<TPR>(sum) * (1.f / HD);
        float vs = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ln0[e] -= mu;
          vs += ln0[e] * ln0[e];
        }
        const float inv = rsqrtf(row_sum<TPR>(vs) * (1.f / HD) + eps);
#pragma unroll
        for (int e = 0; e < 8; ++e) ln0[e] *= inv;
      }
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float rot = ln0[e ^ 1] * rc[e];
        y[e] = (ln0[e] * cg[e] + rot * sn[e] + ad[e]) * scale;
      }
      if (valid)
        *reinterpret_cast<uint4*>(dst + (h0 + u) * HD) =
            make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                       pack_bf16(y[6], y[7]));
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (the library
// links no libcuda)
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

// The 4-D tensor map of one operand of ``esize``-byte elements (``type``):
// (columns cols, rows S, heads H, batch rows B) at element strides (ss, sh,
// sb); boxes of ``box_cols`` columns x ``rows`` rows in the swizzle of their
// row width (32, 64 or 128 bytes); rows past S read as zeros.
cudaError_t tensor_map_4d(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base,
                          int cols, long long s, long long h, long long b, long long ss,
                          long long sh, long long sb, int box_cols, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss * esize),
                                 static_cast<cuuint64_t>(sh * esize),
                                 static_cast<cuuint64_t>(sb * esize)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(rows), 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const int span = box_cols * esize;
  const CUtensorMapSwizzle swizzle = span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One bf16 operand of the split-KV bodies: boxes of splitkv_box_cols(HD)
// columns x ``rows`` rows (K and V: a kv tile).
template <int HD>
cudaError_t kv_tensor_map(CUtensorMap* map, const void* base, long long s, long long h,
                          long long b, long long ss, long long sh, long long sb,
                          int rows = splitkv_bn(HD)) {
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, HD, s, h, b, ss, sh, sb,
                       splitkv_box_cols(HD), rows);
}

// The prologue passes of k and q (q' scaled by a->qscale) into ``pro``
// (bf16 k' [B][Skv][H * HD], then q' [B][Sq][H * HD]); ``p`` gets the
// arguments of a body on q', k' and v.
template <int HD>
cudaError_t prologue_passes(void (*prologue)(TGAttnArgs, int, __nv_bfloat16*, long long),
                            const TGAttnArgs* a, void* pro, cudaStream_t s, TGAttnArgs* p) {
  const long long hd = a->h * HD;
  __nv_bfloat16* kp = static_cast<__nv_bfloat16*>(pro);
  __nv_bfloat16* qp = kp + a->b * a->skv * hd;
  constexpr int rows = prologue_block_rows(HD);
  for (int side = 1; side >= 0; --side) {
    const long long n = side ? a->skv : a->sq;
    const dim3 grid(static_cast<unsigned>((n + rows - 1) / rows), static_cast<unsigned>(a->b));
    prologue<<<grid, NTHREADS, 0, s>>>(*a, side, side ? kp : qp, n * hd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  *p = *a;
  p->k = kp;
  p->k_sb = a->skv * hd;
  p->k_ss = hd;
  p->k_sh = HD;
  p->q = qp;
  p->q_sb = a->sq * hd;
  p->q_ss = hd;
  p->q_sh = HD;
  p->qscale = 1.0;  // folded into q' by its prologue
  return cudaSuccess;
}

}  // namespace
