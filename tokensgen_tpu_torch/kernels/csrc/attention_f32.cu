// K4 on float32 operands: plain [B, H, S, head_dim] attention in float32 for
// Hopper (sm_90a), the body `flash_attention_bhsd` takes for float32 tensors
// (the DINOv2 image encoder hands its float32 q / k / v to the TPU's
// `_flash_kernel`, tokensgen_tpu/kernels/attention.py:54, through
// `flash_attention`). The bfloat16 body stays in attention.cu.
//
//   tg_attention_bhsd_f32   bhsd_f32_kernel<HD>, head_dim 16, 32 or 64
//
// What it computes: softmax(scale * q . k^T + key_bias) . v per (b, h), every
// product and the softmax in float32 on the CUDA cores (FMA), so the result
// keeps float32 precision (no TF32, no bfloat16 rounding anywhere).
//
// Design (a simple, correct body; speed work is for later):
// * one block of F32_BQ threads per F32_BQ q rows of one (b, h); each thread
//   owns one q row: the row, pre-scaled by scale * log2 e, and its output
//   accumulator live in registers;
// * the keys stream through shared memory in tiles of F32_BN (K and V rows
//   and the tile's key bias), loaded by all threads with 16-byte loads; the
//   threads then read them by broadcast (every thread of a warp reads the
//   same address), 4 FMAs a 16-byte load;
// * online softmax in the exp2 domain: per tile the running max, the rescale
//   of l and of the accumulator, p = exp2(s - m), l += p, acc += p * v;
// * ragged lengths are masked from the lengths: rows past Sq are computed on
//   zeros and not stored, keys past Skv score -inf (their K / V rows load as
//   zeros). No padded copies are made.

#include <cuda_runtime.h>
#include <math.h>

#define F32_BQ 64  // q rows (threads) a block
#define F32_BN 32  // keys a tile

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

static constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__global__ void __launch_bounds__(F32_BQ) bhsd_f32_kernel(const TGF32Args a) {
  constexpr int BN = F32_BN;
  constexpr int V4 = D / 4;  // 16-byte vectors a row
  __shared__ __align__(16) float ks[BN * D];
  __shared__ __align__(16) float vs[BN * D];
  __shared__ float bs[BN];

  const long long row = static_cast<long long>(blockIdx.x) * F32_BQ + threadIdx.x;
  const long long hh = blockIdx.y, bb = blockIdx.z;
  const bool valid = row < a.sq;
  const float qscale = static_cast<float>(a.qscale);

  float q[D], acc[D];
  {
    const float* qp = a.q + bb * a.q_sb + hh * a.q_sh + (valid ? row : 0) * a.q_ss;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      float4 x = valid ? *reinterpret_cast<const float4*>(qp + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      q[c] = x.x * qscale;
      q[c + 1] = x.y * qscale;
      q[c + 2] = x.z * qscale;
      q[c + 3] = x.w * qscale;
      acc[c] = acc[c + 1] = acc[c + 2] = acc[c + 3] = 0.f;
    }
  }
  const float* kb = a.k + bb * a.k_sb + hh * a.k_sh;
  const float* vb = a.v + bb * a.v_sb + hh * a.v_sh;
  const float* biasb = a.bias != nullptr ? a.bias + bb * a.skv : nullptr;
  float m = -INFINITY, l = 0.f;

  for (long long j0 = 0; j0 < a.skv; j0 += BN) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BN * V4; i += F32_BQ) {
      const int j = i / V4, c = (i % V4) * 4;
      const long long key = j0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < a.skv) {
        kx = *reinterpret_cast<const float4*>(kb + key * a.k_ss + c);
        vx = *reinterpret_cast<const float4*>(vb + key * a.v_ss + c);
      }
      *reinterpret_cast<float4*>(ks + j * D + c) = kx;
      *reinterpret_cast<float4*>(vs + j * D + c) = vx;
    }
    if (threadIdx.x < BN) {
      const long long key = j0 + threadIdx.x;
      bs[threadIdx.x] = key < a.skv ? (biasb != nullptr ? biasb[key] * kLog2e : 0.f) : -INFINITY;
    }
    __syncthreads();

    float s[BN];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + j * D + c);
        x0 = fmaf(q[c], kk.x, x0);
        x1 = fmaf(q[c + 1], kk.y, x1);
        x0 = fmaf(q[c + 2], kk.z, x0);
        x1 = fmaf(q[c + 3], kk.w, x1);
      }
      s[j] = (x0 + x1) + bs[j];
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
    const float alpha = exp2f(m - base);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float p = exp2f(s[j] - base);
      l += p;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * D + c);
        acc[c] = fmaf(p, vv.x, acc[c]);
        acc[c + 1] = fmaf(p, vv.y, acc[c + 1]);
        acc[c + 2] = fmaf(p, vv.z, acc[c + 2]);
        acc[c + 3] = fmaf(p, vv.w, acc[c + 3]);
      }
    }
    m = m_new;
  }

  if (valid) {
    const float inv = 1.f / l;
    float* op = a.o + bb * a.o_sb + hh * a.o_sh + row * a.o_ss;
#pragma unroll
    for (int c = 0; c < D; c += 4)
      *reinterpret_cast<float4*>(op + c) =
          make_float4(acc[c] * inv, acc[c + 1] * inv, acc[c + 2] * inv, acc[c + 3] * inv);
  }
}

template <int D>
static int launch_f32(const TGF32Args* a, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a->sq + F32_BQ - 1) / F32_BQ),
                  static_cast<unsigned>(a->h), static_cast<unsigned>(a->b));
  bhsd_f32_kernel<D><<<grid, F32_BQ, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

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

}  // extern "C"
