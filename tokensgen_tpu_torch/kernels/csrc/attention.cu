// Flash-attention kernels for the attention calls of the To2V edit, training
// and generation paths and of the T2To trainer, written for Hopper (sm_90a),
// head dim 64 (K4, K5, K6: 16, 32, 64 or 128), bf16 operands with f32 softmax and
// accumulation (K1-K4, K6 and K5 at head dim 64: wgmma; K7 and K5 at 16, 32 and
// 128: mma.sync m16n8k16 tiles, K7's score product on m16n8k32 int8 tiles).
// K7's tile pieces are flash_fwd.cuh's, shared with the K4-family probes of
// probes.cu; K3's and K4's body is the split-KV body of flash_splitkv.cuh,
// K1's and K6's the overlapped one of flash_ws.cuh, K2's its K / V-resident
// form there; K5's one-pass body at 64 is flash_bwd.cuh's.
//
// Replaces the Pallas TPU kernels of tokensgen_tpu/kernels/attention.py:
//   tg_attention_joint          joint_prologue_kernel + joint_splitkv_kernel
//                               (+ joint_combine_kernel)
//                                               <- _flash_packed_kernel  (_flash_fused_packed_tpu)
//   tg_attention_cross_smallkv  smallkv_prologue_kernel + smallkv_kernel
//                                               <- _cross_smallkv_kernel (_flash_cross_smallkv_tpu)
//   tg_attention_cross_smallq   smallq_prologue_kernel + smallq_splitkv_kernel
//                               (+ smallq_combine_kernel)
//                                               <- _cross_smallq_kernel  (_flash_cross_smallq_tpu)
//   tg_attention_bhsd           bhsd_splitkv_kernel<HD> (+ bhsd_combine_kernel<HD>)
//                                               <- _flash_kernel         (_flash_attention_tpu)
//   tg_attention_bwd            bwd_onepass_kernel + bwd_dq_store_kernel (head dim 64),
//                               bwd_dkdv_kernel<HD> + bwd_dq_kernel<HD> (16, 32, 128)
//                                               <- _packed_bwd_kernel    (_flash_packed_bwd_tpu)
//   tg_attention_joint_int8     int8_prologue_kernel + joint_int8_kernel
//                                               <- _flash_packed_kernel, int8_scores branch
//   tg_attention_fused_bhsd     fused_bhsd_prologue_kernel<HD> + fused_bhsd_splitkv_kernel<HD>
//                               (+ fused_bhsd_combine_kernel<HD>)
//                                               <- _flash_fused_kernel   (_flash_fused_tpu)
//
// The forward kernels optionally write the per-row logsumexp of the scores,
// f32 [B, H, Sq], in the NATURAL log base (lse = ln sum_j exp(s_j), with s the
// natural-domain scores scale*q.k + bias), as the TPU kernel's with_lse output
// does. Inside, the kernels run in the log2 domain (log2 e folded into q), so
// they store (m + log2 l) * ln 2. The backward takes the same natural lse.
//
// What each computes: softmax(P_q(q) . P_k(k)^T + key_bias) . v per head,
// where the prologue P is the per-head LayerNorm (f32 statistics, eps) folded
// with interleaved RoPE as  y = ln0*cosg + (ln0 @ Rg)*sin + add  (tables from
// make_prologue; Rg = diag(g) . R has nonzeros only on the pair swap, so the
// kernel takes the 64 coefficients rot[j] = Rg[j^1, j]), then cast to bf16.
// Without a prologue the q rows are only scaled (softmax scale and log2 e)
// before the bf16 cast, as the TPU wrapper does.
//
// Design for this card (see PERF.md for the times):
// * K7 (simple first version): each block of 128 q rows sweeps the kv tiles
//   itself with synchronous loads, mma.sync. No TMA or wgmma yet.
// * K1, K2 and K6: the TPU kernels keep the prologued K in VMEM across the q
//   sweep of one head pair; Hopper blocks run in no order and carry nothing
//   between them, so the prologue of k and of q runs once per row in a
//   pass of its own (prologue_rows, into a bf16 workspace), and the body
//   (flash_ws.cuh) takes q', k' and v by TMA: both products on wgmma, each
//   warpgroup's softmax overlapping its other row block's p.v, no block
//   barrier per kv tile. K2's keys (<= 512) stay in shared memory while the
//   block runs a range of q tiles against them.
// * K3 and K4 (split-KV, TMA, wgmma): both are bound by operations (the
//   two products at the bf16 tensor-core rate: 0.22 and 0.03 ms at the
//   edit path's shapes), but a block-per-q-tile sweep left them bound by
//   latency: K4's call had 48 blocks for 132 SMs, each sweeping 281 kv
//   tiles with nothing in flight; K3's blocks each ran the k prologue on all
//   18,256 keys (4 times per key and head, 7.2 GB of f32 table reads
//   through L2). Now K3 runs its prologue once per row in a pass of its own
//   (smallq_prologue_kernel: every head of a row, the tables read once per
//   row), and both run flash_splitkv.cuh's body: the keys split by the host
//   (`attention.kv_split_plan`, the least modelled makespan), K / V tiles
//   loaded by the Tensor Memory Accelerator into a 4-stage ring, both
//   products on wgmma, 256 q rows a block at head dims <= 64; then a
//   combine of the splits' f32 partials in a fixed order.
// * K5 at head dim 64: one pass over the q tiles per block of keys, five
//   products on wgmma, dq summed across blocks by atomics (flash_bwd.cuh).
// * Online-max softmax in the exp2 domain (the TPU's max-free shift by a
//   table bound is a TPU trick; exact softmax is what both compute).
// * p is rounded to bf16 before p@v; l sums the f32 p; o = acc / l.
// * Ragged Sq / Skv are masked here from the lengths: rows past Sq are not
//   stored, keys past Skv score -inf. No padded copies are made.

#include "flash_bwd.cuh"
#include "flash_fwd.cuh"
#include "flash_splitkv.cuh"
#include "flash_ws.cuh"

namespace {

constexpr int SMALLKV_MAX = SK_STAGES * 128;  // K2's keys, held whole in shared memory

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

// K3: vip -> [text_video || vip] cross-attention, in three launches: the
// prologue pass for q and for k (`smallq_prologue_kernel`, prologue_rows at
// 64 with rows padded to PRO_ROWS; q' carries the softmax scale and log2 e),
// the split-KV body on the prologued rows (`smallq_splitkv_kernel`), and
// with more than one split the combine (`smallq_combine_kernel`).
constexpr int PRO_ROWS = prologue_block_rows(D);  // rows per K3 prologue block

__global__ void __launch_bounds__(NTHREADS) smallq_prologue_kernel(const TGAttnArgs a, int k_side,
                                                                   __nv_bfloat16* out,
                                                                   long long out_sb) {
  prologue_rows<D>(a, k_side, out, out_sb);
}

// Grid (q tiles x splits, H, B), the q tile fastest: the blocks that share
// one split's K / V run side by side and read it from L2 once.
__global__ void __launch_bounds__(SK_NT) smallq_splitkv_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, int splits, int split_len, float* ws) {
  const int qt = gridDim.x / splits;
  splitkv_body<D>(a, &kmap, &vmap, blockIdx.y, blockIdx.z, (blockIdx.x % qt) * splitkv_bm(D),
                  blockIdx.x / qt, split_len, splits, ws);
}

__global__ void __launch_bounds__(CMB_NT) smallq_combine_kernel(const TGAttnArgs a, int splits,
                                                                const float* ws) {
  combine_rows<D>(a, splits, ws);
}

// K4: plain [B, H, S, HD] attention (HD = 16, 32, 64 or 128, as the JAX
// kernel takes any head dim); qscale = softmax scale * log2 e. The split-KV
// body, then with more than one split the combine.
template <int HD>
__global__ void __launch_bounds__(SK_NT) bhsd_splitkv_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, int splits, int split_len, float* ws) {
  const int qt = gridDim.x / splits;
  splitkv_body<HD>(a, &kmap, &vmap, blockIdx.y, blockIdx.z, (blockIdx.x % qt) * splitkv_bm(HD),
                   blockIdx.x / qt, split_len, splits, ws);
}

template <int HD>
__global__ void __launch_bounds__(CMB_NT) bhsd_combine_kernel(const TGAttnArgs a, int splits,
                                                              const float* ws) {
  combine_rows<HD>(a, splits, ws);
}

// K1 (joint self-attention on merged [B, S, H * 64], both prologues) and
// K6 (the same function per head on [B, H, S, HD] operands given by
// strides, HD = 16, 32, 64 or 128; replaces _flash_fused_kernel, wrapper
// _flash_fused_tpu: what the JAX package runs for odd head counts, for
// 2 * d not a multiple of 128 and for 4-D operands; the TPU kernel's head
// blocking and lane padding have no use here; a merged tensor arrives as
// its [B, H, S, HD] view, sh = HD, ss = H * HD, without a copy). Each is
// three launches: the prologue pass of k and of q (`*_prologue_kernel`,
// prologue_rows: once per row instead of once per q tile that reads it;
// q' carries the softmax scale and log2 e), the body on q', k' and v
// (`*_splitkv_kernel`: flash_ws.cuh's overlapped body at HD <= 64,
// flash_splitkv.cuh's at 128), and with more than one split the combine
// (`*_combine_kernel`). Bound on this card: the two products at the bf16
// tensor-core rate, with the exponentials at the MUFU's rate as close a
// second.
static_assert(WS_NT == SK_NT, "the two bodies take the same block");

// flash_ws.cuh's body at HD <= 64; at 128 its two row blocks do not fit in
// registers, and a one-row-block form ran no faster than flash_splitkv.cuh's
// body on an H100
__host__ __device__ constexpr int fused_bm(int hd) { return hd <= 64 ? WS_BM : splitkv_bm(hd); }

template <int HD>
__device__ __forceinline__ void fused_body(const TGAttnArgs& a, const CUtensorMap* kmap,
                                           const CUtensorMap* vmap, const CUtensorMap* qmap,
                                           int splits, int split_len, float* ws) {
  const int qt = gridDim.x / splits;
  const int q0 = (blockIdx.x % qt) * fused_bm(HD), split = blockIdx.x / qt;
  if constexpr (HD <= 64)
    ws_body<HD>(a, kmap, vmap, qmap, blockIdx.y, blockIdx.z, q0, split, split_len, splits, ws);
  else
    splitkv_body<HD>(a, kmap, vmap, blockIdx.y, blockIdx.z, q0, split, split_len, splits, ws);
}

__global__ void __launch_bounds__(NTHREADS) joint_prologue_kernel(const TGAttnArgs a, int k_side,
                                                                  __nv_bfloat16* out,
                                                                  long long out_sb) {
  prologue_rows<D>(a, k_side, out, out_sb);
}

__global__ void __launch_bounds__(WS_NT, 1) joint_splitkv_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap qmap,
    int splits, int split_len, float* ws) {
  fused_body<D>(a, &kmap, &vmap, &qmap, splits, split_len, ws);
}

__global__ void __launch_bounds__(CMB_NT) joint_combine_kernel(const TGAttnArgs a, int splits,
                                                               const float* ws) {
  combine_rows<D>(a, splits, ws);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) fused_bhsd_prologue_kernel(const TGAttnArgs a,
                                                                       int k_side,
                                                                       __nv_bfloat16* out,
                                                                       long long out_sb) {
  prologue_rows<HD>(a, k_side, out, out_sb);
}

template <int HD>
__global__ void __launch_bounds__(WS_NT, 1) fused_bhsd_splitkv_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap qmap,
    int splits, int split_len, float* ws) {
  fused_body<HD>(a, &kmap, &vmap, &qmap, splits, split_len, ws);
}

template <int HD>
__global__ void __launch_bounds__(CMB_NT) fused_bhsd_combine_kernel(const TGAttnArgs a, int splits,
                                                                    const float* ws) {
  combine_rows<HD>(a, splits, ws);
}

// K2: text_video -> vip cross-attention, in three launches: the prologue
// pass for k and for q (`smallkv_prologue_kernel`, prologue_rows at 64; q'
// carries the softmax scale and log2 e; the k prologue that the TPU wrapper
// runs in XLA runs here), then the K / V-resident body on q', k' and v
// (`smallkv_kernel`, flash_ws.cuh's smallkv_body: a contiguous range of
// ``per_block`` q tiles of WS_BM rows a block, (b, h)-major).
__global__ void __launch_bounds__(NTHREADS) smallkv_prologue_kernel(const TGAttnArgs a, int k_side,
                                                                    __nv_bfloat16* out,
                                                                    long long out_sb) {
  prologue_rows<D>(a, k_side, out, out_sb);
}

__global__ void __launch_bounds__(WS_NT, 1) smallkv_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap qmap,
    int per_block) {
  smallkv_body<D>(a, &kmap, &vmap, &qmap, per_block);
}

// ---------------------------------------------------------------------------
// K5: the attention backward (replaces _packed_bwd_kernel, wrapper
// _flash_packed_bwd_tpu), from the forward's saved natural-log lse:
//
//   p  = exp(scale * q.k + bias - lse)        f32, rounded to bf16 for p^T @ g
//   ds = p * (g @ v^T - dsum)                 f32, rounded to bf16 for ds^T @ q, ds @ k
//   dv = p^T @ g,  dk = scale * ds^T @ q,  dq = scale * ds @ k,  dbias = sum_q ds
//
// with dsum = rowsum(g * out) per head (computed by the caller) and f32
// accumulation, the JAX kernel's rounding points. Per head: the TPU's
// head-pair block-diagonal packing is a lane trick with no use here. Bound
// on this card: the five products at the bf16 tensor-core rate.
//
// At head dim 64 (every launch of both full-width trainers) it is one pass,
// flash_bwd.cuh's (`bwd_onepass_kernel`, then `bwd_dq_store_kernel`): a
// block owns 128 keys of one (b, h) with K and V in shared memory, streams
// the q tiles by TMA, runs the five products on wgmma and adds its share of
// dq to an f32 workspace with atomics. The same form serves the short sides
// of the training shapes: 480 keys give 4 blocks per (b, h), 384 in all for
// 132 SMs (2.9 waves of equal blocks), and 480 q rows 4 q tiles per block,
// 143 blocks per (b, h) adding into the same dq rows.
//
// At head dims 16, 32 and 128 it keeps FA2's two-pass form (deterministic,
// no atomics, mma.sync): at 128 the one-pass body's dk and dv accumulators
// alone would take 128 registers a thread beside the 128 of s^T and dp^T;
// 16 and 32 carry 18 and 0 launches (the tiny To2V trainer). The head dim is
// a template parameter there: the smem tiles are [rows][HD + 8], the
// transposed ones [HD][72], the fragment loops run HD / 16 k-steps and
// HD / 8 column tiles, and the lse, dsum and bias are per row or key,
// whatever HD. The tiles are dynamic shared memory (above the 49,152 bytes
// of a static allocation at HD = 128: 53.2 KB for the dq pass, 141.3 KB for
// the dk/dv pass).
// * bwd_dkdv_kernel: a block owns 128 kv rows of one (b, h) (8 warps x 16
//   rows; K and V held as mma A fragments in registers) and sweeps every q
//   tile of 64 rows: s^T = K q^T and dp^T = V g^T, then dv += p^T g and
//   dk += ds^T q. q and g are staged row-major (for the B fragments of the
//   first two products) and transposed (for the last two). dbias is written
//   per (b, h, key); the caller sums it over heads. At HD = 128 K and V stay
//   in shared memory (69.6 KB for the block's 128 rows) and each k-step of
//   the two score products loads its two fragments from there.
// * bwd_dq_kernel: a block owns 128 q rows (q and g as A fragments) and
//   sweeps kv tiles of 64: s = q K^T, dp = g V^T, dq += ds K, with K staged
//   row-major and transposed.
// That is 7 tile products against the 5 of one pass (s and dp twice), the
// price of no cross-block reduction. Ragged Sq / Skv are masked from the
// lengths (p = 0 outside), as in the forward kernels.
// ---------------------------------------------------------------------------

constexpr int BWD_BKV = BM;   // kv rows per dk/dv block
constexpr int BWD_BQ = 64;    // q rows per step of its sweep
constexpr int BWD_BQ2 = BM;   // q rows per dq block
constexpr int BWD_BKV2 = BN;  // kv rows per step of its sweep
constexpr int LDT = 64 + 8;   // pitch of the transposed 64-column tiles

// The dk/dv pass keeps K and V in shared memory, not in registers (HD = 128)
template <int HD>
__host__ __device__ constexpr bool kv_resident() { return HD > 64; }

// dynamic shared memory of the two passes: the row-major q and g (k and v)
// tiles, the transposed ones, and the resident K and V rows
template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * BWD_BQ * pitch(HD) + 2 * HD * LDT +
                                  (kv_resident<HD>() ? 2 * BWD_BKV * pitch(HD) : 0));
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * BWD_BKV2 * pitch(HD) + HD * LDT);
}

template <typename T>
__device__ __forceinline__ T* at_head(const void* base, long long sb, long long sh, int b, int h) {
  return static_cast<T*>(const_cast<void*>(base)) + b * sb + h * sh;
}

template <int N>
__device__ __forceinline__ void zero_tile(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[n][i] = 0.f;
}

// Stores this warp's 16 rows (row0 = first row of the block) of an f32
// accumulator tile of HD columns times ``scale`` as bf16.
template <int HD>
__device__ __forceinline__ void store_rows16(const float (&acc)[HD / 8][4], __nv_bfloat16* dst,
                                             long long ss, int row0, int n, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r0 * ss + c) =
          __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
    if (r1 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r1 * ss + c) =
          __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// The A fragment of k-step kk for this warp's 16 rows of a [rows][pitch(HD)] tile.
template <int HD>
__device__ __forceinline__ void load_a_frag(uint32_t* x, const __nv_bfloat16* S, int kk) {
  constexpr int ld = pitch(HD);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const __nv_bfloat16* p = S + (warp * 16 + (lane >> 2)) * ld + kk * 16 + (lane & 3) * 2;
  x[0] = *reinterpret_cast<const uint32_t*>(p);
  x[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  x[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  x[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// Grid (ceil(Skv / 128), H, B); dynamic shared memory dkdv_smem_bytes<HD>().
template <int HD>
__global__ void __launch_bounds__(NTHREADS) bwd_dkdv_kernel(const TGAttnBwdArgs a) {
  constexpr int ld = pitch(HD);
  constexpr bool RES = kv_resident<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float lse2_s[BWD_BQ];
  __shared__ float dsum_s[BWD_BQ];
  __nv_bfloat16* Qs = buf;                                   // [64 q][ld]
  __nv_bfloat16* Gs = buf + BWD_BQ * ld;                     // [64 q][ld]
  __nv_bfloat16* Qt = buf + 2 * BWD_BQ * ld;                 // [HD d][LDT]
  __nv_bfloat16* Gt = buf + 2 * BWD_BQ * ld + HD * LDT;      // [HD d][LDT]
  __nv_bfloat16* Kr = Gt + HD * LDT;                         // RES: [128 kv][ld]
  __nv_bfloat16* Vr = Kr + BWD_BKV * ld;                     // RES: [128 kv][ld]
  const int kv0 = blockIdx.x * BWD_BKV, h = blockIdx.y, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float c1 = static_cast<float>(a.scale) * LOG2E;
  const __nv_bfloat16* q = at_head<const __nv_bfloat16>(a.q, a.q_sb, a.q_sh, b, h);
  const __nv_bfloat16* k = at_head<const __nv_bfloat16>(a.k, a.k_sb, a.k_sh, b, h);
  const __nv_bfloat16* v = at_head<const __nv_bfloat16>(a.v, a.v_sb, a.v_sh, b, h);
  const __nv_bfloat16* gg = at_head<const __nv_bfloat16>(a.g, a.g_sb, a.g_sh, b, h);
  const long long bh = (long long)b * a.h + h;
  const float* lse = static_cast<const float*>(a.lse) + bh * sq;
  const float* dsum = static_cast<const float*>(a.dsum) + bh * sq;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  const Side none{};

  // K and V rows of this block -> A fragments, staged through buf (128 rows
  // of pitch ld: the two row-major q / g tiles' room); with RES they stay
  // in Kr / Vr (visible after the sweep's first barrier) and ka / va hold
  // one k-step's fragments at a time
  constexpr int NF = RES ? 1 : HD / 16;
  uint32_t ka[NF][4], va[NF][4];
  if constexpr (RES) {
    load_rows<false, HD>(Kr, ld, k, a.k_ss, kv0, BWD_BKV, skv, none, b, 1.f, 0.f);
    load_rows<false, HD>(Vr, ld, v, a.v_ss, kv0, BWD_BKV, skv, none, b, 1.f, 0.f);
  } else {
    load_rows<false, HD>(buf, ld, k, a.k_ss, kv0, BWD_BKV, skv, none, b, 1.f, 0.f);
    __syncthreads();
    load_q_frags<HD>(ka, buf);
    __syncthreads();
    load_rows<false, HD>(buf, ld, v, a.v_ss, kv0, BWD_BKV, skv, none, b, 1.f, 0.f);
    __syncthreads();
    load_q_frags<HD>(va, buf);
  }

  // this thread's two kv rows: bias in the log2 domain, -inf past Skv
  const int rA = kv0 + warp * 16 + g, rB = rA + 8;
  const float bA = rA < skv ? (bias ? bias[rA] * LOG2E : 0.f) : -INFINITY;
  const float bB = rB < skv ? (bias ? bias[rB] * LOG2E : 0.f) : -INFINITY;
  float dk[HD / 8][4], dv[HD / 8][4];
  zero_tile(dk);
  zero_tile(dv);
  float dbA = 0.f, dbB = 0.f;

  for (int q0 = 0; q0 < sq; q0 += BWD_BQ) {
    __syncthreads();  // staging / previous tiles consumed by every warp
    load_rows<false, HD>(Qs, ld, q, a.q_ss, q0, BWD_BQ, sq, none, b, 1.f, 0.f);
    load_vt<HD>(Qt, LDT, q, a.q_ss, q0, BWD_BQ, sq);
    load_rows<false, HD>(Gs, ld, gg, a.g_ss, q0, BWD_BQ, sq, none, b, 1.f, 0.f);
    load_vt<HD>(Gt, LDT, gg, a.g_ss, q0, BWD_BQ, sq);
    if (threadIdx.x < BWD_BQ) {
      const int r = q0 + threadIdx.x;
      lse2_s[threadIdx.x] = r < sq ? lse[r] * LOG2E : INFINITY;  // p = 0 past Sq
      dsum_s[threadIdx.x] = r < sq ? dsum[r] : 0.f;
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    zero_tile(s);
    zero_tile(dp);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int f = RES ? 0 : kk;
      if constexpr (RES) {
        load_a_frag<HD>(ka[0], Kr, kk);
        load_a_frag<HD>(va[0], Vr, kk);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* qp = Qs + (nt * 8 + g) * ld + kk * 16 + t * 2;
        mma16816(s[nt], ka[f], *reinterpret_cast<const uint32_t*>(qp),
                 *reinterpret_cast<const uint32_t*>(qp + 8));
        const __nv_bfloat16* gp = Gs + (nt * 8 + g) * ld + kk * 16 + t * 2;
        mma16816(dp[nt], va[f], *reinterpret_cast<const uint32_t*>(gp),
                 *reinterpret_cast<const uint32_t*>(gp + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + t * 2 + (i & 1);
        const float p = exp2f(s[nt][i] * c1 + (i < 2 ? bA : bB) - lse2_s[col]);
        const float ds = p * (dp[nt][i] - dsum_s[col]);
        s[nt][i] = p;
        dp[nt][i] = ds;
        if (i < 2) dbA += ds; else dbB += ds;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      da[0] = pack_bf16(dp[2 * j][0], dp[2 * j][1]);
      da[1] = pack_bf16(dp[2 * j][2], dp[2 * j][3]);
      da[2] = pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]);
      da[3] = pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3]);
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const __nv_bfloat16* gtp = Gt + (dt * 8 + g) * LDT + j * 16 + t * 2;
        mma16816(dv[dt], pa, *reinterpret_cast<const uint32_t*>(gtp),
                 *reinterpret_cast<const uint32_t*>(gtp + 8));
        const __nv_bfloat16* qtp = Qt + (dt * 8 + g) * LDT + j * 16 + t * 2;
        mma16816(dk[dt], da, *reinterpret_cast<const uint32_t*>(qtp),
                 *reinterpret_cast<const uint32_t*>(qtp + 8));
      }
    }
  }

  const float scale = static_cast<float>(a.scale);
  store_rows16<HD>(dk, at_head<__nv_bfloat16>(a.dk, a.dk_sb, a.dk_sh, b, h), a.dk_ss, kv0, skv,
                   scale);
  store_rows16<HD>(dv, at_head<__nv_bfloat16>(a.dv, a.dv_sb, a.dv_sh, b, h), a.dv_ss, kv0, skv,
                   1.f);
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

// Grid (ceil(Sq / 128), H, B); dynamic shared memory dq_smem_bytes<HD>().
template <int HD>
__global__ void __launch_bounds__(NTHREADS) bwd_dq_kernel(const TGAttnBwdArgs a) {
  constexpr int ld = pitch(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float bias2_s[BWD_BKV2];
  __nv_bfloat16* Ks = buf;                       // [64 kv][ld]
  __nv_bfloat16* Vs = buf + BWD_BKV2 * ld;       // [64 kv][ld]
  __nv_bfloat16* Kt = buf + 2 * BWD_BKV2 * ld;   // [HD d][LDT]
  const int q0 = blockIdx.x * BWD_BQ2, h = blockIdx.y, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float c1 = static_cast<float>(a.scale) * LOG2E;
  const __nv_bfloat16* q = at_head<const __nv_bfloat16>(a.q, a.q_sb, a.q_sh, b, h);
  const __nv_bfloat16* k = at_head<const __nv_bfloat16>(a.k, a.k_sb, a.k_sh, b, h);
  const __nv_bfloat16* v = at_head<const __nv_bfloat16>(a.v, a.v_sb, a.v_sh, b, h);
  const __nv_bfloat16* gg = at_head<const __nv_bfloat16>(a.g, a.g_sb, a.g_sh, b, h);
  const long long bh = (long long)b * a.h + h;
  const float* lse = static_cast<const float*>(a.lse) + bh * sq;
  const float* dsum = static_cast<const float*>(a.dsum) + bh * sq;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;
  const Side none{};

  // q and g rows of this block -> A fragments, staged through Ks|Vs (128 rows)
  uint32_t qa[HD / 16][4], ga[HD / 16][4];
  load_rows<false, HD>(buf, ld, q, a.q_ss, q0, BWD_BQ2, sq, none, b, 1.f, 0.f);
  __syncthreads();
  load_q_frags<HD>(qa, buf);
  __syncthreads();
  load_rows<false, HD>(buf, ld, gg, a.g_ss, q0, BWD_BQ2, sq, none, b, 1.f, 0.f);
  __syncthreads();
  load_q_frags<HD>(ga, buf);

  const int rA = q0 + warp * 16 + g, rB = rA + 8;
  const float lA = rA < sq ? lse[rA] * LOG2E : INFINITY;
  const float lB = rB < sq ? lse[rB] * LOG2E : INFINITY;
  const float sA = rA < sq ? dsum[rA] : 0.f;
  const float sB = rB < sq ? dsum[rB] : 0.f;
  float dq[HD / 8][4];
  zero_tile(dq);

  for (int kv0 = 0; kv0 < skv; kv0 += BWD_BKV2) {
    __syncthreads();  // staging / previous tiles consumed by every warp
    load_rows<false, HD>(Ks, ld, k, a.k_ss, kv0, BWD_BKV2, skv, none, b, 1.f, 0.f);
    load_rows<false, HD>(Vs, ld, v, a.v_ss, kv0, BWD_BKV2, skv, none, b, 1.f, 0.f);
    load_vt<HD>(Kt, LDT, k, a.k_ss, kv0, BWD_BKV2, skv);
    if (threadIdx.x < BWD_BKV2) {
      const int j = kv0 + threadIdx.x;
      bias2_s[threadIdx.x] = j < skv ? (bias ? bias[j] * LOG2E : 0.f) : -INFINITY;
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    zero_tile(s);
    zero_tile(dp);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * ld + kk * 16 + t * 2;
        mma16816(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
        const __nv_bfloat16* vp = Vs + (nt * 8 + g) * ld + kk * 16 + t * 2;
        mma16816(dp[nt], ga[kk], *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + t * 2 + (i & 1);
        const float p = exp2f(s[nt][i] * c1 + bias2_s[col] - (i < 2 ? lA : lB));
        dp[nt][i] = p * (dp[nt][i] - (i < 2 ? sA : sB));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t da[4];
      da[0] = pack_bf16(dp[2 * j][0], dp[2 * j][1]);
      da[1] = pack_bf16(dp[2 * j][2], dp[2 * j][3]);
      da[2] = pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]);
      da[3] = pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3]);
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const __nv_bfloat16* ktp = Kt + (dt * 8 + g) * LDT + j * 16 + t * 2;
        mma16816(dq[dt], da, *reinterpret_cast<const uint32_t*>(ktp),
                 *reinterpret_cast<const uint32_t*>(ktp + 8));
      }
    }
  }
  store_rows16<HD>(dq, at_head<__nv_bfloat16>(a.dq, a.dq_sb, a.dq_sh, b, h), a.dq_ss, q0, sq,
                   static_cast<float>(a.scale));
}

// K5 at head dim 64: flash_bwd.cuh's one-pass body, grid (ceil(Skv / 128), H,
// B); dynamic shared memory bw_smem_bytes()
__global__ void __launch_bounds__(BW_NT, 1) bwd_onepass_kernel(
    const TGAttnBwdArgs a, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dqmap,
    const float* aux) {
  bwd_onepass_body(a, &qmap, &gmap, &kmap, &vmap, &dqmap, aux);
}

__global__ void __launch_bounds__(NTHREADS) bwd_dq_store_kernel(const TGAttnBwdArgs a,
                                                                const float* dqws) {
  bwd_dq_store(a, dqws);
}

}  // namespace

// ---------------------------------------------------------------------------
// K7: joint self-attention with the score product in int8 (the int8_scores
// branch of _flash_packed_kernel, flag of _flash_fused_packed_tpu; the
// DiT's quant_attn). What it computes, per batch row b and head h of pair
// p = h / 2:
//
//   y   = prologue(x) * scale    f32 (scale = log2 e on the q side, 1 on k)
//   s_r = max(max |y| over the 128 features of pair p in row r, 1e-30)
//   c   = clip(rint(y * (127 / s_r)), -127, 127)          int8 codes
//   scores = int32(cq . ck^T) * (sq_r / 127) * (sk_j / 127) + bias_j * log2 e
//   out = softmax_2(scores) . v    (p rounded to bf16, f32 accumulation)
//
// Both heads of a pair share a row's scale: that is the TPU kernel's
// quantization granularity (its head pair fills the 128 lanes), kept here.
//
// Design (simple first version; see PERF.md for the times):
// * int8_prologue_kernel: one warp per (b, row, pair) runs the LN + RoPE
//   prologue in f32 over the pair's 128 features (4 per lane, LayerNorm sums
//   over each head's 16 lanes), reduces the absmax over the 32 lanes, and
//   writes the codes [B, S, H*64] and the scales s_r / 127 [B, H/2, S]. The
//   pair-wide scale needs both heads of a row, which a per-head attention
//   block does not see; and the k prologue now runs once per kv row instead
//   of once per q tile, as in K1.
// * joint_int8_kernel: K1's structure (a block owns 128 q rows of one (b, h)
//   and sweeps kv tiles of 64), with the scores on mma.sync m16n8k32
//   s8 x s8 -> s32 (the B operand is the k tile row-major, which is the
//   codes' own layout), dequantized by the row and column scales, then K1's
//   online softmax, ragged-tile mask and bf16 p@v.
// Bound on this card: the two products (the score product at the int8 rate,
// p@v at the bf16 rate).
// ---------------------------------------------------------------------------

// Quantizing prologue arguments (every field 8 bytes). x: bf16 [B, S, H*64]
// with strides sb, ss (elements), pair p at columns [128p, 128p + 128);
// codes: int8 [B, S, H*64] contiguous; scales: f32 [B, H/2, S].
struct TGQuantArgs {
  const void* x; void* codes; void* scales;
  const void* cos; const void* sin; const void* add; const void* rot;
  long long sb, ss, tb;
  long long b, s, pairs, norm;
  double scale, eps;
};

// Int8-score attention arguments (every field 8 bytes): the codes and scales
// of q and k as int8_prologue_kernel writes them, v and o bf16 with strides
// in elements, bias f32 [B, Skv] or null.
struct TGInt8Args {
  const void* q8; const void* k8; const void* qs; const void* ks;
  const void* v; void* o; const void* bias;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long b, h, sq, skv;
};

namespace {

constexpr int QP_WARPS = 8;   // rows per int8_prologue_kernel block
constexpr int LDI8 = D + 16;  // smem pitch (bytes) of the int8 tiles: conflict-free fragments

__device__ __forceinline__ float half_sum16(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x;
}

// Grid (ceil(S / QP_WARPS), H/2, B); warp w takes row blockIdx.x * 8 + w.
__global__ void __launch_bounds__(QP_WARPS * 32) int8_prologue_kernel(const TGQuantArgs a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * QP_WARPS + warp;
  const int p = blockIdx.y, b = blockIdx.z;
  if (row >= a.s) return;  // the whole warp: row is uniform in it
  const int c = (lane & 15) * 4;      // column in the head
  const int col = p * 128 + lane * 4;  // column in the row
  const uint2 raw = *reinterpret_cast<const uint2*>(
      static_cast<const __nv_bfloat16*>(a.x) + b * a.sb + row * a.ss + col);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 x01 = __bfloat1622float2(h2[0]), x23 = __bfloat1622float2(h2[1]);
  float ln0[4] = {x01.x, x01.y, x23.x, x23.y};
  if (a.norm) {
    const float mu = half_sum16(ln0[0] + ln0[1] + ln0[2] + ln0[3]) * (1.f / D);
    float vs = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ln0[e] -= mu;
      vs += ln0[e] * ln0[e];
    }
    const float inv = rsqrtf(half_sum16(vs) * (1.f / D) + static_cast<float>(a.eps));
#pragma unroll
    for (int e = 0; e < 4; ++e) ln0[e] *= inv;
  }
  const long long toff = b * a.tb + row * D + c;
  const float4 cg = *reinterpret_cast<const float4*>(static_cast<const float*>(a.cos) + toff);
  const float4 sn = *reinterpret_cast<const float4*>(static_cast<const float*>(a.sin) + toff);
  const float4 ad = *reinterpret_cast<const float4*>(static_cast<const float*>(a.add) + toff);
  const float4 rc = *reinterpret_cast<const float4*>(static_cast<const float*>(a.rot) + c);
  const float cgv[4] = {cg.x, cg.y, cg.z, cg.w}, snv[4] = {sn.x, sn.y, sn.z, sn.w};
  const float adv[4] = {ad.x, ad.y, ad.z, ad.w}, rcv[4] = {rc.x, rc.y, rc.z, rc.w};
  const float scale = static_cast<float>(a.scale);
  float y[4], amax = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float rot = ln0[e ^ 1] * rcv[e];
    y[e] = (ln0[e] * cgv[e] + rot * snv[e] + adv[e]) * scale;
    amax = fmaxf(amax, fabsf(y[e]));
  }
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
  const float sc = fmaxf(amax, 1e-30f);
  const float mul = 127.f / sc;
  char4 q;
  int v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = max(-127, min(127, __float2int_rn(y[e] * mul)));
  q.x = static_cast<signed char>(v[0]);
  q.y = static_cast<signed char>(v[1]);
  q.z = static_cast<signed char>(v[2]);
  q.w = static_cast<signed char>(v[3]);
  *reinterpret_cast<char4*>(static_cast<int8_t*>(a.codes) + (b * a.s + row) * (a.pairs * 128) +
                            col) = q;
  if (lane == 0) static_cast<float*>(a.scales)[(b * a.pairs + p) * a.s + row] = sc * (1.f / 127.f);
}

__device__ __forceinline__ void mma16832_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + nrows) of one head's int8 codes (``src`` at (b, head),
// ``rs`` bytes per row) into shared memory (pitch LDI8), zeros past seqlen.
// Four threads per row, 16 bytes each.
__device__ void load_rows_i8(int8_t* dst, const int8_t* src, long long rs, int row0, int nrows,
                             int seqlen) {
  for (int i = threadIdx.x; i < nrows * 4; i += NTHREADS) {
    const int r = i >> 2, c = (i & 3) * 16;
    const int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < seqlen) v = *reinterpret_cast<const uint4*>(src + row * rs + c);
    *reinterpret_cast<uint4*>(dst + r * LDI8 + c) = v;
  }
}

// Grid (ceil(Sq / BM), H, B), as K1.
__global__ void __launch_bounds__(NTHREADS) joint_int8_kernel(const TGInt8Args a) {
  __shared__ __align__(16) int8_t Qs[BM * LDI8];
  __shared__ __align__(16) int8_t Ks[BN * LDI8];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * LDV];
  __shared__ float ksc[BN];
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int sq = static_cast<int>(a.sq), skv = static_cast<int>(a.skv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long rs = a.h * D;  // bytes per row of the codes
  const long long pair = (long long)b * (a.h / 2) + h / 2;
  const int8_t* q8 = static_cast<const int8_t*>(a.q8) + b * a.sq * rs + h * D;
  const int8_t* k8 = static_cast<const int8_t*>(a.k8) + b * a.skv * rs + h * D;
  const float* qs = static_cast<const float*>(a.qs) + pair * sq;
  const float* ks = static_cast<const float*>(a.ks) + pair * skv;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + (long long)b * skv : nullptr;

  load_rows_i8(Qs, q8, rs, q0, BM, sq);
  __syncthreads();
  // A fragments of m16n8k32 (s8): rows g / g+8, bytes t*4.. (+16) of each
  // 32-wide k step
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int8_t* p = Qs + (warp * 16 + g) * LDI8 + kk * 32 + t * 4;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDI8);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 16);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDI8 + 16);
  }
  const int r0 = q0 + warp * 16 + g;
  const float qsc0 = r0 < sq ? qs[r0] : 0.f, qsc1 = r0 + 8 < sq ? qs[r0 + 8] : 0.f;
  Acc acc;
  init_acc(acc);
  for (int kv0 = 0; kv0 < skv; kv0 += BN) {
    __syncthreads();  // previous tile consumed by every warp
    load_rows_i8(Ks, k8, rs, kv0, BN, skv);
    load_vt(Vt, LDV, v, a.v_ss, kv0, BN, skv);
    if (threadIdx.x < BN) {
      const int j = kv0 + threadIdx.x;
      ksc[threadIdx.x] = j < skv ? ks[j] : 0.f;
    }
    __syncthreads();
    int c[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nt][i] = 0;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        // B fragments: key nt*8+g, bytes t*4.. (+16) of the k step
        const int8_t* kp = Ks + (nt * 8 + g) * LDI8 + kk * 32 + t * 4;
        mma16832_s8(c[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                    *reinterpret_cast<const uint32_t*>(kp + 16));
      }
    }
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[nt][i] = static_cast<float>(c[nt][i]) * (i < 2 ? qsc0 : qsc1) *
                   ksc[nt * 8 + t * 2 + (i & 1)];
    softmax_pv(s, Vt, LDV, kv0, skv, bias, acc);
  }
  store_out(acc, o, a.o_ss, q0, sq, nullptr);
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

// The 4-D tensor map of one bf16 operand for the split-KV bodies: (columns
// HD, rows S, heads H, batch rows B) at element strides (ss, sh, sb); boxes
// of splitkv_box_cols(HD) columns x ``rows`` rows (K and V: a kv tile) in
// the swizzle of their row width; rows past S read as zeros.
template <int HD>
cudaError_t kv_tensor_map(CUtensorMap* map, const void* base, long long s, long long h,
                          long long b, long long ss, long long sh, long long sb,
                          int rows = splitkv_bn(HD)) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr int cols = splitkv_box_cols(HD);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {cols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 3-D f32 tensor map of K5's dq workspace [B * H][Sq][64]: boxes of 32
// columns x 64 rows in the 128-byte swizzle; rows past Sq are clipped.
cudaError_t dq_ws_map(CUtensorMap* map, void* base, long long sq, long long bh) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {64, static_cast<cuuint64_t>(sq), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {64 * 4, static_cast<cuuint64_t>(sq) * 64 * 4};
  const cuuint32_t box[3] = {32, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The split-KV body (and with splits > 1 the combine) of K3 or K4 at head
// dim HD. Every split but the last holds split_len keys, a whole number of
// kv tiles; the last holds the rest (at least one key).
template <int HD>
int launch_splitkv(void (*body)(TGAttnArgs, CUtensorMap, CUtensorMap, int, int, float*),
                   void (*combine)(TGAttnArgs, int, const float*), const TGAttnArgs* a,
                   long long splits, long long split_len, void* ws, cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0 || splits < 1 || split_len < splitkv_bn(HD) ||
      split_len % splitkv_bn(HD) || (splits - 1) * split_len >= a->skv ||
      splits * split_len < a->skv || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap kmap, vmap;
  cudaError_t err = kv_tensor_map<HD>(&kmap, a->k, a->skv, a->h, a->b, a->k_ss, a->k_sh, a->k_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<HD>(&vmap, a->v, a->skv, a->h, a->b, a->v_ss, a->v_sh, a->v_sb);
  constexpr int smem = splitkv_smem_bytes<HD>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(body, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qt = (a->sq + splitkv_bm(HD) - 1) / splitkv_bm(HD);
  const dim3 grid(static_cast<unsigned>(qt * splits), static_cast<unsigned>(a->h),
                  static_cast<unsigned>(a->b));
  float* wsf = static_cast<float*>(ws);
  body<<<grid, SK_NT, smem, s>>>(*a, kmap, vmap, static_cast<int>(splits),
                                 static_cast<int>(split_len), wsf);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long threads = a->b * a->h * a->sq * (HD / 8);
  combine<<<static_cast<unsigned>((threads + CMB_NT - 1) / CMB_NT), CMB_NT, 0, s>>>(
      *a, static_cast<int>(splits), wsf);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bhsd(const TGAttnArgs* a, long long splits, long long split_len, void* ws,
                cudaStream_t s) {
  return launch_splitkv<HD>(bhsd_splitkv_kernel<HD>, bhsd_combine_kernel<HD>, a, splits,
                            split_len, ws, s);
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

// K1 or K6 at head dim HD: the prologue passes into ``pro``, then the body
// on q', k' and v in ``splits`` splits of ``split_len`` keys (``ws``: their
// f32 partials, null at one split), then with more than one split the
// combine.
template <int HD>
int launch_fused(void (*prologue)(TGAttnArgs, int, __nv_bfloat16*, long long),
                 void (*body)(TGAttnArgs, CUtensorMap, CUtensorMap, CUtensorMap, int, int, float*),
                 void (*combine)(TGAttnArgs, int, const float*), const TGAttnArgs* a,
                 long long splits, long long split_len, void* pro, void* ws, cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0 || pro == nullptr || splits < 1 ||
      split_len < splitkv_bn(HD) || split_len % splitkv_bn(HD) ||
      (splits - 1) * split_len >= a->skv || splits * split_len < a->skv ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  TGAttnArgs p;
  cudaError_t err = prologue_passes<HD>(prologue, a, pro, s, &p);
  CUtensorMap kmap, vmap, qmap;
  if (err == cudaSuccess)
    err = kv_tensor_map<HD>(&kmap, p.k, p.skv, p.h, p.b, p.k_ss, p.k_sh, p.k_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<HD>(&vmap, p.v, p.skv, p.h, p.b, p.v_ss, p.v_sh, p.v_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<HD>(&qmap, p.q, p.sq, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, fused_bm(HD));
  constexpr int smem = HD <= 64 ? ws_smem_bytes<HD>() : splitkv_smem_bytes<HD>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(body, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qt = (p.sq + fused_bm(HD) - 1) / fused_bm(HD);
  const dim3 grid(static_cast<unsigned>(qt * splits), static_cast<unsigned>(p.h),
                  static_cast<unsigned>(p.b));
  float* wsf = static_cast<float*>(ws);
  body<<<grid, WS_NT, smem, s>>>(p, kmap, vmap, qmap, static_cast<int>(splits),
                                    static_cast<int>(split_len), wsf);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long threads = p.b * p.h * p.sq * (HD / 8);
  combine<<<static_cast<unsigned>((threads + CMB_NT - 1) / CMB_NT), CMB_NT, 0, s>>>(
      p, static_cast<int>(splits), wsf);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_k6(const TGAttnArgs* a, long long splits, long long split_len, void* pro, void* ws,
              cudaStream_t s) {
  return launch_fused<HD>(fused_bhsd_prologue_kernel<HD>, fused_bhsd_splitkv_kernel<HD>,
                          fused_bhsd_combine_kernel<HD>, a, splits, split_len, pro, ws, s);
}

template <int HD>
int launch_bwd(const TGAttnBwdArgs* a, cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem_kv = dkdv_smem_bytes<HD>(), smem_q = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_kv));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>((a->skv + BWD_BKV - 1) / BWD_BKV),
                     static_cast<unsigned>(a->h), static_cast<unsigned>(a->b));
  bwd_dkdv_kernel<HD><<<grid_kv, NTHREADS, smem_kv, s>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(static_cast<unsigned>((a->sq + BWD_BQ2 - 1) / BWD_BQ2),
                    static_cast<unsigned>(a->h), static_cast<unsigned>(a->b));
  bwd_dq_kernel<HD><<<grid_q, NTHREADS, smem_q, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// K5 at head dim 64: the one-pass body, then dq from the workspace. ``aux``:
// f32 [B * H][ceil(Sq / 128)][lse2 | dsum][128] (lse2 = lse log2 e; past Sq
// lse2 = +inf and dsum = 0); ``dqws``: f32 [B, H, Sq, 64], zeroed.
int launch_bwd_onepass(const TGAttnBwdArgs* a, const void* aux, void* dqws, cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0 || aux == nullptr || dqws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, gmap, kmap, vmap, dqmap;
  cudaError_t err = kv_tensor_map<64>(&qmap, a->q, a->sq, a->h, a->b, a->q_ss, a->q_sh, a->q_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<64>(&gmap, a->g, a->sq, a->h, a->b, a->g_ss, a->g_sh, a->g_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<64>(&kmap, a->k, a->skv, a->h, a->b, a->k_ss, a->k_sh, a->k_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<64>(&vmap, a->v, a->skv, a->h, a->b, a->v_ss, a->v_sh, a->v_sb);
  if (err == cudaSuccess) err = dq_ws_map(&dqmap, dqws, a->sq, a->b * a->h);
  constexpr int smem = bw_smem_bytes();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_onepass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a->skv + BW_BKV - 1) / BW_BKV),
                  static_cast<unsigned>(a->h), static_cast<unsigned>(a->b));
  bwd_onepass_kernel<<<grid, BW_NT, smem, s>>>(*a, qmap, gmap, kmap, vmap, dqmap,
                                               static_cast<const float*>(aux));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = a->b * a->h * a->sq * 8;
  bwd_dq_store_kernel<<<static_cast<unsigned>((threads + NTHREADS - 1) / NTHREADS), NTHREADS, 0,
                        s>>>(*a, static_cast<const float*>(dqws));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1: the prologue passes, the body, the combine (launch_fused); ``pro``
// holds the prologued rows (bf16, B * (Skv + Sq) * H * 64), ``ws`` the f32
// partials of `splits` > 1 splits of `split_len` keys.
int tg_attention_joint(const TGAttnArgs* a, long long splits, long long split_len, void* pro,
                       void* ws, void* stream) {
  return launch_fused<D>(joint_prologue_kernel, joint_splitkv_kernel, joint_combine_kernel, a,
                         splits, split_len, pro, ws, static_cast<cudaStream_t>(stream));
}

// K3: the q and k prologue passes into ``pro`` (bf16: q' [B][Sq_p][H * 64],
// then k' [B][Skv_p][H * 64], S_p = S rounded up to PRO_ROWS; q' carries
// a->qscale), then the split-KV body on q', k' and v; ``ws``: the f32
// partials of `splits` > 1 splits of `split_len` keys (flash_splitkv.cuh).
int tg_attention_cross_smallq(const TGAttnArgs* a, long long splits, long long split_len,
                              void* pro, void* ws, void* stream) {
  if (a->sq <= 0 || a->skv <= 0 || pro == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hd = a->h * D;
  const long long sq_p = (a->sq + PRO_ROWS - 1) / PRO_ROWS * PRO_ROWS;
  const long long skv_p = (a->skv + PRO_ROWS - 1) / PRO_ROWS * PRO_ROWS;
  __nv_bfloat16* qp = static_cast<__nv_bfloat16*>(pro);
  __nv_bfloat16* kp = qp + a->b * sq_p * hd;
  const long long rows[2] = {sq_p, skv_p};
  __nv_bfloat16* outs[2] = {qp, kp};
  for (int side = 0; side < 2; ++side) {
    const dim3 grid(static_cast<unsigned>(rows[side] / PRO_ROWS), static_cast<unsigned>(a->b));
    smallq_prologue_kernel<<<grid, NTHREADS, 0, s>>>(*a, side, outs[side], rows[side] * hd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  TGAttnArgs p = *a;
  p.q = qp;
  p.k = kp;
  p.q_sb = sq_p * hd;
  p.k_sb = skv_p * hd;
  p.q_ss = p.k_ss = hd;
  p.q_sh = p.k_sh = D;
  p.qscale = 1.0;  // folded into q' by its prologue
  return launch_splitkv<D>(smallq_splitkv_kernel, smallq_combine_kernel, &p, splits, split_len,
                           ws, s);
}

// K4: plain [B, H, S, head_dim] attention, head_dim 16, 32, 64 or 128, in
// `splits` splits of `split_len` keys (``ws``: their f32 partials, null at
// one split).
int tg_attention_bhsd(const TGAttnArgs* a, long long head_dim, long long splits,
                      long long split_len, void* ws, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_bhsd<16>(a, splits, split_len, ws, s);
    case 32: return launch_bhsd<32>(a, splits, split_len, ws, s);
    case 64: return launch_bhsd<64>(a, splits, split_len, ws, s);
    case 128: return launch_bhsd<128>(a, splits, split_len, ws, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6: fused-prologue [B, H, S, head_dim] attention, head_dim 16, 32, 64 or
// 128, as K1 (``pro`` and ``ws`` likewise, at head_dim).
int tg_attention_fused_bhsd(const TGAttnArgs* a, long long head_dim, long long splits,
                            long long split_len, void* pro, void* ws, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_k6<16>(a, splits, split_len, pro, ws, s);
    case 32: return launch_k6<32>(a, splits, split_len, pro, ws, s);
    case 64: return launch_k6<64>(a, splits, split_len, pro, ws, s);
    case 128: return launch_k6<128>(a, splits, split_len, pro, ws, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2: text_video -> vip cross-attention, Skv <= SMALLKV_MAX: the k and q
// prologue passes into ``pro`` (as K1's), then the K / V-resident body, a
// range of ``per_block`` q tiles a block.
int tg_attention_cross_smallkv(const TGAttnArgs* a, long long per_block, void* pro,
                               void* stream) {
  if (a->sq <= 0 || a->skv <= 0 || a->skv > SMALLKV_MAX || per_block < 1 || pro == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  TGAttnArgs p;
  cudaError_t err = prologue_passes<D>(smallkv_prologue_kernel, a, pro, s, &p);
  CUtensorMap kmap, vmap, qmap;
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&kmap, p.k, p.skv, p.h, p.b, p.k_ss, p.k_sh, p.k_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&vmap, p.v, p.skv, p.h, p.b, p.v_ss, p.v_sh, p.v_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&qmap, p.q, p.sq, p.h, p.b, p.q_ss, p.q_sh, p.q_sb, WS_BM);
  constexpr int smem = smallkv_smem_bytes<D>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(smallkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = p.b * p.h * ((p.sq + WS_BM - 1) / WS_BM);
  smallkv_kernel<<<static_cast<unsigned>((tiles + per_block - 1) / per_block), WS_NT, smem, s>>>(
      p, kmap, vmap, qmap, static_cast<int>(per_block));
  return static_cast<int>(cudaGetLastError());
}

// K5: attention backward, head_dim 16, 32, 64 or 128: at 64 the one-pass
// body (``aux`` and ``ws`` as launch_bwd_onepass takes them), else the dk/dv
// (and dbias) pass then the dq pass (``aux`` and ``ws`` unused).
int tg_attention_bwd(const TGAttnBwdArgs* a, long long head_dim, void* aux, void* ws,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_bwd<16>(a, s);
    case 32: return launch_bwd<32>(a, s);
    case 64: return launch_bwd_onepass(a, aux, ws, s);
    case 128: return launch_bwd<128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7: the q and k quantizing prologues, then the int8-score attention.
int tg_attention_joint_int8(const TGQuantArgs* qa, const TGQuantArgs* ka, const TGInt8Args* a,
                            void* stream) {
  if (a->sq <= 0 || a->skv <= 0 || a->h % 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TGQuantArgs* sides[2] = {qa, ka};
  for (const TGQuantArgs* p : sides) {
    const dim3 grid(static_cast<unsigned>((p->s + QP_WARPS - 1) / QP_WARPS),
                    static_cast<unsigned>(p->pairs), static_cast<unsigned>(p->b));
    int8_prologue_kernel<<<grid, QP_WARPS * 32, 0, s>>>(*p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((a->sq + BM - 1) / BM), static_cast<unsigned>(a->h),
                  static_cast<unsigned>(a->b));
  joint_int8_kernel<<<grid, NTHREADS, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
