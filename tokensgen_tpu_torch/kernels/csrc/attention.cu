// Flash-attention kernels for the attention calls of the To2V edit, training
// and generation paths and of the T2To trainer, written for Hopper (sm_90a),
// head dim 64 (K4, K5, K6: 16, 32, 64 or 128), bf16 operands with f32 softmax and
// accumulation, every product on wgmma (K7's score product in int8,
// s32.s8.s8). K3's and K4's body is the split-KV body of flash_splitkv.cuh,
// K1's, K6's and K7's the overlapped one of flash_ws.cuh (K7's with int8
// scores), K2's its K / V-resident form there; K5's one-pass body is
// flash_bwd.cuh's at 64, flash_bwd128.cuh's at 128 and flash_bwd_small.cuh's
// at 16 and 32.
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
//   tg_attention_bwd            bwd_onepass_kernel + bwd_dq_store_kernel<64> (head dim 64),
//                               bwd_onepass128_kernel + bwd_dq_store_kernel<128> (128),
//                               bwd_small_kernel<HD> + bwd_dq_store_kernel<HD> (16, 32)
//                                               <- _packed_bwd_kernel    (_flash_packed_bwd_tpu)
//   tg_attention_joint_int8     int8_prologue_kernel + joint_int8_splitkv_kernel
//                               (+ joint_int8_combine_kernel)
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
// * K1, K2, K6 and K7: the TPU kernels keep the prologued K in VMEM across the q
//   sweep of one head pair; Hopper blocks run in no order and carry nothing
//   between them, so the prologue of k and of q runs once per row in a
//   pass of its own (prologue_rows, into a bf16 workspace; K7's quantizes
//   into int8 codes and scales), and the body (flash_ws.cuh) takes q', k'
//   and v by TMA: both products on wgmma, each warpgroup's softmax
//   overlapping its other row block's p.v, no block barrier per kv tile.
//   K2's keys (<= 512) stay in shared memory while the block runs a range
//   of q tiles against them.
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
// * K5: one pass over the q tiles per block of keys, five products on
//   wgmma, dq summed across blocks by TMA reduce-adds (flash_bwd.cuh,
//   flash_bwd128.cuh, flash_bwd_small.cuh).
// * Online-max softmax in the exp2 domain (the TPU's max-free shift by a
//   table bound is a TPU trick; exact softmax is what both compute).
// * p is rounded to bf16 before p@v; l sums the f32 p; o = acc / l.
// * Ragged Sq / Skv are masked here from the lengths: rows past Sq are not
//   stored, keys past Skv score -inf. No padded copies are made.

#include "flash_bwd.cuh"
#include "flash_bwd128.cuh"
#include "flash_bwd_small.cuh"
#include "flash_fwd.cuh"
#include "flash_splitkv.cuh"
#include "flash_ws.cuh"
#include "flash_prologue.cuh"

namespace {

constexpr int SMALLKV_MAX = SK_STAGES * 128;  // K2's keys, held whole in shared memory

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
// on this card: the five products at the bf16 tensor-core rate (at head dim
// 16 the exponentials, one ex2 a score, weigh more).
//
// At head dim 64 (every launch of both full-width trainers) it is one pass,
// flash_bwd.cuh's (`bwd_onepass_kernel`, then `bwd_dq_store_kernel<64>`): a
// block owns 128 keys of one (b, h) with K and V in shared memory, streams
// the q tiles by TMA, runs the five products on wgmma and adds its share of
// dq to an f32 workspace by TMA reduce-adds. The same form serves the short
// sides of the training shapes: 480 keys give 4 blocks per (b, h), 384 in
// all for 132 SMs (2.9 waves of equal blocks), and 480 q rows 4 q tiles per
// block, 143 blocks per (b, h) adding into the same dq rows. At head dim 128
// it is the same form re-cut for the registers (flash_bwd128.cuh's
// `bwd_onepass128_kernel`, then `bwd_dq_store_kernel<128>`): q tiles of 64
// rows, dq split between the warpgroups by d columns.
//
// At head dims 16 and 32 (the tiny trainers) it is the same form re-cut for
// rows of 32 and 64 bytes and for shapes that leave 128-key blocks too few
// to fill the card (flash_bwd_small.cuh's `bwd_small_kernel<HD>`, then
// `bwd_dq_store_kernel<HD>`): a warpgroup a 64-key group, the group's q
// tiles shared between QS warpgroups of a block.
// ---------------------------------------------------------------------------

// K5 at head dim 64: flash_bwd.cuh's one-pass body, grid (ceil(Skv / 128), H,
// B); dynamic shared memory bw_smem_bytes()
__global__ void __launch_bounds__(BW_NT, 1) bwd_onepass_kernel(
    const TGAttnBwdArgs a, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dqmap,
    const float* aux) {
  bwd_onepass_body(a, &qmap, &gmap, &kmap, &vmap, &dqmap, aux);
}

// K5 at head dim 128: flash_bwd128.cuh's one-pass body, grid (ceil(Skv / 128),
// H, B); dynamic shared memory bw128_smem_bytes()
__global__ void __launch_bounds__(BW_NT, 1) bwd_onepass128_kernel(
    const TGAttnBwdArgs a, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dqmap,
    const float* aux) {
  bwd_onepass128_body(a, &qmap, &gmap, &kmap, &vmap, &dqmap, aux);
}

// K5 at head dims 16 and 32: flash_bwd_small.cuh's one-pass body, grid
// (ceil(Skv / (64 NK)), H, B) of BsGeom<HD>::NT threads; dynamic shared memory
// BsGeom<HD>::SMEM
template <int HD>
__global__ void __launch_bounds__(BsGeom<HD>::NT, BsCut<HD>::MINB) bwd_small_kernel(
    const TGAttnBwdArgs a, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dqmap,
    const float* aux) {
  bwd_small_body<HD>(a, &qmap, &gmap, &kmap, &vmap, &dqmap, aux);
}

// K5's per-q-tile table, [B * H][nq][lse2 | dsum][tile] f32, from lse and
// dsum (f32 [B * H][Sq]): lse2 = lse log2 e; past Sq lse2 = +inf and dsum =
// 0, so that p = ds = 0 on the padding rows (which the bodies read as
// zeros). One thread an entry (B * H * nq * tile threads).
__global__ void __launch_bounds__(NTHREADS) bwd_aux_kernel(const TGAttnBwdArgs a, float* aux,
                                                           int nq, int tile) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b * a.h * nq * tile) return;
  const int c = static_cast<int>(i % tile);
  const long long t = i / tile;  // (b * H + h) * nq + tile index
  const long long bh = t / nq;
  const int r = static_cast<int>(t % nq) * tile + c;
  const bool in = r < a.sq;
  aux[t * 2 * tile + c] = in ? static_cast<const float*>(a.lse)[bh * a.sq + r] * LOG2E : INFINITY;
  aux[t * 2 * tile + tile + c] = in ? static_cast<const float*>(a.dsum)[bh * a.sq + r] : 0.f;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) bwd_dq_store_kernel(const TGAttnBwdArgs a,
                                                                const float* dqws) {
  bwd_dq_store<HD>(a, dqws);
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
//   scores = int32(cq . ck^T) * (sk_j / 127) * (sq_r / 127) + bias_j * log2 e
//   out = softmax_2(scores) . v    (p rounded to bf16, f32 accumulation)
//
// Both heads of a pair share a row's scale: that is the TPU kernel's
// quantization granularity (its head pair fills the 128 lanes), kept here.
//
// Bound on this card: operations, and not the products. The score product
// runs at the int8 rate (1.96 ms at the gen path's joint shape) and p.v at
// the bf16 rate (3.93 ms), but the exponentials, one MUFU ex2 a score at 16
// a clock per SM, take ~7.3 ms: the softmax bounds K7, as it nearly does K1.
// So the design is K1's (the body that overlaps the softmax with the
// products) with the least work a score besides its exponential.
// * int8_prologue_kernel: one warp per (b, row, pair) runs the LN + RoPE
//   prologue in f32 over the pair's 128 features (4 per lane, LayerNorm sums
//   over each head's 16 lanes), reduces the absmax over the 32 lanes, and
//   writes the codes [B, S, H*64] and the scales s_r / 127 [B, H/2, S'] (S'
//   = int8_scale_stride(S): 16-byte rows for the body's tensor maps). The
//   pair-wide scale needs both heads of a row, which a per-head attention
//   block does not see, so the quantization is a pass of its own, once per
//   row (as K1's prologue pass).
// * joint_int8_splitkv_kernel: flash_ws.cuh's ws_body with int8 scores
//   (I8): the q codes and each K tile's codes by TMA (64-byte rows, the
//   64-byte swizzle), with the q tile's row scales and the K tile's key
//   scales by TMA on the same mbarriers, V by K1's bf16 map; the scores by
//   wgmma m64n128k32 s32.s8.s8 from shared memory; each s32 score to f32
//   exactly by an integer add and an FP32 add (I8_MAGIC, no I2F), times its
//   key's scale; the row scale joins the exp2's FMA; then K1's online
//   softmax, its p.v on wgmma and its turns, the tiles that need no mask in
//   a loop of their own. K1's splits (`attention.kv_split_plan`) and, at
//   more than one, joint_int8_combine_kernel.
// ---------------------------------------------------------------------------

// Quantizing prologue arguments (every field 8 bytes). x: bf16 [B, S, H*64]
// with strides sb, ss (elements), pair p at columns [128p, 128p + 128);
// codes: int8 [B, S, H*64] contiguous; scales: f32 [B, H/2,
// int8_scale_stride(S)] (the padding never written nor read).
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
  if (lane == 0)
    static_cast<float*>(a.scales)[(b * a.pairs + p) * int8_scale_stride(a.s) + row] =
        sc * (1.f / 127.f);
}

// K7's body, grid (q tiles of WS_BM x splits, H, B), as K1's; ``qsmap``
// and ``ksmap``: the maps of the scale tables (scale_map)
__global__ void __launch_bounds__(WS_NT, 1) joint_int8_splitkv_kernel(
    const TGAttnArgs a, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap qsmap, const __grid_constant__ CUtensorMap ksmap,
    int splits, int split_len, float* ws) {
  const int qt = gridDim.x / splits;
  ws_body<D, true>(a, &kmap, &vmap, &qmap, blockIdx.y, blockIdx.z, (blockIdx.x % qt) * WS_BM,
                   blockIdx.x / qt, split_len, splits, ws, &qsmap, &ksmap);
}

__global__ void __launch_bounds__(CMB_NT) joint_int8_combine_kernel(const TGAttnArgs a, int splits,
                                                                    const float* ws) {
  combine_rows<D>(a, splits, ws);
}

// K7's int8 codes [B, S, H * 64] (contiguous): a box is ``rows`` rows of one
// head's 64 bytes, in the 64-byte swizzle. The map's type is unsigned (the
// enum has no signed 8-bit type): the bits are copied as they are.
cudaError_t i8_tensor_map(CUtensorMap* map, const void* base, long long s, long long h,
                          long long b, int rows) {
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, D, s, h, b, h * D, D,
                       s * h * D, D, rows);
}

// K7's scale table [B * H / 2][int8_scale_stride(S)] f32 (one row a batch
// row and head pair), S columns: boxes of ``box`` scales of one row, no
// swizzle; columns past S read as zeros.
cudaError_t scale_map(CUtensorMap* map, const void* base, long long s, long long rows, int box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(int8_scale_stride(s)) * 4};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(box), 1};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                            strides, boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 3-D f32 tensor map of K5's dq workspace [B * H][Sq][HD]: boxes of 32
// columns x 64 rows in the 128-byte swizzle (at HD = 16 of 16 columns in the
// 64-byte one); rows past Sq are clipped.
cudaError_t dq_ws_map(CUtensorMap* map, void* base, long long sq, long long bh, int hd) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(sq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 4,
                                 static_cast<cuuint64_t>(sq) * hd * 4};
  const int cols = hd < 32 ? hd : 32;  // 128-byte rows, or at 16 64-byte ones
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
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
  constexpr int smem = [] {
    if constexpr (HD <= 64)
      return ws_smem_bytes<HD>();
    else
      return splitkv_smem_bytes<HD>();
  }();
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

// A one-pass body's inputs besides the operands: its table in ``aux`` (nq
// tiles of ``tile`` rows a (b, h): ceil(Sq / tile) rounded up to a multiple
// of ``multiple``) and dq's f32 workspace ``dqws`` [B, H, Sq, hd], zeroed.
cudaError_t bwd_prepare(const TGAttnBwdArgs* a, void* aux, int tile, int multiple, void* dqws,
                        int hd, cudaStream_t s) {
  const long long nq = (a->sq + tile * multiple - 1) / (tile * multiple) * multiple;
  const long long n = a->b * a->h * nq * tile;
  bwd_aux_kernel<<<static_cast<unsigned>((n + NTHREADS - 1) / NTHREADS), NTHREADS, 0, s>>>(
      *a, static_cast<float*>(aux), static_cast<int>(nq), tile);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dqws, 0, static_cast<size_t>(a->b * a->h * a->sq * hd) * sizeof(float),
                          s);
  return err;
}

// K5 at head dim 64: the table and the workspace, the one-pass body, then
// dq from the workspace. ``aux``: room for f32 [B * H][ceil(Sq / 128)][lse2
// | dsum][128]; ``dqws``: for f32 [B, H, Sq, 64].
int launch_bwd_onepass(const TGAttnBwdArgs* a, void* aux, void* dqws, cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0 || aux == nullptr || dqws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, gmap, kmap, vmap, dqmap;
  cudaError_t err = bwd_prepare(a, aux, BW_BQ, 1, dqws, 64, s);
  if (err == cudaSuccess)
    err = kv_tensor_map<64>(&qmap, a->q, a->sq, a->h, a->b, a->q_ss, a->q_sh, a->q_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<64>(&gmap, a->g, a->sq, a->h, a->b, a->g_ss, a->g_sh, a->g_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<64>(&kmap, a->k, a->skv, a->h, a->b, a->k_ss, a->k_sh, a->k_sb);
  if (err == cudaSuccess)
    err = kv_tensor_map<64>(&vmap, a->v, a->skv, a->h, a->b, a->v_ss, a->v_sh, a->v_sb);
  if (err == cudaSuccess) err = dq_ws_map(&dqmap, dqws, a->sq, a->b * a->h, 64);
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
  bwd_dq_store_kernel<64><<<static_cast<unsigned>((threads + NTHREADS - 1) / NTHREADS), NTHREADS,
                            0, s>>>(*a, static_cast<const float*>(dqws));
  return static_cast<int>(cudaGetLastError());
}

// K5 at head dim 128: the table and the workspace, the one-pass body, then
// dq from the workspace. ``aux``: room for f32 [B * H][ceil(Sq / 64)][lse2 |
// dsum][64]; ``dqws``: for f32 [B, H, Sq, 128].
int launch_bwd_onepass128(const TGAttnBwdArgs* a, void* aux, void* dqws, cudaStream_t s) {
  if (a->sq <= 0 || a->skv <= 0 || aux == nullptr || dqws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, gmap, kmap, vmap, dqmap;
  cudaError_t err = bwd_prepare(a, aux, B8_BQ, 1, dqws, 128, s);
  if (err == cudaSuccess)
    err = kv_tensor_map<128>(&qmap, a->q, a->sq, a->h, a->b, a->q_ss, a->q_sh, a->q_sb, B8_BQ);
  if (err == cudaSuccess)
    err = kv_tensor_map<128>(&gmap, a->g, a->sq, a->h, a->b, a->g_ss, a->g_sh, a->g_sb, B8_BQ);
  if (err == cudaSuccess)
    err = kv_tensor_map<128>(&kmap, a->k, a->skv, a->h, a->b, a->k_ss, a->k_sh, a->k_sb, B8_BKV);
  if (err == cudaSuccess)
    err = kv_tensor_map<128>(&vmap, a->v, a->skv, a->h, a->b, a->v_ss, a->v_sh, a->v_sb, B8_BKV);
  if (err == cudaSuccess) err = dq_ws_map(&dqmap, dqws, a->sq, a->b * a->h, 128);
  constexpr int smem = bw128_smem_bytes();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_onepass128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a->skv + B8_BKV - 1) / B8_BKV),
                  static_cast<unsigned>(a->h), static_cast<unsigned>(a->b));
  bwd_onepass128_kernel<<<grid, BW_NT, smem, s>>>(*a, qmap, gmap, kmap, vmap, dqmap,
                                                  static_cast<const float*>(aux));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = a->b * a->h * a->sq * 16;
  bwd_dq_store_kernel<128><<<static_cast<unsigned>((threads + NTHREADS - 1) / NTHREADS), NTHREADS,
                             0, s>>>(*a, static_cast<const float*>(dqws));
  return static_cast<int>(cudaGetLastError());
}

// K5 at head dims 16 and 32: the table and the workspace, the one-pass body,
// then dq from the workspace. ``aux``: room for f32 [B * H][2 ceil(Sq /
// 128)][lse2 | dsum][64]; ``dqws``: for f32 [B, H, Sq, HD].
template <int HD>
int launch_bwd_small(const TGAttnBwdArgs* a, void* aux, void* dqws, cudaStream_t s) {
  using S = BsGeom<HD>;
  if (a->sq <= 0 || a->skv <= 0 || aux == nullptr || dqws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int keys = S::NK * BS_KEYS;
  CUtensorMap qmap, gmap, kmap, vmap, dqmap;
  cudaError_t err = bwd_prepare(a, aux, BS_AUX_ROWS, 2, dqws, HD, s);
  if (err == cudaSuccess)
    err = kv_tensor_map<HD>(&qmap, a->q, a->sq, a->h, a->b, a->q_ss, a->q_sh, a->q_sb, S::BQ);
  if (err == cudaSuccess)
    err = kv_tensor_map<HD>(&gmap, a->g, a->sq, a->h, a->b, a->g_ss, a->g_sh, a->g_sb, S::BQ);
  if (err == cudaSuccess)
    err = kv_tensor_map<HD>(&kmap, a->k, a->skv, a->h, a->b, a->k_ss, a->k_sh, a->k_sb, keys);
  if (err == cudaSuccess)
    err = kv_tensor_map<HD>(&vmap, a->v, a->skv, a->h, a->b, a->v_ss, a->v_sh, a->v_sb, keys);
  if (err == cudaSuccess) err = dq_ws_map(&dqmap, dqws, a->sq, a->b * a->h, HD);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_small_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a->skv + keys - 1) / keys), static_cast<unsigned>(a->h),
                  static_cast<unsigned>(a->b));
  bwd_small_kernel<HD><<<grid, S::NT, S::SMEM, s>>>(*a, qmap, gmap, kmap, vmap, dqmap,
                                                    static_cast<const float*>(aux));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = a->b * a->h * a->sq * (HD / 8);
  bwd_dq_store_kernel<HD><<<static_cast<unsigned>((threads + NTHREADS - 1) / NTHREADS), NTHREADS,
                            0, s>>>(*a, static_cast<const float*>(dqws));
  return static_cast<int>(cudaGetLastError());
}

// K5's cut at head dim 16 or 32, for the smoke's log and the tests: threads
// a block, dynamic shared memory, resident blocks a SM, keys a block, q rows
// a tile, warpgroups a key group
template <int HD>
int geometry_bwd_small(long long* out) {
  using S = BsGeom<HD>;
  cudaError_t err = cudaFuncSetAttribute(bwd_small_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bwd_small_kernel<HD>, S::NT,
                                                        S::SMEM);
  out[0] = S::NT;
  out[1] = S::SMEM;
  out[2] = blocks;
  out[3] = S::NK * BS_KEYS;
  out[4] = S::BQ;
  out[5] = S::QS;
  return static_cast<int>(err);
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

// K5: attention backward, head_dim 16, 32, 64 or 128: the table and the
// workspace, the one-pass body of the head dim, then dq from ``ws`` (``aux``
// and ``ws``: room as launch_bwd_small, launch_bwd_onepass and
// launch_bwd_onepass128 take it).
int tg_attention_bwd(const TGAttnBwdArgs* a, long long head_dim, void* aux, void* ws,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_bwd_small<16>(a, aux, ws, s);
    case 32: return launch_bwd_small<32>(a, aux, ws, s);
    case 64: return launch_bwd_onepass(a, aux, ws, s);
    case 128: return launch_bwd_onepass128(a, aux, ws, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5's geometry at head dim 16 or 32 (geometry_bwd_small's six values)
int tg_attention_bwd_small_geometry(long long head_dim, long long* out) {
  switch (head_dim) {
    case 16: return geometry_bwd_small<16>(out);
    case 32: return geometry_bwd_small<32>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7: the q and k quantizing prologues, then the int8-score body in
// `splits` splits of `split_len` keys (``ws``: their f32 partials, null at
// one split), then with more than one split the combine.
int tg_attention_joint_int8(const TGQuantArgs* qa, const TGQuantArgs* ka, const TGInt8Args* a,
                            long long splits, long long split_len, void* ws, void* stream) {
  if (a->sq <= 0 || a->skv <= 0 || a->h % 2 || splits < 1 || split_len < splitkv_bn(D) ||
      split_len % splitkv_bn(D) || (splits - 1) * split_len >= a->skv ||
      splits * split_len < a->skv || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TGQuantArgs* sides[2] = {qa, ka};
  for (const TGQuantArgs* p : sides) {
    const dim3 grid(static_cast<unsigned>((p->s + QP_WARPS - 1) / QP_WARPS),
                    static_cast<unsigned>(p->pairs), static_cast<unsigned>(p->b));
    int8_prologue_kernel<<<grid, QP_WARPS * 32, 0, s>>>(*p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  TGAttnArgs p{};  // the body's: q and k are the codes (read by their maps), no lse
  p.q = a->q8;
  p.k = a->k8;
  p.v = a->v;
  p.o = a->o;
  p.bias = a->bias;
  p.v_sb = a->v_sb;
  p.v_ss = a->v_ss;
  p.v_sh = a->v_sh;
  p.o_sb = a->o_sb;
  p.o_ss = a->o_ss;
  p.o_sh = a->o_sh;
  p.b = a->b;
  p.h = a->h;
  p.sq = a->sq;
  p.skv = a->skv;
  CUtensorMap kmap, vmap, qmap, qsmap, ksmap;
  cudaError_t err = i8_tensor_map(&kmap, p.k, p.skv, p.h, p.b, splitkv_bn(D));
  if (err == cudaSuccess)
    err = kv_tensor_map<D>(&vmap, p.v, p.skv, p.h, p.b, p.v_ss, p.v_sh, p.v_sb);
  if (err == cudaSuccess) err = i8_tensor_map(&qmap, p.q, p.sq, p.h, p.b, WS_BM);
  if (err == cudaSuccess) err = scale_map(&qsmap, a->qs, p.sq, p.b * p.h / 2, WS_BM);
  if (err == cudaSuccess) err = scale_map(&ksmap, a->ks, p.skv, p.b * p.h / 2, splitkv_bn(D));
  constexpr int smem = ws_smem_bytes<D, true>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(joint_int8_splitkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qt = (p.sq + WS_BM - 1) / WS_BM;
  const dim3 grid(static_cast<unsigned>(qt * splits), static_cast<unsigned>(p.h),
                  static_cast<unsigned>(p.b));
  float* wsf = static_cast<float*>(ws);
  joint_int8_splitkv_kernel<<<grid, WS_NT, smem, s>>>(
      p, kmap, vmap, qmap, qsmap, ksmap, static_cast<int>(splits), static_cast<int>(split_len),
      wsf);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long threads = p.b * p.h * p.sq * (D / 8);
  joint_int8_combine_kernel<<<static_cast<unsigned>((threads + CMB_NT - 1) / CMB_NT), CMB_NT, 0,
                              s>>>(p, static_cast<int>(splits), wsf);
  return static_cast<int>(cudaGetLastError());
}

// K7's launch geometry, for the smoke's log: the body's dynamic shared
// memory (bytes) and threads per block.
int tg_attention_joint_int8_geometry(long long* smem, long long* threads) {
  *smem = ws_smem_bytes<D, true>();
  *threads = WS_NT;
  return 0;
}

}  // extern "C"
