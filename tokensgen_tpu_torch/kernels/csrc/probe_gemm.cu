// T7, tg_probe_matmul (<- tools/bench_matmul_pallas.py `_mm_kernel`, the
// JAX package's blocked bf16 GEMM): C = bf16(sum_k f32(a[m, k] b[k, n])), a
// [M, K] and b [K, N] bf16 row-major (K and N multiples of 8: TMA's 16-byte
// row strides), an f32 accumulator, C [M, N] bf16.
//
// Bound: 2 M K N operations at the bf16 tensor-core rate; at the DiT's dense
// shapes (M = 36,352) the bytes read and written once take 2-5% of that.
//
// A Hopper GEMM, written here from inline PTX (no CUTLASS or cuBLAS code):
// * Persistent: one block an SM, block i taking tiles i, i + grid, ... of
//   the GM_BM x GM_BN output tiles in a grouped raster order: GM_GROUP row
//   tiles a group, column by column within it, so that the tiles in flight
//   share their a rows and b columns in L2 (`probes.matmul_tiles` is the
//   same order).
// * Loads by TMA: a k tile of a is one box of GM_BM rows x 64 columns
//   (K-major), of b GM_BN / 64 boxes of 64 k rows x 64 columns, read as they
//   lie (N-major) by wgmma's transpose mode: nothing goes through
//   registers. The 128-byte swizzle; rows and columns past the tensor read
//   as zeros, so the ragged M, N and K edges need no code. The k tiles
//   stream through a ring of GM_STAGES slots (tma_ring.cuh) that runs on
//   across tiles: the next tile's first k tiles land during this tile's
//   last products and its epilogue. A third, producer warpgroup issues them
//   (one thread; its registers handed to the consumers by setmaxnreg; 384
//   threads cap the launch at 168 registers a thread, which the consumers
//   fit without spilling). With one consumer thread issuing them instead,
//   that thread's branch in the k loop, taken while the last k tile's wgmma
//   runs, made ptxas serialize every wgmma (C7518, "WG.DP in divergent
//   path"): twice the time.
// * Two consumer warpgroups, each GM_BM / 2 rows x GM_BN columns of the
//   tile, wgmma SS (m64 x GM_BN x k16, f32 accumulators in registers). A
//   tile's first k step takes scale-d 0, so no instruction but wgmma writes
//   the accumulators (ptxas serializes the products otherwise); k tile kt's
//   products are issued before kt - 1's are waited for and kt - 1's slot is
//   released.
// * Epilogue: f32 -> bf16 into 64 x 64 boxes of shared memory in the
//   128-byte swizzle (no bank conflicts), each written out by a TMA store
//   that clips the ragged edges, two boxes a warpgroup in flight.
// tools/kernel_ablations.py times each choice against its removal.

#include <cuda.h>

#include "flash_prologue.cuh"
#include "tma_ring.cuh"

// T7 arguments shared with the Python wrapper (every field 8 bytes).
struct TGMatmulArgs {
  const void* a; const void* b; void* c;
  long long m, k, n;
};

// d (m64 x N f32) += A (m64 x k16 from shared memory, K-major) x B (k16 x N
// from shared memory, N-major: the transpose flag); scale_d = 0 ignores d.
// Members of a class template outside the anonymous namespace, so that the
// shape a build leaves unused draws no warning.
template <int N>
struct WgmmaTB;

template <>
struct WgmmaTB<128> {
  __device__ static __forceinline__ void mma(float (&d)[16][4], uint64_t adesc, uint64_t bdesc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(adesc), "l"(bdesc), "r"(scale_d));
  }
};

template <>
struct WgmmaTB<256> {
  __device__ static __forceinline__ void mma(float (&d)[32][4], uint64_t adesc, uint64_t bdesc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "l"(adesc), "l"(bdesc), "r"(scale_d));
  }
};


namespace {

constexpr int GM_BM = 128;                              // rows of an output tile (128 or 256)
constexpr int GM_BN = 256;                              // its columns (128 or 256)
constexpr int GM_BK = 64;                               // k tile (a 128-byte row of a)
constexpr int GM_STAGES = 4;                            // slots of the k-tile ring
constexpr int GM_GROUP = 8;                             // row tiles a raster group
constexpr int GM_WG_ROWS = GM_BM / 2;                   // rows a consumer warpgroup
constexpr int GM_MB = GM_WG_ROWS / 64;                  // its m64 row blocks
constexpr int GM_CONSUMERS = 256;                       // two warpgroups
constexpr int GM_NT = GM_CONSUMERS + 128;               // and the producer
constexpr uint32_t GM_A = GM_BM * 128;                  // a's k tile
constexpr uint32_t GM_BBOX = GM_BK * 128;               // one box of b's k tile
constexpr uint32_t GM_STAGE = GM_A + GM_BN / 64 * GM_BBOX;
constexpr int GM_EPI_BUFS = 2;                          // epilogue boxes a warpgroup
constexpr uint32_t GM_EPI_BOX = 64 * 128;               // 64 rows x 64 bf16 columns
constexpr uint32_t GM_EPI = 2 * GM_EPI_BUFS * GM_EPI_BOX;
static_assert((GM_BM == 128 || GM_BM == 256) && (GM_BN == 128 || GM_BN == 256),
              "tiles of 128 or 256");
static_assert(GM_MB * GM_BN <= 256, "at most 128 accumulator registers a thread");

// dynamic shared memory: alignment slack, the ring, the epilogue's boxes,
// the full and empty mbarriers
__host__ __device__ constexpr int gemm_smem_bytes() {
  return static_cast<int>(1024 + GM_STAGES * GM_STAGE + GM_EPI) + 16 * GM_STAGES;
}
static_assert(gemm_smem_bytes() <= 232448, "more shared memory than a block has");

// output tile ``tile`` of the grouped raster order -> (row tile, column tile)
__device__ __forceinline__ void tile_coords(int tile, int tm, int tn, int& mt, int& nt) {
  const int per_group = GM_GROUP * tn;
  const int first = tile / per_group * GM_GROUP;
  const int rows = min(tm - first, GM_GROUP);
  const int r = tile % per_group;
  mt = first + r % rows;
  nt = r / rows;
}

// one 64 x 64 box of shared memory into the tensor of ``map`` at (c0, c1),
// in the issuing thread's bulk async-group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Grid: min(tiles, SMs) blocks. amap: a (boxes of 64 columns x GM_BM rows);
// bmap: b and cmap: C (64 x 64).
__global__ void __launch_bounds__(GM_NT, 1) gemm_kernel(const __grid_constant__ CUtensorMap amap,
                                                        const __grid_constant__ CUtensorMap bmap,
                                                        const __grid_constant__ CUtensorMap cmap,
                                                        int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring_base = align1024(smem_raw);
  unsigned char* epi = ring_base + GM_STAGES * GM_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + GM_EPI);
  const int tm = (M + GM_BM - 1) / GM_BM, tn = (N + GM_BN - 1) / GM_BN;
  const int nk = (K + GM_BK - 1) / GM_BK;
  const int count = (tm * tn - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x);  // this block's tiles
  // step n: this block's tile n / nk, its k tile n % nk
  StepRing<GM_STAGES> ring{full, full + GM_STAGES, 0, count * nk};
  auto load = [&](int n, int slot) {
    unsigned char* dst = ring_base + slot * GM_STAGE;
    int mt, nt;
    tile_coords(blockIdx.x + n / nk * gridDim.x, tm, tn, mt, nt);
    const int k0 = n % nk * GM_BK;
    mbar_expect_tx(ring.full + slot, GM_STAGE);
    tma_load_2d(dst, &amap, ring.full + slot, k0, mt * GM_BM);
#pragma unroll
    for (int j = 0; j < GM_BN / 64; ++j)
      tma_load_2d(dst + GM_A + j * GM_BBOX, &bmap, ring.full + slot, nt * GM_BN + j * 64, k0);
  };
  if (threadIdx.x == 0) {
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the mbarriers' initialization

  const int warp = threadIdx.x >> 5, wg = warp >> 2;
  if (wg == 2) {  // the producer: every load, in step order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == GM_CONSUMERS) ring.fill(ring.total, load);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wtid = threadIdx.x & 127, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wrow = (warp & 3) * 16 + g;  // this thread's first row in a row block
    float acc[GM_MB][GM_BN / 8][4];
    for (int i = 0; i < count; ++i) {
      int mt, nt;
      tile_coords(blockIdx.x + i * gridDim.x, tm, tn, mt, nt);
      for (int kt = 0; kt < nk; ++kt) {
        const int n = i * nk + kt;
        ring.wait(n);
        const unsigned char* st = ring_base + n % GM_STAGES * GM_STAGE;
        // k step kk: 32 bytes on within a's rows, 16 rows (2 x 1,024 bytes) on in b's boxes
        const uint64_t adesc = smem_desc(st + wg * GM_WG_ROWS * 128, 16, 1024, 1);
        const uint64_t bdesc = smem_desc(st + GM_A, GM_BBOX, 1024, 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GM_BK / 16; ++kk)
#pragma unroll
          for (int mb = 0; mb < GM_MB; ++mb)
            WgmmaTB<GM_BN>::mma(acc[mb], adesc + mb * (64 * 128 / 16) + kk * 2, bdesc + kk * 128,
                                kt > 0 || kk > 0);
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();
          ring.release(n - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < GM_MB; ++mb) pin_regs(acc[mb]);
      ring.release(i * nk + nk - 1);
      const int r0 = mt * GM_BM + wg * GM_WG_ROWS;  // this warpgroup's first row
#pragma unroll
      for (int mb = 0; mb < GM_MB; ++mb) {
#pragma unroll
        for (int j = 0; j < GM_BN / 64; ++j) {
          // box (mb, j) through buffer e % GM_EPI_BUFS, once its last store has read it
          const int e = mb * (GM_BN / 64) + j;
          unsigned char* box = epi + (wg * GM_EPI_BUFS + e % GM_EPI_BUFS) * GM_EPI_BOX;
          if (wtid == 0)
            asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(GM_EPI_BUFS - 1) : "memory");
          wg_sync(wg);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            unsigned char* cell = box + wrow * 128 + ((q ^ g) << 4) + t * 4;
            *reinterpret_cast<uint32_t*>(cell) =
                pack_bf16(acc[mb][j * 8 + q][0], acc[mb][j * 8 + q][1]);
            *reinterpret_cast<uint32_t*>(cell + 8 * 128) =
                pack_bf16(acc[mb][j * 8 + q][2], acc[mb][j * 8 + q][3]);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          wg_sync(wg);
          if (wtid == 0) {
            tma_store_2d(&cmap, box, nt * GM_BN + j * 64, r0 + mb * 64);
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          }
        }
      }
    }
    if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// The 2-D tensor map of a row-major bf16 [rows][cols] operand: boxes of 64
// columns (128 bytes, the 128-byte swizzle) x ``box_rows`` rows; past the
// tensor, loads read zeros and stores are clipped.
cudaError_t gemm_map(CUtensorMap* map, const void* base, long long cols, long long rows,
                     int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * 2)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// T7: K and N multiples of 8, the three pointers 16-byte aligned.
int tg_probe_matmul(const TGMatmulArgs* p, void* stream) {
  if (p->m <= 0 || p->k <= 0 || p->n <= 0 || p->k % 8 || p->n % 8 ||
      (reinterpret_cast<uintptr_t>(p->a) | reinterpret_cast<uintptr_t>(p->b) |
       reinterpret_cast<uintptr_t>(p->c)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap amap, bmap, cmap;
  cudaError_t err = gemm_map(&amap, p->a, p->k, p->m, GM_BM);
  if (err == cudaSuccess) err = gemm_map(&bmap, p->b, p->n, p->k, GM_BK);
  if (err == cudaSuccess) err = gemm_map(&cmap, p->c, p->n, p->m, 64);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int smem = gemm_smem_bytes();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = ((p->m + GM_BM - 1) / GM_BM) * ((p->n + GM_BN - 1) / GM_BN);
  const long long grid = tiles < sms ? tiles : sms;
  gemm_kernel<<<static_cast<unsigned>(grid), GM_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      amap, bmap, cmap, static_cast<int>(p->m), static_cast<int>(p->n), static_cast<int>(p->k));
  return static_cast<int>(cudaGetLastError());
}

// T7's build: tile rows, tile columns, k tile, ring slots, threads, dynamic
// shared memory (bytes), raster group.
int tg_probe_matmul_geometry(long long* out) {
  const long long g[7] = {GM_BM, GM_BN, GM_BK, GM_STAGES, GM_NT, gemm_smem_bytes(), GM_GROUP};
  for (int i = 0; i < 7; ++i) out[i] = g[i];
  return 0;
}

}  // extern "C"
