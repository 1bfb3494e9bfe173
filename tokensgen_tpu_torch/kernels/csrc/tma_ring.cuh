// The ring of TMA-loaded shared-memory slots that the probes' Hopper bodies
// share (probes_maxfree.cuh's T3a, T3b and T5; probe_gemm.cu's T7): one
// thread fills the slots in step order, each step's boxes completing on the
// slot's "full" mbarrier; the consumer warps release a slot on its "empty"
// mbarrier once their products have read it, with no block barrier.

#pragma once

#include "flash_splitkv.cuh"

namespace {

// the first 1,024-byte boundary of dynamic shared memory (swizzled boxes
// start on one), as an offset from ``p`` so that the compiler keeps
// shared-memory loads and stores (through an integer it would go generic)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// true if the phase of ``bar`` with the given parity has completed (no wait)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// the 128 threads of warpgroup ``wg`` meet (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Slots filled in step order by one thread (the loader) and released by
// WARPS consumer warps. Step n lives in slot n % S; it may be loaded once
// step n - S is released.
template <int S, int WARPS = 8>
struct StepRing {
  uint64_t* full;   // [S], one arrival (the loader's expect_tx) and the bytes
  uint64_t* empty;  // [S], one arrival per consumer warp
  int next;         // the loader's next step to load
  int total;

  __device__ void init() {  // one thread, before a block barrier
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, WARPS);
    }
  }
  // The loader: every step up to ``need`` loaded (waiting for slots), then
  // as many more as have free slots (not waiting).
  template <typename Load>
  __device__ void fill(int need, Load&& load) {
    while (next < total) {
      if (next >= S) {
        const unsigned parity = ((next / S) - 1) & 1;
        if (next <= need)
          mbar_wait(empty + next % S, parity);
        else if (!mbar_test(empty + next % S, parity))
          return;
      }
      load(next, next % S);
      ++next;
    }
  }
  __device__ void wait(int n) const { mbar_wait(full + n % S, (n / S) & 1); }
  // lane 0 of each warp arrives, by a predicate inside one instruction: a
  // branch here, taken while a wgmma is in flight, made ptxas serialize
  // every wgmma (C7518, "WG.DP in divergent path")
  __device__ void release(int n) const {
    asm volatile(
        "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_addr(empty + n % S)),
        "r"(threadIdx.x & 31)
        : "memory");
  }
};

}  // namespace
