// Hopper (sm_90a) asynchronous copies and the synchronisation around them:
// mbarriers (with expected transaction bytes, as TMA completes them), bulk
// copies between global and shared memory without a tensor map (with L2
// eviction policies), the proxy fence, and grid-wide counters in device
// memory (release adds, acquire waits). Used by wgmma_tiles.cuh (the TMA
// tile loads of linear.cu, attention.cu and streaming_attention.cu) and by
// AdaGN's one-pass kernel (adagn.cu). One copy of each primitive lives
// here.
#pragma once

#include "common.cuh"

// -------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); then a
// __syncthreads() before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// This thread's arrival, and `bytes` more of transactions (TMA writes) the
// current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed (a barrier starts
// in phase 0; its k-th completion ends the phase of parity k % 2). A wait
// that lasts about 2^34 cycles (seconds) traps: a parity slip then fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// ------------------------------------------ bulk copies (TMA without a map)

// L2 eviction policies for the bulk copies below: lines a kernel reads
// again soon (evict_last), lines it is done with (evict_first).
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of contiguous
// global memory at src into shared memory at dst under an L2 policy,
// completing `bytes` of bar's transactions when they land.
__device__ __forceinline__ void bulk_load_hint(void* dst, const void* src,
                                               unsigned bytes, uint64_t* bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// `bytes` of shared memory at src to global memory at dst under an L2
// policy, in this thread's open bulk group (bulk_commit closes it). The
// writes that filled src must be fenced first (fence_proxy_async, then a
// barrier).
__device__ __forceinline__ void bulk_store_hint(void* dst, const void* src,
                                                unsigned bytes,
                                                uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], "
      "[%1], %2, %3;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed bulk groups still read
// their shared memory: the older groups' sources may be written again.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- grid-wide counters

// Adds 1 to a device-memory counter, releasing this thread's earlier writes
// (and, after a block barrier, its block's) at GPU scope; returns the old
// value.
__device__ __forceinline__ unsigned long long atomic_add_release(
    unsigned long long* p) {
  unsigned long long old;
  asm volatile("atom.add.release.gpu.u64 %0, [%1], 1;\n"
               : "=l"(old)
               : "l"(p)
               : "memory");
  return old;
}

// Waits until a device-memory counter reaches `target`, acquiring the
// writes released by the adds that took it there. Traps after about 2^34
// cycles (seconds) instead of hanging the card.
__device__ __forceinline__ void wait_counter(const unsigned long long* p,
                                             unsigned long long target) {
  const long long t0 = clock64();
  for (;;) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.u64 %0, [%1];\n" : "=l"(v) : "l"(p)
                 : "memory");
    if (v >= target) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
    __nanosleep(32);
  }
}

// ------------------------------------------------------------- proxy fence

// Makes this thread's shared-memory stores (st.shared, the generic proxy)
// visible to the async proxy, through which wgmma reads its operands and a
// bulk store reads its source; then a barrier before the wgmma or the store
// that reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
