// bulk_stream: a whole-array stream through shared memory with Hopper's
// bulk asynchronous copies (TMA without a tensor map).
//
// One thread of a block drives a ring of STAGES shared-memory stages of
// STAGE_BYTES each:
//
//   * a bulk load, cp.async.bulk.shared::cluster.global.mbarrier::
//     complete_tx::bytes, fills a stage; its completion is counted on the
//     stage's mbarrier, armed with the chunk's byte count (expect_tx)
//     before the load is issued, and waited on by phase parity (the k-th
//     use of a stage completes phase k, so its waiter passes parity k & 1);
//   * a bulk store, cp.async.bulk.global.shared::cta.bulk_group, writes the
//     stage back out as soon as it has arrived, one bulk group per chunk;
//   * before a stage is refilled, cp.async.bulk.wait_group.read waits until
//     the store that reads it has read it (all but the newest group).
//
// So STAGES - 1 loads are in flight while one store drains, reads and
// writes overlap across stages, and no thread spends registers or
// instructions on the bytes: the TMA unit computes every address.
//
// Proxy rule: the stage is written by the async proxy (the bulk load) and
// read by the async proxy (the bulk store), and the mbarrier wait orders
// the load's completion (complete_tx has release semantics) before the
// store is issued, so no fence.proxy.async is needed between them. A
// caller that writes a stage with ordinary stores (the generic proxy)
// between the wait and the store must put fence.proxy.async.shared::cta
// after its writes and before the store.
//
// Alignment: every address and byte count of a bulk copy is a multiple of
// 16; shared stages are 128-byte aligned.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk_stream {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(arrivals)
               : "memory");
}

// Make initialised barriers visible to the copy engine.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and expect `bytes` more to land on the barrier.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void load(void* stage, const void* src, uint32_t bytes,
                                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem(stage)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// Store a stage and close its bulk group.
__device__ __forceinline__ void store(void* dst, const void* stage, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem(stage)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Order this thread's ordinary (generic-proxy) writes to shared memory
// before the bulk copies issued after it, which read that memory through
// the async proxy. Every writing thread runs it, then the threads sync.
__device__ __forceinline__ void fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Wait until at most N bulk groups still read their shared memory.
template <int N>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Wait until every bulk group of this thread has completed its writes.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Copy `bytes` (a multiple of 16) from src to dst; dst may equal src. The
// array is cut into chunks of STAGE_BYTES (the last one ragged), chunk c
// going to block c % gridDim.x; a chunk is read whole into its stage
// before its store is issued, by the same block, so the copy in place is
// safe. Called by ONE thread of the block; `stages` is STAGES *
// STAGE_BYTES of 128-byte aligned shared memory, `bars` STAGES barriers.
template <int STAGES, int STAGE_BYTES>
__device__ void copy(const char* src, char* dst, long long bytes, unsigned char* stages,
                     uint64_t* bars) {
  static_assert(STAGE_BYTES % 16 == 0, "bulk copies move multiples of 16 bytes");
  const long long chunks = (bytes + STAGE_BYTES - 1) / STAGE_BYTES;
  const long long first = blockIdx.x, step = gridDim.x;
  if (first >= chunks) return;
  const long long nk = (chunks - 1 - first) / step + 1;  // this block's chunks
  for (int s = 0; s < STAGES; ++s) bar_init(&bars[s], 1);
  bar_init_fence();
  auto offset = [&](long long k) { return (first + k * step) * STAGE_BYTES; };
  auto size = [&](long long off) {
    return (uint32_t)(bytes - off < STAGE_BYTES ? bytes - off : STAGE_BYTES);
  };
  auto fill = [&](long long k) {
    const int s = (int)(k % STAGES);
    const long long off = offset(k);
    const uint32_t n = size(off);
    bar_expect(&bars[s], n);
    load(stages + (long long)s * STAGE_BYTES, src + off, n, &bars[s]);
  };
  for (long long k = 0; k < nk && k < STAGES; ++k) fill(k);
  for (long long k = 0; k < nk; ++k) {
    const int s = (int)(k % STAGES);
    bar_wait(&bars[s], (uint32_t)((k / STAGES) & 1));
    const long long off = offset(k);
    store(dst + off, stages + (long long)s * STAGE_BYTES, size(off));
    if (k >= 1 && k - 1 + STAGES < nk) {
      wait_read<1>();  // the store of chunk k - 1 has read its stage
      fill(k - 1 + STAGES);
    }
  }
  wait_all();
}

}  // namespace bulk_stream
