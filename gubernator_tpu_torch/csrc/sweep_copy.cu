// sweep_copy: stream a (NB, 128) int32 table from src into dst.
//
// Replaces the TPU copy sweeps of the measurement scripts:
// exp/exp_sweep2.py::k_copy (pallas_call at :156 via build, the table
// aliased in place) and exp/exp_mem2.py::copy_kernel (pallas_call at :103
// via sweep_copy, out of place). Both move 2048-row (1 MiB) blocks through
// VMEM and measure the whole-table stream every sweep write pays.
//
// Bound on an H100 (3.35 TB/s): each table byte read once and written
// once, 2 x 1 GiB = 2.147 GB at the scripts' 2^21-row table, 0.641 ms.
// Nothing else bounds it, so the design only has to keep the memory busy
// in both directions at once.
//
// Design (guber_sweep_copy): the bulk-copy stream of bulk_stream.cuh. A
// persistent grid of two blocks per SM, each block one thread that drives
// a ring of three shared-memory stages of 32 KB: bulk loads fill the
// stages ahead, a bulk store drains each stage as soon as it has arrived,
// and a stage is refilled once its store has read it. Threads move no
// bytes themselves, and reads and writes overlap across stages instead of
// alternating within each thread. dst may equal src (the aliased form): a
// chunk is read whole into shared memory before its store is issued, by
// the same block. Other shapes of the stream were tried (one block per SM
// with 2-12 stages of 16-96 KB, a separate producer and consumer thread,
// L2 evict-first hints on the loads or the stores, each block's chunks
// contiguous instead of interleaved); none was faster.
//
// guber_sweep_copy_grid is the earlier design, kept so that one run can
// time the two side by side: a grid-stride loop over 16-byte pieces, 8 blocks
// of 256 threads per SM, each thread issuing four streaming loads before
// its four stores.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_stream.cuh"

namespace {

constexpr int kStages = 3;
constexpr int kStageBytes = 32 * 1024;
constexpr int kBlocksPerSm = 2;
constexpr int kSmemBytes = kStages * kStageBytes;
static_assert(kBlocksPerSm * kSmemBytes <= 227 * 1024, "an SM's shared memory is 227 KB");

__global__ void __launch_bounds__(32, kBlocksPerSm)
sweep_copy_bulk_kernel(const char* src, char* dst, long long bytes) {
  extern __shared__ __align__(128) unsigned char stages[];
  __shared__ __align__(8) uint64_t bars[kStages];
  if (threadIdx.x != 0) return;
  bulk_stream::copy<kStages, kStageBytes>(src, dst, bytes, stages, bars);
}

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void sweep_copy_grid_kernel(const int4* src, int4* dst, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = __ldcs(src + i + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) __stcs(dst + i + k * stride, v[k]);
  }
  for (; i < n; i += stride) __stcs(dst + i, __ldcs(src + i));
}

int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

extern "C" int guber_sweep_copy(const void* src, void* dst, long long n16, void* stream) {
  if (n16 <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_copy_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long bytes = n16 * 16;
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  long long blocks = (bytes + kStageBytes - 1) / kStageBytes;
  if (blocks > cap) blocks = cap;
  sweep_copy_bulk_kernel<<<(unsigned int)blocks, 32, kSmemBytes, (cudaStream_t)stream>>>(
      (const char*)src, (char*)dst, bytes);
  return (int)cudaGetLastError();
}

extern "C" int guber_sweep_copy_grid(const void* src, void* dst, long long n16,
                                     void* stream) {
  if (n16 <= 0) return (int)cudaSuccess;
  const long long cap = (long long)sm_count() * 8;
  long long blocks = (n16 + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  sweep_copy_grid_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)src, (int4*)dst, n16);
  return (int)cudaGetLastError();
}
