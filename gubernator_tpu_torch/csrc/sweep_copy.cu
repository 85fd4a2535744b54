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
// Nothing else bounds it, so the design only keeps enough bytes in
// flight: a grid-stride loop over 16-byte pieces, 8 blocks of 256 threads
// per SM, each thread issuing four loads before its four stores, with
// streaming cache hints (the table is far larger than L2). dst may equal
// src (the aliased form): every piece is read and then written by the
// same thread, so no __restrict__.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void sweep_copy_kernel(const int4* src, int4* dst, long long n) {
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

}  // namespace

extern "C" int guber_sweep_copy(const void* src, void* dst, long long n16, void* stream) {
  if (n16 <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n16 + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * 8) blocks = (long long)sms * 8;
  sweep_copy_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)src, (int4*)dst, n16);
  return (int)cudaGetLastError();
}
