// fence_claim: claim contiguously published request-ring slots.
//
// Replaces the TPU kernel of the JAX package's ring consumer,
// gubernator_tpu/ops/ring_drain.py::_fence_claim_kernel (pallas_call at :257,
// built by make_fence_claim). Starting from ticket `start`, it claims up to
// m = min(k, k_max, S) tickets in order: ticket t is published when
// seq_in[t % S] == t + 1, and the first gap stops the claim. For claim
// position i < n it copies slot (start + i) % S, a (5, W+1) int32 wire grid,
// into bank[i], and only after that copy is complete stores the fence
// fence_out[slot] = t + 1 with release semantics. Block 0 writes n.
//
// Design: one block per claim position i < k_max. The TPU kernel walks the
// positions in one sequential loop, carrying n; here every block computes
// the same prefix n itself: its threads load the m fence words with acquire
// loads and take the first gap with a shared-memory atomicMin. seq_in does
// not change during a launch on one stream, so the blocks agree. Block i < n
// copies its slot with 4-byte loads and stores (a slot is 5*(W+1)*4 bytes,
// contiguous but not 16-byte aligned in general), 1024 threads with eight
// loads in flight each, so one SM keeps 32 KB of reads outstanding; then
// __syncthreads() and __threadfence() order the copy before thread 0's
// release store of the fence. Block i >= n writes zeros into
// bank[i], so the whole bank is defined: the drain decides a zeroed grid
// (every row inactive) for a position past the claim.
//
// Bound on an H100 (3.35 TB/s): the kernel must read the n claimed slots and
// the m fence words and write k_max bank rows, n fences and n. At the ring
// geometry (W = 16384, k_max = n = 8) that is 2 x 8 x 327,700 B = 5.24 MB,
// about 1.6 us. With eight blocks on 132 SMs, the copy runs on eight SMs at
// the rate their outstanding reads allow (32 KB each over the memory
// latency), several times the bound; the launch is the other floor.
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive as
// void*; the fence words are int32 or int64 (fence_bytes 4 or 8, the kernel
// is templated on the type). The function launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 8;  // independent loads in flight per thread

template <typename T>
__global__ void fence_claim_kernel(const T* __restrict__ seq_in, T* fence_out,
                                   const int32_t* __restrict__ grids,
                                   int32_t* __restrict__ bank, int32_t* n_out,
                                   long long S, long long words,
                                   long long start, int m) {
  __shared__ int first_gap;
  if (threadIdx.x == 0) first_gap = m;
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    long long t = start + j;
    cuda::atomic_ref<T, cuda::thread_scope_device> fence(
        const_cast<T&>(seq_in[t % S]));
    if ((long long)fence.load(cuda::memory_order_acquire) != t + 1) {
      atomicMin(&first_gap, j);
    }
  }
  __syncthreads();
  const int n = first_gap;
  const int i = blockIdx.x;
  int32_t* dst = bank + (long long)i * words;
  const long long step = blockDim.x;
  if (i < n) {
    const long long t = start + i;
    const long long slot = t % S;
    const int32_t* src = grids + slot * words;
    long long w = threadIdx.x;
    for (; w + (kUnroll - 1) * step < words; w += kUnroll * step) {
      int32_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = src[w + u * step];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) dst[w + u * step] = v[u];
    }
    for (; w < words; w += step) dst[w] = src[w];
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      cuda::atomic_ref<T, cuda::thread_scope_device> fence(fence_out[slot]);
      fence.store((T)(t + 1), cuda::memory_order_release);
    }
  } else {
    for (long long w = threadIdx.x; w < words; w += step) dst[w] = 0;
  }
  if (i == 0 && threadIdx.x == 0) n_out[0] = n;
}

}  // namespace

extern "C" int guber_fence_claim(int fence_bytes, const void* seq_in,
                                 void* fence_out, const void* grids,
                                 void* bank, void* n_out, long long S,
                                 long long words, long long start, int m,
                                 int k_max, void* stream) {
  if (k_max <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (fence_bytes == 4) {
    fence_claim_kernel<int32_t><<<k_max, kThreads, 0, s>>>(
        (const int32_t*)seq_in, (int32_t*)fence_out, (const int32_t*)grids,
        (int32_t*)bank, (int32_t*)n_out, S, words, start, m);
  } else if (fence_bytes == 8) {
    fence_claim_kernel<long long><<<k_max, kThreads, 0, s>>>(
        (const long long*)seq_in, (long long*)fence_out,
        (const int32_t*)grids, (int32_t*)bank, (int32_t*)n_out, S, words,
        start, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
