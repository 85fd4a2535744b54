// fence_claim: claim contiguously published request-ring slots.
//
// Replaces the TPU kernel of the JAX package's ring consumer,
// gubernator_tpu/ops/ring_drain.py::_fence_claim_kernel (pallas_call at :257,
// built by make_fence_claim). Starting from ticket `start`, it claims up to
// m = min(k, k_max, S) tickets in order: ticket t is published when
// seq_in[t % S] == t + 1, and the first gap stops the claim. For claim
// position i < n it copies slot (start + i) % S, a (5, W+1) int32 wire grid,
// into bank[i], and only after that copy is complete stores the fence
// fence_out[slot] = t + 1 with release semantics. Bank rows past n are
// zeros, so the drain decides a zeroed grid (every row inactive) for a
// position past the claim. Block 0 writes n.
//
// Bound on an H100 (3.35 TB/s): the kernel must read the n claimed slots and
// the m fence words and write k_max bank rows, n fences and n. At the ring
// geometry (W = 16384, k_max = n = 8) that is 2 x 8 x 327,700 B = 5.24 MB,
// about 1.6 us; the launch is the other floor.
//
// Design. The TPU kernel walks the positions in one sequential loop, carrying
// n. The first Hopper design gave each position one block, so eight SMs
// copied 2.6 MB while 124 idled: 13.9 us. Here the grid is k_max x G blocks
// (gridDim.x = G chunks per position, gridDim.y = the position), G sized so
// that each thread moves one 16-byte word of its slot and the grid covers
// every SM (41 x 8 blocks of 512 threads at the ring geometry):
//
//  * every block finds n itself: its threads load the m fence words with
//    acquire loads and take the first gap with a shared-memory atomicMin;
//    seq_in does not change during a launch on one stream, so all agree;
//  * block (g, i) copies chunk g of slot (start + i) % S into bank[i], or
//    zeros it when i >= n, with 16-byte accesses. A slot is 327,700 B, so
//    slot and bank-row bases drift by 4 B per position and a source is
//    often 4, 8 or 12 bytes off its destination's 16-byte alignment; then
//    each 16-byte store is assembled from the two aligned 16-byte loads
//    that cover it (a funnel of words; the second load is the next
//    thread's first, an L1 hit). The few words before the destination's
//    first 16-byte boundary and after its last are copied singly;
//  * completion: each block ends its chunk with __syncthreads(); its thread
//    0 then runs __threadfence() and an acq_rel atomicAdd on position i's
//    counter; the block that completes the count stores the fence with
//    release semantics and resets the counter to 0. The counters live in a
//    scratch buffer the wrapper allocates once per device and stream
//    (torch.zeros), left zeroed by every launch.
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive as
// void*; the fence words are int32 or int64 (fence_bytes 4 or 8, the kernel
// is templated on the type). The function launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;  // at least this many blocks per SM (132 SMs)
constexpr int kSms = 132;
constexpr int kMinChunk = 128;   // 16-byte accesses, 2 KB

// 4 words of the 8 in (a, b) starting at word `shift` (1, 2 or 3)
__device__ __forceinline__ int4 funnel(const int4 a, const int4 b, int shift) {
  if (shift == 1) return make_int4(a.y, a.z, a.w, b.x);
  if (shift == 2) return make_int4(a.z, a.w, b.x, b.y);
  return make_int4(a.w, b.x, b.y, b.z);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fence_claim_kernel(const T* __restrict__ seq_in, T* fence_out,
                       const int32_t* __restrict__ grids, int32_t* __restrict__ bank,
                       int32_t* n_out, unsigned* counters, long long S, long long words,
                       long long start, int m) {
  __shared__ int first_gap;
  if (threadIdx.x == 0) first_gap = m;
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const long long t = start + j;
    cuda::atomic_ref<T, cuda::thread_scope_device> fence(const_cast<T&>(seq_in[t % S]));
    if ((long long)fence.load(cuda::memory_order_acquire) != t + 1) atomicMin(&first_gap, j);
  }
  __syncthreads();
  const int n = first_gap;
  const int i = blockIdx.y;
  const int G = gridDim.x;
  const int g = blockIdx.x;
  const bool claimed = i < n;
  const long long t = start + i;
  const long long slot = t % S;
  int32_t* dst = bank + (long long)i * words;
  const int32_t* src = grids + slot * words;

  // the destination in 16-byte units [0, n4) from word `head`; words
  // before `head` and from head + 4*n4 on are copied singly by block 0
  const int head = (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2);
  const long long h = head < words ? head : words;
  const long long n4 = (words - h) >> 2;
  const long long per = (n4 + G - 1) / G;
  const long long j0 = g * per;
  const long long j1 = j0 + per < n4 ? j0 + per : n4;
  int4* d4 = reinterpret_cast<int4*>(dst + h);
  if (claimed) {
    const uintptr_t sa = (uintptr_t)(src + h);
    const int shift = (int)((sa & 15) >> 2);
    const int4* s4 = reinterpret_cast<const int4*>(sa & ~(uintptr_t)15);
    if (shift == 0) {
      for (long long j = j0 + threadIdx.x; j < j1; j += kThreads) d4[j] = s4[j];
    } else {
      for (long long j = j0 + threadIdx.x; j < j1; j += kThreads)
        d4[j] = funnel(s4[j], s4[j + 1], shift);
    }
    if (g == 0) {
      const long long tail = h + 4 * n4;
      if (threadIdx.x < h) dst[threadIdx.x] = src[threadIdx.x];
      if (threadIdx.x < words - tail) dst[tail + threadIdx.x] = src[tail + threadIdx.x];
    }
  } else {
    const int4 z = make_int4(0, 0, 0, 0);
    for (long long j = j0 + threadIdx.x; j < j1; j += kThreads) d4[j] = z;
    if (g == 0) {
      const long long tail = h + 4 * n4;
      if (threadIdx.x < h) dst[threadIdx.x] = 0;
      if (threadIdx.x < words - tail) dst[tail + threadIdx.x] = 0;
    }
  }
  if (claimed) {
    // the last block of position i to finish its chunk publishes the fence
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      cuda::atomic_ref<unsigned, cuda::thread_scope_device> c(counters[i]);
      if (c.fetch_add(1u, cuda::memory_order_acq_rel) == (unsigned)G - 1) {
        c.store(0u, cuda::memory_order_relaxed);
        cuda::atomic_ref<T, cuda::thread_scope_device> fence(fence_out[slot]);
        fence.store((T)(t + 1), cuda::memory_order_release);
      }
    }
  }
  if (i == 0 && g == 0 && threadIdx.x == 0) n_out[0] = n;
}

template <typename T>
cudaError_t launch(const void* seq_in, void* fence_out, const void* grids, void* bank,
                   void* n_out, void* counters, long long S, long long words,
                   long long start, int m, int k_max, cudaStream_t s) {
  // chunks per position: one 16-byte access per thread, so every load of a
  // chunk is in flight at once (a second pass would wait a memory latency);
  // more chunks to cover every SM, but none under kMinChunk accesses (a
  // small slot gains nothing from more blocks, each with its own fence
  // reads and completion atomic)
  const long long n4 = words / 4;
  long long G = (n4 + kThreads - 1) / kThreads;
  long long cover = (kSms * kBlocksPerSm + k_max - 1) / k_max;
  if (cover > n4 / kMinChunk) cover = n4 / kMinChunk;
  if (G < cover) G = cover;
  if (G > 65535) G = 65535;
  if (G < 1) G = 1;
  fence_claim_kernel<T><<<dim3((unsigned)G, (unsigned)k_max), kThreads, 0, s>>>(
      (const T*)seq_in, (T*)fence_out, (const int32_t*)grids, (int32_t*)bank,
      (int32_t*)n_out, (unsigned*)counters, S, words, start, m);
  return cudaGetLastError();
}

}  // namespace

// `counters`: k_max unsigned words, zero before the launch and after it.
extern "C" int guber_fence_claim(int fence_bytes, const void* seq_in,
                                 void* fence_out, const void* grids,
                                 void* bank, void* n_out, void* counters,
                                 long long S, long long words, long long start,
                                 int m, int k_max, void* stream) {
  if (k_max <= 0 || k_max > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (fence_bytes == 4)
    return (int)launch<int32_t>(seq_in, fence_out, grids, bank, n_out, counters, S, words,
                                start, m, k_max, s);
  if (fence_bytes == 8)
    return (int)launch<long long>(seq_in, fence_out, grids, bank, n_out, counters, S,
                                  words, start, m, k_max, s);
  return (int)cudaErrorInvalidValue;
}
