// sweep_groups.cuh: group a block's window entries by target with a sort.
//
// The TPU sweeps sum every window entry that names a target with one-hot
// matmuls. A Hopper block groups the entries that share a target instead,
// so that one owner sums each group and alone stores to its target: no
// two threads write one address and the sums need no atomics.
//
// group() does it in shared memory, in four steps over the block:
//
//   1. load: every entry's key (target << kIdxBits | entry), all of the
//      block's target loads in flight at once;
//   2. compact: the live keys (target >= 0) are packed in entry order by
//      a block-wide prefix count (warp ballot + __popc, one total per warp);
//   3. sort: unless they are in order already (one block-wide vote), by a
//      bitonic network over the next power of two m of the live count,
//      log2(m)(log2(m)+1)/2 barrier stages (28 at m = 128, 45 at m = 512);
//   4. cut: a run starts where the target differs from the entry before;
//      the run starts are packed by a second prefix count.
//
// Entries of one target come out in entry order, so a caller that packs
// two windows as entries 0..u-1 and u..2u-1 still knows each entry's
// window. It replaces the link of sweep_links.cuh, whose O(n^2) compares
// cost a 512-entry block about 8K dependent shared loads per warp. Nothing
// here depends on the order of the targets: shuffled windows group alike.

#pragma once

#include <stdint.h>

namespace sweep_groups {

constexpr int kIdxBits = 11;  // entry index within the block: n <= 2048
constexpr unsigned long long kIdxMask = (1ull << kIdxBits) - 1;
constexpr int kMaxEntries = 1 << kIdxBits;

// Shared memory of group() for n entries: the sorted keys (a power of two
// of them), every entry's key, the run starts (n + 1) and one count per
// warp.
inline size_t smem_bytes(int n) {
  size_t m = 1;
  while ((int)m < n) m <<= 1;
  return (m + n) * sizeof(unsigned long long) + (size_t)(n + 1) * sizeof(int) +
         32 * sizeof(int);
}

struct Groups {
  const unsigned long long* key;  // key[0..live): (target << kIdxBits | entry), ascending
  const int* start;               // start[r]: first key of run r; start[runs] == live
  int live;
  int runs;
};

__device__ __forceinline__ long long target(unsigned long long key) {
  return (long long)(key >> kIdxBits);
}

__device__ __forceinline__ int entry(unsigned long long key) { return (int)(key & kIdxMask); }

// This thread's rank among the block's threads whose `flag` is set (in
// thread order), and their number in *total. Every thread calls it;
// blockDim.x is a multiple of 32; `sums` holds one int per warp.
__device__ __forceinline__ int block_rank(bool flag, int* total, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) sums[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int c = sums[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();  // sums are free for the next call
  *total = all;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// Group entries 0..n-1 (n <= kMaxEntries) by target_of(j), a target >= 0
// below 2^52 or -1 for an entry that is not live. Every thread of the
// block calls it; `smem` is smem_bytes(n) of shared memory, 8-byte
// aligned. Ends with a barrier, so every thread may read the result.
template <class TargetOf>
__device__ Groups group(TargetOf target_of, int n, unsigned char* smem) {
  int m = 1;
  while (m < n) m <<= 1;
  constexpr unsigned long long kDead = ~0ull;
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* raw = key + m;
  int* start = reinterpret_cast<int*>(raw + n);
  int* sums = start + n + 1;

#pragma unroll 4
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const long long t = target_of(j);
    raw[j] = t >= 0 ? ((unsigned long long)t << kIdxBits) | (unsigned)j : kDead;
  }
  __syncthreads();
  int live = 0, total;
  for (int j0 = 0; j0 < n; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const unsigned long long k = j < n ? raw[j] : kDead;
    const int r = block_rank(k != kDead, &total, sums);
    if (k != kDead) key[live + r] = k;
    live += total;
  }
  __syncthreads();
  bool in_order = true;
  for (int i = threadIdx.x + 1; i < live; i += blockDim.x) in_order &= key[i - 1] <= key[i];
  int p = 1;
  if (!__syncthreads_and(in_order)) {
    while (p < live) p <<= 1;
    for (int i = live + threadIdx.x; i < p; i += blockDim.x) key[i] = kDead;
    __syncthreads();
  }
  for (int k = 2; k <= p; k <<= 1) {
    for (int d = k >> 1; d > 0; d >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const int lo = ((i & ~(d - 1)) << 1) | (i & (d - 1));
        const unsigned long long a = key[lo], b = key[lo + d];
        if ((a > b) == ((lo & k) == 0)) {
          key[lo] = b;
          key[lo + d] = a;
        }
      }
      __syncthreads();
    }
  }
  int runs = 0;
  for (int i0 = 0; i0 < live; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool head = i < live && (i == 0 || (key[i] >> kIdxBits) != (key[i - 1] >> kIdxBits));
    const int r = block_rank(head, &total, sums);
    if (head) start[runs + r] = i;
    runs += total;
  }
  if (threadIdx.x == 0) start[runs] = live;
  __syncthreads();
  return Groups{key, start, live, runs};
}

}  // namespace sweep_groups
