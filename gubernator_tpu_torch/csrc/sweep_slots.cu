// sweep_slots: compose one window of U slot updates into each block of a
// (NB, 128) int32 table, in place. A slot is 16 int32 fields; bucket row
// r holds slots 0..7.
//
// Replaces the compose variants of exp/exp_sweep2.py (pallas_call at :156
// via build, the table aliased): k_cur (:62) and k_i8acc (:113), planes =
// 8, and k_f32x2 (:87), planes = 16. Window b (entries b*U .. b*U+U-1)
// updates table block b (blk rows); entry e names local bucket lb[e] and
// slot slot[e]. For every target (lb, slot) that some entry names:
//
//   planes = 8:  each byte of each field is the wrapping (mod 256) sum of
//                the matching entries' bytes (k_cur's per-plane int8
//                matmuls & 0xFF, k_i8acc's byte accumulators: the same);
//   planes = 16: lo and hi are the plain sums of the fields' 16-bit halves
//                (exact in the TPU's f32 while U <= 256), stored as
//                lo | (hi << 16) with no masking, so under colliding
//                targets it differs from planes = 8.
//
// Targets no entry names keep their bytes (the write test, a count of
// matching entries, is > 0 exactly for named targets). Entries with lb
// outside [0, blk) or slot outside [0, 8) name nothing.
//
// Bound on an H100 (3.35 TB/s): the window's lb and slot (8 B an entry),
// the payload of the live entries and the written slots (64 B each): at
// the script's geometry (2^21 rows, 1024 windows of 256, half live) about
// 19 MB, 5.6 us; a dense sweep of the table would move 2.1 GB. The table
// is never streamed: the kernel gathers live payloads and scatters
// composed slots, so what holds it back is the latency of each window's
// chain of phases, and how many windows are in flight to hide it.
//
// Design (guber_sweep_slots): one block of 256 threads per window, eight
// blocks an SM (30 registers, a few KB of shared memory), so all 1024
// windows of the script's geometry are resident in one wave. The block
// groups its entries by target slot in one pass, with a hashed owner
// table in shared memory (2^k >= 2U slots, open addressing): each live
// entry claims its target's slot by atomicCAS and pushes itself onto the
// target's member list by atomicExch; the entry that found the list empty
// is the target's owner and appends the slot to the owner list. One
// barrier later each owner's run is composed by four threads, one per
// 16-byte quarter of the slot, loading the members' payload quarters as
// int4 (__vadd4, or two 16-bit sums) and storing one int4 each: one owner
// per target, so the stores need no atomics, and sums mod 2^32 per lane do
// not depend on the order the list was built in. Grouping costs two
// barriers where a sort costs O(log^2 U) of them (sweep_groups.cuh; on an
// H100 it made the script's windows 1.8x slower), and where the link it
// replaces cost O(U^2) dependent compares. The table is sized by U, not by
// the block's blk * 8 targets, so it stays small at any blk. Payloads are
// read from global memory in the compose: staging them into shared memory
// by cp.async while the block groups was slower on the card, since the
// grouping is too short to hide a load behind.
//
// guber_sweep_slots_link is the earlier design, kept so that one run can
// time the two side by side: the entries linked by target
// (sweep_links.cuh), the first entry of each target summing its chain per
// field, one thread per 4-byte field.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_links.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK = 8;
constexpr int kF = 16;
constexpr int kQ = kF / 4;               // 16-byte quarters of a slot
constexpr int kMaxEntries = 2048;        // window entries a block takes
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opting in

__global__ void sweep_slots_link_kernel(int* table, const int* __restrict__ new16,
                                        const int* __restrict__ slot,
                                        const int* __restrict__ lb, int U, int blk,
                                        int planes) {
  extern __shared__ int smem[];
  int* key = smem;
  int* nxt = smem + U;
  unsigned char* head = (unsigned char*)(smem + 2 * U);
  const long long b = blockIdx.x;
  for (int e = threadIdx.x; e < U; e += blockDim.x) {
    const int r = lb[b * U + e];
    const int s = slot[b * U + e];
    key[e] = (r >= 0 && r < blk && s >= 0 && s < kK) ? r * kK + s : -1;
  }
  __syncthreads();
  link_keys(key, nxt, head, U);
  __syncthreads();
  const long long slot0 = b * blk * kK;  // first slot of this block
  for (int p = threadIdx.x; p < U * kF; p += blockDim.x) {
    const int e = p / kF;
    const int f = p % kF;
    if (!head[e]) continue;
    unsigned acc;
    if (planes == 8) {
      acc = 0;
      for (int m = e; m >= 0; m = nxt[m]) {
        acc = __vadd4(acc, (unsigned)new16[(b * U + m) * kF + f]);
      }
    } else {
      unsigned lo = 0, hi = 0;
      for (int m = e; m >= 0; m = nxt[m]) {
        const unsigned x = (unsigned)new16[(b * U + m) * kF + f];
        lo += x & 0xFFFFu;
        hi += x >> 16;
      }
      acc = lo | (hi << 16);
    }
    table[(slot0 + key[e]) * kF + f] = (int)acc;
  }
}

// The number of bits of a hashed owner table for n entries: 2^k >= 2n.
inline int owner_bits(int n) {
  int k = 1;
  while ((1 << k) < 2 * n) ++k;
  return k;
}

// Dynamic shared memory for n entries: the owner table's targets and list
// heads (2^k each), each entry's next member, the owner list and its
// length.
inline size_t owner_smem_bytes(int n) {
  return (((size_t)2 << owner_bits(n)) + 2 * (size_t)n + 1) * sizeof(int);
}

// Quarter q of the slot composed from the member list that starts at
// entry `head`: bytewise sums (planes 8), or the low halves' sums in acc
// and the high halves' in hi, stored as lo | (hi << 16) (planes 16).
template <int kPlanes>
__device__ __forceinline__ uint4 compose(const uint4* __restrict__ pay, const int* nxt,
                                         int head, int q) {
  uint4 acc = make_uint4(0, 0, 0, 0), hi = acc;
  for (int m = head; m >= 0; m = nxt[m]) {
    const uint4 x = pay[m * kQ + q];
    if (kPlanes == 8) {
      acc = make_uint4(__vadd4(acc.x, x.x), __vadd4(acc.y, x.y), __vadd4(acc.z, x.z),
                       __vadd4(acc.w, x.w));
    } else {
      acc.x += x.x & 0xFFFFu;
      acc.y += x.y & 0xFFFFu;
      acc.z += x.z & 0xFFFFu;
      acc.w += x.w & 0xFFFFu;
      hi.x += x.x >> 16;
      hi.y += x.y >> 16;
      hi.z += x.z >> 16;
      hi.w += x.w >> 16;
    }
  }
  if (kPlanes == 16) {
    acc = make_uint4(acc.x | (hi.x << 16), acc.y | (hi.y << 16), acc.z | (hi.z << 16),
                     acc.w | (hi.w << 16));
  }
  return acc;
}

template <int kPlanes>
__global__ void __launch_bounds__(kThreads, 8)
sweep_slots_kernel(int* table, const uint4* __restrict__ new16, const int* __restrict__ slot,
                   const int* __restrict__ lb, int U, int blk, int bits) {
  extern __shared__ int smem_owners[];
  const int size = 1 << bits;
  int* target = smem_owners;  // owner table: a slot's target, -1 while free
  int* head = target + size;  // the slot's last member, -1 while none
  int* nxt = head + size;     // nxt[j]: the member before entry j, -1 at the end
  int* owners = nxt + U;      // the claimed slots, one per target
  int& n_owners = owners[U];
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    target[i] = -1;
    head[i] = -1;
  }
  if (threadIdx.x == 0) n_owners = 0;
  __syncthreads();
  const long long e0 = (long long)blockIdx.x * U;
#pragma unroll 4
  for (int j = threadIdx.x; j < U; j += blockDim.x) {
    const int r = lb[e0 + j];
    const int s = slot[e0 + j];
    if (r < 0 || r >= blk || s < 0 || s >= kK) continue;
    const int t = r * kK + s;
    int h = (int)(((unsigned)t * 2654435761u) >> (32 - bits));
    for (int old; (old = atomicCAS(&target[h], -1, t)) != -1 && old != t;) {
      h = (h + 1) & (size - 1);
    }
    const int prev = atomicExch(&head[h], j);
    nxt[j] = prev;
    if (prev < 0) owners[atomicAdd(&n_owners, 1)] = h;
  }
  __syncthreads();
  const int runs = n_owners;
  const int q = threadIdx.x & 3;  // this thread's quarter of the slot
  uint4* dst = reinterpret_cast<uint4*>(table) + (long long)blockIdx.x * blk * kK * kQ;
  const uint4* pay = new16 + e0 * kQ;
  for (int r0 = 0; r0 < runs; r0 += blockDim.x / 4) {
    const int r = r0 + threadIdx.x / 4;
    if (r < runs) {
      const int h = owners[r];
      dst[(long long)target[h] * kQ + q] = compose<kPlanes>(pay, nxt, head[h], q);
    }
  }
}

}  // namespace

extern "C" int guber_sweep_slots(void* table, const void* new16, const void* slot,
                                 const void* lb, int nblk, int U, int blk, int planes,
                                 void* stream) {
  if (nblk <= 0) return (int)cudaSuccess;
  if (U <= 0 || U > kMaxEntries || (planes != 8 && planes != 16)) {
    return (int)cudaErrorInvalidValue;
  }
  void (*kernel)(int*, const uint4*, const int*, const int*, int, int, int) =
      planes == 8 ? &sweep_slots_kernel<8> : &sweep_slots_kernel<16>;
  const size_t smem = owner_smem_bytes(U);
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned int)nblk, kThreads, smem, (cudaStream_t)stream>>>(
      (int*)table, (const uint4*)new16, (const int*)slot, (const int*)lb, U, blk,
      owner_bits(U));
  return (int)cudaGetLastError();
}

extern "C" int guber_sweep_slots_link(void* table, const void* new16, const void* slot,
                                      const void* lb, int nblk, int U, int blk, int planes,
                                      void* stream) {
  if (nblk <= 0) return (int)cudaSuccess;
  sweep_slots_link_kernel<<<(unsigned int)nblk, kThreads, link_smem_bytes(U, 0),
                            (cudaStream_t)stream>>>(
      (int*)table, (const int*)new16, (const int*)slot, (const int*)lb, U, blk, planes);
  return (int)cudaGetLastError();
}
