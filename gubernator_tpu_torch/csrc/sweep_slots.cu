// sweep_slots: compose one window of U slot updates into each block of a
// (NB, 128) int32 table, in place. A slot is 16 int32 fields; bucket row
// r holds slots 0..7.
//
// Replaces the compose variants of exp/exp_sweep2.py (pallas_call at :156
// via build, the table aliased): k_cur and k_i8acc (planes = 8) and
// k_f32x2 (planes = 16). Window b (entries b*U .. b*U+U-1) updates table
// block b (blk rows); entry e names local bucket lb[e] and slot slot[e].
// For every target (lb, slot) that some entry names:
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
// Bound on an H100 (3.35 TB/s): the window's lb and slot, the payload of
// the live entries and the written slots (64 B each): at the script's
// geometry (2^21 rows, 1024 windows of 256, half live) about 19 MB, 6 us;
// a dense sweep of the table would move 2.1 GB. Design: one block per
// window; the table is never streamed. Entries are linked by target in
// shared memory (sweep_links.cuh); the first entry of each target sums its
// chain per field with __vadd4 (four byte lanes mod 256) or two 16-bit
// sums, and stores the slot: one thread per field, one store per address.
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

__global__ void sweep_slots_kernel(int* table, const int* __restrict__ new16,
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

}  // namespace

extern "C" int guber_sweep_slots(void* table, const void* new16, const void* slot,
                                 const void* lb, int nblk, int U, int blk, int planes,
                                 void* stream) {
  if (nblk <= 0) return (int)cudaSuccess;
  sweep_slots_kernel<<<(unsigned int)nblk, kThreads, link_smem_bytes(U, 0),
                       (cudaStream_t)stream>>>(
      (int*)table, (const int*)new16, (const int*)slot, (const int*)lb, U, blk, planes);
  return (int)cudaGetLastError();
}
