// sweep_window: the windowed sweep write. Compose target-sorted slot
// updates into a (NB, 128) int32 table, in place, each block of blk rows
// from the two u-entry windows that cover its run.
//
// Replaces exp/exp_sweep4.py::make_sweep2's kern (pallas_call at :101) and
// exp/exp_sweep5.py::make_kernel's kern (pallas_call at :132), which get
// their window starts by scalar prefetch. For table block i (slots
// i*K*blk .. +K*blk):
//
//   half 1 is window s = s_blk[i]; half 2 is window min(s + 1, nwin - 1),
//   enabled when s + 1 <= nwin - 1, or with skip2 when need2[i] != 0 (as
//   the TPU kernel's pl.when); an entry is live iff its target lies in the
//   block. Per half and target slot: each byte of each field is the
//   wrapping sum of the live entries' bytes (acc_h), and the write test
//   w_h is their count, or with marker the composed field 15 as a signed
//   int32. The slot takes acc_1 | acc_2 iff w_1 + w_2 > 0 (wrapping int32).
//
// Entries of a block's run past its two windows are dropped, as on the
// TPU. s_blk is clamped to [0, nwin) for memory safety.
//
// Bound on an H100 (3.35 TB/s): the windows' targets, the live entries'
// payload and the written slots: at NB 2^21, B 2^17 about 17 MB, 5 us; at
// the 8 GiB c5 table (NB 2^24, B 2^20) about 138 MB, 41 us. The table is
// never streamed. Design: one block per table block; its 2u entries
// (targets and entry indices) go into shared memory and are linked by
// target (sweep_links.cuh); the first entry of each target sums both
// halves' chains per field with __vadd4 and stores the slot, one thread
// per field. Live targets lie in the block, so blocks never store into
// each other's rows. Offsets are 64-bit (the c5 table is 8 GiB).
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

__global__ void sweep_window_kernel(int* table, const int* __restrict__ pay,
                                    const int* __restrict__ tgt,
                                    const int* __restrict__ s_blk,
                                    const int* __restrict__ need2, int blk, int u,
                                    int nwin, int marker, int skip2) {
  extern __shared__ int smem[];
  const int n = 2 * u;
  int* key = smem;
  int* nxt = smem + n;
  int* ent = smem + 2 * n;
  unsigned char* head = (unsigned char*)(smem + 3 * n);
  const long long i = blockIdx.x;
  const long long kblk = (long long)kK * blk;
  const long long base = i * kblk;  // first slot of this block
  const int s1 = min(max(s_blk[i], 0), nwin - 1);
  const int s2 = min(s1 + 1, nwin - 1);
  const bool en2 = skip2 ? (need2[i] != 0) : (s1 + 1 <= nwin - 1);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const bool second = j >= u;
    const int e = (second ? s2 : s1) * u + (second ? j - u : j);
    const long long rel = (long long)tgt[e] - base;
    const bool live = rel >= 0 && rel < kblk && (!second || en2);
    key[j] = live ? (int)rel : -1;
    ent[j] = e;
  }
  __syncthreads();
  link_keys(key, nxt, head, n);
  __syncthreads();
  for (int p = threadIdx.x; p < n * kF; p += blockDim.x) {
    const int j = p / kF;
    const int f = p % kF;
    if (!head[j]) continue;
    unsigned acc1 = 0, acc2 = 0, m1 = 0, m2 = 0;
    int c1 = 0, c2 = 0;
    for (int m = j; m >= 0; m = nxt[m]) {
      const long long row = (long long)ent[m] * kF;
      const unsigned x = (unsigned)pay[row + f];
      const unsigned x15 = marker ? (unsigned)pay[row + kF - 1] : 0u;
      if (m < u) {
        acc1 = __vadd4(acc1, x);
        m1 = __vadd4(m1, x15);
        ++c1;
      } else {
        acc2 = __vadd4(acc2, x);
        m2 = __vadd4(m2, x15);
        ++c2;
      }
    }
    const unsigned w1 = marker ? m1 : (unsigned)c1;
    const unsigned w2 = marker ? m2 : (unsigned)c2;
    if ((int)(w1 + w2) > 0) {
      table[(base + key[j]) * kF + f] = (int)(acc1 | acc2);
    }
  }
}

}  // namespace

extern "C" int guber_sweep_window(void* table, const void* pay, const void* tgt,
                                  const void* s_blk, const void* need2, int nblk, int blk,
                                  int u, int nwin, int marker, int skip2, void* stream) {
  if (nblk <= 0) return (int)cudaSuccess;
  sweep_window_kernel<<<(unsigned int)nblk, kThreads, link_smem_bytes(2 * u, 1),
                        (cudaStream_t)stream>>>(
      (int*)table, (const int*)pay, (const int*)tgt, (const int*)s_blk,
      (const int*)need2, blk, u, nwin, marker, skip2);
  return (int)cudaGetLastError();
}
