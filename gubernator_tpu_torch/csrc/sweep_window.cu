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
// never streamed.
//
// Design (guber_sweep_window): one block per table block. Its 2u window
// entries are grouped by target slot with a sort (sweep_groups.cuh: the
// live ones compacted, then sorted by (slot, entry) in shared memory, then
// cut into runs), so grouping costs O(m log^2 m) for m live entries where
// the link it replaces cost O(u^2) dependent compares. Each run is served
// by four threads, one per 16-byte quarter of the 64-byte slot: they load
// the run's payload rows as int4, sum each half with __vadd4, take
// marker's field 15 from the fourth quarter's .w by a shuffle inside the
// group, and store the slot as four int4. Entry j < u is half 1, j >= u
// half 2, so the halves stay apart and nothing assumes sorted targets.
// Live targets lie in the block, so blocks never store into each other's
// rows. Offsets are 64-bit (the c5 table is 8 GiB).
//
// guber_sweep_window_link is the earlier design, kept so that one run can
// time the two side by side: the entries linked by target
// (sweep_links.cuh), the first entry of each target summing both halves'
// chains per field, one thread per field.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_groups.cuh"
#include "sweep_links.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK = 8;
constexpr int kF = 16;

__global__ void sweep_window_link_kernel(int* table, const int* __restrict__ pay,
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


// The two windows of table block i: (first entry of half 1, of half 2,
// whether half 2 is enabled).
struct Windows {
  long long e1, e2;
  bool en2;
};

__device__ inline Windows windows(const int* s_blk, const int* need2, long long i, int u,
                                  int nwin, int skip2) {
  const int s1 = min(max(s_blk[i], 0), nwin - 1);
  const int s2 = min(s1 + 1, nwin - 1);
  return Windows{(long long)s1 * u, (long long)s2 * u,
                 skip2 ? (need2[i] != 0) : (s1 + 1 <= nwin - 1)};
}

__device__ __forceinline__ uint4 vadd4(uint4 a, uint4 b) {
  return make_uint4(__vadd4(a.x, b.x), __vadd4(a.y, b.y), __vadd4(a.z, b.z),
                    __vadd4(a.w, b.w));
}

__global__ void __launch_bounds__(256, 8)
sweep_window_kernel(int* table, const int* __restrict__ pay, const int* __restrict__ tgt,
                    const int* __restrict__ s_blk, const int* __restrict__ need2, int blk,
                    int u, int nwin, int marker, int skip2) {
  extern __shared__ __align__(16) unsigned char smem_groups[];
  const int n = 2 * u;
  const long long i = blockIdx.x;
  const long long kblk = (long long)kK * blk;
  const long long base = i * kblk;  // first slot of this block
  const Windows win = windows(s_blk, need2, i, u, nwin, skip2);
  const sweep_groups::Groups g = sweep_groups::group(
      [&](int j) -> long long {
        const bool second = j >= u;
        if (second && !win.en2) return -1;
        const long long rel = (long long)tgt[second ? win.e2 + (j - u) : win.e1 + j] - base;
        return rel >= 0 && rel < kblk ? rel : -1;
      },
      n, smem_groups);
  const int q = threadIdx.x & 3;  // this thread's quarter of the slot
  const int src_lane = (threadIdx.x & 31 & ~3) | 3;
  const uint4* pay4 = reinterpret_cast<const uint4*>(pay);
  for (int r0 = 0; r0 < g.runs; r0 += blockDim.x / 4) {
    const int r = r0 + threadIdx.x / 4;
    uint4 acc1 = make_uint4(0, 0, 0, 0), acc2 = acc1;
    unsigned c1 = 0, c2 = 0;
    long long slot = 0;
    if (r < g.runs) {
      const int a = g.start[r], z = g.start[r + 1];
      slot = base + sweep_groups::target(g.key[a]);
      for (int k = a; k < z; ++k) {
        const int j = sweep_groups::entry(g.key[k]);
        const bool second = j >= u;
        const long long e = second ? win.e2 + (j - u) : win.e1 + j;
        const uint4 x = __ldg(pay4 + e * (kF / 4) + q);
        if (second) {
          acc2 = vadd4(acc2, x);
          ++c2;
        } else {
          acc1 = vadd4(acc1, x);
          ++c1;
        }
      }
    }
    // marker: the write test of a half is its composed field 15, the
    // fourth quarter's .w
    const unsigned m1 = __shfl_sync(0xffffffffu, acc1.w, src_lane);
    const unsigned m2 = __shfl_sync(0xffffffffu, acc2.w, src_lane);
    const unsigned w1 = marker ? m1 : c1;
    const unsigned w2 = marker ? m2 : c2;
    if (r < g.runs && (int)(w1 + w2) > 0) {
      reinterpret_cast<uint4*>(table)[slot * (kF / 4) + q] =
          make_uint4(acc1.x | acc2.x, acc1.y | acc2.y, acc1.z | acc2.z, acc1.w | acc2.w);
    }
  }
}

}  // namespace

extern "C" int guber_sweep_window(void* table, const void* pay, const void* tgt,
                                  const void* s_blk, const void* need2, int nblk, int blk,
                                  int u, int nwin, int marker, int skip2, void* stream) {
  if (nblk <= 0) return (int)cudaSuccess;
  const int n = 2 * u;
  if (n > sweep_groups::kMaxEntries) return (int)cudaErrorInvalidValue;
  const int threads = n > 256 ? 256 : 128;
  sweep_window_kernel<<<(unsigned int)nblk, threads, sweep_groups::smem_bytes(n),
                        (cudaStream_t)stream>>>(
      (int*)table, (const int*)pay, (const int*)tgt, (const int*)s_blk, (const int*)need2,
      blk, u, nwin, marker, skip2);
  return (int)cudaGetLastError();
}

extern "C" int guber_sweep_window_link(void* table, const void* pay, const void* tgt,
                                       const void* s_blk, const void* need2, int nblk,
                                       int blk, int u, int nwin, int marker, int skip2,
                                       void* stream) {
  if (nblk <= 0) return (int)cudaSuccess;
  sweep_window_link_kernel<<<(unsigned int)nblk, kThreads, link_smem_bytes(2 * u, 1),
                             (cudaStream_t)stream>>>(
      (int*)table, (const int*)pay, (const int*)tgt, (const int*)s_blk,
      (const int*)need2, blk, u, nwin, marker, skip2);
  return (int)cudaGetLastError();
}
