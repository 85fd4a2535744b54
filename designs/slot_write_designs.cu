// The designs the package's slot_write kernel (gubernator_tpu_torch/csrc/
// slot_write.cu) was measured against; not part of the package.
// chip_smoke.py builds this file beside the package's kernels and, in its
// `kernel` phase, holds each design to the plain version and times it next
// to the package's kernel on the same inputs:
//
//   guber_slot_write_first the kernel's first design: the caller forms the
//                          int32 targets and packs the payload with PyTorch
//                          ops; four threads a 64 B slot, each loads its
//                          target, tests the sentinel, then loads and
//                          stores its 16 B;
//   guber_slot_write_regs_row
//                          register-only, one thread a row: two rows a
//                          thread, every load of both rows (the 64 B
//                          canonical row, written, bucket, chosen) issued
//                          before any store; each thread stores its rows'
//                          whole slots;
//   guber_slot_write_tma   a persistent grid (the blocks the card holds at
//                          once) walking tiles of 128 rows; one thread a
//                          block stages each tile's four inputs in shared
//                          memory by bulk copies (cp.async.bulk on an
//                          mbarrier, two stages, so the next tile's loads
//                          fly while this tile's stores issue); stores as
//                          the package's;
//   guber_slot_write_plain_stores
//                          the package's kernel with plain stores in place
//                          of its L2::evict_first ones.
//
// Plain C interface, as the package's kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../gubernator_tpu_torch/csrc/bulk_stream.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;
constexpr uint32_t kK = 8;

enum Layout { kFull = 0, kGcra32 = 1, kToken32 = 2 };

constexpr int FP_LO = 0, FP_HI = 1, LIMIT = 2, BURST = 3, REM_I = 4, FLAGS = 5;
constexpr int DUR_LO = 6, DUR_HI = 7, EXP_LO = 10, EXP_HI = 11, REMF_HI = 12, REMF_LO = 13;

template <int L>
__device__ __forceinline__ int4 piece(const int32_t* f, int c) {
  if (L == kFull) return reinterpret_cast<const int4*>(f)[c];
  if (c == 0) {
    return L == kGcra32 ? make_int4(f[FP_LO], f[FP_HI], f[REMF_LO], f[REMF_HI])
                        : make_int4(f[FP_LO], f[FP_HI], f[REM_I], f[LIMIT]);
  }
  const uint32_t meta = ((uint32_t)f[DUR_HI] & 0x7FFFFFu) |
                        ((((uint32_t)f[FLAGS] >> 8) & 0xFFu) << 23);
  return L == kGcra32 ? make_int4(f[LIMIT], f[BURST], f[DUR_LO], (int32_t)meta)
                      : make_int4(f[EXP_LO], f[EXP_HI], f[DUR_LO], (int32_t)meta);
}

// ------------------------------------------------------ first design

__global__ void first_kernel(int4* __restrict__ rows, const int4* __restrict__ payload,
                             const int32_t* __restrict__ target, long long n_rows, int chunks,
                             long long n_slots) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long i = t / chunks;
  if (i >= n_rows) return;
  int c = (int)(t - i * chunks);
  int32_t tg = __ldg(target + i);
  if (tg < 0 || (long long)tg >= n_slots) return;
  rows[(long long)tg * chunks + c] = __ldg(payload + i * chunks + c);
}

// ------------------------------------------------------- register-only

constexpr int kRows = 2;  // rows a thread

template <int L>
__global__ void __launch_bounds__(kThreads)
    regs_row_kernel(int4* __restrict__ rows, const int4* __restrict__ new16,
                const uint8_t* __restrict__ written, const int32_t* __restrict__ bucket,
                const long long* __restrict__ chosen, long long n_rows, long long n_slots) {
  constexpr int kPieces = L == kFull ? 4 : 2;
  const long long base = (long long)blockIdx.x * kThreads * kRows + threadIdx.x;
  int4 p[kRows][4];
  uint8_t w[kRows];
  int32_t b[kRows];
  long long c[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long i = base + (long long)k * kThreads;
    w[k] = 0;
    if (i < n_rows) {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[k][j] = __ldg(new16 + i * 4 + j);
      w[k] = __ldg(written + i);
      b[k] = __ldg(bucket + i);
      c[k] = __ldg(chosen + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (!w[k]) continue;
    const int32_t t = (int32_t)((uint32_t)b[k] * kK + (uint32_t)c[k]);
    if (t < 0 || (long long)t >= n_slots) continue;
    const int32_t* f = reinterpret_cast<const int32_t*>(p[k]);
#pragma unroll
    for (int j = 0; j < kPieces; ++j) rows[(long long)t * kPieces + j] = piece<L>(f, j);
  }
}

// ------------------------------ the package's kernel with plain stores

// One thread a 16 B piece of a slot, kRows pieces a thread. Piece j of a
// packed slot takes fields from two 16 B quarters of the canonical row,
// a = quarter qa(j) and b = quarter qb(j) (the fields piece<L> reads).
template <int L>
__device__ __forceinline__ int qa(int j) {
  return L == kFull ? j : (j == 0 || L == kGcra32 ? 0 : 2);
}
template <int L>
__device__ __forceinline__ int qb(int j) {
  return L == kFull ? j : (j == 0 && L == kGcra32 ? 3 : 1);
}
template <int L>
__device__ __forceinline__ int4 piece_q(int4 a, int4 b, int j) {
  if (L == kFull) return a;
  if (j == 0) return L == kGcra32 ? make_int4(a.x, a.y, b.y, b.x) : make_int4(a.x, a.y, b.x, a.z);
  const uint32_t meta = ((uint32_t)b.w & 0x7FFFFFu) | ((((uint32_t)b.y >> 8) & 0xFFu) << 23);
  return make_int4(a.z, a.w, b.z, (int32_t)meta);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    plain_stores_kernel(int4* __restrict__ rows, const int4* __restrict__ new16,
                        const uint8_t* __restrict__ written, const int32_t* __restrict__ bucket,
                        const long long* __restrict__ chosen, long long n_rows,
                        long long n_slots) {
  constexpr int kPieces = L == kFull ? 4 : 2;
  const long long n_items = n_rows * kPieces;
  const long long base = (long long)blockIdx.x * kThreads * kRows + threadIdx.x;
  const int j = threadIdx.x % kPieces;
  int4 a[kRows], b4[kRows];
  uint8_t w[kRows];
  int32_t b[kRows];
  long long c[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long item = base + (long long)k * kThreads;
    w[k] = 0;
    if (item < n_items) {
      const long long i = item / kPieces;
      a[k] = __ldg(new16 + i * 4 + qa<L>(j));
      b4[k] = L == kFull ? a[k] : __ldg(new16 + i * 4 + qb<L>(j));
      w[k] = __ldg(written + i);
      b[k] = __ldg(bucket + i);
      c[k] = __ldg(chosen + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (!w[k]) continue;
    const int32_t t = (int32_t)((uint32_t)b[k] * kK + (uint32_t)c[k]);
    if (t < 0 || (long long)t >= n_slots) continue;
    rows[(long long)t * kPieces + j] = piece_q<L>(a[k], b4[k], j);
  }
}

// ------------------------------------------------- TMA, persistent grid

struct __align__(128) Stage {
  int4 pay[kTile * 4];
  long long chosen[kTile];
  int32_t bucket[kTile];
  uint8_t written[kTile];
};
constexpr uint32_t kPayBytes = kTile * 64, kChosenBytes = kTile * 8;
constexpr uint32_t kBucketBytes = kTile * 4, kWrittenBytes = kTile;
constexpr uint32_t kStageBytes = kPayBytes + kChosenBytes + kBucketBytes + kWrittenBytes;

// Store rows [0, n) of one tile; the pointers are shared memory (a staged
// tile) or device memory (the ragged last tile, whose byte counts need not
// be the multiples of 16 that bulk copies take).
template <int L>
__device__ __forceinline__ void store_tile(int4* __restrict__ rows, const int32_t* pay,
                                           const uint8_t* written, const int32_t* bucket,
                                           const long long* chosen, int n, long long n_slots) {
  constexpr int kPieces = L == kFull ? 4 : 2;
  for (int j = threadIdx.x; j < n * kPieces; j += kThreads) {
    const int r = j / kPieces, c = j % kPieces;
    if (!written[r]) continue;
    const int32_t t = (int32_t)((uint32_t)bucket[r] * kK + (uint32_t)chosen[r]);
    if (t < 0 || (long long)t >= n_slots) continue;
    rows[(long long)t * kPieces + c] = piece<L>(pay + r * 16, c);
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    tma_kernel(int4* __restrict__ rows, const int4* __restrict__ new16v,
               const uint8_t* __restrict__ written, const int32_t* __restrict__ bucket,
               const long long* __restrict__ chosen, long long n_rows, long long n_slots) {
  const int32_t* new16 = reinterpret_cast<const int32_t*>(new16v);
  __shared__ Stage stage[2];
  __shared__ uint64_t bars[2];
  const long long tiles = (n_rows + kTile - 1) / kTile;
  const long long whole = n_rows / kTile;  // tiles that bulk copies can load
  const long long first = blockIdx.x, step = gridDim.x;
  if (first >= tiles) return;
  const long long nk = (tiles - 1 - first) / step + 1;  // this block's tiles
  const bool lead = threadIdx.x == 0;
  // lead thread: start the loads of this block's k-th tile into stage k & 1
  auto fill = [&](long long k) {
    const long long t = first + k * step;
    if (t >= whole) return;
    Stage& s = stage[k & 1];
    uint64_t* bar = &bars[k & 1];
    const long long r0 = t * kTile;
    bulk_stream::bar_expect(bar, kStageBytes);
    bulk_stream::load(s.pay, new16 + r0 * 16, kPayBytes, bar);
    bulk_stream::load(s.chosen, chosen + r0, kChosenBytes, bar);
    bulk_stream::load(s.bucket, bucket + r0, kBucketBytes, bar);
    bulk_stream::load(s.written, written + r0, kWrittenBytes, bar);
  };
  if (lead) {
    bulk_stream::bar_init(&bars[0], 1);
    bulk_stream::bar_init(&bars[1], 1);
    bulk_stream::bar_init_fence();
    fill(0);
    if (nk > 1) fill(1);
  }
  __syncthreads();
  for (long long k = 0; k < nk; ++k) {
    const long long r0 = (first + k * step) * kTile;
    if (first + k * step < whole) {
      const Stage& s = stage[k & 1];
      // the k-th use of a stage completes its barrier's phase k / 2
      bulk_stream::bar_wait(&bars[k & 1], (uint32_t)((k >> 1) & 1));
      store_tile<L>(rows, reinterpret_cast<const int32_t*>(s.pay), s.written, s.bucket,
                    s.chosen, kTile, n_slots);
    } else {
      store_tile<L>(rows, new16 + r0 * 16, written + r0, bucket + r0, chosen + r0,
                    (int)(n_rows - r0), n_slots);
    }
    if (k + 2 < nk) {
      __syncthreads();  // every thread has read stage k & 1
      if (lead) fill(k + 2);
    }
  }
}

// ------------------------------------------------------------ launches

using Kernel = void (*)(int4*, const int4*, const uint8_t*, const int32_t*, const long long*,
                        long long, long long);

template <template <int> class K>
Kernel for_layout(int layout) {
  return layout == kFull ? K<kFull>::fn() : layout == kGcra32 ? K<kGcra32>::fn() : K<kToken32>::fn();
}
template <int L> struct RegsRow { static Kernel fn() { return regs_row_kernel<L>; } };
template <int L> struct PlainStores { static Kernel fn() { return plain_stores_kernel<L>; } };
template <int L> struct Tma { static Kernel fn() { return tma_kernel<L>; } };

unsigned int per_thread_blocks(long long items) {
  return (unsigned int)((items + kThreads * kRows - 1) / (kThreads * kRows));
}

int run(Kernel kernel, unsigned int blocks, void* rows, const void* new16, const void* written,
        const void* bucket, const void* chosen, long long n_rows, long long n_slots,
        void* stream) {
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int4*)rows, (const int4*)new16, (const uint8_t*)written, (const int32_t*)bucket,
      (const long long*)chosen, n_rows, n_slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int guber_slot_write_first(void* rows, const void* payload, const void* target,
                                      long long n_rows, int fl, long long n_slots,
                                      void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  const int chunks = fl / 4;
  const long long blocks = (n_rows * chunks + kThreads - 1) / kThreads;
  first_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int4*)rows, (const int4*)payload, (const int32_t*)target, n_rows, chunks, n_slots);
  return (int)cudaGetLastError();
}

extern "C" int guber_slot_write_regs_row(void* rows, const void* new16, const void* written,
                                         const void* bucket, const void* chosen,
                                         long long n_rows, long long n_slots, int layout,
                                         void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  return run(for_layout<RegsRow>(layout), per_thread_blocks(n_rows), rows, new16, written,
             bucket, chosen, n_rows, n_slots, stream);
}

extern "C" int guber_slot_write_plain_stores(void* rows, const void* new16, const void* written,
                                             const void* bucket, const void* chosen,
                                             long long n_rows, long long n_slots, int layout,
                                             void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  const long long items = n_rows * (layout == kFull ? 4 : 2);
  return run(for_layout<PlainStores>(layout), per_thread_blocks(items), rows, new16, written,
             bucket, chosen, n_rows, n_slots, stream);
}

extern "C" int guber_slot_write_tma(void* rows, const void* new16, const void* written,
                                    const void* bucket, const void* chosen, long long n_rows,
                                    long long n_slots, int layout, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  const Kernel kernel = for_layout<Tma>(layout);
  // the persistent grid: the blocks the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long tiles = (n_rows + kTile - 1) / kTile, grid = (long long)sms * per_sm;
  return run(kernel, (unsigned int)(tiles < grid ? tiles : grid), rows, new16, written, bucket,
             chosen, n_rows, n_slots, stream);
}
