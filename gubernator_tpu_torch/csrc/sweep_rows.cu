// sweep_rows: compose one window of U full-row updates into each block of
// a (NB, 128) int32 table, with per-lane int8 masks.
//
// Replaces exp/exp_mem2.py::scat_kernel (pallas_call at :146 via
// sweep_scatter, U=64; :176 via sweep_scatter2, U=128; :197 via
// sweep_scatter_alias, the table donated). For bucket row r of block b
// (blk rows; window b holds entries b*U .. b*U+U-1) and lane l:
//
//   W   = sum over entries with bkt == r of int32(mask[e][l])
//   P_s = sum of int8((rows[e][l] >> 8s) & 0xFF)   (signed bytes, the
//         payload NOT masked)
//   acc = OR_s (P_s << 8s)                         (wrapping int32)
//   out[r][l] = W > 0 ? acc : table[r][l]
//
// so a byte >= 0x80 smears ones upward, exactly as the TPU's one-hot
// matmuls compute it. Entries with bkt outside [0, blk) match no row.
//
// Bound on an H100 (3.35 TB/s): out of place, the table read and written
// once (2.147 GB at 2^21 rows) plus the window's rows and masks, 0.654 ms
// at U=64; in place, only the window (42 MB at U=64) and the written
// lanes, about 17 us.
//
// Design (guber_sweep_rows): a block groups its table block's window
// entries by target row (sweep_groups.cuh), and one warp composes a run,
// each lane 4 lanes of the row: an int4 of rows and an int32 of 4 mask
// bytes per entry, from shared memory where the bulk loads of
// bulk_stream.cuh put them. A block owns its rows, so stores never race.
//
//   * Out of place, kParts blocks of four warps per table block, each
//     streaming its share of the rows through a ring of 8 KB stages whose
//     first loads are issued before the grouping; small blocks finish
//     together, so the stream has no long tail. Since the runs come out in
//     row order, a block's runs are one range of the sorted entries, and
//     it stages just those, a row and a mask each; the ring takes the
//     shared memory they leave, so a block whose rows draw many entries
//     (exp_mem2's window names rows 0..U-1) keeps a shorter ring instead of
//     reading them from global memory. As each stage arrives the warps
//     compose into it the runs whose rows lie in it, fence the proxies,
//     and one thread bulk-stores it: every table byte is written once,
//     composed or not, and the compose rides on the stream.
//   * In place, one block of eight warps per table block: its whole window
//     (40 KB at U=64) lands by bulk loads issued before the grouping, then
//     each warp composes runs and stores the lanes with W > 0. The partly
//     written 32-byte sectors cost the memory a read of each touched row
//     besides the write.
//
// guber_sweep_rows_copy_then_compose is the earlier design, kept so that
// one run can time the two side by side: each block first copies its 1 MiB
// of rows (four 16-byte loads in flight per thread), syncs, then links
// the entries by target (sweep_links.cuh) and stores the composed lanes
// over the copy, one thread per (entry, lane) of each chain's first entry.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_stream.cuh"
#include "sweep_groups.cuh"
#include "sweep_links.cuh"

namespace {

constexpr int kRow = 128;
constexpr int kRowBytes = kRow * 4;

// --------------------------------------------------------------- design

constexpr int kWarps = 4;
constexpr int kStageBytes = 8 * 1024;
constexpr int kStageRows = kStageBytes / kRowBytes;
constexpr int kMaxStages = 8;
constexpr int kEarly = 3;          // stages filled before the grouping
constexpr int kParts = 8;          // stream blocks per table block
constexpr size_t kStreamSmem = 108 * 1024;  // ring and staged entries of a stream block
constexpr int kInplaceWarps = 8;
constexpr int kEntryBytes = kRowBytes + kRow;  // an entry's row and mask
constexpr size_t kMaxSmem = 226 * 1024;  // of one block per SM

// Four lanes of one row composed from a run: the values and, in bit l,
// whether lane l is written (W > 0).
struct Lanes {
  int4 v;
  unsigned written;
};

__device__ __forceinline__ int sbyte(int x, int s) { return (int)(int8_t)(x >> (8 * s)); }

// Lanes 4*lane .. 4*lane+3 of the run key[a..z). Entry k of the run is
// row (k - kbase) of (wrows, wmask) when kbase >= 0 (a block's staged
// entries, in key order), else row entry(key[k]) (a window in entry
// order, in shared or global memory).
__device__ inline Lanes compose(const int* wrows, const int8_t* wmask,
                                const unsigned long long* key, int a, int z, int lane,
                                int kbase) {
  int w[4] = {0, 0, 0, 0};
  int p[4][4] = {};
  for (int k = a; k < z; ++k) {
    const int j = kbase >= 0 ? k - kbase : sweep_groups::entry(key[k]);
    const int4 x = reinterpret_cast<const int4*>(wrows + (size_t)j * kRow)[lane];
    const int m = reinterpret_cast<const int*>(wmask + (size_t)j * kRow)[lane];
    const int xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      w[l] += sbyte(m, l);
#pragma unroll
      for (int s = 0; s < 4; ++s) p[l][s] += sbyte(xs[l], s);
    }
  }
  int v[4];
  unsigned written = 0;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    v[l] = (int)((unsigned)p[l][0] | ((unsigned)p[l][1] << 8) | ((unsigned)p[l][2] << 16) |
                 ((unsigned)p[l][3] << 24));
    written |= (w[l] > 0 ? 1u : 0u) << l;
  }
  return Lanes{make_int4(v[0], v[1], v[2], v[3]), written};
}

__device__ __forceinline__ void store_lanes(int* dst, const Lanes& c) {
  if (c.written == 0xFu) {
    *reinterpret_cast<int4*>(dst) = c.v;
    return;
  }
  if (c.written & 1u) dst[0] = c.v.x;
  if (c.written & 2u) dst[1] = c.v.y;
  if (c.written & 4u) dst[2] = c.v.z;
  if (c.written & 8u) dst[3] = c.v.w;
}

__device__ inline long long row_of(const sweep_groups::Groups& g, int r) {
  return sweep_groups::target(g.key[g.start[r]]);
}

// Table block b's entries grouped by target row, by every thread.
__device__ inline sweep_groups::Groups group_rows(const int* bkt, long long b, int U, int blk,
                                                  unsigned char* smem) {
  return sweep_groups::group(
      [&](int j) -> long long {
        const int v = bkt[b * U + j];
        return v >= 0 && v < blk ? v : -1;
      },
      U, smem);
}

// Out of place: block (b, part) streams rows [r0, r1) of table block b
// through a ring of 8 KB stages, and its warps compose into each stage,
// before its store, the runs whose rows lie in it. Since the runs are in
// row order, they are one range of the sorted entries; the block stages
// just those at the top of its kStreamSmem bytes and gives the ring what
// they leave (kEarly stages at least: those are filled before the
// grouping), or reads them from global memory if they leave less.
__global__ void __launch_bounds__(kWarps * 32)
sweep_rows_stream_kernel(const int* table, int* out, const int* __restrict__ rows,
                         const int8_t* __restrict__ mask, const int* __restrict__ bkt, int U,
                         int blk, int parts) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxStages + 1];
  const long long b = blockIdx.x / parts;
  const long long span =  // rows of a part, in whole stages
      ((blk + parts - 1) / parts + kStageRows - 1) / kStageRows * kStageRows;
  const long long r0 = (blockIdx.x % parts) * span;
  const long long r1 = r0 + span < blk ? r0 + span : blk;
  if (r0 >= r1) return;
  unsigned char* ring = smem;
  uint64_t* wbar = &bars[kMaxStages];

  const long long bytes = (r1 - r0) * kRowBytes;
  const long long chunks = (bytes + kStageBytes - 1) / kStageBytes;
  const long long first_row = b * blk + r0;
  const char* src = reinterpret_cast<const char*>(table) + first_row * kRowBytes;
  char* dst = reinterpret_cast<char*>(out) + first_row * kRowBytes;
  int stages = kEarly;
  auto size = [&](long long k) {
    const long long left = bytes - k * kStageBytes;
    return (uint32_t)(left < kStageBytes ? left : kStageBytes);
  };
  auto fill = [&](long long k) {
    const int s = (int)(k % stages);
    bulk_stream::bar_expect(&bars[s], size(k));
    bulk_stream::load(ring + (size_t)s * kStageBytes, src + k * kStageBytes, size(k),
                      &bars[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s <= kMaxStages; ++s) bulk_stream::bar_init(&bars[s], 1);
    bulk_stream::bar_init_fence();
    for (long long k = 0; k < chunks && k < kEarly; ++k) fill(k);
  }
  // group() syncs the block before any thread waits on a barrier
  const sweep_groups::Groups g = group_rows(bkt, b, U, blk, smem + kStreamSmem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int ra = 0, rz = 0;  // this part's runs
  for (int r = lane; r < g.runs; r += 32) {
    ra += row_of(g, r) < r0;
    rz += row_of(g, r) < r1;
  }
  ra = __reduce_add_sync(0xffffffffu, ra);
  rz = __reduce_add_sync(0xffffffffu, rz);
  const int ka = g.start[ra], kz = g.start[rz];  // and their entries
  const size_t staged_bytes = (size_t)(kz - ka) * kEntryBytes;
  const bool staged = staged_bytes + (size_t)kEarly * kStageBytes <= kStreamSmem;
  int* srows = reinterpret_cast<int*>(smem + kStreamSmem - staged_bytes);
  int8_t* smask = reinterpret_cast<int8_t*>(srows + (kz - ka) * kRow);
  const int* wr = staged ? srows : rows + b * U * kRow;
  const int8_t* wm = staged ? smask : mask + b * U * kRow;
  const int kbase = staged ? ka : -1;
  const size_t room = kStreamSmem - (staged ? staged_bytes : 0);
  stages = (int)(room / kStageBytes < (size_t)kMaxStages ? room / kStageBytes : kMaxStages);
  if (threadIdx.x == 0) {
    for (long long k = kEarly; k < chunks && k < stages; ++k) fill(k);
    if (staged) bulk_stream::bar_expect(wbar, (uint32_t)staged_bytes);
  }
  __syncthreads();
  if (staged) {
    if (warp == 0) {
      for (int k = ka + lane; k < kz; k += 32) {
        const long long e = b * U + sweep_groups::entry(g.key[k]);
        bulk_stream::load(srows + (k - ka) * kRow, rows + e * kRow, kRowBytes, wbar);
        bulk_stream::load(smask + (k - ka) * kRow, mask + e * kRow, kRow, wbar);
      }
    }
    bulk_stream::bar_wait(wbar, 0);
  }
  int r = ra;
  for (long long k = 0; k < chunks; ++k) {
    const int s = (int)(k % stages);
    bulk_stream::bar_wait(&bars[s], (uint32_t)((k / stages) & 1));
    int* stage = reinterpret_cast<int*>(ring + (size_t)s * kStageBytes);
    const long long first = r0 + k * kStageRows;  // first row of the chunk in the block
    int end = r;  // the runs of this chunk: [r, end)
    while (end < rz && row_of(g, end) < first + kStageRows) ++end;
    for (int q = r + warp; q < end; q += kWarps) {
      const Lanes c = compose(wr, wm, g.key, g.start[q], g.start[q + 1], lane, kbase);
      store_lanes(stage + (row_of(g, q) - first) * kRow + lane * 4, c);
    }
    r = end;
    bulk_stream::fence_shared();
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_stream::store(dst + k * kStageBytes, stage, size(k));
      if (k >= 1 && k - 1 + stages < chunks) {
        bulk_stream::wait_read<1>();  // the store of chunk k - 1 has read its stage
        fill(k - 1 + stages);
      }
    }
  }
  if (threadIdx.x == 0) bulk_stream::wait_all();
}

// In place: one block per table block. Its whole window comes into shared
// memory by bulk loads, issued before the grouping, when `staged`, else it
// is read from global memory; each warp composes runs and stores their
// lanes with W > 0.
__global__ void __launch_bounds__(kInplaceWarps * 32)
sweep_rows_inplace_kernel(int* table, const int* __restrict__ rows,
                          const int8_t* __restrict__ mask, const int* __restrict__ bkt, int U,
                          int blk, int staged) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t wbar;
  const long long b = blockIdx.x;
  const size_t wbytes = staged ? (size_t)U * kEntryBytes : 0;
  if (threadIdx.x == 0 && staged) {
    bulk_stream::bar_init(&wbar, 1);
    bulk_stream::bar_init_fence();
    bulk_stream::bar_expect(&wbar, (uint32_t)wbytes);
    bulk_stream::load(smem, rows + b * U * kRow, (uint32_t)U * kRowBytes, &wbar);
    bulk_stream::load(smem + (size_t)U * kRowBytes, mask + b * U * kRow, (uint32_t)U * kRow,
                      &wbar);
  }
  // group() syncs the block before any thread waits on the barrier
  const sweep_groups::Groups g = group_rows(bkt, b, U, blk, smem + wbytes);
  if (staged) bulk_stream::bar_wait(&wbar, 0);
  const int* wr = staged ? reinterpret_cast<const int*>(smem) : rows + b * U * kRow;
  const int8_t* wm = staged ? reinterpret_cast<const int8_t*>(smem + (size_t)U * kRowBytes)
                            : mask + b * U * kRow;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < g.runs; r += kInplaceWarps) {
    const Lanes c = compose(wr, wm, g.key, g.start[r], g.start[r + 1], lane, -1);
    store_lanes(table + (b * blk + row_of(g, r)) * kRow + lane * 4, c);
  }
}

// ------------------------------------------------------- earlier design

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ inline void copy_rows(const int4* __restrict__ src, int4* __restrict__ dst,
                                 long long n) {
  long long i = threadIdx.x;
  const long long stride = blockDim.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = __ldcs(src + i + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) __stcs(dst + i + k * stride, v[k]);
  }
  for (; i < n; i += stride) __stcs(dst + i, __ldcs(src + i));
}

__global__ void sweep_rows_copy_then_compose_kernel(const int* table, int* out,
                                                    const int* __restrict__ rows,
                                                    const int8_t* __restrict__ mask,
                                                    const int* __restrict__ bkt, int U,
                                                    int blk, int copy) {
  extern __shared__ int smem_link[];
  int* key = smem_link;
  int* nxt = smem_link + U;
  unsigned char* head = (unsigned char*)(smem_link + 2 * U);
  const long long b = blockIdx.x;
  const long long row0 = b * blk;  // first table row of this block
  if (copy) {
    copy_rows((const int4*)(table + row0 * kRow), (int4*)(out + row0 * kRow),
              (long long)blk * (kRow / 4));
  }
  for (int e = threadIdx.x; e < U; e += blockDim.x) {
    const int v = bkt[b * U + e];
    key[e] = (v >= 0 && v < blk) ? v : -1;
  }
  __syncthreads();
  link_keys(key, nxt, head, U);
  __syncthreads();  // also orders the copy's stores before the lane stores
  for (int p = threadIdx.x; p < U * kRow; p += blockDim.x) {
    const int e = p / kRow;
    const int l = p % kRow;
    if (!head[e]) continue;
    int w = 0, p0 = 0, p1 = 0, p2 = 0, p3 = 0;
    for (int m = e; m >= 0; m = nxt[m]) {
      const long long off = (b * U + m) * kRow + l;
      const unsigned x = (unsigned)rows[off];
      w += (int)mask[off];
      p0 += (int)(int8_t)(x & 0xFFu);
      p1 += (int)(int8_t)((x >> 8) & 0xFFu);
      p2 += (int)(int8_t)((x >> 16) & 0xFFu);
      p3 += (int)(int8_t)((x >> 24) & 0xFFu);
    }
    if (w > 0) {
      const unsigned acc = (unsigned)p0 | ((unsigned)p1 << 8) | ((unsigned)p2 << 16) |
                           ((unsigned)p3 << 24);
      out[(row0 + key[e]) * kRow + l] = (int)acc;
    }
  }
}

}  // namespace

extern "C" int guber_sweep_rows(const void* table, void* out, const void* rows,
                                const void* mask, const void* bkt, int nblk, int U,
                                int blk, int copy, void* stream) {
  if (nblk <= 0) return (int)cudaSuccess;
  if (U > sweep_groups::kMaxEntries) return (int)cudaErrorInvalidValue;
  const size_t groups = sweep_groups::smem_bytes(U);
  cudaError_t err;
  if (!copy) {
    const int staged = groups + (size_t)U * kEntryBytes <= kMaxSmem;
    const size_t smem = groups + (staged ? (size_t)U * kEntryBytes : 0);
    err = cudaFuncSetAttribute(sweep_rows_inplace_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sweep_rows_inplace_kernel<<<(unsigned int)nblk, kInplaceWarps * 32, smem,
                                (cudaStream_t)stream>>>(
        (int*)out, (const int*)rows, (const int8_t*)mask, (const int*)bkt, U, blk, staged);
    return (int)cudaGetLastError();
  }
  const size_t smem = kStreamSmem + groups;  // two blocks per SM at U <= 128
  int parts = (blk + kStageRows - 1) / kStageRows;  // at least one stage of rows each
  if (parts > kParts) parts = kParts;
  err = cudaFuncSetAttribute(sweep_rows_stream_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_rows_stream_kernel<<<(unsigned int)((long long)nblk * parts), kWarps * 32, smem,
                             (cudaStream_t)stream>>>(
      (const int*)table, (int*)out, (const int*)rows, (const int8_t*)mask, (const int*)bkt,
      U, blk, parts);
  return (int)cudaGetLastError();
}

extern "C" int guber_sweep_rows_copy_then_compose(const void* table, void* out,
                                                  const void* rows, const void* mask,
                                                  const void* bkt, int nblk, int U, int blk,
                                                  int copy, void* stream) {
  if (nblk <= 0) return (int)cudaSuccess;
  sweep_rows_copy_then_compose_kernel<<<(unsigned int)nblk, kThreads, link_smem_bytes(U, 0),
                                        (cudaStream_t)stream>>>(
      (const int*)table, (int*)out, (const int*)rows, (const int8_t*)mask, (const int*)bkt,
      U, blk, copy);
  return (int)cudaGetLastError();
}
