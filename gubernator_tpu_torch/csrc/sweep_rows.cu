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
// lanes, about 23 us. Design: one block per 2048-row table block. Out of
// place it first streams its 1 MiB of rows (four 16-byte loads in flight
// per thread), syncs, then stores the composed lanes over them; in place
// it touches only lanes with W > 0. The window's entries are linked by
// target row in shared memory (sweep_links.cuh), and the first entry of
// each row sums its chain for every lane, so each lane is stored by one
// thread. A block owns its rows, so in-place stores never race.
//
// Plain C interface, loaded with ctypes: launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_links.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 128;
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

__global__ void sweep_rows_kernel(const int* table, int* out, const int* __restrict__ rows,
                                  const int8_t* __restrict__ mask,
                                  const int* __restrict__ bkt, int U, int blk, int copy) {
  extern __shared__ int smem[];
  int* key = smem;
  int* nxt = smem + U;
  unsigned char* head = (unsigned char*)(smem + 2 * U);
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
  sweep_rows_kernel<<<(unsigned int)nblk, kThreads, link_smem_bytes(U, 0),
                      (cudaStream_t)stream>>>(
      (const int*)table, (int*)out, (const int*)rows, (const int8_t*)mask,
      (const int*)bkt, U, blk, copy);
  return (int)cudaGetLastError();
}
