// slot_write: the whole table write of one decide dispatch, in one launch.
//
// Replaces the two TPU write kernels of the JAX package,
// gubernator_tpu/ops/kernel2.py::_write_sweep (pallas_call at :533, the dense
// whole-table sweep) and ::_write_sparse (pallas_call at :616, the same sweep
// over dirty blocks only). Both run the kernel body
// kernel2._make_sweep_kernel (:395) and both take what this kernel takes:
// the (B, 16) canonical rows of the decide and the claim (written, bucket,
// chosen). They pack each row to the table's layout, form its target slot
// and place it, streaming table blocks through VMEM with int8 one-hot MXU
// matmuls, because the TPU prefers streaming blocks to scattered stores.
// Targets are unique after the claim's dedup, so the function is
//
//     t = bucket[i]*K + chosen[i]                  (int32, as the claim's)
//     rows.view(NB*K, F)[t] = pack(new16[i])       for written[i], t < NB*K
//
// and Hopper does scattered, aligned 16-byte stores well. The layouts
// (ops/layout.py, pack):
//   full    F = 16: the canonical row as it is;
//   gcra32  F = 8:  fp_lo fp_hi remf_lo remf_hi limit burst dur_lo meta;
//   token32 F = 8:  fp_lo fp_hi rem_i limit exp_lo exp_hi dur_lo meta;
// meta = (dur_hi & 0x7FFFFF) | (((flags >> 8) & 0xFF) << 23), formed in
// uint32 so the bits equal PyTorch's int32 arithmetic.
//
// Bound on an H100 (3.35 TB/s), counted over its own inputs: each written
// row's 64 B canonical row, bucket (4 B) and chosen (8 B) read, every row's
// written flag (1 B) read, and each kept slot (F*4 B) written once. At the
// headline batch, B = 2^17 rows all kept in the full layout, that is
// 2^17 * (1 + 4 + 8 + 64 + 64) B = 18.5 MB, about 5.5 us.
//
// What the design does about latency. A design that loads a target,
// tests the sentinel and only then loads its payload (this kernel's first
// form) pays two memory round trips in series. Here each
// thread owns one 16 B piece of a slot in each of kRows rows (F/4
// neighbouring threads a slot, so a warp's store is whole aligned slots):
// it issues every load of its rows first — the one or two 16 B quarters
// of the canonical row its piece packs, written, bucket and chosen, none
// waiting on another — then forms the targets and packed pieces in
// registers and stores with 16-byte st.global.v4. The sentinel gates only
// the store; the table is never read; nothing is staged in shared memory.
// The stores carry an L2::evict_first cache policy: with the inputs warm
// from the decide and the table cold, as the serving path calls it, that
// was faster than plain stores in each case measured (the dispatch does
// not read the written lines again), and a few tenths of a microsecond
// slower with a cold L2.
// A persistent grid that staged each tile's inputs in shared memory by
// bulk copies (TMA, two stages a block) was measured beside it on the same
// inputs and was no faster (designs/slot_write_designs.cu, chip_smoke.py's
// `kernel` phase), so the simpler design stayed. With a cold L2 the time
// is the launch and one round trip (a kernel that adds 1 to one word,
// timed the same way) plus the bytes at the memory's rate.
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive as
// void*; the launch runs on the caller's stream, allocates nothing and does
// not synchronise or query the device, so it can be captured in a CUDA
// graph; it returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;    // rows a thread (one piece of each)
constexpr uint32_t kK = 8;  // slots a bucket

enum Layout { kFull = 0, kGcra32 = 1, kToken32 = 2 };

// Piece j of a slot packs fields of two 16 B quarters of the canonical row
// (ops/table2.py field order): a = quarter qa(j), b = quarter qb(j).
//   full    piece j is quarter j;
//   gcra32  0: fp_lo fp_hi (q0) remf_lo remf_hi (q3); 1: limit burst (q0)
//           dur_lo meta (q1);
//   token32 0: fp_lo fp_hi limit (q0) rem_i (q1); 1: exp_lo exp_hi (q2)
//           dur_lo meta (q1).
template <int L>
__device__ __forceinline__ int qa(int j) {
  return L == kFull ? j : (j == 0 || L == kGcra32 ? 0 : 2);
}
template <int L>
__device__ __forceinline__ int qb(int j) {
  return L == kFull ? j : (j == 0 && L == kGcra32 ? 3 : 1);
}
template <int L>
__device__ __forceinline__ int4 piece(int4 a, int4 b, int j) {
  if (L == kFull) return a;
  if (j == 0) return L == kGcra32 ? make_int4(a.x, a.y, b.y, b.x) : make_int4(a.x, a.y, b.x, a.z);
  // meta: dur_hi (field 7 = b.w) and the status byte of flags (field 5 = b.y)
  const uint32_t meta = ((uint32_t)b.w & 0x7FFFFFu) | ((((uint32_t)b.y >> 8) & 0xFFu) << 23);
  return make_int4(a.z, a.w, b.z, (int32_t)meta);
}

// A 16-byte store marked to leave the L2 first.
__device__ __forceinline__ void store_evict_first(int4* p, int4 v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.s32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy)
               : "memory");
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    slot_write_kernel(int4* __restrict__ rows, const int4* __restrict__ new16,
                      const uint8_t* __restrict__ written, const int32_t* __restrict__ bucket,
                      const long long* __restrict__ chosen, long long n_rows,
                      long long n_slots) {
  constexpr int kPieces = L == kFull ? 4 : 2;  // 16 B pieces a slot
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  const long long n_items = n_rows * kPieces;
  const long long base = (long long)blockIdx.x * kThreads * kRows + threadIdx.x;
  const int j = threadIdx.x % kPieces;  // every item of this thread is piece j
  int4 a[kRows], b[kRows];
  uint8_t w[kRows];
  int32_t bk[kRows];
  long long ch[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {  // every load first
    const long long item = base + (long long)k * kThreads;
    w[k] = 0;
    if (item < n_items) {
      const long long i = item / kPieces;
      a[k] = __ldg(new16 + i * 4 + qa<L>(j));
      b[k] = L == kFull ? a[k] : __ldg(new16 + i * 4 + qb<L>(j));
      w[k] = __ldg(written + i);
      bk[k] = __ldg(bucket + i);
      ch[k] = __ldg(chosen + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {  // then the stores
    if (!w[k]) continue;
    const int32_t t = (int32_t)((uint32_t)bk[k] * kK + (uint32_t)ch[k]);
    if (t < 0 || (long long)t >= n_slots) continue;  // no slot: not kept
    store_evict_first(rows + (long long)t * kPieces + j, piece<L>(a[k], b[k], j), policy);
  }
}

template <int L>
void launch(cudaStream_t stream, void* rows, const void* new16, const void* written,
            const void* bucket, const void* chosen, long long n_rows, long long n_slots) {
  const long long per_block = (long long)kThreads * kRows;
  const long long items = n_rows * (L == kFull ? 4 : 2);
  slot_write_kernel<L><<<(unsigned int)((items + per_block - 1) / per_block), kThreads, 0,
                         stream>>>((int4*)rows, (const int4*)new16, (const uint8_t*)written,
                                   (const int32_t*)bucket, (const long long*)chosen, n_rows,
                                   n_slots);
}

}  // namespace

extern "C" int guber_slot_write(void* rows, const void* new16, const void* written,
                                const void* bucket, const void* chosen, long long n_rows,
                                long long n_slots, int layout, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (layout) {
    case kFull: launch<kFull>(s, rows, new16, written, bucket, chosen, n_rows, n_slots); break;
    case kGcra32: launch<kGcra32>(s, rows, new16, written, bucket, chosen, n_rows, n_slots); break;
    case kToken32: launch<kToken32>(s, rows, new16, written, bucket, chosen, n_rows, n_slots); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
