// slot_write: scatter each written decision's packed slot into the table.
//
// Replaces the two TPU write kernels of the JAX package,
// gubernator_tpu/ops/kernel2.py::_write_sweep (pallas_call at :533, the dense
// whole-table sweep) and ::_write_sparse (pallas_call at :616, the same sweep
// over dirty blocks only). Both run the kernel body
// kernel2._make_sweep_kernel (:395), which streams table blocks through VMEM
// and places target-sorted payload rows with int8 one-hot MXU matmuls,
// because the TPU prefers streaming blocks to scattered stores. Targets are
// unique after the claim's dedup, so the function both compute is
//
//     rows.view(NB*K, fl)[target[i]] = payload[i]   for every target[i] < NB*K
//
// and Hopper does scattered, aligned 16-byte stores well. Each slot is fl
// int32 (64 B for the full layout, 32 B for the packed ones): fl/4
// neighbouring threads each move 16 B of one slot, so a slot is one
// coalesced, aligned segment, and the table itself is never read. Sentinel
// targets (>= NB*K, the rows the claim did not keep) are skipped.
//
// Bound on an H100 (3.35 TB/s): the kernel must read every target and the
// kept payload rows and write the kept slots, B*(2*fl*4 + 4) bytes when all
// rows are kept — 17.3 MB, about 5.2 us, at the 2^17-row headline batch with
// fl = 16. That is close to a launch's own cost, so the launch is the
// likely floor; the design spends nothing beyond one pass over the bytes.
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive as
// void*; the function launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void slot_write_kernel(int4* __restrict__ rows,
                                  const int4* __restrict__ payload,
                                  const int32_t* __restrict__ target,
                                  long long n_rows, int chunks,
                                  long long n_slots) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long i = t / chunks;
  if (i >= n_rows) return;
  int c = (int)(t - i * chunks);
  int32_t tg = __ldg(target + i);
  if (tg < 0 || (long long)tg >= n_slots) return;  // sentinel: row not kept
  rows[(long long)tg * chunks + c] = __ldg(payload + i * chunks + c);
}

}  // namespace

extern "C" int guber_slot_write(void* rows, const void* payload,
                                const void* target, long long n_rows, int fl,
                                long long n_slots, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  int chunks = fl / 4;  // 16-byte pieces per slot
  long long threads = n_rows * chunks;
  long long blocks = (threads + kThreads - 1) / kThreads;
  slot_write_kernel<<<(unsigned int)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (int4*)rows, (const int4*)payload, (const int32_t*)target, n_rows,
      chunks, n_slots);
  return (int)cudaGetLastError();
}
