// ring_exchange: the ownership all-to-all of the mesh engine.
//
// Replaces the TPU kernel of the JAX package's mesh exchange,
// gubernator_tpu/parallel/ring.py::_ring_kernel (pallas_call at :217, built
// by _ring_pallas). For D shards whose send buffers send[s] are (D, L, C)
// contiguous tensors with the destination as leading axis, it writes
//
//     recv[d][s] = send[s][d]    for every pair (s, d), the own block too,
//
// the receive layout of lax.all_to_all(split_axis=0, concat_axis=0). Each
// (s, d) slab is one contiguous run of L*C elements, so the exchange is D^2
// slab copies.
//
// Design: the TPU kernel runs D-1 remote-DMA hops with two semaphore slots,
// so hop k+1 is in flight while hop k completes, and copies its own block
// locally. On Hopper the blocks of one grid already run every hop at once,
// so the hop is a grid dimension (blockIdx.y = one (source, destination)
// slab) and there are no semaphores and no waits. It is a push design: the
// blocks of source s store into the owner's receive buffer through the
// owner's device pointer. Pointers travel by value in the argument struct,
// at most 8 sources and 8 destinations per launch (send[MAXD], recv[MAXD]):
// no pointer table on the device, no copy per call. A launch serves a group
// of source shards that live on one card (s0 .. s0+ns-1) against a group of
// destinations (d0 .. d0+nd-1), so a simulated mesh of D <= 8 shards on one
// card costs one launch per exchange, and a wider mesh ceil(D/8)^2. Across cards the same code stores through peer
// pointers in CUDA's unified address space; the wrapper enables peer access
// once (guber_ring_enable_peer) and orders the receiving card's stream after
// every source's launch with events. On one card, stream order is the only
// ordering needed.
//
// Each block copies part of one slab with 16-byte loads and stores,
// neighbouring threads on neighbouring addresses, in a grid-stride loop with
// four loads in flight per thread. Slabs and buffers are 16-byte aligned
// (the wrapper checks).
//
// Bound on an H100 (3.35 TB/s): every byte is read once and written once.
// At the mesh phase's geometry (D = 4, c = 2^15 rows per shard,
// C = pair_capacity(c, 4) = 16384, int64): forward L = 12,
// 2 x 4^2 x 12 x 16384 x 8 B = 50.3 MB, 15.0 us; back L = 4, 16.8 MB,
// 5.0 us. The launch (a few us) is the other floor for the small one.
//
// Plain C interface, loaded with ctypes: the function launches on the
// caller's stream of the caller's device, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define GUBER_RING_MAXD 8

extern "C" {

struct GuberRingArgs {
  const void* send[GUBER_RING_MAXD];  // source s0 + i, (D, L, C) contiguous
  void* recv[GUBER_RING_MAXD];        // destination d0 + j, (D, L, C) contiguous
  long long slab_bytes;               // L * C * element size, a multiple of 16
  int D;                              // shards in the mesh
  int s0;                             // first source shard of this launch
  int ns;                             // source shards of this launch (<= MAXD)
  int d0;                             // first destination shard of this launch
  int nd;                             // destination shards of this launch (<= MAXD)
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // independent 16-byte loads in flight per thread

__global__ void __launch_bounds__(kThreads)
ring_exchange_kernel(const GuberRingArgs args) {
  const int slab = blockIdx.y;  // (s - s0) * nd + (d - d0)
  const int si = slab / args.nd;  // source s0 + si
  const int dj = slab % args.nd;  // destination d0 + dj
  const int s = args.s0 + si;
  const int d = args.d0 + dj;
  const long long n16 = args.slab_bytes / 16;
  const int4* __restrict__ src =
      reinterpret_cast<const int4*>(static_cast<const char*>(args.send[si]) +
                                    (long long)d * args.slab_bytes);
  int4* __restrict__ dst = reinterpret_cast<int4*>(
      static_cast<char*>(args.recv[dj]) + (long long)s * args.slab_bytes);
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n16; i += kUnroll * stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n16; i += stride) dst[i] = src[i];
}

}  // namespace

extern "C" int guber_ring_exchange(int device, const GuberRingArgs* args, int blocks_x,
                                   void* stream) {
  if (args->D < 1 || args->ns < 1 || args->ns > GUBER_RING_MAXD || args->s0 < 0 ||
      args->s0 + args->ns > args->D || args->nd < 1 || args->nd > GUBER_RING_MAXD ||
      args->d0 < 0 || args->d0 + args->nd > args->D || args->slab_bytes % 16 != 0 ||
      blocks_x < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (args->slab_bytes == 0) return 0;
  dim3 grid(blocks_x, args->ns * args->nd);
  ring_exchange_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

// Let `device` store into `peer`'s memory. Returns 0 when access is enabled
// (or already was), cudaErrorPeerAccessUnsupported when the pair cannot.
extern "C" int guber_ring_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // reset the last-error state this call set
    return 0;
  }
  return (int)err;
}
