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
// locally. On Hopper the blocks of one grid run every hop at once: there
// are no semaphores and no waits. It is a push design: the blocks of source
// s store into the owner's receive buffer through the owner's device
// pointer. One launch serves every source shard that lives on one card,
// against all D destinations, for any mesh the struct holds.
//
// Addresses travel by value in the kernel's parameter block, no pointer
// table on the device and no copy per call: send[i] and the shard index
// src[i] of the launch's i-th source, recv[d] of every destination. Since
// CUDA 12.1 a kernel's parameters may take 32,764 bytes on Hopper. The wide
// struct holds kWideD = 1024 shards (2 x 8 KB of pointers and 2 KB of shard
// indices, 18.5 KB); 2048 would need 36 KB. That is enough: one process
// drives the cards of one host (at most 8, each store a peer store over
// NVLink), so a wider mesh is simulated shards sharing cards, and 1024
// shards on 8 cards is already 128 tables per card. The C entry raises
// (cudaErrorInvalidValue) above it, and so does the wrapper. Meshes of
// at most kSmallD = 16 shards take a small struct (0.3 KB) of the same
// layout: the 18 KB block measured slower at D = 4 on the card.
//
// Work split: the launch's ns * D slabs are cut into chunks of chunk16
// 16-byte pieces (the last chunk of a slab ragged), and (slab, chunk) is
// flattened into one unit index, slab-major. The chunk is sized by the
// launch's total bytes: about one unit per block of a grid of 8 blocks of
// 256 threads per SM, rounded up to 256 pieces (one per thread), at least
// 256 and at most 4096 (64 KB). A persistent grid of at most 8 blocks per
// SM walks the units; a block copies its unit with every thread issuing up
// to 8 independent 16-byte loads before their stores, the tail predicated,
// so a thread never falls back to one dependent load-store pair at a time.
// At 46 registers a thread (ptxas), 5 blocks are resident per SM, so a
// launch of one unit per block runs in about one and a half waves; a split
// into equal spans that fit one wave of resident blocks was tried and was
// no faster. parallel/ring.exchange_chunks is the host model of this split
// and keeps the same constants.
//
// Across cards the same code stores through peer pointers in CUDA's
// unified address space; the wrapper enables peer access once
// (guber_ring_enable_peer) and orders every receiving card's stream after
// every source's launch with events. On one card, stream order is the only
// ordering needed. Slabs and buffers are 16-byte aligned (the wrapper
// checks).
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

namespace {

constexpr int kSmallD = 16;    // shards of the small parameter block
constexpr int kWideD = 1024;   // shards of the wide one (18.5 KB)
constexpr int kThreads = 256;  // threads per block
constexpr int kUnroll = 8;     // independent 16-byte loads in flight per thread
constexpr int kBlocksPerSm = 8;
constexpr long long kMinChunk16 = kThreads;  // one piece per thread
constexpr long long kMaxChunk16 = 4096;      // 64 KB per unit

template <int MAXD>
struct RingArgs {
  const void* send[MAXD];     // the launch's source i, (D, L, C) contiguous
  void* recv[MAXD];           // destination d, (D, L, C) contiguous
  long long slab16;           // 16-byte pieces per slab
  long long chunk16;          // pieces per unit (the last of a slab ragged)
  long long chunks;           // units per slab
  long long units;            // ns * D * chunks
  int D;                      // shards in the mesh
  unsigned short src[MAXD];   // shard index of the launch's source i
};

static_assert(sizeof(RingArgs<kWideD>) <= 32764, "kernel parameters are capped at 32,764 B");

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
ring_exchange_kernel(const __grid_constant__ RingArgs<MAXD> args) {
  for (long long u = blockIdx.x; u < args.units; u += gridDim.x) {
    const long long slab = u / args.chunks;  // i * D + d
    const long long lo = (u - slab * args.chunks) * args.chunk16;
    const long long hi = min(lo + args.chunk16, args.slab16);
    const int i = (int)(slab / args.D);
    const int d = (int)(slab - (long long)i * args.D);
    const int4* __restrict__ src =
        static_cast<const int4*>(args.send[i]) + (long long)d * args.slab16;
    int4* __restrict__ dst =
        static_cast<int4*>(args.recv[d]) + (long long)args.src[i] * args.slab16;
    for (long long p = lo + threadIdx.x; p < hi; p += kUnroll * kThreads) {
      int4 v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (p + k * kThreads < hi) v[k] = src[p + k * kThreads];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (p + k * kThreads < hi) dst[p + k * kThreads] = v[k];
    }
  }
}

template <int MAXD>
int launch(const void* const* send, const int* src, int ns, void* const* recv, int D,
           long long slab16, int sms, cudaStream_t stream) {
  RingArgs<MAXD> args;
  for (int i = 0; i < ns; ++i) {
    args.send[i] = send[i];
    args.src[i] = (unsigned short)src[i];
  }
  for (int d = 0; d < D; ++d) args.recv[d] = recv[d];
  const long long slabs = (long long)ns * D;
  const long long wave = (long long)sms * kBlocksPerSm;
  long long chunk = (slabs * slab16 + wave - 1) / wave;
  chunk = (chunk + kThreads - 1) / kThreads * kThreads;
  chunk = chunk < kMinChunk16 ? kMinChunk16 : (chunk > kMaxChunk16 ? kMaxChunk16 : chunk);
  args.slab16 = slab16;
  args.chunk16 = chunk;
  args.chunks = (slab16 + chunk - 1) / chunk;
  args.units = slabs * args.chunks;
  args.D = D;
  const long long grid = args.units < wave ? args.units : wave;
  ring_exchange_kernel<MAXD><<<(unsigned int)grid, kThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: sources send[0..ns) (shards src[0..ns) of the mesh, all on
// `device`) into every destination recv[0..D). Returns a cudaError_t.
extern "C" int guber_ring_exchange(int device, const void* const* send, const int* src,
                                   int ns, void* const* recv, int D, long long slab_bytes,
                                   void* stream) {
  if (D < 1 || D > kWideD || ns < 1 || ns > D || slab_bytes < 0 || slab_bytes % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < ns; ++i) {
    if (src[i] < 0 || src[i] >= D) return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (slab_bytes == 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= kSmallD) return launch<kSmallD>(send, src, ns, recv, D, slab_bytes / 16, sms, s);
  return launch<kWideD>(send, src, ns, recv, D, slab_bytes / 16, sms, s);
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
