// probe_walk: one dispatch's whole table walk — bucket-row fetch, claim,
// payload, compose and dirty-row write-back — in one kernel.
//
// Replaces the TPU kernel of the JAX package's fused probe walk,
// gubernator_tpu/ops/pallas_probe.py::_make_probe_kernel (:299), launched by
// _launch_walk (pallas_call at :919), for all three of its stages: decide
// (kernel2.decide_payload), install (install_payload16 rows computed before
// the walk ride the ingress) and merge (kernel2.merge_payload16 against the
// claimed lane). The function is documented in ops/probe_walk.py; this file
// is its Hopper form, held bit for bit against probe_walk_ref.
//
// What bounds it on an H100 (3.35 TB/s): the walk must read each touched
// bucket row once, store each written slot once, read the request columns
// and write the responses. At the headline shape (2^21 buckets x 512 B rows,
// 2^17 uniform rows) that is ~127,100 rows read (65.1 MB), ~131K slots of
// 64 B stored (8.4 MB), 81 B of request columns and 64 B of responses per
// row: 92.5 MB, 27.6 us. The decision math is a few hundred integer and
// float64 operations per row, far below the card's rates.
//
// What the first design lost. It gave one warp to each bucket: at the
// headline shape a bucket holds about one row, so 31 of 32 lanes idled
// through the math and each warp ran a chain of dependent loads (unit start
// -> sort key -> bucket row; sort position -> row index -> request columns)
// for one row: 0.906 ms, 3% of the bound. And it served a written bucket's
// inactive rows inside the writer's warp, before its write-back. The engine
// pads batches with fp 0, all in bucket 0, so one active key in bucket 0 made
// one warp serve every padding row, 32 at a time: 2,048 serial iterations at
// a mesh owner batch of 65,536 rows, 18x the same walk without that key.
//
// This design. The torch prologue (probe_walk.walk_schedule) only sorts the
// rows stably by key = 2*bucket + inactive, so each bucket's active rows come
// first and its inactive rows after them. The kernel cuts the sorted order
// into chunks of 32 positions, one warp per chunk, one lane per position:
//
//  * a lane whose position is an inactive row is a READER: it never ranks,
//    owns or writes; its response depends only on its bucket's
//    pre-dispatch bytes;
//  * a lane whose position is the only active row of its bucket is a
//    SINGLETON writer: rank 0, no duplicate owner, the owner mask its own.
//    It serves its row alone and stores only its written slot (F int32);
//  * a run of two or more active rows of one bucket is served by the
//    warp together, as the first design did (owner mask, ranks and the
//    first-owner rule by warp ballots, 32 rows at a time), after the
//    lane-local rows, by the warp whose chunk holds the run's first row.
//
// Bucket rows arrive by Hopper's bulk asynchronous copy: the first lane of
// each bucket in the chunk issues cp.async.bulk global->shared for its
// 512 B row, completing on one mbarrier per warp, so all of a chunk's rows
// (and the request columns, loaded meanwhile) are in flight at once. Rows
// sit 528 B apart in shared memory, so lanes reading their own rows 16 B at
// a time hit distinct banks. 4 warps per block, 17.4 KB of shared memory
// per warp: three blocks per SM.
//
// Readers before writers, in one launch. A writer must not store its row
// until every reader of that bucket has copied it. Readers sit after their
// writer in sorted order, so:
//  * each warp takes its chunk from a device-side ticket (atomicAdd), in
//    the order warps start, and ticket t serves chunk nchunks-1-t: a
//    bucket's readers get lower tickets than its writer;
//  * a reader lane, once its row has landed, adds itself (warp-aggregated)
//    to the counter of its bucket's inactive run, indexed by the run's
//    first sorted position, but only if the bucket has an active row;
//  * a writer of a bucket with readers finds the end of the inactive run
//    (a warp-cooperative 32-way search of the sorted keys) and spins,
//    before its write-back, until the counter equals the run's length; it
//    then resets the counter to 0.
// A writer waits only on lower tickets, which warps already running hold,
// and a warp adds its readers before any of its writers waits: the launch
// cannot deadlock. Each warp takes its own ticket (finer than a block's,
// and no block-wide barrier inside the work). The ticket, a count of
// finished blocks and the counters live in a scratch buffer the wrapper
// allocates once per device and stream (torch.zeros); the kernel leaves it
// zeroed: each writer resets its counter and the last block to finish
// resets the ticket. A spin that outlasts seconds traps instead of hanging
// the card.
//
// Plain C interface, loaded with ctypes: the arguments arrive as one struct
// (WalkArgs, mirrored by probe_walk._WalkArgs); the function launches on the
// caller's stream, allocates nothing, does not synchronise and returns
// cudaGetLastError() of the launch. Built with --fmad=false (see
// bucket_math.cuh).

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bucket_math.cuh"

// the launch's arguments (mirrored by probe_walk._WalkArgs); at namespace
// scope so that the C entry point below keeps external linkage
struct WalkArgs {
  int32_t* rows;
  long long nb;
  int F;
  int layout;
  const int32_t* perm;   // original row at each sorted position
  const int32_t* key_s;  // 2*bucket + inactive, sorted
  int* sync;             // ticket, finished blocks, B reader counters; zero
  long long B;
  const int64_t* fp;
  const int64_t* now;
  const int32_t* algo;  // decide ingress (null for the walks)
  const int32_t* behavior;
  const int64_t* hits;
  const int64_t* limit;
  const int64_t* burst;
  const int64_t* duration;
  const int64_t* expire_new;
  const int64_t* greg_interval;
  const int64_t* duration_eff;
  const int32_t* pay16;  // (B, 16) canonical install rows / incoming slots
  int64_t* resp;         // (B, outw)
  int outw;
};

namespace {

constexpr int K = 8;                     // slots per bucket
constexpr int kWarps = 4;                // warps (chunks) per block
constexpr int kMaxRow = K * 16;          // int32 lanes of the widest (full) row
constexpr int kStride = kMaxRow + 4;     // shared-memory row pitch (528 B)
constexpr int kWarpSmem = (32 * kStride + kMaxRow) * 4 + 16;  // rows, staged row, mbarrier
constexpr unsigned kFull = 0xffffffffu;

constexpr int kDecide = 0, kInstall = 1, kMerge = 2;
constexpr int kLayoutFull = 0, kLayoutGcra32 = 1, kLayoutToken32 = 2;
constexpr int32_t kDurHiMask = 0x7FFFFF;
constexpr int kStatusShift = 23;

// position of the expiry pair in a packed slot (fp is always fields 0/1)
__device__ __forceinline__ int exp_lo_field(int layout) {
  return layout == kLayoutFull ? gm::EXP_LO : layout == kLayoutGcra32 ? 2 : 4;
}

// ops/layout.py SlotLayout.unpack: packed slot -> canonical 16 fields
__device__ void unpack_slot(int layout, const int32_t* p, int32_t* c) {
  if (layout == kLayoutFull) {
#pragma unroll
    for (int f = 0; f < 16; ++f) c[f] = p[f];
    return;
  }
  const int32_t dur_hi = p[7] & kDurHiMask;
  const int32_t status = (p[7] >> kStatusShift) & 0xFF;
#pragma unroll
  for (int f = 0; f < 16; ++f) c[f] = 0;
  c[gm::FP_LO] = p[0];
  c[gm::FP_HI] = p[1];
  c[gm::DUR_LO] = p[6];
  c[gm::DUR_HI] = dur_hi;
  if (layout == kLayoutGcra32) {
    c[gm::LIMIT] = p[4];
    c[gm::BURST] = p[5];
    c[gm::FLAGS] = gm::flags_of(gm::kAlgoGcra, status);
    c[gm::EXP_LO] = p[2];
    c[gm::EXP_HI] = p[3];
    c[gm::REMF_HI] = p[3];  // the TAT rides the aux pair too
    c[gm::REMF_LO] = p[2];
  } else {
    const int64_t exp = gm::join64(p[4], p[5]);
    const int64_t dur = gm::join64(p[6], dur_hi);
    const int64_t stamp = gm::sub(exp, dur);  // token invariant
    c[gm::LIMIT] = p[3];
    c[gm::REM_I] = p[2];
    c[gm::FLAGS] = gm::flags_of(gm::kAlgoToken, status);
    c[gm::STAMP_LO] = gm::lo32(stamp);
    c[gm::STAMP_HI] = gm::hi32(stamp);
    c[gm::EXP_LO] = p[4];
    c[gm::EXP_HI] = p[5];
  }
}

// ops/layout.py SlotLayout.pack: canonical 16 fields -> packed slot
__device__ void pack_slot(int layout, const int32_t* c, int32_t* p) {
  if (layout == kLayoutFull) {
#pragma unroll
    for (int f = 0; f < 16; ++f) p[f] = c[f];
    return;
  }
  const uint32_t status = (uint32_t)(c[gm::FLAGS] >> 8) & 0xFFu;
  const int32_t meta =
      (int32_t)(((uint32_t)c[gm::DUR_HI] & kDurHiMask) | (status << kStatusShift));
  p[0] = c[gm::FP_LO];
  p[1] = c[gm::FP_HI];
  p[6] = c[gm::DUR_LO];
  p[7] = meta;
  if (layout == kLayoutGcra32) {
    p[2] = c[gm::REMF_LO];
    p[3] = c[gm::REMF_HI];
    p[4] = c[gm::LIMIT];
    p[5] = c[gm::BURST];
  } else {
    p[2] = c[gm::REM_I];
    p[3] = c[gm::LIMIT];
    p[4] = c[gm::EXP_LO];
    p[5] = c[gm::EXP_HI];
  }
}

// ---------------------------------------------------- bulk copy, mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1)
               : "memory");
  // make the initialised barrier visible to the bulk-copy (async) proxy
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// ------------------------------------------------------------ bucket rows

// the claim's view of a bucket row: each slot's fingerprint and expiry
struct Slots {
  int32_t lo[K], hi[K];
  int64_t exp[K];
  bool empty[K];
};

// 16 B reads: lanes reading their own rows 528 B apart hit distinct banks
__device__ __forceinline__ void load_slots(const int32_t* row, int F, int exl, Slots& s) {
  const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int4 h = r4[(k * F) >> 2];
    s.lo[k] = h.x;
    s.hi[k] = h.y;
    const int ei = k * F + exl;  // 0 or 2 mod 4
    const int4 v = r4[ei >> 2];
    s.exp[k] = (ei & 2) ? gm::join64(v.z, v.w) : gm::join64(v.x, v.y);
    s.empty[k] = s.lo[k] == 0 && s.hi[k] == 0;
  }
}

// the first lane holding `fp`, or -1
__device__ __forceinline__ int owner_lane(const Slots& s, int64_t fp) {
  const int32_t lo = gm::lo32(fp), hi = gm::hi32(fp);
  int own = -1;
#pragma unroll
  for (int k = K - 1; k >= 0; --k)
    if (!s.empty[k] && s.lo[k] == lo && s.hi[k] == hi) own = k;
  return own;
}

// one row's inputs, loaded before its bucket row lands
struct RowIn {
  gm::Req r;         // fp and now ride here for every stage
  int32_t in16[16];  // install / merge ingress
};

template <int STAGE>
__device__ __forceinline__ void load_row_in(const WalkArgs& a, int oi, bool valid, RowIn& in) {
  gm::Req& r = in.r;
  r.fp = valid ? a.fp[oi] : 0;
  r.now = valid ? a.now[oi] : 0;
  if (STAGE == kDecide) {
    r.algo = valid ? a.algo[oi] : 0;
    r.behavior = valid ? a.behavior[oi] : 0;
    r.hits = valid ? a.hits[oi] : 0;
    r.limit = valid ? a.limit[oi] : 0;
    r.burst = valid ? a.burst[oi] : 0;
    r.duration = valid ? a.duration[oi] : 0;
    r.expire_new = valid ? a.expire_new[oi] : 0;
    r.greg_interval = valid ? a.greg_interval[oi] : 0;
    r.duration_eff = valid ? a.duration_eff[oi] : 0;
  } else {
    const int4* src = reinterpret_cast<const int4*>(a.pay16 + (long long)oi * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = valid ? src[q] : make_int4(0, 0, 0, 0);
      in.in16[4 * q] = v.x;
      in.in16[4 * q + 1] = v.y;
      in.in16[4 * q + 2] = v.z;
      in.in16[4 * q + 3] = v.w;
    }
  }
}

// One row against its bucket's pre-dispatch bytes, given the claim's inputs
// (own lane, insert rank, the run's owner mask, duplicate-owner drop): the
// chosen lane, the stage's payload packed for that lane, and the row's
// response stored at its original index when `store`. Returns written.
template <int STAGE, int MODE>
__device__ __forceinline__ bool serve_row(const WalkArgs& a, const int32_t* orig,
                                          const Slots& sl, const RowIn& in, bool store,
                                          int oi, bool act, int own, int rank, unsigned om,
                                          bool owner_killed, int* chosen_out,
                                          int32_t* packed) {
  const bool owns = own >= 0;
  const bool need = act && !owns;
  // candidate order of this row's clock: the rank-th lane of (live,
  // expiry, lane index) ascending
  bool live[K];
#pragma unroll
  for (int k = 0; k < K; ++k) live[k] = !(sl.empty[k] || sl.exp[k] < in.r.now);
  const int rc = rank < K - 1 ? rank : K - 1;
  int ins = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    int pos = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool ahead =
          (live[k] < live[j]) ||
          (live[k] == live[j] &&
           (sl.exp[k] < sl.exp[j] || (sl.exp[k] == sl.exp[j] && k < j)));
      pos += ahead;
    }
    if (pos == rc) ins = j;
  }
  const int chosen = owns ? own : ins;
  const bool claim_ok = need && rank < K;
  const bool got = act && (owns || claim_ok);
  const bool killed_ins = claim_ok && ((om >> chosen) & 1u);
  const bool written = got && !killed_ins && !owner_killed;
  const bool evict = claim_ok && live[chosen] && written;

  int32_t p16[16], lane16[16], new16[16];
  const int4* c4 = reinterpret_cast<const int4*>(orig + chosen * a.F);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = q * 4 < a.F ? c4[q] : make_int4(0, 0, 0, 0);
    p16[4 * q] = v.x;
    p16[4 * q + 1] = v.y;
    p16[4 * q + 2] = v.z;
    p16[4 * q + 3] = v.w;
  }
  unpack_slot(a.layout, p16, lane16);
  bool exists = false;
  gm::Decision d;
  if (STAGE == kDecide) {
    gm::decide_payload<MODE>(lane16, in.r, owns, &exists, &d, new16);
  } else if (STAGE == kInstall) {
    exists = owns;
#pragma unroll
    for (int f = 0; f < 16; ++f) new16[f] = in.in16[f];
  } else {
    exists = gm::merge_payload16(in.r.fp, in.in16, lane16, owns, in.r.now, new16);
  }
  pack_slot(a.layout, new16, packed);
  *chosen_out = chosen;

  if (store) {
    int64_t* o = a.resp + (long long)oi * a.outw;
    if (STAGE == kDecide) {
      o[0] = d.resp_status;
      o[1] = d.resp_rem;
      o[2] = d.resp_reset;
      o[6] = d.aux_out;
      o[7] = d.rem_i_out;
    } else {
      o[0] = 0;
      o[1] = 0;
      o[2] = 0;
      o[6] = 0;
      o[7] = 0;
    }
    o[3] = exists;
    o[4] = written;
    o[5] = evict;
    if (a.outw > 8) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        o[8 + q] = evict ? gm::join64(lane16[2 * q], lane16[2 * q + 1]) : 0;
    }
  }
  return written;
}

// ------------------------------------------------------ readers, writers

// The first position in [lo, hi) whose sorted key is >= target, or hi, by
// the whole warp (lo, hi and target warp-uniform): one round over the 32
// positions at the near end, where short runs end, then 32-way rounds.
__device__ long long lower_bound(const int32_t* k, long long lo, long long hi,
                                 int32_t target, int lane, bool near_lo) {
  if (lo >= hi) return hi;
  {
    const long long wlo = near_lo ? lo : (hi - 32 > lo ? hi - 32 : lo);
    const long long whi = near_lo ? (lo + 32 < hi ? lo + 32 : hi) : hi;
    const long long q = wlo + lane;
    const int c = __popc(__ballot_sync(kFull, q < whi && k[q] < target));
    if (near_lo) {
      if (wlo + c < whi) return wlo + c;
      lo = whi;  // every probed key is below
    } else {
      if (c > 0) return wlo + c;
      hi = wlo;  // the answer is at or before wlo
    }
  }
  // the answer lies in [lo, hi]; position hi qualifies
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + lane * step;
    const int c = __popc(__ballot_sync(kFull, q < hi && k[q] < target));
    if (c == 0) return lo;
    const long long nhi = lo + c * step;
    lo = lo + (c - 1) * step + 1;
    hi = nhi < hi ? nhi : hi;
  }
  return lo;
}

// a writer: wait until the `n` readers of its bucket have copied the row,
// then leave the counter zeroed for the next launch
__device__ void wait_readers(int* counter, int n) {
  cuda::atomic_ref<int, cuda::thread_scope_device> c(*counter);
  long long spins = 0;
  while (c.load(cuda::memory_order_acquire) != n) {
    __nanosleep(64);
    if (++spins > (1LL << 25)) __trap();  // a broken schedule: fail, do not hang
  }
  c.store(0, cuda::memory_order_relaxed);
}

// A run of two or more active rows of one bucket, sorted positions
// [s, e), served by the whole warp against the bucket row `orig` (shared
// memory, pre-dispatch bytes): pass 1 ORs the run's owner lanes (the dedup
// authority); pass 2 claims, computes the payloads and composes them into
// `staged` (the later row in batch order lands on a lane two rows chose);
// then, once the bucket's readers have copied the row, the dirtied lanes are
// stored, 16 B per lane.
template <int STAGE, int MODE>
__device__ void serve_run(const WalkArgs& a, long long s, int32_t key, const int32_t* orig,
                          int32_t* staged, int lane, int* counters) {
  const unsigned lt = (1u << lane) - 1u;
  const int F = a.F;
  const int rowl = K * F;
  long long e = s;
  for (long long base = s;; base += 32) {
    const long long p = base + lane;
    const unsigned m = __ballot_sync(kFull, p < a.B && a.key_s[p] == key);
    e = base + __popc(m);
    if (m != kFull) break;
  }
  Slots sl;
  load_slots(orig, F, exp_lo_field(a.layout), sl);

  // pass 1: every lane an owner of this run holds
  unsigned om = 0;
  for (long long base = s; base < e; base += 32) {
    const long long p = base + lane;
    const int own = p < e ? owner_lane(sl, a.fp[a.perm[p]]) : -1;
    om |= __reduce_or_sync(kFull, own >= 0 ? (1u << own) : 0u);
  }

  // pass 2: claim, payload, responses; compose into `staged`
  int need_base = 0;
  int own_seen[K];
#pragma unroll
  for (int k = 0; k < K; ++k) own_seen[k] = 0;
  unsigned dirty = 0;
  for (long long base = s; base < e; base += 32) {
    const long long p = base + lane;
    const bool valid = p < e;
    const int oi = valid ? a.perm[p] : 0;
    RowIn in;
    load_row_in<STAGE>(a, oi, valid, in);
    const int own = valid ? owner_lane(sl, in.r.fp) : -1;
    // a duplicate owner after the first of its run is dropped
    bool owner_killed = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned b = __ballot_sync(kFull, own == k);
      if (own == k) owner_killed = own_seen[k] + __popc(b & lt) > 0;
      own_seen[k] += __popc(b);
    }
    const unsigned nb = __ballot_sync(kFull, valid && own < 0);
    const int rank = valid ? need_base + __popc(nb & lt) : 0;
    need_base += __popc(nb);
    int chosen;
    int32_t packed[16];
    const bool written = serve_row<STAGE, MODE>(a, orig, sl, in, valid, oi, valid, own, rank,
                                                om, owner_killed, &chosen, packed);
    // compose: the chunk's last writer of each lane lands; later chunks
    // overwrite earlier ones
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned w = __ballot_sync(kFull, written && chosen == k);
      if (w) {
        dirty |= 1u << k;
        if (lane == 31 - __clz(w))
          for (int f = 0; f < F; ++f) staged[k * F + f] = packed[f];
      }
    }
    __syncwarp();
  }

  // the bucket's readers (sorted positions [e, end)) copy the row first
  if (e < a.B && a.key_s[e] == key + 1) {
    const long long end = lower_bound(a.key_s, e, a.B, key + 2, lane, true);
    if (lane == 0) wait_readers(counters + e, (int)(end - e));
    __syncwarp();
  }
  int4* row_g = reinterpret_cast<int4*>(a.rows + (long long)(key >> 1) * rowl);
  if (dirty && lane * 4 < rowl && ((dirty >> ((lane * 4) / F)) & 1u))
    row_g[lane] = reinterpret_cast<const int4*>(staged)[lane];
}

// One chunk of 32 sorted positions (see the note at the top).
template <int STAGE, int MODE>
__device__ void serve_chunk(const WalkArgs& a, long long chunk, int32_t* rows_s,
                            int32_t* staged, uint64_t* bar, int lane, int* counters) {
  const long long B = a.B;
  const int F = a.F;
  const int rowl = K * F;
  const long long cs = chunk * 32;
  const long long p = cs + lane;
  const bool valid = p < B;
  const int32_t key = valid ? a.key_s[p] : -2;
  int32_t kprev = __shfl_up_sync(kFull, key, 1);
  int32_t knext = __shfl_down_sync(kFull, key, 1);
  if (lane == 0) kprev = p > 0 ? a.key_s[p - 1] : -2;
  if (lane == 31) knext = p + 1 < B ? a.key_s[p + 1] : -2;
  const bool edge = key != kprev;  // a run starts here (or the batch ends)
  const bool reader = valid && (key & 1);
  const bool single = valid && !reader && edge && knext != key;
  const bool mstart = valid && !reader && edge && knext == key;
  const bool serve = reader || single;
  const long long bucket = key >> 1;
  const unsigned upto = (2u << lane) - 1u;  // lanes 0 .. lane

  // one bulk copy per bucket in the chunk, by its first lane; all in flight
  const bool bstart = valid && (lane == 0 || (kprev >> 1) != bucket);
  const int row_lane = 31 - __clz(__ballot_sync(kFull, bstart) & upto);
  const unsigned copy = __reduce_or_sync(kFull, serve || mstart ? 1u << row_lane : 0u);
  if (lane == 0) {
    mbar_init(bar);
    mbar_expect_tx(bar, (uint32_t)(__popc(copy) * rowl * 4));
  }
  __syncwarp();
  if ((copy >> lane) & 1u)
    bulk_g2s(rows_s + lane * kStride, a.rows + bucket * rowl, (uint32_t)(rowl * 4), bar);
  const int oi = serve ? a.perm[p] : 0;
  RowIn in;
  load_row_in<STAGE>(a, oi, serve, in);

  // a reader's inactive run: its first position r, and whether the bucket
  // has a writer (the key before the run is the bucket's active key)
  const unsigned edges = __ballot_sync(kFull, edge);
  const unsigned mine = edges & upto;
  long long r0 = cs;
  bool writer0 = false;
  if (__shfl_sync(kFull, (int)(reader && !edge), 0)) {  // lane 0's run began earlier
    const int32_t k0 = __shfl_sync(kFull, key, 0);
    r0 = lower_bound(a.key_s, 0, cs, k0, lane, false);
    const int32_t before = lane == 0 && r0 > 0 ? a.key_s[r0 - 1] : -2;
    writer0 = __shfl_sync(kFull, before, 0) == k0 - 1;
  }
  const int q = mine ? 31 - __clz(mine) : 0;
  const int32_t kq = __shfl_sync(kFull, kprev, q);
  const long long r = mine ? cs + q : r0;
  const bool counted = reader && (mine ? kq == key - 1 : writer0);

  // a singleton's readers: sorted positions [p + 1, end)
  const bool waits = single && knext == key + 1;
  const unsigned later = lane < 30 ? edges & ~((2u << (lane + 1)) - 1u) : 0u;
  long long tail = B;
  const unsigned spill = __ballot_sync(kFull, waits && !later);
  if (spill) {  // the readers run past the chunk
    const int32_t kw = __shfl_sync(kFull, key, __ffs(spill) - 1);
    tail = lower_bound(a.key_s, cs + 32 < B ? cs + 32 : B, B, kw + 2, lane, true);
  }
  const long long end = later ? cs + __ffs(later) - 1 : tail;

  mbar_wait(bar, 0);
  __syncwarp();
  // readers: the row has landed; count them in, one atomic per run
  const unsigned grp = __match_any_sync(kFull, counted ? (int)r : -1);
  if (counted && lane == __ffs(grp) - 1) {
    cuda::atomic_ref<int, cuda::thread_scope_device> c(counters[r]);
    c.fetch_add(__popc(grp), cuda::memory_order_release);
  }

  // the lane-local rows: readers and singletons
  const int32_t* row_s = rows_s + row_lane * kStride;
  if (serve) {
    Slots sl;
    load_slots(row_s, F, exp_lo_field(a.layout), sl);
    const int own = single ? owner_lane(sl, in.r.fp) : -1;
    int chosen;
    int32_t packed[16];
    const bool written = serve_row<STAGE, MODE>(a, row_s, sl, in, true, oi, single, own, 0,
                                                own >= 0 ? 1u << own : 0u, false, &chosen,
                                                packed);
    if (waits) wait_readers(counters + p + 1, (int)(end - p - 1));
    if (single && written) {
      int4* dst = reinterpret_cast<int4*>(a.rows + bucket * rowl + chosen * F);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (v * 4 < F)
          dst[v] = make_int4(packed[4 * v], packed[4 * v + 1], packed[4 * v + 2],
                             packed[4 * v + 3]);
    }
  }
  __syncwarp();

  // the runs of two or more active rows that start in this chunk
  unsigned runs = __ballot_sync(kFull, mstart);
  while (runs) {
    const int s = __ffs(runs) - 1;
    runs &= runs - 1;
    serve_run<STAGE, MODE>(a, cs + s, __shfl_sync(kFull, key, s), rows_s + s * kStride,
                           staged, lane, counters);
  }
}

template <int STAGE, int MODE>
__global__ void __launch_bounds__(kWarps * 32) probe_walk_kernel(const WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* rows_s = reinterpret_cast<int32_t*>(smem + warp * kWarpSmem);
  int32_t* staged = rows_s + 32 * kStride;
  uint64_t* bar = reinterpret_cast<uint64_t*>(staged + kMaxRow);
  const long long nchunks = (a.B + 31) / 32;
  int t = 0;
  if (lane == 0) t = atomicAdd(a.sync, 1);
  t = __shfl_sync(kFull, t, 0);
  if (t < nchunks) serve_chunk<STAGE, MODE>(a, nchunks - 1 - t, rows_s, staged, bar, lane,
                                            a.sync + 2);
  // the last block to finish leaves the ticket zeroed for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(a.sync + 1, 1) == (int)gridDim.x - 1) {
      a.sync[0] = 0;
      a.sync[1] = 0;
    }
  }
}

template <int STAGE, int MODE>
cudaError_t launch(const WalkArgs& a, cudaStream_t stream) {
  constexpr int kSmem = kWarps * kWarpSmem;
  static unsigned sized = 0;  // per device: above 48 KB, shared memory is opt-in
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !((sized >> dev) & 1u)) {
    err = cudaFuncSetAttribute(probe_walk_kernel<STAGE, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 32) sized |= 1u << dev;
  }
  const long long chunks = (a.B + 31) / 32;
  const long long blocks = (chunks + kWarps - 1) / kWarps;
  probe_walk_kernel<STAGE, MODE><<<(unsigned int)blocks, kWarps * 32, kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int guber_probe_walk(int stage, int mode, const WalkArgs* args,
                                void* stream) {
  const WalkArgs a = *args;
  if (a.B <= 0) return (int)cudaSuccess;
  if (a.F * K > kMaxRow || (a.F * K) % 4 != 0 || a.F % 4 != 0 ||
      ((uintptr_t)a.rows & 15) != 0 || a.B >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (stage == kDecide) {
    switch (mode) {
      case gm::kToken: return (int)launch<kDecide, gm::kToken>(a, st);
      case gm::kGcra: return (int)launch<kDecide, gm::kGcra>(a, st);
      case gm::kInt: return (int)launch<kDecide, gm::kInt>(a, st);
      case gm::kMixed: return (int)launch<kDecide, gm::kMixed>(a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (stage == kInstall) return (int)launch<kInstall, gm::kMixed>(a, st);
  if (stage == kMerge) return (int)launch<kMerge, gm::kMixed>(a, st);
  return (int)cudaErrorInvalidValue;
}
