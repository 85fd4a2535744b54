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
// The TPU kernel walks bucket-sorted blocks of requests through VMEM: it
// double-buffers row fetches, defers write-back waits and carries bucket
// runs that straddle blocks in scratch. Those are grid and VMEM artifacts.
// Here the torch prologue (probe_walk.walk_schedule) sorts rows stably by
// (real bucket, inactive) and cuts the sorted order into units, and ONE WARP
// OWNS ONE UNIT:
//
//  * a bucket with an active row is one unit: its active rows in batch
//    order, then its inactive rows. The warp loads the bucket row once
//    (512 B on the full layout, 16 B per lane) into shared memory, serves
//    every row of the unit 32 at a time against those pre-dispatch bytes,
//    and only then stores the lanes that rows wrote. No other warp touches
//    the bucket, so no row can read a byte another row wrote, and no carry
//    is needed;
//  * a bucket with no active row is never written; its rows (engine padding
//    is fp 0, all in bucket 0) are cut into read-only units of 32 rows, so a
//    large padding group spreads over many warps.
//
// Per unit, pass 1 ORs the owner lanes of the whole run (the dedup
// authority: an inserter whose lane any owner holds is dropped); pass 2
// computes per row, with warp ballots for the running state: owner match,
// first-owner-wins for duplicate fingerprints, the insert rank (a warp
// prefix sum with a running base), the row's candidate lane order (vacant
// first, then live by soonest expiry, then lane index; exact 64-bit compare
// of the lazy expiry against the row's own clock), rank >= K dropped, the
// stage's payload on the chosen lane, and the (B, 8) int64 response row,
// stored straight at the row's original index (the un-sort of
// pallas_probe.py:970 folds into the kernel). Compose: owners never collide
// (a duplicate owner is dropped) and an inserter on an owner's lane is
// dropped, so only two inserters whose clocks order the lanes differently
// can choose one lane; the later row in batch order lands, as the JAX
// package's CPU scatter lands it.
//
// Bound on an H100 (3.35 TB/s): the walk must read each touched bucket row
// once, store each written slot once, read the request columns and write
// the responses. At the headline shape (2^21 buckets x 512 B rows, 2^17
// uniform rows) that is ~127,100 rows read (65.1 MB), ~131K slots of 64 B
// stored (8.4 MB), 81 B of request columns and 64 B of responses per row:
// about 92 MB, ~28 us. This first design is latency-bound instead: at that
// shape a warp serves about one row, through chains of dependent loads
// (unit -> sort key -> bucket row; sort position -> row index -> request
// columns), with 31 of 32 lanes idle through the decision math.
//
// Plain C interface, loaded with ctypes: the arguments arrive as one struct
// (WalkArgs, mirrored by probe_walk._WalkArgs); the function launches on the
// caller's stream, allocates nothing, does not synchronise and returns
// cudaGetLastError() of the launch. Built with --fmad=false (see
// bucket_math.cuh).

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
  const int32_t* perm;    // original row at each sorted position
  const int32_t* key_s;   // 2*bucket + inactive, sorted
  const int32_t* ustart;  // first sorted position of each unit (B+2)
  long long B;
  const int64_t* fp;
  const int64_t* now;
  const bool* active;
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

constexpr int K = 8;             // slots per bucket
constexpr int kWarps = 8;        // warps (units) per block
constexpr int kMaxRow = K * 16;  // int32 lanes of the widest (full) row
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

template <int STAGE, int MODE>
__global__ void __launch_bounds__(kWarps * 32)
    probe_walk_kernel(const WalkArgs a) {
  __shared__ __align__(16) int32_t s_orig[kWarps][kMaxRow];
  __shared__ __align__(16) int32_t s_new[kWarps][kMaxRow];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const long long u = (long long)blockIdx.x * kWarps + warp;
  if (u >= a.B) return;
  const int s = a.ustart[u];
  if (s >= a.B) return;  // past the last unit
  const int e = a.ustart[u + 1];
  const int F = a.F;
  const int rowl = K * F;
  const long long bucket = a.key_s[s] >> 1;
  int32_t* orig = s_orig[warp];
  int32_t* staged = s_new[warp];

  // the bucket row, once, as 16 B per lane
  int4* row_g = reinterpret_cast<int4*>(a.rows + bucket * rowl);
  if (lane * 4 < rowl) reinterpret_cast<int4*>(orig)[lane] = row_g[lane];
  __syncwarp();

  const int exl = exp_lo_field(a.layout);
  int32_t slot_lo[K], slot_hi[K];
  int64_t slot_exp[K];
  bool slot_empty[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    slot_lo[k] = orig[k * F + gm::FP_LO];
    slot_hi[k] = orig[k * F + gm::FP_HI];
    slot_exp[k] = gm::join64(orig[k * F + exl], orig[k * F + exl + 1]);
    slot_empty[k] = slot_lo[k] == 0 && slot_hi[k] == 0;
  }
  auto owner_lane = [&](int64_t fp) {
    const int32_t lo = gm::lo32(fp), hi = gm::hi32(fp);
    int own = -1;
#pragma unroll
    for (int k = K - 1; k >= 0; --k)
      if (!slot_empty[k] && slot_lo[k] == lo && slot_hi[k] == hi) own = k;
    return own;
  };

  // pass 1: every lane an owner of this run holds; active rows come first
  unsigned om = 0;
  if ((a.key_s[s] & 1) == 0) {
    for (int base = s; base < e; base += 32) {
      const int p = base + lane;
      bool act = false;
      int own = -1;
      if (p < e) {
        const int oi = a.perm[p];
        act = a.active[oi];
        if (act) own = owner_lane(a.fp[oi]);
      }
      om |= __reduce_or_sync(kFull, own >= 0 ? (1u << own) : 0u);
      if (__any_sync(kFull, p < e && !act)) break;
    }
  }

  // pass 2: claim, payload, responses; compose into `staged`
  int need_base = 0;
  int own_seen[K];
#pragma unroll
  for (int k = 0; k < K; ++k) own_seen[k] = 0;
  unsigned dirty = 0;
  for (int base = s; base < e; base += 32) {
    const int p = base + lane;
    const bool valid = p < e;
    const int oi = valid ? a.perm[p] : 0;
    const bool act = valid && a.active[oi];
    const int64_t fp = valid ? a.fp[oi] : 0;
    const int64_t now = valid ? a.now[oi] : 0;

    const int own = act ? owner_lane(fp) : -1;
    const bool owns = own >= 0;
    // a duplicate owner after the first of its run is dropped
    bool owner_killed = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned b = __ballot_sync(kFull, own == k);
      if (own == k) owner_killed = own_seen[k] + __popc(b & lt) > 0;
      own_seen[k] += __popc(b);
    }
    const bool need = act && !owns;
    const unsigned nb = __ballot_sync(kFull, need);
    const int rank = act ? need_base + __popc(nb & lt) : 0;
    need_base += __popc(nb);

    // candidate order of this row's clock: the rank-th lane of (live,
    // expiry, lane index) ascending
    bool live[K];
#pragma unroll
    for (int k = 0; k < K; ++k) live[k] = !(slot_empty[k] || slot_exp[k] < now);
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
             (slot_exp[k] < slot_exp[j] || (slot_exp[k] == slot_exp[j] && k < j)));
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

    int32_t lane16[16], new16[16], packed[16];
    unpack_slot(a.layout, orig + chosen * F, lane16);
    bool exists = false;
    gm::Decision d;
    if (STAGE == kDecide) {
      gm::Req r;
      r.fp = fp;
      r.now = now;
      r.algo = valid ? a.algo[oi] : 0;
      r.behavior = valid ? a.behavior[oi] : 0;
      r.hits = valid ? a.hits[oi] : 0;
      r.limit = valid ? a.limit[oi] : 0;
      r.burst = valid ? a.burst[oi] : 0;
      r.duration = valid ? a.duration[oi] : 0;
      r.expire_new = valid ? a.expire_new[oi] : 0;
      r.greg_interval = valid ? a.greg_interval[oi] : 0;
      r.duration_eff = valid ? a.duration_eff[oi] : 0;
      gm::decide_payload<MODE>(lane16, r, owns, &exists, &d, new16);
    } else {
      int32_t in16[16];
      const int4* src = reinterpret_cast<const int4*>(a.pay16 + (long long)oi * 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = valid ? src[q] : make_int4(0, 0, 0, 0);
        in16[4 * q] = v.x;
        in16[4 * q + 1] = v.y;
        in16[4 * q + 2] = v.z;
        in16[4 * q + 3] = v.w;
      }
      if (STAGE == kInstall) {
        exists = owns;
#pragma unroll
        for (int f = 0; f < 16; ++f) new16[f] = in16[f];
      } else {
        exists = gm::merge_payload16(fp, in16, lane16, owns, now, new16);
      }
    }
    pack_slot(a.layout, new16, packed);

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

    if (valid) {
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
  }

  // write back the dirtied lanes of the row, 16 B per lane
  if (dirty && lane * 4 < rowl && ((dirty >> ((lane * 4) / F)) & 1u))
    row_g[lane] = reinterpret_cast<const int4*>(staged)[lane];
}

template <int STAGE, int MODE>
cudaError_t launch(const WalkArgs& a, cudaStream_t stream) {
  const long long blocks = (a.B + kWarps - 1) / kWarps;
  probe_walk_kernel<STAGE, MODE><<<(unsigned int)blocks, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int guber_probe_walk(int stage, int mode, const WalkArgs* args,
                                void* stream) {
  const WalkArgs a = *args;
  if (a.B <= 0) return (int)cudaSuccess;
  if (a.F * K > kMaxRow || (a.F * K) % 4 != 0) return (int)cudaErrorInvalidValue;
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
