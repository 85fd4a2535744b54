// bucket_math.cuh: the per-row decision math of the rate limiter, as device
// code for the fused probe walk (probe_walk.cu).
//
// One function per stage of gubernator_tpu_torch/ops/math.py and
// ops/kernel2.py, row for row: bucket_math (five algorithms, four math
// modes), decide_payload (the stored lane in, the write payload out) and
// merge_payload16 (the conservative merge). Every line mirrors the tensor
// code, so the kernel and the plain PyTorch version agree bit for bit:
//
//  * int64 arithmetic wraps as XLA's does: add, sub and mul go through
//    uint64 (signed overflow is undefined in C++);
//  * // and % on int64 floor (every divisor here is >= 1);
//  * float64 -> int64 saturates as XLA's conversion does (NaN -> 0,
//    beyond +-2^63 -> the int64 limits), f64_to_i64 in ops/math.py;
//  * int64 -> int32 stores either clip (sat32) or wrap (lo32/hi32);
//  * float64 arithmetic is IEEE round-to-nearest with no contraction: the
//    file that includes this one builds with --fmad=false.
//
// Every branch of a where-chain is computed, then selected, as in the
// tensor code; none can trap.

#pragma once

#include <stdint.h>

namespace gm {

// math modes (ops/math.py bucket_math `mode`)
constexpr int kToken = 0, kGcra = 1, kInt = 2, kMixed = 3;
// algorithms, statuses and behavior bits (types.py)
constexpr int32_t kAlgoToken = 0, kAlgoLeaky = 1, kAlgoGcra = 2,
                  kAlgoWindow = 3, kAlgoLease = 4;
constexpr int32_t kUnder = 0, kOver = 1;
constexpr int32_t kGregorian = 4, kResetRemaining = 8, kDrainOverLimit = 32;
// canonical slot fields (ops/table2.py)
constexpr int FP_LO = 0, FP_HI = 1, LIMIT = 2, BURST = 3, REM_I = 4,
              FLAGS = 5, DUR_LO = 6, DUR_HI = 7, STAMP_LO = 8, STAMP_HI = 9,
              EXP_LO = 10, EXP_HI = 11, REMF_HI = 12, REMF_LO = 13;

__device__ __forceinline__ int64_t add(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t sub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int64_t mul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
// floor division and modulo for b >= 1
__device__ __forceinline__ int64_t fdiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int64_t fmod_(int64_t a, int64_t b) {
  int64_t r = a % b;
  return (r != 0 && r < 0) ? r + b : r;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
// jnp.clip(x, lo, hi) = min(max(x, lo), hi)
__device__ __forceinline__ int64_t clip(int64_t x, int64_t lo, int64_t hi) {
  return min64(max64(x, lo), hi);
}
__device__ __forceinline__ int64_t max1(int64_t x) { return x < 1 ? 1 : x; }
// algo | status << 8 of the flags word, shifted as int32 tensors wrap
__device__ __forceinline__ int32_t flags_of(int32_t algo, int32_t status) {
  return algo | (int32_t)((uint32_t)status << 8);
}

__device__ __forceinline__ int64_t f64_to_i64(double x) {
  const double two63 = 9.223372036854775808e18;
  if (x > -two63 && x < two63) return (int64_t)x;
  if (x >= two63) return INT64_MAX;
  if (x <= -two63) return INT64_MIN;
  return 0;  // NaN
}
__device__ __forceinline__ int32_t lo32(int64_t x) { return (int32_t)(uint32_t)(uint64_t)x; }
__device__ __forceinline__ int32_t hi32(int64_t x) { return (int32_t)(x >> 32); }
__device__ __forceinline__ int64_t join64(int32_t lo, int32_t hi) {
  return (int64_t)(((uint64_t)(uint32_t)hi << 32) | (uint64_t)(uint32_t)lo);
}
__device__ __forceinline__ int32_t sat32(int64_t x) {
  return (int32_t)clip(x, INT32_MIN, INT32_MAX);
}
// the leaky remainder: two f32 bit patterns summed in float64. A NaN high
// half is the sum, quieted, as the plain version (kernel2._f32pair_to_f64)
// and XLA take it; the hardware's add of two NaNs may return either
__device__ __forceinline__ double f32pair(int32_t hi_bits, int32_t lo_bits) {
  const double hi = (double)__int_as_float(hi_bits);
  return __dadd_rn(hi, isnan(hi) ? hi : (double)__int_as_float(lo_bits));
}

struct Req {
  int64_t fp;
  int32_t algo, behavior;
  int64_t hits, limit, burst, duration, now, expire_new, greg_interval,
      duration_eff;
};

struct Stored {
  int64_t limit, burst, rem_i;
  int32_t algo, status;
  int64_t duration, stamp, exp;
  double rem_f;
  int64_t aux;
};

struct Decision {
  int32_t status_out;
  int64_t rem_i_out;
  double rem_f_out;
  int64_t stamp_out, dur_out, exp_out, burst_out;
  int32_t flags_out;
  bool remove;
  int64_t aux_out;
  int32_t resp_status;
  int64_t resp_rem, resp_reset;
};

// ops/math.py _bucket_math_impl, one row
template <int MODE>
__device__ Decision bucket_math(const Stored& s, const Req& r, bool exists) {
  const int64_t now = r.now, h = r.hits;
  const bool is_greg = (r.behavior & kGregorian) != 0;
  const bool is_reset = (r.behavior & kResetRemaining) != 0;
  const bool is_drain = (r.behavior & kDrainOverLimit) != 0;
  const bool is_token = r.algo == kAlgoToken;
  const bool algo_match = exists && (s.algo == r.algo);
  const bool neg_miss = (h < 0) && !algo_match && (r.algo >= 2);
  Decision d;

  // ---------------------------------------------------------------- GCRA
  const int64_t g_T = max64(fdiv(r.duration, max1(r.limit)), 1);
  const int64_t g_tau = mul(g_T, r.burst);
  const int64_t g_tat0 = max64(algo_match ? s.aux : now, now);
  const int64_t g_tat1 = max64(add(g_tat0, mul(h, g_T)), now);
  const bool g_deny = (h > 0) && (sub(g_tat1, g_tau) > now);
  const int64_t g_tat_out =
      g_deny ? (is_drain ? add(now, g_tau) : g_tat0) : g_tat1;
  const int64_t g_rem = clip(fdiv(sub(add(now, g_tau), g_tat_out), g_T), 0, r.burst);
  int64_t g_reset = add(sub(g_tat_out, g_tau), mul(g_T, r.limit));
  g_reset = (g_deny && !is_drain) ? sub(g_tat1, g_tau) : g_reset;
  const int32_t g_status = g_deny ? kOver : kUnder;
  const bool g_rm = (exists && is_reset) || neg_miss;
  const int64_t g_exp = max64(g_tat_out, now);
  const int32_t g_resp_status = g_rm ? kUnder : g_status;
  const int64_t g_resp_rem = g_rm ? r.burst : g_rem;
  const int64_t g_resp_reset = g_rm ? 0 : g_reset;

  if (MODE == kGcra) {
    d.status_out = g_status;
    d.rem_i_out = 0;
    d.rem_f_out = 0.0;
    d.stamp_out = now;
    d.dur_out = r.duration;
    d.exp_out = g_exp;
    d.burst_out = r.burst;
    d.flags_out = flags_of(r.algo, g_status);
    d.remove = g_rm;
    d.aux_out = g_tat_out;
    d.resp_status = g_resp_status;
    d.resp_rem = g_resp_rem;
    d.resp_reset = g_resp_reset;
    return d;
  }

  // -------------------------------------------------------- token bucket
  int64_t t_rem = (s.limit != r.limit)
                      ? max64(sub(add(s.rem_i, r.limit), s.limit), 0)
                      : s.rem_i;
  const bool dur_changed = s.duration != r.duration;
  int64_t expire_dc = is_greg ? r.expire_new : add(s.stamp, r.duration);
  const bool renew = dur_changed && (expire_dc <= now);
  expire_dc = renew ? add(now, r.duration) : expire_dc;
  const int64_t t_created = renew ? now : s.stamp;
  t_rem = renew ? r.limit : t_rem;
  const int64_t t_exp = dur_changed ? expire_dc : s.exp;
  const int64_t t_reset = t_exp;

  const bool zero_hits = h == 0;
  const bool at_limit = (t_rem == 0) && (h > 0);
  const bool exact = !zero_hits && !at_limit && (t_rem == h);
  const bool overask = !zero_hits && !at_limit && !exact && (h > t_rem);
  const bool consume = !zero_hits && !at_limit && !exact && !overask;

  const int64_t tok_rem_out =
      (exact || (overask && is_drain)) ? 0 : (consume ? sub(t_rem, h) : t_rem);
  int32_t tok_resp_status = (at_limit || overask) ? kOver : s.status;
  const int32_t tok_stored_status = at_limit ? kOver : s.status;
  int64_t tok_resp_rem = tok_rem_out;
  int64_t tok_resp_reset = t_reset;

  const bool new_over = h > r.limit;
  const int64_t tokn_rem = new_over ? r.limit : sub(r.limit, h);
  const int32_t tokn_status = new_over ? kOver : kUnder;
  const int64_t tokn_exp = r.expire_new;

  const bool tok_is_new = !algo_match;
  const int32_t tok_status_out = tok_is_new ? kUnder : tok_stored_status;
  const int64_t tok_rem_store = tok_is_new ? tokn_rem : tok_rem_out;
  const int64_t tok_created_out = tok_is_new ? now : t_created;
  const int64_t tok_exp_out = tok_is_new ? tokn_exp : t_exp;
  tok_resp_status = tok_is_new ? tokn_status : tok_resp_status;
  tok_resp_rem = tok_is_new ? tokn_rem : tok_resp_rem;
  tok_resp_reset = tok_is_new ? tokn_exp : tok_resp_reset;

  const bool tok_reset_rm = exists && is_reset;
  tok_resp_status = tok_reset_rm ? kUnder : tok_resp_status;
  tok_resp_rem = tok_reset_rm ? r.limit : tok_resp_rem;
  tok_resp_reset = tok_reset_rm ? 0 : tok_resp_reset;

  if (MODE == kToken) {
    d.status_out = tok_status_out;
    d.rem_i_out = tok_rem_store;
    d.rem_f_out = 0.0;
    d.stamp_out = tok_created_out;
    d.dur_out = r.duration;
    d.exp_out = tok_exp_out;
    d.burst_out = 0;
    d.flags_out = flags_of(r.algo, tok_status_out);
    d.remove = tok_reset_rm;
    d.aux_out = 0;
    d.resp_status = tok_resp_status;
    d.resp_rem = tok_resp_rem;
    d.resp_reset = tok_resp_reset;
    return d;
  }

  // ------------------------------------------------------ sliding window
  const int64_t w_dur = max1(r.duration_eff);
  const int64_t w_ws = sub(now, fmod_(now, w_dur));
  const int64_t w_elapsed = sub(now, w_ws);
  const bool w_same = algo_match && (s.stamp == w_ws);
  const bool w_roll1 = algo_match && (s.stamp == sub(w_ws, w_dur));
  const int64_t w_cur_s = sub(s.limit, s.rem_i);
  const int64_t w_prev = w_same ? s.aux : (w_roll1 ? w_cur_s : 0);
  const int64_t w_cur = w_same ? w_cur_s : 0;
  const int64_t w_used = add(w_cur, fdiv(mul(w_prev, sub(w_dur, w_elapsed)), w_dur));
  const bool w_deny = (h > 0) && (add(w_used, h) > r.limit);
  const int64_t w_take = (w_deny && !is_drain) ? 0 : h;
  const int64_t w_cur_out = max64(add(w_cur, w_take), 0);
  const int64_t w_rem = clip(sub(r.limit, add(w_used, w_take)), 0, r.limit);
  const int64_t w_reset = add(w_ws, w_dur);
  const int32_t w_status = w_deny ? kOver : kUnder;
  const bool w_reset_rm = (exists && is_reset) || neg_miss;
  const int32_t w_resp_status = w_reset_rm ? kUnder : w_status;
  const int64_t w_resp_rem = w_reset_rm ? r.limit : w_rem;
  const int64_t w_resp_reset = w_reset_rm ? 0 : w_reset;

  // --------------------------------------------------- concurrency lease
  const int64_t l_inflight_s = algo_match ? sub(s.limit, s.rem_i) : 0;
  const bool l_deny = (h > 0) && (add(l_inflight_s, h) > r.limit);
  const int64_t l_take = (l_deny && !is_drain) ? 0 : h;
  const int64_t l_inflight = max64(add(l_inflight_s, l_take), 0);
  const bool l_refresh = (h > 0) && !(l_deny && !is_drain);
  const int64_t l_exp =
      (algo_match && !l_refresh) ? s.exp : add(now, r.duration_eff);
  const int64_t l_rem = clip(sub(r.limit, l_inflight), 0, r.limit);
  const int32_t l_status = l_deny ? kOver : kUnder;
  const bool l_reset_rm = (exists && is_reset) || neg_miss;
  const int32_t l_resp_status = l_reset_rm ? kUnder : l_status;
  const int64_t l_resp_rem = l_reset_rm ? r.limit : l_rem;
  const int64_t l_resp_reset = l_reset_rm ? 0 : l_exp;

  const bool is_gcra = r.algo == kAlgoGcra;
  const bool is_win = r.algo == kAlgoWindow;
  const bool is_lease = r.algo == kAlgoLease;
  // per-row algorithm select: token / gcra / window / lease / the rest
#define PICK5(tok, g, w, le, lk) \
  (is_token ? (tok) : is_gcra ? (g) : is_win ? (w) : is_lease ? (le) : (lk))

  const int64_t w_rem_store = sub(r.limit, w_cur_out);
  const int64_t l_rem_store = sub(r.limit, l_inflight);
  const bool remove_all = (tok_reset_rm && is_token) || (g_rm && is_gcra) ||
                          (w_reset_rm && is_win) || (l_reset_rm && is_lease);
  const int64_t aux_out = is_gcra ? g_tat_out : (is_win ? w_prev : 0);
  const int64_t w_exp = add(w_ws, mul(2, w_dur));

  if (MODE == kInt) {
    d.status_out = PICK5(tok_status_out, g_status, w_status, l_status, tok_status_out);
    d.rem_i_out = PICK5(tok_rem_store, (int64_t)0, w_rem_store, l_rem_store, tok_rem_store);
    d.rem_f_out = 0.0;
    d.stamp_out = PICK5(tok_created_out, now, w_ws, now, tok_created_out);
    d.dur_out = r.duration;
    d.exp_out = PICK5(tok_exp_out, g_exp, w_exp, l_exp, tok_exp_out);
    d.burst_out = is_gcra ? r.burst : 0;
    d.flags_out = flags_of(r.algo, d.status_out);
    d.remove = remove_all;
    d.aux_out = aux_out;
    d.resp_status = PICK5(tok_resp_status, g_resp_status, w_resp_status,
                          l_resp_status, tok_resp_status);
    d.resp_rem = PICK5(tok_resp_rem, g_resp_rem, w_resp_rem, l_resp_rem, tok_resp_rem);
    d.resp_reset = PICK5(tok_resp_reset, g_resp_reset, w_resp_reset, l_resp_reset,
                         tok_resp_reset);
    return d;
  }

  // -------------------------------------------------------- leaky bucket
  // float64 remaining; comparisons truncate toward zero like Go's
  // int64(float64)
  const bool lk_is_new = !algo_match;
  const double rate = __ddiv_rn((double)(is_greg ? r.greg_interval : r.duration),
                                (double)max1(r.limit));
  const int64_t irate = f64_to_i64(rate);

  double b_rem = is_reset ? (double)s.burst : s.rem_f;
  const bool burst_changed = s.burst != r.burst;
  b_rem = (burst_changed && (r.burst > f64_to_i64(b_rem))) ? (double)r.burst : b_rem;
  const double elapsed = (double)sub(now, s.stamp);
  const double leak = __ddiv_rn(elapsed, rate);
  const bool leak_applies = f64_to_i64(leak) > 0;
  b_rem = leak_applies ? __dadd_rn(b_rem, leak) : b_rem;
  const int64_t lk_stamp = leak_applies ? now : s.stamp;
  b_rem = (f64_to_i64(b_rem) > r.burst) ? (double)r.burst : b_rem;

  const int64_t lk_rem_now = f64_to_i64(b_rem);
  const bool lk_at_limit = (lk_rem_now == 0) && (h > 0);
  const bool lk_exact = !lk_at_limit && (lk_rem_now == h);
  const bool lk_overask = !lk_at_limit && !lk_exact && (h > lk_rem_now);
  const bool lk_zero = !lk_at_limit && !lk_exact && !lk_overask && (h == 0);
  const bool lk_consume = !lk_at_limit && !lk_exact && !lk_overask && !lk_zero;

  const double lk_rem_out = (lk_exact || (lk_overask && is_drain))
                                ? 0.0
                                : (lk_consume ? __dsub_rn(b_rem, (double)h) : b_rem);
  int32_t lk_resp_status = (lk_at_limit || lk_overask) ? kOver : kUnder;
  int64_t lk_resp_rem = (lk_overask && !is_drain) ? lk_rem_now : f64_to_i64(lk_rem_out);
  const int64_t lk_reset_basis =
      lk_exact ? 0 : (lk_consume ? f64_to_i64(lk_rem_out) : lk_rem_now);
  int64_t lk_resp_reset = add(now, mul(sub(r.limit, lk_reset_basis), irate));
  const int64_t lk_exp = (h != 0) ? add(now, r.duration_eff) : s.exp;

  const bool lkn_over = h > r.burst;
  const double lkn_rem = lkn_over ? 0.0 : (double)sub(r.burst, h);
  const int64_t lkn_resp_rem = lkn_over ? 0 : sub(r.burst, h);
  const int32_t lkn_status = lkn_over ? kOver : kUnder;
  const int64_t lkn_reset = add(now, mul(sub(r.limit, lkn_resp_rem), irate));
  const int64_t lkn_exp = add(now, r.duration_eff);

  const double lk_rem_store = lk_is_new ? lkn_rem : lk_rem_out;
  const int64_t lk_stamp_out = lk_is_new ? now : lk_stamp;
  const int64_t lk_exp_out = lk_is_new ? lkn_exp : lk_exp;
  const int64_t lk_dur_out = lk_is_new ? r.duration_eff : r.duration;
  lk_resp_status = lk_is_new ? lkn_status : lk_resp_status;
  lk_resp_rem = lk_is_new ? lkn_resp_rem : lk_resp_rem;
  lk_resp_reset = lk_is_new ? lkn_reset : lk_resp_reset;

  const bool is_leaky = r.algo == kAlgoLeaky;
  d.status_out = PICK5(tok_status_out, g_status, w_status, l_status, kUnder);
  d.rem_i_out = PICK5(tok_rem_store, (int64_t)0, w_rem_store, l_rem_store, (int64_t)0);
  d.rem_f_out = is_leaky ? lk_rem_store : 0.0;
  d.stamp_out = PICK5(tok_created_out, now, w_ws, now, lk_stamp_out);
  d.dur_out = is_leaky ? lk_dur_out : r.duration;
  d.exp_out = PICK5(tok_exp_out, g_exp, w_exp, l_exp, lk_exp_out);
  d.burst_out = (is_leaky || is_gcra) ? r.burst : 0;
  d.flags_out = flags_of(r.algo, d.status_out);
  d.remove = remove_all;
  d.aux_out = aux_out;
  d.resp_status = PICK5(tok_resp_status, g_resp_status, w_resp_status, l_resp_status,
                        lk_resp_status);
  d.resp_rem = PICK5(tok_resp_rem, g_resp_rem, w_resp_rem, l_resp_rem, lk_resp_rem);
  d.resp_reset = PICK5(tok_resp_reset, g_resp_reset, w_resp_reset, l_resp_reset,
                       lk_resp_reset);
#undef PICK5
  return d;
}

// ops/kernel2.py decide_payload, one row: the chosen lane's canonical
// fields and the request -> exists, the Decision and the canonical
// write payload
template <int MODE>
__device__ void decide_payload(const int32_t* lane16, const Req& r, bool owns,
                               bool* exists_out, Decision* d_out,
                               int32_t* new16) {
  const int64_t s_exp = join64(lane16[EXP_LO], lane16[EXP_HI]);
  const bool exists = owns && (s_exp >= r.now);
  const int32_t s_flags = lane16[FLAGS];
  Stored s;
  s.limit = lane16[LIMIT];
  s.burst = lane16[BURST];
  s.rem_i = lane16[REM_I];
  s.algo = s_flags & 0xFF;
  s.status = s_flags >> 8;
  s.duration = join64(lane16[DUR_LO], lane16[DUR_HI]);
  s.stamp = join64(lane16[STAMP_LO], lane16[STAMP_HI]);
  s.exp = s_exp;
  s.rem_f = f32pair(lane16[REMF_HI], lane16[REMF_LO]);
  s.aux = join64(lane16[REMF_LO], lane16[REMF_HI]);
  const Decision d = bucket_math<MODE>(s, r, exists);

  int32_t remf_hi, remf_lo;
  if (MODE == kToken) {
    remf_hi = 0;
    remf_lo = 0;
  } else if (MODE == kGcra || MODE == kInt) {
    remf_hi = hi32(d.aux_out);
    remf_lo = lo32(d.aux_out);
  } else {
    const float f_hi = __double2float_rn(d.rem_f_out);
    const float f_lo = __double2float_rn(__dsub_rn(d.rem_f_out, (double)f_hi));
    const bool is_leaky = r.algo == kAlgoLeaky;
    remf_hi = is_leaky ? __float_as_int(f_hi) : hi32(d.aux_out);
    remf_lo = is_leaky ? __float_as_int(f_lo) : lo32(d.aux_out);
  }
  const bool rm = d.remove;
  new16[FP_LO] = rm ? 0 : lo32(r.fp);
  new16[FP_HI] = rm ? 0 : hi32(r.fp);
  new16[LIMIT] = sat32(r.limit);
  new16[BURST] = sat32(d.burst_out);
  new16[REM_I] = sat32(d.rem_i_out);
  new16[FLAGS] = d.flags_out;
  new16[DUR_LO] = lo32(d.dur_out);
  new16[DUR_HI] = hi32(d.dur_out);
  new16[STAMP_LO] = lo32(d.stamp_out);
  new16[STAMP_HI] = hi32(d.stamp_out);
  new16[EXP_LO] = rm ? 0 : lo32(d.exp_out);
  new16[EXP_HI] = rm ? 0 : hi32(d.exp_out);
  new16[REMF_HI] = remf_hi;
  new16[REMF_LO] = remf_lo;
  new16[14] = 0;
  new16[15] = 0;
  *exists_out = exists;
  *d_out = d;
}

// float64 minimum as torch.minimum and XLA's min compute it: NaN
// propagates
__device__ __forceinline__ double nan_min(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// ops/kernel2.py merge_payload16, one row: the incoming canonical slot, the
// claimed stored lane, ownership and the receiver clock -> exists and the
// merged canonical row
__device__ bool merge_payload16(int64_t fp, const int32_t* in16,
                                const int32_t* lane16, bool owns, int64_t now,
                                int32_t* new16) {
  const int64_t i_exp = join64(in16[EXP_LO], in16[EXP_HI]);
  const int64_t s_exp = join64(lane16[EXP_LO], lane16[EXP_HI]);
  const bool exists = owns && (s_exp >= now);
  const int64_t i_stamp = join64(in16[STAMP_LO], in16[STAMP_HI]);
  const int64_t s_stamp = join64(lane16[STAMP_LO], lane16[STAMP_HI]);
  const int32_t i_flags = in16[FLAGS], s_flags = lane16[FLAGS];
  const bool keep_stored = exists && (s_stamp > i_stamp);
  const int32_t limit = keep_stored ? lane16[LIMIT] : in16[LIMIT];
  const int32_t burst = keep_stored ? lane16[BURST] : in16[BURST];
  const int32_t algo = keep_stored ? (s_flags & 0xFF) : (i_flags & 0xFF);
  const int64_t dur = keep_stored ? join64(lane16[DUR_LO], lane16[DUR_HI])
                                  : join64(in16[DUR_LO], in16[DUR_HI]);
  const int32_t i_st = i_flags >> 8, s_st = s_flags >> 8;
  const int32_t status = exists ? (i_st > s_st ? i_st : s_st) : i_st;
  const int32_t rem_i = exists ? min(in16[REM_I], lane16[REM_I]) : in16[REM_I];
  const double i_f = f32pair(in16[REMF_HI], in16[REMF_LO]);
  const double s_f = f32pair(lane16[REMF_HI], lane16[REMF_LO]);
  const double rem_f = exists ? nan_min(i_f, s_f) : i_f;
  const int64_t s_aux = join64(lane16[REMF_LO], lane16[REMF_HI]);
  const int64_t i_aux = join64(in16[REMF_LO], in16[REMF_HI]);
  const bool same_algo = exists && ((s_flags & 0xFF) == (i_flags & 0xFF));
  const int64_t aux = same_algo ? max64(s_aux, i_aux) : (keep_stored ? s_aux : i_aux);
  const int64_t exp = exists ? max64(s_exp, i_exp) : i_exp;
  const int64_t stamp = exists ? max64(s_stamp, i_stamp) : i_stamp;

  const float f_hi = __double2float_rn(rem_f);
  const float f_lo = __double2float_rn(__dsub_rn(rem_f, (double)f_hi));
  const bool aux_algo = (algo == kAlgoGcra) || (algo == kAlgoWindow);
  new16[FP_LO] = lo32(fp);
  new16[FP_HI] = hi32(fp);
  new16[LIMIT] = limit;
  new16[BURST] = burst;
  new16[REM_I] = rem_i;
  new16[FLAGS] = flags_of(algo, status);
  new16[DUR_LO] = lo32(dur);
  new16[DUR_HI] = hi32(dur);
  new16[STAMP_LO] = lo32(stamp);
  new16[STAMP_HI] = hi32(stamp);
  new16[EXP_LO] = lo32(exp);
  new16[EXP_HI] = hi32(exp);
  new16[REMF_HI] = aux_algo ? hi32(aux) : __float_as_int(f_hi);
  new16[REMF_LO] = aux_algo ? lo32(aux) : __float_as_int(f_lo);
  new16[14] = 0;
  new16[15] = 0;
  return exists;
}

}  // namespace gm
