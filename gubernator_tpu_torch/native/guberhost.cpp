// guberhost — native host ingress/egress for gubernator-tpu.
//
// The serving hot path's host-side cost is per-item Python work: protobuf
// message traversal, string hashing, and response object construction
// (~1-2 µs/item), which caps a host at ~1M checks/s regardless of kernel
// speed. This module parses the GetRateLimitsReq WIRE BYTES directly into
// flat column buffers (consumed via np.frombuffer), computes both hashes
// (63-bit seeded XXH64 fingerprint — ops/hashing.py parity; fnv1a_32 ring
// point — peers/hash_ring.py parity) in the same pass, and serializes
// GetRateLimitsResp straight from response columns.
//
// Wire schema parsed (proto/gubernator.proto):
//   GetRateLimitsReq { repeated RateLimitReq requests = 1; }
//   RateLimitReq { name=1 str; unique_key=2 str; hits=3; limit=4;
//                  duration=5; algorithm=6; behavior=7; burst=8;
//                  metadata=9 (skipped); created_at=10 }
//   GetRateLimitsResp { repeated RateLimitResp responses = 1; }
//   RateLimitResp { status=1; limit=2; remaining=3; reset_time=4;
//                   error=5 str; metadata=6 }
//
// No libprotobuf dependency: varint/length-delimited framing is ~60 lines.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

// ------------------------------------------------------------------ XXH64
// Standard XXH64 (public algorithm; matches python-xxhash output).

static const uint64_t P1 = 11400714785074694791ULL;
static const uint64_t P2 = 14029467366897019727ULL;
static const uint64_t P3 = 1609587929392839161ULL;
static const uint64_t P4 = 9650029242287828579ULL;
static const uint64_t P5 = 2870177450012600261ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}
static inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86/ARM)
}
static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl64(acc, 31);
  return acc * P1;
}
static inline uint64_t xxh_merge(uint64_t acc, uint64_t val) {
  acc ^= xxh_round(0, val);
  return acc * P1 + P4;
}

static uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, read64(p)); p += 8;
      v2 = xxh_round(v2, read64(p)); p += 8;
      v3 = xxh_round(v3, read64(p)); p += 8;
      v4 = xxh_round(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1); h = xxh_merge(h, v2);
    h = xxh_merge(h, v3); h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, read64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl64(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

static inline uint32_t fnv1a_32(const uint8_t* p, size_t len) {
  uint32_t h = 2166136261u;
  for (size_t i = 0; i < len; i++) {
    h ^= p[i];
    h *= 16777619u;
  }
  return h;
}

// ------------------------------------------------------------ proto frames

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  bool skip(uint32_t wt) {
    switch (wt) {
      case 0: varint(); return ok;
      case 1: if (end - p < 8) return ok = false; p += 8; return true;
      case 2: {
        uint64_t n = varint();
        if (!ok || (uint64_t)(end - p) < n) return ok = false;
        p += n;
        return true;
      }
      case 5: if (end - p < 4) return ok = false; p += 4; return true;
      default: return ok = false;
    }
  }
};

static const uint64_t FP_SEED = 0x6775626572ULL;  // hashing.py _SEED
static const uint64_t MASK63 = (1ULL << 63) - 1;

// err codes — ops/batch.py ERR_*
enum { ERR_OK = 0, ERR_EMPTY_KEY = 1, ERR_EMPTY_NAME = 2 };

// Compact-wire layout constants — MUST mirror ops/wire.py (DUR_BITS,
// HITS_BITS, behavior bit budget). The parser pre-packs each item into the
// 5-lane int32 ingress row IN THE SAME PASS so the serving path can stage a
// dispatch grid without ever materializing per-column int64 arrays; the
// created_at delta (lane 4 bits 18-27) is left zero — the flush loop ORs it
// in once the batch base is known; bits 28-29 carry the priority tier. Lane 3 is duration[0:27] | algo << 27
// (3 bits — five in-kernel algorithms) | cascade_level << 30; the parser
// always emits level 0 (cascade requests take the pb path — see field 11
// below).
static const int64_t WIRE_DUR_MASK = (1LL << 27) - 1;   // ops/wire.DUR_BITS
static const int64_t WIRE_HITS_MASK = (1LL << 18) - 1;  // ops/wire.HITS_BITS
static const int64_t WIRE_I32_MAX = 2147483647LL;
// RESET_REMAINING | DRAIN_OVER_LIMIT | kernel-inert bits | the 2-bit
// priority tier (ops/wire.py _ENCODABLE_BEHAVIOR); anything else
// (Gregorian, unknown) → full-width
static const int32_t WIRE_ENC_BEHAVIOR = 8 | 32 | 1 | 2 | 16 | 64 | 128;
// known client-facing behavior bits: flag values 1..32 plus the 2-bit
// priority tier at bits 6-7 (types.PRIORITY_SHIFT) — anything above is
// masked at ingress: the behavior word's high bits carry the INTERNAL
// cascade level (types.CASCADE_LEVEL_SHIFT), which clients must not be
// able to forge
static const int32_t BEHAVIOR_CLIENT_MASK = 255;
// highest algorithm enum this build speaks (types.MAX_ALGORITHM); larger
// values are per-item errors on the full path, so never fused
static const int32_t MAX_ALGORITHM = 4;

struct Item {
  const uint8_t* name = nullptr; size_t name_len = 0;
  const uint8_t* key = nullptr; size_t key_len = 0;
  const uint8_t* traceparent = nullptr; size_t traceparent_len = 0;
  int64_t hits = 0, limit = 0, duration = 0, burst = 0, created_at = 0;
  int32_t algorithm = 0, behavior = 0;
  bool has_cascade = false;  // repeated CascadeLevel cascade = 11 present
  size_t start = 0, len = 0;  // byte span of the item message in the input
};

// metadata map entry {1: key str, 2: value str} — only "traceparent" is
// routing-relevant (trace propagation; docs/tracing.md)
static void parse_metadata_entry(const uint8_t* p, const uint8_t* end,
                                 Item& it) {
  Cursor c{p, end};
  const uint8_t* k = nullptr; size_t klen = 0;
  const uint8_t* v = nullptr; size_t vlen = 0;
  while (c.p < c.end && c.ok) {
    uint64_t tag = c.varint();
    if (!c.ok) return;
    uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
    if ((field == 1 || field == 2) && wt == 2) {
      uint64_t n = c.varint();
      if (!c.ok || (uint64_t)(c.end - c.p) < n) return;
      if (field == 1) { k = c.p; klen = n; } else { v = c.p; vlen = n; }
      c.p += n;
    } else if (!c.skip(wt)) {
      return;
    }
  }
  if (k && v && klen == 11 && memcmp(k, "traceparent", 11) == 0) {
    it.traceparent = v;
    it.traceparent_len = vlen;
  }
}

static bool parse_item(Cursor& c, Item& it) {
  while (c.p < c.end && c.ok) {
    uint64_t tag = c.varint();
    if (!c.ok) return false;
    uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
    switch (field) {
      case 1: case 2: {  // name / unique_key
        if (wt != 2) return false;
        uint64_t n = c.varint();
        if (!c.ok || (uint64_t)(c.end - c.p) < n) return false;
        if (field == 1) { it.name = c.p; it.name_len = n; }
        else { it.key = c.p; it.key_len = n; }
        c.p += n;
        break;
      }
      case 3: it.hits = (int64_t)c.varint(); break;
      case 4: it.limit = (int64_t)c.varint(); break;
      case 5: it.duration = (int64_t)c.varint(); break;
      case 6: it.algorithm = (int32_t)c.varint(); break;
      case 7: it.behavior = (int32_t)c.varint(); break;
      case 8: it.burst = (int64_t)c.varint(); break;
      case 9: {  // metadata map entry
        if (wt != 2) return false;
        uint64_t n = c.varint();
        if (!c.ok || (uint64_t)(c.end - c.p) < n) return false;
        parse_metadata_entry(c.p, c.p + n, it);
        c.p += n;
        break;
      }
      case 10: it.created_at = (int64_t)c.varint(); break;
      case 11:  // repeated CascadeLevel cascade — flag it; the daemon
                // materializes the pb item and expands the levels itself
        it.has_cascade = true;
        if (!c.skip(wt)) return false;
        break;
      default:
        if (!c.skip(wt)) return false;
    }
  }
  return c.ok;
}

// parse_get_rate_limits(data: bytes)
//   -> (n, fp, algo, behavior, hits, limit, burst, duration, created_at,
//       err, ring_hash, spans, traceparent, lanes, enc, casc)
// Buffer layouts (np.frombuffer): fp/hits/limit/burst/duration/created_at
// int64; algo/behavior int32; err int8; ring_hash uint32; spans int64 pairs
// (start, len) of each item's bytes for lazy pb materialization; lanes a
// (5, n) row-major int32 pre-packed compact-wire image (ops/wire.py lanes,
// created-delta field zero); enc int8 per-item compact-wire encodability;
// casc int8 per-item "carries a cascade field" flag (such batches take the
// pb path, where the daemon expands the levels).
// The scan + fill loops run with the GIL RELEASED — N front-door workers
// parse concurrently (service/daemon.py door pool).
static PyObject* parse_get_rate_limits(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  const uint8_t* data = (const uint8_t*)buf.buf;

  std::vector<Item> items;
  items.reserve(64);
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS;
  Cursor top{data, data + buf.len};
  while (top.p < top.end && top.ok) {
    uint64_t tag = top.varint();
    if (!top.ok) break;
    uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
    if (field == 1 && wt == 2) {
      uint64_t n = top.varint();
      if (!top.ok || (uint64_t)(top.end - top.p) < n) { top.ok = false; break; }
      Item it;
      it.start = (size_t)(top.p - data);
      it.len = (size_t)n;
      Cursor ic{top.p, top.p + n};
      if (!parse_item(ic, it)) { top.ok = false; break; }
      items.push_back(it);
      top.p += n;
    } else if (!top.skip(wt)) {
      break;
    }
  }
  ok = top.ok;
  Py_END_ALLOW_THREADS;
  if (!ok) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "malformed GetRateLimitsReq");
    return nullptr;
  }

  size_t n = items.size();
  // first propagated trace context in the batch (the daemon adopts one
  // scope per request, same as the pb path's first-match extraction)
  PyObject* tp = nullptr;
  for (size_t i = 0; i < n && !tp; i++) {
    if (items[i].traceparent) {
      tp = PyUnicode_DecodeUTF8((const char*)items[i].traceparent,
                                (Py_ssize_t)items[i].traceparent_len,
                                "replace");
      if (!tp) PyErr_Clear();
    }
  }
  if (!tp) {
    tp = Py_None;
    Py_INCREF(Py_None);
  }
  PyObject* out = PyTuple_New(16);
  PyObject* fp_b = PyBytes_FromStringAndSize(nullptr, n * 8);
  PyObject* algo_b = PyBytes_FromStringAndSize(nullptr, n * 4);
  PyObject* beh_b = PyBytes_FromStringAndSize(nullptr, n * 4);
  PyObject* hits_b = PyBytes_FromStringAndSize(nullptr, n * 8);
  PyObject* lim_b = PyBytes_FromStringAndSize(nullptr, n * 8);
  PyObject* burst_b = PyBytes_FromStringAndSize(nullptr, n * 8);
  PyObject* dur_b = PyBytes_FromStringAndSize(nullptr, n * 8);
  PyObject* ca_b = PyBytes_FromStringAndSize(nullptr, n * 8);
  PyObject* err_b = PyBytes_FromStringAndSize(nullptr, n);
  PyObject* ring_b = PyBytes_FromStringAndSize(nullptr, n * 4);
  PyObject* span_b = PyBytes_FromStringAndSize(nullptr, n * 16);
  PyObject* lanes_b = PyBytes_FromStringAndSize(nullptr, n * 5 * 4);
  PyObject* enc_b = PyBytes_FromStringAndSize(nullptr, n);
  PyObject* casc_b = PyBytes_FromStringAndSize(nullptr, n);
  if (!out || !fp_b || !algo_b || !beh_b || !hits_b || !lim_b || !burst_b ||
      !dur_b || !ca_b || !err_b || !ring_b || !span_b || !lanes_b || !enc_b ||
      !casc_b) {
    PyBuffer_Release(&buf);
    Py_XDECREF(out);
    return nullptr;
  }
  int64_t* fp = (int64_t*)PyBytes_AS_STRING(fp_b);
  int32_t* algo = (int32_t*)PyBytes_AS_STRING(algo_b);
  int32_t* beh = (int32_t*)PyBytes_AS_STRING(beh_b);
  int64_t* hits = (int64_t*)PyBytes_AS_STRING(hits_b);
  int64_t* lim = (int64_t*)PyBytes_AS_STRING(lim_b);
  int64_t* burst = (int64_t*)PyBytes_AS_STRING(burst_b);
  int64_t* dur = (int64_t*)PyBytes_AS_STRING(dur_b);
  int64_t* ca = (int64_t*)PyBytes_AS_STRING(ca_b);
  int8_t* err = (int8_t*)PyBytes_AS_STRING(err_b);
  uint32_t* ring = (uint32_t*)PyBytes_AS_STRING(ring_b);
  int64_t* span = (int64_t*)PyBytes_AS_STRING(span_b);
  int32_t* lanes = (int32_t*)PyBytes_AS_STRING(lanes_b);
  int8_t* enc = (int8_t*)PyBytes_AS_STRING(enc_b);
  int8_t* casc = (int8_t*)PyBytes_AS_STRING(casc_b);

  Py_BEGIN_ALLOW_THREADS;
  std::string hk;
  for (size_t i = 0; i < n; i++) {
    const Item& it = items[i];
    algo[i] = it.algorithm;
    // client-facing flag bits only: the high bits are the internal cascade
    // level field, which must never arrive from the wire
    beh[i] = it.behavior & BEHAVIOR_CLIENT_MASK;
    casc[i] = it.has_cascade ? 1 : 0;
    hits[i] = it.hits;
    lim[i] = it.limit;
    burst[i] = it.burst;
    dur[i] = it.duration;
    ca[i] = it.created_at;
    span[2 * i] = (int64_t)it.start;
    span[2 * i + 1] = (int64_t)it.len;
    fp[i] = 0;
    ring[i] = 0;
    lanes[i] = lanes[n + i] = lanes[2 * n + i] = lanes[3 * n + i] =
        lanes[4 * n + i] = 0;
    if (it.key_len == 0) { err[i] = ERR_EMPTY_KEY; enc[i] = 1; continue; }
    if (it.name_len == 0) { err[i] = ERR_EMPTY_NAME; enc[i] = 1; continue; }
    err[i] = ERR_OK;
    hk.clear();
    hk.append((const char*)it.name, it.name_len);
    hk.push_back('_');
    hk.append((const char*)it.key, it.key_len);
    uint64_t h =
        xxh64((const uint8_t*)hk.data(), hk.size(), FP_SEED) & MASK63;
    fp[i] = (int64_t)(h ? h : 1);
    ring[i] = fnv1a_32((const uint8_t*)hk.data(), hk.size());
    // compact-wire encodability, the ops/wire.wire_encodable checks the
    // parser can settle per-item (created_at skew is batch-relative — the
    // flush loop checks it). Validation-error fields (|limit|/|burst|
    // beyond int32) ALSO fall back: the full path turns them into
    // per-item errors the fused path has no pack stage to produce.
    bool e = (beh[i] & ~WIRE_ENC_BEHAVIOR) == 0 &&
             it.duration >= 0 && it.duration <= WIRE_DUR_MASK &&
             it.hits >= 0 && it.hits <= WIRE_HITS_MASK &&
             it.limit >= 0 && it.limit <= WIRE_I32_MAX &&
             it.burst >= -WIRE_I32_MAX && it.burst <= WIRE_I32_MAX &&
             (it.algorithm >= 0 && it.algorithm <= MAX_ALGORITHM) &&
             // burst lane rules: token ignores burst; leaky/GCRA default
             // burst 0 → limit in-trace (explicit bursts → full-width);
             // window/lease never read burst (keep 0 for byte fidelity)
             (it.algorithm == 0 || it.burst == 0) &&
             !it.has_cascade;
    enc[i] = e ? 1 : 0;
    // pre-packed 5-lane int32 row (ops/wire.pack_wire_rows layout);
    // lane 4's created-delta bits stay 0 until the flush stamps them
    uint64_t ufp = (uint64_t)fp[i];
    lanes[i] = (int32_t)(uint32_t)(ufp & 0xFFFFFFFFu);
    lanes[n + i] = (int32_t)(uint32_t)(ufp >> 32);
    lanes[2 * n + i] = (int32_t)it.limit;
    lanes[3 * n + i] = (int32_t)(uint32_t)(
        ((uint64_t)(it.duration & WIRE_DUR_MASK)) |
        ((uint64_t)(uint32_t)it.algorithm << 27));
    uint32_t l4 = (uint32_t)(it.hits & WIRE_HITS_MASK);
    l4 |= (uint32_t)((it.behavior >> 6) & 3) << 28;  // priority tier
    if (it.behavior & 8) l4 |= 1u << 30;   // RESET_REMAINING
    if (it.behavior & 32) l4 |= 1u << 31;  // DRAIN_OVER_LIMIT
    lanes[4 * n + i] = (int32_t)l4;
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);

  PyTuple_SET_ITEM(out, 0, PyLong_FromSize_t(n));
  PyTuple_SET_ITEM(out, 1, fp_b);
  PyTuple_SET_ITEM(out, 2, algo_b);
  PyTuple_SET_ITEM(out, 3, beh_b);
  PyTuple_SET_ITEM(out, 4, hits_b);
  PyTuple_SET_ITEM(out, 5, lim_b);
  PyTuple_SET_ITEM(out, 6, burst_b);
  PyTuple_SET_ITEM(out, 7, dur_b);
  PyTuple_SET_ITEM(out, 8, ca_b);
  PyTuple_SET_ITEM(out, 9, err_b);
  PyTuple_SET_ITEM(out, 10, ring_b);
  PyTuple_SET_ITEM(out, 11, span_b);
  PyTuple_SET_ITEM(out, 12, tp);
  PyTuple_SET_ITEM(out, 13, lanes_b);
  PyTuple_SET_ITEM(out, 14, enc_b);
  PyTuple_SET_ITEM(out, 15, casc_b);
  return out;
}

// ------------------------------------------------------------- encode side

static inline void put_varint(std::string& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back((char)(v | 0x80));
    v >>= 7;
  }
  out.push_back((char)v);
}
static inline void put_tag(std::string& out, uint32_t field, uint32_t wt) {
  put_varint(out, ((uint64_t)field << 3) | wt);
}

// encode_responses(status_i64, limit_i64, remaining_i64, reset_i64,
//                  errors: dict[int, str], now_ms: int = -1)
//                  -> bytes(GetRateLimitsResp)
// The column buffers are raw little-endian int64 — any buffer-protocol
// object works (contiguous numpy int64 arrays pass ZERO-COPY; no .tobytes()
// round trip). Error strings are gathered under the GIL up front; the
// varint/field assembly then runs with the GIL RELEASED so N responder
// workers encode concurrently. With now_ms >= 0, DENIED rows additionally
// carry metadata["retry_after_ms"] = max(0, reset_time - now_ms) — for
// GCRA denials reset_time is the exact TAT-derived conforming instant
// (ops/math.py), so clients honoring it back off precisely.
static PyObject* encode_responses(PyObject*, PyObject* args) {
  Py_buffer sb, lb, rb, tb;
  PyObject* errs;
  long long now_ms = -1;
  if (!PyArg_ParseTuple(args, "y*y*y*y*O|L", &sb, &lb, &rb, &tb, &errs,
                        &now_ms))
    return nullptr;
  size_t n = (size_t)(sb.len / 8);
  const int64_t* st = (const int64_t*)sb.buf;
  const int64_t* li = (const int64_t*)lb.buf;
  const int64_t* re = (const int64_t*)rb.buf;
  const int64_t* rt = (const int64_t*)tb.buf;

  // sparse {row: message} dict → C-side (row, utf8) list, GIL held
  std::vector<std::pair<size_t, std::string>> errv;
  bool bad = false;
  if (errs != Py_None) {
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(errs, &pos, &key, &val)) {
      size_t row = (size_t)PyLong_AsSize_t(key);
      if (row == (size_t)-1 && PyErr_Occurred()) { bad = true; break; }
      Py_ssize_t elen;
      const char* ep = PyUnicode_AsUTF8AndSize(val, &elen);
      if (!ep) { bad = true; break; }
      if (elen) errv.emplace_back(row, std::string(ep, (size_t)elen));
    }
  }
  if (bad) {
    PyBuffer_Release(&sb); PyBuffer_Release(&lb);
    PyBuffer_Release(&rb); PyBuffer_Release(&tb);
    return nullptr;
  }
  std::vector<const std::string*> err_at(errv.empty() ? 0 : n, nullptr);
  for (const auto& kv : errv)
    if (kv.first < n) err_at[kv.first] = &kv.second;

  std::string out;
  Py_BEGIN_ALLOW_THREADS;
  out.reserve(n * 24);
  std::string item;
  for (size_t i = 0; i < n; i++) {
    item.clear();
    if (st[i]) { put_tag(item, 1, 0); put_varint(item, (uint64_t)st[i]); }
    if (li[i]) { put_tag(item, 2, 0); put_varint(item, (uint64_t)li[i]); }
    if (re[i]) { put_tag(item, 3, 0); put_varint(item, (uint64_t)re[i]); }
    if (rt[i]) { put_tag(item, 4, 0); put_varint(item, (uint64_t)rt[i]); }
    if (!err_at.empty() && err_at[i]) {
      put_tag(item, 5, 2);
      put_varint(item, err_at[i]->size());
      item += *err_at[i];
    }
    if (now_ms >= 0 && st[i] == 1) {
      // metadata map entry {1: "retry_after_ms", 2: decimal-ms}
      static const char RA_KEY[] = "retry_after_ms";
      long long d = rt[i] - now_ms;
      if (d < 0) d = 0;
      char vbuf[24];
      int vlen = snprintf(vbuf, sizeof vbuf, "%lld", d);
      std::string entry;
      put_tag(entry, 1, 2);
      put_varint(entry, sizeof(RA_KEY) - 1);
      entry.append(RA_KEY, sizeof(RA_KEY) - 1);
      put_tag(entry, 2, 2);
      put_varint(entry, (uint64_t)vlen);
      entry.append(vbuf, (size_t)vlen);
      put_tag(item, 6, 2);
      put_varint(item, entry.size());
      item += entry;
    }
    put_tag(out, 1, 2);
    put_varint(out, item.size());
    out += item;
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&sb);
  PyBuffer_Release(&lb);
  PyBuffer_Release(&rb);
  PyBuffer_Release(&tb);
  return PyBytes_FromStringAndSize(out.data(), (Py_ssize_t)out.size());
}

// fingerprint64(data: bytes) -> int — parity check hook for tests
static PyObject* fingerprint64(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  uint64_t h = xxh64((const uint8_t*)buf.buf, (size_t)buf.len, FP_SEED) & MASK63;
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLongLong(h ? h : 1);
}

static PyObject* fnv1a32_py(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  uint32_t h = fnv1a_32((const uint8_t*)buf.buf, (size_t)buf.len);
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(h);
}

static PyMethodDef methods[] = {
    {"parse_get_rate_limits", parse_get_rate_limits, METH_VARARGS,
     "GetRateLimitsReq wire bytes -> column buffers"},
    {"encode_responses", encode_responses, METH_VARARGS,
     "response columns -> GetRateLimitsResp wire bytes"},
    {"fingerprint64", fingerprint64, METH_VARARGS, "seeded 63-bit XXH64"},
    {"fnv1a32", fnv1a32_py, METH_VARARGS, "fnv1a 32-bit"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef mod = {PyModuleDef_HEAD_INIT, "_guberhost",
                                 "native host ingress/egress", -1, methods};

PyMODINIT_FUNC PyInit__guberhost(void) { return PyModule_Create(&mod); }
