"""Host-RAM shadow table: fp-keyed canonical 64 B rows + optional spill
(the port of ``gubernator_tpu/tier/shadow.py``, numpy only).

The shadow is the demotion target for rows leaving HBM (evictee sidecar,
idle sweep) and the fault-back source during host staging. Design points:

* **Canonical rows.** Entries are always the 16-field full-width slot row
  (ops/layout.py conversion contract): demotes unpack the table's own
  layout at the boundary, promotes re-enter through `merge_rows` which
  packs back — so a row that lived in a packed table round-trips
  bit-exactly and cross-layout restarts stay sound.
* **Byte bound.** `max_bytes` bounds the RAM set at the nominal
  ROW_BYTES (64) per row — the state bytes themselves (``stats()``
  reports it as ``nominal_bytes``). Over-budget entries shed oldest-demoted-first
  (LRU over demote/refresh time): to the spill file when one is
  configured (lossless), else dropped and counted — exactly today's
  eviction loss, never worse.
* **Conservative conflicts.** A demote for a fingerprint already
  shadowed merges host-side with the merge2 rules (remaining=min,
  expiry=max, aux=max-same-algo, OVER sticks, newest-stamp config) —
  a duplicated or reordered demote can only tighten.
* **Spill file.** DeltaLog frame format (store.py — CRC-framed raw-LE
  full-layout rows), append-only with an in-memory fp → byte-offset
  index for O(1) single-row fault-back reads; compacts when garbage
  dominates. Spill writes are BATCHED (`flush()`, sweep cadence) so the
  serving-path evict capture never pays an fsync. Promote REMOVALS are
  RAM-only: after a restart a promoted row may be re-promoted stale,
  which the conservative merge renders harmless (under-grant only).
"""

from __future__ import annotations

import logging
import os
import struct
import tempfile
import threading
import zlib
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from gubernator_tpu_torch.ops.table2 import (
    BURST,
    DUR_HI,
    DUR_LO,
    EXP_HI,
    EXP_LO,
    F,
    FLAGS,
    LIMIT,
    REM_I,
    REMF_HI,
    REMF_LO,
    STAMP_HI,
    STAMP_LO,
)
from gubernator_tpu_torch.store import (
    DELTA_LOG_MAGIC,
    _FRAME_HEADER,
    encode_delta_frame,
    read_delta_frames,
)

log = logging.getLogger("gubernator_tpu_torch.tier")

ROW_BYTES = F * 4  # canonical full-width slot row: the shadow's unit cost


def _join(slots: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return (slots[:, hi].astype(np.int64) << 32) | (
        slots[:, lo].astype(np.int64) & 0xFFFFFFFF
    )


def _split(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lo_u = vals & 0xFFFFFFFF
    lo = np.where(lo_u >= (1 << 31), lo_u - (1 << 32), lo_u).astype(np.int32)
    return lo, (vals >> 32).astype(np.int32)


def _remf_f64(slots: np.ndarray) -> np.ndarray:
    return (
        slots[:, REMF_HI].view(np.float32).astype(np.float64)
        + slots[:, REMF_LO].view(np.float32).astype(np.float64)
    )


def merge_canonical_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side conservative merge of same-fingerprint canonical rows —
    the numpy twin of kernel2.merge2's exists-branch (remaining=min,
    expiry=max, aux=max when algorithms agree else config winner's,
    OVER sticks, newest-stamp config wins). (n, 16) × (n, 16) → (n, 16);
    used for shadow offer conflicts and spill-load dedup, so a duplicated
    demote can only tighten what a later promote installs."""
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    out = a.copy()
    st_a, st_b = _join(a, STAMP_LO, STAMP_HI), _join(b, STAMP_LO, STAMP_HI)
    keep_a = st_a > st_b  # config carrier: the newer stamp's side
    for f_ in (LIMIT, BURST, DUR_LO, DUR_HI):
        out[:, f_] = np.where(keep_a, a[:, f_], b[:, f_])
    algo = np.where(keep_a, a[:, FLAGS] & 0xFF, b[:, FLAGS] & 0xFF)
    status = np.maximum(a[:, FLAGS] >> 8, b[:, FLAGS] >> 8)
    out[:, FLAGS] = algo | (status << 8)
    out[:, REM_I] = np.minimum(a[:, REM_I], b[:, REM_I])
    exp = np.maximum(_join(a, EXP_LO, EXP_HI), _join(b, EXP_LO, EXP_HI))
    out[:, EXP_LO], out[:, EXP_HI] = _split(exp)
    stamp = np.maximum(st_a, st_b)
    out[:, STAMP_LO], out[:, STAMP_HI] = _split(stamp)
    # raw aux pair (GCRA TAT / window prev): max tightens when the two
    # sides agree on the algorithm, else the config winner's raw value;
    # the float lane keeps its unconditional min (merge2's own rule)
    aux_a, aux_b = _join(a, REMF_LO, REMF_HI), _join(b, REMF_LO, REMF_HI)
    same = (a[:, FLAGS] & 0xFF) == (b[:, FLAGS] & 0xFF)
    aux = np.where(
        same, np.maximum(aux_a, aux_b), np.where(keep_a, aux_a, aux_b)
    )
    rem_f = np.minimum(_remf_f64(a), _remf_f64(b))
    f_hi = rem_f.astype(np.float32)
    f_lo = (rem_f - f_hi.astype(np.float64)).astype(np.float32)
    aux_lo, aux_hi = _split(aux)
    is_aux = (algo == 2) | (algo == 3)  # GCRA | sliding window
    out[:, REMF_HI] = np.where(is_aux, aux_hi, f_hi.view(np.int32))
    out[:, REMF_LO] = np.where(is_aux, aux_lo, f_lo.view(np.int32))
    return out


class _SpillFile:
    """Append-only DeltaLog-format spill with an fp → byte-offset index.

    One frame per flush; each indexed row is read back with a single
    seek + 64 B read. Compaction rewrites the live rows into a fresh
    file (atomic replace) when garbage dominates. NOT thread-safe on its
    own — the owning ShadowTable's lock serializes every call."""

    COMPACT_MIN_BYTES = 1 << 22  # don't bother below 4 MiB
    _ROW = ROW_BYTES

    def __init__(self, path: str):
        self.path = path
        self.index: dict = {}  # fp -> absolute byte offset of the row
        self.payload_bytes = 0  # all row bytes ever appended (garbage incl.)
        self.read_errors = 0
        self.loaded_rows = 0

    # ------------------------------------------------------------- loading
    def load(self) -> int:
        """Rebuild the index from an existing spill file (boot). Later
        frames supersede earlier ones; a torn tail is ignored (the clean
        prefix is what the scan yields). Returns indexed rows."""
        scan = read_delta_frames(self.path)
        if scan.error:
            log.warning("tier spill %s: %s — keeping the clean prefix",
                        self.path, scan.error)
        off = len(DELTA_LOG_MAGIC)
        for _epoch, _now, slots, layout in scan.frames:
            payload_off = off + _FRAME_HEADER.size
            n = slots.shape[0]
            width = slots.shape[1] * 4
            if getattr(layout, "F", None) == F:
                fps = (slots[:, 1].astype(np.int64) << 32) | (
                    slots[:, 0].astype(np.int64) & 0xFFFFFFFF
                )
                for i in range(n):
                    if fps[i] != 0:
                        self.index[int(fps[i])] = payload_off + i * self._ROW
            off = payload_off + n * width
        self.payload_bytes = max(0, off - len(DELTA_LOG_MAGIC))
        self.loaded_rows = len(self.index)
        return self.loaded_rows

    # ------------------------------------------------------------ appending
    def append(self, fps: np.ndarray, rows: np.ndarray, now_ms: int) -> None:
        """Append one frame of canonical rows; index every row."""
        n = int(fps.shape[0])
        if n == 0:
            return
        frame = encode_delta_frame(0, now_ms, rows.astype(np.int32))
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fresh = not os.path.exists(self.path) or os.path.getsize(
            self.path
        ) == 0
        with open(self.path, "ab") as f:
            if fresh:
                f.write(DELTA_LOG_MAGIC)
            base = f.tell() + _FRAME_HEADER.size
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        for i in range(n):
            self.index[int(fps[i])] = base + i * self._ROW
        self.payload_bytes += n * self._ROW

    # -------------------------------------------------------------- reading
    def read(self, fp: int) -> Optional[np.ndarray]:
        """One indexed row ((16,) int32) or None. Validates the stored
        fingerprint — a mismatch (torn/foreign file) drops the entry."""
        off = self.index.get(fp)
        if off is None:
            return None
        try:
            with open(self.path, "rb") as f:
                f.seek(off)
                buf = f.read(self._ROW)
        except OSError:
            self.read_errors += 1
            self.index.pop(fp, None)
            return None
        if len(buf) < self._ROW:
            self.read_errors += 1
            self.index.pop(fp, None)
            return None
        row = np.frombuffer(buf, dtype="<i4").astype(np.int32)
        got = (int(row[1]) << 32) | (int(row[0]) & 0xFFFFFFFF)
        if got != fp:
            self.read_errors += 1
            self.index.pop(fp, None)
            return None
        return row

    def discard(self, fp: int) -> None:
        self.index.pop(fp, None)

    # ----------------------------------------------------------- compaction
    def maybe_compact(self, now_ms: int) -> bool:
        """Rewrite live rows into a fresh file when garbage dominates
        (> half the payload) and the file is worth the I/O."""
        live = len(self.index) * self._ROW
        if self.payload_bytes < self.COMPACT_MIN_BYTES:
            return False
        if live * 2 > self.payload_bytes:
            return False
        fps = np.fromiter(self.index.keys(), dtype=np.int64,
                          count=len(self.index))
        rows = np.zeros((fps.shape[0], F), dtype=np.int32)
        keep = np.zeros(fps.shape[0], dtype=bool)
        for i, fp in enumerate(fps):
            row = self.read(int(fp))
            if row is not None:
                rows[i] = row
                keep[i] = True
        fps, rows = fps[keep], rows[keep]
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".gubtpu-spill-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(DELTA_LOG_MAGIC)
                base = f.tell() + _FRAME_HEADER.size
                if fps.shape[0]:
                    f.write(encode_delta_frame(0, now_ms, rows))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.index = {
            int(fps[i]): base + i * self._ROW for i in range(fps.shape[0])
        }
        self.payload_bytes = fps.shape[0] * self._ROW
        return True

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0


class ShadowTable:
    """The host-side tier: fp → canonical 64 B row, byte-bounded RAM set
    with LRU shed-to-spill (or shed-and-count), batched durable spill,
    and exact-match fault-back probes. Thread-safe (one lock): offers
    arrive from fetch threads (evict capture) and the sweep task, probes
    from prep threads, flushes from the tier manager."""

    def __init__(self, max_bytes: int, spill_path: Optional[str] = None):
        if max_bytes <= 0:
            raise ValueError("shadow max_bytes must be positive")
        self.max_bytes = int(max_bytes)
        self._rows: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._unspilled: set = set()  # fps RAM-newer than the spill file
        self.spill = _SpillFile(spill_path) if spill_path else None
        self._lock = threading.Lock()
        # Bloom pre-filter over everything ever shadowed: the fault-back
        # probe runs per BATCH on the serving path, and for hot-set
        # traffic every fingerprint misses — the vectorized two-probe
        # reject makes a full-batch miss cost microseconds instead of a
        # per-fp dict walk. Removals never clear bits (promotes leave
        # false positives, which the dict then rejects exactly), so the
        # filter only ever errs toward the slow-but-correct path. Sized
        # ~16 bits per row the byte budget can hold, clamped to
        # [2^16, 2^30] bits.
        bits = 16 * max(1, self.max_bytes // ROW_BYTES)
        p = 1 << 16
        while p < bits and p < (1 << 30):
            p *= 2
        self._bloom_mask = np.uint64(p - 1)
        self._bloom = np.zeros(p >> 6, dtype=np.uint64)
        # counters (cumulative; the metrics layer diffs them)
        self.demoted_evict = 0
        self.demoted_idle = 0
        self.promoted = 0
        # promote rows handed BACK (claim dropped after retries — > K
        # same-bucket promotes in one batch): their decide that batch may
        # have fresh-granted; the bound docs/tiering.md documents
        self.promote_returned = 0
        self.shed = 0  # rows dropped with no spill — today's eviction loss
        self.probes = 0
        self.probe_hits = 0
        self.expired_dropped = 0
        self.conflicts_merged = 0

    # --------------------------------------------------------- bloom filter

    def _bloom_hashes(self, fps: np.ndarray):
        x = np.asarray(fps, dtype=np.int64).view(np.uint64)
        with np.errstate(over="ignore"):
            h1 = (x * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(17)
            h2 = (x * np.uint64(0xC2B2AE3D27D4EB4F)) >> np.uint64(17)
        return h1 & self._bloom_mask, h2 & self._bloom_mask

    def _bloom_add(self, fps: np.ndarray) -> None:
        for h in self._bloom_hashes(fps):
            np.bitwise_or.at(
                self._bloom, (h >> np.uint64(6)).astype(np.int64),
                np.uint64(1) << (h & np.uint64(63)),
            )

    def _bloom_maybe(self, fps: np.ndarray) -> np.ndarray:
        h1, h2 = self._bloom_hashes(fps)
        one = np.uint64(1)
        g = lambda h: (
            self._bloom[(h >> np.uint64(6)).astype(np.int64)]
            >> (h & np.uint64(63))
        ) & one
        return (g(h1) & g(h2)).astype(bool)

    # ------------------------------------------------------------- geometry
    @property
    def ram_rows(self) -> int:
        return len(self._rows)

    @property
    def nominal_bytes(self) -> int:
        """RAM set cost at ROW_BYTES per row — the bounded figure."""
        return len(self._rows) * ROW_BYTES

    @property
    def tracked_rows(self) -> int:
        """Rows reachable for fault-back: RAM ∪ spill-only."""
        n = len(self._rows)
        if self.spill is not None:
            n += sum(
                1 for fp in self.spill.index if fp not in self._rows
            )
        return n

    # --------------------------------------------------------------- demote
    def offer(self, fps: np.ndarray, rows: np.ndarray, now_ms: int,
              reason: str = "evict") -> int:
        """Accept a demote batch of canonical rows. Expired rows are
        dropped (dead state must not resurrect); conflicts merge
        conservatively; the RAM byte bound is enforced after insert
        (shed-to-spill, else shed-and-count). Returns rows accepted."""
        n = int(fps.shape[0])
        if n == 0:
            return 0
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        exp = _join(rows, EXP_LO, EXP_HI)
        live = exp >= now_ms
        accepted = 0
        with self._lock:
            self.expired_dropped += int((~live).sum())
            for i in np.nonzero(live)[0]:
                fp = int(fps[i])
                if fp == 0:
                    continue
                row = rows[i]
                cur = self._rows.get(fp)
                if cur is not None:
                    row = merge_canonical_rows(row[None], cur[None])[0]
                    self.conflicts_merged += 1
                self._rows[fp] = row
                self._rows.move_to_end(fp)
                self._unspilled.add(fp)
                accepted += 1
            if accepted:
                self._bloom_add(fps[live])
            if reason == "idle":
                self.demoted_idle += accepted
            elif reason == "return":
                self.promote_returned += accepted
            else:
                self.demoted_evict += accepted
            self._enforce_bound(now_ms)
        return accepted

    def _enforce_bound(self, now_ms: int) -> None:
        """Pop oldest RAM entries past the byte budget (lock held). With a
        spill the popped rows are appended there first (lossless); without
        one they are shed — counted state loss, identical to the
        pre-tiering eviction behavior."""
        over = len(self._rows) - self.max_bytes // ROW_BYTES
        if over <= 0:
            return
        popped_fps = np.empty(over, dtype=np.int64)
        popped_rows = np.empty((over, F), dtype=np.int32)
        for j in range(over):
            fp, row = self._rows.popitem(last=False)
            popped_fps[j] = fp
            popped_rows[j] = row
            self._unspilled.discard(fp)
        if self.spill is not None:
            self.spill.append(popped_fps, popped_rows, now_ms)
        else:
            self.shed += over

    def flush(self, now_ms: int) -> int:
        """Write RAM entries newer than the spill file out to it (sweep
        cadence / shutdown). No-op without a spill. Returns rows written."""
        if self.spill is None:
            return 0
        with self._lock:
            fps = [fp for fp in self._unspilled if fp in self._rows]
            if not fps:
                self._unspilled.clear()
                return 0
            arr_fps = np.asarray(fps, dtype=np.int64)
            arr_rows = np.stack([self._rows[fp] for fp in fps])
            self.spill.append(arr_fps, arr_rows, now_ms)
            self._unspilled.clear()
            self.spill.maybe_compact(now_ms)
            return len(fps)

    def load(self) -> int:
        """Boot: index an existing spill file (rows stay on disk; they
        fault back lazily). Returns indexed rows."""
        if self.spill is None:
            return 0
        with self._lock:
            n = self.spill.load()
            if n:
                self._bloom_add(
                    np.fromiter(self.spill.index.keys(), dtype=np.int64,
                                count=len(self.spill.index))
                )
            return n

    # ------------------------------------------------------------ fault-back
    def take(self, fps: np.ndarray, now_ms: int):
        """Exact-match probe-and-REMOVE for a batch of fingerprints:
        (found_fps (m,) i64, rows (m, 16) i32). Misses cost one dict
        lookup each (two with a spill) — the off-hot-path contract.
        Expired entries are dropped, not promoted."""
        n = int(fps.shape[0])
        if n == 0:
            return np.empty(0, dtype=np.int64), np.empty((0, F), np.int32)
        # vectorized Bloom reject: a batch with no shadowed key pays a
        # few numpy ops, never a per-fp dict walk (the hot-set contract)
        maybe = self._bloom_maybe(fps)
        if not maybe.any():
            with self._lock:
                self.probes += n
            return np.empty(0, dtype=np.int64), np.empty((0, F), np.int32)
        out_fps = []
        out_rows = []
        fp_list = np.asarray(fps, dtype=np.int64)[maybe].tolist()
        with self._lock:
            self.probes += n
            seen = set()
            for fp in fp_list:
                if fp == 0 or fp in seen:
                    continue
                seen.add(fp)
                row = self._rows.pop(fp, None)
                if row is None and self.spill is not None:
                    row = self.spill.read(fp)
                if row is None:
                    continue
                self._unspilled.discard(fp)
                if self.spill is not None:
                    self.spill.discard(fp)
                exp = (int(row[EXP_HI]) << 32) | (int(row[EXP_LO]) & 0xFFFFFFFF)
                if exp < now_ms:
                    self.expired_dropped += 1
                    continue
                out_fps.append(fp)
                out_rows.append(row)
            self.probe_hits += len(out_fps)
            # taken rows ARE promoted by contract: the caller installs
            # them through the conservative merge before its dispatch
            self.promoted += len(out_fps)
        if not out_fps:
            return np.empty(0, dtype=np.int64), np.empty((0, F), np.int32)
        return (
            np.asarray(out_fps, dtype=np.int64),
            np.stack(out_rows).astype(np.int32),
        )

    def contains(self, fps: np.ndarray) -> np.ndarray:
        """Non-destructive membership mask (RAM ∪ spill index) — the
        miss re-check's cheap gate (ops/engine._shadow_rehydrate)."""
        n = int(fps.shape[0])
        out = np.zeros(n, dtype=bool)
        fp_list = np.asarray(fps, dtype=np.int64).tolist()
        with self._lock:
            rows = self._rows
            idx = self.spill.index if self.spill is not None else None
            for i, fp in enumerate(fp_list):
                if fp == 0:
                    continue
                out[i] = fp in rows or (idx is not None and fp in idx)
        return out

    # ---------------------------------------------------------------- status
    def stats(self) -> dict:
        with self._lock:
            out = {
                "ram_rows": len(self._rows),
                "nominal_bytes": len(self._rows) * ROW_BYTES,
                "max_bytes": self.max_bytes,
                "demoted_evict": self.demoted_evict,
                "demoted_idle": self.demoted_idle,
                "promoted": self.promoted,
                "promote_returned": self.promote_returned,
                "shed": self.shed,
                "probes": self.probes,
                "probe_hits": self.probe_hits,
                "expired_dropped": self.expired_dropped,
                "conflicts_merged": self.conflicts_merged,
            }
            if self.spill is not None:
                out["spill"] = {
                    "path": self.spill.path,
                    "indexed_rows": len(self.spill.index),
                    "file_bytes": self.spill.size_bytes(),
                    "read_errors": self.spill.read_errors,
                }
            return out
