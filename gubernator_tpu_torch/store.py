"""Persistence hooks: table snapshots, the delta log, and the Loader /
Store interfaces (the port of ``gubernator_tpu/store.py``, numpy only).

The reference never persists by default; ``Loader`` (startup/shutdown
snapshot) and ``Store`` (continuous write-through) are embedding hooks the
server wires when asked (reference store.go:49-78, workers.go:335-540):

* snapshot = one device-to-host copy of the whole packed-row table
  (Table2.rows) written to disk; restore = one host-to-device copy.
* Store = a host-side write-through hook with the reference's full
  contract (store.go:63-78, algorithms.go:45-51): after every dispatch
  ``on_change`` receives the per-key stored state (algo / status / limit /
  remaining / reset / duration / burst / stamp), and on a device-reported
  cache miss the engine consults ``get_many`` and re-hydrates found
  entries into the table before the decision stands. Keys are
  fingerprints (raw keys never reach the device, hashing.py).

Delta logs and their tombstone frames are byte-identical to the JAX
package's; a snapshot holds byte-identical array members (its zip container
stamps the write time). Each package reads the other's files.
"""

from __future__ import annotations

import os
import struct
import tempfile
import zlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

SNAPSHOT_MAGIC = "GUBTPU1"


def save_snapshot(path: str, rows: np.ndarray, epoch: int = 0,
                  layout_name: str = "full") -> None:
    """Atomically write a table snapshot (tmp + rename, so a crash mid-write
    never leaves a torn file for the next boot). `epoch` records the last
    checkpoint epoch the snapshot includes (0 on the classic full-snapshot
    path) so warm restart can skip already-compacted delta frames.
    `layout_name` records the slot layout the rows bytes are in
    (ops/layout.py) — "full" writes a file byte-identical to the
    pre-layout format."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".gubtpu-snap-")
    try:
        with os.fdopen(fd, "wb") as f:
            extra = {}
            if layout_name != "full":
                # only non-default layouts write the key: full snapshots
                # stay byte-identical to every pre-layout file
                extra["layout"] = np.frombuffer(
                    layout_name.encode(), dtype=np.uint8
                )
            np.savez_compressed(f, magic=np.frombuffer(
                SNAPSHOT_MAGIC.encode(), dtype=np.uint8
            ), rows=rows, epoch=np.int64(epoch), **extra)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_snapshot(path: str) -> np.ndarray:
    with np.load(path) as z:
        magic = bytes(z["magic"]).decode()
        if magic != SNAPSHOT_MAGIC:
            raise ValueError(f"{path}: not a gubernator-tpu snapshot")
        return z["rows"]


def load_snapshot_meta(path: str) -> "Tuple[np.ndarray, int, str]":
    """(rows, epoch, layout_name) — epoch is 0 and layout "full" for
    snapshots written before the respective planes existed."""
    with np.load(path) as z:
        magic = bytes(z["magic"]).decode()
        if magic != SNAPSHOT_MAGIC:
            raise ValueError(f"{path}: not a gubernator-tpu snapshot")
        epoch = int(z["epoch"]) if "epoch" in z.files else 0
        layout = (
            bytes(z["layout"]).decode() if "layout" in z.files else "full"
        )
        return z["rows"], epoch, layout


# ------------------------------------------------------------- delta log
#
# The incremental-checkpoint append log (docs/durability.md): CRC-framed
# packed slot rows — the table's own (N, F) int32 slot-field layout, the
# same raw-LE buffer format the TransferState handoff wire uses — appended
# beside the base snapshot by service/checkpoint.CheckpointManager. Warm
# restart replays base + frames through kernel2.merge2 (remaining=min,
# expiry=max, OVER sticks), so a torn tail, a duplicated frame, or a crash
# between compaction steps can only UNDER-grant, never over-grant.

DELTA_LOG_MAGIC = b"GUBTPUDL"  # 8-byte file header
FRAME_MAGIC = 0x46445547  # "GUDF" little-endian
# frame version doubles as the SLOT-LAYOUT byte: version = 1 + layout.code
# (ops/layout.py), so a full-layout frame is version 1 — byte-identical to
# every log written before packed layouts existed — and a reader that
# predates a layout refuses its frames (scan stops at the unknown version,
# the conservative prefix rule) instead of misparsing the rows.
FRAME_VERSION = 1
# frame header: magic u32, version u32, n_rows u32, epoch i64, now_ms i64,
# payload crc32 u32
_FRAME_HEADER = struct.Struct("<IIIqqI")
_SLOT_FIELDS = 16  # full-layout fields/row (VERSION 1); packed versions
# derive theirs from the layout registry

# TOMBSTONE frames (hot-set tiering, docs/tiering.md): a demote-on-idle
# removes a live row from HBM after shadowing it — without a removal
# record, warm-restart replay of an OLDER state frame would resurrect the
# row (harmless for admission — the resurrected bytes equal the shadowed
# copy and the fault-back merge is idempotent — but it silently undoes the
# demotion's capacity win and double-homes the state). A tombstone frame
# carries just the removed fingerprints ((N, 2) int32 lo/hi rows) and
# replays as tombstone_fps IN FILE ORDER, so state-frame → tombstone →
# later-state sequences resolve exactly. The version byte lives in its own
# range (0x40) — a pre-tiering reader stops its scan at the unknown
# version (the conservative prefix rule) instead of misparsing 8 B rows as
# 64 B slots.
TOMBSTONE_FRAME_VERSION = 0x40
_TOMBSTONE_FIELDS = 2


class _TombstoneKind:
    """Sentinel standing in the DeltaScan frame tuple's layout position
    for tombstone frames (the 4-tuple shape every consumer already
    unpacks stays intact; replay branches on identity)."""

    name = "tombstone"

    def __repr__(self):  # pragma: no cover - debugging nicety
        return "<tombstone-frame>"


TOMBSTONE = _TombstoneKind()


def _frame_layout(version: int):
    from gubernator_tpu_torch.ops.layout import layout_by_code

    if version == TOMBSTONE_FRAME_VERSION:
        return TOMBSTONE
    return layout_by_code(version - 1)


def fps_from_slots(slots: np.ndarray) -> np.ndarray:
    """Fingerprints encoded in packed slot rows (fields FP_LO/FP_HI — the
    0/1 position is a cross-layout invariant, ops/layout.py) — the reason
    delta frames need no separate fp column."""
    from gubernator_tpu_torch.ops.table2 import FP_HI, FP_LO

    lo = slots[:, FP_LO].astype(np.int64) & 0xFFFFFFFF
    hi = slots[:, FP_HI].astype(np.int64)
    return (hi << 32) | lo


def encode_delta_frame(epoch: int, now_ms: int, slots: np.ndarray,
                       layout=None) -> bytes:
    """One CRC-framed delta: header + raw little-endian (N, F_layout) int32
    slot rows — live rows of dirty blocks only, vs the base snapshot's
    every-slot-of-every-bucket. 64 B/row under the full layout, 32 B/row
    under the packed ones (the frame's version byte carries the layout)."""
    if layout is None:
        from gubernator_tpu_torch.ops.layout import FULL

        if slots.shape[1] != FULL.F:
            raise ValueError(
                "packed slot rows need an explicit layout for framing"
            )
        layout = FULL
    if slots.shape[1] != layout.F:
        raise ValueError(
            f"slot rows are {slots.shape[1]} fields wide but layout "
            f"{layout.name} has {layout.F}"
        )
    payload = np.ascontiguousarray(slots, dtype="<i4").tobytes()
    header = _FRAME_HEADER.pack(
        FRAME_MAGIC, 1 + layout.code, slots.shape[0], epoch, now_ms,
        zlib.crc32(payload),
    )
    return header + payload


def encode_tombstone_frame(epoch: int, now_ms: int,
                           fps: np.ndarray) -> bytes:
    """One CRC-framed tombstone record: removed fingerprints as (N, 2)
    int32 lo/hi rows under the dedicated version byte (see
    TOMBSTONE_FRAME_VERSION)."""
    fps = np.asarray(fps, dtype=np.int64)
    rows = np.empty((fps.shape[0], _TOMBSTONE_FIELDS), dtype=np.int32)
    lo = fps & 0xFFFFFFFF
    rows[:, 0] = np.where(lo >= (1 << 31), lo - (1 << 32), lo).astype(
        np.int32
    )
    rows[:, 1] = (fps >> 32).astype(np.int32)
    payload = np.ascontiguousarray(rows, dtype="<i4").tobytes()
    header = _FRAME_HEADER.pack(
        FRAME_MAGIC, TOMBSTONE_FRAME_VERSION, rows.shape[0], epoch, now_ms,
        zlib.crc32(payload),
    )
    return header + payload


class DeltaScan:
    """Result of reading a delta log: the valid frame prefix plus what (if
    anything) was skipped. A torn tail (crash mid-append) or a corrupt
    frame stops the scan — replaying a prefix is always safe under merge2
    semantics, while resynchronizing past a corrupt length field is not."""

    def __init__(self):
        # (epoch, now_ms, slots, layout) — slots in the frame's own
        # layout; tombstone frames carry (N, 2) fp rows with the
        # TOMBSTONE sentinel in the layout position
        self.frames: List[Tuple[int, int, np.ndarray, object]] = []
        self.skipped_bytes = 0
        self.clean_bytes = 0  # file prefix (log header + clean frames)
        self.error: Optional[str] = None

    @property
    def rows(self) -> int:
        return sum(f[2].shape[0] for f in self.frames)


def read_delta_frames(path: str) -> DeltaScan:
    """Scan a delta log: every complete, CRC-clean frame in order. Never
    raises on damage — a truncated or corrupt tail is recorded on the
    returned DeltaScan and the clean prefix is still usable."""
    scan = DeltaScan()
    if not os.path.exists(path):
        return scan
    with open(path, "rb") as f:
        head = f.read(len(DELTA_LOG_MAGIC))
        if head != DELTA_LOG_MAGIC:
            scan.error = "bad delta-log header"
            scan.skipped_bytes = os.path.getsize(path)
            return scan
        while True:
            pos = f.tell()
            scan.clean_bytes = pos
            hdr = f.read(_FRAME_HEADER.size)
            if not hdr:
                break  # clean end
            if len(hdr) < _FRAME_HEADER.size:
                scan.error = "truncated frame header"
                scan.skipped_bytes = os.path.getsize(path) - pos
                break
            magic, version, n_rows, epoch, now_ms, crc = _FRAME_HEADER.unpack(hdr)
            if magic != FRAME_MAGIC:
                scan.error = f"bad frame magic at offset {pos}"
                scan.skipped_bytes = os.path.getsize(path) - pos
                break
            try:
                layout = _frame_layout(version)
            except ValueError:
                scan.error = f"unknown frame version {version} at offset {pos}"
                scan.skipped_bytes = os.path.getsize(path) - pos
                break
            fields = (
                _TOMBSTONE_FIELDS if layout is TOMBSTONE else layout.F
            )
            payload = f.read(n_rows * fields * 4)
            if len(payload) < n_rows * fields * 4:
                scan.error = "truncated frame payload"
                scan.skipped_bytes = os.path.getsize(path) - pos
                break
            if zlib.crc32(payload) != crc:
                scan.error = f"frame CRC mismatch at offset {pos}"
                scan.skipped_bytes = os.path.getsize(path) - pos
                break
            slots = np.frombuffer(payload, dtype="<i4").reshape(
                n_rows, fields
            ).astype(np.int32)
            scan.frames.append((epoch, now_ms, slots, layout))
    return scan


class DeltaLog:
    """Append-only delta-frame log beside the base snapshot.

    `append` opens/writes/fsyncs per call (checkpoint cadence, not request
    cadence); `reset` atomically replaces the file with an empty header —
    compaction writes the new base FIRST (atomic rename), so a crash
    between the two steps leaves old deltas atop a newer base, which the
    conservative replay merge renders harmless (and the epoch filter skips
    outright)."""

    def __init__(self, path: str):
        self.path = path

    def append(self, epoch: int, now_ms: int, slots: np.ndarray,
               layout=None) -> int:
        """Append one frame; returns bytes written (header included).
        `layout` tags the slot rows' layout (full inferred for 16-field
        rows)."""
        frame = encode_delta_frame(epoch, now_ms, slots, layout=layout)
        fresh = not os.path.exists(self.path) or (
            os.path.getsize(self.path) == 0
        )
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        with open(self.path, "ab") as f:
            if fresh:
                f.write(DELTA_LOG_MAGIC)
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        return len(frame) + (len(DELTA_LOG_MAGIC) if fresh else 0)

    def append_tombstones(self, epoch: int, now_ms: int,
                          fps: np.ndarray) -> int:
        """Append one tombstone frame (demote-on-idle removals — see
        TOMBSTONE_FRAME_VERSION). Returns bytes written."""
        frame = encode_tombstone_frame(epoch, now_ms, fps)
        fresh = not os.path.exists(self.path) or (
            os.path.getsize(self.path) == 0
        )
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        with open(self.path, "ab") as f:
            if fresh:
                f.write(DELTA_LOG_MAGIC)
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        return len(frame) + (len(DELTA_LOG_MAGIC) if fresh else 0)

    def scan(self) -> DeltaScan:
        return read_delta_frames(self.path)

    def repair(self, scan: DeltaScan) -> None:
        """Truncate a damaged log to `scan`'s clean prefix, fsynced.

        Appends land at the physical end of the file, but the scan stops
        at the first bad frame — so without this, every frame written
        after a torn tail sits behind the damage where no replay can
        reach it until the next compaction. restore() repairs before
        serving so subsequent appends extend a scannable log. A prefix
        with no usable log header rewrites the log empty (atomically)
        instead."""
        if scan.skipped_bytes <= 0 or not os.path.exists(self.path):
            return
        if scan.clean_bytes < len(DELTA_LOG_MAGIC):
            self.reset()
            return
        with open(self.path, "r+b") as f:
            f.truncate(scan.clean_bytes)
            f.flush()
            os.fsync(f.fileno())

    def reset(self) -> None:
        """Truncate to an empty log (post-compaction), atomically."""
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".gubtpu-delta-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(DELTA_LOG_MAGIC)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def frame_count(self) -> int:
        return len(self.scan().frames)


@dataclass
class ChangeSet:
    """One dispatch's worth of state changes: parallel per-key arrays (one
    row per unique fingerprint, the LAST occurrence's state when a batch hits
    a key several times). The schema matches UpdatePeerGlobals installs —
    sufficient to reconstruct the item (reference store.go:29-43)."""

    fps: np.ndarray  # int64 fingerprints touched
    created_at: int  # dispatch timestamp (ms)
    algo: Optional[np.ndarray] = None  # int32 Algorithm per row
    status: Optional[np.ndarray] = None  # int32 UNDER/OVER_LIMIT
    limit: Optional[np.ndarray] = None  # int64
    remaining: Optional[np.ndarray] = None  # int64
    reset_time: Optional[np.ndarray] = None  # int64 ms
    duration: Optional[np.ndarray] = None  # int64 ms
    burst: Optional[np.ndarray] = None  # int64 (leaky burst; limit default)
    stamp: Optional[np.ndarray] = None  # int64 ms item UpdatedAt/CreatedAt


class Store:
    """Write-through hook interface (reference store.go:63-78). Subclass and
    pass to LocalEngine/daemon wiring. `on_change` fires after every dispatch
    with per-key stored state; `get_many` is consulted for fingerprints the
    device reported as cache misses (evicted/expired/restart-lost) — found
    rows are re-hydrated into the table and the decision re-applied against
    them (reference algorithms.go:45-51). `remove` exists for interface
    parity; the engine never calls it (expiry is lazy on-device)."""

    def on_change(self, change: ChangeSet) -> None:  # pragma: no cover
        pass

    def get_many(self, fps: np.ndarray, now_ms: int):  # pragma: no cover
        """Return None (no hydration) or a dict of parallel arrays over
        `fps`: {found: bool, algo, status, limit, remaining, reset_time,
        duration} — rows with found=False are ignored."""
        return None

    def remove(self, fp: int) -> None:  # pragma: no cover
        pass


class Loader:
    """Startup/shutdown snapshot interface (reference store.go:49-60)."""

    def load(self) -> Optional[np.ndarray]:  # pragma: no cover
        """Return table rows to restore, or None."""
        return None

    def save(self, rows: np.ndarray) -> None:  # pragma: no cover
        pass


class FileLoader(Loader):
    """Loader backed by a snapshot file — what GUBER_CHECKPOINT_PATH wires."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> Optional[np.ndarray]:
        if os.path.exists(self.path):
            return load_snapshot(self.path)
        return None

    def save(self, rows: np.ndarray, layout_name: str = "full") -> None:
        save_snapshot(self.path, rows, layout_name=layout_name)


class MemoryLoader(Loader):
    """In-memory Loader for tests/embedders (the MockLoader analog, reference
    store.go:80-109): `save()` keeps the snapshot on the instance; a new
    daemon restoring from it continues the old counts."""

    def __init__(self, rows: Optional[np.ndarray] = None):
        self.rows = rows
        self.load_called = 0
        self.save_called = 0

    def load(self) -> Optional[np.ndarray]:
        self.load_called += 1
        return self.rows

    def save(self, rows: np.ndarray) -> None:
        self.save_called += 1
        self.rows = rows


class RecordingStore(Store):
    """Write-through Store that records every ChangeSet (the MockStore
    analog, reference store.go:111-150)."""

    def __init__(self):
        self.changes: list = []

    def on_change(self, change: ChangeSet) -> None:
        self.changes.append(change)

    @property
    def touched_fps(self) -> set:
        return {int(fp) for c in self.changes for fp in c.fps}


class DictStore(Store):
    """Durable-store mock with the FULL reference contract (store.go:80-150):
    `on_change` writes per-key state through to a host dict, `get_many`
    serves it back for evicted/lost keys. Tests and embedders use this to
    exercise evict-then-rehydrate (reference store_test.go:127)."""

    def __init__(self):
        # fp → (algo, status, limit, remaining, reset, duration, burst, stamp)
        self.rows: dict = {}
        self.get_calls = 0
        self.hydrated = 0

    def on_change(self, change: ChangeSet) -> None:
        for i in range(change.fps.shape[0]):
            self.rows[int(change.fps[i])] = (
                int(change.algo[i]),
                int(change.status[i]),
                int(change.limit[i]),
                int(change.remaining[i]),
                int(change.reset_time[i]),
                int(change.duration[i]),
                int(change.burst[i]),
                int(change.stamp[i]),
            )

    def get_many(self, fps: np.ndarray, now_ms: int):
        self.get_calls += 1
        n = fps.shape[0]
        found = np.zeros(n, dtype=bool)
        cols = np.zeros((8, n), dtype=np.int64)
        for i in range(n):
            row = self.rows.get(int(fps[i]))
            if row is not None:
                found[i] = True
                cols[:, i] = row
        if not found.any():
            return None
        self.hydrated += int(found.sum())
        return dict(
            found=found,
            algo=cols[0].astype(np.int32),
            status=cols[1].astype(np.int32),
            limit=cols[2],
            remaining=cols[3],
            reset_time=cols[4],
            duration=cols[5],
            burst=cols[6],
            stamp=cols[7],
        )

    def remove(self, fp: int) -> None:
        self.rows.pop(int(fp), None)
