"""The mesh engine: the key table sharded over the mesh's devices (the port
of the check path of ``gubernator_tpu/parallel/sharded.py``).

Gubernator spreads keys over cluster nodes with a consistent-hash ring and
forwards each request to its owner (replicated_hash.go, peer_client.go).
Here every mesh device holds one shard of the table, each fingerprint's
owner is ``mesh.shard_of``, and one dispatch decides on every shard.

Batches travel as ONE (D, 12, b) int64 ingress grid — or the (D, 5, b+1)
int32 compact grid (ops/wire.py) — and come back as ONE (D, b+2, 4) output
grid: b response rows per shard, then the shard's two stats rows.

Two routing modes (``route=``, GUBER_SHARD_ROUTE):

* "host": the host sorts rows by owning shard into the ownership grid
  (``_route_plan``); the exact-sequential fallback and the CPU default;
* "device" (the card's default): rows ship in arrival order and the shards
  route them with a capacity-bounded all-to-all (parallel/a2a.py, whose
  exchange is the hand-written kernel ``csrc/ring_exchange.cu``). Rows past
  a pair's capacity come back dropped and unprocessed and are re-dispatched;
  the last retry (depth 2) routes on the host, which has no capacity to
  exceed.

Two dedup modes (``dedup=``, GUBER_SHARD_DEDUP) decide where the decide's
unique-fingerprint contract is met:

* "host": the pass planner's group-by (ops/plan.plan_passes), exact
  per-occurrence sequential semantics; the CPU default;
* "device" (the card's default): duplicates aggregate in the dispatch
  (kernel2.dedup_packed_cols) and the host plans O(1) (plan.single_pass).

The JAX package's donation machinery is XLA's and has no counterpart here:
no ``_staging_donate``, no recycled egress buffers (``_take_egress`` /
``_recycle_egress``), no ``_StagingPool`` (it exists there to dodge the
CPU's zero-copy aliasing of donated buffers), no concurrent per-shard puts.
A staged grid leaves pinned host memory with ``non_blocking`` copies, as
``LocalEngine`` stages, and tables update in place.

The mesh is one process driving its devices; shard d's tensors live on
``mesh.devices[d]``. Ported here: check / check_columns, the pipelined
stage_pass / issue_staged / finish_staged hooks of ops/engine.py's
prepare / issue / finish, and the peer plane and maintenance surface the
service runner calls: ``install_columns`` (owner-routed, one install per
shard), the handoff reads and writes (``extract_live``, ``merge_rows``
also with ``collect=True``, ``read_state`` also raw, ``tombstone_fps``),
incremental checkpoints (``ckpt``, ``checkpoint_begin`` /
``checkpoint_finish``), the idle sweep's read (``extract_idle``), the
telemetry scan (``telemetry_begin``, parallel/telemetry.py), snapshot /
restore (the JAX package's (D, NB, 128) int32 layout, byte for byte),
live_count, layout migration and the stage, wire and overflow counters.
Every per-shard step runs the single-device function of ops/ on the
shard's own tensors; rows are routed to their owners on the host
(``_route_plan``), so row order inside a shard is the JAX package's.
A mesh table is sized at construction: ``maybe_grow`` is always False.
The GLOBAL behavior (replica tables, collective sync) is
parallel/global_sync.py, built on this engine. ``store=`` takes the Store
write-through and miss rehydrate of ops/engine.serve_columns; a ``shadow``
set on the engine takes the tiering fault-back (no evictee sidecar on a
mesh, as in the JAX package).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.ops import wire as wire_mod
from gubernator_tpu_torch.ops.batch import (
    ERROR_STRINGS,
    HostBatch,
    RequestColumns,
    ResponseColumns,
    columns_from_requests,
    pack_host_batch,
)
from gubernator_tpu_torch.ops.engine import (
    EngineStats,
    _pad_size,
    _to_device,
    batch_needs_full_layout,
    default_write_mode,
    effective_math,
    ms_now,
    serve_columns,
)
from gubernator_tpu_torch.ops.batch import InstallBatch
from gubernator_tpu_torch.ops.checkpoint import _extract_blocks_core
from gubernator_tpu_torch.ops.kernel2 import (
    FLAG_DROPPED,
    FLAG_HIT,
    FLAG_MEMBER,
    FLAG_STATUS,
    FLAG_UNPROCESSED,
    decide2_packed_cols_impl,
    decide2_packed_dedup_impl,
    install2_impl,
    merge2_impl,
)
from gubernator_tpu_torch.ops.layout import FULL, resolve_layout
from gubernator_tpu_torch.ops.plan import (
    _subset,
    default_probe_kernel,
    default_walk_kernel,
    plan_passes,
    single_pass,
)
from gubernator_tpu_torch.ops.table2 import (
    F as F_FULL,
    FLAGS,
    Table2,
    _extract_idle_core,
    _extract_sorted,
    _fetch_prefix,
    gather_slots_impl,
    live_count2,
    new_table2,
    table_to_numpy,
    tombstone_rows_impl,
)
from gubernator_tpu_torch.parallel.a2a import make_a2a_decide
from gubernator_tpu_torch.parallel.mesh import Mesh, devices_per_host, mesh_hosts, shard_of
from gubernator_tpu_torch.parallel.ring import a2a_impl
from gubernator_tpu_torch.types import RateLimitRequest, RateLimitResponse


def _knob(name: str, device) -> str:
    v = os.environ.get(name, "auto")
    if v not in ("auto", "host", "device"):
        raise ValueError(f"{name} must be auto, host or device, got {v!r}")
    if v != "auto":
        return v
    return "device" if torch.device(device).type == "cuda" else "host"


def default_shard_route(device="cuda") -> str:
    """GUBER_SHARD_ROUTE, auto by default: "device" (the a2a exchange) when
    the mesh is on the card, "host" on the CPU."""
    return _knob("GUBER_SHARD_ROUTE", device)


def default_shard_dedup(device="cuda") -> str:
    """GUBER_SHARD_DEDUP, auto by default: "device" (in-dispatch
    aggregation) on the card, "host" (the planner's exact per-occurrence
    passes) on the CPU."""
    return _knob("GUBER_SHARD_DEDUP", device)


def make_sharded_decide(mesh: Mesh, math: str = "mixed", write: Optional[str] = None,
                        dedup: bool = False, wire: bool = False, probe: str = "xla"):
    """The decide on the host-routed grid: fn(tables, blocks, shards) →
    (tables, outs), block i being shard shards[i]'s (12, b) int64 block —
    or its (5, b+1) int32 compact block with `wire` — and outs[i] its
    (b+2, 4) output; `shards` defaults to every shard. With `dedup`,
    duplicates aggregate in the dispatch (the host grid puts every
    duplicate on its owner)."""
    write = write or default_write_mode()
    if wire:
        impl = wire_mod.decide2_wire_dedup_impl if dedup else wire_mod.decide2_wire_cols_impl
    else:
        impl = decide2_packed_dedup_impl if dedup else decide2_packed_cols_impl

    def fn(tables: List[Table2], blocks: Sequence[torch.Tensor],
           shards: Optional[Sequence[int]] = None):
        outs = []
        for i, d in enumerate(range(mesh.size) if shards is None else shards):
            tables[d], packed = impl(tables[d], blocks[i], write=write, math=math, probe=probe)
            outs.append(packed)
        return tables, outs

    return fn


def new_sharded_table(mesh: Mesh, capacity_per_shard: int, layout=None) -> List[Table2]:
    """One empty table of `capacity_per_shard` slots per mesh device."""
    return [new_table2(capacity_per_shard, layout=layout, device=d) for d in mesh.devices]


def sharded_table_from_numpy(rows: np.ndarray, mesh: Mesh, layout=None) -> List[Table2]:
    """Shard tables whose bytes are exactly `rows`, a (D, NB, K·F) int32
    array — the layout of the JAX package's ``ShardedEngine.snapshot()``."""
    rows = np.asarray(rows)
    if rows.dtype != np.int32 or rows.ndim != 3 or rows.shape[0] != mesh.size:
        raise ValueError(f"rows must be a ({mesh.size}, NB, row) int32 array, "
                         f"got {rows.dtype} {rows.shape}")
    return [
        Table2(rows=torch.from_numpy(np.array(rows[d], order="C", copy=True)).to(dev),
               layout=layout)
        for d, dev in enumerate(mesh.devices)
    ]


def _fetch(out) -> np.ndarray:
    """(S, rows+2, 4) host array of a dispatch's output over its S staged
    shards (one tensor, or a list when they lie on several devices; already
    numpy after a fused pipelined fetch)."""
    if isinstance(out, np.ndarray):
        return out
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.stack([o.cpu().numpy() for o in out])


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


class ShardedTable:
    """The shard tables seen as the JAX package's one stacked table, for
    callers that read ``engine.table`` (the service runner reads its
    layout): per-shard geometry, as JAX's (D, NB, row) Table2 reports it."""

    __slots__ = ("shards",)

    def __init__(self, shards: List[Table2]):
        self.shards = shards

    @property
    def layout(self):
        return self.shards[0].layout

    @property
    def n_buckets(self) -> int:
        return self.shards[0].n_buckets

    @property
    def capacity(self) -> int:
        return self.shards[0].capacity


class ShardedEngine:
    """The multi-device counterpart of LocalEngine: one table shard per mesh
    device, fed through one engine object."""

    supports_pipeline = True  # the prepare / issue / finish split
    # a mesh is sized at construction: the daemon starts no growth loop
    supports_grow = False
    # routed and exchanged rows lose batch order: cascade verdicts fold on
    # the host (engine._fold_cascades_host)
    supports_cascade_intrace = False

    def __init__(
        self,
        mesh: Mesh,
        capacity_per_shard: int = 50_000,
        max_exact_passes: int = 8,
        created_at_tolerance_ms=None,
        store=None,
        route: Optional[str] = None,
        write_mode: Optional[str] = None,
        dedup: Optional[str] = None,
        wire: Optional[str] = None,
        a2a: Optional[str] = None,
        layout: Optional[str] = None,
        probe: Optional[str] = None,
        walk: Optional[str] = None,
    ):
        dev0 = mesh.devices[0]
        route = route or default_shard_route(dev0)
        if route not in ("host", "device"):
            raise ValueError(f"route must be 'host' or 'device', got {route!r}")
        dedup = dedup or default_shard_dedup(dev0)
        if dedup not in ("host", "device"):
            raise ValueError(f"dedup must be 'host' or 'device', got {dedup!r}")
        if wire is not None and wire not in ("compact", "full"):
            raise ValueError(f"wire must be 'compact' or 'full', got {wire!r}")
        if probe is not None and probe not in ("xla", "pallas"):
            raise ValueError(f"probe must be 'xla' or 'pallas', got {probe!r}")
        if walk is not None and walk not in ("xla", "pallas"):
            raise ValueError(f"walk must be 'xla' or 'pallas', got {walk!r}")
        self.mesh = mesh
        self.created_at_tolerance_ms = created_at_tolerance_ms
        self.n_shards = mesh.size
        # pod topology, host rows × devices per host (introspection only)
        self.n_hosts = mesh_hosts(mesh)
        self.devices_per_host = devices_per_host(mesh)
        # the exchange schedule of route="device" dispatches (parallel/ring.py)
        self.a2a_impl = a2a_impl(a2a, dev0)
        self.tables = new_sharded_table(mesh, capacity_per_shard, layout=resolve_layout(layout))
        self.route = route
        self.dedup = dedup
        self.write_mode = write_mode or default_write_mode()
        if self.write_mode not in ("sweep", "sparse", "xla"):
            raise ValueError(
                f"write_mode must be 'sweep', 'sparse' or 'xla', got {self.write_mode!r}"
            )
        self.probe_mode = probe or default_probe_kernel()
        # the install / merge walks (GUBER_WALK_KERNEL), per shard
        self.walk_mode = walk or default_walk_kernel()
        self.wire = wire or wire_mod.default_wire_mode(dev0)
        self.max_exact_passes = max_exact_passes
        # the write-through hook (store.Store): serve_columns fires its
        # ChangeSet and rehydrates misses through this engine's dispatch
        self.store = store
        self.stats = EngineStats()
        # incremental-checkpoint epoch tracker (ops/checkpoint.EpochTracker
        # with n_shards = D), attached by the checkpoint service
        self.ckpt = None
        # hot-set tiering (tier.ShadowTable), set by the caller as an
        # attribute: a mesh takes part through the idle sweep (extract_idle
        # + tombstone_fps) and the fault-back through the routed
        # merge_rows(collect=True). Its routed dispatches carry no evictee
        # sidecar, as in the JAX package
        self.shadow = None
        self.last_dispatch_rows = 0
        # set, with its reason, when a failed collective launch left the
        # tables suspect (the daemon's health check reads it)
        self.poisoned: Optional[str] = None
        # host staging cost, ms per stage (wire_pack / wire_decode: the
        # compact codec; 0 on full-width dispatches)
        self.stage_ms = {"route": 0.0, "pack": 0.0, "put": 0.0, "wire_pack": 0.0,
                         "wire_decode": 0.0}
        self._stage_taken = dict(self.stage_ms)
        self._stage_lock = threading.Lock()  # stage_pass may run on prepare threads
        # bytes over the host↔device boundary on the decide path
        self.wire_bytes = {"put": 0, "fetch": 0}
        self._wire_taken = dict(self.wire_bytes)
        # rows the exchange capacity-dropped before any decide saw them,
        # counted at every depth
        self.a2a_overflow = 0
        self._a2a_overflow_taken = 0

    @property
    def layout(self):
        return self.tables[0].layout

    @property
    def table(self) -> ShardedTable:
        """The primary shards as one table (``engine.table.layout``)."""
        return ShardedTable(self.tables)

    def check(self, requests: Sequence[RateLimitRequest],
              now_ms: Optional[int] = None) -> List[RateLimitResponse]:
        """Object API over check_columns, as the JAX package's mesh engine
        has it."""
        if not requests:
            return []
        rc = self.check_columns(columns_from_requests(requests), now_ms=now_ms)
        return [
            RateLimitResponse(
                status=int(rc.status[i]), limit=int(rc.limit[i]),
                remaining=int(rc.remaining[i]), reset_time=int(rc.reset_time[i]),
                error=ERROR_STRINGS[int(rc.err[i])],
            )
            for i in range(len(requests))
        ]

    def check_columns(self, cols: RequestColumns,
                      now_ms: Optional[int] = None) -> ResponseColumns:
        def dispatch(pass_batch, n_rows: int, cascade: bool = False):
            _, vals = self._dispatch(pass_batch)
            return vals

        return serve_columns(self, cols, now_ms, dispatch)

    def plan(self, hb: HostBatch):
        """The pass plan (engine._plan hook): O(1) when duplicates aggregate
        in the dispatch, the host group-by otherwise."""
        if self.dedup == "device":
            return single_pass(hb)
        return plan_passes(hb, max_exact=self.max_exact_passes)

    def _mark_dirty(self, fps) -> None:
        """Checkpoint hook: mark the touched fingerprints' (shard, block)
        pairs dirty, on the engine thread, in the job of the mutation."""
        if self.ckpt is not None:
            self.ckpt.mark(np.asarray(fps))

    # -------------------------------------------- staging cost accounting

    def _stage_time(self, key: str, dt_s: float) -> None:
        with self._stage_lock:
            self.stage_ms[key] += dt_s * 1e3

    def take_stage_deltas(self) -> Dict[str, float]:
        """Host staging ms per stage since the last take."""
        with self._stage_lock:
            d = {k: self.stage_ms[k] - self._stage_taken[k] for k in self.stage_ms}
            self._stage_taken = dict(self.stage_ms)
        return d

    def _wire_count(self, direction: str, nbytes: int) -> None:
        with self._stage_lock:
            self.wire_bytes[direction] += int(nbytes)

    def take_wire_deltas(self) -> Dict[str, int]:
        """Bytes over the host↔device boundary per direction since the last
        take."""
        with self._stage_lock:
            d = {k: self.wire_bytes[k] - self._wire_taken[k] for k in self.wire_bytes}
            self._wire_taken = dict(self.wire_bytes)
        return d

    def take_a2a_overflow_delta(self) -> "tuple[str, int]":
        """(exchange impl, overflow rows since the last take)."""
        with self._stage_lock:
            d = self.a2a_overflow - self._a2a_overflow_taken
            self._a2a_overflow_taken = self.a2a_overflow
        return self.a2a_impl, d

    # ------------------------------------------------------------ peer plane

    def _routed(self, fps: np.ndarray):
        """The owner-routed grid plan of `fps`: (order, shard of each sorted
        row, position in its block, padded per-shard width)."""
        return _route_plan(shard_of(fps, self.n_shards), self.n_shards)

    def install_columns(
        self,
        fp: np.ndarray,
        algo: np.ndarray,
        status: np.ndarray,
        limit: np.ndarray,
        remaining: np.ndarray,
        reset_time: np.ndarray,
        duration: np.ndarray,
        now_ms: Optional[int] = None,
        burst: Optional[np.ndarray] = None,
        stamp: Optional[np.ndarray] = None,
        aux: Optional[np.ndarray] = None,
        rem_store: Optional[np.ndarray] = None,
    ) -> int:
        """Install owner-authoritative GLOBAL statuses, each on its owning
        shard (the UpdatePeerGlobals receive path; cf.
        LocalEngine.install_columns). Returns the number installed."""
        now = now_ms if now_ms is not None else ms_now()
        n = fp.shape[0]
        if n == 0:
            return 0
        if burst is None:
            burst = np.asarray(limit, dtype=np.int64)
        if stamp is None:
            stamp = np.full(n, now, dtype=np.int64)
        if not self.layout.supports_algos(algo):
            self.migrate_layout_full("install of off-family algorithms")
        self._mark_dirty(fp)
        D = self.n_shards
        order, rs, offset, b_local = self._routed(fp)

        def grid(field, dtype):
            return self._put_grid(_to_grid(np.asarray(field)[order].astype(dtype), rs, offset,
                                           D, b_local))

        cols = dict(
            fp=grid(fp, np.int64), algo=grid(algo, np.int32), status=grid(status, np.int32),
            limit=grid(limit, np.int64), remaining=grid(remaining, np.int64),
            reset_time=grid(reset_time, np.int64), duration=grid(duration, np.int64),
            now=grid(np.full(n, now, dtype=np.int64), np.int64),
            active=grid(np.ones(n, dtype=bool), bool), burst=grid(burst, np.int64),
            stamp=grid(stamp, np.int64),
            aux=None if aux is None else grid(aux, np.int64),
            rem_store=None if rem_store is None else grid(rem_store, np.int64),
        )
        installed = []
        for d in range(D):
            inst = InstallBatch(**{k: (None if v is None else v[d]) for k, v in cols.items()})
            self.tables[d], done = install2_impl(self.tables[d], inst, write=self.write_mode,
                                                 probe=self.walk_mode)
            installed.append(done)
        self.stats.dispatches += 1
        return int(sum(int(x.sum()) for x in installed))

    # ------------------------------------------------- maintenance surface

    def snapshot(self) -> np.ndarray:
        """(D, NB, row) int32 host copy of every shard, the JAX package's
        snapshot layout."""
        return np.stack([table_to_numpy(t) for t in self.tables])

    def restore(self, rows: np.ndarray, layout=None) -> None:
        """Restore a snapshot (this engine's or the JAX package's). A
        snapshot written under another slot layout converts through the
        canonical full row when the bucket geometry matches. A restore
        marks every checkpoint block dirty."""
        lay = self.layout
        rows = np.asarray(rows)
        shape = (self.n_shards,) + tuple(self.tables[0].rows.shape)
        if layout is not None and layout is not lay:
            if rows.shape[:-1] != shape[:-1]:
                raise ValueError(f"snapshot geometry {rows.shape} incompatible with table {shape}")
            full = layout.unpack_rows(torch.from_numpy(np.ascontiguousarray(rows)))
            rows = lay.pack_rows(full).numpy()
        if rows.shape != shape:
            raise ValueError(f"snapshot shape {rows.shape} != table {shape}")
        self.tables = sharded_table_from_numpy(rows.astype(np.int32, copy=False), self.mesh,
                                               layout=lay)
        if self.ckpt is not None:
            # state of unknown provenance: the next epoch captures it all
            self.ckpt.mark_all()

    def live_count(self, now_ms: Optional[int] = None) -> int:
        now = now_ms if now_ms is not None else ms_now()
        return sum(live_count2(t, now) for t in self.tables)

    def migrate_layout_full(self, reason: str = "off-family traffic") -> bool:
        """Migrate every shard to the canonical full layout in place (engine
        thread only). Returns True when a migration happened."""
        if self.layout is FULL:
            return False
        self._tables_to_full(self.tables, reason)
        return True

    def _tables_to_full(self, tables: List[Table2], reason: str = "off-family traffic") -> None:
        """Unpack a list of shard tables to the full layout, element by
        element (the list object stays the caller's)."""
        logging.getLogger("gubernator_tpu_torch.engine").warning(
            "migrating sharded table layout %s -> full (%s)", tables[0].layout.name, reason
        )
        for d, t in enumerate(tables):
            tables[d] = Table2(rows=t.layout.unpack_rows(t.rows).contiguous(), layout=FULL)
        self.stats.layout_migrations += 1

    # ----------------------------------------------------------- handoff
    # The LocalEngine surface: the shards do the whole-table passes, the
    # host stages only the transferred rows.

    def extract_live(self, now_ms: Optional[int] = None):
        """Every live slot as (fps (N,) int64, slots (N, F) int32), shard by
        shard in table order (JAX's stable sort over the shard-major
        stacked table gives the same order), in the table's own layout."""
        now = now_ms if now_ms is not None else ms_now()
        lay = self.layout
        parts = [_extract_sorted(t.rows, now, layout=lay) for t in self.tables]
        return _concat_prefixes([_fetch_prefix(s, f, int(c), lay.F) for s, f, c in parts],
                                lay.F)

    def _slots_to_full(self, slots: np.ndarray, layout=None) -> np.ndarray:
        """Incoming slot rows in the canonical full layout (cf.
        LocalEngine._slots_to_full: the same inference rules)."""
        if layout is None:
            if slots.shape[1] == FULL.F:
                layout = FULL
            elif slots.shape[1] == self.layout.F:
                layout = self.layout
            else:
                raise ValueError(f"cannot infer slot layout for width {slots.shape[1]}")
        return layout.unpack(torch.from_numpy(np.ascontiguousarray(slots, np.int32))).numpy()

    def merge_rows(
        self, fps: np.ndarray, slots: np.ndarray,
        now_ms: Optional[int] = None, layout=None, collect: bool = False,
    ):
        """Conservatively merge transferred slot rows, each on its owning
        shard (cf. LocalEngine.merge_rows): repeated fingerprints merge as
        sequential passes by occurrence rank. ``collect=True`` (unique
        fingerprints only) returns (count, merged mask, evictee fps,
        evictee canonical rows)."""
        from gubernator_tpu_torch.ops.engine import _occurrence_rank

        n = fps.shape[0]
        if n == 0:
            if collect:
                return 0, np.zeros(0, dtype=bool), np.empty(0, dtype=np.int64), \
                    np.empty((0, 16), dtype=np.int32)
            return 0
        slots = self._slots_to_full(slots, layout)
        rank = _occurrence_rank(fps)
        if rank.max() > 0:
            if collect:
                raise ValueError("merge_rows(collect=True) requires unique fingerprints")
            return sum(
                self.merge_rows(fps[rank == r], slots[rank == r], now_ms)
                for r in range(int(rank.max()) + 1)
            )
        if not self.layout.supports_algos(slots[:, FLAGS] & 0xFF):
            self.migrate_layout_full("merge of off-family rows")
        now = now_ms if now_ms is not None else ms_now()
        self._mark_dirty(fps)
        D = self.n_shards
        order, rs, offset, b_local = self._routed(fps)
        fp_g = _to_grid(fps[order].astype(np.int64), rs, offset, D, b_local)
        now_g = np.full((D, b_local), now, dtype=np.int64)
        act_g = _to_grid(np.ones(n, dtype=bool), rs, offset, D, b_local)
        slots_g = np.zeros((D, b_local, slots.shape[1]), dtype=np.int32)
        slots_g[rs, offset] = slots[order]
        fp_d, slots_d, now_d, act_d = [self._put_grid(g) for g in (fp_g, slots_g, now_g, act_g)]
        merged, ev = [], []
        for d in range(D):
            out = merge2_impl(self.tables[d], fp_d[d], slots_d[d], now_d[d], act_d[d],
                              write=self.write_mode, evictees=collect, probe=self.walk_mode)
            self.tables[d] = out[0]
            merged.append(out[1])
            if collect:
                ev.append(out[2])
        self.stats.dispatches += 1
        if collect:
            merged_h = np.stack([_host(m) for m in merged])
            mask = np.zeros(n, dtype=bool)
            mask[order] = merged_h[rs, offset]
            ev_h = np.concatenate([_host(e) for e in ev])
            ev_fp = (ev_h[:, 1].astype(np.int64) << 32) | (ev_h[:, 0].astype(np.int64)
                                                            & 0xFFFFFFFF)
            keep = ev_fp != 0
            return int(mask.sum()), mask, ev_fp[keep], ev_h[keep].copy()
        return int(sum(int(m.sum()) for m in merged))

    def read_state(self, fps: np.ndarray, raw: bool = False):
        """(found (n,) bool, slots (n, 16) int32 canonical fields) of `fps`,
        each read on its owning shard without mutating anything; with
        ``raw=True`` the slots are re-packed into the table's own layout.
        Expiry is not checked."""
        lay = self.layout
        n = fps.shape[0]
        if n == 0:
            width = lay.F if raw else F_FULL
            return np.zeros(0, dtype=bool), np.zeros((0, width), dtype=np.int32)
        D = self.n_shards
        order, rs, offset, b_local = self._routed(fps)
        fp_g = self._put_grid(_to_grid(fps[order].astype(np.int64), rs, offset, D, b_local))
        act_g = self._put_grid(_to_grid(np.ones(n, dtype=bool), rs, offset, D, b_local))
        got = [gather_slots_impl(t.rows, fp_g[d], act_g[d], lay) for d, t in enumerate(self.tables)]
        slots_h = np.stack([_host(s) for s, _f in got])
        found_h = np.stack([_host(f) for _s, f in got])
        slots = np.zeros((n, F_FULL), dtype=np.int32)
        found = np.zeros(n, dtype=bool)
        slots[order] = slots_h[rs, offset]
        found[order] = found_h[rs, offset]
        if raw:
            slots = lay.pack(slots)
        return found, slots

    def tombstone_fps(self, fps: np.ndarray) -> int:
        """Zero the slots holding `fps`, each on its owning shard. Missing
        fingerprints are no-ops; returns the number removed."""
        n = fps.shape[0]
        if n == 0:
            return 0
        self._mark_dirty(fps)
        D = self.n_shards
        order, rs, offset, b_local = self._routed(fps)
        fp_g = self._put_grid(_to_grid(fps[order].astype(np.int64), rs, offset, D, b_local))
        act_g = self._put_grid(_to_grid(np.ones(n, dtype=bool), rs, offset, D, b_local))
        found = [tombstone_rows_impl(t.rows, fp_g[d], act_g[d]) for d, t in enumerate(self.tables)]
        self.stats.dispatches += 1
        return int(sum(int(f.sum()) for f in found))

    # ------------------------------------------------------- checkpointing
    # LocalEngine's begin / finish split, the extract run per shard: the
    # tracker's global block ids (shard-major: gid = shard · nblk + local)
    # regroup into per-shard local block lists.

    def checkpoint_begin(self, gids: np.ndarray, now_ms: Optional[int] = None):
        """Launch half of a dirty-block checkpoint extract (engine thread)."""
        now = now_ms if now_ms is not None else ms_now()
        blk, nblk = self.ckpt.blk, self.ckpt.nblk
        D = self.n_shards
        shard = gids // nblk
        local = gids % nblk
        counts = np.bincount(shard, minlength=D)
        G = _pad_size(int(max(counts.max(), 1)), floor=8)
        bidx = np.full((D, G), nblk, dtype=np.int64)  # sentinel: zero rows
        order = np.argsort(shard, kind="stable")
        rs = shard[order]
        offset = np.arange(gids.shape[0]) - np.searchsorted(rs, rs)
        bidx[rs, offset] = local[order]
        # per shard (slots live-first, fp, live count); no slot row leaves
        # its shard, the finish fetches per-shard live prefixes
        bidx_d = self._put_grid(bidx)
        return [_extract_blocks_core(t.rows, bidx_d[d], int(now), blk, self.layout)
                for d, t in enumerate(self.tables)]

    def checkpoint_finish(self, pending):
        """Fetch half (any thread): per-shard live prefixes, concatenated
        shard by shard."""
        F = self.layout.F
        return _concat_prefixes(
            [_fetch_prefix(s, f, int(c), int(s.shape[-1])) for s, f, c in pending], F)

    # ------------------------------------------------------------- tiering

    def extract_idle(self, now_ms: int, idle_ms: int, max_rows: int = 1 << 16):
        """Live rows idle past `idle_ms` on every shard: (fps (N,) int64,
        slots (N, F) int32), N ≤ max_rows. The filter runs per shard; the
        cap takes shards in order, and the rest waits for the next sweep."""
        lay = self.layout
        got = [_extract_idle_core(t.rows, int(now_ms), int(idle_ms), lay) for t in self.tables]
        parts, left = [], int(max_rows)
        for s, f, c in got:
            n = min(int(c), left)
            if n <= 0:
                continue
            parts.append(_fetch_prefix(s, f, n, lay.F))
            left -= n
        return _concat_prefixes(parts, lay.F)

    # ----------------------------------------------------------- telemetry

    def telemetry_begin(self, now_ms: Optional[int] = None):
        """Launch the per-shard telemetry scan without fetching
        (parallel/telemetry.py); its snapshot also carries per-shard live
        counts."""
        from gubernator_tpu_torch.parallel.telemetry import sharded_scan_begin

        return sharded_scan_begin(self, now_ms if now_ms is not None else ms_now())

    def maybe_grow(self, **kw) -> bool:
        """Mesh tables are sized at construction (growth is a mesh re-plan,
        like the reference's fixed CacheSize per node): never grown."""
        return False

    def hbm_bytes_per_decision_estimate(self) -> float:
        """Modeled table bytes per decision at the last dispatch geometry,
        per shard (the LocalEngine twin over per-shard rows)."""
        from gubernator_tpu_torch.ops.probe_walk import hbm_bytes_per_decision

        rows = self.last_dispatch_rows or 4096
        per_shard = max(1, rows // self.n_shards)
        return hbm_bytes_per_decision(self.layout, per_shard, self.tables[0].n_buckets,
                                      self.write_mode, self.probe_mode)

    # ------------------------------------------------------ pipelined surface
    # ops/engine.py's prepare_check_columns stages each pass here (any
    # thread), issue_check_columns launches it without fetching (engine
    # thread), finish_check_columns fetches and decodes.

    def stage_pass(self, pass_batch: HostBatch, n: int, cascade: bool = False):
        """(pass batch, staged dispatch). No row padding: the grid's width
        is the padded per-shard width. `cascade` is ignored (host fold)."""
        return pass_batch, self._stage(pass_batch, None)

    def issue_staged(self, staged, batch_rows: int):
        self.last_dispatch_rows = batch_rows
        return staged, self._decide(self.tables, staged)

    def finish_staged(self, pending, n: int):
        staged, out = pending
        s, l, r, t, dropped, hit, unproc, member, evicted = self._unroute(
            staged, _fetch(out), n
        )
        # per-row accounting over the rows a decide processed (a2a capacity
        # drops count at their retry; dedup members through their carrier)
        counted = ~unproc & ~member
        st = (int(hit[counted].sum()), int((~hit[counted]).sum()),
              int((s[counted] == 1).sum()), evicted)
        return (s, l, r, t, dropped, hit), st, unproc

    def _redispatch_rows(self, batch: HostBatch, n: int, uncounted=None):
        """Pipelined retry (engine thread): this dispatch is retry #1; it
        counts dispatches and evictions, plus the outcome of the `uncounted`
        rows, which the first dispatch never decided (a2a capacity drops)."""
        _, (s, l, r, t, d, h) = self._dispatch(batch, depth=1, count=uncounted)
        return s[:n], l[:n], r[:n], t[:n], d[:n], h[:n]

    # ------------------------------------------------------- dispatch core

    def _wire_plan(self, batch: HostBatch) -> "tuple[bool, int]":
        """(compact?, base): compact when the engine is compact and the batch
        fits the narrow layout, else full-width with the same semantics."""
        if self.wire != "compact":
            return False, 0
        base = wire_mod.pick_base(batch)
        return wire_mod.wire_encodable(batch, base), base

    def _put_grid(self, grid: np.ndarray, shards: Optional[Sequence[int]] = None
                  ) -> List[torch.Tensor]:
        """One staged host grid → block i on the device of shard shards[i]
        (every shard by default). Blocks bound for one device share one
        copy."""
        devs = self.mesh.devices
        targets = [devs[d] for d in (range(self.n_shards) if shards is None else shards)]
        if all(t == targets[0] for t in targets):
            t = _to_device(grid, targets[0])
            return [t[i] for i in range(len(targets))]
        return [_to_device(grid[i], dv) for i, dv in enumerate(targets)]

    def _stage(self, batch: HostBatch, shard: Optional[np.ndarray]):
        """Host half of one dispatch. route="host" (or explicit `shard`
        pins): rows sorted by owning shard into one (S, 12, b_local) grid
        over the S shards that hold rows — a pinned dispatch (a GLOBAL
        replica pass) stages and decides its home shard alone.
        route="device": arrival order, the mesh routes (``_stage_a2a``)."""
        if self.route == "device" and shard is None:
            return self._stage_a2a(batch)
        D = self.n_shards
        t0 = time.perf_counter()
        routed = shard if shard is not None else shard_of(batch.fp, D)
        order, rs, offset, b_local = _route_plan(routed, D)
        # the shards that hold rows (every shard for an empty batch): the
        # others would only walk all-inactive blocks
        shards = np.nonzero(np.bincount(rs, minlength=D))[0] if rs.size else np.arange(D)
        blk = np.searchsorted(shards, rs)
        S = shards.size
        t1 = time.perf_counter()
        wired, base = self._wire_plan(batch)
        if wired:
            # one trailing column per shard block carries the base
            grid = np.zeros((S, wire_mod.WIRE_LANES, b_local + 1), dtype=np.int32)
            packed = wire_mod.pack_wire_rows(batch, base)
            grid[blk, :, offset] = packed[:, order].T
            for i in range(S):
                wire_mod.stamp_base(grid[i], base)
            stage = "wire_pack"
        else:
            grid = np.zeros((S, 12, b_local), dtype=np.int64)
            grid[blk, :, offset] = pack_host_batch(batch)[:, order].T
            stage = "pack"
        t2 = time.perf_counter()
        shards = tuple(shards.tolist())
        dev = self._put_grid(grid, shards)
        t3 = time.perf_counter()
        self._stage_time("route", t1 - t0)
        self._stage_time(stage, t2 - t1)
        self._stage_time("put", t3 - t2)
        self._wire_count("put", grid.nbytes)
        math = effective_math(self.layout, batch)
        return _Staged(
            order=order, blk=blk, offset=offset, b_local=b_local, shards=shards, dev=dev,
            math=math, wire=wired, base=base,
            needs_full=batch_needs_full_layout(self.layout, math, batch),
        )

    def _stage_a2a(self, batch: HostBatch) -> "_StagedA2A":
        """Arrival-order staging: row i goes to shard i // c, no routing work
        on the host. Compact dispatches build the 5-lane int32 grid with one
        trailing base column per shard."""
        D = self.n_shards
        n = batch.fp.shape[0]
        c = _pad_size(max(1, -(-n // D)), floor=8)
        t0 = time.perf_counter()
        wired, base = self._wire_plan(batch)
        if wired:
            L = wire_mod.WIRE_LANES
            flat = np.zeros((L, D * c), dtype=np.int32)
            wire_mod.pack_wire_rows(batch, base, out=flat[:, :n])
            grid = np.zeros((D, L, c + 1), dtype=np.int32)
            grid[:, :, :c] = flat.reshape(L, D, c).transpose(1, 0, 2)
            for d in range(D):
                wire_mod.stamp_base(grid[d], base)
            stage = "wire_pack"
        else:
            flat = np.zeros((12, D * c), dtype=np.int64)
            pack_host_batch(batch, out=flat[:, :n])
            grid = np.ascontiguousarray(flat.reshape(12, D, c).transpose(1, 0, 2))
            stage = "pack"
        t1 = time.perf_counter()
        dev = self._put_grid(grid)
        t2 = time.perf_counter()
        self._stage_time(stage, t1 - t0)
        self._stage_time("put", t2 - t1)
        self._wire_count("put", grid.nbytes)
        math = effective_math(self.layout, batch)
        return _StagedA2A(
            c=c, dev=dev, math=math, wire=wired, base=base,
            needs_full=batch_needs_full_layout(self.layout, math, batch),
        )

    def _tables(self, table_attr: str) -> List[Table2]:
        """The shard tables a dispatch targets: "table" (the authoritative
        shards) or another attribute holding a list (the GLOBAL replicas)."""
        return self.tables if table_attr == "table" else getattr(self, table_attr)

    def _decide(self, tables: List[Table2], staged):
        """Launch one staged dispatch on the shards of `tables` it stages
        (engine thread): the tables advance in place (a needed migration to
        the full layout converts this list's shards); returns the output,
        one (S, rows+2, 4) tensor over the S staged shards when they share
        a device, else a list of S."""
        if staged.needs_full and tables[0].layout is not FULL:
            self._tables_to_full(tables)
        dedup = self.dedup == "device"
        if isinstance(staged, _StagedA2A):
            fn = make_a2a_decide(self.mesh, staged.c, math=staged.math, write=self.write_mode,
                                 dedup=dedup, wire=staged.wire, impl=self.a2a_impl,
                                 probe=self.probe_mode)
        else:
            fn = make_sharded_decide(self.mesh, math=staged.math, write=self.write_mode,
                                     dedup=dedup, wire=staged.wire, probe=self.probe_mode)
        if isinstance(staged, _StagedA2A):
            _, outs = fn(tables, staged.dev)
        else:
            _, outs = fn(tables, staged.dev, staged.shards)
        if all(o.device == outs[0].device for o in outs):
            return torch.stack(outs)
        return outs

    def _unroute(self, staged, outh: np.ndarray, n: int):
        """Decode the fetched (S, rows+2, 4) output back to pass-row order:
        responses, the `unprocessed` mask (rows the exchange dropped before
        any decide), the `member` mask (rows answered from a dedup carrier,
        left out of per-row accounting) and the summed evicted_unexpired,
        the one stat that is not derived per row."""
        self._wire_count("fetch", outh.nbytes)
        if isinstance(staged, _StagedA2A):
            st = outh[:, staged.c, :].astype(np.int64).sum(axis=0)
            per = outh[:, : staged.c, :].reshape(-1, 4)[:n]
            per = per.copy() if per.dtype == np.int64 else per
        else:
            st = outh[:, staged.b_local, :].astype(np.int64).sum(axis=0)
            per = np.empty((n, 4), dtype=outh.dtype)
            per[staged.order] = outh[staged.blk, staged.offset]
        if staged.wire:
            t0 = time.perf_counter()
            per = wire_mod.decode_wire_rows(per, staged.base)
            self._stage_time("wire_decode", time.perf_counter() - t0)
        status = (per[:, 3] & FLAG_STATUS).astype(np.int32)
        hit = (per[:, 3] & FLAG_HIT) != 0
        dropped = (per[:, 3] & FLAG_DROPPED) != 0
        unproc = (per[:, 3] & FLAG_UNPROCESSED) != 0
        member = (per[:, 3] & FLAG_MEMBER) != 0
        if isinstance(staged, _StagedA2A):
            # members inherit their carrier's flags without being exchanged
            over = int((unproc & ~member).sum())
            if over:
                with self._stage_lock:
                    self.a2a_overflow += over
        return (status, per[:, 0], per[:, 1], per[:, 2], dropped, hit, unproc, member,
                int(st[3]))

    def _dispatch(self, batch: HostBatch, depth: int = 0,
                  shard: Optional[np.ndarray] = None, table_attr: str = "table",
                  count: Optional[np.ndarray] = None):
        """Route one unique-fp pass across the shards, decide, un-route the
        responses to pass-row order, and re-dispatch dropped rows up to depth
        3. `shard` pins rows to shards (host grid; the GLOBAL path pins rows
        to their home's replica). `table_attr` picks the tables: "table"
        (the authoritative shards) or "replica". `count` masks the rows
        whose hit / miss / over outcome this call accounts (None: the active
        rows at depth 0, none at retry depths): each row is counted once, by
        the dispatch that first decides it."""
        n = batch.fp.shape[0]
        self._mark_dirty(batch.fp)
        staged = self._stage(batch, shard)
        out = self._decide(self._tables(table_attr), staged)
        self.stats.dispatches += 1
        status, limit, remaining, reset, dropped, hit, unproc, member, evicted = (
            self._unroute(staged, _fetch(out), n)
        )
        if count is None:
            count = np.asarray(batch.active) if depth == 0 else np.zeros(n, bool)
        counted = count & ~unproc & ~member
        self.stats.cache_hits += int(hit[counted].sum())
        self.stats.cache_misses += int((~hit[counted]).sum())
        self.stats.over_limit += int((status[counted] == 1).sum())
        self.stats.evicted_unexpired += evicted
        if dropped.any() and depth < 3:
            rows = np.nonzero(dropped)[0]
            sub_shard = shard[rows] if shard is not None else None
            if sub_shard is None and self.route == "device" and depth == 2:
                # the last retry routes on the host: its grid has no pair
                # capacity to exceed, so a valid request is never refused
                # for the exchange's sake
                sub_shard = shard_of(batch.fp[rows], self.n_shards)
            _, (s2, l2, r2, t2, d2, h2) = self._dispatch(
                _subset(batch, rows), depth=depth + 1, shard=sub_shard,
                table_attr=table_attr, count=(count & unproc)[rows],
            )
            status, limit, remaining, reset = (status.copy(), limit.copy(), remaining.copy(),
                                               reset.copy())
            dropped, hit = dropped.copy(), hit.copy()
            status[rows], limit[rows], remaining[rows], reset[rows] = s2, l2, r2, t2
            dropped[rows] = d2
            hit[rows] = h2
        elif dropped.any():
            # retries exhausted: the decision was not persisted (ERR_DROPPED);
            # rows never decided at all are counted apart
            self.stats.dropped += int(dropped.sum())
            self.stats.unprocessed_dropped += int((dropped & unproc).sum())
        return np.arange(n), (status, limit, remaining, reset, dropped, hit)


class _Staged(NamedTuple):
    """One staged host-routed dispatch: the routing plan and the per-shard
    ingress blocks."""

    order: np.ndarray  # (n,) pass row at each sorted position
    blk: np.ndarray  # (n,) block of each sorted row: its shard's index in `shards`
    offset: np.ndarray  # (n,) position within the shard's block
    b_local: int  # padded per-shard width
    shards: tuple  # the S shards staged: those that hold rows
    dev: list  # S blocks: (12, b_local) int64, or compact (5, b_local+1) int32
    math: str  # the decision math mode
    wire: bool = False  # compact blocks (ops/wire.py)
    base: int = 0  # created_at base of the compact encoding
    needs_full: bool = False  # the batch needs the full slot layout


class _StagedA2A(NamedTuple):
    """One staged device-routed dispatch (parallel/a2a.py): arrival-order
    blocks; the pair capacity derives from c and the mesh size."""

    c: int  # rows per shard (a power of two)
    dev: list  # D blocks: (12, c) int64, or compact (5, c+1) int32
    math: str
    wire: bool = False
    base: int = 0
    needs_full: bool = False


def _route_plan(routed: np.ndarray, D: int):
    """Rows grouped by shard: (order, shard of each sorted row, position in
    its shard's block, padded per-shard width)."""
    n = routed.shape[0]
    order = np.argsort(routed, kind="stable")
    counts = np.bincount(routed, minlength=D)
    b_local = _pad_size(int(counts.max()))
    rs = routed[order]
    offset = np.arange(n) - np.searchsorted(rs, rs)
    return order, rs, offset, b_local


def _to_grid(field: np.ndarray, shard_sorted, offset, D: int, b_local: int) -> np.ndarray:
    """One column laid out as the (D, b_local) owner-routed grid (zeros in
    the padding, which is inactive)."""
    grid = np.zeros((D, b_local), dtype=field.dtype)
    grid[shard_sorted, offset] = field
    return grid


def _concat_prefixes(parts, width: int):
    """Concatenate per-shard (fps, slots) host prefixes, shard by shard."""
    if not parts:
        return np.empty(0, dtype=np.int64), np.empty((0, width), dtype=np.int32)
    return np.concatenate([f for f, _s in parts]), np.concatenate([s for _f, s in parts])
