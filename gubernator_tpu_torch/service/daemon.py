"""Daemon: process assembly + the V1 request-routing core (the port of
``gubernator_tpu/service/daemon.py``, the daemon of one data center).

The TPU analog of the reference's V1Instance + Daemon (reference
gubernator.go:121-302, daemon.go:90-434). One daemon owns one device engine
(single-writer dispatch thread), a batching front door, a peer plane
(consistent-hash ownership + forwarding with retry), the GLOBAL manager, and
the gRPC/HTTP listeners.

Routing per request item (reference GetRateLimits, gubernator.go:186-302):
  1. validate + fingerprint (columns at the edge, wire.py)
  2. ForceGlobal config flips every item to GLOBAL (config.go:65-66)
  3. owner = consistent-hash ring on the item's hash key
  4. owner == self        → coalescing batcher → device kernel
     GLOBAL && not owner  → answer from LOCAL state now, queue async hit
                            (gubernator.go:401-429)
     not owner            → forward to owner, ≤5 retries re-resolving
                            ownership (gubernator.go:318-399)

The port serves every plane of the JAX daemon: the front door, the peer
plane, the GLOBAL plane between daemons, the ownership handoff, incremental
checkpoints and warm restart (service/checkpoint.py), the tiering sweep
(tier/manager.py), the request ring (service/ring.py), TLS
(service/tls.py), multi-region replication (service/region_manager.py),
edge quota leases (service/lease_manager.py) and peer discovery
(discovery/: dns, etcd, k8s, member-list). ``device`` names the engine's
device: None is the card (and raises without one), as everywhere in the
port.
"""

from __future__ import annotations

import asyncio
import collections
import random
import time
from typing import Dict, List, Optional

import numpy as np

from gubernator_tpu_torch.config import DaemonConfig, DegradationPolicy
from gubernator_tpu_torch.hashing import fingerprint_key
from gubernator_tpu_torch.ops.batch import ERROR_STRINGS, RequestColumns
from gubernator_tpu_torch.ops.engine import LocalEngine, ms_now
from gubernator_tpu_torch.peers.hash_ring import ReplicatedConsistentHash
from gubernator_tpu_torch.peers.ownership import OwnershipIndex
from gubernator_tpu_torch.peers.picker import RegionPicker
from gubernator_tpu_torch.proto import globalsync_pb2 as globalsync_pb
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.proto import handoff_pb2 as handoff_pb
from gubernator_tpu_torch.proto import peers_pb2 as peers_pb
from gubernator_tpu_torch.service.batcher import Batcher
from gubernator_tpu_torch.service.global_manager import GlobalManager
from gubernator_tpu_torch.service.breaker import BreakerState, CircuitBreaker
from gubernator_tpu_torch.service.metrics import DaemonMetrics
from gubernator_tpu_torch.service.peer_client import (
    PeerCircuitOpenError,
    PeerClient,
    PeerError,
)
from gubernator_tpu_torch.service.runner import EngineRunner
from gubernator_tpu_torch.service.wire import (
    batch_too_large_error,
    columns_from_pb,
    expand_cascades,
    pb_from_cascade_response_columns,
    pb_from_response_columns,
    subset_columns,
)
from gubernator_tpu_torch.types import Behavior, HitEvent, PeerInfo, has_behavior
from gubernator_tpu_torch import tracing

import logging

log = logging.getLogger("gubernator_tpu_torch.daemon")

FORWARD_RETRIES = 5  # reference asyncRequest retries (gubernator.go:333-359)

def _hashkey_fp(key: str) -> int:
    """Fingerprint of a pre-joined hash key ('name_uniquekey') — identical to
    fingerprint(name, unique_key) because that joins with '_' (client.go:39-41)."""
    return fingerprint_key(key)


class Daemon:
    """One serving process. Use `await Daemon.spawn(conf)`."""

    cert_watch_interval_s = 30.0  # PEM rotation poll cadence (class-level
    # so tests can speed it up before spawn)

    def __init__(
        self,
        conf: DaemonConfig,
        engine: Optional[LocalEngine] = None,
        event_channel: Optional[asyncio.Queue] = None,
        store=None,
        loader=None,
        device=None,
    ):
        conf.validate()
        self.conf = conf
        if conf.tls_cert_file or conf.tls_auto:
            # resolve the certificates now: unreadable files, or AutoTLS
            # without the `cryptography` package, fail here, before any
            # listener exists — a TLS config never serves plaintext
            from gubernator_tpu_torch.service.tls import bundle_from_config

            bundle_from_config(conf)
        # optional Loader hook (startup restore / shutdown save); None falls
        # back to GUBER_CHECKPOINT_PATH file snapshots
        self.loader = loader
        # optional audit hook: HitEvent per owner-side hit (reference
        # config.go:128-135); non-blocking — events drop when the consumer
        # lags rather than stalling the serving path
        self.event_channel = event_channel
        self.events_dropped = 0
        self.metrics = DaemonMetrics(metric_flags=conf.metric_flags)
        if engine is not None:
            self.engine = engine
            if store is not None:
                engine.store = store
        elif conf.engine == "sharded":
            # one daemon serving a whole device mesh: the table shards over
            # every local card (or the one named device), ownership =
            # fingerprint % n_shards. The mesh-global engine additionally
            # serves the GLOBAL behavior as collectives (replica answers +
            # the collective sync) when this daemon runs standalone — the
            # BASELINE #3 topology where the mesh IS the peer group.
            import torch

            from gubernator_tpu_torch.parallel import make_mesh
            from gubernator_tpu_torch.parallel.global_sync import GlobalShardedEngine

            # make_mesh raises without a card: no silent CPU fallback
            mesh = (
                make_mesh(torch.cuda.device_count()) if device is None
                else make_mesh(devices=[device])
            )
            n_dev = mesh.size
            self.engine = GlobalShardedEngine(
                # GUBER_MESH_HOSTS folds the devices into 2-D (host,
                # device) axes inside make_mesh; single hosts keep the 1-D
                # "shard" axis
                mesh,
                capacity_per_shard=max(1, conf.cache_size // n_dev),
                created_at_tolerance_ms=int(conf.created_at_tolerance_ms),
                store=store,
                # "auto" = the backend default (device routing + in-trace
                # dedup on TPU meshes, host grid + pass planner elsewhere)
                route=None if conf.shard_route == "auto" else conf.shard_route,
                dedup=None if conf.shard_dedup == "auto" else conf.shard_dedup,
                # exchange schedule for device-routed dispatches
                # (parallel/ring.py; "auto" = ring on TPU backends)
                a2a=None if conf.a2a_impl == "auto" else conf.a2a_impl,
                # table-walk kernel (ops/pallas_probe.py; "auto" = xla
                # until the device bench record flips the default)
                probe=None if conf.probe_kernel == "auto"
                else conf.probe_kernel,
                # install/merge walk kernel (fused vs two-pass; same
                # default-flip policy, independent knob)
                walk=None if conf.walk_kernel == "auto"
                else conf.walk_kernel,
            )
        else:
            self.engine = LocalEngine(
                capacity=conf.cache_size,
                device=device,
                created_at_tolerance_ms=int(conf.created_at_tolerance_ms),
                store=store,
                probe=None if conf.probe_kernel == "auto"
                else conf.probe_kernel,
                walk=None if conf.walk_kernel == "auto"
                else conf.walk_kernel,
            )
        self.runner = EngineRunner(
            self.engine,
            metrics=self.metrics,
            fetch_workers=conf.behaviors.pipeline_inflight,
        )
        # the request ring (service/ring.py): when armed, all-wire flushes
        # stage into ring slots and the serving loop consumes them in
        # ticket order — on the card through the fused drain (fence_claim
        # claims the published slots), on the CPU through the host loop
        self.ring = None
        if conf.behaviors.ring_enable:
            from gubernator_tpu_torch.ops.ring_drain import default_ring_issue
            from gubernator_tpu_torch.service.ring import RequestRing

            ring_issue = conf.behaviors.ring_issue
            if ring_issue == "auto":
                ring_issue = default_ring_issue(
                    getattr(self.engine, "device", device)
                )
            self.ring = RequestRing(
                self.runner,
                slots=conf.behaviors.ring_slots,
                metrics=self.metrics,
                issue_mode=ring_issue,
                drain_k=conf.behaviors.ring_drain_k,
                slot_width=conf.behaviors.ring_slot_width,
            )
        self.batcher = Batcher(
            self.runner,
            batch_wait_ms=conf.behaviors.batch_wait_ms,
            coalesce_limit=conf.behaviors.coalesce_limit,
            metrics=self.metrics,
            max_inflight=conf.behaviors.pipeline_inflight,
            workers=conf.behaviors.front_workers,
            adaptive=conf.behaviors.adaptive_batch,
            close_rows=conf.behaviors.batch_close_rows,
            close_bytes=conf.behaviors.batch_close_bytes,
            max_queue_rows=conf.behaviors.batch_queue_rows,
            ring=self.ring,
            overload_deadline_ms=conf.behaviors.overload_deadline_ms,
            overload_deadline_auto=conf.behaviors.overload_deadline_auto,
            tenant_share=conf.behaviors.overload_tenant_share,
            tenant_buckets=conf.behaviors.overload_tenant_buckets,
            shed_retry_ms=conf.behaviors.overload_retry_ms,
        )
        # front-door parse/encode pool: the native parser and response
        # encoder drop the GIL, so offloading big request buffers here lets
        # N workers parse/encode concurrently while the event loop keeps
        # accepting connections. Tiny requests stay inline — the executor
        # hop costs more than the parse.
        from concurrent.futures import ThreadPoolExecutor

        n_door = conf.behaviors.front_workers or max(
            2, conf.behaviors.pipeline_inflight // 2
        )
        self._door = ThreadPoolExecutor(
            max_workers=n_door, thread_name_prefix="door"
        )
        self.global_manager = GlobalManager(self)
        from gubernator_tpu_torch.service.region_manager import RegionManager

        self.region_manager = RegionManager(self)
        # edge quota leases: the V1 LeaseQuota surface — bounded slices of a
        # limit delegated to client-side admission, accounted through the
        # normal decide path + a CONCURRENCY_LEASE outstanding ledger (TTL
        # reclamation)
        from gubernator_tpu_torch.service.lease_manager import LeaseManager

        self.lease_manager = LeaseManager(self)
        # incremental-checkpoint plane (service/checkpoint.py): inert unless
        # GUBER_CHECKPOINT_INTERVAL_MS > 0 — then a background loop appends
        # dirty-block delta frames beside the base snapshot and restart
        # replays base + deltas
        from gubernator_tpu_torch.service.checkpoint import CheckpointManager

        self.checkpointer = CheckpointManager(self)
        # hot-set tiering plane (tier/manager.py): inert unless
        # GUBER_TIER_ENABLED — then evicted/idle rows demote to a host-RAM
        # shadow instead of vanishing, and host staging faults them back
        # through the conservative merge
        from gubernator_tpu_torch.tier.manager import TierManager

        self.tier = TierManager(self)
        self._tier_task = None
        self._checkpoint_task = None
        self._maintenance_task = None
        self._global_sync_task = None  # mesh-global collective sync tick
        self._telemetry_task = None  # background table-telemetry cadence
        self._table_telemetry = None  # last ops/telemetry.TableSnapshot
        self._local_picker = ReplicatedConsistentHash()
        self._region_picker = RegionPicker()
        self._peer_clients: Dict[str, PeerClient] = {}
        # breakers OUTLIVE their clients, keyed by address: a flapping
        # discovery backend that drops and re-adds a peer must not reset an
        # open breaker to closed (the peer is no healthier for having
        # blinked out of the peer list)
        self._peer_breakers: Dict[str, CircuitBreaker] = {}
        # clients dropped by set_peers while no event loop was running —
        # drained on the next loop entry (or close) instead of leaking
        self._orphaned_clients: List[PeerClient] = []
        # topology-change handoff (service/handoff.py): fp→ring-point
        # sidecar + the transfer manager + idempotency ledger for received
        # chunks ((transfer_id, chunk) → merged count)
        from gubernator_tpu_torch.service.handoff import HandoffManager

        self.ownership = OwnershipIndex()
        self.handoff = HandoffManager(self)
        self._applied_transfers: "collections.OrderedDict" = (
            collections.OrderedDict()
        )
        self._handoff_tasks: set = set()
        self._leaving = False  # drain in progress → health shows "leaving"
        self._shutting_down = False
        self._servers = []  # transport handles (service/server.py)
        self._pool = None  # discovery pool
        self.grpc_port: Optional[int] = None
        self.http_port: Optional[int] = None
        self.status_http_port: Optional[int] = None
        self._client_creds = None  # set by TLS setup
        self._cert_watch_task = None
        self._http_ssl_contexts = []  # live HTTPS listener contexts

    # ---------------------------------------------------------------- spawn
    @classmethod
    async def spawn(
        cls,
        conf: DaemonConfig,
        engine: Optional[LocalEngine] = None,
        event_channel: Optional[asyncio.Queue] = None,
        store=None,
        loader=None,
        device=None,
    ):
        """SpawnDaemon analog (reference daemon.go:75-88): build, restore
        the snapshot or the incremental checkpoint, warm up (on the card the
        first dispatches build the kernels, so no request waits on a
        build), arm the checkpoint tracker and the tier shadow, then start
        listeners, loops and discovery."""
        d = cls(
            conf, engine=engine, event_channel=event_channel, store=store,
            loader=loader, device=device,
        )
        if tracing.exporter is None:
            # standard OTEL_* envs wire a real span exporter (reference
            # cmd/gubernator/main.go:90-97 InitTracing); process-global —
            # in-process clusters share one pipeline like one binary would
            from gubernator_tpu_torch.otel import exporter_from_env

            exp = exporter_from_env()
            if exp is not None:
                tracing.set_exporter(exp)
                log.info("OTLP trace export enabled → %s", exp.endpoint)
        d.maybe_restore()
        await d.warm_up()
        if d.checkpointer.enabled:
            # epoch tracker attaches BEFORE the listeners open: every
            # serving mutation from the first request onward is marked
            d.checkpointer.attach()
        if d.tier.enabled:
            # AFTER the checkpoint restore (delta replay — including
            # tombstone frames — settles the table first), before serving
            d.tier.attach()
        from gubernator_tpu_torch.service.server import start_servers

        await start_servers(d)
        d.global_manager.start()
        d.region_manager.start()
        if getattr(d.engine, "mesh_global", False):
            # collective GLOBAL sync tick (GlobalSyncWait cadence, reference
            # config.go:142-146) — the in-mesh analog of runAsyncHits +
            # runBroadcasts, collapsed into one collective step
            d._global_sync_task = asyncio.create_task(
                d._global_sync_loop(), name="mesh-global-sync"
            )
        if conf.telemetry_interval_ms > 0:
            # background table-telemetry cadence (docs/observability.md):
            # the scan is issued on the engine thread and fetched off it, so
            # it overlaps serving dispatches — never the serving path
            d._telemetry_task = asyncio.create_task(
                d._telemetry_loop(), name="table-telemetry"
            )
        if d.checkpointer.enabled:
            # incremental checkpoint cadence: extract launch on the engine
            # thread, fetch + frame append off it — checkpointing overlaps
            # serving like the telemetry scan does
            d._checkpoint_task = asyncio.create_task(
                d.checkpointer.loop(), name="checkpoint"
            )
        if d.tier.enabled:
            # demote-on-idle sweep on the telemetry cadence: extract +
            # tombstone in one engine job, shadow append + spill flush +
            # tombstone frame off it
            d._tier_task = asyncio.create_task(
                d.tier.loop(), name="tier-sweep"
            )
        if d._client_creds is not None and conf.tls_cert_file:
            # rotation watcher: the gRPC server hot-reloads per handshake,
            # but peer-forwarding CLIENTS hold credentials from startup — on
            # a cert rotation they must re-dial with the new pair or
            # verify-mode clusters break both directions until restart
            d._cert_watch_task = asyncio.create_task(
                d._cert_watch_loop(), name="cert-watch"
            )
        await d._start_discovery()
        if conf.cache_max_size > conf.cache_size:
            if getattr(d.engine, "supports_grow", False):
                d._maintenance_task = asyncio.create_task(
                    d._maintenance_loop(), name="table-maintenance"
                )
            else:
                log.warning(
                    "GUBER_CACHE_MAX_SIZE is set but the %s engine cannot "
                    "auto-grow; the table stays at its construction size",
                    conf.engine,
                )
        return d

    async def _global_sync_loop(self) -> None:
        """Mesh-global sync tick: drain accumulated GLOBAL hits through the
        collective step every GlobalSyncWait. Empty ticks skip the dispatch —
        the reference's timer also idles when no hits are queued
        (global.go:125-151)."""
        wait_s = self.conf.behaviors.global_sync_wait_ms / 1e3
        while not self._shutting_down:
            await asyncio.sleep(wait_s)
            try:
                if self.engine.has_pending():
                    await self.runner.sync_global()
            except asyncio.CancelledError:
                raise
            except Exception:  # pragma: no cover - defensive
                log.exception("mesh global sync tick failed")

    async def _telemetry_loop(self) -> None:
        """Background table-telemetry cadence (GUBER_TELEMETRY_INTERVAL_MS):
        refresh the gubernator_tpu_table_* families, the /v1/debug/table
        snapshot, cache_size, and the GLOBAL staleness gauge."""
        wait_s = self.conf.telemetry_interval_ms / 1e3
        while not self._shutting_down:
            await asyncio.sleep(wait_s)
            try:
                await self.collect_telemetry()
            except asyncio.CancelledError:
                raise
            except Exception:  # pragma: no cover - defensive
                log.exception("table telemetry tick failed")

    async def collect_telemetry(self):
        """One telemetry round: scan the table (engine-thread launch, off-
        thread fetch — EngineRunner.table_telemetry) and publish the
        snapshot. Also callable on demand (the debug endpoint uses it when
        the loop is disabled)."""
        snap = await self.runner.table_telemetry()
        self._table_telemetry = snap
        self.metrics.observe_table(snap)
        # the scan counts live keys anyway — keep cache_size fresh between
        # /metrics scrapes for free
        self.metrics.cache_size.set(snap.live_keys)
        self.metrics.global_sync_staleness.set(self.global_sync_staleness_s())
        self.metrics.region_sync_staleness.set(
            self.region_manager.oldest_delta_age_s()
        )
        return snap

    def global_sync_staleness_s(self) -> float:
        """Age of the oldest un-synced GLOBAL hit across BOTH planes: the
        cross-daemon async queue (GlobalManager) and the in-mesh outbox
        (GlobalShardedEngine.pending). The convergence-lag signal the
        multi-region roadmap item is judged on — if this grows while
        traffic flows, replicas are falling behind their owners."""
        age = self.global_manager.oldest_hit_age_s()
        mesh_age = getattr(self.engine, "oldest_pending_age_s", None)
        if mesh_age is not None:
            age = max(age, mesh_age())
        return age

    async def _maintenance_loop(self) -> None:
        """Auto-grow tick: double the table when live keys pass 60% of
        capacity, up to GUBER_CACHE_MAX_SIZE."""
        while not self._shutting_down:
            await asyncio.sleep(2.0)
            try:
                grew = await self.runner.maybe_grow(
                    max_capacity=self.conf.cache_max_size
                )
                if grew:
                    live = await self.runner.live_count()
                    self.metrics.cache_size.set(live)
                    log.info(
                        "table grew to %d slots (%d live)",
                        self.engine.table.capacity, live,
                    )
            except asyncio.CancelledError:
                raise
            except Exception:  # pragma: no cover - defensive
                log.exception("table maintenance tick failed")

    async def _cert_watch_loop(self) -> None:
        """Rebuild peer-client credentials + channels when the PEM files
        rotate (complements the server side's per-handshake hot reload)."""
        from gubernator_tpu_torch.service.tls import (
            _validate_keypair,
            bundle_from_config,
            cert_files_mtimes,
            client_credentials,
        )

        last = cert_files_mtimes(self.conf)
        while not self._shutting_down:
            await asyncio.sleep(self.cert_watch_interval_s)
            try:
                now_mt = cert_files_mtimes(self.conf)
                if now_mt is None or now_mt == last:
                    continue
                # a torn rotation (cert written, key not yet) must neither
                # commit `last` (so the next tick retries) nor tear down
                # working channels — same guard as the server-side reloader
                try:
                    _validate_keypair(bundle_from_config(self.conf))
                except Exception:
                    log.warning(
                        "rotated TLS files failed validation; keeping the "
                        "current peer credentials until the next check"
                    )
                    continue
                last = now_mt
                self._client_creds = client_credentials(self.conf)
                # force-recreate every peer channel with the new credentials;
                # set_peers reuses clients by address, so drop them first and
                # drain the old ones
                old = self._peer_clients
                self._peer_clients = {}
                peers = self.local_peers() + self.region_peers()
                self.set_peers([PeerInfo(**vars(p)) for p in peers])
                await asyncio.gather(
                    *(c.shutdown() for c in old.values()), return_exceptions=True
                )
                # HTTPS listeners share long-lived SSLContexts: reload the
                # chain in place so new handshakes serve the rotated pair
                # (gRPC reloads per-handshake; these must not lag behind)
                for ctx in self._http_ssl_contexts:
                    try:
                        ctx.load_cert_chain(
                            self.conf.tls_cert_file, self.conf.tls_key_file
                        )
                    except Exception:
                        log.warning(
                            "HTTP listener certificate reload failed; "
                            "keeping the current pair"
                        )
                log.info("TLS certificates rotated; peer channels re-dialed")
            except asyncio.CancelledError:
                raise
            except Exception:  # pragma: no cover - defensive
                log.exception("certificate rotation check failed")

    async def warm_up(self) -> None:
        """Run the decision + install paths for the smallest batch shape
        BEFORE serving: on the card the first dispatches build the hand
        kernels (nvcc, seconds on a cold build/), which would blow
        the 500 ms peer-RPC budgets (global_timeout, batch_timeout) and drop
        the first GLOBAL sync round of a fresh daemon. All three static math
        variants compile (engine._math_mode picks per dispatch): an all-token
        warm batch alone would leave the first leaky- or GCRA-carrying
        request to pay the mixed/int graph's compile on the request path.
        Packed-layout tables (GUBER_SLOT_LAYOUT) warm ONLY their own
        family's graph — an off-family warm batch would migrate the table
        to full before the first real request arrives. The native ingress
        extension builds here too (g++, seconds on a cold build/), not on
        the first request."""
        from gubernator_tpu_torch import native

        await asyncio.get_running_loop().run_in_executor(None, native.load)
        lay = getattr(self.engine.table, "layout", None)
        variants = (
            [0],  # math="token" graph
            [2],  # math="gcra" graph (all-GCRA specialization)
            [2, 3],  # math="int" graph (mixed integer algorithms)
            [1],  # math="mixed" graph
        )
        if lay is not None and lay.algos is not None:
            variants = tuple(
                v for v in variants
                if lay.supports_algos(np.asarray(v, dtype=np.int32))
            )
        for algos in variants:
            n = len(algos)
            warm = RequestColumns(
                fp=np.arange(1, n + 1, dtype=np.int64),
                algo=np.asarray(algos, dtype=np.int32),
                behavior=np.zeros(n, dtype=np.int32),
                hits=np.zeros(n, dtype=np.int64),
                limit=np.ones(n, dtype=np.int64),
                burst=np.zeros(n, dtype=np.int64),
                duration=np.ones(n, dtype=np.int64),  # expires ~immediately
                created_at=np.zeros(n, dtype=np.int64),
                err=np.zeros(n, dtype=np.int8),
            )
            await self.runner.check_columns(warm)
        warm_install_algo = (
            lay.algos[0]
            if lay is not None and lay.algos is not None else 0
        )
        await self.runner.install_columns(
            fp=np.asarray([1], dtype=np.int64),
            algo=np.full(1, warm_install_algo, dtype=np.int32),
            status=np.zeros(1, dtype=np.int32),
            limit=np.ones(1, dtype=np.int64),
            remaining=np.ones(1, dtype=np.int64),
            reset_time=np.ones(1, dtype=np.int64),
            duration=np.ones(1, dtype=np.int64),
            now_ms=1,
        )
        # the install warm above already traced the install walk under the
        # engine's resolved walk_mode (GUBER_WALK_KERNEL threads through
        # install2/merge2 transparently). The merge walk is warmed for
        # region daemons (the replication receive path) AND whenever the
        # fused Pallas walks are armed — tiering promotes and handoff
        # merges ride merge2 too, and a fused-walk graph compiling on the
        # first promote would stall the engine thread mid-serving.
        fused_walks = getattr(self.engine, "walk_mode", "xla") == "pallas"
        if self.conf.data_center or fused_walks:
            # region plane (docs/robustness.md "Multi-region active-
            # active"): pre-trace the stored-state read (the sender's
            # staging gather) and the conservative merge (the receiver's
            # reconcile) so the first replicated batch doesn't pay an XLA
            # compile inside a peer's RPC deadline — a timed-out first
            # sync would requeue and re-apply as a duplicate (under-
            # granting, but needlessly). DC-less daemons never replicate,
            # so they skip the staging-read compile.
            from gubernator_tpu_torch.ops.table2 import F as F_FULL

            fp1 = np.asarray([1], dtype=np.int64)
            if self.conf.data_center:
                await self.runner.read_state_raw(fp1)
            # an all-zero incoming row is expired at every clock: the
            # merge kernel compiles, the table keeps its bytes
            await self.runner.merge_rows(
                fp1, np.zeros((1, F_FULL), dtype=np.int32)
            )
        # GUBER_WARM_SHAPES=pow2[-mixed]: additionally compile every pow2
        # coalesce geometry up to the coalesce cap (like bench.py's e2e
        # prewarm) so no production batch shape ever compiles on the
        # request path; off by default — it multiplies spawn time by the
        # shape count, which in-process test clusters cannot afford
        mode = self.conf.behaviors.warm_shapes
        if mode in ("pow2", "pow2-mixed"):
            from gubernator_tpu_torch.ops.engine import _pad_size

            algos = [0] if mode == "pow2" else [0, 1]
            size = 16
            # up to the PADDED top shape: a non-pow2 coalesce_limit still
            # pads saturated batches to the next pow2, which must be warm
            top = _pad_size(int(self.conf.behaviors.coalesce_limit))
            while size <= top:
                for a in algos:
                    warm = RequestColumns(
                        fp=np.arange(1, size + 1, dtype=np.int64),
                        algo=np.full(size, a, dtype=np.int32),
                        behavior=np.zeros(size, dtype=np.int32),
                        hits=np.zeros(size, dtype=np.int64),
                        limit=np.ones(size, dtype=np.int64),
                        burst=np.zeros(size, dtype=np.int64),
                        duration=np.ones(size, dtype=np.int64),
                        created_at=np.zeros(size, dtype=np.int64),
                        err=np.zeros(size, dtype=np.int8),
                    )
                    await self.runner.check_columns(warm)
                size *= 2
            # herd geometries: a same-key batch plans j sequential passes
            # (j ≤ max_exact) whose same-shape outputs fuse into one
            # stacked fetch (ops/engine._stack_pass_outputs) — trace the
            # stack kernel for every pass count now, or the first
            # production herd pays that compile on the request path
            max_exact = getattr(self.engine, "max_exact_passes", 8)
            for j in range(2, max_exact + 1):
                warm = RequestColumns(
                    fp=np.full(j, 7, dtype=np.int64),
                    algo=np.zeros(j, dtype=np.int32),
                    behavior=np.zeros(j, dtype=np.int32),
                    hits=np.zeros(j, dtype=np.int64),
                    limit=np.ones(j, dtype=np.int64),
                    burst=np.zeros(j, dtype=np.int64),
                    duration=np.ones(j, dtype=np.int64),
                    created_at=np.zeros(j, dtype=np.int64),
                    err=np.zeros(j, dtype=np.int8),
                )
                # through the PIPELINED door: the stack kernel only traces
                # on the issue path (serial check_columns never stacks)
                await self.runner.check(warm)
            if (
                getattr(self.engine, "mesh_global", False)
                and self.engine.store is None
            ):
                # pre-trace the collective sync steps (single + fused R
                # variants) so the first deep GLOBAL backlog can't compile
                # on the engine thread mid-tick
                await asyncio.get_running_loop().run_in_executor(
                    self.runner._exec, self.engine.warm_sync_steps
                )
                from gubernator_tpu_torch.parallel.global_sync import GlobalStats

                self.engine.global_stats = GlobalStats()
        # warm-up is not traffic: reset counters so tests and metrics see
        # only real requests. The pipelined warms above apply their stats
        # deltas fire-and-forget on the engine executor — flush it first or
        # a late apply lands AFTER the reset and resurrects warm-up counts
        from gubernator_tpu_torch.ops.engine import EngineStats

        await asyncio.get_running_loop().run_in_executor(
            self.runner._exec, lambda: None
        )
        self.engine.stats = EngineStats()
        self.metrics._last_engine = None

    async def _start_discovery(self) -> None:
        kind = self.conf.peer_discovery_type
        if kind == "dns":
            from gubernator_tpu_torch.discovery.dns import DNSPool

            self._pool = DNSPool(
                fqdn=self.conf.dns_fqdn,
                poll_ms=self.conf.dns_poll_ms,
                on_update=self.set_peers,
                self_address=self.conf.advertise_address,
                http_address=self.conf.http_address,
                data_center=self.conf.data_center,
            )
        elif kind == "etcd":
            from gubernator_tpu_torch.discovery.etcd import EtcdPool

            self._pool = EtcdPool(
                endpoint=self.conf.etcd_endpoint,
                on_update=self.set_peers,
                peer_info=self.peer_info(),
                key_prefix=self.conf.etcd_key_prefix,
                lease_ttl_s=self.conf.etcd_lease_ttl_s,
                poll_ms=self.conf.etcd_poll_ms,
            )
        elif kind == "member-list":
            from gubernator_tpu_torch.discovery.memberlist import MemberlistPool

            self._pool = MemberlistPool(
                bind_address=self.conf.memberlist_address,
                advertise_address=self.conf.memberlist_advertise_address,
                known_nodes=[
                    n.strip()
                    for n in self.conf.memberlist_known_nodes.split(",")
                    if n.strip()
                ],
                on_update=self.set_peers,
                peer_info=self.peer_info(),
                gossip_interval_ms=self.conf.memberlist_gossip_interval_ms,
                secret_keys=self.conf.memberlist_keyring(),
            )
        elif kind == "k8s":
            from gubernator_tpu_torch.discovery.kubernetes import K8sPool

            self._pool = K8sPool(
                on_update=self.set_peers,
                pod_ip=self.conf.k8s_pod_ip,
                pod_port=self.conf.k8s_pod_port
                or self.conf.grpc_address.rsplit(":", 1)[-1],
                namespace=self.conf.k8s_namespace,
                selector=self.conf.k8s_selector,
                mechanism=self.conf.k8s_mechanism,
                api_url=self.conf.k8s_api_url,
                poll_ms=self.conf.k8s_poll_ms,
            )
        if self._pool is not None:
            await self._pool.start()
        # "none": explicit set_peers calls (reference daemon.go:258-262)

    # ---------------------------------------------------------------- peers
    def peer_info(self) -> PeerInfo:
        return PeerInfo(
            grpc_address=self.conf.advertise_address,
            http_address=self.conf.http_address,
            data_center=self.conf.data_center,
            is_owner=True,
        )

    def set_peers(self, peers: List[PeerInfo]) -> None:
        """Hot-swap the peer set (reference SetPeers, gubernator.go:694-789):
        rebuild both pickers from scratch, reuse live PeerClients by address
        (and CircuitBreakers across churn — a flapping discovery backend
        must not reset open breakers), drain clients for peers that
        disappeared, and launch a device-side ownership handoff for live
        rows whose ring owner moved (service/handoff.py)."""
        old_local = self._local_picker
        local = ReplicatedConsistentHash()
        region = RegionPicker()
        keep: Dict[str, PeerClient] = {}
        for info in peers:
            info.is_owner = info.grpc_address == self.conf.advertise_address
            if not info.data_center or info.data_center == self.conf.data_center:
                local.add(info)
            else:
                region.add(info)
            if not info.is_owner:
                client = self._peer_clients.get(info.grpc_address)
                if client is None:
                    b = self.conf.behaviors
                    breaker = self._peer_breakers.get(info.grpc_address)
                    if breaker is None:
                        breaker = CircuitBreaker(
                            failure_threshold=b.peer_breaker_errors,
                            backoff_base_ms=b.peer_breaker_backoff_base_ms,
                            backoff_cap_ms=b.peer_breaker_backoff_cap_ms,
                            probe_budget=b.peer_breaker_probes,
                        )
                        self._peer_breakers[info.grpc_address] = breaker
                    client = PeerClient(
                        info,
                        batch_wait_ms=b.batch_wait_ms,
                        batch_limit=b.batch_limit,
                        batch_timeout_ms=b.batch_timeout_ms,
                        metrics=self.metrics,
                        channel_credentials=self._client_creds,
                        breaker=breaker,
                    )
                keep[info.grpc_address] = client
        dropped = [
            c for a, c in self._peer_clients.items() if a not in keep
        ]
        self._peer_clients = keep
        self._local_picker = local
        self._region_picker = region
        # closed breakers of departed peers carry no state worth keeping;
        # open/half-open ones persist so a re-added peer resumes its cooldown
        for addr in list(self._peer_breakers):
            if (
                addr not in keep
                and self._peer_breakers[addr].state is BreakerState.CLOSED
            ):
                del self._peer_breakers[addr]
        self._orphaned_clients.extend(dropped)
        self._flush_orphans()
        # ---- topology-change handoff: live rows whose ownership moved away
        # from this daemon follow it to the new owner (rebalance diff). The
        # initial set_peers (old ring empty) and no-op swaps (same address
        # set — e.g. the cert watcher's re-dial, a peer restart) skip it.
        if (
            self.conf.behaviors.handoff_enabled
            and not self._shutting_down
            and old_local.size() > 0
            and local.size() > 0
            and {p.grpc_address for p in old_local.peers()}
            != {p.grpc_address for p in local.peers()}
        ):
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                pass  # no loop (synchronous test wiring): nothing to move yet
            else:
                t = loop.create_task(
                    self._rebalance_handoff(old_local, local),
                    name="handoff-rebalance",
                )
                self._handoff_tasks.add(t)
                t.add_done_callback(self._handoff_tasks.discard)

    async def _rebalance_handoff(self, old_picker, new_picker) -> None:
        try:
            await self.handoff.rebalance(old_picker, new_picker)
        except asyncio.CancelledError:
            raise
        except Exception:  # pragma: no cover - defensive
            log.exception("ownership rebalance handoff failed")

    def _flush_orphans(self) -> None:
        """Drain clients dropped by set_peers. With no running loop (tests
        wiring daemons synchronously) the clients stay queued and close on
        the next loop entry — previously they leaked their channels."""
        if not self._orphaned_clients:
            return
        clients, self._orphaned_clients = self._orphaned_clients, []

        async def drain():
            await asyncio.gather(
                *(c.shutdown() for c in clients), return_exceptions=True
            )

        try:
            asyncio.get_running_loop().create_task(drain())
        except RuntimeError:
            self._orphaned_clients = clients  # retried on next loop entry

    def local_peers(self) -> List[PeerInfo]:
        return self._local_picker.peers()

    def region_peers(self) -> List[PeerInfo]:
        return self._region_picker.peers()

    def region_owners(self, key: str) -> List[PeerInfo]:
        """The key's owner in every OTHER datacenter (region picker holds only
        non-local DCs, see set_peers)."""
        return self._region_picker.get_clients(key)

    def get_peer(self, key: str) -> PeerInfo:
        return self._local_picker.get(key)

    def is_self(self, info: PeerInfo) -> bool:
        return info.grpc_address == self.conf.advertise_address

    def peer_client(self, info: PeerInfo) -> Optional[PeerClient]:
        return self._peer_clients.get(info.grpc_address)

    def now_ms(self) -> int:
        return ms_now()

    # ------------------------------------------------------------ V1 service
    async def get_rate_limits(
        self, items: List["pb.RateLimitReq"]
    ) -> List["pb.RateLimitResp"]:
        if len(items) > self.conf.max_batch_size:
            raise ValueError(batch_too_large_error(self.conf.max_batch_size))
        self.metrics.concurrent_checks.inc()
        # ingress scope: adopt the client's trace when one is propagated in
        # request metadata, else start a fresh root span
        token = None
        for it in items:
            parent = tracing.extract(it.metadata)
            if parent is not None:
                token = tracing.start_scope("GetRateLimits", parent)
                break
        if token is None:
            token = tracing.start_scope("GetRateLimits")
        try:
            return await self._route(items)
        finally:
            tracing.end_scope(token)
            self.metrics.concurrent_checks.dec()

    async def _route(self, items) -> List["pb.RateLimitResp"]:
        n = len(items)
        if self.conf.behaviors.force_global:
            for it in items:
                it.behavior |= int(Behavior.GLOBAL)
        cols, hash_keys = columns_from_pb(items)
        out: List[Optional[pb.RateLimitResp]] = [None] * n

        standalone = self._local_picker.size() == 0
        local_rows: List[int] = []
        global_rows: List[int] = []
        forwards: List[tuple] = []  # (row, key, item)
        owner_global_rows: List[int] = []
        owner_region_rows: List[int] = []
        for i in range(n):
            if cols.err[i] != 0:
                out[i] = pb.RateLimitResp(error=ERROR_STRINGS[int(cols.err[i])])
                continue
            is_global = bool(cols.behavior[i] & int(Behavior.GLOBAL))
            is_mr = bool(cols.behavior[i] & int(Behavior.MULTI_REGION))
            if standalone:
                local_rows.append(i)
                if is_global:
                    owner_global_rows.append(i)
                if is_mr:
                    owner_region_rows.append(i)
                continue
            info = self.get_peer(hash_keys[i])
            if self.is_self(info):
                local_rows.append(i)
                if is_global:
                    owner_global_rows.append(i)
                if is_mr:
                    owner_region_rows.append(i)
            elif is_global:
                global_rows.append(i)
            else:
                forwards.append((i, hash_keys[i], items[i]))

        if local_rows and not standalone and self.conf.behaviors.handoff_enabled:
            # sidecar for topology-change handoff: remember each owned row's
            # ring point (fp and point are not mutually derivable — the
            # native path records the wire parser's points vectorized)
            self.ownership.record_keys(
                (cols.fp[i] for i in local_rows),
                (hash_keys[i] for i in local_rows),
                self._local_picker.hash_fn,
            )
        if owner_global_rows and not standalone:
            # clustered: owner-daemon GLOBAL answers must stay authoritative
            # so the cross-daemon broadcast (queue_update below) carries a
            # fresh status; the engine's mesh replica plane serves GLOBAL only
            # when this daemon runs standalone (the mesh IS the peer group)
            cols.behavior[np.asarray(owner_global_rows)] &= ~np.int32(
                int(Behavior.GLOBAL)
            )
        tasks = []
        if local_rows:
            rows = np.asarray(local_rows)
            tasks.append(self._check_rows(cols, rows, out, items))
        if global_rows:
            rows = np.asarray(global_rows)
            # answer from local state with GLOBAL stripped + NO_BATCHING
            # forced (reference gubernator.go:416-422), and queue async hits
            gcols = subset_columns(cols, rows)
            gcols = gcols._replace(
                behavior=(gcols.behavior & ~np.int32(int(Behavior.GLOBAL)))
                | np.int32(int(Behavior.NO_BATCHING))
            )
            for i in global_rows:
                self.global_manager.queue_hit(hash_keys[i], items[i])
            tasks.append(self._check_subset(gcols, rows, out, items))
        for row, key, item in forwards:
            tasks.append(self._forward(row, key, item, out))
        if tasks:
            await asyncio.gather(*tasks)
        # owner-side GLOBAL items broadcast their fresh status (reference
        # getLocalRateLimit → QueueUpdate, gubernator.go:670-672). A
        # standalone mesh-global daemon skips this: the collective plane IS
        # the broadcast, and there are no peer daemons to push to.
        if not (standalone and getattr(self.engine, "mesh_global", False)):
            for i in owner_global_rows:
                self.global_manager.queue_update(hash_keys[i], items[i])
        # owner-side MULTI_REGION hits replicate to the other DCs' owners
        for i in owner_region_rows:
            self.region_manager.queue_hit(hash_keys[i], items[i])
        # audit events fire for locally-executed (owner-side) hits only
        # (reference gubernator.go:676-688)
        if self.event_channel is not None:
            for i in local_rows:
                self._emit_event(items[i], out[i])
        for i in range(n):
            if out[i] is None:  # pragma: no cover - defensive
                out[i] = pb.RateLimitResp(error="internal: row not routed")
            if out[i].status == pb.OVER_LIMIT:
                self.metrics.over_limit_counter.inc()
        return out  # type: ignore[return-value]

    async def lease_quota(self, req: "pb.LeaseQuotaReq") -> "pb.LeaseQuotaResp":
        """One edge quota-lease operation (service/lease_manager.py): grant
        a bounded slice of a limit for client-side admission, renew it, or
        take unused tokens back. The grant/refund rows ride the exact
        routing this daemon's GetRateLimits uses, so ownership, GLOBAL and
        MULTI_REGION behaviors see leased consumption as ordinary hits."""
        return await self.lease_manager.lease_quota(req)

    # ------------------------------------------------- native raw fast path
    # requests below this many wire bytes parse inline: the door-pool
    # executor hop costs more than the parse itself for small buffers
    DOOR_OFFLOAD_BYTES = 4096

    async def get_rate_limits_raw(self, data: bytes) -> bytes:
        """Serve GetRateLimitsReq wire bytes → GetRateLimitsResp wire bytes.

        The native ingress (gubernator_tpu/native) parses the request buffer
        straight into column arrays AND pre-packed compact-wire lanes in one
        pass — no per-item Python objects on the owner-local path, and (for
        wire-encodable batches against a compact-wire local engine) no
        column re-pack either: the batcher stages the parser's lanes
        directly into the dispatch grid. Big buffers parse on the door pool
        (the C parser drops the GIL, so N workers parse concurrently); only
        items that must travel as messages (forwards, GLOBAL/MULTI_REGION
        queue entries) materialize lazily from their wire spans. Falls back
        to the pb path when the extension is unavailable or an event channel
        needs full request objects."""
        from gubernator_tpu_torch.service.wire import wire_batch_from_wire

        parsed = None
        parse_s = 0.0
        if self.event_channel is None:
            t0 = time.perf_counter()
            if len(data) >= self.DOOR_OFFLOAD_BYTES:
                parsed = await asyncio.get_running_loop().run_in_executor(
                    self._door, wire_batch_from_wire, data
                )
            else:
                parsed = wire_batch_from_wire(data)
            parse_s = time.perf_counter() - t0
        if parsed is None:
            req = pb.GetRateLimitsReq.FromString(data)
            resps = await self.get_rate_limits(list(req.requests))
            return pb.GetRateLimitsResp(responses=resps).SerializeToString()
        wb, ring, spans, traceparent = parsed
        n = wb.rows
        if n > self.conf.max_batch_size:
            raise ValueError(batch_too_large_error(self.conf.max_batch_size))
        self.metrics.concurrent_checks.inc()
        parent = tracing.parse_traceparent(traceparent) if traceparent else None
        token = tracing.start_scope("GetRateLimits", parent)
        # parse is a stage of THIS request (not of any batch dispatch):
        # observed under the request span so its exemplar resolves to the
        # request's own trace; the child span makes "where did my p99 go"
        # decomposable per request
        self._observe_request_stage("parse", parse_s, token.span)
        try:
            return await self._route_raw(data, wb, ring, spans)
        finally:
            tracing.end_scope(token)
            self.metrics.concurrent_checks.dec()

    async def _route_raw(self, data, wb, ring, spans) -> bytes:
        from gubernator_tpu_torch.service.wire import (
            encode_response_columns,
            item_from_span,
            subset_wire,
        )

        cols = wb.cols
        n = cols.fp.shape[0]
        force_global = self.conf.behaviors.force_global
        if force_global:
            # GLOBAL is kernel-inert (dropped on the compact wire), so the
            # routing-only behavior flip leaves the parser's lanes valid
            cols = cols._replace(
                behavior=cols.behavior | np.int32(int(Behavior.GLOBAL))
            )
            wb = wb._replace(cols=cols)

        def materialize(i):
            """Lazy pb item from its wire span; a forced GLOBAL bit must
            follow the item into queues/forwards (the pb path mutates items
            in place, gubernator.go:239-241)."""
            item = item_from_span(data, spans[i])
            if force_global:
                item.behavior |= int(Behavior.GLOBAL)
            return item
        status = np.zeros(n, dtype=np.int64)
        limit = np.zeros(n, dtype=np.int64)
        remaining = np.zeros(n, dtype=np.int64)
        reset = np.zeros(n, dtype=np.int64)
        errors: Dict[int, str] = {
            int(i): ERROR_STRINGS[int(cols.err[i])]
            for i in np.nonzero(cols.err)[0]
        }
        valid = cols.err == 0
        is_global = (cols.behavior & np.int32(int(Behavior.GLOBAL))) != 0
        is_mr = (cols.behavior & np.int32(int(Behavior.MULTI_REGION))) != 0

        if self._local_picker.size() == 0:
            mine = valid
        else:
            owners = self._local_picker.owners_of(ring)
            self_addr = self.conf.advertise_address
            mine = valid & np.fromiter(
                (o.grpc_address == self_addr for o in owners), bool, n
            )
        local_rows = np.nonzero(mine)[0]
        global_rows = np.nonzero(valid & ~mine & is_global)[0]
        fwd_rows = np.nonzero(valid & ~mine & ~is_global)[0]
        if self._local_picker.size() > 0:
            if self.conf.behaviors.handoff_enabled and local_rows.size:
                # handoff sidecar: the native parser already computed each
                # item's ring point — record owned rows vectorized
                self.ownership.record(cols.fp[local_rows], ring[local_rows])
            # clustered: keep owner-side GLOBAL authoritative (see _route)
            lg = local_rows[is_global[local_rows]]
            if lg.size:
                cols.behavior[lg] &= ~np.int32(int(Behavior.GLOBAL))

        def place(rows, rc) -> None:
            status[rows] = rc.status
            limit[rows] = rc.limit
            remaining[rows] = rc.remaining
            reset[rows] = rc.reset_time
            for j, i in enumerate(rows):
                if rc.err[j]:
                    errors[int(i)] = ERROR_STRINGS[int(rc.err[j])]

        async def run_local():
            # the WireBatch subset keeps the parser's pre-packed lanes with
            # the columns — an all-local encodable batch stages straight
            # into the dispatch grid (fused path, service/batcher.py)
            rc = await self.batcher.check(subset_wire(wb, local_rows))
            place(local_rows, rc)

        async def run_global():
            # answer from local state with GLOBAL stripped + NO_BATCHING
            # forced, and queue the async hits (gubernator.go:401-429).
            # Both touched bits are kernel-inert — the lane image stays
            # valid, so the fused path serves GLOBAL answer rows too.
            g = subset_wire(wb, global_rows)
            g = g._replace(
                cols=g.cols._replace(
                    behavior=(g.cols.behavior & ~np.int32(int(Behavior.GLOBAL)))
                    | np.int32(int(Behavior.NO_BATCHING))
                )
            )
            for i in global_rows:
                item = materialize(i)
                self.global_manager.queue_hit(
                    item.name + "_" + item.unique_key, item
                )
            rc = await self.batcher.check(g)
            place(global_rows, rc)

        degraded_rows: set = set()

        async def run_forward(row: int):
            item = materialize(row)
            out: List[Optional[pb.RateLimitResp]] = [None]
            await self._forward(0, item.name + "_" + item.unique_key, item, out)
            r = out[0]
            status[row] = r.status
            limit[row] = r.limit
            remaining[row] = r.remaining
            reset[row] = r.reset_time
            if r.error:
                errors[int(row)] = r.error
            if "degraded" in r.metadata:
                degraded_rows.add(int(row))

        tasks = []
        if local_rows.size:
            tasks.append(run_local())
        if global_rows.size:
            tasks.append(run_global())
        tasks.extend(run_forward(int(i)) for i in fwd_rows)
        if tasks:
            await asyncio.gather(*tasks)
        # owner-side GLOBAL broadcasts + MULTI_REGION replication (standalone
        # mesh-global daemons skip queue_update — see _route)
        if not (
            self._local_picker.size() == 0
            and getattr(self.engine, "mesh_global", False)
        ):
            for i in local_rows[is_global[local_rows]]:
                item = materialize(i)
                self.global_manager.queue_update(
                    item.name + "_" + item.unique_key, item
                )
        for i in local_rows[is_mr[local_rows]]:
            item = materialize(i)
            self.region_manager.queue_hit(
                item.name + "_" + item.unique_key, item
            )
        over = int((status == int(pb.OVER_LIMIT)).sum())
        if over:
            self.metrics.over_limit_counter.inc(over)
        if degraded_rows:
            # degraded responses carry the metadata marker, which the native
            # encoder does not emit — partitions are the rare path, so fall
            # back to pb encoding for the whole batch
            resps = []
            for i in range(n):
                r = pb.RateLimitResp(
                    status=int(status[i]),
                    limit=int(limit[i]),
                    remaining=int(remaining[i]),
                    reset_time=int(reset[i]),
                    error=errors.get(i, ""),
                )
                if i in degraded_rows:
                    r.metadata["degraded"] = "true"
                resps.append(r)
            return pb.GetRateLimitsResp(responses=resps).SerializeToString()
        t0 = time.perf_counter()
        now = self.now_ms()  # retry_after_ms metadata basis (denied rows)
        if n * 8 >= self.DOOR_OFFLOAD_BYTES:
            # native encode drops the GIL — responder workers encode big
            # batches in parallel off the event loop
            out_bytes = await asyncio.get_running_loop().run_in_executor(
                self._door,
                encode_response_columns,
                status, limit, remaining, reset, errors, now,
            )
        else:
            out_bytes = encode_response_columns(
                status, limit, remaining, reset, errors, now
            )
        self._observe_request_stage(
            "encode", time.perf_counter() - t0, tracing.current_span()
        )
        return out_bytes

    def _observe_request_stage(self, stage: str, dt_s: float, span) -> None:
        """One request-scoped stage (parse/encode — stages that belong to a
        single request, unlike the per-flush queue/put/issue/fetch): the
        histogram sample carries the REQUEST trace as its exemplar and the
        child span hangs under the request span."""
        self.metrics.stage_duration.labels(stage=stage).observe(
            dt_s,
            exemplar={"trace_id": span.trace_id} if span is not None else None,
        )
        if span is not None and tracing.exporter is not None:
            end_ns = time.time_ns()
            tracing.record_span(
                stage, tracing.new_span(span), span.span_id,
                end_ns - int(dt_s * 1e9), end_ns,
            )

    def _emit_event(self, item, resp) -> None:
        if resp is None:  # pragma: no cover - defensive
            return
        try:
            self.event_channel.put_nowait(HitEvent(request=item, response=resp))
        except asyncio.QueueFull:
            self.events_dropped += 1

    async def _check_rows(self, cols, rows: np.ndarray, out, items=None) -> None:
        await self._check_subset(subset_columns(cols, rows), rows, out, items)

    async def _check_subset(self, sub, rows: np.ndarray, out, items=None) -> None:
        """Serve a column subset through the batcher. `items` (the full pb
        item list, indexed by the ORIGINAL row ids in `rows`) enables
        cascade expansion: every level of a cascade request becomes one
        engine row — all levels of all requests still resolve in a single
        engine dispatch — and the per-level responses contract back into
        the top-level response's `cascade` list."""
        resps = await self._serve_items(sub, (
            None if items is None else [items[int(i)] for i in rows]
        ))
        for j, i in enumerate(rows):
            out[int(i)] = resps[j]

    async def _serve_items(self, cols, items) -> "List[pb.RateLimitResp]":
        """Columns (+ aligned pb items, for cascade expansion) → pb
        responses via one batcher dispatch."""
        exp, counts = expand_cascades(
            cols, items, self.conf.cascade_max_levels
        )
        rc = await self.batcher.check(exp)
        now = self.now_ms()
        if counts is None:
            return pb_from_response_columns(rc, now_ms=now)
        for m in counts:
            if m:
                self.metrics.cascade_depth.observe(1 + m)
        return pb_from_cascade_response_columns(
            rc, counts, self.conf.cascade_max_levels, now_ms=now
        )

    async def _forward(self, row: int, key: str, item, out) -> None:
        """Forward to the owner with ownership re-resolution on failure
        (reference asyncRequest, gubernator.go:318-399), consulting the
        owner's circuit breaker: an open breaker fails fast (no RPC, no
        timeout wait) straight into the degradation policy, and retry
        sleeps are jittered-exponential instead of fixed-linear (Dean &
        Barroso, *The Tail at Scale*)."""
        last_err = "no peers available"
        for attempt in range(FORWARD_RETRIES):
            try:
                info = self.get_peer(key)
            except Exception as exc:
                last_err = str(exc)
                break
            if self.is_self(info):
                # ownership moved to us mid-flight — serve locally
                cols, _ = columns_from_pb([item])
                out[row] = (await self._serve_items(cols, [item]))[0]
                return
            client = self.peer_client(info)
            if client is None:
                last_err = f"no client for peer {info.grpc_address}"
                break
            try:
                out[row] = await client.get_peer_rate_limit(item)
                return
            except PeerCircuitOpenError as exc:
                # cooling down: retrying the same owner is pointless until
                # the breaker half-opens — degrade/error immediately
                last_err = str(exc)
                break
            except PeerError as exc:
                last_err = str(exc)
                self.metrics.batch_send_retries.inc()
                await asyncio.sleep(random.uniform(0, 0.002 * (2**attempt)))
        await self._forward_fallback(row, key, item, out, last_err)

    async def _forward_fallback(self, row: int, key: str, item, out, last_err) -> None:
        """Owner unreachable: apply the degradation policy. LOCAL answers
        from this daemon's own store (route-around first for pure reads),
        marked metadata["degraded"]="true"; ERROR keeps the reference's
        error response (gubernator.go:389-398)."""
        if (
            self.conf.behaviors.degradation_policy
            == DegradationPolicy.LOCAL.value
        ):
            if item.hits == 0:
                resp = await self._forward_around(key, item)
                if resp is not None:
                    out[row] = resp
                    return
            out[row] = await self._degraded_local(item)
            return
        self.metrics.check_error_counter.labels(error="forward").inc()
        out[row] = pb.RateLimitResp(
            error=f"Error while fetching rate limit from peer: {last_err}"
        )

    async def _forward_around(self, key: str, item) -> Optional["pb.RateLimitResp"]:
        """Route a zero-hit read around the dead owner to the next live peer
        on the ring — its replica state (GLOBAL broadcasts) may be fresher
        than ours. Returns None when no usable alternate exists (the local
        fallback handles it)."""
        try:
            owner = self.get_peer(key)
        except Exception:
            return None
        exclude = {owner.grpc_address}
        for addr, client in self._peer_clients.items():
            if client.breaker.blocked:
                exclude.add(addr)
        try:
            alt = self._local_picker.get(key, frozenset(exclude))
        except RuntimeError:
            return None
        if self.is_self(alt):
            return None
        client = self.peer_client(alt)
        if client is None:
            return None
        try:
            resp = await client.get_peer_rate_limit(item)
        except PeerError:
            return None
        resp.metadata["degraded"] = "true"
        self.metrics.degraded_responses.inc()
        return resp

    async def _degraded_local(self, item) -> "pb.RateLimitResp":
        """Best-effort local decision against this daemon's own store —
        clients keep getting rate-limit answers during partitions, each
        marked degraded so callers can tell it is not owner-authoritative."""
        cols, _ = columns_from_pb([item])
        resp = (await self._serve_items(cols, [item]))[0]
        resp.metadata["degraded"] = "true"
        self.metrics.degraded_responses.inc()
        return resp

    # --------------------------------------------------------- peers service
    async def get_peer_rate_limits(
        self, req: "peers_pb.GetPeerRateLimitsReq"
    ) -> "peers_pb.GetPeerRateLimitsResp":
        """Owner executes a forwarded/async batch (reference
        gubernator.go:476-559). GLOBAL-accumulated hits apply with
        DRAIN_OVER_LIMIT forced (gubernator.go:526-532)."""
        items = list(req.requests)
        # pick up the forwarder's trace context (reference gubernator.go:522-524
        # extracts the propagated TraceContext from request metadata)
        token = None
        for it in items:
            parent = tracing.extract(it.metadata)
            if parent is not None:
                token = tracing.start_scope("GetPeerRateLimits", parent)
                break
        try:
            return await self._get_peer_rate_limits(items)
        finally:
            if token is not None:
                tracing.end_scope(token)

    async def _get_peer_rate_limits(
        self, items
    ) -> "peers_pb.GetPeerRateLimitsResp":
        for it in items:
            if has_behavior(it.behavior, Behavior.GLOBAL):
                it.behavior |= int(Behavior.DRAIN_OVER_LIMIT)
        cols, hash_keys = columns_from_pb(items)
        if self._local_picker.size() > 0 and self.conf.behaviors.handoff_enabled:
            # forwarded batches execute owner-side too: record their ring
            # points for the handoff sidecar
            ok = [i for i in range(len(items)) if cols.err[i] == 0]
            self.ownership.record_keys(
                (cols.fp[i] for i in ok),
                (hash_keys[i] for i in ok),
                self._local_picker.hash_fn,
            )
        # strip GLOBAL before the local check so the engine path does not
        # depend on it; broadcast queueing happens below. Forwarded cascade
        # requests execute owner-side HERE — same expansion/contraction as
        # the front door, so the forwarder receives the folded verdict +
        # per-level sub-responses over the peer wire unchanged.
        cols = cols._replace(behavior=cols.behavior & ~np.int32(int(Behavior.GLOBAL)))
        resps = await self._serve_items(cols, items)
        for i, it in enumerate(items):
            if cols.err[i] != 0:
                continue
            if has_behavior(it.behavior, Behavior.GLOBAL):
                self.global_manager.queue_update(hash_keys[i], it)
            # forwarded MULTI_REGION hits reach the owner HERE, not in _route
            # — they must replicate cross-region too (replicated copies have
            # MULTI_REGION stripped by RegionManager, so no ping-pong)
            if has_behavior(it.behavior, Behavior.MULTI_REGION):
                self.region_manager.queue_hit(hash_keys[i], it)
        if self.event_channel is not None:
            # peer-batch execution is owner-side too (the reference's event
            # fires inside getLocalRateLimit, on every owner execution)
            for it, r in zip(items, resps):
                self._emit_event(it, r)
        return peers_pb.GetPeerRateLimitsResp(rate_limits=resps)

    async def update_peer_globals(
        self, req: "peers_pb.UpdatePeerGlobalsReq"
    ) -> "peers_pb.UpdatePeerGlobalsResp":
        """Install owner-authoritative statuses (reference gubernator.go:434-474)."""
        g = list(req.globals)
        n = len(g)
        if n:
            fp = np.fromiter((_hashkey_fp(u.key) for u in g), dtype=np.int64, count=n)
            remaining = np.fromiter(
                (u.status.remaining for u in g), dtype=np.int64, count=n
            )
            # sliding-window fidelity metadata (w_prev / w_rem — see
            # global_manager._broadcast): replicas interpolate the same
            # `used` as the owner. Absent (old senders / non-window rows)
            # the install falls back to the conservative weighted rebuild.
            aux = np.zeros(n, dtype=np.int64)
            rem_store = remaining.copy()
            has_meta = False
            for i, u in enumerate(g):
                md = u.status.metadata
                if "w_prev" in md:
                    try:
                        aux[i] = int(md["w_prev"])
                        rem_store[i] = int(md.get("w_rem", remaining[i]))
                        has_meta = True
                    except ValueError:
                        pass
            await self.runner.install_columns(
                fp=fp,
                algo=np.fromiter((u.algorithm for u in g), dtype=np.int32, count=n),
                status=np.fromiter(
                    (u.status.status for u in g), dtype=np.int32, count=n
                ),
                limit=np.fromiter((u.status.limit for u in g), dtype=np.int64, count=n),
                remaining=remaining,
                reset_time=np.fromiter(
                    (u.status.reset_time for u in g), dtype=np.int64, count=n
                ),
                duration=np.fromiter((u.duration for u in g), dtype=np.int64, count=n),
                aux=aux if has_meta else None,
                rem_store=rem_store if has_meta else None,
            )
            self.metrics.updates_installed.inc(n)
            self.metrics.broadcast_counter.labels(
                condition="update_peer_globals"
            ).inc()
        return peers_pb.UpdatePeerGlobalsResp()

    async def sync_globals_wire(
        self, req: "globalsync_pb.SyncGlobalsWireReq"
    ) -> "globalsync_pb.SyncGlobalsWireResp":
        """Receive one compact inter-slice GLOBAL hit-sync batch
        (service/wire.sync_wire_items): decode the lane image back to
        items and drive them through the exact owner path the proto
        GetPeerRateLimits fallback drives — DRAIN forced, broadcast
        queueing, MULTI_REGION replication (excluded by the codec's
        encodability rule) all behave identically."""
        from gubernator_tpu_torch.service.wire import sync_wire_items

        items = sync_wire_items(req)
        self.metrics.global_wire_entries.labels(direction="recv").inc(
            len(items)
        )
        await self._get_peer_rate_limits(items)
        return globalsync_pb.SyncGlobalsWireResp(applied=len(items))

    async def sync_regions_wire(self, req):
        """Receive one compact cross-region delta batch
        (service/wire.sync_regions_pb): decode the lane image + hit-delta
        sidecar + the sender's stored rows, and reconcile through the
        conservative merge kernel (ops/reconcile.apply_region_sync → ONE
        engine job → kernel2.merge2) — never the serving path, so a
        replicated batch cannot queue broadcasts or re-replicate
        (ping-pong is structurally impossible). The sender's rows arrive
        in ITS slot layout and convert through the canonical full row
        (the one conversion point), so a packed-layout sender cannot
        corrupt or over-grant a differently-laid-out receiver.

        The body runs SHIELDED: once the merge job is committed to the
        engine thread it will land whether or not the sender's RPC
        deadline survives, so the apply and its accounting (note_recv,
        ownership sidecar) can never be split by a client-side cancel —
        the sender's retry then re-applies a FULLY accounted batch, which
        the merge turns into under-grant, never a half-recorded one."""
        task = asyncio.ensure_future(self._sync_regions_wire(req))
        return await asyncio.shield(task)

    async def _sync_regions_wire(self, req):
        from gubernator_tpu_torch.proto import regionsync_pb2 as regionsync_pb
        from gubernator_tpu_torch.service.wire import sync_regions_arrays

        fps, deltas, cfg, hash_keys, slots, layout, cums = (
            sync_regions_arrays(req)
        )
        # per-source exact dedup: a re-shipped batch (lost ack + sender
        # requeue) applies only the hits this receiver has not merged yet
        # — convergence stays exact under retries. The ledger commits only
        # after the merge lands (this handler runs shielded, so the pair
        # cannot be split by a client-side cancel).
        deltas, commit_dedup = self.region_manager.dedup_recv(
            req.source, fps, deltas, cums
        )
        applied = await self.runner.apply_region(
            fps, deltas, cfg, slots, layout
        )
        commit_dedup()
        if (
            self._local_picker.size() > 0
            and self.conf.behaviors.handoff_enabled
        ):
            # merged rows live on this daemon now: record their ring points
            # so a later rebalance can route them onward (handoff sidecar).
            # Steady-state rows travel string-less ("" marker) — their
            # points were recorded by the key's bootstrap batch.
            idx = [i for i, k in enumerate(hash_keys) if k]
            if idx:
                self.ownership.record_keys(
                    (fps[i] for i in idx),
                    (hash_keys[i] for i in idx),
                    self._local_picker.hash_fn,
                )
        self.region_manager.note_recv(len(hash_keys), applied)
        return regionsync_pb.SyncRegionsWireResp(applied=applied)

    async def transfer_state(
        self, req: "handoff_pb.TransferStateReq"
    ) -> "handoff_pb.TransferStateResp":
        """Receive one ownership-handoff chunk (service/handoff.py): merge
        the rows through the conservative merge kernel (kernel2.merge2 —
        remaining=min, expiry=max, newest config wins) and remember their
        ring points so a later rebalance can route them onward. Idempotent:
        a replayed (transfer_id, chunk) answers from the ledger without
        re-merging — and the merge semantics make even a ledger miss
        harmless (min/max can only tighten)."""
        from gubernator_tpu_torch.service.wire import transfer_chunk_arrays

        key = (req.transfer_id, int(req.chunk))
        cached = self._applied_transfers.get(key)
        if cached is not None:
            return handoff_pb.TransferStateResp(merged=cached, duplicate=True)
        fps, points, slots, chunk_layout = transfer_chunk_arrays(req)
        merged = await self.runner.merge_rows(fps, slots, layout=chunk_layout)
        self.ownership.record(fps, points)
        self.metrics.handoff_rows.labels(phase="merged").inc(merged)
        self._applied_transfers[key] = merged
        while len(self._applied_transfers) > 4096:
            self._applied_transfers.popitem(last=False)
        return handoff_pb.TransferStateResp(merged=merged)

    # ------------------------------------------------------------ debug plane
    # JSON snapshots behind /v1/debug/{table,pipeline,peers,global}
    # (docs/observability.md): what to look at when p99 regresses (pipeline),
    # when evictions start (table), when forwards fail (peers), and when
    # GLOBAL convergence lags (global).

    async def debug_table(self) -> dict:
        """Latest table-telemetry snapshot; scans on demand when the
        background cadence is disabled or has not ticked yet. Grows the
        cumulative live-eviction count (the state-loss signal tiering
        turns into demotions — gubernator_tpu_evicted_live_total) and a
        tiering summary when the plane is armed."""
        snap = self._table_telemetry
        if snap is None:
            snap = await self.collect_telemetry()
        out = snap.to_dict()
        out["evicted_live_total"] = self.engine.stats.evicted_unexpired
        if self.tier.enabled:
            out["tiering"] = {
                "shadow_rows": self.tier.shadow.ram_rows,
                "tracked_rows": self.tier.shadow.tracked_rows,
            }
        return out

    def debug_tier(self) -> dict:
        """Hot-set tiering plane: shadow occupancy/bounds, demote/promote
        counters, spill state — what an operator checks when capacity or
        fault-back behavior is in question."""
        return self.tier.debug()

    def debug_durability(self) -> dict:
        """Durability plane: checkpoint epoch freshness, delta-log volume,
        compaction progress and the last persistence error — what an
        operator checks before trusting a rolling restart (or after an
        unclean one)."""
        out = self.checkpointer.status()
        self.metrics.checkpoint_epoch_age.set(
            self.checkpointer.epoch_age_s() if self.checkpointer.enabled
            else 0.0
        )
        loader = self._loader()
        out["loader"] = type(loader).__name__ if loader is not None else None
        return out

    def debug_regions(self) -> dict:
        """Multi-region replication plane: per-region breaker states, queue
        depths, last-sync ages, wire-vs-fallback counts — what an operator
        checks when a partition is suspected or after a heal (is the
        backlog draining?)."""
        out = self.region_manager.debug()
        self.metrics.region_sync_staleness.set(out["staleness_s"])
        return out

    def debug_leases(self) -> dict:
        """Edge quota-lease plane: outstanding tokens per key, grant/renew/
        return/expire rates, and the live over-admission bound = Σ
        outstanding leased tokens."""
        out = self.lease_manager.debug()
        self.metrics.lease_outstanding.set(out["outstanding_tokens_total"])
        return out

    def debug_pipeline(self) -> dict:
        """Front-door + engine pipeline state: ring depth, worker liveness,
        dispatch-path counters, adaptive-close reasons, engine identity."""
        from gubernator_tpu_torch import native

        eng = self.engine
        return {
            "batcher": self.batcher.debug(),
            # which ingress parser serves: "native" (the C++ extension) or
            # "protobuf" (GUBER_NATIVE=0 or no toolchain)
            "parser": native.parser(),
            "engine": {
                "kind": type(eng).__name__,
                "device": str(getattr(eng, "device", None)),
                "wire": getattr(eng, "wire", None),
                "write_mode": getattr(eng, "write_mode", None),
                # table-walk kernel (GUBER_PROBE_KERNEL) + the modeled HBM
                # bytes/decision at the current layout × write × geometry —
                # the live view of gubernator_table_hbm_bytes_per_decision
                "probe_kernel": getattr(eng, "probe_mode", None),
                "hbm_bytes_per_decision": (
                    round(eng.hbm_bytes_per_decision_estimate(), 1)
                    if hasattr(eng, "hbm_bytes_per_decision_estimate")
                    else None
                ),
                "n_shards": getattr(eng, "n_shards", 1),
                "n_hosts": getattr(eng, "n_hosts", 1),
                "devices_per_host": getattr(eng, "devices_per_host", None),
                "route": getattr(eng, "route", None),
                "dedup": getattr(eng, "dedup", None),
                "a2a_impl": getattr(eng, "a2a_impl", None),
                # exchange capacity-overflow rows (FLAG_UNPROCESSED before
                # reaching a kernel): the live view of
                # gubernator_tpu_a2a_overflow_total — sustained growth means
                # pair_capacity is undersized for the traffic's skew
                # (GUBER_A2A_CAPACITY_SIGMA)
                "a2a_overflow": getattr(eng, "a2a_overflow", 0),
                "poisoned": getattr(eng, "poisoned", None),
                "checks": eng.stats.checks,
                "dispatches": eng.stats.dispatches,
                "dropped": eng.stats.dropped,
            },
            # per-algorithm decision counts (live view of
            # gubernator_tpu_decisions_total) — scenario breadth at a glance
            "decisions_by_algorithm": dict(self.runner.algo_counts),
            "cascade_max_levels": self.conf.cascade_max_levels,
            "pipeline_inflight": self.conf.behaviors.pipeline_inflight,
            "concurrent_checks": self.metrics.concurrent_checks._value.get(),
        }

    def debug_peers(self) -> dict:
        """Peer plane: per-peer breaker state + recent errors, and ownership
        handoff progress."""
        peers = []
        for addr, client in self._peer_clients.items():
            peers.append({
                "address": addr,
                "breaker_state": client.breaker.state_name,
                "recent_errors": client.recent_errors()[:5],
            })
        h = self.handoff
        return {
            "self": self.conf.advertise_address,
            "local_peer_count": self._local_picker.size(),
            "region_peer_count": self._region_picker.size(),
            "leaving": self._leaving,
            "peers": peers,
            "handoff": {
                "enabled": h.enabled,
                "active": h.active,
                "rounds": h.rounds,
                "last_round": dict(h.last_round),
                "tracked_fps": len(self.ownership),
            },
        }

    def debug_global(self) -> dict:
        """GLOBAL behavior: cross-daemon queue ages + mesh outbox depth —
        the convergence-lag view behind the staleness gauge."""
        out = {
            "staleness_s": round(self.global_sync_staleness_s(), 3),
            "manager": self.global_manager.debug(),
        }
        self.metrics.global_sync_staleness.set(out["staleness_s"])
        if getattr(self.engine, "mesh_global", False):
            gs = self.engine.global_stats
            out["mesh"] = {
                "pending": sum(len(p) for p in self.engine.pending),
                "oldest_age_s": round(self.engine.oldest_pending_age_s(), 3),
                "sync_rounds": gs.sync_rounds,
                "hits_queued": gs.hits_queued,
                "broadcasts_applied": gs.broadcasts_applied,
                "updates_installed": gs.updates_installed,
            }
        return out

    # ----------------------------------------------------------------- health
    async def health_check(self) -> "pb.HealthCheckResp":
        """Aggregate per-peer recent errors + breaker states (reference
        gubernator.go:562-643). Tri-state status so probes can tell a
        *degraded* instance (peer errors / open breakers, still serving
        every request) from an *unhealthy* one (structurally broken —
        e.g. not in its own peer list)."""
        errs: List[str] = []
        breaker_alarm = False
        local = self.local_peers()
        for c in self._peer_clients.values():
            errs.extend(c.recent_errors())
            if c.breaker.state is not BreakerState.CLOSED:
                breaker_alarm = True
        fatal: List[str] = []
        if local and not any(self.is_self(p) for p in local):
            fatal.append(
                f"this instance ({self.conf.advertise_address}) is not in the peer list"
            )
        poisoned = getattr(self.engine, "poisoned", None)
        if poisoned:
            # a donated collective launch died mid-flight: the engine's
            # device buffers are suspect, so this instance must read
            # unhealthy even though the process is alive
            fatal.append(f"engine poisoned: {poisoned}")
        if self._leaving:
            # graceful drain in progress: probes and peers must route around
            # this instance BEFORE it disappears (its owned state is moving
            # to the ring successors right now)
            status = "leaving"
        elif fatal:
            status = "unhealthy"
        elif errs or breaker_alarm:
            status = "degraded"
        else:
            status = "healthy"
        resp = pb.HealthCheckResp(
            status=status,
            message="; ".join((fatal + errs)[:5]),
            peer_count=self._local_picker.size() + self._region_picker.size(),
            advertise_address=self.conf.advertise_address,
            region=self.conf.data_center,
        )

        def peer_entry(p: PeerInfo) -> "pb.PeerHealthResp":
            e = pb.PeerHealthResp(
                grpc_address=p.grpc_address, data_center=p.data_center
            )
            c = self._peer_clients.get(p.grpc_address)
            if c is not None:  # no client toward self
                e.breaker_state = c.breaker.state_name
                e.recent_errors.extend(c.recent_errors()[:5])
            return e

        for p in local:
            resp.local_peers.append(peer_entry(p))
        for p in self.region_peers():
            resp.region_peers.append(peer_entry(p))
        return resp

    def live_check(self) -> "pb.LiveCheckResp":
        """Liveness gate (reference gubernator.go:646-651): fails during
        shutdown so load balancers de-register before the listeners close."""
        if self._shutting_down:
            raise RuntimeError("shutting down")
        return pb.LiveCheckResp()

    # ------------------------------------------------------------ checkpoint
    def _loader(self):
        """The active Loader: an injected one, else a FileLoader over
        GUBER_CHECKPOINT_PATH, else None (reference wires Loader the same
        way — an embedding hook the server binary points at a file,
        store.go:49-60)."""
        if self.loader is not None:
            return self.loader
        if self.conf.checkpoint_path:
            from gubernator_tpu_torch.store import FileLoader

            return FileLoader(self.conf.checkpoint_path)
        return None

    def maybe_restore(self) -> None:
        """Boot-time restore. The incremental plane replays base + delta
        frames (service/checkpoint.py); the classic Loader path loads one
        snapshot. EITHER degrades to a logged cold start on damage — a
        snapshot whose geometry/schema no longer matches the configured
        table (cache_size changed across restart), a corrupt file, or a
        loader that throws must never kill the boot."""
        if self.checkpointer.enabled:
            self.checkpointer.restore()
            return
        loader = self._loader()
        if loader is None:
            return
        try:
            rows = loader.load()
            if rows is not None:
                self.engine.restore(np.asarray(rows))
        except Exception:
            log.warning(
                "checkpoint restore failed; starting cold", exc_info=True
            )
            self.metrics.checkpoint_errors.labels(stage="restore").inc()

    def maybe_checkpoint(self) -> None:
        """Shutdown snapshot through the Loader hook. Guarded: a failed
        save (disk full, unwritable path) is logged + counted — it must
        never wedge close() before _door.shutdown/runner.close run."""
        loader = self._loader()
        if loader is None:
            return
        try:
            rows = self.runner.snapshot_sync()
            lay = self.engine.table.layout
            try:
                # FileLoader records the slot layout so a later meta read
                # interprets the bytes; Loader subclasses without the kw
                # keep the classic single-arg contract
                loader.save(rows, layout_name=lay.name)
            except TypeError:
                loader.save(rows)
        except Exception:
            log.exception("shutdown checkpoint failed; state not persisted")
            self.metrics.checkpoint_errors.labels(stage="shutdown").inc()

    # ---------------------------------------------------------------- close
    async def abort(self) -> None:
        """Unclean-death surface for chaos tests — the in-process analog of
        `kill -9`: listeners, loops and executors stop, but NOTHING runs
        that a SIGKILL would skip — no drain, no GLOBAL flush, no handoff,
        no final checkpoint. Whatever the incremental checkpoint plane
        already made durable is ALL a restart gets."""
        if self._shutting_down:
            return
        self._shutting_down = True
        for t in (
            self._cert_watch_task, self._maintenance_task,
            self._global_sync_task, self._telemetry_task,
            self._checkpoint_task, self._tier_task, *self._handoff_tasks,
        ):
            if t is not None:
                t.cancel()
        if self._pool is not None:
            await self._pool.close()
        # kill the GLOBAL/region loops WITHOUT the flush their close() does
        for t in (
            *self.global_manager._tasks,
            *([self.region_manager._task]
              if self.region_manager._task is not None else []),
        ):
            t.cancel()
        await asyncio.gather(
            *(c.shutdown() for c in self._peer_clients.values()),
            *(c.shutdown() for c in self._orphaned_clients),
            return_exceptions=True,
        )
        self._orphaned_clients = []
        for s in self._servers:
            await s.stop()
        self._door.shutdown(wait=False)
        self.runner.close()

    async def stop(self, drain: bool = False) -> None:
        """Graceful shutdown; `drain=True` additionally hands every owned
        live row to its ring successor before the listeners close (the
        deployable-under-load path, docs/robustness.md "Topology change &
        drain")."""
        await self.close(drain=drain)

    async def close(self, drain: bool = False) -> None:
        """Graceful shutdown (reference daemon.go:388-434): stop intake,
        drain batches + global queues, [hand off owned state], checkpoint,
        stop listeners."""
        if self._shutting_down:
            return
        if drain:
            # health flips to "leaving" first so probes/peers route around
            # this instance while its state moves
            self._leaving = True
        self._shutting_down = True  # live_check now fails → LBs de-register
        if self.conf.graceful_termination_delay_s > 0:
            # keep serving while load balancers notice the failing liveness
            # probe (reference daemon.go:389-391)
            await asyncio.sleep(self.conf.graceful_termination_delay_s)
        for t in (
            self._cert_watch_task, self._maintenance_task,
            self._global_sync_task, self._telemetry_task,
            self._checkpoint_task, self._tier_task,
        ):
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
        if self._pool is not None:
            await self._pool.close()
        # in-flight rebalance handoffs yield to the final drain pass (or to
        # plain shutdown — their rows simply stay local)
        for t in list(self._handoff_tasks):
            t.cancel()
        if self._handoff_tasks:
            await asyncio.gather(*self._handoff_tasks, return_exceptions=True)
        await self.global_manager.close()  # flushes pending GLOBAL queues
        await self.region_manager.close()
        await self.batcher.drain()
        if self.ring is not None:
            # after the batcher: its drain flushes pending chunks THROUGH
            # the ring; only then can the ring retire every published
            # ticket and park the serving loop (zero-loss ordering)
            await self.ring.drain()
        if drain and self.conf.behaviors.handoff_enabled:
            # hand owned live rows to ring successors under the deadline;
            # whatever stays unacked is snapshotted by maybe_checkpoint below
            try:
                await self.handoff.drain()
            except Exception:  # pragma: no cover - defensive
                log.exception("graceful drain handoff failed")
        await asyncio.gather(
            *(c.shutdown() for c in self._peer_clients.values()),
            *(c.shutdown() for c in self._orphaned_clients),
            return_exceptions=True,
        )
        self._orphaned_clients = []
        for s in self._servers:
            await s.stop()
        if getattr(self.engine, "mesh_global", False) and self.engine.has_pending():
            # final collective flush so queued GLOBAL hits reach their owner
            # shards before the checkpoint (global_manager.close analog)
            await self.runner.sync_global()
        if self.tier.enabled:
            # persist unspilled shadow rows so a graceful restart faults
            # them back from disk (no-op without a spill file). Guarded:
            # shutdown always completes.
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, lambda: self.tier.close(self.now_ms())
                )
            except Exception:
                log.exception("tier shadow flush failed")
        if self.checkpointer.enabled:
            # incremental plane: one last compaction folds the delta log
            # into the base so a restart replays nothing. Guarded like
            # maybe_checkpoint — shutdown always completes.
            try:
                await self.checkpointer.final_checkpoint()
            except Exception:
                log.exception("final checkpoint compaction failed")
                self.metrics.checkpoint_errors.labels(stage="shutdown").inc()
        else:
            self.maybe_checkpoint()
        self._door.shutdown(wait=True)
        self.runner.close()
        if tracing.exporter is not None:
            # flush (not close): the exporter is process-global and other
            # daemons in this process may still be serving. Off-loop — the
            # flush POST blocks up to its timeout
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, tracing.exporter.flush
                )
            except Exception:  # pragma: no cover - defensive
                log.exception("trace export flush failed")
