"""Prometheus metrics for the daemon — load-bearing for convergence tests.

The reference's functional suite asserts distributed behavior by scraping each
node's /metrics endpoint and checking exact counter values (reference
functional_test.go:1760-2167 via getMetrics/waitForBroadcast; series catalog
docs/prometheus.md:17-43). This module exposes the same-named series backed by
the TPU engine's host-side counters, on a PRIVATE registry per daemon so an
in-process test cluster scrapes N independent endpoints.
"""

from __future__ import annotations

import logging

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    Summary,
    generate_latest,
)
from prometheus_client.core import CounterMetricFamily
from prometheus_client.openmetrics import exposition as om_exposition
from prometheus_client.parser import text_string_to_metric_families

# one bucket scheme for every request/stage-latency histogram on the serving
# path (stage_duration; grpc_request_duration/batch_send_duration
# since the observability PR — Summaries hid exactly the tails the serving
# plane is judged on, and Summaries cannot carry OpenMetrics exemplars)
LATENCY_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 10.0,
)


class _OtelSpanCollector:
    """Surfaces the process-global OTLP exporter's own health as scrapeable
    series (gubernator_otel_spans_*): export failures used to be counted in
    exporter attributes nobody could scrape — a silently dead trace pipeline
    looked identical to an idle one. Reads tracing.exporter at collect time
    (zeros when no exporter is configured), so every daemon's registry in a
    shared process reports the shared pipeline, like the process collectors
    do."""

    def collect(self):
        from gubernator_tpu_torch import tracing

        exp = tracing.exporter
        for name, doc, value in (
            ("exported", "Spans successfully exported over OTLP",
             getattr(exp, "exported", 0)),
            ("dropped", "Spans dropped by the bounded export buffer",
             getattr(exp, "dropped", 0)),
            ("export_errors", "Failed OTLP export POSTs (batch dropped)",
             getattr(exp, "export_errors", 0)),
        ):
            fam = CounterMetricFamily(f"gubernator_otel_spans_{name}", doc)
            fam.add_metric([], value)
            yield fam


class DaemonMetrics:
    """One daemon's metric family set (names mirror docs/prometheus.md).

    `metric_flags` (GUBER_METRIC_FLAGS, comma-separated) opts into optional
    runtime collectors, mirroring the reference's FlagOSMetrics /
    FlagGolangMetrics (reference flags.go:19-57, daemon.go:293-306):
      * "os"     → process collector (RSS/vsize, fds, CPU seconds, start
                   time) under the gubernator namespace;
      * "python" → interpreter runtime collectors (GC generations +
                   platform info), the analog of the reference's Go
                   collector ("golang" accepted as an alias).
    Unknown flags are logged and ignored, like the reference's
    getEnvMetricFlags."""

    def __init__(self, metric_flags: str = "") -> None:
        self.registry = CollectorRegistry()
        r = self.registry
        flags = {f.strip().lower() for f in metric_flags.split(",") if f.strip()}
        for bad in sorted(flags - {"os", "python", "golang"}):
            logging.getLogger("gubernator_tpu_torch.metrics").error(
                "invalid flag %r for GUBER_METRIC_FLAGS; valid options are "
                "['os', 'python', 'golang']", bad,
            )
        if "os" in flags:
            from prometheus_client import process_collector

            process_collector.ProcessCollector(
                namespace="gubernator", registry=r
            )
        if flags & {"python", "golang"}:
            from prometheus_client import gc_collector, platform_collector

            gc_collector.GCCollector(registry=r)
            platform_collector.PlatformCollector(registry=r)
        # --- request plane (grpc_stats.go:41-131 analog)
        self.grpc_request_counts = Counter(
            "gubernator_grpc_request_counts",
            "The count of gRPC/HTTP requests",
            ["method", "status"],
            registry=r,
        )
        self.grpc_request_duration = Histogram(
            # a HISTOGRAM (was a Summary): request-plane TAILS are the
            # serving plane's acceptance metric, and histogram buckets can
            # carry trace-exemplars — _sum/_count series names unchanged
            "gubernator_grpc_request_duration",
            "Request handling duration in seconds",
            ["method"],
            registry=r,
            buckets=LATENCY_BUCKETS,
        )
        self.concurrent_checks = Gauge(
            "gubernator_concurrent_checks_counter",
            "Number of rate limit checks in flight",
            registry=r,
        )
        self.check_error_counter = Counter(
            "gubernator_check_error_counter",
            "Count of per-item errors returned",
            ["error"],
            registry=r,
        )
        self.over_limit_counter = Counter(
            "gubernator_over_limit_counter",
            "Count of OVER_LIMIT responses",
            registry=r,
        )
        # --- cache / table (lrucache.go:48-59 analog)
        self.cache_size = Gauge(
            "gubernator_cache_size",
            "Number of live keys in the device table",
            registry=r,
        )
        self.cache_access = Counter(
            "gubernator_cache_access_count",
            "Device table lookups",
            ["type"],  # hit | miss
            registry=r,
        )
        self.unexpired_evictions = Counter(
            "gubernator_unexpired_evictions_count",
            "Live (unexpired) items evicted for new keys",
            registry=r,
        )
        # the same kernel stat under the TPU-native name the tiering plane
        # documents (renders gubernator_tpu_evicted_live_total): each
        # increment is LIVE state displaced by the claim — silent loss
        # with tiering off, a demotion with it on (docs/tiering.md)
        self.evicted_live = Counter(
            "gubernator_tpu_evicted_live",
            "Live (unexpired) rows the decision kernel's claim displaced "
            "(kernel2 evicted_unexpired stat) — state loss when tiering "
            "is off, demote-on-evict events when it is on",
            registry=r,
        )
        # --- hot-set tiering (gubernator_tpu/tier/; docs/tiering.md)
        self.tier_demoted = Counter(
            # renders gubernator_tier_demoted_rows_total
            "gubernator_tier_demoted_rows",
            "Rows demoted from HBM to the host-RAM shadow, by trigger "
            "(evict = displaced by the claim, idle = background sweep)",
            ["reason"],  # evict | idle
            registry=r,
        )
        self.tier_promoted = Counter(
            "gubernator_tier_promoted_rows",
            "Shadow rows faulted back into HBM through the conservative "
            "merge ahead of a decide dispatch",
            registry=r,
        )
        self.tier_shed = Counter(
            "gubernator_tier_shed_rows",
            "Shadow rows dropped at the RAM byte bound with no spill "
            "file configured — counted state loss, identical to the "
            "pre-tiering eviction behavior",
            registry=r,
        )
        self.tier_promote_returned = Counter(
            "gubernator_tier_promote_returned_rows",
            "Promote rows returned to the shadow after their claim "
            "dropped (> K same-bucket promotes in one batch) — their "
            "decide that batch may have fresh-granted (docs/tiering.md "
            "bound)",
            registry=r,
        )
        self.tier_shadow_rows = Gauge(
            "gubernator_tier_shadow_rows",
            "Shadow rows resident in host RAM",
            registry=r,
        )
        self.tier_shadow_bytes = Gauge(
            "gubernator_tier_shadow_bytes",
            "Nominal bytes (64 B/row) of the RAM-resident shadow — "
            "bounded by GUBER_TIER_SHADOW_BYTES",
            registry=r,
        )
        self.tier_spilled_rows = Gauge(
            "gubernator_tier_spilled_rows",
            "Rows indexed in the shadow spill file (fault back with one "
            "seek+read)",
            registry=r,
        )
        # --- TPU dispatch plane (no reference analog; the kernel is ours)
        self.dispatch_count = Counter(
            "gubernator_tpu_dispatch_count",
            "Decision-kernel dispatches",
            registry=r,
        )
        self.dispatch_launches = Counter(
            # renders as gubernator_tpu_dispatch_launches_total
            "gubernator_tpu_dispatch_launches",
            "Decision-kernel launches by feed path: ring = per-slot "
            "dispatches from the request ring's host issue loop "
            "(service/ring.py), fused = multi-slot drain launches that "
            "retire up to GUBER_RING_DRAIN_K published slots each "
            "(ops/ring_drain.py), xla = the direct per-flush dispatch "
            "round-trip (docs/latency.md 'Launch budget')",
            ["path"],  # ring | fused | xla
            registry=r,
        )
        self.ring_occupancy = Gauge(
            "gubernator_tpu_ring_occupancy",
            "Request-ring slots published but not yet consumed — bounded "
            "by GUBER_RING_SLOTS; sustained saturation means submitters "
            "are in backpressure and the serving loop is the bottleneck",
            registry=r,
        )
        self.ring_drain_slots = Histogram(
            "gubernator_tpu_ring_drain_slots",
            "Published ring slots retired per fused drain launch — "
            "_sum/_count is the scrapeable launch-amortization factor "
            "(slots/launch; docs/latency.md 'Launch budget')",
            registry=r,
            buckets=(1, 2, 4, 8, 16, 32, 64),
        )
        self.dispatch_duration = Histogram(
            "gubernator_tpu_dispatch_duration",
            "Seconds per decision-kernel dispatch (host-observed)",
            registry=r,
            buckets=(0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.5, 2.5),
        )
        self.stage_duration = Histogram(
            "gubernator_tpu_stage_duration",
            "Seconds per serving-pipeline stage",
            # parse | queue | put | issue | fetch | encode, plus the mesh
            # ingress host-staging split shard_route | shard_pack |
            # shard_put (ShardedEngine host work per dispatch — route plan,
            # grid pack, device transfer; docs/latency.md "mesh ingress")
            # and the compact-wire codec stages wire_pack | wire_decode
            # (host encode of the 5-lane ingress grid / decode of the int32
            # egress; docs/latency.md "wire budget").
            # The request-ring plane adds ring_put (submit-side slot claim
            # + payload staging + ingress-fence publish) and ring_poll
            # (the egress-fence wait for the coalesced response) —
            # service/ring.py, docs/latency.md "Dispatch budget".
            # A HISTOGRAM (was a Summary) so per-stage TAILS are scrapeable:
            # _sum/_count keep the same series names the e2e bench means
            # used, and the buckets let BENCH_r06+ report per-stage p99 —
            # means hid exactly the tail behavior the serving plane is
            # judged on (docs/latency.md "Serving plane")
            ["stage"],
            registry=r,
            buckets=LATENCY_BUCKETS,
        )
        self.decisions_total = Counter(
            # renders as gubernator_tpu_decisions_total
            "gubernator_tpu_decisions",
            "Rate-limit decisions served, by algorithm (cascade levels "
            "count one decision per level — docs/algorithms.md)",
            ["algorithm"],  # token_bucket | leaky_bucket | gcra |
            # sliding_window | concurrency_lease | invalid
            registry=r,
        )
        self.cascade_depth = Histogram(
            "gubernator_tpu_cascade_depth",
            "Levels per cascaded multi-limit check (the request's own "
            "level plus its cascade entries)",
            registry=r,
            buckets=(2, 3, 4, 6, 8, 16, 32),
        )
        self.wire_bytes = Counter(
            # renders as gubernator_tpu_wire_bytes_total
            "gubernator_tpu_wire_bytes",
            "Bytes crossing the host-device boundary on the serving decide "
            "path (ingress grids and fetched outputs, whichever wire format "
            "ran) — bytes/decision is this over the dispatch row count",
            ["direction"],  # put | fetch
            registry=r,
        )
        self.dropped_rows = Counter(
            "gubernator_tpu_dropped_rows_count",
            "Rows whose decision could not be persisted after retries",
            registry=r,
        )
        self.unprocessed_dropped = Counter(
            "gubernator_tpu_unprocessed_dropped_count",
            "Rows that exhausted retries without ever reaching the decision "
            "kernel (a2a exchange-capacity drops) — absent from hit/miss "
            "counters by definition",
            registry=r,
        )
        self.a2a_overflow = Counter(
            # renders as gubernator_tpu_a2a_overflow_total
            "gubernator_tpu_a2a_overflow",
            "Rows the device-routed ownership exchange capacity-dropped "
            "before they reached a kernel (FLAG_UNPROCESSED — retried, so "
            "not lost; sustained growth means pair_capacity is undersized "
            "for the traffic skew, GUBER_A2A_CAPACITY_SIGMA)",
            ["impl"],  # ring | collective (GUBER_A2A_IMPL)
            registry=r,
        )
        self.global_wire_entries = Counter(
            # renders as gubernator_global_wire_sync_entries_total
            "gubernator_global_wire_sync_entries",
            "Inter-slice GLOBAL hit-sync entries by path: sent = shipped on "
            "the compact SyncGlobalsWire codec, fallback = shipped on the "
            "classic GetPeerRateLimits proto path (non-encodable batch or "
            "pre-compact peer), recv = decoded and applied as owner",
            ["direction"],  # sent | fallback | recv
            registry=r,
        )
        # --- batching front door (gubernator.go:98-112 analog)
        self.queue_length = Gauge(
            "gubernator_queue_length",
            "Items waiting in the front-door coalescing buffer",
            registry=r,
        )
        self.batch_send_duration = Histogram(
            # Histogram (was Summary): see grpc_request_duration
            "gubernator_batch_send_duration",
            "Seconds per coalesced front-door batch",
            registry=r,
            buckets=LATENCY_BUCKETS,
        )
        self.batch_queue_length = Gauge(
            "gubernator_batch_queue_length",
            "Items queued toward peers (forwarding)",
            registry=r,
        )
        # --- overload plane (service/batcher.py shed policy;
        # docs/robustness.md "Overload & QoS")
        self.shed_total = Counter(
            # renders as gubernator_tpu_shed_total
            "gubernator_tpu_shed",
            "Rate-limit rows shed by the front-door overload plane before "
            "reaching the engine, by reason (queue_full = bounded ring had "
            "no space the item could wait out, deadline = the item's "
            "enqueue deadline passed or the queue-wait estimate exceeded "
            "it, fairness = the item's tenant bucket was over its fair "
            "share of the window, preempted = evicted from the queue by a "
            "higher-priority arrival) and the item's priority tier "
            "(0 = best-effort .. 3 = shed last)",
            ["reason", "tier"],
            registry=r,
        )
        self.queue_wait_seconds = Histogram(
            "gubernator_tpu_queue_wait_seconds",
            "Seconds each admitted front-door batch waited in the coalesce "
            "queue before its dispatch began (per enqueued batch, not per "
            "chunk — the p99 of this series is the queueing half of the "
            "overload story; shed items never appear here)",
            registry=r,
            buckets=LATENCY_BUCKETS,
        )
        self.batch_send_retries = Counter(
            "gubernator_batch_send_retries",
            "Forwarded requests re-sent after peer errors/ownership moves",
            registry=r,
        )
        # --- peer fault tolerance (service/breaker.py; docs/robustness.md)
        self.circuit_breaker_state = Gauge(
            "gubernator_circuit_breaker_state",
            "Per-peer circuit breaker state (0=closed, 1=half-open, 2=open)",
            ["peer"],
            registry=r,
        )
        self.degraded_responses = Counter(
            "gubernator_degraded_response_count",
            "Responses served from local state because the owner was "
            "unreachable (DegradationPolicy.LOCAL)",
            registry=r,
        )
        self.global_requeued = Counter(
            "gubernator_global_requeue_count",
            "GLOBAL pending hits re-merged into the queue after a failed "
            "owner send (instead of dropped)",
            registry=r,
        )
        self.global_requeue_dropped = Counter(
            "gubernator_global_requeue_dropped_count",
            "GLOBAL pending hits dropped after exhausting requeue retries "
            "or hitting the queue cap",
            registry=r,
        )
        # --- multi-region replication (service/region_manager.py;
        # docs/robustness.md "Multi-region active-active")
        self.region_queue_length = Gauge(
            "gubernator_region_queue_length",
            "Pending cross-region hit deltas awaiting the region sync tick "
            "(summed over destination regions)",
            registry=r,
        )
        self.region_requeued = Counter(
            "gubernator_region_requeue_count",
            "Cross-region delta batches re-merged into the pending queue "
            "after a failed send (instead of dropped)",
            registry=r,
        )
        self.region_requeue_dropped = Counter(
            "gubernator_region_requeue_dropped_count",
            "Cross-region pending deltas dropped after exhausting requeue "
            "retries or hitting the queue cap",
            registry=r,
        )
        self.region_wire_entries = Counter(
            "gubernator_region_wire_entries_total",
            "Cross-region replication entries by path: sent/recv ride the "
            "compact SyncRegionsWire merge codec, fallback the classic "
            "GetPeerRateLimits proto path",
            ["direction"],  # sent | recv | fallback
            registry=r,
        )
        self.region_rows_merged = Counter(
            "gubernator_region_rows_merged_total",
            "Replicated rows applied through the conservative merge kernel "
            "(kernel2.merge2) on the region receive path",
            registry=r,
        )
        self.region_dedup_skipped = Counter(
            "gubernator_region_dedup_skipped_hits_total",
            "Duplicate cross-region hit deltas skipped EXACTLY by the "
            "per-source cumulative-counter ledger (re-shipped batches "
            "after a lost ack) — convergence stays exact under retries "
            "instead of degrading to under-grant",
            registry=r,
        )
        # --- edge quota leases (service/lease_manager.py; docs/leases.md):
        # the client-side admission plane's server-side accounting. The
        # outstanding gauge IS the live over-admission bound the delegation
        # adds on top of the limits (Σ tokens granted out, not yet returned
        # or expired).
        self.lease_ops = Counter(
            # renders as gubernator_lease_ops_total
            "gubernator_lease_ops",
            "Edge quota-lease operations by kind (acquire = new lease, "
            "renew = TTL/grant refresh, return = unused tokens back, deny "
            "= zero-token answer, expire = TTL reclamation of an "
            "unrenewed lease, unknown_return = return against a lease "
            "this daemon no longer remembers)",
            ["op"],  # acquire | renew | return | deny | expire |
            # unknown_return
            registry=r,
        )
        self.lease_tokens = Counter(
            # renders as gubernator_lease_tokens_total
            "gubernator_lease_tokens",
            "Edge quota-lease tokens by flow: granted out to edge "
            "limiters, returned unused, expired (reclaimed by TTL with "
            "the real-limit consumption kept — conservative)",
            ["kind"],  # granted | returned | expired
            registry=r,
        )
        self.lease_outstanding = Gauge(
            "gubernator_lease_outstanding_tokens",
            "Σ outstanding leased tokens across keys on this daemon — the "
            "live over-admission bound contribution (docs/leases.md)",
            registry=r,
        )
        self.lease_active = Gauge(
            "gubernator_lease_active",
            "Live (unexpired) edge quota leases tracked by this daemon",
            registry=r,
        )
        # --- topology-change handoff (service/handoff.py; docs/robustness.md
        # "Topology change & drain") — the rolling-restart chaos test asserts
        # row-count parity between phases across daemons, so phase labels are
        # load-bearing: extracted (rows leaving the source table) ≥
        # transferred (acked by a destination) = merged (applied by a
        # destination) + tombstoned (zeroed at the source post-ack);
        # snapshotted = the unacked remainder left for the shutdown
        # checkpoint.
        self.handoff_rows = Counter(
            "gubernator_handoff_rows",
            "Live rows moved through each ownership-handoff phase",
            ["phase"],  # extracted|transferred|merged|tombstoned|snapshotted
            registry=r,
        )
        self.handoff_duration = Histogram(
            "gubernator_handoff_duration",
            "Seconds per ownership-handoff round (extract → transfer → "
            "tombstone)",
            registry=r,
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
        )
        self.handoff_chunk_retries = Counter(
            "gubernator_handoff_chunk_retries",
            "TransferState chunks re-sent after a peer error",
            registry=r,
        )
        # --- GLOBAL behavior (global.go:53-79 analog; names must match, the
        # convergence tests key on them)
        self.global_send_duration = Summary(
            "gubernator_global_send_duration",
            "Seconds per async hit-sync send to owners",
            registry=r,
        )
        self.broadcast_duration = Summary(
            "gubernator_broadcast_duration",
            "Seconds per owner broadcast round",
            registry=r,
        )
        self.broadcast_counter = Counter(
            "gubernator_broadcast_counter",
            "Owner UpdatePeerGlobals broadcasts sent",
            ["condition"],  # broadcast | update_peer_globals (received)
            registry=r,
        )
        self.global_queue_length = Gauge(
            "gubernator_global_queue_length",
            "Pending async GLOBAL hits awaiting the sync tick",
            registry=r,
        )
        self.broadcast_queue_length = Gauge(
            "gubernator_broadcast_queue_length",
            "Owner-side keys queued for an authoritative broadcast",
            registry=r,
        )
        self.updates_installed = Counter(
            "gubernator_update_peer_globals_installed",
            "Authoritative GLOBAL statuses installed from owner broadcasts",
            registry=r,
        )
        # --- mesh-global collective plane (parallel/global_sync.py; the
        # in-mesh analog of the global.go series — convergence tests scrape
        # these for exact counts, like waitForBroadcast does)
        self.mesh_sync_rounds = Counter(
            "gubernator_mesh_sync_rounds",
            "Collective GLOBAL sync rounds executed over the device mesh",
            registry=r,
        )
        self.mesh_broadcasts_applied = Counter(
            "gubernator_mesh_broadcasts_applied",
            "GLOBAL entries applied+broadcast as owner during mesh sync",
            registry=r,
        )
        self.mesh_updates_installed = Counter(
            "gubernator_mesh_updates_installed",
            "Authoritative GLOBAL statuses installed into replica tables",
            registry=r,
        )
        self.mesh_hits_queued = Counter(
            "gubernator_mesh_global_hits_queued",
            "GLOBAL hits accumulated for the collective sync tick",
            registry=r,
        )
        self.mesh_global_queue_length = Gauge(
            "gubernator_mesh_global_queue_length",
            "Pending mesh-GLOBAL outbox entries awaiting the collective sync",
            registry=r,
        )
        self.created_at_clamped = Counter(
            "gubernator_created_at_clamped_count",
            "Requests whose client created_at was outside the skew tolerance",
            registry=r,
        )
        # --- device-side table telemetry (ops/telemetry.py; the background
        # scan EngineRunner.table_telemetry feeds via observe_table). These
        # are SNAPSHOT gauges, not event counters: each scan replaces the
        # previous values; distribution families use a bucket label like a
        # histogram's `le` but stay gauges because the population they
        # describe (live keys right now) shrinks as well as grows.
        self.table_live_keys = Gauge(
            "gubernator_tpu_table_live_keys",
            "Live (non-empty, unexpired) keys at the last telemetry scan",
            registry=r,
        )
        self.table_occupied_slots = Gauge(
            "gubernator_tpu_table_occupied_slots",
            "Occupied slots (live + expired-not-yet-evicted)",
            registry=r,
        )
        self.table_capacity = Gauge(
            "gubernator_tpu_table_capacity",
            "Total table slots (buckets x slots-per-bucket)",
            registry=r,
        )
        self.table_load_factor = Gauge(
            "gubernator_tpu_table_load_factor",
            "live_keys / capacity — eviction pressure precursor (buckets "
            "degrade past ~0.6)",
            registry=r,
        )
        self.table_over_fraction = Gauge(
            "gubernator_tpu_table_over_fraction",
            "Fraction of live keys whose stored status is OVER_LIMIT",
            registry=r,
        )
        self.table_bucket_occupancy = Gauge(
            "gubernator_tpu_table_bucket_occupancy",
            "Buckets holding exactly `slots` live entries (collision "
            "pressure: mass at slots=8 predicts unexpired_evictions)",
            ["slots"],  # "0".."8"
            registry=r,
        )
        self.table_probe_depth = Gauge(
            "gubernator_tpu_table_probe_depth",
            "Live keys by their bucket's occupancy (a lookup gathers the "
            "whole bucket row — depth is the key's collision exposure)",
            ["depth"],  # "1".."8"
            registry=r,
        )
        self.table_block_fill = Gauge(
            "gubernator_tpu_table_block_fill",
            "Sweep-block fill-fraction histogram (64-bucket blocks, decile "
            "bins) — hot-block skew the sparse write kernel sees",
            ["decile"],  # "0".."9"
            registry=r,
        )
        self.table_ttl_horizon = Gauge(
            "gubernator_tpu_table_ttl_horizon",
            "Live keys expiring within the horizon (cumulative; le in "
            "seconds) — how much of the table frees itself soon",
            ["le"],
            registry=r,
        )
        self.table_remaining_frac = Gauge(
            "gubernator_tpu_table_remaining_frac",
            "Live keys with remaining/limit at or below the bound "
            "(cumulative) — admission headroom distribution",
            ["le"],
            registry=r,
        )
        self.table_scan_duration = Histogram(
            "gubernator_tpu_table_scan_duration",
            "Seconds per background telemetry scan (launch to decoded "
            "snapshot; the scan overlaps serving dispatches)",
            registry=r,
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
        )
        self.table_hbm_bytes_per_decision = Gauge(
            "gubernator_table_hbm_bytes_per_decision",
            "Modeled HBM bytes the decide path's table walk moves per "
            "decision (worst case) at the engine's current slot layout, "
            "write mode, probe kernel and last dispatch geometry "
            "(ops/pallas_probe.hbm_bytes_per_decision) — the roofline "
            "denominator behind the decisions/s record (docs/kernel.md)",
            registry=r,
        )
        # --- durability plane (service/checkpoint.py; docs/durability.md):
        # the incremental checkpoint loop's cost, volume, and freshness —
        # kind=delta for epoch frames, kind=base for compactions/shutdown
        # snapshots. epoch_age is THE recovery-bound signal: a kill -9 loses
        # at most the writes admitted in that window.
        self.checkpoint_duration = Histogram(
            "gubernator_tpu_checkpoint_duration_seconds",
            "Seconds per checkpoint operation (dirty-block extract + frame "
            "append, or base compaction)",
            ["kind"],  # delta | base
            registry=r,
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
        )
        self.checkpoint_bytes = Counter(
            # renders as gubernator_tpu_checkpoint_bytes_total
            "gubernator_tpu_checkpoint_bytes",
            "Bytes written to the checkpoint plane (delta frames vs base "
            "snapshots) — delta bytes track the write rate, not table size",
            ["kind"],  # delta | base
            registry=r,
        )
        self.checkpoint_rows = Counter(
            # renders as gubernator_tpu_checkpoint_rows_total
            "gubernator_tpu_checkpoint_rows",
            "Live slot rows captured per checkpoint kind",
            ["kind"],  # delta | base
            registry=r,
        )
        self.checkpoint_epoch_age = Gauge(
            "gubernator_tpu_checkpoint_epoch_age_seconds",
            "Seconds since the last durable checkpoint epoch — the upper "
            "bound on state a kill -9 can lose right now",
            registry=r,
        )
        self.checkpoint_errors = Counter(
            # renders as gubernator_tpu_checkpoint_errors_total
            "gubernator_tpu_checkpoint_errors",
            "Failed checkpoint operations by stage (the dirty set is "
            "re-armed on delta failures, so dirt is deferred, not lost)",
            ["stage"],  # delta | base | restore | shutdown
            registry=r,
        )
        # --- GLOBAL convergence lag (docs/observability.md): age of the
        # oldest un-synced GLOBAL hit across the cross-daemon queue
        # (service/global_manager.py) and the mesh outbox
        # (parallel/global_sync.PendingHits) — the signal the multi-region
        # reconcile roadmap item is judged on. 0 = nothing pending.
        self.global_sync_staleness = Gauge(
            "gubernator_global_sync_staleness_seconds",
            "Age in seconds of the oldest GLOBAL hit not yet synced to its "
            "owner (cross-daemon queue and mesh outbox)",
            registry=r,
        )
        # region-plane convergence lag, built the same way: age of the
        # oldest hit delta not yet acked by every remote region's owner —
        # survives requeues; a partitioned region's gauge grows for exactly
        # as long as the partition, then drains to 0 on heal
        self.region_sync_staleness = Gauge(
            "gubernator_region_sync_staleness_seconds",
            "Age in seconds of the oldest cross-region hit delta not yet "
            "replicated to every remote region",
            registry=r,
        )
        # OTLP exporter health (satellite: export failures were attributes
        # nobody could scrape)
        r.register(_OtelSpanCollector())

    def observe_engine(self, stats) -> None:
        """Refresh counter families from an EngineStats snapshot (engine
        counters are cumulative; prometheus Counters only go up, so set via
        delta)."""
        # Counters in prometheus_client can't be set; track last-seen and inc
        # the difference.
        last = getattr(self, "_last_engine", None)
        if last is None:
            last = dict(
                hits=0, misses=0, over=0, evic=0, dropped=0, disp=0, clamped=0
            )
        d_hits = stats.cache_hits - last["hits"]
        d_miss = stats.cache_misses - last["misses"]
        d_over = stats.over_limit - last["over"]
        d_evic = stats.evicted_unexpired - last["evic"]
        d_drop = stats.dropped - last["dropped"]
        d_disp = stats.dispatches - last["disp"]
        if d_hits > 0:
            self.cache_access.labels(type="hit").inc(d_hits)
        if d_miss > 0:
            self.cache_access.labels(type="miss").inc(d_miss)
        if d_over > 0:
            self.over_limit_counter.inc(d_over)
        if d_evic > 0:
            self.unexpired_evictions.inc(d_evic)
            self.evicted_live.inc(d_evic)
        if d_drop > 0:
            self.dropped_rows.inc(d_drop)
        if d_disp > 0:
            self.dispatch_count.inc(d_disp)
        d_clamp = stats.created_at_clamped - last.get("clamped", 0)
        if d_clamp > 0:
            self.created_at_clamped.inc(d_clamp)
        d_unproc = stats.unprocessed_dropped - last.get("unproc", 0)
        if d_unproc > 0:
            self.unprocessed_dropped.inc(d_unproc)
        self._last_engine = dict(
            hits=stats.cache_hits,
            misses=stats.cache_misses,
            over=stats.over_limit,
            evic=stats.evicted_unexpired,
            dropped=stats.dropped,
            disp=stats.dispatches,
            clamped=stats.created_at_clamped,
            unproc=stats.unprocessed_dropped,
        )

    def observe_global(self, gs) -> None:
        """Refresh mesh-global counters from a GlobalStats snapshot (same
        delta pattern as observe_engine). NOT thread-safe: every caller runs
        on the EngineRunner thread (dispatch path and sync path both), which
        serializes the _last_global read-modify-write."""
        last = getattr(self, "_last_global", None)
        if last is None:
            last = dict(rounds=0, bcast=0, inst=0, queued=0)
        d = gs.sync_rounds - last["rounds"]
        if d > 0:
            self.mesh_sync_rounds.inc(d)
        d = gs.broadcasts_applied - last["bcast"]
        if d > 0:
            self.mesh_broadcasts_applied.inc(d)
        d = gs.updates_installed - last["inst"]
        if d > 0:
            self.mesh_updates_installed.inc(d)
        d = gs.hits_queued - last["queued"]
        if d > 0:
            self.mesh_hits_queued.inc(d)
        self.mesh_global_queue_length.set(gs.send_queue_length)
        self._last_global = dict(
            rounds=gs.sync_rounds,
            bcast=gs.broadcasts_applied,
            inst=gs.updates_installed,
            queued=gs.hits_queued,
        )

    def observe_table(self, snap) -> None:
        """Publish one table-telemetry snapshot (ops/telemetry.TableSnapshot)
        into the gubernator_tpu_table_* families. Snapshot semantics: every
        series is overwritten; a shrinking table shrinks its gauges."""
        from gubernator_tpu_torch.ops.telemetry import REMAIN_EDGES, TTL_EDGES_MS

        self.table_live_keys.set(snap.live_keys)
        self.table_occupied_slots.set(snap.occupied_slots)
        self.table_capacity.set(snap.capacity)
        self.table_load_factor.set(snap.load_factor)
        self.table_over_fraction.set(snap.over_fraction)
        for j, v in enumerate(snap.bucket_occupancy):
            self.table_bucket_occupancy.labels(slots=str(j)).set(v)
        for j, v in enumerate(snap.probe_depth, start=1):
            self.table_probe_depth.labels(depth=str(j)).set(v)
        for j, v in enumerate(snap.block_fill):
            self.table_block_fill.labels(decile=str(j)).set(v)
        for e, v in zip(TTL_EDGES_MS, snap.ttl_horizon):
            self.table_ttl_horizon.labels(le=str(e // 1000)).set(v)
        self.table_ttl_horizon.labels(le="+Inf").set(snap.live_keys)
        for e, v in zip(REMAIN_EDGES, snap.remaining_frac):
            self.table_remaining_frac.labels(le=str(e)).set(v)
        self.table_remaining_frac.labels(le="+Inf").set(snap.live_keys)
        self.table_scan_duration.observe(snap.scan_ms / 1e3)

    def render(self, openmetrics: bool = False) -> bytes:
        """Prometheus exposition (the /metrics body). `openmetrics=True`
        emits the OpenMetrics format — the one that carries the exemplars
        (trace_ids on latency buckets); scrapers ask for it via the Accept
        header (service/server.py negotiates)."""
        if openmetrics:
            return om_exposition.generate_latest(self.registry)
        return generate_latest(self.registry)


def parse_metrics(text: str):
    """Scrape helper for tests: text exposition → {name: {labelset: value}}.
    The analog of the reference tests' expfmt parsing (functional_test.go:2245)."""
    out = {}
    for fam in text_string_to_metric_families(text):
        for sample in fam.samples:
            out.setdefault(sample.name, {})[
                tuple(sorted(sample.labels.items()))
            ] = sample.value
    return out
