"""Daemon configuration: GUBER_* environment variables + optional config file.

Mirrors the reference's env-driven config system (reference config.go:302-547):
every knob is a `GUBER_*` env var, optionally seeded from a `key=value` file
(reference config.go:703-726 loads the file INTO the environment first, so env
set by the file and real env resolve through one path). Defaults match the
reference's (reference config.go:137-158) where a counterpart exists.
"""

from __future__ import annotations

import enum
import os
import random
import re
import socket
import string
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class DegradationPolicy(str, enum.Enum):
    """What a non-owner answers when the owner is unreachable (breaker open
    or forward retries exhausted) — see docs/robustness.md.

    ERROR: today's reference-compatible behavior — the item carries an
    "Error while fetching rate limit from peer: ..." response.
    LOCAL: best-effort local check against this daemon's own store; the
    response is real (non-error) but marked via metadata["degraded"]="true"
    so clients know it may not reflect the owner's authoritative state.
    """

    ERROR = "error"
    LOCAL = "local"


class ConfigError(ValueError):
    """Invalid configuration — message says which key and why (the reference
    returns actionable errors from SetupDaemonConfig, config.go:359-363)."""


def load_config_file(path: str, env: Optional[Dict[str, str]] = None) -> None:
    """Parse a `key=value` file and set the pairs into the environment
    (reference config.go:703-726: `fromEnvFile`). Lines starting with # and
    blank lines are ignored; existing env vars are NOT overridden (real env
    wins, same as the reference)."""
    env_map = os.environ if env is None else env
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ConfigError(f"{path}:{ln}: expected key=value, got {line!r}")
            k, _, v = line.partition("=")
            k, v = k.strip(), v.strip()
            if k and k not in env_map:
                env_map[k] = v


def _get(env, key: str, default: str = "") -> str:
    return env.get(key, default)


def _get_int(env, key: str, default: int) -> int:
    raw = env.get(key)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ConfigError(f"{key}: expected integer, got {raw!r}")


def _get_float_ms(env, key: str, default_ms: float) -> float:
    """Duration in milliseconds (reference uses Go durations; we accept a
    plain number = ms, or with a s/ms/us suffix)."""
    raw = env.get(key)
    if raw is None or raw == "":
        return default_ms
    m = re.fullmatch(r"\s*([0-9.]+)\s*(us|ms|s|m)?\s*", raw)
    if not m:
        raise ConfigError(f"{key}: expected duration, got {raw!r}")
    val = float(m.group(1))
    unit = m.group(2) or "ms"
    return val * {"us": 1e-3, "ms": 1.0, "s": 1e3, "m": 60e3}[unit]


def _get_fraction(env, key: str, default: float) -> float:
    raw = env.get(key)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        raise ConfigError(f"{key}: expected a number, got {raw!r}")


def _get_bool(env, key: str, default: bool = False) -> bool:
    raw = env.get(key, "")
    if raw == "":
        return default
    return raw.lower() in ("1", "true", "yes", "on")


def instance_id(env=None) -> str:
    """Stable-ish instance id: env override or random tag (reference
    config.go:746-783 also tries the docker cgroup; not meaningful here)."""
    env = os.environ if env is None else env
    iid = env.get("GUBER_INSTANCE_ID", "")
    if iid:
        return iid
    return "".join(random.choices(string.hexdigits.lower(), k=12))


@dataclass
class BehaviorConfig:
    """Batching / GLOBAL cadence knobs (reference config.go:49-70; defaults
    config.go:137-146)."""

    batch_timeout_ms: float = 500.0  # forwarding RPC timeout (BatchTimeout 500ms)
    batch_wait_ms: float = 0.5  # coalescing window (BatchWait 500µs)
    batch_limit: int = 1000  # max items per forwarded batch (BatchLimit)
    # per-DEVICE-dispatch row cap for the front-door batcher: oversized
    # flushes split into whole sub-batches (one oversized enqueue dispatches
    # alone). Bigger caps amortize kernel fixed costs, smaller caps bound
    # per-dispatch latency; no reference analog (device batches replace the
    # worker channels)
    coalesce_limit: int = 16384
    # concurrent device dispatches the front door keeps in flight (issue of
    # N+1 overlaps compute of N and fetch of N-1); 1 = the serial door
    pipeline_inflight: int = 4
    # --- serving plane (docs/latency.md "Serving plane") ------------------
    # parser/responder flush workers on the front door: each forms a chunk,
    # dispatches it, and slices its coalesced response back in parallel
    # with the others; 0 = one per pipeline_inflight slot
    front_workers: int = 0
    # adaptive batch window: close the coalesce window on accumulated
    # rows/bytes (or an idle engine) instead of always sleeping
    # batch_wait_ms; the wall clock remains the ceiling. false restores the
    # fixed-tick window
    adaptive_batch: bool = True
    # rows that close the adaptive window early (0 = coalesce_limit)
    batch_close_rows: int = 0
    # accumulated request wire bytes that close the adaptive window early
    batch_close_bytes: int = 1 << 20
    # bounded front-door ring: enqueues past this many pending rows wait
    # for drain progress (backpressure) instead of growing the queue
    # without limit (0 = 8 × coalesce_limit)
    batch_queue_rows: int = 0
    # --- overload plane (docs/robustness.md "Overload & QoS") -------------
    # per-item enqueue deadline in ms: arms the front-door overload plane —
    # queue waits are bounded by min(this, the caller's remaining gRPC
    # deadline), a full ring or an infeasible wait sheds lowest-tier-first
    # with a fast per-item overload error instead of blocking, and the
    # dispatch order becomes tier-major. 0 (default) = disarmed: the legacy
    # unbounded-backpressure door
    overload_deadline_ms: float = 0.0
    # derive the enqueue deadline from MEASURED dispatch speed instead of a
    # hard-coded guess: GUBER_OVERLOAD_DEADLINE_MS=auto arms the overload
    # plane with deadline = max(overload_retry_ms,
    # OVERLOAD_AUTO_DEADLINE_MULT × EWMA of stage_duration{stage="issue"}),
    # re-evaluated per enqueue — one knob that tracks real device speed on
    # both backends (docs/robustness.md "Overload & QoS")
    overload_deadline_auto: bool = False
    # fair admission: one tenant (key-fingerprint bucket) may hold at most
    # this fraction of the bounded ring once the queue is ≥ half full;
    # excess rows from that tenant shed with reason="fairness"
    overload_tenant_share: float = 0.5
    # fingerprint buckets for tenant accounting (rounded up to a pow2)
    overload_tenant_buckets: int = 64
    # reset_time hint stamped on shed responses (client retry backoff)
    overload_retry_ms: int = 25
    # device-resident request ring (service/ring.py; docs/latency.md
    # "Dispatch budget"): all-wire flushes are staged into a fixed ring of
    # compact wire-grid slots and consumed in ticket order by a persistent
    # serving loop — on TPU this kills the per-flush dispatch round-trip;
    # the CPU build runs a functional emulation of the same protocol. Off
    # (default) = the direct per-flush dispatch every PR before this one
    # shipped.
    ring_enable: bool = False
    # ring depth in slots: submits past this many published-but-unconsumed
    # batches wait (bounded backpressure, no drops, FIFO order)
    ring_slots: int = 64
    # consume tier (docs/latency.md "Launch budget"): "auto" resolves per
    # backend (fused on TPU, host on CPU); "host" = one XLA launch per
    # published slot; "fused" = ONE jitted while_loop launch drains up to
    # ring_drain_k published slots (ops/ring_drain.py); "persistent" =
    # staged Pallas fence-claim tier (runs the fused drain with a watchdog
    # until the device run validates the resident loop)
    ring_issue: str = "auto"
    # max published slots one fused drain launch retires (the launch-
    # amortization factor; clamped to ring_slots)
    ring_drain_k: int = 8
    # fixed device slot width in rows for the fused tiers; chunks wider
    # than this ride the per-slot host path. 0 = auto-size to the first
    # fused chunk's padded dispatch size
    ring_slot_width: int = 0
    # warm-up breadth: "" compiles only the 1-row shapes (fast spawn);
    # "pow2" additionally compiles every pow2 coalesce shape up to
    # coalesce_limit (token graph), "pow2-mixed" both math graphs — without
    # this, the first request that produces a new coalesced batch geometry
    # pays a multi-second XLA compile on the request path
    warm_shapes: str = ""

    global_timeout_ms: float = 500.0  # GLOBAL rpc timeout (GlobalTimeout)
    global_sync_wait_ms: float = 100.0  # hit-sync cadence (GlobalSyncWait)
    global_batch_limit: int = 1000  # GlobalBatchLimit
    global_peer_concurrency: int = 100  # GlobalPeerRequestsConcurrency
    # inter-slice GLOBAL hit batches ride the compact wire codec
    # (SyncGlobalsWire RPC, service/wire.sync_wire_pb — 20 B/entry of
    # numeric config + one string blob instead of nested RateLimitReq
    # messages) when the batch is representable; off forces the classic
    # GetPeerRateLimits proto path everywhere (the parity oracle)
    global_wire_sync: bool = True

    force_global: bool = False  # reference config.go:65-66

    # --- peer fault tolerance (docs/robustness.md) -------------------------
    # consecutive RPC failures toward one peer that trip its breaker OPEN
    peer_breaker_errors: int = 5
    # jittered-exponential open-state cooldown: first trip cools for
    # ~base/2..base, doubling per consecutive trip up to the cap
    peer_breaker_backoff_base_ms: float = 500.0
    peer_breaker_backoff_cap_ms: float = 30_000.0
    # concurrent HALF_OPEN probe RPCs allowed while testing a tripped peer
    peer_breaker_probes: int = 1
    # owner-unreachable answer policy: "error" | "local" (DegradationPolicy)
    degradation_policy: str = DegradationPolicy.ERROR.value
    # failed GLOBAL hit batches re-merge into the pending queue this many
    # times before the hits are dropped (0 restores the reference's
    # drop-on-error, global.go:190-195)
    global_requeue_retries: int = 3
    # total pending-hit keys the requeue path may grow the queue to; beyond
    # it, failed batches drop (bounds memory during long partitions)
    global_queue_cap: int = 10_000

    # --- multi-region replication (docs/robustness.md "Multi-region
    # active-active") ---------------------------------------------------
    # cross-region sync cadence; 0 inherits global_sync_wait_ms
    region_sync_wait_ms: float = 0.0
    # per-RPC deadline for region replication sends; 0 derives
    # max(global_timeout_ms, 2000) — deliberately GENEROUS: the plane is
    # asynchronous (nothing user-facing waits on it), and a deadline that
    # cancels a receiver mid-apply turns a slow round into a duplicate
    # delivery on retry (under-granting, but needless)
    region_timeout_ms: float = 0.0
    # failed cross-region delta batches re-merge into the pending queue
    # this many times before dropping (the over-admission bound after a
    # partition longer than retries × sync_wait grows by the dropped
    # deltas — size this to the longest partition you want to ride out)
    region_requeue_retries: int = 3
    # pending-delta keys PER DESTINATION REGION the requeue path may grow
    # to; beyond it, failed batches drop (bounds memory during partitions)
    region_queue_cap: int = 10_000
    # encodable delta batches ride the compact SyncRegionsWire codec and
    # reconcile through the conservative merge kernel; off forces the
    # classic GetPeerRateLimits proto path everywhere (legacy DRAIN
    # semantics — the parity oracle and the pre-upgrade behavior)
    region_wire_sync: bool = True

    # --- topology-change handoff (docs/robustness.md "Topology change &
    # drain") -----------------------------------------------------------
    # move owned live rows to their new ring owners on set_peers rebalance
    # and on graceful drain (off restores the reference's state-stranding
    # behavior: moved keys answer fresh at the new owner until TTL)
    handoff_enabled: bool = True
    # wall-clock budget for one handoff round (rebalance or drain); chunks
    # still unacked at the deadline stay in the table (drain snapshots them)
    handoff_deadline_ms: float = 5_000.0
    # rows per TransferState chunk (4096 rows ≈ 300 KiB on the wire, under
    # the 1 MiB peer-channel receive cap with headroom)
    handoff_chunk_rows: int = 4096


@dataclass
class DaemonConfig:
    """Everything a daemon needs to boot (reference DaemonConfig,
    config.go:197-284)."""

    grpc_address: str = "localhost:1051"
    http_address: str = "localhost:1050"
    # optional extra HTTP listener serving /metrics + health ONLY, and (when
    # TLS is on) WITHOUT requiring client certificates — so probes and
    # scrapers work in mTLS clusters (reference HTTPStatusListenAddress,
    # daemon.go:324-352)
    status_http_address: str = ""
    advertise_address: str = ""  # defaults to grpc_address
    data_center: str = ""
    instance_id: str = ""

    # per-RPC item cap on the V1 wire surface (reference hard-codes 1000,
    # gubernator.go:41-42 — the wire-compatible default; raising it lets a
    # client ship engine-sized batches in one RPC instead of paying proto
    # framing per 1000 rows). The rejection string keeps the reference's
    # exact wording either way.
    max_batch_size: int = 1000
    # total limit levels (the request itself + its cascade entries) one
    # cascaded check may carry (GUBER_CASCADE_MAX_LEVELS;
    # docs/algorithms.md "Cascades"). Cascades up to 4 levels ride the
    # compact wire; deeper ones fall back to the full-width grids.
    cascade_max_levels: int = 8
    cache_size: int = 50_000  # CacheSize (config.go:151) → table capacity
    # auto-grow: double the device table when live keys pass 60% of capacity
    # (0 = fixed size like the reference's LRU; >0 = growth ceiling in slots)
    cache_max_size: int = 0
    engine: str = "local"  # "local" (one device) | "sharded" (mesh)
    # sharded request routing: "auto" (device on TPU backends, host
    # elsewhere — parallel/sharded.default_shard_route) | "host" (ownership
    # grid built host-side) | "device" (arrival-order rows, on-mesh
    # all_to_all exchange — the multi-host-scale path, parallel/a2a.py)
    shard_route: str = "auto"
    # sharded duplicate-key handling: "auto" (device on TPU backends) |
    # "host" (pass-planner group-by, exact sequential same-key semantics) |
    # "device" (in-trace aggregation — hits summed, RESET OR-ed, newest
    # config wins; O(1) host planning, kernel2.dedup_packed_cols)
    shard_dedup: str = "auto"
    # ownership-exchange schedule for route="device" dispatches
    # (parallel/ring.py): "auto" (ring on TPU backends, collective
    # elsewhere) | "ring" (hand-rolled per-hop remote-DMA/ppermute
    # schedule, double-buffered hops) | "collective" (one monolithic
    # lax.all_to_all per direction — the parity oracle). Byte-identical
    # results either way; GUBER_A2A_IMPL.
    a2a_impl: str = "auto"
    # fold the mesh's devices into this many (simulated) host rows — the
    # 2-D (host, device) topology used by multi-host tests/CI on one
    # machine (GUBER_MESH_HOSTS; 0 = from the runtime: process_count on a
    # real pod slice, 1 host otherwise). Read by parallel/mesh.make_mesh
    # through the environment, surfaced here for validation + visibility.
    mesh_hosts: int = 0
    # table-walk kernel for decide dispatches (ops/plan.default_probe_kernel;
    # GUBER_PROBE_KERNEL): "auto" (= xla until the device record flips it) |
    # "xla" (row gather + sweep/sparse write) | "pallas" (the fused
    # double-buffered probe→decide→write megakernel, ops/pallas_probe.py —
    # interpret-mode on CPU backends)
    probe_kernel: str = "auto"
    # table-walk kernel for the NON-decide walks — GLOBAL installs,
    # region/handoff merges, tiering promotes (ops/plan.default_walk_kernel;
    # GUBER_WALK_KERNEL): "auto" (= xla until the device bench's fused-vs-
    # two-pass wall flips it) | "xla" (two-pass gather + sweep/sparse
    # write) | "pallas" (the fused probe→install/merge→write walk,
    # ops/pallas_probe.walk2_pallas_impl). Independent of probe_kernel so
    # the latency-critical decide path and the throughput walks can flip
    # separately.
    walk_kernel: str = "auto"
    workers: int = 0  # 0 = auto; host-side executor width

    behaviors: BehaviorConfig = field(default_factory=BehaviorConfig)

    # peer discovery (reference config.go:359-363: {none, dns, k8s, etcd,
    # member-list})
    peer_discovery_type: str = "none"
    dns_fqdn: str = ""
    dns_poll_ms: float = 5_000.0

    # etcd discovery (reference etcd.go; GUBER_ETCD_*)
    etcd_endpoint: str = ""  # http(s)://host:port of the v3 JSON gateway
    etcd_key_prefix: str = "/gubernator/peers/"
    etcd_lease_ttl_s: int = 30
    etcd_poll_ms: float = 2_000.0

    # member-list gossip discovery (reference memberlist.go; GUBER_MEMBERLIST_*)
    memberlist_address: str = ""  # gossip bind address (host:port)
    memberlist_advertise_address: str = ""
    memberlist_known_nodes: str = ""  # comma-separated seed gossip addresses
    memberlist_gossip_interval_ms: float = 500.0
    # comma-separated base64 AES keys (16/24/32 bytes each); first encrypts
    # outbound gossip, all decrypt inbound (rotation). Empty = plaintext
    # (reference SecretKey/keyring, memberlist.go:149-167)
    memberlist_secret_keys: str = ""

    # kubernetes discovery (reference kubernetes.go; GUBER_K8S_*)
    k8s_namespace: str = "default"
    k8s_pod_ip: str = ""
    k8s_pod_port: str = ""
    k8s_selector: str = ""  # endpoints/pods label selector
    k8s_mechanism: str = "endpointslices"  # or "pods"
    k8s_api_url: str = ""  # override for tests; default in-cluster
    k8s_poll_ms: float = 5_000.0

    # TLS (reference tls.go); empty = plaintext
    tls_ca_file: str = ""
    tls_cert_file: str = ""
    tls_key_file: str = ""
    tls_auto: bool = False  # auto self-signed CA + cert (AutoTLS)
    tls_client_auth: str = ""  # "", "require", "verify"

    # checkpoint/resume (SURVEY §5.4): snapshot file for the Loader hook
    checkpoint_path: str = ""
    # incremental checkpointing (docs/durability.md): background cadence of
    # the dirty-block delta plane. 0 (default) keeps the seed behavior —
    # restore on boot, one full snapshot on graceful shutdown; > 0 appends
    # CRC-framed delta frames of blocks dirtied since the last epoch to the
    # delta log every interval, bounding kill -9 loss to one interval of
    # writes. Requires checkpoint_path.
    checkpoint_interval_ms: float = 0.0
    # compact the delta log into a fresh base snapshot after this many
    # frames (bounds replay length and log growth)
    checkpoint_compact_frames: int = 64
    # delta-log file; default <checkpoint_path>.delta
    checkpoint_delta_path: str = ""

    # --- hot-set tiering (gubernator_tpu/tier/; docs/tiering.md) --------
    # demote evicted/idle rows to a host-RAM shadow table and fault them
    # back through the conservative merge — capacity scales with TRACKED
    # keys while HBM holds the hot set. Off (default) = the pre-tiering
    # behavior: live evictions silently discard state.
    tier_enabled: bool = False
    # rows idle (no update) past this horizon demote out of HBM on the
    # background sweep (telemetry cadence)
    tier_idle_ms: float = 60_000.0
    # RAM budget for the shadow's resident rows (64 B canonical rows);
    # over-budget rows shed to the spill file when configured, else drop
    # (counted — exactly today's eviction loss)
    tier_shadow_bytes: int = 1 << 28
    # optional spill file (DeltaLog frame format): makes demotions durable
    # across restarts and lets the shadow overflow RAM losslessly
    tier_spill_path: str = ""

    # background device-table telemetry cadence (ops/telemetry.py; the scan
    # overlaps serving and feeds gubernator_tpu_table_* + /v1/debug/table);
    # 0 disables the loop (the debug endpoint then scans on demand)
    telemetry_interval_ms: float = 5_000.0
    # serve the /v1/debug/{table,pipeline,peers,global} JSON snapshots on
    # the HTTP listeners (docs/observability.md); off hides the plane on
    # deployments that treat internals as sensitive
    debug_endpoints: bool = True

    # --- edge quota leases (service/lease_manager.py; docs/leases.md) ----
    # ceiling on Σ outstanding leased tokens per key, as a fraction of the
    # key's limit — sizes the documented over-admission bound (a lease is
    # admission delegated to the edge; what's out there is what a
    # partitioned/crashed client can still admit)
    lease_max_fraction: float = 0.5
    # lease TTL clamp: requested TTLs resolve into [min, max]; shorter TTLs
    # reclaim crashed clients' tokens faster at more renew RPCs
    lease_min_ttl_ms: float = 100.0
    lease_max_ttl_ms: float = 30_000.0
    # tier-aware lease sizing (docs/robustness.md "Overload & QoS"): scale
    # lease grants by the requester's priority tier — tier 3 keeps the full
    # computed grant, each tier below loses 25% (tier 0 gets 25%), and under
    # key pressure the response carries a shrink_to hint sized the same
    # way so edges release quota before their TTL. Off (default) preserves
    # tier-blind grants
    lease_priority_scaling: bool = False
    # absolute per-key cap on Σ outstanding leased tokens (0 = only the
    # fraction cap applies) — for huge limits where even a small fraction
    # delegates more than an edge fleet should hold
    lease_max_outstanding: int = 0

    # accepted client created_at skew (ms); requests outside now±tolerance are
    # clamped and counted (gubernator_created_at_clamped_count)
    created_at_tolerance_ms: float = 5 * 60 * 1000.0

    # delay before graceful termination starts, giving load balancers time
    # to de-register (reference config.go:215-217, daemon.go:389-391)
    graceful_termination_delay_s: float = 0.0

    log_level: str = "info"
    # optional runtime metric collectors, comma-separated: "os" (process
    # RSS/fds/CPU) and/or "python" (GC + platform; "golang" alias) —
    # reference flags.go:19-57 FlagOSMetrics/FlagGolangMetrics
    metric_flags: str = ""
    # bound gRPC connection lifetime so load balancers re-balance
    # (reference GRPCMaxConnectionAgeSeconds, config.go:351; 0 = unbounded)
    grpc_max_conn_age_s: float = 0.0

    def memberlist_keyring(self):
        """Decoded AES keyring from GUBER_MEMBERLIST_SECRET_KEYS — the ONE
        strict parser (validate() calls this, so embedders skipping
        validate() get the same rejection of malformed keys)."""
        import base64
        import binascii

        out = []
        for part in self.memberlist_secret_keys.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                key = base64.b64decode(part, validate=True)
            except (ValueError, binascii.Error):
                raise ConfigError(
                    "GUBER_MEMBERLIST_SECRET_KEYS: entries must be base64"
                )
            if len(key) not in (16, 24, 32):
                raise ConfigError(
                    "GUBER_MEMBERLIST_SECRET_KEYS: keys must decode to "
                    f"16, 24 or 32 bytes (got {len(key)})"
                )
            out.append(key)
        return out

    def __post_init__(self):
        if not self.advertise_address:
            self.advertise_address = self.grpc_address
        if not self.instance_id:
            self.instance_id = instance_id()

    def validate(self) -> None:
        if self.peer_discovery_type not in (
            "none", "dns", "etcd", "member-list", "k8s",
        ):
            raise ConfigError(
                f"GUBER_PEER_DISCOVERY_TYPE: unknown type "
                f"{self.peer_discovery_type!r}; must be one of: none, dns, "
                "etcd, member-list, k8s"
            )
        if self.peer_discovery_type == "dns" and not self.dns_fqdn:
            raise ConfigError("GUBER_DNS_FQDN is required when GUBER_PEER_DISCOVERY_TYPE=dns")
        if self.peer_discovery_type == "etcd" and not self.etcd_endpoint:
            raise ConfigError(
                "GUBER_ETCD_ENDPOINT is required when GUBER_PEER_DISCOVERY_TYPE=etcd"
            )
        if self.peer_discovery_type == "member-list" and not self.memberlist_address:
            raise ConfigError(
                "GUBER_MEMBERLIST_ADDRESS is required when "
                "GUBER_PEER_DISCOVERY_TYPE=member-list"
            )
        if self.memberlist_secret_keys:
            self.memberlist_keyring()  # the strict parser raises ConfigError
            try:
                from cryptography.hazmat.primitives.ciphers.aead import (  # noqa: F401
                    AESGCM,
                )
            except ImportError:
                raise ConfigError(
                    "GUBER_MEMBERLIST_SECRET_KEYS requires the "
                    "'cryptography' package"
                )
        if self.k8s_mechanism not in ("endpointslices", "pods"):
            raise ConfigError(
                "GUBER_K8S_WATCH_MECHANISM must be endpointslices or pods"
            )
        if self.peer_discovery_type == "k8s" and not self.k8s_pod_ip:
            # self-recognition (not-ready-self inclusion, owner marking) keys
            # on the pod IP; an empty value silently breaks it
            raise ConfigError(
                "GUBER_K8S_POD_IP is required when GUBER_PEER_DISCOVERY_TYPE="
                "k8s (set it from the downward API: status.podIP)"
            )
        if self.peer_discovery_type == "k8s" and not self.k8s_selector:
            # without a selector the pool would list EVERY workload in the
            # namespace and forward rate-limit RPCs to unrelated pods
            raise ConfigError(
                "GUBER_K8S_ENDPOINTS_SELECTOR is required when "
                "GUBER_PEER_DISCOVERY_TYPE=k8s (e.g. "
                "kubernetes.io/service-name=gubernator for endpointslices, "
                "app=gubernator for pods)"
            )
        if self.engine not in ("local", "sharded"):
            raise ConfigError(f"GUBER_ENGINE: must be local or sharded, got {self.engine!r}")
        if self.shard_route not in ("auto", "host", "device"):
            raise ConfigError(
                f"GUBER_SHARD_ROUTE: must be auto, host or device, got "
                f"{self.shard_route!r}"
            )
        if self.shard_dedup not in ("auto", "host", "device"):
            raise ConfigError(
                f"GUBER_SHARD_DEDUP: must be auto, host or device, got "
                f"{self.shard_dedup!r}"
            )
        if self.a2a_impl not in ("auto", "ring", "collective"):
            raise ConfigError(
                f"GUBER_A2A_IMPL: must be auto, ring or collective, got "
                f"{self.a2a_impl!r}"
            )
        if self.mesh_hosts < 0:
            raise ConfigError(
                "GUBER_MESH_HOSTS must be >= 0 (0 = topology from the runtime)"
            )
        if self.probe_kernel not in ("auto", "xla", "pallas"):
            raise ConfigError(
                f"GUBER_PROBE_KERNEL: must be auto, xla or pallas, got "
                f"{self.probe_kernel!r}"
            )
        if self.walk_kernel not in ("auto", "xla", "pallas"):
            raise ConfigError(
                f"GUBER_WALK_KERNEL: must be auto, xla or pallas, got "
                f"{self.walk_kernel!r}"
            )
        if self.cache_size <= 0:
            raise ConfigError("GUBER_CACHE_SIZE must be positive")
        if self.behaviors.batch_limit <= 0 or self.behaviors.batch_limit > 1000:
            # the reference hard-caps batches at 1000 (gubernator.go:41-42)
            raise ConfigError("GUBER_BATCH_LIMIT must be in (0, 1000]")
        if self.behaviors.pipeline_inflight <= 0:
            raise ConfigError("GUBER_PIPELINE_INFLIGHT must be >= 1")
        if self.behaviors.coalesce_limit <= 0:
            raise ConfigError("GUBER_BATCH_COALESCE_LIMIT must be positive")
        if self.max_batch_size <= 0:
            raise ConfigError("GUBER_MAX_BATCH_SIZE must be positive")
        if not (2 <= self.cascade_max_levels <= 256):
            raise ConfigError(
                "GUBER_CASCADE_MAX_LEVELS must be in [2, 256] (the level "
                "field is 8 bits)"
            )
        if self.behaviors.front_workers < 0:
            raise ConfigError("GUBER_FRONT_WORKERS must be >= 0 (0 = auto)")
        if self.behaviors.batch_close_rows < 0:
            raise ConfigError("GUBER_BATCH_CLOSE_ROWS must be >= 0 (0 = auto)")
        if self.behaviors.batch_close_bytes <= 0:
            raise ConfigError("GUBER_BATCH_CLOSE_BYTES must be positive")
        if self.behaviors.batch_queue_rows < 0:
            raise ConfigError("GUBER_BATCH_QUEUE_ROWS must be >= 0 (0 = auto)")
        if self.behaviors.overload_deadline_ms < 0:
            raise ConfigError(
                "GUBER_OVERLOAD_DEADLINE_MS must be >= 0 (0 = overload "
                "plane disarmed)"
            )
        if not (0.0 < self.behaviors.overload_tenant_share <= 1.0):
            raise ConfigError(
                "GUBER_OVERLOAD_TENANT_SHARE must be in (0, 1] (the ring "
                "fraction one tenant bucket may hold)"
            )
        if self.behaviors.overload_tenant_buckets <= 0:
            raise ConfigError(
                "GUBER_OVERLOAD_TENANT_BUCKETS must be positive"
            )
        if self.behaviors.overload_retry_ms <= 0:
            raise ConfigError("GUBER_OVERLOAD_RETRY_MS must be positive")
        if self.behaviors.ring_slots < 2:
            raise ConfigError(
                "GUBER_RING_SLOTS must be >= 2 (a 1-slot ring serializes "
                "staging against consumption — no overlap to buy)"
            )
        if self.behaviors.ring_issue not in (
            "auto", "host", "fused", "persistent"
        ):
            raise ConfigError(
                "GUBER_RING_ISSUE must be auto, host, fused or persistent, "
                f"got {self.behaviors.ring_issue!r}"
            )
        if self.behaviors.ring_drain_k < 1:
            raise ConfigError(
                "GUBER_RING_DRAIN_K must be >= 1 (published slots one "
                "fused drain launch may retire)"
            )
        if self.behaviors.ring_slot_width < 0:
            raise ConfigError(
                "GUBER_RING_SLOT_WIDTH must be >= 0 (0 = auto-size to the "
                "first fused chunk)"
            )
        if self.behaviors.peer_breaker_errors <= 0:
            raise ConfigError("GUBER_PEER_BREAKER_ERRORS must be >= 1")
        if self.behaviors.peer_breaker_probes <= 0:
            raise ConfigError("GUBER_PEER_BREAKER_PROBES must be >= 1")
        if self.behaviors.peer_breaker_backoff_base_ms <= 0:
            raise ConfigError("GUBER_PEER_BREAKER_BACKOFF_BASE must be positive")
        if (
            self.behaviors.peer_breaker_backoff_cap_ms
            < self.behaviors.peer_breaker_backoff_base_ms
        ):
            raise ConfigError(
                "GUBER_PEER_BREAKER_BACKOFF_CAP must be >= the backoff base"
            )
        if self.behaviors.degradation_policy not in (
            DegradationPolicy.ERROR.value,
            DegradationPolicy.LOCAL.value,
        ):
            raise ConfigError(
                "GUBER_DEGRADATION_POLICY must be error or local, got "
                f"{self.behaviors.degradation_policy!r}"
            )
        if self.behaviors.global_requeue_retries < 0:
            raise ConfigError("GUBER_GLOBAL_REQUEUE_RETRIES must be >= 0")
        if self.behaviors.global_queue_cap <= 0:
            raise ConfigError("GUBER_GLOBAL_QUEUE_CAP must be positive")
        if self.behaviors.region_sync_wait_ms < 0:
            raise ConfigError(
                "GUBER_REGION_SYNC_WAIT must be >= 0 (0 = inherit "
                "GUBER_GLOBAL_SYNC_WAIT)"
            )
        if self.behaviors.region_timeout_ms < 0:
            raise ConfigError(
                "GUBER_REGION_TIMEOUT must be >= 0 (0 = derived from "
                "GUBER_GLOBAL_TIMEOUT)"
            )
        if self.behaviors.region_requeue_retries < 0:
            raise ConfigError("GUBER_REGION_REQUEUE_RETRIES must be >= 0")
        if self.behaviors.region_queue_cap <= 0:
            raise ConfigError("GUBER_REGION_QUEUE_CAP must be positive")
        if self.behaviors.handoff_deadline_ms <= 0:
            raise ConfigError("GUBER_HANDOFF_DEADLINE must be positive")
        if self.behaviors.handoff_chunk_rows <= 0:
            raise ConfigError("GUBER_HANDOFF_CHUNK_ROWS must be positive")
        if not (0.0 < self.lease_max_fraction <= 1.0):
            raise ConfigError(
                "GUBER_LEASE_MAX_FRACTION must be in (0, 1] (the fraction "
                "of a limit that may be delegated to edge leases)"
            )
        if self.lease_min_ttl_ms <= 0:
            raise ConfigError("GUBER_LEASE_MIN_TTL_MS must be positive")
        if self.lease_max_ttl_ms < self.lease_min_ttl_ms:
            raise ConfigError(
                "GUBER_LEASE_MAX_TTL_MS must be >= GUBER_LEASE_MIN_TTL_MS"
            )
        if self.lease_max_outstanding < 0:
            raise ConfigError(
                "GUBER_LEASE_MAX_OUTSTANDING must be >= 0 (0 = fraction "
                "cap only)"
            )
        if self.tls_client_auth not in ("", "require", "verify"):
            raise ConfigError("GUBER_TLS_CLIENT_AUTH must be require or verify")
        if self.created_at_tolerance_ms <= 0:
            raise ConfigError("GUBER_CREATED_AT_TOLERANCE must be positive")
        if self.telemetry_interval_ms < 0:
            raise ConfigError(
                "GUBER_TELEMETRY_INTERVAL_MS must be >= 0 (0 = disabled)"
            )
        if self.checkpoint_interval_ms < 0:
            raise ConfigError(
                "GUBER_CHECKPOINT_INTERVAL_MS must be >= 0 (0 = shutdown-"
                "snapshot only)"
            )
        if self.checkpoint_interval_ms > 0 and not self.checkpoint_path:
            raise ConfigError(
                "GUBER_CHECKPOINT_INTERVAL_MS requires GUBER_CHECKPOINT_PATH "
                "(the delta log lives beside the base snapshot)"
            )
        if self.checkpoint_delta_path and not self.checkpoint_path:
            raise ConfigError(
                "GUBER_CHECKPOINT_DELTA_PATH requires GUBER_CHECKPOINT_PATH"
            )
        if self.checkpoint_compact_frames <= 0:
            raise ConfigError(
                "GUBER_CHECKPOINT_COMPACT_FRAMES must be >= 1"
            )
        if self.tier_idle_ms <= 0:
            raise ConfigError(
                "GUBER_TIER_IDLE_MS must be positive (the demote-on-idle "
                "horizon)"
            )
        if self.tier_shadow_bytes < 64:
            raise ConfigError(
                "GUBER_TIER_SHADOW_BYTES must hold at least one 64 B "
                "canonical row"
            )
        if self.tier_enabled and self.tier_spill_path and not os.path.isdir(
            os.path.dirname(os.path.abspath(self.tier_spill_path))
        ):
            # fail at boot, not at the first sweep: a typo'd spill dir
            # would silently downgrade durability to RAM-only
            raise ConfigError(
                "GUBER_TIER_SPILL_PATH parent directory does not exist"
            )


def setup_daemon_config(
    config_file: str = "", env: Optional[Dict[str, str]] = None
) -> DaemonConfig:
    """Build a validated DaemonConfig from env (+ optional file), the analog of
    SetupDaemonConfig (reference config.go:302-547)."""
    env = dict(os.environ) if env is None else env
    if config_file:
        load_config_file(config_file, env)

    host = socket.gethostname() or "localhost"
    conf = DaemonConfig(
        grpc_address=_get(env, "GUBER_GRPC_ADDRESS", "localhost:1051"),
        http_address=_get(env, "GUBER_HTTP_ADDRESS", "localhost:1050"),
        status_http_address=_get(env, "GUBER_STATUS_HTTP_ADDRESS", ""),
        advertise_address=_get(env, "GUBER_ADVERTISE_ADDRESS", ""),
        data_center=_get(env, "GUBER_DATA_CENTER", ""),
        instance_id=_get(env, "GUBER_INSTANCE_ID", ""),
        max_batch_size=_get_int(env, "GUBER_MAX_BATCH_SIZE", 1000),
        cascade_max_levels=_get_int(env, "GUBER_CASCADE_MAX_LEVELS", 8),
        cache_size=_get_int(env, "GUBER_CACHE_SIZE", 50_000),
        cache_max_size=_get_int(env, "GUBER_CACHE_MAX_SIZE", 0),
        engine=_get(env, "GUBER_ENGINE", "local"),
        shard_route=_get(env, "GUBER_SHARD_ROUTE", "auto"),
        shard_dedup=_get(env, "GUBER_SHARD_DEDUP", "auto"),
        a2a_impl=_get(env, "GUBER_A2A_IMPL", "auto"),
        mesh_hosts=_get_int(env, "GUBER_MESH_HOSTS", 0),
        probe_kernel=_get(env, "GUBER_PROBE_KERNEL", "auto"),
        walk_kernel=_get(env, "GUBER_WALK_KERNEL", "auto"),
        workers=_get_int(env, "GUBER_WORKER_COUNT", 0),
        behaviors=BehaviorConfig(
            batch_timeout_ms=_get_float_ms(env, "GUBER_BATCH_TIMEOUT", 500.0),
            batch_wait_ms=_get_float_ms(env, "GUBER_BATCH_WAIT", 0.5),
            batch_limit=_get_int(env, "GUBER_BATCH_LIMIT", 1000),
            coalesce_limit=_get_int(env, "GUBER_BATCH_COALESCE_LIMIT", 16384),
            pipeline_inflight=_get_int(env, "GUBER_PIPELINE_INFLIGHT", 4),
            front_workers=_get_int(env, "GUBER_FRONT_WORKERS", 0),
            adaptive_batch=_get_bool(env, "GUBER_ADAPTIVE_BATCH", True),
            batch_close_rows=_get_int(env, "GUBER_BATCH_CLOSE_ROWS", 0),
            batch_close_bytes=_get_int(
                env, "GUBER_BATCH_CLOSE_BYTES", 1 << 20
            ),
            batch_queue_rows=_get_int(env, "GUBER_BATCH_QUEUE_ROWS", 0),
            # GUBER_OVERLOAD_DEADLINE_MS=auto arms the plane with the
            # measured-dispatch-speed deadline (service/batcher.py derives
            # it from the issue-stage EWMA) instead of a fixed number
            overload_deadline_ms=(
                0.0
                if _get(env, "GUBER_OVERLOAD_DEADLINE_MS", "")
                .strip().lower() == "auto"
                else _get_float_ms(env, "GUBER_OVERLOAD_DEADLINE_MS", 0.0)
            ),
            overload_deadline_auto=(
                _get(env, "GUBER_OVERLOAD_DEADLINE_MS", "")
                .strip().lower() == "auto"
            ),
            overload_tenant_share=_get_fraction(
                env, "GUBER_OVERLOAD_TENANT_SHARE", 0.5
            ),
            overload_tenant_buckets=_get_int(
                env, "GUBER_OVERLOAD_TENANT_BUCKETS", 64
            ),
            overload_retry_ms=_get_int(env, "GUBER_OVERLOAD_RETRY_MS", 25),
            ring_enable=_get_bool(env, "GUBER_RING_ENABLE", False),
            ring_slots=_get_int(env, "GUBER_RING_SLOTS", 64),
            ring_issue=_get(env, "GUBER_RING_ISSUE", "auto"),
            ring_drain_k=_get_int(env, "GUBER_RING_DRAIN_K", 8),
            ring_slot_width=_get_int(env, "GUBER_RING_SLOT_WIDTH", 0),
            warm_shapes=_get(env, "GUBER_WARM_SHAPES", ""),
            global_timeout_ms=_get_float_ms(env, "GUBER_GLOBAL_TIMEOUT", 500.0),
            global_sync_wait_ms=_get_float_ms(env, "GUBER_GLOBAL_SYNC_WAIT", 100.0),
            global_batch_limit=_get_int(env, "GUBER_GLOBAL_BATCH_LIMIT", 1000),
            global_peer_concurrency=_get_int(
                env, "GUBER_GLOBAL_PEER_CONCURRENCY", 100
            ),
            global_wire_sync=_get_bool(env, "GUBER_GLOBAL_WIRE_SYNC", True),
            force_global=_get_bool(env, "GUBER_FORCE_GLOBAL", False),
            peer_breaker_errors=_get_int(env, "GUBER_PEER_BREAKER_ERRORS", 5),
            peer_breaker_backoff_base_ms=_get_float_ms(
                env, "GUBER_PEER_BREAKER_BACKOFF_BASE", 500.0
            ),
            peer_breaker_backoff_cap_ms=_get_float_ms(
                env, "GUBER_PEER_BREAKER_BACKOFF_CAP", 30_000.0
            ),
            peer_breaker_probes=_get_int(env, "GUBER_PEER_BREAKER_PROBES", 1),
            degradation_policy=_get(
                env, "GUBER_DEGRADATION_POLICY", DegradationPolicy.ERROR.value
            ),
            global_requeue_retries=_get_int(
                env, "GUBER_GLOBAL_REQUEUE_RETRIES", 3
            ),
            global_queue_cap=_get_int(env, "GUBER_GLOBAL_QUEUE_CAP", 10_000),
            region_sync_wait_ms=_get_float_ms(
                env, "GUBER_REGION_SYNC_WAIT", 0.0
            ),
            region_timeout_ms=_get_float_ms(env, "GUBER_REGION_TIMEOUT", 0.0),
            region_requeue_retries=_get_int(
                env, "GUBER_REGION_REQUEUE_RETRIES", 3
            ),
            region_queue_cap=_get_int(env, "GUBER_REGION_QUEUE_CAP", 10_000),
            region_wire_sync=_get_bool(env, "GUBER_REGION_WIRE_SYNC", True),
            handoff_enabled=_get_bool(env, "GUBER_HANDOFF_ENABLED", True),
            handoff_deadline_ms=_get_float_ms(
                env, "GUBER_HANDOFF_DEADLINE", 5_000.0
            ),
            handoff_chunk_rows=_get_int(env, "GUBER_HANDOFF_CHUNK_ROWS", 4096),
        ),
        peer_discovery_type=_get(env, "GUBER_PEER_DISCOVERY_TYPE", "none"),
        dns_fqdn=_get(env, "GUBER_DNS_FQDN", ""),
        dns_poll_ms=_get_float_ms(env, "GUBER_DNS_POLL", 5_000.0),
        etcd_endpoint=_get(env, "GUBER_ETCD_ENDPOINT", ""),
        etcd_key_prefix=_get(env, "GUBER_ETCD_KEY_PREFIX", "/gubernator/peers/"),
        etcd_lease_ttl_s=_get_int(env, "GUBER_ETCD_LEASE_TTL", 30),
        etcd_poll_ms=_get_float_ms(env, "GUBER_ETCD_POLL", 2_000.0),
        memberlist_address=_get(env, "GUBER_MEMBERLIST_ADDRESS", ""),
        memberlist_advertise_address=_get(
            env, "GUBER_MEMBERLIST_ADVERTISE_ADDRESS", ""
        ),
        memberlist_known_nodes=_get(env, "GUBER_MEMBERLIST_KNOWN_NODES", ""),
        memberlist_gossip_interval_ms=_get_float_ms(
            env, "GUBER_MEMBERLIST_GOSSIP_INTERVAL", 500.0
        ),
        memberlist_secret_keys=_get(env, "GUBER_MEMBERLIST_SECRET_KEYS", ""),
        k8s_namespace=_get(env, "GUBER_K8S_NAMESPACE", "default"),
        k8s_pod_ip=_get(env, "GUBER_K8S_POD_IP", ""),
        k8s_pod_port=_get(env, "GUBER_K8S_POD_PORT", ""),
        k8s_selector=_get(env, "GUBER_K8S_ENDPOINTS_SELECTOR", ""),
        k8s_mechanism=_get(env, "GUBER_K8S_WATCH_MECHANISM", "endpointslices"),
        k8s_api_url=_get(env, "GUBER_K8S_API_URL", ""),
        k8s_poll_ms=_get_float_ms(env, "GUBER_K8S_POLL", 5_000.0),
        tls_ca_file=_get(env, "GUBER_TLS_CA", ""),
        tls_cert_file=_get(env, "GUBER_TLS_CERT", ""),
        tls_key_file=_get(env, "GUBER_TLS_KEY", ""),
        tls_auto=_get_bool(env, "GUBER_TLS_AUTO", False),
        tls_client_auth=_get(env, "GUBER_TLS_CLIENT_AUTH", ""),
        checkpoint_path=_get(env, "GUBER_CHECKPOINT_PATH", ""),
        checkpoint_interval_ms=_get_float_ms(
            env, "GUBER_CHECKPOINT_INTERVAL_MS", 0.0
        ),
        checkpoint_compact_frames=_get_int(
            env, "GUBER_CHECKPOINT_COMPACT_FRAMES", 64
        ),
        checkpoint_delta_path=_get(env, "GUBER_CHECKPOINT_DELTA_PATH", ""),
        tier_enabled=_get_bool(env, "GUBER_TIER_ENABLED", False),
        tier_idle_ms=_get_float_ms(env, "GUBER_TIER_IDLE_MS", 60_000.0),
        tier_shadow_bytes=_get_int(
            env, "GUBER_TIER_SHADOW_BYTES", 1 << 28
        ),
        tier_spill_path=_get(env, "GUBER_TIER_SPILL_PATH", ""),
        telemetry_interval_ms=_get_float_ms(
            env, "GUBER_TELEMETRY_INTERVAL_MS", 5_000.0
        ),
        debug_endpoints=_get_bool(env, "GUBER_DEBUG_ENDPOINTS", True),
        lease_max_fraction=_get_fraction(env, "GUBER_LEASE_MAX_FRACTION", 0.5),
        lease_min_ttl_ms=_get_float_ms(env, "GUBER_LEASE_MIN_TTL_MS", 100.0),
        lease_max_ttl_ms=_get_float_ms(
            env, "GUBER_LEASE_MAX_TTL_MS", 30_000.0
        ),
        lease_max_outstanding=_get_int(
            env, "GUBER_LEASE_MAX_OUTSTANDING", 0
        ),
        lease_priority_scaling=_get_bool(
            env, "GUBER_PRIORITY_LEASE_SCALING", False
        ),
        created_at_tolerance_ms=_get_float_ms(
            env, "GUBER_CREATED_AT_TOLERANCE", 5 * 60 * 1000.0
        ),
        graceful_termination_delay_s=_get_float_ms(
            env, "GUBER_GRACEFUL_TERMINATION_DELAY", 0.0
        )
        / 1e3,
        log_level=_get(env, "GUBER_LOG_LEVEL", "info"),
        metric_flags=_get(env, "GUBER_METRIC_FLAGS", ""),
        grpc_max_conn_age_s=float(
            _get_int(env, "GUBER_GRPC_MAX_CONN_AGE_SEC", 0)
        ),
    )
    # hostname convenience: GUBER_GRPC_ADDRESS=:1051 binds all interfaces but
    # advertises the hostname (reference net.go ResolveHostIP analog)
    if conf.advertise_address.startswith(":"):
        conf.advertise_address = f"{host}{conf.advertise_address}"
    conf.validate()
    return conf
