#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (gubernator_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed N] [--keys N] [--xla-keys N] [--profile DIR]

It builds the port's kernels from the sources in the checkout (one nvcc per
kernel, all started together) and drives the port's paths, printing one
JSON line per phase:

1. ``device`` — the card (``nvidia-smi`` name and power limit) and the
   builds (seconds and flags per kernel);
2. ``kernel`` (slot_write) — the kernel against its plain PyTorch version
   at the main path's shapes (byte-equal): a 2^17-row claim for each slot
   layout (full, gcra32, token32) and a ragged 100,003-row one with 10%
   sentinel rows, over a 2^21-bucket table. Beside it, on the same inputs
   and checked byte-equal first, the designs it was measured against
   (``designs/slot_write_designs.cu``, outside the package: the kernel's
   first design, a register-only one with one thread a row, a persistent
   grid staging tiles by bulk copies, the package's kernel with plain stores
   in place of its evict-first ones). Times of
   each, with the plain version and one library call that computes the
   scatter: a cold L2 (``cold_ms``: a read sweep of five times the L2
   before each timed call), in situ (``insitu_ms``: the inputs read back in
   after the sweep, the table cold), ``l2_warm_ms`` (queued calls that
   repeat one working set small enough to stay in the L2) and host-paced
   calls (``call_ms``; ``first_path`` is the first design's whole write,
   its PyTorch ops to form the target and pack included);
3. ``kernel`` (fence_claim) — the ring's claim kernel against its plain
   version at the ring geometry (64 slots of 16384 rows, k 8, int64 fence
   words) and on a gap, a wrap and the k bound (int32 fence words), with
   the same times and the copy alone as the library yardstick (and the
   kernel's time over it, measured in the same run);
4. ``main`` — the decide path with the XLA-style probe
   (``LocalEngine(capacity=2**24)``, gather + sort-based claim +
   slot_write), seeded with ``--xla-keys`` keys (2M by default) in
   2^17-row ``check_columns`` batches (token bucket, 1 h), the live count
   held against its exact host-side value, timed steady passes (one
   profiled: kernels a pass and slot_write's device time a launch) and the
   check() recipe (limit 3 → remaining 2, 1, 0, then OVER_LIMIT);
5. ``main_probe`` — the headline deployment (BASELINE.json: checks/sec/chip
   at 10M live keys) through ``LocalEngine(capacity=2**24,
   probe="pallas")``: the fused probe walk, 10M keys seeded, steady passes,
   the recipe, every response checked and the exact live count; the
   decide dispatch alone timed, with its device-time split by kernel, and
   one profiled steady pass (``pass_kernels``, ``pass_device_busy_ms``).
   Both ``main`` lines name their ingress (``wire``: compact on the card);
6. ``kernel`` (probe_walk) — the walk kernel against its plain version on
   the same CUDA tensors at the headline shapes, for its three stages, on
   the 10M-key table of phase 5: decide (all five algorithms, math
   "mixed"), install (half the keys held by the table) and merge (live
   rows decoded from the table, half of them re-keyed, evictees on).
   Responses and table bytes must be equal. Each case reports the
   kernel's split of its rows (``units``: writers, singletons, reader
   units, writers that wait) and the decide cases the time of bucket 0
   written over half padding;
7. ``ring`` — the ring path on the same engine: ``prepare_ring_slot`` ×8 →
   ``DeviceRing`` stage + drain (``fence_claim``, then eight decides) →
   ``finish_check_columns``, nine drains of 8 × 16384 rows (half keys the
   table holds, half fresh; one drain profiled), a partly filled slot with
   and without an active key in bucket 0, and two direct 2^17-row passes
   beside them; every response checked, the exact live count, host time of
   prepare / issue / finish, device time, kernels per drain and the host
   syncs inside the issue half (torch.cuda's sync debug mode);
8. ``walk`` — ``install_columns`` and ``merge_rows`` (also
   ``collect=True``) with ``walk="pallas"`` on the card against the same
   engine on the CPU, on contended mixed-algorithm rows: byte-equal;
9. ``parity`` — contended mixed-algorithm ``check_columns`` batches on a
   compact-wire card engine and a full-width CPU engine, for
   ``probe="xla"`` and ``probe="pallas"``: responses, stats and table
   bytes equal;
10. ``ring_parity`` — the card's ring path against the CPU engine's ring
    path and its direct ``check_columns``, on contended mixed-algorithm
    slots at capacity 2^20, for both probes: responses, stats and table
    bytes equal;
11. ``sweeps`` — the exp/ sweep probes (slice 4). Its main path is the
    four entry points ``gubernator_tpu_torch.exp.exp_sweep2``,
    ``exp_sweep4``, ``exp_sweep5`` (default cases) and ``exp_mem2`` at
    their scripts' geometry (``sweeps_main`` line); then each sweep kernel
    against its plain version at that geometry, byte-equal: ``sweep_copy``
    (the 1 GiB table out of place and in place, the bulk-copy stream timed
    beside the grid-stride design it replaced and ``dst.copy_``, with
    ``kernel_over_library``), ``sweep_rows`` (U=64,
    U=128, in place; random rows, masks in [-2, 2], targets in [-1, 2048)),
    ``sweep_slots`` (exp_sweep2's data as drawn and sorted by target,
    planes 8 and 16) and
    ``sweep_window`` (exp_sweep4's claim-routed write at its small check's
    geometry and at blk 2048, 4096 and 8192, where entries drop, and the
    exp_sweep5 cases base, skip2-2048-256, all-1024-128 and
    c5-all-1024-128 on the 8 GiB table), each with device times of the
    kernel, the plain version, a library yardstick and the earlier design
    the kernel replaced (``grid_stride_ms``, ``copy_then_compose_ms``,
    ``link_ms``; checked byte-equal first), and its byte bound;
12. ``kernel`` (ring_exchange) — the mesh's ownership exchange against its
    plain version (``exchange_ref``, the ring schedule) and the all_to_all
    layout (``exchange_collective``) at the mesh phase's geometry: D = 4
    shards of one card, 2^15 rows per shard, C = pair_capacity = 16384,
    forward (4, 12, C) and back (4, C, 4) int64 blocks, byte-equal, with
    times, byte bounds and the library yardstick (the stacked buffer's
    transpose, and ``kernel_over_library``); then 16 and 33 shards of one
    card (the small and the wide parameter block), one launch per
    exchange, byte-equal, with the same times; with two or more cards
    the forward exchange also runs across real cards, else its line says
    why it did not;
13. ``mesh`` — the slice's main path (slice 5): the headline deployment
    sharded four ways on one card, ``GlobalShardedEngine(make_mesh(4,
    devices=["cuda:0"] * 4), capacity_per_shard=2**22, route="device",
    dedup="device", a2a="ring", probe="pallas", wire="compact")``, 10M keys
    seeded through check_columns, every response checked, each shard's
    live count exact; steady passes (decisions/s), profiled passes (device
    time and kernels, the exchanges' share, the walk's time per dispatch),
    a pipelined pass with 0 host syncs in its issue half, ring_exchange
    launched twice and probe_walk four times per device-routed dispatch;
    then probe_walk against probe_walk_ref on shard 0's table at the
    path's owner batch (4·C = 65,536 rows: all active, half padding, half
    padding with an active key in bucket 0), byte-equal, with the
    bucket-0 / half-padding time ratio;
14. ``mesh_parity`` — 4-shard meshes at capacity 2^14 per shard on mixed,
    repeated keys: card vs CPU for route × dedup × probe (and compact card
    vs full-width CPU), ring vs collective on the card, a 16-shard mesh of
    2^12 slots per shard (card ring vs CPU vs card collective, one
    ring_exchange launch per exchange), route host vs route device on
    distinct keys; responses, stats and table bytes equal;
15. ``loop`` (slice 6) — ``ops/loop.decide_loop`` on the engine of phase 4
    (``probe="xla"``, 2M keys) and of phase 5 (``probe="pallas"``, 10M
    keys, after phase 7): 8 stacked batches of 2^17 rows (seven eighths
    live keys, one eighth fresh), one CUDA graph per batch; the graph held
    to the eager loop on a clone of the table (bytes and totals), then
    runs of 32 and 544 iterations, three each, the time per iteration from
    ``bench_guard.slope``, gated by ``check_work`` and ``check_dropped``;
    decisions/s and kernels per replay beside the host-timed pass;
16. ``maint`` (slice 6) — the maintenance surface on phase 5's engine, each
    call held to a numpy oracle on a snapshot: the telemetry scan,
    ``extract_live``, ``read_state`` of 2^17 keys (and raw), a checkpoint
    epoch over one check pass, the idle sweep (``extract_idle`` then
    ``tombstone_fps``) and, last, ``maybe_grow`` to 2^25 slots against
    ``rehash_rows``; host time, event span and the byte bound of each scan;
17. ``maint_parity`` (slice 6) — the same maintenance calls on a card engine
    and a CPU engine at 2^20 slots after contended traffic, for the three
    slot layouts (resize down, maybe_grow, resize up included): outputs,
    stats and table bytes equal;
18. ``mesh_maint`` (slice 7) — the mesh's maintenance surface on phase
    13's engine (10M keys over 4 shards), each call against a numpy oracle
    on a snapshot: the telemetry scan with per-shard live counts,
    ``extract_live``, ``read_state`` of 2^17 keys (and raw), an
    owner-routed ``install_columns`` of 2^16 keys read back,
    ``tombstone_fps``, ``merge_rows`` of 2^16 re-keyed rows read back (and
    ``collect=True``), a checkpoint epoch over one pass, ``extract_idle``
    under a cap and ``maybe_grow`` (False); host time and event span;
19. ``global`` (slice 7) — BASELINE config #3 on one card (``bench.py``
    ``config3_global_case``): ``GlobalShardedEngine(make_mesh(4,
    devices=["cuda:0"] * 4), capacity_per_shard=2**22, sync_out=16384)``
    with the card's defaults, a 1 GiB primary and a 1 GiB replica; 10M
    keys seeded through the plain path (token bucket, limit 2^30, 1 h),
    then eight GLOBAL 2^17-row batches of fresh keys through the
    pipelined hooks from rotating homes (about 2^18 queued entries a
    home), then ``sync()``: one single round (its host syncs counted: only
    the counter fetch), one profiled round (kernels per round), the rest
    as one drain of exactly the rounds left (14). Checked: every response, each replica
    under a quarter full, every owner row at limit − its hits, every
    non-owner replica row equal to the owner's broadcast, exact live
    counts of every primary and replica, slot_write twice per shard per
    round. Reported: host ms per GLOBAL and plain pass, ms per single
    round and per drained round, reconciled entries/s;
20. ``global_parity`` (slice 7) — GLOBAL 4-shard meshes of 2^12 slots per
    shard, sync_out 64: card against CPU with all seven knobs named
    (route, dedup, a2a, write_mode, wire, probe, walk) in four
    combinations, on contended mixed-algorithm GLOBAL and plain rows with
    RESET / DRAIN from rotating homes (check_columns, the pipelined hooks,
    ``check(home_shard=)``), many-round drains and single rounds, compact
    and full outboxes, then install_columns and merge_rows: responses,
    GlobalStats, EngineStats, primary and replica bytes equal;
21. ``mesh_maint_parity`` (slice 7) — the mesh maintenance calls on a card
    mesh and a CPU mesh (4 shards of 2^14 slots) on the three slot
    layouts, ending in an off-family install that migrates a packed mesh:
    outputs, stats and table bytes equal;
22. ``tier`` (slice 8) — the JAX package's tiering deployment (``bench.py``
    ``tiering_case``, "capacity past the HBM wall") at its TPU geometry:
    ``LocalEngine(capacity=2**23, probe="pallas", walk="pallas")`` (512 MiB
    of table) with a ``tier.ShadowTable`` of 4 x 2^23 rows attached, 4 x
    2^23 tracked keys (token bucket, limit 12, one day) in 2^16-row batches
    of 3 hits. The curve at 1x, 2x and 4x tracked/capacity (live rows,
    shadow rows, demotes, promotes); a 4,096-key sample drained to its
    limit, zero over-grant; ``shed`` 0; live + shadow rows == keys
    answered, exactly; the evictee-bearing probe_walk decide and promote
    merge against their plain version at this geometry; the hot-set rate
    (Zipf 1.05 over 2^20 keys) tiered against an engine with no shadow,
    interleaved, best of 3 (the reference's 0.9 target reported, not
    gated); host ms of the evictee harvests and shadow takes per batch,
    host RSS and wall seconds;
23. ``tier_parity`` (slice 8) — tiering on the card against the CPU at 2^14
    slots with 4x tracked keys, for probe xla/pallas x walk xla/pallas:
    the serial path, the pipelined prepare / issue / finish, one ring
    drain and an idle demote with its fault-back, then a 4-shard mesh of
    the card with a shadow (idle demote, routed fault-back): responses,
    EngineStats, table bytes, the shadow's fps and rows in order and its
    stats equal;
24. ``store_parity`` (slice 8) — the Store hooks on the card against the
    CPU: a DictStore on LocalEngine and on a 4-shard device-routed mesh
    (traffic, a restart onto a fresh table, a restore of an empty table,
    the leaky custom-burst and leak-since-write rehydrates) and a
    RecordingStore on GlobalShardedEngine with a backlog deeper than
    sync_out per home (a sync of several rounds, each delivered once):
    every ChangeSet field by field, the stores, stats and table bytes;
25. ``service`` (slice 9) — the port's ``Daemon`` at its default knobs
    over the engine of phase 5 after phases 7 and 15, driven through
    ``get_rate_limits_raw`` (what its gRPC handler calls): 64 concurrent
    submitters, each sending 32 hand-encoded GetRateLimitsReq of 1,000
    token-bucket items (limit 100, 60 s, 1 hit, keys uniform over 10M
    names), once with probe "xla" (the daemon's default) and once with
    "pallas", the clock frozen on the engine's timeline: decisions/s,
    per-request p50 / p99, rows per flush, the daemon's own stage histogram
    (parse, queue wait, put, issue, fetch, encode), launches per flush, and
    the device's busy share (torch.profiler over a quarter of the traffic
    at the same concurrency). For each probe two exact runs at the same
    concurrency hold every response row to the host's count and read each
    key's state back: 64,000 keys hit 4 times each, and distinct keys
    with a limit each (the fused front door); each must have had two or
    more dispatches in flight. Then the same mixed request bytes one at a
    time through a daemon over a 2^16-slot engine on the card and on the
    CPU, response bytes equal; then the headline traffic over gRPC to the
    same daemon (``daemon`` line). The phase fails where grpc, aiohttp,
    protobuf or prometheus_client is missing;
26. ``service_ring`` (slice 10) — the request ring from the front door:
    the port's ``Daemon`` with GUBER_RING_ENABLE (issue ``auto``, which
    must resolve to ``fused`` on the card; slots as wide as the coalesce
    limit) over the same engine, driven by phase 25's headline traffic and
    its distinct-key exact run (256,000 fresh keys, every row held to the
    host's count): ring dispatches against columns-path flushes,
    ``fence_claim`` launches (> 0 on the distinct-key run), slots per
    drain, decisions/s, request p50 / p99, beside phase 25's numbers; then
    card == CPU response bytes through ring-armed daemons at 2^16 slots,
    and a zero-loss ``drain()`` at close;
27. ``durability`` (slice 10) — incremental checkpoints on the headline
    engine: a daemon with GUBER_CHECKPOINT_INTERVAL_MS 250 loads 2^17
    fresh keys, takes the base snapshot, serves three passes over those
    keys while its loop appends delta frames, takes a last frame (copied
    aside: a kill -9's files), closes cleanly (its final compaction); a
    fresh daemon over a new 2^24-slot engine (``walk="pallas"``) restores
    base + deltas, and its live rows equal the first engine's, sorted by
    fingerprint, byte for byte: base snapshot seconds, ms and rows per
    frame, the restore's seconds and its merge launches;
28. ``tier_plane`` (slice 10) — the tiering sweep's host loop: a daemon
    with GUBER_TIER_ENABLED, a spill file and checkpoints over a 2^20-slot
    engine on the card and on the CPU, frozen clock: traffic,
    ``TierManager.sweep_once``, fault-back traffic; card == CPU on the
    responses, the table bytes, the shadow's rows and the delta log (the
    tombstone frame);
29. ``regions`` (slice 10) — two port daemons, dc1 and dc2, over 2^20-slot
    card engines with ``walk="pallas"``, exchanging MULTI_REGION hits on
    shared keys; the phase ticks both region managers' sync until every
    key's count on both sides is the exact union of the hits: rounds,
    reconciled entries/s and the receive path's ``probe_walk`` merges;
30. ``leases`` (slice 11) — edge quota leases on the engine of phase 5
    after phase 27, the JAX package's own lease traffic (``bench.py``
    ``leases_case``, ``ci/bench_cpu.py`` ``lease_smoke``) on the real clock
    through a port ``Daemon`` over gRPC: 8 single-item per-check checkers
    for 0.5 s (the baseline), then one ``LocalLimiter`` (limit 2^24, ttl 200
    ms, initial grant 4096) hammered by 2 admission threads for 0.8 s
    (admissions/s, the fan-in cut, renewals ≥ 2, the grant sizes,
    admissions ≤ the daemon's consumption), then the restart bound on a
    2^20-slot daemon checkpointing every 25 ms (limit 200, ttl 20 s, grant
    60, a kill -9 and a warm restart: admissions ≤ limit +
    outstanding-at-crash and ≥ outstanding-at-crash); slot_write and
    probe_walk launches > 0;
31. ``leases_parity`` (slice 11) — ``lease_script()`` (acquire, the
    partial grant at the per-key cap, a denial at a spent limit, a clamped
    return and renew, forged and unknown returns, priority scaling with
    shrink hints, GLOBAL, MULTI_REGION, TTL expiry) over gRPC through a
    daemon over a 2^16-slot engine on the card and on the CPU, frozen clock,
    one seeded uuid4, for probe xla and pallas: response bytes,
    ``debug_leases()``, the GLOBAL and region queues and the table bytes
    equal;
32. ``discovery`` (slice 11) — two daemons over 2^20-slot card engines
    (one on the fused walk, one at the default knobs) finding each other by
    member-list gossip (no keyring): convergence time, 32 requests of 1,000
    items over 20,000 keys through each door in turn, every key's count
    read back through the other door equal to the hits sent (one owner per
    key), launches of both kernels > 0, and a leave the other daemon
    drops within the pool's suspect window;
33. ``binaries`` (slice 11) — ``python -m
    gubernator_tpu_torch.cmd.cluster -n 3`` on the card, the
    ``healthcheck`` binary against it (exit 0, 3 peers), the ``cli`` load
    generator's one pass over its 2,000-limit corpus in requests of 10
    checks (exit 0, no errors),
    and SIGTERM (exit 0);
34. ``mesh_daemon`` (slice 12) — a port ``Daemon`` over phase 13's engine
    (a ``GlobalShardedEngine`` of 4 shards of one card, 2^22 slots each,
    10M keys, device route and dedup, the ring exchange, the fused walk)
    passed as ``engine=``, counts zeroed after the spawn: phase 25's
    traffic at a quarter of its submitters (16 × 8 × 1,000 items) through
    ``get_rate_limits_raw`` (decisions/s, request p50 / p99, rows and
    launches per flush, the busy share), ring_exchange launched twice per
    device-routed dispatch (the front door's first launches of the
    kernel); an exact run (every key hit 4 times; device dedup gives a
    key's rows in one dispatch one shared answer, and the check follows
    that); GLOBAL items through the replicas and the daemon's collective
    sync tick, the owner's state exact (the reads at every home
    reported); then gRPC;
35. ``mesh_daemon_parity`` (slice 12) — one seeded request sequence (the
    service parity mix plus GLOBAL items), frozen clock, a sync every 8
    requests, through a port mesh daemon of 4 shards of the card and of 4
    CPU shards at 2^14 slots a shard, both with device route, device
    dedup, the ring exchange and the fused walk: response bytes and every
    shard's primary and replica rows equal;
36. ``overload`` (slice 12) — the overload door in front of a 2^20-slot
    card engine: 32 submitters at tiers 0-3 send 1,000-item requests into
    a door armed at 500 ms with a queue bound of 12,000 rows and one
    dispatch of at most 4,000 rows in flight: zero priority inversions,
    no tier-3 row shed, rows shed, and every answered row and every key's
    state equal to the host's count of the answered hits.

Every device time in ``kernel`` lines and in the ``kernels`` line comes
from CUDA events around calls queued behind a spin kernel (``queued_ms``;
for probe_walk, launches of the kernel alone on one prepared schedule;
for slot_write, calls after a sweep of the L2, ``cold_ms``);
torch.profiler gives only the per-kernel splits and busy times of phases
5-7, 13 and 19.

Each kernel's launch count is zeroed just before the phase that drives its
path (4 for slot_write, 5 for probe_walk, 7 for fence_claim, 13 for
ring_exchange, 11 for the four sweep kernels) and read just after. Phases
run in the order 1-3, 12, 4, 15 (xla), 5-7, 15 (pallas), 25-27, 30, 16,
13, 18, 34, 19, 22, 8-10, 14, 35, 20, 17, 21, 23, 24, 28, 29, 31, 32, 36,
33, 11; phases 19, 22, 25-30, 32 and 34-36 zero the counts again before
their own paths. The line before the last
is ``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``. Without a card, or if any phase fails,
it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

NOW = 1_700_000_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (data sheet)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Time per call of `fn` as a caller sees it: CUDA events around
    `inner` back-to-back calls paced by the host's launches (median of
    `reps`, after one warm call)."""
    from gubernator_tpu_torch.exp._timing import events_ms

    return events_ms(fn, reps, inner, queued=False)


def queued_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call of `fn`, the one device timer of the kernels
    line: CUDA events around `calls` back-to-back calls queued behind a
    spin kernel, so the card runs them without waiting on the host
    (median of `reps`, after one warm call). A call that synchronises
    inside (the plain versions' ``unique``) waits for the host anyway, so
    for it this is the time per call."""
    from gubernator_tpu_torch.exp._timing import events_ms

    return events_ms(fn, reps, calls, queued=True)


L2_SCRUB_BYTES = 256 << 20  # five times the H100's 50 MB L2


def cold_ms(fn, reps: int = 21, warm: tuple = ()) -> float:
    """Device time of one call of `fn` with a cold L2: before each call a
    read sweep of L2_SCRUB_BYTES (a sum over a buffer five times the L2)
    evicts what the earlier calls left there, and the call, queued behind
    the sweep, is timed alone by CUDA events (median of `reps`, after one
    warm call). The tensors in `warm` are read back in after the sweep, as
    the kernels that made them leave them in the serving path: the
    in-situ time (inputs warm, the table's lines cold)."""
    scrub = torch.ones(L2_SCRUB_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        scrub.sum()
        for t in warm:
            t.view(torch.uint8).sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del scrub
    return statistics.median(times)


def _is_kernel(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


def _dev_us(ev) -> float:
    v = getattr(ev, "self_device_time_total", None)
    return v if v is not None else getattr(ev, "self_cuda_time_total", 0)


def phase_device() -> dict:
    from gubernator_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    designs = _designs_build_start()
    builds = _build.build_all(list(_build.KERNELS))
    builds["slot_write_designs"] = _designs_build_finish(designs)
    wall = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in builds.items()}
    info = {
        "phase": "device", "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": wall,
        "builds": {k: {"seconds": v["seconds"], "flags": v["flags"]}
                   for k, v in builds.items()},
        "ptxas": ptxas,
    }
    emit(info)
    return info


# The slot_write designs the package's kernel is measured against, built
# from designs/slot_write_designs.cu beside the package's kernels (outside
# the package: the port never calls them).
DESIGNS_SRC = Path(__file__).resolve().parent / "designs" / "slot_write_designs.cu"
SLOT_WRITE_DESIGNS = ("first", "regs_row", "tma", "plain_stores")
_DESIGNS: dict = {}


def _designs_build_start():
    from gubernator_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"libslot_write_designs-{os.getpid()}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(DESIGNS_SRC)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, cmd, time.perf_counter()


def _designs_build_finish(job) -> dict:
    proc, out, cmd, t0 = job
    log, _ = proc.communicate()
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"slot_write designs: nvcc exit {proc.returncode}\n{log}")
    lib = ctypes.CDLL(str(out))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.guber_slot_write_first.argtypes = [p, p, p, ll, ctypes.c_int, ll, p]
    for name in SLOT_WRITE_DESIGNS[1:]:
        getattr(lib, f"guber_slot_write_{name}").argtypes = [p, p, p, p, p, ll, ll,
                                                             ctypes.c_int, p]
    for name in SLOT_WRITE_DESIGNS:
        getattr(lib, f"guber_slot_write_{name}").restype = ctypes.c_int
    _DESIGNS["lib"] = lib
    return {"seconds": secs, "log": log, "path": str(out), "flags": cmd[1:-3]}


def _first_inputs(rows, new16, written, bucket, chosen, lay):
    """The target and the packed payload as the first design's caller formed
    them, with PyTorch ops."""
    n_slots = rows.numel() // lay.F
    target = torch.where(written, bucket * 8 + chosen.to(torch.int32),
                         torch.full_like(bucket, n_slots))
    return target, lay.pack(new16).contiguous()


def _design_calls(rows, new16, written, bucket, chosen, lay) -> dict:
    """name -> fn(rows) running that design on these inputs (for the first
    design, on its target and payload formed once, outside the call)."""
    from gubernator_tpu_torch.ops.slot_write import _CODE

    lib = _DESIGNS["lib"]
    n, n_slots = new16.shape[0], rows.numel() // lay.F
    target, payload = _first_inputs(rows, new16, written, bucket, chosen, lay)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def checked(err):
        if err != 0:
            raise SystemExit(f"slot_write design launch failed: cudaError {err}")

    def fused(name):
        fn = getattr(lib, f"guber_slot_write_{name}")
        return lambda r: checked(fn(r.data_ptr(), new16.data_ptr(), written.data_ptr(),
                                    bucket.data_ptr(), chosen.data_ptr(), n, n_slots,
                                    _CODE[lay.name], stream()))

    return {
        "first": lambda r: checked(lib.guber_slot_write_first(
            r.data_ptr(), payload.data_ptr(), target.data_ptr(), n, lay.F, n_slots,
            stream())),
        **{name: fused(name) for name in SLOT_WRITE_DESIGNS[1:]},
    }


def _first_path(rows, new16, written, bucket, chosen, lay):
    """The first design's whole write as its caller ran it: the target and
    the packed payload by PyTorch ops, then its kernel."""
    target, payload = _first_inputs(rows, new16, written, bucket, chosen, lay)
    err = _DESIGNS["lib"].guber_slot_write_first(
        rows.data_ptr(), payload.data_ptr(), target.data_ptr(), new16.shape[0], lay.F,
        rows.numel() // lay.F, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"slot_write design launch failed: cudaError {err}")


# (case, layout, rows, share of rows the claim did not keep)
SLOT_WRITE_CASES = (
    ("headline_full", "full", 1 << 17, 0.0),
    ("headline_gcra32", "gcra32", 1 << 17, 0.0),
    ("headline_token32", "token32", 1 << 17, 0.0),
    ("ragged_sentinels", "full", 100_003, 0.1),
)


def phase_kernel(seed: int, device: str = "cuda", nb: int = 1 << 21) -> dict:
    """slot_write against slot_write_ref on the card, for each layout, on a
    claim over a table of `nb` buckets; the designs it replaced or beat on
    the same inputs. Returns every case's measurements by name."""
    from gubernator_tpu_torch.ops.layout import LAYOUTS
    from gubernator_tpu_torch.ops.slot_write import slot_write, slot_write_ref

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k = 8
    # the floor of the same timers: one trivial kernel that reads and writes
    # one word (a launch and one round trip to memory)
    tiny = torch.zeros(1, device=dev)
    floor = {"cold": cold_ms(lambda: tiny.add_(1)), "l2_warm": queued_ms(lambda: tiny.add_(1))}
    results = {}
    for name, lname, n, sentinel in SLOT_WRITE_CASES:
        lay = LAYOUTS[lname]
        base = torch.randint(-(2**31), 2**31 - 1, (nb, k * lay.F), dtype=torch.int32,
                             device=dev, generator=gen)
        new16 = torch.randint(-(2**31), 2**31 - 1, (n, 16), dtype=torch.int32,
                              device=dev, generator=gen)
        slots = torch.randperm(nb * k, device=dev, generator=gen)[:n]
        bucket, chosen = (slots // k).to(torch.int32), slots % k
        written = torch.rand(n, device=dev, generator=gen) >= sentinel
        args = (new16, written, bucket, chosen, lay)
        got, want = base.clone(), base.clone()
        slot_write(got, *args)
        slot_write_ref(want, *args)
        designs = _design_calls(got, *args)
        designs_equal = {}
        for d, fn in designs.items():
            out = base.clone()
            fn(out)
            torch.cuda.synchronize()
            designs_equal[d] = bool(torch.equal(out, want))
            del out
        torch.cuda.synchronize()
        diff = got != want
        max_err = int((got[diff].to(torch.int64) - want[diff].to(torch.int64)).abs().max()) \
            if bool(diff.any()) else 0
        equal = bool(torch.equal(got, want))
        del base, diff
        target = torch.where(written, bucket * k + chosen.to(torch.int32),
                             torch.full_like(bucket, nb * k))
        kept = target < nb * k
        n_kept = int(kept.sum())
        idx_k, pay_k = target[kept].to(torch.int64), lay.pack(new16)[kept].contiguous()
        flat = got.view(-1, lay.F)
        calls = {
            "kernel": lambda: slot_write(got, *args),
            "plain": lambda: slot_write_ref(want, *args),
            "library": lambda: flat.index_copy_(0, idx_k, pay_k),
            **{d: (lambda fn=fn: fn(got)) for d, fn in designs.items()},
        }
        # cold: every input and the table's lines read from HBM; in situ:
        # the inputs warm, as the decide leaves them, the table cold; warm:
        # queued calls repeat one working set (18.5 MB at full) that stays
        # in the 50 MB L2; call: calls paced by the host's launches, the
        # host's cost included (first_path: the first design's PyTorch ops
        # and kernel)
        inputs = (new16, written, bucket, chosen)
        cold = {c: cold_ms(f) for c, f in calls.items()}
        insitu = {c: cold_ms(f, warm=inputs) for c, f in calls.items() if c != "plain"}
        warm = {c: queued_ms(f) for c, f in calls.items()}
        call = {c: cuda_ms(calls[c]) for c in ("kernel", "plain", "library")}
        call["first_path"] = cuda_ms(lambda: _first_path(got, *args))
        # bytes the function must move: every row's written flag read; each
        # kept row's bucket, chosen and canonical row read and its slot
        # written once
        nbytes = n + n_kept * (4 + 8 + 64 + lay.F * 4)
        res = {
            "case": name, "layout": lname, "fl": lay.F, "rows": n, "kept": n_kept,
            "table_bytes": nb * k * lay.F * 4, "equal": equal, "max_abs_err": max_err,
            "designs_equal": designs_equal,
            "kernel_ms": cold["kernel"], "plain_ms": cold["plain"],
            "library_ms": cold["library"], "first_ms": cold["first"], "timer": "cold L2",
            "cold_ms": cold, "insitu_ms": insitu, "l2_warm_ms": warm, "call_ms": call,
            "floor_ms": floor,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        results[name] = res
        emit({"phase": "kernel", "name": "slot_write", **res})
        del got, want, new16, written, bucket, chosen, slots, target, flat, idx_k, pay_k
        del calls, designs, args
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if not equal:
            raise SystemExit(f"slot_write disagrees with its plain version ({name})")
        if not all(designs_equal.values()):
            raise SystemExit(f"a slot_write design disagrees with the plain version ({name}): "
                             f"{designs_equal}")
    return results


def _token_cols(fp: np.ndarray, hits: int = 1):
    from gubernator_tpu_torch.ops.batch import RequestColumns

    n = fp.shape[0]
    return RequestColumns(
        fp=fp, algo=np.zeros(n, np.int32), behavior=np.zeros(n, np.int32),
        hits=np.full(n, hits, np.int64), limit=np.full(n, 100, np.int64),
        burst=np.zeros(n, np.int64), duration=np.full(n, 3_600_000, np.int64),
        created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8),
    )


def _kernel_wrappers() -> dict:
    from gubernator_tpu_torch.ops.probe_walk import probe_walk
    from gubernator_tpu_torch.ops.ring_drain import fence_claim
    from gubernator_tpu_torch.ops.slot_write import slot_write
    from gubernator_tpu_torch.parallel.ring import ring_exchange

    return {"slot_write": slot_write, "probe_walk": probe_walk, "fence_claim": fence_claim,
            "ring_exchange": ring_exchange}


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def _zero_launch_counts() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def phase_main(seed: int, n_keys: int, profile_dir, device: str = "cuda",
               capacity: int = 1 << 24, batch: int = 1 << 17,
               probe: str = "xla"):
    """One decide path at the headline deployment: seed `n_keys`, check
    every response and the live count, time steady passes and the decide
    dispatch alone. Returns (info, engine)."""
    from gubernator_tpu_torch import RateLimitRequest, Status
    from gubernator_tpu_torch.ops.batch import (
        ERR_DROPPED, pack_columns, pack_host_batch, pad_batch,
    )
    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.ops.kernel2 import decide2_packed_cols
    from gubernator_tpu_torch.ops.plan import plan_passes

    rng = np.random.default_rng(seed)
    fps = np.unique(rng.integers(1, 2**63 - 1, int(n_keys * 1.001) + 16, dtype=np.int64))
    fps = rng.permutation(fps)[:n_keys]

    eng = LocalEngine(capacity=capacity, device=device, probe=probe)
    nb = eng.table.n_buckets
    _zero_launch_counts()  # counts from here on are this path's
    persisted = np.zeros(n_keys, dtype=bool)
    wrong = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, n_keys, batch):
        rc = eng.check_columns(_token_cols(fps[s:s + batch]), now_ms=NOW)
        ok = rc.err == 0
        persisted[s:s + batch] = ok
        # fresh keys: UNDER_LIMIT, 99 left of 100, reset one hour out
        wrong += int((ok & ((rc.status != 0) | (rc.remaining != 99) | (rc.limit != 100)
                            | (rc.reset_time != NOW + 3_600_000))).sum())
        wrong += int((~ok & (rc.err != ERR_DROPPED)).sum())
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    seed_dispatches = eng.stats.dispatches

    live = eng.live_count(NOW)
    # every bucket keeps its first K persisted keys' worth of occupancy: all
    # keys share one expiry, so an insert only evicts from a full bucket
    expect_live = int(np.minimum(np.bincount(fps[persisted] % nb, minlength=nb), 8).sum())

    # steady state: keys seen before, one 2^17-row batch per pass
    pass_s = []
    steady_wrong = 0
    for i in range(5):
        sl = fps[i * batch:(i + 1) * batch]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rc = eng.check_columns(_token_cols(sl), now_ms=NOW + 1_000)
        pass_s.append(time.perf_counter() - t1)
        steady_wrong += int(((rc.err == 0) & ~np.isin(rc.remaining, (98, 99))).sum())
    # one more steady pass under the profiler: kernels and device time per
    # pass, and slot_write's device time a launch in situ (its inputs warm
    # from the decide, the table's lines mostly cold)
    sl = fps[5 * batch:6 * batch]
    rc, prof_rows = _profile_rows(
        lambda: eng.check_columns(_token_cols(sl), now_ms=NOW + 1_000))
    pass_busy_ms = sum(r[2] for r in prof_rows) / 1e3
    pass_kernels = sum(r[1] for r in prof_rows)
    sw_rows = [(c, us) for name, c, us in prof_rows if "slot_write_kernel" in name]
    sw_launches = sum(c for c, _ in sw_rows)
    sw_us = sum(us for _, us in sw_rows) / sw_launches if sw_launches else None
    steady_wrong += int(((rc.err == 0) & ~np.isin(rc.remaining, (98, 99))).sum())
    # the check() recipe through the string-key path (pure-Python XXH64)
    r = RateLimitRequest(name="t", unique_key="k", hits=1, limit=3, duration=60_000)
    recipe = [eng.check([r], now_ms=NOW)[0] for _ in range(4)]
    recipe_ok = [x.remaining for x in recipe[:3]] == [2, 1, 0] and [
        x.status for x in recipe] == [Status.UNDER_LIMIT] * 3 + [Status.OVER_LIMIT]
    torch.cuda.synchronize()
    launches = _launch_counts()
    dispatches = eng.stats.dispatches

    # the decide dispatch alone, on a staged ingress grid (CUDA events)
    hb, _ = pack_columns(_token_cols(fps[:batch], hits=0), NOW + 2_000)
    (p,) = plan_passes(hb)
    grid = torch.from_numpy(pack_host_batch(pad_batch(p.batch, batch))).to(eng.device)
    decide = lambda: decide2_packed_cols(eng.table, grid, write=eng.write_mode,
                                         math="token", probe=probe)
    decide_ms = cuda_ms(decide, reps=7, inner=3)
    split = _kernel_split(decide, calls=3, out_dir=profile_dir, tag=f"decide_{probe}")
    decide_device_ms = split["device_us"] / 1e3
    # the same dispatch with the table write as the first slot_write design
    # ran it (its PyTorch ops, then its kernel), in turns with the kernel
    decide_turns = _decide_write_turns(decide) if probe == "xla" and _DESIGNS else None

    med = statistics.median(pass_s)
    info = {
        "phase": "main" if probe == "xla" else "main_probe", "probe": probe,
        "wire": eng.wire, "card": torch.cuda.get_device_name(0),
        "capacity": eng.table.capacity, "buckets": nb,
        "table_bytes": eng.table.rows.numel() * 4, "keys": n_keys, "batch": batch,
        "write_mode": eng.write_mode, "seed_s": seed_s,
        "seed_dispatches": seed_dispatches, "seed_keys_per_s": n_keys / seed_s,
        "persisted": int(persisted.sum()), "live": live, "expected_live": expect_live,
        "dropped": eng.stats.dropped, "evicted_unexpired": eng.stats.evicted_unexpired,
        "wrong_rows": wrong, "steady_wrong_rows": steady_wrong,
        "steady_pass_s": pass_s, "steady_decisions_per_s": batch / med,
        "pass_kernels": pass_kernels, "pass_device_busy_ms": pass_busy_ms,
        "slot_write_us_per_launch": sw_us, "slot_write_profiled_launches": sw_launches,
        "decide_ms": decide_ms, "decide_device_ms": decide_device_ms,
        "decide_write_turns": decide_turns,
        "device_split": split,
        "recipe": [[x.status, x.remaining] for x in recipe],
        "launches": launches, "dispatches": dispatches,
    }
    emit(info)
    if wrong or steady_wrong:
        raise SystemExit(f"wrong responses on the {probe} path: {wrong} + {steady_wrong}")
    if live != expect_live:
        raise SystemExit(f"live count {live} != expected {expect_live}")
    if not recipe_ok:
        raise SystemExit(f"check() recipe failed: {info['recipe']}")
    if launches["fence_claim"]:
        raise SystemExit(f"the {probe} check path launched fence_claim: {launches}")
    if probe == "xla":
        if launches["slot_write"] < dispatches or launches["probe_walk"]:
            raise SystemExit(f"xla path launches {launches} for {dispatches} dispatches")
    elif launches["probe_walk"] != dispatches or launches["slot_write"]:
        raise SystemExit(f"pallas path launches {launches} for {dispatches} dispatches")
    return info, eng


def _decide_write_turns(decide, pairs: int = 10) -> dict:
    """Host-paced ms of the decide dispatch `decide` (``cuda_ms``) with
    ``kernel2._write_claim`` as it is and as the first slot_write design's
    caller ran it, in `pairs` pairs of turns, alternating which runs first."""
    from gubernator_tpu_torch.ops import kernel2

    fused = kernel2._write_claim

    def first(table, new16, c):
        _first_path(table.rows, new16, c.written, c.bucket, c.chosen, table.layout)

    out = {"kernel": [], "first": []}
    try:
        for i in range(2 * pairs):
            side = ("kernel", "first")[(i + i // 2) % 2]  # k f f k k f ...
            kernel2._write_claim = fused if side == "kernel" else first
            out[side].append(cuda_ms(decide, reps=7, inner=3))
    finally:
        kernel2._write_claim = fused
    wins = sum(k < f for k, f in zip(out["kernel"], out["first"]))
    return {**out, "median_kernel": statistics.median(out["kernel"]),
            "median_first": statistics.median(out["first"]), "kernel_wins": wins}


def _kernel_split(fn, calls: int = 3, out_dir=None, tag: str = "decide"):
    """Device time of `fn` by kernel name (torch.profiler, `calls` calls
    after one warm call): the top rows per call, largest first. With
    `out_dir`, the table and a chrome trace are written there too."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [{"name": ev.key[:120], "launches": ev.count / calls,
             "device_us": _dev_us(ev) / calls}
            for ev in prof.key_averages() if _is_kernel(ev)]
    rows.sort(key=lambda r: -r["device_us"])
    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"trace_{tag}.json"))
        (out / f"profile_{tag}.json").write_text(json.dumps(rows, indent=1))
    return {"device_us": sum(r["device_us"] for r in rows),
            "kernels": sum(r["launches"] for r in rows), "top": rows[:12]}


# ------------------------------------------------------- the walk kernel


def _walk_bytes(fp, NB: int, layout, written: int, ingress_bytes: int, outw: int) -> int:
    """Bytes the walk must move for these inputs: each touched bucket row
    read once, each written slot stored once, the ingress read once and the
    responses written once."""
    touched = int(torch.unique(fp % NB).numel())
    return (touched * layout.row * 4 + written * layout.F * 4 + ingress_bytes
            + fp.shape[0] * outw * 8)


def _walk_case(name, table, stage, fp, now, active, req, pay16, math, evictees,
               ingress_bytes, path):
    """One stage of probe_walk against its plain version on the same CUDA
    inputs, from the same table bytes; then the times and the bound. `path`
    names the engine whose table and batch shape the case takes."""
    from gubernator_tpu_torch.ops.probe_walk import (
        OC_WRITTEN, OUTW, OUTW_EV, _prepared, probe_walk, probe_walk_ref, walk_schedule,
        walk_units,
    )

    layout = table.layout
    NB = table.rows.shape[0]
    kw = dict(req=req, pay16=pay16, math=math, evictees=evictees)
    got_rows, want_rows = table.rows.clone(), table.rows.clone()
    got = probe_walk(got_rows, layout, stage, fp, now, active, **kw)
    want = probe_walk_ref(want_rows, layout, stage, fp, now, active, **kw)
    torch.cuda.synchronize()
    equal_resp = bool(torch.equal(got, want))
    equal_rows = bool(torch.equal(got_rows, want_rows))
    err = 0
    if not equal_resp:
        err = max(err, int((got - want).abs().max()))
    if not equal_rows:
        d = got_rows != want_rows
        err = max(err, int((got_rows[d].to(torch.int64) - want_rows[d].to(torch.int64))
                           .abs().max()))
    written = int((got[:, OC_WRITTEN] != 0).sum())
    evicted = int((got[:, 5] != 0).sum())
    del want_rows
    call = lambda: probe_walk(got_rows, layout, stage, fp, now, active, **kw)
    # the kernel alone: launches on one prepared schedule (the wrapper's
    # sort and casts are torch kernels of their own; the split shows them)
    _resp, launch = _prepared(got_rows, layout, stage, fp, now, active, req, pay16, math,
                              evictees)
    kernel_ms = queued_ms(launch, calls=10)
    split = _kernel_split(call, calls=5)
    plain = lambda: probe_walk_ref(got_rows, layout, stage, fp, now, active, **kw)
    nbytes = _walk_bytes(fp, NB, layout, written, ingress_bytes,
                         OUTW_EV if evictees else OUTW)
    writers, readers = walk_units(walk_schedule(fp, active, NB)[1])
    units = {"writers": len(writers), "singletons": int((writers[:, 1] - writers[:, 0] == 1)
                                                        .sum()),
             "reader_units": len(readers), "waiting_writers": int((writers[:, 2] > 0).sum()),
             "longest_wait": int(writers[:, 2].max()) if len(writers) else 0}
    res = {
        "path": path, "stage": stage, "case": name, "rows": int(fp.shape[0]), "buckets": NB,
        "written": written, "evicted": evicted,
        "equal": equal_resp and equal_rows, "equal_responses": equal_resp,
        "equal_table": equal_rows, "max_abs_err": err,
        "kernel_ms": kernel_ms, "walk_device_ms": split["device_us"] / 1e3,
        "walk_kernels": split["kernels"], "call_ms": cuda_ms(call, reps=7, inner=3),
        "plain_ms": queued_ms(plain, calls=3, reps=3), "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "units": units,
        "split": split["top"][:6],
    }
    emit({"phase": "kernel", "name": "probe_walk", **res})
    del got_rows
    if not res["equal"]:
        raise SystemExit(f"probe_walk disagrees with its plain version ({stage})")
    return res


def phase_walk_kernel(seed: int, table, batch: int = 1 << 17, path: str = "local",
                      decide_only: bool = False) -> dict:
    """probe_walk against probe_walk_ref on the card, on a copy of a seeded
    table (the local engine's at the headline shapes, or a mesh shard's at
    its owner batch): decide (all rows active, half padding, half padding
    with an active key in bucket 0), then, unless `decide_only`, install
    and merge."""
    from gubernator_tpu_torch.ops.batch import InstallBatch, ReqBatch
    from gubernator_tpu_torch.ops.kernel2 import install_payload16
    from gubernator_tpu_torch.ops.table2 import FP_HI, FP_LO, decode_live_slots

    dev = table.rows.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)
    i64 = torch.int64
    slots, held, _exp = decode_live_slots(table.rows, NOW, table.layout)
    pick = torch.randperm(held.shape[0], device=dev, generator=gen)[:batch]
    half = batch // 2
    new = torch.randint(1, 2**62, (batch - half,), device=dev, generator=gen, dtype=i64)
    fp = torch.cat([held[pick[:half]], new])
    fp = fp[torch.randperm(batch, device=dev, generator=gen)]
    if torch.unique(fp).numel() != batch:
        raise SystemExit("walk kernel phase: fingerprints collided")
    ri = lambda lo, hi, dt=i64: torch.randint(lo, hi, (batch,), device=dev,
                                              generator=gen, dtype=dt)
    now = NOW + 5_000 + ri(-1_000, 1_000)
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    results = {}

    # decide: all five algorithms, every response column
    dur = ri(1, 7200) * 1_000
    req = ReqBatch(
        fp=fp, algo=ri(0, 5, torch.int32),
        behavior=(torch.where(ri(0, 20) == 0, 8, 0) | torch.where(ri(0, 20) == 0, 32, 0))
        .to(torch.int32),
        hits=ri(-1, 4), limit=ri(0, 200), burst=ri(0, 200), duration=dur,
        created_at=now, expire_new=now + dur, greg_interval=torch.zeros_like(dur),
        duration_eff=dur, active=active,
    )
    results["decide"] = _walk_case(
        "mixed, 5 algorithms", table, "decide", fp, now, active, req, None, "mixed",
        False, ingress_bytes=batch * (9 * 8 + 2 * 4 + 1), path=path)

    # the cost of engine padding (fp 0, inactive: all in bucket 0), half the
    # batch: spread over read-only units, then with one active key of
    # bucket 0, whose warp then serves every padding row itself
    pad = torch.arange(batch, device=dev) >= half
    for name, key0 in (("half padding", False), ("half padding, bucket 0 written", True)):
        pfp = torch.where(pad, torch.zeros_like(fp), fp)
        if key0:
            pfp[0] = table.rows.shape[0] * 12_345
        preq = req._replace(fp=pfp, active=~pad)
        results[name] = _walk_case(
            name, table, "decide", pfp, now, ~pad, preq, None, "mixed", False,
            ingress_bytes=batch * (9 * 8 + 2 * 4 + 1), path=path)
    ratio = (results["half padding, bucket 0 written"]["kernel_ms"]
             / results["half padding"]["kernel_ms"])
    results["half padding, bucket 0 written"]["bucket0_ratio"] = ratio
    emit({"phase": "kernel", "name": "probe_walk", "path": path, "rows": batch,
          "bucket0_over_half_padding": ratio,
          "kernel_ms": {k: v["kernel_ms"] for k, v in results.items()},
          "bound_ms": {k: v["bound_ms"] for k, v in results.items()}})
    if decide_only:
        del slots, held
        torch.cuda.empty_cache()
        return results

    # install: owner broadcasts, half for keys the table holds
    remaining = ri(0, 101)
    inst = InstallBatch(
        fp=fp, algo=ri(0, 5, torch.int32), status=ri(0, 2, torch.int32),
        limit=torch.full_like(fp, 100), remaining=remaining,
        reset_time=now + 60_000, duration=torch.full_like(fp, 60_000), now=now,
        active=active, burst=torch.full_like(fp, 100), stamp=now - ri(0, 5_000),
    )
    pay16 = install_payload16(inst).contiguous()
    results["install"] = _walk_case(
        "GLOBAL broadcasts", table, "install", fp, now, active, None, pay16, "mixed",
        False, ingress_bytes=batch * (8 + 8 + 1 + 64), path=path)

    # merge: live rows decoded from the table, half of them re-keyed (so
    # they claim, and evict from full buckets), with evictees
    rows16 = slots[pick].clone()
    mfp = held[pick].clone()
    rekey = torch.arange(batch, device=dev) >= half
    mfp[rekey] = new
    rows16[:, FP_LO] = (mfp & 0xFFFFFFFF).to(torch.int32)
    rows16[:, FP_HI] = (mfp >> 32).to(torch.int32)
    mnow = torch.full_like(mfp, NOW + 1_000)
    i_exp = (rows16[:, 11].to(i64) << 32) | (rows16[:, 10].to(i64) & 0xFFFFFFFF)
    results["merge"] = _walk_case(
        "transferred live rows", table, "merge", mfp, mnow, i_exp >= mnow, None,
        rows16.contiguous(), "mixed", True, ingress_bytes=batch * (8 + 8 + 1 + 64),
        path=path)
    del slots, held, rows16
    torch.cuda.empty_cache()
    return results


def _mixed_cols(rng, n: int, nb: int, pool: np.ndarray, encodable: bool = False):
    """Contended mixed-algorithm rows: repeated keys, hot buckets, RESET /
    DRAIN, Gregorian rows, negative hits, explicit bursts, error rows. With
    `encodable`, the rows the compact wire cannot carry are made plain
    (hits >= 0, no Gregorian row, burst 0), so the batch ships compact."""
    cols = _mixed_cols_all(rng, n, nb, pool)
    if not encodable:
        return cols
    greg = (cols.behavior & 4) != 0
    return cols._replace(
        hits=np.abs(cols.hits), behavior=cols.behavior & ~np.int32(4),
        duration=np.where(greg, 2_000, cols.duration), burst=np.zeros_like(cols.burst))


def _mixed_cols_all(rng, n: int, nb: int, pool: np.ndarray):
    from gubernator_tpu_torch.ops.batch import RequestColumns

    fp = rng.choice(pool, n)  # repeat keys across and within batches
    hot = rng.random(n) < 0.3  # bucket-concentrated new keys: > K per bucket
    fp[hot] = rng.integers(1, 1 << 40, hot.sum()) * nb + rng.integers(0, 64, hot.sum())
    algo = rng.integers(0, 5, n).astype(np.int32)
    beh = (np.where(rng.random(n) < 0.08, 8, 0) | np.where(rng.random(n) < 0.1, 32, 0))
    greg = rng.random(n) < 0.03
    beh = np.where(greg, beh | 4, beh).astype(np.int32)
    dur = np.where(greg, rng.integers(0, 3, n), rng.integers(1, 6, n) * 1_000)
    err = np.zeros(n, np.int8)
    err[rng.random(n) < 0.01] = 1
    return RequestColumns(
        fp=np.where(err == 0, fp, 0).astype(np.int64), algo=algo, behavior=beh,
        hits=rng.integers(-1, 5, n).astype(np.int64),
        limit=rng.integers(0, 20, n).astype(np.int64),
        burst=np.where(rng.random(n) < 0.5, 0, rng.integers(0, 20, n)).astype(np.int64),
        duration=dur.astype(np.int64), created_at=np.zeros(n, np.int64), err=err,
    )


def _same(a, b) -> bool:
    """Equality of two engine results: ints, arrays or tuples of them."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def phase_walk(seed: int, device: str = "cuda", capacity: int = 1 << 20,
               n: int = 4096) -> dict:
    """install_columns and merge_rows (also collect=True) with
    walk="pallas" on the card against the same engine on the CPU, on
    contended mixed-algorithm rows: results and table bytes equal."""
    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.ops.table2 import decode_live_slots

    rng = np.random.default_rng(seed + 2)
    engines = [LocalEngine(capacity=capacity, device=d, walk="pallas", probe="pallas")
               for d in (device, "cpu")]
    nb = engines[0].table.n_buckets
    pool = rng.integers(1, 2**63 - 1, 20_000, dtype=np.int64)

    def both(fn, what):
        a, b = fn(engines[0]), fn(engines[1])
        if not _same(a, b):
            raise SystemExit(f"card and CPU disagree on {what} in phase walk")
        if engines[0].snapshot().tobytes() != engines[1].snapshot().tobytes():
            raise SystemExit(f"card and CPU tables differ after {what} in phase walk")
        return a

    def hot_keys(m):  # new keys concentrated in 64 buckets: > K per bucket
        return rng.integers(1, 1 << 40, m) * nb + rng.integers(0, 64, m)

    now = NOW
    installed = merged = promoted = 0
    for step in range(3):
        cols = _mixed_cols(rng, n, nb, pool)
        both(lambda e: e.check_columns(cols, now_ms=now).status, "check_columns")
        fp = np.unique(np.concatenate([rng.choice(pool, n // 2), hot_keys(n // 2)]))
        m = fp.shape[0]
        algo = rng.integers(0, 5, m).astype(np.int32)
        status = rng.integers(0, 2, m).astype(np.int32)
        rem = rng.integers(0, 51, m).astype(np.int64)
        dur = np.full(m, 30_000, np.int64)
        installed += both(lambda e: e.install_columns(
            fp, algo, status, np.full(m, 50, np.int64), rem, now + dur - rem, dur,
            now_ms=now), "install_columns")
        # transfers: live rows of the table, half of them re-keyed
        live, lfp, _ = decode_live_slots(engines[1].table.rows, now)
        take = rng.permutation(lfp.shape[0])[:n]
        slots = live[take].numpy().copy()
        mfp = lfp[take].numpy().copy()
        mfp[::2] = hot_keys(mfp[::2].shape[0])
        slots[:, 0] = (mfp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        slots[:, 1] = (mfp >> 32).astype(np.int32)
        # a crossed transfer repeats keys: merge_rows splits passes
        dfp = np.concatenate([mfp, mfp[:16]])
        dslots = np.concatenate([slots, slots[:16]])
        merged += both(lambda e: e.merge_rows(dfp, dslots, now_ms=now + 1), "merge_rows")
        uniq, first = np.unique(mfp, return_index=True)
        out = both(lambda e: e.merge_rows(uniq, slots[first], now_ms=now + 2, collect=True),
                   "merge_rows(collect=True)")
        promoted += out[0]
        now += int(rng.integers(500, 3_000))
    sa, sb = (dataclasses.asdict(e.stats) for e in engines)
    if sa != sb:
        raise SystemExit(f"card and CPU stats differ in phase walk: {sa} vs {sb}")
    info = {"phase": "walk", "capacity": engines[0].table.capacity,
            "installed": installed, "merged": merged, "promoted": promoted,
            "equal": True, "stats": sa}
    emit(info)
    return info


def phase_parity(seed: int, device: str = "cuda", capacity: int = 1 << 20) -> dict:
    """Contended mixed-algorithm check_columns batches on a compact-wire
    card engine and a full-width CPU engine, for both probes: responses,
    stats and table bytes equal. Every other batch is compact-encodable;
    the rest fall back to full-width on the card."""
    from gubernator_tpu_torch.ops.batch import pack_columns
    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.ops.wire import pick_base, wire_encodable

    info = {"phase": "parity", "capacity": capacity, "equal": True,
            "wire": {"card": "compact", "cpu": "full"}}
    for probe in ("xla", "pallas"):
        rng = np.random.default_rng(seed + 1)
        gpu = LocalEngine(capacity=capacity, device=device, probe=probe, wire="compact")
        cpu = LocalEngine(capacity=capacity, device="cpu", probe=probe, wire="full")
        nb = gpu.table.n_buckets
        pool = rng.integers(1, 2**63 - 1, 20_000, dtype=np.int64)
        now = NOW
        rows = compact_steps = 0
        for step in range(5):
            cols = _mixed_cols(rng, 4096, nb, pool, encodable=step % 2 == 0)
            hb, _ = pack_columns(cols, now)
            compact_steps += wire_encodable(hb, pick_base(hb))
            a = gpu.check_columns(cols, now_ms=now)
            b = cpu.check_columns(cols, now_ms=now)
            for f in a._fields:
                if not np.array_equal(getattr(a, f), getattr(b, f)):
                    raise SystemExit(f"card and CPU disagree on {f} at step {step} ({probe})")
            if gpu.snapshot().tobytes() != cpu.snapshot().tobytes():
                raise SystemExit(f"card and CPU tables differ after step {step} ({probe})")
            rows += 4096
            now += int(rng.integers(0, 3_000))
        sa, sb = dataclasses.asdict(gpu.stats), dataclasses.asdict(cpu.stats)
        if sa != sb:
            raise SystemExit(f"card and CPU stats differ ({probe}): {sa} vs {sb}")
        info[probe] = {"rows": rows, "compact_steps": compact_steps, "stats": sa}
        if not compact_steps:
            raise SystemExit("phase parity: no batch rode the compact wire")
    emit(info)
    return info


# ------------------------------------------------------- the ring drain


def phase_fence_kernel(seed: int, device: str = "cuda") -> dict:
    """fence_claim against fence_claim_plain on the same CUDA tensors: the
    ring geometry (S 64, W 16384, k 8, int64 fences, tickets across the
    wrap) and, with int32 fences, a gap, a wrap and the k bound. Bank, n
    and fence words must be equal. Returns the ring-geometry case's
    measurements; the library yardstick is the copy alone
    (``grids.index_select`` of the claimed slots, the claim done on the
    host)."""
    from gubernator_tpu_torch.ops.ring_drain import fence_claim, fence_claim_plain

    dev = torch.device(device)
    rng = np.random.default_rng(seed + 11)
    cases = [  # name, S, W, k, published tickets, start, fence type
        ("ring geometry, int64", 64, 16384, 8, range(60, 68), 60, np.int64),
        ("gap, int32", 4, 64, 4, [0, 2, 3], 0, np.int32),
        ("wrap, int32", 4, 64, 4, [6, 7, 8, 9], 6, np.int32),
        ("k bound, int32", 8, 64, 2, range(6), 0, np.int32),
    ]
    results = []
    for name, S, W, k, tickets, start, dt in cases:
        grids = torch.from_numpy(
            rng.integers(-(2**31), 2**31, (S, 5, W + 1), dtype=np.int64).astype(np.int32)
        ).to(dev)
        seq_np = np.zeros(S, np.int64)
        for t in tickets:
            seq_np[t % S] = t + 1
        seq_in = torch.from_numpy(seq_np.astype(dt)).to(dev)
        fence0 = torch.from_numpy(rng.integers(0, 3, S).astype(dt)).to(dev)
        fk, fp_ = fence0.clone(), fence0.clone()
        bank_k, n_k = fence_claim(seq_in, fk, grids, start, k, k)
        bank_p, n_p = fence_claim_plain(seq_in, fp_, grids, start, k, k)
        torch.cuda.synchronize()
        equal = torch.equal(bank_k, bank_p) and torch.equal(n_k, n_p) and torch.equal(fk, fp_)
        err = max(int((bank_k.to(torch.int64) - bank_p.to(torch.int64)).abs().max()),
                  int((fk.to(torch.int64) - fp_.to(torch.int64)).abs().max()),
                  int((n_k - n_p).abs().max()))
        n = int(n_k[0])
        words, fb = 5 * (W + 1), seq_in.element_size()
        # bytes the claim must move: the n claimed slots read, k bank rows
        # written (zeros past the claim), the fence words read and written
        nbytes = n * words * 4 + k * words * 4 + min(k, S) * fb + n * fb + 4
        claimed = torch.tensor([(start + i) % S for i in range(n)], device=dev)
        calls = {
            "kernel": lambda: fence_claim(seq_in, fk, grids, start, k, k),
            "plain": lambda: fence_claim_plain(seq_in, fp_, grids, start, k, k),
            "library": lambda: grids.index_select(0, claimed),
        }
        dev_ms = {c: queued_ms(f) for c, f in calls.items()}
        call_ms = {c: cuda_ms(f) for c, f in calls.items()}
        res = {
            "case": name, "slots": S, "width": W, "k": k, "fence_bytes": fb, "claimed": n,
            "equal": equal, "max_abs_err": err, "kernel_ms": dev_ms["kernel"],
            "plain_ms": dev_ms["plain"], "library_ms": dev_ms["library"],
            "library_call": "grids.index_select(0, claimed slots): the copy alone, "
                            "claim done on the host",
            "kernel_over_library": dev_ms["kernel"] / dev_ms["library"],
            "call_ms": call_ms, "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        emit({"phase": "kernel", "name": "fence_claim", **res})
        results.append(res)
        if not equal:
            raise SystemExit(f"fence_claim disagrees with its plain version ({name})")
    head = dict(results[0])
    head["max_abs_err"] = max(r["max_abs_err"] for r in results)
    head["equal"] = all(r["equal"] for r in results)
    return head


def _profile_rows(fn):
    """Run fn once under torch.profiler: (result, [(kernel name, launches,
    device us)] largest first)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = [(ev.key, ev.count, _dev_us(ev)) for ev in prof.key_averages() if _is_kernel(ev)]
    rows.sort(key=lambda r: -r[2])
    return out, rows


def _profile_once(fn):
    """Run fn once under torch.profiler: (result, device ms of its kernels,
    kernels launched, top rows)."""
    out, rows = _profile_rows(fn)
    return (out, sum(r[2] for r in rows) / 1e3, sum(r[1] for r in rows),
            [{"name": k[:100], "launches": c, "device_us": us} for k, c, us in rows[:6]])


def _issue_counting_syncs(fn):
    """Run fn with torch.cuda's sync debug mode on "warn": (result, list of
    "file:line: message" for each host sync it made)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{Path(w.filename).name}:{w.lineno}: {str(w.message)[:80]}" for w in caught
             if "called a synchronizing" in str(w.message)]
    return out, syncs


def phase_ring(seed: int, eng, slots: int = 64, width: int = 16384, drain_k: int = 8,
               drains: int = 8) -> dict:
    """The ring path on the headline engine (10M keys, probe="pallas"):
    `drains` timed drains plus one profiled, each of `drain_k` full slots
    (half keys the table holds, half fresh, every key once), then one
    partly filled slot with and without an active key in bucket 0, and two
    direct 2^17-row check_columns passes beside them. Every response is
    checked, the live count held to its exact value, and fence_claim must
    have launched once per drain, probe_walk once per dispatch."""
    from gubernator_tpu_torch.ops import ring_drain as rd
    from gubernator_tpu_torch.ops.batch import ERR_DROPPED
    from gubernator_tpu_torch.ops.engine import prepare_ring_slot
    from gubernator_tpu_torch.ops.table2 import REM_I, decode_live_slots
    from gubernator_tpu_torch.service.wire import wire_batch_from_columns

    dev = eng.table.rows.device
    now = NOW + 10_000
    fresh_reset = now + 3_600_000
    nb = eng.table.n_buckets
    rng = np.random.default_rng(seed + 21)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 21)
    slot_live, held_fp, held_exp = decode_live_slots(eng.table.rows, now, eng.table.layout)
    init_occ = torch.bincount(held_fp % nb, minlength=nb)
    full = drains + 1
    n_rows = full * drain_k * width
    pick = torch.randperm(held_fp.shape[0], device=dev, generator=gen)[: n_rows // 2]
    h_fp = held_fp[pick].cpu().numpy()
    h_rem = eng.table.layout.unpack(slot_live[pick])[:, REM_I].to(torch.int64).cpu().numpy()
    h_exp = held_exp[pick].cpu().numpy()
    del slot_live, held_fp, held_exp
    # fresh keys: distinct, none the table holds (collisions with 10M of
    # 2^63 keys are negligible, and dropped anyway)
    extra = 3 * (1 << 17) + 2_000
    fresh = np.unique(rng.integers(1, 2**63 - 1, n_rows - n_rows // 2 + extra + 4_096,
                                   dtype=np.int64))
    fresh = rng.permutation(fresh[~np.isin(fresh, h_fp)])
    fps = np.concatenate([h_fp, fresh[: n_rows - n_rows // 2]])
    is_held = np.arange(n_rows) < h_fp.shape[0]
    exp_rem = np.concatenate([h_rem - 1, np.full(n_rows - h_fp.shape[0], 99)])
    exp_reset = np.concatenate([h_exp, np.full(n_rows - h_fp.shape[0], fresh_reset)])
    order = rng.permutation(n_rows)
    fps, is_held, exp_rem, exp_reset = fps[order], is_held[order], exp_rem[order], exp_reset[order]
    fresh_left = fresh[n_rows - n_rows // 2:]

    tally = {"wrong": 0, "held_refreshed": 0, "dropped": 0}
    persisted_fresh = []

    def check(rc, sl):
        ok = rc.err == 0
        fresh_ans = (rc.status == 0) & (rc.limit == 100) & (rc.remaining == 99) & (
            rc.reset_time == fresh_reset)
        held_ans = (rc.status == 0) & (rc.limit == 100) & (rc.remaining == exp_rem[sl]) & (
            rc.reset_time == exp_reset[sl])
        held = is_held[sl]
        tally["wrong"] += int((ok & ~held & ~fresh_ans).sum() + (ok & held & ~(held_ans | fresh_ans)).sum()
                              + (~ok & ((rc.err != ERR_DROPPED) | held)).sum())
        # a held key evicted earlier in this phase (its bucket full) answers as new
        tally["held_refreshed"] += int((ok & held & ~held_ans & fresh_ans).sum())
        tally["dropped"] += int((~ok).sum())
        persisted_fresh.append(fps[sl][ok & ~held])

    ring = rd.DeviceRing(slots, width, drain_k, device=dev)
    disp0, ev0 = eng.stats.dispatches, eng.stats.evicted_unexpired
    _zero_launch_counts()  # counts from here on are the ring path's
    ticket = 0
    per_drain, syncs = [], []
    profiled = {}
    for d in range(full):
        base = d * drain_k * width
        sls = [slice(base + i * width, base + (i + 1) * width) for i in range(drain_k)]
        wbs = [wire_batch_from_columns(_token_cols(fps[sl])) for sl in sls]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        group = [prepare_ring_slot(eng, [wb], width, now_ms=now) for wb in wbs]
        t1 = time.perf_counter()
        if any(g is None for g in group):
            raise SystemExit("phase ring: a slot did not take the fused wire path")
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def issue():
            e0.record()
            out = rd.issue_ring_group(eng, ring, group, ticket)
            e1.record()
            return out

        if d == drains:  # the profiled drain
            (bank_n, dsyncs), busy_ms, kernels, top = _profile_once(
                lambda: _issue_counting_syncs(issue))
            profiled = {"device_busy_ms": busy_ms, "kernels": kernels, "top": top}
        else:
            bank_n, dsyncs = _issue_counting_syncs(issue)
        t2 = time.perf_counter()
        done = rd.finish_ring_group(eng, group, *bank_n, lambda fn: fn())
        t3 = time.perf_counter()
        for (rc, delta), sl in zip(done, sls):
            eng.stats.merge(delta)
            check(rc, sl)
        syncs += dsyncs
        ticket += drain_k
        per_drain.append({"prepare_ms": (t1 - t0) * 1e3, "issue_ms": (t2 - t1) * 1e3,
                          "finish_ms": (t3 - t2) * 1e3,
                          "device_span_ms": e0.elapsed_time(e1), "syncs": len(dsyncs)})
    timed = per_drain[:drains]
    host_s = sum(p["prepare_ms"] + p["issue_ms"] + p["finish_ms"] for p in timed) / 1e3

    # one partly filled slot (1,000 active rows of `width`), without and
    # with an active key in bucket 0, where the padding rows (fp 0) fall
    partial = {}
    for name, key0 in (("partial slot", False), ("partial slot, key in bucket 0", True)):
        fp = fresh_left[:1_000].copy()
        fresh_left = fresh_left[1_000:]
        if key0:
            fp[0] = nb * int(rng.integers(1, 1 << 40))
        cols = _token_cols(fp)
        group = [prepare_ring_slot(eng, [wire_batch_from_columns(cols)], width, now_ms=now)]
        bank_n, busy_ms, kernels, top = _profile_once(
            lambda: rd.issue_ring_group(eng, ring, group, ticket))
        (rc, delta), = rd.finish_ring_group(eng, group, *bank_n, lambda fn: fn())
        eng.stats.merge(delta)
        ticket += 1
        ok = rc.err == 0
        tally["wrong"] += int((ok & ((rc.remaining != 99) | (rc.reset_time != fresh_reset))).sum()
                              + (~ok & (rc.err != ERR_DROPPED)).sum())
        persisted_fresh.append(fp[ok])
        walk_us = sum(r["device_us"] for r in top if "probe_walk_kernel" in r["name"])
        partial[name] = {"active_rows": 1_000, "device_busy_ms": busy_ms, "kernels": kernels,
                         "walk_kernel_ms": walk_us / 1e3}

    # two direct 2^17-row check_columns passes of fresh keys beside the ring
    direct = {}
    for name in ("direct pass", "direct pass, profiled"):
        fp = fresh_left[: 1 << 17]
        fresh_left = fresh_left[1 << 17:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "direct pass":
            rc = eng.check_columns(_token_cols(fp), now_ms=now)
            direct[name] = {"host_ms": (time.perf_counter() - t0) * 1e3}
        else:
            rc, busy_ms, kernels, _top = _profile_once(
                lambda: eng.check_columns(_token_cols(fp), now_ms=now))
            direct[name] = {"device_busy_ms": busy_ms, "kernels": kernels}
        ok = rc.err == 0
        tally["wrong"] += int((ok & ((rc.remaining != 99) | (rc.reset_time != fresh_reset))).sum()
                              + (~ok & (rc.err != ERR_DROPPED)).sum())
        persisted_fresh.append(fp[ok])
    torch.cuda.synchronize()
    launches = _launch_counts()
    dispatches = eng.stats.dispatches - disp0
    evicted = eng.stats.evicted_unexpired - ev0

    fresh_all = torch.from_numpy(np.concatenate(persisted_fresh)).to(dev)
    occ = init_occ + torch.bincount(fresh_all % nb, minlength=nb)
    expect_live = int(torch.clamp(occ, max=8).sum())
    live = eng.live_count(now)
    n_drains = full + len(partial)
    info = {
        "phase": "ring", "slots": slots, "width": width, "drain_k": drain_k,
        "rows_per_drain": drain_k * width, "drains": n_drains, "timed_drains": drains,
        "probe": eng.probe_mode, "wire": eng.wire,
        "wrong_rows": tally["wrong"], "dropped_rows": tally["dropped"],
        "held_refreshed": tally["held_refreshed"], "evicted_unexpired": evicted,
        "live": live, "expected_live": expect_live,
        "launches": launches, "dispatches": dispatches,
        "decisions_per_s": drains * drain_k * width / host_s,
        "median": {k: statistics.median(p[k] for p in timed) for k in timed[0]},
        "per_drain": per_drain, "profiled_drain": profiled,
        "host_syncs_in_issue": len(syncs), "sync_sources": sorted(set(syncs))[:12],
        "partial": partial, "direct": direct,
    }
    emit(info)
    if tally["wrong"]:
        raise SystemExit(f"phase ring: {tally['wrong']} wrong responses")
    if tally["held_refreshed"] > evicted:
        raise SystemExit(f"phase ring: {tally['held_refreshed']} held keys answered as new, "
                         f"only {evicted} evictions")
    if live != expect_live:
        raise SystemExit(f"phase ring: live count {live} != expected {expect_live}")
    if launches["fence_claim"] != n_drains:
        raise SystemExit(f"phase ring: fence_claim launched {launches['fence_claim']} times "
                         f"for {n_drains} drains")
    if launches["probe_walk"] != dispatches or launches["slot_write"]:
        raise SystemExit(f"phase ring: launches {launches} for {dispatches} dispatches")
    return info


def _ring_slot_cols(rng, m: int, nb: int, pool: np.ndarray, hot_frac: float):
    """One ring slot of mixed-algorithm rows the compact wire carries: keys
    unique in the slot and repeated across slots, `hot_frac` of them in 64
    hot buckets (more than K new keys per bucket: claims drop), a leaky row
    in every slot (one math mode, "mixed"), RESET / DRAIN / priority bits
    and a few error rows."""
    from gubernator_tpu_torch.ops.batch import RequestColumns

    fp = rng.choice(pool, m, replace=False)
    hot = rng.random(m) < hot_frac
    fp[hot] = rng.integers(1, 1 << 40, hot.sum()) * nb + rng.integers(0, 64, hot.sum())
    fp = rng.permutation(np.unique(fp))
    m = fp.shape[0]
    algo = rng.integers(0, 5, m).astype(np.int32)
    algo[0] = 1
    err = np.zeros(m, np.int8)
    err[rng.random(m) < 0.01] = 1
    beh = (np.where(rng.random(m) < 0.08, 8, 0) | np.where(rng.random(m) < 0.1, 32, 0)
           | np.where(rng.random(m) < 0.1, 64, 0))
    return RequestColumns(
        fp=np.where(err == 0, fp, 0).astype(np.int64), algo=algo, behavior=beh.astype(np.int32),
        hits=rng.integers(0, 5, m).astype(np.int64), limit=rng.integers(0, 20, m).astype(np.int64),
        burst=np.zeros(m, np.int64), duration=rng.integers(1, 6, m).astype(np.int64) * 1_000,
        created_at=np.zeros(m, np.int64), err=err,
    )


def _pipelined_group(eng, wbs, now):
    """The CPU engine's pipelined path over a group, in the drain's order:
    prepare and issue every slot, then finish each (claim-drop retries
    after the whole group, as the ring's finish runs them)."""
    from gubernator_tpu_torch.ops import engine as te

    pend = [te.issue_check_columns(eng, te.prepare_check_columns(eng, wb.cols, now_ms=now))
            for wb in wbs]
    out = []
    for p in pend:
        rc, delta = te.finish_check_columns(eng, p, lambda fn: fn())
        eng.stats.merge(delta)
        out.append(rc)
    return out


def phase_ring_parity(seed: int, device: str = "cuda", capacity: int = 1 << 20,
                      slots: int = 8, width: int = 4096, drain_k: int = 4,
                      groups: int = 2) -> dict:
    """The card's ring path against the CPU engine's ring path and a CPU
    engine without the ring, for both probes: responses, stats and table
    bytes equal after every drain. Two mixes: keys repeated across slots
    (no claim drops), held against the CPU engine's direct check_columns;
    and contended slots whose claims drop, held against the CPU engine's
    pipelined prepare/issue/finish in the drain's order — a drain retries a
    slot's dropped rows only after the whole group is decided (the JAX
    package's runner does the same), so there the serial path's table may
    differ."""
    from gubernator_tpu_torch.ops import ring_drain as rd
    from gubernator_tpu_torch.ops.engine import LocalEngine, prepare_ring_slot
    from gubernator_tpu_torch.service.wire import wire_batch_from_columns

    info = {"phase": "ring_parity", "capacity": capacity, "slots": slots, "width": width,
            "drain_k": drain_k, "equal": True}
    for probe in ("xla", "pallas"):
        for mix, hot_frac in (("repeated keys vs check_columns", 0.0),
                              ("contended vs pipelined", 0.3)):
            rng = np.random.default_rng(seed + 3)
            card = LocalEngine(capacity=capacity, device=device, probe=probe, wire="compact")
            cpu = LocalEngine(capacity=capacity, device="cpu", probe=probe, wire="compact")
            other = LocalEngine(capacity=capacity, device="cpu", probe=probe, wire="full")
            rings = [rd.DeviceRing(slots, width, drain_k, device=d) for d in (device, "cpu")]
            nb = card.table.n_buckets
            pool = rng.integers(1, 2**63 - 1, 12_000, dtype=np.int64)
            now, ticket, rows = NOW, 0, 0
            for g in range(groups):
                # row counts in (width/2, width]: the other path pads to the slot width
                wbs = [wire_batch_from_columns(_ring_slot_cols(
                    rng, int(rng.integers(width // 2 + 64, width)), nb, pool, hot_frac))
                    for _ in range(drain_k)]
                answers = []
                for eng, ring in zip((card, cpu), rings):
                    group = [prepare_ring_slot(eng, [wb], width, now_ms=now) for wb in wbs]
                    if any(p is None or p.math != "mixed" for p in group):
                        raise SystemExit("phase ring_parity: a slot left the fused wire path")
                    bank_n = rd.issue_ring_group(eng, ring, group, ticket)
                    done = rd.finish_ring_group(eng, group, *bank_n, lambda fn: fn())
                    for _rc, delta in done:
                        eng.stats.merge(delta)
                    answers.append([rc for rc, _d in done])
                if hot_frac:
                    answers.append(_pipelined_group(other, wbs, now))
                else:
                    answers.append([other.check_columns(wb.cols, now_ms=now) for wb in wbs])
                for i in range(drain_k):
                    for f in answers[0][i]._fields:
                        a, b, c = (getattr(x[i], f) for x in answers)
                        if not (np.array_equal(a, b) and np.array_equal(a, c)):
                            raise SystemExit(f"phase ring_parity: {f} differs, group {g} "
                                             f"slot {i} ({probe}, {mix})")
                snaps = [e.snapshot().tobytes() for e in (card, cpu, other)]
                if not snaps[0] == snaps[1] == snaps[2]:
                    raise SystemExit(f"phase ring_parity: tables differ after group {g} "
                                     f"({probe}, {mix})")
                if not torch.equal(rings[0].seq_out.cpu(), rings[1].seq_out):
                    raise SystemExit(f"phase ring_parity: seq_out differs ({probe}, {mix})")
                ticket += drain_k
                rows += sum(wb.rows for wb in wbs)
                now += int(rng.integers(200, 2_000))
            stats = [dataclasses.asdict(e.stats) for e in (card, cpu, other)]
            if not stats[0] == stats[1] == stats[2]:
                raise SystemExit(f"phase ring_parity: stats differ ({probe}, {mix}): {stats}")
            info[f"{probe}, {mix}"] = {"rows": rows, "stats": stats[0]}
    emit(info)
    return info


# ------------------------------------------------------------- the mesh


MESH_D = 4  # shards of the mesh phases, all on one card unless named otherwise


def _exchange_case(blocks, devices, dev, reps: int = 5) -> dict:
    """ring_exchange against exchange_ref and exchange_collective on the same
    send blocks: byte-equal, then the device times of the kernel, the plain
    version and the library yardstick (the stacked buffer's transpose)."""
    from gubernator_tpu_torch.parallel import ring

    before = ring.ring_exchange.launches
    got = ring.ring_exchange(blocks, devices)
    launches = ring.ring_exchange.launches - before
    want = ring.exchange_ref(blocks, devices)
    coll = ring.exchange_collective(blocks, devices)
    torch.cuda.synchronize()
    err = 0
    equal = True
    for g, w, c in zip(got, want, coll):
        for other in (w, c):
            if not torch.equal(g, other.to(g.device)):
                equal = False
                err = max(err, int((g - other.to(g.device)).abs().max()))
    D = len(blocks)
    nbytes = 2 * sum(b.numel() * b.element_size() for b in blocks)
    res = {"shards": D, "devices": sorted({str(d) for d in devices}),
           "block": list(blocks[0].shape), "dtype": str(blocks[0].dtype).replace("torch.", ""),
           "equal": equal, "max_abs_err": err, "launches_per_exchange": launches,
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    if len(set(devices)) == 1:
        stacked = torch.stack(blocks)  # (D, D, L, C): [source][destination]
        calls = {"kernel": lambda: ring.ring_exchange(blocks, devices),
                 "plain": lambda: ring.exchange_ref(blocks, devices),
                 "library": lambda: stacked.transpose(0, 1).contiguous()}
        dev_ms = {k: queued_ms(f, calls=10, reps=reps) for k, f in calls.items()}
        res.update({"kernel_ms": dev_ms["kernel"], "plain_ms": dev_ms["plain"],
                    "library_ms": dev_ms["library"],
                    "kernel_over_library": dev_ms["kernel"] / dev_ms["library"],
                    "library_call": "torch.stack(sends).transpose(0, 1).contiguous() — the "
                                    "same function on one card",
                    "call_ms": cuda_ms(calls["kernel"], reps=7, inner=5)})
        del stacked
    else:
        # across cards: host clock around synchronised exchanges
        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            for d in set(devices):
                torch.cuda.synchronize(d)
            return (time.perf_counter() - t0) / 10 * 1e3
        res.update({"host_ms_per_exchange": timed(lambda: ring.ring_exchange(blocks, devices)),
                    "plain_host_ms": timed(lambda: ring.exchange_ref(blocks, devices))})
    return res


def phase_ring_exchange_kernel(seed: int, device: str = "cuda:0", c: int = 1 << 15) -> dict:
    """ring_exchange against its plain version and the all_to_all layout at
    the mesh phase's geometry: D = 4 shards of one card, c rows per shard,
    C = pair_capacity(c, 4); forward (D, 12, C) and back (D, C, 4) int64
    blocks, byte-equal, with times and byte bounds. With two or more cards
    the forward exchange also runs across real cards."""
    from gubernator_tpu_torch import _build
    from gubernator_tpu_torch.parallel.a2a import pair_capacity

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 31)
    D = MESH_D
    C = pair_capacity(c, D)
    ri = lambda shape: torch.randint(-(2**62), 2**62, shape, dtype=torch.int64, device=dev,
                                     generator=gen)
    build_s = _build.BUILD_LOG.get("ring_exchange", {}).get("seconds")
    cases = {}
    for name, shape in (("forward", (D, 12, C)), ("back", (D, C, 4))):
        blocks = [ri(shape) for _ in range(D)]
        cases[name] = _exchange_case(blocks, [dev] * D, dev)
        emit({"phase": "kernel", "name": "ring_exchange", "case": name, "rows_per_shard": c,
              "pair_capacity": C, "build_s": build_s, **cases[name]})
        del blocks
    # wider meshes: 16 shards (the small parameter block) and 33 (the wide
    # one), one launch per exchange each
    for wide_d, wide_c in ((16, pair_capacity(c // 4, 16)), (33, 512)):
        name = f"forward, {wide_d} shards"
        blocks = [ri((wide_d, 12, wide_c)) for _ in range(wide_d)]
        cases[name] = _exchange_case(blocks, [dev] * wide_d, dev, reps=3)
        emit({"phase": "kernel", "name": "ring_exchange", "case": name,
              "pair_capacity": wide_c, **cases[name]})
        del blocks
        if dev.type == "cuda" and cases[name]["launches_per_exchange"] != 1:
            raise SystemExit(f"ring_exchange: {wide_d} shards took "
                             f"{cases[name]['launches_per_exchange']} launches, not 1")
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(min(n_cards, D))]
        blocks = [torch.randint(-(2**62), 2**62, (len(cards), 12, C), dtype=torch.int64,
                                device=d) for d in cards]
        cross = _exchange_case(blocks, cards, dev)
        cross["ran"] = True
        del blocks
    else:
        cross = {"ran": False, "why": f"{n_cards} card(s) on this machine: the exchange "
                                      "across cards needs two or more"}
    emit({"phase": "kernel", "name": "ring_exchange", "case": "across cards", **cross})
    if not all(r["equal"] for r in cases.values()) or not cross.get("equal", True):
        raise SystemExit("ring_exchange disagrees with its plain version")
    head = dict(cases["forward"])
    head["max_abs_err"] = max(r["max_abs_err"] for r in cases.values())
    head["back"] = {k: cases["back"][k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                                  "kernel_over_library", "bound_ms", "bytes")}
    head["wide"] = [{k: cases[f"forward, {w} shards"][k]
                     for k in ("shards", "block", "launches_per_exchange", "kernel_ms",
                               "plain_ms", "library_ms", "kernel_over_library", "bound_ms",
                               "bytes", "equal")} for w in (16, 33)]
    head["across_cards"] = cross
    head["build_s"] = build_s
    return head


def _mesh_engine(device, capacity_per_shard, shards: int = MESH_D, engine_cls=None, **kw):
    from gubernator_tpu_torch.parallel import ShardedEngine, make_mesh

    return (engine_cls or ShardedEngine)(make_mesh(shards, devices=[device] * shards),
                                         capacity_per_shard=capacity_per_shard, **kw)


def _count_a2a(eng):
    """Wrap eng._decide to count device-routed dispatches (each launches two
    exchanges; the host-routed last retry launches none)."""
    from gubernator_tpu_torch.parallel.sharded import _StagedA2A

    counts = {"a2a": 0, "host": 0}
    decide = eng._decide

    def counted(tables, staged):
        counts["a2a" if isinstance(staged, _StagedA2A) else "host"] += 1
        return decide(tables, staged)

    eng._decide = counted
    return counts


def phase_mesh(seed: int, n_keys: int, device: str = "cuda:0",
               capacity_per_shard: int = 1 << 22, batch: int = 1 << 17,
               steady: int = 5, profiled: int = 4) -> dict:
    """The slice's main path: the headline deployment (10M live keys,
    2^17-row batches, token bucket) sharded four ways on one card —
    GlobalShardedEngine(route="device", dedup="device", a2a="ring",
    probe="pallas", wire="compact"), 2^22 slots per shard (1 GiB in all):
    the class a mesh daemon serves, so phase mesh_daemon reuses the
    engine; without GLOBAL rows it is the ShardedEngine path.
    Keys are seeded through check_columns; every response is checked and
    each shard's live count held to its exact value; then timed steady
    passes, profiled passes (device time, kernels, the exchanges' share,
    the walk's time per dispatch) and one pipelined pass whose issue half
    must make no host sync. ring_exchange must launch twice per
    device-routed dispatch and probe_walk once per shard and dispatch.
    Last, probe_walk is held byte for byte to its plain version on shard
    0's table at the owner batch of this path (D·C rows)."""
    from gubernator_tpu_torch.ops import engine as te
    from gubernator_tpu_torch.ops.batch import ERR_DROPPED
    from gubernator_tpu_torch.ops.engine import _pad_size
    from gubernator_tpu_torch.ops.table2 import live_count2
    from gubernator_tpu_torch.parallel.a2a import pair_capacity
    from gubernator_tpu_torch.parallel.mesh import shard_of

    rng = np.random.default_rng(seed + 41)
    fps = np.unique(rng.integers(1, 2**63 - 1, int(n_keys * 1.001) + 16, dtype=np.int64))
    fps = rng.permutation(fps)[:n_keys]
    from gubernator_tpu_torch.parallel.global_sync import GlobalShardedEngine

    eng = _mesh_engine(device, capacity_per_shard, engine_cls=GlobalShardedEngine,
                       route="device", dedup="device", a2a="ring", probe="pallas",
                       wire="compact")
    nb = eng.tables[0].n_buckets
    routed = _count_a2a(eng)
    _zero_launch_counts()  # counts from here on are the mesh path's
    persisted = np.zeros(n_keys, dtype=bool)
    wrong = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, n_keys, batch):
        rc = eng.check_columns(_token_cols(fps[s:s + batch]), now_ms=NOW)
        ok = rc.err == 0
        persisted[s:s + batch] = ok
        wrong += int((ok & ((rc.status != 0) | (rc.remaining != 99) | (rc.limit != 100)
                            | (rc.reset_time != NOW + 3_600_000))).sum())
        wrong += int((~ok & (rc.err != ERR_DROPPED)).sum())
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    seed_dispatches = eng.stats.dispatches
    owner = shard_of(fps[persisted], MESH_D)
    expect = [int(np.minimum(np.bincount(fps[persisted][owner == d] % nb, minlength=nb),
                             8).sum()) for d in range(MESH_D)]
    live = [live_count2(t, NOW) for t in eng.tables]

    pass_s, steady_wrong = [], 0
    for i in range(steady):
        sl = fps[i * batch:(i + 1) * batch]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rc = eng.check_columns(_token_cols(sl), now_ms=NOW + 1_000)
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t1)
        steady_wrong += int(((rc.err == 0) & ~np.isin(rc.remaining, (98, 99))).sum())
    per_pass = []
    for i in range(steady, steady + profiled):
        sl = fps[i * batch:(i + 1) * batch]
        rc, rows = _profile_rows(lambda: eng.check_columns(_token_cols(sl), now_ms=NOW + 2_000))
        steady_wrong += int(((rc.err == 0) & ~np.isin(rc.remaining, (97, 98, 99))).sum())
        walk = [r for r in rows if "probe_walk" in r[0]]
        exch = [r for r in rows if "ring_exchange" in r[0]]
        busy_us = sum(r[2] for r in rows)
        per_pass.append({
            "device_busy_ms": busy_us / 1e3, "kernels": sum(r[1] for r in rows),
            "walk_ms": sum(r[2] for r in walk) / 1e3, "walk_launches": sum(r[1] for r in walk),
            "exchange_ms": sum(r[2] for r in exch) / 1e3,
            "exchange_launches": sum(r[1] for r in exch),
            "exchange_share": sum(r[2] for r in exch) / busy_us if busy_us else None,
            "top": [{"name": k[:90], "launches": c, "device_us": us} for k, c, us in rows[:8]],
        })
    # one pass with an active key in bucket 0 of every shard, where the
    # owner's padding rows (fp 0) fall: that bucket's warp serves them all
    sl = fps[(steady + profiled) * batch:(steady + profiled + 1) * batch].copy()
    hi = rng.integers(1, 1 << 29, MESH_D) * MESH_D + np.arange(MESH_D)
    sl[:MESH_D] = (hi << 32) | (rng.integers(1, 1 << 13, MESH_D) * nb)
    rc, rows = _profile_rows(lambda: eng.check_columns(_token_cols(sl), now_ms=NOW + 2_000))
    steady_wrong += int(((rc.err == 0) & ~np.isin(rc.remaining, (97, 98, 99))).sum())
    walk = [r for r in rows if "probe_walk" in r[0]]
    bucket0 = {"device_busy_ms": sum(r[2] for r in rows) / 1e3,
               "walk_ms": sum(r[2] for r in walk) / 1e3,
               "walk_launches": sum(r[1] for r in walk)}
    # one pipelined pass: the issue half must not wait on the card
    sl = fps[(steady + profiled + 1) * batch:(steady + profiled + 2) * batch]
    pend = te.prepare_check_columns(eng, _token_cols(sl), now_ms=NOW + 3_000)
    pend, syncs = _issue_counting_syncs(lambda: te.issue_check_columns(eng, pend))
    rc, delta = te.finish_check_columns(eng, pend, lambda fn: fn())
    eng.stats.merge(delta)
    steady_wrong += int(((rc.err == 0) & ~np.isin(rc.remaining, (96, 97, 98, 99))).sum())
    torch.cuda.synchronize()
    launches = _launch_counts()
    dispatches = eng.stats.dispatches
    # the walk at this path's own shapes, held to its plain version (these
    # launches come after the counts were read): shard 0's table and the
    # owner batch of D·C rows, about half of them padding, with and
    # without an active key in bucket 0
    owner_rows = MESH_D * pair_capacity(_pad_size(-(-batch // MESH_D), floor=8), MESH_D)
    walk_k = phase_walk_kernel(seed, eng.tables[0], batch=owner_rows, path="mesh",
                               decide_only=True)
    med = statistics.median(pass_s)
    walk_ms = [p["walk_ms"] for p in per_pass]
    info = {
        "phase": "mesh", "card": torch.cuda.get_device_name(0), "shards": MESH_D,
        "devices": [str(d) for d in eng.mesh.devices], "route": eng.route, "dedup": eng.dedup,
        "a2a": eng.a2a_impl, "probe": eng.probe_mode, "wire": eng.wire,
        "write_mode": eng.write_mode, "capacity_per_shard": eng.tables[0].capacity,
        "buckets_per_shard": nb,
        "table_bytes": sum(t.rows.numel() * 4 for t in eng.tables), "keys": n_keys,
        "batch": batch, "seed_s": seed_s, "seed_dispatches": seed_dispatches,
        "persisted": int(persisted.sum()), "live": live, "expected_live": expect,
        "dropped": eng.stats.dropped, "evicted_unexpired": eng.stats.evicted_unexpired,
        "a2a_overflow": eng.a2a_overflow, "wrong_rows": wrong,
        "steady_wrong_rows": steady_wrong, "steady_pass_s": pass_s,
        "decisions_per_s": batch / med, "profiled_passes": per_pass,
        "walk_ms_per_dispatch": {"median": statistics.median(walk_ms), "max": max(walk_ms)},
        "bucket0_pass": bucket0,
        "walk_vs_plain_at_owner_batch": {
            name: {f: r[f] for f in ("rows", "buckets", "equal", "max_abs_err", "kernel_ms",
                                     "plain_ms", "bound_ms", "units")}
            for name, r in walk_k.items()},
        "walk_bucket0_over_half_padding": walk_k["half padding, bucket 0 written"][
            "bucket0_ratio"],
        "host_syncs_in_issue": len(syncs), "sync_sources": sorted(set(syncs))[:12],
        "stage_ms": eng.stage_ms, "wire_bytes": eng.wire_bytes,
        "launches": launches, "dispatches": dispatches, "routed_dispatches": routed,
    }
    emit(info)
    if wrong or steady_wrong:
        raise SystemExit(f"phase mesh: wrong responses: {wrong} + {steady_wrong}")
    if live != expect:
        raise SystemExit(f"phase mesh: live counts {live} != expected {expect}")
    if syncs:
        raise SystemExit(f"phase mesh: {len(syncs)} host syncs in the issue half: {syncs[:4]}")
    if launches["ring_exchange"] != 2 * routed["a2a"] or routed["a2a"] == 0:
        raise SystemExit(f"phase mesh: ring_exchange launched {launches['ring_exchange']} "
                         f"times for {routed['a2a']} device-routed dispatches")
    if launches["probe_walk"] != MESH_D * dispatches or launches["slot_write"] \
            or launches["fence_claim"]:
        raise SystemExit(f"phase mesh: launches {launches} for {dispatches} dispatches")
    return info, eng


def phase_mesh_parity(seed: int, device: str = "cuda:0", capacity_per_shard: int = 1 << 14,
                      n: int = 4096, steps: int = 3) -> dict:
    """The 4-shard mesh at a small size, byte for byte: the card's mesh
    against the CPU's for route host/device × dedup host/device × probe
    xla/pallas (and the compact wire on the card against full-width on the
    CPU in one case); on the card, the ring exchange against the
    collective; a 16-shard mesh of 2^12 slots per shard on the card (device
    routing, the ring exchange, one launch per exchange) against the CPU's
    and the card's collective; and route host against route device on
    batches of distinct keys. Responses, EngineStats and snapshot() bytes
    equal."""
    info = {"phase": "mesh_parity", "shards": MESH_D, "capacity_per_shard": capacity_per_shard,
            "rows": n, "steps": steps, "equal": True, "cases": {}}
    knobs = dict(write_mode="sparse", a2a="ring")

    def run(name, engines, make_cols):
        rng = np.random.default_rng(seed + 51)
        nb = engines[0].tables[0].n_buckets
        pool = rng.integers(1, 2**63 - 1, 6_000, dtype=np.int64)
        now = NOW
        for step in range(steps):
            cols = make_cols(rng, nb, pool, step)
            rcs = [e.check_columns(cols, now_ms=now) for e in engines]
            for f in rcs[0]._fields:
                if not all(np.array_equal(getattr(rcs[0], f), getattr(r, f)) for r in rcs[1:]):
                    raise SystemExit(f"phase mesh_parity: {f} differs at step {step} ({name})")
            snaps = [e.snapshot().tobytes() for e in engines]
            if any(sn != snaps[0] for sn in snaps[1:]):
                raise SystemExit(f"phase mesh_parity: tables differ after step {step} ({name})")
            now += int(rng.integers(200, 2_000))
        stats = [dataclasses.asdict(e.stats) for e in engines]
        if any(st != stats[0] for st in stats[1:]):
            raise SystemExit(f"phase mesh_parity: stats differ ({name}): {stats}")
        if any(e.a2a_overflow != engines[0].a2a_overflow for e in engines[1:]):
            raise SystemExit(f"phase mesh_parity: a2a_overflow differs ({name})")
        info["cases"][name] = {"stats": stats[0],
                               "a2a_overflow": [e.a2a_overflow for e in engines]}

    mixed = lambda rng, nb, pool, step: _mixed_cols(rng, n, nb, pool)
    for route in ("host", "device"):
        for dedup in ("host", "device"):
            for probe in ("xla", "pallas"):
                kw = dict(knobs, route=route, dedup=dedup, probe=probe, wire="full")
                run(f"card vs cpu, route {route}, dedup {dedup}, probe {probe}",
                    [_mesh_engine(d, capacity_per_shard, **kw) for d in (device, "cpu")], mixed)
    kw = dict(knobs, route="device", dedup="device", probe="pallas")
    run("compact card vs full-width cpu, route device, dedup device, probe pallas",
        [_mesh_engine(device, capacity_per_shard, wire="compact", **kw),
         _mesh_engine("cpu", capacity_per_shard, wire="full", **kw)],
        lambda rng, nb, pool, step: _mixed_cols(rng, n, nb, pool, encodable=True))
    for probe in ("xla", "pallas"):
        kw = dict(write_mode="sparse", route="device", dedup="device", probe=probe, wire="full")
        run(f"card ring vs card collective, probe {probe}",
            [_mesh_engine(device, capacity_per_shard, a2a=a2a, **kw)
             for a2a in ("ring", "collective")], mixed)

    # 16 shards of one card: the one-launch exchange on an engine path, held
    # to the CPU mesh and to the card's collective exchange
    from gubernator_tpu_torch.parallel import ring

    wide = 16
    kw = dict(write_mode="sparse", route="device", dedup="device", probe="pallas", wire="full")
    name = (f"{wide} shards, card ring vs cpu vs card collective, route device, "
            "dedup device, probe pallas")
    engines = [_mesh_engine(d, 1 << 12, shards=wide, a2a=a2a, **kw)
               for d, a2a in ((device, "ring"), ("cpu", "ring"), (device, "collective"))]
    routed = _count_a2a(engines[0])
    before = ring.ring_exchange.launches
    run(name, engines, mixed)
    launched = ring.ring_exchange.launches - before
    info["cases"][name].update(shards=wide, capacity_per_shard=1 << 12,
                               routed_dispatches=routed, ring_exchange_launches=launched)
    if torch.device(device).type == "cuda" and (launched != 2 * routed["a2a"]
                                                or routed["a2a"] == 0):
        raise SystemExit(f"phase mesh_parity: {wide} shards launched ring_exchange "
                         f"{launched} times for {routed['a2a']} device-routed dispatches")
    del engines

    def distinct(rng, nb, pool, step):
        cols = _mixed_cols(rng, n, nb, pool)
        fp = np.unique(rng.integers(1, 2**63 - 1, 2 * n, dtype=np.int64))[:n]
        return cols._replace(fp=np.where(cols.err == 0, rng.permutation(fp), 0))

    kw = dict(knobs, dedup="host", probe="pallas", wire="full")
    run("card route host vs card route device, distinct keys",
        [_mesh_engine(device, capacity_per_shard, route=r, **kw) for r in ("host", "device")],
        distinct)

    def hot_shard(rng, nb, pool, step):
        # 70% of the rows owned by shard 0: every source block overflows its
        # pair capacity (sigma 0: mean + 8 rows), the retries overflow
        # again, and the last retry routes on the host
        cols = _mixed_cols(rng, n, nb, pool)
        hot = (rng.random(n) < 0.7) & (cols.err == 0)
        fp = cols.fp.copy()
        fp[hot] = rng.choice(pool, int(hot.sum())) & ~np.int64((MESH_D - 1) << 32)
        return cols._replace(fp=fp)

    sigma = os.environ.get("GUBER_A2A_CAPACITY_SIGMA")
    os.environ["GUBER_A2A_CAPACITY_SIGMA"] = "0"
    try:
        kw = dict(knobs, route="device", dedup="device", probe="pallas", wire="full")
        name = "card vs cpu, hot shard overflow (sigma 0), route device, dedup device"
        engines = [_mesh_engine(d, capacity_per_shard, **kw) for d in (device, "cpu")]
        routed = _count_a2a(engines[0])
        run(name, engines, hot_shard)
        info["cases"][name]["routed_dispatches"] = routed
    finally:
        if sigma is None:
            del os.environ["GUBER_A2A_CAPACITY_SIGMA"]
        else:
            os.environ["GUBER_A2A_CAPACITY_SIGMA"] = sigma
    if not info["cases"][name]["a2a_overflow"][0] or not routed["host"]:
        raise SystemExit(f"phase mesh_parity: the hot-shard case did not overflow into the "
                         f"host-routed retry: {info['cases'][name]}")
    emit(info)
    return info


# ------------------------------------------- GLOBAL on the mesh (slice 7)

GLOBAL_BIT = 2  # Behavior.GLOBAL
GLOBAL_LIMIT = 1 << 30


def _limit_cols(fp: np.ndarray, hits, behavior: int = 0):
    """Token-bucket rows of limit 2^30 and 1 h (the GLOBAL phase's config)."""
    from gubernator_tpu_torch.ops.batch import RequestColumns

    n = fp.shape[0]
    return RequestColumns(
        fp=fp, algo=np.zeros(n, np.int32), behavior=np.full(n, behavior, np.int32),
        hits=np.broadcast_to(np.asarray(hits, np.int64), (n,)).copy(),
        limit=np.full(n, GLOBAL_LIMIT, np.int64), burst=np.zeros(n, np.int64),
        duration=np.full(n, 3_600_000, np.int64), created_at=np.zeros(n, np.int64),
        err=np.zeros(n, np.int8))


def _global_engine(device, capacity_per_shard, sync_out, shards: int = MESH_D, **kw):
    from gubernator_tpu_torch.parallel import make_mesh
    from gubernator_tpu_torch.parallel.global_sync import GlobalShardedEngine

    return GlobalShardedEngine(make_mesh(shards, devices=[device] * shards),
                               capacity_per_shard=capacity_per_shard, sync_out=sync_out, **kw)


def phase_global(seed: int, n_keys: int, device: str = "cuda:0",
                 capacity_per_shard: int = 1 << 22, sync_out: int = 16384,
                 batch: int = 1 << 17, n_batches: int = 8) -> dict:
    """BASELINE config #3 on one card (bench.py config3_global_case): the
    GLOBAL behavior over a 4-shard mesh of cuda:0,
    GlobalShardedEngine(capacity_per_shard=2**22, sync_out=16384) with the
    card's defaults (device route and dedup, ring exchange, compact wire,
    fused walk) — a 1 GiB primary and a 1 GiB replica. `n_keys` random keys
    are seeded through the plain path (token bucket, limit 2^30, 1 h, one
    hit); then `n_batches` GLOBAL batches of fresh keys (1-4 hits each)
    through the pipelined hooks, the homes rotating, so each home queues
    about 2^18 entries. sync() then drains them: one single round with its
    host syncs counted, one profiled round, and the rest as one drain of
    exactly the rounds left. Checked: every response; each replica under a
    quarter full; after the sync each key's owner row shows limit − its
    hits, every non-owner replica row equals the owner's broadcast state,
    and every shard's primary and replica live counts are exact. Reported:
    host ms per GLOBAL and plain pass, ms per single round and per drained
    round (every drained round carries work), reconciled entries/s,
    slot_write launches (2 per shard per round) and kernels per round."""
    from gubernator_tpu_torch.ops import engine as te
    from gubernator_tpu_torch.ops.batch import ERR_DROPPED
    from gubernator_tpu_torch.ops.slot_write import slot_write
    from gubernator_tpu_torch.ops.table2 import K, gather_slots_impl, live_count2
    from gubernator_tpu_torch.parallel.mesh import shard_of

    rng = np.random.default_rng(seed + 61)
    n_glob = batch * n_batches
    keys = np.unique(rng.integers(1, 2**63 - 1, int((n_keys + n_glob) * 1.001) + 16,
                                  dtype=np.int64))
    keys = rng.permutation(keys)[:n_keys + n_glob]
    seeded, gkeys = keys[:n_keys], keys[n_keys:]
    ghits = rng.integers(1, 5, n_glob).astype(np.int64)
    del keys
    eng = _global_engine(device, capacity_per_shard, sync_out, route="device",
                         dedup="device", a2a="ring", wire="compact", probe="pallas",
                         write_mode="sparse")
    nb = eng.tables[0].n_buckets
    wrong = {"seed": 0, "plain": 0, "global": 0}
    persisted = np.zeros(n_keys, dtype=bool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, n_keys, batch):
        rc = eng.check_columns(_limit_cols(seeded[s:s + batch], 1), now_ms=NOW)
        ok = rc.err == 0
        persisted[s:s + batch] = ok
        wrong["seed"] += int((ok & ((rc.status != 0) | (rc.remaining != GLOBAL_LIMIT - 1))).sum()
                             + (~ok & (rc.err != ERR_DROPPED)).sum())
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    held = seeded[persisted]

    # plain passes on this engine (held keys, no hits) for their host time;
    # a key that a later seed evicted from its full bucket starts afresh
    plain_ms = []
    for i in range(3):
        sl = held[i * batch:(i + 1) * batch]
        present = eng.read_state(sl)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rc = eng.check_columns(_limit_cols(sl, 0), now_ms=NOW)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t1) * 1e3)
        want = np.where(present, GLOBAL_LIMIT - 1, GLOBAL_LIMIT)
        wrong["plain"] += int(((rc.err == 0) & (rc.remaining != want)).sum())

    # GLOBAL passes through the pipelined hooks; batch i's home is i % D
    _zero_launch_counts()
    global_ms, dropped = [], np.zeros(n_glob, dtype=bool)
    for i in range(n_batches):
        sl, h = gkeys[i * batch:(i + 1) * batch], ghits[i * batch:(i + 1) * batch]
        cols = _limit_cols(sl, h, GLOBAL_BIT)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pend = te.prepare_check_columns(eng, cols, now_ms=NOW)
        pend = te.issue_check_columns(eng, pend)
        rc, delta = te.finish_check_columns(eng, pend, lambda fn: fn())
        eng.stats.merge(delta)
        torch.cuda.synchronize()
        global_ms.append((time.perf_counter() - t1) * 1e3)
        ok = rc.err == 0
        dropped[i * batch:(i + 1) * batch] = ~ok
        wrong["global"] += int((ok & ((rc.status != 0) | (rc.remaining != GLOBAL_LIMIT - h))).sum()
                               + (~ok & (rc.err != ERR_DROPPED)).sum())
    pass_launches = _launch_counts()
    replica_live_before = [live_count2(t, NOW) for t in eng.replica]
    queued = [len(p) for p in eng.pending]
    gs_before = dataclasses.asdict(eng.global_stats)

    # the drain: one single round (host syncs counted), one profiled round,
    # the rest as one drain
    def counted_round():
        torch.cuda.synchronize()
        t = time.perf_counter()
        before = (slot_write.launches, eng.global_stats.broadcasts_applied)
        _, syncs = _issue_counting_syncs(lambda: eng._sync_round(NOW))
        torch.cuda.synchronize()
        return {"ms": (time.perf_counter() - t) * 1e3,
                "slot_write": slot_write.launches - before[0],
                "entries": eng.global_stats.broadcasts_applied - before[1],
                "host_syncs": syncs}

    single = counted_round()
    before = (slot_write.launches, eng.global_stats.broadcasts_applied)
    _, rows = _profile_rows(lambda: eng._sync_round(NOW))
    profiled = {"kernels": sum(r[1] for r in rows), "device_busy_ms": sum(r[2] for r in rows) / 1e3,
                "slot_write": slot_write.launches - before[0],
                "entries": eng.global_stats.broadcasts_applied - before[1],
                "top": [{"name": k[:90], "launches": c, "device_us": us} for k, c, us in rows[:8]]}
    rounds_left = max((len(p) + sync_out - 1) // sync_out for p in eng.pending)
    R = min(rounds_left, eng._SYNC_DRAIN_CAP)  # one drain runs exactly the rounds needed
    before = (slot_write.launches, eng.global_stats.broadcasts_applied,
              eng.global_stats.sync_rounds)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.sync(now_ms=NOW)
    torch.cuda.synchronize()
    drain_ms = (time.perf_counter() - t1) * 1e3
    drain = {"ms": drain_ms, "rounds_needed": rounds_left, "R": R,
             "ms_per_round": drain_ms / R,
             "slot_write": slot_write.launches - before[0],
             "entries": eng.global_stats.broadcasts_applied - before[1],
             "sync_rounds": eng.global_stats.sync_rounds - before[2]}
    drain["entries_per_s"] = drain["entries"] / (drain_ms / 1e3)
    single["entries_per_s"] = single["entries"] / (single["ms"] / 1e3)

    # convergence at 10M keys: owner rows, replica rows, live counts. A
    # bucket holds K keys, so at this load a key can lose its slot to a
    # later one (the primary's live count stays Σ min(keys of a bucket, K));
    # an owner-side row whose slot was taken before the sync comes back
    # fresh from its 0-hit broadcast marker
    owner = shard_of(gkeys, MESH_D)
    home = np.repeat(np.arange(n_batches) % MESH_D, batch)
    found, full = eng.read_state(gkeys)
    owner_wrong = int((found & (full[:, 4] != GLOBAL_LIMIT - ghits)
                       & ~((owner == home) & (full[:, 4] == GLOBAL_LIMIT))).sum())
    fields = [2, 4, 5, 6, 7, 10, 11]  # limit, remaining, flags, duration, expiry
    rep_found, rep_wrong, rep_expect = [], 0, []
    held_owner = shard_of(held, MESH_D)
    prim_expect, overflow = [], 0
    for d in range(MESH_D):
        sel = owner != d
        fp_t = torch.from_numpy(gkeys[sel]).to(eng.replica[d].rows.device)
        slots, fnd = gather_slots_impl(eng.replica[d].rows, fp_t,
                                       torch.ones_like(fp_t, dtype=torch.bool))
        slots, fnd = slots.cpu().numpy(), fnd.cpu().numpy()
        rep_found.append(int(fnd.sum()))
        both = fnd & found[sel]
        rep_wrong += int((both & (slots[:, fields] != full[sel][:, fields]).any(axis=1)).sum())
        nbr = eng.replica[d].n_buckets
        rep_expect.append(int(np.minimum(np.bincount(gkeys[sel] % nbr, minlength=nbr),
                                         K).sum()))
        cnt = (np.bincount(held[held_owner == d] % nb, minlength=nb)
               + np.bincount(gkeys[owner == d] % nb, minlength=nb))
        prim_expect.append(int(np.minimum(cnt, K).sum()))
        overflow += int(np.maximum(cnt - K, 0).sum())
        del slots, fnd, fp_t, both
    rep_live = [live_count2(t, NOW) for t in eng.replica]
    prim_live = [live_count2(t, NOW) for t in eng.tables]
    info = {
        "phase": "global", "card": torch.cuda.get_device_name(0), "shards": MESH_D,
        "devices": [str(d) for d in eng.mesh.devices], "route": eng.route, "dedup": eng.dedup,
        "a2a": eng.a2a_impl, "probe": eng.probe_mode, "walk": eng.walk_mode, "wire": eng.wire,
        "capacity_per_shard": eng.tables[0].capacity, "sync_out": sync_out,
        "table_bytes": sum(t.rows.numel() * 4 for t in eng.tables),
        "replica_bytes": sum(t.rows.numel() * 4 for t in eng.replica),
        "keys": n_keys, "persisted": int(persisted.sum()), "seed_s": seed_s,
        "global_keys": n_glob, "global_batches": n_batches, "batch": batch,
        "global_pass_ms": global_ms, "plain_pass_ms": plain_ms,
        "global_pass_median_ms": statistics.median(global_ms[1:]),
        "plain_pass_median_ms": statistics.median(plain_ms),
        "global_dropped": int(dropped.sum()), "pass_launches": pass_launches,
        "queued_per_home": queued, "replica_live_after_passes": replica_live_before,
        "global_stats_before_sync": gs_before,
        "global_stats": dataclasses.asdict(eng.global_stats),
        "single_round": single, "profiled_round": profiled, "drain": drain,
        "owner_missing": int((~found).sum()), "owner_missing_bound": overflow,
        "owner_wrong": owner_wrong,
        "replica_found": rep_found, "replica_expected": rep_expect, "replica_live": rep_live,
        "replica_wrong": rep_wrong, "primary_live": prim_live, "primary_expected": prim_expect,
        "wrong_rows": wrong, "stats": dataclasses.asdict(eng.stats),
    }
    emit(info)
    bad = []
    if any(wrong.values()):
        bad.append(f"wrong responses {wrong}")
    if max(replica_live_before) > capacity_per_shard // 4:
        bad.append(f"replica over a quarter full: {replica_live_before}")
    if owner_wrong or int((~found).sum()) > overflow:
        bad.append(f"owner rows: {owner_wrong} wrong, {int((~found).sum())} missing "
                   f"(at most {overflow} can lose their slot)")
    if rep_wrong or rep_found != rep_expect or rep_live != rep_expect:
        bad.append(f"replicas: {rep_wrong} wrong, found {rep_found}, live {rep_live}, "
                   f"expected {rep_expect}")
    if prim_live != prim_expect:
        bad.append(f"primary live {prim_live} != expected {prim_expect}")
    if single["slot_write"] != 2 * MESH_D or profiled["slot_write"] != 2 * MESH_D \
            or drain["slot_write"] != 2 * MESH_D * R:
        bad.append(f"slot_write launches per round: single {single['slot_write']}, "
                   f"profiled {profiled['slot_write']}, drain {drain['slot_write']} for R={R}")
    # the one sync allowed: the counter fetch at the end of global_sync._drain
    if len(single["host_syncs"]) > 1 or any(not x.startswith("global_sync.py")
                                            for x in single["host_syncs"]):
        bad.append(f"host syncs in a round: {single['host_syncs'][:4]}")
    if eng.has_pending() or drain["sync_rounds"] != rounds_left:
        bad.append(f"drain left {[len(p) for p in eng.pending]}, rounds {drain['sync_rounds']}")
    if bad:
        raise SystemExit("phase global: " + "; ".join(bad))
    return info


def _global_parity_cols(rng, n: int, nb: int, pool: np.ndarray, encodable: bool):
    """Contended mixed rows (RESET, DRAIN, hot buckets, repeated keys) with
    GLOBAL on about 70% of them."""
    cols = _mixed_cols(rng, n, nb, pool, encodable=encodable)
    glob = rng.random(n) < 0.7
    return cols._replace(behavior=np.where(glob, cols.behavior | GLOBAL_BIT,
                                           cols.behavior).astype(np.int32))


def phase_global_parity(seed: int, device: str = "cuda:0", capacity_per_shard: int = 1 << 12,
                        sync_out: int = 64, n: int = 2048, steps: int = 4) -> dict:
    """GLOBAL 4-shard meshes at 2^12 slots per shard, sync_out 64: the
    card's engine against the CPU's, every knob named to both (route,
    dedup, a2a, write_mode, wire, probe, walk), on contended mixed-algorithm
    GLOBAL and plain rows with RESET_REMAINING and DRAIN_OVER_LIMIT from
    rotating homes (check_columns, the pipelined hooks, and object-API
    checks at explicit homes), many-round drains and single rounds,
    compact and full outboxes, then install_columns and merge_rows through the walk.
    Responses, GlobalStats, EngineStats and the primary and replica bytes
    equal after every step."""
    from gubernator_tpu_torch import RateLimitRequest
    from gubernator_tpu_torch.ops import engine as te

    cases = [
        dict(route="device", dedup="device", a2a="ring", write_mode="sparse", wire="compact",
             probe="pallas", walk="pallas"),
        dict(route="host", dedup="host", a2a="ring", write_mode="sparse", wire="full",
             probe="xla", walk="xla"),
        dict(route="device", dedup="host", a2a="collective", write_mode="sweep",
             wire="compact", probe="xla", walk="pallas"),
        dict(route="host", dedup="device", a2a="ring", write_mode="xla", wire="full",
             probe="pallas", walk="xla"),
    ]
    info = {"phase": "global_parity", "shards": MESH_D, "capacity_per_shard": capacity_per_shard,
            "sync_out": sync_out, "rows": n, "steps": steps, "cases": []}
    for kw in cases:
        name = ", ".join(f"{k} {v}" for k, v in kw.items())
        engines = [_global_engine(d, capacity_per_shard, sync_out, **kw) for d in (device, "cpu")]
        rng = np.random.default_rng(seed + 71)
        nb = engines[0].tables[0].n_buckets
        pool = rng.integers(1, 2**63 - 1, 3_000, dtype=np.int64)
        encodable = kw["wire"] == "compact"
        wires = []

        def same(what):
            a, b = engines
            st = [(dataclasses.asdict(e.stats), dataclasses.asdict(e.global_stats))
                  for e in engines]
            if st[0] != st[1]:
                raise SystemExit(f"phase global_parity ({name}): stats differ after {what}: "
                                 f"{st}")
            if a.snapshot().tobytes() != b.snapshot().tobytes():
                raise SystemExit(f"phase global_parity ({name}): primaries differ after {what}")
            reps = [np.stack([t.rows.cpu().numpy() for t in e.replica]).tobytes()
                    for e in engines]
            if reps[0] != reps[1]:
                raise SystemExit(f"phase global_parity ({name}): replicas differ after {what}")

        def answers(rcs, what):
            for f in rcs[0]._fields:
                if not np.array_equal(getattr(rcs[0], f), getattr(rcs[1], f)):
                    raise SystemExit(f"phase global_parity ({name}): {f} differs at {what}")

        def drain(what):
            wire_boxes = engines[0]._wire_boxes
            seen = []
            engines[0]._wire_boxes = lambda boxes, now: seen.append(wire_boxes(boxes, now)) \
                or seen[-1]
            rounds = max((len(p) + sync_out - 1) // sync_out for p in engines[0].pending)
            for e in engines:
                e.sync(now_ms=now)
            engines[0]._wire_boxes = wire_boxes
            wires.append({"rounds": rounds, "compact": seen})
            same(what)

        now = NOW
        for step in range(steps):
            cols = _global_parity_cols(rng, n, nb, pool, encodable)
            if step % 2:
                rcs = []
                for e in engines:
                    p = te.issue_check_columns(e, te.prepare_check_columns(e, cols, now_ms=now))
                    rc, delta = te.finish_check_columns(e, p, lambda fn: fn())
                    e.stats.merge(delta)
                    rcs.append(rc)
            else:
                rcs = [e.check_columns(cols, now_ms=now) for e in engines]
            answers(rcs, f"step {step}")
            same(f"step {step}")
            reqs = [RateLimitRequest(name="gp", unique_key=f"k{int(k)}", hits=int(h), limit=9,
                                     duration=4_000, algorithm=int(a), behavior=GLOBAL_BIT)
                    for k, h, a in zip(rng.integers(0, 40, 48), rng.integers(0, 4, 48),
                                       rng.integers(0, 5, 48))]
            home = step % MESH_D
            got = [[(r.status, r.limit, r.remaining, r.reset_time, r.error)
                    for r in e.check(reqs, now_ms=now, home_shard=home)] for e in engines]
            if got[0] != got[1]:
                raise SystemExit(f"phase global_parity ({name}): check() differs at {step}")
            if step % 2:
                drain(f"sync after step {step}")  # a deep backlog: many-round drains
            now += int(rng.integers(200, 1_500))
        cols = _global_parity_cols(rng, 64, nb, pool, encodable)
        answers([e.check_columns(cols, now_ms=now) for e in engines], "last step")
        drain("single round")
        # the peer plane through the walk knob, on the GLOBAL engine
        m = 512
        ifp = np.concatenate([rng.choice(pool, m // 2, replace=False),
                              rng.integers(1, 2**63 - 1, m // 2)])
        ikw = dict(fp=ifp, algo=rng.integers(0, 5, m).astype(np.int32),
                   status=rng.integers(0, 2, m).astype(np.int32),
                   limit=rng.integers(1, 30, m).astype(np.int64),
                   remaining=rng.integers(0, 30, m).astype(np.int64),
                   reset_time=now + rng.integers(1, 10**6, m).astype(np.int64),
                   duration=np.full(m, 60_000, np.int64), now_ms=now)
        inst = [e.install_columns(**ikw) for e in engines]
        live, lslots = engines[0].extract_live(now)
        mfp = rng.integers(1, 1 << 40, m) * nb + rng.integers(0, 64, m)
        ms = lslots[rng.permutation(live.shape[0])[:m]].copy()
        ms[:, 0] = (mfp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        ms[:, 1] = (mfp >> 32).astype(np.int32)
        merged = [e.merge_rows(mfp[:ms.shape[0]], ms, now_ms=now) for e in engines]
        if inst[0] != inst[1] or merged[0] != merged[1]:
            raise SystemExit(f"phase global_parity ({name}): install {inst} / merge {merged}")
        same("install and merge")
        info["cases"].append({"knobs": kw, "global_stats": dataclasses.asdict(
            engines[0].global_stats), "stats": dataclasses.asdict(engines[0].stats),
            "drains": wires, "installed": inst[0], "merged": merged[0]})
        del engines
    if not any(True in d["compact"] for c in info["cases"] for d in c["drains"]) or not any(
            False in d["compact"] for c in info["cases"] for d in c["drains"]):
        raise SystemExit("phase global_parity: compact and full outboxes were not both sent")
    if not any(d["rounds"] > 1 for c in info["cases"] for d in c["drains"]) or not any(
            d["rounds"] == 1 for c in info["cases"] for d in c["drains"]):
        raise SystemExit("phase global_parity: single rounds and many-round drains not both run")
    info["equal"] = True
    emit(info)
    return info


def phase_mesh_maint(seed: int, eng, batch: int = 1 << 17, m: int = 1 << 16,
                     idle_cap: int = 1 << 16) -> dict:
    """The mesh's maintenance surface on the `mesh` phase's engine (10M
    keys over 4 shards of one card), every call once against a numpy oracle
    on a snapshot: the telemetry scan (host_telemetry, per-shard live
    counts), extract_live, read_state of `batch` keys (and raw), an
    owner-routed install_columns of `m` keys (half held, half new; read
    back), tombstone_fps of the installed keys, merge_rows of `m` re-keyed
    live rows (read back) and with collect=True, a checkpoint epoch
    over one check pass, extract_idle under a cap and maybe_grow (False on
    a mesh). Host time and event span of each."""
    from gubernator_tpu_torch.ops.checkpoint import EpochTracker
    from gubernator_tpu_torch.ops.telemetry import finish_scan, host_telemetry
    from gubernator_tpu_torch.parallel.mesh import shard_of

    lay = eng.table.layout
    nb = eng.table.n_buckets
    D = eng.n_shards
    tbytes = sum(t.rows.numel() * 4 for t in eng.tables)
    now = NOW + 30_000
    rng = np.random.default_rng(seed + 81)
    times, checks = {}, {}
    snap = _timed(times, "snapshot", eng.snapshot)

    tele = _timed(times, "telemetry", lambda: finish_scan(eng.telemetry_begin(now)), tbytes)
    want = host_telemetry(snap, now, layout=lay)
    per_shard = [int(_host_live(snap[d], now, lay)[0].shape[0]) for d in range(D)]
    checks["telemetry"] = (dataclasses.replace(tele, scan_ms=0.0, per_shard_live=None) == want
                           and tele.per_shard_live == per_shard)
    live_n = _timed(times, "live_count", lambda: eng.live_count(now), tbytes)

    def read_oracle(s, fps):
        owner = shard_of(fps, D)
        found = np.zeros(fps.shape[0], bool)
        full = np.zeros((fps.shape[0], 16), np.int32)
        raw = np.zeros((fps.shape[0], lay.F), np.int32)
        for d in range(D):
            sel = owner == d
            found[sel], full[sel], raw[sel] = _host_read_state(s[d], fps[sel], lay)
        return found, full, raw

    fps, slots = _timed(times, "extract_live", lambda: eng.extract_live(now), tbytes)
    _idx, hfp, hslots = _host_live(snap, now, lay)
    checks["extract_live"] = (np.array_equal(fps, hfp) and np.array_equal(slots, hslots)
                              and fps.shape[0] == live_n == tele.live_keys == sum(per_shard))
    del slots, hslots

    probe = np.concatenate([rng.choice(hfp, batch // 2, replace=False),
                            rng.integers(1, 2**63 - 1, batch // 2, dtype=np.int64)])
    found, full = _timed(times, "read_state", lambda: eng.read_state(probe))
    _f, raw = _timed(times, "read_state_raw", lambda: eng.read_state(probe, raw=True))
    w_found, w_full, w_raw = read_oracle(snap, probe)
    checks["read_state"] = (np.array_equal(found, w_found) and np.array_equal(full, w_full)
                            and np.array_equal(raw, w_raw) and int(found.sum()) >= batch // 2)
    del full, raw, w_full, w_raw

    # install: half held keys, half new ones; read back from the owners
    ifp = np.concatenate([rng.choice(hfp, m // 2, replace=False),
                          rng.integers(1, 2**63 - 1, m // 2, dtype=np.int64)])
    rem = rng.integers(0, 100, m).astype(np.int64)
    n_inst = _timed(times, "install_columns", lambda: eng.install_columns(
        fp=ifp, algo=np.zeros(m, np.int32), status=np.zeros(m, np.int32),
        limit=np.full(m, 100, np.int64), remaining=rem,
        reset_time=np.full(m, now + 3_600_000, np.int64),
        duration=np.full(m, 3_600_000, np.int64), now_ms=now))
    # (a full bucket can refuse a key: the install then leaves it as it was)
    f2, full2 = eng.read_state(ifp)
    h = m // 2
    landed = np.concatenate([f2[:h] & (full2[:h, 4] == rem[:h]), f2[h:]])
    checks["install_columns"] = (n_inst == int(landed.sum()) >= m - 64
                                 and np.array_equal(full2[landed, 4], rem[landed]))
    gone = _timed(times, "tombstone", lambda: eng.tombstone_fps(ifp))
    checks["tombstone"] = gone == int(f2.sum()) and not eng.read_state(ifp)[0].any()

    # merge: live rows re-keyed to fresh keys land verbatim
    take = rng.permutation(hfp.shape[0])[:m + 4096]
    snap_rows = snap.reshape(-1, lay.F)[_idx[take]]
    canon = lay.unpack(snap_rows)
    mfp = rng.integers(1, 2**63 - 1, take.shape[0], dtype=np.int64)
    canon[:, 0] = (mfp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    canon[:, 1] = (mfp >> 32).astype(np.int32)
    n_merged = _timed(times, "merge_rows", lambda: eng.merge_rows(mfp[:m], canon[:m],
                                                                  now_ms=now))
    f3, full3 = eng.read_state(mfp[:m])
    checks["merge_rows"] = (n_merged == m and bool(f3.all())
                            and np.array_equal(full3, canon[:m]))
    cnt, mask, ev_fp, ev_rows = _timed(times, "merge_rows_collect", lambda: eng.merge_rows(
        mfp[m:], canon[m:], now_ms=now, collect=True))
    f4, _ = eng.read_state(mfp[m:])
    f5, _ = eng.read_state(ev_fp) if ev_fp.size else (np.zeros(0, bool), None)
    checks["merge_rows_collect"] = (cnt == int(mask.sum()) and np.array_equal(mask, f4)
                                    and not f5.any())
    del snap_rows, canon

    # a checkpoint epoch over one check pass of held keys
    eng.ckpt = EpochTracker(nb, n_shards=D)
    pass_fp = rng.choice(hfp, batch, replace=False)
    _timed(times, "check_pass_marked",
           lambda: eng.check_columns(_token_cols(pass_fp), now_ms=now))
    epoch, gids = eng.ckpt.take()
    cfp, cslots = _timed(times, "checkpoint_extract",
                         lambda: eng.checkpoint_finish(eng.checkpoint_begin(gids, now)))
    snap = eng.snapshot()
    blk, nblk = eng.ckpt.blk, eng.ckpt.nblk
    rows = np.concatenate([snap[g // nblk, (g % nblk) * blk:(g % nblk + 1) * blk] for g in gids])
    _i, bfp, bslots = _host_live(rows, now, lay)
    owner = shard_of(pass_fp, D)
    want_g = np.unique(owner * nblk + (pass_fp % nb) // blk)
    checks["checkpoint"] = (np.array_equal(gids, want_g) and np.array_equal(cfp, bfp)
                            and np.array_equal(cslots, bslots))
    ck = {"epoch": epoch, "dirty_blocks": int(gids.shape[0]), "rows": int(cfp.shape[0])}
    del rows, cslots, bslots
    eng.ckpt = None

    # the idle sweep's read, capped shard by shard
    idle_ms = 25_000
    ifp2, islots = _timed(times, "extract_idle", lambda: eng.extract_idle(now, idle_ms, idle_cap),
                          tbytes)
    idx, hfp2, hslots = _host_live(snap, now, lay)
    idle = (now - lay.idle_ref(hslots)) >= idle_ms
    checks["extract_idle"] = (np.array_equal(ifp2, hfp2[idle][:idle_cap])
                              and np.array_equal(islots, hslots[idle][:idle_cap]))
    del idx, hfp2, hslots, islots, snap
    grown = _timed(times, "maybe_grow", lambda: eng.maybe_grow(threshold=0.01, now_ms=now))
    checks["maybe_grow"] = grown is False
    info = {
        "phase": "mesh_maint", "card": torch.cuda.get_device_name(0), "shards": D,
        "layout": lay.name, "table_bytes": tbytes, "live": live_n, "per_shard_live": per_shard,
        "read_state_rows": batch, "installed": n_inst, "merged": n_merged,
        "collected": {"merged": cnt, "evicted": int(ev_fp.size)}, "tombstoned": gone,
        "checkpoint": ck, "idle_rows": int(ifp2.shape[0]), "times": times, "checks": checks,
        "hbm_bytes_per_decision": eng.hbm_bytes_per_decision_estimate(),
    }
    emit(info)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"phase mesh_maint: {bad} disagree with their numpy oracles")
    return info


def phase_mesh_maint_parity(seed: int, device: str = "cuda:0",
                            capacity_per_shard: int = 1 << 14, n: int = 4096,
                            steps: int = 3) -> dict:
    """The mesh maintenance calls on a card mesh and a CPU mesh (4 shards,
    every knob named, an epoch tracker each) after contended traffic, for
    the three slot layouts: extract_live, extract_idle, read_state (and
    raw), the telemetry scan, a checkpoint epoch, install_columns,
    merge_rows (and collect=True), tombstone_fps and an off-family install
    that migrates a packed mesh to full. Every output, the stats and the
    snapshot bytes equal."""
    from gubernator_tpu_torch.ops.checkpoint import EpochTracker
    from gubernator_tpu_torch.ops.telemetry import finish_scan

    info = {"phase": "mesh_maint_parity", "shards": MESH_D,
            "capacity_per_shard": capacity_per_shard, "equal": True}
    knobs = dict(route="device", dedup="device", a2a="ring", write_mode="sparse", wire="full",
                 probe="pallas", walk="pallas")
    for layout in ("full", "gcra32", "token32"):
        rng = np.random.default_rng(seed + 91)
        engines = [_mesh_engine(d, capacity_per_shard, layout=layout, **knobs)
                   for d in (device, "cpu")]
        for e in engines:
            e.ckpt = EpochTracker(e.table.n_buckets, n_shards=MESH_D)
        nb = engines[0].table.n_buckets
        pool = rng.integers(1, 2**63 - 1, 20_000, dtype=np.int64)
        calls = []

        def both(fn, what):
            a, b = fn(engines[0]), fn(engines[1])
            if not _same(a, b):
                raise SystemExit(f"phase mesh_maint_parity ({layout}): card and CPU disagree "
                                 f"on {what}")
            if engines[0].snapshot().tobytes() != engines[1].snapshot().tobytes():
                raise SystemExit(f"phase mesh_maint_parity ({layout}): tables differ after "
                                 f"{what}")
            calls.append(what)
            return a

        def epoch(e):
            ep, gids = e.ckpt.take()
            return (ep, gids) + tuple(e.checkpoint_finish(e.checkpoint_begin(gids, now)))

        def scan(e):
            s = finish_scan(e.telemetry_begin(now))
            return tuple(np.asarray(v) for v in dataclasses.astuple(
                dataclasses.replace(s, scan_ms=0.0)))

        now = NOW
        for step in range(steps):
            cols = _family_cols(rng, n, nb, pool, layout)
            both(lambda e: e.check_columns(cols, now_ms=now).status, f"check step {step}")
            now += int(rng.integers(500, 3_000))
        live, lslots = both(lambda e: e.extract_live(now), "extract_live")
        both(lambda e: e.extract_idle(now, 2_000, 1_000), "extract_idle")
        probe = np.concatenate([live[::5], rng.integers(1, 2**63 - 1, 100, dtype=np.int64)])
        both(lambda e: e.read_state(probe), "read_state")
        both(lambda e: e.read_state(probe, raw=True), "read_state raw")
        both(scan, "telemetry")
        both(epoch, "checkpoint epoch")
        m = n // 4
        algo = {"full": None, "gcra32": 2, "token32": 0}[layout]
        ikw = dict(fp=np.concatenate([live[:m // 2], rng.integers(1, 2**63 - 1, m - m // 2)]),
                   algo=(rng.integers(0, 5, m) if algo is None else np.full(m, algo))
                   .astype(np.int32), status=rng.integers(0, 2, m).astype(np.int32),
                   limit=rng.integers(1, 30, m).astype(np.int64),
                   remaining=rng.integers(0, 30, m).astype(np.int64),
                   reset_time=now + rng.integers(1, 10**6, m).astype(np.int64),
                   duration=np.full(m, 60_000, np.int64), now_ms=now)
        both(lambda e: e.install_columns(**ikw), "install_columns")
        take = rng.permutation(live.shape[0])[:m]
        mfp = rng.integers(1, 1 << 40, take.shape[0]) * nb + rng.integers(0, 64, take.shape[0])
        ms = lslots[take].copy()
        ms[:, 0] = (mfp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        ms[:, 1] = (mfp >> 32).astype(np.int32)
        both(lambda e: e.merge_rows(np.concatenate([mfp, mfp[:64]]),
                                    np.concatenate([ms, ms[:64]]), now_ms=now), "merge_rows")
        cms = lslots[:256].copy()
        cfp = rng.integers(1, 2**63 - 1, cms.shape[0], dtype=np.int64)
        cms[:, 0] = (cfp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        cms[:, 1] = (cfp >> 32).astype(np.int32)
        both(lambda e: e.merge_rows(cfp, cms, now_ms=now, collect=True), "merge_rows collect")
        idle, _ = both(lambda e: e.extract_idle(now, 2_000), "extract_idle, all")
        both(lambda e: e.tombstone_fps(np.concatenate([idle, probe[-10:]])), "tombstone_fps")
        both(epoch, "checkpoint epoch 2")
        if layout != "full":
            both(lambda e: e.install_columns(**dict(ikw, algo=np.full(m, 1, np.int32))),
                 "off-family install (migration)")
        sa, sb = (dataclasses.asdict(e.stats) for e in engines)
        if sa != sb:
            raise SystemExit(f"phase mesh_maint_parity ({layout}): stats differ: {sa} vs {sb}")
        info[layout] = {"calls": len(calls), "live": int(live.shape[0]),
                        "layout_after": engines[0].table.layout.name, "stats": sa}
        del engines
    emit(info)
    return info


# ------------------------------------------------- the decide loop (slice 6)


def _loop_stack(seed: int, eng, now: int, batch: int, n_batches: int):
    """`n_batches` token-bucket request batches of `batch` unique keys on the
    engine's device, stacked (ops/loop.stack_batches): seven eighths drawn
    from the live keys of the table, one eighth fresh; no key in two
    batches. Returns (stacked, active rows per batch)."""
    from gubernator_tpu_torch.ops.batch import ReqBatch
    from gubernator_tpu_torch.ops.loop import stack_batches
    from gubernator_tpu_torch.ops.table2 import decode_live_slots

    dev = eng.table.rows.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 31)
    _slots, held, _exp = decode_live_slots(eng.table.rows, now, eng.table.layout)
    del _slots, _exp
    n_held = batch - batch // 8
    pick = held[torch.randperm(held.shape[0], device=dev, generator=gen)[: n_held * n_batches]]
    rng = np.random.default_rng(seed + 31)
    fresh = np.unique(rng.integers(1, 2**63 - 1, (batch // 8) * n_batches + 4_096, dtype=np.int64))
    fresh = torch.from_numpy(rng.permutation(fresh)[: (batch // 8) * n_batches]).to(dev)
    full = lambda v, dt: torch.full((batch,), v, dtype=dt, device=dev)
    out = []
    for i in range(n_batches):
        fp = torch.cat([pick[i * n_held:(i + 1) * n_held],
                        fresh[i * (batch // 8):(i + 1) * (batch // 8)]])
        fp = fp[torch.randperm(batch, device=dev, generator=gen)]
        out.append(ReqBatch(
            fp=fp, algo=full(0, torch.int32), behavior=full(0, torch.int32),
            hits=full(1, torch.int64), limit=full(100, torch.int64), burst=full(100, torch.int64),
            duration=full(3_600_000, torch.int64), created_at=full(now, torch.int64),
            expire_new=full(now + 3_600_000, torch.int64), greg_interval=full(0, torch.int64),
            duration_eff=full(3_600_000, torch.int64), active=full(True, torch.bool)))
    return stack_batches(out), batch


def phase_loop(seed: int, eng, ref: dict, batch: int = 1 << 17, n_batches: int = 8,
               ks=(32, 544), k_equal: int = 16, reps: int = 3) -> dict:
    """The decide loop (ops/loop.decide_loop: one CUDA graph per stacked
    batch, replayed k times) on the engine's table: the graph held to the
    eager loop on a clone of the table (equal bytes and totals), then timed
    runs of ks[0] and ks[1] iterations, `reps` times each; the slope
    (bench_guard.slope) gives the time per iteration, gated by check_work
    (hits + misses == k · active rows) and check_dropped. Prints
    decisions/s beside `ref`'s host-timed pass."""
    from gubernator_tpu_torch import bench_guard
    from gubernator_tpu_torch.ops import loop
    from gubernator_tpu_torch.ops.table2 import Table2

    probe, write = eng.probe_mode, eng.write_mode
    now = NOW + 20_000
    stacked, active = _loop_stack(seed, eng, now, batch, n_batches)
    kw = dict(write=write, math="token", probe=probe)
    graphs = loop.LoopGraphs()
    launches0 = _launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = Table2(eng.table.rows.clone(), eng.table.layout)
    clone_s = time.perf_counter() - t0
    # the graph against the eager loop on the clone: same k, same start
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, acc_g = loop.decide_loop(eng.table, stacked, k_equal, graphs=graphs, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    captured = {k: v - launches0[k] for k, v in _launch_counts().items()}
    acc_e = torch.zeros(4, dtype=torch.int64, device=eng.device)
    for i in range(k_equal):
        loop._step(twin, loop._batch(stacked, i % n_batches), acc_e, write, "token", probe)
    torch.cuda.synchronize()
    equal = bool(torch.equal(acc_g, acc_e)) and bool(torch.equal(eng.table.rows, twin.rows))
    totals_equal = acc_g.tolist()
    del twin
    torch.cuda.empty_cache()
    if not equal:
        raise SystemExit(f"phase loop ({probe}): graph {acc_g.tolist()} != eager {acc_e.tolist()} "
                         "or the tables differ")
    # one replay profiled, and one eager dispatch, for kernels per decision
    _acc, replay_rows = _profile_rows(
        lambda: loop.decide_loop(eng.table, stacked, 1, graphs=graphs, **kw))
    _acc, eager_rows = _profile_rows(
        lambda: loop._step(eng.table, loop._batch(stacked, 0),
                           torch.zeros(4, dtype=torch.int64, device=eng.device), write, "token",
                           probe))
    runs = {k: [] for k in ks}
    refusals = []
    for _ in range(reps):
        for k in ks:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            _, acc = loop.decide_loop(eng.table, stacked, k, graphs=graphs, **kw)
            e1.record()
            tot = acc.tolist()  # the fetch ends the timed run
            host_s = time.perf_counter() - t0
            runs[k].append({"host_s": host_s, "device_ms": e0.elapsed_time(e1), "acc": tot})
            for why in (bench_guard.check_work(tot[0] + tot[1], k * active, label=f"k={k}"),
                        bench_guard.check_dropped(tot[3], k * active, label=f"k={k}")):
                if why:
                    refusals.append(why)
    t_short = min(r["host_s"] for r in runs[ks[0]])
    t_long = min(r["host_s"] for r in runs[ks[1]])
    sl = bench_guard.slope(t_short, t_long, ks[0], ks[1], active)
    dev_per_iter = statistics.median(r["device_ms"] for r in runs[ks[1]]) / ks[1]
    info = {
        "phase": "loop", "probe": probe, "write": write, "card": torch.cuda.get_device_name(0),
        "capacity": eng.table.capacity, "batch": batch, "batches": n_batches,
        "ks": list(ks), "reps": reps, "graph_equals_eager": equal, "k_equal": k_equal,
        "totals_k_equal": totals_equal, "clone_s": clone_s, "first_call_s": first_s,
        "captures": graphs.captures, "captured_launches": captured,
        "kernels_per_replay": sum(r[1] for r in replay_rows),
        "replay_device_ms": sum(r[2] for r in replay_rows) / 1e3,
        "kernels_per_eager_dispatch": sum(r[1] for r in eager_rows),
        "eager_dispatch_device_ms": sum(r[2] for r in eager_rows) / 1e3,
        "slope": sl._asdict(), "device_ms_per_iter": dev_per_iter,
        "device_decisions_per_s": batch / (dev_per_iter / 1e3),
        "host_pass_decisions_per_s": ref["steady_decisions_per_s"],
        "host_pass_kernels": ref["pass_kernels"],
        "runs": {str(k): v for k, v in runs.items()}, "refusals": refusals,
    }
    emit(info)
    graphs.clear()
    if refusals:
        raise SystemExit(f"phase loop ({probe}): {refusals[0]}")
    if sl.rate is None:
        raise SystemExit(f"phase loop ({probe}): slope refused: {sl.reason}")
    return info


# ------------------------------------------------ maintenance (slice 6)


def _timed(times: dict, name: str, fn, scan_bytes: int = 0):
    """Run fn once: its host time (to a synchronise) and the CUDA-event span
    around it, and for a whole-table scan the byte bound (one read of
    `scan_bytes` at the card's memory rate)."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    times[name] = {"host_ms": (time.perf_counter() - t0) * 1e3, "device_ms": e0.elapsed_time(e1)}
    if scan_bytes:
        times[name]["bound_ms"] = scan_bytes / HBM_BYTES_PER_S * 1e3
    return out


def _host_read_state(snap: np.ndarray, fps: np.ndarray, lay):
    """Numpy oracle of read_state: (found, canonical slots, raw slots) —
    the first lane of the key's bucket holding its fingerprint."""
    nb = snap.shape[0]
    n = fps.shape[0]
    rows = snap[fps % nb].reshape(n, 8, lay.F)
    my_lo = (fps & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    my_hi = (fps >> 32).astype(np.int32)
    lo, hi = rows[:, :, 0], rows[:, :, 1]
    match = (lo == my_lo[:, None]) & (hi == my_hi[:, None]) & ((lo != 0) | (hi != 0))
    found = match.any(axis=1)
    sel = rows[np.arange(n), match.argmax(axis=1)]
    full = np.where(found[:, None], lay.unpack(sel), 0).astype(np.int32)
    return found, full, lay.pack(full)


def _host_live(rows: np.ndarray, now: int, lay):
    """Numpy oracle of the live filter, in table order: (flat slot index,
    fp, slots) of the live slots of `rows`."""
    slots = rows.reshape(-1, lay.F)
    fp = (slots[:, 1].astype(np.int64) << 32) | (slots[:, 0].astype(np.int64) & 0xFFFFFFFF)
    exp = (slots[:, lay.exp_hi_i].astype(np.int64) << 32) | (
        slots[:, lay.exp_lo_i].astype(np.int64) & 0xFFFFFFFF)
    idx = np.flatnonzero((fp != 0) & (exp >= now))
    return idx, fp[idx], slots[idx]


def phase_maint(seed: int, eng, batch: int = 1 << 17, idle_cap: int = 1 << 16) -> dict:
    """The maintenance surface on the headline engine (10M keys, 1 GiB),
    each call held to a numpy oracle on a snapshot: the telemetry scan
    (host_telemetry), extract_live (the live slots in table order; count =
    live_count), read_state of `batch` keys (and raw), a checkpoint epoch
    (a tracker attached, one check pass, take, checkpoint_begin / finish
    against the dirty blocks cut from the snapshot), the idle sweep
    (extract_idle, then tombstone_fps: the snapshot bytes after it), and
    last maybe_grow to 2^25 slots against rehash_rows on the host. Host
    time, event span and, for the scans, the byte bound of each."""
    from gubernator_tpu_torch.ops.checkpoint import EpochTracker
    from gubernator_tpu_torch.ops.table2 import K, n_buckets_for, rehash_rows
    from gubernator_tpu_torch.ops.telemetry import finish_scan, host_telemetry

    lay = eng.table.layout
    nb = eng.table.n_buckets
    tbytes = eng.table.rows.numel() * 4
    now = NOW + 30_000
    rng = np.random.default_rng(seed + 41)
    times, checks = {}, {}
    snap = _timed(times, "snapshot", eng.snapshot)

    tele = _timed(times, "telemetry", lambda: finish_scan(eng.telemetry_begin(now)), tbytes)
    t0 = time.perf_counter()
    want = host_telemetry(snap, now, layout=lay)
    times["telemetry"]["oracle_host_ms"] = (time.perf_counter() - t0) * 1e3
    checks["telemetry"] = dataclasses.replace(tele, scan_ms=0.0) == want
    live_n = _timed(times, "live_count", lambda: eng.live_count(now), tbytes)

    fps, slots = _timed(times, "extract_live", lambda: eng.extract_live(now), tbytes)
    idx, hfp, hslots = _host_live(snap, now, lay)
    checks["extract_live"] = (np.array_equal(fps, hfp) and np.array_equal(slots, hslots)
                              and fps.shape[0] == live_n == tele.live_keys)
    del slots, hslots, idx

    probe = np.concatenate([rng.choice(hfp, batch // 2, replace=False),
                            rng.integers(1, 2**63 - 1, batch // 2, dtype=np.int64)])
    found, full = _timed(times, "read_state", lambda: eng.read_state(probe))
    _f, raw = _timed(times, "read_state_raw", lambda: eng.read_state(probe, raw=True))
    w_found, w_full, w_raw = _host_read_state(snap, probe, lay)
    checks["read_state"] = (np.array_equal(found, w_found) and np.array_equal(full, w_full)
                            and np.array_equal(raw, w_raw) and int(found.sum()) >= batch // 2)
    del full, raw, w_full, w_raw

    # the bus: a 1 GiB device-to-host copy into pageable and into pinned
    # memory (every fetch above crosses it)
    pinned = torch.empty(eng.table.rows.shape, dtype=torch.int32,
                         pin_memory=eng.table.rows.is_cuda)
    _timed(times, "d2h_1gib_pageable", lambda: eng.table.rows.cpu())
    _timed(times, "d2h_1gib_pinned", lambda: pinned.copy_(eng.table.rows))
    del pinned

    # a checkpoint epoch over one check pass (and the same kind of pass
    # before the tracker is attached, for its host time)
    def pass_fps():
        return np.concatenate([rng.choice(hfp, batch - batch // 8, replace=False),
                               rng.integers(1, 2**63 - 1, batch // 8, dtype=np.int64)])

    plain_fp = pass_fps()
    _timed(times, "check_pass", lambda: eng.check_columns(_token_cols(plain_fp), now_ms=now))
    eng.ckpt = EpochTracker(nb)
    pass_fp = pass_fps()
    _timed(times, "check_pass_marked", lambda: eng.check_columns(_token_cols(pass_fp),
                                                                 now_ms=now))
    epoch, gids = eng.ckpt.take()
    cfp, cslots = _timed(times, "checkpoint_extract",
                         lambda: eng.checkpoint_finish(eng.checkpoint_begin(gids, now)))
    snap = eng.snapshot()
    blk = eng.ckpt.blk
    _i, bfp, bslots = _host_live(snap[(gids[:, None] * blk + np.arange(blk)).reshape(-1)], now, lay)
    checks["checkpoint"] = (np.array_equal(gids, np.unique(pass_fp % nb // blk))
                            and np.array_equal(cfp, bfp) and np.array_equal(cslots, bslots))
    ck = {"epoch": epoch, "dirty_blocks": int(gids.shape[0]), "rows": int(cfp.shape[0])}
    del cslots, bslots

    # the idle sweep: extract the rows idle past the horizon, tombstone them
    idle_ms, cap = 25_000, idle_cap
    ifp, islots = _timed(times, "extract_idle", lambda: eng.extract_idle(now, idle_ms, cap),
                         tbytes)
    idx, hfp, hslots = _host_live(snap, now, lay)
    idle = (now - lay.idle_ref(hslots)) >= idle_ms
    sel = idx[idle][:cap]
    checks["extract_idle"] = (np.array_equal(ifp, hfp[idle][:cap])
                              and np.array_equal(islots, hslots[idle][:cap]) and sel.size == cap)
    gone = _timed(times, "tombstone", lambda: eng.tombstone_fps(ifp))
    expect = snap.copy()
    expect.reshape(-1, lay.F)[sel] = 0
    snap = eng.snapshot()
    checks["tombstone"] = gone == sel.size and snap.tobytes() == expect.tobytes()
    del expect, idx, hfp, hslots, islots

    # growth, last: maybe_grow past 0.4 load doubles the table (to 2^25 slots)
    ev0 = eng.stats.evicted_unexpired
    grown = _timed(times, "maybe_grow", lambda: eng.maybe_grow(threshold=0.4, now_ms=now))
    t0 = time.perf_counter()
    want_rows, want_drop = rehash_rows(snap, n_buckets_for(2 * nb * K), now, layout=lay)
    times["maybe_grow"]["oracle_host_ms"] = (time.perf_counter() - t0) * 1e3
    checks["maybe_grow"] = (grown and eng.table.capacity == n_buckets_for(2 * nb * K) * K
                            and eng.stats.evicted_unexpired - ev0 == want_drop
                            and eng.snapshot().tobytes() == want_rows.tobytes()
                            and eng.ckpt.dirty_blocks == eng.table.n_buckets
                            and eng.maybe_grow(now_ms=now) is False)
    del want_rows, snap
    info = {
        "phase": "maint", "card": torch.cuda.get_device_name(0), "layout": lay.name,
        "capacity_before": nb * K, "capacity_after": eng.table.capacity, "table_bytes": tbytes,
        "live": live_n, "read_state_rows": batch, "checkpoint": ck, "idle_rows": int(gone),
        "rehash_dropped": int(want_drop), "times": times, "checks": checks,
        "hbm_bytes_per_decision": eng.hbm_bytes_per_decision_estimate(),
    }
    emit(info)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"phase maint: {bad} disagree with their numpy oracles")
    return info


def _family_cols(rng, n: int, nb: int, pool: np.ndarray, layout: str):
    """Contended rows for a table of `layout`: the mixed rows on the full
    layout, single-algorithm rows (GCRA or token bucket, no Gregorian row
    for token32) on the packed ones."""
    cols = _mixed_cols_all(rng, n, nb, pool)
    if layout == "full":
        return cols
    algo = 2 if layout == "gcra32" else 0
    greg = (cols.behavior & 4) != 0
    return cols._replace(
        algo=np.full(n, algo, np.int32), behavior=cols.behavior & ~np.int32(4),
        duration=np.where(greg, 2_000, cols.duration))


def phase_maint_parity(seed: int, device: str = "cuda", capacity: int = 1 << 20,
                       n: int = 4096, steps: int = 4) -> dict:
    """The same maintenance calls on a card engine and a CPU engine, each
    with an epoch tracker, after contended mixed traffic, for the three
    slot layouts: extract_live, extract_idle, read_state (and raw), the
    telemetry scan, a checkpoint epoch, merge_rows of re-keyed live rows,
    tombstone_fps, resize and maybe_grow. Every output, the stats and the
    snapshot bytes equal."""
    from gubernator_tpu_torch.ops.checkpoint import EpochTracker
    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.ops.telemetry import finish_scan

    info = {"phase": "maint_parity", "capacity": capacity, "equal": True}
    for layout in ("full", "gcra32", "token32"):
        rng = np.random.default_rng(seed + 51)
        engines = [LocalEngine(capacity=capacity, device=d, layout=layout) for d in (device, "cpu")]
        for e in engines:
            e.ckpt = EpochTracker(e.table.n_buckets)
        nb = engines[0].table.n_buckets
        pool = rng.integers(1, 2**63 - 1, 20_000, dtype=np.int64)
        calls = []

        def both(fn, what):
            a, b = fn(engines[0]), fn(engines[1])
            if not _same(a, b):
                raise SystemExit(f"phase maint_parity ({layout}): card and CPU disagree on {what}")
            if engines[0].snapshot().tobytes() != engines[1].snapshot().tobytes():
                raise SystemExit(f"phase maint_parity ({layout}): tables differ after {what}")
            calls.append(what)
            return a

        def epoch(e):
            ep, gids = e.ckpt.take()
            return (ep, gids) + tuple(e.checkpoint_finish(e.checkpoint_begin(gids, now)))

        def scan(e):
            s = finish_scan(e.telemetry_begin(now))
            return tuple(np.asarray(v) for v in dataclasses.astuple(
                dataclasses.replace(s, scan_ms=0.0, per_shard_live=None)))

        now = NOW
        for step in range(steps):
            cols = _family_cols(rng, n, nb, pool, layout)
            both(lambda e: e.check_columns(cols, now_ms=now).status, f"check step {step}")
            now += int(rng.integers(500, 3_000))
        live, lslots = both(lambda e: e.extract_live(now), "extract_live")
        both(lambda e: e.extract_idle(now, 2_000, 1_000), "extract_idle")
        probe = np.concatenate([live[::5], rng.integers(1, 2**63 - 1, 100, dtype=np.int64)])
        both(lambda e: e.read_state(probe), "read_state")
        both(lambda e: e.read_state(probe, raw=True), "read_state raw")
        both(scan, "telemetry")
        both(epoch, "checkpoint epoch")
        take = rng.permutation(live.shape[0])[:n // 4]
        mfp = rng.integers(1, 1 << 40, take.shape[0]) * nb + rng.integers(0, 64, take.shape[0])
        ms = lslots[take].copy()
        ms[:, 0] = (mfp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        ms[:, 1] = (mfp >> 32).astype(np.int32)
        both(lambda e: e.merge_rows(mfp, ms, now_ms=now), "merge_rows")
        idle, _ = both(lambda e: e.extract_idle(now, 2_000), "extract_idle, all")
        both(lambda e: e.tombstone_fps(np.concatenate([idle, probe[-10:]])), "tombstone_fps")
        both(epoch, "checkpoint epoch 2")
        both(lambda e: e.resize(capacity // 8, now), "resize down")
        both(lambda e: e.maybe_grow(threshold=0.3, now_ms=now), "maybe_grow")
        both(lambda e: e.resize(capacity * 2, now), "resize up")
        both(epoch, "checkpoint epoch after resize")
        sa, sb = (dataclasses.asdict(e.stats) for e in engines)
        if sa != sb:
            raise SystemExit(f"phase maint_parity ({layout}): stats differ: {sa} vs {sb}")
        info[layout] = {"calls": len(calls), "live": int(live.shape[0]),
                        "capacity_after": engines[0].table.capacity, "stats": sa}
        del engines
    emit(info)
    return info


def _tables_equal(got: torch.Tensor, want: torch.Tensor):
    """(byte-equal, max |difference| as int64)."""
    if bool(torch.equal(got, want)):
        return True, 0
    d = got != want
    return False, int((got[d].to(torch.int64) - want[d].to(torch.int64)).abs().max())


def _sweep_case(kernel: str, case: str, run_kernel, run_plain, got, want, nbytes: int,
                launches: int, library=None, library_call=None, variants=None,
                **extra) -> dict:
    """One sweep kernel against its plain version on the card: both run,
    the tables must be byte-equal; then the device times (``queued_ms``)
    of the kernel, the plain version, the library yardstick and each other
    design of the same kernel in `variants` (name -> call, timed in the
    same run, reported as ``<name>_ms``), and the kernel's time per call
    when the host paces the launches."""
    run_kernel()
    run_plain()
    torch.cuda.synchronize()
    equal, err = _tables_equal(got, want)
    calls = {"kernel": run_kernel, "plain": run_plain}
    if library is not None:
        calls["library"] = library
    calls.update(variants or {})
    dev_ms = {k: queued_ms(f, calls=10 if k == "plain" else 20) for k, f in calls.items()}
    res = {
        "case": case, "equal": equal, "max_abs_err": err, "launches": launches,
        "kernel_ms": dev_ms["kernel"], "call_ms": cuda_ms(run_kernel, reps=5, inner=5),
        "plain_ms": dev_ms["plain"], "library_ms": dev_ms.get("library"),
        "library_call": library_call, "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        **{f"{k}_ms": dev_ms[k] for k in variants or {}}, **extra,
    }
    if library is not None:
        res["kernel_over_library"] = dev_ms["kernel"] / dev_ms["library"]
    emit({"phase": "kernel", "name": kernel, **res})
    if not equal:
        raise SystemExit(f"{kernel} disagrees with its plain version ({case})")
    return res


def _replaced_design(kernel: str, entry: str, argtypes: list):
    """The C entry `entry` in csrc/<kernel>.cu: the design the kernel's
    wrapper replaced, kept there so that one run times the two side by
    side. Called with the C entry's arguments, tensors for its pointers
    and the stream of the first tensor last; no launch count: it is timed
    beside the kernel, not on a path."""
    from gubernator_tpu_torch import _build

    fn = getattr(_build.load(kernel), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int

    def call(*args):
        stream = _stream(next(a for a in args if isinstance(a, torch.Tensor)))
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return call


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def phase_sweeps(seed: int, device: str = "cuda", nb: int = 1 << 21,
                 c5_nb: int = 1 << 24, entry_kw=None) -> dict:
    """Slice 4: the exp/ sweep probes. First the slice's main path — the
    four entry points (exp_sweep2, exp_sweep4, exp_sweep5 with its default
    cases, exp_mem2) at their own geometry — with every sweep kernel's
    count zeroed just before and read just after; then each kernel against
    its plain version at the scripts' headline geometry (byte-equal
    tables), with times, byte bounds and library yardsticks."""
    from gubernator_tpu_torch.exp import exp_mem2, exp_sweep2, exp_sweep4, exp_sweep5, sweeps
    from gubernator_tpu_torch.exp._timing import generator, randint32
    from gubernator_tpu_torch.ops import kernel2 as k2
    from gubernator_tpu_torch.ops.table2 import new_table2

    dev = torch.device(device)
    kw = {"reps": 3, "inner": 3, **(entry_kw or {})}
    wrappers = sweeps.kernels()
    for fn in wrappers.values():
        fn.launches = 0  # counts from here on are the main path's
    t0 = time.perf_counter()
    runs = {
        "exp_sweep2": exp_sweep2.run(seed, dev, **kw.get("exp_sweep2", {}),
                                     reps=kw["reps"], inner=kw["inner"]),
        "exp_sweep4": exp_sweep4.run(seed, dev, **kw.get("exp_sweep4", {}),
                                     reps=kw["reps"], inner=kw["inner"]),
        "exp_sweep5": exp_sweep5.run(seed, exp_sweep5.DEFAULT_CASES, dev,
                                     **kw.get("exp_sweep5", {}),
                                     reps=kw["reps"], inner=kw["inner"]),
        "exp_mem2": exp_mem2.run(seed, dev, **kw.get("exp_mem2", {}),
                                 reps=kw["reps"], inner=kw["inner"]),
    }
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    main_s = time.perf_counter() - t0
    emit({"phase": "sweeps_main", "seconds": main_s, "launches": launches, "runs": runs})
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise SystemExit(f"phase sweeps: the entry points launched no {idle}")
    torch.cuda.empty_cache()

    gen = generator(dev, seed + 4)
    out = {}
    i64 = torch.int64
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    # A: the whole-table stream, out of place and in place; beside the bulk
    # stream, the grid-stride design it replaced, timed in the same run
    src = randint32(gen, (nb, 128), dev)
    tb = src.numel() * 4
    copy_grid = _replaced_design("sweep_copy", "guber_sweep_copy_grid", [P, P, L, P])
    grid = lambda a, b: copy_grid(a, b, a.numel() // 4)
    dk, dp, dg = torch.zeros_like(src), torch.zeros_like(src), torch.zeros_like(src)
    grid(src, dg)
    torch.cuda.synchronize()
    if not torch.equal(dg, src):
        raise SystemExit("sweep_copy's grid-stride design disagrees with its plain version")
    out["sweep_copy"] = [_sweep_case(
        "sweep_copy", f"out of place, {tb / 2**30:g} GiB", lambda: sweeps.sweep_copy(src, dk),
        lambda: sweeps.sweep_copy_ref(src, dp), dk, dp, 2 * tb, launches["sweep_copy"],
        library=lambda: dp.copy_(src), library_call="dst.copy_(src)",
        variants={"grid_stride": lambda: grid(src, dg)})]
    del dk, dp, dg
    tk_, tp = src.clone(), src.clone()
    out["sweep_copy"].append(_sweep_case(
        "sweep_copy", f"in place, {tb / 2**30:g} GiB", lambda: sweeps.sweep_copy(tk_, tk_),
        lambda: sweeps.sweep_copy_ref(tp, tp), tk_, tp, 2 * tb, launches["sweep_copy"],
        variants={"grid_stride": lambda: grid(tk_, tk_)}))
    if not torch.equal(tk_, src):
        raise SystemExit("sweep_copy in place changed the table")
    del tk_, tp
    torch.cuda.empty_cache()

    # B: full-row updates with int8 lane masks, signed bytes; beside the
    # kernel, the copy-then-compose design it replaced, timed in the same run
    table = src
    rows_ctc = _replaced_design("sweep_rows", "guber_sweep_rows_copy_then_compose",
                                [P, P, P, P, P, I, I, I, I, P])
    out["sweep_rows"] = []
    for u, inplace in ((64, False), (128, False), (64, True)):
        n = nb // 2048 * u
        rows = randint32(gen, (n, 128), dev)
        mask = torch.randint(-2, 3, (n, 128), dtype=torch.int8, device=dev, generator=gen)
        bkt = torch.randint(-1, 2048, (n,), dtype=torch.int32, device=dev, generator=gen)
        valid, uniq, inv = sweeps.row_groups(bkt, u, 2048)
        w = torch.zeros((uniq.shape[0], 128), dtype=i64, device=dev).index_add_(
            0, inv, mask[valid].to(i64))
        lanes = int((w > 0).sum())
        n_valid = int(valid.sum())
        if inplace:
            got, want = table.clone(), table.clone()
            run_k = lambda: sweeps.sweep_rows(got, rows, mask, bkt, u)
            run_p = lambda: sweeps.sweep_rows_ref(want, rows, mask, bkt, u)
            nbytes = n * 4 + n_valid * (512 + 128) + lanes * 4
        else:
            got, want = torch.empty_like(table), torch.empty_like(table)
            run_k = lambda: sweeps.sweep_rows(table, rows, mask, bkt, u, out=got)
            run_p = lambda: sweeps.sweep_rows_ref(table, rows, mask, bkt, u, out=want)
            nbytes = 2 * tb + n * 4 + n_valid * (512 + 128)
        run_p()
        composed = want[uniq].contiguous()
        old = table.clone() if inplace else torch.empty_like(table)
        run_old = lambda: rows_ctc(old if inplace else table, old, rows, mask, bkt,
                                   nb // 2048, u, 2048, int(not inplace))
        run_old()
        torch.cuda.synchronize()
        if not torch.equal(old, want):
            raise SystemExit("sweep_rows' copy-then-compose design disagrees with its plain "
                             "version")
        if inplace:
            lib = lambda: want.index_copy_(0, uniq, composed)
            lib_call = "table.index_copy_(0, touched rows, composed rows)"
        else:
            lib = lambda: want.copy_(table).index_copy_(0, uniq, composed)
            lib_call = "out.copy_(table).index_copy_(0, touched rows, composed rows)"
        out["sweep_rows"].append(_sweep_case(
            "sweep_rows", f"U={u}, {'in place' if inplace else 'out of place'}", run_k, run_p,
            got, want, nbytes, launches["sweep_rows"], library=lib,
            library_call=lib_call + " — the copy alone: colliding entries have no one call",
            variants={"copy_then_compose": run_old},
            entries=n, valid=n_valid, rows_touched=int(uniq.shape[0]), lanes_written=lanes))
        del got, want, old, rows, mask, bkt, composed
        torch.cuda.empty_cache()
    del table, src
    torch.cuda.empty_cache()

    # C: exp_sweep2's slot compose, both planes, on the script's windows and
    # on the same windows sorted by target, as a caller that sorts its
    # updates hands them over; beside the kernel, the link design it
    # replaced, timed in the same run
    slots_link = _replaced_design("sweep_slots", "guber_sweep_slots_link",
                                  [P, P, P, P, I, I, I, I, P])
    rows, wnew, wslot, wlb = exp_sweep2.make_data(gen, dev, nb)
    U, BLK = exp_sweep2.U, exp_sweep2.BLK
    n = wnew.shape[0]
    out["sweep_slots"] = []
    for data in ("exp_sweep2 data", "exp_sweep2 data sorted by target"):
        if data != "exp_sweep2 data":
            wnew, wslot, wlb = exp_sweep2.sort_windows(wnew, wslot, wlb, U, BLK)
        valid, uniq, _ = sweeps.slot_groups(wslot.reshape(-1), wlb.reshape(-1), U, BLK)
        n_valid = int(valid.sum())
        nbytes = n * 8 + n_valid * 64 + int(uniq.shape[0]) * 64
        for planes in (8, 16):
            got, want, old = rows.clone(), rows.clone(), rows.clone()
            run_p = lambda: sweeps.sweep_slots_ref(want, wnew, wslot, wlb, U, planes)
            run_p()
            run_old = lambda: slots_link(old, wnew, wslot, wlb, n // U, U, BLK, planes)
            run_old()
            torch.cuda.synchronize()
            if not torch.equal(old, want):
                raise SystemExit(f"sweep_slots' link design disagrees with its plain version "
                                 f"({data}, planes={planes})")
            composed = want.view(-1, 16)[uniq].contiguous()
            out["sweep_slots"].append(_sweep_case(
                "sweep_slots", f"{data}, planes={planes}",
                lambda: sweeps.sweep_slots(got, wnew, wslot, wlb, U, planes), run_p,
                got, want, nbytes, launches["sweep_slots"],
                library=lambda: want.view(-1, 16).index_copy_(0, uniq, composed),
                library_call="table.view(-1, 16).index_copy_(0, targets, composed slots) — "
                             "the copy alone: colliding targets have no one call",
                variants={"link": run_old}, entries=n, valid=n_valid,
                slots_written=int(uniq.shape[0]), dense_sweep_bytes=2 * rows.numel() * 4))
            del got, want, old, composed
    del rows, wnew, wslot, wlb
    torch.cuda.empty_cache()

    # D: the windowed sweep on zero tables — exp_sweep4's claim-routed
    # write at every geometry its entry point launches (the small check's,
    # then each headline blk; at blk 8192 a block's run outgrows its two
    # windows and entries drop), then the exp_sweep5 cases (the last on the
    # 8 GiB c5 table)
    cases = []
    cap, batch = exp_sweep4.HEADLINE
    scale = nb / (cap // 8)
    geoms = [(exp_sweep4.SMALL, None)] + [((int(cap * scale), int(batch * scale)), blk)
                                          for blk in exp_sweep4.BLKS]
    for (cap_g, batch_g), blk in geoms:
        tbl = new_table2(cap_g, device=dev)
        NB = tbl.n_buckets
        blk, u = k2.sweep_geometry(NB, batch_g) if blk is None else (blk, exp_sweep4.U)
        if NB % blk:
            continue
        fps = torch.randint(1, 2**63 - 1, (batch_g,), dtype=i64, device=dev, generator=gen)
        fps[:100] = fps[0].clone()  # duplicates, as the entry point's small check
        b = exp_sweep4.mk_batch(fps, exp_sweep4.NOW)
        c = k2._probe_claim2(tbl.rows, b.fp, b.created_at, b.active, blk, u)
        new16 = randint32(gen, (batch_g, 16), dev)
        pay_s, tgt_eff, s_blk = exp_sweep4.sweep_inputs(NB, batch_g, blk, u, new16, c)
        cases.append((f"exp_sweep4 claim-routed, NB {NB}, blk {blk}, u {u}", NB,
                      (pay_s, tgt_eff, s_blk, None, blk, u, False, False)))
        del tbl, b, c, fps, new16
    for name in ("base", "skip2-2048-256", "all-1024-128", "c5-all-1024-128"):
        NB, B, blk, u, marker, skip2 = exp_sweep5.MATRIX[name]
        scale = (nb if NB == exp_sweep5.NB else c5_nb) / NB
        NB, B = int(NB * scale), int(B * scale)
        tgt, pay = exp_sweep5.case_data(gen, dev, NB, B, marker)
        s_blk5, need2 = exp_sweep5.window_starts(tgt, NB, blk, u)
        cases.append((f"exp_sweep5 {name}", NB,
                      (pay, tgt, s_blk5, need2, blk, u, marker, skip2)))
    window_link = _replaced_design("sweep_window", "guber_sweep_window_link",
                                   [P, P, P, P, P, I, I, I, I, I, I, P])
    out["sweep_window"] = []
    for name, NB, args in cases:
        pay, tgt, sb, n2, blk, u, marker, skip2 = args
        got = torch.zeros((NB, 128), dtype=torch.int32, device=dev)
        want = torch.zeros_like(got)
        old = torch.zeros_like(got)
        run_p = lambda: sweeps.sweep_window_ref(want, *args)
        run_p()
        run_old = lambda: window_link(old, pay, tgt, sb, n2 if skip2 else None, NB // blk,
                                      blk, u, tgt.numel() // u, int(marker), int(skip2))
        run_old()
        torch.cuda.synchronize()
        if not torch.equal(old, want):
            raise SystemExit(f"sweep_window's link design disagrees with its plain version "
                             f"({name})")
        halves = sweeps.window_live(tgt, sb, n2, NB // blk, blk, u, skip2)
        ents = torch.cat([e for _t, e in halves])
        uniq = torch.unique(torch.cat([t for t, _e in halves]))
        # live entries no window of their block composes (the TPU drops them)
        dropped = int((tgt < NB * 8).sum()) - int(torch.unique(ents).numel())
        composed = want.view(-1, 16)[uniq].contiguous()
        nbytes = tgt.numel() * 4 + sb.numel() * 4 * (2 if skip2 else 1) \
            + int(ents.shape[0]) * 64 + int(uniq.shape[0]) * 64
        out["sweep_window"].append(_sweep_case(
            "sweep_window", name, lambda: sweeps.sweep_window(got, *args), run_p, got, want,
            nbytes, launches["sweep_window"],
            library=lambda: want.view(-1, 16).index_copy_(0, uniq, composed),
            library_call="table.view(-1, 16).index_copy_(0, targets, composed slots) — "
                         "the copy alone",
            variants={"link": run_old}, table_bytes=NB * 512, batch=tgt.numel(), blk=blk,
            u=u, marker=marker, skip2=skip2, composed_entries=int(ents.shape[0]),
            dropped_entries=dropped, slots_written=int(uniq.shape[0])))
        del got, want, old, composed, ents, halves, uniq
        torch.cuda.empty_cache()
    del cases, args, pay, tgt, sb, n2
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["main_s"] = main_s
    return out


# ------------------------------------------------------------ hot-set tiering

TIER_LIMIT = 12
TIER_DAY_MS = 86_400_000


def _tier_cols(fp: np.ndarray, t: int, hits: int, limit: int = TIER_LIMIT):
    """Token-bucket rows of the tiering deployment (``bench.py``
    ``tiering_case``): limit 12, a one-day window, stamped `t`."""
    from gubernator_tpu_torch.ops.batch import RequestColumns

    n = fp.shape[0]
    return RequestColumns(
        fp=np.ascontiguousarray(fp, np.int64), algo=np.zeros(n, np.int32),
        behavior=np.zeros(n, np.int32), hits=np.full(n, hits, np.int64),
        limit=np.full(n, limit, np.int64), burst=np.zeros(n, np.int64),
        duration=np.full(n, TIER_DAY_MS, np.int64), created_at=np.full(n, t, np.int64),
        err=np.zeros(n, np.int8))


def _rss_mib() -> float:
    """Resident set size of this process now (MiB), from /proc."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
    return float("nan")


def _timed_method(obj, name: str, acc: dict) -> None:
    """Wrap obj.<name> so that its calls add their host seconds and count
    to acc[name] (an instance attribute shadows the bound method)."""
    fn = getattr(obj, name)
    acc[name] = {"s": 0.0, "calls": 0}

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[name]["s"] += time.perf_counter() - t0
            acc[name]["calls"] += 1

    setattr(obj, name, timed)


def phase_tier(seed: int, device: str = "cuda", capacity: int = 1 << 23,
               batch: int = 1 << 16, sample_n: int = 4096, hot_batches: int = 12) -> dict:
    """The JAX package's tiering deployment (``bench.py`` ``tiering_case``,
    "capacity past the HBM wall") at its TPU geometry: a 2^23-slot table
    (``probe="pallas"``, ``walk="pallas"``: the decide with its evictee
    sidecar and the promote merge run probe_walk) with a host shadow of
    4x capacity rows, 4 x 2^23 tracked keys driven in 2^16-row batches of 3
    hits (limit 12, one day). The curve at 1x, 2x and 4x tracked/capacity;
    a 4,096-key sample drained to its limit (zero over-grant); the state
    identity live + shadow rows == keys answered; the probe_walk decide and
    merge with evictees timed at this geometry; then the hot-set rate on
    Zipf(1.05) batches, tiered against an engine with no shadow,
    interleaved, best of 3."""
    import resource

    from gubernator_tpu_torch.ops.batch import ReqBatch
    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.tier import ROW_BYTES, ShadowTable

    wall0 = time.perf_counter()
    rss0 = _rss_mib()
    rng = np.random.default_rng(seed + 121)
    eng = LocalEngine(capacity=capacity, device=device, probe="pallas", walk="pallas")
    cap = eng.table.capacity
    keys = np.unique(rng.integers(1, 1 << 62, size=4 * cap, dtype=np.int64))
    tracked = keys.shape[0]
    shadow = ShadowTable(max_bytes=tracked * ROW_BYTES)
    eng.attach_shadow(shadow)
    host = {}
    _timed_method(eng, "_harvest_evictees", host)
    _timed_method(shadow, "take", host)
    consumed = np.zeros(tracked, np.int64)
    answered = np.zeros(tracked, bool)
    t = NOW
    curve = []
    pass_s = []
    _zero_launch_counts()
    for mult in (1, 2, 4):
        hi = min(tracked, mult * cap)
        lo = 0 if mult == 1 else min(tracked, (mult // 2) * cap)
        for i in range(lo, hi, batch):
            w = keys[i:i + batch]
            t0 = time.perf_counter()
            rc = eng.check_columns(_tier_cols(w, t, 3), now_ms=t)
            pass_s.append(time.perf_counter() - t0)
            ok = (rc.status == 0) & (rc.err == 0)
            consumed[i:i + batch][ok] += 3
            answered[i:i + batch] |= rc.err == 0
            t += 7
        st = shadow.stats()
        live = eng.live_count(t)
        curve.append({"tracked_keys": hi, "tracked_x_capacity": hi / cap, "live": live,
                      "shadow_ram_rows": st["ram_rows"], "demoted_evict": st["demoted_evict"],
                      "promoted": st["promoted"], "answered": int(answered[:hi].sum()),
                      "identity": live + st["ram_rows"] == int(answered[:hi].sum())})
        emit({"phase": "tier_curve", **curve[-1]})
    # zero over-grant: drain each sampled key to its limit
    sample = rng.permutation(tracked)[:sample_n]
    for i in range(0, sample_n, batch):
        si = sample[i:i + batch]
        rc = eng.check_columns(_tier_cols(keys[si], t, TIER_LIMIT), now_ms=t)
        ok = (rc.status == 0) & (rc.err == 0)
        consumed[si[ok]] += TIER_LIMIT
        answered[si] |= rc.err == 0
        t += 7
    torch.cuda.synchronize()
    launches = _launch_counts()
    over = int((consumed[sample] > TIER_LIMIT).sum())
    st = shadow.stats()
    live = eng.live_count(t)
    n_answered = int(answered.sum())
    dispatches = host["_harvest_evictees"]["calls"]
    info = {
        "phase": "tier", "card": torch.cuda.get_device_name(0), "capacity_slots": cap,
        "table_bytes": int(eng.table.rows.numel() * 4), "tracked_keys": int(tracked),
        "batch": batch, "batches": len(pass_s), "curve": curve,
        "sample_keys": sample_n, "over_granted_sample_keys": over,
        "live": live, "shadow_ram_rows": st["ram_rows"], "answered_keys": n_answered,
        "identity_live_plus_shadow_eq_answered": live + st["ram_rows"] == n_answered,
        "shadow": st, "stats": dataclasses.asdict(eng.stats), "launches": launches,
        "dispatches": dispatches,
        "pass_ms_median": statistics.median(pass_s) * 1e3,
        "host_ms_per_batch": {
            "harvest": host["_harvest_evictees"]["s"] * 1e3 / max(1, len(pass_s)),
            "take": host["take"]["s"] * 1e3 / max(1, len(pass_s))},
        "host_s": {k: v["s"] for k, v in host.items()},
        "shadow_nominal_bytes": shadow.nominal_bytes,
    }
    if over:
        raise SystemExit(f"phase tier: {over} sampled keys over-granted")
    if st["shed"] != 0:
        raise SystemExit(f"phase tier: the shadow shed {st['shed']} rows")
    if not all(c["identity"] for c in curve) or not info["identity_live_plus_shadow_eq_answered"]:
        raise SystemExit(f"phase tier: live + shadow rows != keys answered ({curve}, "
                         f"{live} + {st['ram_rows']} vs {n_answered})")
    if launches["probe_walk"] == 0 or st["demoted_evict"] == 0 or st["promoted"] == 0:
        raise SystemExit(f"phase tier: the tier path did not run ({launches}, {st})")

    # probe_walk with the evictee sidecar at this geometry: a decide of
    # fresh keys into the full table, and a merge of shadowed rows (the
    # promote), each against its plain version
    dev = eng.table.rows.device
    fresh = torch.from_numpy(rng.integers(1, 1 << 62, batch, dtype=np.int64)).to(dev)
    now_t = torch.full((batch,), t, dtype=torch.int64, device=dev)
    act = torch.ones(batch, dtype=torch.bool, device=dev)
    full = lambda v: torch.full((batch,), v, dtype=torch.int64, device=dev)
    req = ReqBatch(fp=fresh, algo=torch.zeros(batch, dtype=torch.int32, device=dev),
                   behavior=torch.zeros(batch, dtype=torch.int32, device=dev), hits=full(3),
                   limit=full(TIER_LIMIT), burst=full(0), duration=full(TIER_DAY_MS),
                   created_at=now_t, expire_new=now_t + TIER_DAY_MS, greg_interval=full(0),
                   duration_eff=full(TIER_DAY_MS), active=act)
    walk = {"decide": _walk_case(
        "tier: fresh keys into the full table, evictees", eng.table, "decide", fresh, now_t,
        act, req, None, "token", True, ingress_bytes=batch * (9 * 8 + 2 * 4 + 1),
        path="tier")}
    import itertools

    taken = list(itertools.islice(shadow._rows.items(), batch))
    mfp = torch.from_numpy(np.array([f for f, _r in taken], np.int64)).to(dev)
    rows16 = torch.from_numpy(np.stack([r for _f, r in taken])).to(dev)
    walk["merge"] = _walk_case(
        "tier: promote of shadowed rows, evictees", eng.table, "merge", mfp, now_t[:len(taken)],
        act[:len(taken)], None, rows16, "mixed", True,
        ingress_bytes=len(taken) * (8 + 8 + 1 + 64), path="tier")
    info["walk"] = {k: {f: v[f] for f in ("kernel_ms", "call_ms", "plain_ms", "bound_ms",
                                          "bytes", "rows", "written", "evicted", "equal",
                                          "max_abs_err")}
                    for k, v in walk.items()}
    del fresh, req, mfp, rows16, taken
    torch.cuda.empty_cache()

    # the hot set: Zipf batches over capacity/8 keys, tiered vs no shadow
    hot = keys[:cap // 8]
    zr = np.minimum(rng.zipf(1.05, size=hot_batches * batch) - 1, hot.shape[0] - 1)
    tb = t + 10_000_000
    batches = []
    for i in range(hot_batches):
        batches.append((np.unique(hot[zr[i * batch:(i + 1) * batch]]), tb))
        tb += 13
    base = LocalEngine(capacity=capacity, device=device, probe="pallas", walk="pallas")
    warm_s = {}
    for tag, e in (("tiering", eng), ("baseline", base)):
        t0 = time.perf_counter()
        e.check_columns(_tier_cols(hot, tb, 0), now_ms=tb)
        for fp, bt in batches[:2]:
            e.check_columns(_tier_cols(fp, bt, 0), now_ms=bt)
        torch.cuda.synchronize()
        warm_s[tag] = time.perf_counter() - t0
    rows_total = sum(b[0].shape[0] for b in batches[2:])
    best = {"tiering": float("inf"), "baseline": float("inf")}
    for _rep in range(3):
        for tag, e in (("tiering", eng), ("baseline", base)):
            t0 = time.perf_counter()
            for fp, bt in batches[2:]:
                e.check_columns(_tier_cols(fp, bt, 0), now_ms=bt)
            torch.cuda.synchronize()
            best[tag] = min(best[tag], time.perf_counter() - t0)
    rates = {k: rows_total / v for k, v in best.items()}
    info.update({
        "hot_keys": int(hot.shape[0]), "hot_rows_timed": int(rows_total),
        "hot_warm_s": warm_s,
        "hot_set_rate": rates, "hot_set_ratio": rates["tiering"] / rates["baseline"],
        "hot_set_ratio_target": 0.9,
        "shadow_after_hot": shadow.stats(),
        "rss_mib": {"before": rss0, "after": _rss_mib(),
                    "peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024},
        "wall_s": time.perf_counter() - wall0,
    })
    del base
    emit(info)
    del eng
    torch.cuda.empty_cache()
    return info


def _shadow_state(eng):
    """A shadow's comparable contents: fps and canonical rows in order, and
    its stats."""
    sh = eng.shadow
    fps = np.fromiter(sh._rows.keys(), np.int64, len(sh._rows))
    rows = np.stack(list(sh._rows.values())) if len(sh._rows) else np.zeros((0, 16), np.int32)
    return fps.tobytes(), rows.tobytes(), sh.stats()


def _tier_same(engines, what: str, phase: str) -> None:
    """Card and CPU engines agree on table bytes, EngineStats and the
    shadow's fps, rows (in order) and stats; SystemExit names `what`."""
    a, b = engines
    if a.snapshot().tobytes() != b.snapshot().tobytes():
        raise SystemExit(f"phase {phase}: tables differ after {what}")
    sa, sb = dataclasses.asdict(a.stats), dataclasses.asdict(b.stats)
    if sa != sb:
        raise SystemExit(f"phase {phase}: stats differ after {what}: {sa} vs {sb}")
    ha, hb = _shadow_state(a), _shadow_state(b)
    for name, x, y in zip(("fps", "rows", "stats"), ha, hb):
        if x != y:
            raise SystemExit(f"phase {phase}: shadow {name} differ after {what}")


def _responses_same(rcs, what: str, phase: str) -> None:
    for f in rcs[0]._fields:
        if not all(np.array_equal(getattr(rcs[0], f), getattr(r, f)) for r in rcs[1:]):
            raise SystemExit(f"phase {phase}: {f} differs ({what})")


def _tier_traffic(rng, keys: np.ndarray, n: int, t: int, dup: float = 0.05):
    """A batch over the tracked keys: mostly unique rows of 3 hits, a few
    keys repeated (multi-pass plans), a few error rows."""
    fp = rng.choice(keys, n, replace=False)
    rep = rng.random(n) < dup
    fp[rep] = rng.choice(fp, int(rep.sum()))
    cols = _tier_cols(fp, t, 3)
    err = (rng.random(n) < 0.01).astype(np.int8)
    return cols._replace(err=err, fp=np.where(err == 0, cols.fp, 0),
                         hits=rng.integers(0, 5, n).astype(np.int64))


def phase_tier_parity(seed: int, device: str = "cuda", capacity: int = 1 << 14,
                      batch: int = 4096, width: int = 1024, drain_k: int = 4) -> dict:
    """Tiering on the card against the CPU, byte for byte, at 2^14 slots
    with 4x tracked keys, for probe xla/pallas x walk xla/pallas, over four
    paths on one shadow-armed engine pair (both compact-wire): the serial
    check_columns over every tracked key, the pipelined prepare / issue /
    finish, one ring drain of `drain_k` slots, and an idle demote
    (extract_idle + tombstone_fps + offer) followed by the fault-back; then
    a 4-shard mesh on one card with a shadow: idle demote and fault-back
    through the routed merge. After each path: responses, EngineStats,
    table bytes, the shadow's fps and rows in order and its stats."""
    from gubernator_tpu_torch.ops import engine as te
    from gubernator_tpu_torch.ops import ring_drain as rd
    from gubernator_tpu_torch.ops.engine import LocalEngine, prepare_ring_slot
    from gubernator_tpu_torch.service.wire import wire_batch_from_columns
    from gubernator_tpu_torch.tier import ROW_BYTES, ShadowTable

    info = {"phase": "tier_parity", "capacity": capacity, "equal": True, "cases": {}}
    P = "tier_parity"
    fixup = lambda fn: fn()
    for probe in ("xla", "pallas"):
        for walk in ("xla", "pallas"):
            rng = np.random.default_rng(seed + 131)
            engines = [LocalEngine(capacity=capacity, device=d, probe=probe, walk=walk,
                                   wire="compact") for d in (device, "cpu")]
            cap = engines[0].table.capacity
            keys = np.unique(rng.integers(1, 1 << 62, 4 * cap, dtype=np.int64))
            for e in engines:
                e.attach_shadow(ShadowTable(max_bytes=keys.shape[0] * ROW_BYTES))
            case = f"probe={probe}, walk={walk}"
            t = NOW
            # serial: every tracked key once, then a mixed pass
            for i in range(0, keys.shape[0], batch):
                cols = _tier_cols(keys[i:i + batch], t, 3)
                _responses_same([e.check_columns(cols, now_ms=t) for e in engines],
                                f"serial batch {i // batch}, {case}", P)
                t += 7
            for _ in range(4):
                cols = _tier_traffic(rng, keys, batch, t)
                _responses_same([e.check_columns(cols, now_ms=t) for e in engines],
                                f"serial mixed, {case}", P)
                t += 7
            _tier_same(engines, f"serial, {case}", P)
            # pipelined: prepare / issue / finish, two batches in flight
            for _ in range(3):
                c1, c2 = (_tier_traffic(rng, keys, batch, t, dup=0.0) for _ in range(2))
                outs = []
                for e in engines:
                    p1 = te.issue_check_columns(e, te.prepare_check_columns(e, c1, now_ms=t))
                    p2 = te.issue_check_columns(e, te.prepare_check_columns(e, c2, now_ms=t))
                    got = []
                    for p in (p1, p2):
                        rc, delta = te.finish_check_columns(e, p, fixup)
                        e.stats.merge(delta)
                        got.append(rc)
                    outs.append(got)
                for j in range(2):
                    _responses_same([o[j] for o in outs], f"pipelined, {case}", P)
                t += 7
            _tier_same(engines, f"pipelined, {case}", P)
            # one ring drain over drain_k slots of tracked keys
            rings = [rd.DeviceRing(2 * drain_k, width, drain_k, evictees=True, device=d)
                     for d in (device, "cpu")]
            wbs = [wire_batch_from_columns(_tier_cols(
                rng.choice(keys, width - 16 * j, replace=False), t, 3)) for j in range(drain_k)]
            answers = []
            for e, ring in zip(engines, rings):
                group = [prepare_ring_slot(e, [wb], width, now_ms=t) for wb in wbs]
                if any(g is None for g in group):
                    raise SystemExit("phase tier_parity: a slot left the fused wire path")
                done = rd.finish_ring_group(e, group, *rd.issue_ring_group(e, ring, group, 0),
                                            fixup)
                for _rc, delta in done:
                    e.stats.merge(delta)
                answers.append([rc for rc, _d in done])
            for j in range(drain_k):
                _responses_same([a[j] for a in answers], f"ring slot {j}, {case}", P)
            _tier_same(engines, f"ring drain, {case}", P)
            t += 1_000
            # idle demote, then fault-back of the demoted keys
            demoted = []
            for e in engines:
                fps, slots = e.extract_idle(t, 500, max_rows=batch)
                e.tombstone_fps(fps)
                e.shadow.offer(fps, e.table.layout.unpack(slots), t, reason="idle")
                demoted.append(fps)
            if not np.array_equal(demoted[0], demoted[1]) or demoted[0].shape[0] == 0:
                raise SystemExit(f"phase tier_parity: idle demotes differ or none ({case})")
            _tier_same(engines, f"idle demote, {case}", P)
            t += 7
            back = _tier_cols(demoted[0][: batch // 2], t, 1)
            _responses_same([e.check_columns(back, now_ms=t) for e in engines],
                            f"fault-back, {case}", P)
            _tier_same(engines, f"fault-back, {case}", P)
            info["cases"][case] = {"tracked": int(keys.shape[0]),
                                   "idle_demoted": int(demoted[0].shape[0]),
                                   "shadow": engines[0].shadow.stats(),
                                   "stats": dataclasses.asdict(engines[0].stats)}
            del engines, rings
    # the mesh: 4 shards of one card, idle demote and routed fault-back
    knobs = dict(route="device", dedup="device", a2a="ring", write_mode="sparse", wire="full",
                 probe="pallas", walk="pallas")
    rng = np.random.default_rng(seed + 137)
    engines = [_mesh_engine(d, capacity // MESH_D, **knobs) for d in (device, "cpu")]
    cap = engines[0].table.capacity * MESH_D
    keys = np.unique(rng.integers(1, 1 << 62, 4 * cap, dtype=np.int64))
    for e in engines:
        e.shadow = ShadowTable(max_bytes=keys.shape[0] * ROW_BYTES)
    t = NOW
    for i in range(0, cap, batch):
        cols = _tier_traffic(rng, keys, batch, t)
        _responses_same([e.check_columns(cols, now_ms=t) for e in engines], "mesh traffic", P)
        t += 7
    t += 1_000
    demoted = []
    for e in engines:
        fps, slots = e.extract_idle(t, 500, max_rows=batch)
        e.tombstone_fps(fps)
        e.shadow.offer(fps, e.table.layout.unpack(slots), t, reason="idle")
        demoted.append(fps)
    if not np.array_equal(demoted[0], demoted[1]) or demoted[0].shape[0] == 0:
        raise SystemExit("phase tier_parity: mesh idle demotes differ or none")
    _tier_same(engines, "mesh idle demote", P)
    for k in range(2):
        t += 7
        back = _tier_traffic(rng, np.concatenate([demoted[0], keys[:batch]]), batch, t)
        _responses_same([e.check_columns(back, now_ms=t) for e in engines],
                        f"mesh fault-back {k}", P)
        _tier_same(engines, f"mesh fault-back {k}", P)
    if engines[0].shadow.stats()["promoted"] == 0:
        raise SystemExit("phase tier_parity: the mesh fault-back promoted nothing")
    info["mesh"] = {"shards": MESH_D, "idle_demoted": int(demoted[0].shape[0]),
                    "shadow": engines[0].shadow.stats(),
                    "stats": dataclasses.asdict(engines[0].stats)}
    emit(info)
    return info


def _changes_same(a: list, b: list, what: str) -> int:
    """Two ChangeSet lists equal field by field, dtype included; returns
    the rows they hold."""
    if len(a) != len(b):
        raise SystemExit(f"phase store_parity: {len(a)} vs {len(b)} ChangeSets ({what})")
    rows = 0
    for i, (x, y) in enumerate(zip(a, b)):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray):
                if u.dtype != v.dtype or not np.array_equal(u, v):
                    raise SystemExit(f"phase store_parity: ChangeSet {i} field {f.name} "
                                     f"differs ({what})")
            elif u != v:
                raise SystemExit(f"phase store_parity: ChangeSet {i} field {f.name} "
                                 f"differs ({what})")
        rows += x.fps.shape[0]
    return rows


def phase_store_parity(seed: int, device: str = "cuda", capacity: int = 1 << 14,
                       n: int = 2048, steps: int = 3) -> dict:
    """The Store hooks on the card against the CPU: a DictStore (that also
    logs its ChangeSets) on LocalEngine and on a 4-shard device-routed
    mesh — contended mixed traffic, a restart onto a fresh table with the
    same store (rehydrate), a restore of an empty table (rehydrate), and
    the leaky custom-burst and leak-since-write cases — and a
    RecordingStore on GlobalShardedEngine with a GLOBAL backlog deeper than
    sync_out per home, so sync() drains round by round. Every ChangeSet
    field by field, the stores' rows and counters, responses, stats and
    table bytes (primary and replica) equal."""
    from gubernator_tpu_torch import types as tt
    from gubernator_tpu_torch.ops.batch import columns_from_requests
    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.store import DictStore, RecordingStore

    P = "store_parity"

    class LoggedDict(DictStore):
        """A DictStore that also keeps every ChangeSet it receives."""

        def __init__(self):
            super().__init__()
            self.log = []

        def on_change(self, change) -> None:
            self.log.append(change)
            super().on_change(change)

    info = {"phase": P, "equal": True, "cases": {}}
    mesh_knobs = dict(route="device", dedup="device", a2a="ring", write_mode="sparse",
                      wire="full", probe="pallas", walk="pallas")
    makers = {
        "local": lambda d, store: LocalEngine(capacity=capacity, device=d, probe="pallas",
                                              walk="pallas", wire="full", store=store),
        "mesh": lambda d, store: _mesh_engine(d, capacity // MESH_D, store=store,
                                              **mesh_knobs),
    }
    for name, make in makers.items():
        rng = np.random.default_rng(seed + 141)
        stores = [LoggedDict(), LoggedDict()]
        devs = (device, "cpu")
        engines = [make(d, s) for d, s in zip(devs, stores)]
        nb = engines[0].table.n_buckets
        pool = rng.integers(1, 2**63 - 1, 4 * n, dtype=np.int64)
        t = NOW

        def run(cols, what):
            rcs = [e.check_columns(cols, now_ms=t) for e in engines]
            _responses_same(rcs, f"{what}, {name}", P)
            if engines[0].snapshot().tobytes() != engines[1].snapshot().tobytes():
                raise SystemExit(f"phase {P}: tables differ after {what} ({name})")
            sa, sb = (dataclasses.asdict(e.stats) for e in engines)
            if sa != sb:
                raise SystemExit(f"phase {P}: stats differ after {what} ({name}): {sa} vs {sb}")

        for step in range(steps):
            run(_mixed_cols(rng, n, nb, pool), f"traffic {step}")
            t += int(rng.integers(200, 2_000))
        # restart onto a fresh table with the same store: misses rehydrate
        engines = [make(d, s) for d, s in zip(devs, stores)]
        run(_mixed_cols(rng, n, nb, pool), "after restart")
        t += 500
        # restore of an empty table: every key rehydrates again
        for e in engines:
            e.restore(np.zeros_like(e.snapshot()))
        run(_mixed_cols(rng, n, nb, pool), "after empty restore")
        # leaky bucket: a custom burst, and the leak since the stored stamp
        lb = tt.RateLimitRequest(name="t", unique_key="lb", hits=15, limit=10, burst=20,
                                 duration=60_000, algorithm=1)
        lk = tt.RateLimitRequest(name="t", unique_key="lk", hits=10, limit=10,
                                 duration=60_000, algorithm=1, created_at=t)
        run(columns_from_requests([lb, lk]), "leaky writes")
        engines = [make(d, s) for d, s in zip(devs, stores)]
        got = []
        for req, now in ((dataclasses.replace(lb, hits=1), t),
                         (dataclasses.replace(lk, hits=0, created_at=t + 30_000), t + 30_000)):
            rcs = [e.check_columns(columns_from_requests([req]), now_ms=now) for e in engines]
            _responses_same(rcs, f"leaky rehydrate, {name}", P)
            got.append(int(rcs[0].remaining[0]))
        if got != [4, 5]:
            raise SystemExit(f"phase {P}: leaky rehydrates gave {got}, want [4, 5] ({name})")
        sa, sb = (dataclasses.asdict(e.stats) for e in engines)
        if sa != sb or engines[0].snapshot().tobytes() != engines[1].snapshot().tobytes():
            raise SystemExit(f"phase {P}: stats or tables differ after the leaky rehydrates "
                             f"({name})")
        rows = _changes_same(stores[0].log, stores[1].log, name)
        if stores[0].rows != stores[1].rows or (stores[0].hydrated, stores[0].get_calls) != (
                stores[1].hydrated, stores[1].get_calls):
            raise SystemExit(f"phase {P}: store contents or counters differ ({name})")
        if stores[0].hydrated == 0:
            raise SystemExit(f"phase {P}: nothing rehydrated ({name})")
        info["cases"][name] = {"change_sets": len(stores[0].log), "change_rows": rows,
                               "store_rows": len(stores[0].rows),
                               "hydrated": stores[0].hydrated,
                               "get_calls": stores[0].get_calls,
                               "stats": dataclasses.asdict(engines[0].stats)}
    # GLOBAL: owner-row write-through at check, and sync round by round
    rng = np.random.default_rng(seed + 143)
    stores = [RecordingStore(), RecordingStore()]
    sync_out = 16
    engines = [_global_engine(d, capacity // MESH_D, sync_out, store=s, **mesh_knobs)
               for d, s in zip((device, "cpu"), stores)]
    t = NOW
    # distinct keys per batch (each key queues at one home): the sync must
    # then deliver each reconciled key exactly once
    keys = np.unique(rng.integers(1, 2**63 - 1, 320, dtype=np.int64))[:288]
    for b in range(3):
        fp = keys[b * 96:(b + 1) * 96]
        cols = _limit_cols(fp, rng.integers(1, 4, 96), behavior=GLOBAL_BIT)
        plain = rng.random(96) < 0.25
        cols = cols._replace(behavior=np.where(plain, 0, cols.behavior).astype(np.int32))
        _responses_same([e.check_columns(cols, now_ms=t) for e in engines],
                        f"GLOBAL batch {b}", P)
    depth = max(len(p) for p in engines[0].pending)
    if depth <= sync_out:
        raise SystemExit(f"phase {P}: GLOBAL backlog {depth} is not deeper than sync_out")
    n_check = len(stores[0].changes)
    for e in engines:
        e.sync(now_ms=t)
    rows = _changes_same(stores[0].changes, stores[1].changes, "global")
    ga, gb = (dataclasses.asdict(e.global_stats) for e in engines)
    if ga != gb:
        raise SystemExit(f"phase {P}: GlobalStats differ: {ga} vs {gb}")
    if engines[0].snapshot().tobytes() != engines[1].snapshot().tobytes():
        raise SystemExit(f"phase {P}: GLOBAL primaries differ")
    for a, b in zip(engines[0].replica, engines[1].replica):
        if a.rows.cpu().numpy().tobytes() != b.rows.numpy().tobytes():
            raise SystemExit(f"phase {P}: GLOBAL replicas differ")
    synced = [fp for ch in stores[0].changes[n_check:] for fp in ch.fps.tolist()]
    if len(synced) != len(set(synced)) or ga["sync_rounds"] < 2:
        raise SystemExit(f"phase {P}: the sync did not deliver each entry once over "
                         f"several rounds ({len(synced)} rows, {ga['sync_rounds']} rounds)")
    info["global"] = {"sync_out": sync_out, "deepest_home": depth,
                      "change_sets": len(stores[0].changes), "change_rows": rows,
                      "synced_rows": len(synced), "global_stats": ga}
    # GLOBAL with a DictStore: after a restart onto fresh meshes with the
    # same stores, the owner rows of a GLOBAL batch rehydrate on the primary
    stores = [LoggedDict(), LoggedDict()]
    make = lambda d, st: _global_engine(d, capacity // MESH_D, sync_out, store=st, **mesh_knobs)
    for k, hits in enumerate((3, 1)):
        engines = [make(d, st) for d, st in zip((device, "cpu"), stores)]
        cols = _limit_cols(keys[:96], hits, behavior=GLOBAL_BIT)
        _responses_same([e.check_columns(cols, now_ms=t + k) for e in engines],
                        f"GLOBAL DictStore batch {k}", P)
        for e in engines:
            e.sync(now_ms=t + k)
        if engines[0].snapshot().tobytes() != engines[1].snapshot().tobytes():
            raise SystemExit(f"phase {P}: GLOBAL DictStore primaries differ ({k})")
    rows = _changes_same(stores[0].log, stores[1].log, "global, DictStore")
    if stores[0].rows != stores[1].rows or stores[0].hydrated != stores[1].hydrated \
            or stores[0].hydrated == 0:
        raise SystemExit(f"phase {P}: GLOBAL DictStore contents differ or nothing "
                         f"rehydrated ({stores[0].hydrated}, {stores[1].hydrated})")
    info["global"]["dict_store"] = {"change_rows": rows, "hydrated": stores[0].hydrated}
    emit(info)
    return info


# ---------------------------------------------------------------- service

SERVICE_SUBMITTERS = 64
SERVICE_REQUESTS = 32  # per submitter
SERVICE_ITEMS = 1000  # per request: the daemon's max_batch_size
SERVICE_KEYS = 10_000_000
SERVICE_PACKAGES = ("grpc", "aiohttp", "google.protobuf", "prometheus_client")


def _varint(v: int) -> bytes:
    """Protobuf base-128 varint of `v` (negative ints as their 64-bit two's
    complement, ten bytes, as protobuf writes int64)."""
    v &= (1 << 64) - 1
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def encode_rate_limit_req(name: str = "", unique_key: str = "", hits: int = 0,
                          limit: int = 0, duration: int = 0, algorithm: int = 0,
                          behavior: int = 0, burst: int = 0, created_at=None) -> bytes:
    """RateLimitReq wire bytes as protobuf's SerializeToString writes them:
    fields in number order, proto3 defaults left out, `created_at` (an
    optional field) written whenever it is given."""
    out = b""
    if name:
        out += _ld(1, name.encode())
    if unique_key:
        out += _ld(2, unique_key.encode())
    for field, v in ((3, hits), (4, limit), (5, duration), (6, algorithm),
                     (7, behavior), (8, burst)):
        if v:
            out += _varint(field << 3) + _varint(v)
    if created_at is not None:
        out += _varint(10 << 3) + _varint(created_at)
    return out


def encode_get_rate_limits_req(items) -> bytes:
    """GetRateLimitsReq wire bytes over encoded RateLimitReq items."""
    return b"".join(_ld(1, it) for it in items)


def _service_requests(rng, n_req: int, items: int, keys: int) -> tuple:
    """`n_req` GetRateLimitsReq of `items` token-bucket items each (limit 100,
    60 s, 1 hit), keys drawn uniformly from `keys` names: (request bytes,
    key ids (n_req, items))."""
    tail = encode_rate_limit_req(hits=1, limit=100, duration=60_000)
    head = _ld(1, b"svc")
    kids = rng.integers(0, keys, (n_req, items))
    out = [b"".join(_ld(1, head + _ld(2, b"k%d" % k) + tail) for k in ks.tolist())
           for ks in kids]
    return out, kids


def _exact_requests(name: str, kids: np.ndarray, limits: np.ndarray) -> list:
    """GetRateLimitsReq bytes, one per row of `kids`: token bucket, 1 hit,
    two hours, key id k under `name` with the limit limits[k]. The two hours
    outlive every other key of the headline table, so a claim never evicts
    these keys while it has an older lane to take."""
    head = _ld(1, name.encode())
    return [b"".join(_ld(1, head + _ld(2, b"x%d" % k) + encode_rate_limit_req(
        hits=1, limit=int(limits[k]), duration=7_200_000)) for k in ks.tolist())
        for ks in kids]


def _service_parity_requests(rng, n_req: int, now: int) -> list:
    """Mixed requests over a small key pool: the five algorithms, Gregorian
    durations, RESET_REMAINING / DRAIN_OVER_LIMIT, explicit bursts, error
    items (empty name or key), repeated keys in one request, hits above the
    compact lanes, and an empty request."""
    out = [encode_get_rate_limits_req([])]
    for r in range(n_req):
        its = []
        for _ in range(int(rng.integers(1, 48))):
            kind = int(rng.integers(0, 12))
            k = int(rng.integers(0, 64))
            algo = int(rng.integers(0, 5))
            f = dict(name="p%d" % (k % 3), unique_key="u%d" % k,
                     hits=int(rng.integers(0, 4)), limit=int(rng.integers(1, 12)),
                     duration=int(rng.integers(1, 4)) * 1_000, algorithm=algo)
            if kind == 0:
                f["name"] = ""
            elif kind == 1:
                f["unique_key"] = ""
            elif kind == 2:
                f.update(behavior=4, duration=int(rng.integers(0, 3)))  # Gregorian
            elif kind == 3:
                f["behavior"] = 8  # RESET_REMAINING
            elif kind == 4:
                f["behavior"] = 32  # DRAIN_OVER_LIMIT
            elif kind == 5 and algo in (1, 2):
                f["burst"] = f["limit"] + 3
            elif kind == 6:
                f.update(hits=1 << 19, limit=1 << 20)  # past the compact lanes
            elif kind == 7:
                f["created_at"] = now - int(rng.integers(0, 500))
            its.append(encode_rate_limit_req(**f))
        out.append(encode_get_rate_limits_req(its))
    return out


def _clock_to(fn, limiter: bool = False):
    """Point the serving clock (ms_now of ops.engine, read by the engine,
    and the copies in service.batcher and service.daemon, the encoder's
    basis, and in parallel.sharded and parallel.global_sync, the mesh
    engines') at `fn`, and with `limiter` the LocalLimiter's own clock too;
    returns the undo."""
    from gubernator_tpu_torch.edge import local_limiter as limiter_mod
    from gubernator_tpu_torch.ops import engine as engine_mod
    from gubernator_tpu_torch.parallel import global_sync as global_mod
    from gubernator_tpu_torch.parallel import sharded as sharded_mod
    from gubernator_tpu_torch.service import batcher as batcher_mod
    from gubernator_tpu_torch.service import daemon as daemon_mod

    names = [(engine_mod, "ms_now"), (batcher_mod, "ms_now"), (daemon_mod, "ms_now"),
             (sharded_mod, "ms_now"), (global_mod, "ms_now")]
    if limiter:
        names.append((limiter_mod, "_now_ms"))
    saved = [getattr(m, a) for m, a in names]
    for m, a in names:
        setattr(m, a, fn)

    def undo():
        for (m, a), f in zip(names, saved):
            setattr(m, a, f)

    return undo


def _settable_clock(now: int):
    """Set the serving clock (as _clock_to) to `now`; returns (t, undo):
    t[0] is the time all of them read."""
    t = [now]
    return t, _clock_to(lambda: t[0])


def _frozen_clock(now: int):
    """Freeze the serving clock at `now`; returns the undo."""
    return _settable_clock(now)[1]


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


def _spawn_daemon(loop, engine, behaviors=None, **conf_kw):
    """The port's Daemon at its default knobs over `engine` (spawn warms the
    engine and the native parser first), its gRPC door on a free local
    port and no HTTP door; `behaviors` and `conf_kw` set knobs by name."""
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.service.daemon import Daemon

    conf = DaemonConfig(grpc_address="127.0.0.1:0", http_address="", **conf_kw)
    for k, v in (behaviors or {}).items():
        setattr(conf.behaviors, k, v)
    return loop.run_until_complete(Daemon.spawn(conf, engine=engine))


def _stage_hist(d) -> dict:
    """The daemon's gubernator_tpu_stage_duration histogram as read from
    its registry: stage → {"count", "sum" (s), "le": {bound: cumulative}}."""
    out = {}
    for fam in d.metrics.stage_duration.collect():
        for s in fam.samples:
            e = out.setdefault(s.labels["stage"], {"count": 0.0, "sum": 0.0, "le": {}})
            if s.name.endswith("_count"):
                e["count"] = s.value
            elif s.name.endswith("_sum"):
                e["sum"] = s.value
            elif s.name.endswith("_bucket"):
                e["le"][float(s.labels["le"])] = s.value
    return out


def _stage_delta(before: dict, after: dict, stage: str) -> dict:
    """One stage's samples between two reads of the histogram: their number,
    mean ms, and the upper bounds (ms) of the buckets that hold the median
    and the 99th percentile (None past the last finite bound)."""
    a = after.get(stage)
    b = before.get(stage, {"count": 0.0, "sum": 0.0, "le": {}})
    if a is None or a["count"] == b["count"]:
        return {"n": 0}
    n = a["count"] - b["count"]
    les = sorted(a["le"])
    cum = [a["le"][le] - b["le"].get(le, 0.0) for le in les]

    def bound(q):
        le = next(le for le, c in zip(les, cum) if c >= q * n)
        return le * 1e3 if le != float("inf") else None

    return {"n": int(n), "mean": (a["sum"] - b["sum"]) / n * 1e3,
            "p50_le": bound(0.5), "p99_le": bound(0.99)}


def _serve(loop, d, reqs: list, submitters: int, per: int, profiled: bool = False) -> dict:
    """Serve reqs[:submitters * per] through ``Daemon.get_rate_limits_raw``
    (the gRPC handler's call) from `submitters` concurrent submitters of
    `per` requests each. Returns the response bytes in request order, the
    per-request latencies, the wall time, the flushes by path, the launch
    counts, the stage histogram's deltas, the most dispatches the batcher
    had in flight at once, and the profiler's rows when `profiled`."""
    import asyncio

    b = d.batcher
    outs = [None] * (submitters * per)
    lat = []
    peak = [0]

    async def submitter(i: int):
        for j in range(per):
            r = i * per + j
            t = time.perf_counter()
            outs[r] = await d.get_rate_limits_raw(reqs[r])
            lat.append(time.perf_counter() - t)

    async def run():
        done = asyncio.Event()

        async def watch():
            while not done.is_set():
                peak[0] = max(peak[0], b.debug()["inflight"])
                await asyncio.sleep(0.001)

        w = asyncio.ensure_future(watch())
        await asyncio.gather(*(submitter(i) for i in range(submitters)))
        done.set()
        await w

    paths0 = (b.fused_dispatches, b.column_dispatches, b.wire_fallbacks, b.ring_dispatches)
    h0 = _stage_hist(d)
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profiled:
        _, rows = _profile_rows(lambda: loop.run_until_complete(run()))
    else:
        loop.run_until_complete(run())
        rows = None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    h1 = _stage_hist(d)
    fused, column, fallbacks, ring = (x - y for x, y in zip(
        (b.fused_dispatches, b.column_dispatches, b.wire_fallbacks, b.ring_dispatches), paths0))
    # a flush whose wire batch cannot fuse (repeated keys) is counted as a
    # wire fallback AND a column dispatch; an all-wire flush of a ring-armed
    # daemon is a ring dispatch (the ring's own debug() splits it further)
    return {"outs": outs, "latency_s": lat, "wall_s": wall, "flushes": fused + column + ring,
            "fused_flushes": fused, "column_flushes": column, "wire_fallbacks": fallbacks,
            "ring_flushes": ring,
            "launches": launches, "peak_inflight": peak[0], "profile": rows,
            "stages": {st: _stage_delta(h0, h1, st) for st in
                       ("parse", "queue_wait", "put", "issue", "fetch", "encode")}}


def _decode_responses(outs: list):
    """(status, limit, remaining, has error or metadata) over every row of
    the GetRateLimitsResp bytes in `outs`, and the rows of each."""
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    cols, sizes = [], []
    for o in outs:
        rs = pb.GetRateLimitsResp.FromString(o).responses
        sizes.append(len(rs))
        cols.extend((r.status, r.limit, r.remaining, bool(r.error) or len(r.metadata) > 0)
                    for r in rs)
    a = np.array(cols, np.int64).reshape(-1, 4)
    return a[:, 0], a[:, 1], a[:, 2], a[:, 3].astype(bool), np.array(sizes)


def _check_invariants(outs: list, items: int) -> int:
    """Rows of the headline traffic (1 hit on a limit of 100) that are not
    UNDER_LIMIT with limit 100, remaining in [0, 99] and no error, plus the
    rows missing from short responses. A key's count cannot be held exactly
    here: its lane expires (60 s) before those of the 10M seeded keys (an
    hour), so a claim in a full bucket evicts it first, and its next hit
    starts again at 99."""
    st, lim, rem, err, sizes = _decode_responses(outs)
    return int(((st != 0) | (lim != 100) | (rem < 0) | (rem > 99) | err).sum()
               + (items * len(outs) - sizes.sum()))


def _check_exact(outs: list, kids: np.ndarray, limits: np.ndarray,
                 shared: bool = False) -> dict:
    """Every response row against the host's count. A key hit n times in
    the run (from fresh) answers, across its rows in whatever order the
    submitters were served, remaining limit-1, limit-2, ..., limit-n once
    each, UNDER_LIMIT, its own limit and no error. With `shared` (a mesh
    with device dedup, where a key's rows in one dispatch share the answer
    after all of them), its answers sorted from the highest form runs of
    equal values, each run's value the limit less the rows up to the run's
    end: limit-m1 m1 times, then limit-m1-m2 m2 times, and so on. A row
    given another flush's or another request's outputs breaks either.
    Returns the wrong rows, the per-key counts and the key ids."""
    st, lim, rem, err, sizes = _decode_responses(outs)
    k = kids.ravel()
    if sizes.sum() != k.size or (sizes != kids.shape[1]).any():
        return {"wrong_rows": int(k.size), "short_responses": int((sizes != kids.shape[1]).sum())}
    order = np.lexsort((-rem, k))
    ks = k[order]
    first = np.r_[True, ks[1:] != ks[:-1]]
    idx = np.arange(k.size)
    rank = idx - np.maximum.accumulate(np.where(first, idx, 0))
    if shared:
        rs = rem[order]
        run_end = np.r_[(ks[1:] != ks[:-1]) | (rs[1:] != rs[:-1]), True]
        # each row's run ends at the nearest run end at or after it
        end = np.minimum.accumulate(np.where(run_end, idx, k.size)[::-1])[::-1]
        rank = rank[end]
    want_rem = limits[ks] - 1 - rank
    bad = ((rem[order] != want_rem) | (st[order] != 0) | (lim[order] != limits[ks])
           | err[order])
    uk, counts = np.unique(k, return_counts=True)
    if (counts >= limits[uk]).any():
        raise SystemExit("phase service: an exact run's key reached its limit")
    return {"wrong_rows": int(bad.sum()), "keys": uk, "counts": counts}


def _exact_run(loop, d, name: str, kids: np.ndarray, limits: np.ndarray,
               submitters: int, shared: bool = False) -> dict:
    """Serve `kids`' requests (fresh keys under `name`) through the daemon
    from `submitters` concurrent submitters, check every response row
    exactly (_check_exact), then read each key's state back through the
    runner: its remaining is its limit less its hits."""
    from gubernator_tpu_torch.ops.table2 import REM_I
    from gubernator_tpu_torch.service.wire import wire_batch_from_wire

    reqs = _exact_requests(name, kids, limits)
    per = len(reqs) // submitters
    r = _serve(loop, d, reqs, submitters, per)
    chk = _check_exact(r["outs"], kids[:submitters * per], limits, shared)
    out = {"name": name, "requests": submitters * per, "rows": submitters * per * kids.shape[1],
           "wrong_rows": chk["wrong_rows"], "peak_inflight": r["peak_inflight"],
           "flushes": r["flushes"], "fused_flushes": r["fused_flushes"],
           "column_flushes": r["column_flushes"], "ring_flushes": r["ring_flushes"],
           "launches": r["launches"], "wall_s": r["wall_s"],
           "decisions_per_s": submitters * per * kids.shape[1] / r["wall_s"],
           "request_ms": {"p50": _pct(r["latency_s"], 0.5) * 1e3,
                          "p99": _pct(r["latency_s"], 0.99) * 1e3}}
    if "keys" in chk:
        # each key's fingerprint as the parser makes it
        fp = np.concatenate([wire_batch_from_wire(q)[0].cols.fp for q in reqs[:submitters * per]])
        _, first = np.unique(kids[:submitters * per].ravel(), return_index=True)
        found, slots = loop.run_until_complete(d.runner.read_state(fp[first]))
        state_bad = (~found) | (slots[:, REM_I] != limits[chk["keys"]] - chk["counts"])
        out.update(keys=int(chk["keys"].size), max_hits=int(chk["counts"].max()),
                   state_wrong_keys=int(state_bad.sum()))
    return out


def phase_service(seed: int, eng, smi: str, submitters: int = SERVICE_SUBMITTERS,
                  per: int = SERVICE_REQUESTS, items: int = SERVICE_ITEMS,
                  keys: int = SERVICE_KEYS, parity_capacity: int = 1 << 16,
                  parity_requests: int = 96, exact_per: int = 4,
                  exact_hits: int = 4, device: str = "cuda") -> dict:
    """The port's Daemon (default knobs) over the headline engine (10M
    keys), driven through ``get_rate_limits_raw``: `submitters` concurrent
    submitters, each sending `per` GetRateLimitsReq of `items` token-bucket
    items (limit 100, 60 s, 1 hit, keys uniform over `keys` names) as
    hand-encoded bytes; once with probe "xla" (the daemon's default) and
    once with probe="pallas", each timed and then run again under
    torch.profiler for the device's busy share. Stage times come from the
    daemon's own stage histogram. The clock is frozen on the engine's
    timeline. Each probe also serves two exact runs at the same concurrency
    (every row held to the host's count, several dispatches in flight):
    keys hit `exact_hits` times each, and distinct keys, each with its own
    limit (so the fused front door runs). Then card vs CPU: the same
    mixed request bytes, one at a time under a frozen clock, through a
    daemon over a `parity_capacity`-slot engine on each: response bytes
    equal. Last, the headline traffic again over gRPC (the ``daemon``
    line)."""
    import asyncio
    import importlib.util

    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.ops.engine import LocalEngine

    P = "service"
    t_phase = time.perf_counter()
    missing = [m for m in SERVICE_PACKAGES if importlib.util.find_spec(m.split(".")[0]) is None
               or (m == "google.protobuf" and importlib.util.find_spec(m) is None)]
    if missing:
        raise SystemExit(f"phase {P}: the daemon needs {', '.join(missing)}")
    if native.load() is None:
        raise SystemExit(f"phase {P}: the native parser did not build")
    from gubernator_tpu_torch.service.wire import encode_response_columns, wire_batch_from_wire

    rng = np.random.default_rng(seed + 13)
    t_gen = time.perf_counter()
    reqs, _kids = _service_requests(rng, submitters * per, items, keys)
    gen_s = time.perf_counter() - t_gen
    # one request's parse and encode alone, on an idle host: what the
    # stages cost without the pipeline's threads around them
    t0 = time.perf_counter()
    for r in reqs[:32]:
        wire_batch_from_wire(r)
    parse_alone_ms = (time.perf_counter() - t0) / 32 * 1e3
    z = np.zeros(items, np.int64)
    t0 = time.perf_counter()
    for _ in range(32):
        encode_response_columns(z, z + 100, z + 99, z + NOW, {}, NOW)
    encode_alone_ms = (time.perf_counter() - t0) / 32 * 1e3
    # the exact runs: every key hit exact_hits times (flushes repeat keys
    # and fall back to columns), and distinct keys with a limit each
    # (flushes fuse). Under max_exact_passes hits a key, no flush can hold
    # it often enough for the planner to share one aggregate answer among
    # its rows (ops/plan.py), so each row has its own count.
    n_exact = submitters * exact_per
    if exact_hits >= eng.max_exact_passes or (n_exact * items) % exact_hits:
        raise SystemExit(f"phase {P}: {exact_hits} hits a key do not fit the exact runs")
    exact_pool = n_exact * items // exact_hits
    repeat_kids = rng.permutation(np.repeat(np.arange(exact_pool), exact_hits)).reshape(
        n_exact, items)
    repeat_limits = np.full(exact_pool, 100, np.int64)
    distinct_kids = rng.permutation(n_exact * items).reshape(n_exact, items)
    distinct_limits = 100 + np.arange(n_exact * items) % 900

    undo = _frozen_clock(NOW + 20_000)
    saved_probe = eng.probe_mode
    stats = eng.stats  # the daemon's warm-up resets them; later phases read them
    loop = asyncio.new_event_loop()
    runs, exact = {}, []
    d = None
    try:
        d = _spawn_daemon(loop, eng)
        # warm: the batch shapes this traffic coalesces into, both probes
        for probe in ("xla", "pallas"):
            eng.probe_mode = probe
            _serve(loop, d, reqs, min(8, submitters), min(4, per))
        for probe in ("xla", "pallas"):
            eng.probe_mode = probe
            ev0 = eng.stats.evicted_unexpired
            r = _serve(loop, d, reqs, submitters, per)
            loop.run_until_complete(d.runner.live_count())  # after the stats merges
            evicted = eng.stats.evicted_unexpired - ev0
            wrong = _check_invariants(r["outs"], items)
            # the busy share from a quarter of the traffic at the same
            # concurrency: the profiler's own cost grows with the launches
            pper = max(1, per // 4)
            pr = _serve(loop, d, reqs, submitters, pper, profiled=True)
            prow = pr["profile"]
            busy_ms = sum(x[2] for x in prow) / 1e3
            decisions = submitters * per * items
            flushes = r["flushes"]
            launches = r["launches"]
            lat = r["latency_s"]
            runs[probe] = {
                "probe": probe, "decisions": decisions, "wall_s": r["wall_s"],
                "decisions_per_s": decisions / r["wall_s"],
                "request_ms": {"p50": _pct(lat, 0.5) * 1e3, "p99": _pct(lat, 0.99) * 1e3,
                               "mean": statistics.fmean(lat) * 1e3},
                "flushes": flushes, "rows_per_flush": decisions / max(flushes, 1),
                "fused_flushes": r["fused_flushes"], "column_flushes": r["column_flushes"],
                "wire_fallbacks": r["wire_fallbacks"], "peak_inflight": r["peak_inflight"],
                "stage_host_ms": r["stages"],
                "launches": launches,
                "launches_per_flush": {k: v / max(flushes, 1) for k, v in launches.items()},
                "evicted_unexpired": evicted,
                "profiled_requests": submitters * pper,
                "profiled_wall_s": pr["wall_s"], "device_busy_ms": busy_ms,
                "device_busy_share": busy_ms / 1e3 / pr["wall_s"],
                "profiled_kernels": sum(x[1] for x in prow),
                "wrong_rows": wrong,
            }
            if wrong:
                emit(runs[probe])
                raise SystemExit(f"phase {P}: {wrong} wrong rows (probe {probe})")
            if probe == "xla" and (launches["slot_write"] < flushes or launches["probe_walk"]):
                raise SystemExit(f"phase {P}: xla launches {launches} for {flushes} flushes")
            if probe == "pallas" and (launches["probe_walk"] < flushes or launches["slot_write"]):
                raise SystemExit(f"phase {P}: pallas launches {launches} for {flushes} flushes")
            for kind, kids, limits in (("repeat", repeat_kids, repeat_limits),
                                       ("distinct", distinct_kids, distinct_limits)):
                x = _exact_run(loop, d, f"exact-{probe}-{kind}", kids, limits, submitters)
                x.update(probe=probe, kind=kind)
                exact.append(x)
                if (x["wrong_rows"] or x.get("state_wrong_keys", 1) or x["peak_inflight"] < 2
                        or (kind == "distinct" and not x["fused_flushes"])):
                    emit({"phase": P, "exact": exact})
                    raise SystemExit(f"phase {P}: exact run {x['name']} failed")
        # the same traffic over gRPC, on the same daemon
        eng.probe_mode = saved_probe
        daemon_line = _grpc_run(loop, d, reqs, submitters, per, items)
    finally:
        if d is not None:
            loop.run_until_complete(d.close())
        loop.close()
        eng.probe_mode = saved_probe
        eng.stats = stats
        undo()

    # card vs CPU, one request at a time under a frozen clock
    now = NOW + 30_000
    preqs = _service_parity_requests(np.random.default_rng(seed + 17), parity_requests, now)
    outs = {}
    for dev in (device, "cpu"):
        e = LocalEngine(capacity=parity_capacity, device=dev)
        outs[dev] = serve_one_by_one(e, preqs, now)
        outs[dev + "_wire"] = e.wire
    diff = [i for i, (a, c) in enumerate(zip(outs[device], outs["cpu"])) if a != c]
    parity = {"requests": len(preqs), "nonempty_requests": sum(len(r) > 0 for r in preqs),
              "bytes": sum(len(o) for o in outs["cpu"]), "differing_requests": diff[:8],
              "equal": not diff, "card_wire": outs[device + "_wire"],
              "cpu_wire": outs["cpu_wire"]}
    info = {"phase": P, "card": smi, "parser": native.parser(), "entry": "Daemon.get_rate_limits_raw",
            "submitters": submitters, "requests_per_submitter": per, "items_per_request": items,
            "keys": keys, "request_gen_s": gen_s, "parse_alone_ms": parse_alone_ms,
            "encode_alone_ms": encode_alone_ms, "runs": runs, "exact": exact,
            "parity": parity, "phase_s": time.perf_counter() - t_phase}
    emit(info)
    emit(daemon_line)
    if diff:
        raise SystemExit(f"phase {P}: card and CPU response bytes differ in requests {diff[:8]}")
    return info


def serve_one_by_one(engine, reqs: list, now: int, behaviors=None, info=None,
                     sync_every: int = 0) -> list:
    """The response bytes of a daemon (default knobs, or `behaviors` set by
    name) over `engine` to each of `reqs`, sent one at a time through
    ``get_rate_limits_raw`` with the serving clock frozen at `now`. With
    `info` (a dict) the daemon's ring state after the requests lands in
    info["ring"]. With `sync_every`, a GLOBAL sync runs after every
    `sync_every` requests and after the last (for a daemon whose timed
    sync tick `behaviors` turned off)."""
    import asyncio

    undo = _frozen_clock(now)
    loop = asyncio.new_event_loop()
    d = None
    try:
        d = _spawn_daemon(loop, engine, behaviors)
        outs = []
        for i, r in enumerate(reqs):
            outs.append(loop.run_until_complete(d.get_rate_limits_raw(r)))
            if sync_every and (i % sync_every == sync_every - 1 or i == len(reqs) - 1):
                loop.run_until_complete(d.runner.sync_global())
        if info is not None and d.ring is not None:
            info["ring"] = d.ring.debug()
        return outs
    finally:
        if d is not None:
            loop.run_until_complete(d.close())
        loop.close()
        undo()


def _grpc_run(loop, d, reqs: list, submitters: int, per: int, items: int) -> dict:
    """The headline traffic over gRPC to daemon `d` from `submitters`
    concurrent clients (the ``daemon`` line)."""
    import asyncio

    import grpc

    lat = []
    outs = [None] * (submitters * per)

    async def run():
        chan = grpc.aio.insecure_channel(f"127.0.0.1:{d.grpc_port}")
        call = chan.unary_unary("/pb.gubernator.V1/GetRateLimits",
                                request_serializer=lambda b: b,
                                response_deserializer=lambda b: b)

        async def client(i):
            for j in range(per):
                t = time.perf_counter()
                outs[i * per + j] = await call(reqs[i * per + j], timeout=60)
                lat.append(time.perf_counter() - t)

        t0 = time.perf_counter()
        await asyncio.gather(*(client(i) for i in range(submitters)))
        wall = time.perf_counter() - t0
        await chan.close()
        return wall

    wall = loop.run_until_complete(run())
    n = submitters * per * items
    wrong = _check_invariants(outs, items)
    info = {"phase": "daemon", "decisions": n, "wall_s": wall, "decisions_per_s": n / wall,
            "request_ms": {"p50": _pct(lat, 0.5) * 1e3, "p99": _pct(lat, 0.99) * 1e3},
            "wrong_rows": wrong}
    if wrong:
        emit(info)
        raise SystemExit(f"phase daemon: {wrong} wrong rows")
    return info


RING_SLOT_WIDTH = 16384  # the batcher's coalesce limit: every flush fits a slot


def _ring_run_info(r: dict, ring0: dict, ring1: dict, decisions: int) -> dict:
    """One ring-armed run's numbers: flushes by path (ring dispatches; of
    those, slots the fused drains took and slots that rode the per-slot
    path, the columns path among them), drains and slots per drain, the
    launches, decisions/s and request p50 / p99."""
    d = {k: ring1[k] - ring0[k] for k in ("published", "drain_launches", "drained_slots",
                                          "host_slots", "fallbacks")}
    lat = r["latency_s"]
    return {"decisions": decisions, "wall_s": r["wall_s"],
            "decisions_per_s": decisions / r["wall_s"],
            "request_ms": {"p50": _pct(lat, 0.5) * 1e3, "p99": _pct(lat, 0.99) * 1e3},
            "flushes": r["flushes"], "ring_dispatches": r["ring_flushes"],
            "direct_fused_flushes": r["fused_flushes"], "direct_column_flushes": r["column_flushes"],
            "ring_drained_slots": d["drained_slots"], "ring_host_slots": d["host_slots"],
            "columns_path_flushes": d["fallbacks"] + r["column_flushes"],
            "drains": d["drain_launches"],
            "slots_per_drain": d["drained_slots"] / max(d["drain_launches"], 1),
            "launches": r["launches"], "peak_inflight": r["peak_inflight"]}


def phase_service_ring(seed: int, eng, smi: str, service: dict,
                       submitters: int = SERVICE_SUBMITTERS, per: int = SERVICE_REQUESTS,
                       items: int = SERVICE_ITEMS, keys: int = SERVICE_KEYS,
                       exact_per: int = 4, parity_capacity: int = 1 << 16,
                       parity_requests: int = 96, device: str = "cuda") -> dict:
    """The request ring from the front door (slice 10): the port's Daemon
    with GUBER_RING_ENABLE, issue "auto" (which must resolve to "fused" on
    the card) and the slot width at the coalesce limit, over the headline
    engine: phase ``service``'s headline traffic (the same bytes), then its
    distinct-key exact run at the same concurrency (256,000 fresh keys,
    every row held to the host's count and each key's state read back),
    where every flush is all-wire and so rides the ring and its fused
    drains (``fence_claim``, then one decide per claimed slot). Then the
    mixed request bytes one at a time through a ring-armed daemon over a
    `parity_capacity`-slot engine on the card and on the CPU (the CPU's ring
    is the host tier): bytes equal. The daemon's close drains the ring:
    every published ticket retired. Phase ``service``'s numbers with the
    same probe stand beside."""
    import asyncio

    from gubernator_tpu_torch.ops.engine import LocalEngine

    P = "service_ring"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 13)
    reqs, _kids = _service_requests(rng, submitters * per, items, keys)
    n_exact = submitters * exact_per
    kids = np.random.default_rng(seed + 19).permutation(n_exact * items).reshape(n_exact, items)
    limits = 100 + np.arange(n_exact * items) % 900
    beh = {"ring_enable": True, "ring_issue": "auto", "ring_slot_width": RING_SLOT_WIDTH}
    undo = _frozen_clock(NOW + 20_000)
    stats = eng.stats
    loop = asyncio.new_event_loop()
    d = None
    runs = {}
    try:
        d = _spawn_daemon(loop, eng, beh)
        issue = d.ring.issue_mode
        if issue != "fused":
            raise SystemExit(f"phase {P}: GUBER_RING_ISSUE=auto resolved to {issue!r} on the card")
        _serve(loop, d, reqs, min(8, submitters), min(4, per))  # warm the ring's shapes
        r0 = d.ring.debug()
        r = _serve(loop, d, reqs, submitters, per)
        runs["headline"] = _ring_run_info(r, r0, d.ring.debug(), submitters * per * items)
        runs["headline"]["wrong_rows"] = _check_invariants(r["outs"], items)
        r0 = d.ring.debug()
        x = _exact_run(loop, d, "ring-distinct", kids, limits, submitters)
        r1 = d.ring.debug()
        runs["distinct"] = {
            **{k: x[k] for k in ("requests", "rows", "wrong_rows", "keys", "state_wrong_keys",
                                 "wall_s", "decisions_per_s", "request_ms", "flushes",
                                 "ring_flushes", "launches", "peak_inflight")
               if k in x},
            "ring_drained_slots": r1["drained_slots"] - r0["drained_slots"],
            "ring_host_slots": r1["host_slots"] - r0["host_slots"],
            "columns_path_flushes": r1["fallbacks"] - r0["fallbacks"] + x["column_flushes"],
            "drains": r1["drain_launches"] - r0["drain_launches"],
        }
        runs["distinct"]["slots_per_drain"] = (runs["distinct"]["ring_drained_slots"]
                                               / max(runs["distinct"]["drains"], 1))
        loop.run_until_complete(d.close())
        closed = d.ring.debug()
        d = None
    finally:
        if d is not None:
            loop.run_until_complete(d.close())
        loop.close()
        eng.stats = stats
        undo()
    drain = {k: closed[k] for k in ("published", "consumed", "occupancy", "closed",
                                    "launches", "drain_launches", "drained_slots",
                                    "host_slots", "fallbacks", "watchdog_relaunches")}

    # card vs CPU, one request at a time, both ring-armed
    now = NOW + 30_000
    preqs = _service_parity_requests(np.random.default_rng(seed + 17), parity_requests, now)
    outs, rings = {}, {}
    for dev in (device, "cpu"):
        rings[dev] = {}
        outs[dev] = serve_one_by_one(LocalEngine(capacity=parity_capacity, device=dev), preqs,
                                     now, behaviors=beh, info=rings[dev])
    diff = [i for i, (a, c) in enumerate(zip(outs[device], outs["cpu"])) if a != c]
    # phase service's run with the probe this engine serves the ring with
    svc = service["runs"][eng.probe_mode]
    svc_exact = next(e for e in service["exact"]
                     if e["probe"] == eng.probe_mode and e["kind"] == "distinct")
    info = {"phase": P, "card": smi, "issue": issue, "slot_width": RING_SLOT_WIDTH,
            "engine_probe": eng.probe_mode, "runs": runs, "close_drain": drain,
            "service_beside": {
                "headline": {"decisions_per_s": svc["decisions_per_s"],
                             "request_ms": svc["request_ms"], "flushes": svc["flushes"],
                             "fused_flushes": svc["fused_flushes"],
                             "column_flushes": svc["column_flushes"]},
                "distinct": {k: svc_exact.get(k) for k in (
                    "wall_s", "decisions_per_s", "request_ms", "flushes", "fused_flushes",
                    "column_flushes")}},
            "parity": {"requests": len(preqs), "bytes": sum(len(o) for o in outs["cpu"]),
                       "differing_requests": diff[:8], "equal": not diff,
                       "card_ring": {k: rings[device]["ring"][k] for k in (
                           "issue_mode", "drain_launches", "drained_slots", "host_slots")},
                       "cpu_ring_issue": rings["cpu"]["ring"]["issue_mode"]},
            "phase_s": time.perf_counter() - t_phase}
    emit(info)
    h, x = runs["headline"], runs["distinct"]
    if h["wrong_rows"]:
        raise SystemExit(f"phase {P}: {h['wrong_rows']} wrong rows in the headline traffic")
    if x["wrong_rows"] or x.get("state_wrong_keys", 1):
        raise SystemExit(f"phase {P}: the distinct-key run has wrong rows or states")
    if not x["launches"]["fence_claim"] or not x["ring_drained_slots"]:
        raise SystemExit(f"phase {P}: the distinct-key run launched no fence_claim")
    if not (drain["closed"] and drain["occupancy"] == 0
            and drain["published"] == drain["consumed"] == drain["launches"]):
        raise SystemExit(f"phase {P}: the ring's drain at close lost tickets: {drain}")
    if diff:
        raise SystemExit(f"phase {P}: card and CPU response bytes differ in requests {diff[:8]}")
    if not info["parity"]["card_ring"]["drain_launches"]:
        raise SystemExit(f"phase {P}: the card's parity daemon never drained through the ring")
    return info


DURABILITY_KEYS = 1 << 17  # the keys the checkpointed traffic updates


def _live_sorted(rows: torch.Tensor, now: int):
    """A table's live slots sorted by fingerprint, on its device."""
    from gubernator_tpu_torch.ops.table2 import decode_live_slots

    slots, fp, _exp = decode_live_slots(rows, now)
    order = torch.argsort(fp)
    return slots[order], fp[order]


def phase_durability(seed: int, eng, smi: str, submitters: int = 16, rounds: int = 3,
                     keys: int = DURABILITY_KEYS, interval_ms: float = 250.0,
                     device: str = "cuda") -> dict:
    """Incremental checkpoints and warm restart (slice 10) on the headline
    engine (2^24 slots, 10M keys): a daemon with
    GUBER_CHECKPOINT_INTERVAL_MS `interval_ms` over it loads
    DURABILITY_KEYS fresh two-hour keys, takes the base snapshot
    (compaction), then serves `rounds` passes of one hit on each of those
    keys while its loop appends delta frames, takes a last frame, and the
    files are copied aside (what a kill -9 would leave); then the clean
    close folds the log into the base. A fresh daemon over a new 2^24-slot
    engine (``walk="pallas"``) restores the copy, base + deltas: its live
    rows equal the first engine's, sorted by fingerprint, byte for byte.
    The checkpointed traffic only updates keys in place, so no claim
    evicts a row the base still holds. Files live in a temporary directory
    removed afterwards."""
    import asyncio
    import shutil
    import tempfile

    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.service.checkpoint import CheckpointManager
    from gubernator_tpu_torch.service.daemon import Daemon
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.store import DeltaLog

    P = "durability"
    t_phase = time.perf_counter()
    now = NOW + 20_000
    tmp = tempfile.mkdtemp(prefix="guber-durability-")
    live = os.path.join(tmp, "live")
    kill9 = os.path.join(tmp, "kill9")
    os.makedirs(live)
    os.makedirs(kill9)

    def conf(root):
        return DaemonConfig(grpc_address="127.0.0.1:0", http_address="",
                            cache_size=eng.table.capacity,
                            checkpoint_path=os.path.join(root, "base.npz"),
                            checkpoint_interval_ms=interval_ms,
                            checkpoint_compact_frames=1 << 20)

    kids = np.arange(keys).reshape(-1, 128)  # 128 items a request
    reqs = _exact_requests("durable", kids, np.full(keys, 1000, np.int64))
    per = len(reqs) // submitters
    undo = _frozen_clock(now)
    stats = eng.stats
    loop = asyncio.new_event_loop()
    d = d2 = None
    new = None
    info = {"phase": P, "card": smi, "keys_updated": keys, "interval_ms": interval_ms}
    try:
        d = loop.run_until_complete(Daemon.spawn(conf(live), engine=eng))
        _serve(loop, d, reqs, submitters, per)  # fresh keys: claims may evict here
        t0 = time.perf_counter()
        loop.run_until_complete(d.checkpointer.compact())
        info["base_snapshot_s"] = time.perf_counter() - t0
        info["base_bytes"] = os.path.getsize(d.checkpointer.base_path)
        frames0 = d.metrics.checkpoint_rows.labels(kind="delta")._value.get()
        t0 = time.perf_counter()
        for _ in range(rounds):
            _serve(loop, d, reqs, submitters, per)  # in place: no claim, no eviction
        info["traffic_s"] = time.perf_counter() - t0
        loop.run_until_complete(d.checkpointer.checkpoint_once())
        torch.cuda.synchronize()
        src_slots, src_fp = _live_sorted(eng.table.rows, now)
        dur = [s for fam in d.metrics.checkpoint_duration.collect() for s in fam.samples
               if s.labels.get("kind") == "delta"]
        n_frames = next(s.value for s in dur if s.name.endswith("_count"))
        t_frames = next(s.value for s in dur if s.name.endswith("_sum"))
        rows = d.metrics.checkpoint_rows.labels(kind="delta")._value.get() - frames0
        scan = DeltaLog(d.checkpointer.delta_path).scan()
        info.update(frames=int(n_frames), frames_in_log=len(scan.frames),
                    ms_per_frame=t_frames / max(n_frames, 1) * 1e3,
                    rows_per_frame=scan.rows / max(len(scan.frames), 1),
                    delta_rows_since_base=rows, delta_log_bytes=d.checkpointer._log.size_bytes())
        for name in ("base.npz", "base.npz.delta"):
            shutil.copy(os.path.join(live, name), os.path.join(kill9, name))
        t0 = time.perf_counter()
        loop.run_until_complete(d.close())
        info["close_s"] = time.perf_counter() - t0
        d = None
        info["close_log_frames"] = DeltaLog(os.path.join(live, "base.npz.delta")).frame_count()
        new = LocalEngine(capacity=eng.table.capacity, device=device, probe=eng.probe_mode,
                          walk="pallas")
        timing = {}
        orig = CheckpointManager.restore

        def timed_restore(self):
            _zero_launch_counts()
            t = time.perf_counter()
            try:
                return orig(self)
            finally:
                torch.cuda.synchronize()
                timing["s"] = time.perf_counter() - t
                timing["launches"] = _launch_counts()

        CheckpointManager.restore = timed_restore
        try:
            d2 = loop.run_until_complete(Daemon.spawn(conf(kill9), engine=new))
        finally:
            CheckpointManager.restore = orig
        launches = timing["launches"]
        cp = d2.checkpointer
        info.update(restore_s=timing["s"], restored=cp.restored,
                    replayed_frames=cp.replayed_frames, replayed_rows=cp.replayed_rows,
                    restore_launches=launches, merge_launches=launches["probe_walk"])
        dst_slots, dst_fp = _live_sorted(new.table.rows, now)
        info["live_rows"] = int(src_fp.numel())
        info["equal"] = bool(torch.equal(src_fp, dst_fp) and torch.equal(src_slots, dst_slots))
        loop.run_until_complete(d2.abort())
        d2 = None
    finally:
        for x in (d, d2):
            if x is not None:
                loop.run_until_complete(x.abort())
        loop.close()
        eng.stats = stats
        eng.ckpt = None  # the tracker the daemon attached
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
        del new
    info["phase_s"] = time.perf_counter() - t_phase
    emit(info)
    if info["restored"] != "base+delta" or not info["replayed_frames"]:
        raise SystemExit(f"phase {P}: restored {info['restored']} with "
                         f"{info['replayed_frames']} frames, not base + deltas")
    if not info["equal"]:
        raise SystemExit(f"phase {P}: the restored live rows differ from the first engine's")
    if not info["merge_launches"] or info["close_log_frames"]:
        raise SystemExit(f"phase {P}: replay launched no merge, or the close left frames")
    return info


def _tier_requests(prefix: str, kids: np.ndarray, hits: int) -> list:
    """GetRateLimitsReq bytes, one per row of `kids`: token bucket, limit 50,
    one hour, `hits` hits, key id k under the name `prefix`."""
    head = _ld(1, prefix.encode())
    tail = encode_rate_limit_req(hits=hits, limit=50, duration=3_600_000)
    return [b"".join(_ld(1, head + _ld(2, b"t%d" % k) + tail) for k in ks.tolist())
            for ks in kids]


def phase_tier_plane(seed: int, smi: str, device: str = "cuda", capacity: int = 1 << 20,
                     idle: int = 1 << 16, hot: int = 1 << 14, items: int = 256) -> dict:
    """The tiering sweep's host loop (slice 10): a daemon with
    GUBER_TIER_ENABLED, a spill file, checkpoints (for the tombstone
    frames) and a frozen clock over a `capacity`-slot engine, on the card
    and the same config on the CPU. Traffic on `idle` keys, then an hour's
    later traffic on `hot` fresh keys (`items` keys a request), ``TierManager.sweep_once`` (which
    demotes the idle keys), then fault-back traffic on half of them, one
    request at a time. Card == CPU on every response, the sweep summary,
    the table bytes, the shadow's rows and stats and the delta log's bytes
    (the tombstone frame)."""
    import asyncio
    import shutil
    import tempfile

    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.service.daemon import Daemon

    P = "tier_plane"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 23)
    ids = rng.permutation(idle + hot)
    step = items
    idle_reqs = _tier_requests("tier-plane", ids[:idle].reshape(-1, step), 2)
    hot_reqs = _tier_requests("tier-plane", ids[idle:].reshape(-1, step), 1)
    back_reqs = _tier_requests("tier-plane", ids[:idle // 2].reshape(-1, step), 1)
    tmp = tempfile.mkdtemp(prefix="guber-tier-")
    got, t_sweep = [], []
    try:
        for i, dev in enumerate((device, "cpu")):
            root = os.path.join(tmp, str(i))
            os.makedirs(root)
            conf = DaemonConfig(grpc_address="127.0.0.1:0", http_address="", cache_size=capacity,
                                tier_enabled=True, tier_idle_ms=60_000.0,
                                tier_spill_path=os.path.join(root, "spill"),
                                telemetry_interval_ms=600_000.0,
                                checkpoint_path=os.path.join(root, "base.npz"),
                                checkpoint_interval_ms=600_000.0)
            loop = asyncio.new_event_loop()
            d = None
            out = []
            undo = _frozen_clock(NOW)
            try:
                d = loop.run_until_complete(Daemon.spawn(conf, device=dev))
                out += [loop.run_until_complete(d.get_rate_limits_raw(q)) for q in idle_reqs]
                loop.run_until_complete(d.checkpointer.checkpoint_once())
                undo()
                undo = _frozen_clock(NOW + 3_600_000 - 60_000)
                out += [loop.run_until_complete(d.get_rate_limits_raw(q)) for q in hot_reqs]
                t0 = time.perf_counter()
                summary = loop.run_until_complete(d.tier.sweep_once())
                t_sweep.append(time.perf_counter() - t0)
                out += [loop.run_until_complete(d.get_rate_limits_raw(q)) for q in back_reqs]
                sh = d.tier.shadow
                stats = sh.stats()
                stats["spill"].pop("path")
                got.append({"responses": out, "summary": summary,
                            "table": d.engine.snapshot().tobytes(),
                            "shadow_fps": list(sh._rows.keys()),
                            "shadow_rows": b"".join(r.tobytes() for r in sh._rows.values()),
                            "shadow_stats": stats,
                            "log": open(d.checkpointer.delta_path, "rb").read(),
                            "wire": d.engine.wire})
            finally:
                undo()
                if d is not None:
                    loop.run_until_complete(d.close())
                loop.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = got
    same = {k: a[k] == b[k] for k in ("responses", "summary", "table", "shadow_fps",
                                      "shadow_rows", "shadow_stats", "log")}
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    back = [r.remaining for o in a["responses"][-len(back_reqs):]
            for r in pb.GetRateLimitsResp.FromString(o).responses]
    info = {"phase": P, "card": smi, "capacity": capacity, "idle_keys": idle, "hot_keys": hot,
            "requests": len(idle_reqs) + len(hot_reqs) + len(back_reqs),
            "sweep": a["summary"], "sweep_s": {"card": t_sweep[0], "cpu": t_sweep[1]},
            "shadow_stats": a["shadow_stats"],
            "log_bytes": len(a["log"]), "card_wire": a["wire"], "cpu_wire": b["wire"],
            "faulted_back_remaining": sorted(set(back)), "equal": same,
            "phase_s": time.perf_counter() - t_phase}
    emit(info)
    if not all(same.values()):
        raise SystemExit(f"phase {P}: card and CPU differ: {same}")
    if a["summary"]["demoted"] != idle or set(back) != {47}:
        raise SystemExit(f"phase {P}: the sweep demoted {a['summary']['demoted']} of {idle}, "
                         f"fault-back remaining {sorted(set(back))[:4]}")
    return info


def phase_regions(seed: int, smi: str, device: str = "cuda", capacity: int = 1 << 20,
                  keys: int = 1 << 15, requests: int = 32, items: int = SERVICE_ITEMS,
                  max_rounds: int = 8) -> dict:
    """Multi-region replication (slice 10): two port daemons, dc1 and dc2,
    each over a `capacity`-slot engine on the card with ``walk="pallas"``,
    each the other's peer in the other region, with the sync loop's own
    timer out of the way. Each serves `requests` requests of MULTI_REGION
    hits (1-3 hits, limit 10^6, two hours) on `keys` shared keys through
    ``get_rate_limits_raw``, and the phase ticks both region managers' sync
    after each pair of requests, as the loop wakes once a batch limit of
    hits (1,000 by default) is queued: a tick ships at most two requests'
    keys, well under the peer server's 1 MiB message limit. Then it ticks
    until every key's stored count on both sides equals the exact union of
    the hits (`rounds`: the ticks after the traffic). The receive path
    merges through the engine's merge walk: ``probe_walk`` launches (the
    decides use ``slot_write``)."""
    import asyncio

    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.ops.table2 import REM_I
    from gubernator_tpu_torch.service.wire import wire_batch_from_wire
    from gubernator_tpu_torch.types import PeerInfo

    P = "regions"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 29)
    limit = 1_000_000
    head = _ld(1, b"region")
    sides = []
    for _ in range(2):
        kids = rng.integers(0, keys, (requests, items))
        hits = rng.integers(1, 4, (requests, items))
        reqs = [b"".join(_ld(1, head + _ld(2, b"r%d" % k) + encode_rate_limit_req(
            hits=int(h), limit=limit, duration=7_200_000, behavior=16))
            for k, h in zip(ks.tolist(), hs.tolist())) for ks, hs in zip(kids, hits)]
        sides.append((kids, hits, reqs))
    total = np.zeros(keys, np.int64)
    for kids, hits, _ in sides:
        np.add.at(total, kids.ravel(), hits.ravel())
    fp_of = np.zeros(keys, np.int64)
    for kids, _, reqs in sides:
        for ks, q in zip(kids, reqs):
            fp_of[ks] = wire_batch_from_wire(q)[0].cols.fp
    used = np.flatnonzero(total)
    undo = _frozen_clock(NOW + 40_000)
    loop = asyncio.new_event_loop()
    ds = []
    try:
        for dc in ("dc1", "dc2"):
            eng = LocalEngine(capacity=capacity, device=device, walk="pallas")
            ds.append(_spawn_daemon(loop, eng, {"region_sync_wait_ms": 3_600_000.0,
                                                "global_batch_limit": 1 << 30},
                                    data_center=dc))

        async def tick():
            await asyncio.gather(*(d.region_manager._send() for d in ds))

        def timed_tick():
            t0 = time.perf_counter()
            loop.run_until_complete(tick())
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        peers = [PeerInfo(grpc_address=d.conf.advertise_address, data_center=d.conf.data_center)
                 for d in ds]
        for d in ds:
            d.set_peers([PeerInfo(**vars(p)) for p in peers])
        def converged():
            states = [loop.run_until_complete(d.runner.read_state(fp_of[used])) for d in ds]
            return all(f.all() and (s[:, REM_I] == limit - total[used]).all() for f, s in states)

        _zero_launch_counts()
        serve_s = sync_s = 0.0
        for i in range(requests):
            t0 = time.perf_counter()
            for d, (_, _, reqs) in zip(ds, sides):
                loop.run_until_complete(d.get_rate_limits_raw(reqs[i]))
            serve_s += time.perf_counter() - t0
            sync_s += timed_tick()
        rounds = 0
        done = converged()
        while rounds < max_rounds and not done:
            rounds += 1
            sync_s += timed_tick()
            done = converged()
        launches = _launch_counts()
        rms = [d.region_manager.debug()["wire"] for d in ds]
    finally:
        for d in ds:
            loop.run_until_complete(d.close())
        loop.close()
        undo()
    merged = sum(w["rows_merged"] for w in rms)
    info = {"phase": P, "card": smi, "capacity": capacity, "keys": int(used.size),
            "requests_per_side": requests, "items": items, "serve_s": serve_s,
            "ticks_with_traffic": requests, "rounds": rounds, "converged": done,
            "sync_s": sync_s,
            "reconciled_entries": merged, "reconciled_entries_per_s": merged / max(sync_s, 1e-9),
            "wire": rms, "merge_launches": launches["probe_walk"], "launches": launches,
            "phase_s": time.perf_counter() - t_phase}
    emit(info)
    if not done:
        raise SystemExit(f"phase {P}: not converged to the exact union after {rounds} rounds")
    if launches["probe_walk"] < requests or any(w["fallback"] for w in rms):
        raise SystemExit(f"phase {P}: merges {launches['probe_walk']}, fallbacks "
                         f"{[w['fallback'] for w in rms]}")
    return info


LEASE_T3 = 3 << 6  # priority tier 3: priority scaling keeps the whole slice
# the knobs of the scripted lease sequence's daemon: priority scaling on, the
# GLOBAL and region loops' timers out of the way (their queues are read)
LEASE_PARITY_BEHAVIORS = {"global_sync_wait_ms": 3_600_000.0, "global_batch_limit": 1 << 30,
                          "region_sync_wait_ms": 3_600_000.0}
LEASE_PARITY_CONF = {"data_center": "dc1", "lease_priority_scaling": True}


def lease_script() -> list:
    """The scripted lease sequence of phase ``leases_parity`` (and of the CPU
    tests against the JAX daemon, tests/test_torch_leases.py), for a daemon
    with LEASE_PARITY_CONF and LEASE_PARITY_BEHAVIORS whose peers are itself
    and one dc2 peer it never reaches. Steps: ("lease", LeaseQuotaReq
    fields; an int lease_id names the id the lease step of that index
    answered), ("check", [RateLimitReq fields]) and ("advance", ms added to
    the frozen clock)."""
    T3 = LEASE_T3

    def lease(key, **kw):
        return ("lease", {"name": "ls", "unique_key": key, "limit": 100, "duration": 60_000,
                          "ttl_ms": 5_000, "behavior": T3, **kw})

    def check(key, **kw):
        return ("check", [{"name": "ls", "unique_key": key, "hits": 0, "limit": 100,
                           "duration": 60_000, "behavior": T3, **kw}])

    return [
        lease("a", tokens=20),  # 0: acquire
        check("a"),
        lease("a", tokens=40),  # 1: a partial grant at the per-key cap (50)
        ("check", [{"name": "ls\x00lease", "unique_key": "a", "hits": 0, "limit": 50,
                    "duration": 5_000, "algorithm": 4}]),  # the ledger row
        check("b", hits=10, limit=10),
        lease("b", tokens=3, limit=10),  # 2: denied, the real limit is spent
        lease("a", lease_id=0, tokens=10, return_tokens=500),  # 3: clamped return, renew
        lease("b", lease_id=0, return_tokens=5, limit=10),  # 4: another key's id
        lease("a", lease_id="deadbeef", return_tokens=3),  # 5: an unknown id
        check("a"),
        lease("p", tokens=40, behavior=1 << 6),  # 6: tier 1 halves the slice
        lease("p", tokens=25),  # 7: tier 3, the whole slice; the key is pressured
        lease("p", lease_id=6, tokens=2, behavior=1 << 6),  # 8: renew, a shrink hint
        lease("p", tokens=4, behavior=0),  # 9: tier 0, a quarter and a shrink hint
        lease("g", tokens=10, behavior=T3 | 2),  # 10: GLOBAL, the owner queues a broadcast
        lease("m", tokens=10, behavior=T3 | 16),  # 11: MULTI_REGION, queued for dc2
        check("g", behavior=T3 | 2), check("m", behavior=T3 | 16),
        ("advance", 10_000),  # past every lease's TTL
        lease("a", tokens=50),  # 12: the ledger reclaimed by TTL, the whole cap again
        check("a"), check("b", limit=10), check("p"),
    ]


async def run_lease_script(client, advance) -> list:
    """Drive lease_script() through `client` (a V1Client of the port) and
    return each response's bytes; `advance(ms)` moves the frozen clock."""
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    ids, outs = [], []
    for kind, arg in lease_script():
        if kind == "advance":
            advance(arg)
        elif kind == "lease":
            kw = dict(arg)
            if isinstance(kw.get("lease_id"), int):
                kw["lease_id"] = ids[kw["lease_id"]]
            r = await client.lease_quota(pb.LeaseQuotaReq(**kw))
            ids.append(r.lease_id)
            outs.append(r.SerializeToString())
        else:
            r = await client.get_rate_limits([pb.RateLimitReq(**it) for it in arg])
            outs.append(r.SerializeToString())
    return outs


def lease_peers(d, peer_cls=None) -> list:
    """The scripted sequence's peers of daemon `d`: itself in dc1 and a
    dc2 peer on a local port nothing listens on (its region queue is read,
    never sent); `peer_cls` is the daemon's PeerInfo (the port's by
    default)."""
    if peer_cls is None:
        from gubernator_tpu_torch.types import PeerInfo as peer_cls

    return [peer_cls(grpc_address=d.conf.advertise_address, data_center="dc1"),
            peer_cls(grpc_address="127.0.0.1:9", data_center="dc2")]


def lease_state(d) -> dict:
    """What the scripted sequence leaves in daemon `d` besides its table:
    debug_leases(), the GLOBAL broadcast queue and the region queues."""
    return {"debug": d.debug_leases(),
            "global_updates": {k: v.SerializeToString() for k, v
                               in sorted(d.global_manager._updates.items())},
            "region_pending": {dc: {k: v.SerializeToString() for k, v in sorted(q.items())}
                               for dc, q in sorted(d.region_manager._pending.items())}}


def lease_uuid(seed: int):
    """A uuid.uuid4 stand-in: one seeded sequence of lease ids."""
    import random
    import uuid

    rng = random.Random(seed)
    return lambda: uuid.UUID(int=rng.getrandbits(128), version=4)


def lease_responses(outs: list) -> list:
    """The LeaseQuotaResp messages among run_lease_script's response bytes."""
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    kinds = [kind for kind, _ in lease_script() if kind != "advance"]
    return [pb.LeaseQuotaResp.FromString(b) for b, kind in zip(outs, kinds) if kind == "lease"]


LEASE_LIMIT = 1 << 24  # phase leases (b): the hot key's limit (bench.py leases_case)
# phase leases (a) and (b): where the serving clock starts, after the clocks
# of the headline engine's earlier phases and inside the seeded keys' hour
LEASE_NOW = NOW + 40_000


def phase_leases(seed: int, eng, smi: str, device: str = "cuda", baseline_s: float = 0.5,
                 admit_s: float = 0.8, restart_capacity: int = 1 << 20,
                 restart_limit: int = 200, n_keys: int = 0) -> dict:
    """Edge quota leases (slice 11) on the headline engine (2^24 slots, 10M
    keys, probe "pallas"), the JAX package's own lease traffic (bench.py
    ``leases_case``, ci/bench_cpu.py ``lease_smoke``). A port Daemon at its
    default knobs over the engine, reached over gRPC, with the serving
    clock and the LocalLimiter's clock both running at wall rate from
    LEASE_NOW, so that the keys the headline phases seeded are live while
    the lease traffic competes with them for bucket slots (`live_keys`, read
    on the card at the start; at least half of `n_keys`):

    (a) the per-check baseline: 8 concurrent single-item GetRateLimits
        checkers for `baseline_s`;
    (b) one LocalLimiter (limit 2^24, 60 s, ttl 200 ms, initial grant 4096)
        hammered by 2 admission threads for `admit_s`: admissions/s, the
        fan-in cut over (a), renewals (≥ 2), the grant-size trace, and
        admissions ≤ the daemon's consumption;
    (c) ``lease_smoke``'s restart bound on a daemon of its own
        (`restart_capacity` slots, default knobs, checkpoints every 25 ms,
        the real clock): limit `restart_limit`, ttl 20 s, initial grant 60,
        20 admissions, a kill -9 and a warm restart from the checkpoint;
        admissions ≤ limit + outstanding-at-crash and ≥ outstanding-at-crash.

    Launches are counted per part, each from 0 after its daemon has
    spawned (spawn warms the engine, and the warm restart restores through
    merge_rows): `launches_baseline` over (a), `launches_limiter` over (b),
    and `launches_restart` over the limiter's traffic in (c), before the
    crash and after the restart. `launches` is (b) + (c), the lease
    traffic's own; (b) must launch probe_walk (the headline engine's walk)
    and (c) slot_write (the restart daemon's default probe)."""
    import asyncio
    import shutil
    import tempfile
    import threading

    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.edge import LocalLimiter
    from gubernator_tpu_torch.ops.table2 import decode_live_slots
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb
    from gubernator_tpu_torch.service.daemon import Daemon

    P = "leases"
    t_phase = time.perf_counter()
    minute = 60_000
    loop = asyncio.new_event_loop()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_leases_")
    wall0 = time.time_ns() // 1_000_000
    undo_clock = _clock_to(lambda: LEASE_NOW + time.time_ns() // 1_000_000 - wall0,
                           limiter=True)
    d = rd = None
    info = {"phase": P, "card": smi,
            "engine": {"capacity": eng.table.capacity, "probe": eng.probe_mode}}
    try:
        d = _spawn_daemon(loop, eng)
        _, live_fp, _ = decode_live_slots(eng.table.rows, d.now_ms())
        info["engine"]["live_keys"] = live_keys = int(live_fp.numel())
        del live_fp

        async def baseline():
            cl = V1Client(d.conf.grpc_address)
            n = [0]

            async def checker(i, deadline):
                while time.perf_counter() < deadline:
                    r = (await cl.get_rate_limits([pb.RateLimitReq(
                        name="lease-rpc", unique_key=f"u{i}", hits=1, limit=1 << 30,
                        duration=minute)])).responses[0]
                    if r.error:
                        raise SystemExit(f"phase {P}: baseline check failed: {r.error}")
                    n[0] += 1

            t0 = time.perf_counter()
            await asyncio.gather(*(checker(i, t0 + baseline_s) for i in range(8)))
            wall = time.perf_counter() - t0
            await cl.close()
            return n[0], wall

        _zero_launch_counts()
        checks, wall = loop.run_until_complete(baseline())
        launches_a = _launch_counts()
        rpc_rate = checks / wall
        info["baseline"] = {"checkers": 8, "checks": checks, "wall_s": wall,
                            "checks_per_s": rpc_rate}

        async def hammer():
            lim = LocalLimiter(d.conf.grpc_address, "lease-edge", "hot", limit=LEASE_LIMIT,
                               duration=minute, ttl_ms=200, initial_grant=4096)
            await lim.start()
            stop = threading.Event()
            counts = [0, 0]

            def admit(i):
                while not stop.is_set():
                    if lim.allow():
                        counts[i] += 1
                    else:
                        time.sleep(0.0005)

            t0 = time.perf_counter()
            futs = [asyncio.get_running_loop().run_in_executor(None, admit, i) for i in range(2)]
            await asyncio.sleep(admit_s)
            stop.set()
            await asyncio.gather(*futs)
            wall = time.perf_counter() - t0
            await lim.close()
            return lim, sum(counts), wall

        _zero_launch_counts()
        lim, admitted, wall = loop.run_until_complete(hammer())
        launches_b = _launch_counts()

        async def consumed():
            cl = V1Client(d.conf.grpc_address)
            srv = (await cl.get_rate_limits([pb.RateLimitReq(
                name="lease-edge", unique_key="hot", hits=0, limit=LEASE_LIMIT,
                duration=minute)])).responses[0]
            await cl.close()
            return LEASE_LIMIT - int(srv.remaining)

        info["limiter"] = {
            "admission_threads": 2, "wall_s": wall, "admitted": admitted,
            "admissions_per_s": admitted / wall,
            "fan_in_cut": (admitted / wall) / max(rpc_rate, 1e-9),
            "renewals": lim.stats.grants, "grant_sizes": lim.stats.grant_sizes[:16],
            "tokens_granted": lim.stats.tokens_granted,
            "tokens_returned": lim.stats.tokens_returned,
            "consumed_server_side": loop.run_until_complete(consumed()),
            "debug_leases": d.debug_leases()["ops"]}
        loop.run_until_complete(d.close())
        d = None
        undo_clock()
        undo_clock = None

        def restart_conf():
            return DaemonConfig(grpc_address="127.0.0.1:0", http_address="",
                                cache_size=restart_capacity,
                                checkpoint_path=os.path.join(tmp, "ckpt.npz"),
                                checkpoint_interval_ms=25.0)

        async def restart_bound():
            nonlocal rd
            rd = await Daemon.spawn(restart_conf(), device=device)
            addr = rd.conf.grpc_address
            _zero_launch_counts()
            lim = LocalLimiter(addr, "boom", "k", limit=restart_limit, duration=10 * minute,
                               ttl_ms=20_000, initial_grant=60)
            await lim.start()
            for _ in range(20):
                if not lim.allow():
                    raise SystemExit(f"phase {P}: the first grant did not admit")
            outstanding = lim.budget
            before = _launch_counts()
            await asyncio.sleep(0.3)  # the incremental checkpoint covers the grant writes
            await rd.abort()
            conf = restart_conf()
            conf.grpc_address = addr
            t0 = time.perf_counter()
            rd = await Daemon.spawn(conf, device=device)
            restart_s = time.perf_counter() - t0
            _zero_launch_counts()
            while lim.allow():
                pass
            for _ in range(3 * restart_limit):
                await lim.check()
            total = lim.stats.local_admits + lim.stats.rpc_admits
            await lim.close()
            after = _launch_counts()
            return {"limit": restart_limit, "outstanding_at_crash": outstanding,
                    "admitted_total": total, "bound": restart_limit + outstanding,
                    "restart_s": restart_s, "restored": rd.debug_durability()["restored"]}, \
                {k: before[k] + after[k] for k in before}

        info["restart"], launches_c = loop.run_until_complete(restart_bound())
    finally:
        if undo_clock is not None:
            undo_clock()
        for x in (d, rd):
            if x is not None:
                loop.run_until_complete(x.close())
        loop.close()
        shutil.rmtree(tmp, ignore_errors=True)
    info.update(launches_baseline=launches_a, launches_limiter=launches_b,
                launches_restart=launches_c,
                launches={k: launches_b[k] + launches_c[k] for k in launches_b},
                phase_s=time.perf_counter() - t_phase)
    emit(info)
    lm, rs = info["limiter"], info["restart"]
    if 2 * live_keys < n_keys:
        raise SystemExit(f"phase {P}: {live_keys} live keys of {n_keys} seeded")
    if lm["renewals"] < 2 or lm["admitted"] > lm["consumed_server_side"]:
        raise SystemExit(f"phase {P}: renewals {lm['renewals']}, admitted {lm['admitted']} "
                         f"against {lm['consumed_server_side']} consumed")
    if not rs["outstanding_at_crash"] <= rs["admitted_total"] <= rs["bound"]:
        raise SystemExit(f"phase {P}: {rs['admitted_total']} admitted across the restart, "
                         f"outside [{rs['outstanding_at_crash']}, {rs['bound']}]")
    if launches_b["probe_walk"] == 0 or launches_c["slot_write"] == 0:
        raise SystemExit(f"phase {P}: lease launches (b) {launches_b}, (c) {launches_c}")
    return info


def phase_leases_parity(seed: int, smi: str, device: str = "cuda",
                        capacity: int = 1 << 16) -> dict:
    """lease_script() through a port daemon over a `capacity`-slot engine on
    the card and one on the CPU, over gRPC, for probe "xla" and "pallas":
    the clock frozen and advanced by the script, uuid4 one seeded sequence
    in both. Every response byte-equal, lease_state() (debug_leases, the
    GLOBAL broadcast queue, the region queues) equal, the table bytes
    equal at the end."""
    import asyncio
    import types

    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.service import lease_manager

    P = "leases_parity"
    t_phase = time.perf_counter()
    saved_uuid = lease_manager.uuid
    out = {"phase": P, "card": smi, "capacity": capacity, "steps": len(lease_script())}
    bad = []
    try:
        for probe in ("xla", "pallas"):
            runs = []
            for dev in (device, "cpu"):
                t, undo = _settable_clock(NOW + 60_000)
                lease_manager.uuid = types.SimpleNamespace(uuid4=lease_uuid(seed + 15))
                loop = asyncio.new_event_loop()
                d = None
                try:
                    d = _spawn_daemon(loop, LocalEngine(capacity=capacity, device=dev,
                                                        probe=probe),
                                      LEASE_PARITY_BEHAVIORS, **LEASE_PARITY_CONF)
                    d.set_peers(lease_peers(d))

                    def advance(ms):
                        t[0] += ms

                    async def script():
                        cl = V1Client(d.conf.grpc_address)
                        try:
                            return await run_lease_script(cl, advance)
                        finally:
                            await cl.close()

                    outs = loop.run_until_complete(script())
                    runs.append((outs, lease_state(d), d.engine.snapshot().tobytes()))
                    d.set_peers(lease_peers(d)[:1])  # dc2's queue drops at close
                finally:
                    if d is not None:
                        loop.run_until_complete(d.close())
                    loop.close()
                    undo()
            (co, cs_, ct), (po, ps, pt) = runs
            same = {"responses": co == po, "lease_state": cs_ == ps, "table": ct == pt}
            out[probe] = {**same, "responses_n": len(co),
                          "granted": [r.granted for r in lease_responses(co)]}
            bad += [f"{probe}:{k}" for k, v in same.items() if not v]
    finally:
        lease_manager.uuid = saved_uuid
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise SystemExit(f"phase {P}: card and CPU differ in {bad}")
    return out


def phase_discovery(seed: int, smi: str, device: str = "cuda", capacity: int = 1 << 20,
                    requests: int = 32, items: int = SERVICE_ITEMS, keys: int = 20_000,
                    gossip_ms: float = 100.0, forward_timeout_ms: float = 10_000.0) -> dict:
    """Peer discovery (slice 11): two port daemons over `capacity`-slot
    engines on the card, as in phase ``regions``, with
    GUBER_PEER_DISCOVERY_TYPE=member-list and no keyring, gossiping every
    `gossip_ms`: the second knows only the first's gossip address. One
    daemon's engine walks with probe "pallas" (probe_walk), the other's is
    at the default knobs (slot_write). They converge to one two-peer list
    (convergence seconds). Then `requests` requests of `items` token-bucket
    items (1 hit, limit 10^6, two hours, keys uniform over `keys` names) go
    through each door in turn; a second pass reads every key (0 hits)
    through the other door: every key's remaining is the limit less the
    hits the host sent it, whichever door took them — each key answered by
    its one owner. Last, one daemon leaves and the other must drop it
    within the pool's suspect window (6 gossip ticks).

    The forwarding RPC timeout (GUBER_BATCH_TIMEOUT) is
    `forward_timeout_ms`: a forward that times out after its owner applied
    it is retried and counted twice, as in the reference (asyncRequest),
    and at the default 500 ms a loaded host's 1,000-item requests come
    close to it; the phase reports the retries (`forward_retries`) and the
    keys counted more (`over`) or less (`under`) than the host sent."""
    import asyncio

    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    P = "discovery"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 31)
    limit = 1_000_000
    head = _ld(1, b"disc")
    kids = rng.integers(0, keys, (requests, items))
    reqs = [b"".join(_ld(1, head + _ld(2, b"k%d" % k) + encode_rate_limit_req(
        hits=1, limit=limit, duration=7_200_000)) for k in ks.tolist()) for ks in kids]
    sent = np.bincount(kids.ravel(), minlength=keys)
    used = np.flatnonzero(sent)
    reads = [b"".join(_ld(1, head + _ld(2, b"k%d" % k) + encode_rate_limit_req(
        hits=0, limit=limit, duration=7_200_000)) for k in chunk.tolist())
        for chunk in np.array_split(used, -(-used.size // items))]
    suspect_s = 6 * gossip_ms / 1e3
    loop = asyncio.new_event_loop()
    ds = []
    info = {"phase": P, "card": smi, "capacity": capacity, "requests": requests, "items": items,
            "keys": int(used.size), "gossip_ms": gossip_ms}
    try:
        gossip = {"peer_discovery_type": "member-list", "memberlist_address": "127.0.0.1:0",
                  "memberlist_gossip_interval_ms": gossip_ms}
        fwd = {"batch_timeout_ms": forward_timeout_ms}
        ds.append(_spawn_daemon(loop, LocalEngine(capacity=capacity, device=device,
                                                  probe="pallas"), fwd, **gossip))
        t0 = time.perf_counter()
        ds.append(_spawn_daemon(loop, LocalEngine(capacity=capacity, device=device), fwd,
                                memberlist_known_nodes=ds[0]._pool.advertise_address, **gossip))
        want = sorted(d.conf.advertise_address for d in ds)

        async def until(pred, timeout_s):
            deadline = time.perf_counter() + timeout_s
            while not pred():
                if time.perf_counter() > deadline:
                    return False
                await asyncio.sleep(0.005)
            return True

        def peers(d):
            return sorted(p.grpc_address for p in d.local_peers())

        converged = loop.run_until_complete(until(
            lambda: all(peers(d) == want for d in ds), 30.0))
        info["converge_s"] = time.perf_counter() - t0
        info["peers"] = [peers(d) for d in ds]
        if not converged:
            raise SystemExit(f"phase {P}: no common peer list after 30 s: {info['peers']}")
        _zero_launch_counts()
        t0 = time.perf_counter()
        wrong = 0
        for i, r in enumerate(reqs):
            resp = pb.GetRateLimitsResp.FromString(
                loop.run_until_complete(ds[i % 2].get_rate_limits_raw(r)))
            wrong += sum(1 for x in resp.responses if x.error or x.status != pb.UNDER_LIMIT)
        info["serve_s"] = time.perf_counter() - t0
        got = []
        for i, r in enumerate(reads):
            resp = pb.GetRateLimitsResp.FromString(
                loop.run_until_complete(ds[(i + 1) % 2].get_rate_limits_raw(r)))
            got += [x.remaining for x in resp.responses]
        info["launches"] = _launch_counts()
        info["owners"] = [sum(1 for k in used[:2000] if ds[0].get_peer(f"disc_k{k}")
                              .grpc_address == d.conf.advertise_address) for d in ds]
        diff = (limit - sent[used]) - np.asarray(got)  # > 0: hits counted more than sent
        off = int(np.count_nonzero(diff))
        info.update(wrong_rows=wrong, remaining_off=off, over=int((diff > 0).sum()),
                    under=int((diff < 0).sum()),
                    forward_retries=[int(d.metrics.batch_send_retries._value.get()) for d in ds])
        # the leave: from the leaving pool's close (its tombstone) to the
        # list without it that the other pool publishes
        gone = ds.pop()
        marks = {}
        publish, leave = ds[0]._pool.on_update, gone._pool.close

        def on_update(ps):
            publish(ps)
            if len(ps) == 1:
                marks.setdefault("dropped", time.perf_counter())

        async def close_pool():
            marks["leave"] = time.perf_counter()
            await leave()

        ds[0]._pool.on_update, gone._pool.close = on_update, close_pool
        loop.run_until_complete(gone.close())
        left = loop.run_until_complete(until(
            lambda: peers(ds[0]) == [ds[0].conf.advertise_address], 10 * suspect_s))
        info.update(leave_s=marks.get("dropped", float("inf")) - marks["leave"],
                    suspect_window_s=suspect_s)
    finally:
        for d in ds:
            loop.run_until_complete(d.close())
        loop.close()
    info["phase_s"] = time.perf_counter() - t_phase
    emit(info)
    if wrong or off:
        raise SystemExit(f"phase {P}: {wrong} wrong rows, {off} keys off their count")
    if not left or info["leave_s"] > suspect_s:
        raise SystemExit(f"phase {P}: the leave took {info['leave_s']:.3f} s, over the "
                         f"suspect window {suspect_s} s")
    if (min(info["owners"]) == 0 or info["launches"]["slot_write"] == 0
            or info["launches"]["probe_walk"] == 0):
        raise SystemExit(f"phase {P}: owners {info['owners']}, launches {info['launches']}")
    return info


def _free_port_block(n: int) -> int:
    """A base port with `n` consecutive ports free on 127.0.0.1 (checked by
    binding each; another process may still take one before the caller
    binds it, so callers retry on a bind failure)."""
    import socket

    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1] + 10
        socks = []
        try:
            for i in range(n):
                so = socket.socket()
                socks.append(so)
                so.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for so in socks:
                so.close()
    raise SystemExit("no free port block")


BIND_FAILURES = ("failed to bind", "address already in use")


def _boot_cluster(P: str, nodes: int, device, env: dict, attempts: int = 3):
    """Start ``python -m gubernator_tpu_torch.cmd.cluster -n nodes`` on a
    free port block and run the healthcheck binary against its first node
    until it exits 0 (300 s at most). A cluster that exits because one of
    its ports was taken in the meantime is started again on another block,
    `attempts` times at most; any other exit fails the phase. Returns
    (process, base port, the passing healthcheck, seconds to healthy, the
    attempts made)."""
    import tempfile

    for attempt in range(1, attempts + 1):
        base = _free_port_block(2 * nodes)
        log = tempfile.TemporaryFile("w+")  # its log, read back if it exits
        cluster = subprocess.Popen(
            [sys.executable, "-m", "gubernator_tpu_torch.cmd.cluster", "-n", str(nodes),
             "--base-port", str(base), *(["--device", device] if device else [])],
            stdout=subprocess.DEVNULL, stderr=log, text=True, env=env)
        http = f"127.0.0.1:{base + 1}"
        t0 = time.perf_counter()
        try:
            while time.perf_counter() - t0 < 300:
                if cluster.poll() is not None:
                    log.seek(0)
                    err = log.read()
                    if attempt < attempts and any(m in err.lower() for m in BIND_FAILURES):
                        break
                    raise SystemExit(f"phase {P}: the cluster exited {cluster.returncode}: "
                                     f"{err[-2000:]}")
                hc = subprocess.run(
                    [sys.executable, "-m", "gubernator_tpu_torch.cmd.healthcheck"],
                    env=dict(env, GUBER_HTTP_ADDRESS=http), capture_output=True, text=True,
                    timeout=60)
                if hc.returncode == 0:
                    return cluster, base, hc, time.perf_counter() - t0, attempt
                time.sleep(0.5)
            else:
                raise SystemExit(f"phase {P}: the cluster was not healthy in 300 s: "
                                 f"{hc.stdout[-2000:]}")
        except BaseException:
            if cluster.poll() is None:
                cluster.kill()
                cluster.wait()
            raise
        finally:
            log.close()
    raise SystemExit(f"phase {P}: no port block held in {attempts} attempts")


def phase_binaries(smi: str, nodes: int = 3, device=None) -> dict:
    """The port's binaries on the card (no --device; `device` names one, for
    a rehearsal on the CPU): ``python -m
    gubernator_tpu_torch.cmd.cluster -n 3`` as a subprocess (started again
    on other ports if one was taken before it bound); ``python -m
    gubernator_tpu_torch.cmd.healthcheck`` against its first node exits 0
    (retried while the cluster boots) and the node's HealthCheck names 3
    peers; ``python -m gubernator_tpu_torch.cmd.cli --once --concurrency
    8 --checks 10`` (200 requests of 10 checks) against it exits 0 over its
    2,000-limit corpus with no errors; SIGTERM stops the
    cluster with exit code 0."""
    import signal
    import urllib.request

    P = "binaries"
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent  # the checkout: `-m` finds the port there
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))
    cluster, base, hc, ready_s, attempts = _boot_cluster(P, nodes, device, env)
    info = {"phase": P, "card": smi, "nodes": nodes, "base_port": base,
            "boot_attempts": attempts,
            "healthcheck": {"rc": hc.returncode, "ready_s": ready_s,
                            "stdout": hc.stdout.strip().splitlines()[-1:]}}
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{base + 1}/v1/HealthCheck",
                                    timeout=10) as r:
            health = json.loads(r.read())
        info["health"] = {k: health.get(k) for k in ("status", "peer_count")}
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "gubernator_tpu_torch.cmd.cli", "-e",
                              f"127.0.0.1:{base}", "--once", "-q", "--timeout", "30",
                              "--concurrency", "8", "--checks", "10"],
                             env=env, capture_output=True, text=True, timeout=300)
        report = json.loads(cli.stdout.strip().splitlines()[-1]) if cli.stdout.strip() else {}
        info["cli"] = {"rc": cli.returncode, "s": time.perf_counter() - t0, **report}
    finally:
        t0 = time.perf_counter()
        cluster.send_signal(signal.SIGTERM)
        try:
            rc = cluster.wait(timeout=120)
        except subprocess.TimeoutExpired:
            cluster.kill()
            rc = cluster.wait()
        info["sigterm"] = {"rc": rc, "stop_s": time.perf_counter() - t0}
    info["phase_s"] = time.perf_counter() - t_phase
    emit(info)
    cl = info["cli"]
    if (info["health"]["peer_count"] != nodes
            or cl["rc"] != 0 or cl.get("checks") != 2000 or cl.get("errors") != 0
            or info["sigterm"]["rc"] != 0):
        raise SystemExit(f"phase {P}: {info}")
    return info


MESH_DAEMON_SUBMITTERS = SERVICE_SUBMITTERS // 4  # a quarter of the service phase's


def _global_requests(rng, n_req: int, items: int, pool: int) -> tuple:
    """`n_req` GetRateLimitsReq of `items` GLOBAL token-bucket items each
    (limit 100, 1 hit, two hours: as the exact runs' keys, they outlive the
    headline table's, so no claim evicts them), keys drawn uniformly from
    `pool` names: (request bytes, key ids (n_req, items))."""
    tail = encode_rate_limit_req(hits=1, limit=100, duration=7_200_000, behavior=GLOBAL_BIT)
    head = _ld(1, b"mglob")
    kids = rng.integers(0, pool, (n_req, items))
    out = [b"".join(_ld(1, head + _ld(2, b"g%d" % k) + tail) for k in ks.tolist())
           for ks in kids]
    return out, kids


def _zero_hit(req: bytes) -> bytes:
    """The same GetRateLimitsReq with every item's hits field left out (0)."""
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    m = pb.GetRateLimitsReq.FromString(req)
    for it in m.requests:
        it.hits = 0
    return m.SerializeToString()


def phase_mesh_daemon(seed: int, eng, smi: str, submitters: int = MESH_DAEMON_SUBMITTERS,
                      per: int = 8, items: int = SERVICE_ITEMS, keys: int = SERVICE_KEYS,
                      exact_per: int = 4, exact_hits: int = 4, global_per: int = 2) -> dict:
    """A port Daemon over the mesh phase's engine (a GlobalShardedEngine of
    4 shards of one card, 2^22 slots each, 10M keys; the card's defaults:
    device route and dedup, the ring exchange, the fused walk), passed as
    ``engine=``. The launch counts are zeroed after the spawn. The service
    phase's traffic at a quarter of its submitters (`submitters` × `per` ×
    `items` token-bucket items over `keys` names) through
    ``get_rate_limits_raw``: decisions/s, request p50 / p99, rows and
    launches per flush, then a quarter of it under torch.profiler for the
    device's busy share. ring_exchange must launch, twice per device-routed
    dispatch. One exact run (every key hit `exact_hits` times, every row and
    every key's state held to the host's count); one run of GLOBAL items
    answered by the replicas and drained by the daemon's collective sync
    tick, after which the owner's state equals the host's count (a
    zero-hit read at every home is reported: a replica can answer off the
    owner after a finish retry, as in the JAX package); then the headline
    traffic over gRPC. The clock is frozen on the engine's timeline."""
    import asyncio

    from gubernator_tpu_torch.ops.table2 import REM_I
    from gubernator_tpu_torch.parallel.global_sync import GlobalShardedEngine
    from gubernator_tpu_torch.service.wire import wire_batch_from_wire

    P = "mesh_daemon"
    t_phase = time.perf_counter()
    if not isinstance(eng, GlobalShardedEngine):
        raise SystemExit(f"phase {P}: the engine is a {type(eng).__name__}")
    rng = np.random.default_rng(seed + 61)
    reqs, _ = _service_requests(rng, submitters * per, items, keys)
    n_exact = submitters * exact_per
    pool = n_exact * items // exact_hits
    exact_kids = rng.permutation(np.repeat(np.arange(pool), exact_hits)).reshape(n_exact, items)
    exact_limits = np.full(pool, 100, np.int64)
    greqs, gkids = _global_requests(rng, submitters * global_per, items,
                                    submitters * global_per * items // 2)
    routed = _count_a2a(eng)
    undo = _frozen_clock(NOW + 20_000)
    loop = asyncio.new_event_loop()
    d = None
    info = {"phase": P, "card": smi, "shards": eng.n_shards,
            "devices": [str(x) for x in eng.mesh.devices], "route": eng.route,
            "dedup": eng.dedup, "a2a": eng.a2a_impl, "probe": eng.probe_mode, "wire": eng.wire,
            "capacity_per_shard": eng.tables[0].capacity, "submitters": submitters,
            "requests_per_submitter": per, "items_per_request": items, "keys": keys}
    try:
        d = _spawn_daemon(loop, eng)
        _zero_launch_counts()  # the daemon's spawn warmed the engine
        _serve(loop, d, reqs, min(8, submitters), 2)  # the batch shapes of this traffic
        routed.update(a2a=0, host=0)
        r = _serve(loop, d, reqs, submitters, per)
        routed_run = dict(routed)
        launches, flushes = r["launches"], r["flushes"]
        decisions = submitters * per * items
        lat = r["latency_s"]
        pper = max(1, per // 4)
        pr = _serve(loop, d, reqs, submitters, pper, profiled=True)
        busy_ms = sum(x[2] for x in pr["profile"]) / 1e3
        info["run"] = {
            "decisions": decisions, "wall_s": r["wall_s"],
            "decisions_per_s": decisions / r["wall_s"],
            "request_ms": {"p50": _pct(lat, 0.5) * 1e3, "p99": _pct(lat, 0.99) * 1e3},
            "flushes": flushes, "rows_per_flush": decisions / max(flushes, 1),
            "fused_flushes": r["fused_flushes"], "column_flushes": r["column_flushes"],
            "peak_inflight": r["peak_inflight"], "stage_host_ms": r["stages"],
            "launches": launches, "device_routed_dispatches": routed_run,
            "launches_per_flush": {k: v / max(flushes, 1) for k, v in launches.items()},
            "profiled_requests": submitters * pper, "profiled_wall_s": pr["wall_s"],
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / 1e3 / pr["wall_s"],
            "profiled_kernels": sum(x[1] for x in pr["profile"]),
            "wrong_rows": _check_invariants(r["outs"], items)}
        x = _exact_run(loop, d, "mesh-exact", exact_kids, exact_limits, submitters,
                       shared=eng.dedup == "device")
        info["exact"] = x
        # GLOBAL: replica answers at rotating homes, hits drained by the sync tick
        rounds0 = eng.global_stats.sync_rounds
        g = _serve(loop, d, greqs, submitters, global_per)
        st, lim, rem, err, sizes = _decode_responses(g["outs"])
        k = gkids.ravel()
        uk, counts = np.unique(k, return_counts=True)
        want = np.full(int(k.max()) + 1, 100, np.int64)
        want[uk] -= counts
        g_wrong = int(((st != 0) | (lim != 100) | err | (rem > 99) | (rem < want[k])).sum()
                      + (k.size - sizes.sum()))

        async def drained():
            t0 = time.perf_counter()
            while eng.has_pending() or eng.global_stats.sync_rounds == rounds0:
                if time.perf_counter() - t0 > 60:
                    raise SystemExit(f"phase {P}: the sync tick did not drain")
                await asyncio.sleep(0.02)
            return time.perf_counter() - t0

        drain_s = loop.run_until_complete(drained())
        # a tick may still be running its drain on the engine thread: one
        # more sync queues behind it there
        loop.run_until_complete(d.runner.sync_global())
        reads = [loop.run_until_complete(d.get_rate_limits_raw(_zero_hit(q)))
                 for q in greqs[:1] for _ in range(eng.n_shards)]
        read_off = 0
        for o in reads:
            _, _, rr, rerr, _ = _decode_responses([o])
            read_off += int(((rr != want[gkids[0]]) | rerr).sum())
        fp = np.concatenate([wire_batch_from_wire(q)[0].cols.fp for q in greqs])
        _, first = np.unique(k, return_index=True)
        found, slots = loop.run_until_complete(d.runner.read_state(fp[first]))
        owner_off = int(((~found) | (slots[:, REM_I] != want[uk])).sum())
        info["global"] = {"requests": len(greqs), "rows": int(k.size), "keys": int(uk.size),
                          "wall_s": g["wall_s"], "drain_s": drain_s,
                          "sync_rounds": eng.global_stats.sync_rounds - rounds0,
                          "answer_wrong_rows": g_wrong, "home_reads": len(reads),
                          "home_read_off_rows": read_off, "owner_off_keys": owner_off,
                          "launches": g["launches"]}
        _zero_launch_counts()
        info["daemon"] = _grpc_run(loop, d, reqs, submitters, per, items)
        info["daemon"]["launches"] = _launch_counts()
    finally:
        if d is not None:
            loop.run_until_complete(d.close())
        loop.close()
        undo()
    info["phase_s"] = time.perf_counter() - t_phase
    emit(info)
    run = info["run"]
    if run["wrong_rows"]:
        raise SystemExit(f"phase {P}: {run['wrong_rows']} wrong rows")
    if not launches["ring_exchange"] or launches["ring_exchange"] != 2 * routed_run["a2a"]:
        raise SystemExit(f"phase {P}: ring_exchange launched {launches['ring_exchange']} times "
                         f"for {routed_run['a2a']} device-routed dispatches")
    if x["wrong_rows"] or x.get("state_wrong_keys", 1):
        raise SystemExit(f"phase {P}: the exact run is off: {x['wrong_rows']} rows, "
                         f"{x.get('state_wrong_keys')} keys")
    gl = info["global"]
    # home_read_off_rows is reported, not gated: a home-pinned dispatch that
    # overflows the exchange retries its dropped rows in finish, after a
    # sync may have broadcast the owner's state, and the replicas then
    # answer off the owner until the key's next hit, as the JAX package's
    # do (tests/test_torch_sharded_daemon.py pins it in both packages)
    if gl["answer_wrong_rows"] or gl["owner_off_keys"]:
        raise SystemExit(f"phase {P}: GLOBAL off: {gl}")
    if not info["daemon"]["launches"]["ring_exchange"]:
        raise SystemExit(f"phase {P}: no ring_exchange launch over gRPC")
    return info


def _mesh_parity_requests(rng, n_req: int, now: int) -> list:
    """The service parity mix, each request with up to 8 GLOBAL items on keys
    of their own (one algorithm, limit and duration a key)."""
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb

    out = []
    for q in _service_parity_requests(rng, n_req, now):
        m = pb.GetRateLimitsReq.FromString(q)
        for _ in range(int(rng.integers(0, 9))):
            k = int(rng.integers(0, 32))
            m.requests.add(name="pg", unique_key="g%d" % k, hits=int(rng.integers(0, 4)),
                           limit=20 + k, duration=60_000, algorithm=k % 2, behavior=GLOBAL_BIT)
        out.append(m.SerializeToString())
    return out


def phase_mesh_daemon_parity(seed: int, device: str = "cuda:0",
                             capacity_per_shard: int = 1 << 14, n_req: int = 96) -> dict:
    """One seeded request sequence (the service parity mix plus GLOBAL items)
    through a port mesh daemon of 4 shards of the card and one of 4 CPU
    shards, both with device routing, device dedup, the ring exchange and
    the fused walk (the CPU runs their plain versions), frozen clock,
    deterministic sync points: response bytes equal, and each shard's
    primary and replica rows."""
    P = "mesh_daemon_parity"
    t_phase = time.perf_counter()
    now = NOW + 30_000
    reqs = _mesh_parity_requests(np.random.default_rng(seed + 67), n_req, now)
    knobs = dict(route="device", dedup="device", a2a="ring", probe="pallas")
    res = {}
    for dev in (device, "cpu"):
        eng = _global_engine(dev, capacity_per_shard, sync_out=256, **knobs)
        _zero_launch_counts()
        outs = serve_one_by_one(eng, reqs, now, {"global_sync_wait_ms": 3_600_000.0},
                                sync_every=8)
        tables = [t.rows.cpu() for t in eng.tables + (eng.replica or [])]
        res[dev] = {"outs": outs, "tables": tables, "launches": _launch_counts(),
                    "wire": eng.wire, "layout": eng.layout.name,
                    "sync_rounds": eng.global_stats.sync_rounds}
    card, cpu = res[device], res["cpu"]
    diff = [i for i, (a, b) in enumerate(zip(card["outs"], cpu["outs"])) if a != b]
    tdiff = [i for i, (a, b) in enumerate(zip(card["tables"], cpu["tables"]))
             if not torch.equal(a, b)]
    info = {"phase": P, "shards": MESH_D, "capacity_per_shard": capacity_per_shard, **knobs,
            "requests": len(reqs), "global_items": sum(
                q.count(_ld(1, b"pg")) for q in reqs),
            "bytes": sum(len(o) for o in cpu["outs"]), "differing_requests": diff[:8],
            "tables": len(cpu["tables"]), "differing_tables": tdiff,
            "equal": not diff and not tdiff and len(card["tables"]) == len(cpu["tables"]),
            "card_launches": card["launches"], "card_wire": card["wire"],
            "cpu_wire": cpu["wire"], "sync_rounds": card["sync_rounds"],
            "phase_s": time.perf_counter() - t_phase}
    emit(info)
    if not info["equal"]:
        raise SystemExit(f"phase {P}: card and CPU differ: requests {diff[:8]}, "
                         f"tables {tdiff}")
    if not card["launches"]["ring_exchange"]:
        raise SystemExit(f"phase {P}: no ring_exchange launch on the card")
    return info


def _overload_requests(submitters: int, per: int, items: int) -> list:
    """Submitter s's `per` requests, each one hit on every one of its own
    `items` keys, at priority tier s % 4 (token bucket, limit 1,000, 60 s)."""
    from gubernator_tpu_torch.types import with_priority

    out = []
    for s in range(submitters):
        tail = encode_rate_limit_req(hits=1, limit=1000, duration=60_000,
                                     behavior=with_priority(0, s % 4))
        head = _ld(1, b"ovl")
        one = b"".join(_ld(1, head + _ld(2, b"s%d-%d" % (s, j)) + tail)
                       for j in range(items))
        out.extend([one] * per)
    return out


def phase_overload(seed: int, smi: str, device: str = "cuda", capacity: int = 1 << 20,
                   submitters: int = 32, per: int = 6, items: int = SERVICE_ITEMS,
                   deadline_ms: float = 500.0, queue_rows: int = 12_000,
                   coalesce: int = 4_000) -> dict:
    """The overload door in front of the card's engine: a port Daemon over a
    LocalEngine of `capacity` slots on the card, the door armed
    (``overload_deadline_ms``) with a queue bound of `queue_rows` rows, one
    dispatch in flight of at most `coalesce` rows. `submitters` concurrent
    submitters, submitter s at priority tier s % 4, send `per` requests of
    one hit on each of their own `items` keys (so a tier's requests press on
    the queue together). Checked: zero priority inversions, no tier-3 row
    shed, some rows shed; every answered row's remaining is its limit less
    the requests of its submitter answered so far, every shed row carries
    the overload error, and each key's state read back is its limit less the
    answered hits: shed rows never reached the engine."""
    import asyncio

    from gubernator_tpu_torch.ops.batch import ERR_OVERLOAD, ERROR_STRINGS
    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.ops.table2 import REM_I
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb
    from gubernator_tpu_torch.service.wire import wire_batch_from_wire

    P = "overload"
    t_phase = time.perf_counter()
    reqs = _overload_requests(submitters, per, items)
    eng = LocalEngine(capacity=capacity, device=device)
    beh = {"overload_deadline_ms": deadline_ms, "batch_queue_rows": queue_rows,
           "coalesce_limit": coalesce, "pipeline_inflight": 1}
    undo = _frozen_clock(NOW + 50_000)
    loop = asyncio.new_event_loop()
    d = None
    try:
        d = _spawn_daemon(loop, eng, beh)
        _zero_launch_counts()
        r = _serve(loop, d, reqs, submitters, per)
        b = d.batcher
        door = {"priority_inversions": b.priority_inversions,
                "shed_rows": dict(b.shed_rows), "shed_by_tier": list(b.shed_by_tier),
                "admitted_by_tier": list(b.admitted_by_tier)}
        shed_err = ERROR_STRINGS[ERR_OVERLOAD]
        wrong = 0
        served = np.zeros(submitters, np.int64)
        shed_requests = [0] * 4
        for i, o in enumerate(r["outs"]):
            s = i // per
            rs = pb.GetRateLimitsResp.FromString(o).responses
            if len(rs) != items:
                wrong += items
                continue
            errs = {x.error for x in rs}
            if errs == {""}:
                served[s] += 1
                wrong += sum(x.remaining != 1000 - served[s] or x.status != 0 for x in rs)
            elif errs == {shed_err}:
                shed_requests[s % 4] += 1
            else:
                wrong += items
        fp = np.concatenate([wire_batch_from_wire(reqs[s * per])[0].cols.fp
                             for s in range(submitters)])
        found, slots = loop.run_until_complete(d.runner.read_state(fp))
        want = np.repeat(served, items)
        state_off = int(((found != (want > 0)) | (found & (slots[:, REM_I] != 1000 - want))).sum())
    finally:
        if d is not None:
            loop.run_until_complete(d.close())
        loop.close()
        undo()
    lat = r["latency_s"]
    decisions = int(served.sum()) * items
    info = {"phase": P, "card": smi, "device": device, "capacity": capacity,
            "submitters": submitters, "requests_per_submitter": per, "items_per_request": items,
            "overload_deadline_ms": deadline_ms, "queue_rows": queue_rows,
            "coalesce_limit": coalesce, **door, "shed_requests_by_tier": shed_requests,
            "served_requests": int(served.sum()), "wrong_rows": wrong,
            "state_off_keys": state_off, "launches": r["launches"], "flushes": r["flushes"],
            "wall_s": r["wall_s"], "served_decisions_per_s": decisions / r["wall_s"],
            "request_ms": {"p50": _pct(lat, 0.5) * 1e3, "p99": _pct(lat, 0.99) * 1e3},
            "phase_s": time.perf_counter() - t_phase}
    emit(info)
    if door["priority_inversions"] or door["shed_by_tier"][3] or shed_requests[3]:
        raise SystemExit(f"phase {P}: inversions {door['priority_inversions']}, tier-3 shed "
                         f"{door['shed_by_tier'][3]}")
    if not sum(door["shed_rows"].values()) or not sum(shed_requests):
        raise SystemExit(f"phase {P}: the door shed nothing")
    if wrong or state_off:
        raise SystemExit(f"phase {P}: {wrong} wrong rows, {state_off} keys off their count")
    return info


def _kernel_entry(name, source, replaces, calls, launches, dispatches, k) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "replaces_calls": calls, "launches": launches, "dispatches": dispatches,
        "equal": k["equal"], "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
        "call_ms": k["call_ms"],
        "bound_ms": k["bound_ms"], "bound_by": "bytes", "library_ms": k.get("library_ms"),
        "library_call": k.get("library_call"),
    }


# name: (the TPU kernel body it replaces, the pallas_calls that run it,
# the headline case of its kernels-line entry)
SWEEP_KERNELS = {
    "sweep_copy": ("exp/exp_mem2.py:98", ["exp/exp_mem2.py:103 (sweep_copy)",
                                          "exp/exp_sweep2.py:156 (build(k_copy), :58)"],
                   "out of place, 1 GiB"),
    "sweep_rows": ("exp/exp_mem2.py:120", ["exp/exp_mem2.py:146 (sweep_scatter, U=64)",
                                           "exp/exp_mem2.py:176 (sweep_scatter2, U=128)",
                                           "exp/exp_mem2.py:197 (sweep_scatter_alias)"],
                   "U=64, out of place"),
    "sweep_slots": ("exp/exp_sweep2.py:62", [
        "exp/exp_sweep2.py:156 (build(k_cur), :62; build(k_i8acc), :113; "
        "build(k_f32x2), :87)"], "exp_sweep2 data, planes=8"),
    "sweep_window": ("exp/exp_sweep4.py:39", [
        "exp/exp_sweep4.py:101 (make_sweep2)",
        "exp/exp_sweep5.py:132 (sweep_call; kern :45)"], "exp_sweep5 base"),
}


def _sweep_entries(sw: dict) -> list:
    """The kernels-line entries of the four sweep kernels: the headline
    case's numbers, every case under "cases"."""
    entries = []
    for name, (replaces, calls, head) in SWEEP_KERNELS.items():
        res = sw[name]
        head = next((i for i, r in enumerate(res) if r["case"] == head), 0)
        e = _kernel_entry(
            name, f"gubernator_tpu_torch/csrc/{name}.cu", replaces, calls,
            sw["launches"][name], None,
            {**res[head], "equal": all(r["equal"] for r in res),
             "max_abs_err": max(r["max_abs_err"] for r in res)})
        e["case"] = res[head]["case"]
        e["cases"] = [{f: r[f] for f in ("case", "kernel_ms", "call_ms", "plain_ms",
                                         "library_ms", "kernel_over_library", "grid_stride_ms",
                                         "link_ms", "copy_then_compose_ms",
                                         "bound_ms", "bytes", "equal") if f in r}
                      for r in res]
        if "kernel_over_library" in res[head]:
            e["kernel_over_library"] = res[head]["kernel_over_library"]
        entries.append(e)
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=10_000_000,
                    help="live keys of the headline deployment (probe walk path)")
    ap.add_argument("--xla-keys", type=int, default=2_000_000,
                    help="keys seeded on the xla probe path")
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler traces of the decide dispatches")
    args = ap.parse_args(argv)
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # imported only now: a copy of this script without the port fails here
    import gubernator_tpu_torch  # noqa: F401

    dev = phase_device()
    k = phase_kernel(args.seed)
    fence = phase_fence_kernel(args.seed)
    exch = phase_ring_exchange_kernel(args.seed)
    main_xla, eng = phase_main(args.seed, args.xla_keys, args.profile, probe="xla")
    phase_loop(args.seed, eng, main_xla)
    del eng
    torch.cuda.empty_cache()
    main_probe, eng = phase_main(args.seed, args.keys, args.profile, probe="pallas")
    walk_k = phase_walk_kernel(args.seed, eng.table)
    ring = phase_ring(args.seed, eng)
    phase_loop(args.seed, eng, main_probe)
    service = phase_service(args.seed, eng, dev["nvidia_smi"])
    service_ring = phase_service_ring(args.seed, eng, dev["nvidia_smi"], service)
    durability = phase_durability(args.seed, eng, dev["nvidia_smi"])
    leases = phase_leases(args.seed, eng, dev["nvidia_smi"], n_keys=args.keys)
    phase_maint(args.seed, eng)
    del eng
    torch.cuda.empty_cache()
    mesh, eng = phase_mesh(args.seed, args.keys)
    phase_mesh_maint(args.seed, eng)
    mesh_daemon = phase_mesh_daemon(args.seed, eng, dev["nvidia_smi"])
    del eng
    torch.cuda.empty_cache()
    glob = phase_global(args.seed, args.keys)
    torch.cuda.empty_cache()
    tier = phase_tier(args.seed)
    phase_walk(args.seed)
    phase_parity(args.seed)
    phase_ring_parity(args.seed)
    phase_mesh_parity(args.seed)
    phase_mesh_daemon_parity(args.seed)
    phase_global_parity(args.seed)
    phase_maint_parity(args.seed)
    phase_mesh_maint_parity(args.seed)
    phase_tier_parity(args.seed)
    phase_store_parity(args.seed)
    phase_tier_plane(args.seed, dev["nvidia_smi"])
    regions = phase_regions(args.seed, dev["nvidia_smi"])
    phase_leases_parity(args.seed, dev["nvidia_smi"])
    discovery = phase_discovery(args.seed, dev["nvidia_smi"])
    phase_overload(args.seed, dev["nvidia_smi"])
    torch.cuda.empty_cache()
    phase_binaries(dev["nvidia_smi"])
    torch.cuda.empty_cache()
    sw = phase_sweeps(args.seed)
    walk = _kernel_entry(
        "probe_walk", "gubernator_tpu_torch/csrc/probe_walk.cu",
        "gubernator_tpu/ops/pallas_probe.py:299",
        ["gubernator_tpu/ops/pallas_probe.py:919"],
        main_probe["launches"]["probe_walk"], main_probe["dispatches"],
        {**walk_k["decide"],
         "equal": all(v["equal"] for v in walk_k.values())
         and all(v["equal"] for v in mesh["walk_vs_plain_at_owner_batch"].values())
         and all(v["equal"] for v in tier["walk"].values()),
         "max_abs_err": max(v["max_abs_err"] for v in (
             *walk_k.values(), *mesh["walk_vs_plain_at_owner_batch"].values(),
             *tier["walk"].values()))},
    )
    walk["mesh_owner_batch"] = mesh["walk_vs_plain_at_owner_batch"]
    walk["tier_launches"] = tier["launches"]["probe_walk"]
    walk["service_launches"] = service["runs"]["pallas"]["launches"]["probe_walk"]
    walk["service_flushes"] = service["runs"]["pallas"]["flushes"]
    walk["service_ring_launches"] = {k: service_ring["runs"][k]["launches"]["probe_walk"]
                                     for k in ("headline", "distinct")}
    walk["durability_merge_launches"] = durability["merge_launches"]
    walk["regions_merge_launches"] = regions["merge_launches"]
    walk["lease_launches"] = leases["launches"]["probe_walk"]
    walk["mesh_daemon_launches"] = mesh_daemon["run"]["launches"]["probe_walk"]
    walk["discovery_launches"] = discovery["launches"]["probe_walk"]
    walk["tier_dispatches"] = tier["dispatches"]
    walk["tier_evictees"] = tier["walk"]
    walk["bucket0_over_half_padding"] = {
        "local": walk_k["half padding, bucket 0 written"]["bucket0_ratio"],
        "mesh": mesh["walk_bucket0_over_half_padding"]}
    walk["kernels_per_pass"] = {"main_probe": main_probe["pass_kernels"],
                                "mesh": [p["kernels"] for p in mesh["profiled_passes"]]}
    walk["stages"] = {
        st: {f: v[f] for f in ("kernel_ms", "call_ms", "plain_ms",
                               "bound_ms", "rows", "written", "evicted")}
        for st, v in walk_k.items()
    }
    exch_entry = _kernel_entry(
        "ring_exchange", "gubernator_tpu_torch/csrc/ring_exchange.cu",
        "gubernator_tpu/parallel/ring.py:133", ["gubernator_tpu/parallel/ring.py:217"],
        mesh["launches"]["ring_exchange"], mesh["routed_dispatches"]["a2a"], exch)
    exch_entry.update({k: exch[k] for k in ("kernel_over_library", "back", "wide",
                                            "across_cards", "build_s")})
    # the front door's launches: the mesh daemon's headline run
    exch_entry.update(
        daemon_launches=mesh_daemon["run"]["launches"]["ring_exchange"],
        daemon_device_routed_dispatches=mesh_daemon["run"]["device_routed_dispatches"]["a2a"],
        daemon_flushes=mesh_daemon["run"]["flushes"],
        daemon_grpc_launches=mesh_daemon["daemon"]["launches"]["ring_exchange"])
    emit({"phase": "total", "script_s": time.perf_counter() - t_script})
    emit({"kernels": [
        _kernel_entry(
            "slot_write", "gubernator_tpu_torch/csrc/slot_write.cu",
            "gubernator_tpu/ops/kernel2.py:395",
            ["gubernator_tpu/ops/kernel2.py:533", "gubernator_tpu/ops/kernel2.py:616"],
            main_xla["launches"]["slot_write"], main_xla["dispatches"],
            {**k["headline_full"], "call_ms": k["headline_full"]["call_ms"]["kernel"],
             "equal": all(c["equal"] for c in k.values()),
             "max_abs_err": max(c["max_abs_err"] for c in k.values()),
             "library_call": "flat.index_copy_(0, kept targets, kept packed rows)"})
        | {"timer": k["headline_full"]["timer"], "case": "headline_full",
           "first_design_ms": k["headline_full"]["first_ms"],
           "insitu_us_main": main_xla["slot_write_us_per_launch"],
           "decide_ms_main": {k: main_xla["decide_write_turns"][k]
                              for k in ("median_kernel", "median_first", "kernel_wins")},
           "pass_kernels_main": main_xla["pass_kernels"],
           "cases": [{f: c[f] for f in ("case", "layout", "rows", "kept", "equal",
                                        "designs_equal", "cold_ms", "insitu_ms",
                                        "l2_warm_ms", "call_ms", "bound_ms", "floor_ms")}
                     for c in k.values()],
           "global_sync_launches_per_round": glob["single_round"]["slot_write"],
           "global_drain_launches": glob["drain"]["slot_write"],
           "global_drain_rounds": glob["drain"]["R"],
           "tier_launches": tier["launches"]["slot_write"],
           "service_launches": service["runs"]["xla"]["launches"]["slot_write"],
           "service_flushes": service["runs"]["xla"]["flushes"],
           "lease_launches": leases["launches"]["slot_write"],
           "discovery_launches": discovery["launches"]["slot_write"]},
        walk,
        _kernel_entry(
            "fence_claim", "gubernator_tpu_torch/csrc/fence_claim.cu",
            "gubernator_tpu/ops/ring_drain.py:198",
            ["gubernator_tpu/ops/ring_drain.py:257"],
            ring["launches"]["fence_claim"], ring["drains"],
            {**fence, "call_ms": fence["call_ms"]["kernel"]})
        | {"kernel_over_library": fence["kernel_over_library"],
           "service_ring_launches": {k: service_ring["runs"][k]["launches"]["fence_claim"]
                                     for k in ("headline", "distinct")},
           "service_ring_drains": {k: service_ring["runs"][k]["drains"]
                                   for k in ("headline", "distinct")}},
        *_sweep_entries(sw),
        exch_entry,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
