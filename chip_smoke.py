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
   at the main path's shapes (byte-equal), with CUDA-event and profiler
   times for the kernel, the plain version and one library call that
   computes the same function;
3. ``main`` — the decide path with the XLA-style probe
   (``LocalEngine(capacity=2**24)``, gather + sort-based claim +
   slot_write), seeded with ``--xla-keys`` keys (2M by default) in
   2^17-row ``check_columns`` batches (token bucket, 1 h), the live count
   held against its exact host-side value, timed steady passes and the
   check() recipe (limit 3 → remaining 2, 1, 0, then OVER_LIMIT);
4. ``main_probe`` — the headline deployment (BASELINE.json: checks/sec/chip
   at 10M live keys) through ``LocalEngine(capacity=2**24,
   probe="pallas")``: the fused probe walk, 10M keys seeded, steady passes,
   the recipe, every response checked and the exact live count; the
   decide dispatch alone timed, with its device-time split by kernel;
5. ``kernel`` (probe_walk) — the walk kernel against its plain version on
   the same CUDA tensors at the headline shapes, for its three stages, on
   the 10M-key table of phase 4: decide (all five algorithms, math
   "mixed"), install (half the keys held by the table) and merge (live
   rows decoded from the table, half of them re-keyed, evictees on).
   Responses and table bytes must be equal;
6. ``walk`` — ``install_columns`` and ``merge_rows`` (also
   ``collect=True``) with ``walk="pallas"`` on the card against the same
   engine on the CPU, on contended mixed-algorithm rows: byte-equal;
7. ``parity`` — contended mixed-algorithm ``check_columns`` batches on the
   card and on the CPU, for ``probe="xla"`` and ``probe="pallas"``:
   responses, stats and table bytes equal.

Each kernel's launch count is zeroed just before the phase that drives its
path (3 for slot_write, 4 for probe_walk) and read just after. The line
before the last is ``{"kernels": [...]}``; the last is ``{"ok": true,
"device": {...}}``. Without a card, or if any phase fails, it exits nonzero
and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    """Median per-call time of `fn` on the card, from CUDA events around
    `inner` back-to-back calls, over `reps` repeats (after one warm call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _is_kernel(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


def _dev_us(ev) -> float:
    v = getattr(ev, "self_device_time_total", None)
    return v if v is not None else getattr(ev, "self_cuda_time_total", 0)


def device_ms(fn, calls: int = 20) -> float:
    """Device time per call of `fn`: the summed time of the kernels it ran,
    from torch.profiler's CUDA activity over `calls` calls (after one warm
    call). Unlike cuda_ms this excludes the host's launch overhead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(_dev_us(ev) for ev in prof.key_averages() if _is_kernel(ev))
    return us / calls / 1e3


def phase_device() -> dict:
    from gubernator_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    builds = _build.build_all(list(_build.KERNELS))
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


def phase_kernel(seed: int, device: str = "cuda", nb: int = 1 << 21) -> dict:
    """slot_write against slot_write_ref on the card; returns the headline
    case's measurements."""
    from gubernator_tpu_torch.ops.slot_write import slot_write, slot_write_ref

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k = 8
    cases = [
        ("headline_full", 16, 1 << 17, 0.0),
        ("headline_packed", 8, 1 << 17, 0.0),
        ("ragged_sentinels", 16, 100_003, 0.1),
    ]
    results = {}
    for name, fl, n, sentinel in cases:
        base = torch.randint(-(2**31), 2**31 - 1, (nb, k * fl), dtype=torch.int32,
                             device=dev, generator=gen)
        payload = torch.randint(-(2**31), 2**31 - 1, (n, fl), dtype=torch.int32,
                                device=dev, generator=gen)
        target = torch.randperm(nb * k, device=dev, generator=gen)[:n].to(torch.int32)
        drop = torch.rand(n, device=dev, generator=gen) < sentinel
        target = torch.where(drop, torch.full_like(target, nb * k), target).contiguous()
        got, want = base.clone(), base.clone()
        slot_write(got, payload, target)
        slot_write_ref(want, payload, target)
        torch.cuda.synchronize()
        diff = got != want
        max_err = int((got[diff].to(torch.int64) - want[diff].to(torch.int64)).abs().max()) \
            if bool(diff.any()) else 0
        equal = bool(torch.equal(got, want))
        kept = target < nb * k
        n_kept = int(kept.sum())
        idx_k, pay_k = target[kept].to(torch.int64), payload[kept].contiguous()
        flat = got.view(-1, fl)
        calls = {
            "kernel": lambda: slot_write(got, payload, target),
            "plain": lambda: slot_write_ref(want, payload, target),
            "library": lambda: flat.index_copy_(0, idx_k, pay_k),
        }
        # device time (profiler) is the kernel's own cost; call time (CUDA
        # events around back-to-back calls) adds the host's launch overhead
        dev_ms = {k: device_ms(f) for k, f in calls.items()}
        call_ms = {k: cuda_ms(f) for k, f in calls.items()}
        # bytes the function must move: every target read, each kept payload
        # row read once and each kept slot written once
        nbytes = n * 4 + n_kept * fl * 4 * 2
        res = {
            "case": name, "fl": fl, "rows": n, "kept": n_kept,
            "table_bytes": nb * k * fl * 4, "equal": equal, "max_abs_err": max_err,
            "kernel_ms": dev_ms["kernel"], "plain_ms": dev_ms["plain"],
            "library_ms": dev_ms["library"], "call_ms": call_ms,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        results[name] = res
        emit({"phase": "kernel", "name": "slot_write", **res})
        del base, got, want, payload, target, flat, idx_k, pay_k
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if not equal:
            raise SystemExit(f"slot_write disagrees with its plain version ({name})")
    return results["headline_full"]


def _token_cols(fp: np.ndarray, hits: int = 1):
    from gubernator_tpu_torch.ops.batch import RequestColumns

    n = fp.shape[0]
    return RequestColumns(
        fp=fp, algo=np.zeros(n, np.int32), behavior=np.zeros(n, np.int32),
        hits=np.full(n, hits, np.int64), limit=np.full(n, 100, np.int64),
        burst=np.zeros(n, np.int64), duration=np.full(n, 3_600_000, np.int64),
        created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8),
    )


def _launch_counts() -> dict:
    from gubernator_tpu_torch.ops.probe_walk import probe_walk
    from gubernator_tpu_torch.ops.slot_write import slot_write

    return {"slot_write": slot_write.launches, "probe_walk": probe_walk.launches}


def _zero_launch_counts() -> None:
    from gubernator_tpu_torch.ops.probe_walk import probe_walk
    from gubernator_tpu_torch.ops.slot_write import slot_write

    slot_write.launches = 0
    probe_walk.launches = 0


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
    decide_device_ms = device_ms(decide, calls=5)
    split = _kernel_split(decide, calls=3, out_dir=profile_dir, tag=f"decide_{probe}")

    med = statistics.median(pass_s)
    info = {
        "phase": "main" if probe == "xla" else "main_probe", "probe": probe,
        "card": torch.cuda.get_device_name(0),
        "capacity": eng.table.capacity, "buckets": nb,
        "table_bytes": eng.table.rows.numel() * 4, "keys": n_keys, "batch": batch,
        "write_mode": eng.write_mode, "seed_s": seed_s,
        "seed_dispatches": seed_dispatches, "seed_keys_per_s": n_keys / seed_s,
        "persisted": int(persisted.sum()), "live": live, "expected_live": expect_live,
        "dropped": eng.stats.dropped, "evicted_unexpired": eng.stats.evicted_unexpired,
        "wrong_rows": wrong, "steady_wrong_rows": steady_wrong,
        "steady_pass_s": pass_s, "steady_decisions_per_s": batch / med,
        "decide_ms": decide_ms, "decide_device_ms": decide_device_ms,
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
    if probe == "xla":
        if launches["slot_write"] < dispatches or launches["probe_walk"]:
            raise SystemExit(f"xla path launches {launches} for {dispatches} dispatches")
    elif launches["probe_walk"] != dispatches or launches["slot_write"]:
        raise SystemExit(f"pallas path launches {launches} for {dispatches} dispatches")
    return info, eng


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
               ingress_bytes):
    """One stage of probe_walk against its plain version on the same CUDA
    inputs, from the same table bytes; then the times and the bound."""
    from gubernator_tpu_torch.ops.probe_walk import (
        OC_WRITTEN, OUTW, OUTW_EV, probe_walk, probe_walk_ref,
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
    split = _kernel_split(call, calls=5)
    kernel_us = sum(r["device_us"] for r in split["top"] if "probe_walk_kernel" in r["name"])
    plain = lambda: probe_walk_ref(got_rows, layout, stage, fp, now, active, **kw)
    nbytes = _walk_bytes(fp, NB, layout, written, ingress_bytes,
                         OUTW_EV if evictees else OUTW)
    res = {
        "stage": stage, "case": name, "rows": int(fp.shape[0]), "buckets": NB,
        "written": written, "evicted": evicted,
        "equal": equal_resp and equal_rows, "equal_responses": equal_resp,
        "equal_table": equal_rows, "max_abs_err": err,
        "kernel_ms": kernel_us / 1e3, "walk_device_ms": split["device_us"] / 1e3,
        "walk_kernels": split["kernels"], "call_ms": cuda_ms(call, reps=7, inner=3),
        "plain_ms": device_ms(plain, calls=3), "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "split": split["top"][:6],
    }
    emit({"phase": "kernel", "name": "probe_walk", **res})
    del got_rows
    if not res["equal"]:
        raise SystemExit(f"probe_walk disagrees with its plain version ({stage})")
    return res


def phase_walk_kernel(seed: int, table, batch: int = 1 << 17) -> dict:
    """probe_walk against probe_walk_ref on the card at the headline shapes,
    on a copy of the seeded table, for decide, install and merge."""
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
        False, ingress_bytes=batch * (9 * 8 + 2 * 4 + 1))

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
            ingress_bytes=batch * (9 * 8 + 2 * 4 + 1))

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
        False, ingress_bytes=batch * (8 + 8 + 1 + 64))

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
        rows16.contiguous(), "mixed", True, ingress_bytes=batch * (8 + 8 + 1 + 64))
    del slots, held, rows16
    torch.cuda.empty_cache()
    return results


def _mixed_cols(rng, n: int, nb: int, pool: np.ndarray):
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
    from gubernator_tpu_torch.ops.engine import LocalEngine

    info = {"phase": "parity", "capacity": capacity, "equal": True}
    for probe in ("xla", "pallas"):
        rng = np.random.default_rng(seed + 1)
        gpu = LocalEngine(capacity=capacity, device=device, probe=probe)
        cpu = LocalEngine(capacity=capacity, device="cpu", probe=probe)
        nb = gpu.table.n_buckets
        pool = rng.integers(1, 2**63 - 1, 20_000, dtype=np.int64)
        now = NOW
        rows = 0
        for step in range(5):
            cols = _mixed_cols(rng, 4096, nb, pool)
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
        info[probe] = {"rows": rows, "stats": sa}
    emit(info)
    return info


def _kernel_entry(name, source, replaces, calls, launches, dispatches, k) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "replaces_calls": calls, "launches": launches, "dispatches": dispatches,
        "equal": k["equal"], "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
        "call_ms": k["call_ms"],
        "bound_ms": k["bound_ms"], "bound_by": "bytes", "library_ms": k.get("library_ms"),
    }


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
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # imported only now: a copy of this script without the port fails here
    import gubernator_tpu_torch  # noqa: F401

    dev = phase_device()
    k = phase_kernel(args.seed)
    main_xla, eng = phase_main(args.seed, args.xla_keys, args.profile, probe="xla")
    del eng
    torch.cuda.empty_cache()
    main_probe, eng = phase_main(args.seed, args.keys, args.profile, probe="pallas")
    walk_k = phase_walk_kernel(args.seed, eng.table)
    del eng
    torch.cuda.empty_cache()
    phase_walk(args.seed)
    phase_parity(args.seed)
    walk = _kernel_entry(
        "probe_walk", "gubernator_tpu_torch/csrc/probe_walk.cu",
        "gubernator_tpu/ops/pallas_probe.py:299",
        ["gubernator_tpu/ops/pallas_probe.py:919"],
        main_probe["launches"]["probe_walk"], main_probe["dispatches"],
        {**walk_k["decide"], "equal": all(v["equal"] for v in walk_k.values()),
         "max_abs_err": max(v["max_abs_err"] for v in walk_k.values())},
    )
    walk["stages"] = {
        st: {f: v[f] for f in ("kernel_ms", "walk_device_ms", "call_ms", "plain_ms",
                               "bound_ms", "rows", "written", "evicted")}
        for st, v in walk_k.items()
    }
    emit({"kernels": [
        _kernel_entry(
            "slot_write", "gubernator_tpu_torch/csrc/slot_write.cu",
            "gubernator_tpu/ops/kernel2.py:395",
            ["gubernator_tpu/ops/kernel2.py:533", "gubernator_tpu/ops/kernel2.py:616"],
            main_xla["launches"]["slot_write"], main_xla["dispatches"],
            {**k, "call_ms": k["call_ms"]["kernel"]}),
        walk,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
