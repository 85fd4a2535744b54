#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (gubernator_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed N] [--keys N] [--profile DIR]

It builds the port's kernels from the sources in the checkout and drives the
port's main path, printing one JSON line per phase:

1. ``device`` — the card (``nvidia-smi`` name and power limit) and the build;
2. ``kernel`` — each kernel against its plain PyTorch version at the main
   path's shapes (byte-equal), with CUDA-event medians for the kernel, the
   plain version and one library call that computes the same function;
3. ``main`` — the headline deployment (BASELINE.json: checks/sec/chip at
   10M live keys): ``LocalEngine(capacity=2**24)`` seeded with 10M keys in
   2^17-row ``check_columns`` batches (token bucket, 1 h), the live count
   held against its exact host-side value, one timed steady-state pass, and
   the check() recipe (limit 3 → remaining 2, 1, 0, then OVER_LIMIT). Launch
   counts are zeroed just before and read just after this phase;
4. ``parity`` — contended mixed-algorithm batches decided on the card and,
   with the same port, on the CPU: responses, stats and table bytes equal.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a card, or if any phase fails, it
exits nonzero and prints no result.
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
    builds = _build.build_all(["slot_write"])
    wall = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in builds["slot_write"]["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    info = {
        "phase": "device", "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": wall,
        "builds": {k: v["seconds"] for k, v in builds.items()},
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


def phase_main(seed: int, n_keys: int, profile_dir, device: str = "cuda",
               capacity: int = 1 << 24, batch: int = 1 << 17) -> dict:
    from gubernator_tpu_torch import RateLimitRequest, Status
    from gubernator_tpu_torch.ops.batch import (
        ERR_DROPPED, pack_columns, pack_host_batch, pad_batch,
    )
    from gubernator_tpu_torch.ops.engine import LocalEngine
    from gubernator_tpu_torch.ops.kernel2 import decide2_packed_cols
    from gubernator_tpu_torch.ops.plan import plan_passes
    from gubernator_tpu_torch.ops.slot_write import slot_write

    rng = np.random.default_rng(seed)
    fps = np.unique(rng.integers(1, 2**63 - 1, int(n_keys * 1.001) + 16, dtype=np.int64))
    fps = rng.permutation(fps)[:n_keys]

    eng = LocalEngine(capacity=capacity, device=device)
    nb = eng.table.n_buckets
    slot_write.launches = 0  # counts from here on are the main path's
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
    launches = slot_write.launches
    dispatches = eng.stats.dispatches

    # the decide dispatch alone, on a staged ingress grid (CUDA events)
    hb, _ = pack_columns(_token_cols(fps[:batch], hits=0), NOW + 2_000)
    (p,) = plan_passes(hb)
    grid = torch.from_numpy(pack_host_batch(pad_batch(p.batch, batch))).to(eng.device)
    decide = lambda: decide2_packed_cols(eng.table, grid, write=eng.write_mode, math="token")
    decide_ms = cuda_ms(decide, reps=7, inner=3)
    decide_device_ms = device_ms(decide, calls=5)
    if profile_dir is not None:
        _profile(eng, grid, profile_dir)

    med = statistics.median(pass_s)
    info = {
        "phase": "main", "card": torch.cuda.get_device_name(0),
        "capacity": eng.table.capacity, "buckets": nb,
        "table_bytes": eng.table.rows.numel() * 4, "keys": n_keys, "batch": batch,
        "write_mode": eng.write_mode, "seed_s": seed_s,
        "seed_dispatches": seed_dispatches, "seed_keys_per_s": n_keys / seed_s,
        "persisted": int(persisted.sum()), "live": live, "expected_live": expect_live,
        "dropped": eng.stats.dropped, "evicted_unexpired": eng.stats.evicted_unexpired,
        "wrong_rows": wrong, "steady_wrong_rows": steady_wrong,
        "steady_pass_s": pass_s, "steady_decisions_per_s": batch / med,
        "decide_ms": decide_ms, "decide_device_ms": decide_device_ms, "recipe": [[x.status, x.remaining] for x in recipe],
        "launches": {"slot_write": launches}, "dispatches": dispatches,
        "launches_per_dispatch": launches / max(dispatches, 1),
    }
    emit(info)
    if wrong or steady_wrong:
        raise SystemExit(f"wrong responses on the main path: {wrong} + {steady_wrong}")
    if live != expect_live:
        raise SystemExit(f"live count {live} != expected {expect_live}")
    if not recipe_ok:
        raise SystemExit(f"check() recipe failed: {info['recipe']}")
    if launches < dispatches:
        raise SystemExit(f"slot_write launched {launches} times for {dispatches} dispatches")
    return info


def _profile(eng, grid, out_dir) -> None:
    """torch.profiler over a few decide dispatches: device time by kernel,
    written to out_dir/profile_decide.json (and a chrome trace beside it)."""
    from torch.profiler import ProfilerActivity, profile

    from gubernator_tpu_torch.ops.kernel2 import decide2_packed_cols

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            decide2_packed_cols(eng.table, grid, write=eng.write_mode, math="token")
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace_decide.json"))
    rows = [{"name": ev.key[:120], "calls": ev.count, "device_us": _dev_us(ev)}
            for ev in prof.key_averages() if _is_kernel(ev)]
    rows.sort(key=lambda r: -r["device_us"])
    (out / "profile_decide.json").write_text(json.dumps(rows, indent=1))
    emit({"phase": "profile", "dispatches": 3,
          "device_us_per_dispatch": sum(r["device_us"] for r in rows) / 3,
          "kernels_per_dispatch": sum(r["calls"] for r in rows) / 3,
          "top": rows[:10]})


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


def phase_parity(seed: int, device: str = "cuda") -> dict:
    from gubernator_tpu_torch.ops.engine import LocalEngine

    rng = np.random.default_rng(seed + 1)
    gpu = LocalEngine(capacity=1 << 20, device=device)
    cpu = LocalEngine(capacity=1 << 20, device="cpu")
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
                raise SystemExit(f"card and CPU disagree on {f} at step {step}")
        if gpu.snapshot().tobytes() != cpu.snapshot().tobytes():
            raise SystemExit(f"card and CPU tables differ after step {step}")
        rows += 4096
        now += int(rng.integers(0, 3_000))
    sa, sb = dataclasses.asdict(gpu.stats), dataclasses.asdict(cpu.stats)
    if sa != sb:
        raise SystemExit(f"card and CPU stats differ: {sa} vs {sb}")
    info = {"phase": "parity", "rows": rows, "capacity": gpu.table.capacity,
            "equal": True, "stats": sa}
    emit(info)
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=10_000_000)
    ap.add_argument("--profile", default=None,
                    help="directory for a torch.profiler trace of the decide dispatch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # imported only now: a copy of this script without the port fails here
    import gubernator_tpu_torch  # noqa: F401

    dev = phase_device()
    k = phase_kernel(args.seed)
    main_info = phase_main(args.seed, args.keys, args.profile)
    phase_parity(args.seed)
    emit({"kernels": [{
        "name": "slot_write", "route": "cuda",
        "source": "gubernator_tpu_torch/csrc/slot_write.cu",
        "replaces": "gubernator_tpu/ops/kernel2.py:395",
        "replaces_calls": ["gubernator_tpu/ops/kernel2.py:533",
                           "gubernator_tpu/ops/kernel2.py:616"],
        "launches": main_info["launches"]["slot_write"],
        "dispatches": main_info["dispatches"],
        "equal": k["equal"], "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
        "call_ms": k["call_ms"]["kernel"],
        "bound_ms": k["bound_ms"], "bound_by": "bytes", "library_ms": k["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
