"""One run of one cell: the deployment seeded, the daemon spawned at its
default knobs, warm-up, the measured window through the front door, and
the judgement of every answer the window's requests received.

The window drives ``Daemon.get_rate_limits_raw`` (the gRPC handler's call
on the raw GetRateLimitsReq bytes) from closed-loop submitters on the
daemon's own asyncio loop: each awaits its answer, then sends its next
pre-made request. The clock the daemon reads is an input: frozen at the
seed time while the table is seeded, then at the window's time.
"""

from __future__ import annotations

import asyncio
import contextvars
import sys
import time
from typing import Dict, Optional

import numpy as np

from benchmark import generator
from benchmark.reference import keyhash, limiter, respwire

STAGES = ("parse", "queue_wait", "put", "issue", "fetch", "encode")
BASE_MS = 1_700_000_000_000
READ_CHUNK = 1 << 20  # keys a state read-back call gathers
UNHIT_SAMPLE = 1 << 16  # keys of closed buckets the window never hit, read back


class RunFailed(RuntimeError):
    """The run cannot report: its window ran out of requests."""


def clock_for(cfg: dict, seed: int) -> limiter.Clock:
    ts = BASE_MS + (int(seed) % 1_000_000) * 1_000
    return limiter.Clock(ts=ts, t1=ts + int(cfg["window_after_seed_ms"]))


def _point_clock(now: list):
    """Point the daemon's clock (``ms_now`` of the engine, the batcher and
    the daemon) at now[0]; returns the undo."""
    from gubernator_tpu_torch.ops import engine as engine_mod
    from gubernator_tpu_torch.service import batcher as batcher_mod
    from gubernator_tpu_torch.service import daemon as daemon_mod

    mods = (engine_mod, batcher_mod, daemon_mod)
    saved = [m.ms_now for m in mods]
    for m in mods:
        m.ms_now = lambda: now[0]

    def undo():
        for m, f in zip(mods, saved):
            m.ms_now = f

    return undo


def _stage_sums(d) -> Dict[str, tuple]:
    out = {}
    for fam in d.metrics.stage_duration.collect():
        for s in fam.samples:
            st = s.labels.get("stage")
            c, t = out.get(st, (0.0, 0.0))
            if s.name.endswith("_count"):
                c = s.value
            elif s.name.endswith("_sum"):
                t = s.value
            out[st] = (c, t)
    return out


def _counters(d) -> dict:
    b, st = d.batcher, d.engine.stats
    return {
        "flushes": b.fused_dispatches + b.column_dispatches + b.ring_dispatches,
        "fused_flushes": b.fused_dispatches,
        "column_flushes": b.column_dispatches,
        "dispatches": st.dispatches,
        "dropped": st.dropped,
        "evicted_unexpired": st.evicted_unexpired,
        "stages": _stage_sums(d),
    }


def _delta(a: dict, b: dict) -> dict:
    out = {k: b[k] - a[k] for k in a if k != "stages"}
    out["stages"] = {s: (b["stages"].get(s, (0, 0))[0] - a["stages"].get(s, (0, 0))[0],
                         b["stages"].get(s, (0, 0))[1] - a["stages"].get(s, (0, 0))[1])
                     for s in STAGES}
    return out


async def _drain_engine(d) -> None:
    """Let the engine thread fold the stats of finished dispatches."""
    await asyncio.get_running_loop().run_in_executor(d.runner._exec, lambda: None)


async def _drive(d, reqs, submitters: int, seconds: float, cycle: bool = False,
                 flushes: Optional[FlushLog] = None):
    """Closed-loop submitters over `reqs` in order for `seconds` (over and
    over with `cycle`); returns send and done times, answers, the window's
    open and close, whether the requests ran out, and the counters at open
    and after the last answer."""
    if cycle:
        reqs = _Cycle(reqs)
    n = len(reqs)
    sent, done, outs = [], [], []
    state = {"next": 0, "ran_out": False, "errors": 0}
    await _drain_engine(d)
    c0 = _counters(d)
    cpu0 = time.process_time()
    t_open = time.perf_counter()
    t_close = t_open + seconds

    async def submitter():
        while time.perf_counter() < t_close:
            i = state["next"]
            if i >= n:
                state["ran_out"] = True
                return
            state["next"] = i + 1
            if flushes is not None:
                flushes.request.set(i)
            sent.append(time.perf_counter())
            done.append(0.0)
            outs.append(None)
            try:
                outs[i] = await d.get_rate_limits_raw(reqs[i])
            except Exception:  # an unanswered request is judged as missing
                state["errors"] += 1
            done[i] = time.perf_counter()

    if flushes is not None:
        flushes.recording = True
    await asyncio.gather(*(submitter() for _ in range(submitters)))
    if flushes is not None:
        flushes.recording = False
    cpu1 = time.process_time()
    await _drain_engine(d)
    c1 = _counters(d)
    return {"sent": np.array(sent), "done": np.array(done), "outs": outs, "t_open": t_open,
            "t_close": t_close, "ran_out": state["ran_out"], "errors": state["errors"],
            "counters": _delta(c0, c1),
            "process_cpu_s": cpu1 - cpu0}


class _Cycle:
    """A request pool read over and over, as long as a window can use."""

    def __init__(self, reqs):
        self.reqs = reqs

    def __len__(self):
        return 1 << 40

    def __getitem__(self, i):
        return self.reqs[i % len(self.reqs)]


class FlushLog:
    """Which window requests each flush of the batcher carried, in its
    order: the judge holds a key's rows in one flush to the configuration's
    rule (its first rows there answered one at a time). The submitter
    names its request in a context variable; the batcher's enqueue
    (``check``) notes each payload's request, and its flush (``_dispatch``)
    the requests of its chunk, in the order it concatenates them."""

    def __init__(self, d):
        b = d.batcher
        if not (callable(getattr(b, "check", None)) and callable(getattr(b, "_dispatch", None))):
            raise RuntimeError("the batcher has no check/_dispatch to record flushes by")
        self.request = contextvars.ContextVar("bench_request", default=-1)
        self.flushes = []
        self.recording = False
        self._by_rows = {}
        check, dispatch = b.check, b._dispatch

        def rows_of(payload):
            return id(getattr(payload, "cols", payload).fp)

        async def check_logged(payload, *a, **k):
            if self.recording:
                self._by_rows[rows_of(payload)] = self.request.get()
            return await check(payload, *a, **k)

        async def dispatch_logged(batch):
            if self.recording:
                self.flushes.append([self._by_rows.pop(rows_of(e.payload), -1) for e in batch])
            return await dispatch(batch)

        b.check, b._dispatch = check_logged, dispatch_logged
        self._undo = lambda: (delattr(b, "check"), delattr(b, "_dispatch"))

    def close(self):
        self._undo()

    def of_requests(self, n: int):
        """(flush, place in the flush) of each of the first `n` requests;
        -1 where no flush carried one."""
        flush = np.full(n, -1, np.int64)
        place = np.full(n, -1, np.int64)
        for f, reqs in enumerate(self.flushes):
            for p, r in enumerate(reqs):
                if 0 <= r < n:
                    flush[r], place[r] = f, p
        return flush, place


def _hook_stages(d, sl) -> None:
    """Record each host stage's interval into the slice while it is open
    (the daemon's own stage observations, timed where the program times
    them)."""
    run_obs, req_obs = d.runner._observe_stage, d._observe_request_stage

    def observe_stage(stage, t0, span):
        sl.stage(stage, t0, time.perf_counter())
        return run_obs(stage, t0, span)

    def observe_request_stage(stage, dt_s, span):
        t1 = time.perf_counter()
        sl.stage(stage, t1 - dt_s, t1)
        return req_obs(stage, dt_s, span)

    d.runner._observe_stage = observe_stage
    d._observe_request_stage = observe_request_stage

    def undo():
        d.runner._observe_stage = run_obs
        d._observe_request_stage = req_obs

    return undo


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             t_start: float, device: Optional[str] = None, log=None,
             stages: bool = True) -> dict:
    """Run one cell once. `t_start` is the process's start on the
    perf_counter clock. `device` None means the card. Returns the window's
    numbers, the profiled slice (with `trace`; its idle gaps labelled by
    the host stages with `stages`) and the judgement."""
    import torch

    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.service.daemon import Daemon
    from gubernator_tpu_torch.service.wire import wire_batch_from_wire

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    on_card = device is None
    clock = clock_for(cfg, seed)
    log(f"set-up: program imported at {time.perf_counter() - t_start:.2f} s")
    inp = generator.Inputs(cfg, traffic, seed, seconds)
    log(f"inputs: {len(inp.seed_reqs)} seed buffers, {len(inp.warm_reqs)} warm and "
        f"{len(inp.window_reqs)} window requests of {inp.per_request} items")
    now = [clock.ts - 60_000]
    undo_clock = _point_clock(now)
    loop = asyncio.new_event_loop()
    d = None
    try:
        conf = DaemonConfig(grpc_address="127.0.0.1:0", http_address="",
                            cache_size=int(cfg["slots"]))
        t_phase = time.perf_counter()
        log(f"set-up: inputs made at {t_phase - t_start:.2f} s")
        d = loop.run_until_complete(Daemon.spawn(conf, device=device))
        log(f"set-up: daemon spawned in {time.perf_counter() - t_phase:.2f} s")
        t_phase = time.perf_counter()
        now[0] = clock.ts
        seed_errors = 0
        for buf in inp.seed_reqs:
            cols = wire_batch_from_wire(buf)[0].cols
            rc = loop.run_until_complete(d.runner.check_columns(cols))
            seed_errors += int((np.asarray(rc.err) != 0).sum())
        log(f"set-up: table seeded in {time.perf_counter() - t_phase:.2f} s")
        t_phase = time.perf_counter()
        now[0] = clock.t1
        warm = loop.run_until_complete(
            _drive(d, inp.warm_reqs, int(traffic["submitters"]), float(traffic["warm_s"]),
                   cycle=True))
        if on_card:
            torch.cuda.synchronize()
        log(f"set-up: warmed up in {time.perf_counter() - t_phase:.2f} s "
            f"({len(warm['outs'])} requests)")
        sl = None
        if trace:
            from benchmark.devtrace import Slice

            sl = Slice()
            sl.warm()
        setup_s = time.perf_counter() - t_start
        flush_log = FlushLog(d)
        undo_hooks = _hook_stages(d, sl) if sl is not None and stages else (lambda: None)
        if sl is not None:
            sl.start()
        w = loop.run_until_complete(
            _drive(d, inp.window_reqs, int(traffic["submitters"]), seconds, flushes=flush_log))
        if sl is not None:
            sl.stop()
        undo_hooks()
        flush_log.close()
        w["flush"], w["place"] = flush_log.of_requests(len(w["outs"]))
        if w["ran_out"]:
            raise RunFailed(f"the window ran out of its {len(inp.window_reqs)} requests")
        log(f"window: {len(w['outs'])} requests sent in {seconds} s")
        mem_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
        tr = None
        if sl is not None:
            from benchmark.devtrace import MARKS, reduce

            events = sl.events()
            tr = reduce(events, sl.anchors, sl.stages)
            if tr is None:
                marks = [e for e in events if any(m in e["name"] for m in MARKS)]
                log(f"trace: no reading: {len(events)} device events, {len(marks)} markers "
                    f"of {len(sl.anchors)} launched, first {events[:1]}, last {events[-1:]}")
            if tr is not None:
                tr["counters"] = w["counters"]
                ids = inp.window_ids[: len(w["outs"])]
                tr["items"] = int(ids.size)
                tr["distinct_keys"] = int(np.unique(ids).size)
        t_phase = time.perf_counter()
        judged = _judge(loop, d, cfg, clock, inp, w, seed_errors)
        log(f"reference: judged in {time.perf_counter() - t_phase:.2f} s")
    finally:
        if d is not None:
            loop.run_until_complete(d.close())
        loop.close()
        undo_clock()
    return {"window": w, "setup_s": setup_s, "seconds": seconds, "trace": tr, "judged": judged, "memory_peak_bytes": mem_peak,
            "per_request": inp.per_request}


def _judge(loop, d, cfg, clock, inp, w, seed_errors: int) -> dict:
    """Every answer of every request the window sent, and the state the
    run left, against the reference."""
    n_keys = int(cfg["keys"])
    per = inp.per_request
    outs = w["outs"]
    have = [i for i, o in enumerate(outs) if o is not None]
    ans = respwire.decode([outs[i] for i in have])
    full = np.zeros(len(outs), bool)
    full[np.array(have, np.int64)[ans.items == per]] = True
    missing = int((~full).sum()) * per
    keep = np.repeat(ans.items == per, ans.items)
    ans = respwire.Answers(*(c[keep] for c in ans[:5]), ans.items, ans.malformed)
    # items each request had answered without an error
    answered = np.zeros(len(outs), np.int64)
    answered[full] = per - ans.error.reshape(-1, per).sum(axis=1)
    kid = inp.window_ids[: len(outs)][full].reshape(-1)
    flat = (np.nonzero(full)[0][:, None] * per + np.arange(per)).reshape(-1)
    hits = inp.hits_of(flat)
    flush = np.repeat(w["flush"][full], per)
    pos = np.repeat(w["place"][full], per) * per + np.tile(np.arange(per), int(full.sum()))
    fps = keyhash.fingerprints(generator.hash_keys(inp.name, np.arange(n_keys)))
    nb = keyhash.n_buckets_for(int(cfg["slots"]))
    closed = limiter.closed_keys(fps, nb)
    seed = limiter.seeded(cfg, clock, inp.seed_hits, inp.leaky)
    j = limiter.judge(cfg, clock, kid, ans, seed, closed, hits, flush, pos)
    wrong = j["wrong"]
    # the state the run left: every closed key the window hit, and a
    # sample of closed keys it never hit
    cl_rows = closed[kid]
    keys, end, end_f = limiter.final_state(cfg, kid[cl_rows],
                                           respwire.Answers(*(c[cl_rows] for c in ans[:5]),
                                                            ans.items, 0), seed)
    untouched = np.setdiff1d(np.nonzero(closed)[0], keys)
    rng = generator.rng_for(inp.seed, "unhit")
    sample = rng.choice(untouched, min(UNHIT_SAMPLE, untouched.size), replace=False)
    read_keys = np.concatenate([keys, sample])
    found = np.zeros(read_keys.size, bool)
    slots = np.zeros((read_keys.size, 16), np.int32)
    for i in range(0, read_keys.size, READ_CHUNK):
        f, s = loop.run_until_complete(d.runner.read_state(fps[read_keys[i:i + READ_CHUNK]]))
        found[i:i + READ_CHUNK] = f
        slots[i:i + READ_CHUNK] = s
    state_wrong = _state_mismatch(cfg, clock, seed, read_keys, keys.size, end, end_f,
                                 found, slots)
    return {
        "rows": int(kid.size), "missing_rows": missing, "malformed": int(ans.malformed),
        "wrong_rows": int(wrong.sum()), "closed_rows": j["closed_rows"],
        "overflow_rows": j["overflow_rows"], "error_rows": int(ans.error.sum()),
        "state_keys": int(read_keys.size), "state_wrong": int(state_wrong),
        "seed_errors": int(seed_errors),
        "over_limit_rows": int((ans.status == 1).sum()),
        "request_errors": int(w["errors"]),
        "unflushed_requests": int((w["flush"][full] < 0).sum()),
        "answered": answered,
    }


def _state_mismatch(cfg, clock, seed, read_keys, n_hit, end, end_f, found, slots) -> int:
    """Keys whose stored state is not where the reference's chain ends
    (hit keys) or as seeded (the unhit sample). The canonical slot's
    fields: limit 2, integer remaining 4, expiry 10-11, the leaky float
    remaining as an f32 pair 12-13."""
    limit, dur = int(cfg["limit"]), int(cfg["duration_ms"])
    exp = (slots[:, 11].astype(np.int64) << 32) | (slots[:, 10].astype(np.int64) & 0xFFFFFFFF)
    bad = ~found | (slots[:, 2] != limit)
    hit = np.arange(read_keys.size) < n_hit
    lk = seed.leaky[read_keys]
    # token buckets: the integer remaining, the seeded expiry
    want = np.concatenate([end, seed.rem[read_keys[n_hit:]]])
    bad |= ~lk & ((slots[:, 4] != want) | (exp != seed.expiry[read_keys]))
    # leaky buckets: the float remaining; a hit moves the expiry
    rem_f = (slots[:, 12].copy().view(np.float32).astype(np.float64)
             + slots[:, 13].copy().view(np.float32).astype(np.float64))
    end_f_all = np.concatenate([end_f, np.zeros(read_keys.size - n_hit)])
    bad |= lk & hit & ((rem_f != end_f_all) | (exp != clock.t1 + dur))
    unhit_ok = (rem_f == seed.rem_unleaked[read_keys]) | (rem_f == seed.rem_f[read_keys])
    bad |= lk & ~hit & (~unhit_ok | (exp != seed.expiry[read_keys]))
    return int(bad.sum())
