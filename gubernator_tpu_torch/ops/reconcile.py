"""Cross-region delta reconcile — remote hits applied through the
conservative merge (the port of ``gubernator_tpu/ops/reconcile.py``; numpy
on the host, then ``engine.merge_rows`` on the engine's device, which with
``walk="pallas"`` on the card is one ``probe_walk`` merge-stage launch).

The receive half of the region plane (service/region_manager.py ships, the
owner daemon in each remote region lands here). A replicated batch carries,
per key: the sending region's aggregated HIT DELTA since its last successful
sync, the request config (limit/duration/algorithm/created_at — the compact
lane image), and the sender's own stored slot row in the sender's slot
layout (ops/layout.py; zero row when the sender's slot was already evicted).

Reconcile builds one INCOMING canonical full-width row per key and hands it
to ``kernel2.merge2`` via ``engine.merge_rows`` — never the serving path, so
a replicated batch cannot answer requests, queue broadcasts, or re-replicate
(ping-pong is structurally impossible). The incoming row is derived from:

* the receiver's OWN live stored row with the delta applied (the common
  case): ``REM_I`` drops by the delta for every integer remaining-style
  algorithm, GCRA advances its stored TAT by ``delta·T``, leaky subtracts
  from the float remainder (no refill accrual — conservative);
* else the sender's row verbatim (bootstrap: the sender's state already
  embodies the delta, plus every older hit the receiver may have missed);
* else a fresh row synthesized from the wire config with the delta applied.

Because the incoming remaining is always ≤ what the receiver stored and the
merge keeps ``remaining=min / expiry=max / aux=max / OVER-sticks``, a
duplicated or crossed replication batch can only UNDER-grant — the same
pinned conservatism that covers checkpoint replay and handoff. Exactness:
with each delta delivered once, every region's per-key count converges to
the exact union of all regions' hits (the delta protocol is an op-based
CRDT; at-least-once delivery degrades to under-grant, never over).

Runs as ONE engine-thread job (EngineRunner.apply_region), so the
read→reconcile→merge triplet is atomic with respect to serving dispatches —
no concurrent hit can slip between the stored-state read and the merge.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gubernator_tpu_torch.ops.table2 import (
    BURST, DUR_HI, DUR_LO, EXP_HI, EXP_LO, F, FLAGS, FP_HI, FP_LO, LIMIT,
    REM_I, REMF_HI, REMF_LO, STAMP_HI, STAMP_LO,
)
from gubernator_tpu_torch.types import Algorithm, Status

_M32 = 0xFFFFFFFF
_OVER = int(Status.OVER_LIMIT)
i64 = np.int64


def _lo32(x: np.ndarray) -> np.ndarray:
    return (x & _M32).astype(np.uint32).view(np.int32)


def _hi32(x: np.ndarray) -> np.ndarray:
    return ((x >> 32) & _M32).astype(np.uint32).view(np.int32)


def _join64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (lo.astype(i64) & _M32) | (hi.astype(i64) << 32)


def _f64_pair(hi_i32: np.ndarray, lo_i32: np.ndarray) -> np.ndarray:
    """REMF f32 pair → float64 (leaky remainder storage, kernel2 rule)."""
    hi = np.ascontiguousarray(hi_i32, dtype=np.int32).view(np.float32)
    lo = np.ascontiguousarray(lo_i32, dtype=np.int32).view(np.float32)
    return hi.astype(np.float64) + lo.astype(np.float64)


def _pair_f64(val: np.ndarray):
    hi = val.astype(np.float32)
    lo = (val - hi.astype(np.float64)).astype(np.float32)
    return hi.view(np.int32), lo.view(np.int32)


def reconcile_region_rows(
    fps: np.ndarray,
    deltas: np.ndarray,
    cfg: dict,
    local_slots: np.ndarray,
    local_found: np.ndarray,
    sender_slots: Optional[np.ndarray],
    now_ms: int,
) -> np.ndarray:
    """Incoming canonical rows for one replicated delta batch (module
    docstring). `cfg` is the decode_wire_host column dict (limit, duration,
    algo, created_at as int64); `local_slots`/`local_found` come from
    engine.read_state; `sender_slots` are the sender's stored rows ALREADY
    unpacked to canonical full width (or None). Returns (n, 16) int32."""
    n = int(fps.shape[0])
    deltas = np.asarray(deltas, dtype=i64)
    lim = np.asarray(cfg["limit"], dtype=i64)
    dur = np.asarray(cfg["duration"], dtype=i64)
    algo = np.asarray(cfg["algo"], dtype=i64)
    ca = np.asarray(cfg["created_at"], dtype=i64)
    if sender_slots is None or sender_slots.size == 0:
        sender_slots = np.zeros((n, F), dtype=np.int32)
    local = np.asarray(local_slots, dtype=np.int32)
    sender = np.asarray(sender_slots, dtype=np.int32)

    l_exp = _join64(local[:, EXP_LO], local[:, EXP_HI])
    l_algo = local[:, FLAGS].astype(i64) & 0xFF
    # live matching local row → apply the delta to OUR state (exact union);
    # an expired local row means the window/TAT it described is over — the
    # delta belongs to a bucket that no longer exists, so fall through to
    # the sender row / fresh synthesis (whose own expiry gates staleness).
    use_local = (
        np.asarray(local_found, dtype=bool) & (l_exp >= now_ms)
        & (l_algo == algo)
    )
    s_fp = _join64(sender[:, FP_LO], sender[:, FP_HI])
    s_algo = sender[:, FLAGS].astype(i64) & 0xFF
    s_found = (s_fp != 0) & (s_algo == algo)
    use_sender = ~use_local & s_found
    use_fresh = ~use_local & ~use_sender

    is_gcra = algo == int(Algorithm.GCRA)
    is_leaky = algo == int(Algorithm.LEAKY_BUCKET)
    is_lease = algo == int(Algorithm.CONCURRENCY_LEASE)
    is_int = ~is_gcra & ~is_leaky  # REM_I remaining-style families

    # ---------------- candidate 1: receiver's own row ⊕ delta
    b_rem = local[:, REM_I].astype(i64)
    b_aux = _join64(local[:, REMF_LO], local[:, REMF_HI])
    b_limit = local[:, LIMIT].astype(i64)
    b_burst = local[:, BURST].astype(i64)
    b_dur = _join64(local[:, DUR_LO], local[:, DUR_HI])
    b_status = (local[:, FLAGS].astype(i64) >> 8) & 0xFF
    T_l = np.maximum(b_dur // np.maximum(b_limit, 1), 1)
    tau_l = T_l * np.where(b_burst > 0, b_burst, b_limit)
    tat0 = np.maximum(b_aux, now_ms)
    tat1 = tat0 + deltas * T_l
    a_rem = np.maximum(b_rem - deltas, 0)
    a_over_int = deltas > b_rem
    b_remf = _f64_pair(local[:, REMF_HI], local[:, REMF_LO])
    a_remf = np.maximum(b_remf - deltas.astype(np.float64), 0.0)
    a_over_lk = deltas.astype(np.float64) > b_remf
    a_over_g = (tat1 - tau_l) > now_ms
    a_status = np.maximum(
        b_status,
        np.where(
            np.where(is_gcra, a_over_g, np.where(is_leaky, a_over_lk,
                                                 a_over_int)),
            _OVER, 0,
        ),
    )
    a_aux = np.where(is_gcra, tat1, b_aux)
    a_exp = np.where(
        is_gcra, np.maximum(l_exp, tat1),
        np.where(is_lease, np.maximum(l_exp, now_ms + b_dur), l_exp),
    )
    # sender-row fold where both sides hold the same live algorithm: the
    # sliding-window previous count and the expiry tighten by MAX (a larger
    # prev or longer-lived state only denies more). GCRA TATs are NOT
    # folded — the sender's TAT already embodies the hits its deltas carry,
    # and max-ing it on top of the delta advance would double-count.
    s_exp = _join64(sender[:, EXP_LO], sender[:, EXP_HI])
    s_aux = _join64(sender[:, REMF_LO], sender[:, REMF_HI])
    fold = use_local & s_found
    a_exp = np.where(fold & ~is_gcra, np.maximum(a_exp, s_exp), a_exp)
    a_aux = np.where(
        fold & (algo == int(Algorithm.SLIDING_WINDOW)),
        np.maximum(a_aux, s_aux), a_aux,
    )

    # ---------------- candidate 3: fresh row from the wire config
    T_c = np.maximum(dur // np.maximum(lim, 1), 1)
    tau_c = T_c * lim
    g_tat = ca + deltas * T_c
    f_rem = np.where(is_int, np.maximum(lim - deltas, 0), 0)
    f_remf = np.where(
        is_leaky, np.maximum(lim - deltas, 0).astype(np.float64), 0.0
    )
    f_over = np.where(is_gcra, (g_tat - tau_c) > now_ms, deltas > lim)
    f_status = np.where(f_over, _OVER, 0)
    f_aux = np.where(is_gcra, g_tat, 0)
    f_stamp = np.where(is_lease, now_ms, ca)
    f_exp = np.where(
        is_gcra, g_tat,
        np.where(
            is_lease, now_ms + dur,
            np.where(algo == int(Algorithm.SLIDING_WINDOW),
                     ca + 2 * dur, ca + dur),
        ),
    )

    # ---------------- select + pack to canonical int32 lanes
    def pick64(a, s, f):
        return np.where(use_local, a, np.where(use_sender, s, f))

    sel_rem = pick64(a_rem, sender[:, REM_I].astype(i64), f_rem)
    sel_aux = pick64(a_aux, s_aux, f_aux)
    sel_exp = pick64(a_exp, s_exp, f_exp)
    sel_stamp = pick64(
        _join64(local[:, STAMP_LO], local[:, STAMP_HI]),
        _join64(sender[:, STAMP_LO], sender[:, STAMP_HI]),
        f_stamp,
    )
    sel_limit = pick64(b_limit, sender[:, LIMIT].astype(i64), lim)
    sel_burst = pick64(b_burst, sender[:, BURST].astype(i64), lim)
    sel_dur = pick64(
        b_dur, _join64(sender[:, DUR_LO], sender[:, DUR_HI]), dur
    )
    sel_status = pick64(
        a_status, (sender[:, FLAGS].astype(i64) >> 8) & 0xFF, f_status
    )
    # float remainder lanes: leaky carries the f32 pair; GCRA/window carry
    # the raw aux int64 split (merge2's aux_algo rule re-derives which)
    remf_hi_f, remf_lo_f = _pair_f64(pick64(a_remf, 0.0, f_remf))
    s_remf = np.stack([sender[:, REMF_HI], sender[:, REMF_LO]], axis=-1)
    aux_lanes = is_gcra | (algo == int(Algorithm.SLIDING_WINDOW))
    remf_hi = np.where(
        aux_lanes, _hi32(sel_aux),
        np.where(use_sender, s_remf[:, 0], remf_hi_f),
    )
    remf_lo = np.where(
        aux_lanes, _lo32(sel_aux),
        np.where(use_sender, s_remf[:, 1], remf_lo_f),
    )

    out = np.zeros((n, F), dtype=np.int32)
    out[:, FP_LO] = _lo32(np.asarray(fps, dtype=i64))
    out[:, FP_HI] = _hi32(np.asarray(fps, dtype=i64))
    out[:, LIMIT] = sel_limit.astype(np.int32)
    out[:, BURST] = sel_burst.astype(np.int32)
    out[:, REM_I] = np.clip(sel_rem, -(1 << 31), (1 << 31) - 1).astype(
        np.int32
    )
    out[:, FLAGS] = (algo | (sel_status << 8)).astype(np.int32)
    out[:, DUR_LO] = _lo32(sel_dur)
    out[:, DUR_HI] = _hi32(sel_dur)
    out[:, STAMP_LO] = _lo32(sel_stamp)
    out[:, STAMP_HI] = _hi32(sel_stamp)
    out[:, EXP_LO] = _lo32(sel_exp)
    out[:, EXP_HI] = _hi32(sel_exp)
    out[:, REMF_HI] = remf_hi
    out[:, REMF_LO] = remf_lo
    return out


# per-source receive-ledger bound: ~1M keys per source before the ledger
# resets wholesale (a reset degrades re-shipped batches to the legacy
# under-grant rule, never over)
DEDUP_LEDGER_CAP = 1 << 20


def dedup_source_deltas(
    ledger: dict,
    fps: np.ndarray,
    deltas: np.ndarray,
    cums: Optional[np.ndarray],
) -> np.ndarray:
    """Receiver-side exact dedup of re-shipped region-sync batches.

    `ledger` is this receiver's per-SOURCE map fp → highest cumulative
    counter already APPLIED (committed by the caller only after the merge
    lands — see RegionManager.dedup_recv). `cums[i]` is the sender's total
    hits ever queued for `fps[i]` toward this region, INCLUDING this
    batch's `deltas[i]`. The effective delta to apply is::

        cum >  seen  →  min(delta, cum - seen)   (normal / partial overlap)
        cum == seen  →  0                        (exact duplicate: skip)
        cum <  seen  →  delta                    (sender restarted or its
                                                  ledger reset: its new
                                                  counter counts only new
                                                  hits — apply them, and
                                                  re-baseline below)

    The `min(delta, ·)` cap matters when the sender DROPPED batches
    (bounded requeue, GUBER_REGION_REQUEUE_RETRIES): the gap between
    counters then includes hits that were never shipped and never will be
    — applying more than this batch actually carries would fabricate them.
    Every branch errs toward applying less, so dedup can only remove the
    double-apply under-grant, never over-grant. Returns the effective
    delta array; does NOT touch `ledger` (commit after the merge lands so
    a failed/cancelled apply is re-appliable)."""
    deltas = np.asarray(deltas, dtype=i64)
    if cums is None:
        return deltas  # pre-dedup sender: legacy at-least-once rule
    cums = np.asarray(cums, dtype=i64)
    eff = deltas.copy()
    for i, fp in enumerate(np.asarray(fps, dtype=i64)):
        seen = ledger.get(int(fp))
        if seen is None:
            continue
        c = int(cums[i])
        if c > seen:
            eff[i] = min(int(deltas[i]), c - seen)
        elif c == seen:
            eff[i] = 0
        # c < seen: sender reset — apply the delta as shipped
    return eff


def commit_source_cums(
    ledger: dict, fps: np.ndarray, cums: Optional[np.ndarray]
) -> None:
    """Record a successfully MERGED batch's cumulative counters into the
    per-source ledger (the second half of dedup_source_deltas). A
    sender-reset (cum below the stored baseline) re-baselines downward so
    the sender's fresh counter stream keeps deduping."""
    if cums is None:
        return
    if len(ledger) + fps.shape[0] > DEDUP_LEDGER_CAP:
        ledger.clear()  # degrade to legacy under-grant, bounded memory
    cums = np.asarray(cums, dtype=i64)
    for i, fp in enumerate(np.asarray(fps, dtype=i64)):
        ledger[int(fp)] = int(cums[i])


def apply_region_sync(
    engine,
    fps: np.ndarray,
    deltas: np.ndarray,
    cfg: dict,
    sender_slots: Optional[np.ndarray],
    sender_layout=None,
    now_ms: Optional[int] = None,
) -> int:
    """Apply one received cross-region delta batch: read the receiver's
    stored state, build the reconciled incoming rows, and merge them through
    kernel2.merge2 (engine.merge_rows). The sender's slot rows arrive in
    the SENDER's layout and convert through the canonical full row here —
    the single conversion point — so a packed (gcra32/token32) sender
    cannot corrupt or over-grant a full-layout receiver, or vice versa.

    MUST run as one engine-thread job (EngineRunner.apply_region) so no
    serving dispatch interleaves between the read and the merge. Returns
    the number of rows merged."""
    from gubernator_tpu_torch.ops.engine import ms_now

    fps = np.asarray(fps, dtype=i64)
    n = int(fps.shape[0])
    if n == 0:
        return 0
    now = now_ms if now_ms is not None else ms_now()
    if sender_slots is not None and sender_slots.size:
        sender_full = engine._slots_to_full(sender_slots, sender_layout)
    else:
        sender_full = None
    # duplicate fps inside one batch would make the per-key delta rows
    # shadow each other in the min-merge (losing the smaller delta — the
    # OVER-granting direction); the sender aggregates per key, but fold
    # defensively anyway
    uniq, first, inv = np.unique(fps, return_index=True, return_inverse=True)
    if uniq.shape[0] != n:
        # keep each key's first occurrence for config/slots, sum the deltas
        agg = np.zeros(uniq.shape[0], dtype=i64)
        np.add.at(agg, inv, np.asarray(deltas, dtype=i64))
        fps = fps[first]
        deltas = agg
        cfg = {k: np.asarray(v)[first] for k, v in cfg.items()}
        if sender_full is not None:
            sender_full = sender_full[first]
        n = fps.shape[0]
    found, local = engine.read_state(fps)
    rows = reconcile_region_rows(
        fps, deltas, cfg, local, found, sender_full, now
    )
    return engine.merge_rows(fps, rows, now_ms=now)
