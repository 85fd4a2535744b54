"""Decision kernel v2 on PyTorch: packed-row table, sort-based claim, slot
write (the port of ``gubernator_tpu/ops/kernel2.py``, decide path).

One dispatch runs four stages over a batch of unique fingerprints:

  1. **probe** — ONE row gather brings each request's whole bucket (all 8
     slots) into registers;
  2. **claim** — requests are sorted by bucket; each inserting row takes a
     rank among its bucket's inserters via segmented prefix sums, and rank
     r picks the r-th lane in (vacant-first, then soonest-expiring) order.
     A second sort over target slots dedups insert-vs-owner collisions
     (owners win) and applies the write-window overflow drop;
  3. **decide** — the branchless decision tables (ops/math.py) on the
     chosen lane's state;
  4. **write** — one hand-written CUDA kernel (ops/slot_write.py) takes
     the canonical rows and the claim, packs the written rows to the
     table's layout and stores them in slot ``bucket*K + chosen`` — the
     Hopper counterpart of the TPU's Pallas sweep and block-sparse sweep,
     which computed the same function from the same inputs.

The gather, sorts, scans and decision math are eager torch ops (they were
XLA, not Pallas, in the JAX package). Every sort is stable, matching
``lax.sort``; the write-window geometry (``sweep_geometry`` /
``sparse_geometry`` / ``resolve_write``) is kept because the claim's
overflow drop depends on it, bit for bit.

Where the JAX entry points donate the table, the port updates
``table.rows`` in place.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.ops.batch import BatchStats, ReqBatch, RespBatch
from gubernator_tpu_torch.ops.layout import FULL
from gubernator_tpu_torch.ops.math import StoredState, bucket_math
from gubernator_tpu_torch.ops.slot_write import slot_write
from gubernator_tpu_torch.ops.table2 import (
    BURST,
    DUR_HI,
    DUR_LO,
    EXP_HI,
    EXP_LO,
    F,
    FLAGS,
    FP_HI,
    FP_LO,
    K,
    LIMIT,
    REM_I,
    REMF_HI,
    REMF_LO,
    STAMP_HI,
    STAMP_LO,
    Table2,
)
from gubernator_tpu_torch.types import Algorithm, Status

i32 = torch.int32
i64 = torch.int64
f32 = torch.float32
f64 = torch.float64


def _lo32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64, wrapped to int32."""
    return (x & 0xFFFFFFFF).to(i32)


def _hi32(x: torch.Tensor) -> torch.Tensor:
    return (x >> 32).to(i32)


def _join64(lo32: torch.Tensor, hi32: torch.Tensor) -> torch.Tensor:
    return (hi32.to(i64) << 32) | (lo32.to(i64) & 0xFFFFFFFF)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def _first_of_run(x: torch.Tensor) -> torch.Tensor:
    """True where x[i] starts a run of equal values (x[0] always)."""
    first = torch.ones_like(x, dtype=torch.bool)
    first[1:] = x[1:] != x[:-1]
    return first


def _unsort(perm: torch.Tensor, vals_sorted: torch.Tensor) -> torch.Tensor:
    """Values at sorted positions back to original row order."""
    out = torch.empty_like(vals_sorted)
    out[perm] = vals_sorted
    return out


def sweep_geometry(n_buckets: int, batch: int) -> Tuple[int, int]:
    """(BLK bucket-rows per write block, U update window per block) of the
    TPU's dense sweep. The port writes through one scatter kernel in every
    mode, but the claim still drops rows past a block's U-window exactly as
    the reference does, so the geometry is kept verbatim."""
    blk = min(2048, n_buckets)
    if n_buckets % blk:
        raise ValueError(
            f"n_buckets={n_buckets} not divisible by sweep block {blk}; "
            "build tables with new_table2()"
        )
    while True:
        nblk = n_buckets // blk
        mean = batch / nblk
        u = int(mean + 5.0 * mean**0.5) + 64
        p = 64
        while p < u:
            p *= 2
        u = min(p, batch)
        if blk * u <= (1 << 19) or blk <= 256:
            u = min(u, max(64, (1 << 19) // blk))
            return blk, u
        blk //= 2


def _sparse_blk() -> int:
    """Block rows per sparse-write grid step (GUBER_WRITE_SPARSE_BLK)."""
    return int(os.environ.get("GUBER_WRITE_SPARSE_BLK", "64"))


def sparse_write_crossover() -> float:
    """Coverage bound gating the sparse write (GUBER_WRITE_SPARSE_CROSSOVER)."""
    return float(os.environ.get("GUBER_WRITE_SPARSE_CROSSOVER", "4"))


def sparse_geometry(n_buckets: int, batch: int) -> Tuple[int, int, int]:
    """(BLK bucket-rows per sparse block, U update window, G grid steps) of
    the TPU's block-sparse write."""
    blk = min(_sparse_blk(), n_buckets)
    while blk > 1 and n_buckets % blk:
        blk //= 2
    nblk = n_buckets // blk
    mean = batch / nblk
    u = int(mean + 5.0 * mean**0.5) + 64
    p = 64
    while p < u:
        p *= 2
    u = min(p, batch)
    u = min(u, max(64, (1 << 19) // blk))
    return blk, u, min(nblk, batch)


def resolve_write(write: str, n_buckets: int, batch: int, layout=None) -> str:
    """Per-dispatch write-mode resolution: "sparse" falls back to "sweep"
    when the sparse grid's worst-case coverage, scaled by the layout's bytes
    per slot, crosses GUBER_WRITE_SPARSE_CROSSOVER of the table."""
    if write not in ("sweep", "sparse", "xla"):
        raise ValueError(
            f"unknown write mode {write!r}; expected 'sweep', 'sparse' or 'xla'"
        )
    if write != "sparse":
        return write
    layout = FULL if layout is None else layout
    blk, _u, g = sparse_geometry(n_buckets, batch)
    coverage_bytes_scaled = g * blk * (layout.F / float(F))
    if coverage_bytes_scaled * sparse_write_crossover() >= n_buckets:
        return "sweep"
    return "sparse"


def claim_geometry(write: str, n_buckets: int, batch: int, layout=None) -> Tuple[int, int]:
    """(blk, u) of the claim's overflow rule for a dispatch: the sparse
    geometry when `write` resolves to "sparse", the sweep geometry otherwise
    ("xla" included), as decide2_impl chooses them in the JAX package."""
    if resolve_write(write, n_buckets, batch, layout) == "sparse":
        blk, u, _g = sparse_geometry(n_buckets, batch)
        return blk, u
    return sweep_geometry(n_buckets, batch)


def _lane_positions(live: torch.Tensor, exp64: torch.Tensor) -> torch.Tensor:
    """(B, K) position of each lane in the claim's candidate order: (live,
    expiry, lane index) ascending — vacant lanes first, then live lanes by
    soonest expiry. A lane's position is the number of lanes ahead of it,
    from all K×K pair compares (the JAX package's lax.sort over that
    65-bit key)."""
    lane = torch.arange(K, device=live.device)
    lv = live.to(i32)
    ahead = (lv[:, :, None] < lv[:, None, :]) | (
        (lv[:, :, None] == lv[:, None, :])
        & (
            (exp64[:, :, None] < exp64[:, None, :])
            | ((exp64[:, :, None] == exp64[:, None, :]) & (lane[:, None] < lane[None, :]))
        )
    )  # ahead[b, k, j]: lane k sorts before lane j
    return ahead.sum(dim=1)


class Claim2(NamedTuple):
    bucket: torch.Tensor  # (B,) int32
    chosen: torch.Tensor  # (B,) int64 lane in [0, K)
    got: torch.Tensor  # (B,) bool — row has a lane (pre-dedup)
    owns: torch.Tensor  # (B,) bool — lane holds this row's fp
    written: torch.Tensor  # (B,) bool — row survives dedup + window overflow
    evict_live: torch.Tensor  # (B,) bool — claimed lane held a live item
    slots: torch.Tensor  # (B, K, 16) int32 — the gathered bucket contents
    # sweep-write routing (sorted-by-target domain)
    order: torch.Tensor  # (B,) int32 original index at each sorted position
    tgt_sorted: torch.Tensor  # (B,) int32 target slot at each sorted position
    written_sorted: torch.Tensor  # (B,) bool — written flag at sorted position


def _probe_claim2(rows_tbl: torch.Tensor, fp, now, active, blk: int, u: int,
                  layout=None) -> Claim2:
    """Probe + claim (JAX kernel2._probe_claim2, kernel2.py:276-389)."""
    layout = FULL if layout is None else layout
    NB = rows_tbl.shape[0]
    B = fp.shape[0]
    if NB * K * 2 >= 2**31:
        raise ValueError("table too large for int32 slot ids")
    dev = fp.device

    bucket = (fp % NB).to(i32)
    my_lo = _lo32(fp)
    my_hi = _hi32(fp)

    rows = rows_tbl.index_select(0, bucket.to(i64))  # the only table read
    slots = layout.unpack(rows.view(B, K, layout.F))  # (B, K, 16) canonical
    s_fp_lo = slots[:, :, FP_LO]
    s_fp_hi = slots[:, :, FP_HI]

    empty = (s_fp_lo == 0) & (s_fp_hi == 0)
    match = (s_fp_lo == my_lo[:, None]) & (s_fp_hi == my_hi[:, None]) & ~empty
    match = match & active[:, None]
    owns = match.any(dim=1)
    own_j = match.to(i32).argmax(dim=1)  # first matching lane

    # exact lazy expiry (reference lrucache.go:111-128); the JAX kernel
    # compares the split (hi, unsigned lo) pair, which is the int64 order
    exp64 = _join64(slots[:, :, EXP_LO], slots[:, :, EXP_HI])
    dead = ~empty & (exp64 < now[:, None])
    vacant = empty | dead
    live = ~vacant

    # ---- rank among inserting rows of the same bucket (sorted domain)
    need = active & ~owns
    bkey = torch.where(active, bucket, torch.full_like(bucket, NB))
    bkey_s, idx_s1 = torch.sort(bkey, stable=True)
    need_s = need[idx_s1].to(i64)
    first = _first_of_run(bkey_s)
    csum = torch.cumsum(need_s, dim=0)
    c_excl = csum - need_s
    seg_base = _cummax(torch.where(first, c_excl, torch.full_like(c_excl, -1)))
    rank = _unsort(idx_s1, c_excl - seg_base)

    lane_pos = _lane_positions(live, exp64)
    rank_c = torch.clamp(rank, 0, K - 1)
    ins_lane = (lane_pos == rank_c[:, None]).to(i32).argmax(dim=1)
    claim_ok = need & (rank < K)

    chosen = torch.where(owns, own_j, ins_lane).to(i64)
    got = active & (owns | claim_ok)
    lane_live = live.gather(1, chosen[:, None])[:, 0]
    evict_live = claim_ok & lane_live

    # ---- conflict dedup + write-window overflow over target slots
    NBK = NB * K
    target = torch.where(got, bucket * K + chosen.to(i32), torch.full_like(bucket, NBK))
    # owners sort ahead of inserters on equal targets, so dedup keeps them
    skey = target * 2 + (~owns).to(i32)
    skey_s, idx_s2 = torch.sort(skey, stable=True)
    tgt_s = skey_s >> 1
    dup = torch.zeros_like(owns)
    dup[1:] = tgt_s[1:] == tgt_s[:-1]

    # window overflow: position within the target's write-block run
    pos_i = torch.arange(B, device=dev)
    first_blk = _first_of_run(tgt_s // (K * blk))
    blk_start = _cummax(torch.where(first_blk, pos_i, torch.full_like(pos_i, -1)))
    overflow = (pos_i - blk_start) >= u

    written_s = (tgt_s < NBK) & ~dup & ~overflow
    written = _unsort(idx_s2, written_s)

    return Claim2(
        bucket=bucket,
        chosen=chosen,
        got=got,
        owns=owns,
        written=written,
        evict_live=evict_live & written,
        slots=slots,
        order=idx_s2.to(i32),
        tgt_sorted=tgt_s,
        written_sorted=written_s,
    )


# -------------------------------------------------------------------- decide


def decide_payload(lane16, req: ReqBatch, owns, *, math: str):
    """The per-row DECIDE stage (JAX kernel2.decide_payload): the chosen
    lane's canonical (B, 16) fields + the request rows → (exists, Decision,
    canonical (B, 16) int32 write-payload rows)."""
    now = req.created_at
    g = lambda f: lane16[:, f]
    s_exp = _join64(g(EXP_LO), g(EXP_HI))
    exists = owns & (s_exp >= now)
    s_flags = g(FLAGS)
    stored = StoredState(
        limit=g(LIMIT).to(i64),
        burst=g(BURST).to(i64),
        rem_i=g(REM_I).to(i64),
        algo=s_flags & 0xFF,
        status=s_flags >> 8,
        duration=_join64(g(DUR_LO), g(DUR_HI)),
        stamp=_join64(g(STAMP_LO), g(STAMP_HI)),
        exp=s_exp,
        rem_f=_f32pair_to_f64(g(REMF_HI), g(REMF_LO)),
        # the same lane pair as a raw int64 (GCRA TAT / window prev count)
        aux=_join64(g(REMF_LO), g(REMF_HI)),
    )
    d = bucket_math(stored, req, exists, mode=math)

    # ---- build update payload rows
    sat32 = lambda x: torch.clamp(x, -(2**31), 2**31 - 1).to(i32)
    zero = torch.zeros_like(req.algo)
    if math == "token":
        remf_hi_i = zero
        remf_lo_i = zero
    elif math in ("gcra", "int"):
        remf_hi_i = _hi32(d.aux_out)
        remf_lo_i = _lo32(d.aux_out)
    else:
        # leaky rows store the f64 remainder as an f32 hi/lo pair, bit cast
        f_hi = d.rem_f_out.to(f32)
        f_lo = (d.rem_f_out - f_hi.to(f64)).to(f32)
        is_leaky = req.algo == 1
        remf_hi_i = torch.where(is_leaky, f_hi.view(i32), _hi32(d.aux_out))
        remf_lo_i = torch.where(is_leaky, f_lo.view(i32), _lo32(d.aux_out))
    my_lo = _lo32(req.fp)
    my_hi = _hi32(req.fp)
    rm = d.remove
    new16 = torch.stack(
        [
            torch.where(rm, zero, my_lo),
            torch.where(rm, zero, my_hi),
            sat32(req.limit),
            sat32(d.burst_out),
            sat32(d.rem_i_out),
            d.flags_out,
            _lo32(d.dur_out),
            _hi32(d.dur_out),
            _lo32(d.stamp_out),
            _hi32(d.stamp_out),
            torch.where(rm, zero, _lo32(d.exp_out)),
            torch.where(rm, zero, _hi32(d.exp_out)),
            remf_hi_i,
            remf_lo_i,
            zero,
            zero,
        ],
        dim=1,
    )  # (B, 16) int32
    return exists, d, new16


def assemble_resp(req: ReqBatch, d, exists, written, evict_live):
    """Response + stats assembly: the Decision rows plus the claim outcome
    flags → (RespBatch, BatchStats)."""
    active = req.active
    dropped = active & ~written
    status = torch.where(
        active, d.resp_status, torch.full_like(d.resp_status, int(Status.UNDER_LIMIT))
    )
    zero64 = torch.zeros_like(req.limit)
    resp = RespBatch(
        status=status,
        limit=torch.where(active, req.limit, zero64),
        remaining=torch.where(active, d.resp_rem, zero64),
        reset_time=torch.where(active, d.resp_reset, zero64),
        cache_hit=exists,
        dropped=dropped,
        aux=d.aux_out,
        rem_store=d.rem_i_out,
    )
    over = int(Status.OVER_LIMIT)
    stats = BatchStats(
        cache_hits=exists.sum(dtype=i64),
        cache_misses=(active & ~exists).sum(dtype=i64),
        over_limit=(active & (resp.status == over)).sum(dtype=i64),
        evicted_unexpired=evict_live.sum(dtype=i64),
        dropped=dropped.sum(dtype=i64),
    )
    return resp, stats


def _write_claim(table: Table2, new16: torch.Tensor, c: Claim2) -> None:
    """The table write of a claim (JAX kernel2._write_xla and the Pallas
    sweeps): each written row's canonical payload, packed to the table's
    layout, lands in slot ``bucket*K + chosen`` — one slot_write call, which
    forms the target and packs the rows itself."""
    slot_write(table.rows, new16.contiguous(), c.written.contiguous(),
               c.bucket.contiguous(), c.chosen.contiguous(), table.layout)


def _claim_for(table: Table2, write: str, fp, now, active) -> Claim2:
    NB = table.rows.shape[0]
    blk, u = claim_geometry(write, NB, fp.shape[0], table.layout)
    return _probe_claim2(table.rows, fp, now, active, blk, u, table.layout)


def decide2_impl(
    table: Table2, req: ReqBatch, *, write: str = "sweep", math: str = "mixed",
    probe: str = "xla", evictees: bool = False,
):
    """One decide dispatch (JAX kernel2.decide2_impl). Updates
    ``table.rows`` IN PLACE — the JAX entry points donate the table instead
    — and returns (table, RespBatch, BatchStats), plus the (B, 16) int32
    evictee sidecar (the canonical rows the claim displaced from live
    lanes, zero rows elsewhere) when ``evictees=True``.

    `write` chooses only the claim geometry (and with it the window-overflow
    drop); every mode writes through the one slot_write kernel.
    ``probe="pallas"`` routes the whole dispatch through the fused probe
    walk (ops/probe_walk.py), where `write` is moot."""
    layout = table.layout
    if not layout.supports_math(math):
        raise ValueError(
            f"table layout {layout.name!r} cannot serve math={math!r}; "
            "migrate the table to the full layout first (the engine does "
            "this automatically)"
        )
    if probe not in ("xla", "pallas"):
        raise ValueError(f"unknown probe kernel {probe!r}; expected 'xla' or 'pallas'")
    if probe == "pallas":
        from gubernator_tpu_torch.ops.probe_walk import decide2_pallas_impl

        return decide2_pallas_impl(table, req, math=math, evictees=evictees)
    B = req.fp.shape[0]
    c = _claim_for(table, write, req.fp, req.created_at, req.active)

    lane16 = c.slots[torch.arange(B, device=c.slots.device), c.chosen]  # (B, 16)
    exists, d, new16 = decide_payload(lane16, req, c.owns, math=math)
    _write_claim(table, new16, c)

    resp, stats = assemble_resp(req, d, exists, c.written, c.evict_live)
    if evictees:
        ev16 = torch.where(c.evict_live[:, None], lane16, torch.zeros_like(lane16))
        return table, resp, stats, ev16
    return table, resp, stats


# ---------------------------------------------------------- packed outputs

# flag bits of pack_outputs' 4th column
FLAG_STATUS = 1
FLAG_HIT = 2
FLAG_DROPPED = 4
FLAG_UNPROCESSED = 8
FLAG_MEMBER = 16
# bits 5-6: the row's priority tier, echoed from the behavior word
FLAG_TIER_SHIFT = 5
FLAG_TIER_MASK = 0x3
_BEH_PRIO_SHIFT = 6


def pack_outputs(resp: RespBatch, stats: BatchStats, behavior=None) -> torch.Tensor:
    """Pack responses + stats into ONE (B+2, 4) int64 tensor, so a dispatch
    costs one device→host copy. Row i < B = [limit, remaining, reset_time,
    flags] with flags = status | cache_hit<<1 | dropped<<2 | tier<<5; row
    B = [cache_hits, cache_misses, over_limit, evicted_unexpired]; row
    B+1 = [dropped, 0, 0, 0]."""
    flags = (
        resp.status.to(i64)
        | (resp.cache_hit.to(i64) << 1)
        | (resp.dropped.to(i64) << 2)
    )
    if behavior is not None:
        tier = (behavior.to(i64) >> _BEH_PRIO_SHIFT) & 3
        flags = flags | (tier << FLAG_TIER_SHIFT)
    rows = torch.stack([resp.limit, resp.remaining, resp.reset_time, flags], dim=1)
    z = torch.zeros((), dtype=i64, device=rows.device)
    srow0 = torch.stack(
        [stats.cache_hits, stats.cache_misses, stats.over_limit,
         stats.evicted_unexpired]
    )[None, :]
    srow1 = torch.stack([stats.dropped, z, z, z])[None, :]
    return torch.cat([rows, srow0, srow1], dim=0)


def unpack_tiers(arr: np.ndarray, n: int) -> np.ndarray:
    """Per-row priority tiers from a fetched output array (either wire
    format: the flags column layout is shared)."""
    return (
        (np.asarray(arr[:n, 3]).astype(np.int64) >> FLAG_TIER_SHIFT) & FLAG_TIER_MASK
    ).astype(np.int32)


def unpack_outputs(arr: np.ndarray, n: int):
    """Decode a fetched pack_outputs array (host-side): (B+2, 4) int64 →
    ((status, limit, remaining, reset_time, dropped, hit), (cache_hits,
    cache_misses, over_limit, evicted_unexpired)). Response arrays are
    writable copies. Compact-wire outputs (int32, base-relative reset) are
    self-describing by dtype and decode through ops/wire.py's twin."""
    arr = np.asarray(arr)
    if arr.dtype == np.int32:
        from gubernator_tpu_torch.ops.wire import unpack_wire_out

        return unpack_wire_out(arr, n)
    st = (int(arr[-2, 0]), int(arr[-2, 1]), int(arr[-2, 2]), int(arr[-2, 3]))
    limit = arr[:n, 0].copy()
    remaining = arr[:n, 1].copy()
    reset = arr[:n, 2].copy()
    status = (arr[:n, 3] & FLAG_STATUS).astype(np.int32)
    hit = (arr[:n, 3] & FLAG_HIT) != 0
    dropped = (arr[:n, 3] & FLAG_DROPPED) != 0
    return (status, limit, remaining, reset, dropped, hit), st


def req_from_arr(arr: torch.Tensor) -> ReqBatch:
    """Rebuild the ReqBatch from the packed (12, B) int64 ingress tensor
    (batch.pack_host_batch)."""
    return ReqBatch(
        fp=arr[0],
        algo=arr[1].to(i32),
        behavior=arr[2].to(i32),
        hits=arr[3],
        limit=arr[4],
        burst=arr[5],
        duration=arr[6],
        created_at=arr[7],
        expire_new=arr[8],
        greg_interval=arr[9],
        duration_eff=arr[10],
        active=arr[11] != 0,
    )


# ------------------------------------------------------- evictee sidecar
#
# With evictees=True a dispatch also returns the canonical rows it evicted
# from live lanes. They ride the fetched output between the response rows
# and the two stats rows, so every decoder of `arr[:n]` / `arr[-2]` keeps
# working:
#   int64 packed outputs: each (16,) int32 row as 8 int64 lanes
#     ((hi<<32)|lo over adjacent field pairs), 2 rows of 4 per request →
#     (3B+2, 4);
#   int32 compact-wire outputs: the raw fields, 4 rows of 4 per request →
#     (5B+2, 4) (slot fields are bit patterns and must not ride the
#     clamped response narrowing).


def attach_evictees(packed: torch.Tensor, ev16: torch.Tensor) -> torch.Tensor:
    """Insert a (B, 16) int32 evictee sidecar into a (B+2, 4) int64
    pack_outputs tensor → (3B+2, 4)."""
    B = ev16.shape[0]
    ev64 = _join64(ev16[:, 0::2], ev16[:, 1::2]).reshape(2 * B, 4)
    return torch.cat([packed[:B], ev64, packed[B:]], dim=0)


def attach_evictees_wire(enc: torch.Tensor, ev16: torch.Tensor) -> torch.Tensor:
    """Insert a (B, 16) int32 evictee sidecar into a compact (B+2, 4) int32
    egress tensor → (5B+2, 4) (raw fields, already int32)."""
    B = ev16.shape[0]
    return torch.cat([enc[:B], ev16.reshape(4 * B, 4), enc[B:]], dim=0)


def unpack_evictees(arr: np.ndarray):
    """Host-side sidecar decode of a fetched output with the sidecar
    attached, either wire format → (fps (E,) int64, rows (E, 16) int32
    canonical) for the E evictee rows with a nonzero fingerprint. The
    caller must know the dispatch ran with evictees=True: a sidecar-less
    array is not self-distinguishing."""
    arr = np.asarray(arr)
    if arr.dtype == np.int32:
        B = (arr.shape[0] - 2) // 5
        ev = np.ascontiguousarray(arr[B:5 * B]).reshape(B, 16)
    else:
        B = (arr.shape[0] - 2) // 3
        ev64 = np.ascontiguousarray(arr[B:3 * B]).reshape(B, 8)
        lo_u = ev64 & 0xFFFFFFFF
        lo = np.where(lo_u >= (1 << 31), lo_u - (1 << 32), lo_u).astype(np.int32)
        hi = (ev64 >> 32).astype(np.int32)
        ev = np.empty((B, 16), dtype=np.int32)
        ev[:, 0::2] = lo
        ev[:, 1::2] = hi
    fps = (ev[:, 1].astype(np.int64) << 32) | (ev[:, 0].astype(np.int64) & 0xFFFFFFFF)
    keep = fps != 0
    return fps[keep], ev[keep]


# ------------------------------------------------------------ cascade fold
#
# A cascade request is one row per limit level: a level-0 carrier followed
# by its level>0 members (behavior bits 8-15). Folded in the dispatch, the
# carrier takes deny-if-any status, the minimum remaining and, when a level
# denies, the latest reset among denying levels. Members keep their own
# verdicts. The fold needs rows in batch order, so single-device engines
# run it on single-pass batches; the engine's host fold completes it.

CASCADE_LEVEL_SHIFT = 8


def cascade_groups(arr: torch.Tensor):
    """(carrier, member) from a packed ingress tensor's level bits: member
    rows are level > 0 regardless of activity; carrier[i] is the nearest
    preceding level-0 row (itself for carriers and standalone rows, and for
    a leading orphan member)."""
    level = (arr[2] >> CASCADE_LEVEL_SHIFT) & 0xFF
    n = arr.shape[1]
    idx = torch.arange(n, dtype=i64, device=arr.device)
    member = level > 0
    carrier = _cummax(torch.where(~member, idx, torch.full_like(idx, -1)))
    return torch.where(carrier < 0, idx, carrier), member


def fold_cascade_packed(packed: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """Fold each cascade group's verdicts into its carrier row of the packed
    (n+2, 4) output (JAX kernel2.fold_cascade_packed). Inactive rows are
    left out of the reductions; member rows are untouched."""
    n = arr.shape[1]
    carrier, member = cascade_groups(arr)
    active = arr[11] != 0
    rows = packed[:n]
    flags = rows[:, 3]
    zero = torch.zeros_like(flags)
    status = torch.where(active, flags & FLAG_STATUS, zero)
    over = zero.scatter_reduce(0, carrier, status, "amax", include_self=False)
    big = 2**62
    rem = torch.where(active, rows[:, 1], torch.full_like(flags, big))
    rem_min = torch.full_like(flags, big).scatter_reduce(
        0, carrier, rem, "amin", include_self=False
    )
    deny_reset = torch.where(active & (status != 0), rows[:, 2], zero)
    reset_max = zero.scatter_reduce(0, carrier, deny_reset, "amax", include_self=False)
    is_carrier = ~member & active
    new_flags = torch.where(is_carrier, flags | over, flags)
    new_rem = torch.where(
        is_carrier & (rem_min < big), torch.minimum(rows[:, 1], rem_min), rows[:, 1]
    )
    new_reset = torch.where(
        is_carrier & (over != 0), torch.maximum(rows[:, 2], reset_max), rows[:, 2]
    )
    rows = torch.stack([rows[:, 0], new_rem, new_reset, new_flags], dim=1)
    return torch.cat([rows, packed[n:]], dim=0)


def decide2_packed_impl(
    table: Table2, req: ReqBatch, *, write: str = "sweep", math: str = "mixed",
    probe: str = "xla", evictees: bool = False,
):
    """(table, packed (B+2, 4) int64[, evictee sidecar (B, 16) int32]) —
    the sidecar element exists only with evictees=True (see decide2_impl)."""
    if evictees:
        table, resp, stats, ev16 = decide2_impl(
            table, req, write=write, math=math, probe=probe, evictees=True
        )
        return table, pack_outputs(resp, stats, req.behavior), ev16
    table, resp, stats = decide2_impl(table, req, write=write, math=math, probe=probe)
    return table, pack_outputs(resp, stats, req.behavior)


def decide2_packed_cols_impl(
    table: Table2, arr: torch.Tensor, *, write: str = "sweep",
    math: str = "mixed", cascade: bool = False, probe: str = "xla",
    evictees: bool = False,
) -> Tuple[Table2, torch.Tensor]:
    """Serving entry: packed (12, B) int64 ingress in, packed (B+2, 4) int64
    outputs out ((3B+2, 4) with the evictee sidecar); ``table.rows`` is
    updated in place. ``cascade=True`` folds cascade groups' verdicts into
    their carriers (batch-order dispatches only)."""
    if evictees:
        table, packed, ev16 = decide2_packed_impl(
            table, req_from_arr(arr), write=write, math=math, probe=probe,
            evictees=True,
        )
        if cascade:
            packed = fold_cascade_packed(packed, arr)
        return table, attach_evictees(packed, ev16)
    table, packed = decide2_packed_impl(
        table, req_from_arr(arr), write=write, math=math, probe=probe
    )
    if cascade:
        packed = fold_cascade_packed(packed, arr)
    return table, packed


# eager PyTorch has no jit/donation wrapper: the serving name is the impl
decide2_packed_cols = decide2_packed_cols_impl


# ------------------------------------------------- in-dispatch dedup
#
# The mesh engine with dedup="device" aggregates duplicate keys inside the
# dispatch instead of planning same-key passes on the host: each (fp,
# cascade level) group's newest row carries the summed hits and the OR of
# RESET_REMAINING; the other rows are deactivated and answered from their
# carrier, marked FLAG_MEMBER. These are plan_passes(max_exact=1)'s
# semantics (the reference's GLOBAL hot-key aggregation, global.go:109-123).

RESET_REMAINING_BIT = 8  # Behavior.RESET_REMAINING


def _segment_max(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """jax.ops.segment_max over `n` segments: an empty segment holds the
    dtype's minimum, as JAX gives it."""
    base = torch.full((n,), torch.iinfo(vals.dtype).min, dtype=vals.dtype, device=vals.device)
    return base.scatter_reduce(0, seg, vals, "amax", include_self=False)


def dedup_packed_cols(arr: torch.Tensor):
    """Aggregate duplicate (fingerprint, cascade level) groups of a packed
    (12, n) ingress tensor. Returns (deduped arr, carrier, member):

    * deduped arr — same shape and order; each group's carrier (its newest
      active row) carries the summed hits and the OR-ed RESET_REMAINING
      bit, every other row of the group is deactivated (fp 0, active 0);
    * carrier — (n,) int32, each row's carrier index (itself when unique,
      0 for inactive rows);
    * member — (n,) bool, active rows answered from their carrier.

    Keying on (fp, level) keeps two levels of one cascade apart when their
    keys collide on a fingerprint."""
    fp = arr[0]
    active = arr[11] != 0
    n = fp.shape[0]
    dev = fp.device
    idx = torch.arange(n, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i64, device=dev)
    # inactive rows key to 0, below every real fingerprint (>= 1): one
    # leading segment that no active row joins
    key = torch.where(active, fp, zero)
    lvl = torch.where(active, (arr[2] >> CASCADE_LEVEL_SHIFT) & 0xFF, zero).to(i32)
    # lexicographic (key, lvl) with ties in batch order: two stable sorts
    o1 = torch.sort(lvl, stable=True).indices
    o2 = torch.sort(key[o1], stable=True).indices
    perm = o1[o2]
    key_s, lvl_s, idx_s = key[perm], lvl[perm], idx[perm]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = (key_s[1:] != key_s[:-1]) | (lvl_s[1:] != lvl_s[:-1])
    seg = torch.cumsum(first.to(i32), dim=0) - 1
    seg64 = seg.to(i64)
    act_s = active[perm]
    hits_s = torch.where(act_s, arr[3][perm], zero)
    seg_hits = torch.zeros(n, dtype=i64, device=dev).index_add_(0, seg64, hits_s)
    reset_s = torch.where(act_s, arr[2][perm] & RESET_REMAINING_BIT, zero)
    seg_reset = _segment_max(reset_s, seg64, n)
    # carrier = the newest member, the largest batch index (plan_passes'
    # config rule); a segment of inactive rows only gives -1, clipped to 0
    seg_carrier = _segment_max(torch.where(act_s, idx_s, torch.full_like(idx_s, -1)), seg64, n)
    seg_u = _unsort(perm, seg64)
    carrier = torch.clip(seg_carrier[seg_u], 0, n - 1).to(i32)
    is_carrier = active & (carrier == idx)
    member = active & ~is_carrier
    ded = torch.cat(
        [
            torch.where(is_carrier, fp, zero)[None],
            arr[1:2],
            (arr[2] | seg_reset[seg_u])[None],
            torch.where(is_carrier, seg_hits[seg_u], zero)[None],
            arr[4:11],
            is_carrier.to(i64)[None],
        ],
        dim=0,
    )
    return ded, carrier, member


def fanout_packed(packed: torch.Tensor, carrier: torch.Tensor, member: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Answer each member row of the packed (n+2, 4) output from its
    carrier's row, marked FLAG_MEMBER (the carrier alone stands for the
    group in the stats rows)."""
    rows = packed[:n]
    fan = rows[carrier.to(i64)]
    fan = torch.cat([fan[:, :3], (fan[:, 3] | FLAG_MEMBER)[:, None]], dim=1)
    rows = torch.where(member[:, None], fan, rows)
    return torch.cat([rows, packed[n:]], dim=0)


def decide2_packed_dedup_impl(
    table: Table2, arr: torch.Tensor, *, write: str = "sweep", math: str = "mixed",
    cascade: bool = False, probe: str = "xla",
) -> Tuple[Table2, torch.Tensor]:
    """Serving entry with in-dispatch dedup: packed (12, n) ingress whose
    keys may repeat in, packed (n+2, 4) outputs out, members answered from
    their carrier. ``cascade=True`` also folds cascade verdicts (batch-order
    dispatches only)."""
    ded, carrier, member = dedup_packed_cols(arr)
    table, packed = decide2_packed_cols_impl(table, ded, write=write, math=math, probe=probe)
    packed = fanout_packed(packed, carrier, member, arr.shape[1])
    if cascade:
        packed = fold_cascade_packed(packed, arr)
    return table, packed


# ----------------------------------------------------------------- install


def install_payload16(inst) -> torch.Tensor:
    """The per-row INSTALL payload (JAX kernel2.install_payload16):
    InstallBatch columns → canonical (B, 16) int32 slot rows. A pure
    function of the batch — it never reads table state — shared by the
    two-pass path below and the fused walk, which takes these rows as its
    ingress."""
    is_token = inst.algo == int(Algorithm.TOKEN_BUCKET)
    is_leaky = inst.algo == int(Algorithm.LEAKY_BUCKET)
    is_gcra = inst.algo == int(Algorithm.GCRA)
    is_win = inst.algo == int(Algorithm.SLIDING_WINDOW)
    zero64 = torch.zeros_like(inst.remaining)
    inst_aux = inst.aux if inst.aux is not None else zero64
    inst_rem = inst.rem_store if inst.rem_store is not None else inst.remaining
    # REM_I is remaining-style for every integer algorithm; leaky keeps its
    # float lane and GCRA its TAT
    rem_i = torch.where(
        is_leaky | is_gcra, zero64, torch.where(is_win, inst_rem, inst.remaining)
    )
    rem_f = torch.where(
        is_leaky, inst.remaining.to(f64), torch.zeros_like(inst.remaining, dtype=f64)
    )
    # GCRA: reset_time is the TAT; windows: the previous count
    aux = torch.where(is_gcra, inst.reset_time, torch.where(is_win, inst_aux, zero64))
    burst = torch.where(is_token | is_win, zero64, inst.burst)
    w_dur = torch.clamp(inst.duration, min=1)
    w_ws = inst.now - torch.remainder(inst.now, w_dur)
    exp = torch.where(
        is_token | is_gcra,
        inst.reset_time,
        torch.where(is_win, w_ws + 2 * w_dur, inst.stamp + inst.duration),
    )
    flags = inst.algo | (inst.status << 8)
    sat32 = lambda x: torch.clamp(x, -(2**31), 2**31 - 1).to(i32)
    remf_hi_f = rem_f.to(f32)
    remf_lo_f = (rem_f - remf_hi_f.to(f64)).to(f32)
    remf_hi = torch.where(is_leaky, remf_hi_f.view(i32), _hi32(aux))
    remf_lo = torch.where(is_leaky, remf_lo_f.view(i32), _lo32(aux))
    stamp_eff = torch.where(is_win, w_ws, inst.stamp)
    zero = torch.zeros_like(inst.algo)
    return torch.stack(
        [
            _lo32(inst.fp), _hi32(inst.fp),
            sat32(inst.limit), sat32(burst), sat32(rem_i), flags.to(i32),
            _lo32(inst.duration), _hi32(inst.duration),
            _lo32(stamp_eff), _hi32(stamp_eff),
            _lo32(exp), _hi32(exp),
            remf_hi, remf_lo, zero, zero,
        ],
        dim=1,
    )


def install2_impl(table: Table2, inst, *, write: str = "xla", probe: str = "xla"):
    """Install owner-authoritative GLOBAL statuses as fresh items (JAX
    kernel2.install2_impl). Updates ``table.rows`` in place; returns
    (table, installed mask). ``probe="pallas"`` runs the fused walk."""
    if probe not in ("xla", "pallas"):
        raise ValueError(f"unknown probe kernel {probe!r}; expected 'xla' or 'pallas'")
    new16 = install_payload16(inst)
    if probe == "pallas":
        from gubernator_tpu_torch.ops.probe_walk import walk2_pallas_impl

        return walk2_pallas_impl(
            table, inst.fp, new16, inst.now, inst.active, stage="install"
        )
    c = _claim_for(table, write, inst.fp, inst.now, inst.active)
    _write_claim(table, new16, c)
    return table, inst.active & c.written


# ------------------------------------------------------ conservative merge


def _f32pair_to_f64(hi_bits: torch.Tensor, lo_bits: torch.Tensor) -> torch.Tensor:
    """The leaky remainder: two f32 bit patterns summed in float64. A NaN
    high half is the sum (quieted), as XLA's add gives it; torch's add of
    two NaNs picks either operand by device, so it is not left to choose."""
    hi = hi_bits.contiguous().view(f32).to(f64)
    return torch.where(torch.isnan(hi), hi, hi + lo_bits.contiguous().view(f32).to(f64))


def merge_payload16(fp, slots, lane16, owns, now):
    """The per-row MERGE payload (JAX kernel2.merge_payload16): incoming
    canonical slot, chosen stored lane, ownership and the receiver clock →
    (exists, merged canonical (B, 16) int32 rows). Against a live entry the
    merge only tightens: remaining = min, raw aux (GCRA TAT / window
    previous count) = max, expiry = max, OVER sticks, the newer stamp's
    config wins."""
    g_i = lambda f: slots[:, f]
    g_s = lambda f: lane16[:, f]
    i_exp = _join64(g_i(EXP_LO), g_i(EXP_HI))
    s_exp = _join64(g_s(EXP_LO), g_s(EXP_HI))
    exists = owns & (s_exp >= now)

    i_stamp = _join64(g_i(STAMP_LO), g_i(STAMP_HI))
    s_stamp = _join64(g_s(STAMP_LO), g_s(STAMP_HI))
    i_flags = g_i(FLAGS)
    s_flags = g_s(FLAGS)
    keep_stored = exists & (s_stamp > i_stamp)
    pick = lambda i_f, s_f: torch.where(keep_stored, s_f, i_f)
    limit = pick(g_i(LIMIT), g_s(LIMIT))
    burst = pick(g_i(BURST), g_s(BURST))
    algo = pick(i_flags & 0xFF, s_flags & 0xFF)
    dur = pick(_join64(g_i(DUR_LO), g_i(DUR_HI)), _join64(g_s(DUR_LO), g_s(DUR_HI)))
    status = torch.where(
        exists, torch.maximum(i_flags >> 8, s_flags >> 8), i_flags >> 8
    )
    rem_i = torch.where(exists, torch.minimum(g_i(REM_I), g_s(REM_I)), g_i(REM_I))
    i_f = _f32pair_to_f64(g_i(REMF_HI), g_i(REMF_LO))
    s_f = _f32pair_to_f64(g_s(REMF_HI), g_s(REMF_LO))
    rem_f = torch.where(exists, torch.minimum(i_f, s_f), i_f)
    s_aux = _join64(g_s(REMF_LO), g_s(REMF_HI))
    i_aux = _join64(g_i(REMF_LO), g_i(REMF_HI))
    same_algo = exists & ((s_flags & 0xFF) == (i_flags & 0xFF))
    aux = torch.where(
        same_algo, torch.maximum(s_aux, i_aux), torch.where(keep_stored, s_aux, i_aux)
    )
    exp = torch.where(exists, torch.maximum(s_exp, i_exp), i_exp)
    stamp = torch.where(exists, torch.maximum(s_stamp, i_stamp), i_stamp)

    remf_hi_f = rem_f.to(f32)
    remf_lo_f = (rem_f - remf_hi_f.to(f64)).to(f32)
    aux_algo = (algo == int(Algorithm.GCRA)) | (algo == int(Algorithm.SLIDING_WINDOW))
    remf_hi = torch.where(aux_algo, _hi32(aux), remf_hi_f.view(i32))
    remf_lo = torch.where(aux_algo, _lo32(aux), remf_lo_f.view(i32))
    zero = torch.zeros_like(limit)
    new16 = torch.stack(
        [
            _lo32(fp), _hi32(fp), limit, burst, rem_i, algo | (status << 8),
            _lo32(dur), _hi32(dur), _lo32(stamp), _hi32(stamp),
            _lo32(exp), _hi32(exp), remf_hi, remf_lo, zero, zero,
        ],
        dim=1,
    )
    return exists, new16


def merge2_impl(table: Table2, fp, slots, now, active, *, write: str = "xla",
                evictees: bool = False, probe: str = "xla"):
    """Conservative merge of transferred canonical (B, 16) int32 slot rows
    (JAX kernel2.merge2_impl, the TransferState receive path). Incoming
    rows already expired at `now` are dropped; absent keys install the
    incoming slot verbatim. Updates ``table.rows`` in place; returns
    (table, merged mask), plus the (B, 16) evictee sidecar with
    ``evictees=True``. ``probe="pallas"`` runs the fused walk."""
    if probe not in ("xla", "pallas"):
        raise ValueError(f"unknown probe kernel {probe!r}; expected 'xla' or 'pallas'")
    now = torch.broadcast_to(torch.as_tensor(now, dtype=i64, device=fp.device), fp.shape)
    i_exp = _join64(slots[:, EXP_LO], slots[:, EXP_HI])
    active = active & (i_exp >= now)
    if probe == "pallas":
        from gubernator_tpu_torch.ops.probe_walk import walk2_pallas_impl

        return walk2_pallas_impl(
            table, fp, slots, now, active, stage="merge", evictees=evictees
        )
    B = fp.shape[0]
    c = _claim_for(table, write, fp, now, active)
    lane16 = c.slots[torch.arange(B, device=fp.device), c.chosen]
    _exists, new16 = merge_payload16(fp, slots, lane16, c.owns, now)
    _write_claim(table, new16, c)
    if evictees:
        ev16 = torch.where(c.evict_live[:, None], lane16, torch.zeros_like(lane16))
        return table, active & c.written, ev16
    return table, active & c.written
