"""The fused probe walk: one dispatch's whole table walk — bucket-row fetch,
claim, payload and dirty-row write-back — as one kernel (the port of
``gubernator_tpu/ops/pallas_probe.py``).

The TPU kernel there, ``_make_probe_kernel`` (launched by ``_launch_walk``),
streams bucket-sorted requests through VMEM in blocks, double-buffers the
row fetches, carries bucket runs that straddle blocks and defers the
write-back. All of that is VMEM and grid machinery. What it computes is:

* every row reads its bucket's PRE-dispatch bytes;
* the claim of ``kernel2._probe_claim2`` without its write-window drop:
  owner match, exact lazy expiry, insert rank among the bucket's active
  non-owners in batch order, the rank-th lane of (vacant first, then live
  by soonest expiry, then lane index), rank ≥ K dropped, an inserter whose
  lane any owner of the bucket holds dropped (owner wins), a duplicate
  owner after the first dropped;
* a payload per row — ``decide`` (``kernel2.decide_payload``), ``install``
  (the ``install_payload16`` rows, computed before the walk) or ``merge``
  (``kernel2.merge_payload16`` against the claimed lane);
* each written row's payload packed into its lane; where two inserters of
  one bucket choose one lane (possible only when their clocks order the
  lanes differently), the later row in batch order lands, as the JAX
  package's CPU scatter lands it;
* per row, in batch order, the (B, 8) int64 response columns (``OC_*``),
  widened to (B, 16) with the candidate victim row when ``evictees``.

On a CUDA tensor ``probe_walk`` launches the hand-written Hopper kernel
``csrc/probe_walk.cu`` (rows sorted by bucket in a torch prologue, then
one lane per row for the singleton buckets and the inactive rows, one warp
per run of two or more active rows of a bucket; design notes in the
source) or raises; ``probe_walk.launches`` counts its launches. On a CPU
tensor it runs the plain PyTorch version ``probe_walk_ref``, which
computes the batch as one block, as the JAX package does on its CPU
backend.

``GUBER_PROBE_BLK`` and ``GUBER_PROBE_MOVEMENT`` size VMEM blocks and pick
the interpret-mode data movement of the TPU kernel; they have no
counterpart here and are ignored: the kernel cuts the sorted rows into
chunks of its own, and the result does not depend on them in the JAX
package either (``tests/test_pallas_probe.py``).
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.device import stream_scratch
from gubernator_tpu_torch.ops.batch import ReqBatch
from gubernator_tpu_torch.ops.kernel2 import (
    _cummax,
    _first_of_run,
    _hi32,
    _join64,
    _lane_positions,
    _lo32,
    _unsort,
    assemble_resp,
    decide_payload,
    merge_payload16,
    resolve_write,
    sparse_geometry,
)
from gubernator_tpu_torch.ops.layout import FULL, GCRA32, TOKEN32
from gubernator_tpu_torch.ops.table2 import EXP_HI, EXP_LO, FP_HI, FP_LO, K, Table2

i32 = torch.int32
i64 = torch.int64

# response columns of the walk, in batch order
OC_STATUS, OC_REM, OC_RESET, OC_EXISTS = 0, 1, 2, 3
OC_WRITTEN, OC_EVICT, OC_AUX, OC_REMSTORE = 4, 5, 6, 7
OUTW = 8
# with evictees the rows widen by the evicted lane's canonical 16 fields as
# 8 (hi<<32)|lo pairs, zero unless the row evicted a live lane
OUTW_EV = 16

STAGES = ("decide", "install", "merge")
MATHS = ("token", "gcra", "int", "mixed")
_LAYOUT_CODES = {FULL: 0, GCRA32: 1, TOKEN32: 2}
UNIT_ROWS = 32  # sorted positions per chunk: one warp, one lane per position


def hbm_bytes_per_decision(
    layout, batch: int, n_buckets: int, write: str, probe: str = "xla"
) -> float:
    """Worst-case table bytes a walk moves per decision (JAX
    pallas_probe.hbm_bytes_per_decision): one bucket row read, plus one row
    written back for the fused walk, or the write mode's share for the
    gather + write path."""
    row_b = float(layout.row * 4)
    if probe == "pallas":
        return 2.0 * row_b
    w = resolve_write(write, n_buckets, batch, layout)
    if w == "sweep":
        write_b = 2.0 * n_buckets * row_b / max(batch, 1)
    elif w == "sparse":
        blk, _u, g = sparse_geometry(n_buckets, batch)
        write_b = 2.0 * min(g * blk, n_buckets) * row_b / max(batch, 1)
    else:
        write_b = float(layout.slot_bytes)
    return row_b + write_b


# ------------------------------------------------------------ plain version


def _stage_payload(stage, math, lane16, owns, fp, now, req, pay16):
    """(exists, Decision or None, canonical (B, 16) payload) of one stage."""
    if stage == "decide":
        exists, d, new16 = decide_payload(lane16, req, owns, math=math)
        return exists, d, new16
    if stage == "install":
        return owns, None, pay16
    exists, new16 = merge_payload16(fp, pay16, lane16, owns, now)
    return exists, None, new16


def probe_walk_ref(rows: torch.Tensor, layout, stage: str, fp, now, active, *,
                   req: ReqBatch = None, pay16=None, math: str = "mixed",
                   evictees: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the walk over the whole batch as one block
    (JAX ``_make_probe_kernel`` with one grid step). Updates ``rows`` in
    place and returns the (B, OUTW or OUTW_EV) int64 responses."""
    NB = rows.shape[0]
    B = fp.shape[0]
    dev = rows.device
    bucket = (fp % NB).to(i64)
    slots = layout.unpack(rows.index_select(0, bucket).view(B, K, layout.F))

    my_lo, my_hi = _lo32(fp), _hi32(fp)
    s_lo, s_hi = slots[:, :, FP_LO], slots[:, :, FP_HI]
    empty = (s_lo == 0) & (s_hi == 0)
    match = (s_lo == my_lo[:, None]) & (s_hi == my_hi[:, None]) & ~empty & active[:, None]
    owns = match.any(dim=1)
    own_j = match.to(i32).argmax(dim=1)
    exp64 = _join64(slots[:, :, EXP_LO], slots[:, :, EXP_HI])
    live = ~(empty | (~empty & (exp64 < now[:, None])))

    # segments of the bucket sort; inactive rows share one key past every
    # bucket, so they rank 0 and own nothing
    bkey = torch.where(active, bucket, torch.full_like(bucket, NB))
    bkey_s, perm = torch.sort(bkey, stable=True)
    first = _first_of_run(bkey_s)
    seg = torch.cumsum(first.to(i64), dim=0) - 1
    need = active & ~owns
    need_s = need[perm].to(i64)
    c_excl = torch.cumsum(need_s, dim=0) - need_s
    seg_base = _cummax(torch.where(first, c_excl, torch.full_like(c_excl, -1)))
    rank = _unsort(perm, c_excl - seg_base)

    # owner lanes over the whole segment (the dedup authority) and earlier
    # owners of the same lane (a duplicate owner after the first loses)
    lane = torch.arange(K, device=dev)
    ownerhot_s = ((lane[None, :] == own_j[:, None]) & owns[:, None]).to(i64)[perm]
    seg_own = torch.zeros((B, K), dtype=i64, device=dev).index_add_(0, seg, ownerhot_s)
    om = _unsort(perm, seg_own[seg] > 0)
    pre_own = torch.cumsum(ownerhot_s, dim=0) - ownerhot_s
    base_own = torch.cummax(
        torch.where(first[:, None], pre_own, torch.full_like(pre_own, -1)), dim=0
    ).values
    earlier = _unsort(perm, pre_own - base_own)
    owner_killed = owns & (earlier.gather(1, own_j[:, None].to(i64))[:, 0] > 0)

    lane_pos = _lane_positions(live, exp64)
    ins_lane = (lane_pos == torch.clamp(rank, 0, K - 1)[:, None]).to(i32).argmax(dim=1)
    chosen = torch.where(owns, own_j, ins_lane).to(i64)
    claim_ok = need & (rank < K)
    got = active & (owns | claim_ok)
    lane_live = live.gather(1, chosen[:, None])[:, 0]
    killed_ins = claim_ok & om.gather(1, chosen[:, None])[:, 0]
    written = got & ~killed_ins & ~owner_killed
    evict = claim_ok & lane_live & written

    lane16 = slots[torch.arange(B, device=dev), chosen]
    exists, d, new16 = _stage_payload(stage, math, lane16, owns, fp, now, req, pay16)
    pay = layout.pack(new16)

    # the write: written rows in sort order, the last one per slot lands
    tgt_s = (bucket * K + chosen)[perm]
    w_s = written[perm]
    key = torch.where(w_s, tgt_s, torch.full_like(tgt_s, NB * K))
    key_u, order = torch.sort(key, stable=True)
    last = torch.ones_like(w_s)
    last[:-1] = key_u[1:] != key_u[:-1]
    keep = last & (key_u < NB * K)
    src = perm[order[keep]]
    rows.view(-1, layout.F).index_copy_(0, key_u[keep], pay[src].contiguous())

    z = torch.zeros_like(fp)
    if d is not None:
        cols = [d.resp_status.to(i64), d.resp_rem, d.resp_reset]
        tail = [d.aux_out, d.rem_i_out]
    else:
        cols, tail = [z, z, z], [z, z]
    cols += [exists.to(i64), written.to(i64), evict.to(i64)] + tail
    out = torch.stack(cols, dim=1)
    if evictees:
        ev16 = torch.where(evict[:, None], lane16, torch.zeros_like(lane16))
        out = torch.cat([out, _join64(ev16[:, 0::2], ev16[:, 1::2])], dim=1)
    return out


# --------------------------------------------------------------- the kernel


class _WalkArgs(ctypes.Structure):
    """Mirror of ``struct WalkArgs`` in csrc/probe_walk.cu."""

    _fields_ = [
        ("rows", ctypes.c_void_p), ("nb", ctypes.c_longlong),
        ("F", ctypes.c_int), ("layout", ctypes.c_int),
        ("perm", ctypes.c_void_p), ("key_s", ctypes.c_void_p),
        ("sync", ctypes.c_void_p), ("B", ctypes.c_longlong),
        ("fp", ctypes.c_void_p), ("now", ctypes.c_void_p),
        ("algo", ctypes.c_void_p), ("behavior", ctypes.c_void_p),
        ("hits", ctypes.c_void_p), ("limit", ctypes.c_void_p),
        ("burst", ctypes.c_void_p), ("duration", ctypes.c_void_p),
        ("expire_new", ctypes.c_void_p), ("greg_interval", ctypes.c_void_p),
        ("duration_eff", ctypes.c_void_p),
        ("pay16", ctypes.c_void_p),
        ("resp", ctypes.c_void_p), ("outw", ctypes.c_int),
    ]


def _entry():
    """The C entry point, built and typed at first use."""
    fn = _build.load("probe_walk").guber_probe_walk
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(_WalkArgs),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def walk_schedule(fp: torch.Tensor, active: torch.Tensor, NB: int):
    """The kernel's prologue, in torch ops: the rows sorted stably by
    key = 2·bucket + inactive, so each bucket's active rows come first, in
    batch order, and its inactive rows after them. Returns (perm, key_s):
    the original row at each sorted position (int32) and the sorted keys
    (int32). The kernel finds its units in the sorted keys itself
    (``walk_units`` is their host model)."""
    key = (fp % NB).to(i32).mul_(2).add_(~active.to(torch.bool))
    key_s, perm = torch.sort(key, stable=True)
    return perm.to(i32), key_s


def walk_units(key_s: torch.Tensor):
    """Host model of the kernel's split of the sorted order (for tests and
    reports; the kernel derives the same from ``key_s`` on the card).
    Positions are cut into chunks of UNIT_ROWS, one warp each, served in
    reverse order of position, so a bucket's readers come before its
    writer. Returns (writers, readers), int64 arrays:

    * writers (first, end, waits): the sorted positions of one bucket's
      active rows, a singleton when end - first == 1, and the number of
      reader rows the writer waits for before its write-back (the
      bucket's inactive rows);
    * readers (chunk, first, end, counter): the inactive rows of one
      bucket inside one chunk, at most UNIT_ROWS, and the counter they
      add to — the first position of their bucket's inactive run, which is
      its writer's end — or -1 when the bucket has no active row."""
    k = key_s.detach().cpu().numpy().astype(np.int64)
    B = k.shape[0]
    if B == 0:
        return np.zeros((0, 3), np.int64), np.zeros((0, 4), np.int64)
    first = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    end = np.r_[first[1:], B]
    key = k[first]
    writers, readers = [], []
    for j, (s, e, kk) in enumerate(zip(first, end, key)):
        if kk % 2 == 0:
            follows = j + 1 < len(first) and key[j + 1] == kk + 1
            writers.append((s, e, end[j + 1] - e if follows else 0))
            continue
        counter = s if j > 0 and key[j - 1] == kk - 1 else -1
        for c in range(s // UNIT_ROWS, (e - 1) // UNIT_ROWS + 1):
            lo, hi = max(s, c * UNIT_ROWS), min(e, (c + 1) * UNIT_ROWS)
            readers.append((c, lo, hi, counter))
    return (np.asarray(writers, np.int64).reshape(-1, 3),
            np.asarray(readers, np.int64).reshape(-1, 4))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(rows, layout, stage, fp, now, active, req, pay16, math, evictees):
    resp, launch = _prepared(rows, layout, stage, fp, now, active, req, pay16, math,
                             evictees)
    launch()
    return resp


def _prepared(rows, layout, stage, fp, now, active, req, pay16, math, evictees):
    """(resp, launch): the walk's schedule and operands, and a callable
    that enqueues the kernel on them (each call one launch, writing
    `resp` and updating `rows` in place), so the kernel can be timed
    apart from the schedule's torch ops."""
    B = fp.shape[0]
    NB = rows.shape[0]
    outw = OUTW_EV if evictees else OUTW
    resp = torch.empty((B, outw), dtype=i64, device=rows.device)
    if B == 0:
        return resp, lambda: None
    if layout not in _LAYOUT_CODES:
        raise ValueError(f"no kernel rule for layout {layout!r}")
    if NB * K * 2 >= 2**31:
        raise ValueError("table too large for int32 slot ids")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned (the kernel copies bucket rows in bulk)")
    if active.shape != (B,) or active.device != rows.device:
        raise ValueError(f"active: expected ({B},) on {rows.device}")
    perm, key_s = walk_schedule(fp, active, NB)
    c = lambda t, dt: None if t is None else t.to(dt).contiguous()
    keep = dict(fp=c(fp, i64), now=c(now, i64), pay16=c(pay16, i32))
    if req is not None:
        keep.update(
            algo=c(req.algo, i32), behavior=c(req.behavior, i32),
            hits=c(req.hits, i64), limit=c(req.limit, i64), burst=c(req.burst, i64),
            duration=c(req.duration, i64), expire_new=c(req.expire_new, i64),
            greg_interval=c(req.greg_interval, i64),
            duration_eff=c(req.duration_eff, i64),
        )
    for name, t in keep.items():
        if t is not None and (t.device != rows.device or t.shape[0] != B):
            raise ValueError(f"{name}: expected ({B},...) on {rows.device}")
    args = _WalkArgs(
        rows=rows.data_ptr(), nb=NB, F=layout.F, layout=_LAYOUT_CODES[layout],
        perm=perm.data_ptr(), key_s=key_s.data_ptr(), B=B,
        resp=resp.data_ptr(), outw=outw,
        **{k: _ptr(v) for k, v in keep.items()},
    )

    def launch():
        fn = _entry()
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream(rows.device).cuda_stream
            args.sync = stream_scratch("probe_walk", rows.device, B + 2).data_ptr()
            err = fn(STAGES.index(stage), MATHS.index(math), ctypes.byref(args), stream)
        if err != 0:
            raise RuntimeError(f"probe_walk launch failed: cudaError {err}")
        probe_walk.launches += 1

    launch.operands = (perm, key_s, keep)  # `args` points into them
    return resp, launch


def probe_walk(rows: torch.Tensor, layout, stage: str, fp, now, active, *,
               req: ReqBatch = None, pay16=None, math: str = "mixed",
               evictees: bool = False) -> torch.Tensor:
    """One walk over the table: ``rows`` is updated in place and the
    (B, OUTW or OUTW_EV) int64 responses come back in batch order. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if math not in MATHS:
        raise ValueError(f"unknown math mode {math!r}")
    if (stage == "decide") != (req is not None) or (stage != "decide") != (pay16 is not None):
        raise ValueError("decide walks take req=, install/merge walks pay16=")
    if rows.dtype != i32 or not rows.is_contiguous() or rows.shape[-1] != layout.row:
        raise ValueError(f"rows must be a contiguous (NB, {layout.row}) int32 tensor")
    if rows.device.type == "cpu":
        return probe_walk_ref(rows, layout, stage, fp, now, active, req=req,
                              pay16=pay16, math=math, evictees=evictees)
    if rows.device.type != "cuda":
        raise ValueError(f"probe_walk runs on cuda or cpu tensors, got {rows.device}")
    return _launch(rows, layout, stage, fp, now, active, req, pay16, math, evictees)


probe_walk.launches = 0


# ------------------------------------------------------------- entry points


def _evictee_rows(out: torch.Tensor) -> torch.Tensor:
    evcols = out[:, OUTW:]
    ev16 = torch.stack([_lo32(evcols), _hi32(evcols)], dim=-1).reshape(-1, 16)
    return torch.where((out[:, OC_EVICT] != 0)[:, None], ev16, torch.zeros_like(ev16))


def decide2_pallas_impl(table: Table2, req: ReqBatch, *, math: str = "mixed",
                        evictees: bool = False):
    """The fused walk's decide dispatch (reached through
    ``kernel2.decide2_impl(probe="pallas")``). Updates ``table.rows`` in
    place; returns (table, RespBatch, BatchStats), plus the (B, 16) int32
    evictee sidecar when ``evictees=True``."""
    out = probe_walk(table.rows, table.layout, "decide", req.fp, req.created_at,
                     req.active, req=req, math=math, evictees=evictees)
    d_like = SimpleNamespace(
        resp_status=out[:, OC_STATUS].to(i32),
        resp_rem=out[:, OC_REM],
        resp_reset=out[:, OC_RESET],
        aux_out=out[:, OC_AUX],
        rem_i_out=out[:, OC_REMSTORE],
    )
    resp, stats = assemble_resp(
        req, d_like, out[:, OC_EXISTS] != 0, out[:, OC_WRITTEN] != 0,
        out[:, OC_EVICT] != 0,
    )
    if evictees:
        return table, resp, stats, _evictee_rows(out)
    return table, resp, stats


def walk2_pallas_impl(table: Table2, fp, pay16, now, active, *, stage: str,
                      evictees: bool = False):
    """The fused walk's install / merge (reached through
    ``kernel2.install2_impl`` / ``merge2_impl`` with ``probe="pallas"``).
    `pay16` is the (B, 16) int32 canonical ingress: the install rows, or
    the incoming slots to merge. Updates ``table.rows`` in place; returns
    (table, active & written), plus the evictee sidecar with
    ``evictees=True``."""
    if stage not in ("install", "merge"):
        raise ValueError(f"stage must be install or merge, got {stage!r}")
    now = torch.broadcast_to(torch.as_tensor(now, dtype=i64, device=fp.device), fp.shape)
    out = probe_walk(table.rows, table.layout, stage, fp, now, active,
                     pay16=pay16.to(i32), evictees=evictees)
    written = active & (out[:, OC_WRITTEN] != 0)
    if evictees:
        return table, written, _evictee_rows(out)
    return table, written


__all__ = [
    "decide2_pallas_impl",
    "hbm_bytes_per_decision",
    "probe_walk",
    "probe_walk_ref",
    "walk2_pallas_impl",
    "walk_schedule",
    "walk_units",
]
