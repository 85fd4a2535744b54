"""Packed-row device table: one bucket per row (the port of
``gubernator_tpu/ops/table2.py``).

``rows`` is an (NB, K·layout.F) int32 tensor — NB buckets, each row K=8
slots of layout.F int32 fields, slot-major. A full-layout row is 128 int32
(512 B). Per-slot field order (full layout): fp_lo, fp_hi, limit, burst,
rem_i, flags(algo | status<<8), dur_lo, dur_hi, stamp_lo, stamp_hi, exp_lo,
exp_hi, remf_hi(f32 bits), remf_lo(f32 bits), reserved, reserved. fp == 0
marks an empty slot; the bucket of a key is fp % NB.

The bytes are the JAX table's bytes: ``table_from_numpy`` and
``table_to_numpy`` carry a table between the two packages unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gubernator_tpu_torch.device import resolve_device
from gubernator_tpu_torch.ops.layout import FULL, SlotLayout, host_tensor, layout_for_row

K = 8  # slots per bucket
F = 16  # int32 fields per slot in the canonical FULL layout
ROW = K * F  # 128 int32 lanes per full-layout bucket row

# field indices within a FULL-layout slot
FP_LO, FP_HI, LIMIT, BURST, REM_I, FLAGS = 0, 1, 2, 3, 4, 5
DUR_LO, DUR_HI, STAMP_LO, STAMP_HI, EXP_LO, EXP_HI = 6, 7, 8, 9, 10, 11
REMF_HI, REMF_LO = 12, 13


class Table2:
    """One device table: a rows tensor plus the SlotLayout addressing it.
    Without a layout, the full layout is inferred from the 128-lane width."""

    __slots__ = ("rows", "layout")

    def __init__(self, rows: torch.Tensor, layout: Optional[SlotLayout] = None):
        if layout is None:
            layout = layout_for_row(int(rows.shape[-1]))
        self.rows = rows
        self.layout = layout

    @property
    def n_buckets(self) -> int:
        return self.rows.shape[-2]

    @property
    def capacity(self) -> int:
        return self.rows.shape[-2] * K

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"Table2(rows={tuple(self.rows.shape)}, layout={self.layout.name})"


def n_buckets_for(capacity: int) -> int:
    """Bucket count for a requested slot capacity: a power of two up to 2048
    buckets, a multiple of 2048 above (the write geometry divides evenly)."""
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    nb = -(-capacity // K)
    if nb <= 2048:
        p = 1
        while p < nb:
            p *= 2
        return p
    return -(-nb // 2048) * 2048


def new_table2(capacity: int, layout: Optional[SlotLayout] = None,
               device=None) -> Table2:
    """Fresh empty table on `device` (None = the card)."""
    layout = FULL if layout is None else layout
    dev = resolve_device(device)
    rows = torch.zeros(
        (n_buckets_for(capacity), layout.row), dtype=torch.int32, device=dev
    )
    return Table2(rows=rows, layout=layout)


def table_from_numpy(rows: np.ndarray, layout: Optional[SlotLayout] = None,
                     device=None) -> Table2:
    """A table whose bytes are exactly `rows` (an (NB, K·F) int32 array, e.g.
    ``np.asarray`` of a JAX table's rows)."""
    rows = np.asarray(rows)
    if rows.dtype != np.int32 or rows.ndim != 2:
        raise ValueError(f"rows must be a 2-D int32 array, got {rows.dtype} {rows.shape}")
    layout = layout_for_row(int(rows.shape[-1])) if layout is None else layout
    if rows.shape[-1] != layout.row:
        raise ValueError(f"row width {rows.shape[-1]} != layout {layout.name} ({layout.row})")
    dev = resolve_device(device)
    t = torch.from_numpy(np.array(rows, dtype=np.int32, order="C", copy=True))
    return Table2(rows=t.to(dev), layout=layout)


def table_to_numpy(table: Table2) -> np.ndarray:
    """Host copy of the table's bytes, as the JAX package stores them."""
    return table.rows.detach().cpu().numpy().copy()


def _slot_fp_exp(slots: torch.Tensor, layout: SlotLayout):
    i64 = torch.int64
    fp = (slots[..., FP_HI].to(i64) << 32) | (slots[..., FP_LO].to(i64) & 0xFFFFFFFF)
    exp = (slots[..., layout.exp_hi_i].to(i64) << 32) | (
        slots[..., layout.exp_lo_i].to(i64) & 0xFFFFFFFF
    )
    return fp, exp


def live_count2(table: Table2, now_ms: int) -> int:
    """Live (non-empty, unexpired) slots — reference cache Size()
    (lrucache.go:152-157). Counted on the table's device."""
    slots = table.rows.view(-1, K, table.layout.F)
    fp, exp = _slot_fp_exp(slots, table.layout)
    return int(((fp != 0) & (exp >= now_ms)).sum().item())


def decode_live_slots(rows, now_ms: int, layout: Optional[SlotLayout] = None):
    """Flatten a rows tensor (or numpy array) into live slot records:
    (slot_fields (N, F) int32, fp (N,) int64, exp (N,) int64) for slots that
    are non-empty and unexpired at now_ms, in table order and in the table's
    own layout. Numpy in, numpy out."""
    if isinstance(rows, np.ndarray):
        out = decode_live_slots(host_tensor(rows), now_ms, layout)
        return tuple(t.numpy() for t in out)
    layout = layout_for_row(int(rows.shape[-1])) if layout is None else layout
    slots = rows.reshape(-1, layout.F)
    fp, exp = _slot_fp_exp(slots, layout)
    live = (fp != 0) & (exp >= now_ms)
    return slots[live], fp[live], exp[live]


# ------------------------------------------------------------- handoff ops
#
# Topology change, tiering and the region plane read the table through a
# whole-table filter + pack on the device: the selected slots sorted to the
# front by a STABLE sort (so they keep table order), and the host fetches
# only that prefix, padded to a power of two from 256 — one device→host copy
# of `pad` rows, never the whole sorted table.


def _front(slots: torch.Tensor, fp: torch.Tensor, keep: torch.Tensor):
    """The rows with `keep` set sorted to the front, in table order
    (jnp.argsort of the 0/1 key is stable): (slots, fp, count tensor)."""
    order = torch.argsort(torch.where(keep, 0, 1).to(torch.int32), stable=True)
    return slots[order], fp[order], keep.sum()


def _extract_sorted(rows: torch.Tensor, now_ms: int, *, layout: SlotLayout):
    """Device filter + pack over any (..., K·F) rows tensor: (slots (N, F)
    live-first, fp (N,), live count) with the live slots in the first
    `count` positions, in table order and in the table's own layout."""
    slots = rows.reshape(-1, layout.F)
    fp, exp = _slot_fp_exp(slots, layout)
    return _front(slots, fp, (fp != 0) & (exp >= now_ms))


def _fetch_prefix(slots_s: torch.Tensor, fp_s: torch.Tensor, n: int, width: int):
    """Host copies of the first `n` sorted rows: (fps (n,) int64, slots (n,
    width) int32). One device→host copy of the prefix padded to a power of
    two from 256 (at most the whole array)."""
    if n == 0:
        return np.empty(0, dtype=np.int64), np.empty((0, width), dtype=np.int32)
    pad = 256
    while pad < n:
        pad *= 2
    pad = min(pad, int(fp_s.shape[0]))
    return (fp_s[:pad].cpu().numpy()[:n].copy(),
            slots_s[:pad].cpu().numpy()[:n].copy())


def extract_live_rows(rows: torch.Tensor, now_ms: int,
                      layout: Optional[SlotLayout] = None):
    """Every live slot of a rows tensor as host copies: (fps (N,) int64,
    slots (N, F) int32), in table order and the table's own layout."""
    layout = layout_for_row(int(rows.shape[-1])) if layout is None else layout
    slots_s, fp_s, cnt = _extract_sorted(rows, now_ms, layout=layout)
    return _fetch_prefix(slots_s, fp_s, int(cnt), layout.F)


def _extract_idle_core(rows2d: torch.Tensor, now_ms: int, idle_ms: int,
                       layout: SlotLayout):
    """Live slots whose last-activity reference (layout.idle_ref) is at
    least `idle_ms` behind `now_ms`, sorted to the front: (slots (T·K, F)
    idle-first, fp (T·K,), idle count) of a (T, K·F) rows tensor."""
    slots = rows2d.reshape(-1, layout.F)
    fp, exp = _slot_fp_exp(slots, layout)
    live = (fp != 0) & (exp >= now_ms)
    idle = live & ((now_ms - layout.idle_ref(slots)) >= idle_ms)
    return _front(slots, fp, idle)


def _extract_idle_sorted(rows: torch.Tensor, now_ms: int, idle_ms: int, *,
                         layout: SlotLayout):
    """Single-array entry: any (..., K·F) rows tensor."""
    return _extract_idle_core(rows.reshape(-1, layout.row), now_ms, idle_ms, layout)


def extract_idle_rows(rows: torch.Tensor, now_ms: int, idle_ms: int,
                      layout: Optional[SlotLayout] = None, max_rows: int = 1 << 16):
    """Live slots idle past the horizon as host copies: (fps (N,) int64,
    slots (N, F) int32), N ≤ max_rows (the per-sweep demote cap; the rest
    waits for the next sweep), in table order."""
    layout = layout_for_row(int(rows.shape[-1])) if layout is None else layout
    slots_s, fp_s, cnt = _extract_idle_sorted(rows, now_ms, idle_ms, layout=layout)
    return _fetch_prefix(slots_s, fp_s, min(int(cnt), int(max_rows)), layout.F)


def _bucket_match(rows: torch.Tensor, fp: torch.Tensor, active: torch.Tensor, F_l: int):
    """One bucket-row gather and the lane match of each fingerprint:
    (bucket (B,) int64, bucket slots (B, K, F_l), match (B, K) bool)."""
    NB = rows.shape[0]
    B = fp.shape[0]
    bucket = fp % NB
    b_rows = rows.index_select(0, bucket).view(B, K, F_l)
    my_lo = (fp & 0xFFFFFFFF).to(torch.int32)
    my_hi = (fp >> 32).to(torch.int32)
    s_lo = b_rows[:, :, FP_LO]
    s_hi = b_rows[:, :, FP_HI]
    empty = (s_lo == 0) & (s_hi == 0)
    match = (s_lo == my_lo[:, None]) & (s_hi == my_hi[:, None]) & ~empty & active[:, None]
    return bucket, b_rows, match


def gather_slots_impl(rows: torch.Tensor, fp: torch.Tensor, active: torch.Tensor,
                      layout: Optional[SlotLayout] = None):
    """Read the slot holding each fingerprint without mutating anything:
    one bucket-row gather + lane match (the first matching lane), unpacked
    to canonical fields. Returns (full_slots (B, 16) int32, found (B,)
    bool); expiry is not checked."""
    layout = layout_for_row(int(rows.shape[-1])) if layout is None else layout
    _bucket, b_rows, match = _bucket_match(rows, fp, active, layout.F)
    full = layout.unpack(b_rows)  # (B, K, 16); fp fields are 0/1 in every layout
    found = match.any(dim=1)
    lane = match.to(torch.int32).argmax(dim=1)  # first matching lane
    lane16 = full[torch.arange(fp.shape[0], device=fp.device), lane]
    return torch.where(found[:, None], lane16, torch.zeros_like(lane16)), found


def tombstone_rows_impl(rows: torch.Tensor, fp: torch.Tensor, active: torch.Tensor):
    """Zero the slot holding each fingerprint, IN PLACE (the JAX package
    donates the table instead), and return found (B,) bool. Missing
    fingerprints kill nothing: the kill mask has a sentinel row NB·K that
    every unmatched row targets. Layout-agnostic: only the fingerprint pair
    (fields 0/1 in every layout) and the row geometry are read."""
    NB = rows.shape[0]
    F_l = rows.shape[-1] // K
    bucket, _rows, match = _bucket_match(rows, fp, active, F_l)
    lane = match.to(torch.int32).argmax(dim=1)
    found = match.any(dim=1)
    NBK = NB * K
    tgt = torch.where(found, bucket * K + lane, torch.full_like(bucket, NBK))
    kill = torch.zeros(NBK + 1, dtype=torch.bool, device=rows.device)
    kill[tgt] = True
    flat = rows.view(NBK, F_l)
    flat.masked_fill_(kill[:NBK, None], 0)
    return found


def rehash_rows(rows: np.ndarray, new_n_buckets: int, now_ms: int,
                layout: Optional[SlotLayout] = None):
    """Re-place every live slot into a table of `new_n_buckets` buckets (the
    host side of a resize; placement is bucket = fp % NB). Buckets that
    receive more than K live entries keep the K latest-expiring and drop
    the rest. Returns (new rows array, dropped count), same slot layout."""
    layout = layout_for_row(int(rows.shape[-1])) if layout is None else layout
    slots, fp, exp = decode_live_slots(rows, now_ms, layout=layout)
    out = np.zeros((new_n_buckets, layout.row), dtype=np.int32)
    if fp.shape[0] == 0:
        return out, 0
    bucket = fp % new_n_buckets
    # rank entries within their new bucket, latest-expiring first
    order = np.lexsort((-exp, bucket))
    b_sorted = bucket[order]
    first = np.concatenate([[True], b_sorted[1:] != b_sorted[:-1]])
    pos = np.arange(b_sorted.shape[0])
    start = np.maximum.accumulate(np.where(first, pos, -1))
    lane = (pos - start).astype(np.int64)
    keep = lane < K
    dropped = int((~keep).sum())
    tgt = b_sorted[keep] * K + lane[keep]
    out.reshape(-1, layout.F)[tgt] = slots[order[keep]]
    return out, dropped
