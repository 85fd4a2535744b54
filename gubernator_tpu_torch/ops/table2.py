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
from gubernator_tpu_torch.ops.layout import FULL, SlotLayout, layout_for_row

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


def decode_live_slots(rows: torch.Tensor, now_ms: int,
                      layout: Optional[SlotLayout] = None):
    """Flatten a rows tensor into live slot records: (slot_fields (N, F)
    int32, fp (N,) int64, exp (N,) int64) for slots that are non-empty and
    unexpired at now_ms, in table order and in the table's own layout."""
    layout = layout_for_row(int(rows.shape[-1])) if layout is None else layout
    slots = rows.reshape(-1, layout.F)
    fp, exp = _slot_fp_exp(slots, layout)
    live = (fp != 0) & (exp >= now_ms)
    return slots[live], fp[live], exp[live]
