"""Compact host↔device wire codec (the port of ``gubernator_tpu/ops/wire.py``).

A dispatch ships either the full-width (12, B) int64 ingress grid and
fetches a (B+2, 4) int64 output, or — when the batch is representable —
this narrow pair:

**Ingress — 5 int32 lanes (20 B/row) + one trailing base column:**

  lane 0  fp_lo          low 32 bits of the fingerprint
  lane 1  fp_hi          high 32 bits (fp == 0 ⇒ inactive row)
  lane 2  limit          full int32
  lane 3  duration[0:27] | algo << 27 (3 bits) | cascade_level << 30 (2 bits)
  lane 4  hits[0:18] | (created_delta + 512) << 18 | priority << 28
          | RESET << 30 | DRAIN << 31

  column B (the +1): cells [0, B], [1, B] carry the batch's created_at BASE
  (lo/hi int32); every other per-row timestamp decodes base-relative.

**Egress — (B+2, 4) int32 (16 B/row), the row layout of
kernel2.pack_outputs:** row i < B is [limit, remaining (saturating),
reset_delta, flags]; row B the four counters; row B+1 [dropped, base_lo,
base_hi, 0]. reset_delta = reset_time - base, with -2^31 reserved as the
"reset == 0" sentinel; the base rides in the spare stats cells, so the
fetched array is self-describing (kernel2.unpack_outputs dispatches on its
dtype).

The host half (encode, encodability, grid assembly, decode of fetched
outputs) is numpy and packs the same bytes as the JAX package; the device
half (``decode_wire_block``, ``encode_wire_out``, ``decide2_wire_cols_impl``)
is torch ops, as it was plain XLA there. The bit layout and behaviour bits
are this module's own copies of the JAX package's constants.

A batch the narrow layout cannot represent (Gregorian durations, hits ≥
2^18, durations ≥ 2^27 ms, created_at skew beyond ±511 ms of the base,
negative limits, explicit leaky/GCRA bursts) takes the full-width path:
same semantics, more bytes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from gubernator_tpu_torch.ops.batch import HostBatch
from gubernator_tpu_torch.ops.kernel2 import (
    FLAG_DROPPED,
    FLAG_HIT,
    FLAG_STATUS,
    _hi32,
    _join64,
    _lo32,
    attach_evictees_wire,
    decide2_packed_cols_impl,
    decide2_packed_dedup_impl,
    decide2_packed_impl,
    fold_cascade_packed,
    req_from_arr,
)

i32 = torch.int32
i64 = torch.int64

WIRE_LANES = 5  # ingress int32 lanes per row (20 B) — + 1 base column/grid
WIRE_EGRESS_ROW_BYTES = 16  # (·, 4) int32 egress rows
DUR_BITS = 27  # duration < 2^27 ms (~37 hours); beyond → full-width
ALGO_BITS = 3  # five algorithms
LEVEL_SHIFT = DUR_BITS + ALGO_BITS  # cascade level, 2 bits (30, 31)
LEVEL_MAX = 3  # deeper cascades → full-width
HITS_BITS = 18  # hits in [0, 2^18)
DELTA_BITS = 10  # created_at - base in [-512, 511] ms
DELTA_BIAS = 1 << (DELTA_BITS - 1)
PRIO_SHIFT = HITS_BITS + DELTA_BITS  # priority tier, 2 bits (28, 29)
_DUR_MASK = (1 << DUR_BITS) - 1
_ALGO_MASK = (1 << ALGO_BITS) - 1
_HITS_MASK = (1 << HITS_BITS) - 1
_DELTA_MASK = (1 << DELTA_BITS) - 1
RESET_SENTINEL = -(2**31)  # egress reset_delta value for reset_time == 0
_BEH_LEVEL_SHIFT = 8  # behavior-word cascade level field
_BEH_PRIO_SHIFT = 6  # behavior-word priority tier field
_MAX_ALGO = 4  # highest wire-encodable algorithm

# behavior bits (types.Behavior values, frozen by the proto)
_RESET = 8  # RESET_REMAINING — read by the decision math
_DRAIN = 32  # DRAIN_OVER_LIMIT — read by the decision math
_GREG = 4  # DURATION_IS_GREGORIAN — host-resolved; forces full-width
_INERT = 1 | 2 | 16  # NO_BATCHING | GLOBAL | MULTI_REGION: never read by the math
_PRIO_BEH = 0x3 << _BEH_PRIO_SHIFT  # priority tier — carried in lane 4
_ENCODABLE_BEHAVIOR = _RESET | _DRAIN | _INERT | _PRIO_BEH

I32_MAX = 2**31 - 1


def default_wire_mode(device=None) -> str:
    """Compact grids on the card, full-width on the CPU (the parity
    oracle); GUBER_WIRE_COMPACT=1/0 forces either. ``device=None`` means
    the card, as for the engine."""
    env = os.environ.get("GUBER_WIRE_COMPACT")
    if env is not None:
        return "compact" if env not in ("0", "false", "off") else "full"
    dev = torch.device("cuda" if device is None else device)
    return "compact" if dev.type == "cuda" else "full"


# ------------------------------------------------------------- host encode


def pick_base(b: HostBatch) -> int:
    """The batch's created_at base: the first active row's stamp."""
    act = np.asarray(b.active)
    if not act.any():
        return 0
    return int(b.created_at[int(np.argmax(act))])


def wire_encodable(b: HostBatch, base: int) -> bool:
    """Can this batch ride the compact wire exactly? Every check guards a
    field the compact layout narrows or recomputes; failing one sends the
    dispatch full-width (same semantics, more bytes)."""
    act = np.asarray(b.active)
    if not act.any():
        return True
    fp = b.fp[act]
    if (fp == 0).any():
        return False  # active ⟺ fp != 0 is the decode's activity rule
    beh = b.behavior[act].astype(np.int64)
    # bits 0..7 are behavior flags, 8..15 the cascade level; anything
    # above is unknown → full-width
    if (beh & ~np.int64((0xFF << _BEH_LEVEL_SHIFT) | _ENCODABLE_BEHAVIOR)).any():
        return False  # Gregorian (host-resolved calendar fields) or unknown
    lvl = (beh >> _BEH_LEVEL_SHIFT) & 0xFF
    if (lvl > LEVEL_MAX).any():
        return False  # cascade deeper than the 2-bit lane budget
    if (b.greg_interval[act] != 0).any():
        return False
    dur = b.duration[act]
    if ((dur < 0) | (dur > _DUR_MASK)).any():
        return False
    if (b.duration_eff[act] != dur).any():
        return False
    created = b.created_at[act]
    if (b.expire_new[act] != created + dur).any():
        return False  # expire recomputes on the device only for the linear rule
    delta = created - base
    if ((delta < -DELTA_BIAS) | (delta > DELTA_BIAS - 1)).any():
        return False
    hits = b.hits[act]
    if ((hits < 0) | (hits > _HITS_MASK)).any():
        return False  # negative hits (lease releases) ride full-width
    limit = b.limit[act]
    if ((limit < 0) | (limit > I32_MAX)).any():
        return False  # negative limits keep the full-width path's arithmetic
    algo = b.algo[act]
    if ((algo < 0) | (algo > _MAX_ALGO)).any():
        return False
    burst = b.burst[act]
    bursty = (algo == 1) | (algo == 2)  # leaky / GCRA: burst derived from limit
    if bursty.any() and (burst[bursty] != limit[bursty]).any():
        return False  # explicit bursts ship full-width
    nob = (algo == 3) | (algo == 4)  # window / lease: burst unused, keep 0
    if nob.any() and (burst[nob] != 0).any():
        return False
    return True


def pack_wire_rows(b: HostBatch, base: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack a (wire_encodable) HostBatch into (5, n) int32 data lanes.
    Inactive rows encode as all-zero columns. `out` packs in place."""
    n = b.fp.shape[0]
    if out is None:
        arr = np.empty((WIRE_LANES, n), dtype=np.int32)
    else:
        if out.shape != (WIRE_LANES, n) or out.dtype != np.int32:
            raise ValueError(f"out must be a ({WIRE_LANES}, {n}) int32 array")
        arr = out
    act = b.active
    fp = np.where(act, b.fp, 0)
    arr[0] = fp.astype(np.int64).astype(np.int32)  # low 32, wrap cast
    arr[1] = (fp >> 32).astype(np.int32)
    arr[2] = np.where(act, b.limit, 0).astype(np.int32)
    lvl = (b.behavior.astype(np.int64) >> _BEH_LEVEL_SHIFT) & 0xFF
    l3 = (
        (b.duration & _DUR_MASK)
        | (b.algo.astype(np.int64) << DUR_BITS)
        | (lvl << LEVEL_SHIFT)
    )
    arr[3] = np.where(act, l3, 0).astype(np.int64).astype(np.int32)
    reset = (b.behavior & _RESET) != 0
    drain = (b.behavior & _DRAIN) != 0
    prio = (b.behavior.astype(np.int64) >> _BEH_PRIO_SHIFT) & 0x3
    l4 = (
        (b.hits & _HITS_MASK)
        | (((b.created_at - base + DELTA_BIAS) & _DELTA_MASK) << HITS_BITS)
        | (prio << PRIO_SHIFT)
        | (reset.astype(np.int64) << 30)
        | (drain.astype(np.int64) << 31)
    )
    arr[4] = np.where(act, l4, 0).astype(np.int64).astype(np.int32)
    return arr


def pack_wire_full(b: HostBatch, base: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """(5, n+1) int32: data lanes plus the trailing base column."""
    n = b.fp.shape[0]
    if out is None:
        arr = np.zeros((WIRE_LANES, n + 1), dtype=np.int32)
    else:
        if out.shape != (WIRE_LANES, n + 1) or out.dtype != np.int32:
            raise ValueError(f"out must be a ({WIRE_LANES}, {n + 1}) int32 array")
        arr = out
        arr[:, n] = 0
    pack_wire_rows(b, base, out=arr[:, :n])
    stamp_base(arr, base)
    return arr


def assemble_wire_grid(lane_parts, created: np.ndarray, base: int, pad: int,
                       active: np.ndarray) -> np.ndarray:
    """Front-door staging: scatter pre-packed per-request lane blocks (the
    parser's (5, n_i) int32 images, created-delta bits zero) into ONE
    padded (5, pad+1) grid, OR the batch-relative created deltas into lane
    4 and stamp the base column. `created` holds the stamped absolute
    created_at over the concatenated rows; callers check the delta budget
    (±511 ms of `base`) first."""
    grid = np.zeros((WIRE_LANES, pad + 1), dtype=np.int32)
    off = 0
    for lanes in lane_parts:
        w = lanes.shape[1]
        grid[:, off : off + w] = lanes
        off += w
    delta32 = (((created - base + DELTA_BIAS) & _DELTA_MASK) << HITS_BITS).astype(np.int32)
    grid[4, :off] |= np.where(active, delta32, np.int32(0))
    stamp_base(grid, base)
    return grid


def grid_math_mode(grid: np.ndarray, n: int) -> str:
    """Math mode of an assembled wire grid (the lane-level twin of
    engine._math_mode): all-token → "token", a leaky row → "mixed", all
    active rows GCRA → "gcra", otherwise "int"."""
    algo = (grid[3, :n].astype(np.int64) >> DUR_BITS) & _ALGO_MASK
    if (algo == 1).any():
        return "mixed"
    if not algo.any():
        return "token"
    act = algo[(grid[0, :n] != 0) | (grid[1, :n] != 0)]
    if act.size and (act == 2).all():
        return "gcra"
    return "int"


def grid_has_cascade(grid: np.ndarray, n: int) -> bool:
    """Whether an assembled wire grid carries cascade level bits (lane 3
    bits 30-31)."""
    return bool(((grid[3, :n].astype(np.int64) >> LEVEL_SHIFT) & 3).any())


def stamp_base(block: np.ndarray, base: int) -> None:
    """Write the base into a wire block's trailing column (cells [0, -1]
    and [1, -1]), the cells decode_wire_block reads."""
    block[0, -1] = np.int64(base).astype(np.int32)
    block[1, -1] = np.int64(base >> 32).astype(np.int32)


# ----------------------------------------------------------- device decode


def decode_wire_block(blk: torch.Tensor):
    """Decode one (5, W+1) int32 wire block back to the full (12, W) int64
    ingress tensor (kernel2.req_from_arr layout) plus the base (a 0-d int64
    tensor). Casts and shifts only; int32 ``>>`` is arithmetic, so every
    field is masked after its shift."""
    W = blk.shape[1] - 1
    base = _join64(blk[0, W], blk[1, W])
    l0, l1, l2, l3, l4 = (blk[i, :W] for i in range(WIRE_LANES))
    fp = _join64(l0, l1)
    limit = l2.to(i64)
    dur = (l3 & _DUR_MASK).to(i64)
    algo = (l3 >> DUR_BITS) & _ALGO_MASK
    level = (l3 >> LEVEL_SHIFT) & 3
    hits = (l4 & _HITS_MASK).to(i64)
    delta = (((l4 >> HITS_BITS) & _DELTA_MASK) - DELTA_BIAS).to(i64)
    behavior = (
        ((l4 >> 30) & 1) * _RESET
        | ((l4 >> 31) & 1) * _DRAIN
        | (((l4 >> PRIO_SHIFT) & 3) << _BEH_PRIO_SHIFT)
        | (level << _BEH_LEVEL_SHIFT)
    )
    created = base + delta
    active = fp != 0
    # burst reconstructs to limit for leaky and GCRA (the pack-side
    # defaulting), 0 otherwise
    burst = torch.where((algo == 1) | (algo == 2), limit, torch.zeros_like(limit))
    arr12 = torch.stack(
        [
            fp,
            algo.to(i64),
            behavior.to(i64),
            hits,
            limit,
            burst,
            dur,
            created,
            created + dur,  # expire_new (non-Gregorian by encodability)
            torch.zeros_like(fp),  # greg_interval
            dur,  # duration_eff
            active.to(i64),
        ]
    )
    return arr12, base


def encode_wire_out(packed: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Narrow the (B+2, 4) int64 pack_outputs tensor to int32: reset as a
    base-relative delta (RESET_SENTINEL keeps reset == 0 exact), the other
    cells clamped to int32 in int64 before the cast, and the base stamped
    into the spare stats cells."""
    B = packed.shape[0] - 2
    rows = packed[:B]
    sat = lambda x: torch.clamp(x, -(2**31), 2**31 - 1).to(i32)
    reset = rows[:, 2]
    enc = torch.where(
        reset == 0,
        torch.full_like(reset, RESET_SENTINEL),
        torch.clamp(reset - base, -(2**31) + 1, 2**31 - 1),
    ).to(i32)
    body = torch.stack([sat(rows[:, 0]), sat(rows[:, 1]), enc, sat(rows[:, 3])], dim=1)
    stats = sat(packed[B:])
    stats[1, 1] = _lo32(base)
    stats[1, 2] = _hi32(base)
    return torch.cat([body, stats], dim=0)


# -------------------------------------------------------------- host decode


def decode_wire_host(lanes: np.ndarray, base: int) -> dict:
    """Host decode of a (5, n) int32 lane image (pack_wire_rows layout)
    back to full-width int64 columns — the numpy twin of
    decode_wire_block."""
    lanes = np.asarray(lanes, dtype=np.int32)
    l0, l1, l2, l3, l4 = (lanes[i].astype(np.int64) for i in range(WIRE_LANES))
    fp = (l0 & 0xFFFFFFFF) | (l1 << 32)
    dur = l3 & _DUR_MASK
    algo = (l3 >> DUR_BITS) & _ALGO_MASK
    level = (l3 >> LEVEL_SHIFT) & 3
    hits = l4 & _HITS_MASK
    delta = ((l4 >> HITS_BITS) & _DELTA_MASK) - DELTA_BIAS
    behavior = (
        ((l4 >> 30) & 1) * _RESET
        | ((l4 >> 31) & 1) * _DRAIN
        | (((l4 >> PRIO_SHIFT) & 3) << _BEH_PRIO_SHIFT)
        | (level << _BEH_LEVEL_SHIFT)
    )
    created = base + delta
    return {
        "fp": fp,
        "algo": algo.astype(np.int32),
        "behavior": behavior.astype(np.int32),
        "hits": hits,
        "limit": l2,
        "duration": dur,
        "created_at": created,
        "active": fp != 0,
    }


def wire_out_base(arr: np.ndarray) -> int:
    """The base stamped into a fetched compact egress array."""
    return (int(arr[-1, 1]) & 0xFFFFFFFF) | (int(arr[-1, 2]) << 32)


def decode_wire_rows(per: np.ndarray, base: int) -> np.ndarray:
    """Host decode of compact egress response rows ((n, 4) int32 → int64,
    absolute reset_time). Returns a fresh writable array."""
    out = per.astype(np.int64)
    d = out[:, 2]
    out[:, 2] = np.where(d == RESET_SENTINEL, 0, base + d)
    return out


def unpack_wire_out(arr: np.ndarray, n: int):
    """Compact counterpart of kernel2.unpack_outputs (same return shape)."""
    base = wire_out_base(arr)
    st = (int(arr[-2, 0]), int(arr[-2, 1]), int(arr[-2, 2]), int(arr[-2, 3]))
    per = decode_wire_rows(arr[:n], base)
    status = (per[:, 3] & FLAG_STATUS).astype(np.int32)
    hit = (per[:, 3] & FLAG_HIT) != 0
    dropped = (per[:, 3] & FLAG_DROPPED) != 0
    return (status, per[:, 0], per[:, 1], per[:, 2], dropped, hit), st


# --------------------------------------------------- single-device entries


def decide2_wire_cols_impl(
    table, carr, *, write="sweep", math="mixed", cascade=False, probe="xla",
    evictees=False,
):
    """Compact serving entry: (5, B+1) int32 wire block in, (B+2, 4) int32
    outputs out — the narrow twin of kernel2.decide2_packed_cols_impl;
    ``table.rows`` is updated in place. ``cascade=True`` folds cascade
    verdicts on the wide packed tensor BEFORE the narrowing;
    ``evictees=True`` appends the raw int32 evictee sidecar after it
    (kernel2.attach_evictees_wire → (5B+2, 4))."""
    arr12, base = decode_wire_block(carr)
    if evictees:
        table, packed, ev16 = decide2_packed_impl(
            table, req_from_arr(arr12), write=write, math=math, probe=probe,
            evictees=True,
        )
        if cascade:
            packed = fold_cascade_packed(packed, arr12)
        return table, attach_evictees_wire(encode_wire_out(packed, base), ev16)
    table, packed = decide2_packed_cols_impl(
        table, arr12, write=write, math=math, cascade=cascade, probe=probe
    )
    return table, encode_wire_out(packed, base)


def decide2_wire_dedup_impl(
    table, carr, *, write="sweep", math="mixed", cascade=False, probe="xla"
):
    """Compact entry with in-dispatch dedup (the mesh engine's
    dedup="device" dispatch on the narrow wire)."""
    arr12, base = decode_wire_block(carr)
    table, packed = decide2_packed_dedup_impl(
        table, arr12, write=write, math=math, cascade=cascade, probe=probe
    )
    return table, encode_wire_out(packed, base)


# eager PyTorch has no jit/donation wrapper: the serving name is the impl
decide2_wire_cols = decide2_wire_cols_impl
