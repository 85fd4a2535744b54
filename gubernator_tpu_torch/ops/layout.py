"""Slot-layout descriptors: the canonical 16-field row and the two packed
32 B rows (the port of ``gubernator_tpu/ops/layout.py``).

* ``full``    — 16×i32 (64 B): fp_lo fp_hi limit burst rem_i flags dur_lo
  dur_hi stamp_lo stamp_hi exp_lo exp_hi remf_hi remf_lo 0 0.
* ``gcra32``  — 8×i32 for all-GCRA tables: fp_lo fp_hi tat_lo tat_hi limit
  burst dur_lo meta, with meta = dur_hi[0:23] | status<<23. The TAT pair is
  the expiry pair; the stamp is dropped.
* ``token32`` — 8×i32 for all-token tables: fp_lo fp_hi rem_i limit exp_lo
  exp_hi dur_lo meta. The stamp is derived as exp - duration; Gregorian
  rows are not representable.

Pack and unpack work on int32 tensors of any leading shape, and on numpy
arrays, which they return as numpy (the host converters of the handoff,
checkpoint and tiering paths hand them host slots); every packed layout
converts through the canonical full row. ``resolve_layout`` reads the
same ``GUBER_SLOT_LAYOUT`` knob as the JAX package, and with no math hint it
gives ``full``, the layout this slice serves.
"""

from __future__ import annotations

import os

import numpy as np
import torch

K = 8  # slots per bucket — shared with table2 by construction

# canonical full-layout field indices (ops/table2.py)
_FP_LO, _FP_HI, _LIMIT, _BURST, _REM_I, _FLAGS = 0, 1, 2, 3, 4, 5
_DUR_LO, _DUR_HI, _STAMP_LO, _STAMP_HI, _EXP_LO, _EXP_HI = 6, 7, 8, 9, 10, 11
_REMF_HI, _REMF_LO = 12, 13

_ALGO_TOKEN = 0
_ALGO_GCRA = 2

_DUR_HI_MASK = 0x7FFFFF  # 23 bits of dur_hi → durations < 2^55 ms
_STATUS_SHIFT = 23


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a numpy array's values: shared when the array is
    contiguous and writable, else over a copy."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _host_or_tensor(fn):
    """Let a conversion take a numpy array as well as a tensor: the array
    goes through the tensor code on the CPU and comes back as numpy, so
    both forms compute exactly the same."""

    def wrapper(self, x):
        if isinstance(x, np.ndarray):
            return fn(self, host_tensor(x)).numpy()
        return fn(self, x)

    wrapper.__name__, wrapper.__doc__ = fn.__name__, fn.__doc__
    return wrapper


class SlotLayout:
    """One slot layout: geometry + pack/unpack to the canonical full row.
    Instances are module-level singletons compared by identity."""

    __slots__ = (
        "name", "code", "F", "modes", "algos", "greg_ok",
        "exp_lo_i", "exp_hi_i",
    )

    def __init__(self, name, code, F, modes, algos, greg_ok,
                 exp_lo_i, exp_hi_i):
        self.name = name
        self.code = code  # frame/wire version byte (full=0)
        self.F = F  # int32 fields per slot
        self.modes = modes  # math modes this layout can serve
        self.algos = algos  # storable algorithm ids (None = all)
        self.greg_ok = greg_ok  # Gregorian batches representable?
        # expiry pair position in the packed row (fp is always fields 0/1)
        self.exp_lo_i = exp_lo_i
        self.exp_hi_i = exp_hi_i

    @property
    def row(self) -> int:
        return K * self.F

    @property
    def slot_bytes(self) -> int:
        return self.F * 4

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"SlotLayout({self.name}, F={self.F})"

    # --------------------------------------------------------- conversion

    @_host_or_tensor
    def unpack(self, slots: torch.Tensor) -> torch.Tensor:
        """(..., F) int32 packed slot fields → (..., 16) canonical fields."""
        if self is FULL:
            return slots
        p = lambda i: slots[..., i]
        zero = torch.zeros_like(p(0))
        dur_hi = p(7) & _DUR_HI_MASK
        status = (p(7) >> _STATUS_SHIFT) & 0xFF
        if self is GCRA32:
            flags = (status << 8) | _ALGO_GCRA
            # EXP ≡ TAT; the aux (REMF) pair is the same raw TAT
            cols = [p(0), p(1), p(4), p(5), zero, flags, p(6), dur_hi,
                    zero, zero, p(2), p(3), p(3), p(2), zero, zero]
        elif self is TOKEN32:
            flags = (status << 8) | _ALGO_TOKEN
            # stamp = exp - duration (token invariant; Gregorian excluded)
            i64 = torch.int64
            exp = (p(5).to(i64) << 32) | (p(4).to(i64) & 0xFFFFFFFF)
            dur = (dur_hi.to(i64) << 32) | (p(6).to(i64) & 0xFFFFFFFF)
            stamp = exp - dur
            st_lo = (stamp & 0xFFFFFFFF).to(slots.dtype)
            st_hi = (stamp >> 32).to(slots.dtype)
            cols = [p(0), p(1), p(3), zero, p(2), flags, p(6), dur_hi,
                    st_lo, st_hi, p(4), p(5), zero, zero, zero, zero]
        else:  # pragma: no cover - registry guards
            raise ValueError(f"no unpack rule for layout {self.name}")
        return torch.stack(cols, dim=-1)

    @_host_or_tensor
    def pack(self, full: torch.Tensor) -> torch.Tensor:
        """(..., 16) canonical fields → (..., F) packed fields. Lossy by
        design: fields the layout's algorithm family never reads are
        dropped."""
        if self is FULL:
            return full
        g = lambda i: full[..., i]
        status = (g(_FLAGS) >> 8) & 0xFF
        meta = (g(_DUR_HI) & _DUR_HI_MASK) | (status << _STATUS_SHIFT)
        if self is GCRA32:
            # raw aux pair (REMF_LO = lo32, REMF_HI = hi32) is the TAT
            cols = [g(_FP_LO), g(_FP_HI), g(_REMF_LO), g(_REMF_HI),
                    g(_LIMIT), g(_BURST), g(_DUR_LO), meta]
        elif self is TOKEN32:
            cols = [g(_FP_LO), g(_FP_HI), g(_REM_I), g(_LIMIT),
                    g(_EXP_LO), g(_EXP_HI), g(_DUR_LO), meta]
        else:  # pragma: no cover - registry guards
            raise ValueError(f"no pack rule for layout {self.name}")
        return torch.stack(cols, dim=-1)

    @_host_or_tensor
    def unpack_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(..., K·F) packed bucket rows → (..., K·16) full bucket rows."""
        if self is FULL:
            return rows
        shape = rows.shape[:-1]
        out = self.unpack(rows.reshape(shape + (K, self.F)))
        return out.reshape(shape + (K * 16,))

    @_host_or_tensor
    def pack_rows(self, rows_full: torch.Tensor) -> torch.Tensor:
        """(..., K·16) full bucket rows → (..., K·F) packed bucket rows."""
        if self is FULL:
            return rows_full
        shape = rows_full.shape[:-1]
        out = self.pack(rows_full.reshape(shape + (K, 16)))
        return out.reshape(shape + (K * self.F,))

    @_host_or_tensor
    def idle_ref(self, slots: torch.Tensor) -> torch.Tensor:
        """Per-slot last-activity reference (ms, int64) of the tiering idle
        sweep: the stored stamp when the layout keeps one (and it is
        nonzero), else ``exp - duration`` — exact for token32 (the pack
        derives the stamp the same way), a proxy for gcra32 that only
        makes the sweep demote later. (..., F) slot fields in THIS
        layout."""
        i64 = torch.int64
        p = lambda i: slots[..., i]
        exp = (p(self.exp_hi_i).to(i64) << 32) | (p(self.exp_lo_i).to(i64) & 0xFFFFFFFF)
        dur_hi = p(_DUR_HI) if self is FULL else p(7) & _DUR_HI_MASK
        dur = (dur_hi.to(i64) << 32) | (p(_DUR_LO).to(i64) & 0xFFFFFFFF)
        ref = exp - dur
        if self is FULL:
            stamp = (p(_STAMP_HI).to(i64) << 32) | (p(_STAMP_LO).to(i64) & 0xFFFFFFFF)
            ref = torch.where(stamp != 0, stamp, ref)
        return ref

    # ---------------------------------------------------------- predicates

    def supports_math(self, math: str) -> bool:
        return math in self.modes

    def supports_algos(self, algo, active=None) -> bool:
        """Host-side (numpy): can every ACTIVE row's algorithm live in this
        layout? Padding rows carry algo=0 and never persist."""
        if self.algos is None:
            return True
        a = np.asarray(algo)
        if active is not None:
            a = a[np.asarray(active)]
        if a.size == 0:
            return True
        return bool(np.isin(a, self.algos).all())


FULL = SlotLayout(
    name="full", code=0, F=16,
    modes=("token", "gcra", "int", "mixed"),
    algos=None, greg_ok=True, exp_lo_i=_EXP_LO, exp_hi_i=_EXP_HI,
)
GCRA32 = SlotLayout(
    name="gcra32", code=1, F=8,
    modes=("gcra",), algos=(_ALGO_GCRA,), greg_ok=True,
    exp_lo_i=2, exp_hi_i=3,  # the TAT pair IS the expiry pair
)
TOKEN32 = SlotLayout(
    name="token32", code=2, F=8,
    modes=("token",), algos=(_ALGO_TOKEN,), greg_ok=False,
    exp_lo_i=4, exp_hi_i=5,
)

LAYOUTS = {l.name: l for l in (FULL, GCRA32, TOKEN32)}
_BY_CODE = {l.code: l for l in LAYOUTS.values()}


def layout_by_code(code: int) -> SlotLayout:
    """Layout for a frame/wire version byte; raises on unknown codes (a
    reader must refuse bytes it cannot interpret, not guess)."""
    lay = _BY_CODE.get(int(code))
    if lay is None:
        raise ValueError(f"unknown slot-layout code {code}")
    return lay


def layout_for_row(row_lanes: int) -> SlotLayout:
    """Layout inferred from a rows array's lane width. Only the full
    layout's 128-lane row is unambiguous."""
    if row_lanes == FULL.row:
        return FULL
    raise ValueError(
        f"cannot infer slot layout from row width {row_lanes}; "
        "packed layouts must be passed explicitly"
    )


def slot_layout_env() -> str:
    """The GUBER_SLOT_LAYOUT knob: auto | full | packed | gcra32 | token32."""
    v = os.environ.get("GUBER_SLOT_LAYOUT", "auto")
    if v not in ("auto", "full", "packed") and v not in LAYOUTS:
        raise ValueError(
            f"GUBER_SLOT_LAYOUT must be auto, full, packed or a layout "
            f"name ({', '.join(LAYOUTS)}), got {v!r}"
        )
    return v


def resolve_layout(mode=None, math_hint=None) -> SlotLayout:
    """Resolve the table layout for an engine: an explicit mode wins over
    the env knob; "auto"/"packed" pick the packed layout matching a
    single-algorithm math hint and fall back to full."""
    mode = mode or slot_layout_env()
    if mode in LAYOUTS:
        return LAYOUTS[mode]
    if mode in ("auto", "packed"):
        if math_hint == "gcra":
            return GCRA32
        if math_hint == "token":
            return TOKEN32
        return FULL
    raise ValueError(f"unknown slot-layout mode {mode!r}")
