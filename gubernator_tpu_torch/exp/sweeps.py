"""The sweep-write probes of the measurement scripts: four kernels, their
plain PyTorch versions and their launch counts.

The TPU scripts (``exp/exp_sweep2.py``, ``exp_sweep4.py``, ``exp_sweep5.py``,
``exp_mem2.py``) stream a (NB, 128) int32 bucket table through VMEM block by
block and compose a window of updates into each block with int8 one-hot
matmuls. The functions they compute, each ported as one CUDA kernel:

* ``sweep_copy(src, dst)`` — the whole-table stream (``exp_sweep2.k_copy``,
  ``exp_mem2.sweep_copy``); ``dst`` may be ``src``.
* ``sweep_rows(table, rows, mask, bkt, U, out=None)`` — full-row updates
  with per-lane int8 masks (``exp_mem2.scat_kernel``): for bucket row r of
  block b and lane l, W = Σ mask, P_s = Σ int8(byte s of rows) over the
  window's entries with ``bkt == r``; acc = OR_s (P_s << 8s) in wrapping
  int32 (a negative P_s smears ones upward, as on the TPU); the lane takes
  acc where W > 0. Out of place when ``out`` is given, else in place.
* ``sweep_slots(table, new16, slot, lb, U, planes)`` — slot updates routed
  by (local bucket, slot) (``exp_sweep2.k_cur`` / ``k_i8acc``, planes=8:
  each byte the wrapping sum mod 256 of the matching entries' bytes;
  ``k_f32x2``, planes=16: plain sums of the 16-bit halves, ``lo | hi<<16``
  unmasked). In place.
* ``sweep_window(table, pay_s, tgt_eff, s_blk, need2, blk, u, marker,
  skip2)`` — the windowed sweep of target-sorted updates
  (``exp_sweep4.make_sweep2``, ``exp_sweep5.make_kernel``). In place.

On a CUDA tensor each wrapper launches its kernel (``csrc/<name>.cu``,
built at first use) or raises, and adds one to its ``.launches``; on a CPU
tensor it runs the plain version (``<name>_ref``), which gathers only the
touched rows. The plain versions also run on the card, where they are the
reference the kernels are held to.
"""

from __future__ import annotations

import ctypes

import torch

from gubernator_tpu_torch import _build

ROW = 128  # int32 lanes per bucket row
K = 8  # slots per bucket
F = 16  # int32 fields per slot
i32, i64 = torch.int32, torch.int64

MAX_SHARED_ENTRIES = 2048  # window entries a kernel block groups in shared memory


# ---------------------------------------------------------------- helpers


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor as int32 (two's complement)."""
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(i32)


def _byte(x: torch.Tensor, s: int) -> torch.Tensor:
    """Byte s of int32 `x` as an unsigned value 0..255 (int32)."""
    return (x >> (8 * s)) & 0xFF


def _signed_byte(x: torch.Tensor, s: int) -> torch.Tensor:
    """Byte s of int32 `x` as a signed value -128..127 (int32)."""
    b = _byte(x, s)
    return b - ((b >> 7) << 8)


def _sum_rows(inv: torch.Tensor, n: int, vals: torch.Tensor) -> torch.Tensor:
    """Row sums of `vals` grouped by `inv` into `n` groups (int64)."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=i64, device=vals.device)
    return out.index_add_(0, inv, vals.to(i64))


def _byte_sums(inv: torch.Tensor, n: int, x: torch.Tensor) -> torch.Tensor:
    """Per group, each byte the wrapping (mod 256) sum of the members'
    bytes, composed back into int32."""
    acc = torch.zeros((n,) + tuple(x.shape[1:]), dtype=i64, device=x.device)
    for s in range(4):
        acc |= (_sum_rows(inv, n, _byte(x, s)) & 0xFF) << (8 * s)
    return _wrap32(acc)


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sweeps run on cuda or cpu tensors, got {dev}")
    return dev


def _contiguous(**ts: torch.Tensor) -> None:
    for name, t in ts.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dtype(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _table(t: torch.Tensor, name: str = "table") -> int:
    _dtype(t, name, i32)
    if t.dim() != 2 or t.shape[1] != ROW:
        raise ValueError(f"{name} must be (NB, {ROW}) int32, got {tuple(t.shape)}")
    return int(t.shape[0])


def _windows(nb: int, n: int, U: int) -> tuple:
    """(nblk, blk) of a table of `nb` rows under `n` window entries of `U`
    each: one window per block of blk bucket rows."""
    if U <= 0 or n % U:
        raise ValueError(f"{n} window entries are not a whole number of windows of U={U}")
    nblk = n // U
    if nblk == 0 or nb % nblk:
        raise ValueError(f"{nblk} windows do not divide a table of {nb} rows")
    return nblk, nb // nblk


def _flat(t: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """(n,) or (n, 1) int32 → (n,)."""
    _dtype(t, name, i32)
    if t.numel() != n or t.dim() not in (1, 2) or (t.dim() == 2 and t.shape[1] != 1):
        raise ValueError(f"{name} must be ({n},) or ({n}, 1), got {tuple(t.shape)}")
    return t.reshape(n)


def _aligned(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("the table operands must be 16-byte aligned")


def _entry(name: str, argtypes: list):
    """The C entry point of kernel `name`, built and typed at first use."""
    fn = getattr(_build.load(name), f"guber_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------- A: sweep_copy


def _check_copy(src: torch.Tensor, dst: torch.Tensor) -> None:
    _table(src, "src")
    _table(dst, "dst")
    if src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst {tuple(dst.shape)} differ")
    _contiguous(src=src, dst=dst)
    _same_device(src, dst)


def sweep_copy_ref(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Plain version: ``dst.copy_(src)``."""
    _check_copy(src, dst)
    return dst.copy_(src)


def sweep_copy(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Stream the table `src` into `dst` (which may be `src` itself)."""
    _check_copy(src, dst)
    if src.device.type == "cpu":
        return sweep_copy_ref(src, dst)
    _aligned(src, dst)
    fn = _entry("sweep_copy", [_P, _P, _L, _P])
    with torch.cuda.device(src.device):
        _launched("sweep_copy", fn(src.data_ptr(), dst.data_ptr(), src.numel() // 4,
                                   _stream(src)))
    sweep_copy.launches += 1
    return dst


sweep_copy.launches = 0


# ---------------------------------------------------------- B: sweep_rows


def _check_rows(table, rows, mask, bkt, U, out):
    nb = _table(table)
    _dtype(rows, "rows", i32)
    _dtype(mask, "mask", torch.int8)
    n = int(rows.shape[0])
    if rows.shape != (n, ROW) or mask.shape != (n, ROW):
        raise ValueError(f"rows and mask must be (n, {ROW}), got {tuple(rows.shape)} "
                         f"and {tuple(mask.shape)}")
    bk = _flat(bkt, n, "bkt")
    nblk, blk = _windows(nb, n, U)
    ts = [table, rows, mask, bk] + ([] if out is None else [out])
    _same_device(*ts)
    _contiguous(table=table, rows=rows, mask=mask, bkt=bk)
    if out is not None:
        if out.shape != table.shape or out.dtype != i32 or not out.is_contiguous():
            raise ValueError("out must be a contiguous int32 tensor shaped like table")
    return bk, nblk, blk


def row_groups(bkt: torch.Tensor, U: int, blk: int):
    """The entries of sweep_rows grouped by the table row they name:
    (valid entries, the unique rows, each valid entry's group)."""
    b = torch.arange(bkt.shape[0], device=bkt.device) // U
    valid = (bkt >= 0) & (bkt < blk)
    uniq, inv = torch.unique((b * blk + bkt.to(i64))[valid], return_inverse=True)
    return valid, uniq, inv


def sweep_rows_ref(table: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                   bkt: torch.Tensor, U: int, out: torch.Tensor = None) -> torch.Tensor:
    """Plain version: the window entries grouped by target row (unique),
    summed with ``index_add_`` and scattered back over the touched rows."""
    bk, nblk, blk = _check_rows(table, rows, mask, bkt, U, out)
    dst = table if out is None else out.copy_(table)
    valid, uniq, inv = row_groups(bk, U, blk)
    r = rows[valid]
    W = _sum_rows(inv, uniq.shape[0], mask[valid])
    acc = torch.zeros((uniq.shape[0], ROW), dtype=i64, device=bk.device)
    for s in range(4):
        acc |= _sum_rows(inv, uniq.shape[0], _signed_byte(r, s)) << (8 * s)
    dst[uniq] = torch.where(W > 0, _wrap32(acc), table[uniq])
    return dst


def sweep_rows(table: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
               bkt: torch.Tensor, U: int, out: torch.Tensor = None) -> torch.Tensor:
    """Compose one window of U full-row updates into each block of the
    table; into `out` (a full copy first) when given, else in place."""
    bk, nblk, blk = _check_rows(table, rows, mask, bkt, U, out)
    if table.device.type == "cpu":
        return sweep_rows_ref(table, rows, mask, bkt, U, out)
    if U > MAX_SHARED_ENTRIES:
        raise ValueError(f"U={U} exceeds the kernel's window of {MAX_SHARED_ENTRIES}")
    dst = table if out is None else out
    _aligned(table, dst, rows, mask)
    fn = _entry("sweep_rows", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(table.device):
        _launched("sweep_rows", fn(table.data_ptr(), dst.data_ptr(), rows.data_ptr(),
                                   mask.data_ptr(), bk.data_ptr(), nblk, U, blk,
                                   int(out is not None), _stream(table)))
    sweep_rows.launches += 1
    return dst


sweep_rows.launches = 0


# --------------------------------------------------------- C: sweep_slots


def _check_slots(table, new16, slot, lb, U, planes):
    nb = _table(table)
    _dtype(new16, "new16", i32)
    n = int(new16.shape[0])
    if new16.shape != (n, F):
        raise ValueError(f"new16 must be (n, {F}), got {tuple(new16.shape)}")
    sl, l = _flat(slot, n, "slot"), _flat(lb, n, "lb")
    nblk, blk = _windows(nb, n, U)
    if planes not in (8, 16):
        raise ValueError(f"planes must be 8 or 16, got {planes}")
    if planes == 16 and U > 256:
        # 16-bit halves summed in f32 on the TPU are exact only while
        # U * 65535 < 2^24
        raise ValueError(f"planes=16 needs U <= 256, got {U}")
    _same_device(table, new16, sl, l)
    _contiguous(table=table, new16=new16, slot=sl, lb=l)
    return sl, l, nblk, blk


def slot_groups(slot: torch.Tensor, lb: torch.Tensor, U: int, blk: int):
    """The entries of sweep_slots grouped by the table slot they name:
    (valid entries, the unique slots, each valid entry's group)."""
    b = torch.arange(slot.shape[0], device=slot.device) // U
    valid = (lb >= 0) & (lb < blk) & (slot >= 0) & (slot < K)
    g = ((b * blk + lb.to(i64)) * K + slot.to(i64))[valid]
    uniq, inv = torch.unique(g, return_inverse=True)
    return valid, uniq, inv


def sweep_slots_ref(table: torch.Tensor, new16: torch.Tensor, slot: torch.Tensor,
                    lb: torch.Tensor, U: int, planes: int) -> torch.Tensor:
    """Plain version: entries grouped by target slot (unique), their bytes
    (planes=8) or 16-bit halves (planes=16) summed with ``index_add_``,
    the composed slots written back."""
    sl, l, nblk, blk = _check_slots(table, new16, slot, lb, U, planes)
    valid, uniq, inv = slot_groups(sl, l, U, blk)
    x = new16[valid]
    if planes == 8:
        acc = _byte_sums(inv, uniq.shape[0], x)
    else:
        lo = _sum_rows(inv, uniq.shape[0], x & 0xFFFF)
        hi = _sum_rows(inv, uniq.shape[0], (x >> 16) & 0xFFFF)
        acc = _wrap32(lo | (hi << 16))
    table.view(-1, F)[uniq] = acc
    return table


def sweep_slots(table: torch.Tensor, new16: torch.Tensor, slot: torch.Tensor,
                lb: torch.Tensor, U: int, planes: int) -> torch.Tensor:
    """Compose one window of U slot updates into each block, in place."""
    sl, l, nblk, blk = _check_slots(table, new16, slot, lb, U, planes)
    if table.device.type == "cpu":
        return sweep_slots_ref(table, new16, slot, lb, U, planes)
    if U > MAX_SHARED_ENTRIES:
        raise ValueError(f"U={U} exceeds the kernel's window of {MAX_SHARED_ENTRIES}")
    _aligned(table, new16)
    fn = _entry("sweep_slots", [_P, _P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(table.device):
        _launched("sweep_slots", fn(table.data_ptr(), new16.data_ptr(), sl.data_ptr(),
                                    l.data_ptr(), nblk, U, blk, planes, _stream(table)))
    sweep_slots.launches += 1
    return table


sweep_slots.launches = 0


# -------------------------------------------------------- D: sweep_window


def _check_window(table, pay_s, tgt_eff, s_blk, need2, blk, u, skip2):
    nb = _table(table)
    _dtype(pay_s, "pay_s", i32)
    B = int(pay_s.shape[0])
    if pay_s.shape != (B, F):
        raise ValueError(f"pay_s must be (B, {F}), got {tuple(pay_s.shape)}")
    tgt = _flat(tgt_eff, B, "tgt_eff")
    if blk <= 0 or nb % blk:
        raise ValueError(f"blk={blk} does not divide a table of {nb} rows")
    nblk = nb // blk
    if u <= 0 or B % u or B == 0:
        raise ValueError(f"B={B} is not a whole number of windows of u={u}")
    if nb * K >= 2**31:
        raise ValueError("table too large for int32 slot ids")
    s = _flat(s_blk, nblk, "s_blk")
    n2 = _flat(need2, nblk, "need2") if need2 is not None else None
    if skip2 and n2 is None:
        raise ValueError("skip2 needs need2")
    _same_device(*[t for t in (table, pay_s, tgt, s, n2) if t is not None])
    _contiguous(table=table, pay_s=pay_s, tgt_eff=tgt, s_blk=s)
    if n2 is not None:
        _contiguous(need2=n2)
    return tgt, s, n2, nblk, B // u


def window_live(tgt: torch.Tensor, s_blk: torch.Tensor, need2, nblk: int, blk: int,
                u: int, skip2: bool):
    """The entries sweep_window composes, per half: [(targets, entry
    indices) of half 1, (…) of half 2], over every block's windows."""
    dev = tgt.device
    nwin = tgt.shape[0] // u
    kblk = K * blk
    base = torch.arange(nblk, device=dev, dtype=i64)[:, None] * kblk
    s1 = torch.clamp(s_blk.to(i64), 0, nwin - 1)  # the kernel clamps too
    s2 = torch.clamp(s1 + 1, max=nwin - 1)
    en2 = (need2 != 0) if skip2 else (s1 + 1 <= nwin - 1)
    j = torch.arange(u, device=dev, dtype=i64)
    halves = []
    for start, enabled in ((s1, None), (s2, en2)):
        e = start[:, None] * u + j  # (nblk, u) entry index
        t = tgt[e].to(i64)
        live = (t - base >= 0) & (t - base < kblk)
        if enabled is not None:
            live &= enabled[:, None]
        halves.append((t[live], e[live]))
    return halves


def sweep_window_ref(table: torch.Tensor, pay_s: torch.Tensor, tgt_eff: torch.Tensor,
                     s_blk: torch.Tensor, need2, blk: int, u: int, marker: bool,
                     skip2: bool) -> torch.Tensor:
    """Plain version: each block's two windows gathered, live entries
    grouped by target slot (unique), each half's byte sums and write test
    from ``index_add_``, the written slots scattered back."""
    tgt, s, n2, nblk, _ = _check_window(table, pay_s, tgt_eff, s_blk, need2, blk, u, skip2)
    halves = window_live(tgt, s, n2, nblk, blk, u, skip2)
    uniq, inv = torch.unique(torch.cat([h[0] for h in halves]), return_inverse=True)
    n = uniq.shape[0]
    split = halves[0][0].shape[0]
    accs, ws = [], []
    for (_t, e), iv in zip(halves, (inv[:split], inv[split:])):
        x = pay_s[e]
        acc = _byte_sums(iv, n, x)
        accs.append(acc)
        if marker:
            ws.append(acc[:, F - 1].to(i64))
        else:
            ws.append(_sum_rows(iv, n, torch.ones_like(iv)))
    written = _wrap32(ws[0] + ws[1]) > 0
    table.view(-1, F)[uniq[written]] = (accs[0] | accs[1])[written]
    return table


def sweep_window(table: torch.Tensor, pay_s: torch.Tensor, tgt_eff: torch.Tensor,
                 s_blk: torch.Tensor, need2, blk: int, u: int, marker: bool,
                 skip2: bool) -> torch.Tensor:
    """Compose target-sorted slot updates into each block of `blk` rows from
    its two u-windows (``s_blk[i]`` and the next), in place. ``need2`` (only
    read with ``skip2``) gates the second window per block; with ``marker``
    the write test is the composed field 15 instead of a count."""
    tgt, s, n2, nblk, nwin = _check_window(table, pay_s, tgt_eff, s_blk, need2, blk, u,
                                           skip2)
    if table.device.type == "cpu":
        return sweep_window_ref(table, pay_s, tgt_eff, s_blk, need2, blk, u, marker, skip2)
    if 2 * u > MAX_SHARED_ENTRIES:
        raise ValueError(f"u={u} exceeds the kernel's window of {MAX_SHARED_ENTRIES // 2}")
    _aligned(table, pay_s)
    fn = _entry("sweep_window", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    n2p = n2.data_ptr() if skip2 else None
    with torch.cuda.device(table.device):
        _launched("sweep_window", fn(table.data_ptr(), pay_s.data_ptr(), tgt.data_ptr(),
                                     s.data_ptr(), n2p, nblk, blk, u, nwin, int(marker),
                                     int(skip2), _stream(table)))
    sweep_window.launches += 1
    return table


sweep_window.launches = 0


def kernels() -> dict:
    """The four wrappers by kernel name (each carries ``.launches``)."""
    return {"sweep_copy": sweep_copy, "sweep_rows": sweep_rows,
            "sweep_slots": sweep_slots, "sweep_window": sweep_window}
