"""The table write of a decide dispatch: one packed slot per kept row.

``slot_write(rows, new16, written, bucket, chosen, layout)`` takes what the
TPU's write takes: the (B, 16) int32 canonical rows of the decide and the
claim's ``written`` (bool), ``bucket`` (int32) and ``chosen`` (int64) lanes.
Each written row, packed to the table's layout (``full``, ``gcra32`` or
``token32``; a name or a ``SlotLayout``), lands in slot
``bucket*K + chosen`` (int32, as the claim forms it); a target outside the
table is no slot. Targets are unique (the claim dedups them), so the result
does not depend on the order of the stores.

* On a CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/slot_write.cu`` (the counterpart of the TPU's Pallas sweep and
  block-sparse sweep, ``gubernator_tpu/ops/kernel2.py`` ``_write_sweep`` and
  ``_write_sparse``, which also pack and form the target themselves) or
  raises; ``slot_write.launches`` counts its launches.
* On a CPU tensor it runs the plain PyTorch version ``slot_write_ref``: the
  target by ``torch.where``, ``layout.pack``, then ``index_copy_`` over the
  kept rows — the JAX package's ``_write_xla`` scatter.

Both update ``rows`` in place.
"""

from __future__ import annotations

import ctypes

import torch

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.ops.layout import K, LAYOUTS, SlotLayout

_ALIGN = 16  # the kernel loads and stores 16-byte pieces of new16 and rows
_CODE = {"full": 0, "gcra32": 1, "token32": 2}  # the kernel's layout ids


def _check(rows, new16, written, bucket, chosen, layout) -> SlotLayout:
    """Validate the operands; returns the layout."""
    lay = LAYOUTS[layout] if isinstance(layout, str) else layout
    if not isinstance(lay, SlotLayout) or lay.name not in _CODE:
        raise ValueError(f"unknown slot layout {layout!r}")
    want = {"rows": (rows, torch.int32), "new16": (new16, torch.int32),
            "written": (written, torch.bool), "bucket": (bucket, torch.int32),
            "chosen": (chosen, torch.int64)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")
    b = new16.shape[0] if new16.dim() == 2 else -1
    if new16.dim() != 2 or new16.shape[1] != 16 or any(
            t.dim() != 1 or t.shape[0] != b for t in (written, bucket, chosen)):
        raise ValueError(
            f"new16 must be (B, 16) and written, bucket, chosen (B,), got "
            f"{tuple(new16.shape)}, {tuple(written.shape)}, {tuple(bucket.shape)}, "
            f"{tuple(chosen.shape)}")
    if rows.numel() % (K * lay.F):
        raise ValueError(f"a {lay.name} table holds whole buckets of {K * lay.F} int32, "
                         f"got {rows.numel()}")
    return lay


def slot_write_ref(rows: torch.Tensor, new16: torch.Tensor, written: torch.Tensor,
                   bucket: torch.Tensor, chosen: torch.Tensor, layout) -> torch.Tensor:
    """Plain PyTorch version: the target by torch.where, layout.pack, then
    one index_copy_ over the kept rows."""
    lay = _check(rows, new16, written, bucket, chosen, layout)
    flat = rows.view(-1, lay.F)
    n_slots = flat.shape[0]
    target = torch.where(written, bucket * K + chosen.to(torch.int32),
                         torch.full_like(bucket, n_slots))
    keep = (target >= 0) & (target < n_slots)
    flat.index_copy_(0, target[keep].to(torch.int64), lay.pack(new16)[keep])
    return rows


def _entry():
    """The C entry point, built and typed at first use."""
    fn = _build.load("slot_write").guber_slot_write
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, ll, ll, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def slot_write(rows: torch.Tensor, new16: torch.Tensor, written: torch.Tensor,
               bucket: torch.Tensor, chosen: torch.Tensor, layout) -> torch.Tensor:
    """Pack each written canonical row to `layout` and store it in slot
    ``bucket*K + chosen`` of `rows`, in place. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    lay = _check(rows, new16, written, bucket, chosen, layout)
    if rows.device.type == "cpu":
        return slot_write_ref(rows, new16, written, bucket, chosen, lay)
    if rows.device.type != "cuda":
        raise ValueError(f"slot_write runs on cuda or cpu tensors, got {rows.device}")
    for name, t in (("rows", rows), ("new16", new16)):
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be 16-byte aligned")
    n = int(new16.shape[0])
    if n == 0:
        return rows
    fn = _entry()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), new16.data_ptr(), written.data_ptr(), bucket.data_ptr(),
                 chosen.data_ptr(), n, rows.numel() // lay.F, _CODE[lay.name], stream)
    if err != 0:
        raise RuntimeError(f"slot_write launch failed: cudaError {err}")
    slot_write.launches += 1
    return rows


slot_write.launches = 0
