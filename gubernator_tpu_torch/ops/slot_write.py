"""The table write of a decide dispatch: one slot per kept row.

``slot_write(rows, payload, target)`` stores ``payload[i]`` into slot
``target[i]`` of the table for every ``target[i] < NB*K``; other targets are
the claim's sentinel for rows it did not keep. Targets are unique (the claim
dedups them), so the result does not depend on the order of the stores.

* On a CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/slot_write.cu`` (the counterpart of the TPU's Pallas sweep and
  block-sparse sweep, ``gubernator_tpu/ops/kernel2.py`` ``_write_sweep`` and
  ``_write_sparse``) or raises; ``slot_write.launches`` counts its launches.
* On a CPU tensor it runs the plain PyTorch version ``slot_write_ref``, the
  counterpart of the JAX package's ``_write_xla`` scatter.

Both update ``rows`` in place.
"""

from __future__ import annotations

import ctypes

import torch

from gubernator_tpu_torch import _build

_ALIGN = 16  # the kernel moves 16-byte pieces


def _check(rows: torch.Tensor, payload: torch.Tensor, target: torch.Tensor) -> int:
    """Validate the operands; returns fl (int32 fields per slot)."""
    if rows.dtype != torch.int32 or payload.dtype != torch.int32:
        raise TypeError(
            f"rows and payload must be int32, got {rows.dtype} and {payload.dtype}"
        )
    if target.dtype != torch.int32:
        raise TypeError(f"target must be int32, got {target.dtype}")
    if payload.dim() != 2 or target.dim() != 1 or target.shape[0] != payload.shape[0]:
        raise ValueError(
            f"payload must be (B, fl) and target (B,), got {tuple(payload.shape)} "
            f"and {tuple(target.shape)}"
        )
    fl = int(payload.shape[1])
    if fl <= 0 or fl % 4 or rows.numel() % fl:
        raise ValueError(
            f"slot width fl={fl} must be a positive multiple of 4 dividing the "
            f"table ({rows.numel()} int32)"
        )
    if not (rows.is_contiguous() and payload.is_contiguous() and target.is_contiguous()):
        raise ValueError("rows, payload and target must be contiguous")
    if not (rows.device == payload.device == target.device):
        raise ValueError(
            f"operands on different devices: {rows.device}, {payload.device}, "
            f"{target.device}"
        )
    return fl


def slot_write_ref(rows: torch.Tensor, payload: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one index_copy_ over the kept rows."""
    fl = _check(rows, payload, target)
    flat = rows.view(-1, fl)
    keep = (target >= 0) & (target < flat.shape[0])
    flat.index_copy_(0, target[keep].to(torch.int64), payload[keep])
    return rows


def _entry():
    """The C entry point, built and typed at first use."""
    fn = _build.load("slot_write").guber_slot_write
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def slot_write(rows: torch.Tensor, payload: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    """Scatter `payload` rows into `rows` slots named by `target`, in place.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    fl = _check(rows, payload, target)
    if rows.device.type == "cpu":
        return slot_write_ref(rows, payload, target)
    if rows.device.type != "cuda":
        raise ValueError(f"slot_write runs on cuda or cpu tensors, got {rows.device}")
    for t in (rows, payload):
        if t.data_ptr() % _ALIGN:
            raise ValueError("rows and payload must be 16-byte aligned")
    n = int(target.shape[0])
    if n == 0:
        return rows
    fn = _entry()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), payload.data_ptr(), target.data_ptr(), n,
                 fl, rows.numel() // fl, stream)
    if err != 0:
        raise RuntimeError(f"slot_write launch failed: cudaError {err}")
    slot_write.launches += 1
    return rows


slot_write.launches = 0
