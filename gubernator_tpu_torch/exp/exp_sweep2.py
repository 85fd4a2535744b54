"""Port of exp/exp_sweep2.py: the sweep-write variants on the card.

    python -m gubernator_tpu_torch.exp.exp_sweep2 [--seed N] [--device cuda|cpu]

A (NB, 128) int32 table (2^21 rows, 1 GiB) takes, per block of BLK=2048
rows, one window of U=256 slot updates ``(new16, slot, lb)``, half of them
live, in place. The variants of the TPU script map onto two kernels:

  copy   — the in-place stream alone: ``sweeps.sweep_copy(rows, rows)``
  cur    — byte-plane compose: ``sweeps.sweep_slots(..., planes=8)``
  f32x2  — 16-bit halves: ``sweeps.sweep_slots(..., planes=16)``
  i8acc  — byte accumulators, the same function as cur (planes=8)

Each line on stderr is a variant's time per call; stdout gets one JSON line.
"""

from __future__ import annotations

import argparse

import torch

from gubernator_tpu_torch.device import resolve_device
from gubernator_tpu_torch.exp import sweeps
from gubernator_tpu_torch.exp._timing import (
    device_info, emit, generator, log, randint32, time_ms,
)

NB = 1 << 21  # 2M buckets = 1 GiB table
ROW = 128
K = 8
F = 16
BLK = 2048
U = 256
NBLK = NB // BLK

VARIANTS = ("copy", "cur", "f32x2", "i8acc")


def make_data(gen: torch.Generator, device: torch.device, nb: int = NB, blk: int = BLK,
              u: int = U):
    """The script's data: table lanes in [0, 2^30), random payloads and
    slots, and per window u//2 live local buckets (one draw per window
    column, shared by every window; about 0.5 colliding pairs a window at
    the headline geometry), the rest -1."""
    nblk = nb // blk
    rows = torch.randint(0, 1 << 30, (nb, ROW), dtype=torch.int32, device=device,
                         generator=gen)
    wnew = randint32(gen, (nblk * u, F), device)
    wslot = torch.randint(0, K, (nblk * u, 1), dtype=torch.int32, device=device,
                          generator=gen)
    lb = torch.full((nblk, u), -1, dtype=torch.int32, device=device)
    lb[:, : u // 2] = torch.randint(0, blk, (1, u // 2), dtype=torch.int32, device=device,
                                    generator=gen)
    return rows, wnew, wslot, lb.reshape(-1, 1)


def sort_windows(wnew: torch.Tensor, wslot: torch.Tensor, wlb: torch.Tensor, u: int = U,
                 blk: int = BLK):
    """The same windows with each one's entries ordered by target slot
    (``lb * K + slot``), the entries that name nothing last, ties in entry
    order: what a caller that sorts its updates hands the kernel."""
    lb, sl = wlb.view(-1, u).to(torch.int64), wslot.view(-1, u).to(torch.int64)
    live = (lb >= 0) & (lb < blk) & (sl >= 0) & (sl < K)
    order = torch.argsort(torch.where(live, lb * K + sl, blk * K), dim=1, stable=True)
    idx = (order + torch.arange(order.shape[0], device=order.device)[:, None] * u).reshape(-1)
    return wnew[idx], wslot[idx], wlb[idx]


def variant(name: str, u: int = U):
    """The step of one variant: (rows, wnew, wslot, wlb) → rows, in place."""
    if name == "copy":
        return lambda rows, wnew, wslot, wlb: sweeps.sweep_copy(rows, rows)
    planes = 16 if name == "f32x2" else 8
    if name not in ("cur", "i8acc", "f32x2"):
        raise ValueError(f"unknown variant {name!r}")
    return lambda rows, wnew, wslot, wlb: sweeps.sweep_slots(rows, wnew, wslot, wlb, u,
                                                             planes)


def run(seed: int = 3, device=None, nb: int = NB, blk: int = BLK, u: int = U,
        reps: int = 7, inner: int = 5) -> dict:
    dev = resolve_device(device)
    rows, wnew, wslot, wlb = make_data(generator(dev, seed), dev, nb, blk, u)
    out = {"script": "exp_sweep2", **device_info(dev), "nb": nb, "blk": blk, "u": u,
           "ms": {}}
    for name in VARIANTS:
        step = variant(name, u)
        ms = time_ms(lambda: step(rows, wnew, wslot, wlb), dev, reps, inner)
        log(f"{name:8s}: {ms:9.4f} ms")
        out["ms"][name] = ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    emit(run(args.seed, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
