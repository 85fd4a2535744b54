"""Port of exp/exp_sweep5.py: the sweep-write optimisation matrix on the card.

    python -m gubernator_tpu_torch.exp.exp_sweep5 [--seed N] [--cases a,b,...]
        [--device cuda|cpu]

Each case writes B sorted, unique random targets with random payloads into
a zero (NB, 128) table through ``sweeps.sweep_window`` with the TPU
script's geometry (blk, u) and flags: ``marker`` (the write test is the
composed field 15, the payload's field 15 set to 1) and ``skip2`` (a
block's second window runs only where its run crosses the first). The
case names and the default list are the TPU script's (``SWEEP5_CASES``).
A line per case on stderr; one JSON line on stdout.
"""

from __future__ import annotations

import argparse

import torch

from gubernator_tpu_torch.device import resolve_device
from gubernator_tpu_torch.exp import sweeps
from gubernator_tpu_torch.exp._timing import (
    device_info, emit, generator, log, randint32, time_ms,
)

K, F, ROW = sweeps.K, sweeps.F, sweeps.ROW
NB, B = 1 << 21, 1 << 17  # headline: 2M bucket rows (1 GiB), 131K updates
DEFAULT_CASES = "skip2-2048-256,all-1024-128"
# name: (NB, B, blk, u, marker, skip2)
MATRIX = {
    "base": (NB, B, 2048, 256, False, False),
    "geom-1024-128": (NB, B, 1024, 128, False, False),
    "geom-512-64": (NB, B, 512, 64, False, False),
    "skip2-2048-256": (NB, B, 2048, 256, False, True),
    "all-1024-128": (NB, B, 1024, 128, False, True),
    "all-512-64": (NB, B, 512, 64, False, True),
    # config5 scale: 16.7M bucket rows (8 GiB), 1M updates
    "c5-base": (1 << 24, 1 << 20, 2048, 256, False, False),
    "c5-all-1024-128": (1 << 24, 1 << 20, 1024, 128, False, True),
    "c5-all-512-64": (1 << 24, 1 << 20, 512, 64, False, True),
}


def window_starts(tgt_eff: torch.Tensor, NB: int, blk: int, u: int):
    """(s_blk, need2) of exp_sweep5.sweep_call: each block's first window
    by searchsorted over the effective targets, and whether its run
    crosses into the next window."""
    Bn = tgt_eff.shape[0]
    nblk, nwin = NB // blk, Bn // u
    bounds = torch.arange(nblk, dtype=torch.int32, device=tgt_eff.device) * (K * blk)
    starts = torch.searchsorted(tgt_eff, bounds).to(torch.int32)
    ends = torch.cat([starts[1:], torch.full((1,), Bn, dtype=torch.int32,
                                             device=tgt_eff.device)])
    s_blk = torch.clamp(starts // u, 0, nwin - 1)
    need2 = (ends > (s_blk + 1) * u).to(torch.int32)
    return s_blk.contiguous(), need2


def sweep_call(rows_tbl: torch.Tensor, pay_s: torch.Tensor, tgt_eff: torch.Tensor,
               blk: int, u: int, marker: bool, skip2: bool) -> torch.Tensor:
    """exp_sweep5.sweep_call: the windowed write of sorted updates, in place
    (``tgt_eff`` is (B,) or (B, 1))."""
    tgt = tgt_eff.reshape(-1).contiguous()
    s_blk, need2 = window_starts(tgt, rows_tbl.shape[0], blk, u)
    return sweeps.sweep_window(rows_tbl, pay_s, tgt, s_blk, need2, blk, u, marker, skip2)


def case_data(gen, dev, NB: int, B: int, marker: bool):
    """Sorted unique targets and random payloads (field 15 = 1 with
    marker), as the TPU script fabricates them."""
    tgt = torch.sort(torch.randperm(NB * K, device=dev, generator=gen)[:B]).values
    pay = randint32(gen, (B, F), dev, high=2**31 - 1)
    if marker:
        pay[:, 15] = 1
    return tgt.to(torch.int32), pay


def case(name: str, NB: int, B: int, blk: int, u: int, marker: bool, skip2: bool, gen, dev,
         reps: int = 7, inner: int = 5) -> dict:
    tgt, pay = case_data(gen, dev, NB, B, marker)
    rows = torch.zeros((NB, ROW), dtype=torch.int32, device=dev)
    ms = time_ms(lambda: sweep_call(rows, pay, tgt, blk, u, marker, skip2), dev, reps, inner)
    nwin = B // u
    log(f"[{name}] NB={NB} B={B} blk={blk} u={u} nwin={nwin} "
        f"marker={marker} skip2={skip2}: {ms:.4f} ms")
    return {"nb": NB, "batch": B, "blk": blk, "u": u, "marker": marker, "skip2": skip2,
            "ms": ms}


def run(seed: int = 3, cases: str = DEFAULT_CASES, device=None, matrix=None,
        reps: int = 7, inner: int = 5) -> dict:
    dev = resolve_device(device)
    gen = generator(dev, seed)
    matrix = MATRIX if matrix is None else matrix
    out = {"script": "exp_sweep5", **device_info(dev), "cases": {}}
    for name in (c.strip() for c in cases.split(",")):
        if name not in matrix:
            raise ValueError(f"unknown case {name!r}; known: {', '.join(matrix)}")
        out["cases"][name] = case(name, *matrix[name], gen, dev, reps, inner)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--cases", default=DEFAULT_CASES,
                    help=f"comma-separated case names of: {', '.join(MATRIX)}")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    emit(run(args.seed, args.cases, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
