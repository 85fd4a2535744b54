"""Port of exp/exp_sweep4.py: the windowed sweep write, routed by the claim.

    python -m gubernator_tpu_torch.exp.exp_sweep4 [--seed N] [--device cuda|cpu]

Updates stay in target-sorted order (the claim's ``order`` and
``tgt_sorted``); each table block of blk rows composes the two u-entry
windows that cover its run (``sweeps.sweep_window``). First the write is
held against the engine's own write (``kernel2._write_claim``) on a small
table (2^14 slots, 2^10 rows, duplicate fingerprints); then it is timed at
the headline scale (2^24 slots, 2^17 rows) for blk in 2048, 4096, 8192
with u = 256. Lines on stderr as in the TPU script; one JSON line on stdout.
"""

from __future__ import annotations

import argparse

import torch

from gubernator_tpu_torch.device import resolve_device
from gubernator_tpu_torch.exp import sweeps
from gubernator_tpu_torch.exp._timing import (
    device_info, emit, generator, log, randint32, time_ms,
)
from gubernator_tpu_torch.ops import kernel2 as k2
from gubernator_tpu_torch.ops.batch import ReqBatch
from gubernator_tpu_torch.ops.table2 import F, K, Table2, new_table2

NOW = 1_700_000_000_000
SMALL = (1 << 14, 1 << 10)  # (capacity, batch) of the correctness check
HEADLINE = (1 << 24, 1 << 17)
BLKS = (2048, 4096, 8192)
U = 256


def sweep_inputs(NB: int, B: int, blk: int, u: int, new16: torch.Tensor, c: k2.Claim2):
    """The device-side prep of exp_sweep4's write: one payload gather into
    sorted order, the effective targets (unwritten rows get the sentinel
    NB*K) and each block's first window, by searchsorted over
    ``c.tgt_sorted``. Returns (pay_s, tgt_eff, s_blk)."""
    nblk, nwin = NB // blk, B // u
    order = c.order.long()
    pay_s = new16[order].contiguous()
    written_s = c.written[order]
    tgt_eff = torch.where(written_s, c.tgt_sorted,
                          torch.full_like(c.tgt_sorted, NB * K)).contiguous()
    bounds = torch.arange(nblk, dtype=torch.int32, device=new16.device) * (K * blk)
    starts = torch.searchsorted(c.tgt_sorted, bounds).to(torch.int32)
    s_blk = torch.clamp(starts // u, 0, nwin - 1).contiguous()
    return pay_s, tgt_eff, s_blk


def make_sweep2(NB: int, B: int, blk: int, u: int):
    """The write of exp_sweep4.make_sweep2: (rows_tbl, new16, c) → rows_tbl,
    updated in place: the prep (``sweep_inputs``) in torch ops, the compose
    in the kernel."""

    def write(rows_tbl: torch.Tensor, new16: torch.Tensor, c: k2.Claim2) -> torch.Tensor:
        pay_s, tgt_eff, s_blk = sweep_inputs(NB, B, blk, u, new16, c)
        return sweeps.sweep_window(rows_tbl, pay_s, tgt_eff, s_blk, None, blk, u,
                                   marker=False, skip2=False)

    return write


def mk_batch(fps: torch.Tensor, now: int) -> ReqBatch:
    b = fps.shape[0]
    dev = fps.device
    full = lambda v: torch.full((b,), v, dtype=torch.int64, device=dev)
    zeros32 = torch.zeros(b, dtype=torch.int32, device=dev)
    return ReqBatch(
        fp=fps, algo=zeros32, behavior=zeros32.clone(), hits=full(1), limit=full(1000),
        burst=full(0), duration=full(60_000), created_at=full(now),
        expire_new=full(now + 60_000), greg_interval=full(0), duration_eff=full(60_000),
        active=torch.ones(b, dtype=torch.bool, device=dev),
    )


def _fps(gen, n: int, dev) -> torch.Tensor:
    return torch.randint(1, 2**63 - 1, (n,), dtype=torch.int64, device=dev, generator=gen)


def check_small(gen, dev, cap: int, batch: int) -> dict:
    """The sweep against the engine's write on a small table; duplicates
    exercise the dedup sentinels."""
    tbl = new_table2(cap, device=dev)
    nb = tbl.n_buckets
    blk, u = k2.sweep_geometry(nb, batch)
    fps = _fps(gen, batch, dev)
    fps[:100] = fps[0].clone()
    b = mk_batch(fps, NOW)
    c = k2._probe_claim2(tbl.rows, b.fp, b.created_at, b.active, blk, u)
    new16 = randint32(gen, (batch, F), dev)
    ref = Table2(tbl.rows.clone())
    k2._write_claim(ref, new16, c)
    got = make_sweep2(nb, batch, blk, u)(tbl.rows.clone(), new16, c)
    same = bool(torch.equal(ref.rows, got))
    log(f"correctness vs xla (small): {same}")
    return {"equal": same, "nb": nb, "batch": batch, "blk": blk, "u": u,
            "written": int(c.written.sum())}


def run(seed: int = 11, device=None, small=SMALL, headline=HEADLINE, blks=BLKS, u: int = U,
        reps: int = 7, inner: int = 5) -> dict:
    dev = resolve_device(device)
    gen = generator(dev, seed)
    out = {"script": "exp_sweep4", **device_info(dev), "small": check_small(gen, dev, *small)}
    if not out["small"]["equal"]:
        raise SystemExit("exp_sweep4: the windowed sweep disagrees with the engine's write")
    cap, batch = headline
    table = new_table2(cap, device=dev)
    nb = table.n_buckets
    b = mk_batch(_fps(gen, batch, dev), NOW)
    n16 = torch.zeros((batch, F), dtype=torch.int32, device=dev)
    out.update({"nb": nb, "batch": batch, "u": u, "ms": {}})
    for blk in blks:
        if nb % blk:
            continue
        c = k2._probe_claim2(table.rows, b.fp, b.created_at, b.active, blk, u)
        write = make_sweep2(nb, batch, blk, u)
        ms = time_ms(lambda: write(table.rows, n16, c), dev, reps, inner)
        log(f"sweep2 blk={blk:5d}: {ms:8.4f} ms")
        out["ms"][str(blk)] = ms
        table.rows.zero_()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    emit(run(args.seed, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
