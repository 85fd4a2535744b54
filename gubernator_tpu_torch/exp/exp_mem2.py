"""Port of exp/exp_mem2.py: gathers, sorts and whole-table sweeps on the card.

    python -m gubernator_tpu_torch.exp.exp_mem2 [--seed N] [--device cuda|cpu]

At the TPU script's geometry (a (2^21, 128) int32 table, 1 GiB; 2^17
rows or keys):

  G1-G4  row gathers (int64 and int32 indices, int32 and float32 tables)
  S1-S3  sorts of 2^17 keys (int64 sort and argsort; int32 key + payload)
  P1     the whole-table copy sweep, out of place (sweeps.sweep_copy)
  P2     the one-hot scatter sweep, U=64, out of place (sweeps.sweep_rows)
  P3     the same, U=128
  P4     the same as P2 with the table updated in place

G and S are plain XLA programs in the TPU script, so here they are single
PyTorch calls; P1-P4 are the port's kernels. As in the TPU script the
update rows and masks are zero and window entry j names bucket row j of
its block. Lines on stderr; one JSON line on stdout.
"""

from __future__ import annotations

import argparse

import torch

from gubernator_tpu_torch.device import resolve_device
from gubernator_tpu_torch.exp import sweeps
from gubernator_tpu_torch.exp._timing import device_info, emit, generator, log, time_ms

NB = 1 << 21  # 2M buckets (= 16.7M slots at K=8)
ROW = 128  # 8 slots x 16 fields
B = 1 << 17
BLK = 2048  # bucket rows per sweep block
U, U2 = 64, 128  # update windows of P2/P4 and P3


def updates(nblk: int, u: int, device: torch.device):
    """The script's update window: zero rows, zero masks, entry j of each
    window naming bucket row j."""
    rows = torch.zeros((nblk * u, ROW), dtype=torch.int32, device=device)
    mask = torch.zeros((nblk * u, ROW), dtype=torch.int8, device=device)
    bkt = torch.arange(u, dtype=torch.int32, device=device).repeat(nblk)
    return rows, mask, bkt


def run(seed: int = 0, device=None, nb: int = NB, batch: int = B, blk: int = BLK,
        reps: int = 7, inner: int = 5) -> dict:
    dev = resolve_device(device)
    gen = generator(dev, seed)
    out = {"script": "exp_mem2", **device_info(dev), "nb": nb, "batch": batch, "ms": {}}

    def timed(name: str, fn) -> None:
        ms = time_ms(fn, dev, reps, inner)
        log(f"{name:55s} {ms:10.4f} ms")
        out["ms"][name.split(":")[0]] = ms

    tbl_i32 = torch.zeros((nb, ROW), dtype=torch.int32, device=dev)
    tbl_f32 = torch.zeros((nb, ROW), dtype=torch.float32, device=dev)
    buckets = torch.randint(0, nb, (batch,), dtype=torch.int64, device=dev, generator=gen)
    buckets32 = buckets.to(torch.int32)
    keys = torch.randint(1, 1 << 62, (batch,), dtype=torch.int64, device=dev, generator=gen)
    pay32 = torch.arange(batch, dtype=torch.int32, device=dev)

    timed(f"G1: ({batch},128) i32 row gather from ({nb},128)", lambda: tbl_i32[buckets])
    timed("G2: (B,128) f32 row gather", lambda: tbl_f32[buckets])
    timed("G3: same, i32 idx", lambda: tbl_i32[buckets32])
    timed("G4: index_select rows", lambda: tbl_i32.index_select(0, buckets))
    timed("S1: sort B i64 keys", lambda: torch.sort(keys).values)
    timed("S2: argsort B i64 keys", lambda: torch.argsort(keys))

    def sort_pair():
        k, idx = torch.sort(buckets32, stable=True)
        return k, pay32[idx]

    timed("S3: sort (i32 key, i32 payload)", sort_pair)
    del tbl_f32

    nblk = nb // blk
    dst = torch.empty_like(tbl_i32)
    timed("P1: sweep copy (NB,128) i32, out of place",
          lambda: sweeps.sweep_copy(tbl_i32, dst))
    rows, mask, bkt = updates(nblk, U, dev)
    timed(f"P2: sweep + one-hot scatter U={U}",
          lambda: sweeps.sweep_rows(tbl_i32, rows, mask, bkt, U, out=dst))
    rows2, mask2, bkt2 = updates(nblk, U2, dev)
    timed(f"P3: sweep + one-hot scatter U={U2}",
          lambda: sweeps.sweep_rows(tbl_i32, rows2, mask2, bkt2, U2, out=dst))
    timed(f"P4: sweep scatter U={U}, in place",
          lambda: sweeps.sweep_rows(tbl_i32, rows, mask, bkt, U))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    emit(run(args.seed, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
