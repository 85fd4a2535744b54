"""Incremental checkpoints: the dirty-block epoch tracker and the dirty-block
extract (the port of ``gubernator_tpu/ops/checkpoint.py``).

* **EpochTracker** — a host bitmap of dirty blocks (``bucket // blk``, one
  bit per (shard, block)). Every table mutation marks the blocks of the
  fingerprints it touches on the engine thread, before (or in the same job
  as) the mutation's launch; ``take()`` runs on the engine thread just
  before the extract's launch, so a dirtied block never falls between two
  epochs.
* **extract** — the ``extract_live_rows`` pattern over the dirty blocks
  only: one gather of their bucket rows, a live filter, the live slots
  sorted to the front (stable, so in block order), and a host fetch of the
  live prefix. Cost follows the dirty blocks, not the table.

Extracted slots keep the table's own slot layout ((N, F) int32), which is
what ``merge_rows`` takes on replay; a stale or repeated frame can only
tighten admission (the conservative merge).
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.ops.layout import FULL, SlotLayout, layout_for_row
from gubernator_tpu_torch.ops.table2 import K, _fetch_prefix, _front, _slot_fp_exp


def ckpt_blk() -> int:
    """Buckets per checkpoint dirty block (GUBER_CHECKPOINT_BLK), bucket
    granularity (1) by default: extract cost is dirty blocks × blk × K
    slots, so the tracking block hugs the placement granularity."""
    return int(os.environ.get("GUBER_CHECKPOINT_BLK", "1"))


class EpochTracker:
    """Host-side dirty-block accumulator between checkpoint epochs.

    ``mark()`` is a vectorised setitem on the serving path, ``take()``
    snapshots and clears the set for one epoch, ``remark()`` re-arms a
    taken set whose save failed. Thread-safe: marks come from the engine
    thread, takes from the checkpoint manager, status reads from anywhere."""

    def __init__(self, n_buckets: int, n_shards: int = 1, blk: Optional[int] = None,
                 start_epoch: int = 0):
        if n_buckets <= 0:
            raise ValueError("n_buckets must be positive")
        b = min(blk or ckpt_blk(), n_buckets)
        # conforming tables (new_table2) are a power of two below 2048
        # buckets or a multiple of 2048 above: some power of two ≤ b divides
        while b > 1 and n_buckets % b:
            b //= 2
        self.blk = b
        self.n_buckets = n_buckets
        self.n_shards = n_shards
        self.nblk = n_buckets // b  # blocks per shard
        self._dirty = np.zeros(n_shards * self.nblk, dtype=bool)
        # completed epochs; take() hands out epoch + 1 and advances
        self.epoch = start_epoch
        self.marked_fps = 0  # cumulative fingerprints marked (status surface)
        self._lock = threading.Lock()

    def _block_ids(self, fps: np.ndarray) -> np.ndarray:
        fps = np.asarray(fps, dtype=np.int64)
        fps = fps[fps != 0]  # padding and inactive rows carry fp == 0
        if fps.size == 0:
            return fps
        blkid = (fps % self.n_buckets) // self.blk
        if self.n_shards > 1:
            from gubernator_tpu_torch.parallel.mesh import shard_of

            blkid = shard_of(fps, self.n_shards) * self.nblk + blkid
        return blkid

    def mark(self, fps: np.ndarray) -> None:
        """Mark the blocks holding `fps` dirty (fp == 0 entries ignored)."""
        blkid = self._block_ids(fps)
        if blkid.size == 0:
            return
        with self._lock:
            self._dirty[blkid] = True
            self.marked_fps += int(blkid.size)

    def mark_all(self) -> None:
        """Everything is dirty (a restore or resize of unknown provenance):
        the next epoch extracts the whole live set once."""
        with self._lock:
            self._dirty[:] = True

    def take(self) -> Tuple[int, np.ndarray]:
        """Snapshot and clear the dirty set for one epoch: (epoch id, sorted
        global block ids). The epoch advances on an empty take too, so
        frame ids stay monotone."""
        with self._lock:
            gids = np.nonzero(self._dirty)[0].astype(np.int64)
            self._dirty[:] = False
            self.epoch += 1
            return self.epoch, gids

    def remark(self, gids: np.ndarray) -> None:
        """Re-arm a taken block set whose frame could not be persisted."""
        if gids.size == 0:
            return
        with self._lock:
            self._dirty[np.asarray(gids, dtype=np.int64)] = True

    @property
    def dirty_blocks(self) -> int:
        with self._lock:
            return int(self._dirty.sum())

    def rebuild(self, n_buckets: int) -> "EpochTracker":
        """Tracker for a resized table: the same epoch lineage, everything
        dirty (block ids do not survive a geometry change)."""
        t = EpochTracker(n_buckets, n_shards=self.n_shards, blk=self.blk,
                         start_epoch=self.epoch)
        t.mark_all()
        return t


# ------------------------------------------------------------- extract pass


def _extract_blocks_core(rows2d: torch.Tensor, bidx: torch.Tensor, now: int, blk: int,
                         layout: Optional[SlotLayout] = None):
    """Gather the blocks' bucket rows, filter live slots, pack them to the
    front. `rows2d` is (T, K·F); `bidx` (g,) int64 block ids, where ids past
    the table are padding: they read as zero rows (fp 0, never live), as
    JAX's ``jnp.take(mode="fill")`` reads them. Returns (slots (g·blk·K, F)
    live-first, fp (g·blk·K,), live count)."""
    layout = FULL if layout is None else layout
    g = bidx.shape[0]
    T = rows2d.shape[0]
    rowidx = (bidx[:, None] * blk
              + torch.arange(blk, dtype=torch.int64, device=bidx.device)[None, :]).reshape(-1)
    inside = rowidx < T
    blocks = rows2d.index_select(0, torch.where(inside, rowidx, torch.zeros_like(rowidx)))
    blocks = blocks.masked_fill(~inside[:, None], 0)
    slots = blocks.reshape(g * blk * K, layout.F)
    fp, exp = _slot_fp_exp(slots, layout)
    return _front(slots, fp, (fp != 0) & (exp >= now))


def _extract_blocks_sorted(rows: torch.Tensor, bidx: torch.Tensor, now: int, *, blk: int,
                           layout: SlotLayout):
    """Single-array entry: any (..., K·F) rows tensor (block ids are then
    global, shard-major)."""
    return _extract_blocks_core(rows.reshape(-1, layout.row), bidx, now, blk, layout)


def _pad_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def extract_begin(rows: torch.Tensor, gids: np.ndarray, blk: int, now_ms: int,
                  layout: Optional[SlotLayout] = None):
    """Launch half of a dirty-block extract (engine thread: reads a coherent
    table, costs the enqueue): the block list padded to a power of two with
    a sentinel one past the last block, then the gather + filter + pack.
    Returns a pending handle for finish_extract."""
    layout = layout_for_row(int(rows.shape[-1])) if layout is None else layout
    sentinel = int(np.prod(rows.shape[:-1])) // blk
    g = int(gids.shape[0])
    bidx = np.full(_pad_pow2(max(g, 1)), sentinel, dtype=np.int64)
    bidx[:g] = gids
    return _extract_blocks_sorted(rows, torch.from_numpy(bidx).to(rows.device),
                                  int(now_ms), blk=blk, layout=layout)


def finish_extract(pending):
    """Fetch half (any thread): the live count, then only the live prefix
    (the extract_live_rows fetch rule). Slots come back in the table's own
    layout."""
    slots_s, fp_s, cnt = pending
    return _fetch_prefix(slots_s, fp_s, int(cnt), int(slots_s.shape[-1]))
