"""The decide loop: K decide dispatches with no host work between them (the
port of ``gubernator_tpu/ops/loop.py``).

A device-bound measurement needs the card's time per decision, not the
host's time per launch: a host-driven loop of K dispatches makes about 143
launches per dispatch and leaves the card mostly idle. The JAX package runs
the K iterations inside one jitted ``lax.fori_loop`` with a traced trip
count. The port's counterpart on the card is CUDA graphs: one graph per
stacked batch, each holding one ``decide2_impl`` dispatch and the update of
the totals, captured once and replayed for batch ``i % n``, ``i < k``. One
capture serves every ``k`` (the JAX loop's traced ``k``: no retrace).

The graphs are cached by the table's rows pointer and geometry, the stacked
tensors and ``write`` / ``math`` / ``probe``; a new rows tensor (after a
resize or a layout migration) gets a new capture. A capture that fails
raises: the card never quietly runs the eager loop. On the CPU the loop is
plain: ``decide2_impl`` over ``stacked[i % n]``, ``k`` times.

This harness adds no semantics: the table and the totals equal ``k``
sequential ``decide2_impl`` calls.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Tuple

import torch

from gubernator_tpu_torch import device as device_mod
from gubernator_tpu_torch.ops.batch import ReqBatch
from gubernator_tpu_torch.ops.kernel2 import decide2_impl
from gubernator_tpu_torch.ops.table2 import Table2

_MAX_CAPTURES = 4  # cached graph sets; the oldest is dropped past this


def stack_batches(batches: List[ReqBatch]) -> ReqBatch:
    """Stack N same-shape request batches along a new leading axis: one
    (N, B) tensor per column, on the batches' device."""
    return ReqBatch(*[torch.stack(cols) for cols in zip(*batches)])


def _step(table: Table2, b: ReqBatch, acc: torch.Tensor, write, math, probe) -> None:
    """One dispatch and its totals, added into `acc` in place."""
    _t, _resp, st = decide2_impl(table, b, write=write, math=math, probe=probe)
    acc.add_(torch.stack([st.cache_hits, st.cache_misses, st.over_limit, st.dropped]))


def _batch(stacked: ReqBatch, j: int) -> ReqBatch:
    return ReqBatch(*[col[j] for col in stacked])


class _Captured:
    """One stacked batch set's graphs on one table, the totals they add
    into, and every scratch buffer alive at capture (the walk's zeroed
    words), held so their memory outlives the graphs. The table and the
    batches are not held: a call replays an entry only when its own
    tensors lie at the captured addresses, with the captured shapes."""

    __slots__ = ("graphs", "acc", "scratch")

    def __init__(self, graphs, acc, scratch):
        self.graphs = graphs
        self.acc = acc
        self.scratch = scratch


class LoopGraphs:
    """Cache of captured decide loops (most recent last). ``captures``
    counts the captures made, so a caller can see one capture serve every
    ``k``."""

    def __init__(self):
        self._entries: "OrderedDict[tuple, _Captured]" = OrderedDict()
        self.captures = 0

    @staticmethod
    def _key(table: Table2, stacked: ReqBatch, write, math, probe) -> tuple:
        rows = table.rows
        cols = tuple((c.data_ptr(), tuple(c.shape), c.dtype, tuple(c.stride())) for c in stacked)
        return (rows.data_ptr(), tuple(rows.shape), table.layout.name, cols, write, math, probe)

    def get(self, table: Table2, stacked: ReqBatch, write, math, probe) -> _Captured:
        key = self._key(table, stacked, write, math, probe)
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            return entry
        entry = self._capture(table, stacked, write, math, probe)
        self._entries[key] = entry
        while len(self._entries) > _MAX_CAPTURES:
            self._entries.popitem(last=False)
        return entry

    def _capture(self, table: Table2, stacked: ReqBatch, write, math, probe) -> _Captured:
        dev = table.rows.device
        n = stacked.fp.shape[0]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        # warm-up on the capture stream, on a small table of the same layout:
        # it builds and loads the kernels and makes the walk's scratch words
        # for this stream, so nothing is allocated or built mid-capture; the
        # real table is not touched
        warm = Table2(torch.zeros((2048, table.layout.row), dtype=torch.int32, device=dev),
                      table.layout)
        with torch.cuda.stream(side):
            _step(warm, _batch(stacked, 0), torch.zeros(4, dtype=torch.int64, device=dev),
                  write, math, probe)
        side.synchronize()
        del warm
        acc = torch.zeros(4, dtype=torch.int64, device=dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        for j in range(n):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=side):
                _step(table, _batch(stacked, j), acc, write, math, probe)
            graphs.append(g)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.captures += 1
        return _Captured(graphs, acc, device_mod.scratch_buffers())

    def clear(self) -> None:
        """Drop every capture (and the memory its graphs hold)."""
        self._entries.clear()


_GRAPHS = LoopGraphs()


def decide_loop(table: Table2, stacked: ReqBatch, k, *, write: str = "sweep",
                math: str = "mixed", probe: str = "xla",
                graphs: LoopGraphs = None) -> Tuple[Table2, torch.Tensor]:
    """Run `k` decide2 dispatches, cycling over the stacked batches; returns
    (table, [hits, misses, over, dropped] int64 totals). ``table.rows`` is
    updated in place (the JAX loop donates the table instead).

    The totals are the proof of work: a rate derived from this loop is
    published only when hits + misses == k · active rows
    (bench_guard.check_work). On the card the dispatches are CUDA graph
    replays (`graphs`, the module's cache by default); on the CPU a plain
    loop."""
    k = int(k)
    n = int(stacked.fp.shape[0])
    dev = table.rows.device
    if any(col.device != dev for col in stacked):
        raise ValueError(f"stacked batches must be on the table's device {dev}")
    if dev.type == "cpu":
        acc = torch.zeros(4, dtype=torch.int64)
        for i in range(k):
            _step(table, _batch(stacked, i % n), acc, write, math, probe)
        return table, acc
    if dev.type != "cuda":
        raise ValueError(f"decide_loop runs on cuda or cpu tables, got {dev}")
    entry = (graphs or _GRAPHS).get(table, stacked, write, math, probe)
    with torch.cuda.device(dev):
        entry.acc.zero_()
        for i in range(k):
            entry.graphs[i % n].replay()
        return table, entry.acc.clone()
