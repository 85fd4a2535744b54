"""Port parity through the service: the JAX package's
``service/runner.EngineRunner`` drives a port engine
(gubernator_tpu_torch.ops.engine.LocalEngine on the CPU) and a JAX engine
through the same sequence of the maintenance calls it makes — serial
checks, ``live_count``, ``table_telemetry``, ``snapshot``,
``tier_demote_idle`` (extract_idle + tombstone_fps in one engine job, rows
unpacked on the host), ``checkpoint_extract`` and ``checkpoint_snapshot``
with an epoch tracker attached, ``extract_live``, ``merge_rows``,
``tombstone_fps``, ``read_state`` and ``read_state_raw``, ``maybe_grow``
and ``snapshot_sync`` — on each slot layout. Every result, EngineStats and
the table bytes must be equal. Tolerance: exact.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from gubernator_tpu.ops import checkpoint as jck
from gubernator_tpu.ops.batch import RequestColumns as JCols
from gubernator_tpu.ops.engine import LocalEngine as JaxEngine
from gubernator_tpu.service.runner import EngineRunner
from gubernator_tpu_torch.ops import checkpoint as tck
from gubernator_tpu_torch.ops.batch import RequestColumns as TCols
from gubernator_tpu_torch.ops.engine import LocalEngine as TorchEngine

torch.set_num_threads(1)

NOW = 1_700_000_000_000
ALGOS = {"full": (0, 1, 2, 3, 4), "gcra32": (2,), "token32": (0,)}


def _plain(x):
    """A comparable form of one runner result."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if hasattr(x, "to_dict"):  # a TableSnapshot of either package
        d = x.to_dict()
        d.pop("scan_ms")
        return d
    if hasattr(x, "F") and hasattr(x, "code"):  # a SlotLayout of either package
        return ("layout", x.name)
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


async def _drive(runner, cols_cls, layout, seed):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63 - 1, 1500, dtype=np.int64)
    out = []
    now = NOW
    for _ in range(3):
        n = 512
        c = dict(fp=rng.choice(pool, n, replace=False),
                 algo=rng.choice(ALGOS[layout], n).astype(np.int32),
                 behavior=np.zeros(n, np.int32), hits=rng.integers(0, 4, n).astype(np.int64),
                 limit=rng.integers(1, 9, n).astype(np.int64), burst=np.zeros(n, np.int64),
                 duration=rng.integers(1, 40, n).astype(np.int64) * 3_600_000,
                 created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8))
        out.append(await runner.check_columns(cols_cls(**c), now_ms=now))
        now += int(rng.integers(1_000, 9_000))
    out.append(await runner.live_count())
    out.append(await runner.table_telemetry(now_ms=now))
    out.append(await runner.snapshot())
    out.append(await runner.tier_demote_idle(5_000, max_rows=100, now_ms=now))
    out.append(await runner.checkpoint_extract(now_ms=now))
    out.append(await runner.checkpoint_extract(now_ms=now))  # empty epoch
    out.append(await runner.checkpoint_snapshot())
    fps, slots = await runner.extract_live(now_ms=now)
    out += [fps, slots]
    # a transfer back under new keys, half of them repeated (two passes)
    new = rng.integers(1, 2**63 - 1, 64, dtype=np.int64)
    ms = slots[:64].copy()
    ms[:, 0] = (new & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    ms[:, 1] = (new >> 32).astype(np.int32)
    out.append(await runner.merge_rows(np.concatenate([new, new[:32]]),
                                       np.concatenate([ms, ms[:32]]), now_ms=now))
    gone = np.concatenate([fps[:40], new[:8], [np.int64(7)]])
    out.append(await runner.tombstone_fps(gone))
    probe = np.concatenate([fps[30:90], new, [np.int64(7)]])
    out.append(await runner.read_state(probe))
    out.append(await runner.read_state_raw(probe))
    out.append(await runner.checkpoint_extract(now_ms=now))
    out.append(await runner.maybe_grow(threshold=0.05, now_ms=now))
    out.append(await runner.live_count())
    out.append(runner.snapshot_sync())
    return out


@pytest.mark.parametrize("layout", ["full", "gcra32", "token32"])
def test_runner_maintenance_calls_match(layout):
    j = JaxEngine(capacity=1 << 12, write_mode="xla", wire="full", layout=layout)
    t = TorchEngine(capacity=1 << 12, write_mode="xla", layout=layout, device="cpu")
    j.ckpt = jck.EpochTracker(j.table.n_buckets)
    t.ckpt = tck.EpochTracker(t.table.n_buckets)
    results = []
    for eng, cols_cls in ((j, JCols), (t, TCols)):
        runner = EngineRunner(eng, fetch_workers=2)
        try:
            results.append(asyncio.run(_drive(runner, cols_cls, layout, seed=17)))
        finally:
            runner.close()
    want, got = results
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _plain(a) == _plain(b), i
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert t.table.capacity == j.table.capacity == 1 << 13  # maybe_grow doubled it
    assert t.snapshot().tobytes() == np.asarray(j.table.rows).tobytes()
    assert t.ckpt.epoch == j.ckpt.epoch == 3
