"""The parsed request batch of the serving edge (the port of
``gubernator_tpu/service/wire.py``, ``WireBatch`` only).

A ``WireBatch`` carries both serving forms of one request batch: the
column view (``ops.batch.RequestColumns``) and the pre-packed compact-wire
lanes (``ops/wire.py`` layout) with a per-row ``encodable`` flag. The JAX
package's native parser (``native/guberhost.cpp``, ``parse_get_rate_limits``)
produces the lanes in the same pass over the request bytes;
``wire_batch_from_columns`` is a numpy copy of that lane pass over
already-parsed columns, which feeds ``engine.prepare_check_wire`` and
``engine.prepare_ring_slot`` until the parser and the service layer are
ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from gubernator_tpu_torch.ops import wire as wire_mod
from gubernator_tpu_torch.ops.batch import RequestColumns

# the client-facing behaviour bits the parser keeps (the higher bits are
# the internal cascade level)
BEHAVIOR_CLIENT_MASK = 255


class WireBatch(NamedTuple):
    """One parsed request batch: columns, the (5, n) int32 lanes (lane 4's
    created-delta bits zero until the flush stamps them) and the per-row
    compact-wire encodability."""

    cols: RequestColumns
    lanes: np.ndarray  # (5, n) int32
    encodable: np.ndarray  # (n,) bool

    @property
    def rows(self) -> int:
        return self.cols.fp.shape[0]


def wire_batch_from_columns(cols: RequestColumns) -> WireBatch:
    """The parser's lane pass over parsed columns. A row with a
    fingerprint-stage error (empty key or name) has all-zero lanes and
    counts as encodable; any other row is encodable when its masked
    behaviour holds only compact flags, its duration, hits, limit, burst
    and algorithm fit the lanes, an explicit burst is on a token row only,
    and it carries no cascade level (behaviour bits 8-15)."""
    n = cols.fp.shape[0]
    ok = cols.err == 0
    beh = cols.behavior.astype(np.int64)
    algo = cols.algo.astype(np.int64)
    enc = (
        ((beh & BEHAVIOR_CLIENT_MASK & ~wire_mod._ENCODABLE_BEHAVIOR) == 0)
        & (cols.duration >= 0) & (cols.duration <= wire_mod._DUR_MASK)
        & (cols.hits >= 0) & (cols.hits <= wire_mod._HITS_MASK)
        & (cols.limit >= 0) & (cols.limit <= wire_mod.I32_MAX)
        & (cols.burst >= -wire_mod.I32_MAX) & (cols.burst <= wire_mod.I32_MAX)
        & (algo >= 0) & (algo <= wire_mod._MAX_ALGO)
        & ((algo == 0) | (cols.burst == 0))
        & (((beh >> 8) & 0xFF) == 0)
    )
    fp = np.where(ok, cols.fp, 0).astype(np.int64)
    l4 = (
        (cols.hits.astype(np.int64) & wire_mod._HITS_MASK)
        | (((beh >> 6) & 3) << wire_mod.PRIO_SHIFT)
        | (((beh & 8) != 0).astype(np.int64) << 30)
        | (((beh & 32) != 0).astype(np.int64) << 31)
    )
    lanes = np.stack([
        fp & 0xFFFFFFFF,
        fp >> 32,
        cols.limit.astype(np.int64),
        (cols.duration.astype(np.int64) & wire_mod._DUR_MASK) | ((algo & 0xFFFFFFFF) << 27),
        l4,
    ])
    lanes = np.where(ok, lanes, 0).astype(np.int64).astype(np.int32)
    return WireBatch(cols=cols, lanes=lanes.reshape(5, n), encodable=np.where(ok, enc, True))
