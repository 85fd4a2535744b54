"""Ownership handoff — device-side state migration on topology change.

The reference accepts that a SetPeers hot-swap strands counter state: keys
whose ring ownership moves are answered fresh by the new owner while the old
owner's rows linger until TTL — a double-capacity window on every scale
event or rolling restart (reference gubernator.go:694-789 rebuilds the
pickers and does nothing with the cache). This manager closes that window
Dynamo-style (DeCandia et al., SOSP'07) adapted to an HBM-resident table:

* **rebalance** (set_peers diff): the device packs every live slot in one
  filter pass (table2.extract_live_rows — the TPU pays for partitioning,
  the host fetches only the live prefix); rows owned by this daemon under
  the OLD ring whose NEW owner is another peer are chunked into idempotent
  TransferState RPCs; the destination merges them through the conservative
  merge kernel (kernel2.merge2 — remaining=min, expiry=max, newest config
  wins, so a retried or crossed transfer can never grant extra capacity);
  the source tombstones rows only after their chunk is acked.
* **drain** (daemon.stop(drain=True)): same machinery with ownership
  computed as if this daemon had already left the ring (owners_of(...,
  exclude=self)) — every owned live row moves to its ring successor under
  a deadline; the unacked remainder stays in the table for the shutdown
  checkpoint (store.FileLoader) and is counted `snapshotted`.

Chunk sends are breaker-gated (service/breaker.py) with jittered-exponential
retry inside the round's deadline — mid-handoff faults cost retries, not
lost rows. Fingerprint → ring-point mapping comes from the daemon's
OwnershipIndex sidecar (peers/ownership.py); rows without a recorded point
cannot be routed and degrade to the reference's behavior for exactly those
rows.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Dict, List, Optional

import numpy as np

from gubernator_tpu_torch.service.peer_client import PeerCircuitOpenError, PeerError
from gubernator_tpu_torch.service.wire import transfer_chunk_pb

log = logging.getLogger("gubernator_tpu_torch.handoff")


class HandoffManager:
    def __init__(self, daemon):
        self.daemon = daemon
        b = daemon.conf.behaviors
        self.enabled = b.handoff_enabled
        self.chunk_rows = int(b.handoff_chunk_rows)
        self.deadline_s = b.handoff_deadline_ms / 1e3
        self.rpc_timeout_s = b.batch_timeout_ms / 1e3
        self.metrics = daemon.metrics
        self._seq = 0
        # one round at a time: overlapping rebalances (a flapping discovery
        # backend) would race extract/tombstone against each other
        self._lock = asyncio.Lock()
        # progress surface for /v1/debug/peers: is a round running, and what
        # did the last one move
        self.active = False
        self.rounds = 0
        self.last_round: Dict[str, float] = {}

    # ------------------------------------------------------------- entries
    async def rebalance(self, old_picker, new_picker) -> Dict[str, int]:
        """Move rows whose ownership left this daemon between two ring
        generations (the set_peers diff path)."""
        async with self._lock:
            return await self._round(old_picker, new_picker, frozenset())

    async def drain(self) -> Dict[str, int]:
        """Hand every owned live row to its ring successor (graceful-drain
        path): new ownership is computed with this daemon excluded, exactly
        what the surviving peers' rings will resolve once it is gone."""
        picker = self.daemon._local_picker
        self_addr = self.daemon.conf.advertise_address
        if picker.size() <= 1:
            return dict(extracted=0, transferred=0, tombstoned=0,
                        snapshotted=0, unroutable=0)
        async with self._lock:
            stats = await self._round(picker, picker, frozenset({self_addr}))
        snapshotted = stats["extracted"] - stats["transferred"]
        if snapshotted > 0:
            self.metrics.handoff_rows.labels(phase="snapshotted").inc(
                snapshotted
            )
        stats["snapshotted"] = snapshotted
        return stats

    # --------------------------------------------------------------- round
    async def _round(self, old_picker, new_picker, exclude) -> Dict[str, int]:
        t0 = time.perf_counter()
        daemon = self.daemon
        self_addr = daemon.conf.advertise_address
        stats = dict(extracted=0, transferred=0, tombstoned=0, unroutable=0)
        self.active = True
        try:
            fps, slots = await daemon.runner.extract_live()
            if fps.shape[0] == 0:
                return stats
            points, found = daemon.ownership.points_for(fps)
            stats["unroutable"] = int((~found).sum())
            idx = np.nonzero(found)[0]
            if idx.size == 0:
                return stats
            pts = points[idx]
            old_addr = np.array(
                [o.grpc_address for o in old_picker.owners_of(pts)]
            )
            new_owners = new_picker.owners_of(pts, exclude=exclude)
            new_addr = np.array([o.grpc_address for o in new_owners])
            move = (old_addr == self_addr) & (new_addr != self_addr)
            n_move = int(move.sum())
            if n_move == 0:
                return stats
            stats["extracted"] = n_move
            self.metrics.handoff_rows.labels(phase="extracted").inc(n_move)
            self._seq += 1
            transfer_id = f"{self_addr}/{daemon.conf.instance_id}/{self._seq}"
            now = daemon.now_ms()
            deadline = asyncio.get_running_loop().time() + self.deadline_s
            acked: List[np.ndarray] = []
            sends = []
            for dest in sorted(set(new_addr[move].tolist())):
                rows = idx[move & (new_addr == dest)]
                info = new_picker.get_by_address(dest)
                if info is None:  # pragma: no cover - defensive
                    continue
                sends.append(
                    self._send_dest(
                        info, fps[rows], points[rows], slots[rows],
                        f"{transfer_id}/{dest}", now, deadline, acked,
                    )
                )
            await asyncio.gather(*sends)
            if acked:
                acked_fps = np.concatenate(acked)
                stats["transferred"] = int(acked_fps.shape[0])
                removed = await daemon.runner.tombstone_fps(acked_fps)
                daemon.ownership.discard(acked_fps)
                stats["tombstoned"] = removed
                self.metrics.handoff_rows.labels(phase="tombstoned").inc(
                    removed
                )
            if stats["transferred"] < n_move:
                log.warning(
                    "handoff round incomplete: %d/%d rows acked before the "
                    "deadline (unacked rows stay in the local table)",
                    stats["transferred"], n_move,
                )
            return stats
        finally:
            self.active = False
            self.rounds += 1
            self.last_round = {
                **stats, "duration_ms": round((time.perf_counter() - t0) * 1e3, 1),
            }
            self.metrics.handoff_duration.observe(time.perf_counter() - t0)
            log.info(
                "handoff round: %s in %.1f ms",
                stats, (time.perf_counter() - t0) * 1e3,
            )

    async def _send_dest(
        self, info, fps, points, slots, transfer_id, now, deadline, acked_out
    ) -> None:
        """Ship one destination's rows in chunks; each chunk retries with
        jittered-exponential backoff inside the round deadline. Acked chunk
        fps land in `acked_out` (the source tombstones only those)."""
        daemon = self.daemon
        client = daemon.peer_client(info)
        if client is None:
            return
        loop = asyncio.get_running_loop()
        n = fps.shape[0]
        total = -(-n // self.chunk_rows)
        # chunks travel in this daemon's own slot layout; the receiver
        # converts through the canonical full row on mismatch (merge_rows)
        layout = daemon.engine.table.layout
        for ci in range(total):
            sl = slice(ci * self.chunk_rows, (ci + 1) * self.chunk_rows)
            req = transfer_chunk_pb(
                transfer_id, ci, total, daemon.conf.advertise_address, now,
                fps[sl], points[sl], slots[sl], layout=layout,
            )
            attempt = 0
            while True:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    return  # this chunk (and the rest) stays local
                try:
                    resp = await client.transfer_state(
                        req, timeout=min(self.rpc_timeout_s, remaining)
                    )
                except PeerCircuitOpenError as exc:
                    # cooldown, then the next attempt is the half-open probe
                    await asyncio.sleep(
                        max(0.0, min(exc.retry_after_s, remaining, 0.25))
                    )
                except PeerError:
                    attempt += 1
                    self.metrics.handoff_chunk_retries.inc()
                    await asyncio.sleep(
                        max(0.0, min(
                            random.uniform(0, 0.02 * (2 ** min(attempt, 6))),
                            remaining,
                        ))
                    )
                else:
                    count = int(fps[sl].shape[0])
                    acked_out.append(fps[sl])
                    self.metrics.handoff_rows.labels(
                        phase="transferred"
                    ).inc(count)
                    if resp.duplicate:
                        log.debug(
                            "transfer chunk %s/%d was an idempotent replay",
                            transfer_id, ci,
                        )
                    break
