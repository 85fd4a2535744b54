"""PeerClient — one per remote peer; forwarding with batch coalescing.

Mirrors reference peer_client.go: a gRPC connection plus a batching queue that
flushes at BatchLimit (1000) or BatchWait (500 µs), a NO_BATCHING direct path,
a graceful Shutdown that drains in-flight requests, and a recent-error LRU
feeding the health check (reference peer_client.go:86-451).

Raw grpc.aio unary calls are built from method paths + pb2 serializers — no
generated stubs needed (the repo's pb2 files carry messages only).
"""

from __future__ import annotations

import asyncio
import collections
import time
from typing import List, Optional, Tuple

import grpc

from gubernator_tpu_torch import tracing
from gubernator_tpu_torch.proto import globalsync_pb2 as globalsync_pb
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.proto import handoff_pb2 as handoff_pb
from gubernator_tpu_torch.proto import peers_pb2 as peers_pb
from gubernator_tpu_torch.service import deadline as deadline_mod
from gubernator_tpu_torch.service.breaker import CircuitBreaker
from gubernator_tpu_torch.types import Behavior, PeerInfo, has_behavior

GET_PEER_RATE_LIMITS = "/pb.gubernator.PeersV1/GetPeerRateLimits"
UPDATE_PEER_GLOBALS = "/pb.gubernator.PeersV1/UpdatePeerGlobals"
TRANSFER_STATE = "/pb.gubernator.PeersV1/TransferState"
SYNC_GLOBALS_WIRE = "/pb.gubernator.PeersV1/SyncGlobalsWire"
SYNC_REGIONS_WIRE = "/pb.gubernator.PeersV1/SyncRegionsWire"
GET_RATE_LIMITS = "/pb.gubernator.V1/GetRateLimits"
HEALTH_CHECK = "/pb.gubernator.V1/HealthCheck"

LAST_ERRS_CAP = 100  # reference peer_client.go:211-240 — LRU(100)
LAST_ERRS_TTL_S = 300.0  # 5-minute TTL


class PeerError(Exception):
    """RPC-level failure talking to a peer (carries the address)."""

    def __init__(self, address: str, cause: BaseException):
        super().__init__(f"peer {address}: {cause}")
        self.address = address
        self.cause = cause


class PeerCircuitOpenError(PeerError):
    """Fast-fail: the peer's circuit breaker refused the attempt — no RPC
    was made (and none should be retried against the same peer until the
    cooldown elapses)."""

    def __init__(self, address: str, retry_after_s: float = 0.0):
        super().__init__(
            address,
            RuntimeError(
                f"circuit breaker open (retry in {retry_after_s * 1e3:.0f} ms)"
            ),
        )
        self.retry_after_s = retry_after_s


class PeerClient:
    def __init__(
        self,
        info: PeerInfo,
        batch_wait_ms: float = 0.5,
        batch_limit: int = 1000,
        batch_timeout_ms: float = 500.0,
        metrics=None,
        channel_credentials=None,
        breaker: Optional[CircuitBreaker] = None,
    ):
        self.info = info
        self.batch_wait_s = batch_wait_ms / 1e3
        self.batch_limit = batch_limit
        self.timeout_s = batch_timeout_ms / 1e3
        self.metrics = metrics
        self._creds = channel_credentials
        if breaker is None:
            breaker = CircuitBreaker()
        self.breaker = breaker
        if metrics is not None and breaker._on_state is None:
            gauge = metrics.circuit_breaker_state.labels(
                peer=info.grpc_address
            )
            gauge.set(int(breaker.state))
            breaker._on_state = lambda s: gauge.set(int(s))
        self._channel: Optional[grpc.aio.Channel] = None
        self._queue: List[Tuple[pb.RateLimitReq, asyncio.Future]] = []
        self._wake: Optional[asyncio.Event] = None
        self._loop_task: Optional[asyncio.Task] = None
        self._inflight = 0
        self._closed = False
        self.last_errs: collections.deque = collections.deque(maxlen=LAST_ERRS_CAP)

    # ------------------------------------------------------------- transport
    def _chan(self) -> grpc.aio.Channel:
        if self._channel is None:
            opts = [
                ("grpc.max_receive_message_length", 1 << 20),  # daemon.go:133
            ]
            if self._creds is not None:
                self._channel = grpc.aio.secure_channel(
                    self.info.grpc_address, self._creds, options=opts
                )
            else:
                self._channel = grpc.aio.insecure_channel(
                    self.info.grpc_address, options=opts
                )
        return self._channel

    def _record_err(self, exc: BaseException) -> None:
        self.last_errs.append((time.monotonic(), str(exc)))

    def recent_errors(self) -> List[str]:
        cutoff = time.monotonic() - LAST_ERRS_TTL_S
        return [msg for ts, msg in self.last_errs if ts >= cutoff]

    async def _unary(self, path: str, req, resp_cls, timeout: Optional[float] = None):
        # the breaker gates EVERY unary RPC toward this peer — forwards,
        # GLOBAL hit-syncs and broadcasts all fail fast while it is open
        # instead of stacking timeout waits on a dead peer
        if not self.breaker.allow():
            raise PeerCircuitOpenError(
                self.info.grpc_address, self.breaker.retry_after_s()
            )
        call = self._chan().unary_unary(
            path,
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString,
        )
        try:
            resp = await call(req, timeout=timeout or self.timeout_s)
        except asyncio.CancelledError:
            # task cancellation must propagate, not become a PeerError; it is
            # no verdict on the peer either — release any probe slot
            self.breaker.record_discard()
            raise
        except BaseException as exc:
            self.breaker.record_failure()
            self._record_err(exc)
            raise PeerError(self.info.grpc_address, exc) from exc
        self.breaker.record_success()
        return resp

    # ------------------------------------------------------------ peer RPCs
    async def get_peer_rate_limits(
        self, req: "peers_pb.GetPeerRateLimitsReq", timeout: Optional[float] = None
    ) -> "peers_pb.GetPeerRateLimitsResp":
        return await self._unary(
            GET_PEER_RATE_LIMITS, req, peers_pb.GetPeerRateLimitsResp, timeout
        )

    async def update_peer_globals(
        self, req: "peers_pb.UpdatePeerGlobalsReq", timeout: Optional[float] = None
    ) -> "peers_pb.UpdatePeerGlobalsResp":
        return await self._unary(
            UPDATE_PEER_GLOBALS, req, peers_pb.UpdatePeerGlobalsResp, timeout
        )

    async def sync_globals_wire(
        self,
        req: "globalsync_pb.SyncGlobalsWireReq",
        timeout: Optional[float] = None,
    ) -> "globalsync_pb.SyncGlobalsWireResp":
        """Ship one compact GLOBAL hit-sync batch (service/wire.sync_wire_pb)
        to the owning peer — the inter-slice half of the hierarchical sync.
        `wire_sync_ok` latches False when the peer answers UNIMPLEMENTED (a
        pre-compact build), so the manager falls back to the proto path
        permanently for that peer instead of probing every round."""
        return await self._unary(
            SYNC_GLOBALS_WIRE, req, globalsync_pb.SyncGlobalsWireResp, timeout
        )

    # latched by GlobalManager on UNIMPLEMENTED — peer runs a pre-compact
    # build; the proto path serves it with identical semantics
    wire_sync_ok = True

    async def sync_regions_wire(
        self,
        req,
        timeout: Optional[float] = None,
    ):
        """Ship one compact cross-region delta batch
        (service/wire.sync_regions_pb) to the key owner in a remote region.
        `region_wire_ok` latches False when the peer answers UNIMPLEMENTED
        (a pre-region-merge build), so the RegionManager falls back to the
        classic GetPeerRateLimits proto path permanently for that peer."""
        from gubernator_tpu_torch.proto import regionsync_pb2 as regionsync_pb

        return await self._unary(
            SYNC_REGIONS_WIRE, req, regionsync_pb.SyncRegionsWireResp,
            timeout,
        )

    # latched by RegionManager on UNIMPLEMENTED — peer predates the region
    # merge plane; the proto fallback serves it with legacy semantics
    region_wire_ok = True

    async def transfer_state(
        self, req: "handoff_pb.TransferStateReq", timeout: Optional[float] = None
    ) -> "handoff_pb.TransferStateResp":
        """One ownership-handoff chunk toward this peer. Breaker-gated like
        every unary (an open breaker fast-fails so the handoff's deadline is
        spent on reachable destinations); idempotent on the receiver, so the
        caller retries failed chunks freely."""
        return await self._unary(
            TRANSFER_STATE, req, handoff_pb.TransferStateResp, timeout
        )

    # ------------------------------------------------- forwarding (batched)
    async def get_peer_rate_limit(self, item: "pb.RateLimitReq") -> "pb.RateLimitResp":
        """Forward one item to this peer. BATCHING (default) coalesces into
        the 500 µs / 1000-item window; NO_BATCHING and GLOBAL-accumulated
        sends go direct (reference peer_client.go:126-162)."""
        if self._closed:
            raise PeerError(self.info.grpc_address, RuntimeError("peer client closed"))
        if self.breaker.blocked:
            # fail BEFORE enqueueing: a request queued behind an open breaker
            # would strand until the queue-wait deadline, defeating the
            # fail-fast point of the breaker. `blocked` is side-effect-free —
            # when the cooldown has elapsed, the flush RPC itself becomes the
            # half-open probe via _unary's allow().
            raise PeerCircuitOpenError(
                self.info.grpc_address, self.breaker.retry_after_s()
            )
        # propagate the active trace to the owner via request metadata
        # (reference peer_client.go:140-142, 364-367)
        tracing.inject(item.metadata)
        if has_behavior(item.behavior, Behavior.NO_BATCHING):
            resp = await self.get_peer_rate_limits(
                peers_pb.GetPeerRateLimitsReq(requests=[item])
            )
            if len(resp.rate_limits) != 1:
                raise PeerError(
                    self.info.grpc_address,
                    RuntimeError("expected 1 rate limit in response"),
                )
            return resp.rate_limits[0]
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._queue.append((item, fut))
        if self.metrics is not None:
            self.metrics.batch_queue_length.set(len(self._queue))
        if self._loop_task is None or self._loop_task.done():
            self._wake = asyncio.Event()
            self._loop_task = loop.create_task(
                self._run(), name=f"peer-batch:{self.info.grpc_address}"
            )
        self._wake.set()
        # queue-wait deadline (BatchTimeout analog, reference config.go:138):
        # a request must never strand in the queue awaiting a flush that does
        # not come. The loop drains a deep queue in sequential chunks, so the
        # budget scales with this item's chunk position — a burst's tail is
        # legitimately behind several RPCs, not timed out.
        chunks_ahead = (len(self._queue) + self.batch_limit - 1) // self.batch_limit
        deadline = self.batch_wait_s + self.timeout_s * max(1, chunks_ahead) + 1.0
        # ... but never past the caller's own remaining gRPC deadline: a
        # deep queue can push the computed budget beyond what the inbound
        # request has left, and waiting out the difference only burns a
        # worker on an answer nobody is listening for
        inbound = deadline_mod.remaining()
        if inbound is not None:
            deadline = min(deadline, max(inbound, 0.001))
        try:
            return await asyncio.wait_for(asyncio.shield(fut), timeout=deadline)
        except asyncio.TimeoutError:
            try:
                self._queue.remove((item, fut))
                if self.metrics is not None:
                    self.metrics.batch_queue_length.set(len(self._queue))
            except ValueError:
                pass  # already picked up by a flush; its result is dropped
            fut.cancel()
            err = PeerError(
                self.info.grpc_address,
                TimeoutError("request timed out awaiting the batch flush"),
            )
            self._record_err(err)
            raise err

    async def _run(self) -> None:
        """The long-lived flush loop (reference runBatch, one goroutine per
        peer, peer_client.go:289-344): wake on enqueue, wait out the batch
        window unless the limit is already met, then send chunks until the
        queue is empty. Items enqueued while a send is in flight are picked
        up by the next iteration — nothing strands, and a running send is
        never cancelled by new arrivals (the one-shot-task design this loop
        replaced could do both)."""
        while not self._closed:
            await self._wake.wait()
            self._wake.clear()
            if not self._queue:
                continue
            if len(self._queue) < self.batch_limit and self.batch_wait_s > 0:
                await asyncio.sleep(self.batch_wait_s)
            await self._drain()

    async def _drain(self) -> None:
        """Send the queue in batch_limit chunks until empty (shared by the
        flush loop and shutdown so metrics/chunking can't diverge)."""
        while self._queue:
            batch = self._queue[: self.batch_limit]
            self._queue = self._queue[self.batch_limit :]
            if self.metrics is not None:
                self.metrics.batch_queue_length.set(len(self._queue))
            await self._send(batch)

    async def _send(self, batch) -> None:
        self._inflight += 1
        try:
            req = peers_pb.GetPeerRateLimitsReq(requests=[i for i, _ in batch])
            try:
                resp = await self.get_peer_rate_limits(req)
                if len(resp.rate_limits) != len(batch):
                    raise PeerError(
                        self.info.grpc_address,
                        RuntimeError("mismatched response count"),
                    )
                for (item, fut), r in zip(batch, resp.rate_limits):
                    if not fut.done():
                        fut.set_result(r)
            except asyncio.CancelledError:
                # loop-task cancellation mid-RPC: fail the batch, then let the
                # cancellation end the task (never swallow it — the loop would
                # otherwise survive cancel() forever)
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(
                            PeerError(
                                self.info.grpc_address,
                                RuntimeError("peer client cancelled"),
                            )
                        )
                raise
            except BaseException as exc:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(
                            exc
                            if isinstance(exc, PeerError)
                            else PeerError(self.info.grpc_address, exc)
                        )
        finally:
            self._inflight -= 1

    # -------------------------------------------------------------- shutdown
    async def shutdown(self) -> None:
        """Drain: stop the flush loop, send anything still queued, wait for
        in-flight sends, close the channel (reference peer_client.go:415-451)."""
        self._closed = True
        try:
            if self._loop_task is not None and not self._loop_task.done():
                self._wake.set()
                await self._loop_task
            # single-drainer invariant: the loop has exited, so no send is in
            # flight here — this drain is the only sender left
            await self._drain()
        finally:
            # a failing peer (PeerError/cancellation out of the final drain)
            # must never leak the channel
            if self._channel is not None:
                await self._channel.close()
                self._channel = None
