"""Client library — dial helper + typed client for the V1 service (the
port of ``gubernator_tpu/client.py``).

The analog of the reference's Go client helpers (reference client.go:44-105)
plus its Python client's role (python/gubernator). Builds raw grpc.aio unary
calls over the port's pb2 messages, so no generated service stubs are
required. Host code only: nothing here touches a tensor.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Union

import grpc

from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.types import RateLimitRequest, RateLimitResponse

GET_RATE_LIMITS = "/pb.gubernator.V1/GetRateLimits"
HEALTH_CHECK = "/pb.gubernator.V1/HealthCheck"
LIVE_CHECK = "/pb.gubernator.V1/LiveCheck"
LEASE_QUOTA = "/pb.gubernator.V1/LeaseQuota"


def response_retry_after_ms(resp: "pb.RateLimitResp") -> int:
    """The denied row's backoff hint as a first-class value.

    The frozen proto schema carries retry_after only as
    metadata["retry_after_ms"]; this is the one place that knows the
    spelling, so callers (the edge library's per-check fallback among them)
    never string-key spelunk. 0 for allowed rows or pre-retry_after peers."""
    raw = resp.metadata.get("retry_after_ms", "")
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            return 0
    return 0


def response_from_pb(resp: "pb.RateLimitResp") -> RateLimitResponse:
    """pb.RateLimitResp → typed RateLimitResponse with `retry_after_ms`
    populated as a first-class field (types.RateLimitResponse)."""
    return RateLimitResponse(
        status=int(resp.status),
        limit=int(resp.limit),
        remaining=int(resp.remaining),
        reset_time=int(resp.reset_time),
        error=resp.error,
        metadata=dict(resp.metadata),
        retry_after_ms=response_retry_after_ms(resp),
    )


def to_pb(r: Union[RateLimitRequest, Dict, "pb.RateLimitReq"]) -> "pb.RateLimitReq":
    if isinstance(r, pb.RateLimitReq):
        return r
    if isinstance(r, dict):
        return pb.RateLimitReq(**r)
    msg = pb.RateLimitReq(
        name=r.name,
        unique_key=r.unique_key,
        hits=r.hits,
        limit=r.limit,
        duration=r.duration,
        algorithm=int(r.algorithm),
        behavior=int(r.behavior),
        burst=r.burst,
    )
    if r.created_at:
        msg.created_at = r.created_at
    if r.metadata:
        for k, v in r.metadata.items():
            msg.metadata[k] = v
    if getattr(r, "cascade", None):
        for lvl in r.cascade:
            msg.cascade.add(
                name=lvl.name,
                unique_key=lvl.unique_key,
                limit=lvl.limit,
                duration=lvl.duration,
                algorithm=int(lvl.algorithm),
                burst=lvl.burst,
            )
    return msg


class V1Client:
    """Async client for one daemon (DialV1Server analog, client.go:44-66).

    `channels` > 1 opens that many HTTP/2 connections and round-robins
    GetRateLimits across them — one gRPC channel serializes every response
    onto a single TCP stream, which caps a hot client well below what the
    server can produce (HTTP/2 flow control + head-of-line blocking on the
    shared connection). The per-method callables are built once per channel,
    not per call."""

    def __init__(
        self,
        address: str,
        credentials: Optional[grpc.ChannelCredentials] = None,
        timeout_s: float = 5.0,
        channels: int = 1,
    ):
        if channels < 1:
            raise ValueError("channels must be >= 1")
        self.address = address
        self.timeout_s = timeout_s

        def dial(i: int):
            # distinct channel args defeat grpc's global subchannel sharing
            # — with identical args every "channel" can ride one TCP
            # connection and the fan-out buys nothing
            opts = [("gubernator.client_channel", i)]
            if credentials is not None:
                return grpc.aio.secure_channel(address, credentials, options=opts)
            return grpc.aio.insecure_channel(address, options=opts)

        self._channels = [dial(i) for i in range(channels)]
        self._calls = [
            ch.unary_unary(
                GET_RATE_LIMITS,
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb.GetRateLimitsResp.FromString,
            )
            for ch in self._channels
        ]
        self._rr = 0

    @property
    def _channel(self):
        """First channel (back-compat for callers poking the raw channel)."""
        return self._channels[0]

    def _next_call(self):
        self._rr = (self._rr + 1) % len(self._calls)
        return self._calls[self._rr]

    async def get_rate_limits(
        self,
        requests: Sequence[Union[RateLimitRequest, Dict, "pb.RateLimitReq"]],
        timeout_s: Optional[float] = None,
    ) -> "pb.GetRateLimitsResp":
        req = pb.GetRateLimitsReq(requests=[to_pb(r) for r in requests])
        return await self._next_call()(req, timeout=timeout_s or self.timeout_s)

    async def check(
        self,
        requests: Sequence[Union[RateLimitRequest, Dict, "pb.RateLimitReq"]],
        timeout_s: Optional[float] = None,
    ) -> List[RateLimitResponse]:
        """get_rate_limits returning typed responses with retry_after_ms as
        a first-class field — callers back off without metadata spelunking."""
        resp = await self.get_rate_limits(requests, timeout_s=timeout_s)
        return [response_from_pb(r) for r in resp.responses]

    async def lease_quota(
        self, req: "pb.LeaseQuotaReq", timeout_s: Optional[float] = None
    ) -> "pb.LeaseQuotaResp":
        """One edge quota-lease operation (acquire / renew / return); the
        edge.LocalLimiter drives this."""
        call = self._channel.unary_unary(
            LEASE_QUOTA,
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.LeaseQuotaResp.FromString,
        )
        return await call(req, timeout=timeout_s or self.timeout_s)

    async def health_check(self, timeout_s: Optional[float] = None) -> "pb.HealthCheckResp":
        call = self._channel.unary_unary(
            HEALTH_CHECK,
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.HealthCheckResp.FromString,
        )
        return await call(pb.HealthCheckReq(), timeout=timeout_s or self.timeout_s)

    async def live_check(self, timeout_s: Optional[float] = None) -> "pb.LiveCheckResp":
        call = self._channel.unary_unary(
            LIVE_CHECK,
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.LiveCheckResp.FromString,
        )
        return await call(pb.LiveCheckReq(), timeout=timeout_s or self.timeout_s)

    async def close(self) -> None:
        for ch in self._channels:
            await ch.close()


def random_peer(peers: List[str], rng: Optional[random.Random] = None) -> str:
    """reference client.go RandomPeer: a uniform choice, drawn from `rng`
    (a caller's seeded generator) or from a fresh one."""
    return (rng or random.Random()).choice(peers)
