"""Transport: gRPC services + HTTP/JSON gateway + /metrics.

The reference serves gRPC (V1 + PeersV1) and an HTTP gateway that maps
/v1/GetRateLimits, /v1/HealthCheck, /v1/LiveCheck to the same handlers with
proto-names JSON (reference daemon.go:131-196, 264-311). Here: grpc.aio with
hand-built generic handlers over the repo's pb2 messages (no generated service
stubs needed), and an aiohttp app for the gateway + Prometheus /metrics.

With TLS configured (files or AutoTLS, service/tls.py) gRPC serves over
TLS and both HTTP listeners over HTTPS; nothing falls back to plaintext.
"""

from __future__ import annotations

import time

import grpc
from aiohttp import web
from google.protobuf import json_format

from gubernator_tpu_torch import tracing
from gubernator_tpu_torch.service import deadline as deadline_mod
from gubernator_tpu_torch.proto import globalsync_pb2 as globalsync_pb
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.proto import handoff_pb2 as handoff_pb
from gubernator_tpu_torch.proto import peers_pb2 as peers_pb
from gubernator_tpu_torch.proto import regionsync_pb2 as regionsync_pb

V1 = "pb.gubernator.V1"
PEERS_V1 = "pb.gubernator.PeersV1"

# OpenMetrics exposition content type (the format that carries exemplars)
OPENMETRICS_CT = "application/openmetrics-text"


def _timed(metrics, method):
    def wrap(fn):
        async def run(request, context):
            t0 = time.perf_counter()
            status = "ok"
            try:
                return await fn(request, context)
            except Exception:
                status = "error"
                raise
            finally:
                metrics.grpc_request_counts.labels(
                    method=method, status=status
                ).inc()
                # the handler's request scope has already closed; its span
                # is this context's last-ended — the request-duration bucket
                # carries the request's trace_id as its exemplar
                span = tracing.last_ended_span()
                metrics.grpc_request_duration.labels(method=method).observe(
                    time.perf_counter() - t0,
                    exemplar=(
                        {"trace_id": span.trace_id} if span is not None else None
                    ),
                )

        return run

    return wrap


def build_grpc_services(daemon):
    """Generic handlers for the V1 + PeersV1 services."""
    m = daemon.metrics

    @_timed(m, "/v1.GetRateLimits")
    async def get_rate_limits(request: bytes, context):
        # raw wire bytes: the native ingress parses them straight into
        # columns (daemon.get_rate_limits_raw); pb fallback inside
        deadline_mod.set_inbound_deadline(context.time_remaining())
        try:
            return await daemon.get_rate_limits_raw(request)
        except ValueError as exc:  # batch too large etc.
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))

    @_timed(m, "/v1.HealthCheck")
    async def health_check(request: pb.HealthCheckReq, context):
        return await daemon.health_check()

    @_timed(m, "/v1.LiveCheck")
    async def live_check(request: pb.LiveCheckReq, context):
        try:
            return daemon.live_check()
        except RuntimeError as exc:
            await context.abort(grpc.StatusCode.UNAVAILABLE, str(exc))

    @_timed(m, "/v1.LeaseQuota")
    async def lease_quota(request: pb.LeaseQuotaReq, context):
        return await daemon.lease_quota(request)

    @_timed(m, "/peers.GetPeerRateLimits")
    async def get_peer_rate_limits(request: peers_pb.GetPeerRateLimitsReq, context):
        deadline_mod.set_inbound_deadline(context.time_remaining())
        return await daemon.get_peer_rate_limits(request)

    @_timed(m, "/peers.UpdatePeerGlobals")
    async def update_peer_globals(request: peers_pb.UpdatePeerGlobalsReq, context):
        return await daemon.update_peer_globals(request)

    @_timed(m, "/peers.TransferState")
    async def transfer_state(request: handoff_pb.TransferStateReq, context):
        try:
            return await daemon.transfer_state(request)
        except ValueError as exc:  # malformed chunk buffers
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))

    @_timed(m, "/peers.SyncGlobalsWire")
    async def sync_globals_wire(
        request: "globalsync_pb.SyncGlobalsWireReq", context
    ):
        try:
            return await daemon.sync_globals_wire(request)
        except ValueError as exc:  # malformed lane/string buffers
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))

    @_timed(m, "/peers.SyncRegionsWire")
    async def sync_regions_wire(
        request: "regionsync_pb.SyncRegionsWireReq", context
    ):
        try:
            return await daemon.sync_regions_wire(request)
        except ValueError as exc:  # malformed lane/slot/string buffers
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))

    def unary(fn, req_cls, resp_cls):
        return grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=lambda msg: msg.SerializeToString(),
        )

    v1 = grpc.method_handlers_generic_handler(
        V1,
        {
            # GetRateLimits passes wire bytes through untouched — the
            # native ingress owns (de)serialization
            "GetRateLimits": grpc.unary_unary_rpc_method_handler(
                get_rate_limits,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b,
            ),
            "HealthCheck": unary(health_check, pb.HealthCheckReq, pb.HealthCheckResp),
            "LiveCheck": unary(live_check, pb.LiveCheckReq, pb.LiveCheckResp),
            "LeaseQuota": unary(lease_quota, pb.LeaseQuotaReq, pb.LeaseQuotaResp),
        },
    )
    peers = grpc.method_handlers_generic_handler(
        PEERS_V1,
        {
            "GetPeerRateLimits": unary(
                get_peer_rate_limits,
                peers_pb.GetPeerRateLimitsReq,
                peers_pb.GetPeerRateLimitsResp,
            ),
            "UpdatePeerGlobals": unary(
                update_peer_globals,
                peers_pb.UpdatePeerGlobalsReq,
                peers_pb.UpdatePeerGlobalsResp,
            ),
            "TransferState": unary(
                transfer_state,
                handoff_pb.TransferStateReq,
                handoff_pb.TransferStateResp,
            ),
            "SyncGlobalsWire": unary(
                sync_globals_wire,
                globalsync_pb.SyncGlobalsWireReq,
                globalsync_pb.SyncGlobalsWireResp,
            ),
            "SyncRegionsWire": unary(
                sync_regions_wire,
                regionsync_pb.SyncRegionsWireReq,
                regionsync_pb.SyncRegionsWireResp,
            ),
        },
    )
    return [v1, peers]


def build_http_app(daemon, status_only: bool = False) -> web.Application:
    """The grpc-gateway analog: JSON in/out with proto field names
    (UseProtoNames — reference daemon.go:267-273), plus /metrics.
    `status_only` builds the reduced status-listener app: health, liveness
    and /metrics, no rate-limit surface (reference daemon.go:324-352)."""

    def to_json(msg) -> web.Response:
        return web.json_response(
            json_format.MessageToDict(
                msg,
                preserving_proto_field_name=True,
                always_print_fields_with_no_presence=True,
            )
        )

    async def get_rate_limits(request: web.Request) -> web.Response:
        try:
            body = await request.json()
            req = json_format.ParseDict(body, pb.GetRateLimitsReq())
        except Exception as exc:
            return web.json_response(
                {"code": 3, "message": f"invalid request: {exc}"}, status=400
            )
        try:
            resps = await daemon.get_rate_limits(list(req.requests))
        except ValueError as exc:
            return web.json_response({"code": 3, "message": str(exc)}, status=400)
        return to_json(pb.GetRateLimitsResp(responses=resps))

    async def lease_quota(request: web.Request) -> web.Response:
        try:
            body = await request.json()
            req = json_format.ParseDict(body, pb.LeaseQuotaReq())
        except Exception as exc:
            return web.json_response(
                {"code": 3, "message": f"invalid request: {exc}"}, status=400
            )
        return to_json(await daemon.lease_quota(req))

    async def health(request: web.Request) -> web.Response:
        return to_json(await daemon.health_check())

    async def live(request: web.Request) -> web.Response:
        try:
            daemon.live_check()
        except RuntimeError as exc:
            return web.json_response({"code": 14, "message": str(exc)}, status=503)
        return web.json_response({})

    async def metrics(request: web.Request) -> web.Response:
        daemon.metrics.cache_size.set(await daemon.runner.live_count())
        daemon.metrics.global_sync_staleness.set(
            daemon.global_sync_staleness_s()
        )
        daemon.metrics.region_sync_staleness.set(
            daemon.region_manager.oldest_delta_age_s()
        )
        # content negotiation: scrapers that Accept the OpenMetrics format
        # get it (WITH the trace exemplars on latency buckets); everyone
        # else keeps the classic text exposition
        if OPENMETRICS_CT in request.headers.get("Accept", ""):
            return web.Response(
                body=daemon.metrics.render(openmetrics=True),
                headers={
                    "Content-Type": f"{OPENMETRICS_CT}; version=1.0.0; "
                    "charset=utf-8"
                },
            )
        return web.Response(
            body=daemon.metrics.render(),
            content_type="text/plain",
            charset="utf-8",
        )

    async def debug(request: web.Request) -> web.Response:
        """/v1/debug/{table,pipeline,peers,global}: live JSON snapshots of
        the planes the scrape-and-assert metrics model cannot show
        (docs/observability.md)."""
        kind = request.match_info["kind"]
        try:
            if kind == "table":
                return web.json_response(await daemon.debug_table())
            if kind == "pipeline":
                return web.json_response(daemon.debug_pipeline())
            if kind == "peers":
                return web.json_response(daemon.debug_peers())
            if kind == "global":
                return web.json_response(daemon.debug_global())
            if kind == "regions":
                return web.json_response(daemon.debug_regions())
            if kind == "leases":
                return web.json_response(daemon.debug_leases())
            if kind == "durability":
                return web.json_response(daemon.debug_durability())
            if kind == "tier":
                return web.json_response(daemon.debug_tier())
        except Exception as exc:  # pragma: no cover - defensive
            return web.json_response(
                {"code": 13, "message": f"debug snapshot failed: {exc}"},
                status=500,
            )
        return web.json_response(
            {"code": 5, "message": f"unknown debug plane {kind!r}; one of: "
             "table, pipeline, peers, global, regions, durability, leases, "
             "tier"},
            status=404,
        )

    app = web.Application()
    if not status_only:
        app.router.add_post("/v1/GetRateLimits", get_rate_limits)
        app.router.add_post("/v1/LeaseQuota", lease_quota)
    app.router.add_get("/v1/HealthCheck", health)
    app.router.add_post("/v1/HealthCheck", health)
    app.router.add_get("/v1/LiveCheck", live)
    app.router.add_post("/v1/LiveCheck", live)
    app.router.add_get("/metrics", metrics)
    if daemon.conf.debug_endpoints:
        # the debug plane rides the status listener too: it is exactly what
        # an operator probes when the serving listener is the thing broken
        app.router.add_get("/v1/debug/{kind}", debug)
    return app


class GrpcHandle:
    def __init__(self, server: grpc.aio.Server):
        self.server = server

    async def stop(self) -> None:
        await self.server.stop(grace=1.0)


class HttpHandle:
    def __init__(self, runner: web.AppRunner):
        self.runner = runner

    async def stop(self) -> None:
        await self.runner.cleanup()


async def start_servers(daemon) -> None:
    """Bind + start the gRPC server and HTTP gateway; records actual ports on
    the daemon (port 0 supported for tests)."""
    # transport limits mirroring the reference's server options
    # (daemon.go:131-144): 1 MiB receive cap — a wire batch maxes out at
    # GUBER_MAX_BATCH_SIZE small messages, so anything bigger is abuse, not
    # traffic (the cap scales at ~1 KiB/item when the batch limit is raised
    # past the reference's 1000) — plus optional connection-age bounds for
    # LB churn (GUBER_GRPC_MAX_CONN_AGE_SEC, config.go:351).
    recv_cap = max(1024 * 1024, daemon.conf.max_batch_size * 1024)
    options = [("grpc.max_receive_message_length", recv_cap)]
    if daemon.conf.grpc_max_conn_age_s > 0:
        age_ms = int(daemon.conf.grpc_max_conn_age_s * 1000)
        options += [
            ("grpc.max_connection_age_ms", age_ms),
            ("grpc.max_connection_age_grace_ms", age_ms),
        ]
    server = grpc.aio.server(options=options)
    for h in build_grpc_services(daemon):
        server.add_generic_rpc_handlers((h,))
    creds = None
    if daemon.conf.tls_cert_file or daemon.conf.tls_auto:
        from gubernator_tpu_torch.service.tls import (
            client_credentials,
            server_credentials,
        )

        creds = server_credentials(daemon.conf)
        daemon._client_creds = client_credentials(daemon.conf)
    if creds is not None:
        port = server.add_secure_port(daemon.conf.grpc_address, creds)
    else:
        port = server.add_insecure_port(daemon.conf.grpc_address)
    if port == 0:
        raise RuntimeError(f"failed to bind {daemon.conf.grpc_address}")
    daemon.grpc_port = port
    # rewrite :0 addresses with the real port so advertise/peer wiring works
    host = daemon.conf.grpc_address.rsplit(":", 1)[0]
    daemon.conf.grpc_address = f"{host}:{port}"
    if daemon.conf.advertise_address.endswith(":0"):
        daemon.conf.advertise_address = f"{host}:{port}"
    await server.start()
    daemon._servers.append(GrpcHandle(server))

    # with TLS on, the gateway serves HTTPS with the daemon's client-auth
    # mode — otherwise /v1 JSON and /metrics would leave the host in the
    # clear while gRPC is encrypted (reference daemon.go:150-155 terminates
    # the gateway behind the same TLS config)
    gw_ssl = status_ssl = None
    if creds is not None:
        from gubernator_tpu_torch.service.tls import http_ssl_context

        gw_ssl = http_ssl_context(daemon.conf)
        status_ssl = http_ssl_context(daemon.conf, require_client_auth=False)
        # live contexts: the daemon's cert watcher reloads the chain in
        # place on rotation (new handshakes pick it up; gRPC reloads
        # per-handshake, these must not lag behind it)
        daemon._http_ssl_contexts = [gw_ssl, status_ssl]

    async def start_http(address: str, status_only: bool, ssl_ctx):
        app = build_http_app(daemon, status_only=status_only)
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        hhost, _, hport = address.rpartition(":")
        site = web.TCPSite(
            runner, hhost or "127.0.0.1", int(hport), ssl_context=ssl_ctx
        )
        await site.start()
        real = runner.addresses[0][1] if runner.addresses else int(hport)
        daemon._servers.append(HttpHandle(runner))
        return f"{hhost or '127.0.0.1'}:{real}", real

    if daemon.conf.http_address:
        addr, real = await start_http(daemon.conf.http_address, False, gw_ssl)
        daemon.http_port = real
        daemon.conf.http_address = addr
    if daemon.conf.status_http_address:
        # status listener: health + /metrics only, TLS without client certs
        # so k8s probes and Prometheus scrape in mTLS clusters (reference
        # HTTPStatusListenAddress, daemon.go:324-352)
        addr, real = await start_http(
            daemon.conf.status_http_address, True, status_ssl
        )
        daemon.status_http_port = real
        daemon.conf.status_http_address = addr
