"""The event channel and trace propagation on port daemons: the five cases
of tests/test_events_tracing.py through the port's ``tracing`` and
``otel.OTLPJsonExporter``.

- The event channel fires for hits an owner serves (the same event bytes
  as a JAX daemon's under a frozen clock), and for forwarded hits on the
  owner only.
- traceparent round trip and malformed headers.
- A client's trace reaches the owner across a forward.
- The OTLP exporter lands both daemons' spans of one trace in an aiohttp
  collector.
"""

import asyncio

from gubernator_tpu.service.daemon import Daemon as JDaemon
from gubernator_tpu_torch import tracing
from gubernator_tpu_torch.client import V1Client
from gubernator_tpu_torch.service.daemon import Daemon as TDaemon
from gubernator_tpu_torch.types import RateLimitRequest

from tests.cluster import daemon_config
from tests.test_torch_service import async_test
from tests.torch_cluster import Cluster, frozen, port_config, wait_for  # noqa: F401


def req(key, name="ev", hits=1, limit=10, **kw):
    return RateLimitRequest(name=name, unique_key=key, hits=hits, limit=limit,
                            duration=60_000, **kw)


@async_test
async def test_event_channel_fires_for_owner_hits(frozen):
    events = []
    for spawn in (lambda q: JDaemon.spawn(daemon_config(), event_channel=q),
                  lambda q: TDaemon.spawn(port_config(), event_channel=q, device="cpu")):
        q: asyncio.Queue = asyncio.Queue()
        d = await spawn(q)
        client = V1Client(d.conf.grpc_address)
        try:
            await client.get_rate_limits([req("a"), req("b", hits=3)])
            got = [await asyncio.wait_for(q.get(), 5) for _ in range(2)]
        finally:
            await client.close()
            await d.close()
        by_key = {e.request.unique_key: e for e in got}
        assert set(by_key) == {"a", "b"}
        assert by_key["a"].response.remaining == 9
        assert by_key["b"].response.remaining == 7
        assert by_key["b"].request.hits == 3
        events.append({k: (e.request.SerializeToString(), e.response.SerializeToString())
                       for k, e in by_key.items()})
    assert events[1] == events[0]


@async_test
async def test_event_channel_fires_on_owner_for_forwarded_hits():
    qs = [asyncio.Queue() for _ in range(3)]
    c = await Cluster.start(3, event_channels=qs)
    try:
        owner = c.find_owning_daemon("ev", "fwd-key")
        non_owner = c.non_owning_daemons("ev", "fwd-key")[0]
        client = V1Client(non_owner.conf.grpc_address)
        try:
            resp = await client.get_rate_limits([req("fwd-key")])
            assert resp.responses[0].error == ""
        finally:
            await client.close()
        ev = await asyncio.wait_for(qs[c.daemons.index(owner)].get(), 5)
        assert ev.request.unique_key == "fwd-key"
        assert qs[c.daemons.index(non_owner)].empty()
    finally:
        await c.stop()


def test_traceparent_roundtrip_and_malformed():
    span = tracing.new_span()
    meta = {}
    tok = tracing._current.set(span)
    try:
        tracing.inject(meta)
    finally:
        tracing._current.reset(tok)
    assert tracing.extract(meta) == span
    assert tracing.parse_traceparent("nonsense") is None
    assert tracing.parse_traceparent("00-" + "0" * 32 + "-" + "1" * 16 + "-01") is None
    assert tracing.parse_traceparent("00-" + "a" * 32 + "-" + "0" * 16 + "-01") is None
    assert tracing.parse_traceparent("zz-" + "a" * 32 + "-" + "b" * 16 + "-xx") is None
    ok = tracing.parse_traceparent("00-" + "a" * 32 + "-" + "b" * 16 + "-01")
    assert ok is not None and ok.trace_id == "a" * 32


@async_test
async def test_trace_propagates_to_owner_across_forwarding():
    c = await Cluster.start(3)
    seen = []
    old_hook = tracing.span_hook
    tracing.span_hook = lambda name, span: seen.append((name, span))
    try:
        non_owner = c.non_owning_daemons("trace", "tkey")[0]
        client = V1Client(non_owner.conf.grpc_address)
        trace_id = "ab" * 16
        try:
            resp = await client.get_rate_limits([req(
                "tkey", name="trace",
                metadata={"traceparent": f"00-{trace_id}-{'cd' * 8}-01"})])
            assert resp.responses[0].error == ""
        finally:
            await client.close()

        async def peer_scope():
            return [n for n, s in seen if n == "GetPeerRateLimits"]

        await wait_for(peer_scope)
        peer_scopes = [s for n, s in seen if n == "GetPeerRateLimits"]
        assert any(s.trace_id == trace_id for s in peer_scopes), seen
        assert any(s.trace_id == trace_id for n, s in seen if n == "GetRateLimits")
    finally:
        tracing.span_hook = old_hook
        await c.stop()


@async_test
async def test_otlp_exporter_lands_spans_in_collector():
    from aiohttp import web

    from gubernator_tpu_torch.otel import OTLPJsonExporter

    received = []

    async def v1_traces(request):
        received.append(await request.json())
        return web.json_response({})

    app = web.Application()
    app.router.add_post("/v1/traces", v1_traces)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    url = f"http://127.0.0.1:{runner.addresses[0][1]}"

    exporter = OTLPJsonExporter(url, service_name="guber-test")
    old = tracing.exporter
    tracing.set_exporter(exporter)
    c = await Cluster.start(2)
    try:
        non_owner = c.non_owning_daemons("otel", "okey")[0]
        client = V1Client(non_owner.conf.grpc_address)
        trace_id = "12" * 16
        try:
            resp = await client.get_rate_limits([req(
                "okey", name="otel", metadata={"traceparent": f"00-{trace_id}-{'34' * 8}-01"})])
            assert resp.responses[0].error == ""
        finally:
            await client.close()
        # scopes closed in executors may end a beat later; flush off the
        # loop, which serves the collector
        await asyncio.sleep(0.05)
        await asyncio.get_running_loop().run_in_executor(None, exporter.flush)
        spans = [sp for body in received for rs in body["resourceSpans"]
                 for ss in rs["scopeSpans"] for sp in ss["spans"]]
        assert spans, "collector received no spans"
        svc = received[0]["resourceSpans"][0]["resource"]["attributes"][0]
        assert svc["value"]["stringValue"] == "guber-test"
        ours = [sp for sp in spans if sp["traceId"] == trace_id]
        names = {sp["name"] for sp in ours}
        # the non-owner's ingress scope and the owner's peer scope: one trace
        assert "GetRateLimits" in names and "GetPeerRateLimits" in names
        for sp in ours:
            assert int(sp["endTimeUnixNano"]) > int(sp["startTimeUnixNano"])
    finally:
        tracing.set_exporter(old)
        exporter.close()
        await c.stop()
        await runner.cleanup()
