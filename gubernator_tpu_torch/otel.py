"""OTLP/HTTP JSON trace export — spans actually land in a collector.

The reference instruments everything with the OpenTelemetry SDK and exports
wherever the standard OTEL_* envs point (reference daemon.go:136,
cmd/gubernator/main.go:90-97, docs/tracing.md:43-54). This build's tracing
core (gubernator_tpu_torch.tracing) is SDK-free, so the exporter speaks the OTLP
1.x HTTP+JSON encoding directly (https://opentelemetry.io/docs/specs/otlp/)
— any OTLP-capable collector (otel-collector, Jaeger, Tempo, ...) accepts
it with zero extra dependencies. Enabled by OTEL_EXPORTER_OTLP_ENDPOINT /
OTEL_EXPORTER_OTLP_TRACES_ENDPOINT; service name from OTEL_SERVICE_NAME.

Spans batch on a daemon thread (never the serving path): `record` appends
to a bounded buffer, the worker flushes every couple of seconds or at the
batch cap, and export failures are counted and dropped — tracing must never
take the service down with it.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from collections import deque
from typing import List, Optional

log = logging.getLogger("gubernator_tpu_torch.otel")

MAX_BUFFER = 8192  # spans held before the oldest drop (backpressure-free)


def _attr_value(v) -> dict:
    """Python value → OTLP JSON AnyValue (ints are strings per the OTLP 1.x
    JSON mapping of int64)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def parse_resource_attributes(raw: str) -> dict:
    """OTEL_RESOURCE_ATTRIBUTES parser: comma-separated key=value pairs with
    percent-encoded values (the W3C Baggage subset the OTEL spec mandates).
    Malformed pairs are skipped — resource decoration must never stop the
    exporter from coming up."""
    from urllib.parse import unquote

    out: dict = {}
    for pair in raw.split(","):
        if "=" not in pair:
            continue
        k, _, v = pair.partition("=")
        k = k.strip()
        if k:
            out[k] = unquote(v.strip())
    return out


class OTLPJsonExporter:
    def __init__(
        self,
        endpoint: str,
        service_name: str = "gubernator-tpu",
        flush_interval_s: float = 2.0,
        max_batch: int = 512,
        append_path: bool = True,
        resource_attributes: Optional[dict] = None,
    ):
        # OTLP spec: the generic endpoint gets the per-signal path appended;
        # a signal-specific endpoint is used VERBATIM (append_path=False)
        ep = endpoint.rstrip("/")
        if append_path and not ep.endswith("/v1/traces"):
            ep = ep + "/v1/traces"
        self.endpoint = ep
        self.service_name = service_name
        # extra resource attributes (OTEL_RESOURCE_ATTRIBUTES): what lets a
        # shared collector tell multi-daemon cluster nodes apart
        self.resource_attributes = dict(resource_attributes or {})
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        self.exported = 0
        self.dropped = 0
        self.export_errors = 0
        # drop-oldest in O(1): record() runs on the serving thread and must
        # not memmove thousands of entries when the collector is down
        self._buf: "deque[dict]" = deque(maxlen=MAX_BUFFER)
        self._lock = threading.Lock()
        self._kick = threading.Event()
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, name="otel-export", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------- recording
    def record(
        self,
        name: str,
        span,
        parent_span_id: str,
        start_ns: int,
        end_ns: int,
        attributes: Optional[dict] = None,
        links=(),
        kind: int = 2,
    ) -> None:
        """tracing.end_scope / tracing.record_span feed finished spans here
        (serving thread — must stay O(1) and never block). `kind` defaults
        to SPAN_KIND_SERVER (request scopes wrap RPC handling); stage spans
        pass SPAN_KIND_INTERNAL (1). `links` carries SpanContexts of related
        spans in OTHER traces — the batch-aware causality edge."""
        entry = {
            "traceId": span.trace_id,
            "spanId": span.span_id,
            "name": name,
            "kind": kind,
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(end_ns),
        }
        if parent_span_id:
            entry["parentSpanId"] = parent_span_id
        if attributes:
            entry["attributes"] = [
                {"key": k, "value": _attr_value(v)}
                for k, v in attributes.items()
            ]
        if links:
            entry["links"] = [
                {"traceId": l.trace_id, "spanId": l.span_id} for l in links
            ]
        with self._lock:
            if len(self._buf) == MAX_BUFFER:
                self.dropped += 1  # deque(maxlen) evicts the oldest
            self._buf.append(entry)
            if len(self._buf) >= self.max_batch:
                self._kick.set()

    # -------------------------------------------------------------- flushing
    def _drain(self) -> List[dict]:
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out

    def _payload(self, spans: List[dict]) -> bytes:
        resource_attrs = [
            {
                "key": "service.name",
                "value": {"stringValue": self.service_name},
            }
        ] + [
            {"key": k, "value": _attr_value(v)}
            for k, v in self.resource_attributes.items()
            if k != "service.name"
        ]
        return json.dumps(
            {
                "resourceSpans": [
                    {
                        "resource": {"attributes": resource_attrs},
                        "scopeSpans": [
                            {
                                "scope": {"name": "gubernator_tpu_torch"},
                                "spans": spans,
                            }
                        ],
                    }
                ]
            }
        ).encode()

    def _post(self, spans: List[dict]) -> None:
        if not spans:
            return
        req = urllib.request.Request(
            self.endpoint,
            data=self._payload(spans),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5.0):
                pass
            self.exported += len(spans)
        except Exception:
            # counted + dropped, never retried and never raised into the
            # serving path (the reference's exporter failures log and move on)
            self.export_errors += 1
            log.debug("OTLP export to %s failed", self.endpoint, exc_info=True)

    def _post_batched(self, spans: List[dict]) -> None:
        # max_batch caps the spans per POST too, not just the kick
        # threshold — a collector's request-size limit must not reject a
        # whole backlog at once
        for i in range(0, len(spans), self.max_batch):
            self._post(spans[i : i + self.max_batch])

    def _run(self) -> None:
        while not self._closed:
            self._kick.wait(timeout=self.flush_interval_s)
            self._kick.clear()
            self._post_batched(self._drain())

    def flush(self) -> None:
        """Synchronous flush of everything recorded so far (tests, shutdown)."""
        self._post_batched(self._drain())

    def close(self) -> None:
        self._closed = True
        self._kick.set()
        self._worker.join(timeout=5.0)
        self.flush()


def exporter_from_env(env=None):
    """Build an exporter when the standard OTEL_* envs ask for one, else
    None (reference semantics: exporters configured by OTEL_* envs,
    docs/tracing.md:43-54)."""
    import os

    env = os.environ if env is None else env
    traces_ep = env.get("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT", "")
    generic_ep = env.get("OTEL_EXPORTER_OTLP_ENDPOINT", "")
    if not traces_ep and not generic_ep:
        return None
    # resource attributes: OTEL_RESOURCE_ATTRIBUTES decorates every span so
    # multi-daemon clusters sharing one collector stay distinguishable;
    # OTEL_SERVICE_NAME takes precedence over a service.name entry (the
    # OTEL SDK precedence rule)
    attrs = parse_resource_attributes(env.get("OTEL_RESOURCE_ATTRIBUTES", ""))
    service = (
        env.get("OTEL_SERVICE_NAME", "")
        or attrs.pop("service.name", "")
        or "gubernator-tpu"
    )
    attrs.pop("service.name", None)
    return OTLPJsonExporter(
        traces_ep or generic_ep,
        service_name=service,
        # per OTLP spec the signal-specific endpoint is used verbatim; only
        # the generic endpoint gets /v1/traces appended
        append_path=not traces_ep,
        resource_attributes=attrs,
    )
