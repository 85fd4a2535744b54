"""Trace propagation across the peer mesh — the MetadataCarrier analog.

The reference injects W3C TraceContext into `RateLimitReq.Metadata` on the
forwarding side and extracts it on the owner so one client request is a single
distributed trace across daemons (reference metadata_carrier.go:19-40,
peer_client.go:140-142, gubernator.go:522-524). OTEL itself is not a baked-in
dependency here, so this module implements the W3C `traceparent` header format
directly (https://www.w3.org/TR/trace-context/) over a contextvar, plus an
optional span-event hook embedders can point at their own tracer.
"""

from __future__ import annotations

import contextvars
import secrets
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

TRACEPARENT_KEY = "traceparent"
_FLAG_SAMPLED = 0x01


@dataclass(frozen=True)
class SpanContext:
    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars
    flags: int = _FLAG_SAMPLED

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"


_current: contextvars.ContextVar[Optional[SpanContext]] = contextvars.ContextVar(
    "gubernator_tpu_span", default=None
)

# the most recently ENDED scope's span in this context: transport-layer
# metrics (grpc_request_duration) observe AFTER the handler's scope closed,
# so this is how a request-duration bucket gets the request's trace_id as
# its OpenMetrics exemplar
_last_ended: contextvars.ContextVar[Optional[SpanContext]] = (
    contextvars.ContextVar("gubernator_tpu_last_span", default=None)
)


def last_ended_span() -> Optional[SpanContext]:
    return _last_ended.get()

# embedder hook: called with (name, SpanContext) whenever a scope starts;
# wire this to a real tracer (OTEL etc.) if you have one
span_hook: Optional[Callable[[str, SpanContext], None]] = None

# optional exporter: an object with record(name, span, parent_span_id,
# start_ns, end_ns, *, attributes=None, links=(), kind=...); end_scope and
# record_span feed it finished spans. Wired by the daemon from the standard
# OTEL_* envs (gubernator_tpu_torch.otel.OTLPJsonExporter).
exporter = None


def set_exporter(exp) -> None:
    global exporter
    exporter = exp


@dataclass
class Scope:
    """One open scope (returned by start_scope, consumed by end_scope):
    carries what the exporter needs to emit a finished span."""

    token: object
    name: str
    span: SpanContext
    parent_span_id: str
    start_ns: int
    attributes: Optional[dict] = None


# ---------------------------------------------------------------- span links
# Batching breaks parent-child causality: a request span cannot parent the
# dispatch span that served it (one dispatch serves many requests, and it
# outlives none of them cleanly). OTLP span LINKS restore the edge — the
# batcher registers "request span → dispatch span" links here while the
# request scope is still open, and end_scope attaches them to the finished
# span. Bounded: an abandoned scope (exceptions, exporter off) must not leak.
_links_lock = threading.Lock()
_pending_links: "Dict[str, List[SpanContext]]" = {}
_MAX_LINK_SPANS = 4096  # open spans tracked
_MAX_LINKS_PER_SPAN = 16  # a request split across local/global/forward rows


def add_span_link(span: Optional[SpanContext], target: Optional[SpanContext]) -> None:
    """Register a link from `span` (whose scope is still open — e.g. the
    request scope awaiting its batch slice) to `target` (e.g. the dispatch
    span that served it). Attached when the span's scope ends."""
    if span is None or target is None:
        return
    with _links_lock:
        lst = _pending_links.setdefault(span.span_id, [])
        if len(lst) < _MAX_LINKS_PER_SPAN:
            lst.append(target)
        while len(_pending_links) > _MAX_LINK_SPANS:
            _pending_links.pop(next(iter(_pending_links)))


def take_span_links(span_id: str) -> List[SpanContext]:
    with _links_lock:
        return _pending_links.pop(span_id, [])


def record_span(
    name: str,
    span: SpanContext,
    parent_span_id: str,
    start_ns: int,
    end_ns: int,
    attributes: Optional[dict] = None,
    links=(),
    kind: int = 1,
) -> None:
    """Emit one already-finished span straight to the exporter — the scope
    machinery (contextvar set/reset) is wrong for spans whose lifetime
    crosses threads and requests, like a batcher flush and its pipeline
    stage children. No-op without an exporter or when sampled out."""
    if exporter is not None and span.flags & 0x01:
        exporter.record(
            name, span, parent_span_id, start_ns, end_ns,
            attributes=attributes, links=links, kind=kind,
        )


def current_span() -> Optional[SpanContext]:
    return _current.get()


def new_span(parent: Optional[SpanContext] = None) -> SpanContext:
    """A child of `parent` (same trace), or a fresh root."""
    return SpanContext(
        trace_id=parent.trace_id if parent else secrets.token_hex(16),
        span_id=secrets.token_hex(8),
        flags=parent.flags if parent else _FLAG_SAMPLED,
    )


def start_scope(name: str, parent: Optional[SpanContext] = None):
    """Begin a scope: set the current span (child of parent or of the ambient
    span) and return a Scope to pass to end_scope. The
    tracing.StartNamedScope analog."""
    import time

    eff_parent = parent if parent is not None else _current.get()
    span = new_span(eff_parent)
    if span_hook is not None:
        span_hook(name, span)
    token = _current.set(span)
    return Scope(
        token=token,
        name=name,
        span=span,
        parent_span_id=eff_parent.span_id if eff_parent else "",
        start_ns=time.time_ns(),
    )


def end_scope(scope) -> None:
    if isinstance(scope, Scope):
        _current.reset(scope.token)
        _last_ended.set(scope.span)
        # pop pending links unconditionally — an unsampled or unexported
        # scope must not strand registry entries
        links = take_span_links(scope.span.span_id)
        # honor the W3C sampled flag: traces sampled out upstream
        # (traceparent ...-00) must not produce orphan partial traces here
        if exporter is not None and scope.span.flags & 0x01:
            import time

            exporter.record(
                scope.name, scope.span, scope.parent_span_id,
                scope.start_ns, time.time_ns(),
                attributes=scope.attributes, links=links,
            )
    else:  # raw contextvars token (embedders on the old surface)
        _current.reset(scope)


def parse_traceparent(value: str) -> Optional[SpanContext]:
    """Parse a W3C traceparent header; None on anything malformed (invalid
    inbound context must not break serving)."""
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16)
        f = int(flags, 16)
    except ValueError:
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id, flags=f)


def inject(metadata) -> None:
    """Write the current span into a RateLimitReq.metadata map (the carrier's
    Set side, metadata_carrier.go:33-36). No-op when there is no active span."""
    span = _current.get()
    if span is not None:
        metadata[TRACEPARENT_KEY] = span.to_traceparent()


def extract(metadata: Mapping[str, str]) -> Optional[SpanContext]:
    """Read a span from a RateLimitReq.metadata map (the carrier's Get side,
    metadata_carrier.go:24-31)."""
    raw = metadata.get(TRACEPARENT_KEY, "")
    return parse_traceparent(raw) if raw else None
