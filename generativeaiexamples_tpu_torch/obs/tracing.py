"""Tracing: spans across the chain server, the retriever, the LLM
connector and the engine.

The port's copy of generativeaiexamples_tpu/obs/tracing.py: W3C
`traceparent` propagation over HTTP, spans for generate / retrieve / llm
with token counts, and a `first_token` event carrying the TTFT. Toggled by
`tracing.enabled` in the config or the ENABLE_TRACING environment
variable.

Backends: the OpenTelemetry SDK when it can be imported (an optional
dependency, imported only inside `setup`); otherwise a built-in minimal
tracer with the same span and propagation semantics (spans with
attributes and events, parent/child through W3C traceparent, and any
exporter with `.export([spans])`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import threading
import time
from typing import Dict, Iterator, List, Optional

_LOG = logging.getLogger(__name__)

_TRACER = None
_ENABLED = False
_PROVIDER = None
_BACKEND = None  # "otel" | "mini"
_TLS = threading.local()  # mini-backend attached context

# Export/attribute failure accounting (the trainer idiom: logged once,
# counted always — a sick exporter must show up in /metrics, not
# silently drop span enrichment). Surfaced by EngineMetrics.snapshot()
# as the always-present `trace_export_errors` counter.
_ERR_LOCK = threading.Lock()
_EXPORT_ERRORS = 0
_ERR_LOGGED = False


def note_trace_error(where: str, exc: Optional[BaseException] = None) -> None:
    """Count one span export/attribute failure; log the FIRST one at
    warning (with traceback when given) so the log isn't flooded but
    the failure mode is never invisible."""
    global _EXPORT_ERRORS, _ERR_LOGGED
    with _ERR_LOCK:
        _EXPORT_ERRORS += 1
        first = not _ERR_LOGGED
        _ERR_LOGGED = True
    if first:
        _LOG.warning("span %s failed (counted in trace_export_errors; "
                     "further failures logged at debug)", where,
                     exc_info=exc)
    else:
        _LOG.debug("span %s failed", where, exc_info=exc)


def trace_export_errors() -> int:
    """Total span export/attribute failures this process (monotonic)."""
    with _ERR_LOCK:
        return _EXPORT_ERRORS


def span_trace_id(manual_span) -> str:
    """Hex trace id of a ManualSpan (or "" when tracing is off / the
    span is closed): the key that links a request id to its
    distributed trace."""
    sp = getattr(manual_span, "_span", None)
    if sp is None:
        return ""
    try:
        ctx = getattr(sp, "context", None)
        if ctx is None and hasattr(sp, "get_span_context"):
            ctx = sp.get_span_context()
        tid = getattr(ctx, "trace_id", 0)
        return f"{tid:032x}" if tid else ""
    except Exception:
        return ""


def is_enabled() -> bool:
    """Whether setup() turned tracing on in this process (span sites
    skip their enrichment work when it is off)."""
    return _ENABLED


# ---------------------------------------------------------------------------
# Built-in minimal tracer (used when the otel SDK is unavailable)
# ---------------------------------------------------------------------------


class _MiniContext:
    """Span context: ints like otel's SpanContext."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


class _MiniEvent:
    __slots__ = ("name", "attributes", "timestamp")

    def __init__(self, name: str, attributes: Dict):
        self.name = name
        self.attributes = dict(attributes)
        self.timestamp = time.time()


class _MiniSpan:
    def __init__(self, name: str, context: _MiniContext,
                 parent: Optional[_MiniContext], exporters: List):
        self.name = name
        self.context = context
        self.parent = parent
        self.attributes: Dict = {}
        self.events: List[_MiniEvent] = []
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        self._exporters = exporters

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, attributes: Optional[Dict] = None) -> None:
        self.events.append(_MiniEvent(name, attributes or {}))

    def end(self) -> None:
        if self.end_time is not None:
            return
        self.end_time = time.time()
        for ex in self._exporters:
            try:
                ex.export([self])
            except Exception as e:
                # Counted, logged once — never silently dropped.
                note_trace_error("export", e)

    # context-manager protocol so `with span(...)` keeps working
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class _MiniTracer:
    """start_span-compatible subset of an otel Tracer."""

    def __init__(self):
        self.exporters: List = []

    def start_span(self, name: str, context=None, attributes=None) -> _MiniSpan:
        parent = context if isinstance(context, _MiniContext) else \
            getattr(_TLS, "ctx", None)
        trace_id = parent.trace_id if parent else random.getrandbits(128)
        sp = _MiniSpan(name, _MiniContext(trace_id, random.getrandbits(64)),
                       parent, self.exporters)
        for k, v in (attributes or {}).items():
            sp.set_attribute(k, v)
        return sp

    @contextlib.contextmanager
    def start_as_current_span(self, name: str, context=None):
        sp = self.start_span(name, context=context)
        prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = sp.context
        try:
            yield sp
        finally:
            _TLS.ctx = prev
            sp.end()


class MemoryExporter:
    """In-memory exporter for the built-in backend (API-compatible with
    otel's InMemorySpanExporter where tests need it)."""

    def __init__(self):
        self._spans: List[_MiniSpan] = []
        self._lock = threading.Lock()

    def export(self, spans) -> None:
        with self._lock:
            self._spans.extend(spans)

    def get_finished_spans(self):
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # The rest of OpenTelemetry's SpanExporter interface, so the SDK's
    # span processor can flush and shut it down at exit.
    def force_flush(self, timeout_millis: int = 30000) -> bool:
        return True

    def shutdown(self) -> None:
        pass


class LogExporter:
    """Default mini-backend exporter: one structured log line per span."""

    def export(self, spans) -> None:
        for s in spans:
            _LOG.info(
                "span name=%s trace=%032x dur_ms=%.1f attrs=%s events=%s",
                s.name, s.context.trace_id,
                ((s.end_time or time.time()) - s.start_time) * 1e3,
                s.attributes, [e.name for e in s.events])


def _parse_traceparent(value: str) -> Optional[_MiniContext]:
    try:
        parts = value.strip().split("-")
        if len(parts) != 4:
            return None
        return _MiniContext(int(parts[1], 16), int(parts[2], 16))
    except Exception:
        return None


def setup(config=None, exporter=None) -> bool:
    """Initialize the tracer once per process. Returns enabled state.

    Re-invocation (e.g. a second ChainServer in one test process) reuses
    the existing provider — OTel's global provider can only be set once —
    and an injected `exporter` is attached with a synchronous processor
    (tests use InMemorySpanExporter).
    """
    global _TRACER, _ENABLED, _PROVIDER, _BACKEND
    enabled = (os.environ.get("ENABLE_TRACING", "").lower() in ("1", "true")
               or (config is not None and config.tracing.enabled)
               or exporter is not None)
    if not enabled:
        # Never downgrade: a disabled-config setup() after an explicit
        # enable (e.g. ChainServer init after test/process-level setup)
        # leaves the active tracer in place.
        return _ENABLED
    try:
        from opentelemetry import trace
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import (
            BatchSpanProcessor, ConsoleSpanExporter, SimpleSpanProcessor)

        if _PROVIDER is None:
            service = (config.tracing.service_name if config
                       else "chain-server")
            _PROVIDER = TracerProvider(
                resource=Resource.create({"service.name": service}))
            otlp = None
            endpoint = (config.tracing.otlp_endpoint if config
                        else os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT", ""))
            if endpoint and exporter is None:
                try:
                    from opentelemetry.exporter.otlp.proto.grpc \
                        .trace_exporter import OTLPSpanExporter

                    otlp = OTLPSpanExporter(endpoint=endpoint, insecure=True)
                except Exception:
                    _LOG.warning("OTLP exporter unavailable; using console")
            if exporter is None:
                _PROVIDER.add_span_processor(
                    BatchSpanProcessor(otlp or ConsoleSpanExporter()))
            trace.set_tracer_provider(_PROVIDER)
        if exporter is not None:
            _PROVIDER.add_span_processor(SimpleSpanProcessor(exporter))
        _TRACER = trace.get_tracer("generativeaiexamples_tpu_torch")
        _BACKEND = "otel"
        _ENABLED = True
        return True
    except Exception:
        # otel SDK unavailable: built-in minimal tracer (real spans,
        # W3C propagation, log/in-memory export).
        if _TRACER is None or _BACKEND != "mini":
            _TRACER = _MiniTracer()
            _BACKEND = "mini"
        if exporter is not None:
            _TRACER.exporters.append(exporter)
        elif not _TRACER.exporters:
            _TRACER.exporters.append(LogExporter())
        _ENABLED = True
        _LOG.info("tracing enabled with built-in tracer (otel SDK absent)")
        return True


def extract_context(headers: Dict[str, str]):
    """W3C traceparent from incoming HTTP headers (reference
    tracing.py:62-73)."""
    if not _ENABLED:
        return None
    # Header names are case-insensitive (a client may send Traceparent);
    # the OpenTelemetry propagator looks up the lower-case name.
    hdrs = {k.lower(): v for k, v in dict(headers).items()}
    if _BACKEND == "mini":
        tp = hdrs.get("traceparent", "")
        return _parse_traceparent(tp) if tp else None
    try:
        from opentelemetry.propagate import extract

        return extract(hdrs)
    except Exception:
        return None


def inject_context(headers: Dict[str, str]) -> Dict[str, str]:
    """Inject the current span context into outgoing headers (reference
    frontend/tracing.py:46-50)."""
    if not _ENABLED:
        return headers
    if _BACKEND == "mini":
        ctx = getattr(_TLS, "ctx", None)
        if ctx is not None:
            headers["traceparent"] = (
                f"00-{ctx.trace_id:032x}-{ctx.span_id:016x}-01")
        return headers
    try:
        from opentelemetry.propagate import inject

        inject(headers)
    except Exception:
        pass
    return headers


def current_context():
    """The active trace context in this thread (None when disabled) —
    handed to GenRequest.trace_context so engine spans parent onto the
    request trace across the scheduler-thread boundary."""
    if not _ENABLED:
        return None
    if _BACKEND == "mini":
        return getattr(_TLS, "ctx", None)
    try:
        from opentelemetry import context as otel_context

        return otel_context.get_current()
    except Exception:
        return None


def attach_context(ctx):
    """Attach an extracted context to the current thread; returns a
    detach token (None if disabled/no ctx)."""
    if not _ENABLED or ctx is None:
        return None
    if _BACKEND == "mini":
        prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = ctx
        return ("mini", prev)
    try:
        from opentelemetry import context as otel_context

        return otel_context.attach(ctx)
    except Exception:
        return None


def detach_context(token) -> None:
    if token is None:
        return
    if isinstance(token, tuple) and token and token[0] == "mini":
        _TLS.ctx = token[1]
        return
    try:
        from opentelemetry import context as otel_context

        otel_context.detach(token)
    except Exception:
        pass


@contextlib.contextmanager
def span(name: str, attributes: Optional[Dict] = None,
         context=None) -> Iterator:
    """Span context manager that degrades to a timing log span."""
    if _ENABLED and _TRACER is not None:
        with _TRACER.start_as_current_span(name, context=context) as sp:
            for k, v in (attributes or {}).items():
                sp.set_attribute(k, v)
            yield sp
    else:
        yield _NullSpan()


class _NullSpan:
    def set_attribute(self, *a, **k):
        pass

    def add_event(self, *a, **k):
        pass


def get_system_metrics() -> Dict[str, float]:
    """Host CPU/memory snapshot attached to every span at end — parity
    with the reference's psutil block
    (tools/observability/langchain/opentelemetry_callback.py:65-102).
    psutil when available; a resource-module fallback keeps a stable
    subset of the attribute set otherwise."""
    try:
        import psutil

        proc = psutil.Process()
        with proc.oneshot():
            mem = proc.memory_info()
            return {
                "system.cpu_percent": psutil.cpu_percent(interval=None),
                "system.process_cpu_percent": proc.cpu_percent(interval=None),
                "system.memory_rss_mb": round(mem.rss / 1e6, 1),
                "system.memory_vms_mb": round(mem.vms / 1e6, 1),
                "system.memory_percent": psutil.virtual_memory().percent,
            }
    except Exception:
        try:
            import resource

            ru = resource.getrusage(resource.RUSAGE_SELF)
            return {  # ru_maxrss is KiB on Linux
                "system.memory_rss_mb": round(ru.ru_maxrss / 1e3, 1),
                "system.cpu_user_s": round(ru.ru_utime, 3),
                "system.cpu_sys_s": round(ru.ru_stime, 3),
            }
        except Exception:
            return {}


class ManualSpan:
    """Explicitly started/ended span for code that crosses threads (the
    engine scheduler opens one at prefill and ends it at slot retire —
    start_as_current_span's thread-local context doesn't fit there).
    No-ops when tracing is disabled."""

    def __init__(self, name: str, context=None,
                 attributes: Optional[Dict] = None):
        self._span = None
        if _ENABLED and _TRACER is not None:
            try:
                self._span = _TRACER.start_span(name, context=context,
                                                attributes=attributes or {})
            except Exception:
                self._span = None

    def set_attribute(self, key: str, value) -> None:
        if self._span is not None:
            self._span.set_attribute(key, value)

    def add_event(self, name: str, attributes: Optional[Dict] = None) -> None:
        if self._span is not None:
            self._span.add_event(name, attributes or {})

    def context(self):
        """A trace context with this span as the parent (for
        attach_context on another thread, or a child's `context=`);
        None when tracing is off or the span is closed."""
        if self._span is None:
            return None
        if _BACKEND == "mini":
            return self._span.context
        try:
            from opentelemetry import trace

            return trace.set_span_in_context(self._span)
        except Exception:
            return None

    def end(self) -> None:
        if self._span is not None:
            for k, v in get_system_metrics().items():
                try:
                    self._span.set_attribute(k, v)
                except Exception as e:
                    # One bad attribute must not drop the REST of the
                    # system-metric set (the old `break` silently lost
                    # every attribute after the first failure): count
                    # it, log once, keep going.
                    note_trace_error(f"set_attribute({k})", e)
                    continue
            try:
                self._span.end()
            except Exception as e:
                note_trace_error("end", e)
            self._span = None


class GenerationSpan:
    """Per-request span helper: records TTFT as an event on the first
    token and token counts at the end. Built on ManualSpan (not
    thread-local "current span") so it is safe across asyncio task
    interleaving and executor threads."""

    def __init__(self, name: str = "generate", context=None):
        self.sp = ManualSpan(name, context=context)
        self.t0 = time.perf_counter()
        self.first: Optional[float] = None
        self.tokens = 0

    def __enter__(self):
        return self

    def on_token(self):
        if self.first is None:
            self.first = time.perf_counter() - self.t0
            self.sp.add_event("first_token",
                              {"ttft_ms": round(self.first * 1e3, 2)})
        self.tokens += 1

    def __exit__(self, *exc):
        self.sp.set_attribute("tokens_generated", self.tokens)
        if self.first is not None:
            self.sp.set_attribute("ttft_ms", round(self.first * 1e3, 2))
        self.sp.end()
        return False


def traced_llm_stream(name: str, iterator, attributes: Optional[Dict] = None):
    """Wrap an LLM token iterator in a span with the reference's
    callback-handler semantics (opentelemetry_callback.py:161-674):
    span opens at call, a first_token event records TTFT, and chunk/char
    counts land as attributes at end. Built on ManualSpan, NOT
    start_as_current_span: a generator span held open across yields
    would leak into the consumer's context between tokens (mis-parenting
    any span the caller opens mid-stream, and detaching out of order for
    interleaved/abandoned streams). No-op overhead when disabled."""
    if not _ENABLED:
        yield from iterator
        return
    import time as _time

    sp = ManualSpan(name, context=current_context(),
                    attributes=attributes)
    t0 = _time.perf_counter()
    first = True
    chunks = 0
    chars = 0
    try:
        for piece in iterator:
            if first:
                sp.add_event("first_token", {
                    "ttft_ms": round((_time.perf_counter() - t0) * 1e3, 2)})
                first = False
            chunks += 1
            chars += len(piece)
            yield piece
    finally:
        sp.set_attribute("chunks", chunks)
        sp.set_attribute("chars", chars)
        sp.set_attribute("duration_ms",
                         round((_time.perf_counter() - t0) * 1e3, 2))
        sp.end()
