"""Distributed request tracing for the PyTorch engine: a copy of the JAX
package's ``production_stack_tpu/tracing`` with its imports repointed
(stdlib only, plus ``utils.log``), and the port's own step meter.

- ``context``: W3C `traceparent` encode/parse + `x-request-id` hygiene.
- ``spans``: the span model, pluggable exporters (log / memory /
  OTLP-shape / none), Sentry init.
- ``timeline``: the engine's per-request lifecycle timeline (enqueue →
  admit → prefill chunks → first token → sampled decode rounds →
  preempt/resume → finish) feeding `/debug/requests` and the
  `engine_request` span.
- ``steps`` (imported by the engine, not here: it alone needs torch):
  the step meter, host ranges of the step loop entered only while a
  profiler runs, and counters of steps, fetches and served work that
  the engine's stats publish.

See ``production_stack_tpu/tracing/README.md`` for the end-to-end flow
and how to read a timeline when triaging a TTFT regression.
"""

from production_stack_tpu_torch.tracing.context import (
    REQUEST_ID_HEADER,
    TRACEPARENT_HEADER,
    SpanContext,
    format_traceparent,
    parse_traceparent,
    valid_request_id,
)
from production_stack_tpu_torch.tracing.spans import (
    EXPORTERS,
    OTLP_FLUSH_INTERVAL_S,
    RequestTracer,
    Span,
    init_sentry,
    log_otlp_payload,
    noop_tracer,
    otlp_flush_loop,
    otlp_payload,
    span_to_otlp,
)
from production_stack_tpu_torch.tracing.timeline import (
    DECODE_EVENT_EVERY,
    NULL_RECORDER,
    RequestTimeline,
    TimelineRecorder,
    debug_requests_payload,
)

__all__ = [
    "DECODE_EVENT_EVERY",
    "EXPORTERS",
    "NULL_RECORDER",
    "OTLP_FLUSH_INTERVAL_S",
    "REQUEST_ID_HEADER",
    "RequestTimeline",
    "RequestTracer",
    "Span",
    "SpanContext",
    "TRACEPARENT_HEADER",
    "TimelineRecorder",
    "debug_requests_payload",
    "format_traceparent",
    "init_sentry",
    "log_otlp_payload",
    "noop_tracer",
    "otlp_flush_loop",
    "otlp_payload",
    "parse_traceparent",
    "span_to_otlp",
    "valid_request_id",
]
