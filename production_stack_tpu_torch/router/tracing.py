"""The router's names for the span model of the port's ``tracing``
package (counterpart of ``production_stack_tpu/router/tracing.py``): the
router and the engine share one span model, exporters and trace-context
propagation.
"""

from production_stack_tpu_torch.tracing.context import (  # noqa: F401
    REQUEST_ID_HEADER,
    TRACEPARENT_HEADER,
    SpanContext,
    format_traceparent,
    parse_traceparent,
    valid_request_id,
)
from production_stack_tpu_torch.tracing.spans import (  # noqa: F401
    EXPORTERS,
    RequestTracer,
    Span,
    init_sentry,
    noop_tracer,
)
