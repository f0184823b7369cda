"""W3C trace-context propagation (the `traceparent` header).

The router opens a span per proxied request and injects
``traceparent: 00-<trace_id>-<span_id>-<flags>`` (W3C Trace Context
shape) alongside the correlation ``x-request-id`` header; the engine
server extracts it so engine-side spans and request timelines join the
router's trace. Parsing is strict-but-forgiving per the spec: a
malformed header yields ``None`` and the receiver starts a fresh trace
instead of failing the request.

Stdlib-only on purpose — this module is imported on the proxy hot path.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

TRACEPARENT_HEADER = "traceparent"
REQUEST_ID_HEADER = "x-request-id"

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")
_SPAN_ID_RE = re.compile(r"^[0-9a-f]{16}$")
# correlation ids cross process boundaries as HTTP headers and come back
# on responses: bound the charset/length so a hostile client id can't
# smuggle header structure or unbounded bytes through the echo
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._:\-]{1,128}$")


@dataclass(frozen=True)
class SpanContext:
    """The remote end of a trace link, as carried by `traceparent`."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars
    sampled: bool = True


def format_traceparent(
    trace_id: str, span_id: str, sampled: bool = True
) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def parse_traceparent(header: str | None) -> SpanContext | None:
    """Parse a `traceparent` header; None on ANY malformation.

    Spec rules enforced: 4+ dash-separated fields, 2-hex version that is
    not "ff", version 00 has exactly 4 fields, 32-hex non-zero trace id,
    16-hex non-zero parent span id, 2-hex flags. Callers fall back to a
    fresh trace when this returns None — a bad upstream header must
    never fail (or detach) the request itself.
    """
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if not re.fullmatch(r"[0-9a-f]{2}", version) or version == "ff":
        return None
    if version == "00" and len(parts) != 4:
        return None
    if not _TRACE_ID_RE.fullmatch(trace_id) or trace_id == "0" * 32:
        return None
    if not _SPAN_ID_RE.fullmatch(span_id) or span_id == "0" * 16:
        return None
    if not re.fullmatch(r"[0-9a-f]{2}", flags):
        return None
    return SpanContext(
        trace_id=trace_id,
        span_id=span_id,
        sampled=bool(int(flags, 16) & 0x01),
    )


def valid_request_id(value: str | None) -> bool:
    """True when a client/router-supplied x-request-id is safe to adopt
    as the engine-side request id and echo back on responses."""
    return bool(value) and _REQUEST_ID_RE.fullmatch(value) is not None
