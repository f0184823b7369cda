"""Per-request lifecycle timeline for the engine.

Answers "where did THIS request's latency go": timestamped events for
enqueue, scheduler admit (queue-wait), each prefill chunk (with
staged-hit / chained flags riding the tpu:prefill_* instrumentation
points), first token, sampled decode-round boundaries, preemption /
resume, and finish. Recording is an append of a small tuple to a
per-request list — no locks, no device syncs — so it stays off the
device-dispatch critical path; when disabled every entry point returns
after ONE boolean check. PERF.md gives the host time a step with it on
against off, from the engine's step meter (tracing/steps.py).

Event times are ``time.monotonic()`` stamps anchored to the request's
arrival epoch at export (wall-clock steps cannot reorder a timeline).
Finished timelines land in a bounded ring buffer served by the engine's
``/debug/requests`` endpoint; when a tracer with a live exporter is
attached, each finished timeline is also exported as an
``engine_request`` span whose parent is the router's proxied span
(via the propagated ``traceparent``).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from production_stack_tpu_torch.tracing.context import parse_traceparent
from production_stack_tpu_torch.tracing.spans import RequestTracer, Span

# decode-round boundaries are SAMPLED: one event per this many fused
# rounds per request (plus the final round via finish), so a 10k-token
# stream records dozens of events, not thousands
DECODE_EVENT_EVERY = 8


class RequestTimeline:
    """Append-only event list for one request's lifetime."""

    __slots__ = (
        "request_id", "trace_id", "parent_span_id", "sampled",
        "arrival_time", "_arrival_mono", "events", "decode_rounds",
        "finished", "finish_reason",
    )

    def __init__(
        self,
        request_id: str,
        trace_id: str,
        parent_span_id: str | None,
        arrival_time: float,
        sampled: bool = True,
    ):
        self.request_id = request_id
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.sampled = sampled
        self.arrival_time = arrival_time
        self._arrival_mono = time.monotonic()
        self.events: list[tuple[str, float, dict | None]] = []
        self.decode_rounds = 0
        self.finished = False
        self.finish_reason: str | None = None

    def append(self, name: str, attrs: dict | None = None) -> None:
        self.events.append((name, time.monotonic(), attrs))

    def to_dict(self) -> dict:
        """Export shape: epoch-anchored event times plus per-event
        offsets from arrival (what you read when triaging a TTFT)."""
        base_epoch = self.arrival_time
        base_mono = self._arrival_mono
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "parent_span_id": self.parent_span_id,
            "arrival_time": base_epoch,
            "finished": self.finished,
            "finish_reason": self.finish_reason,
            "decode_rounds": self.decode_rounds,
            "events": [
                {
                    "name": n,
                    "t_rel_s": round(t - base_mono, 6),
                    "time": base_epoch + (t - base_mono),
                    **({"attributes": a} if a else {}),
                }
                for n, t, a in list(self.events)
            ],
        }


class TimelineRecorder:
    """Bounded per-request timeline store.

    ``enabled=False`` turns every method into a single-boolean-check
    no-op (callers on per-step paths additionally guard with the
    ``enabled`` attribute so not even the call happens). All engine
    entry points run under the AsyncLLMEngine step lock, so event
    appends need no lock of their own; the ring/active maps are guarded
    for the HTTP thread's snapshot reads.
    """

    def __init__(
        self,
        enabled: bool = True,
        maxlen: int = 256,
        tracer: RequestTracer | None = None,
    ):
        self.enabled = enabled
        self.tracer = tracer
        self._active: dict[str, RequestTimeline] = {}
        self._done: deque[dict] = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(
        self,
        request_id: str,
        arrival_time: float | None = None,
        traceparent: str | None = None,
        **attrs,
    ) -> None:
        if not self.enabled:
            return
        ctx = parse_traceparent(traceparent)
        if ctx is not None:
            trace_id, parent, sampled = (
                ctx.trace_id, ctx.span_id, ctx.sampled
            )
        else:
            # malformed/absent header: fresh trace, no parent link
            trace_id, parent, sampled = (
                self.tracer.new_trace_id() if self.tracer is not None
                else f"{time.monotonic_ns() & ((1 << 128) - 1):032x}",
                None,
                True,
            )
        tl = RequestTimeline(
            request_id, trace_id, parent,
            arrival_time if arrival_time is not None else time.time(),
            sampled=sampled,
        )
        tl.append("enqueue", attrs or None)
        with self._lock:
            self._active[request_id] = tl
            if len(self._active) > 4096:  # leak guard: a caller that
                # never finishes its requests must not grow unbounded
                self._active.pop(next(iter(self._active)))

    def event(self, request_id: str, name: str,
              attrs: dict | None = None) -> None:
        if not self.enabled:
            return
        tl = self._active.get(request_id)
        if tl is not None:
            tl.append(name, attrs)

    def decode_round(self, request_id: str, k: int = 1,
                     attrs: dict | None = None) -> None:
        """One fused decode round applied for this request; records an
        event every DECODE_EVENT_EVERY rounds. `attrs` (e.g. the
        elastic-decode k_chosen/lanes_done fields) merge into the same
        append-only event."""
        if not self.enabled:
            return
        tl = self._active.get(request_id)
        if tl is None:
            return
        tl.decode_rounds += 1
        if tl.decode_rounds % DECODE_EVENT_EVERY == 0:
            tl.append(
                "decode_round",
                {"round": tl.decode_rounds, "k": k, **(attrs or {})},
            )

    def finish(self, request_id: str, reason: str | None,
               attrs: dict | None = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            tl = self._active.pop(request_id, None)
        if tl is None:
            return  # unknown/already finished: idempotent
        tl.finished = True
        tl.finish_reason = reason
        tl.append("finish", {"reason": reason, **(attrs or {})}
                  if (reason is not None or attrs) else None)
        self._done.append(tl.to_dict())
        self._export_span(tl)

    # -- export ------------------------------------------------------------
    def _export_span(self, tl: RequestTimeline) -> None:
        """Render a finished timeline as an `engine_request` span, child
        of the router's proxied span when a traceparent was supplied.
        Sampled-out traces (flag 00) keep their LOCAL timeline for
        /debug/requests but export no span — the origin's sampling
        decision is honored."""
        tracer = self.tracer
        if tracer is None or not tracer.enabled or not tl.sampled:
            return
        span = Span(
            name="engine_request",
            trace_id=tl.trace_id,
            span_id=tracer.new_span_id(),
            parent_span_id=tl.parent_span_id,
            start_time=tl.arrival_time,
            attributes={
                "request_id": tl.request_id,
                "decode_rounds": tl.decode_rounds,
                "finish_reason": tl.finish_reason,
            },
        )
        base_epoch, base_mono = tl.arrival_time, tl._arrival_mono
        last = base_mono
        for n, t, a in tl.events:
            span.events.append((n, base_epoch + (t - base_mono), a or {}))
            last = t
        span.end_time = base_epoch + (last - base_mono)
        span.status = (
            "ERROR" if tl.finish_reason == "error" else "OK"
        )
        tracer.finish(span)

    # -- introspection (/debug/requests) -----------------------------------
    def snapshot(self, limit: int = 64) -> list[dict]:
        """Recent finished timelines (newest last) + in-flight ones."""
        with self._lock:
            done = list(self._done)
            active = list(self._active.values())
        # limit=0 caps to zero finished timelines (a -0 slice would
        # return the whole ring)
        out = done[-limit:] if limit > 0 else []
        out.extend(tl.to_dict() for tl in active)
        return out


# shared disabled recorder: the zero-cost default for engines created
# with request_timeline=False
NULL_RECORDER = TimelineRecorder(enabled=False, maxlen=1)


def debug_requests_payload(
    limit_raw,
    enabled: bool,
    snapshot,
    hint: str,
    default_limit: int = 64,
) -> dict:
    """The ONE /debug/requests response body both servers serve (router:
    recent proxy spans; engine: request timelines). `limit_raw` is the
    raw ?limit= query value (bad values fall back, never 500);
    `snapshot` is called with the resolved limit only when enabled."""
    try:
        limit = (
            int(limit_raw) if limit_raw is not None else default_limit
        )
    except (TypeError, ValueError):
        limit = default_limit
    if not enabled:
        return {"enabled": False, "hint": hint, "requests": []}
    return {"enabled": True, "requests": snapshot(limit)}
