"""Core proxy: pick a backend, stream the response, feed the stats monitor.

Parity: reference src/vllm_router/services/request_service/request.py —
route_general_request:141 (alias resolution, model filter, sleep filter,
routing, streaming), process_request:55 (per-chunk hot loop + stats), and the
disaggregated-prefill two-phase flow route_disaggregated_prefill_request:349
(prefill with max_tokens=1, then stream from the decoder while it pulls KV).

The port's copy runs on the standard library: the stdlib client of
utils/http.py upstream (one connection a request; the body relayed as it
arrives, so first-token latency is preserved) and utils/web.py's
StreamResponse (chunked) to the client.

Observability: every proxied request runs under a ``PhaseClock`` whose
tiled marks decompose the router's time into
receive -> route_decision -> upstream_connect -> upstream_ttft ->
stream_relay -> finalize. Each finished attempt feeds the
``tpu_router:*`` phase histograms + the per-engine health scoreboard
(stats/health.py), and — when tracing is on — each phase is exported as
a child span of the request's ``proxy_request`` span, so the router's
decomposition joins the engine-side timeline under one trace id.
A connect-stage failure (nothing sent to either side's socket yet) is
retried against the remaining routing candidates before giving up.
"""

from __future__ import annotations

import asyncio
import json
import math
import re
import time
import uuid

from production_stack_tpu_torch.router.admission import (
    ShedDecision,
    get_admission_controller,
)
from production_stack_tpu_torch.router.protocols import EndpointInfo, RouterRequest
from production_stack_tpu_torch.router.routing_logic import (
    DisaggregatedPrefillRouter,
    PDRouter,
    get_routing_logic,
)
from production_stack_tpu_torch.router.service_discovery import (
    get_service_discovery,
)
from production_stack_tpu_torch.router.services.metrics_service import (
    upstream_retries,
)
from production_stack_tpu_torch.router.stats.engine_stats import (
    get_engine_stats_scraper,
)
from production_stack_tpu_torch.router.stats.health import (
    PhaseClock,
    get_engine_health_board,
    record_proxy_observation,
    record_shed_observation,
)
from production_stack_tpu_torch.router.stats.request_stats import (
    get_request_stats_monitor,
)
from production_stack_tpu_torch.router.stats.slo import get_slo_tracker
from production_stack_tpu_torch.tracing import (
    REQUEST_ID_HEADER,
    TRACEPARENT_HEADER,
    Span,
    parse_traceparent,
)
from production_stack_tpu_torch.utils import http, init_logger, web

logger = init_logger(__name__)

# connect-stage failures re-route to at most this many other candidates
MAX_CONNECT_RETRIES = 2

_HOP_HEADERS = {
    "host", "content-length", "connection", "keep-alive", "te", "trailers",
    "transfer-encoding", "upgrade", "proxy-authenticate",
    "proxy-authorization",
}


class _ClientDisconnected(Exception):
    """A CLIENT-socket write failed mid-proxy. Kept distinct from the
    upstream exception types so the health scoreboard can tell an
    impatient client apart from a failing engine (engine_fault=False)."""

    def __init__(self, orig: BaseException) -> None:
        super().__init__(str(orig))
        self.orig = orig


async def _to_client(coro) -> None:
    """Await a client-socket write, translating its failure. TimeoutError
    and ConnectionResetError both subclass OSError, so this covers every
    transport-level way the client can go away."""
    try:
        await coro
    except OSError as e:
        raise _ClientDisconnected(e) from e


def _mark_open_phase(
    clock: PhaseClock, prepared: bool, first_chunk_seen: bool
) -> str:
    """Close the open slice on the phase that was in progress when a
    proxy attempt died; returns the error-kind label for it."""
    if not prepared:
        clock.mark("upstream_connect")
        return "connect"
    if not first_chunk_seen:
        clock.mark("upstream_ttft")
        return "ttft"
    clock.mark("stream_relay")
    return "stream"


def _shed_error_body(shed: ShedDecision) -> dict:
    """The ONE 429 body for an admission shed (general, PD, and batch
    paths must classify identically): tenant-budget sheds (including
    the tenant's own SLO error budget) are ``rate_limit_exceeded``,
    cluster-state sheds are ``overloaded``."""
    kind = (
        "rate_limit_exceeded"
        if shed.reason in ("tenant_limit", "tenant_concurrency",
                           "slo_burn")
        else "overloaded"
    )
    return {"error": {
        "message": shed.message,
        "type": kind,
        "code": shed.reason,
        "retry_after_s": round(shed.retry_after_s, 3),
    }}


def _forward_headers(request: web.Request) -> dict[str, str]:
    return {
        k: v
        for k, v in request.headers.items()
        if k.lower() not in _HOP_HEADERS
    }


def _set_header(headers: dict[str, str], name: str, value: str) -> None:
    """Replace a header CASE-INSENSITIVELY in a plain forwarded-header
    dict. A bare `headers[name] = value` would leave a client-sent
    'Traceparent'/'X-Request-Id' casing as a SECOND entry — the client
    sends both and the engine reads the first (the client's), silently
    replacing the router's injected context."""
    for k in [k for k in headers if k.lower() == name.lower()]:
        del headers[k]
    headers[name] = value


class RequestService:
    """Owns the upstream HTTP session + the request hot path."""

    def __init__(
        self,
        session_key: str | None = None,
        callbacks=None,
        rewriter=None,
        semantic_cache=None,
        request_timeout_s: float = 600.0,
        tracer=None,
    ):
        from production_stack_tpu_torch.router.tracing import noop_tracer

        self.session_key = session_key
        self.callbacks = callbacks
        self.rewriter = rewriter
        self.semantic_cache = semantic_cache
        self.tracer = tracer or noop_tracer()
        self.timeout = http.ClientTimeout(
            total=request_timeout_s, sock_connect=10
        )
        self._session: http.ClientSession | None = None
        self.in_flight = 0

    async def start(self) -> None:
        # no pool to bound: one upstream connection a request
        self._session = http.ClientSession(timeout=self.timeout)

    async def close(self) -> None:
        if self._session:
            await self._session.close()

    @property
    def session(self) -> http.ClientSession:
        assert self._session is not None, "RequestService not started"
        return self._session

    # -- endpoint filtering (reference: request.py:211-237) ----------------
    @staticmethod
    def _filter_endpoints(
        endpoints: list[EndpointInfo], model: str | None
    ) -> tuple[list[EndpointInfo], str | None, int]:
        """Filter by requested model (resolving aliases), drop sleeping pods.

        Returns (endpoints, resolved_model, asleep_count) where
        ``asleep_count`` is how many pool members WOULD serve the
        model but are asleep/draining — an empty candidate list with a
        nonzero asleep count is the ``fleet_asleep`` shed (429 +
        Retry-After until wake), not a 503/502."""
        awake = [e for e in endpoints if not e.sleep]
        asleep = [e for e in endpoints if e.sleep]
        if not model:
            return awake, model, len(asleep)
        resolved = model
        serving = []
        for e in awake:
            if model in e.model_names:
                serving.append(e)
            elif model in e.aliases:
                resolved = e.aliases[model]
                serving.append(e)
        asleep_serving = sum(
            1 for e in asleep
            if model in e.model_names or model in e.aliases
        )
        return serving, resolved, asleep_serving

    @staticmethod
    def _context_window_filter(
        candidates: list[EndpointInfo], body: dict
    ) -> tuple[list[EndpointInfo], web.Response | None]:
        """Skip backends whose advertised context window
        (EndpointInfo.max_model_len, from the /v1/models card) is
        smaller than the prompt's token count — an oversized prompt
        must not burn a routing pick only to 400 at the engine. When NO
        backend qualifies, returns a 413 naming the cluster's max
        admitted context instead of letting the request fail opaquely
        downstream. Backends without a card window (None) are never
        filtered; the estimate is a deliberate lower bound
        (estimate_prompt_tokens), so borderline prompts pass through
        to the engine's own gate."""
        est = _estimate_prompt_tokens(body)
        if est <= 1 or not candidates:
            return candidates, None
        fits = [
            e for e in candidates
            if e.max_model_len is None or e.max_model_len >= est
        ]
        if fits:
            return fits, None
        cluster_max = max(e.max_model_len or 0 for e in candidates)
        return [], web.json_response(
            {
                "error": {
                    "message": (
                        f"prompt (~{est} tokens) exceeds every "
                        "backend's context window; the cluster's max "
                        f"admitted context is {cluster_max} tokens"
                    ),
                    "type": "invalid_request_error",
                    "code": "context_length_exceeded",
                }
            },
            status=413,
        )

    # -- load shedding (router/admission/) ---------------------------------
    def _shed_response(
        self,
        clock: PhaseClock,
        shed: ShedDecision,
        request_id: str,
    ) -> web.Response:
        """Build the 429 for an admission shed: the whole router time
        tiles as ONE ``shed`` phase (closure holds for sheds too), the
        Retry-After header is the computed finite value (HTTP wants
        integer seconds — ceil, never 0), and — tracing on — the
        decision exports as an ``admission_shed`` span event so shed
        requests appear in /debug/requests beside served ones."""
        clock.mark("shed")
        record_shed_observation(clock, shed.tenant, shed.reason)
        if self.tracer.enabled:
            load = (
                shed.load_score
                if shed.load_score != float("inf") else -1.0
            )
            span = self.tracer.start_span(
                "proxy_request",
                attributes={
                    "request_id": request_id,
                    "http.status": 429,
                    "shed_reason": shed.reason,
                    "tenant": shed.tenant_label,
                    "priority": shed.priority,
                },
            )
            span.add_event("admission_shed", {
                "reason": shed.reason,
                "retry_after_s": round(shed.retry_after_s, 3),
                "load_score": round(load, 4),
            })
            self.tracer.finish(span, status="SHED")
        return web.json_response(
            _shed_error_body(shed),
            status=429,
            headers={
                "Retry-After": str(max(1, math.ceil(shed.retry_after_s))),
            },
        )

    @staticmethod
    def _shed_fleet_asleep(admission, ticket, tenant=None) -> ShedDecision:
        """The ONE fleet-asleep sequence shared by the general, PD,
        and batch paths: build the ``fleet_asleep`` decision, then
        refund the token this request's admit consumed (a tenant
        retrying against a parked fleet must not drain its budget).
        Callers render the decision — ``_shed_response`` on HTTP
        paths, the (status, body) tuple in ``execute_internal``."""
        shed = admission.shed_fleet_asleep(
            tenant if tenant is not None
            else (ticket.name if ticket is not None else None)
        )
        admission.refund(ticket)
        return shed

    # -- per-tenant SLO evaluation (stats/slo.py) --------------------------
    @staticmethod
    # stackcheck: hot-path — read per finished streamed request
    def _ttft_from_clock(clock: PhaseClock) -> float:
        """Tenant-perceived TTFT: request arrival -> first upstream
        byte, read off the tiled phase marks (a retried request's
        dead-backend window counts — the tenant waited through it)."""
        phases = clock.phases
        return (
            phases.get("receive", 0.0)
            + phases.get("route_decision", 0.0)
            + phases.get("upstream_connect", 0.0)
            + phases.get("upstream_ttft", 0.0)
        )

    @staticmethod
    # stackcheck: hot-path — one call per finished proxied request
    def _note_slo(
        tenant: str | None,
        body: dict,
        ok: bool,
        e2e_s: float,
        ttft_s: float | None = None,
        tokens: int = 0,
        span: Span | None = None,
    ) -> tuple[str, ...]:
        """Evaluate one finished request against the tenant's SLO
        objectives (no-op when none are configured). Latencies are the
        TENANT's view (see ``_ttft_from_clock``); ITL is the streaming
        average over ``tokens`` units — SSE events for event-stream
        upstreams (TCP chunk framing must not move a latency SLO),
        relay chunks otherwise. Violations export as an
        ``slo_violation`` span event so shed triage can join
        /debug/requests with the burn dashboards."""
        tracker = get_slo_tracker()
        if not tracker.active:
            return ()
        itl_s = None
        if ttft_s is not None and tokens > 1:
            itl_s = (e2e_s - ttft_s) / (tokens - 1)
        violated = tracker.observe_request(
            tenant, body.get("model"), ok,
            e2e_s=e2e_s, ttft_s=ttft_s, itl_s=itl_s,
        )
        if violated and span is not None:
            span.add_event("slo_violation", {
                "objectives": ",".join(violated),
                "tenant": tenant or "(anonymous)",
                "e2e_s": round(e2e_s, 6),
                "ttft_s": (
                    round(ttft_s, 6) if ttft_s is not None else None
                ),
            })
        return violated

    # -- main entry (reference: request.py:141) ----------------------------
    # stackcheck: hot-path — per-request proxy entry; no blocking calls
    # stackcheck: slo-finish — every finish path notes SLO exactly once
    async def route_general_request(
        self, request: web.Request, endpoint_path: str
    ) -> web.StreamResponse:
        clock = PhaseClock()
        try:
            body = await request.json()
        except json.JSONDecodeError:
            # stackcheck: disable=exactly-once-note — malformed JSON is
            # rejected before tenant resolution; nothing entered the
            # pipeline, so there is no request to judge against an SLO
            return web.json_response(
                {"error": {"message": "invalid JSON", "type":
                           "invalid_request_error"}},
                status=400,
            )

        request_id = request.headers.get(
            "x-request-id", uuid.uuid4().hex
        )

        # admission control FIRST — before callbacks, rewriting, or any
        # routing work: overload protection only protects if a shed
        # costs microseconds, and the concurrency ticket must span the
        # whole request (PD flows included)
        admission = get_admission_controller()
        ticket, shed = admission.admit(
            request.headers, remote=request.remote
        )
        if shed is not None:
            return self._shed_response(clock, shed, request_id)
        # SLO attribution needs the tenant even when admission is OFF
        # (kill switch / feature gate): the identity ladder is pure —
        # resolve it iff objectives are configured, so the no-SLO
        # no-admission hot path stays zero-work
        tenant = ticket.name if ticket is not None else (
            admission.resolve_tenant(request.headers, request.remote)
            if get_slo_tracker().active else None
        )
        try:
            # PD branch (reference: request.py:159-163). PDRouter
            # requests may still serve single-phase (prefix-affine
            # resume / degenerate fleet) —
            # route_disaggregated_prefill_request decides.
            router = get_routing_logic()
            if isinstance(router, (DisaggregatedPrefillRouter, PDRouter)):
                return await self.route_disaggregated_prefill_request(
                    request, endpoint_path, body, request_id,
                    ticket=ticket, tenant=tenant,
                )

            # pre-request callback (reference: request.py:175-181)
            if self.callbacks is not None:
                maybe = self.callbacks.pre_request(
                    request, body, request_id
                )
                if maybe is not None:
                    body = maybe

            # request rewriter (reference: request.py:192-206)
            if self.rewriter is not None:
                body = self.rewriter.rewrite_request(
                    body, endpoint_path, request_id
                )

            endpoints = get_service_discovery().get_endpoint_info()
            model = body.get("model")
            candidates, resolved_model, asleep = self._filter_endpoints(
                endpoints, model
            )
            if resolved_model != model and resolved_model is not None:
                body["model"] = resolved_model
            if not candidates:
                if asleep and admission.active:
                    # the pool exists but every member is asleep or
                    # draining: a retryable 429 with the wake horizon,
                    # NOT a 502/503 — a reason clients can tell apart
                    # from their own budget, with the admit's token
                    # refunded. (Admission disabled keeps the
                    # pre-admission 503 below.)
                    return self._shed_response(
                        clock,
                        self._shed_fleet_asleep(admission, ticket),
                        request_id,
                    )
                # stackcheck: disable=exactly-once-note — local
                # pre-dispatch reject (no backend serves the model);
                # SLO objectives judge served requests, and the admit
                # above was released by the finally
                return web.json_response(
                    {"error": {
                        "message": f"no endpoint serving model {model!r}",
                        "type": "service_unavailable"}},
                    status=503,
                )
            # context-window gate: too-small backends drop out of the
            # pick; a prompt no backend can admit 413s HERE with the
            # cluster max instead of failing opaquely at the engine
            candidates, too_long = self._context_window_filter(
                candidates, body
            )
            if too_long is not None:
                # stackcheck: disable=exactly-once-note — 413 before
                # dispatch: the prompt fits no backend's context
                # window; nothing entered the pipeline to judge
                return too_long

            engine_stats = get_engine_stats_scraper().get_engine_stats()
            request_stats = get_request_stats_monitor().get_request_stats()
            rr = RouterRequest(
                headers=dict(request.headers), body=body,
                endpoint=endpoint_path,
            )
            clock.mark("receive")
            try:
                url = await router.route_request(
                    candidates, engine_stats, request_stats, rr
                )
            except RuntimeError as e:
                # stackcheck: disable=exactly-once-note — routing found
                # no viable backend before dispatch; nothing entered
                # the pipeline to judge against an SLO
                return web.json_response(
                    {"error": {"message": str(e), "type":
                               "service_unavailable"}},
                    status=503,
                )
            clock.mark("route_decision")
            logger.info(
                "Routing request %s to %s at endpoint %s",
                request_id, url, endpoint_path,
            )
            # connect-stage failures may fall over to the others
            alternates = [
                e.url for e in candidates if e.url != url
            ][:MAX_CONNECT_RETRIES]
            return await self.process_request(
                request, body, url, endpoint_path, request_id,
                clock=clock, alternates=alternates, tenant=tenant,
            )
        finally:
            admission.release(ticket)

    def _emit_phase_spans(
        self, span: Span, clock: PhaseClock, request_id: str,
        windows: list[tuple[int, str]],
    ) -> None:
        """Export the clock's tiled marks as child spans of the
        proxy_request span. Monotonic marks map onto the parent's
        epoch anchor, so the children line up with the engine-side
        timeline spans in one cross-hop trace view. `receive`/
        `route_decision` legitimately start BEFORE the parent span was
        created (the span needs the routing outcome for its backend
        attribute) — their small negative offsets are truthful.

        ``windows`` maps mark index ranges to backends ((first mark
        index, url) per connect attempt): a retried request's failed
        connect slice carries the DEAD backend's url, not the one that
        eventually served it."""
        if not span.sampled:
            return  # same contract as the parent: sampled-out = local only
        anchor = span._start_mono
        for i, (name, start, end) in enumerate(clock.marks):
            backend = windows[0][1]
            for w_start, w_url in windows:
                if w_start <= i:
                    backend = w_url
                else:
                    break
            child = Span(
                name=f"router.{name}",
                trace_id=span.trace_id,
                span_id=self.tracer.new_span_id(),
                parent_span_id=span.span_id,
                start_time=span.start_time + (start - anchor),
                sampled=span.sampled,
                attributes={
                    "request_id": request_id, "backend": backend,
                },
            )
            child.end_time = span.start_time + (end - anchor)
            self.tracer.finish(child)

    # -- proxy + streaming (reference: request.py:55-138) ------------------
    # stackcheck: hot-path — per-chunk relay loop; no blocking calls
    # stackcheck: slo-finish — every finish path notes SLO exactly once
    async def process_request(
        self,
        request: web.Request,
        body: dict,
        backend_url: str,
        endpoint_path: str,
        request_id: str,
        stats_url: str | None = None,
        clock: PhaseClock | None = None,
        alternates: list[str] | tuple[str, ...] = (),
        tenant: str | None = None,
    ) -> web.StreamResponse:
        monitor = get_request_stats_monitor()
        board = get_engine_health_board()
        if clock is None:
            # direct callers (PD decode phase) skipped the routed entry:
            # receive/route_decision tile as zero-width phases
            clock = PhaseClock()
        prompt_tokens = _estimate_prompt_tokens(body)
        # correlation: the engine adopts this id as ITS request id (and
        # echoes it back), so router logs/spans and engine logs/spans/
        # timelines join end-to-end — previously the generated id was
        # dropped on the engine floor
        headers = _forward_headers(request)
        _set_header(headers, REQUEST_ID_HEADER, request_id)
        span = None
        if self.tracer.enabled:
            # continue the CLIENT's trace when it sent a valid
            # traceparent; the legacy x-trace-id override applies only
            # WITHOUT one (combining them would parent the span into a
            # different trace than its trace_id names) and only when it
            # is a spec-valid 32-hex trace id — an opaque legacy value
            # would make the injected traceparent unparseable (silently
            # detaching the engine) and its OTLP traceId invalid, so it
            # rides as an attribute instead
            parent = parse_traceparent(
                request.headers.get(TRACEPARENT_HEADER)
            )
            legacy = request.headers.get("x-trace-id")
            trace_id = None
            attrs = {
                "request_id": request_id,
                "backend": backend_url,
                "endpoint": endpoint_path,
                "model": body.get("model"),
                "prompt_tokens_est": prompt_tokens,
                # stackcheck: disable=device-sync-hot — plain dict
                # truthiness; the router never holds device arrays
                "stream": bool(body.get("stream")),
            }
            if legacy is not None and parent is None:
                if re.fullmatch(r"[0-9a-f]{32}", legacy):
                    trace_id = legacy
                else:
                    attrs["legacy_trace_id"] = legacy
            span = self.tracer.start_span(
                "proxy_request",
                trace_id=trace_id,
                parent=parent,
                attributes=attrs,
            )
            # engine spans/timelines become children of this span
            _set_header(headers, TRACEPARENT_HEADER, span.traceparent)
        self.in_flight += 1
        # store-after-response for the semantic cache (reference:
        # semantic_cache_integration.py:74): only whole (non-stream) chat
        # completions are cacheable
        cache_body = (
            self.semantic_cache is not None
            and endpoint_path.endswith("chat/completions")
            and not body.get("stream")
        )
        # connect-stage failures (nothing written to either socket yet)
        # fall over to the remaining routing candidates; once the client
        # response is prepared the stream is committed to one backend
        targets = [backend_url]
        targets += [u for u in alternates if u not in targets]
        last_exc: Exception | None = None
        committed: web.StreamResponse | None = None
        # (first mark index, url) per connect attempt — phase spans use
        # this to attribute each slice to the backend that owned it
        attempt_windows: list[tuple[int, str]] = [(0, backend_url)]
        try:
            for attempt, url in enumerate(targets):
                surl = stats_url or url
                # retry attempts observe only their own window
                # (PhaseClock.checkpoint): the healthy fallback backend
                # must not absorb the dead backend's connect timeout
                # into its histograms/EWMA, nor re-observe the shared
                # receive/route_decision slices (charged to attempt 0)
                ckpt = clock.checkpoint() if attempt else None
                if attempt:
                    attempt_windows.append((len(clock.marks), url))
                monitor.on_new_request(
                    surl, request_id, num_prompt_tokens=prompt_tokens
                )
                board.on_request_start(surl)
                first_chunk_seen = False
                prepared = False
                completed = False  # monitor.on_request_complete ran
                observed = False   # record_proxy_observation ran
                tokens_relayed = 0
                # SSE event count for the SLO ITL denominator: TCP
                # buffering coalesces/splits iter_any() chunks, so
                # chunk count would judge transport framing, not
                # model latency (tokens_relayed keeps the historical
                # chunk semantics the relay metrics are gated on)
                sse_units = 0
                prev_nl = False
                ttft_s: float | None = None
                captured: list[bytes] = []
                try:
                    async with self.session.post(
                        f"{url}{endpoint_path}",
                        json=body,
                        headers=headers,
                    ) as upstream:
                        t_connect = clock.mark("upstream_connect")
                        resp = web.StreamResponse(
                            status=upstream.status,
                            headers={
                                k: v
                                for k, v in upstream.headers.items()
                                if k.lower() not in _HOP_HEADERS
                            },
                        )
                        await _to_client(resp.prepare(request))
                        prepared = True
                        committed = resp
                        is_sse = upstream.headers.get(
                            "Content-Type", ""
                        ).startswith("text/event-stream")
                        async for chunk in upstream.content.iter_any():
                            if not first_chunk_seen:
                                first_chunk_seen = True
                                t_first = clock.mark("upstream_ttft")
                                ttft_s = t_first - t_connect
                                monitor.on_request_response(
                                    surl, request_id
                                )
                                if span is not None:
                                    span.add_event("first_token")
                            else:
                                monitor.on_token(surl, request_id)
                            tokens_relayed += 1
                            if is_sse and chunk:
                                sse_units += chunk.count(b"\n\n")
                                if prev_nl and chunk[:1] == b"\n":
                                    # "\n\n" split across chunks
                                    sse_units += 1
                                prev_nl = (
                                    chunk.endswith(b"\n")
                                    and not chunk.endswith(b"\n\n")
                                )
                            if cache_body and upstream.status == 200:
                                captured.append(chunk)
                            await _to_client(resp.write(chunk))
                        await _to_client(resp.write_eof())
                        clock.mark("stream_relay")
                        monitor.on_request_complete(surl, request_id)
                        completed = True
                        if captured:
                            try:
                                self.semantic_cache.store(
                                    body, json.loads(b"".join(captured))
                                )
                            except (json.JSONDecodeError,
                                    UnicodeDecodeError):
                                pass
                        if self.callbacks is not None:
                            self.callbacks.post_request(request_id, body)
                        if span is not None:
                            span.set_attribute(
                                "http.status", upstream.status
                            )
                            if attempt:
                                span.set_attribute("backend", url)
                                span.set_attribute(
                                    "connect_retries", attempt
                                )
                        clock.mark("finalize")
                        # upstream 5xx counts against engine health;
                        # 4xx is the client's problem, not the engine's
                        record_proxy_observation(
                            surl, clock,
                            ok=upstream.status < 500,
                            error_kind=(
                                None if upstream.status < 500
                                else f"http_{upstream.status}"
                            ),
                            ttft_s=ttft_s,
                            tokens=tokens_relayed,
                            since=ckpt,
                        )
                        observed = True
                        self._note_slo(
                            tenant, body,
                            ok=upstream.status < 500,
                            e2e_s=clock.elapsed_s,
                            ttft_s=(
                                self._ttft_from_clock(clock)
                                if first_chunk_seen else None
                            ),
                            tokens=(
                                sse_units if is_sse else tokens_relayed
                            ),
                            span=span,
                        )
                        if span is not None:
                            self._emit_phase_spans(
                                span, clock, request_id, attempt_windows
                            )
                            self.tracer.finish(span)
                            span = None
                        return resp
                except _ClientDisconnected as e:
                    # the CLIENT went away (prepare/write failed) — the
                    # engine did its job: record the sample + phase
                    # histograms but leave its error totals/streak/EWMA
                    # untouched, and never burn a retry candidate on it
                    if not completed:
                        monitor.on_request_complete(surl, request_id)
                    clock.mark(
                        "stream_relay" if first_chunk_seen
                        else "upstream_ttft"
                    )
                    record_proxy_observation(
                        surl, clock, ok=False,
                        error_kind="client_disconnect",
                        ttft_s=ttft_s, tokens=tokens_relayed,
                        engine_fault=False, since=ckpt,
                    )
                    logger.info(
                        "client for request %s went away mid-proxy "
                        "(backend %s): %s", request_id, url, e,
                    )
                    # stackcheck: disable=exactly-once-note — the
                    # client went away mid-stream: there is no
                    # tenant-observed completion to judge; the proxy
                    # observation above records the disconnect
                    return resp
                except (http.ClientError, ConnectionResetError,
                        asyncio.TimeoutError) as e:
                    last_exc = e
                    if not completed:
                        monitor.on_request_complete(surl, request_id)
                    # attribute the open slice to the phase in progress
                    kind = _mark_open_phase(
                        clock, prepared, first_chunk_seen
                    )
                    record_proxy_observation(
                        surl, clock, ok=False, error_kind=kind,
                        ttft_s=ttft_s, tokens=tokens_relayed,
                        since=ckpt,
                    )
                    retriable = (
                        not prepared and attempt + 1 < len(targets)
                    )
                    logger.warning(
                        "backend %s failed for request %s during %s: "
                        "%s%s",
                        url, request_id, kind, e,
                        " (retrying on next candidate)"
                        if retriable else "",
                    )
                    if not retriable:
                        break
                    board.note_retry(surl)
                    upstream_retries.labels(server=surl).inc()
                except BaseException as e:
                    # anything else — handler cancellation (client gone
                    # / server shutdown), an unexpected bug — must not
                    # leak the board's in-flight count or the monitor's
                    # open entry; not charged to engine health (the
                    # backend did nothing wrong that we know of). The
                    # completed/observed guards keep a failure in the
                    # post-stream bookkeeping (callbacks, span export)
                    # from double-counting a finished request.
                    if not completed:
                        monitor.on_request_complete(surl, request_id)
                    if not observed:
                        _mark_open_phase(
                            clock, prepared, first_chunk_seen
                        )
                        record_proxy_observation(
                            surl, clock, ok=False,
                            error_kind=(
                                "cancelled"
                                if isinstance(e, asyncio.CancelledError)
                                else type(e).__name__
                            ),
                            ttft_s=ttft_s, tokens=tokens_relayed,
                            engine_fault=False, since=ckpt,
                        )
                    raise
            # terminal upstream failure (every candidate burned, or a
            # committed stream died): ONE per-request SLO observation —
            # client disconnects/cancellations never reach here, so
            # only engine-fault outcomes count against error budgets
            self._note_slo(
                tenant, body, ok=False, e2e_s=clock.elapsed_s, span=span,
            )
            if committed is not None:
                # the client stream is already committed to a failed
                # backend: a fresh 502 body cannot go out on this
                # connection — close it so the client sees truncation
                # (SSE consumers: no terminating [DONE])
                committed.force_close()
                return committed
            return web.json_response(
                {"error": {"message": f"backend error: {last_exc}",
                           "type": "bad_gateway"}},
                status=502,
            )
        finally:
            if span is not None:
                self._emit_phase_spans(
                    span, clock, request_id, attempt_windows
                )
                self.tracer.finish(span, status="ERROR")
            self.in_flight -= 1

    # -- headless execution (batch API worker path) ------------------------
    # stackcheck: slo-finish — every finish path notes SLO exactly once
    async def execute_internal(
        self, body: dict, endpoint_path: str, request_id: str | None = None
    ) -> tuple[int, dict]:
        """Route + execute one non-streaming request with no client socket.

        Used by the batch processor (reference executes batches through the
        same proxy machinery, services/batch_service/local_processor.py).
        Returns (status_code, response_json)."""
        request_id = request_id or uuid.uuid4().hex
        body = dict(body)
        body.pop("stream", None)
        clock = PhaseClock()
        # batch-API work is the canonical shed-first traffic: one
        # shared tenant at `batch` priority, so under overload the
        # batch processor backs off (it retries 429s on its own clock)
        # before any interactive request is touched
        admission = get_admission_controller()
        ticket, shed = admission.admit(
            {"x-priority": "batch"}, tenant="batch-api"
        )
        if shed is not None:
            clock.mark("shed")
            record_shed_observation(clock, shed.tenant, shed.reason)
            return 429, _shed_error_body(shed)
        try:
            endpoints = get_service_discovery().get_endpoint_info()
            candidates, resolved_model, asleep = self._filter_endpoints(
                endpoints, body.get("model")
            )
            if (resolved_model is not None
                    and resolved_model != body.get("model")):
                body["model"] = resolved_model
            if not candidates:
                if asleep and admission.active:
                    fleet_shed = self._shed_fleet_asleep(
                        admission, ticket, tenant="batch-api"
                    )
                    clock.mark("shed")
                    record_shed_observation(
                        clock, fleet_shed.tenant, fleet_shed.reason
                    )
                    return 429, _shed_error_body(fleet_shed)
                # stackcheck: disable=exactly-once-note — local
                # pre-dispatch reject (no backend serves the model);
                # nothing entered the pipeline to judge
                return 503, {"error": {
                    "message": (
                        f"no endpoint serving model "
                        f"{body.get('model')!r}"),
                    "type": "service_unavailable"}}
            router = get_routing_logic()
            monitor = get_request_stats_monitor()
            clock.mark("receive")
            try:
                url = await router.route_request(
                    candidates,
                    get_engine_stats_scraper().get_engine_stats(),
                    monitor.get_request_stats(),
                    RouterRequest(
                        headers={}, body=body, endpoint=endpoint_path
                    ),
                )
            except RuntimeError as e:
                # stackcheck: disable=exactly-once-note — routing found
                # no viable backend before dispatch; nothing entered
                # the pipeline to judge
                return 503, {"error": {"message": str(e),
                                       "type": "service_unavailable"}}
            clock.mark("route_decision")
            monitor.on_new_request(
                url, request_id,
                num_prompt_tokens=_estimate_prompt_tokens(body),
            )
            board = get_engine_health_board()
            board.on_request_start(url)
            self.in_flight += 1
            ok, kind = False, "connect"
            try:
                async with self.session.post(
                    f"{url}{endpoint_path}", json=body,
                    headers={REQUEST_ID_HEADER: request_id},
                ) as upstream:
                    clock.mark("upstream_connect")
                    monitor.on_request_response(url, request_id)
                    kind = "stream"
                    payload = await upstream.json(content_type=None)
                    clock.mark("stream_relay")
                    ok = upstream.status < 500
                    kind = None if ok else f"http_{upstream.status}"
                    return upstream.status, payload
            except (http.ClientError, ConnectionResetError,
                    asyncio.TimeoutError, json.JSONDecodeError,
                    UnicodeDecodeError) as e:
                return 502, {"error": {"message": f"backend error: {e}",
                                       "type": "bad_gateway"}}
            finally:
                monitor.on_request_complete(url, request_id)
                # batch requests are whole-body reads: no relay
                # throughput, and no sample ring entry (the ring is the
                # loadgen's view of the streaming proxy path)
                record_proxy_observation(
                    url, clock, ok=ok, error_kind=kind,
                    record_sample=False
                )
                # whole-body reads have no streaming TTFT/ITL: only
                # the e2e/error/availability objectives evaluate
                self._note_slo(
                    "batch-api", body, ok=ok, e2e_s=clock.elapsed_s,
                )
                self.in_flight -= 1
        finally:
            admission.release(ticket)

    # -- disaggregated prefill (reference: request.py:349-441) -------------
    # stackcheck: slo-finish — every finish path notes SLO exactly once
    async def route_disaggregated_prefill_request(
        self,
        request: web.Request,
        endpoint_path: str,
        body: dict,
        request_id: str,
        ticket=None,
        tenant: str | None = None,
    ) -> web.StreamResponse:
        router = get_routing_logic()
        assert isinstance(router, (DisaggregatedPrefillRouter, PDRouter))
        discovered = get_service_discovery().get_endpoint_info()
        endpoints = [e for e in discovered if not e.sleep]
        if not endpoints and discovered:
            # whole PD fleet asleep/draining: same retryable 429 +
            # Retry-After + token-refund contract as the general
            # route (admission off keeps the legacy 503 from the
            # empty-pool RuntimeError below; the caller still
            # release()s the ticket)
            admission = get_admission_controller()
            if admission.active:
                # direct PD entries (no ticket) resolve the tenant
                # from the request for shed attribution
                tenant = (
                    None if ticket is not None
                    else admission.resolve_tenant(
                        request.headers, request.remote
                    )
                )
                return self._shed_response(
                    PhaseClock(),
                    self._shed_fleet_asleep(
                        admission, ticket, tenant=tenant
                    ),
                    request_id,
                )
        # same context-window gate as the general route: neither PD
        # phase can serve a prompt past its backend's window
        endpoints, too_long = self._context_window_filter(
            endpoints, body
        )
        if too_long is not None:
            # stackcheck: disable=exactly-once-note — 413 before
            # dispatch: the prompt fits neither PD phase's context
            # window; nothing entered the pipeline to judge
            return too_long
        try:
            if isinstance(router, PDRouter):
                rr = RouterRequest(
                    headers=dict(request.headers), body=body,
                    endpoint=endpoint_path,
                )
                prefill_url, decode_url = await router.plan(endpoints, rr)
                if prefill_url is None:
                    # prefix-affine resume (PPD) or degenerate fleet:
                    # the serving engine already holds / will hold the
                    # whole chain — no handoff, one phase
                    return await self.process_request(
                        request, body, decode_url, endpoint_path,
                        request_id, tenant=tenant,
                    )
            else:
                prefill_url, decode_url = (
                    await router.route_prefill_decode(endpoints)
                )
        except RuntimeError as e:
            # stackcheck: disable=exactly-once-note — PD planning found
            # no viable pair before dispatch; nothing entered the
            # pipeline to judge against an SLO
            return web.json_response(
                {"error": {"message": str(e),
                           "type": "service_unavailable"}},
                status=503,
            )

        monitor = get_request_stats_monitor()
        headers = _forward_headers(request)
        _set_header(headers, REQUEST_ID_HEADER, request_id)

        # Phase 1: prefill with max_tokens=1, KV lands in the transfer tier
        prefill_body = dict(body)
        orig_max_tokens = body.get("max_tokens", 128)
        prefill_body["max_tokens"] = 1
        prefill_body["stream"] = False
        prefill_body.setdefault("kv_transfer_params", {})["role"] = (
            "producer"
        )
        # interval math on time.monotonic() only (wall-clock steps must
        # not corrupt the logged prefill duration or the stats window)
        t0 = time.monotonic()
        monitor.on_new_request(
            prefill_url, f"{request_id}-prefill",
            num_prompt_tokens=_estimate_prompt_tokens(body),
        )
        # the phase-1 POST must feed the health scoreboard like every
        # other upstream attempt: PDRouter's prefill-pool pick is
        # health-gated + in-flight-weighted, and a dead prefill engine
        # can only trip is_healthy() (and fail over on the next cold
        # prompt) if its failures are OBSERVED here. record_sample=False
        # keeps these whole-body reads out of the streaming sample ring
        # (they carry no tiled phase decomposition).
        board = get_engine_health_board()
        board.on_request_start(prefill_url)
        try:
            async with self.session.post(
                f"{prefill_url}{endpoint_path}",
                json=prefill_body, headers=headers,
            ) as pr:
                if pr.status != 200:
                    detail = await pr.text()
                    monitor.on_request_complete(
                        prefill_url, f"{request_id}-prefill"
                    )
                    board.observe(
                        prefill_url, {}, time.monotonic() - t0,
                        ok=pr.status < 500,
                        error_kind=f"http_{pr.status}",
                        record_sample=False,
                    )
                    self._note_slo(
                        tenant, body, ok=pr.status < 500,
                        e2e_s=time.monotonic() - t0,
                    )
                    return web.json_response(
                        {"error": {"message":
                                   f"prefiller error: {detail[:500]}",
                                   "type": "bad_gateway"}},
                        status=502,
                    )
                await pr.read()
        except (http.ClientError, ConnectionResetError,
                asyncio.TimeoutError) as e:
            monitor.on_request_complete(
                prefill_url, f"{request_id}-prefill"
            )
            board.observe(
                prefill_url, {}, time.monotonic() - t0,
                ok=False, error_kind="connect", record_sample=False,
            )
            self._note_slo(
                tenant, body, ok=False, e2e_s=time.monotonic() - t0,
            )
            return web.json_response(
                {"error": {"message": f"prefiller unreachable: {e}",
                           "type": "bad_gateway"}},
                status=502,
            )
        monitor.on_request_response(
            prefill_url, f"{request_id}-prefill"
        )
        monitor.on_request_complete(
            prefill_url, f"{request_id}-prefill"
        )
        board.observe(
            prefill_url, {}, time.monotonic() - t0, ok=True,
            record_sample=False,
        )
        logger.info(
            "PD request %s: prefill on %s took %.3fs; decoding on %s",
            request_id, prefill_url, time.monotonic() - t0, decode_url,
        )

        # Phase 2: decode streams to the client, pulling KV from prefiller
        decode_body = dict(body)
        decode_body["max_tokens"] = orig_max_tokens
        decode_body.setdefault("kv_transfer_params", {})["role"] = (
            "consumer"
        )
        return await self.process_request(
            request, decode_body, decode_url, endpoint_path, request_id,
            stats_url=decode_url, tenant=tenant,
        )

    # -- sleep/wake passthrough (reference: request.py:444-520) ------------
    async def route_sleep_wakeup_request(
        self, request: web.Request, path: str
    ) -> web.Response:
        url = request.query.get("url") or request.headers.get("x-engine-url")
        endpoints = get_service_discovery().get_endpoint_info()
        targets = (
            [e for e in endpoints if e.url == url]
            if url
            else endpoints
        )
        if not targets:
            return web.json_response(
                {"error": {"message": "no matching engine",
                           "type": "not_found"}},
                status=404,
            )
        results = {}
        for ep in targets:
            try:
                if path == "/is_sleeping":
                    async with self.session.get(
                        f"{ep.url}{path}"
                    ) as r:
                        status = r.status
                        results[ep.url] = await r.json()
                else:
                    async with self.session.post(
                        f"{ep.url}{path}",
                        params=dict(request.query),
                    ) as r:
                        status = r.status
                        results[ep.url] = await r.json()
            except http.ClientError as e:
                results[ep.url] = {"error": str(e)}
                continue
            if status != 200:
                continue
            # reflect the verb's outcome into discovery IMMEDIATELY:
            # the sleep filter and the admission fleet_asleep path must
            # see an operator-initiated sleep on the very next request,
            # not after the discovery reprobe interval
            if path == "/sleep":
                ep.sleep = True
            elif path == "/wake_up":
                ep.sleep = False
            elif path == "/is_sleeping" and isinstance(
                results[ep.url], dict
            ):
                ep.sleep = bool(
                    results[ep.url].get("is_sleeping", ep.sleep)
                )
        if url:
            return web.json_response(results[url])
        return web.json_response(results)


def _estimate_prompt_tokens(body: dict) -> int:
    """Cheap prompt-size signal for the stats monitor and the
    context-window filter — exact for token-id prompts, ~4 chars/token
    (a deliberate lower bound) for text. One copy:
    router.utils.estimate_prompt_tokens."""
    from production_stack_tpu_torch.router.utils import estimate_prompt_tokens

    return max(1, estimate_prompt_tokens(body))
