"""Router-level Prometheus metrics: gauges + data-plane histograms.

Parity: reference src/vllm_router/services/metrics_service/__init__.py:5-47 —
the same `vllm:*` gauge names, labeled by server (engine URL), so the
reference's Grafana dashboard panels read ours unchanged.

On top of the reference's Gauges, the proxy hot path records per-hop
phase HISTOGRAMS under `tpu_router:*` (routing decision, upstream
connect, upstream TTFT, stream relay, relay tokens/s) plus
request/error/retry counters — aggregate gauges can say an engine is
slow, only the phase distributions say WHERE a request's router time
went. Fed through ``observe_proxy_phases`` (one call per finished proxy
attempt, see stats/health.py); scoreboard gauges are pushed by
``stats/log_stats.py`` on render.

The port's copy registers the same families on utils/prometheus.py (the
subset of prometheus_client they use, with its text exposition).
"""

from __future__ import annotations

from production_stack_tpu_torch.utils.prometheus import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

ROUTER_REGISTRY = CollectorRegistry()


def _g(name: str, doc: str) -> Gauge:
    return Gauge(name, doc, ["server"], registry=ROUTER_REGISTRY)


num_requests_running = _g(
    "vllm:num_requests_running", "Requests running on each engine"
)
num_requests_waiting = _g(
    "vllm:num_requests_waiting", "Requests queued on each engine"
)
current_qps = _g("vllm:current_qps", "QPS routed to each engine")
avg_decoding_length = _g(
    "vllm:avg_decoding_length", "Average decode length per engine"
)
num_prefill_requests = _g(
    "vllm:num_prefill_requests", "Requests currently in prefill"
)
num_decoding_requests = _g(
    "vllm:num_decoding_requests", "Requests currently decoding"
)
avg_latency = _g("vllm:avg_latency", "Average end-to-end latency")
avg_itl = _g("vllm:avg_itl", "Average inter-token latency")
num_requests_swapped = _g(
    "vllm:num_requests_swapped", "Requests swapped/preempted"
)
gpu_cache_usage_perc = _g(
    "vllm:gpu_cache_usage_perc", "Engine KV cache usage"
)
gpu_prefix_cache_hit_rate = _g(
    "vllm:gpu_prefix_cache_hit_rate", "Engine prefix-cache hit rate"
)
healthy_pods_total = _g(
    "vllm:healthy_pods_total", "Healthy serving engines"
)
avg_ttft = _g("vllm:avg_ttft", "Average time to first token")

# -- router data-plane phase histograms (proxy hot path) ---------------------
# sub-ms buckets matter: routing decisions and upstream connects on a
# LAN are 10us-5ms events; the top buckets catch timeout-shaped tails
_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
_THROUGHPUT_BUCKETS = (
    1.0, 10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0, 10000.0, 50000.0,
    100000.0,
)


def _h(name: str, doc: str, buckets=_LATENCY_BUCKETS) -> Histogram:
    return Histogram(
        name, doc, ["server"], registry=ROUTER_REGISTRY, buckets=buckets
    )


receive_seconds = _h(
    "tpu_router:receive_seconds",
    "Body parse + callbacks + rewrite + endpoint filter, per request",
)
routing_decision_seconds = _h(
    "tpu_router:routing_decision_seconds",
    "Routing-logic pick (incl. kv/ttft estimation), per request",
)
upstream_connect_seconds = _h(
    "tpu_router:upstream_connect_seconds",
    "Upstream connect + request write until response headers",
)
upstream_ttft_seconds = _h(
    "tpu_router:upstream_ttft_seconds",
    "Upstream response headers until first body byte",
)
stream_relay_seconds = _h(
    "tpu_router:stream_relay_seconds",
    "First upstream byte until eof written to the client",
)
finalize_seconds = _h(
    "tpu_router:finalize_seconds",
    "Post-stream bookkeeping (cache store, callbacks, span export)",
)
request_e2e_seconds = _h(
    "tpu_router:request_e2e_seconds",
    "Whole proxied request as the router saw it (receive -> finish)",
)
relay_tokens_per_second = _h(
    "tpu_router:relay_tokens_per_second",
    "Streaming relay throughput (chunks relayed / relay seconds)",
    buckets=_THROUGHPUT_BUCKETS,
)

PHASE_HISTOGRAMS = {
    "receive": receive_seconds,
    "route_decision": routing_decision_seconds,
    "upstream_connect": upstream_connect_seconds,
    "upstream_ttft": upstream_ttft_seconds,
    "stream_relay": stream_relay_seconds,
    "finalize": finalize_seconds,
}

# renders as tpu_router:requests_total / tpu_router:upstream_errors_total /
# tpu_router:upstream_retries_total (a Counter appends _total)
proxy_requests = Counter(
    "tpu_router:requests", "Finished proxy attempts",
    ["server", "outcome"], registry=ROUTER_REGISTRY,
)
upstream_errors = Counter(
    "tpu_router:upstream_errors", "Failed proxy attempts by error kind",
    ["server", "kind"], registry=ROUTER_REGISTRY,
)
upstream_retries = Counter(
    "tpu_router:upstream_retries",
    "Connect-stage failures re-proxied to another backend "
    "(counted on the failed backend)",
    ["server"], registry=ROUTER_REGISTRY,
)

# shared KV cache hints (kvaware/prefixaware querying the cache
# server's `lookup` verb): how often the cluster cache held a prefix no
# candidate engine did — each hit is a cold prompt that routed
# load-aware into a restore instead of sticky into a recompute
shared_cache_lookups = Counter(
    "tpu_router:shared_cache_lookups",
    "Cache-server lookup probes issued by KV-aware routing",
    ["server"], registry=ROUTER_REGISTRY,
)
shared_cache_hits = Counter(
    "tpu_router:shared_cache_hits",
    "Lookups where the shared cache held a chain prefix",
    ["server"], registry=ROUTER_REGISTRY,
)
shared_cache_routed = Counter(
    "tpu_router:shared_cache_routed",
    "Requests routed load-aware on a cluster cache hit (no engine "
    "held the prefix locally)",
    ["server"], registry=ROUTER_REGISTRY,
)

# -- admission control (router/admission/) -----------------------------------
# tenant labels are ONLY configured tenant names or "(other)" (the
# controller folds IP/API-key fallback identities into one label so a
# scanning client cannot explode the Prometheus label set)
admission_sheds = Counter(
    "tpu_router:admission_sheds",
    "Requests shed by admission control, by tenant and reason "
    "(tenant_limit | tenant_concurrency | overload | fleet_asleep | "
    "slo_burn)",
    ["tenant", "reason"], registry=ROUTER_REGISTRY,
)
admission_admitted = Counter(
    "tpu_router:admission_admitted",
    "Requests admitted by admission control, by tenant",
    ["tenant"], registry=ROUTER_REGISTRY,
)
admission_bucket_occupancy = Histogram(
    "tpu_router:admission_bucket_occupancy",
    "Token-bucket fill fraction (0..1) observed at each admission "
    "decision for rate-limited tenants",
    ["tenant"], registry=ROUTER_REGISTRY,
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
)
admission_retry_after = Histogram(
    "tpu_router:admission_retry_after_seconds",
    "Computed Retry-After advertised on shed (429) responses "
    "(bucket refill deficit + backpressure term)",
    ["reason"], registry=ROUTER_REGISTRY,
    buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0),
)
admission_load_score = Gauge(
    "tpu_router:admission_load_score",
    "Cluster load score driving overload shedding (1.0 = awake fleet "
    "at its configured target; -1 = fleet fully asleep)",
    registry=ROUTER_REGISTRY,
)
admission_shed_seconds = Histogram(
    "tpu_router:shed_seconds",
    "Router time spent on a shed request (the tiled `shed` phase: "
    "body parse + admission decision + 429 build)",
    registry=ROUTER_REGISTRY, buckets=_LATENCY_BUCKETS,
)


def observe_admission_shed(
    tenant_label: str,
    reason: str,
    retry_after_s: float,
    occupancy: float | None = None,
    load_score: float | None = None,
) -> None:
    """Fold one shed decision into the admission counters (called via
    AdmissionController._shed on the proxy hot path)."""
    admission_sheds.labels(tenant=tenant_label, reason=reason).inc()
    admission_retry_after.labels(reason=reason).observe(retry_after_s)
    if occupancy is not None:
        admission_bucket_occupancy.labels(
            tenant=tenant_label
        ).observe(occupancy)
    if load_score is not None:
        admission_load_score.set(load_score)


def observe_admission_admitted(
    tenant_label: str, occupancy: float | None = None
) -> None:
    admission_admitted.labels(tenant=tenant_label).inc()
    if occupancy is not None:
        admission_bucket_occupancy.labels(
            tenant=tenant_label
        ).observe(occupancy)


# -- per-tenant SLO tracking (stats/slo.py) ----------------------------------
# tenant labels are ONLY configured tenant names or "(other)"
# (default-matched fallback identities fold into one label, same
# hygiene as the admission counters above); `objective` is one of
# ttft | itl | e2e | error_rate | availability
slo_compliance_ratio = Gauge(
    "tpu_router:slo_compliance_ratio",
    "Fraction of requests meeting the objective over the FAST window "
    "(1.0 = fully compliant; a tenant's worst model row)",
    ["tenant", "objective"], registry=ROUTER_REGISTRY,
)
slo_budget_remaining = Gauge(
    "tpu_router:slo_budget_remaining",
    "Error budget left over the SLOW window (1.0 = untouched, 0 = "
    "exhausted; a tenant's worst model row)",
    ["tenant", "objective"], registry=ROUTER_REGISTRY,
)
slo_burn_rate = Gauge(
    "tpu_router:slo_burn_rate",
    "Error-budget burn rate (violation fraction / budget fraction; "
    "1.0 = budget exactly exhausted over the window) per multi-window "
    "pair (window = fast | slow)",
    ["tenant", "objective", "window"], registry=ROUTER_REGISTRY,
)
# renders as tpu_router:slo_violations_total
slo_violations = Counter(
    "tpu_router:slo_violations",
    "Requests that violated a tenant SLO objective",
    ["tenant", "objective"], registry=ROUTER_REGISTRY,
)


def observe_slo_violations(
    tenant_label: str, objectives,
) -> None:
    """Fold one request's violated objectives into the counter (called
    via SLOTracker.observe_request on the proxy hot path)."""
    for name in objectives:
        slo_violations.labels(
            tenant=tenant_label, objective=name
        ).inc()


# -- fleet autoscale signal family (HPA/KEDA-consumable) ---------------------
# refreshed by AdmissionController.export_gauges on /metrics render;
# observability/prom-adapter.yaml exports these so the operator layer
# can scale engine replicas on the router's own load view
fleet_load_score = Gauge(
    "tpu_router:fleet_load_score",
    "Cluster load score normalized per awake engine (same signal the "
    "admission ladder sheds on; -1 = fleet fully asleep)",
    registry=ROUTER_REGISTRY,
)
fleet_awake_engines = Gauge(
    "tpu_router:fleet_awake_engines",
    "Discovered backends currently awake (sleeping/draining excluded)",
    registry=ROUTER_REGISTRY,
)
fleet_desired_replicas_hint = Gauge(
    "tpu_router:fleet_desired_replicas_hint",
    "Engine replica count that would bring the load score to the "
    "configured target (ceil(awake * score / target), min 1 while "
    "any endpoint is discovered) — feed HPA/KEDA directly",
    registry=ROUTER_REGISTRY,
)


# engine health scoreboard gauges (mirror of GET /debug/engines; pushed
# by stats/log_stats.py on each render so /metrics scrapes stay fresh)
engine_ewma_latency = _g(
    "tpu_router:engine_ewma_latency_seconds",
    "EWMA e2e latency per backend (router-observed)",
)
engine_ewma_ttft = _g(
    "tpu_router:engine_ewma_ttft_seconds",
    "EWMA upstream TTFT per backend (router-observed)",
)
engine_error_rate = _g(
    "tpu_router:engine_error_rate",
    "EWMA error rate per backend (0..1)",
)
engine_consecutive_failures = _g(
    "tpu_router:engine_consecutive_failures",
    "Current consecutive-failure streak per backend",
)
engine_inflight = _g(
    "tpu_router:engine_inflight",
    "Requests currently proxied to each backend",
)
engine_last_scrape_age = _g(
    "tpu_router:engine_last_scrape_age_seconds",
    "Seconds since the stats scraper last reached each backend",
)


def observe_proxy_phases(
    url: str,
    phases: dict[str, float],
    e2e_s: float,
    ok: bool,
    error_kind: str | None = None,
    tokens: int = 0,
    engine_fault: bool = True,
) -> None:
    """Record one finished proxy attempt into the phase histograms and
    outcome counters (called via stats.health.record_proxy_observation
    on the proxy hot path — keep this allocation-light).

    A failure with ``engine_fault=False`` (client disconnect, handler
    cancellation) gets its own outcome label and stays out of
    ``upstream_errors`` — those count failures the BACKEND caused."""
    for name, seconds in phases.items():
        hist = PHASE_HISTOGRAMS.get(name)
        if hist is not None:
            hist.labels(server=url).observe(seconds)
    request_e2e_seconds.labels(server=url).observe(e2e_s)
    relay_s = phases.get("stream_relay", 0.0)
    if tokens > 0 and relay_s > 0:
        relay_tokens_per_second.labels(server=url).observe(
            tokens / relay_s
        )
    outcome = "ok" if ok else ("error" if engine_fault else "client_abort")
    proxy_requests.labels(server=url, outcome=outcome).inc()
    if not ok and engine_fault:
        upstream_errors.labels(
            server=url, kind=error_kind or "error"
        ).inc()


def note_shared_cache_lookup(
    cache_url: str, hit: bool, routed: bool, lookup: bool = True
) -> None:
    """KV-aware routing accounting against the shared cache server:
    `lookup=True` counts a probe (plus its hit), `routed=True` counts
    a request actually sent load-aware into a restore (a separate,
    later decision — pass lookup=False for it)."""
    if lookup:
        shared_cache_lookups.labels(server=cache_url).inc()
        if hit:
            shared_cache_hits.labels(server=cache_url).inc()
    if routed:
        shared_cache_routed.labels(server=cache_url).inc()


# router-host resource gauges (reference: routers/metrics_router.py:42-53)
_router_g = lambda name, doc: Gauge(name, doc, registry=ROUTER_REGISTRY)
router_cpu_percent = _router_g(
    "router:cpu_usage_percent", "Router host CPU usage"
)
router_mem_percent = _router_g(
    "router:memory_usage_percent", "Router host memory usage"
)
router_disk_percent = _router_g(
    "router:disk_usage_percent", "Router host disk usage"
)


# prime the per-process CPU sample so the first scrape isn't a false 0.0
try:
    import psutil as _psutil

    _psutil.cpu_percent()
except ImportError:
    pass


def render_prometheus() -> str:
    """Prometheus exposition text for the /metrics endpoint, including the
    psutil host gauges (reference: metrics_router.py:77-86)."""
    try:
        import psutil

        router_cpu_percent.set(psutil.cpu_percent())
        router_mem_percent.set(psutil.virtual_memory().percent)
        router_disk_percent.set(psutil.disk_usage("/").percent)
    except ImportError:
        pass
    return generate_latest(ROUTER_REGISTRY).decode()
