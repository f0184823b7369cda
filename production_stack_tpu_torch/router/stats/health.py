"""Per-engine health scoreboard + proxy phase accounting (router data
plane observability).

Two pieces, both fed from the proxy hot path in
``services/request_service.py``:

- ``PhaseClock``: tiled monotonic phase stamps for one proxied request.
  Consecutive ``mark()`` calls close the currently-open phase, so the
  phases TILE the request's lifetime — ``sum(phases) == e2e`` by
  construction, and the loadbench smoke gate
  (``tests/test_router_loadbench.py``) asserts the closure stays within
  5%: a future edit that measures phases disjointly (leaving
  unattributed gaps) breaks the gate instead of silently leaking
  latency out of the decomposition.

- ``EngineHealthBoard``: the per-backend scoreboard behind
  ``GET /debug/engines`` — EWMA latency/TTFT, in-flight count, EWMA
  error rate, consecutive-failure streak, retry/error totals, and
  last-scrape age (fed by ``stats/engine_stats.py``). This is the
  signal surface routing policies (and the future multi-engine
  directions in ROADMAP.md) read; today it is observational only.

Clock discipline matches ``tracing/spans.py``: every interval is
measured on ``time.monotonic()``; epoch time is never used for math
(ages are reported as seconds-since, computed monotonic-to-monotonic).

Threading: all mutation happens on the router's single event loop
(proxy callbacks + scraper task), mirroring ``RequestStatsMonitor`` —
no locks on the hot path.
"""
# stackcheck: monotonic-only — health scoring and phase accounting are
# interval math; wall clock jumps would flap engine health

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

# no cycle: metrics_service depends only on utils/prometheus.py (the
# services package __init__ is inert)
from production_stack_tpu_torch.router.services.metrics_service import (
    observe_proxy_phases,
)

# phase order of a fully-relayed streaming request; failures attribute
# their open slice to the phase that was in progress when they hit
PROXY_PHASES = (
    "receive",           # body parse, callbacks, rewrite, endpoint filter
    "route_decision",    # routing-logic pick (incl. kv/ttft estimates)
    "upstream_connect",  # connect + request write until response headers
    "upstream_ttft",     # headers -> first body byte (incl. client prepare)
    "stream_relay",      # first byte -> eof written to the client
    "finalize",          # cache store, callbacks, span bookkeeping
    # terminal phase of an admission-SHED request (429 + Retry-After):
    # the one mark closes body-parse + admission decision + response
    # build as `shed`, so sum(phases) == e2e holds for sheds too
    "shed",
)


class PhaseClock:
    """Tiled monotonic phase stamps for ONE proxied request."""

    __slots__ = ("t0", "_last", "marks")

    def __init__(self) -> None:
        self.t0 = time.monotonic()
        self._last = self.t0
        # (phase, start_mono, end_mono) in mark order
        self.marks: list[tuple[str, float, float]] = []

    def mark(self, phase: str) -> float:
        """Close the open slice as ``phase``; returns the boundary."""
        now = time.monotonic()
        self.marks.append((phase, self._last, now))
        self._last = now
        return now

    @property
    def phases(self) -> dict[str, float]:
        """Per-phase seconds (repeated marks of one phase accumulate)."""
        out: dict[str, float] = {}
        for name, start, end in self.marks:
            out[name] = out.get(name, 0.0) + (end - start)
        return out

    @property
    def elapsed_s(self) -> float:
        """Independently-measured e2e: now minus the first stamp. The
        closure gate compares this against sum(phases)."""
        return time.monotonic() - self.t0

    # -- retry attribution windows ----------------------------------------
    def checkpoint(self) -> tuple[int, float]:
        """Snapshot (mark index, open-slice start). An observation
        recorded ``since=`` a checkpoint covers only the marks after it,
        so a connect-retry's successful attempt does not charge the
        dead backend's timeout to the healthy backend's histograms/EWMA.
        Tiling is preserved within the window: phases_since sums to
        elapsed_since by the same construction as the full clock."""
        return (len(self.marks), self._last)

    def phases_since(self, ckpt: tuple[int, float]) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, start, end in self.marks[ckpt[0]:]:
            out[name] = out.get(name, 0.0) + (end - start)
        return out

    def elapsed_since(self, ckpt: tuple[int, float]) -> float:
        return time.monotonic() - ckpt[1]


@dataclass
class EngineHealth:
    """Mutable per-backend scoreboard row."""

    url: str
    ewma_latency_s: float = -1.0  # -1 = no completed request yet
    ewma_ttft_s: float = -1.0
    error_rate: float = 0.0  # EWMA of the per-request error indicator
    in_flight: int = 0
    consecutive_failures: int = 0
    requests_total: int = 0
    errors_total: int = 0
    retries_total: int = 0
    scrape_failures: int = 0
    last_error: str | None = None
    last_request_mono: float | None = None
    last_scrape_mono: float | None = None

    def to_dict(self, now_mono: float | None = None) -> dict:
        now = now_mono if now_mono is not None else time.monotonic()
        age = lambda t: round(now - t, 3) if t is not None else None
        return {
            "url": self.url,
            "ewma_latency_s": round(self.ewma_latency_s, 6),
            "ewma_ttft_s": round(self.ewma_ttft_s, 6),
            "error_rate": round(self.error_rate, 6),
            "in_flight": self.in_flight,
            "consecutive_failures": self.consecutive_failures,
            "requests_total": self.requests_total,
            "errors_total": self.errors_total,
            "retries_total": self.retries_total,
            "scrape_failures": self.scrape_failures,
            "last_error": self.last_error,
            "last_request_age_s": age(self.last_request_mono),
            "last_scrape_age_s": age(self.last_scrape_mono),
        }


class EngineHealthBoard:
    """Scoreboard of every backend the proxy/scraper has touched."""

    def __init__(
        self, ewma_alpha: float = 0.1, sample_capacity: int = 4096
    ) -> None:
        self.ewma_alpha = ewma_alpha
        self._engines: dict[str, EngineHealth] = {}
        # bounded ring of raw per-request phase samples: the load
        # harness (scripts/router_loadgen.py) reads these to compute
        # per-phase percentiles and the closure check; sized well above
        # steady-state debugging needs, resizable for bench runs
        self.samples: deque[dict] = deque(maxlen=sample_capacity)

    def _eng(self, url: str) -> EngineHealth:
        eng = self._engines.get(url)
        if eng is None:
            eng = self._engines[url] = EngineHealth(url)
        return eng

    def set_sample_capacity(self, n: int) -> None:
        self.samples = deque(self.samples, maxlen=n)

    # -- proxy feed --------------------------------------------------------
    def on_request_start(self, url: str) -> None:
        self._eng(url).in_flight += 1

    def note_retry(self, url: str) -> None:
        """A request abandoned this backend at connect time and is being
        re-proxied elsewhere (counted on the FAILED backend)."""
        self._eng(url).retries_total += 1

    def observe(
        self,
        url: str,
        phases: dict[str, float],
        e2e_s: float,
        ok: bool,
        error_kind: str | None = None,
        ttft_s: float | None = None,
        tokens: int = 0,
        record_sample: bool = True,
        engine_fault: bool = True,
    ) -> None:
        """Fold one finished proxy attempt into the scoreboard.

        ``engine_fault=False`` marks a failure the BACKEND did not cause
        (client disconnected mid-relay, handler cancelled): the request
        still counts and the sample is recorded, but the engine's error
        totals/streak/EWMA error rate stay untouched — an impatient
        client must not be able to mark a healthy engine unhealthy."""
        eng = self._eng(url)
        eng.in_flight = max(0, eng.in_flight - 1)
        eng.requests_total += 1
        eng.last_request_mono = time.monotonic()
        a = self.ewma_alpha
        fold = lambda cur, v: v if cur < 0 else (1 - a) * cur + a * v
        if ok:
            eng.ewma_latency_s = fold(eng.ewma_latency_s, e2e_s)
            if ttft_s is not None:
                eng.ewma_ttft_s = fold(eng.ewma_ttft_s, ttft_s)
            eng.consecutive_failures = 0
        elif engine_fault:
            eng.errors_total += 1
            eng.consecutive_failures += 1
            eng.last_error = error_kind or "error"
        eng.error_rate = (1 - a) * eng.error_rate + a * (
            1.0 if (not ok and engine_fault) else 0.0
        )
        if record_sample:
            self.samples.append({
                "url": url,
                "ok": ok,
                "error": error_kind,
                "e2e_s": e2e_s,
                "ttft_s": ttft_s,
                "tokens": tokens,
                "phases": phases,
            })

    # -- scraper feed ------------------------------------------------------
    def note_scrape(self, url: str, ok: bool = True) -> None:
        eng = self._eng(url)
        if ok:
            eng.last_scrape_mono = time.monotonic()
            eng.scrape_failures = 0
        else:
            eng.scrape_failures += 1

    def prune(
        self, keep: set[str], min_idle_s: float = 600.0
    ) -> list[str]:
        """Evict rows for backends that are no longer discovered, have
        nothing in flight, and have been idle for ``min_idle_s``.
        Dynamic-discovery churn (k8s pod restarts → new URL each time)
        must not grow the scoreboard — and the per-server Prometheus
        label sets exported from it — without bound. Returns the
        evicted URLs so the caller can drop their gauge labels too."""
        now = time.monotonic()
        evicted = []
        for url, eng in list(self._engines.items()):
            if url in keep or eng.in_flight:
                continue
            last = max(
                eng.last_request_mono or 0.0,
                eng.last_scrape_mono or 0.0,
            )
            if last and now - last < min_idle_s:
                continue
            del self._engines[url]
            evicted.append(url)
        return evicted

    # -- queries -----------------------------------------------------------
    def get(self, url: str) -> EngineHealth | None:
        """Public row accessor for scoreboard consumers (routing
        policies): the row for a backend the proxy/scraper has touched,
        or None. Callers must treat the row as read-only."""
        return self._engines.get(url)

    def is_healthy(self, url: str, max_streak: int = 3) -> bool:
        """Cheap go/no-go signal for routing policies: a backend with a
        running failure streak is suspect until a request succeeds."""
        eng = self._engines.get(url)
        return eng is None or eng.consecutive_failures < max_streak

    def snapshot(self) -> dict[str, dict]:
        now = time.monotonic()
        return {
            url: eng.to_dict(now) for url, eng in self._engines.items()
        }


def record_proxy_observation(
    url: str,
    clock: PhaseClock,
    ok: bool,
    error_kind: str | None = None,
    ttft_s: float | None = None,
    tokens: int = 0,
    record_sample: bool = True,
    engine_fault: bool = True,
    since: tuple[int, float] | None = None,
) -> None:
    """The ONE sink for a finished proxy attempt: folds the phase clock
    into the health board AND the ``tpu_router:*`` Prometheus
    histograms/counters (services/metrics_service.py).

    ``since`` (a ``PhaseClock.checkpoint()``) restricts the observation
    to the marks after a connect-retry, so each attempt's backend is
    charged only for its own window."""
    if since is not None:
        phases = clock.phases_since(since)
        e2e_s = clock.elapsed_since(since)
    else:
        phases = clock.phases
        e2e_s = clock.elapsed_s
    get_engine_health_board().observe(
        url, phases, e2e_s, ok,
        error_kind=error_kind, ttft_s=ttft_s, tokens=tokens,
        record_sample=record_sample, engine_fault=engine_fault,
    )
    observe_proxy_phases(
        url, phases, e2e_s, ok,
        error_kind=error_kind, tokens=tokens, engine_fault=engine_fault,
    )


def record_shed_observation(
    clock: PhaseClock, tenant: str, reason: str
) -> None:
    """The sink for an admission-SHED request: a tiled sample in the
    board's ring (so the loadgen closure gate covers shed requests —
    ``shed: True`` keeps them out of per-engine error accounting; no
    backend was ever touched, so no scoreboard row moves) plus the
    ``tpu_router:shed_seconds`` histogram. Sheds also fold into the
    tenant's SLO ``availability`` window (stats/slo.py): from the
    tenant's view a shed request was not served — but NEVER into the
    latency/error objectives that feed admission's shed signal back."""
    # read the independent e2e FIRST: a shed request is microseconds
    # long, so every instruction between the caller's final mark and
    # this read — even a cached import statement — is relative
    # closure error (everything below, the SLO fold included, must
    # stay AFTER this read)
    e2e_s = clock.elapsed_s
    from production_stack_tpu_torch.router.services.metrics_service import (
        admission_shed_seconds,
    )
    from production_stack_tpu_torch.router.stats.slo import get_slo_tracker

    phases = clock.phases
    get_slo_tracker().observe_shed(tenant)
    admission_shed_seconds.observe(phases.get("shed", 0.0))
    get_engine_health_board().samples.append({
        "url": None,
        "shed": True,
        "ok": True,  # the ROUTER did its job; not an upstream error
        "error": None,
        "shed_reason": reason,
        "tenant": tenant,
        "e2e_s": e2e_s,
        "ttft_s": None,
        "tokens": 0,
        "phases": phases,
    })


# -- singleton lifecycle -----------------------------------------------------
_board: EngineHealthBoard | None = None


def initialize_engine_health_board(
    ewma_alpha: float = 0.1, sample_capacity: int = 4096
) -> EngineHealthBoard:
    global _board
    _board = EngineHealthBoard(ewma_alpha, sample_capacity)
    return _board


def get_engine_health_board() -> EngineHealthBoard:
    """Auto-creates with defaults: the scoreboard must never be the
    reason a proxy callback or scraper tick raises."""
    global _board
    if _board is None:
        _board = EngineHealthBoard()
    return _board


def _reset_engine_health_board() -> None:
    global _board
    _board = None
