"""SLO-aware admission control: the decision every proxied request
passes through BEFORE routing.

Decision ladder (cheapest first, all O(1) on the event loop):

1. resolve the tenant (``x-tenant-id`` header → API key → client IP)
   and its priority (tenant config; an ``x-priority`` header can only
   LOWER it — clients cannot self-promote above interactive),
2. per-tenant concurrency cap (``tenant_concurrency`` shed),
3. cluster overload: the :func:`admission.load.compute_load` score vs
   the priority ladder — batch sheds at 75% of the threshold, normal
   at 90%, interactive at 100%, so interactive traffic sheds LAST
   (``overload`` shed),
4. per-tenant token bucket (``tenant_limit`` shed).

Every shed carries a computed, finite ``Retry-After``: the bucket's
refill deficit plus a backpressure term proportional to how far the
load score sits past the tenant's shed point — a shed client learns
both WHEN its budget refills and how loaded the cluster is, instead of
hammering a 429 wall.

Shedding here returns a 429 in microseconds instead of queuing the
request into a cluster-wide TTFT blowup — the p99 protection the
ROADMAP's overload direction calls the "missing production half".

Live-reload: ``apply_config`` (fed by ``dynamic_config.py``) swaps
budgets atomically, preserving in-flight counts; the
``AdmissionControl`` feature gate and the ``enabled`` config key are
the kill switches.

Threading: all mutation happens on the router's single event loop
(mirrors ``RequestStatsMonitor`` / ``EngineHealthBoard``) — no locks
on the hot path, and no wall-clock reads anywhere (monotonic only).
"""
# stackcheck: monotonic-only — retry-after and shed decisions are
# interval math; wall clock jumps would mis-time backoffs

from __future__ import annotations

import hashlib
import math
import time
from dataclasses import dataclass

from production_stack_tpu_torch.router.admission.load import (
    LoadSignals,
    compute_load,
)
from production_stack_tpu_torch.router.admission.tenants import (
    PRIORITIES,
    TenantLimits,
    TenantState,
    priority_rank,
)
# no cycles: feature_gates + metrics_service import nothing from the
# router data plane; hoisted here so the per-request admit path never
# pays a lazy-import lookup
from production_stack_tpu_torch.router.feature_gates import get_feature_gates
from production_stack_tpu_torch.router.services.metrics_service import (
    admission_load_score,
    fleet_awake_engines,
    fleet_desired_replicas_hint,
    fleet_load_score,
    observe_admission_admitted,
    observe_admission_shed,
)
# stats.slo imports only metrics_service — no cycle back into admission
from production_stack_tpu_torch.router.stats.slo import get_slo_tracker
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# fraction of the shed threshold at which each priority starts
# shedding under cluster overload: the ladder that makes interactive
# traffic shed LAST
PRIORITY_SHED_FRACTION = {
    "batch": 0.75,
    "normal": 0.90,
    "interactive": 1.0,
}

# Retry-After shaping: never advertise more than a minute (clients
# should re-probe — budgets and load both move), and scale the
# backpressure term so a score 20% past the shed point reads ~1s
RETRY_AFTER_MAX_S = 60.0
OVERLOAD_RETRY_SCALE_S = 5.0

# load-score recompute rate limit: the signals (board in-flight,
# scraped stats) move on request/scrape cadence, not per-microsecond —
# recomputing at most every 250ms keeps admit() O(1) at 10k RPS
LOAD_SCORE_MAX_AGE_S = 0.25

# unconfigured (IP-fallback) tenant rows idle this long are pruned so
# an IP sweep cannot grow the tenant table without bound
TENANT_IDLE_PRUNE_S = 900.0

# metrics label for tenants NOT named in config (IP/API-key fallback
# identities must not explode the Prometheus label set)
OTHER_TENANT_LABEL = "(other)"


@dataclass(frozen=True)
class ShedDecision:
    """One load-shedding verdict: everything the 429 response, the
    metrics, and the span event need."""

    # tenant_limit | tenant_concurrency | overload | fleet_asleep |
    # slo_burn
    reason: str
    retry_after_s: float
    tenant: str
    tenant_label: str
    priority: str
    load_score: float
    message: str


class AdmissionController:
    """Owns tenant budgets + the cluster load score; one per router."""

    def __init__(
        self,
        enabled: bool = True,
        tenant_header: str = "x-tenant-id",
        default_limits: TenantLimits | None = None,
        tenants: dict[str, TenantLimits] | None = None,
        engine_inflight_target: int = 512,
        engine_queue_target: int = 256,
        delay_target_s: float = 2.0,
        shed_threshold: float = 1.0,
        asleep_retry_s: float = 10.0,
        fleet_target_load: float = 0.75,
    ) -> None:
        self.enabled = enabled
        self.tenant_header = tenant_header.lower()
        self.default_limits = default_limits or TenantLimits()
        self.tenant_limits: dict[str, TenantLimits] = dict(tenants or {})
        self.engine_inflight_target = engine_inflight_target
        self.engine_queue_target = engine_queue_target
        self.delay_target_s = delay_target_s
        self.shed_threshold = shed_threshold
        self.asleep_retry_s = asleep_retry_s
        # load score the autoscale hint steers toward: the exported
        # tpu_router:fleet_desired_replicas_hint is the replica count
        # that would bring the score back to this target
        self.fleet_target_load = fleet_target_load
        self._states: dict[str, TenantState] = {}
        self._load = LoadSignals()
        self._load_stamp: float | None = None
        # decision totals (cheap cross-check for /debug/admission);
        # refunds = admits whose request the fleet could not serve
        # (token returned), so admitted - refunded = actually routed
        self.admitted_total = 0
        self.shed_total = 0
        self.refunded_total = 0

    # -- activation --------------------------------------------------------
    @property
    def active(self) -> bool:
        """Both kill switches consulted per request: the config
        ``enabled`` flag (live-reloadable) and the AdmissionControl
        feature gate (boot-time ``--feature-gates`` kill switch)."""
        if not self.enabled:
            return False
        return get_feature_gates().enabled("AdmissionControl")

    # -- tenant resolution -------------------------------------------------
    # stackcheck: hot-path — per-request identity lookup, O(1)
    def resolve_tenant(
        self, headers, remote: str | None = None
    ) -> str:
        """Identity ladder: explicit tenant header (operator-routed) →
        API key (hashed — the key itself must not reach logs/metrics)
        → client IP → anonymous."""
        tenant = headers.get(self.tenant_header)
        if tenant:
            return tenant
        auth = headers.get("authorization") or headers.get("x-api-key")
        if auth:
            if auth.lower().startswith("bearer "):
                auth = auth[7:]
            digest = hashlib.sha1(auth.encode()).hexdigest()[:12]
            return f"key:{digest}"
        if remote:
            return f"ip:{remote}"
        return "(anonymous)"

    def _state(self, tenant: str, now: float) -> TenantState:
        state = self._states.get(tenant)
        if state is None:
            limits = self.tenant_limits.get(tenant, self.default_limits)
            state = TenantState.build(
                tenant, limits, now, configured=tenant in self.tenant_limits
            )
            self._states[tenant] = state
        state.last_seen_mono = now
        return state

    def _priority(self, state: TenantState, headers) -> str:
        """Tenant-config priority, lowered (never raised) by an
        ``x-priority`` request header."""
        prio = state.limits.priority
        requested = headers.get("x-priority")
        if requested and priority_rank(requested) < priority_rank(prio):
            prio = requested if requested in PRIORITIES else prio
        return prio

    # -- load score --------------------------------------------------------
    # stackcheck: hot-path — rate-limited recompute inside admit()
    def load_score(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        if (
            self._load_stamp is None
            or now - self._load_stamp > LOAD_SCORE_MAX_AGE_S
        ):
            self._load = self._compute_load()
            self._load_stamp = now
        return self._load.score

    def _compute_load(self, detail: bool = False) -> LoadSignals:
        from production_stack_tpu_torch.router.service_discovery import (
            get_service_discovery,
        )
        from production_stack_tpu_torch.router.stats.engine_stats import (
            get_engine_stats_scraper,
        )
        from production_stack_tpu_torch.router.stats.health import (
            get_engine_health_board,
        )

        try:
            endpoints = get_service_discovery().get_endpoint_info()
            engine_stats = get_engine_stats_scraper().get_engine_stats()
        except RuntimeError:
            # discovery/scraper not up yet (boot, unit tests): no
            # signal is not a reason to shed
            return LoadSignals()
        return compute_load(
            endpoints,
            get_engine_health_board(),
            engine_stats,
            self.engine_inflight_target,
            self.engine_queue_target,
            self.delay_target_s,
            detail=detail,
        )

    # -- the decision ------------------------------------------------------
    # stackcheck: hot-path — every proxied request passes through here
    # before routing; O(1), no awaits, no blocking calls
    def admit(
        self,
        headers,
        remote: str | None = None,
        now: float | None = None,
        tenant: str | None = None,
    ) -> tuple[TenantState | None, ShedDecision | None]:
        """Returns ``(ticket, None)`` on admission — the caller MUST
        ``release(ticket)`` when the request finishes — or
        ``(None, shed)`` when the request must be shed."""
        if not self.active:
            return None, None
        now = time.monotonic() if now is None else now
        tenant = tenant or self.resolve_tenant(headers, remote)
        state = self._state(tenant, now)
        prio = self._priority(state, headers)
        load = self.load_score(now)

        limits = state.limits
        if (
            limits.max_concurrency > 0
            and state.in_flight >= limits.max_concurrency
        ):
            return None, self._shed(
                state, "tenant_concurrency", prio, load,
                # concurrency drains as in-flight requests finish —
                # there is no refill clock, so advertise a short
                # backpressure-shaped nudge
                base_retry_s=1.0,
                message=(
                    f"tenant {tenant!r} has {state.in_flight} requests "
                    f"in flight (cap {limits.max_concurrency})"
                ),
            )

        # SLO-budget protection: a tenant burning
        # its own fast-window error budget sheds its batch/normal
        # traffic BEFORE the cluster-load ladder fires, protecting the
        # tenant's interactive requests with its remaining budget. The
        # signal reads only the latency/error objectives — never
        # `availability`, which sheds feed (death-spiral guard in
        # stats/slo.py) — and is off until the slo: config sets
        # shed_burn_threshold > 0.
        if prio != "interactive":
            tracker = get_slo_tracker()
            burn = tracker.shed_burn(tenant, now)
            threshold = tracker.shed_burn_threshold
            if burn is not None and burn >= threshold:
                return None, self._shed(
                    state, "slo_burn", prio, load,
                    # no refill clock: advertise a backpressure nudge
                    # proportional to how hot the budget is burning,
                    # bounded well under the fast window
                    base_retry_s=min(
                        30.0, OVERLOAD_RETRY_SCALE_S * burn / threshold
                    ),
                    message=(
                        f"tenant {tenant!r} is burning its SLO error "
                        f"budget at {burn:.1f}x the sustainable rate "
                        f"(threshold {threshold:g}); shedding "
                        f"{prio}-priority traffic"
                    ),
                )

        shed_at = self.shed_threshold * PRIORITY_SHED_FRACTION.get(
            prio, PRIORITY_SHED_FRACTION["normal"]
        )
        # an INFINITE score means the fleet is entirely asleep — that
        # is not an overload: let the request through to the endpoint
        # filter, which sheds it as the distinct `fleet_asleep` reason
        # (with the bucket token refunded). Shedding it here as
        # `overload` would mislabel the condition and burn no-fault
        # budget, and which label a client saw would depend on the
        # load-score cache age.
        if shed_at <= load != float("inf"):
            return None, self._shed(
                state, "overload", prio, load,
                base_retry_s=1.0,
                message=(
                    f"cluster load {load:.2f} >= {shed_at:.2f} "
                    f"({prio} shed point)"
                ),
            )

        if state.bucket is not None and not state.bucket.try_acquire(now):
            return None, self._shed(
                state, "tenant_limit", prio, load,
                base_retry_s=state.bucket.deficit_s(now),
                message=(
                    f"tenant {tenant!r} exceeded its "
                    f"{limits.rate:g} req/s budget"
                ),
            )

        state.in_flight += 1
        state.admitted_total += 1
        self.admitted_total += 1
        self._observe_admitted(state)
        return state, None

    # stackcheck: hot-path — paired with admit() on every request
    def release(self, ticket: TenantState | None) -> None:
        if ticket is not None:
            ticket.in_flight = max(0, ticket.in_flight - 1)

    def refund(self, ticket: TenantState | None) -> None:
        """Return the bucket token consumed by an admit whose request
        the router then could NOT route through no fault of the tenant
        (fleet asleep): a tenant retrying against a parked fleet must
        not drain its budget on requests that were never served. The
        caller still ``release()``s the ticket as usual — this only
        restores the token."""
        if ticket is None:
            return
        if ticket.bucket is not None:
            ticket.bucket.tokens = min(
                ticket.bucket.burst, ticket.bucket.tokens + 1.0
            )
        ticket.refunded_total += 1
        self.refunded_total += 1

    def shed_fleet_asleep(
        self, tenant: str | None = None
    ) -> ShedDecision:
        """The fleet-wide shed: every pool member serving the model is
        asleep/draining. Distinct reason (``fleet_asleep``, not
        ``tenant_limit``) so clients and dashboards can tell 'you are
        over budget' from 'the fleet is parked'; Retry-After is the
        configured wake horizon, not a bucket refill."""
        now = time.monotonic()
        state = self._state(tenant or "(anonymous)", now)
        return self._shed(
            state, "fleet_asleep", state.limits.priority,
            self.load_score(now),
            base_retry_s=self.asleep_retry_s,
            message=(
                "every backend serving this model is asleep/draining"
            ),
        )

    def _shed(
        self,
        state: TenantState,
        reason: str,
        priority: str,
        load: float,
        base_retry_s: float,
        message: str,
    ) -> ShedDecision:
        """Build the decision + fold it into counters/metrics. The
        Retry-After is base (bucket deficit / wake horizon) plus a
        backpressure term proportional to how far past the shed point
        the load score sits, clamped finite."""
        shed_at = self.shed_threshold * PRIORITY_SHED_FRACTION.get(
            priority, PRIORITY_SHED_FRACTION["normal"]
        )
        backpressure = 0.0
        if load > shed_at and load != float("inf"):
            backpressure = (load - shed_at) * OVERLOAD_RETRY_SCALE_S
        retry_after = min(
            RETRY_AFTER_MAX_S, max(0.05, base_retry_s + backpressure)
        )
        state.shed_total += 1
        state.sheds_by_reason[reason] = (
            state.sheds_by_reason.get(reason, 0) + 1
        )
        self.shed_total += 1
        label = state.name if state.configured else OTHER_TENANT_LABEL
        observe_admission_shed(
            label, reason, retry_after,
            occupancy=(
                state.bucket.occupancy
                if state.bucket is not None else None
            ),
            load_score=load if load != float("inf") else None,
        )
        return ShedDecision(
            reason=reason,
            retry_after_s=retry_after,
            tenant=state.name,
            tenant_label=label,
            priority=priority,
            load_score=load,
            message=message,
        )

    def _observe_admitted(self, state: TenantState) -> None:
        observe_admission_admitted(
            state.name if state.configured else OTHER_TENANT_LABEL,
            occupancy=(
                state.bucket.occupancy
                if state.bucket is not None else None
            ),
        )

    # -- live-reload (dynamic_config.py) -----------------------------------
    def apply_config(self, raw: dict) -> None:
        """Atomically apply an ``admission:`` section from the dynamic
        config file. Validates EVERYTHING before touching any state so
        a malformed payload keeps the last-good config (the watcher
        catches the raise). Shape::

            admission:
              enabled: true
              shed_threshold: 1.0
              engine_inflight_target: 512
              engine_queue_target: 256
              delay_target_s: 2.0
              asleep_retry_s: 10.0
              default: {rate: 0, burst: 0, max_concurrency: 0,
                        priority: normal}
              tenants:
                team-a: {rate: 50, burst: 100, priority: interactive}
        """
        if not isinstance(raw, dict):
            raise ValueError(
                f"admission config must be a mapping, got {raw!r}"
            )
        known = {
            "enabled", "shed_threshold", "engine_inflight_target",
            "engine_queue_target", "delay_target_s", "asleep_retry_s",
            "fleet_target_load", "default", "tenants",
        }
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"unknown admission config keys {sorted(unknown)}"
            )
        # omitted sections mean "keep current" (a bare {enabled: false}
        # toggle must not wipe budgets or refill live buckets);
        # explicitly-present ones replace wholesale
        budgets_changed = "default" in raw or "tenants" in raw
        default = (
            TenantLimits.from_dict(raw["default"])
            if "default" in raw else self.default_limits
        )
        tenants = (
            {
                str(name): TenantLimits.from_dict(spec)
                for name, spec in (raw["tenants"] or {}).items()
            }
            if "tenants" in raw else self.tenant_limits
        )
        scalars = {}
        for key, cast, floor in (
            ("shed_threshold", float, 0.0),
            ("engine_inflight_target", int, 1),
            ("engine_queue_target", int, 1),
            ("delay_target_s", float, 0.0),
            ("asleep_retry_s", float, 0.0),
            ("fleet_target_load", float, 0.0),
        ):
            if key in raw:
                value = cast(raw[key])
                if value < floor:
                    raise ValueError(f"admission {key} must be >= {floor}")
                scalars[key] = value
        # -- validated: swap atomically --
        now = time.monotonic()
        self.enabled = bool(raw.get("enabled", self.enabled))
        self.default_limits = default
        self.tenant_limits = tenants
        for key, value in scalars.items():
            setattr(self, key, value)
        if budgets_changed:
            for name, state in list(self._states.items()):
                # live tenants pick up retuned budgets in place
                # (in-flight preserved); tenants dropped from config
                # fall back to the (possibly retuned) default. An
                # UNCHANGED budget keeps its bucket as-is — an edit to
                # an unrelated config key must not hand every throttled
                # tenant a fresh full burst
                state.configured = name in tenants
                new_limits = tenants.get(name, default)
                if new_limits != state.limits:
                    state.reconfigure(new_limits, now)
        self._load_stamp = None  # thresholds changed: recompute
        logger.info(
            "admission config applied: %d named tenants, default "
            "rate=%g, shed_threshold=%g, enabled=%s",
            len(tenants), default.rate, self.shed_threshold, self.enabled,
        )

    # -- housekeeping / introspection --------------------------------------
    def prune(self, now: float | None = None) -> list[str]:
        """Drop idle UNCONFIGURED tenant rows (IP-fallback identities)
        so a scanning client cannot grow the table without bound.
        Called off the hot path (log_stats render)."""
        now = time.monotonic() if now is None else now
        dropped = []
        for name, state in list(self._states.items()):
            if state.configured or state.in_flight:
                continue
            if now - state.last_seen_mono >= TENANT_IDLE_PRUNE_S:
                del self._states[name]
                dropped.append(name)
        return dropped

    def export_gauges(self) -> None:
        """Refresh the admission + fleet-autoscale gauges on /metrics
        render (mirrors the health-board gauge push in
        stats/log_stats.py). The ``tpu_router:fleet_*`` family is the
        HPA/KEDA-consumable signal the operator layer scales engine
        replicas on (observability/prom-adapter.yaml exports it)."""
        score = self.load_score()
        finite = score if score != float("inf") else -1.0
        admission_load_score.set(finite)
        fleet_load_score.set(finite)
        fleet_awake_engines.set(self._load.awake_backends)
        fleet_desired_replicas_hint.set(self.desired_replicas_hint())

    def desired_replicas_hint(self, sig: LoadSignals | None = None) -> int:
        """Engine replicas that would bring the load score back to
        ``fleet_target_load``: ``ceil(awake * score / target)``,
        floored at 1 while ANY endpoint is discovered (a fully-asleep
        fleet still needs one replica to wake; an empty discovery
        hints 0 — nothing is known to scale)."""
        if sig is None:
            sig = self._load
        known = sig.awake_backends + sig.sleeping_backends
        if known == 0:
            return 0
        if sig.score == float("inf") or sig.awake_backends == 0:
            return 1
        if self.fleet_target_load <= 0:
            return max(1, sig.awake_backends)
        return max(1, math.ceil(
            sig.awake_backends * sig.score / self.fleet_target_load
        ))

    def snapshot(self, detail: bool = True) -> dict:
        """The /debug/admission payload."""
        now = time.monotonic()
        load = self._compute_load(detail=detail)
        return {
            "enabled": self.enabled,
            "active": self.active,
            "load": load.to_dict(),
            "config": {
                "tenant_header": self.tenant_header,
                "shed_threshold": self.shed_threshold,
                "priority_shed_fractions": dict(PRIORITY_SHED_FRACTION),
                "engine_inflight_target": self.engine_inflight_target,
                "engine_queue_target": self.engine_queue_target,
                "delay_target_s": self.delay_target_s,
                "asleep_retry_s": self.asleep_retry_s,
                "fleet_target_load": self.fleet_target_load,
                "default": {
                    "rate": self.default_limits.rate,
                    "burst": self.default_limits.burst,
                    "max_concurrency": self.default_limits.max_concurrency,
                    "priority": self.default_limits.priority,
                },
            },
            "admitted_total": self.admitted_total,
            "shed_total": self.shed_total,
            "refunded_total": self.refunded_total,
            # the exported autoscale signal family, as /metrics sees it
            "fleet": {
                "awake_engines": load.awake_backends,
                "load_score": (
                    round(load.score, 4)
                    if load.score != float("inf") else -1.0
                ),
                "desired_replicas_hint": self.desired_replicas_hint(load),
            },
            "tenants": {
                name: state.to_dict(now)
                for name, state in sorted(self._states.items())
            },
        }


# -- singleton lifecycle -----------------------------------------------------
_controller: AdmissionController | None = None


def initialize_admission_controller(**kwargs) -> AdmissionController:
    global _controller
    _controller = AdmissionController(**kwargs)
    return _controller


def get_admission_controller() -> AdmissionController:
    """Auto-creates with defaults (unlimited budgets, lenient
    thresholds): admission must never be the reason a proxy callback
    raises, and un-configured deployments admit everything."""
    global _controller
    if _controller is None:
        _controller = AdmissionController()
    return _controller


def _reset_admission_controller() -> None:
    global _controller
    _controller = None
