"""Per-tenant SLO tracking: objectives, error budgets, burn rates.

The stack measures everything (PhaseClock phases, engine timelines,
admission sheds) but — before this module — judged nothing: there was
no notion of a per-tenant TTFT/ITL objective and no error-budget burn
signal. The :class:`SLOTracker` closes that loop: every proxied
request is evaluated against the per-(tenant, model) objectives the
operator declares in the dynamic config's ``slo:`` section, and the
rolling violation fractions become the SRE-standard multi-window burn
rates (fast ~5m / slow ~1h) that alerting and admission consume.

Objectives (per configured tenant, optionally per model):

- ``ttft_p99_s`` / ``itl_p99_s`` / ``e2e_p99_s``: latency thresholds —
  a SERVED request violates when it exceeds the threshold; the
  compliance target (default 0.99, the "p99" in the name) sets the
  error budget ``1 - target``.
- ``error_rate``: the tolerated upstream-error fraction (5xx /
  unreachable backend). Client aborts and admission sheds do NOT
  count — they are not the fleet failing the tenant.
- ``availability``: the target fraction of requests actually SERVED —
  sheds and errors both violate. This is the tenant's own view of
  "did my request go through"; it is deliberately EXCLUDED from the
  admission shed signal (``shed_burn``), otherwise shedding a burning
  tenant would raise its burn and lock the shed in (death spiral).

Burn rate = (observed violation fraction over a window) / (error
budget fraction). 1.0 = consuming the budget exactly at the rate that
exhausts it over the window; the classic multi-window alert pairs a
fast and a slow window so a spike pages only while it is still
happening (observability/tpu-stack-alerts.yaml carries the rules).

Clock discipline matches ``stats/request_stats.py`` / the admission
package: every interval is measured on ``time.monotonic()`` and every
method takes an explicit ``now`` so tests pin the clock — wall-clock
reads never appear in this module (an NTP step must not burn or refill
an error budget; pinned by tests/test_slo.py).

Hot-path contract: an SLOTracker with ZERO configured objectives does
zero per-request work — ``observe_request`` / ``observe_shed`` /
``shed_burn`` return before touching the clock or any state (pinned by
tests/test_slo.py with a poisoned clock). Windows are time-bucketed
count rings (no per-request allocations survive the call); burn reads
on the admission path are cached per row with a 1 s max age.

Threading: all mutation happens on the router's single event loop
(proxy callbacks + log_stats render), mirroring ``EngineHealthBoard``
— no locks on the hot path.
"""
# stackcheck: monotonic-only — burn-rate and error-budget refill math
# must never ride wall-clock steps (NTP slew corrupts the budgets)

from __future__ import annotations

import math
import time
from dataclasses import dataclass

# no cycle: metrics_service depends only on utils/prometheus.py
from production_stack_tpu_torch.router.services.metrics_service import (
    observe_slo_violations,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# objective order also fixes the ring's slot layout: 2 slots per
# objective (requests counted, violations) — see _BucketRing
OBJECTIVES = ("ttft", "itl", "e2e", "error_rate", "availability")
_OBJ_INDEX = {name: 2 * i for i, name in enumerate(OBJECTIVES)}
_NSLOTS = 2 * len(OBJECTIVES)

# idle UNCONFIGURED-tenant rows (default-matched identities) are
# pruned after this long so a scanning client cannot grow the row
# table without bound (same hygiene as admission's tenant prune)
ROW_IDLE_PRUNE_S = 900.0

# metrics label for tenants matched only by the `default` objective
# (IP/API-key fallback identities must not explode the label set)
OTHER_TENANT_LABEL = "(other)"

# per-row fast-burn cache age: the admission path consults shed_burn
# per request — recomputing the window sum at most once a second keeps
# admit() O(1) at high RPS while staying fresher than the fast window
BURN_CACHE_MAX_AGE_S = 1.0

_EMPTY: tuple[str, ...] = ()


@dataclass(frozen=True)
class SLOObjective:
    """One tenant's (or tenant/model's) declared objectives. A zero
    threshold means "not tracked" for that dimension."""

    ttft_p99_s: float = 0.0
    itl_p99_s: float = 0.0
    e2e_p99_s: float = 0.0
    error_rate: float = 0.0     # tolerated error fraction (the budget)
    availability: float = 0.0   # target served fraction
    target: float = 0.99        # compliance target for latency objectives

    @staticmethod
    def from_dict(raw: dict) -> "SLOObjective":
        """Validating constructor for dynamic-config payloads: unknown
        keys or out-of-range values raise ValueError so the watcher
        keeps the last-good config."""
        if not isinstance(raw, dict):
            raise ValueError(
                f"slo objective must be a mapping, got {raw!r}"
            )
        known = {"ttft_p99_s", "itl_p99_s", "e2e_p99_s", "error_rate",
                 "availability", "target"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"unknown slo objective keys {sorted(unknown)}"
            )
        obj = SLOObjective(
            ttft_p99_s=float(raw.get("ttft_p99_s", 0.0)),
            itl_p99_s=float(raw.get("itl_p99_s", 0.0)),
            e2e_p99_s=float(raw.get("e2e_p99_s", 0.0)),
            error_rate=float(raw.get("error_rate", 0.0)),
            availability=float(raw.get("availability", 0.0)),
            target=float(raw.get("target", 0.99)),
        )
        for key in ("ttft_p99_s", "itl_p99_s", "e2e_p99_s"):
            if getattr(obj, key) < 0:
                raise ValueError(f"slo {key} must be >= 0")
        if not 0.0 <= obj.error_rate < 1.0:
            raise ValueError("slo error_rate must be in [0, 1)")
        if obj.availability and not 0.0 < obj.availability < 1.0:
            raise ValueError("slo availability must be in (0, 1)")
        if not 0.0 < obj.target < 1.0:
            raise ValueError("slo target must be in (0, 1)")
        if not obj.tracked():
            raise ValueError(
                "slo objective tracks nothing: set at least one of "
                "ttft_p99_s/itl_p99_s/e2e_p99_s/error_rate/availability"
            )
        return obj

    def tracked(self) -> tuple[str, ...]:
        out = []
        if self.ttft_p99_s > 0:
            out.append("ttft")
        if self.itl_p99_s > 0:
            out.append("itl")
        if self.e2e_p99_s > 0:
            out.append("e2e")
        if self.error_rate > 0:
            out.append("error_rate")
        if self.availability > 0:
            out.append("availability")
        return tuple(out)

    def budget_fraction(self, objective: str) -> float:
        """The error budget: the fraction of requests allowed to
        violate this objective before the SLO is broken."""
        if objective == "error_rate":
            return self.error_rate
        if objective == "availability":
            return 1.0 - self.availability
        return 1.0 - self.target


class _BucketRing:
    """Time-bucketed violation counters on a monotonic clock.

    One ring covers BOTH windows: granularity is sized off the fast
    window (fast/20), capacity off the slow window — the fast window
    reads the newest buckets, the slow window the whole ring. Buckets
    are recycled lazily by granule id, so idle tenants cost nothing."""

    __slots__ = ("granule_s", "n", "ids", "counts")

    def __init__(self, fast_window_s: float, slow_window_s: float) -> None:
        self.granule_s = max(1.0, fast_window_s / 20.0)
        # stackcheck: disable=device-sync-transitive — the router holds no
        # device value: host float math
        self.n = int(math.ceil(slow_window_s / self.granule_s)) + 1
        self.ids = [-1] * self.n
        self.counts = [[0.0] * _NSLOTS for _ in range(self.n)]

    # stackcheck: hot-path — one call per tracked proxied request
    def bucket(self, now: float) -> list[float]:
        # stackcheck: disable=device-sync-hot — the router holds no device
        # value: host float math
        gid = int(now // self.granule_s)
        i = gid % self.n
        if self.ids[i] != gid:
            self.ids[i] = gid
            c = self.counts[i]
            for j in range(_NSLOTS):
                c[j] = 0.0
        return self.counts[i]

    def window_sums(self, now: float, window_s: float) -> list[float]:
        gid_now = int(now // self.granule_s)
        first = gid_now - max(
            1, int(math.ceil(window_s / self.granule_s))
        ) + 1
        out = [0.0] * _NSLOTS
        for i in range(self.n):
            gid = self.ids[i]
            if first <= gid <= gid_now:
                c = self.counts[i]
                for j in range(_NSLOTS):
                    out[j] += c[j]
        return out


class _SLORow:
    """Mutable per-(tenant, model) scoreboard row."""

    __slots__ = ("tenant", "model", "label", "spec", "configured",
                 "ring", "violations_total", "requests_total",
                 "last_seen_mono", "_burn_stamp", "_burn_value",
                 "_fast_s")

    def __init__(
        self, tenant: str, model: str, label: str, spec: SLOObjective,
        configured: bool, fast_s: float, slow_s: float, now: float,
    ) -> None:
        self.tenant = tenant
        self.model = model
        self.label = label
        self.spec = spec
        self.configured = configured
        self.ring = _BucketRing(fast_s, slow_s)
        self._fast_s = fast_s
        self.violations_total: dict[str, int] = {}
        self.requests_total = 0
        self.last_seen_mono = now
        self._burn_stamp: float | None = None
        self._burn_value = 0.0

    def window_view(self, now: float, window_s: float) -> dict[str, dict]:
        """Per-objective (n, bad, bad_frac, burn) over one window."""
        sums = self.ring.window_sums(now, window_s)
        out = {}
        for name in self.spec.tracked():
            i = _OBJ_INDEX[name]
            n, bad = sums[i], sums[i + 1]
            frac = (bad / n) if n > 0 else 0.0
            budget = self.spec.budget_fraction(name)
            out[name] = {
                # stackcheck: disable=device-sync-transitive — the router holds
                # no device value: host float math
                "requests": int(n),
                # stackcheck: disable=device-sync-transitive — (as above)
                "violations": int(bad),
                "violation_fraction": round(frac, 6),
                "burn_rate": round(frac / budget, 4) if budget > 0
                else 0.0,
            }
        return out

    # stackcheck: hot-path — cached read on the admission decision path
    def shed_burn(self, now: float) -> float:
        """Max fast-window burn across the SERVED-quality objectives
        (latency + error_rate). ``availability`` is excluded by design:
        sheds feed it, so including it would make the shed signal
        self-sustaining. Cached — the admission path reads this per
        request."""
        if (
            self._burn_stamp is not None
            and now - self._burn_stamp < BURN_CACHE_MAX_AGE_S
        ):
            return self._burn_value
        burn = 0.0
        for name, view in self.window_view(now, self._fast_s).items():
            if name != "availability" and view["burn_rate"] > burn:
                burn = view["burn_rate"]
        self._burn_stamp = now
        self._burn_value = burn
        return burn


class SLOTracker:
    """Evaluates every proxied request against per-(tenant, model)
    objectives and exposes burn rates; one per router."""

    def __init__(
        self,
        enabled: bool = True,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        shed_burn_threshold: float = 0.0,
    ) -> None:
        self.enabled = enabled
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        # fast-window burn at which the admission controller starts
        # shedding the tenant's batch/normal traffic (0 = off)
        self.shed_burn_threshold = shed_burn_threshold
        # config key -> spec; keys are "tenant", "tenant/model", or
        # "default" (matched for ANY tenant, folded to "(other)")
        self._objectives: dict[str, SLOObjective] = {}
        self._configured_tenants: set[str] = set()
        self._rows: dict[tuple[str, str], _SLORow] = {}
        # per-tenant shed_burn memo (stamp, value): admit() consults
        # the signal per request, and recomputing means iterating the
        # row table — cache at the same 1s age as the per-row burn
        self._burn_cache: dict[str, tuple[float, float | None]] = {}

    # -- activation / lookup ------------------------------------------------
    @property
    def active(self) -> bool:
        return self.enabled and bool(self._objectives)

    # stackcheck: hot-path — per-request objective lookup, O(1)
    def _match(self, tenant: str, model: str) -> SLOObjective | None:
        objectives = self._objectives
        spec = objectives.get(f"{tenant}/{model}")
        if spec is None:
            spec = objectives.get(tenant)
        if spec is None:
            spec = objectives.get("default")
        return spec

    def _row(
        self, tenant: str, model: str, spec: SLOObjective, now: float
    ) -> _SLORow:
        key = (tenant, model)
        row = self._rows.get(key)
        # value comparison, not identity: re-applying an UNCHANGED
        # objectives map must not reset a tenant's window history
        if row is None or row.spec != spec:
            configured = tenant in self._configured_tenants
            row = _SLORow(
                tenant, model,
                tenant if configured else OTHER_TENANT_LABEL,
                spec, configured,
                self.fast_window_s, self.slow_window_s, now,
            )
            self._rows[key] = row
        row.last_seen_mono = now
        return row

    # -- the per-request feed ----------------------------------------------
    # stackcheck: hot-path — called from the proxy hot path on every
    # finished request; MUST return before touching the clock or any
    # state when no objectives are configured
    def observe_request(
        self,
        tenant: str | None,
        model: str | None,
        ok: bool,
        e2e_s: float | None = None,
        ttft_s: float | None = None,
        itl_s: float | None = None,
        now: float | None = None,
    ) -> tuple[str, ...]:
        """Fold one finished proxied request into the tenant's windows.

        Returns the tuple of objective names this request VIOLATED
        (empty for untracked tenants), so the caller can export
        ``slo_violation`` span events without a second lookup.

        ``ok`` is the upstream outcome (False = engine fault: 5xx or
        unreachable). Latency objectives only evaluate SERVED requests
        — an errored request counts against ``error_rate`` /
        ``availability`` instead of polluting the latency windows with
        fast-fail timings.

        ``availability`` is evaluated TENANT-scoped (the model-less
        row): admission sheds land there before routing ever resolves
        a model, so served requests must share that window or the
        violation fraction would read 100% from one shed forever
        (sheds in a pure-shed row, served requests elsewhere). The
        latency/error objectives stay per-(tenant, model)."""
        if not self.enabled or not self._objectives:
            return _EMPTY
        tenant = tenant or "(anonymous)"
        model = model or ""
        spec = self._match(tenant, model)
        if spec is None:
            return _EMPTY
        now = time.monotonic() if now is None else now
        violated: list[str] = []
        label = None

        def count(row, bucket, name: str, value_bad: bool) -> None:
            i = _OBJ_INDEX[name]
            bucket[i] += 1.0
            if value_bad:
                bucket[i + 1] += 1.0
                violated.append(name)
                row.violations_total[name] = (
                    row.violations_total.get(name, 0) + 1
                )

        per_model = (
            (ok and (spec.ttft_p99_s > 0 or spec.itl_p99_s > 0
                     or spec.e2e_p99_s > 0))
            or spec.error_rate > 0
        )
        if per_model:
            row = self._row(tenant, model, spec, now)
            bucket = row.ring.bucket(now)
            row.requests_total += 1
            label = row.label
            if ok:
                if spec.ttft_p99_s > 0 and ttft_s is not None:
                    count(row, bucket, "ttft",
                          ttft_s > spec.ttft_p99_s)
                if spec.itl_p99_s > 0 and itl_s is not None:
                    count(row, bucket, "itl", itl_s > spec.itl_p99_s)
                if spec.e2e_p99_s > 0 and e2e_s is not None:
                    count(row, bucket, "e2e", e2e_s > spec.e2e_p99_s)
            if spec.error_rate > 0:
                count(row, bucket, "error_rate", not ok)
        # availability: the tenant-wide row (matched by the "tenant" /
        # "default" keys — a per-model override cannot scope it)
        aspec = spec if model == "" else (
            self._objectives.get(tenant)
            or self._objectives.get("default")
        )
        if aspec is not None and aspec.availability > 0:
            arow = self._row(tenant, "", aspec, now)
            if not per_model:
                # the request touched no other row: count it here so
                # every observed request lands on exactly one row
                arow.requests_total += 1
            count(arow, arow.ring.bucket(now), "availability", not ok)
            label = label or arow.label
        if violated:
            observe_slo_violations(label, violated)
        return tuple(violated)

    # stackcheck: hot-path — called on the shed path (already a 429)
    def observe_shed(
        self, tenant: str | None, now: float | None = None
    ) -> None:
        """An admission shed counts ONLY against ``availability`` (the
        tenant's requests are not being served) — never against the
        latency/error objectives that feed the shed signal back into
        admission."""
        if not self.enabled or not self._objectives:
            return
        tenant = tenant or "(anonymous)"
        spec = self._match(tenant, "")
        # a shed happens before routing resolves the model: fold it
        # into the tenant-wide row (model "")
        if spec is None or spec.availability <= 0:
            return
        now = time.monotonic() if now is None else now
        row = self._row(tenant, "", spec, now)
        bucket = row.ring.bucket(now)
        i = _OBJ_INDEX["availability"]
        bucket[i] += 1.0
        bucket[i + 1] += 1.0
        row.violations_total["availability"] = (
            row.violations_total.get("availability", 0) + 1
        )
        observe_slo_violations(row.label, ("availability",))

    # -- the admission shed signal -----------------------------------------
    # stackcheck: hot-path — consulted inside AdmissionController.admit
    def shed_burn(
        self, tenant: str, now: float | None = None
    ) -> float | None:
        """The tenant's max fast-window burn across its latency/error
        objectives — the SLO-budget signal: a tenant burning
        its own budget sheds its batch/normal traffic BEFORE the
        cluster-load ladder fires. Returns None when the signal is off
        (no threshold, tracker disabled, or tenant untracked)."""
        if (
            self.shed_burn_threshold <= 0
            or not self.enabled
            or not self._objectives
        ):
            return None
        now = time.monotonic() if now is None else now
        cached = self._burn_cache.get(tenant)
        if cached is not None and now - cached[0] < BURN_CACHE_MAX_AGE_S:
            return cached[1]
        burn = None
        for (row_tenant, _model), row in self._rows.items():
            if row_tenant != tenant:
                continue
            value = row.shed_burn(now)
            if burn is None or value > burn:
                burn = value
        self._burn_cache[tenant] = (now, burn)
        return burn

    # -- live-reload (dynamic_config.py) ------------------------------------
    def apply_config(self, raw: dict) -> None:
        """Atomically apply an ``slo:`` section from the dynamic config
        file. Validates EVERYTHING before touching any state so a
        malformed payload keeps the last-good config (the watcher
        catches the raise). Shape::

            slo:
              enabled: true
              fast_window_s: 300
              slow_window_s: 3600
              shed_burn_threshold: 0   # 0 = no SLO-driven shedding
              objectives:
                team-a: {ttft_p99_s: 0.5, error_rate: 0.01}
                team-a/big-model: {ttft_p99_s: 2.0, target: 0.99}
                default: {availability: 0.999}
        """
        if not isinstance(raw, dict):
            raise ValueError(f"slo config must be a mapping, got {raw!r}")
        known = {"enabled", "fast_window_s", "slow_window_s",
                 "shed_burn_threshold", "objectives"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown slo config keys {sorted(unknown)}")
        fast = float(raw.get("fast_window_s", self.fast_window_s))
        slow = float(raw.get("slow_window_s", self.slow_window_s))
        if fast <= 0 or slow <= 0:
            raise ValueError("slo windows must be > 0 seconds")
        if slow < fast:
            raise ValueError(
                f"slo slow_window_s ({slow:g}) must be >= "
                f"fast_window_s ({fast:g})"
            )
        threshold = float(
            raw.get("shed_burn_threshold", self.shed_burn_threshold)
        )
        if threshold < 0:
            raise ValueError("slo shed_burn_threshold must be >= 0")
        objectives = (
            {
                str(key): SLOObjective.from_dict(spec)
                for key, spec in (raw["objectives"] or {}).items()
            }
            if "objectives" in raw else self._objectives
        )
        for key, spec in objectives.items():
            # availability is TENANT-scoped by design (sheds land
            # before routing resolves a model — see observe_request):
            # a per-model availability objective would validate but
            # never be evaluated, so reject it loudly instead
            if "/" in key and spec.availability > 0:
                raise ValueError(
                    f"slo objective {key!r}: availability cannot be "
                    "model-scoped — declare it on the tenant key "
                    f"({key.split('/', 1)[0]!r})"
                )
        # -- validated: swap atomically --
        windows_changed = (
            fast != self.fast_window_s or slow != self.slow_window_s
        )
        self.enabled = bool(raw.get("enabled", self.enabled))
        self.fast_window_s = fast
        self.slow_window_s = slow
        self.shed_burn_threshold = threshold
        self._objectives = objectives
        self._configured_tenants = {
            key.split("/", 1)[0]
            for key in objectives if key != "default"
        }
        self._burn_cache.clear()
        if windows_changed:
            # the rings are sized off the windows: a retune restarts
            # measurement (an operator retune is a fresh budget)
            self._rows.clear()
        else:
            # rows whose spec was dropped or CHANGED are dropped now,
            # history included: an operator retuning an objective is
            # declaring a fresh budget, and a stale row must not keep
            # feeding shed_burn the old spec's violations (a tenant
            # whose batch traffic is being shed sends no served
            # requests to rebuild the row lazily). Unchanged specs
            # compare equal and keep their window history.
            for key, row in list(self._rows.items()):
                if self._match(row.tenant, row.model) != row.spec:
                    del self._rows[key]
        logger.info(
            "slo config applied: %d objectives, windows %gs/%gs, "
            "shed_burn_threshold=%g, enabled=%s",
            len(objectives), fast, slow, threshold, self.enabled,
        )

    # -- housekeeping / export ----------------------------------------------
    def prune(self, now: float | None = None) -> list[tuple[str, str]]:
        """Drop idle UNCONFIGURED rows (default-matched identities) so
        a scanning client cannot grow the row table without bound.
        Called off the hot path (log_stats render)."""
        now = time.monotonic() if now is None else now
        dropped = []
        for key, row in list(self._rows.items()):
            if row.configured:
                continue
            if now - row.last_seen_mono >= ROW_IDLE_PRUNE_S:
                del self._rows[key]
                dropped.append(key)
        # the shed_burn memo is keyed by tenant IDENTITY (including
        # the ip:/key: fallbacks): stale entries are recomputed on the
        # next read anyway, so dropping them here bounds the dict — a
        # scanning client cycling source IPs must not grow it forever
        for tenant, (stamp, _value) in list(self._burn_cache.items()):
            if now - stamp >= BURN_CACHE_MAX_AGE_S:
                del self._burn_cache[tenant]
        return dropped

    def export_gauges(self, now: float | None = None) -> None:
        """Refresh the slo_* gauges on /metrics render (mirrors the
        health-board gauge push in stats/log_stats.py). Labels stay
        (tenant, objective): a tenant with several model rows exports
        its WORST row per objective — the conservative read an alert
        should fire on."""
        from production_stack_tpu_torch.router.services.metrics_service import (
            slo_budget_remaining,
            slo_burn_rate,
            slo_compliance_ratio,
        )

        if not self._rows:
            return
        now = time.monotonic() if now is None else now
        # (label, objective) -> [compliance, budget_remaining,
        #                        burn_fast, burn_slow]
        agg: dict[tuple[str, str], list[float]] = {}
        for row in self._rows.values():
            fast = row.window_view(now, self.fast_window_s)
            slow = row.window_view(now, self.slow_window_s)
            for name in row.spec.tracked():
                compliance = 1.0 - fast[name]["violation_fraction"]
                burn_fast = fast[name]["burn_rate"]
                burn_slow = slow[name]["burn_rate"]
                remaining = max(0.0, 1.0 - burn_slow)
                key = (row.label, name)
                cur = agg.get(key)
                if cur is None:
                    agg[key] = [compliance, remaining,
                                burn_fast, burn_slow]
                else:
                    cur[0] = min(cur[0], compliance)
                    cur[1] = min(cur[1], remaining)
                    cur[2] = max(cur[2], burn_fast)
                    cur[3] = max(cur[3], burn_slow)
        for (label, name), vals in agg.items():
            slo_compliance_ratio.labels(
                tenant=label, objective=name).set(vals[0])
            slo_budget_remaining.labels(
                tenant=label, objective=name).set(vals[1])
            slo_burn_rate.labels(
                tenant=label, objective=name, window="fast"
            ).set(vals[2])
            slo_burn_rate.labels(
                tenant=label, objective=name, window="slow"
            ).set(vals[3])

    def snapshot(self, now: float | None = None) -> dict:
        """The /debug/slo payload."""
        now = time.monotonic() if now is None else now
        rows = []
        for (tenant, model), row in sorted(self._rows.items()):
            rows.append({
                "tenant": tenant,
                "model": model or None,
                "label": row.label,
                "configured": row.configured,
                "requests_total": row.requests_total,
                "violations_total": dict(row.violations_total),
                "objectives": {
                    "ttft_p99_s": row.spec.ttft_p99_s or None,
                    "itl_p99_s": row.spec.itl_p99_s or None,
                    "e2e_p99_s": row.spec.e2e_p99_s or None,
                    "error_rate": row.spec.error_rate or None,
                    "availability": row.spec.availability or None,
                    "target": row.spec.target,
                },
                "fast": row.window_view(now, self.fast_window_s),
                "slow": row.window_view(now, self.slow_window_s),
                "idle_s": round(now - row.last_seen_mono, 3),
            })
        return {
            "enabled": self.enabled,
            "active": self.active,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "shed_burn_threshold": self.shed_burn_threshold,
            "objectives": {
                key: {
                    field: getattr(spec, field)
                    for field in ("ttft_p99_s", "itl_p99_s", "e2e_p99_s",
                                  "error_rate", "availability", "target")
                    if getattr(spec, field)
                }
                for key, spec in sorted(self._objectives.items())
            },
            "tenants": rows,
        }


# -- singleton lifecycle -----------------------------------------------------
_tracker: SLOTracker | None = None


def initialize_slo_tracker(**kwargs) -> SLOTracker:
    global _tracker
    _tracker = SLOTracker(**kwargs)
    return _tracker


def get_slo_tracker() -> SLOTracker:
    """Auto-creates with defaults (no objectives): SLO tracking must
    never be the reason a proxy callback raises, and un-configured
    deployments track nothing at zero cost."""
    global _tracker
    if _tracker is None:
        _tracker = SLOTracker()
    return _tracker


def _reset_slo_tracker() -> None:
    global _tracker
    _tracker = None
