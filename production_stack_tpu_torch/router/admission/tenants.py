"""Per-tenant rate limiting primitives: token buckets + tenant state.

A tenant is whatever identity the operator keys budgets on — the
`x-tenant-id` header, the API key, or (fallback) the client IP
(resolution order in ``controller.resolve_tenant``). Each tenant owns
one :class:`TokenBucket` (requests/s budget with burst headroom) and an
in-flight concurrency counter; the controller consults both on every
proxied request BEFORE routing.

Clock discipline matches ``stats/request_stats.py`` /
``stats/health.py``: every interval is measured on ``time.monotonic()``
and every method takes an explicit ``now`` so tests pin the clock —
wall-clock reads never appear in this package (an NTP step must not
refill or starve a budget; pinned by test_admission.py).

Priorities form the shed ladder: under cluster backpressure the lowest
priority sheds first and ``interactive`` sheds last (FlowKV-style
load-aware admission; see controller.py for the thresholds).
"""
# stackcheck: monotonic-only — token-bucket refill is interval math;
# a wall-clock step would refill or drain whole budgets at once

from __future__ import annotations

import time
from dataclasses import dataclass, field

# shed order under overload: leftmost sheds first, rightmost last
PRIORITIES = ("batch", "normal", "interactive")

_PRIORITY_RANK = {name: i for i, name in enumerate(PRIORITIES)}


def priority_rank(name: str) -> int:
    """Ladder position (0 = sheds first). Unknown names rank as the
    default 'normal' so a typo'd header cannot self-promote a request
    above interactive traffic."""
    return _PRIORITY_RANK.get(name, _PRIORITY_RANK["normal"])


@dataclass(frozen=True)
class TenantLimits:
    """Operator-configured budget for one tenant (or the default).

    ``rate`` is the sustained admission budget in requests/s (0 =
    unlimited: no bucket is consulted). ``burst`` is the bucket
    capacity — how far above the sustained rate a quiet tenant may
    spike; 0 derives ``max(rate, 1)``. ``max_concurrency`` caps the
    tenant's simultaneously in-flight proxied requests (0 =
    unlimited)."""

    rate: float = 0.0
    burst: float = 0.0
    max_concurrency: int = 0
    priority: str = "normal"

    def effective_burst(self) -> float:
        return self.burst if self.burst > 0 else max(self.rate, 1.0)

    @staticmethod
    def from_dict(raw: dict) -> "TenantLimits":
        """Validating constructor for dynamic-config payloads: unknown
        keys, negative budgets, or an unknown priority raise ValueError
        so the watcher keeps the last-good config."""
        if not isinstance(raw, dict):
            raise ValueError(f"tenant limits must be a mapping, got {raw!r}")
        known = {"rate", "burst", "max_concurrency", "priority"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown tenant limit keys {sorted(unknown)}")
        limits = TenantLimits(
            rate=float(raw.get("rate", 0.0)),
            burst=float(raw.get("burst", 0.0)),
            max_concurrency=int(raw.get("max_concurrency", 0)),
            priority=str(raw.get("priority", "normal")),
        )
        if limits.rate < 0 or limits.burst < 0 or limits.max_concurrency < 0:
            raise ValueError(f"tenant limits must be >= 0: {raw!r}")
        if limits.priority not in PRIORITIES:
            raise ValueError(
                f"unknown priority {limits.priority!r}; "
                f"want one of {PRIORITIES}"
            )
        return limits


class TokenBucket:
    """Classic token bucket on a monotonic clock.

    Holds at most ``burst`` tokens, refilling at ``rate`` tokens/s.
    Admission costs 1 token per request. All methods take ``now``
    (``time.monotonic()`` domain) so refill math is deterministic under
    test."""

    __slots__ = ("rate", "burst", "tokens", "last_mono")

    def __init__(self, rate: float, burst: float, now: float) -> None:
        assert rate > 0 and burst > 0
        self.rate = rate
        self.burst = burst
        self.tokens = burst  # a fresh tenant starts with full burst
        self.last_mono = now

    # stackcheck: hot-path — called per proxied request at admission
    def _refill(self, now: float) -> None:
        if now > self.last_mono:
            self.tokens = min(
                self.burst, self.tokens + (now - self.last_mono) * self.rate
            )
            self.last_mono = now

    # stackcheck: hot-path — called per proxied request at admission
    def try_acquire(self, now: float, cost: float = 1.0) -> bool:
        self._refill(now)
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def deficit_s(self, now: float, cost: float = 1.0) -> float:
        """Seconds until ``cost`` tokens will have refilled (0 when
        they are already available) — the bucket half of Retry-After."""
        self._refill(now)
        missing = cost - self.tokens
        if missing <= 0:
            return 0.0
        return missing / self.rate

    @property
    def occupancy(self) -> float:
        """Fill fraction 0..1 at the last refill (1 = full budget)."""
        return self.tokens / self.burst if self.burst > 0 else 1.0


@dataclass
class TenantState:
    """Mutable per-tenant scoreboard row: the bucket, the in-flight
    counter the concurrency cap gates on, and shed/admit totals for
    /debug/admission + the admission metrics."""

    name: str
    limits: TenantLimits
    configured: bool = False  # named in config (metrics label by name)
    bucket: TokenBucket | None = None
    in_flight: int = 0
    admitted_total: int = 0
    shed_total: int = 0
    # admits whose request the router could not route (fleet asleep):
    # the bucket token was returned, see AdmissionController.refund
    refunded_total: int = 0
    sheds_by_reason: dict[str, int] = field(default_factory=dict)
    last_seen_mono: float = 0.0

    @staticmethod
    def build(
        name: str, limits: TenantLimits, now: float, configured: bool = False
    ) -> "TenantState":
        state = TenantState(name=name, limits=limits, configured=configured)
        if limits.rate > 0:
            state.bucket = TokenBucket(
                limits.rate, limits.effective_burst(), now
            )
        state.last_seen_mono = now
        return state

    def reconfigure(self, limits: TenantLimits, now: float) -> None:
        """Apply retuned limits in place, preserving the in-flight
        count (live requests must keep gating the concurrency cap) and
        the counters. The bucket restarts full at the new rate — an
        operator retune is a fresh budget, not a carried debt."""
        self.limits = limits
        self.bucket = (
            TokenBucket(limits.rate, limits.effective_burst(), now)
            if limits.rate > 0 else None
        )

    def to_dict(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        if self.bucket is not None:
            self.bucket._refill(now)
        return {
            "priority": self.limits.priority,
            "rate": self.limits.rate,
            "burst": (
                self.limits.effective_burst()
                if self.limits.rate > 0 else 0.0
            ),
            "max_concurrency": self.limits.max_concurrency,
            "configured": self.configured,
            "tokens": (
                round(self.bucket.tokens, 3)
                if self.bucket is not None else None
            ),
            "in_flight": self.in_flight,
            "admitted_total": self.admitted_total,
            "shed_total": self.shed_total,
            "refunded_total": self.refunded_total,
            "sheds_by_reason": dict(self.sheds_by_reason),
            "idle_s": round(now - self.last_seen_mono, 3),
        }
