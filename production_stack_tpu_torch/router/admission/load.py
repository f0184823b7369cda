"""Cluster load score: real backend-load signals folded into one number.

The admission controller must tighten BEFORE upstreams fall over, which
means the backpressure signal cannot be connect failures (those arrive
after the damage) — it has to be the live load surface the router
already maintains:

- the :class:`EngineHealthBoard`'s per-backend in-flight depth (every
  proxied request the router currently has open against each engine),
- the engine-stats scraper's queue depth (``vllm:num_requests_waiting``)
  and recent scheduling delay (windowed from the engines'
  ``tpu:scheduling_delay_seconds`` histogram — enqueue→admission wait
  is the earliest TTFT-blowup symptom, see the timeline events).

Sleeping/draining backends are EXCLUDED from the capacity denominator:
a fleet half-asleep has half the capacity, so the same absolute
in-flight/queue depth reads as twice the load and admission tightens
accordingly.

The score is normalized so 1.0 ≈ "the awake fleet is at its configured
target"; the controller's priority ladder sheds batch traffic first as
the score approaches the threshold and interactive traffic last.
"""
# stackcheck: monotonic-only — load-score smoothing is interval math;
# wall clock jumps would spike the backpressure signal

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class LoadSignals:
    """One computed load snapshot (also the /debug/admission payload)."""

    score: float = 0.0
    awake_backends: int = 0
    sleeping_backends: int = 0
    total_in_flight: int = 0
    total_queue_depth: int = 0
    max_scheduling_delay_s: float = 0.0
    # which signal produced the max (operator triage: WHAT saturated)
    dominant: str = "none"
    per_engine: list[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            # the +inf asleep-fleet sentinel maps to -1: json.dumps
            # would otherwise emit RFC-invalid `Infinity` and break
            # strict parsers on /debug/admission at exactly the moment
            # an operator is staring at a parked fleet (same mapping
            # as the admission_load_score gauge)
            "score": (
                round(self.score, 4)
                if self.score != float("inf") else -1.0
            ),
            "dominant_signal": self.dominant,
            "awake_backends": self.awake_backends,
            "sleeping_backends": self.sleeping_backends,
            "total_in_flight": self.total_in_flight,
            "total_queue_depth": self.total_queue_depth,
            "max_scheduling_delay_s": round(
                self.max_scheduling_delay_s, 4
            ),
            "per_engine": self.per_engine,
        }


# stackcheck: hot-path — recomputed (rate-limited) inside admission
def compute_load(
    endpoints,
    board,
    engine_stats: dict,
    inflight_target: int,
    queue_target: int,
    delay_target_s: float,
    detail: bool = False,
) -> LoadSignals:
    """Fold the live signals into one normalized cluster load score.

    ``endpoints`` is the discovered fleet (EndpointInfo, with
    ``sleep``), ``board`` the EngineHealthBoard, ``engine_stats`` the
    scraper's url→EngineStats map. Targets are PER-ENGINE: the score
    is max over the three signal families of
    ``total / (n_awake * target)``, except scheduling delay which is a
    per-engine worst (one saturated engine's admission stall is a
    cluster problem even when its siblings idle).

    No discovered endpoints at all (startup, discovery outage) scores
    0.0 — admission must not shed while the router is still finding
    its fleet. A discovered-but-fully-asleep fleet scores +inf; the
    request path turns that into the distinct ``fleet_asleep`` shed.
    """
    sig = LoadSignals()
    if not endpoints:
        return sig
    awake = [e for e in endpoints if not e.sleep]
    sig.awake_backends = len(awake)
    sig.sleeping_backends = len(endpoints) - len(awake)
    if not awake:
        sig.score = float("inf")
        sig.dominant = "fleet_asleep"
        return sig
    max_delay = 0.0
    for ep in awake:
        row = board.get(ep.url)
        in_flight = row.in_flight if row is not None else 0
        es = engine_stats.get(ep.url)
        queue = es.num_queuing_requests if es is not None else 0
        delay = (
            es.recent_scheduling_delay_s if es is not None else 0.0
        )
        sig.total_in_flight += in_flight
        sig.total_queue_depth += queue
        if delay > max_delay:
            max_delay = delay
        if detail:
            sig.per_engine.append({
                "url": ep.url,
                "in_flight": in_flight,
                "queue_depth": queue,
                "scheduling_delay_s": round(delay, 4),
            })
    sig.max_scheduling_delay_s = max_delay
    n = len(awake)
    candidates = (
        ("in_flight", sig.total_in_flight / (n * inflight_target)
         if inflight_target > 0 else 0.0),
        ("queue_depth", sig.total_queue_depth / (n * queue_target)
         if queue_target > 0 else 0.0),
        ("scheduling_delay", max_delay / delay_target_s
         if delay_target_s > 0 else 0.0),
    )
    for name, value in candidates:
        if value > sig.score:
            sig.score = value
            sig.dominant = name
    return sig
