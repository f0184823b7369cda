"""The arithmetic of the end-to-end and per-layer metrics, on plain
records: percentiles, rates, per-request token gaps, and the union of
device intervals."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def tokens_in(chunks, t0: float, t1: float) -> list[tuple[float, int]]:
    """The (time, count) deliveries of a request inside [t0, t1)."""
    return [(t, n) for t, n in chunks if t0 <= t < t1]


def output_rate(requests, t0: float, t1: float) -> float:
    """Tokens delivered in [t0, t1) by every request, over its length."""
    n = sum(n for r in requests for _, n in tokens_in(r.chunks, t0, t1))
    return n / (t1 - t0)


def ttfts(requests, t0: float, t1: float) -> list[float]:
    """Seconds from due to first token, of every request whose first
    token came in [t0, t1)."""
    return [r.first_token_s - r.due_s for r in requests
            if r.first_token_s is not None and t0 <= r.first_token_s < t1]


def tpots(requests, t0: float, t1: float) -> list[float]:
    """(last - first token time) / (tokens - 1) over the tokens each
    request got in [t0, t1), for every request with at least 2 there."""
    out = []
    for r in requests:
        inside = tokens_in(r.chunks, t0, t1)
        n = sum(c for _, c in inside)
        if n >= 2:
            out.append((inside[-1][0] - inside[0][0]) / (n - 1))
    return out


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """The (start, end) stretches of [t0, t1) that no interval covers."""
    out = []
    at = t0
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(s, e) for s, e in out if e > s]


def clip(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """Intervals cut to [t0, t1), those outside dropped."""
    return [(max(s, t0), min(e, t1)) for s, e in intervals
            if e > t0 and s < t1]
