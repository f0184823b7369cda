"""Per-engine request statistics from the router's own proxy callbacks.

Parity: reference src/vllm_router/stats/request_stats.py —
MovingAverageMonitor:97, RequestStatsMonitor:145 with on_new_request:186 /
on_request_response:219 / on_request_complete:250, the prefill-TPS estimator
built on a union of overlapping prefill time periods (_calc_engine_prefill_tps
:363), and uncomputed-prefix-token accounting (:384) that feeds the TTFT
router.

Clock discipline (mirrors tracing/spans.py): every interval —
sliding-window expiry, TTFT, ITL, latency, prefill-period unions — is
measured on ``time.monotonic()``; a wall-clock step (NTP slew, manual
set) must never expire a whole window or mint a negative TTFT. Callers
either omit the timestamp (monotonic now) or pass stamps from ONE
consistent clock; nothing here exports epoch time.
"""
# stackcheck: monotonic-only — QPS/TTFT/prefill-TPS interval math must
# never ride wall-clock steps (NTP slew corrupts the windows)

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass


@dataclass
class RequestStats:
    qps: float = 0.0
    ttft: float = -1.0  # average over window; -1 = no data
    in_prefill_requests: int = 0
    in_decoding_requests: int = 0
    finished_requests: int = 0
    uncomputed_prefix_tokens: int = 0
    prefill_tps: float = -1.0  # tokens/s the engine prefills; -1 = no data
    avg_decoding_length: float = -1.0
    avg_latency: float = -1.0
    avg_itl: float = -1.0  # inter-token latency


class MovingAverageMonitor:
    """Sliding-window average of timestamped values."""

    def __init__(self, window_s: float):
        self.window_s = window_s
        self._points: deque[tuple[float, float]] = deque()

    def update(self, timestamp: float, value: float) -> None:
        self._points.append((timestamp, value))
        self._expire(timestamp)

    def _expire(self, now: float) -> None:
        while self._points and self._points[0][0] < now - self.window_s:
            self._points.popleft()

    def average(self, now: float | None = None) -> float:
        if now is not None:
            self._expire(now)
        if not self._points:
            return -1.0
        return sum(v for _, v in self._points) / len(self._points)

    def count(self, now: float | None = None) -> int:
        if now is not None:
            self._expire(now)
        return len(self._points)

    def rate(self, now: float | None = None) -> float:
        """Events per second over the window."""
        if now is not None:
            self._expire(now)
        return len(self._points) / self.window_s


class TimePeriods:
    """Union-of-intervals length (overlapping prefill periods count once)."""

    def __init__(self) -> None:
        self.periods: list[tuple[float, float]] = []

    def add(self, start: float, end: float) -> None:
        if end > start:
            self.periods.append((start, end))

    def union_length(self) -> float:
        if not self.periods:
            return 0.0
        merged = 0.0
        cur_s, cur_e = None, None
        for s, e in sorted(self.periods):
            if cur_s is None:
                cur_s, cur_e = s, e
            elif s <= cur_e:
                cur_e = max(cur_e, e)
            else:
                merged += cur_e - cur_s
                cur_s, cur_e = s, e
        if cur_s is not None:
            merged += cur_e - cur_s
        return merged


class RequestStatsMonitor:
    def __init__(self, sliding_window_s: float = 60.0):
        self.window_s = sliding_window_s
        # url -> monitors
        self._qps: dict[str, MovingAverageMonitor] = {}
        self._ttft: dict[str, MovingAverageMonitor] = {}
        self._latency: dict[str, MovingAverageMonitor] = {}
        self._decode_len: dict[str, MovingAverageMonitor] = {}
        self._itl: dict[str, MovingAverageMonitor] = {}
        # (url, request_id) -> (arrival_ts, num_prompt_tokens)
        self._in_prefill: dict[tuple[str, str], tuple[float, int]] = {}
        # (url, request_id) -> (first_token_ts, n_tokens_so_far)
        self._in_decode: dict[tuple[str, str], tuple[float, int]] = {}
        self._finished: dict[str, int] = {}
        # completed prefills per engine: (start, end, prompt_tokens)
        self._prefill_history: dict[
            str, deque[tuple[float, float, int]]
        ] = {}
        self.first_query_time: float | None = None

    def _mon(self, d: dict[str, MovingAverageMonitor],
             url: str) -> MovingAverageMonitor:
        if url not in d:
            d[url] = MovingAverageMonitor(self.window_s)
        return d[url]

    # -- proxy callbacks ---------------------------------------------------
    def on_new_request(
        self, engine_url: str, request_id: str,
        timestamp: float | None = None, num_prompt_tokens: int = 0,
    ) -> None:
        """timestamp, when given, must be time.monotonic()-domain (as
        must every other explicit stamp passed to this monitor)."""
        ts = timestamp if timestamp is not None else time.monotonic()
        if self.first_query_time is None:
            self.first_query_time = ts
        self._mon(self._qps, engine_url).update(ts, 1.0)
        self._in_prefill[(engine_url, request_id)] = (ts, num_prompt_tokens)

    def on_request_response(
        self, engine_url: str, request_id: str,
        timestamp: float | None = None,
    ) -> None:
        """First token received -> request moves prefill -> decode."""
        ts = timestamp if timestamp is not None else time.monotonic()
        key = (engine_url, request_id)
        entry = self._in_prefill.pop(key, None)
        if entry is None:
            return
        arrival, n_tokens = entry
        self._mon(self._ttft, engine_url).update(ts, ts - arrival)
        self._in_decode[key] = (ts, 0)
        hist = self._prefill_history.setdefault(engine_url, deque())
        hist.append((arrival, ts, n_tokens))
        while hist and hist[0][1] < ts - self.window_s:
            hist.popleft()

    def on_token(self, engine_url: str, request_id: str,
                 timestamp: float | None = None) -> None:
        key = (engine_url, request_id)
        if key in self._in_decode:
            first_ts, n = self._in_decode[key]
            self._in_decode[key] = (first_ts, n + 1)

    def on_request_complete(
        self, engine_url: str, request_id: str,
        timestamp: float | None = None,
    ) -> None:
        ts = timestamp if timestamp is not None else time.monotonic()
        key = (engine_url, request_id)
        # a request may complete straight from prefill (e.g. PD prefill pass)
        pre = self._in_prefill.pop(key, None)
        dec = self._in_decode.pop(key, None)
        self._finished[engine_url] = self._finished.get(engine_url, 0) + 1
        if dec is not None:
            first_ts, n_tokens = dec
            self._mon(self._decode_len, engine_url).update(ts, n_tokens)
            if n_tokens > 1:
                self._mon(self._itl, engine_url).update(
                    ts, (ts - first_ts) / (n_tokens - 1)
                )
            self._mon(self._latency, engine_url).update(ts, ts - first_ts)
        elif pre is not None:
            self._mon(self._latency, engine_url).update(ts, ts - pre[0])

    def on_request_swapped(self, engine_url: str, request_id: str) -> None:
        """Kept for reference API parity (engine-side preemption signal)."""

    # -- queries -----------------------------------------------------------
    def _calc_engine_prefill_tps(self, url: str, now: float) -> float:
        hist = self._prefill_history.get(url)
        if not hist:
            return -1.0
        periods = TimePeriods()
        tokens = 0
        for start, end, n in hist:
            if end < now - self.window_s:
                continue
            periods.add(start, end)
            tokens += n
        dur = periods.union_length()
        if dur <= 0 or tokens <= 0:
            return -1.0
        return tokens / dur

    def _uncomputed_prefix_tokens(self, url: str) -> int:
        return sum(
            n for (u, _), (_, n) in self._in_prefill.items() if u == url
        )

    def get_request_stats(
        self, current_time: float | None = None
    ) -> dict[str, RequestStats]:
        now = current_time if current_time is not None else time.monotonic()
        urls = (
            set(self._qps)
            | {u for u, _ in self._in_prefill}
            | {u for u, _ in self._in_decode}
            | set(self._finished)
        )
        out: dict[str, RequestStats] = {}
        for url in urls:
            qps_mon = self._qps.get(url)
            out[url] = RequestStats(
                qps=qps_mon.rate(now) if qps_mon else 0.0,
                ttft=(
                    self._ttft[url].average(now)
                    if url in self._ttft
                    else -1.0
                ),
                in_prefill_requests=sum(
                    1 for (u, _) in self._in_prefill if u == url
                ),
                in_decoding_requests=sum(
                    1 for (u, _) in self._in_decode if u == url
                ),
                finished_requests=self._finished.get(url, 0),
                uncomputed_prefix_tokens=self._uncomputed_prefix_tokens(url),
                prefill_tps=self._calc_engine_prefill_tps(url, now),
                avg_decoding_length=(
                    self._decode_len[url].average(now)
                    if url in self._decode_len
                    else -1.0
                ),
                avg_latency=(
                    self._latency[url].average(now)
                    if url in self._latency
                    else -1.0
                ),
                avg_itl=(
                    self._itl[url].average(now)
                    if url in self._itl
                    else -1.0
                ),
            )
        return out

    def get_health(self) -> bool:
        return True


_monitor: RequestStatsMonitor | None = None


def initialize_request_stats_monitor(
    sliding_window_s: float = 60.0,
) -> RequestStatsMonitor:
    global _monitor
    _monitor = RequestStatsMonitor(sliding_window_s)
    return _monitor


def get_request_stats_monitor() -> RequestStatsMonitor:
    if _monitor is None:
        raise RuntimeError("request stats monitor not initialized")
    return _monitor
