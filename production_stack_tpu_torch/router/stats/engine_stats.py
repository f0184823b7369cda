"""Engine stats scraper: polls every engine's Prometheus /metrics.

Parity: reference src/vllm_router/stats/engine_stats.py (EngineStats:29,
EngineStatsScraper:88). Parses the vllm:* gauge families our engines (and
stock vLLM engines) export, so the router works against either. Runs as an
asyncio task instead of the reference's daemon thread. The port's copy
reads the text with utils/prometheus.py's parser (prometheus_client's
families and samples) over the stdlib client of utils/http.py.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from production_stack_tpu_torch.utils import http
from production_stack_tpu_torch.utils.prometheus import (
    text_string_to_metric_families,
)

from production_stack_tpu_torch.router.service_discovery import (
    get_service_discovery,
)
from production_stack_tpu_torch.utils import init_logger
from production_stack_tpu_torch.utils.tasks import spawn_watched

logger = init_logger(__name__)


@dataclass
class EngineStats:
    num_running_requests: int = 0
    num_queuing_requests: int = 0
    gpu_prefix_cache_hit_rate: float = 0.0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hits_total: int = 0
    gpu_prefix_cache_queries_total: int = 0
    # lifetime sum/count of the engine's tpu:scheduling_delay_seconds
    # histogram (enqueue -> scheduler admission wait): the
    # scraper turns consecutive scrapes' deltas into the WINDOWED
    # average below — the admission load score's earliest
    # TTFT-blowup signal
    scheduling_delay_sum: float = 0.0
    scheduling_delay_count: int = 0
    # average scheduling delay over the LAST scrape interval (0.0 when
    # no request was admitted in the window); computed by the scraper,
    # not parsed
    recent_scheduling_delay_s: float = 0.0

    @staticmethod
    def from_prometheus_text(text: str) -> "EngineStats":
        s = EngineStats()
        hits = queries = None
        for family in text_string_to_metric_families(text):
            for sample in family.samples:
                name, value = sample.name, sample.value
                if name == "vllm:num_requests_running":
                    s.num_running_requests = int(value)
                elif name == "vllm:num_requests_waiting":
                    s.num_queuing_requests = int(value)
                elif name == "vllm:gpu_cache_usage_perc":
                    s.gpu_cache_usage_perc = float(value)
                elif name == "vllm:gpu_prefix_cache_hit_rate":
                    s.gpu_prefix_cache_hit_rate = float(value)
                elif name == "vllm:gpu_prefix_cache_hits_total":
                    hits = float(value)
                elif name == "vllm:gpu_prefix_cache_queries_total":
                    queries = float(value)
                elif name == "tpu:scheduling_delay_seconds_sum":
                    s.scheduling_delay_sum = float(value)
                elif name == "tpu:scheduling_delay_seconds_count":
                    s.scheduling_delay_count = int(value)
        if hits is not None and queries:
            s.gpu_prefix_cache_hits_total = int(hits)
            s.gpu_prefix_cache_queries_total = int(queries)
            s.gpu_prefix_cache_hit_rate = hits / queries
        return s


class EngineStatsScraper:
    def __init__(self, scrape_interval_s: float = 10.0):
        self.scrape_interval_s = scrape_interval_s
        self._stats: dict[str, EngineStats] = {}
        # previous scrape's (delay_sum, delay_count) per url: the
        # windowed scheduling-delay average comes from the delta, so
        # an hours-old stall cannot keep the load score pinned high
        self._prev_delay: dict[str, tuple[float, int]] = {}
        self._task: asyncio.Task | None = None
        self._session: http.ClientSession | None = None

    async def start(self) -> None:
        self._session = http.ClientSession(
            timeout=http.ClientTimeout(total=self.scrape_interval_s)
        )
        self._task = spawn_watched(self._scrape_loop(), "engine-stats-scrape")

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
        if self._session:
            await self._session.close()

    async def _scrape_loop(self) -> None:
        while True:
            try:
                await self._scrape_all()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("engine stats scrape failed")
            await asyncio.sleep(self.scrape_interval_s)

    async def _scrape_all(self) -> None:
        try:
            endpoints = get_service_discovery().get_endpoint_info()
        except RuntimeError:
            return
        results = await asyncio.gather(
            *(self._scrape_one(ep.url) for ep in endpoints),
            return_exceptions=True,
        )
        # the health scoreboard's last-scrape age / scrape-failure
        # streak is fed here (the scraper is the only component that
        # touches every backend on a clock, request traffic or not)
        from production_stack_tpu_torch.router.stats.health import (
            get_engine_health_board,
        )

        board = get_engine_health_board()
        fresh: dict[str, EngineStats] = {}
        prev_delay: dict[str, tuple[float, int]] = {}
        for ep, res in zip(endpoints, results):
            if isinstance(res, EngineStats):
                res.recent_scheduling_delay_s = self._windowed_delay(
                    ep.url, res
                )
                prev_delay[ep.url] = (
                    res.scheduling_delay_sum, res.scheduling_delay_count
                )
                fresh[ep.url] = res
            board.note_scrape(ep.url, ok=isinstance(res, EngineStats))
        self._stats = fresh
        self._prev_delay = prev_delay

    def _windowed_delay(self, url: str, res: EngineStats) -> float:
        """Average scheduling delay over the last scrape interval,
        from consecutive lifetime-histogram (sum, count) deltas. No
        prior scrape (first contact, or a scrape hiccup dropped the
        url) reports 0.0 — NOT the lifetime average, whose ancient
        stalls are exactly what the windowing exists to forget. An
        engine restart (counters went backwards) also resets."""
        prev = self._prev_delay.get(url)
        if prev is None:
            return 0.0
        prev_sum, prev_count = prev
        d_sum = res.scheduling_delay_sum - prev_sum
        d_count = res.scheduling_delay_count - prev_count
        if d_count <= 0 or d_sum < 0:
            return 0.0
        return d_sum / d_count

    async def _scrape_one(self, url: str) -> EngineStats | None:
        assert self._session is not None
        async with self._session.get(f"{url}/metrics") as r:
            if r.status != 200:
                return None
            text = await r.text()
        return EngineStats.from_prometheus_text(text)

    def get_engine_stats(self) -> dict[str, EngineStats]:
        return dict(self._stats)

    def get_health(self) -> bool:
        return self._task is not None and not self._task.done()


_scraper: EngineStatsScraper | None = None


def initialize_engine_stats_scraper(
    scrape_interval_s: float = 10.0,
) -> EngineStatsScraper:
    global _scraper
    _scraper = EngineStatsScraper(scrape_interval_s)
    return _scraper


def get_engine_stats_scraper() -> EngineStatsScraper:
    if _scraper is None:
        raise RuntimeError("engine stats scraper not initialized")
    return _scraper
