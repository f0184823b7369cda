"""Periodic human-readable stats log + Prometheus gauge updates.

Parity: reference src/vllm_router/stats/log_stats.py:37 `log_stats` — a
background loop that pretty-prints per-engine stats and pushes them into the
router's Prometheus gauges.
"""

from __future__ import annotations

import asyncio

from production_stack_tpu_torch.router.services import metrics_service as ms
from production_stack_tpu_torch.router.service_discovery import (
    get_service_discovery,
)
from production_stack_tpu_torch.router.stats.engine_stats import (
    get_engine_stats_scraper,
)
from production_stack_tpu_torch.router.stats.health import (
    get_engine_health_board,
)
from production_stack_tpu_torch.router.stats.request_stats import (
    get_request_stats_monitor,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger("production_stack_tpu_torch.router.stats")


def update_prometheus_and_render() -> str:
    endpoints = get_service_discovery().get_endpoint_info()
    engine_stats = get_engine_stats_scraper().get_engine_stats()
    request_stats = get_request_stats_monitor().get_request_stats()

    ms.healthy_pods_total.labels(server="all").set(len(endpoints))

    # admission control: refresh the load-score gauge and prune idle
    # IP-fallback tenant rows (same unbounded-growth hygiene as the
    # health-board prune below)
    from production_stack_tpu_torch.router.admission import (
        get_admission_controller,
    )

    admission = get_admission_controller()
    admission.export_gauges()
    admission.prune()

    # per-tenant SLO tracking: burn-rate/compliance/budget gauges
    # refresh on render (violations count on the hot path); idle
    # default-matched rows pruned with the same hygiene as above
    from production_stack_tpu_torch.router.stats.slo import get_slo_tracker

    slo = get_slo_tracker()
    slo.export_gauges()
    slo.prune()

    # health scoreboard gauges (mirror of /debug/engines; histograms
    # observe on the hot path, gauges refresh here on render/scrape)
    board = get_engine_health_board()
    # discovery churn (pod restarts → fresh URLs) must not grow the
    # scoreboard and its exported label sets without bound
    for url in board.prune({ep.url for ep in endpoints}):
        for g in (
            ms.engine_ewma_latency, ms.engine_ewma_ttft,
            ms.engine_error_rate, ms.engine_consecutive_failures,
            ms.engine_inflight, ms.engine_last_scrape_age,
        ):
            try:
                g.remove(url)
            except KeyError:
                pass  # that gauge never exported this backend
    for url, row in board.snapshot().items():
        # -1.0 means "no completed request yet" — leave the series
        # absent rather than exporting a fake 0s latency that would
        # read as the fastest backend in the fleet
        if row["ewma_latency_s"] >= 0:
            ms.engine_ewma_latency.labels(server=url).set(
                row["ewma_latency_s"]
            )
        if row["ewma_ttft_s"] >= 0:
            ms.engine_ewma_ttft.labels(server=url).set(
                row["ewma_ttft_s"]
            )
        ms.engine_error_rate.labels(server=url).set(row["error_rate"])
        ms.engine_consecutive_failures.labels(server=url).set(
            row["consecutive_failures"]
        )
        ms.engine_inflight.labels(server=url).set(row["in_flight"])
        if row["last_scrape_age_s"] is not None:
            ms.engine_last_scrape_age.labels(server=url).set(
                row["last_scrape_age_s"]
            )
    lines = ["", "==================== Router Stats ===================="]
    for ep in endpoints:
        url = ep.url
        es = engine_stats.get(url)
        rs = request_stats.get(url)
        if es:
            ms.num_requests_running.labels(server=url).set(
                es.num_running_requests
            )
            ms.num_requests_waiting.labels(server=url).set(
                es.num_queuing_requests
            )
            ms.gpu_cache_usage_perc.labels(server=url).set(
                es.gpu_cache_usage_perc
            )
            ms.gpu_prefix_cache_hit_rate.labels(server=url).set(
                es.gpu_prefix_cache_hit_rate
            )
        if rs:
            ms.current_qps.labels(server=url).set(rs.qps)
            ms.avg_ttft.labels(server=url).set(max(rs.ttft, 0))
            ms.avg_latency.labels(server=url).set(max(rs.avg_latency, 0))
            ms.avg_itl.labels(server=url).set(max(rs.avg_itl, 0))
            ms.num_prefill_requests.labels(server=url).set(
                rs.in_prefill_requests
            )
            ms.num_decoding_requests.labels(server=url).set(
                rs.in_decoding_requests
            )
            ms.avg_decoding_length.labels(server=url).set(
                max(rs.avg_decoding_length, 0)
            )
        lines.append(
            f"{url} | models={ep.model_names} "
            f"| running={es.num_running_requests if es else '?'} "
            f"| waiting={es.num_queuing_requests if es else '?'} "
            f"| kv={es.gpu_cache_usage_perc:.2f} " if es else f"{url} | -"
        )
        if rs:
            lines.append(
                f"    qps={rs.qps:.2f} ttft={rs.ttft:.3f}s "
                f"prefill={rs.in_prefill_requests} "
                f"decode={rs.in_decoding_requests} "
                f"finished={rs.finished_requests}"
            )
    lines.append("======================================================")
    return "\n".join(lines)


async def log_stats_loop(interval_s: float = 10.0) -> None:
    while True:
        await asyncio.sleep(interval_s)
        try:
            logger.info(update_prometheus_and_render())
        except RuntimeError:
            pass  # subsystems not initialized yet
        except Exception:
            logger.exception("stats logging failed")
