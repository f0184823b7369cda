"""Router app bootstrap: wire singletons, build the app, serve.

Parity: reference src/vllm_router/app.py (initialize_all:127, lifespan:83,
main:302) + the HTTP surface of routers/main_router.py:45-231 and
routers/metrics_router.py:57-123. One application instead of
FastAPI+uvicorn — same endpoints, same Prometheus names, fewer moving parts.
Counterpart of production_stack_tpu/router/app.py on utils/web.py, the
stdlib server (``python -m production_stack_tpu_torch.router`` takes the
JAX router's flags).
"""

from __future__ import annotations

import asyncio
import dataclasses

from production_stack_tpu_torch import __version__
from production_stack_tpu_torch.router import parsers
from production_stack_tpu_torch.router.admission import (
    TenantLimits,
    get_admission_controller,
    initialize_admission_controller,
)
from production_stack_tpu_torch.router.dynamic_config import (
    initialize_dynamic_config_watcher,
)
from production_stack_tpu_torch.router.feature_gates import (
    get_feature_gates,
    initialize_feature_gates,
)
from production_stack_tpu_torch.router.routing_logic import (
    get_routing_logic,
    initialize_routing_logic,
)
from production_stack_tpu_torch.router.service_discovery import (
    get_service_discovery,
    initialize_service_discovery,
)
from production_stack_tpu_torch.router.services.callbacks_service import (
    configure_custom_callbacks,
)
from production_stack_tpu_torch.router.services.request_service import (
    RequestService,
)
from production_stack_tpu_torch.router.services.rewriter import (
    get_request_rewriter,
)
from production_stack_tpu_torch.router.stats.engine_stats import (
    get_engine_stats_scraper,
    initialize_engine_stats_scraper,
)
from production_stack_tpu_torch.router.stats.health import (
    get_engine_health_board,
    initialize_engine_health_board,
)
from production_stack_tpu_torch.router.stats.log_stats import (
    update_prometheus_and_render,
)
from production_stack_tpu_torch.router.stats.request_stats import (
    get_request_stats_monitor,
    initialize_request_stats_monitor,
)
from production_stack_tpu_torch.router.stats.slo import (
    get_slo_tracker,
    initialize_slo_tracker,
)
from production_stack_tpu_torch.utils import init_logger, web
from production_stack_tpu_torch.utils.tasks import spawn_watched

logger = init_logger(__name__)


class RouterApp:
    """Holds the wired subsystems + the web Application."""

    def __init__(self, args):
        self.args = args
        self.request_service: RequestService | None = None
        self.file_storage = None
        self.batch_processor = None
        self.semantic_cache = None
        self.pii_middleware = None
        self.app = web.Application(middlewares=[self._error_middleware])
        self._log_stats_task: asyncio.Task | None = None
        self._trace_flush_task: asyncio.Task | None = None
        self._initialize_all()
        self._add_routes()

    # -- wiring (reference: app.py:127-290) --------------------------------
    def _initialize_all(self) -> None:
        args = self.args
        initialize_feature_gates(args.feature_gates)

        # tracing/error reporting (reference: app.py:138-145)
        from production_stack_tpu_torch.router import tracing

        tracing.init_sentry(
            args.sentry_dsn,
            traces_sample_rate=args.sentry_traces_sample_rate,
            profile_session_sample_rate=(
                args.sentry_profile_session_sample_rate
            ),
        )
        self.tracer = tracing.RequestTracer(
            getattr(args, "tracing_exporter", "none")
        )

        if args.service_discovery == "static":
            initialize_service_discovery(
                "static",
                urls=parsers.parse_comma_list(args.static_backends) or [],
                model_names=parsers.parse_static_models(args.static_models),
                aliases=parsers.parse_static_aliases(args.static_aliases),
                model_labels=parsers.parse_comma_list(
                    args.static_model_labels),
                model_types=parsers.parse_comma_list(
                    args.static_model_types),
                static_backend_health_checks=(
                    args.static_backend_health_checks),
                health_check_interval_s=(
                    args.backend_health_check_timeout_seconds),
                prefill_model_labels=parsers.parse_comma_list(
                    args.prefill_model_labels),
                decode_model_labels=parsers.parse_comma_list(
                    args.decode_model_labels),
            )
        else:
            discovery_type = (
                "k8s_service_name"
                if (args.service_discovery == "k8s_service_name"
                    or args.k8s_service_discovery_type == "service-name")
                else "k8s"
            )
            initialize_service_discovery(
                discovery_type,
                namespace=args.k8s_namespace,
                port=args.k8s_port,
                label_selector=args.k8s_label_selector,
            )

        initialize_engine_stats_scraper(args.engine_stats_interval)
        initialize_request_stats_monitor(args.request_stats_window)
        initialize_engine_health_board(
            ewma_alpha=getattr(args, "health_ewma_alpha", 0.1)
        )
        # admission control: flags set the defaults; per-tenant budgets
        # arrive (and retune live) via the dynamic config watcher's
        # `admission:` section
        initialize_admission_controller(
            enabled=getattr(args, "admission_control", True),
            tenant_header=getattr(
                args, "admission_tenant_header", "x-tenant-id"
            ),
            default_limits=TenantLimits(
                rate=getattr(args, "admission_default_rate", 0.0),
                burst=getattr(args, "admission_default_burst", 0.0),
                max_concurrency=getattr(
                    args, "admission_default_concurrency", 0
                ),
            ),
            engine_inflight_target=getattr(
                args, "admission_inflight_target", 512
            ),
            engine_queue_target=getattr(
                args, "admission_queue_target", 256
            ),
            delay_target_s=getattr(
                args, "admission_delay_target_s", 2.0
            ),
            shed_threshold=getattr(
                args, "admission_shed_threshold", 1.0
            ),
            asleep_retry_s=getattr(
                args, "admission_asleep_retry_s", 10.0
            ),
            fleet_target_load=getattr(
                args, "fleet_target_load", 0.75
            ),
        )
        # SLO tracking: objectives are file-only (dynamic config
        # `slo:` section, applied by the watcher at startup) — the
        # tracker boots inert and costs nothing until configured
        initialize_slo_tracker()

        tokenizer = None
        if args.tokenizer:
            from production_stack_tpu_torch.engine.tokenizer import get_tokenizer

            tokenizer = get_tokenizer(args.tokenizer, args.tokenizer)
        initialize_routing_logic(
            args.routing_logic,
            session_key=args.session_key,
            kv_controller_url=args.kv_controller_url,
            kv_min_match_tokens=args.kv_aware_threshold,
            kv_cache_server_url=getattr(
                args, "kv_cache_server_url", None
            ),
            kv_cache_block_size=getattr(
                args, "kv_cache_block_size", 32
            ),
            kv_transfer_gbps=args.kv_transfer_gbps,
            kv_bytes_per_token=args.kv_bytes_per_token,
            default_prefill_tps=args.default_prefill_tps,
            tokenizer=tokenizer,
        )

        callbacks = configure_custom_callbacks(args.callbacks)
        rewriter = (
            get_request_rewriter(args.request_rewriter)
            if args.request_rewriter else None
        )

        gates = get_feature_gates()
        if gates.enabled("SemanticCache"):
            from production_stack_tpu_torch.router.experimental.semantic_cache import (  # noqa: E501
                SemanticCache,
            )

            self.semantic_cache = SemanticCache(
                model_name=args.semantic_cache_model,
                cache_dir=args.semantic_cache_dir,
                threshold=args.semantic_cache_threshold,
                embedder_url=args.semantic_cache_embedder_url,
            )
        if gates.enabled("PIIDetection"):
            from production_stack_tpu_torch.router.experimental.pii import (
                PIIMiddleware,
            )

            self.pii_middleware = PIIMiddleware(
                analyzer=args.pii_analyzer, action=args.pii_action
            )

        self.request_service = RequestService(
            session_key=args.session_key,
            callbacks=callbacks,
            rewriter=rewriter,
            semantic_cache=self.semantic_cache,
            request_timeout_s=args.request_timeout_seconds,
            tracer=self.tracer,
        )

        if args.enable_batch_api:
            from production_stack_tpu_torch.router.services.batch_service import (
                LocalBatchProcessor,
            )
            from production_stack_tpu_torch.router.services.files_service import (
                FileStorage,
            )

            self.file_storage = FileStorage(args.file_storage_path)
            self.batch_processor = LocalBatchProcessor(
                args.file_storage_path, self.file_storage,
                self.request_service,
            )

        if args.dynamic_config_yaml or args.dynamic_config_json:
            initialize_dynamic_config_watcher(
                args.dynamic_config_yaml or args.dynamic_config_json,
                request_service=self.request_service,
            )

    # -- routes ------------------------------------------------------------
    def _add_routes(self) -> None:
        r = self.app.router
        proxy = self._proxy_handler
        for path in ("/v1/chat/completions", "/v1/completions",
                     "/v1/embeddings", "/v1/rerank", "/v1/score",
                     "/tokenize", "/detokenize"):
            r.add_post(path, proxy)
        r.add_get("/v1/models", self.handle_models)
        r.add_get("/version", self.handle_version)
        r.add_get("/health", self.handle_health)
        r.add_get("/metrics", self.handle_metrics)
        r.add_get("/engines", self.handle_engines)
        r.add_get("/debug/engines", self.handle_debug_engines)
        r.add_get("/debug/admission", self.handle_debug_admission)
        r.add_get("/debug/slo", self.handle_debug_slo)
        r.add_get("/debug/requests", self.handle_debug_requests)
        r.add_post("/sleep", self._sleep_wake_handler)
        r.add_post("/wake_up", self._sleep_wake_handler)
        r.add_get("/is_sleeping", self._sleep_wake_handler)
        if self.file_storage is not None:
            from production_stack_tpu_torch.router.services.files_service import (
                add_file_routes,
            )

            add_file_routes(r, self.file_storage)
        if self.batch_processor is not None:
            from production_stack_tpu_torch.router.services.batch_service import (
                add_batch_routes,
            )

            add_batch_routes(r, self.batch_processor)
        self.app.on_startup.append(self._on_startup)
        self.app.on_cleanup.append(self._on_cleanup)

    @web.middleware
    async def _error_middleware(self, request, handler):
        try:
            return await handler(request)
        except web.HTTPException:
            raise
        except Exception as e:  # noqa: BLE001 — router must not die per-req
            logger.exception("unhandled error on %s", request.path)
            return web.json_response(
                {"error": {"message": str(e), "type": "internal_error"}},
                status=500,
            )

    # -- lifecycle (reference: app.py:83-124) ------------------------------
    async def _on_startup(self, app: web.Application) -> None:
        await self.request_service.start()
        await get_service_discovery().start()
        await get_engine_stats_scraper().start()
        router = get_routing_logic()
        if hasattr(router, "start"):
            await router.start()
        if self.batch_processor is not None:
            await self.batch_processor.start()
        watcher = _get_watcher()
        if watcher is not None:
            await watcher.start()
        if self.args.log_stats:
            self._log_stats_task = spawn_watched(
                self._log_stats_loop(), "router-log-stats")
        if self.tracer.exporter == "otlp":
            from production_stack_tpu_torch.tracing import otlp_flush_loop

            self._trace_flush_task = spawn_watched(
                otlp_flush_loop(self.tracer), "router-trace-flush")

    async def _on_cleanup(self, app: web.Application) -> None:
        watcher = _get_watcher()
        if watcher is not None:
            await watcher.close()
        if self._log_stats_task:
            self._log_stats_task.cancel()
        if self._trace_flush_task is not None:
            self._trace_flush_task.cancel()
            # final drain so the last partial interval's spans aren't
            # dropped with the cancellation
            from production_stack_tpu_torch.tracing import log_otlp_payload

            log_otlp_payload(self.tracer)
        if self.batch_processor is not None:
            await self.batch_processor.close()
        router = get_routing_logic()
        if hasattr(router, "close"):
            await router.close()
        await get_engine_stats_scraper().close()
        await get_service_discovery().close()
        await self.request_service.close()

    async def _log_stats_loop(self) -> None:
        while True:
            await asyncio.sleep(self.args.log_stats_interval)
            try:
                logger.info(update_prometheus_and_render())
            except Exception as e:  # noqa: BLE001
                logger.warning("log_stats failed: %s", e)

    # -- handlers ----------------------------------------------------------
    async def _proxy_handler(self, request: web.Request):
        if self.pii_middleware is not None:
            blocked = await self.pii_middleware.check(request)
            if blocked is not None:
                return blocked
        if self.semantic_cache is not None and request.path.endswith(
                "chat/completions"):
            hit = await self.semantic_cache.check(request)
            if hit is not None:
                return hit
        return await self.request_service.route_general_request(
            request, request.path
        )

    async def _sleep_wake_handler(self, request: web.Request):
        return await self.request_service.route_sleep_wakeup_request(
            request, request.path
        )

    async def handle_models(self, request: web.Request) -> web.Response:
        cards, seen = [], set()
        for ep in get_service_discovery().get_endpoint_info():
            for name in ep.model_names:
                if name not in seen:
                    seen.add(name)
                    info = ep.model_info.get(name)
                    cards.append(
                        info.to_dict() if info else
                        {"id": name, "object": "model",
                         "created": int(ep.added_timestamp),
                         "owned_by": "production-stack-tpu"}
                    )
            for alias in ep.aliases:
                if alias not in seen:
                    seen.add(alias)
                    cards.append({"id": alias, "object": "model",
                                  "created": int(ep.added_timestamp),
                                  "owned_by": "production-stack-tpu"})
        return web.json_response({"object": "list", "data": cards})

    async def handle_version(self, request: web.Request) -> web.Response:
        return web.json_response({"version": __version__})

    async def handle_health(self, request: web.Request) -> web.Response:
        """Aggregate subsystem liveness (reference: main_router.py:196)."""
        problems = []
        try:
            get_service_discovery()
        except RuntimeError:
            problems.append("service discovery not initialized")
        try:
            get_routing_logic()
        except RuntimeError:
            problems.append("routing logic not initialized")
        scraper = get_engine_stats_scraper()
        if not scraper.get_health():
            problems.append("engine stats scraper stalled")
        if problems:
            return web.json_response(
                {"status": "unhealthy", "problems": problems}, status=503
            )
        return web.json_response({"status": "healthy"})

    async def handle_engines(self, request: web.Request) -> web.Response:
        import dataclasses

        endpoints = get_service_discovery().get_endpoint_info()
        engine_stats = get_engine_stats_scraper().get_engine_stats()
        request_stats = get_request_stats_monitor().get_request_stats()
        out = []
        for ep in endpoints:
            es = engine_stats.get(ep.url)
            rs = request_stats.get(ep.url)
            out.append({
                "url": ep.url,
                "models": ep.model_names,
                "model_label": ep.model_label,
                "role": ep.role,
                "sleep": ep.sleep,
                "engine_stats": dataclasses.asdict(es) if es else None,
                "request_stats": dataclasses.asdict(rs) if rs else None,
            })
        return web.json_response({"engines": out})

    async def handle_debug_engines(
        self, request: web.Request
    ) -> web.Response:
        """Per-engine health scoreboard: EWMA latency/TTFT, in-flight,
        EWMA error rate, consecutive-failure streak, retry/error totals,
        and last-scrape age — the router-observed signal surface behind
        routing policies. `/engines` stays the discovery/stats view;
        this is the data-plane view (phases + failures as the PROXY saw
        them), joined per backend with the scraped engine stats."""
        board = get_engine_health_board()
        health = board.snapshot()
        engine_stats = get_engine_stats_scraper().get_engine_stats()
        known = {
            ep.url: ep
            for ep in get_service_discovery().get_endpoint_info()
        }
        out = []
        for url in sorted(set(health) | set(known)):
            es = engine_stats.get(url)
            row = health.get(url) or {"url": url}
            row["discovered"] = url in known
            # PD role (prefill/decode/both) so operators can see which
            # side of the disaggregated split a backend serves
            row["role"] = known[url].role if url in known else None
            row["healthy"] = board.is_healthy(url)
            row["engine_stats"] = (
                dataclasses.asdict(es) if es else None
            )
            out.append(row)
        return web.json_response({"engines": out})

    async def handle_debug_admission(
        self, request: web.Request
    ) -> web.Response:
        """Admission-control introspection: the live cluster load
        signals (per-engine in-flight / queue depth / scheduling
        delay, sleeping exclusions), the configured thresholds +
        priority ladder, and every tenant's budget state (bucket fill,
        in-flight, shed totals by reason). The operator-side view of
        every 429 the router returns."""
        return web.json_response(
            get_admission_controller().snapshot(detail=True)
        )

    async def handle_debug_slo(
        self, request: web.Request
    ) -> web.Response:
        """Per-tenant SLO introspection: the configured objectives,
        every tracked (tenant, model) row's fast/slow-window violation
        fractions and burn rates, and lifetime violation totals — the
        operator-side view behind the tpu_router:slo_* metrics and the
        burn-rate alert rules (observability/tpu-stack-alerts.yaml)."""
        return web.json_response(get_slo_tracker().snapshot())

    async def handle_debug_requests(
        self, request: web.Request
    ) -> web.Response:
        """Recent proxied-request spans (route decision, backend, TTFT
        event, status) from the tracer's bounded ring. The engine-side
        counterpart (/debug/requests on each engine) holds the matching
        request timelines — join on trace_id / x-request-id."""
        from production_stack_tpu_torch.tracing import debug_requests_payload

        return web.json_response(debug_requests_payload(
            request.query.get("limit"),
            enabled=self.tracer.enabled,
            snapshot=lambda n: self.tracer.recent(limit=n),
            hint="start the router with --tracing-exporter "
                 "log|memory|otlp to record request spans",
        ))

    async def handle_metrics(self, request: web.Request) -> web.Response:
        """Prometheus exposition: router gauges + psutil host stats
        (reference: metrics_router.py:57-123)."""
        try:
            update_prometheus_and_render()
        except RuntimeError:
            pass
        from production_stack_tpu_torch.router.services import metrics_service

        text = metrics_service.render_prometheus()
        return web.Response(
            text=text, content_type="text/plain", charset="utf-8"
        )


def _get_watcher():
    from production_stack_tpu_torch.router.dynamic_config import (
        get_dynamic_config_watcher,
    )

    return get_dynamic_config_watcher()


def build_app(args) -> RouterApp:
    return RouterApp(args)


def main(argv: list[str] | None = None) -> None:
    args = parsers.parse_args(argv)
    import logging

    logging.getLogger("production_stack_tpu_torch").setLevel(
        args.log_level.upper() if args.log_level != "trace" else "DEBUG"
    )
    router_app = build_app(args)
    logger.info(
        "starting tpu-router v%s on %s:%d (routing=%s discovery=%s)",
        __version__, args.host, args.port, args.routing_logic,
        args.service_discovery,
    )
    web.run_app(
        router_app.app, host=args.host, port=args.port, print=None
    )


if __name__ == "__main__":
    main()
