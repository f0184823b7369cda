"""Live-reload of router config from a JSON (or YAML) file.

Parity: reference src/vllm_router/dynamic_config.py — DynamicRouterConfig:43,
DynamicConfigWatcher:120 re-reads the file every 10 s and reconfigures
discovery/routing/callbacks on change (reconfigure_all:236). Ours is an
asyncio task in the same event loop as the router app. The port's copy
reads JSON with the standard library and YAML only through the yaml
package where it is installed: without it a YAML file is refused with an
error naming it (parsers.load_yaml), never read as something else.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, fields

from production_stack_tpu_torch.router import routing_logic as rl
from production_stack_tpu_torch.router import service_discovery as sd
from production_stack_tpu_torch.router.utils import (
    parse_static_aliases,
    parse_static_model_names,
    parse_static_urls,
)
from production_stack_tpu_torch.utils import init_logger
from production_stack_tpu_torch.utils.tasks import spawn_watched

logger = init_logger(__name__)


@dataclass
class DynamicRouterConfig:
    service_discovery: str | None = None
    static_backends: str | None = None
    static_models: str | None = None
    static_aliases: str | None = None
    static_model_labels: str | None = None
    k8s_namespace: str | None = None
    k8s_port: int | None = None
    k8s_label_selector: str | None = None
    routing_logic: str | None = None
    session_key: str | None = None
    kv_controller_url: str | None = None
    prefix_chunk_size: int | None = None
    callbacks: str | None = None
    # admission control: per-tenant budgets + overload thresholds
    # (shape: AdmissionController.apply_config). Applied at STARTUP
    # too — CLI flags cannot express per-tenant maps, so the file is
    # their sole source.
    admission: dict | None = None
    # per-tenant SLO objectives + burn-rate windows (shape:
    # SLOTracker.apply_config). Same startup-and-live-reload contract
    # as `admission:` — the file is the sole source of objectives.
    slo: dict | None = None

    @staticmethod
    def from_file(path: str) -> "DynamicRouterConfig":
        from production_stack_tpu_torch.router.parsers import load_yaml

        with open(path) as f:
            text = f.read()
        raw = (
            json.loads(text)
            if path.endswith(".json")
            else load_yaml(path, text)
        ) or {}
        known = {f.name for f in fields(DynamicRouterConfig)}
        return DynamicRouterConfig(
            **{k: v for k, v in raw.items() if k in known}
        )


class DynamicConfigWatcher:
    def __init__(
        self,
        config_path: str,
        poll_interval_s: float = 10.0,
        request_service=None,
    ):
        self.config_path = config_path
        self.poll_interval_s = poll_interval_s
        self.request_service = request_service
        self._current: DynamicRouterConfig | None = None
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        try:
            self._current = DynamicRouterConfig.from_file(self.config_path)
        except Exception:
            logger.exception(
                "failed to load initial dynamic config %s", self.config_path
            )
        # the admission section applies at startup too: CLI flags only
        # carry the defaults, so a file-declared tenant budget must be
        # live before the first request — the rest of the file stays
        # delta-only (discovery/routing were just built FROM the flags;
        # re-initializing them here would churn identical singletons)
        if self._current is not None and self._current.admission is not None:
            try:
                self._apply_admission(self._current.admission)
            except Exception:
                logger.exception(
                    "initial admission config invalid; keeping flag "
                    "defaults"
                )
        if self._current is not None and self._current.slo is not None:
            try:
                self._apply_slo(self._current.slo)
            except Exception:
                logger.exception(
                    "initial slo config invalid; starting untracked"
                )
        self._task = spawn_watched(self._watch_loop(), "dynamic-config-watch")

    @staticmethod
    def _apply_admission(raw: dict) -> None:
        from production_stack_tpu_torch.router.admission import (
            get_admission_controller,
        )

        get_admission_controller().apply_config(raw)

    @staticmethod
    def _apply_slo(raw: dict) -> None:
        from production_stack_tpu_torch.router.stats.slo import get_slo_tracker

        get_slo_tracker().apply_config(raw)

    async def close(self) -> None:
        if self._task:
            self._task.cancel()

    def get_current_config(self) -> DynamicRouterConfig | None:
        return self._current

    def get_health(self) -> bool:
        return self._task is not None and not self._task.done()

    async def _watch_loop(self) -> None:
        while True:
            await asyncio.sleep(self.poll_interval_s)
            try:
                fresh = DynamicRouterConfig.from_file(self.config_path)
            except Exception:
                logger.exception("dynamic config reload failed; keeping old")
                continue
            if fresh == self._current:
                continue
            logger.info("dynamic config changed; reconfiguring")
            try:
                await self.reconfigure_all(fresh)
                self._current = fresh
            except Exception:
                logger.exception("reconfiguration failed; keeping old")

    async def reconfigure_all(self, cfg: DynamicRouterConfig) -> None:
        # admission FIRST: apply_config validates before swapping, so
        # a malformed section raises HERE — before any discovery/
        # routing teardown. Were it applied last, a bad admission
        # section after valid discovery keys would re-churn the
        # discovery singleton (probe restarts, health-state wipe) on
        # EVERY poll until the file is fixed, since _current only
        # advances on full success.
        if cfg.admission is not None:
            self._apply_admission(cfg.admission)

        # slo objectives: same validate-before-swap contract as the
        # admission section (a malformed payload raises here and the
        # watcher keeps last-good); applied before discovery for the
        # same churn-avoidance reason as above
        if cfg.slo is not None:
            self._apply_slo(cfg.slo)

        # discovery (reference: dynamic_config.py:157)
        if cfg.service_discovery == "static" and cfg.static_backends:
            await sd.reconfigure_service_discovery(
                "static",
                urls=parse_static_urls(cfg.static_backends),
                model_names=parse_static_model_names(
                    cfg.static_models or ""
                ),
                aliases=parse_static_aliases(cfg.static_aliases),
            )
        elif cfg.service_discovery == "k8s":
            kwargs = {}
            if cfg.k8s_namespace:
                kwargs["namespace"] = cfg.k8s_namespace
            if cfg.k8s_port:
                kwargs["port"] = cfg.k8s_port
            if cfg.k8s_label_selector:
                kwargs["label_selector"] = cfg.k8s_label_selector
            await sd.reconfigure_service_discovery("k8s", **kwargs)

        # routing logic (reference: dynamic_config.py:203)
        if cfg.routing_logic:
            kwargs = {}
            if cfg.session_key:
                kwargs["session_key"] = cfg.session_key
            if cfg.kv_controller_url:
                kwargs["kv_controller_url"] = cfg.kv_controller_url
            if cfg.prefix_chunk_size:
                kwargs["prefix_chunk_size"] = cfg.prefix_chunk_size
            await rl.reconfigure_routing_logic(cfg.routing_logic, **kwargs)

        # callbacks (reference: dynamic_config.py:227)
        if cfg.callbacks and self.request_service is not None:
            from production_stack_tpu_torch.router.services.callbacks_service import (
                configure_custom_callbacks,
            )

            self.request_service.callbacks = configure_custom_callbacks(
                cfg.callbacks
            )


_watcher: DynamicConfigWatcher | None = None


def initialize_dynamic_config_watcher(
    config_path: str, poll_interval_s: float = 10.0, request_service=None
) -> DynamicConfigWatcher:
    global _watcher
    _watcher = DynamicConfigWatcher(
        config_path, poll_interval_s, request_service
    )
    return _watcher


def get_dynamic_config_watcher() -> DynamicConfigWatcher | None:
    return _watcher
