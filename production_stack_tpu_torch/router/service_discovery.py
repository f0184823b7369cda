"""Service discovery: which serving-engine endpoints exist and what they serve.

Three implementations behind one ABC, capability parity with the reference
(reference: src/vllm_router/service_discovery.py — StaticServiceDiscovery:206,
K8sPodIPServiceDiscovery:344, K8sServiceNameServiceDiscovery:762), rebuilt on
asyncio (the port's copy on the stdlib client of utils/http.py):

- Static: fixed URL list from flags, with optional active health probes.
- K8sPodIP: watches pods matching a label selector; ready pods are probed for
  /v1/models and sleep status, then exposed as http://<pod-ip>:<port>.
- K8sServiceName: watches Services and exposes cluster-DNS URLs.

A module-level singleton mirrors the reference's initialize/get/reconfigure
lifecycle so dynamic config reload can swap discovery live.
"""

from __future__ import annotations

import abc
import asyncio
import time

from production_stack_tpu_torch.router.k8s_client import K8sClient
from production_stack_tpu_torch.router.protocols import EndpointInfo, ModelInfo
from production_stack_tpu_torch.router.utils import is_model_healthy
from production_stack_tpu_torch.utils import http
from production_stack_tpu_torch.utils import init_logger
from production_stack_tpu_torch.utils.tasks import spawn_watched

logger = init_logger(__name__)


class ServiceDiscovery(abc.ABC):
    @abc.abstractmethod
    def get_endpoint_info(self) -> list[EndpointInfo]:
        """Snapshot of currently known endpoints."""

    def get_health(self) -> bool:
        return True

    async def start(self) -> None:  # pragma: no cover - trivial
        pass

    async def close(self) -> None:  # pragma: no cover - trivial
        pass

    def get_unhealthy_endpoint_hashes(self) -> list[str]:
        return []

    # PD helpers: role resolution order is engine-advertised card role
    # (--kv-role) first, then the model-label convention, then "both"
    # (EndpointInfo.role). A "both" engine serves either phase.
    def get_prefill_endpoints(self) -> list[EndpointInfo]:
        return [
            e
            for e in self.get_endpoint_info()
            if e.role in ("prefill", "both")
        ]

    def get_decode_endpoints(self) -> list[EndpointInfo]:
        return [
            e
            for e in self.get_endpoint_info()
            if e.role in ("decode", "both")
        ]


async def _probe_endpoint(
    url: str, timeout_s: float = 5.0
) -> tuple[
    list[str], dict[str, ModelInfo], str | None, str | None,
    int | None, int | None,
] | None:
    """GET <url>/v1/models; returns (model_names, model_info,
    kv_instance_id, kv_role, max_model_len, sp_size) or None. The kv
    instance id is the engine-advertised card metadata that lets
    kvaware routing map controller matches to this endpoint without
    the id == host:port convention; kv_role (prefill/decode/both)
    labels the endpoint for the `pd` routing policy without k8s label
    plumbing; max_model_len is the engine's admitted context window
    (the router's context-window filter skips too-small backends and
    413s oversized prompts); sp_size advertises the long-prefill
    ring's context-parallel capability."""
    try:
        async with http.ClientSession(
            timeout=http.ClientTimeout(total=timeout_s)
        ) as s:
            async with s.get(f"{url}/v1/models") as r:
                if r.status != 200:
                    return None
                data = await r.json()
    except Exception as e:  # noqa: BLE001 — a down endpoint is expected
        logger.debug("model probe failed for %s: %s", url, e)
        return None
    names, info, kv_iid, kv_role = [], {}, None, None
    max_len, sp_size = None, None
    for card in data.get("data", []):
        mi = ModelInfo.from_dict(card)
        names.append(mi.id)
        info[mi.id] = mi
        if kv_iid is None:
            kv_iid = card.get("kv_instance_id")
        if kv_role is None and card.get("kv_role") in (
            "prefill", "decode", "both"
        ):
            kv_role = card["kv_role"]
        if max_len is None and isinstance(
            card.get("max_model_len"), int
        ):
            max_len = card["max_model_len"]
        if sp_size is None and isinstance(card.get("sp_size"), int):
            sp_size = card["sp_size"]
    return names, info, kv_iid, kv_role, max_len, sp_size


async def _probe_sleep(url: str, timeout_s: float = 3.0) -> bool:
    try:
        async with http.ClientSession(
            timeout=http.ClientTimeout(total=timeout_s)
        ) as s:
            async with s.get(f"{url}/is_sleeping") as r:
                if r.status != 200:
                    return False
                data = await r.json()
                return bool(data.get("is_sleeping", False))
    except Exception as e:  # noqa: BLE001 — endpoints without /is_sleeping
        logger.debug("sleep probe failed for %s: %s", url, e)
        return False


class StaticServiceDiscovery(ServiceDiscovery):
    """Fixed endpoint list (reference: service_discovery.py:206)."""

    def __init__(
        self,
        urls: list[str],
        model_names: list[list[str]] | None = None,
        aliases: dict[str, str] | None = None,
        model_labels: list[str] | None = None,
        model_types: list[str] | None = None,
        static_backend_health_checks: bool = False,
        health_check_interval_s: float = 10.0,
        prefill_model_labels: list[str] | None = None,
        decode_model_labels: list[str] | None = None,
    ):
        self.urls = urls
        self.aliases = aliases or {}
        self.model_types = model_types or []
        self.health_checks = static_backend_health_checks
        self.health_check_interval_s = health_check_interval_s
        self.prefill_model_labels = prefill_model_labels or []
        self.decode_model_labels = decode_model_labels or []
        self._unhealthy: set[str] = set()
        self._task: asyncio.Task | None = None
        self._endpoints: list[EndpointInfo] = []
        for i, url in enumerate(urls):
            names = (
                model_names[i]
                if model_names and i < len(model_names)
                else []
            )
            label = (
                model_labels[i]
                if model_labels and i < len(model_labels)
                else None
            )
            ep_aliases = {
                a: m for a, m in self.aliases.items() if m in names
            }
            self._endpoints.append(
                EndpointInfo(
                    url=url,
                    model_names=list(names),
                    model_label=label,
                    aliases=ep_aliases,
                )
            )

    async def start(self) -> None:
        # discover models for endpoints with no static names.
        # Endpoints WITH preset names keep them (hermetic static
        # configs must start without live backends — a failed probe
        # changes nothing), but still get a best-effort metadata probe
        # for the card fields flags cannot carry: the kv instance id
        # (kvaware matching without the id == host:port convention)
        # and the PD role (`pd` policy on static discovery). Probes
        # run concurrently so a dead backend costs one timeout, not
        # one per endpoint.
        async def _probe_into(ep: EndpointInfo) -> None:
            probed = await _probe_endpoint(ep.url)
            if probed is None:
                return
            if not ep.model_names:
                ep.model_names, ep.model_info = probed[0], probed[1]
            ep.kv_instance_id = probed[2]
            ep.pd_role = probed[3]
            ep.max_model_len = probed[4]
            ep.sp_size = probed[5]

        await asyncio.gather(
            *(_probe_into(ep) for ep in self._endpoints)
        )
        if self.health_checks:
            self._task = spawn_watched(
                self._health_loop(), "static-discovery-health"
            )

    async def close(self) -> None:
        if self._task:
            self._task.cancel()

    async def _health_loop(self) -> None:
        while True:
            for ep in self._endpoints:
                healthy = True
                for i, model in enumerate(ep.model_names):
                    mtype = (
                        self.model_types[i]
                        if i < len(self.model_types)
                        else "chat"
                    )
                    if not await is_model_healthy(ep.url, model, mtype):
                        healthy = False
                        break
                if healthy:
                    self._unhealthy.discard(ep.url)
                else:
                    logger.warning("endpoint %s failed health check", ep.url)
                    self._unhealthy.add(ep.url)
            await asyncio.sleep(self.health_check_interval_s)

    def get_endpoint_info(self) -> list[EndpointInfo]:
        # label-based PD roles for static deployments
        for ep in self._endpoints:
            if ep.model_label is None:
                if any(
                    m in self.prefill_model_labels for m in ep.model_names
                ):
                    ep.model_label = "prefill"
                elif any(
                    m in self.decode_model_labels for m in ep.model_names
                ):
                    ep.model_label = "decode"
        return [
            e for e in self._endpoints if e.url not in self._unhealthy
        ]

    def get_unhealthy_endpoint_hashes(self) -> list[str]:
        return sorted(self._unhealthy)


class K8sPodIPServiceDiscovery(ServiceDiscovery):
    """Watch pods by label selector, route to pod IPs
    (reference: service_discovery.py:344)."""

    def __init__(
        self,
        namespace: str = "default",
        port: int = 8000,
        label_selector: str = "environment=router-controlled",
        k8s_client: K8sClient | None = None,
        probe_interval_s: float = 10.0,
    ):
        self.k8s = k8s_client or K8sClient(namespace=namespace)
        self.namespace = namespace or self.k8s.namespace
        self.port = port
        self.label_selector = label_selector
        self.probe_interval_s = probe_interval_s
        self._endpoints: dict[str, EndpointInfo] = {}  # pod_name -> info
        self._lock = asyncio.Lock()
        self._watch_task: asyncio.Task | None = None
        self._probe_task: asyncio.Task | None = None
        self._healthy = False

    async def start(self) -> None:
        self._watch_task = spawn_watched(
            self._watch_pods(), "k8s-pod-watch"
        )
        self._probe_task = spawn_watched(
            self._reprobe_loop(), "k8s-pod-reprobe"
        )

    async def close(self) -> None:
        for t in (self._watch_task, self._probe_task):
            if t:
                t.cancel()
        await self.k8s.close()

    def get_health(self) -> bool:
        return self._healthy

    @staticmethod
    def _pod_ready(pod: dict) -> bool:
        status = pod.get("status", {})
        if status.get("phase") != "Running":
            return False
        if pod.get("metadata", {}).get("deletionTimestamp"):
            return False
        for cond in status.get("conditions", []):
            if cond.get("type") == "Ready":
                return cond.get("status") == "True"
        return False

    @staticmethod
    def _model_label_of(pod: dict) -> str | None:
        return pod.get("metadata", {}).get("labels", {}).get("model")

    async def _watch_pods(self) -> None:
        path = f"/api/v1/namespaces/{self.namespace}/pods"
        params = {"labelSelector": self.label_selector}
        async for event in self.k8s.watch(path, params):
            self._healthy = True
            pod = event.get("object", {})
            name = pod.get("metadata", {}).get("name")
            if not name:
                continue
            etype = event.get("type")
            if etype == "DELETED" or not self._pod_ready(pod):
                async with self._lock:
                    if self._endpoints.pop(name, None):
                        logger.info("engine pod %s removed", name)
                continue
            ip = pod.get("status", {}).get("podIP")
            if not ip:
                continue
            url = f"http://{ip}:{self.port}"
            await self._add_engine(name, url, self._model_label_of(pod))

    async def _add_engine(
        self, pod_name: str, url: str, model_label: str | None
    ) -> None:
        probed = await _probe_endpoint(url)
        if probed is None:
            return
        names, info, kv_iid, kv_role, max_len, sp_size = probed
        sleeping = await _probe_sleep(url)
        async with self._lock:
            self._endpoints[pod_name] = EndpointInfo(
                url=url,
                model_names=names,
                model_info=info,
                model_label=model_label,
                pd_role=kv_role,
                kv_instance_id=kv_iid,
                max_model_len=max_len,
                sp_size=sp_size,
                sleep=sleeping,
                pod_name=pod_name,
                namespace=self.namespace,
                added_timestamp=self._endpoints.get(
                    pod_name,
                    EndpointInfo(url=url, added_timestamp=time.time()),
                ).added_timestamp,
            )
        logger.info(
            "engine pod %s at %s serving %s%s",
            pod_name, url, names, " (sleeping)" if sleeping else "",
        )

    async def _reprobe_loop(self) -> None:
        """Refresh model lists + sleep state (LoRA hot-load changes them)."""
        while True:
            await asyncio.sleep(self.probe_interval_s)
            async with self._lock:
                current = list(self._endpoints.items())
            for pod_name, ep in current:
                probed = await _probe_endpoint(ep.url)
                if probed is None:
                    continue
                sleeping = await _probe_sleep(ep.url)
                async with self._lock:
                    if pod_name in self._endpoints:
                        e = self._endpoints[pod_name]
                        e.model_names, e.model_info = probed[0], probed[1]
                        e.kv_instance_id = probed[2]
                        e.pd_role = probed[3]
                        e.max_model_len = probed[4]
                        e.sp_size = probed[5]
                        e.sleep = sleeping

    def get_endpoint_info(self) -> list[EndpointInfo]:
        return list(self._endpoints.values())


class K8sServiceNameServiceDiscovery(ServiceDiscovery):
    """Watch Services, route via cluster DNS
    (reference: service_discovery.py:762)."""

    #: how a Service name becomes a URL; cluster DNS by default.
    #: Overridable for routers running OFF-cluster (port-forwards, bare
    #: metal) and for hermetic e2e tests, where cluster DNS cannot
    #: resolve.
    DEFAULT_URL_TEMPLATE = (
        "http://{name}.{namespace}.svc.cluster.local:{port}"
    )

    def __init__(
        self,
        namespace: str = "default",
        port: int = 8000,
        label_selector: str = "environment=router-controlled",
        k8s_client: K8sClient | None = None,
        url_template: str | None = None,
    ):
        self.k8s = k8s_client or K8sClient(namespace=namespace)
        self.namespace = namespace or self.k8s.namespace
        self.port = port
        self.label_selector = label_selector
        self.url_template = url_template or self.DEFAULT_URL_TEMPLATE
        self._endpoints: dict[str, EndpointInfo] = {}
        self._watch_task: asyncio.Task | None = None
        self._healthy = False

    async def start(self) -> None:
        self._watch_task = spawn_watched(
            self._watch_services(), "k8s-service-watch"
        )

    async def close(self) -> None:
        if self._watch_task:
            self._watch_task.cancel()
        await self.k8s.close()

    def get_health(self) -> bool:
        return self._healthy

    async def _watch_services(self) -> None:
        path = f"/api/v1/namespaces/{self.namespace}/services"
        params = {"labelSelector": self.label_selector}
        async for event in self.k8s.watch(path, params):
            self._healthy = True
            svc = event.get("object", {})
            name = svc.get("metadata", {}).get("name")
            if not name:
                continue
            if event.get("type") == "DELETED":
                self._endpoints.pop(name, None)
                continue
            url = self.url_template.format(
                name=name, namespace=self.namespace, port=self.port
            )
            probed = await _probe_endpoint(url)
            if probed is None:
                continue
            names, info, kv_iid, kv_role, max_len, sp_size = probed
            label = (
                svc.get("metadata", {}).get("labels", {}).get("model")
            )
            self._endpoints[name] = EndpointInfo(
                url=url, model_names=names, model_info=info,
                model_label=label, pd_role=kv_role, pod_name=name,
                namespace=self.namespace, kv_instance_id=kv_iid,
                max_model_len=max_len, sp_size=sp_size,
            )

    def get_endpoint_info(self) -> list[EndpointInfo]:
        return list(self._endpoints.values())


# -- module singleton (reference: service_discovery.py:1179-1272) ----------
_discovery: ServiceDiscovery | None = None


def initialize_service_discovery(
    discovery_type: str, **kwargs
) -> ServiceDiscovery:
    global _discovery
    if discovery_type == "static":
        _discovery = StaticServiceDiscovery(**kwargs)
    elif discovery_type == "k8s":
        _discovery = K8sPodIPServiceDiscovery(**kwargs)
    elif discovery_type == "k8s_service_name":
        _discovery = K8sServiceNameServiceDiscovery(**kwargs)
    else:
        raise ValueError(f"unknown discovery type {discovery_type!r}")
    return _discovery


async def reconfigure_service_discovery(
    discovery_type: str, **kwargs
) -> ServiceDiscovery:
    global _discovery
    old = _discovery
    new = initialize_service_discovery(discovery_type, **kwargs)
    await new.start()
    if old is not None:
        await old.close()
    return new


def get_service_discovery() -> ServiceDiscovery:
    if _discovery is None:
        raise RuntimeError("service discovery not initialized")
    return _discovery


def _reset_service_discovery() -> None:
    global _discovery
    _discovery = None
