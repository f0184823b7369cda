"""Minimal Kubernetes REST client over the stdlib HTTP client
(utils/http.py, TLS through ``ssl``; the JAX router's runs on aiohttp).

The reference router uses the official `kubernetes` Python client for its pod
watcher (reference: src/vllm_router/service_discovery.py:579 `_watch_engines`).
We talk to the API server directly: in-cluster service-account auth (token +
CA bundle from /var/run/secrets/kubernetes.io/serviceaccount) or an explicit
host for dev/test (e.g. `kubectl proxy`). Only the four verbs the stack needs:
list, watch (chunked JSON event stream), get, patch.
"""

from __future__ import annotations

import asyncio
import json
import os
import ssl
from collections.abc import AsyncIterator

from production_stack_tpu_torch.utils import http
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class K8sClient:
    def __init__(
        self,
        host: str | None = None,
        token: str | None = None,
        ca_path: str | None = None,
        namespace: str | None = None,
    ):
        env_host = os.environ.get("KUBERNETES_SERVICE_HOST")
        env_port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if host:
            self.host = host
        elif env_host:
            self.host = f"https://{env_host}:{env_port}"
        else:
            self.host = "http://127.0.0.1:8001"  # kubectl proxy fallback

        token_path = os.path.join(SA_DIR, "token")
        if token is None and os.path.exists(token_path):
            with open(token_path) as f:
                token = f.read().strip()
        self.token = token

        ca = ca_path or os.path.join(SA_DIR, "ca.crt")
        self._ssl: ssl.SSLContext | bool | None = None
        if self.host.startswith("https://"):
            if os.path.exists(ca):
                self._ssl = ssl.create_default_context(cafile=ca)
            else:
                self._ssl = False  # self-signed dev clusters

        ns_path = os.path.join(SA_DIR, "namespace")
        if namespace:
            self.namespace = namespace
        elif os.path.exists(ns_path):
            with open(ns_path) as f:
                self.namespace = f.read().strip()
        else:
            self.namespace = "default"

        self._session: http.ClientSession | None = None

    def _headers(self, content_type: str | None = None) -> dict:
        h = {}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        if content_type:
            h["Content-Type"] = content_type
        return h

    async def session(self) -> http.ClientSession:
        if self._session is None or self._session.closed:
            self._session = http.ClientSession()
        return self._session

    async def close(self) -> None:
        if self._session and not self._session.closed:
            await self._session.close()

    async def get(self, path: str, params: dict | None = None) -> dict:
        s = await self.session()
        async with s.get(
            f"{self.host}{path}", params=params,
            headers=self._headers(), ssl=self._ssl,
        ) as r:
            r.raise_for_status()
            return await r.json()

    async def patch(
        self, path: str, body: dict,
        content_type: str = "application/merge-patch+json",
    ) -> dict:
        s = await self.session()
        async with s.patch(
            f"{self.host}{path}", json=body,
            headers=self._headers(content_type), ssl=self._ssl,
        ) as r:
            r.raise_for_status()
            return await r.json()

    async def watch(
        self, path: str, params: dict | None = None
    ) -> AsyncIterator[dict]:
        """Yield watch events ({'type': ..., 'object': {...}}) forever;
        reconnects with the last seen resourceVersion on stream end."""
        params = dict(params or {})
        resource_version: str | None = None
        while True:
            p = dict(params)
            p["watch"] = "true"
            if resource_version:
                p["resourceVersion"] = resource_version
            try:
                s = await self.session()
                async with s.get(
                    f"{self.host}{path}", params=p,
                    headers=self._headers(), ssl=self._ssl,
                    timeout=http.ClientTimeout(total=None, sock_read=300),
                ) as r:
                    r.raise_for_status()
                    async for line in r.content:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            event = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        obj = event.get("object", {})
                        rv = obj.get("metadata", {}).get("resourceVersion")
                        if rv:
                            resource_version = rv
                        if event.get("type") == "ERROR":
                            resource_version = None  # resync from scratch
                            break
                        yield event
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.warning("k8s watch error on %s: %s; retrying", path, e)
                resource_version = None
                await asyncio.sleep(2)
