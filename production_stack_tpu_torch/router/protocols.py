"""Router-side data models (endpoint info, request abstraction, OpenAI cards).

Parity: reference src/vllm_router/protocols.py + the EndpointInfo/ModelInfo
dataclasses in src/vllm_router/service_discovery.py:42-105.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelInfo:
    id: str
    object: str = "model"
    created: int = field(default_factory=lambda: int(time.time()))
    owned_by: str = "production-stack-tpu"
    root: str | None = None
    parent: str | None = None
    is_adapter: bool = False

    @staticmethod
    def from_dict(d: dict) -> "ModelInfo":
        return ModelInfo(
            id=d.get("id", "unknown"),
            created=d.get("created", int(time.time())),
            owned_by=d.get("owned_by", "unknown"),
            root=d.get("root"),
            parent=d.get("parent"),
            is_adapter=d.get("parent") is not None,
        )

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "object": self.object,
            "created": self.created,
            "owned_by": self.owned_by,
            "root": self.root,
            "parent": self.parent,
        }


@dataclass
class EndpointInfo:
    """One serving-engine endpoint known to the router."""

    url: str
    model_names: list[str] = field(default_factory=list)
    model_info: dict[str, ModelInfo] = field(default_factory=dict)
    model_label: str | None = None  # helm modelSpec label (PD roles use it)
    # engine-advertised PD role ("prefill" / "decode" / "both") from the
    # /v1/models card metadata (--kv-role); discovery labels are the
    # deployment-side fallback (see `role`)
    pd_role: str | None = None
    # the engine's --kv-instance-id, advertised via /v1/models metadata;
    # kvaware/ttft routing match KV controller results on it (falling
    # back to the id == host:port convention when absent)
    kv_instance_id: str | None = None
    # the engine's admitted context window (resolved_max_model_len on
    # its /v1/models card): the router-wide context filter skips
    # backends whose window is smaller than the prompt's token count
    # and 413s when no backend qualifies. None (card absent / old
    # engine) = unknown — never filtered out.
    max_model_len: int | None = None
    # long-prefill capability: the engine's context-parallel ring size
    # (sp mesh axis) when its long-prefill lane is live
    sp_size: int | None = None
    added_timestamp: float = field(default_factory=time.time)
    sleep: bool = False
    pod_name: str | None = None
    namespace: str | None = None
    # model aliases: alias -> canonical model name
    aliases: dict[str, str] = field(default_factory=dict)

    def serves_model(self, model: str) -> bool:
        return model in self.model_names or model in self.aliases

    @property
    def role(self) -> str:
        """Resolved PD role: the engine-advertised card role wins, then
        the deployment label convention (model_label prefixed
        prefill/decode — helm modelSpec / k8s `model` label), else
        "both" (an unlabeled engine can serve either phase)."""
        if self.pd_role in ("prefill", "decode", "both"):
            return self.pd_role
        lbl = self.model_label or ""
        if lbl.startswith("prefill"):
            return "prefill"
        if lbl.startswith("decode"):
            return "decode"
        return "both"


@dataclass
class RouterRequest:
    """Minimal request view the routing algorithms need."""

    headers: dict[str, str]
    body: dict[str, Any]
    endpoint: str  # HTTP path, e.g. /v1/chat/completions

    @property
    def model(self) -> str | None:
        return self.body.get("model")

    def session_id(self, session_key: str | None) -> str | None:
        if not session_key:
            return None
        # HTTP header names are case-insensitive and clients vary the
        # casing (urllib sends X-user-id for x-user-id); a case-sensitive
        # miss here silently downgrades session stickiness to QPS routing
        want = session_key.lower()
        for k, v in self.headers.items():
            if k.lower() == want:
                return v
        return self.body.get(session_key)

    def request_text(self) -> str:
        """Flatten the prompt/messages for prefix matching."""
        body = self.body
        if "prompt" in body:
            p = body["prompt"]
            return p if isinstance(p, str) else str(p)
        if "messages" in body:
            parts = []
            for m in body["messages"]:
                c = m.get("content", "")
                if isinstance(c, list):
                    c = " ".join(
                        x.get("text", "") for x in c if isinstance(x, dict)
                    )
                parts.append(f"{m.get('role')}: {c}")
            return "\n".join(parts)
        return ""
