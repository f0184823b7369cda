"""Router utilities (parity: reference src/vllm_router/utils.py)."""

from __future__ import annotations

import enum
import re

from production_stack_tpu_torch.utils import http
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class ModelType(enum.Enum):
    chat = "/v1/chat/completions"
    completion = "/v1/completions"
    embeddings = "/v1/embeddings"
    rerank = "/v1/rerank"
    score = "/v1/score"

    @staticmethod
    def get_test_payload(model_type: str) -> dict:
        return {
            "chat": {
                "messages": [{"role": "user", "content": "Hi"}],
                "max_tokens": 2,
            },
            "completion": {"prompt": "Hi", "max_tokens": 2},
            "embeddings": {"input": "Hi"},
            "rerank": {"query": "Hi", "documents": ["Hi"]},
            "score": {"text_1": "Hi", "text_2": "Hi"},
        }[model_type]

    @staticmethod
    def get_all_fields() -> list[str]:
        return [m.name for m in ModelType]


_URL_RE = re.compile(
    r"^https?://"
    r"([a-zA-Z0-9.\-_]+|\[[0-9a-fA-F:]+\])"  # host or [ipv6]
    r"(:\d{1,5})?"
    r"(/.*)?$"
)


def validate_url(url: str) -> bool:
    return bool(_URL_RE.match(url))


def parse_comma_separated(value: str | None) -> list[str]:
    if not value:
        return []
    return [v.strip() for v in value.split(",") if v.strip()]


def parse_static_urls(static_backends: str) -> list[str]:
    urls = parse_comma_separated(static_backends)
    for u in urls:
        if not validate_url(u):
            raise ValueError(f"invalid backend url: {u}")
    return urls


def parse_static_model_names(static_models: str) -> list[list[str]]:
    """'m1,m2|m3' -> [['m1','m2'], ['m3']] — per-endpoint model lists."""
    return [
        [m.strip() for m in group.split(",") if m.strip()]
        for group in static_models.split("|")
    ] if static_models else []


def parse_static_aliases(static_aliases: str | None) -> dict[str, str]:
    """'alias1:model1,alias2:model2' -> {alias: model}."""
    out: dict[str, str] = {}
    for pair in parse_comma_separated(static_aliases):
        if ":" in pair:
            alias, model = pair.split(":", 1)
            out[alias.strip()] = model.strip()
    return out


def set_ulimit(target: int = 65535) -> None:
    """Raise RLIMIT_NOFILE so the proxy can hold many sockets."""
    import resource

    try:
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < target:
            resource.setrlimit(
                resource.RLIMIT_NOFILE, (min(target, hard), hard)
            )
    except (ValueError, OSError) as e:
        logger.warning("could not raise ulimit: %s", e)


async def is_model_healthy(
    url: str, model: str, model_type: str, timeout_s: float = 10.0
) -> bool:
    """Active health probe: POST a tiny request of the right type."""
    payload = {"model": model, **ModelType.get_test_payload(model_type)}
    endpoint = ModelType[model_type].value
    try:
        async with http.ClientSession(
            timeout=http.ClientTimeout(total=timeout_s)
        ) as session:
            async with session.post(f"{url}{endpoint}", json=payload) as r:
                return r.status == 200
    except Exception as e:  # noqa: BLE001 — unreachable == unhealthy
        logger.debug("health probe failed for %s %s: %s", url, model, e)
        return False


def estimate_prompt_tokens(body: dict) -> int:
    """Conservative (lower-bound) token estimate for a request body's
    prompt — the router-wide context-window filter compares it against
    each backend's advertised `max_model_len`.

    Token-id prompts (`prompt` as a list of ints, or a batch of such
    lists) count exactly. Text prompts estimate at ~1 token per 4
    characters — a deliberate UNDER-estimate for every real tokenizer
    family, so a borderline prompt is never falsely 413'd at the
    router (the engine's own max_model_len gate still applies); the
    filter exists to reject prompts that are hopeless on every
    backend, orders of magnitude past the window."""
    def _text_est(t: str) -> int:
        return len(t) // 4

    p = body.get("prompt")
    if isinstance(p, list):
        if p and all(isinstance(t, int) for t in p):
            return len(p)
        # batch: the LARGEST item must fit the chosen backend
        n = 0
        for item in p:
            if isinstance(item, list) and all(
                isinstance(t, int) for t in item
            ):
                n = max(n, len(item))
            elif isinstance(item, str):
                n = max(n, _text_est(item))
        return n
    if isinstance(p, str):
        return _text_est(p)
    msgs = body.get("messages")
    if isinstance(msgs, list):
        total = 0
        for m in msgs:
            if not isinstance(m, dict):
                continue
            c = m.get("content", "")
            if isinstance(c, list):
                c = " ".join(
                    x.get("text", "") for x in c if isinstance(x, dict)
                )
            if isinstance(c, str):
                total += len(c)
        return total // 4
    return 0
