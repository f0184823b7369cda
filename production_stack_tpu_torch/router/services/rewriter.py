"""Request rewriter extension point.

Parity: reference src/vllm_router/services/request_service/rewriter.py —
RequestRewriter ABC:29, NoopRequestRewriter:53, factory get_request_rewriter
:109. Custom rewriters are loaded from a user module path.
"""

from __future__ import annotations

import abc
import importlib.util

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class RequestRewriter(abc.ABC):
    @abc.abstractmethod
    def rewrite_request(
        self, body: dict, endpoint_path: str, request_id: str
    ) -> dict:
        """Return the (possibly modified) request body."""


class NoopRequestRewriter(RequestRewriter):
    def rewrite_request(self, body, endpoint_path, request_id) -> dict:
        return body


def get_request_rewriter(module_path: str | None = None) -> RequestRewriter:
    """Load a RequestRewriter subclass from a user module, else noop."""
    if not module_path:
        return NoopRequestRewriter()
    try:
        spec = importlib.util.spec_from_file_location(
            "pst_custom_rewriter", module_path
        )
        assert spec and spec.loader
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for attr in vars(mod).values():
            if (
                isinstance(attr, type)
                and issubclass(attr, RequestRewriter)
                and attr is not RequestRewriter
            ):
                logger.info("loaded request rewriter %s", attr.__name__)
                return attr()
    except Exception:
        logger.exception("failed to load rewriter from %s", module_path)
    return NoopRequestRewriter()
