"""User-supplied pre/post request hooks loaded via importlib.

Parity: reference src/vllm_router/services/callbacks_service/callbacks.py:23
`configure_custom_callbacks` — a user module exporting `pre_request` /
`post_request` callables, referenced as "path/to/module.py" or
"package.module".
"""

from __future__ import annotations

import importlib
import importlib.util
import os

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class CallbackHandler:
    def __init__(self, module) -> None:
        self._pre = getattr(module, "pre_request", None)
        self._post = getattr(module, "post_request", None)

    def pre_request(self, request, body: dict, request_id: str):
        """May return a modified body; exceptions are logged, not fatal."""
        if self._pre is None:
            return None
        try:
            return self._pre(request, body, request_id)
        except Exception:
            logger.exception("pre_request callback failed")
            return None

    def post_request(self, request_id: str, body: dict) -> None:
        if self._post is None:
            return
        try:
            self._post(request_id, body)
        except Exception:
            logger.exception("post_request callback failed")


def configure_custom_callbacks(spec: str | None) -> CallbackHandler | None:
    if not spec:
        return None
    try:
        if os.path.exists(spec):
            mspec = importlib.util.spec_from_file_location(
                "pst_custom_callbacks", spec
            )
            assert mspec and mspec.loader
            mod = importlib.util.module_from_spec(mspec)
            mspec.loader.exec_module(mod)
        else:
            mod = importlib.import_module(spec)
        logger.info("loaded custom callbacks from %s", spec)
        return CallbackHandler(mod)
    except Exception:
        logger.exception("failed to load callbacks from %s", spec)
        return None
