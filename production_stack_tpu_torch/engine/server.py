"""OpenAI-compatible HTTP server for the PyTorch engine, on stdlib asyncio.

Counterpart of ``production_stack_tpu/engine/server.py`` for the
endpoints this slice serves: ``/health``, ``/v1/models`` (with
``max_model_len`` and the PD role), ``/v1/completions`` and
``/v1/chat/completions`` (both with ``stream``), and a plain-text
``/metrics`` carrying the ``vllm:*`` gauges the router scrapes, and
``/debug/kernel_launches``, which reads (GET) or zeroes (DELETE) the
attention kernels' launch counts and the runner's forward dispatches. The
Prometheus text is written by hand and HTTP/1.1 is parsed by hand
(``asyncio.start_server``): the port needs neither aiohttp nor
prometheus_client. One request per connection (``Connection: close``);
streamed bodies are server-sent events ended by closing the connection.
"""

from __future__ import annotations

import asyncio
import json
import time

from production_stack_tpu_torch.engine import protocol as proto
from production_stack_tpu_torch.engine.async_engine import (
    AsyncLLMEngine,
    EngineSleepingError,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.ops import paged_attention
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_REASONS = {
    200: "OK", 400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable",
}
MAX_BODY_BYTES = 64 * 2**20


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class EngineServer:
    def __init__(self, config: EngineConfig, params: dict | None = None):
        self.config = config
        self.engine = AsyncLLMEngine(config, params=params)
        self.model_name = config.served_model_name or config.model
        self.max_model_len = config.resolved_max_model_len()
        self._server: asyncio.AbstractServer | None = None
        self._routes = {
            ("GET", "/health"): self.handle_health,
            ("GET", "/v1/models"): self.handle_models,
            ("GET", "/metrics"): self.handle_metrics,
            ("POST", "/v1/completions"): self.handle_completions,
            ("POST", "/v1/chat/completions"): self.handle_chat,
            ("GET", "/debug/kernel_launches"): self.handle_kernel_launches,
            ("DELETE", "/debug/kernel_launches"):
                self.handle_reset_kernel_launches,
        }

    # -- lifecycle ---------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the step loop and listen; returns the bound port."""
        self.engine.start(asyncio.get_running_loop())
        self._server = await asyncio.start_server(self._handle, host, port)
        bound = self._server.sockets[0].getsockname()[1]
        logger.info("serving %s on http://%s:%d", self.model_name, host,
                    bound)
        return bound

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.engine.shutdown()

    def run(self, host: str = "0.0.0.0", port: int = 8000) -> None:
        async def main():
            await self.start(host, port)
            try:
                await self._server.serve_forever()
            finally:
                await self.stop()

        try:
            asyncio.run(main())
        except KeyboardInterrupt:
            pass

    # -- HTTP plumbing -----------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, headers, body = await _read_request(reader)
            except HttpError as e:
                await _send_json(writer, e.status, proto.error_json(
                    str(e), code=e.status))
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            handler = self._routes.get((method, path))
            if handler is None:
                known = any(p == path for _, p in self._routes)
                status = 405 if known else 404
                await _send_json(writer, status, proto.error_json(
                    f"{method} {path} not served", code=status))
                return
            if self.config.api_key and path.startswith("/v1/"):
                if headers.get("authorization") != (
                    f"Bearer {self.config.api_key}"
                ):
                    await _send_json(writer, 401, proto.error_json(
                        "invalid or missing API key",
                        "authentication_error", 401))
                    return
            try:
                await handler(body, writer)
            except HttpError as e:
                await _send_json(writer, e.status, proto.error_json(
                    str(e), code=e.status))
            except proto.ProtocolError as e:
                await _send_json(writer, 400, proto.error_json(str(e)))
            except NotImplementedError as e:
                await _send_json(writer, 501, proto.error_json(
                    str(e), "not_implemented", 501))
            except EngineSleepingError as e:
                await _send_json(writer, 503, proto.error_json(
                    str(e), "service_unavailable", 503))
            except ValueError as e:
                await _send_json(writer, 400, proto.error_json(str(e)))
        except ConnectionError:
            pass  # the client went away mid-response
        except Exception:  # noqa: BLE001 — one request, not the server
            logger.exception("request failed")
        finally:
            writer.close()

    # -- endpoints ---------------------------------------------------------
    async def handle_health(self, body, writer) -> None:
        await _send_json(writer, 200, {"status": "healthy"})

    async def handle_models(self, body, writer) -> None:
        card = proto.model_card(
            self.model_name, root=self.config.model,
            kv_role=self.config.pd_role(),
            max_model_len=self.max_model_len,
        )
        await _send_json(writer, 200, {"object": "list", "data": [card]})

    async def handle_metrics(self, body, writer) -> None:
        st = self.engine.stats()
        labels = f'{{model_name="{self.model_name}"}}'
        lines = []
        for name, help_, kind, value in (
            ("vllm:num_requests_running",
             "Requests currently running on the engine.", "gauge",
             st.num_running),
            ("vllm:num_requests_waiting",
             "Requests waiting to be scheduled.", "gauge", st.num_waiting),
            ("vllm:gpu_cache_usage_perc",
             "Fraction of KV cache blocks in use (0-1).", "gauge",
             st.kv_usage),
            ("vllm:prompt_tokens_total", "Prefilled prompt tokens.",
             "counter", st.prompt_tokens_total),
            ("vllm:generation_tokens_total", "Generated tokens.",
             "counter", st.generation_tokens_total),
            ("vllm:num_preemptions_total", "Preempted sequences.",
             "counter", st.num_preemptions_total),
        ):
            lines += [f"# HELP {name} {help_}", f"# TYPE {name} {kind}",
                      f"{name}{labels} {float(value)}"]
        payload = ("\n".join(lines) + "\n").encode()
        await _send(writer, 200, payload,
                    "text/plain; version=0.0.4; charset=utf-8")

    def _launch_report(self) -> dict:
        return {
            "launches": paged_attention.launch_counts(),
            "dispatches": dict(self.engine.engine.runner.dispatch_counts),
        }

    async def handle_kernel_launches(self, body, writer) -> None:
        """Kernel launches (counted only where a CUDA kernel launched) and
        forward dispatches since boot or the last DELETE: shows a driver
        which kernels served its requests."""
        await _send_json(writer, 200, self._launch_report())

    async def handle_reset_kernel_launches(self, body, writer) -> None:
        paged_attention.reset_launch_counts()
        counts = self.engine.engine.runner.dispatch_counts
        for k in counts:
            counts[k] = 0
        await _send_json(writer, 200, self._launch_report())

    async def handle_completions(self, body, writer) -> None:
        req = _json(body)
        self._check_model(req)
        prompt = req.get("prompt")
        if isinstance(prompt, list) and len(prompt) == 1 and isinstance(
            prompt[0], (str, list)
        ):
            prompt = prompt[0]
        if isinstance(prompt, str):
            ids = self.engine.tokenizer.encode(prompt)
        elif isinstance(prompt, list) and prompt and all(
            isinstance(t, int) for t in prompt
        ):
            ids = list(prompt)
        else:
            raise HttpError(
                400, "'prompt' must be one string or one token-id list "
                "(batched prompts are not served by this engine yet)"
            )
        await self._generate(req, ids, writer, chat=False)

    async def handle_chat(self, body, writer) -> None:
        req = _json(body)
        self._check_model(req)
        messages = req.get("messages")
        if not isinstance(messages, list) or not messages:
            raise HttpError(400, "'messages' must be a non-empty list")
        if req.get("tools"):
            raise NotImplementedError(
                "tool calling is not ported to the PyTorch engine yet"
            )
        prompt = self.engine.tokenizer.apply_chat_template(messages)
        ids = self.engine.tokenizer.encode(prompt)
        await self._generate(req, ids, writer, chat=True)

    # -- shared generation paths -------------------------------------------
    def _check_model(self, req: dict) -> None:
        model = req.get("model")
        if model is not None and model not in (
            self.model_name, self.config.model
        ):
            raise HttpError(404, f"model {model!r} is not served here")

    async def _generate(self, req: dict, ids: list[int], writer,
                        chat: bool) -> None:
        sp = proto.sampling_params_from_request(req)
        if sp.n != 1:
            raise NotImplementedError("n > 1 is not ported yet")
        if len(ids) >= self.max_model_len:
            raise HttpError(
                400, f"prompt of {len(ids)} tokens leaves no room in the "
                f"{self.max_model_len}-token context"
            )
        model = req.get("model") or self.model_name
        request_id = proto.make_id("chatcmpl" if chat else "cmpl")
        gen = self.engine.generate(
            request_id, prompt_token_ids=ids, sampling_params=sp,
            priority=int(req.get("priority", 0)),
        )
        if req.get("stream"):
            # the first output comes before the headers, so a request the
            # engine refuses still gets a plain error response
            first = await anext(gen)
            await self._stream(first, gen, writer, request_id, model,
                               chat, len(ids), _wants_usage(req))
            return
        text, reason, n_out = "", None, 0
        async for out in gen:
            text, reason, n_out = out.text, out.finish_reason, len(
                out.token_ids)
        if reason == "error":
            raise HttpError(500, "engine step failed")
        make = proto.chat_response if chat else proto.completion_response
        await _send_json(writer, 200, make(
            request_id, model, text, reason, len(ids), n_out))

    async def _stream(self, first, gen, writer, request_id, model, chat,
                      n_prompt, include_usage) -> None:
        writer.write(_head(200, "text/event-stream", None))

        async def event(data: dict) -> None:
            writer.write(b"data: " + json.dumps(data).encode() + b"\n\n")
            await writer.drain()

        if chat:
            await event(proto.chat_chunk(
                request_id, model, {"role": "assistant", "content": ""},
                None))
        n_out = 0
        out = first
        while out is not None:
            n_out = len(out.token_ids)
            reason = out.finish_reason if out.finished else None
            if out.delta_text or reason is not None:
                if chat:
                    delta = {"content": out.delta_text} if (
                        out.delta_text) else {}
                    await event(proto.chat_chunk(
                        request_id, model, delta, reason))
                else:
                    await event(proto.completion_chunk(
                        request_id, model, out.delta_text, reason))
            out = None if out.finished else await anext(gen, None)
        if include_usage:
            await event(proto.usage_tail_chunk(
                request_id, model, chat, n_prompt, n_out))
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()


def _wants_usage(req: dict) -> bool:
    opts = req.get("stream_options") or {}
    return bool(isinstance(opts, dict) and opts.get("include_usage"))


def _json(body: bytes) -> dict:
    try:
        req = json.loads(body or b"{}")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise HttpError(400, f"invalid JSON body: {e}") from None
    if not isinstance(req, dict):
        raise HttpError(400, "JSON body must be an object")
    return req


async def _read_request(reader: asyncio.StreamReader):
    line = await reader.readline()
    if not line:
        raise asyncio.IncompleteReadError(b"", None)
    try:
        method, target, _version = line.decode("latin-1").split()
    except ValueError:
        raise HttpError(400, "malformed request line") from None
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    length = int(headers.get("content-length", "0") or 0)
    if length > MAX_BODY_BYTES:
        raise HttpError(413, "request body too large")
    body = await reader.readexactly(length) if length else b""
    return method.upper(), target.split("?", 1)[0], headers, body


def _head(status: int, content_type: str, length: int | None) -> bytes:
    lines = [
        f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}",
        f"Content-Type: {content_type}",
        "Connection: close",
        f"Date: {time.strftime('%a, %d %b %Y %H:%M:%S GMT', time.gmtime())}",
    ]
    if length is not None:
        lines.append(f"Content-Length: {length}")
    else:
        lines.append("Cache-Control: no-cache")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def _send(writer, status: int, payload: bytes,
                content_type: str) -> None:
    writer.write(_head(status, content_type, len(payload)) + payload)
    await writer.drain()


async def _send_json(writer, status: int, obj: dict) -> None:
    await _send(writer, status, json.dumps(obj).encode(),
                "application/json")
